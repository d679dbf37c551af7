"""Intermediate-node-prediction probe for PE quality (RQ2), and its command.

Counterpart of the JAX package's ``probe.py`` and ``tools/run_probe.py``:
for node pairs exactly ``hops`` apart in an AST, take the post-expansion
positional encoding the encoder produced for each node
(``CSATrans.encode_pe``), and train a 2-layer MLP to predict the token of
the path's middle node from ``concat(pe_a, pe_b)``.  The accuracy measures
how much tree structure a PE variant's encoding carries.  Tree paths come
from the dataset's ``parent_idx`` arrays; the MLP trains full-batch with
``torch.optim.Adam`` at lr 1e-3 (optax's defaults: β 0.9 / 0.999, eps 1e-8).

    python -m csat_tpu_torch.probe --config python_treepos --data_dir DIR \\
        [--checkpoint OUT_DIR] [--hops 3 5 7] [--device cpu]

``--checkpoint`` is a directory holding the port's ``best_model.pt`` (what
``python -m csat_tpu_torch.cli`` writes); without it the model keeps its
seeded random weights.  The ``sequential`` variant has no learned PE: its
sinusoidal table is probed, as the JAX tool does.  Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["tree_path", "sample_pairs", "ProbeMLP", "run_probe", "extract_pe", "main"]

HIDDEN = 256

#: ``(in_dim, hidden, n_classes)`` → initial MLP weights in JAX's layout:
#: ``w1`` (in, hidden), ``b1``, ``w2`` (hidden, classes), ``b2``
Init = Callable[[int, int, int], Mapping[str, np.ndarray]]


def tree_path(parent_idx: Sequence[int], a: int, b: int) -> List[int]:
    """Shortest path between nodes a and b in a rooted tree given parents."""
    anc_a = {}
    x, d = a, 0
    while x >= 0:
        anc_a[x] = d
        x = int(parent_idx[x]) if x != 0 else -1
        d += 1
    x, path_b = b, []
    while x not in anc_a:
        path_b.append(x)
        x = int(parent_idx[x])
    lca = x
    path_a, x = [], a
    while x != lca:
        path_a.append(x)
        x = int(parent_idx[x])
    return path_a + [lca] + path_b[::-1]


def sample_pairs(parent_idx: np.ndarray, n_nodes: int, hops: int, rng: np.random.Generator,
                 cap: int = 32) -> List[Tuple[int, int, int]]:
    """(a, b, middle) triples with path length ``hops`` among the first 24
    nodes of a random permutation, at most ``cap``."""
    found = []
    nodes = rng.permutation(n_nodes)
    for a in nodes[: min(n_nodes, 24)]:
        for b in nodes[: min(n_nodes, 24)]:
            if b <= a:
                continue
            p = tree_path(parent_idx, int(a), int(b))
            if len(p) == hops + 1:
                found.append((int(a), int(b), p[hops // 2]))
                if len(found) >= cap:
                    return found
    return found


class ProbeMLP(nn.Module):
    """``relu(x·w1 + b1)·w2 + b2``; weights in JAX's ``(in, out)`` layout,
    drawn He-normal from ``gen`` (biases zero) unless ``init`` gives them."""

    def __init__(self, in_dim: int, hidden: int, n_classes: int,
                 gen: Optional[torch.Generator] = None,
                 init: Optional[Mapping[str, np.ndarray]] = None):
        super().__init__()
        if init is None:
            init = {"w1": torch.randn(in_dim, hidden, generator=gen) * (2.0 / in_dim) ** 0.5,
                    "b1": torch.zeros(hidden),
                    "w2": torch.randn(hidden, n_classes, generator=gen) * (2.0 / hidden) ** 0.5,
                    "b2": torch.zeros(n_classes)}
        for name in ("w1", "b1", "w2", "b2"):
            self.register_parameter(name, nn.Parameter(
                torch.as_tensor(np.asarray(init[name], np.float32)).clone()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x @ self.w1 + self.b1) @ self.w2 + self.b2


def run_probe(pe: np.ndarray, parent_idx: List[np.ndarray], n_nodes: List[int],
              node_types: List[np.ndarray], hops: int = 3, epochs: int = 30, seed: int = 0,
              init: Optional[Init] = None, device=None) -> Dict[str, float]:
    """Probe train/test accuracy for ``hops``: ``pe`` (samples, N, pe_dim),
    per sample its parents, node count and per-node type ids.  Pairs and
    the 80/20 split come from ``numpy.random.default_rng(seed)`` as in JAX;
    the MLP starts from the weights ``init`` returns for its shapes (see
    :data:`Init`) or from a draw of a ``torch.Generator`` seeded with
    ``seed``.  On ``device`` (default ``cuda``; raises without one unless
    ``device="cpu"``)."""
    from csat_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for i in range(len(n_nodes)):
        for a, b, mid in sample_pairs(parent_idx[i], int(n_nodes[i]), hops, rng):
            xs.append(np.concatenate([pe[i, a], pe[i, b]]))
            ys.append(int(node_types[i][mid]))
    if len(xs) < 8:
        return {"hops": hops, "n_pairs": len(xs), "train_acc": 0.0, "test_acc": 0.0}
    x = torch.as_tensor(np.stack(xs), dtype=torch.float32, device=dev)
    y = torch.as_tensor(np.asarray(ys), dtype=torch.long, device=dev)
    n_classes = int(y.max()) + 1
    n = x.shape[0]
    split = max(1, int(0.8 * n))
    perm = rng.permutation(n)
    tr = torch.as_tensor(perm[:split], device=dev)
    te = torch.as_tensor(perm[split:], device=dev)

    mlp = ProbeMLP(x.shape[1], HIDDEN, n_classes, torch.Generator().manual_seed(seed),
                   init and init(x.shape[1], HIDDEN, n_classes)).to(dev)
    opt = torch.optim.Adam(mlp.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(epochs):
        opt.zero_grad(set_to_none=True)
        torch.nn.functional.cross_entropy(mlp(x[tr]), y[tr]).backward()
        opt.step()

    @torch.no_grad()
    def acc(idx):
        if len(idx) == 0:
            return 0.0
        pred = torch.argmax(mlp(x[idx]), dim=-1)
        return float(torch.mean((pred == y[idx]).float()))

    return {"hops": hops, "n_pairs": n, "train_acc": round(acc(tr), 4),
            "test_acc": round(acc(te), 4)}


def extract_pe(model, batch, gen: Optional[torch.Generator] = None) -> np.ndarray:
    """The post-expansion PE ``(B, N, pe_dim)`` of ``model``'s deterministic
    forward on ``batch`` (tensors on the model's device); ``gen`` draws the
    SBM graph under ``eval_graph="sample"``."""
    _, _, pe = model.encode_pe(batch, deterministic=True, gen=gen)
    if pe is None:
        raise ValueError("this PE variant produces no probe-visible encoding")
    return pe.to(torch.float32).cpu().numpy()


def _parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="python")
    p.add_argument("--data_dir", default="")
    p.add_argument("--split", default="test")
    p.add_argument("--checkpoint", default="",
                   help="directory of the port's best_model.pt (default: random weights)")
    p.add_argument("--hops", type=int, nargs="+", default=[3, 5, 7])
    p.add_argument("--max_samples", type=int, default=256)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="FIELD=VALUE",
                   help="override a config field; the widths must match the checkpoint's")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--out", default="", help="also write the report to this JSON file")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = _parse(argv)

    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.dataset import (
        ASTDataset, batch_to_device, iterate_batches, load_matrices)
    from csat_tpu_torch.data.vocab import load_vocab
    from csat_tpu_torch.models.components import sinusoidal_rows
    from csat_tpu_torch.train.checkpoint import restore_params
    from csat_tpu_torch.train.state import make_model, triplet_dictionary
    from csat_tpu_torch.utils import resolve_device

    overrides = {}
    for item in args.overrides:
        field, _, value = item.partition("=")
        overrides[field] = ast.literal_eval(value)
    if args.data_dir:
        overrides["data_dir"] = args.data_dir
    cfg = get_config(args.config, **overrides)
    dev = resolve_device(args.device)
    src_vocab, tgt_vocab = load_vocab(cfg.data_dir)
    ds = ASTDataset(cfg, args.split, src_vocab, tgt_vocab)
    records = load_matrices(os.path.join(cfg.data_dir, args.split,
                                         "split_matrices.npz"))["root_first_seq"]
    model = make_model(cfg, src_vocab.size(), tgt_vocab.size(), triplet_dictionary(cfg)[1],
                       device=dev, seed=0)
    if args.checkpoint:
        model.load_state_dict(restore_params(args.checkpoint), strict=True)
    sin_pe = None
    if cfg.use_pegen == "sequential":
        # no learned probe-visible PE: the sinusoidal table the encoder adds
        sin_pe = sinusoidal_rows(torch.arange(cfg.max_src_len), cfg.sbm_enc_dim).numpy()

    limit = min(args.max_samples, len(records))
    gen = torch.Generator(device=dev).manual_seed(0)
    pes, parents, n_nodes, types = [], [], [], []
    for batch in iterate_batches(ds, cfg.batch_size, shuffle=False, drop_last=False):
        if sin_pe is not None:
            pe = np.broadcast_to(sin_pe[None], (batch.src_seq.shape[0], *sin_pe.shape))
        else:
            pe = extract_pe(model, batch_to_device(batch, dev), gen)
        for b in range(pe.shape[0]):
            if len(pes) >= limit:
                break
            rec = records[len(pes)]
            n = min(int(batch.num_node[b]), len(rec.parent_idx))
            parents.append(np.maximum(rec.parent_idx[:n], 0))
            n_nodes.append(n)
            types.append(np.asarray(batch.src_seq[b]))
            pes.append(pe[b])
        if len(pes) >= limit:
            break

    pes_arr = np.stack(pes)
    results = [run_probe(pes_arr, parents, n_nodes, types, hops=h, epochs=args.epochs,
                         device=dev) for h in args.hops]
    report = {"config": cfg.name, "split": args.split, "checkpoint": args.checkpoint,
              "overrides": overrides, "probe": results}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
