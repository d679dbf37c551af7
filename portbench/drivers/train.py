"""The training driver: the port's step loop, as ``Trainer.fit`` runs it.

Set-up builds one step object — the model, its AdamW state and its noise
generator (``train.state``), and the step from ``train.loop.make_train_step``
— over the benchmark's weights, and one batch stream: the corpus through
``data.bucketing.iterate_bucketed_batches`` (the config's bucket ladder and
node budget, reshuffled each epoch), the collate, and
``train.loop.prefetch_batches`` at the config's depth.  The stream's first
batches are one of each bucket width of the ladder (the first of each width
in the first epoch's shuffle, moved ahead of the rest of that epoch), so the
steps the reference follows hold every shape the window times.  Those are
the first steps of the warm-up, which steps on until every bucket shape has
run twice.  The window then dispatches
steps back to back on the same object and stream and closes with a
``torch.cuda.synchronize()``.

Per step the record keeps the rows, the bucket shape, the real nodes and
decoder positions (their sums for the FLOP count) and the wait for the next
batch.  A traced run (``--trace 1``) then profiles ``profile_steps`` more
steps of the same stream, so the profiler's cost stays out of the window.
After that the program is freed and the reference
(``portbench/reference``) runs the first three steps again from the same
weights, seed and samples, which it collates itself from the corpus.
"""

from __future__ import annotations

import collections
import itertools
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.core import gates
from portbench.core.record import Record, Spans
from portbench.core.weights import make_weights
from portbench.reference.model import PAD, AdamW, Reference, loss, relation_planes

__all__ = ["run"]

CHECKED_STEPS = 3


class Corpus:
    """The port's dataset interface over the generated arrays."""

    def __init__(self, arrays: Dict[str, np.ndarray], config):
        self.arrays = arrays
        self.config = config

    def __len__(self) -> int:
        return len(self.arrays["num_node"])


def first_per_width(batches, widths: List[int]):
    """``batches`` with the first batch of each node width in ``widths``
    moved ahead, in the order they come; the batches read on the way follow
    in their own order, then the rest.  A width that never comes is looked
    for no further than the first ``len(widths) * 64`` batches."""
    it = iter(batches)
    firsts, held, seen = [], [], set()
    for b in itertools.islice(it, len(widths) * 64):
        n = b.src_seq.shape[1]
        if n in seen:
            held.append(b)
        else:
            seen.add(n)
            firsts.append(b)
        if seen >= set(widths):
            break
    yield from firsts
    yield from held
    yield from it


def _sums(batch) -> Dict[str, float]:
    """A host batch's sizes: rows, bucket shape, and the sums of its real
    nodes ``n`` and decoder positions ``t`` (those with a target: the
    summary's words and EOS) the FLOP count reads."""
    n = np.asarray(batch.num_node, np.float64)
    t = (np.asarray(batch.target) != PAD).sum(1).astype(np.float64)
    return {"n": n.sum(), "n2": (n * n).sum(), "t": t.sum(), "t2": (t * t).sum(),
            "nt": (n * t).sum(), "rows": float(len(n)), "n_cap": batch.src_seq.shape[1],
            "t_cap": batch.tgt_seq.shape[1]}


def _noted(batches, sizes: collections.deque):
    """``batches`` as they are, each one's :func:`_sums` queued on the way
    (on the prefetch worker's thread, so the window reads sizes without
    waiting on the device)."""
    for b in batches:
        sizes.append(_sums(b))
        yield b


def _leaf_norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[k].double()) for k in names]) * scale
    return dict(zip(names, norms.cpu().tolist()))


def _reference_batches(arrays: Dict[str, np.ndarray], batches: List[Dict[str, np.ndarray]],
                       model: Dict, device) -> List[Dict[str, torch.Tensor]]:
    """The reference's inputs: each timed batch's samples, found in the
    corpus by their token rows, collated again at the batch's width."""
    key = {arrays["src_seq"][i].tobytes() + arrays["tgt_seq"][i].tobytes(): i
           for i in range(len(arrays["num_node"]))}
    out = []
    for b in batches:
        n, t1 = b["src_seq"].shape[1], b["tgt_seq"].shape[1]
        idx = []
        for row_s, row_t in zip(b["src_seq"], b["tgt_seq"]):
            full_s = np.zeros(model["max_src_len"], np.int32)
            full_s[:n] = row_s
            full_t = np.zeros(model["max_tgt_len"] - 1, np.int32)
            full_t[:t1] = row_t
            idx.append(key[full_s.tobytes() + full_t.tobytes()])
        idx = np.asarray(idx)
        host = {"src_seq": arrays["src_seq"][idx][:, :n], "tgt_seq": arrays["tgt_seq"][idx][:, :t1],
                "target": arrays["target"][idx][:, :t1],
                **relation_planes(arrays["L_raw"][idx][:, :n, :n], arrays["T_raw"][idx][:, :n, :n],
                                  model["max_src_len"])}
        out.append({k: torch.as_tensor(v).to(device) for k, v in host.items()})
    return out


def reference_steps(model: Dict, seed: int, batches, device, precision: str = "f32"):
    """The reference's steps over ``batches`` (the checked steps) from the
    run's weights and seed → ``(nll per step, first-gradient norms, change
    norms)``."""
    params = make_weights(model, seed, device)
    start = {k: v.clone() for k, v in params.items()}
    for p in params.values():
        p.requires_grad_(True)
    ref = Reference(model, params, precision)
    opt = AdamW(params, model["learning_rate"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    nll_steps, first = [], None
    for b in batches:
        log_probs, sparsity = ref.forward(b, gen)
        nll, total = loss(model, log_probs, b["target"], sparsity)
        grads = torch.autograd.grad(total, list(params.values()))
        grads = dict(zip(params, grads))
        if first is None:
            first = _leaf_norms(grads)
        opt.step(params, grads)
        nll_steps.append(float(nll.detach()))
        del log_probs, sparsity, grads
    change = _leaf_norms({k: params[k].detach() - start[k] for k in params})
    return nll_steps, first, change


def readings(prog, ref) -> Dict[str, float]:
    """The numbers of ``prog`` against ``ref``, each a ``(nll per step,
    first-gradient norms, change norms)``: the largest step's loss gap and
    each step's (``loss_steps``), the worst leaf's gaps and the median leaf's
    (``*_median``), with the leaves that read the worst (``grad_leaf``,
    ``change_leaf``) and those left out.  A cell's limits file names the ones
    it compares."""
    keep = gates.kept_leaves(ref[1])
    loss_steps = [abs(a - b) / abs(b) for a, b in zip(prog[0], ref[0])]
    grad = gates.leaf_gaps(prog[1], ref[1], keep)
    change = gates.leaf_gaps(prog[2], ref[2], keep)
    return {"loss_gap": max(loss_steps), "loss_steps": loss_steps,
            "grad_gap": gates.worst_leaf(grad),
            "change_gap": gates.worst_leaf(change),
            "grad_median": gates.median(list(grad.values())),
            "change_median": gates.median(list(change.values())),
            "grad_leaf": max(grad, key=grad.get), "change_leaf": max(change, key=change.get),
            "left_out": sorted(set(ref[1]) - set(keep))}


def run(cell, rec: Record, opts) -> Dict:
    from csat_tpu_torch.data.bucketing import iterate_bucketed_batches
    from csat_tpu_torch.train.loop import make_train_step, prefetch_batches
    from csat_tpu_torch.train.state import create_train_state, default_optimizer

    from portbench.core.port import port_config, port_model
    from portbench.core.profile import Tracer
    from portbench.core.spec import ROOT, load_part

    model_cfg, mix, dev = cell.model, cell.mix, opts.device
    cfg = port_config(model_cfg, mix, ROOT)
    arrays = load_part("traffic", mix["generator"]).generate(mix, model_cfg, opts.seed,
                                                             opts.seconds)
    corpus = Corpus(arrays, cfg)

    model = port_model(cfg, model_cfg, make_weights(model_cfg, opts.seed, dev), dev)
    opt = default_optimizer(cfg)
    state = create_train_state(model, opt, opts.seed)
    step = make_train_step(model, opt, cfg)
    if opts.fault is not None:
        step = opts.fault(step, state)

    epochs = (iterate_bucketed_batches(corpus, cfg, shuffle=True, seed=int(opts.seed) + e)
              for e in itertools.count())
    widths = _ladder(cfg)  # one target width: the flagship's
    checked_steps = max(CHECKED_STEPS, len(widths))
    sizes: collections.deque = collections.deque()
    host = first_per_width(itertools.chain.from_iterable(epochs), widths)
    stream = prefetch_batches(_noted(host, sizes), dev, depth=cfg.prefetch)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    spans = rec.spans

    # warm-up: the checked steps (one of each width) first, then every
    # bucket shape twice
    start = {k: p.detach().clone() for k, p in state.params.items()}
    checked, nll = [], []
    first_grad = None
    seen: Dict[tuple, int] = {}
    bad = 0
    for i in range(int(mix["max_warmup_steps"])):
        batch = next(stream)
        sizes.popleft()
        state, metrics = step(state, batch, bad)
        bad = metrics.get("bad_steps", 0)
        key = tuple(batch.src_seq.shape)
        seen[key] = seen.get(key, 0) + 1
        if i < checked_steps:
            checked.append({"src_seq": batch.src_seq.cpu().numpy(),
                            "tgt_seq": batch.tgt_seq.cpu().numpy()})
            nll.append(metrics["loss"])
            if i == 0:
                first_grad = _leaf_norms(state.opt_state.mu, 1.0 / (1.0 - opt.b1))
            if i == checked_steps - 1:
                change = _leaf_norms({k: p.detach() - start[k] for k, p in state.params.items()})
                del start
        if i >= checked_steps - 1 and len(seen) >= len(widths) and min(seen.values()) >= 2:
            break
    prog = ([float(x) for x in nll], first_grad, change)
    sync()
    rec.setup_s = time.perf_counter() - opts.t_process

    # the window
    nonfinite = []
    t_open = time.perf_counter()
    while time.perf_counter() - t_open < opts.seconds:
        with spans.span("train.data_wait"):
            batch = next(stream)
        with spans.span("train.step"):
            state, metrics = step(state, batch, bad)
        bad = metrics.get("bad_steps", 0)
        if "nonfinite" in metrics:
            nonfinite.append(metrics["nonfinite"])
        rec.steps.append(sizes.popleft())
    sync()
    rec.window_s = time.perf_counter() - t_open
    if opts.trace and dev.type == "cuda":
        # the traced steps come after the window, on the same stream, so the
        # profiler's cost stays out of the window's host-clock numbers
        traced = Spans()
        tracer = Tracer(rec, traced)
        tracer.start()
        for _ in range(int(mix["profile_steps"])):
            with traced.span("train.data_wait"):
                batch = next(stream)
            with traced.span("train.step"):
                state, metrics = step(state, batch, bad)
            bad = metrics.get("bad_steps", 0)
            sizes.popleft()
        tracer.stop()
    failed = int(torch.stack(nonfinite).sum()) if nonfinite else 0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    stream.close()
    del state, step, model, opt, stream, batch, metrics, nonfinite
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference's three steps, after the window
    batches = _reference_batches(arrays, checked, model_cfg, dev)
    ref = reference_steps(model_cfg, opts.seed, batches, dev)
    values = readings(prog, ref)
    values["widths"] = [b["src_seq"].shape[1] for b in checked]
    out = {"attempted": len(rec.steps), "failed": failed, "memory_peak_bytes": peak,
           "values": values}
    if opts.control:
        out["control"] = readings(reference_steps(model_cfg, opts.seed, batches, dev, "tf32"),
                                  ref)
    return out


def _ladder(cfg) -> List[int]:
    from csat_tpu_torch.data.bucketing import src_bucket_ladder

    return list(src_bucket_ladder(cfg))
