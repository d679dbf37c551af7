"""Multi-process dry run: one data-parallel train step over a gloo group.

Counterpart of the JAX package's ``parallel/dryrun.py:29-117`` in its
data-parallel form (its ``model`` and ``seq`` axes wait for the next
parallel slice).  :func:`dryrun_train_step` starts ``n_ranks`` processes on
the CPU, joins them in a gloo group through a ``file://`` store, and each
runs ONE optimizer step of a tiny model on its rows of one random global
batch, then one greedy decode of them.  It checks that every output is
finite, the decoded shape is right and the parameters after the step are
the same bits on every process.

    python -m csat_tpu_torch.parallel.dryrun 2
"""

from __future__ import annotations

import json
import multiprocessing
import os
import sys
import tempfile
from typing import Dict, Tuple

__all__ = ["dryrun_train_step", "tiny_multiprocess_config"]

SRC_V, TGT_V = 97, 83


def tiny_multiprocess_config(data: int, **overrides):
    """The flagship at tiny widths with a ``data`` axis of ``data``
    processes, two rows each."""
    from csat_tpu_torch.configs import get_config

    kw = dict(pe_dim=32, pegen_dim=64, sbm_enc_dim=128, hidden_size=128, num_heads=8,
              num_layers=2, sbm_layers=2, clusters=(4, 4), dim_feed_forward=256,
              max_src_len=32, max_tgt_len=12, batch_size=2, tree_pos_width=4,
              tree_pos_height=8, mesh_shape=(("data", data),), noise_mode="counter")
    kw.update(overrides)
    return get_config("python", **kw)


def random_global_batch(cfg, rows: int, seed: int = 0):
    """``rows`` seeded random ASTs of 5 to ``max_src_len`` nodes with random
    summaries, collated at ``cfg.max_src_len`` (on the host)."""
    import numpy as np

    from csat_tpu_torch.data.dataset import collate
    from csat_tpu_torch.data.synthetic import random_ast, train_sample

    rng = np.random.default_rng(seed)
    samples = [train_sample(random_ast(rng, int(n)), cfg, SRC_V, TGT_V, rng)
               for n in rng.integers(5, cfg.max_src_len + 1, rows)]
    arrs = {key: np.stack([s[key] for s in samples]) for key in samples[0]}
    return collate(arrs, cfg.max_src_len)


def _worker(rank: int, world: int, init_file: str, out_dir: str) -> None:
    import torch

    from csat_tpu_torch.data.dataset import batch_to_device
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.parallel import host
    from csat_tpu_torch.parallel.mesh import broadcast_params, build_mesh
    from csat_tpu_torch.train import create_train_state, default_optimizer, make_train_step
    from csat_tpu_torch.train.decode import greedy_decode

    torch.set_num_threads(1)
    host.initialize_multihost("gloo", f"file://{init_file}", world, rank)
    try:
        cfg = tiny_multiprocess_config(world)
        mesh = build_mesh(cfg.mesh_shape)
        b = cfg.batch_size
        full = random_global_batch(cfg, b * world)
        mine = full._replace(**{f: getattr(full, f)[rank * b:(rank + 1) * b]
                                for f in full._fields})
        batch = batch_to_device(mine, torch.device("cpu"))
        model = CSATrans(cfg, SRC_V, TGT_V, device="cpu", seed=cfg.seed)
        opt = default_optimizer(cfg)
        state = create_train_state(model, opt, cfg.seed)
        broadcast_params(state.params, mesh)
        state, metrics = make_train_step(model, opt, cfg, mesh)(state, batch)
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            toks = greedy_decode(model, batch, gen)
        flat = torch.cat([p.detach().reshape(-1) for p in state.params.values()])
        torch.save(flat, os.path.join(out_dir, f"params_{rank}.pt"))
        with open(os.path.join(out_dir, f"rank_{rank}.json"), "w") as f:
            json.dump({"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                       "nonfinite": bool(metrics["nonfinite"]), "mesh": mesh.shape,
                       "decoded": list(toks.shape),
                       "decoded_finite": bool(torch.all(toks >= 0))}, f)
    finally:
        host.shutdown()


def dryrun_train_step(n_ranks: int = 2, timeout_s: float = 300.0) -> Tuple[float, Dict]:
    """One data-parallel step over ``n_ranks`` gloo processes on the CPU →
    ``(loss, info)``.  Raises when a process fails or hangs past
    ``timeout_s``, an output is not finite, or the processes' parameters
    after the step differ."""
    import torch

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_worker, args=(r, n_ranks, init_file, tmp))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout_s)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if hung or any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"dry run: ranks hung {hung}, exit codes "
                               f"{[p.exitcode for p in procs]}")
        recs = []
        for r in range(n_ranks):
            with open(os.path.join(tmp, f"rank_{r}.json")) as f:
                recs.append(json.load(f))
        params = [torch.load(os.path.join(tmp, f"params_{r}.pt")) for r in range(n_ranks)]
    losses = {rec["loss"] for rec in recs}
    if len(losses) != 1 or not all(torch.isfinite(torch.tensor(rec["loss"])) for rec in recs):
        raise AssertionError(f"dry run: losses differ or are not finite: {recs}")
    if any(rec["nonfinite"] for rec in recs) or not all(rec["decoded_finite"] for rec in recs):
        raise AssertionError(f"dry run: a non-finite step or decode: {recs}")
    if not all(torch.equal(params[0], p) for p in params[1:]):
        raise AssertionError("dry run: the parameters after the step differ across ranks")
    if not all(torch.isfinite(p).all() for p in params):
        raise AssertionError("dry run: non-finite parameters after the step")
    return recs[0]["loss"], {"mesh": recs[0]["mesh"], "n_ranks": n_ranks,
                             "grad_norm": recs[0]["grad_norm"], "decoded": recs[0]["decoded"]}


if __name__ == "__main__":
    loss, info = dryrun_train_step(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
    print(json.dumps({"loss": loss, **info}))
