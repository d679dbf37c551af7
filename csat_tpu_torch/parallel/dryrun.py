"""Multi-process dry run: one train step over a gloo group.

Counterpart of the JAX package's ``parallel/dryrun.py:29-117`` over the
``data``, ``model``, ``seq`` and ``pipe`` axes.  :func:`dryrun_train_step`
starts ``n_ranks`` processes on the CPU, joins them in a gloo group through
a ``file://`` store, and each runs ONE optimizer step of a tiny model on its
data shard's rows of one random global batch — its shard of the heads over
a ``model`` axis of ``model_par`` processes, the ring over a ``seq`` axis of
``seq_par``, the GPipe wavefront over a ``pipe`` axis of ``pipe_par`` — then
one greedy decode of them.  It checks that every output is finite, the
decoded shape is right and the (whole, gathered) parameters after the step
are the same bits on every process.

    python -m csat_tpu_torch.parallel.dryrun 2
    python -m csat_tpu_torch.parallel.dryrun 4 --model 2
    python -m csat_tpu_torch.parallel.dryrun 4 --seq 2
    python -m csat_tpu_torch.parallel.dryrun 2 --pipe 2
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import tempfile
from typing import Dict, Tuple

__all__ = ["dryrun_train_step", "tiny_multiprocess_config", "tiny_multichip_config"]

SRC_V, TGT_V = 97, 83


def tiny_multichip_config(n_devices: int, data: int, model_par: int, seq_par: int = 1):
    """The JAX package's dry-run config (``dryrun.py:29-54``): the flagship
    at tiny widths over ``("data", data), ("model", model_par)`` (and
    ``("seq", seq_par)``, with trees ``32 · seq_par`` nodes long), two rows a
    data shard, in the config's own noise mode.  ``n_devices`` is JAX's
    argument, unused as there."""
    from csat_tpu_torch.configs import get_config

    mesh = [("data", data), ("model", model_par)]
    if seq_par > 1:
        mesh.append(("seq", seq_par))
    return get_config("python", pe_dim=32, pegen_dim=64, sbm_enc_dim=128, hidden_size=128,
                      num_heads=8, num_layers=2, sbm_layers=2, clusters=(4, 4),
                      dim_feed_forward=256, max_src_len=32 * max(seq_par, 1), max_tgt_len=12,
                      batch_size=2 * data, tree_pos_width=4, tree_pos_height=8,
                      mesh_shape=tuple(mesh))


def tiny_multiprocess_config(data: int, seq: int = 1, pipe: int = 1, model: int = 1,
                             **overrides):
    """The flagship at tiny widths over a ``data`` axis of ``data``
    processes, two rows each, times a ``model`` axis (the heads split), a
    ``seq`` axis (the ring) or a ``pipe`` axis (two microbatches) when
    given."""
    from csat_tpu_torch.configs import get_config

    mesh = (("data", data),) + ((("model", model),) if model > 1 else ()) + (
        (("seq", seq),) if seq > 1 else ()) + ((("pipe", pipe),) if pipe > 1 else ())
    kw = dict(pe_dim=32, pegen_dim=64, sbm_enc_dim=128, hidden_size=128, num_heads=8,
              num_layers=2, sbm_layers=2, clusters=(4, 4), dim_feed_forward=256,
              max_src_len=32, max_tgt_len=12, batch_size=2 * data, tree_pos_width=4,
              tree_pos_height=8, mesh_shape=mesh, noise_mode="counter", seq_impl="ring")
    if pipe > 1:
        kw.update(pipeline_stages=pipe, pipeline_microbatches=2)
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


def _worker(rank: int, world: int, init_file: str, out_dir: str, seq: int, pipe: int,
            model_par: int) -> None:
    import torch

    from csat_tpu_torch.data.dataset import batch_to_device
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.parallel import host
    from csat_tpu_torch.parallel.mesh import (
        broadcast_params, build_mesh, gather_params, shard_model)
    from csat_tpu_torch.train import create_train_state, default_optimizer, make_train_step
    from csat_tpu_torch.train.decode import greedy_decode

    torch.set_num_threads(1)
    host.initialize_multihost("gloo", f"file://{init_file}", world, rank)
    try:
        cfg = tiny_multiprocess_config(world // (seq * pipe * model_par), seq, pipe, model_par)
        mesh = build_mesh(cfg.mesh_shape)
        b = cfg.batch_size // mesh.data
        full = random_global_batch(cfg, cfg.batch_size)
        row0, _ = mesh.rows(b)
        mine = full._replace(**{f: getattr(full, f)[row0:row0 + b] for f in full._fields})
        batch = batch_to_device(mine, torch.device("cpu"))
        model = shard_model(CSATrans(cfg, SRC_V, TGT_V, device="cpu", seed=cfg.seed), mesh)
        opt = default_optimizer(cfg)
        state = create_train_state(model, opt, cfg.seed)
        broadcast_params(state.params, mesh)
        state, metrics = make_train_step(model, opt, cfg, mesh)(state, batch)
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            toks = greedy_decode(model, batch, gen, mesh.decode_shard(b))
        flat = torch.cat([p.reshape(-1) for p in gather_params(state.params, mesh).values()])
        torch.save(flat, os.path.join(out_dir, f"params_{rank}.pt"))
        with open(os.path.join(out_dir, f"rank_{rank}.json"), "w") as f:
            json.dump({"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                       "nonfinite": bool(metrics["nonfinite"]), "mesh": mesh.shape,
                       "decoded": list(toks.shape),
                       "decoded_finite": bool(torch.all(toks >= 0))}, f)
    finally:
        host.shutdown()


def dryrun_train_step(n_ranks: int = 2, timeout_s: float = 300.0, seq_par: int = 1,
                      pipe_par: int = 1, model_par: int = 1) -> Tuple[float, Dict]:
    """One train step over ``n_ranks`` gloo processes on the CPU, the data
    axis taking what a ``model_par`` / ``seq_par`` / ``pipe_par`` axis
    leaves → ``(loss, info)``.  Raises when a process fails or hangs past
    ``timeout_s``, an output is not finite, or the processes' (gathered)
    parameters after the step differ."""
    import torch

    if n_ranks % (seq_par * pipe_par * model_par):
        raise ValueError(f"{n_ranks} processes cannot hold model {model_par} × seq {seq_par} × "
                         f"pipe {pipe_par}")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_worker,
                             args=(r, n_ranks, init_file, tmp, seq_par, pipe_par, model_par))
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
    ap = argparse.ArgumentParser(description="one train step over gloo processes on the CPU")
    ap.add_argument("n_ranks", nargs="?", type=int, default=2)
    ap.add_argument("--model", type=int, default=1,
                    help="processes on the model axis (tensor parallelism)")
    ap.add_argument("--seq", type=int, default=1, help="processes on the seq axis (the ring)")
    ap.add_argument("--pipe", type=int, default=1, help="processes on the pipe axis (GPipe)")
    a = ap.parse_args()
    loss, info = dryrun_train_step(a.n_ranks, seq_par=a.seq, pipe_par=a.pipe, model_par=a.model)
    print(json.dumps({"loss": loss, **info}))
