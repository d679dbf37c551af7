"""Multi-process set-up for the port's data-parallel tests
(tests/test_torch_parallel.py): ranks run as spawned processes joined in one
gloo group through a ``file://`` store under the test's ``tmp_path`` (never a
fixed TCP port: the suite runs under several xdist workers), each rank on one
intra-op thread, every join bounded, so a hung rank fails its test instead
of the suite.  Workers import no JAX and return picklable results."""

import multiprocessing
import os
import pickle
import time

import numpy as np

SRC_V, TGT_V, TRIP_V = 200, 300, 50  # torch_parity's vocabularies


def run_ranks(target, world, tmp_path, *args, timeout=300.0):
    """``target(rank, world, out_dir, *args)`` in ``world`` spawned
    processes of one gloo group → the list of their return values, by rank.
    Fails when a rank raises, exits non-zero or outlives ``timeout``."""
    ctx = multiprocessing.get_context("spawn")
    out = str(tmp_path)
    os.makedirs(out, exist_ok=True)
    store = os.path.join(out, f"store_{time.monotonic_ns()}")
    procs = [ctx.Process(target=_entry, args=(target, r, world, store, out, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    assert not hung and all(c == 0 for c in codes), f"ranks hung {hung}, exit codes {codes}"
    results = []
    for r in range(world):
        with open(os.path.join(out, f"result_{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _entry(target, rank, world, store, out, args):
    import torch

    from csat_tpu_torch.parallel import host

    torch.set_num_threads(1)
    host.initialize_multihost("gloo", f"file://{store}", world, rank)
    try:
        res = target(rank, world, out, *args)
    finally:
        host.shutdown()
    with open(os.path.join(out, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def fixed_seeds(seeds, layers):
    """Patch the port's ``draw_seed`` to hand out ``seeds[(name, layer)]``,
    the n-th draw of a name being SBM layer n % layers's, and switch the
    cluster projection's own dropout off (as torch_parity.train_setup does
    in the parent process)."""
    import torch

    from csat_tpu_torch.models import sbm as tsbm

    calls = {}

    def draw(gen, name):
        i = calls.get(name, 0)
        calls[name] = i + 1
        return torch.tensor([seeds[(name, i % layers)]], dtype=torch.int32)

    tsbm.draw_seed = draw
    tsbm.ClusterProj.dropout = 0.0
    return calls


def rows_of(batch, lo, hi):
    """Rows ``[lo, hi)`` of every field of a collated batch."""
    return batch._replace(**{f: getattr(batch, f)[lo:hi] for f in batch._fields})


def dp_step(rank, world, out, payload):
    """One data-parallel train step on this rank's half of the payload's
    global batch, from its weights and with its per-layer seeds (or, with
    ``seeds`` None, the port's own draws and the cluster projection's
    dropout) → loss, metrics, gradients and parameters after the AdamW
    update (numpy)."""
    import torch

    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.parallel.mesh import build_mesh
    from csat_tpu_torch.train import create_train_state, default_optimizer, make_train_step

    cfg, state_dict, batch = payload["cfg"], payload["state_dict"], payload["batch"]
    if payload["seeds"] is not None:
        fixed_seeds(payload["seeds"], cfg.sbm_layers)
    mesh = build_mesh(cfg.mesh_shape)
    b = batch.src_seq.shape[0] // world
    mine = rows_of(batch, rank * b, (rank + 1) * b)
    model = CSATrans(cfg, SRC_V, TGT_V, device="cpu", triplet_vocab_size=TRIP_V)
    model.load_state_dict(state_dict)
    opt = default_optimizer(cfg)
    state = create_train_state(model, opt, seed=0)
    state, m = make_train_step(model, opt, cfg, mesh)(state, mine)
    return {"mesh": mesh.shape, "rows": mesh.rows(b),
            "metrics": {k: np.asarray(v.detach()) for k, v in m.items()},
            "grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()},
            "params": {n: p.detach().numpy().copy() for n, p in model.named_parameters()}}


def seeds_drawn(rank, world, out, payload):
    """Two training-mode forwards of ragged local batches (rank r holds
    ``payload["rows"][r]`` rows) with model dropout on, from a generator
    seeded alike on every rank: the hash seeds each rank draws,
    all-gathered."""
    import torch
    import torch.distributed as dist

    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.models import sbm as tsbm
    from csat_tpu_torch.parallel.mesh import DataShard

    cfg, batch, rows = payload["cfg"], payload["batch"], payload["rows"]
    inner, seen = tsbm.draw_seed, []

    def draw(gen, name):
        seed = inner(gen, name)
        seen.append((name, int(seed)))
        return seed

    tsbm.draw_seed = draw
    row0 = sum(rows[:rank])
    mine = rows_of(batch, row0, row0 + rows[rank])
    model = CSATrans(cfg, SRC_V, TGT_V, device="cpu", triplet_vocab_size=TRIP_V)
    gen = torch.Generator().manual_seed(cfg.seed)
    for _ in range(2):
        model(mine, deterministic=False, gen=gen, shard=DataShard(row0=row0, rows=sum(rows)))
    gathered = [None] * world
    dist.all_gather_object(gathered, seen)
    return {"seen": seen, "gathered": gathered}


def consensus(rank, world, out):
    """``coordinated_trigger`` before and after rank 1 is signalled, and the
    save's ``abort_barrier``."""
    from csat_tpu_torch.resilience.preemption import (
        PreemptionHandler, abort_barrier, coordinated_trigger)

    handler = PreemptionHandler()
    before = coordinated_trigger(handler)
    if rank == 1:
        handler.trigger()
    after = coordinated_trigger(handler)
    return {"before": before, "after": after, "latched": handler.triggered,
            "barrier": abort_barrier("preempt_save")}


def dp_fit(rank, world, out, payload):
    """A ``Trainer.fit`` of the payload's config on this rank's shard, with
    a checkpoint function that records its calls; with ``sigterm_at``, rank
    1 sends itself SIGTERM before that train step; with ``resume``, the run
    continues from its checkpoint directory.  → the history's step losses,
    the checkpoint calls, whether it stopped and where, and the final
    parameters."""
    import signal

    from csat_tpu_torch.data.dataset import ASTDataset
    from csat_tpu_torch.resilience.preemption import Preempted
    from csat_tpu_torch.train.checkpoint import make_checkpoint_fn
    from csat_tpu_torch.train.loop import Trainer

    cfg = payload["cfg"]
    tr = Trainer(cfg, log=lambda msg: None, device="cpu")
    train_ds = ASTDataset(cfg, "train", tr.src_vocab, tr.tgt_vocab)
    val_ds = ASTDataset(cfg, "dev", tr.src_vocab, tr.tgt_vocab)
    inner = make_checkpoint_fn(tr.output_dir)
    calls = []

    def ckpt(state, epoch):
        calls.append(epoch)
        inner(state, epoch)

    ckpt.directory = getattr(inner, "directory", None)
    if payload.get("sigterm_at") is not None and rank == 1:
        def scale(step):
            if step == payload["sigterm_at"]:
                os.kill(os.getpid(), signal.SIGTERM)
            return None
        tr.loss_scale_fn = scale
    stopped = None
    try:
        state, hist = tr.fit(train_ds, val_ds, checkpoint_fn=ckpt,
                             resume=payload.get("resume", False))
    except Preempted as p:
        stopped = (p.epoch, p.iterations_done)
        return {"stopped": stopped, "calls": calls, "plan": tr._plan_id()}
    return {"stopped": None, "calls": calls, "plan": tr._plan_id(),
            "steps": [(s["epoch"], s["it"], s["loss"]) for s in hist["steps"]],
            "val_bleu": hist["val_bleu"],
            "params": {k: p.detach().numpy().copy() for k, p in state.params.items()}}
