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


# ---------------------------------------------------------------------------
# the seq and pipe axes (tests/test_torch_ring.py, tests/test_torch_pipeline.py)
# ---------------------------------------------------------------------------

def ring_inputs(b, h, n, dh, kk, seed=0):
    """Seeded ring inputs (numpy f32): q, k, v, q_hat, k_hat, s_aff, pad
    (pad 1.0 on the last 5 keys of odd rows, 3 of even ones) and the
    cotangent of the output."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, dh)).astype(np.float32) for _ in range(3))
    q_hat, k_hat = (1.0 / (1.0 + np.exp(-2.0 * rng.standard_normal((b, h, n, kk))))
                    for _ in range(2))
    logits = rng.standard_normal((h, kk * kk))
    s_aff = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).reshape(h, kk, kk)
    pad = np.zeros((b, n), np.float32)
    for i in range(b):
        pad[i, n - (5 if i % 2 else 3):] = 1.0
    go = rng.standard_normal((b, h, n, dh)).astype(np.float32)
    return dict(q=q, k=k, v=v, q_hat=q_hat.astype(np.float32), k_hat=k_hat.astype(np.float32),
                s_aff=s_aff.astype(np.float32), pad=pad, go=go)


RING_NAMES = ("q", "k", "v", "q_hat", "k_hat", "s_aff")


def ring_rank(rank, world, out, payload):
    """This rank's block of the payload's inputs through the ring (one pass
    per case of ``payload["cases"]``: ``(rate, full)``), with the loss
    ``Σ out·go + gs_coef · Σ graph_sums / seq`` backpropagated → per case the
    output block, ``graph_sums`` rows and every input's gradient (numpy),
    and where the block sits."""
    import torch

    from csat_tpu_torch.parallel.mesh import build_mesh
    from csat_tpu_torch.parallel.ring import (
        node_block, ring_full_attention, ring_sbm_attention)

    mesh = build_mesh(payload["mesh_shape"])
    seq = mesh.axis("seq")
    arrs = payload["inputs"]
    b = arrs["q"].shape[0] // mesh.data
    r0 = mesh.coord("data") * b
    n0, nl = node_block(arrs["q"].shape[2], seq)
    h = arrs["q"].shape[1]
    sseed = torch.tensor([payload["seed"]], dtype=torch.int32)
    dseed = torch.tensor([payload["dseed"]], dtype=torch.int32)
    res = []
    for rate, full in payload["cases"]:
        t = {name: torch.tensor(arrs[name][r0:r0 + b, :, n0:n0 + nl] if name != "s_aff"
                                else arrs[name]).requires_grad_() for name in RING_NAMES}
        pad = torch.tensor(arrs["pad"][r0:r0 + b, n0:n0 + nl])
        go = torch.tensor(arrs["go"][r0:r0 + b, :, n0:n0 + nl])
        if full:
            o = ring_full_attention(t["q"], t["k"], t["v"], pad, seq, rate, dseed, r0 * h)
            gs = torch.zeros((b, h))
        else:
            o, gs = ring_sbm_attention(t["q"], t["k"], t["v"], t["q_hat"], t["k_hat"],
                                       t["s_aff"], pad, sseed, seq, rate, dseed,
                                       payload["floor"], r0 * h)
        loss = torch.sum(o * go) + payload["gs_coef"] * torch.sum(gs) / seq.size
        loss.backward()
        res.append(dict(out=o.detach().numpy(), gs=gs.detach().numpy(),
                        grads={n: (None if v.grad is None else v.grad.numpy())
                               for n, v in t.items()}))
    return dict(where=(r0, b, n0, nl), cases=res)


def mesh_step(rank, world, out, payload):
    """A greedy decode of the payload's config over its mesh (its data
    shard's rows of the global batch, at the initial parameters), then one
    train step of them (with ``reference``: the one-process pipeline
    reference of the mesh instead) → the tokens, metrics, every gradient and
    the parameters after the step."""
    import torch

    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.parallel.mesh import build_mesh, pipeline_reference_mesh
    from csat_tpu_torch.train import create_train_state, default_optimizer, make_train_step
    from csat_tpu_torch.train.decode import greedy_decode

    cfg, batch = payload["cfg"], payload["batch"]
    mesh = (pipeline_reference_mesh(cfg.mesh_shape) if payload.get("reference")
            else build_mesh(cfg.mesh_shape))
    b = batch.src_seq.shape[0] // mesh.data
    row0, _ = mesh.rows(b)
    mine = rows_of(batch, row0, row0 + b)
    model = CSATrans(cfg, SRC_V, TGT_V, device="cpu", triplet_vocab_size=TRIP_V)
    opt = default_optimizer(cfg)
    state = create_train_state(model, opt, seed=0)
    toks = greedy_decode(model, mine, torch.Generator().manual_seed(3), mesh.decode_shard(b))
    state, m = make_train_step(model, opt, cfg, mesh)(state, mine)
    return {"mesh": mesh.shape, "rows": (row0, b),
            "metrics": {k: np.asarray(v.detach()) for k, v in m.items()},
            "grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()},
            "params": {n: p.detach().numpy().copy() for n, p in model.named_parameters()},
            "tokens": toks.numpy()}


def gpipe_rank(rank, world, out, payload):
    """The payload's SBM blocks (``state_dict`` of a ``ModuleList``) as the
    wavefront over its mesh's ``pipe`` axis on this rank's data rows, the
    (layer, microbatch) seeds handed over, the cluster projection's dropout
    off; with ``remat`` each block recomputed in the backward.  Each rank
    backpropagates ``(Σ out·go + Σ sparsity·gsp) / pipe`` → its output rows,
    the sparsity, every block parameter's gradient and the input's."""
    from csat_tpu_torch.parallel.mesh import build_mesh

    return _gpipe_pass(payload, build_mesh(payload["cfg"].mesh_shape), "cpu")


def _gpipe_pass(payload, mesh, device):
    import torch

    from csat_tpu_torch.models import sbm as tsbm
    from csat_tpu_torch.models.components import remat
    from csat_tpu_torch.ops.hashrng import KeyedStream
    from csat_tpu_torch.parallel.mesh import DataShard
    from csat_tpu_torch.parallel.pipeline import gpipe_blocks

    tsbm.ClusterProj.dropout = 0.0
    cfg = payload["cfg"]
    pipe = mesh.axis("pipe")
    blocks = torch.nn.ModuleList(tsbm.SBMBlock(cfg, i) for i in range(cfg.sbm_layers))
    blocks.load_state_dict(payload["state_dict"])
    blocks.to(device)
    x_all, pad_all = payload["x"], payload["pad"]
    b = x_all.shape[0] // mesh.data
    r0, _ = mesh.rows(b)
    x = torch.tensor(x_all[r0:r0 + b], device=device).requires_grad_()
    pad = torch.tensor(pad_all[r0:r0 + b], device=device)
    det = payload["deterministic"]
    seeds = payload["seeds"]  # (2, L, M) int32: sample, dropout
    streams = [[KeyedStream(torch.tensor(seeds[0, l, m], device=device),
                            torch.tensor(seeds[1, l, m], device=device))
                for m in range(seeds.shape[2])] for l in range(seeds.shape[1])]

    def block_apply(l, xm, padm, stream):
        stream.set_state(0)
        shard = DataShard(row0=0, rows=xm.shape[0])
        if payload["remat"]:
            return remat(blocks[l], (stream,), xm, padm, det, stream, shard)
        return blocks[l](xm, padm, det, stream, shard)

    layers = cfg.sbm_layers
    mine = range(pipe.index * layers // pipe.size, (pipe.index + 1) * layers // pipe.size)
    params = [p for l in mine for p in blocks[l].parameters()]
    y, sp = gpipe_blocks(block_apply, params, x, pad, streams, seeds.shape[2], pipe, layers,
                         1, mesh.data)
    go = torch.tensor(payload["go"][r0:r0 + b], device=device)
    gsp = torch.tensor(payload["gsp"], device=device)
    loss = (torch.sum(y * go) + torch.sum(sp * gsp)) / pipe.size
    loss.backward()
    return {"rows": (r0, b), "out": y.detach().cpu().numpy(),
            "sparsity": sp.detach().cpu().numpy(),
            "grads": {n: (np.zeros(p.shape, np.float32) if p.grad is None
                          else p.grad.cpu().numpy()) for n, p in blocks.named_parameters()},
            "x_grad": x.grad.cpu().numpy()}


def card_collectives(rank, world, out):
    """The seq axis's collectives on CUDA tensors over gloo, every rank on
    ``cuda:0``: a cyclic two-tensor hop, a non-cyclic hop, an all-gather and
    a sum, with the loss ``Σ a·(rank+1) + Σ b + 3·Σ c + Σ g·w + Σ s``
    backpropagated → the outputs and the input gradients (numpy)."""
    import torch

    from csat_tpu_torch.parallel.collectives import all_gather_axis, ppermute, psum_axis
    from csat_tpu_torch.parallel.mesh import build_mesh

    torch.cuda.set_device(0)
    axis = build_mesh((("data", 1), ("seq", world))).axis("seq")
    dev = torch.device("cuda")
    x = (torch.arange(6.0, device=dev) + 10 * rank).reshape(2, 3).requires_grad_()
    y = torch.full((4,), float(rank), device=dev, requires_grad=True)
    a, b = ppermute((x, y), axis, 1)
    (c,) = ppermute((x,), axis, 1, cyclic=False)
    g = all_gather_axis(x, axis, 0)
    s = psum_axis(x, axis)
    w = torch.arange(float(g.numel()), device=dev).reshape(g.shape)
    loss = (torch.sum(a * (rank + 1)) + torch.sum(b) + 3 * torch.sum(c) + torch.sum(g * w)
            + torch.sum(s))
    loss.backward()
    on_card = all(t.is_cuda for t in (a, b, c, g, s, x.grad, y.grad))
    return {k: t.detach().cpu().numpy() for k, t in dict(a=a, b=b, c=c, g=g, s=s, x_grad=x.grad,
                                                         y_grad=y.grad).items()} | {
        "on_card": on_card}


def card_gpipe(rank, world, out, payload):
    """:func:`gpipe_rank` on ``cuda:0`` through the kernels, then through the
    plain path on the card (``flex_core.select_impl`` patched), with the
    kernels' launches counted in the first."""
    import torch

    from csat_tpu_torch.ops import build, flex_core
    from csat_tpu_torch.parallel.mesh import build_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = build_mesh(payload["cfg"].mesh_shape)
    build.reset_launches()
    kern = _gpipe_pass(payload, mesh, "cuda")
    kern["launches"] = build.launch_counts()
    select = flex_core.select_impl
    flex_core.select_impl = lambda t: "reference"
    try:
        plain = _gpipe_pass(payload, mesh, "cuda")
    finally:
        flex_core.select_impl = select
    return {"kernel": kern, "plain": plain}


def decode_rows(cfg, batch):
    """One process's greedy decode of ``batch`` at the initial parameters
    (the tokens :func:`mesh_step` decodes on a rank holding these rows)."""
    import torch

    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.train.decode import greedy_decode

    model = CSATrans(cfg, SRC_V, TGT_V, device="cpu", triplet_vocab_size=TRIP_V)
    return greedy_decode(model, batch, torch.Generator().manual_seed(3)).numpy()
