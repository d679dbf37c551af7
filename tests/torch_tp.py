"""Rank workers of the port's tensor-parallel tests (tests/test_torch_tensor.py),
run by ``torch_dist.run_ranks``: each builds the payload's model from whole
weights, cuts it to its shard of the ``model`` axis and returns whole
(gathered) results as numpy.  Workers import no JAX."""

import numpy as np

from torch_dist import SRC_V, TGT_V, TRIP_V, fixed_seeds, rows_of


def _sharded_model(cfg, state_dict, mesh):
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.parallel.mesh import shard_model

    model = CSATrans(cfg, SRC_V, TGT_V, device="cpu", triplet_vocab_size=TRIP_V)
    model.load_state_dict(state_dict)
    return shard_model(model, mesh)


def _fixed_noise(noise):
    """The shared mode's noise of layer i handed out on its i-th draw (the
    whole batch's and heads', which each rank slices)."""
    import torch

    from csat_tpu_torch.models import sbm as tsbm

    calls = []

    def draw(gen, shape):
        calls.append(1)
        return torch.from_numpy(noise[(len(calls) - 1) % len(noise)])

    tsbm.bernoulli_noise = draw


def tp_step(rank, world, out, payload):
    """One train step of the payload's config on this rank's data shard and
    head shard, from its whole weights (``seeds``: the per-layer hash seeds
    handed over, ``noise``: the shared mode's per-layer noise, else the
    port's own draws) → the mesh, metrics, and the
    whole gradients and parameters after the update; with ``steps`` > 1
    that many steps' losses; with ``decode`` the greedy tokens of the
    rows; with ``checkpoint`` a state file of the step written under it."""
    import torch

    from csat_tpu_torch.parallel.mesh import build_mesh, gather_params
    from csat_tpu_torch.train import create_train_state, default_optimizer, make_train_step
    from csat_tpu_torch.train.checkpoint import save_state, whole_state
    from csat_tpu_torch.train.decode import greedy_decode

    cfg, batch = payload["cfg"], payload["batch"]
    if payload.get("seeds") is not None:
        fixed_seeds(payload["seeds"], cfg.sbm_layers)
    if payload.get("noise") is not None:
        _fixed_noise(payload["noise"])
    mesh = build_mesh(cfg.mesh_shape)
    b = batch.src_seq.shape[0] // mesh.data
    row0, _ = mesh.rows(b)
    mine = rows_of(batch, row0, row0 + b)
    model = _sharded_model(cfg, payload["state_dict"], mesh)
    opt = default_optimizer(cfg)
    state = create_train_state(model, opt, seed=0)
    step = make_train_step(model, opt, cfg, mesh)
    state, m = step(state, mine)
    res = {"mesh": mesh.shape,
           "metrics": {k: np.asarray(v.detach()) for k, v in m.items()},
           "grads": {n: g.numpy().copy() for n, g in gather_params(
               {n: p.grad for n, p in model.named_parameters()}, mesh).items()},
           "params": {n: p.numpy().copy() for n, p in gather_params(
               dict(model.named_parameters()), mesh).items()},
           "local": {n: tuple(p.shape) for n, p in model.named_parameters()}}
    losses = [float(m["loss"])]
    for _ in range(payload.get("steps", 1) - 1):
        state, m = step(state, mine)
        losses.append(float(m["loss"]))
    res["losses"] = losses
    if payload.get("decode"):
        gen = torch.Generator().manual_seed(5)
        res["tokens"] = greedy_decode(model, mine, gen, mesh.decode_shard(b)).numpy()
    if payload.get("checkpoint"):
        whole = whole_state(state, mesh)
        if rank == 0:
            save_state(payload["checkpoint"], whole, 1)
        res["gen_state"] = state.generator.get_state().numpy()
    return res


def tp_restore(rank, world, out, payload):
    """A state file restored into this rank's shards → the whole (gathered)
    parameters and moments it holds after the restore."""
    from csat_tpu_torch.parallel.mesh import build_mesh, gather_params
    from csat_tpu_torch.train import create_train_state, default_optimizer
    from csat_tpu_torch.train.checkpoint import restore_state

    cfg = payload["cfg"]
    mesh = build_mesh(cfg.mesh_shape)
    model = _sharded_model(cfg, payload["state_dict"], mesh)
    opt = default_optimizer(cfg)
    state = restore_state(payload["checkpoint"], create_train_state(model, opt, seed=0), 1, mesh)
    whole = lambda d: {n: t.numpy().copy() for n, t in gather_params(d, mesh).items()}
    return {"params": whole(state.params), "mu": whole(state.opt_state.mu),
            "nu": whole(state.opt_state.nu), "step": state.step}
