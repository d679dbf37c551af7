"""The long-AST configs (``python_long``, ``java_long``) on the CPU, against
the JAX package.

* the registry entries carry the JAX entries' fields (N 512, counter noise,
  remat, a ``("data", -1)`` mesh, ``seq_impl="ring"`` — a no-op without a
  ``seq`` axis, in both packages);
* one train step of a tiny model shaped like each (remat on, counter noise,
  N 160 > 128 so the hash stream's 128-row tile is crossed) in JAX
  (``backend="pallas"``, interpret mode, as its own tests run it) and in the
  port from the same converted weights, seeds and batch: the whole-step
  tolerances of tests/test_torch_train.py (loss and sparsity 1e-5, every
  gradient 3e-5, the updated parameters 1e-5);
* remat on against remat off in the port, with model dropout, attention
  dropout and (shared mode) the generator's graph noise all drawn: the
  recompute redraws them, so the loss is the same bits and every gradient
  within 1e-6;
* the hash stream at a batch·head offset is the slice of the global field,
  bit for bit (the plain path's ``uniform_field``, ``keep_field`` and the
  sampled mod's weight);
* serving at N 512: the page geometry funds 512-wide cross chains, the
  prefix cache keeps them whole, ``validate_sample`` takes 512 nodes and
  refuses 513, and the engine's tokens equal the non-paged greedy decode of
  the same model.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from torch_parity import (configs, jax_model_and_params, jax_train_step, request_samples,
                          step_batch, torch_model, train_setup)
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GRAD_TOL = 3e-5
LONG_N = 160           # past the hash stream's 128-row tile
N_REAL = (150, 40, 160, 90)
#: java's SBM width ratio: its encoder is 1.5 times the CSE width
WIDTHS = {"python_long": {}, "java_long": dict(sbm_enc_dim=48, pe_dim=16)}


@pytest.mark.parametrize("name", ["python_long", "java_long"])
def test_long_entries_carry_the_jax_fields(name):
    from csat_tpu.configs import get_config as jax_config
    from csat_tpu_torch.configs import get_config

    jcfg, tcfg = jax_config(name), get_config(name)
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert (tcfg.max_src_len, tcfg.noise_mode, tcfg.remat, tcfg.seq_impl) == (
        512, "counter", True, "ring")
    assert tcfg.mesh_shape == (("data", -1),)


def _long_setup(name, monkeypatch, **over):
    from csat_tpu_torch.models import sbm as tsbm

    draw = tsbm.draw_seed  # train_setup patches it; the remat test wants the real draws
    setup = train_setup("counter", monkeypatch, name=name, max_src_len=LONG_N,
                        **{**WIDTHS[name], **over})
    jcfg, tcfg = setup[0], setup[1]
    jbatch, tbatch = step_batch(jcfg, tcfg, n_real=N_REAL)
    return draw, setup, jbatch, tbatch


@pytest.mark.parametrize("name", ["python_long", "java_long"])
def test_long_step_matches_jax(name, monkeypatch):
    """The port steps first, drawing its seeds from its generator (each SBM
    block draws its sample and dropout seeds again when remat recomputes it
    in the backward: the same values); JAX is then handed those seeds."""
    import jax.numpy as jnp

    from csat_tpu.models import sbm as jsbm
    from csat_tpu_torch.convert import convert_params
    from csat_tpu_torch.models import sbm as tsbm
    from csat_tpu_torch.train import create_train_state, default_optimizer, make_train_step

    draw, setup, jbatch, tbatch = _long_setup(name, monkeypatch)
    jcfg, tcfg, jmodel, params, tmodel = setup[:5]
    assert jcfg.remat and tcfg.remat and tbatch.src_seq.shape == (4, LONG_N)
    drawn = []

    def recorded(gen, which):
        seed = draw(gen, which)
        drawn.append((which, int(seed)))
        return seed

    monkeypatch.setattr(tsbm, "draw_seed", recorded)
    opt = default_optimizer(tcfg)
    state = create_train_state(tmodel, opt, seed=0)
    state, metrics = make_train_step(tmodel, opt, tcfg)(state, tbatch)
    layers = tcfg.sbm_layers
    forward, again = drawn[:2 * layers], drawn[2 * layers:]
    # the backward recomputes the blocks last first, each drawing what its forward drew
    assert again == [d for i in reversed(range(layers)) for d in forward[2 * i:2 * i + 2]]
    seeds = {which: [v for n_, v in forward if n_ == which] for which in ("sample", "dropout")}
    calls = {}

    def handed(module, which):
        i = calls.get(which, 0)
        calls[which] = i + 1
        return jnp.int32(seeds[which][i % layers])

    monkeypatch.setattr(jsbm, "draw_counter_seed", handed)
    jstate, j_metrics, j_grads = jax_train_step(jcfg, jmodel, params, jbatch)
    assert not bool(j_metrics["nonfinite"]) and not bool(metrics["nonfinite"])
    for key in ("loss", "sparsity", "total"):
        assert abs(float(metrics[key]) - float(j_metrics[key])) <= 1e-5, key
    assert abs(float(metrics["grad_norm"]) / float(j_metrics["grad_norm"]) - 1) <= 1e-5
    g_want = convert_params(jax.device_get(j_grads), tmodel)
    for n, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), g_want[n].numpy(), atol=GRAD_TOL, rtol=0,
                                   err_msg=n)
    p_want = convert_params(jax.device_get(jstate.params), tmodel)
    for n, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), p_want[n].numpy(), atol=1e-5, rtol=0,
                                   err_msg=n)


def _grads_of(tcfg, params, tbatch, seed=7):
    from csat_tpu_torch.train import create_train_state, default_optimizer, make_train_step

    model = torch_model(tcfg, params)
    opt = default_optimizer(tcfg)
    state = create_train_state(model, opt, seed=seed)
    state, metrics = make_train_step(model, opt, tcfg)(state, tbatch)
    return metrics, {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("mode", ["counter", "shared"])
def test_remat_equals_no_remat(mode):
    """Every random draw on: model dropout and the cluster projection's
    (generator), attention dropout and, counter mode, the sampled graph (hash
    seeds from the generator), shared mode the graph noise (generator)."""
    jcfg, tcfg = configs("python_long", max_src_len=LONG_N, bucket_src_lens=(),
                         sbm_layers=2, clusters=(4, 3), dropout=0.2, noise_mode=mode,
                         eval_graph="sample",
                         seq_impl="ring" if mode == "counter" else "allgather")
    _, params = jax_model_and_params(jcfg, seed=3)
    _, tbatch = step_batch(jcfg, tcfg, n_real=N_REAL)
    m_on, g_on = _grads_of(tcfg, params, tbatch)
    m_off, g_off = _grads_of(tcfg.replace(remat=False), params, tbatch)
    assert torch.equal(m_on["loss"], m_off["loss"])
    assert torch.equal(m_on["sparsity"], m_off["sparsity"])
    for n in g_on:
        assert (g_on[n] - g_off[n]).abs().max().item() <= 1e-6, n


@pytest.mark.parametrize("b0,h", [(1, 4), (3, 8), (70000, 2)])
def test_hash_stream_offset_is_the_global_slice(b0, h):
    from csat_tpu_torch.ops.flex_core import keep_field
    from csat_tpu_torch.ops.hashrng import noise_stride, uniform_field
    from csat_tpu_torch.ops.mods import exp_adjacency, sbm_sampled_mod

    n, b = LONG_N, 2
    stride = noise_stride(n)
    seed = torch.tensor([123457], dtype=torch.int32)
    glob = uniform_field(seed, b0 + b, h, n, n, stride) if b0 < 100 else None
    part = uniform_field(seed, b, h, n, n, stride, bh0=b0 * h)
    if glob is not None:
        assert torch.equal(part, glob[b0:])
        assert torch.equal(keep_field(seed, b, h, n, stride, 0.2, bh0=b0 * h),
                           keep_field(seed, b0 + b, h, n, stride, 0.2)[b0:])
    else:  # a large offset: the rows one at a time
        for i in range(b):
            one = uniform_field(seed, 1, h, n, n, stride, bh0=(b0 + i) * h)
            assert torch.equal(part[i:i + 1], one)
    # the sampled mod's graph at the offset: drawn from that slice
    rng = np.random.default_rng(b0)
    kk = 3
    q_hat = torch.from_numpy(rng.random((b, h, n, kk), dtype=np.float32))
    k_hat = torch.from_numpy(rng.random((b, h, n, kk), dtype=np.float32))
    s_aff = torch.softmax(torch.from_numpy(rng.standard_normal((h, kk * kk))).float(),
                          -1).reshape(h, kk, kk)
    pad = torch.zeros((b, n), dtype=torch.bool)
    spec, aux = sbm_sampled_mod(q_hat, k_hat, s_aff, pad, seed, bh0=b0 * h)
    p = torch.clamp(exp_adjacency(aux[0], aux[1]), spec.floor, 0.99)
    assert spec.bh0 == b0 * h
    assert torch.equal(spec.full_weight(None, None, aux)[0], (part < p).float())
    at_zero, _ = sbm_sampled_mod(q_hat, k_hat, s_aff, pad, seed)
    assert not torch.equal(at_zero.full_weight(None, None, aux)[0], (part < p).float())


def test_serving_at_n512():
    """A tiny model shaped like python_long serves requests of 300 to 512
    nodes on the CPU: cross chains of 512 / page pages, the prefix cache's
    entries keep them whole, the pool funds every slot's worst case, the
    tokens equal the non-paged greedy decode of the same model."""
    from csat_tpu_torch.data.dataset import batch_to_device
    from csat_tpu_torch.serve import RequestStatus, ServeEngine
    from csat_tpu_torch.serve.ingest import PoisonRequestError, validate_sample
    from csat_tpu_torch.serve.pages import page_geometry
    from csat_tpu_torch.serve.prefill import collate_requests
    from csat_tpu_torch.train.decode import greedy_decode

    jcfg, tcfg = configs("python_long", max_src_len=512, bucket_src_lens=(), serve_slots=2,
                         max_tgt_len=6)
    _, params = jax_model_and_params(jcfg, seed=4)
    model = torch_model(tcfg, params)
    geo = page_geometry(tcfg)
    assert geo.mem_len == 512 and geo.cp == 512 // tcfg.serve_page_size
    assert geo.usable == tcfg.serve_slots * (geo.sp + geo.cp)
    samples = request_samples(jcfg, 3, seed=9, lo=300)
    assert all(300 <= int(s["num_node"]) <= 512 for s in samples)
    for s in samples:
        validate_sample(s, tcfg)
    big = max(samples, key=lambda s: int(s["num_node"]))
    validate_sample(dict(big, num_node=np.int32(512)), tcfg)
    with pytest.raises(PoisonRequestError):
        validate_sample(dict(big, num_node=np.int32(513)), tcfg)

    eng = ServeEngine(model, tcfg, device="cpu")
    ids = [eng.submit(s, 5) for s in samples]
    eng.drain()
    res = [eng.poll(i) for i in ids]
    assert all(r.status == RequestStatus.OK for r in res)
    assert eng.page_leaks() == 0
    cache = eng._prefix
    # entries beyond what the pool keeps beside two worst-case slots are evicted
    assert len(cache) >= 1
    assert cache.pinned_pages == len(cache) * geo.cross_pages(512)
    batch = collate_requests(samples, 512, tcfg)
    steps = np.zeros((len(samples), tcfg.max_tgt_len - 1), np.int32)  # the decode budget
    batch = batch._replace(tgt_seq=steps, target=steps)
    with torch.no_grad():
        want = greedy_decode(model, batch_to_device(batch, torch.device("cpu")))
    for r, w in zip(res, want):
        np.testing.assert_array_equal(np.asarray(r.tokens), w[:len(r.tokens)].numpy())
