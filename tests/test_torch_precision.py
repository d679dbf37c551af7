"""The production precision against the JAX package: bf16 compute with f32
attention islands, bf16 / int8 KV pages, the reference initialisation.

At 2+2+2 layers, hidden 32, pegen 16, 2 heads, at the python (encoder 32,
pe 16) and the java (encoder 48, pe 8) width ratios, with converted weights
and numpy inputs shared by both packages:

* (a) the whole bf16 model — forward on the expected graph, its loss, its
  gradient — must satisfy ``err(port_bf16, jax_bf16) ≤ 0.5 · err(jax_f32,
  jax_bf16)`` (relative L2), which shows the casts fall where JAX's do, not
  merely that both are near f32.  JAX runs op by op (no ``jit``): each jnp
  operation then rounds its result to bf16 as the dtype semantics say,
  where XLA's fusion under ``jit`` keeps some intermediates in f32 on the
  CPU, so a jitted program's bits depend on its fusion.  bf16 rounding is
  chaotic: one f32 ulp of difference in an attention island flips a bf16
  rounding and spreads through the rest of the network.  So the attention
  islands (the CSE and SBM cores and the decoder's scores/softmax/·V) are
  JAX's own, spliced into the port through numpy, and held separately to
  their f32 tolerances by (b) and by the f32 parity tests;
* (b) each SBM layer's f32 island fed JAX's own bf16-derived q/k/v, in the
  counter and shared noise modes: 0 edges apart, output within 1e-5 and
  gradients within 3e-5 (the f32 step tests' limits);
* (c) two bf16 steps keep the master weights f32, decode gives valid ids;
* (d) greedy-decode tokens equal JAX's bf16 ``greedy_decode`` up to the first
  step whose top-2 log-prob gap (the port's) is under ``BF16_TIE`` = 0.05:
  JAX decodes under ``jit``, whose fused arithmetic rounds elsewhere, and a
  logit of a few units carries a bf16 ulp of about 1e-2, so a gap below
  0.05 may resolve either way;
* (e) ``quantize_kv`` bitwise equal to JAX's at f32, bf16 and int8, zero
  rows and exact .5 ties included;
* (f) the serving engine's tokens equal the JAX engine's for (compute,
  pages) = (f32, bf16), (f32, int8), (bf16, f32), up to a near tie: 1e-4
  at f32 compute (the card's own tie margin), ``BF16_TIE`` at bf16;
* (g) ``init_scheme="reference"``: against JAX's ``apply_reference_init``
  on the same flax-initialised tree the same leaves are redrawn, to the
  same bounds, every other leaf bit-equal; the port's own draw has the
  moments of U(±bound) and is deterministic in the seed;
* (h) one CLI fit with ``--set compute_dtype='bfloat16'`` and
  ``init_scheme='reference'``.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    TGT_V, configs, jax_model_and_params, request_samples, step_batch, torch_model,
    train_setup)
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

# one intra-op thread: the suite's workers share the host's cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = dict(num_layers=2, sbm_layers=2, decoder_layers=2, clusters=(4, 3), hidden_size=32,
             pegen_dim=16, num_heads=2, dim_feed_forward=64, max_src_len=80,
             bucket_src_lens=(), dropout=0.0)
WIDTHS = {"python": dict(sbm_enc_dim=32, pe_dim=16), "java": dict(sbm_enc_dim=48, pe_dim=8)}
RATIO = 0.5        # err(port_bf16, jax_bf16) over err(jax_f32, jax_bf16)
OUT_TOL, GRAD_TOL = 1e-5, 3e-5  # the f32 train-step tests' limits
BF16_TIE = 0.05
F32_TIE = 1e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# (a) the whole bf16 model, with JAX's attention islands spliced in
# ---------------------------------------------------------------------------

class _JaxIsland(torch.autograd.Function):
    """A JAX function of f32 arrays as a torch op on the CPU: forward and
    backward (``jax.vjp``) through numpy."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        out, ctx.vjp = jax.vjp(fn, *(jnp.asarray(t.detach().numpy()) for t in tensors))
        return tuple(torch.from_numpy(np.array(o, np.float32)) for o in out)

    @staticmethod
    def backward(ctx, *cts):
        grads = ctx.vjp(tuple(jnp.asarray(g.contiguous().numpy()) for g in cts))
        return (None, *(torch.from_numpy(np.array(g, np.float32)) for g in grads))


def _splice_jax_islands(monkeypatch, jcfg, tcfg):
    """The port's three f32 attention islands replaced by the JAX package's
    own (eager) evaluation of them on the same f32 inputs."""
    from csat_tpu.models import components as jcomp, sbm as jsbm
    from csat_tpu.ops.flex_core import flex_reference as jflex
    from csat_tpu.ops.mods import cse_mod as jcse_mod
    from csat_tpu_torch.models import components, cse, sbm

    def cse_island(q, k, v, spec, aux, *_):
        rel, mask = jnp.asarray(aux[2].numpy()), jnp.asarray(aux[3].numpy())
        fn = lambda q, k, v, lq, lk: (jflex(q, k, v, *jcse_mod(lq, lk, rel, mask))[0],)
        return _JaxIsland.apply(fn, q, k, v, aux[0], aux[1])[0], None

    def sbm_island(self, q, k, v, key_pad, deterministic=True, gen=None, shard=None):
        assert deterministic and tcfg.eval_graph == "expected" and shard is None
        h, dh = q.shape[1], q.shape[3]
        pad = jnp.asarray(key_pad.numpy())
        module = jsbm.SBMAttention(h, dh, self.kk, 0.0, backend="xla",
                                   floor=self.floor, eval_graph="expected")
        fcs = (self.proj.fc1, self.proj.fc2, self.proj.fc3)

        def fn(q, k, v, clusters, *ws):
            proj = {f"Dense_{i}": {"kernel": ws[2 * i].T, "bias": ws[2 * i + 1]}
                    for i in range(3)}
            out, sparsity, _, _ = module.apply(
                {"params": {"clusters": clusters, "ClusterProj_0": proj}}, q, k, v, pad, True)
            return out, sparsity

        return _JaxIsland.apply(fn, q, k, v, self.clusters,
                                *(t for fc in fcs for t in (fc.weight, fc.bias)))

    def mha_island(q, k, v, mask, rate=0.0, deterministic=True, gen=None, shard=None):
        assert (deterministic or rate == 0.0) and shard is None
        m = jnp.asarray(mask.numpy())

        def fn(q, k, v):
            scores = jnp.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
            return (jnp.einsum("bhqk,bhkd->bhqd", jcomp.masked_softmax(scores, m), v),)

        return _JaxIsland.apply(fn, *(t.to(torch.float32) for t in (q, k, v)))[0]

    monkeypatch.setattr(cse, "flex_attention", cse_island)
    monkeypatch.setattr(sbm.SBMAttention, "forward", sbm_island)
    monkeypatch.setattr(components, "attention", mha_island)


@pytest.mark.parametrize("name", ["python", "java"])
def test_bf16_model_matches_jax_bf16(name, monkeypatch):
    from csat_tpu.train.loss import label_smoothing_loss as jloss
    from csat_tpu.train.state import make_model as jmake
    from csat_tpu_torch.convert import convert_params
    from csat_tpu_torch.train.loss import label_smoothing_loss as tloss

    over = {**SMALL, **WIDTHS[name], "eval_graph": "expected"}
    params = None
    res = {}
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = configs(name, compute_dtype=dtype, **over)
        if params is None:
            params = jax_model_and_params(jcfg)[1]
        jmodel = jmake(jcfg, 200, TGT_V, 50)
        jb, tb = step_batch(jcfg, tcfg)

        def jfn(p):
            log_probs, sparsity, *_ = jmodel.apply({"params": p}, jb, deterministic=True)
            return jloss(log_probs, jb.target) + jcfg.sw * sparsity, log_probs

        (j_loss, j_lp), j_grads = jax.value_and_grad(jfn, has_aux=True)(
            jax.tree.map(jnp.asarray, params))
        j_grads = convert_params(jax.tree.map(np.asarray, j_grads))
        keys = sorted(j_grads)
        res["jax", dtype] = (np.asarray(j_lp), float(j_loss),
                             np.concatenate([j_grads[k].numpy().ravel() for k in keys]))
        if dtype == "bfloat16":
            with monkeypatch.context() as mp:
                _splice_jax_islands(mp, jcfg, tcfg)
                model = torch_model(tcfg, params)
                log_probs, sparsity = model(tb, deterministic=True)
                loss = tloss(log_probs, tb.target) + tcfg.sw * sparsity
                loss.backward()
            grads = dict(model.named_parameters())
            assert model.dtype == torch.bfloat16
            assert log_probs.dtype == torch.float32
            assert all(p.dtype == p.grad.dtype == torch.float32 for p in grads.values())
            res["port"] = (log_probs.detach().numpy(), float(loss),
                           np.concatenate([grads[k].grad.numpy().ravel() for k in keys]))
    for i, what in enumerate(("forward", "loss", "gradient")):
        j32, j16, port = res["jax", "float32"][i], res["jax", "bfloat16"][i], res["port"][i]
        bf16_effect = _rel(j32, j16)
        assert bf16_effect > 0, what
        assert _rel(port, j16) <= RATIO * bf16_effect, (what, _rel(port, j16), bf16_effect)


# ---------------------------------------------------------------------------
# (b) each SBM layer's f32 island on JAX's own bf16-derived q/k/v
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["counter", "shared"])
def test_sbm_island_on_jax_bf16_inputs(mode, monkeypatch):
    from csat_tpu.models import sbm as jsbm
    from csat_tpu_torch.convert import convert_params

    jcfg, tcfg, jmodel, params, tmodel, jb, _, jdraws, tdraws = train_setup(
        mode, monkeypatch, backend="xla", compute_dtype="bfloat16")
    assert tmodel.dtype == torch.bfloat16
    got = []
    inner = jsbm.SBMAttention.__call__

    def recorder(self, q, k, v, key_pad, deterministic=True, need_aux=False):
        got.append(tuple(np.asarray(t) for t in (q, k, v, key_pad)))
        return inner(self, q, k, v, key_pad, deterministic, need_aux)

    monkeypatch.setattr(jsbm.SBMAttention, "__call__", recorder)
    jmodel.apply({"params": jax.tree.map(jnp.asarray, params)}, jb, deterministic=False,
                 rngs={"dropout": jax.random.key(1), "sample": jax.random.key(2)})
    monkeypatch.setattr(jsbm.SBMAttention, "__call__", inner)
    assert len(got) == jcfg.sbm_layers
    rng = np.random.default_rng(9)
    for i, (q, k, v, key_pad) in enumerate(got):
        assert q.dtype == np.float32  # the island's inputs, cast from bf16
        b, h, n, dh = q.shape
        assert np.array_equal(q, np.asarray(jnp.asarray(q).astype(jnp.bfloat16)
                                            .astype(jnp.float32)))
        go = rng.standard_normal(q.shape).astype(np.float32)
        gs = rng.standard_normal((h,)).astype(np.float32)
        layer = params["encoder"][f"transformer_{i}"]["SBMAttention_0"]
        module = jsbm.SBMAttention(h, dh, jcfg.clusters[i], jcfg.attention_dropout,
                                   backend="xla", noise_mode=mode, floor=jcfg.sbm_floor,
                                   eval_graph=jcfg.eval_graph)

        def jfn(q, k, v, p):
            out, sparsity, _, _ = module.apply({"params": p}, q, k, v, key_pad, False,
                                               rngs={"sample": jax.random.key(3)})
            return jnp.sum(out * go) + jnp.sum(sparsity * gs), (out, sparsity)

        for draws in (jdraws, tdraws):
            draws.calls = {"sample": i, "dropout": i, "noise": i}
        (_, (j_out, j_sp)), j_g = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3), has_aux=True)(
            *(jnp.asarray(t) for t in (q, k, v)), jax.tree.map(jnp.asarray, layer))
        attn = tmodel.encoder.blocks[i].attn
        leaves = [torch.from_numpy(t.copy()).requires_grad_() for t in (q, k, v)]
        for p in attn.parameters():
            p.grad = None
        t_out, t_sp = attn(*leaves, torch.from_numpy(key_pad), False,
                           torch.Generator().manual_seed(0))
        (torch.sum(t_out * torch.from_numpy(go)) + torch.sum(t_sp * torch.from_numpy(gs))
         ).backward()
        edges = lambda sp: np.round(np.asarray(sp, np.float64) * b * n * n)
        assert np.array_equal(edges(t_sp.detach().numpy()), edges(j_sp)), (i, mode)
        np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), atol=OUT_TOL, rtol=0)
        for name, t, j in zip("qkv", leaves, j_g[:3]):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=GRAD_TOL, rtol=0,
                                       err_msg=f"layer {i} d{name}")
        j_params = convert_params(jax.tree.map(np.asarray, j_g[3]))
        for name, p in attn.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), j_params[name].numpy(), atol=GRAD_TOL,
                                       rtol=0, err_msg=f"layer {i} {name}")


# ---------------------------------------------------------------------------
# (c) master weights, (d) greedy decode
# ---------------------------------------------------------------------------

def test_bf16_steps_keep_f32_master_weights():
    from csat_tpu_torch.train import create_train_state, default_optimizer, make_train_step
    from csat_tpu_torch.train.decode import greedy_decode

    jcfg, tcfg = configs("python", compute_dtype="bfloat16", noise_mode="counter",
                         **{**SMALL, **WIDTHS["python"]})
    model = torch_model(tcfg, jax_model_and_params(jcfg)[1])
    _, batch = step_batch(jcfg, tcfg)
    opt = default_optimizer(tcfg)
    state = create_train_state(model, opt, 0)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    step = make_train_step(model, opt, tcfg)
    for _ in range(2):
        state, metrics = step(state, batch)
        assert np.isfinite(float(metrics["loss"])) and not metrics["nonfinite"]
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in state.params.values()), "master weights must stay f32"
    assert all(v.dtype == torch.float32 for v in state.opt_state.mu.values())
    moved = state.params["encoder.blocks.0.attn.clusters"]
    assert not torch.equal(moved, before["encoder.blocks.0.attn.clusters"])
    y = greedy_decode(model, batch)
    assert y.shape == batch.tgt_seq.shape and bool(((y >= 0) & (y < TGT_V)).all())


def _first_tie(gaps, margin):
    return next((i for i, g in enumerate(gaps) if g < margin), len(gaps))


def test_bf16_greedy_decode_matches_jax(monkeypatch):
    from csat_tpu.train.decode import greedy_decode as jdecode
    from csat_tpu.train.state import make_model as jmake
    from csat_tpu_torch.train import decode

    jcfg, tcfg = configs("python", compute_dtype="bfloat16", eval_graph="expected",
                         **{**SMALL, **WIDTHS["python"]})
    params = jax_model_and_params(jcfg)[1]
    jb, tb = step_batch(jcfg, tcfg, n_real=(75, 30, 80, 12, 60, 44, 7, 66))
    j_toks = np.asarray(jdecode(jmake(jcfg, 200, TGT_V, 50),
                                {"params": jax.tree.map(jnp.asarray, params)}, jb,
                                jax.random.key(0)))
    gaps = []
    inner = decode._decode_step

    def logged(*args):
        log_probs = inner(*args)
        top2 = torch.topk(log_probs, 2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).tolist())
        return log_probs

    monkeypatch.setattr(decode, "_decode_step", logged)
    t_toks = decode.greedy_decode(torch_model(tcfg, params), tb).numpy()
    compared = 0
    for row in range(t_toks.shape[0]):
        upto = _first_tie([g[row] for g in gaps], BF16_TIE)
        np.testing.assert_array_equal(t_toks[row, :upto], j_toks[row, :upto])
        compared += upto
    assert compared >= t_toks.size // 4, (compared, gaps)


# ---------------------------------------------------------------------------
# (e) quantize_kv, (f) the engine at each precision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_quantize_kv_bitwise_equal_to_jax(dtype):
    from csat_tpu.ops.paged_decode import quantize_kv as jquant
    from csat_tpu_torch.ops.paged_decode import quantize_kv as tquant
    from csat_tpu_torch.serve.pages import KV_PAGE_DTYPES

    rng = np.random.default_rng(3)
    x = (rng.standard_normal((6, 4, 16, 32)) * rng.uniform(1e-3, 30, (6, 4, 16, 1))
         ).astype(np.float32)
    x[0, 1, 2] = 0.0                       # all-zero rows: scale 1, values 0
    x[5, :, 7] = 0.0
    x[2, 3, 4, :8] = 127.0 * np.arange(8) / 127.0  # absmax 7: x/scale = 18.14·k
    x[3, 0, 0] = np.linspace(-127, 127, 32) / 127.0 * 2.0
    x[3, 0, 0, 5] = 2.0 * 63.5 / 127.0     # an exact .5 after the scale: half to even
    x[4, 2, 9] = -x[4, 2, 9]
    j_vals, j_scale = jquant(jnp.asarray(x), jnp.dtype(dtype))
    t_vals, t_scale = tquant(torch.from_numpy(x), KV_PAGE_DTYPES[dtype])
    assert t_vals.dtype == KV_PAGE_DTYPES[dtype] and t_scale.dtype == torch.float32
    np.testing.assert_array_equal(t_scale.numpy(), np.asarray(j_scale))
    np.testing.assert_array_equal(t_vals.to(torch.float32).numpy(),
                                  np.asarray(j_vals.astype(jnp.float32)))
    if dtype == "int8":
        assert float(t_scale[0, 1, 2, 0]) == 1.0 and not t_vals[0, 1, 2].any()


BUDGETS = [9, 3, 6, 9, 1, 5]


@pytest.mark.parametrize("compute,pages", [("float32", "bfloat16"), ("float32", "int8"),
                                           ("bfloat16", "float32")])
def test_engine_serves_jax_tokens_at_each_precision(compute, pages):
    from csat_tpu.serve.engine import ServeEngine as JServeEngine
    from csat_tpu.train.state import make_model as jmake
    from csat_tpu_torch.serve import ServeEngine

    jcfg, tcfg = configs(compute_dtype=compute, serve_kv_page_dtype=pages)
    params = jax_model_and_params(jcfg, seed=1)[1]
    samples = request_samples(jcfg, len(BUDGETS), seed=5, lo=2)
    jeng = JServeEngine(jmake(jcfg, 200, TGT_V, 50), params,
                        jcfg.replace(backend="pallas", serve_prefix_cache=0))
    try:
        j_ids = [jeng.submit(s, b) for s, b in zip(samples, BUDGETS)]
        jeng.drain()
        j_res = [jeng.poll(i) for i in j_ids]
    finally:
        jeng.close()

    model = torch_model(tcfg, params)
    log = []
    inner = model.decode_step

    def decode_step(tok, pos, caches, src_mask, prev_pad):
        log_probs, steps = inner(tok, pos, caches, src_mask, prev_pad)
        top2 = torch.topk(log_probs, 2, dim=-1).values
        log.append((pos.tolist(), (top2[:, 0] - top2[:, 1]).tolist()))
        return log_probs, steps

    model.decode_step = decode_step
    eng = ServeEngine(model, tcfg, device="cpu", clock=lambda: len(log))
    pool = eng._pool.pages[0]
    assert pool["k"].dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16,
                               "int8": torch.int8}[pages]
    assert pool["k_scale"].dtype == torch.float32
    ids = [eng.submit(s, b) for s, b in zip(samples, BUDGETS)]
    eng.drain()
    t_res = [eng.poll(i) for i in ids]
    assert eng.page_leaks() == 0
    margin = BF16_TIE if compute == "bfloat16" else F32_TIE
    compared = 0
    for t, j in zip(t_res, j_res):
        assert t.ok and j.ok
        gaps = []
        for step in range(len(t.tokens)):
            pos, gap = log[t.admit_t + step]
            assert pos[t.slot] == step
            gaps.append(gap[t.slot])
        upto = _first_tie(gaps, margin)
        np.testing.assert_array_equal(t.tokens[:upto], np.asarray(j.tokens)[:upto])
        if upto == len(gaps):
            assert len(t.tokens) == len(j.tokens)
        compared += upto
    assert compared >= sum(len(t.tokens) for t in t_res) // 2


# ---------------------------------------------------------------------------
# (g) the reference initialisation
# ---------------------------------------------------------------------------

def _flax_init(jcfg, seed=0):
    from csat_tpu.data.toy import random_request_sample
    from csat_tpu.serve.prefill import collate_requests
    from csat_tpu.train.state import make_model as jmake

    warm = collate_requests([random_request_sample(jcfg, 200, 50, 8, seed=0)],
                            jcfg.max_src_len, 1, jcfg, tgt_width=jcfg.max_tgt_len - 1)
    params = jmake(jcfg, 200, TGT_V, 50).init(
        {"params": jax.random.key(seed), "sample": jax.random.key(seed + 1)}, warm)["params"]
    return jax.tree.map(np.asarray, params)


def _jax_bound(path, leaf, tree):
    if path[-1] == "bias":
        return 1.0 / math.sqrt(
            np.shape(tree_get(tree, path[:-1])["kernel"])[0])
    d_in, d_out = leaf.shape
    return math.sqrt(6.0 / (d_in + 3 * d_out))


def tree_get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.mark.parametrize("name", ["python", "java"])
def test_reference_init_redraws_jax_leaves(name):
    from csat_tpu.models.init import apply_reference_init as japply
    from csat_tpu_torch.convert import _map_path, flatten, load_flax_params
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.models.init import apply_reference_init, reference_bound

    jcfg, tcfg = configs(name, **{**SMALL, **WIDTHS[name]})
    flax_tree = _flax_init(jcfg)
    redrawn = jax.tree.map(np.asarray, japply(jax.tree.map(jnp.asarray, flax_tree), 7))
    model = load_flax_params(CSATrans(tcfg, 200, TGT_V, device="cpu",
                                      triplet_vocab_size=50), flax_tree)
    apply_reference_init(model, 7)
    mine = dict(model.named_parameters())
    j_changed, t_changed = set(), set()
    for path, before in flatten(flax_tree).items():
        key, leaf = _map_path(path)
        after_j = flatten(redrawn)[path]
        after_t = mine[key].detach().numpy()
        after_t = after_t.T if leaf == "kernel" else after_t
        if not np.array_equal(after_j, before):
            j_changed.add(key)
            bound = _jax_bound(path, after_j, flax_tree)
            assert math.isclose(reference_bound(model, key), bound, rel_tol=1e-12), key
            for arr in (after_j, after_t):
                assert np.abs(arr).max() <= bound * (1 + 1e-6), key
        if not np.array_equal(after_t, before):
            t_changed.add(key)
        else:
            assert reference_bound(model, key) is None, key
    assert j_changed == t_changed and j_changed
    kinds = {k.rsplit(".", 1)[-1] for k in j_changed}
    assert kinds == {"bias", "weight"}
    assert {k for k in j_changed if k.endswith("weight")} == {
        k for k in mine if k.startswith("decoder.layers.") and k.endswith(
            (".q.weight", ".k.weight", ".v.weight"))}


def test_reference_init_draw_moments_and_determinism():
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.models.init import reference_bound

    _, tcfg = configs("python", **{**SMALL, **WIDTHS["python"]})
    ref = tcfg.replace(init_scheme="reference")
    model = CSATrans(ref, 200, TGT_V, device="cpu", triplet_vocab_size=50)
    again = CSATrans(ref, 200, TGT_V, device="cpu", triplet_vocab_size=50)
    other = CSATrans(ref, 200, TGT_V, device="cpu", seed=5, triplet_vocab_size=50)
    flax = CSATrans(tcfg, 200, TGT_V, device="cpu", triplet_vocab_size=50)
    flax_p = dict(flax.named_parameters())
    scaled = []
    for (name, p), (_, p2), (_, p3) in zip(model.named_parameters(), again.named_parameters(),
                                           other.named_parameters()):
        assert torch.equal(p, p2), name
        bound = reference_bound(model, name)
        if bound is None:
            assert torch.equal(p, flax_p[name]), name
            continue
        assert not torch.equal(p, p3), name
        assert float(p.abs().max()) <= bound
        scaled.append((p.detach() / bound).ravel())
    u = torch.cat(scaled).double()
    n = u.numel()
    assert n > 5000
    # U(-1, 1): mean 0 (sd 1/sqrt(3n)), E[u^2] = 1/3 (sd sqrt(4/45 / n)), E[u^4] = 1/5
    assert abs(float(u.mean())) < 5 / math.sqrt(3 * n)
    assert abs(float((u ** 2).mean()) - 1 / 3) < 5 * math.sqrt(4 / 45 / n)
    assert abs(float((u ** 4).mean()) - 1 / 5) < 0.01
    assert float(u.abs().max()) > 0.99


# ---------------------------------------------------------------------------
# (h) the command line in bf16
# ---------------------------------------------------------------------------

def test_cli_fits_in_bf16(tmp_path, capsys):
    from csat_tpu_torch.cli import main
    from csat_tpu_torch.data.synthetic import make_corpus

    data = str(tmp_path / "corpus")
    make_corpus(data, n_train=48, n_dev=8, n_test=8, seed=0, max_ast_len=48)
    capsys.readouterr()
    sets = dict(pe_dim=8, pegen_dim=16, sbm_enc_dim=32, hidden_size=32, num_heads=2,
                num_layers=1, sbm_layers=2, clusters=(4, 3), dim_feed_forward=64,
                decoder_layers=2, max_src_len=48, max_tgt_len=10, tree_pos_width=4,
                tree_pos_height=8, val_interval=1, save_interval=1,
                compute_dtype="bfloat16", init_scheme="reference",
                output_dir=str(tmp_path / "out"))
    args = ["--config", "python", "--data_dir", data, "--epochs", "1", "--batch_size", "8",
            "--device", "cpu"]
    for field, value in sets.items():
        args += ["--set", f"{field}={value!r}"]
    main(args)
    lines = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("epoch 1: loss=") for line in lines)
    scores = json.loads(lines[-1])
    assert set(scores) == {"val_best_bleu", "bleu", "rouge_l", "meteor"}
    assert all(np.isfinite(v) for v in scores.values())
    state = torch.load(next((tmp_path / "out").rglob("state_1.pt")), weights_only=False)
    tensors = [v for v in _tensors(state)]
    assert tensors and all(t.dtype != torch.bfloat16 for t in tensors)


def _tensors(obj):
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
