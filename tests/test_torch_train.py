"""The port's training slice against the JAX package on the CPU.

Same numpy inputs and the same (converted) weights through both packages;
the JAX Pallas kernels run in interpret mode, as tests/test_ops.py runs them.

* the config's training fields keep the JAX names and defaults;
* the ``sbm_sampled`` and ``sbm_graph`` mods under attention dropout 0.2:
  ``out`` and ``graph_sum`` within 1e-5 of JAX's ``flex_attention``
  (n = 70 > 64 crosses the CUDA block), the block-skip oracle equal;
* gradients through them (q, k, v, Q̂, K̂, S; the graph) within 3e-5 of
  JAX's kernel backward (``bwd="kernel"``) or reference backward — the
  tolerance of tests/test_ops.py:163;
* the STE and the weighted-softmax backward within 1e-6, exact where the
  math is;
* ``label_smoothing_loss`` within 1e-6 and one AdamW update within 1e-7 of
  optax's on identical gradients;
* one whole train step of the micro model (2 SBM layers, n up to 80) against
  JAX ``make_train_step`` with ``backend="pallas"``, ``noise_mode`` counter
  and shared: model dropout 0 (flax draws it from jax.random, which cannot be
  reproduced), attention dropout 0.2 from the shared hash stream, the
  per-layer seeds (and, shared, the uniform noise) handed to both packages.
  Loss and sparsity within 1e-5, every parameter's gradient within 3e-5,
  the updated parameters within 1e-5 (AdamW's first step is
  ``lr · g/(|g|·√(1−b2) + eps)``: a gradient near 0 amplifies its rounding
  up to ``lr/eps``-fold).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_train_step, train_setup
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

# one intra-op thread: the suite's workers share the host's cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

GRAD_TOL = 3e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def test_config_training_fields_match_jax():
    from csat_tpu.configs import Config as JConfig
    from csat_tpu_torch.configs import Config

    jdefaults = {f.name: f.default for f in dataclasses.fields(JConfig)}
    for f in dataclasses.fields(Config):
        assert f.name in jdefaults, f.name
        assert f.default == jdefaults[f.name], (f.name, f.default, jdefaults[f.name])
    for name in ("dropout", "attention_dropout", "noise_mode", "sbm_floor", "sw",
                 "learning_rate", "smoothing", "batch_size", "nonfinite_guard",
                 "compute_dtype", "init_scheme", "serve_kv_page_dtype"):
        assert name in {f.name for f in dataclasses.fields(Config)}, name
    # the precision fields' vocabularies are JAX's (the port also refuses a
    # compute dtype JAX would quietly take as f32)
    for field, good, bad in (("compute_dtype", "bfloat16", "float16"),
                             ("init_scheme", "reference", "xavier"),
                             ("serve_kv_page_dtype", "int8", "fp8")):
        Config(**{field: good}).validate()
        JConfig(**{field: good}).validate()
        with pytest.raises(AssertionError):
            Config(**{field: bad}).validate()


def _sbm_inputs(n, seed, b=2, h=3, dh=16, kk=4):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, dh)).astype(np.float32) for _ in range(3))
    q_hat, k_hat = (1 / (1 + np.exp(-2 * rng.standard_normal((b, h, n, kk))))
                    for _ in range(2))
    logits = rng.standard_normal((h, kk * kk))
    s_aff = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).reshape(h, kk, kk)
    key_pad = np.zeros((b, n), bool)
    key_pad[1, n // 2:] = True
    graph = (rng.random((b, h, n, n)) < 0.4).astype(np.float32)
    go = rng.standard_normal((b, h, n, dh)).astype(np.float32)
    f32 = lambda x: np.asarray(x, np.float32)
    return dict(q=q, k=k, v=v, q_hat=f32(q_hat), k_hat=f32(k_hat), s_aff=f32(s_aff),
                graph=graph, key_pad=key_pad, go=go)


def _mod(pkg, mod, leaves, key_pad):
    if pkg == "jax":
        from csat_tpu.ops import mods
        seed = jnp.int32(1234)
    else:
        from csat_tpu_torch.ops import mods
        seed = torch.tensor([1234], dtype=torch.int32)
    if mod == "sbm_sampled":
        return mods.sbm_sampled_mod(leaves["q_hat"], leaves["k_hat"], leaves["s_aff"],
                                    key_pad, seed)
    return mods.sbm_graph_mod(leaves["graph"], key_pad)


NAMES = {"sbm_sampled": ("q", "k", "v", "q_hat", "k_hat", "s_aff"),
         "sbm_graph": ("q", "k", "v", "graph")}


@pytest.mark.parametrize("mod", ["sbm_sampled", "sbm_graph"])
def test_train_mods_forward_and_grads_match_jax(mod):
    """Forward (out, graph_sum; dropout 0.2) within 1e-5 of JAX's kernel,
    the skip oracle equal, and gradients within 3e-5 of JAX's kernel
    backward (sampled) or reference backward (graph: the JAX mod has no
    kernel backward)."""
    from csat_tpu.ops import flex_core as jfc
    from csat_tpu_torch.ops import flex_core as tfc

    i = _sbm_inputs(70 if mod == "sbm_graph" else 140, seed=3)
    names = NAMES[mod]
    rate = 0.2

    def jloss(le):
        spec, aux = _mod("jax", mod, le, jnp.asarray(i["key_pad"]))
        out, ex = jfc.flex_attention(le["q"], le["k"], le["v"], spec, aux, rate,
                                     jnp.int32(777), bwd="kernel")
        return jnp.sum(out * i["go"]) + 1e-3 * jnp.sum(ex["graph_sum"]), (out, ex)

    (_, (j_out, j_ex)), j_grads = jax.value_and_grad(jloss, has_aux=True)(
        {n: jnp.asarray(i[n]) for n in names})
    leaves = {n: _t(i[n]).requires_grad_() for n in names}
    spec, aux = _mod("torch", mod, leaves, _t(i["key_pad"]))
    out, ex = tfc.flex_attention(leaves["q"], leaves["k"], leaves["v"], spec, aux, rate,
                                 torch.tensor([777], dtype=torch.int32))
    (torch.sum(out * _t(i["go"])) + 1e-3 * torch.sum(ex["graph_sum"])).backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ex["graph_sum"].detach().numpy(), np.asarray(j_ex["graph_sum"]),
                               atol=1e-5, rtol=0)
    j_spec, j_aux = _mod("jax", mod, {n: jnp.asarray(i[n]) for n in names},
                         jnp.asarray(i["key_pad"]))
    np.testing.assert_array_equal(
        tfc.reference_block_skip(spec, aux, tfc.geometry(out), block=128).numpy(),
        np.asarray(jfc.reference_block_skip(j_spec, j_aux, jfc.geometry(j_out))))
    for n in names:
        np.testing.assert_allclose(leaves[n].grad.numpy(), np.asarray(j_grads[n]),
                                   atol=GRAD_TOL, rtol=0, err_msg=n)


def test_ste_backward_matches_jax():
    from csat_tpu.models.ste import sample_graph as jsample
    from csat_tpu_torch.models.ste import sample_graph as tsample

    rng = np.random.default_rng(1)
    exp_a = rng.random((2, 3, 9, 9)).astype(np.float32) * 1.2 - 0.1
    noise = rng.random(exp_a.shape).astype(np.float32)
    g = (rng.standard_normal(exp_a.shape) * 2).astype(np.float32)
    a_j, vjp = jax.vjp(lambda e: jsample(e, jnp.asarray(noise), 0.01), jnp.asarray(exp_a))
    x = _t(exp_a).requires_grad_()
    a_t = tsample(x, _t(noise), 0.01)
    a_t.backward(_t(g))
    np.testing.assert_array_equal(a_t.detach().numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    assert float(x.grad.abs().max()) <= 1.0


@pytest.mark.parametrize("broadcast_w", [False, True])
def test_weighted_softmax_backward_matches_jax(broadcast_w):
    """Closed-form backward against JAX's ``_weighted_softmax`` vjp, with a
    dead row (all-zero weight) and a broadcast weight (the CSE gate)."""
    from csat_tpu.ops.flex_core import _weighted_softmax
    from csat_tpu_torch.ops.flex_core import _WeightedSoftmax

    rng = np.random.default_rng(2)
    s = rng.standard_normal((2, 3, 7, 11)).astype(np.float32) * 3
    w = (rng.random((1, 1, 1, 11)) if broadcast_w else
         rng.random(s.shape) * (rng.random(s.shape) < 0.6)).astype(np.float32)
    if not broadcast_w:
        w[0, 1, 2] = 0.0
    g = rng.standard_normal(s.shape).astype(np.float32)
    a_j, vjp = jax.vjp(_weighted_softmax, jnp.asarray(s), jnp.asarray(w))
    ds_j, dw_j = vjp(jnp.asarray(g))
    st, wt = _t(s).requires_grad_(), _t(w).requires_grad_()
    a_t, _ = _WeightedSoftmax.apply(st, wt)
    a_t.backward(_t(g))
    np.testing.assert_allclose(a_t.detach().numpy(), np.asarray(a_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(ds_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_j), atol=1e-5, rtol=1e-6)
    if not broadcast_w:
        assert not a_t[0, 1, 2].any()


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_label_smoothing_loss_matches_jax(smoothing):
    from csat_tpu.train.loss import label_smoothing_loss as jloss
    from csat_tpu_torch.train.loss import label_smoothing_loss as tloss

    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 6, 40)).astype(np.float32)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    target = rng.integers(1, 40, (3, 6))
    target[1, 3:] = 0  # PAD tail
    j = float(jloss(jnp.asarray(lp), jnp.asarray(target), smoothing))
    t = float(tloss(_t(lp), _t(target), smoothing))
    assert abs(t - j) <= 1e-6 * max(1.0, abs(j))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_update_matches_jax(weight_decay):
    """Three steps of the reference's AdamW (no bias correction, eps 1e-6,
    decoupled decay) on identical gradients: parameters and moments within
    1e-7."""
    import optax

    from csat_tpu.train.optimizer import adamw
    from csat_tpu_torch.train.optimizer import AdamW

    rng = np.random.default_rng(5)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal((7,)).astype(np.float32) * 1e-3}
    tx = adamw(1e-4, eps=1e-6, weight_decay=weight_decay)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    opt = AdamW(1e-4, eps=1e-6, weight_decay=weight_decay)
    tp = {k: _t(v) for k, v in params.items()}
    ts = opt.init(tp)
    for step in range(3):
        grads = {k: (rng.standard_normal(v.shape) * 10.0 ** -step).astype(np.float32)
                 for k, v in params.items()}
        grads["b"][0] = 0.0
        upd, js = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(tp, {k: _t(g) for k, g in grads.items()}, ts)
    assert ts.count == 3
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-7, rtol=0)
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]), atol=1e-7, rtol=0)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]), atol=1e-7, rtol=0)


# ---------------------------------------------------------------------------
# one whole train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["counter", "shared"])
def test_train_step_matches_jax(mode, monkeypatch):
    from csat_tpu_torch.convert import convert_params
    from csat_tpu_torch.train import create_train_state, default_optimizer, make_train_step

    (jcfg, tcfg, jmodel, params, tmodel, jbatch, tbatch,
     jdraws, tdraws) = train_setup(mode, monkeypatch)

    jstate, j_metrics, j_grads = jax_train_step(jcfg, jmodel, params, jbatch)
    assert not bool(j_metrics["nonfinite"])

    opt = default_optimizer(tcfg)
    state = create_train_state(tmodel, opt, seed=0)
    state, metrics = make_train_step(tmodel, opt, tcfg)(state, tbatch)
    assert tdraws.calls == {"sample": 2, "dropout": 2} if mode == "counter" else \
        tdraws.calls == {"noise": 2, "dropout": 2}
    assert state.step == 1 and not metrics["nonfinite"]

    for key in ("loss", "sparsity", "total"):
        assert abs(float(metrics[key]) - float(j_metrics[key])) <= 1e-5, key
    assert abs(float(metrics["grad_norm"]) / float(j_metrics["grad_norm"]) - 1) <= 1e-5
    g_want = convert_params(jax.device_get(j_grads), tmodel)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), g_want[name].numpy(), atol=GRAD_TOL,
                                   rtol=0, err_msg=name)
    p_want = convert_params(jax.device_get(jstate.params), tmodel)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), p_want[name].numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_guard_skips_a_nonfinite_step(monkeypatch):
    """A NaN loss scale poisons loss and gradients: the update is skipped,
    parameters and moments stay, and the bad-step counter rises."""
    from csat_tpu_torch.train import create_train_state, default_optimizer, make_train_step

    _, tcfg, _, _, tmodel, _, tbatch, _, _ = train_setup("counter", monkeypatch)
    opt = default_optimizer(tcfg)
    state = create_train_state(tmodel, opt, seed=0)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    state, m = make_train_step(tmodel, opt, tcfg)(state, tbatch, bad_steps=2,
                                                   loss_scale=float("nan"))
    assert m["nonfinite"] and m["bad_steps"] == 3 and state.opt_state.count == 0
    for k, p in state.params.items():
        assert torch.equal(p.detach(), before[k]), k
