"""The port's plain op paths against the JAX package on the same inputs.

* flex attention under the ``cse`` and ``sbm_expected`` mods: the port's
  ``flex_reference`` against JAX ``flex_attention`` (Pallas interpret mode)
  and ``flex_reference``.  ``out`` and ``graph_sum`` within 1e-5 — JAX's own
  kernel-vs-reference gate is 2e-6 (tests/test_ops.py); the margin covers
  torch's CPU summation order.  ``reference_block_skip`` at block 128 equals
  JAX's oracle and the JAX kernel's realized count.  The CSE mod also on
  real ASTs' distances and masks (the inputs of the card's K1 cases: a
  T-plane-only tile, all-masked rows, a sample whose key tiles are padding).
* the expected mod's backward (the plain version of the ``flex_bwd_*_sbm_expected``
  kernels): dq, dk, dv, dR, dK̂ within 3e-5 of ``jax.grad`` through JAX's
  kernel backward (``bwd="kernel"``, interpret mode), at attention dropout 0
  and 0.2, with padded keys, and with exact ties of R·K̂ᵀ at both clip bounds
  (``jnp.clip`` passes half the gradient at a tie; ``torch.clamp`` would pass
  all of it).
* paged decode attention, self and cross: within 1e-6 on live rows at f32
  storage and 1e-5 at bf16/int8, skip counts exactly equal, and ``quantize_kv``
  int8 values and scales bit-equal (round half to even).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

# one intra-op thread: the suite's workers share the host's cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, H, DH, R = 2, 4, 8, 40


def _t(x):
    return torch.from_numpy(np.array(x))


def _cse_inputs(n, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, n, DH)).astype(np.float32) for _ in range(3))
    lq, lk = (rng.standard_normal((H, R, DH)).astype(np.float32) for _ in range(2))
    rel = rng.integers(0, R, (B, 2, n, n)).astype(np.int32)  # not symmetric
    mask = rng.random((B, 2, n, n)) < 0.3
    n_real = n - 5
    mask[:, :, :, n_real:] = True   # padded keys: raw distance 0
    mask[:, :, n_real:, :] = True
    mask[:, 0, 3, :] = True         # an all-masked row (uniform quirk)
    mask[1, 1, 7, :] = True
    return q, k, v, lq, lk, rel, mask


def _sbm_inputs(n, seed, kk=5):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, n, DH)).astype(np.float32) for _ in range(3))
    q_hat, k_hat = (rng.random((B, H, n, kk)).astype(np.float32) for _ in range(2))
    logits = rng.standard_normal((H, kk * kk)).astype(np.float32)
    s_aff = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).reshape(H, kk, kk)
    key_pad = np.zeros((B, n), bool)
    key_pad[0, n - 7:] = True
    key_pad[1, n - 2:] = True
    return q, k, v, q_hat, k_hat, s_aff, key_pad


def _both(mod, n, seed):
    """(JAX outputs of kernel + reference, port outputs) for one mod."""
    from csat_tpu.ops import flex_core as jfc
    from csat_tpu.ops import mods as jmods
    from csat_tpu_torch.ops import flex_core as tfc
    from csat_tpu_torch.ops import mods as tmods

    if mod == "cse":
        q, k, v, lq, lk, rel, mask = _cse_inputs(n, seed)
        jspec, jaux = jmods.cse_mod(jnp.asarray(lq), jnp.asarray(lk),
                                    jnp.asarray(rel), jnp.asarray(mask))
        tspec, taux = tmods.cse_mod(_t(lq), _t(lk), _t(rel), _t(mask))
    else:
        q, k, v, q_hat, k_hat, s_aff, key_pad = _sbm_inputs(n, seed)
        jspec, jaux = jmods.sbm_expected_mod(jnp.asarray(q_hat), jnp.asarray(k_hat),
                                             jnp.asarray(s_aff), jnp.asarray(key_pad))
        tspec, taux = tmods.sbm_expected_mod(_t(q_hat), _t(k_hat), _t(s_aff), _t(key_pad))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    j_kernel = jfc.flex_attention(jq, jk, jv, jspec, jaux)
    j_ref = jfc.flex_reference(jq, jk, jv, jspec, jaux)
    j_skip = jfc.reference_block_skip(jspec, jaux, jfc.geometry(jq))
    t_out, t_ex = tfc.flex_attention(_t(q), _t(k), _t(v), tspec, taux)
    t_skip = tfc.reference_block_skip(tspec, taux, tfc.geometry(_t(q)), block=128)
    return j_kernel, j_ref, j_skip, (t_out, t_ex), t_skip, (tspec, taux, _t(q))


@pytest.mark.parametrize("mod", ["cse", "sbm_expected"])
@pytest.mark.parametrize("n", [20, 40])
def test_flex_matches_jax(mod, n):
    j_kernel, j_ref, j_skip, (t_out, t_ex), t_skip, _ = _both(mod, n, seed=n)
    for j_out, j_ex in (j_kernel, j_ref):
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5, rtol=0)
        np.testing.assert_allclose(t_ex["graph_sum"].numpy(), np.asarray(j_ex["graph_sum"]),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t_skip.numpy(), np.asarray(j_skip))
    np.testing.assert_array_equal(t_skip.numpy(), np.asarray(j_kernel[1]["skipped_blocks"]))
    assert np.isfinite(t_out.numpy()).all()


def test_cse_all_masked_row_is_uniform_over_real_columns():
    """A CSE row whose every column is masked attends uniformly over the N
    real columns (-1e9 fills a LIVE entry), never NaN."""
    from csat_tpu_torch.ops import flex_core as tfc
    from csat_tpu_torch.ops import mods as tmods

    q, k, v, lq, lk, rel, mask = _cse_inputs(20, seed=3)
    spec, aux = tmods.cse_mod(_t(lq), _t(lk), _t(rel), _t(mask))
    out, _ = tfc.flex_attention(_t(q), _t(k), _t(v), spec, aux)
    np.testing.assert_allclose(out[0, 0, 3].numpy(), v[0, 0].mean(0), atol=1e-6)


def _ast_cse_inputs(n, variant, seed):
    """CSE inputs on the distances and masks of synthetic ASTs (most entries
    masked, the unmasked distances in a band), with the same edits as the
    card test's K1 cases: ``t_only`` leaves a few T-plane entries of one
    tile unmasked and nothing else; ``empty_row`` masks every column of
    three rows; ``pad_tile`` cuts sample 0 to 10 nodes."""
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.dataset import collate
    from csat_tpu_torch.data.synthetic import random_ast, train_sample

    cfg = get_config("python")
    rng = np.random.default_rng(seed)
    sizes = [10 if variant == "pad_tile" else n - 9, n]
    samples = [train_sample(random_ast(rng, m), cfg, 100, 100, rng) for m in sizes]
    batch = collate({key: np.stack([x[key] for x in samples]) for key in samples[0]},
                    cfg.max_src_len)
    rel = np.stack([batch.L, batch.T], 1)[:, :, :n, :n].astype(np.int32)
    mask = np.stack([batch.L_mask, batch.T_mask], 1)[:, :, :n, :n].copy()
    if variant == "t_only":
        mask[:] = True
        mask[0, 1, 7, [3, 5, 20]] = False
        mask[1, 1, 30, 0] = False
    elif variant == "empty_row":
        mask[0, 0, 1, :] = True
        mask[1, 1, n - 1, :] = True
        mask[0, 1, 16, :] = True
    q, k, v = (rng.standard_normal((B, H, n, DH)).astype(np.float32) for _ in range(3))
    lq, lk = (rng.standard_normal((H, cfg.max_src_len, DH)).astype(np.float32)
              for _ in range(2))
    return q, k, v, lq, lk, rel, mask


@pytest.mark.parametrize("variant", ["ast", "t_only", "empty_row", "pad_tile"])
def test_cse_on_ast_distances_matches_jax(variant):
    """The CSE mod's plain path — the oracle the card holds K1 to — against
    JAX's kernel (interpret mode) and reference on real ASTs' distances and
    masks: the inputs of the card test's K1 cases at a small width.  Every
    all-masked row is the mean of V over the real columns on both sides."""
    from csat_tpu.ops import flex_core as jfc
    from csat_tpu.ops import mods as jmods
    from csat_tpu_torch.ops import flex_core as tfc
    from csat_tpu_torch.ops import mods as tmods

    n = 40
    q, k, v, lq, lk, rel, mask = _ast_cse_inputs(n, variant, seed=11)
    jspec, jaux = jmods.cse_mod(*(jnp.asarray(x) for x in (lq, lk, rel, mask)))
    tspec, taux = tmods.cse_mod(*(_t(x) for x in (lq, lk, rel, mask)))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    t_out, t_ex = tfc.flex_attention(_t(q), _t(k), _t(v), tspec, taux)
    for j_out, j_ex in (jfc.flex_attention(jq, jk, jv, jspec, jaux),
                        jfc.flex_reference(jq, jk, jv, jspec, jaux)):
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5, rtol=0)
        np.testing.assert_allclose(t_ex["graph_sum"].numpy(), np.asarray(j_ex["graph_sum"]),
                                   rtol=1e-5, atol=1e-5)
    empty = np.repeat(mask.all(-1), H // 2, axis=1)  # (B, H, N)
    assert empty.any()  # padded rows at least
    np.testing.assert_allclose(t_out.numpy()[empty],
                               np.broadcast_to(v.mean(2)[:, :, None], v.shape)[empty], atol=1e-5)
    skips = tfc.reference_block_skip(tspec, taux, tfc.geometry(_t(q)))
    assert int(skips.sum()) == 0  # the CSE weight is the real gate: no tile is dead


def test_sbm_block_skip_at_kernel_block_counts_padding():
    """At the CUDA kernel's block (64) a fully padded key tile is dead: the
    oracle counts exactly the (q-tile, dead k-tile) pairs."""
    from csat_tpu_torch.ops import flex_core as tfc
    from csat_tpu_torch.ops import mods as tmods

    n = 100
    q, k, v, q_hat, k_hat, s_aff, key_pad = _sbm_inputs(n, seed=5)
    key_pad[0, 60:] = True   # row 0: keys 64.. all padded → k-tile 1 dead
    spec, aux = tmods.sbm_expected_mod(_t(q_hat), _t(k_hat), _t(s_aff), _t(key_pad))
    skip = tfc.reference_block_skip(spec, aux, tfc.geometry(_t(q)), block=tfc.FLEX_BLOCK)
    assert skip[0].tolist() == [2.0] * H and skip[1].tolist() == [0.0] * H
    assert tfc.num_blocks(n) == 4


def _expected_bwd_inputs(n, seed, ties, floor, b=2, h=3, dh=16, kk=4):
    rng = np.random.default_rng(seed)
    q, k, v = (0.5 * rng.standard_normal((b, h, n, dh)).astype(np.float32) for _ in range(3))
    r = (rng.random((b, h, n, kk)) * 0.6).astype(np.float32)
    kh = (rng.random((b, h, n, kk)) * 0.8).astype(np.float32)
    key_pad = np.zeros((b, n), bool)
    key_pad[1, n // 2:] = True
    if ties:
        kh[:, :, 3] = 0.0           # column 3: R·K̂ᵀ == 0 on every row
        kh[:, :, 5] = 0.0
        kh[:, :, 5, 0] = 1.0        # column 5: R·K̂ᵀ == R[..., 0]
        r[:, :, 7] = 0.0
        r[:, :, 7, 0] = 0.99        # entry (7, 5) == .99, the upper bound
        r[:, :, 8] = 0.0
        r[:, :, 8, 0] = floor       # entry (8, 5) == floor, the lower bound
        r[:, :, 9] = 0.0            # row 9 all 0: a dead row when floor is 0
    go = rng.standard_normal((b, h, n, dh)).astype(np.float32)
    return dict(q=q, k=k, v=v, r=r, kh=kh), key_pad, go


def test_clip_gradient_at_ties_matches_jax():
    """Half the gradient where x equals a bound, as ``jnp.clip`` gives."""
    import jax

    from csat_tpu_torch.ops.mods import clip

    x = np.asarray([-1.0, 0.0, 0.005, 0.01, 0.5, 0.99, 1.5], np.float32)
    for lo in (0.0, 0.01):
        want = jax.grad(lambda a: jnp.sum(3.0 * jnp.clip(a, lo, 0.99)))(jnp.asarray(x))
        xt = _t(x).requires_grad_()
        (3.0 * clip(xt, lo, 0.99)).sum().backward()
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
        np.testing.assert_array_equal(clip(xt, lo, 0.99).detach().numpy(),
                                      np.asarray(jnp.clip(jnp.asarray(x), lo, 0.99)))
    assert xt.grad.tolist() == [0.0, 0.0, 0.0, 1.5, 3.0, 1.5, 0.0]


@pytest.mark.parametrize("n,rate,floor,ties", [
    (70, 0.0, 0.01, False), (140, 0.2, 0.01, False), (70, 0.2, 0.01, True),
    (70, 0.0, 0.0, True), (140, 0.2, 0.0, True)])
def test_expected_backward_matches_jax_kernel(n, rate, floor, ties):
    import jax

    from csat_tpu.ops import flex_core as jfc
    from csat_tpu.ops import mods as jmods
    from csat_tpu_torch.ops import flex_core as tfc
    from csat_tpu_torch.ops import mods as tmods

    le, key_pad, go = _expected_bwd_inputs(n, seed=n, ties=ties, floor=floor)
    h, kk = le["r"].shape[1], le["r"].shape[3]
    eye = np.broadcast_to(np.eye(kk, dtype=np.float32), (h, kk, kk)).copy()  # R = Q̂

    def jloss(l):
        spec, aux = jmods.sbm_expected_mod(l["r"], l["kh"], jnp.asarray(eye),
                                           jnp.asarray(key_pad), floor=floor)
        out, ex = jfc.flex_attention(l["q"], l["k"], l["v"], spec, aux, rate,
                                     jnp.int32(777), bwd="kernel")
        return jnp.sum(out * go) + 1e-3 * jnp.sum(ex["graph_sum"]), out

    (_, j_out), j_grads = jax.value_and_grad(jloss, has_aux=True)(
        {key: jnp.asarray(val) for key, val in le.items()})
    leaves = {key: _t(val).requires_grad_() for key, val in le.items()}
    spec, aux = tmods.sbm_expected_mod(leaves["r"], leaves["kh"], _t(eye), _t(key_pad),
                                       floor=floor)
    out, ex = tfc.flex_attention(leaves["q"], leaves["k"], leaves["v"], spec, aux, rate,
                                 torch.tensor([777], dtype=torch.int32))
    (torch.sum(out * _t(go)) + 1e-3 * torch.sum(ex["graph_sum"])).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=1e-5, rtol=0)
    if ties:
        ea = tmods.exp_adjacency(leaves["r"], leaves["kh"]).detach()
        assert (ea == 0.99).any() and (ea == np.float32(floor)).any() and (ea == 0).any()
    for key in le:
        assert np.abs(np.asarray(j_grads[key])).max() > 1e-3, key
        np.testing.assert_allclose(leaves[key].grad.numpy(), np.asarray(j_grads[key]),
                                   atol=3e-5, rtol=0, err_msg=key)


@pytest.mark.parametrize("floor", [0.01, 0.0])
def test_expected_backward_matches_closed_form_at_ties(floor):
    """The plain backward against the smoke script's float64 closed form,
    which is written from the mod's definition and shares no code with
    ``flex_reference``: at ``floor == 0`` a tie at the lower bound is a
    weight of exactly 0 whose gradient factor is ``e^{s - lse}``."""
    import chip_smoke

    from csat_tpu_torch.ops import flex_core as tfc
    from csat_tpu_torch.ops import mods as tmods

    le, key_pad, go = _expected_bwd_inputs(70, seed=9, ties=True, floor=floor)
    h, kk = le["r"].shape[1], le["r"].shape[3]
    eye = _t(np.broadcast_to(np.eye(kk, dtype=np.float32), (h, kk, kk)).copy())
    leaves = {key: _t(val).requires_grad_() for key, val in le.items()}
    spec, aux = tmods.sbm_expected_mod(leaves["r"], leaves["kh"], eye, _t(key_pad), floor=floor)
    out, ex = tfc.flex_attention(leaves["q"], leaves["k"], leaves["v"], spec, aux)
    (torch.sum(out * _t(go)) + 1e-3 * torch.sum(ex["graph_sum"])).backward()
    with torch.no_grad():
        closed = chip_smoke.expected_closed_form(
            leaves["q"], leaves["k"], leaves["v"], aux, floor, _t(go), 1e-3)
    live = closed["live_rows"]
    assert bool((~live).any()) == (floor == 0.0)  # row 9 is dead only at floor 0
    np.testing.assert_allclose(out.detach()[live].numpy(), closed["out"][live].numpy(), atol=1e-5)
    np.testing.assert_allclose(ex["lse"][live].numpy(), closed["lse"][live].numpy(), atol=1e-5)
    for key, name in (("q", "dq"), ("k", "dk"), ("v", "dv"), ("r", "dr"), ("kh", "dkh")):
        assert closed[name].abs().max() > 1e-3, name
        np.testing.assert_allclose(leaves[key].grad.numpy(), closed[name].numpy(),
                                   atol=3e-5, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

S, NP, PAGE, NB = 4, 16, 4, 5


def _paged_inputs(dtype_name, seed):
    from csat_tpu.ops.paged_decode import quantize_kv as jquant

    rng = np.random.default_rng(seed)
    raw_k, raw_v = (rng.standard_normal((NP, H, PAGE, DH)).astype(np.float32) for _ in range(2))
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[dtype_name]
    (pk, sk), (pv, sv) = jquant(jnp.asarray(raw_k), jdt), jquant(jnp.asarray(raw_v), jdt)
    table = np.zeros((S, NB), np.int32)  # ragged chains, NULL beyond
    ids = rng.permutation(np.arange(1, NP))
    lens = [5, 3, 1, 4]
    at = 0
    for s, ln in enumerate(lens):
        table[s, :ln] = ids[at:at + ln]
        at += ln
    width = 18
    mask = np.zeros((S, width), bool)
    for s, ln in enumerate(lens):
        mask[s, min(ln * PAGE, width):] = True
    mask[1, 2] = True
    mask[3, :] = True  # a frozen row: fully masked, compared nowhere
    q = rng.standard_normal((S, H, 1, DH)).astype(np.float32)
    idx = np.asarray([6, 9, 2, 0], np.int32)
    k_tok, v_tok = (rng.standard_normal((S, H, 1, DH)).astype(np.float32) for _ in range(2))
    return (pk, pv, sk, sv), table, mask, width, q, idx, k_tok, v_tok


def _to_torch_pages(x):
    arr = np.asarray(jnp.asarray(x, jnp.float32))
    if x.dtype == jnp.bfloat16:
        return _t(arr).to(torch.bfloat16)
    return _t(arr).to(torch.int8) if x.dtype == jnp.int8 else _t(arr)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("side", ["self", "cross"])
def test_paged_attend_matches_jax(dtype_name, side):
    from csat_tpu.ops.paged_decode import paged_attend as jattend
    from csat_tpu_torch.ops.paged_decode import paged_attend as tattend

    (pk, pv, sk, sv), table, mask, width, q, idx, k_tok, v_tok = _paged_inputs(dtype_name, 11)
    kw = {}
    tkw = {}
    if side == "self":
        kw = dict(idx=jnp.asarray(idx), k_tok=jnp.asarray(k_tok), v_tok=jnp.asarray(v_tok))
        tkw = dict(idx=_t(idx), k_tok=_t(k_tok), v_tok=_t(v_tok))
    j_out, j_skip = jattend(jnp.asarray(q), pk, pv, sk, sv, jnp.asarray(table),
                            jnp.asarray(mask), width, impl="kernel", **kw)
    t_out, t_skip = tattend(_t(q), _to_torch_pages(pk), _to_torch_pages(pv), _t(np.asarray(sk)),
                            _t(np.asarray(sv)), _t(table), _t(mask), width, **tkw)
    live = ~mask.all(axis=1)
    tol = 1e-6 if dtype_name == "float32" else 1e-5
    np.testing.assert_allclose(t_out.numpy()[live], np.asarray(j_out)[live], atol=tol, rtol=0)
    np.testing.assert_array_equal(t_skip.numpy(), np.asarray(j_skip))


def test_quantize_int8_bit_equal_round_half_even():
    from csat_tpu.ops.paged_decode import quantize_kv as jquant
    from csat_tpu_torch.ops.paged_decode import quantize_kv as tquant

    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, H, 16)).astype(np.float32)
    x[0, 0] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5] + [0.0] * 10  # scale 1: exact halves
    x[1, 1] = 0.0                                               # all-zero row: scale 1
    jq, js = jquant(jnp.asarray(x), jnp.int8)
    tq, ts = tquant(_t(x), torch.int8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[0, 0, :6].tolist() == [127, 2, -4, 0, 0, 2]


@pytest.mark.parametrize("name", ["python", "java"])
def test_kernel_head_widths_cover_every_config(name):
    """Each CUDA kernel is instantiated for the head width every registered
    config gives it, and a width without an instantiation is refused before
    any launch."""
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.ops import build

    cfg = get_config(name)
    widths = {"flex_fwd_cse": cfg.pegen_dim // cfg.num_heads,
              "flex_fwd_sbm_expected": cfg.head_dim,
              "flex_fwd_sbm_sampled": cfg.head_dim,
              "flex_fwd_sbm_graph": cfg.head_dim,
              "flex_bwd_q_sbm_sampled": cfg.head_dim,
              "flex_bwd_k_sbm_sampled": cfg.head_dim,
              "flex_bwd_q_sbm_expected": cfg.head_dim,
              "flex_bwd_k_sbm_expected": cfg.head_dim,
              "paged_decode": cfg.hidden_size // cfg.num_heads}
    assert set(widths) == set(build.KERNELS) == set(build.HEAD_DIMS) == set(build.REPLACES)
    for fn, dh in widths.items():
        build.check_head_dim(fn, dh)
    with pytest.raises(ValueError, match="head widths"):
        build.check_head_dim("paged_decode", 32)
