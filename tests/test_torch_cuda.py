"""The port's CUDA kernels against their plain versions, on the card:
the serving kernels (K1, K2, K5) and the training kernels (K6, K7 forward
with dropout, K3/K4 backward, K8/K9 expected-graph backward with clip ties
and whole padded key tiles) at the training shape and at ragged shapes.

These need a CUDA device and ``nvcc`` (the kernels build at first use), so
they carry the ``cuda`` marker and skip elsewhere; run them on a GPU machine
with ``pytest tests/test_torch_cuda.py -m cuda --noconftest`` (the suite's
conftest imports JAX, which a GPU machine need not have).  ``chip_smoke.py``
holds the same comparisons at the flagship shapes.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _flex_case(mod, b, n, dh, dev, seed=0):
    from csat_tpu_torch.ops.mods import cse_mod, sbm_expected_mod

    g = torch.Generator().manual_seed(seed)
    h, kk, r_len = 4, 6, 40
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)
    q, k, v = rnd(b, h, n, dh), rnd(b, h, n, dh), rnd(b, h, n, dh)
    if mod == "cse":
        rel = torch.randint(0, r_len, (b, 2, n, n), generator=g).to(dev)
        mask = torch.rand((b, 2, n, n), generator=g) < 0.3
        mask[:, :, :, n - 5:] = True
        mask[0, 0, 1, :] = True
        return q, k, v, *cse_mod(rnd(h, r_len, dh), rnd(h, r_len, dh), rel, mask.to(dev))
    pad = torch.zeros((b, n), dtype=torch.bool)
    pad[0, n // 3:] = True
    s_aff = torch.softmax(torch.randn(h, kk * kk, generator=g), -1).reshape(h, kk, kk)
    return q, k, v, *sbm_expected_mod(torch.sigmoid(rnd(b, h, n, kk)),
                                      torch.sigmoid(rnd(b, h, n, kk)), s_aff.to(dev), pad.to(dev))


# every head width ops/build.py HEAD_DIMS instantiates: 64 for both mods,
# 96 for the java config's SBM encoder
@pytest.mark.parametrize("mod,n,dh", [
    ("cse", 20, 64), ("cse", 130, 64), ("cse", 150, 64),
    ("sbm_expected", 20, 64), ("sbm_expected", 130, 64), ("sbm_expected", 150, 96)])
def test_flex_kernel_matches_plain(dev, mod, n, dh):
    from csat_tpu_torch.ops import build, flex_core

    q, k, v, spec, aux = _flex_case(mod, 2, n, dh, dev)
    before = build.launch_counts()[f"flex_fwd_{mod}"]
    out, ex = flex_core.flex_attention(q, k, v, spec, aux)
    ref, rex = flex_core.flex_reference(q, k, v, spec, aux)
    torch.cuda.synchronize()
    assert build.launch_counts()[f"flex_fwd_{mod}"] == before + 1
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(ex["lse"], rex["lse"], atol=2e-5, rtol=0)
    torch.testing.assert_close(ex["graph_sum"], rex["graph_sum"], rtol=1e-5, atol=1e-3)
    skips = flex_core.reference_block_skip(spec, aux, flex_core.geometry(q))
    assert torch.equal(ex["skipped_blocks"], skips)


def _tc_case(mod, b, n, dh, dev, seed):
    """K1/K2 inputs at the flagship's heads, clusters and table length: per
    sample, every key real, keys past 64 padded (whole dead key tiles), a
    third real, or none; CSE also an all-masked row in sample 0."""
    from csat_tpu_torch.ops.mods import cse_mod, sbm_expected_mod

    g = torch.Generator().manual_seed(seed)
    h, kk, r_len = 8, 10, 150
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)
    q, k, v = rnd(b, h, n, dh), rnd(b, h, n, dh), rnd(b, h, n, dh)
    n_real = ([n, min(n, 64), max(1, n // 3), 0] * b)[:b]
    if mod == "cse":
        rel = torch.randint(0, r_len, (b, 2, n, n), generator=g)
        mask = torch.rand((b, 2, n, n), generator=g) < 0.3
        for i, m in enumerate(n_real):
            mask[i, :, :, m:] = True
            mask[i, :, m:, :] = True
        mask[0, 0, 1, :] = True
        return q, k, v, *cse_mod(rnd(h, r_len, dh), rnd(h, r_len, dh), rel.to(dev), mask.to(dev))
    pad = torch.zeros((b, n), dtype=torch.bool)
    for i, m in enumerate(n_real):
        pad[i, m:] = True
    s_aff = torch.softmax(torch.randn(h, kk * kk, generator=g), -1).reshape(h, kk, kk)
    return q, k, v, *sbm_expected_mod(torch.sigmoid(rnd(b, h, n, kk)),
                                      torch.sigmoid(rnd(b, h, n, kk)), s_aff.to(dev), pad.to(dev))


# K1 and the tensor-core K2 at every bucket length and at serving and
# training batch sizes; K2 also at the java width (dh 96), with and without
# dropout
@pytest.mark.parametrize("mod,b,n,dh,rate", [
    *[(mod, b, n, 64, 0.0) for mod in ("cse", "sbm_expected") for n in (37, 75, 150)
      for b in (1, 4, 64)],
    ("sbm_expected", 4, 150, 96, 0.0), ("sbm_expected", 4, 150, 96, 0.2),
    ("sbm_expected", 64, 75, 96, 0.2), ("sbm_expected", 64, 150, 64, 0.2)])
def test_tensor_core_kernel_matches_plain(dev, mod, b, n, dh, rate):
    from csat_tpu_torch.ops import build, flex_core

    q, k, v, spec, aux = _tc_case(mod, b, n, dh, dev, seed=b * 1000 + n)
    dseed = torch.tensor([77], dtype=torch.int32, device=dev) if rate else None
    before = build.launch_counts()[f"flex_fwd_{mod}"]
    out, ex = flex_core.flex_attention(q, k, v, spec, aux, rate, dseed)
    ref, rex = flex_core.flex_reference(q, k, v, spec, aux, rate, dseed)
    torch.cuda.synchronize()
    assert build.launch_counts()[f"flex_fwd_{mod}"] == before + 1
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(ex["lse"], rex["lse"], atol=2e-5, rtol=0)
    torch.testing.assert_close(ex["graph_sum"], rex["graph_sum"], rtol=1e-5, atol=1e-3)
    skips = flex_core.reference_block_skip(spec, aux, flex_core.geometry(q))
    assert torch.equal(ex["skipped_blocks"], skips)
    if mod == "sbm_expected" and b >= 2 and n > 64:
        assert skips.sum() > 0  # the sample padded past key 64 skips whole tiles
    if mod == "cse":  # the all-masked row is uniform over its real columns
        torch.testing.assert_close(out[0, 0, 1], v[0, 0].mean(dim=0), atol=2e-5, rtol=0)


@pytest.mark.parametrize("b,n", [(4, 37), (8, 75), (64, 150)])
def test_cse_kernel_on_ast_distances(dev, b, n):
    """K1 on the distances and masks of synthetic ASTs, as the serving and
    training paths give it: most entries masked, the distances of the
    unmasked ones in a narrow band around the offset, padded rows whose every
    entry is masked."""
    import numpy as np

    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.dataset import collate
    from csat_tpu_torch.data.synthetic import random_ast, train_sample
    from csat_tpu_torch.ops import flex_core
    from csat_tpu_torch.ops.mods import cse_mod

    cfg = get_config("python")
    rng = np.random.default_rng(n)
    samples = [train_sample(random_ast(rng, int(m)), cfg, 100, 100, rng)
               for m in np.linspace(min(10, n), n, b).round()]
    batch = collate({key: np.stack([x[key] for x in samples]) for key in samples[0]},
                    cfg.max_src_len)
    rel = torch.from_numpy(np.stack([batch.L, batch.T], 1)[:, :, :n, :n].astype(np.int32))
    mask = torch.from_numpy(np.stack([batch.L_mask, batch.T_mask], 1)[:, :, :n, :n].copy())
    g = torch.Generator().manual_seed(n)
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)
    q, k, v = rnd(b, 8, n, 64), rnd(b, 8, n, 64), rnd(b, 8, n, 64)
    spec, aux = cse_mod(rnd(8, cfg.max_src_len, 64), rnd(8, cfg.max_src_len, 64), rel.to(dev),
                        mask.to(dev))
    out, ex = flex_core.flex_attention(q, k, v, spec, aux)
    ref, rex = flex_core.flex_reference(q, k, v, spec, aux)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(ex["lse"], rex["lse"], atol=2e-5, rtol=0)


def test_cse_plain_backward_repeats_bit_for_bit(dev):
    """The CSE mod's backward on the card (the plain path: K1 has no backward
    kernel) gives the same bits on every run: the relative-table gathers add
    their cotangents in a fixed order (``ops/mods.py:rel_gather``)."""
    from csat_tpu_torch.ops import flex_core

    q, k, v, spec, (lq, lk, rel, mask) = _tc_case("cse", 16, 150, 64, dev, seed=5)
    go = torch.randn(q.shape, generator=torch.Generator().manual_seed(6)).to(dev)

    def grads():
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, lq, lk)]
        out, _ = flex_core.flex_attention(*leaves[:3], spec, (*leaves[3:], rel, mask))
        return torch.autograd.grad(torch.sum(out * go), leaves)

    first, second = grads(), grads()
    for name, a, b in zip(("dq", "dk", "dv", "dlq", "dlk"), first, second):
        assert torch.equal(a, b), name


def test_embedding_backward_repeats_bit_for_bit(dev):
    """A token embedding's backward on the card gives the same bits on every
    run, also when a small vocabulary repeats indices many times
    (``models/components.py:Embeddings``)."""
    from csat_tpu_torch.models.components import Embeddings

    g = torch.Generator().manual_seed(7)
    emb = Embeddings(26, 512).to(dev)
    torch.nn.init.normal_(emb.weight)
    x = torch.randint(0, 26, (64, 150), generator=g).to(dev)
    go = torch.randn(64, 150, 512, generator=g).to(dev)

    def grad():
        emb.zero_grad(set_to_none=True)
        torch.sum(emb(x) * go).backward()
        return emb.weight.grad.clone()

    assert torch.equal(grad(), grad())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("side", ["self", "cross"])
def test_paged_kernel_matches_plain(dev, dtype, side):
    from csat_tpu_torch.ops import paged_decode as pd

    g = torch.Generator().manual_seed(1)
    s, h, page, dh, nb, width = 4, 4, 8, 64, 5, 37
    n_pages = 1 + s * nb
    (pk, sk), (pv, sv) = (pd.quantize_kv(torch.randn(n_pages, h, page, dh, generator=g), dtype)
                          for _ in range(2))
    table = torch.zeros((s, nb), dtype=torch.int32)
    mask = torch.ones((s, width), dtype=torch.bool)
    for i, ln in enumerate([37, 1, 12, 20]):
        table[i, : -(-ln // page)] = torch.arange(1 + i * nb, 1 + i * nb + -(-ln // page))
        mask[i, :ln] = False
    q = torch.randn(s, h, 1, dh, generator=g)
    merge = {}
    if side == "self":
        merge = dict(idx=torch.tensor([36, 0, 11, 19], dtype=torch.int32),
                     k_tok=torch.randn(s, h, 1, dh, generator=g),
                     v_tok=torch.randn(s, h, 1, dh, generator=g))
    inputs = [t.to(dev) for t in (q, pk, pv, sk, sv, table, mask)] + [width]
    merge = {key: t.to(dev) for key, t in merge.items()}
    out, skipped = pd.paged_attend(*inputs, **merge)
    ref, ref_skip = pd.paged_attend(*[t.cpu() if torch.is_tensor(t) else t for t in inputs],
                                    **{key: t.cpu() for key, t in merge.items()})
    torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=0)
    assert torch.equal(skipped.cpu(), ref_skip)


def test_engine_on_card_serves_cpu_tokens(dev):
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.synthetic import random_ast, request_sample
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.serve import ServeEngine
    import numpy as np

    cfg = get_config("python", eval_graph="expected", serve_slots=4, max_tgt_len=12)
    rng = np.random.default_rng(0)
    samples = [request_sample(random_ast(rng, n), cfg, 500) for n in (20, 60, 150, 90, 33)]
    tokens = {}
    for device in ("cuda", "cpu"):
        eng = ServeEngine(CSATrans(cfg, 500, 700, device=device, seed=3), cfg, device=device)
        res = eng.generate(samples, max_new_tokens=6)
        assert all(r.ok for r in res) and eng.page_leaks() == 0
        tokens[device] = [r.tokens.tolist() for r in res]
    assert tokens["cuda"] == tokens["cpu"]


def test_wrappers_refuse_uninstantiated_head_width(dev):
    from csat_tpu_torch.ops import flex_core

    q, k, v, spec, aux = _flex_case("cse", 1, 20, 32, dev)
    with pytest.raises(ValueError, match="head widths"):
        flex_core.flex_attention(q, k, v, spec, aux)
    q, k, v, spec, aux, _ = _train_case("sbm_sampled", 1, 20, 32, dev)
    with pytest.raises(ValueError, match="head widths"):
        flex_core.flex_attention(q, k, v, spec, aux)


# ---------------------------------------------------------------------------
# the training path: sampled / graph forward (K6, K7), sampled backward (K3, K4)
# ---------------------------------------------------------------------------

RATE = 0.2        # the configs' attention dropout
NEAR = 1e-6       # a Bernoulli draw within this of its threshold may flip
SBM_TOL = 2e-5    # forward out / lse: summation order only
GRAD_TOL = 1e-4   # backward, atol and rtol: summation order over N keys


def _train_case(mod, b, n, dh, dev, seed=0, h=4):
    from csat_tpu_torch.ops.mods import sbm_graph_mod, sbm_sampled_mod

    g = torch.Generator().manual_seed(seed)
    kk = 10
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)
    q, k, v = rnd(b, h, n, dh), rnd(b, h, n, dh), rnd(b, h, n, dh)
    pad = torch.zeros((b, n), dtype=torch.bool)
    for i in range(b):
        pad[i, max(1, n - 1 - (i * 37) % n):] = i > 0
    pad = pad.to(dev)
    dseed = torch.tensor([777 + seed], dtype=torch.int32, device=dev)
    if mod == "sbm_sampled":
        s_aff = torch.softmax(torch.randn(h, kk * kk, generator=g), -1).reshape(h, kk, kk)
        spec, aux = sbm_sampled_mod(torch.sigmoid(2 * rnd(b, h, n, kk)),
                                    torch.sigmoid(2 * rnd(b, h, n, kk)), s_aff.to(dev), pad,
                                    torch.tensor([1234 + seed], dtype=torch.int32, device=dev))
    else:
        graph = (torch.rand((b, h, n, n), generator=g) < 0.4).float().to(dev)
        spec, aux = sbm_graph_mod(graph, pad)
    return q, k, v, spec, aux, dseed


def _near_rows(spec, aux):
    """(B, H, N) rows holding a Bernoulli draw within NEAR of its threshold,
    and the count of such draws per (b, h)."""
    from csat_tpu_torch.ops.hashrng import uniform_field
    from csat_tpu_torch.ops.mods import SBMSampledSpec, exp_adjacency

    if not isinstance(spec, SBMSampledSpec):
        z = torch.zeros(aux[0].shape[:3], dtype=torch.bool, device=aux[0].device)
        return z, z.sum(-1)
    r, kh, _, sseed = aux
    b, h, n, _ = r.shape
    p = torch.clamp(exp_adjacency(r, kh), spec.floor, 0.99)
    near = (uniform_field(sseed, b, h, n, n, spec.stride) - p).abs() <= NEAR
    return near.any(-1), near.sum((-1, -2))


@pytest.mark.parametrize("mod", ["sbm_sampled", "sbm_graph"])
@pytest.mark.parametrize("b,n,dh", [(64, 150, 64), (3, 37, 64), (3, 75, 64), (2, 130, 96)])
def test_sbm_train_forward_matches_plain(dev, mod, b, n, dh):
    from csat_tpu_torch.ops import build, flex_core

    q, k, v, spec, aux, dseed = _train_case(mod, b, n, dh, dev)
    fn = f"flex_fwd_{mod}"
    before = build.launch_counts()[fn]
    out, ex = flex_core.flex_attention(q, k, v, spec, aux, RATE, dseed)
    ref, rex = flex_core.flex_reference(q, k, v, spec, aux, RATE, dseed)
    torch.cuda.synchronize()
    assert build.launch_counts()[fn] == before + 1
    near_rows, near_count = _near_rows(spec, aux)
    # a draw may flip only within NEAR of its threshold: graph_sum moves by
    # at most the near draws of its (b, h), and only rows holding one differ
    assert torch.all((ex["graph_sum"] - rex["graph_sum"]).abs() <= near_count)
    keep = ~near_rows
    torch.testing.assert_close(out[keep], ref[keep], atol=SBM_TOL, rtol=0)
    torch.testing.assert_close(ex["lse"][keep], rex["lse"][keep], atol=SBM_TOL, rtol=0)
    skips = flex_core.reference_block_skip(spec, aux, flex_core.geometry(q))
    assert torch.equal(ex["skipped_blocks"], skips)


@pytest.mark.parametrize("b,n,dh", [(64, 150, 64), (3, 37, 64), (3, 75, 64), (2, 130, 96)])
def test_sbm_sampled_backward_matches_plain(dev, b, n, dh):
    from csat_tpu_torch.ops import build, flex_core

    q, k, v, spec, aux, dseed = _train_case("sbm_sampled", b, n, dh, dev, seed=1)
    go = torch.randn(q.shape, generator=torch.Generator().manual_seed(5)).to(dev)

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, aux[0], aux[1])]
        out, ex = fn(*leaves[:3], spec, (*leaves[3:], *aux[2:]), RATE, dseed)
        loss = torch.sum(out * go) + 1e-3 * torch.sum(ex["graph_sum"])
        return ex["graph_sum"].detach(), torch.autograd.grad(loss, leaves)

    before = build.launch_counts()
    gsum, got = grads(flex_core.flex_attention)
    ref_gsum, want = grads(flex_core.flex_reference)
    torch.cuda.synchronize()
    after = build.launch_counts()
    for fn in ("flex_fwd_sbm_sampled", "flex_bwd_q_sbm_sampled", "flex_bwd_k_sbm_sampled"):
        assert after[fn] == before[fn] + 1, fn
    # a flipped draw changes its own (b, h) only; compare the (b, h) whose
    # graph_sum agrees, and only near-threshold draws may have flipped
    _, near_count = _near_rows(spec, aux)
    assert torch.all((gsum - ref_gsum).abs() <= near_count)
    same = gsum == ref_gsum
    assert same.float().mean() >= 0.9
    for name, a, w in zip(("q", "k", "v", "r", "k_hat"), got, want):
        torch.testing.assert_close(a[same], w[same], atol=GRAD_TOL, rtol=GRAD_TOL, msg=name)


def test_kernel_backward_adds_graph_sum_cotangent_on_dead_tiles(dev):
    """A key tile that is all padding is dead for the attention, but its raw
    graph still carries the graph_sum cotangent into dR / dK̂."""
    from csat_tpu_torch.ops import flex_core
    from csat_tpu_torch.ops.mods import sbm_sampled_mod

    g = torch.Generator().manual_seed(3)
    b, h, n, dh, kk = 1, 2, 150, 64, 10
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)
    pad = torch.zeros((b, n), dtype=torch.bool)
    pad[0, 60:] = True  # k-tiles 1 and 2 are all padding
    s_aff = torch.softmax(torch.randn(h, kk * kk, generator=g), -1).reshape(h, kk, kk).to(dev)
    leaves = [rnd(b, h, n, kk).sigmoid().requires_grad_() for _ in range(2)]
    q, k, v = rnd(b, h, n, dh), rnd(b, h, n, dh), rnd(b, h, n, dh)
    seed = torch.tensor([9], dtype=torch.int32, device=dev)
    outs = []
    for fn in (flex_core.flex_attention, flex_core.flex_reference):
        spec, aux = sbm_sampled_mod(*leaves, s_aff, pad.to(dev), seed)
        _, ex = fn(q, k, v, spec, aux)
        outs.append(torch.autograd.grad(ex["graph_sum"].sum(), leaves))
    for a, w in zip(*outs):
        assert a[:, :, 64:].abs().sum() > 0
        torch.testing.assert_close(a, w, atol=GRAD_TOL, rtol=GRAD_TOL)


def _expected_case(b, n, dh, dev, floor, variant, seed=2, h=4, kk=10):
    """Leaves (q, k, v, R, K̂) and the key-pad mask of an expected-mod call.
    ``ties``: exact ties of R·K̂ᵀ at both clip bounds (0.99, and ``floor``)
    and at 0; ``padded_tile``: every key from 60 on is padding in row 0, so
    k-tiles 1.. are dead there."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g)
    q, k, v = rnd(b, h, n, dh), rnd(b, h, n, dh), rnd(b, h, n, dh)
    r = torch.sigmoid(2 * rnd(b, h, n, kk)) * 0.25
    kh = torch.sigmoid(2 * rnd(b, h, n, kk))
    pad = torch.zeros((b, n), dtype=torch.bool)
    for i in range(1, b):
        pad[i, max(1, n - 1 - (i * 37) % n):] = True
    if variant == "ties":
        kh[:, :, 3] = 0.0                       # column 3: R·K̂ᵀ == 0 on every row
        kh[:, :, 5] = 0.0
        kh[:, :, 5, 0] = 1.0                    # column 5: R·K̂ᵀ == R[..., 0]
        r[:, :, 7] = 0.0
        r[:, :, 7, 0] = 0.99                    # (7, 5) == .99
        r[:, :, 8] = 0.0
        r[:, :, 8, 0] = floor                   # (8, 5) == floor
        r[:, :, 9] = 0.0                        # row 9: all 0 (dead at floor 0)
    if variant == "padded_tile":
        pad[0, 60:] = True
    return [t.to(dev) for t in (q, k, v, r, kh)], pad.to(dev)


@pytest.mark.parametrize("b,n,dh,rate,floor,variant", [
    (64, 150, 64, RATE, 0.01, "plain"), (64, 150, 64, 0.0, 0.01, "plain"),
    (3, 37, 64, RATE, 0.01, "plain"), (3, 75, 64, 0.0, 0.01, "ties"),
    (2, 130, 96, RATE, 0.01, "ties"), (2, 150, 64, RATE, 0.0, "ties"),
    (2, 150, 64, RATE, 0.01, "padded_tile"), (2, 150, 64, 0.0, 0.0, "padded_tile")])
def test_sbm_expected_backward_matches_plain(dev, b, n, dh, rate, floor, variant):
    """K8/K9 (and K2 with dropout) against the plain recomputed backward;
    atol and rtol 1e-4 as K3/K4: summation order over N keys."""
    from csat_tpu_torch.ops import build, flex_core
    from csat_tpu_torch.ops.mods import SBMExpectedSpec, exp_adjacency

    leaves0, pad = _expected_case(b, n, dh, dev, floor, variant)
    h, kk = leaves0[3].shape[1], leaves0[3].shape[3]
    spec = SBMExpectedSpec(n=n, heads=h, kk=kk, floor=floor)
    dseed = torch.tensor([778], dtype=torch.int32, device=dev)
    go = torch.randn(leaves0[0].shape, generator=torch.Generator().manual_seed(5)).to(dev)
    if variant == "ties":
        ea = exp_adjacency(leaves0[3], leaves0[4])
        assert (ea == 0.99).any() and (ea == torch.tensor(floor, device=dev)).any()
        assert (ea == 0).any()

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_() for t in leaves0]
        out, ex = fn(*leaves[:3], spec, (leaves[3], leaves[4], pad.float()), rate, dseed)
        loss = torch.sum(out * go) + 1e-3 * torch.sum(ex["graph_sum"])
        return out.detach(), ex, torch.autograd.grad(loss, leaves)

    before = build.launch_counts()
    out, ex, got = grads(flex_core.flex_attention)
    ref, rex, want = grads(flex_core.flex_reference)
    torch.cuda.synchronize()
    after = build.launch_counts()
    for fn in ("flex_fwd_sbm_expected", "flex_bwd_q_sbm_expected", "flex_bwd_k_sbm_expected"):
        assert after[fn] == before[fn] + 1, fn
    torch.testing.assert_close(out, ref, atol=SBM_TOL, rtol=0)
    torch.testing.assert_close(ex["graph_sum"], rex["graph_sum"], rtol=1e-5, atol=1e-3)
    if variant == "padded_tile":
        assert ex["skipped_blocks"][0].min() >= 2 * 3   # k-tiles 1, 2 × 3 q-tiles
        assert got[4][0, :, 64:].abs().sum() > 0        # gs still reaches dK̂ there
    for name, a, w in zip(("q", "k", "v", "r", "k_hat"), got, want):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, w, atol=GRAD_TOL, rtol=GRAD_TOL, msg=name)


def test_mod_without_a_kernel_raises_on_the_card(dev):
    import dataclasses

    from csat_tpu_torch.ops import flex_core

    @dataclasses.dataclass(frozen=True)
    class Unknown:
        name = "unknown"

    q = torch.zeros((1, 1, 8, 64), device=dev)
    with pytest.raises(NotImplementedError, match="unknown"):
        flex_core.flex_attention(q, q, q, Unknown(), ())
