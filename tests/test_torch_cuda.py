"""The port's CUDA kernels against their plain versions, on the card:
the serving kernels (K1, K2, K5 over every storage dtype at ragged widths)
and the training kernels (K6 and K7 at every bucket length, batch size and
head width, with and without dropout, K3/K4 and K8/K9 backward at every
bucket length, at serving and training batch sizes and at both head widths,
K8/K9 also with clip ties, whole padded key tiles and dead query rows) at the
training shape and at ragged shapes; and the trainer's resilience pieces that
need the card: the guarded AdamW update bitwise on the card, the prefetch
thread's copy stream, the watchdog's device probe on a wedged stream.

These need a CUDA device and ``nvcc`` (the kernels build at first use), so
they carry the ``cuda`` marker and skip elsewhere; run them on a GPU machine
with ``pytest tests/test_torch_cuda.py -m cuda --noconftest`` (the suite's
conftest imports JAX, which a GPU machine need not have).  ``chip_smoke.py``
holds the same comparisons at the flagship shapes.
"""

import dataclasses

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
    """K1/K2/K6 inputs at the flagship's heads, clusters and table length:
    per sample, every key real, keys past 64 padded (whole dead key tiles), a
    third real, or none (every key padded); CSE also an all-masked row in
    sample 0."""
    from csat_tpu_torch.ops.mods import cse_mod, sbm_expected_mod, sbm_sampled_mod

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
    r, kh = torch.sigmoid(rnd(b, h, n, kk)), torch.sigmoid(rnd(b, h, n, kk))
    if mod == "sbm_sampled":
        seed = torch.tensor([seed % 1000 + 5], dtype=torch.int32, device=dev)
        return q, k, v, *sbm_sampled_mod(r, kh, s_aff.to(dev), pad.to(dev), seed)
    return q, k, v, *sbm_expected_mod(r, kh, s_aff.to(dev), pad.to(dev))


# K1 and the tensor-core K2 at every bucket length and at serving and
# training batch sizes; K2 also at the java width (dh 96), with and without
# dropout; the tensor-core K6 at every bucket length, batch size and head
# width, with and without dropout
@pytest.mark.parametrize("mod,b,n,dh,rate", [
    *[(mod, b, n, 64, 0.0) for mod in ("cse", "sbm_expected") for n in (37, 75, 150)
      for b in (1, 4, 64)],
    ("sbm_expected", 4, 150, 96, 0.0), ("sbm_expected", 4, 150, 96, 0.2),
    ("sbm_expected", 64, 75, 96, 0.2), ("sbm_expected", 64, 150, 64, 0.2),
    *[("sbm_sampled", b, n, dh, rate) for n in (37, 75, 150) for b in (1, 4, 64)
      for dh in (64, 96) for rate in (0.0, 0.2)],
    # the long-AST configs' N 512 (python_long dh 64, java_long dh 96)
    ("cse", 4, 512, 64, 0.0), ("sbm_expected", 4, 512, 64, 0.0),
    ("sbm_expected", 4, 512, 96, 0.0),
    *[("sbm_sampled", 4, 512, dh, rate) for dh in (64, 96) for rate in (0.0, 0.2)]])
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
    if mod == "sbm_sampled":
        # one draw order on both paths: the same graph, edge for edge
        assert torch.equal(ex["graph_sum"], rex["graph_sum"])
    else:
        torch.testing.assert_close(ex["graph_sum"], rex["graph_sum"], rtol=1e-5, atol=1e-3)
    skips = flex_core.reference_block_skip(spec, aux, flex_core.geometry(q))
    assert torch.equal(ex["skipped_blocks"], skips)
    if mod != "cse" and b >= 2 and n > 64:
        assert skips.sum() > 0  # the sample padded past key 64 skips whole tiles
    if mod != "cse" and b >= 4:  # sample 3 has every key padded: no live weight
        assert torch.all(out[3] == 0) and torch.all(ex["lse"][3] == flex_core.NEG)
    if mod == "cse":  # the all-masked row is uniform over its real columns
        torch.testing.assert_close(out[0, 0, 1], v[0, 0].mean(dim=0), atol=2e-5, rtol=0)


def _ast_cse_case(b, n, variant, dev, config="python"):
    """K1 inputs from the distances and masks of ``b`` synthetic ASTs of up
    to ``n`` nodes, as the serving and training paths give them (most entries
    masked, the unmasked distances in a narrow band, rows and columns past an
    AST's nodes masked), at the flagship's heads, width and table length.
    ``variant`` edits the masks: ``t_only`` clears the L plane's mask nowhere
    and the T plane's in a few entries of one 16 x 64 tile; ``empty_row``
    masks every column of three rows; ``pad_tile`` cuts sample 0 to 40 nodes,
    so that its key tiles past 64 are wholly padding."""
    import numpy as np

    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.dataset import collate
    from csat_tpu_torch.data.synthetic import random_ast, train_sample
    from csat_tpu_torch.ops.mods import cse_mod

    cfg = get_config(config)
    rng = np.random.default_rng(b * 1000 + n)
    sizes = np.linspace(min(10, n), n, b).round().astype(int)
    if variant == "pad_tile":
        sizes[0] = 40
    samples = [train_sample(random_ast(rng, int(m)), cfg, 100, 100, rng) for m in sizes]
    batch = collate({key: np.stack([x[key] for x in samples]) for key in samples[0]},
                    cfg.max_src_len)
    rel = np.stack([batch.L, batch.T], 1)[:, :, :n, :n].astype(np.int32)
    mask = np.stack([batch.L_mask, batch.T_mask], 1)[:, :, :n, :n].copy()
    if variant == "t_only":
        mask[:] = True
        mask[0, 1, 17, [3, 5, 40, 63]] = False
        mask[0, 1, 30, 0] = False
    elif variant == "empty_row":
        mask[0, 0, 1, :] = True
        mask[b - 1, 1, n - 1, :] = True
        mask[0, 1, 16, :] = True
    g = torch.Generator().manual_seed(n)
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)
    q, k, v = rnd(b, 8, n, 64), rnd(b, 8, n, 64), rnd(b, 8, n, 64)
    spec, aux = cse_mod(rnd(8, cfg.max_src_len, 64), rnd(8, cfg.max_src_len, 64),
                        torch.from_numpy(rel).to(dev), torch.from_numpy(mask).to(dev))
    return q, k, v, spec, aux


# real AST distances at B 1, 4 and 64 (one, two and four 16-row slabs a
# block at N 150) and at the smaller buckets; a T-plane-only sparse tile;
# rows whose every column is masked; N 100 and 130, whose last block holds
# rows past N; sample 0 with its key tiles past 64 wholly padding
@pytest.mark.parametrize("b,n,variant", [
    (1, 150, "ast"), (4, 150, "ast"), (64, 150, "ast"), (4, 37, "ast"), (8, 75, "ast"),
    (4, 150, "t_only"), (1, 150, "empty_row"), (64, 150, "empty_row"), (2, 100, "ast"),
    (64, 130, "ast"), (4, 150, "pad_tile"), (64, 150, "pad_tile")])
def test_cse_kernel_on_ast_distances(dev, b, n, variant):
    """K1 on the distances and masks of synthetic ASTs, as the serving and
    training paths give it, against the plain path: out and lse within
    FLEX_TOL (2e-5), graph_sum and the skip count exact, one launch; a row
    whose every column is masked is the mean of V over the real columns."""
    from csat_tpu_torch.ops import build, flex_core

    q, k, v, spec, aux = _ast_cse_case(b, n, variant, dev)
    before = build.launch_counts()["flex_fwd_cse"]
    out, ex = flex_core.flex_attention(q, k, v, spec, aux)
    ref, rex = flex_core.flex_reference(q, k, v, spec, aux)
    torch.cuda.synchronize()
    assert build.launch_counts()["flex_fwd_cse"] == before + 1
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(ex["lse"], rex["lse"], atol=2e-5, rtol=0)
    assert torch.equal(ex["graph_sum"], rex["graph_sum"])
    skips = flex_core.reference_block_skip(spec, aux, flex_core.geometry(q))
    assert torch.equal(ex["skipped_blocks"], skips)
    empty = aux[3].all(dim=-1).repeat_interleave(spec.group, dim=1)  # (B, H, N)
    if variant == "empty_row":
        assert empty[0, 0, 1] and empty[0, 4, 16]
    for bi, hi, ri in empty.nonzero().tolist()[:64]:
        torch.testing.assert_close(out[bi, hi, ri], v[bi, hi].mean(dim=0), atol=2e-5, rtol=0)


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


# K5 at every storage dtype, both sides, and widths from one lane to the
# cross side's 150, over chains with every lane admissible, a NULL page in
# mid-table, one lane, and a frozen row.  The null page holds zeros, as the
# kernel reads a NULL lane, so the plain path's gather agrees on every row.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("side", ["self", "cross"])
@pytest.mark.parametrize("width", [1, 16, 17, 49, 150])
def test_paged_kernel_matches_plain(dev, dtype, side, width):
    from csat_tpu_torch.ops import build, paged_decode as pd

    g = torch.Generator().manual_seed(width)
    s, h, page, dh = 4, 8, 16, 64
    nb = -(-width // page) + 1
    n_pages = 1 + s * nb
    raw = [torch.randn(n_pages, h, page, dh, generator=g) for _ in range(2)]
    for r in raw:
        r[pd.NULL_PAGE] = 0.0
    (pk, sk), (pv, sv) = (pd.quantize_kv(r, dtype) for r in raw)
    table = torch.full((s, nb), pd.NULL_PAGE, dtype=torch.int32)
    mask = torch.ones((s, width), dtype=torch.bool)
    lens = [width, width, 1, 0]  # slot 3 is frozen: every lane masked
    for i, ln in enumerate(lens):
        table[i, : -(-ln // page)] = torch.arange(1 + i * nb, 1 + i * nb + -(-ln // page))
        mask[i, :ln] = False
    if width > 2 * page:  # slot 1: a NULL page in mid-table, its lanes masked
        table[1, 1] = pd.NULL_PAGE
        mask[1, page:2 * page] = True
    q = torch.randn(s, h, 1, dh, generator=g)
    merge = {}
    if side == "self":
        merge = dict(idx=torch.tensor([width - 1, width // 2, 0, 0], dtype=torch.int32),
                     k_tok=torch.randn(s, h, 1, dh, generator=g),
                     v_tok=torch.randn(s, h, 1, dh, generator=g))
    inputs = [t.to(dev) for t in (q, pk, pv, sk, sv, table, mask)] + [width]
    merge = {key: t.to(dev) for key, t in merge.items()}
    before = build.launch_counts()["paged_decode"]
    out, skipped = pd.paged_attend(*inputs, **merge)
    torch.cuda.synchronize()
    assert build.launch_counts()["paged_decode"] == before + 1
    ref, ref_skip = pd.paged_attend(*[t.cpu() if torch.is_tensor(t) else t for t in inputs],
                                    **{key: t.cpu() for key, t in merge.items()})
    torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=0)
    assert torch.equal(skipped.cpu(), ref_skip)
    assert torch.equal(ref_skip, pd.reference_page_skip(table, h))


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


def _train_case(mod, b, n, dh, dev, seed=0, h=4, kind="random", bh0=0):
    """Inputs of the sampled or the graph mod; ``kind`` shapes the graph:
    ``"random"`` 40 % edges, ``"clipped"`` drawn as the STE draws it, u <
    clip(p, floor, .99), from mostly small p, ``"sparse"`` every p at the
    floor (about 1 % edges, most 8-column tiles empty), ``"tail"`` 40 % edges
    with every sample's keys padded past 64 or past a third (whole key
    tiles).  ``bh0`` is the batch·head offset of the hash streams (a
    data-parallel process's rows)."""
    from csat_tpu_torch.ops.mods import sbm_graph_mod, sbm_sampled_mod

    g = torch.Generator().manual_seed(seed)
    kk = 10
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)
    q, k, v = rnd(b, h, n, dh), rnd(b, h, n, dh), rnd(b, h, n, dh)
    pad = torch.zeros((b, n), dtype=torch.bool)
    for i in range(b):
        if kind == "tail":
            pad[i, (min(n - 1, 64), max(1, n // 3))[i % 2]:] = True
        else:
            pad[i, max(1, n - 1 - (i * 37) % n):] = i > 0
    pad = pad.to(dev)
    dseed = torch.tensor([777 + seed], dtype=torch.int32, device=dev)
    if mod == "sbm_sampled":
        s_aff = torch.softmax(torch.randn(h, kk * kk, generator=g), -1).reshape(h, kk, kk)
        spec, aux = sbm_sampled_mod(torch.sigmoid(2 * rnd(b, h, n, kk)),
                                    torch.sigmoid(2 * rnd(b, h, n, kk)), s_aff.to(dev), pad,
                                    torch.tensor([1234 + seed], dtype=torch.int32, device=dev),
                                    bh0=bh0)
    else:
        u = torch.rand((b, h, n, n), generator=g)
        p = {"clipped": torch.rand((b, h, n, n), generator=g) ** 4,
             "sparse": torch.zeros(())}.get(kind, torch.full((), 0.4))
        graph = (u < torch.clamp(p, 0.01, 0.99)).float().to(dev)
        spec, aux = sbm_graph_mod(graph, pad, bh0)
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
    near = (uniform_field(sseed, b, h, n, n, spec.stride, bh0=spec.bh0) - p).abs() <= NEAR
    return near.any(-1), near.sum((-1, -2))


GRAPH_KINDS = ("clipped", "sparse", "tail")
GRAPH_TOL = 5e-6  # K7, max abs: its output feeds the next layer's graph


# K6 and K7 with dropout at the ragged shapes of the first port; K7 (the
# tensor-core graph forward) also at every bucket length, at serving and
# training batch sizes and at both head widths, with and without dropout,
# its graph floor-clipped random, mostly empty or with padded key tails
# (each kind once per length and once per batch size)
@pytest.mark.parametrize("mod,b,n,dh,rate,kind", [
    *[(mod, b, n, dh, RATE, "random") for mod in ("sbm_sampled", "sbm_graph")
      for b, n, dh in ((64, 150, 64), (3, 37, 64), (3, 75, 64), (2, 130, 96))],
    *[("sbm_graph", b, n, dh, rate, GRAPH_KINDS[(i + j) % 3])
      for i, n in enumerate((37, 75, 150)) for j, b in enumerate((1, 4, 64))
      for dh in (64, 96) for rate in (0.0, RATE)]])
def test_sbm_train_forward_matches_plain(dev, mod, b, n, dh, rate, kind):
    from csat_tpu_torch.ops import build, flex_core

    q, k, v, spec, aux, dseed = _train_case(mod, b, n, dh, dev, kind=kind)
    fn = f"flex_fwd_{mod}"
    before = build.launch_counts()[fn]
    out, ex = flex_core.flex_attention(q, k, v, spec, aux, rate, dseed)
    ref, rex = flex_core.flex_reference(q, k, v, spec, aux, rate, dseed)
    torch.cuda.synchronize()
    assert build.launch_counts()[fn] == before + 1
    skips = flex_core.reference_block_skip(spec, aux, flex_core.geometry(q))
    assert torch.equal(ex["skipped_blocks"], skips)
    if mod == "sbm_graph":
        # the graph is an input: graph_sum is the same count, the output
        # within GRAPH_TOL everywhere, and a second launch the same bits
        assert torch.equal(ex["graph_sum"], rex["graph_sum"])
        torch.testing.assert_close(out, ref, atol=GRAPH_TOL, rtol=0)
        torch.testing.assert_close(ex["lse"], rex["lse"], atol=GRAPH_TOL, rtol=0)
        again, ex2 = flex_core.flex_attention(q, k, v, spec, aux, rate, dseed)
        assert torch.equal(again, out) and torch.equal(ex2["lse"], ex["lse"])
        assert torch.equal(ex2["graph_sum"], ex["graph_sum"])
        if kind == "tail" and n > 64:
            assert skips.sum() > 0  # keys padded past 64 leave whole tiles dead
        return
    near_rows, near_count = _near_rows(spec, aux)
    # a draw may flip only within NEAR of its threshold: graph_sum moves by
    # at most the near draws of its (b, h), and only rows holding one differ
    assert torch.all((ex["graph_sum"] - rex["graph_sum"]).abs() <= near_count)
    keep = ~near_rows
    torch.testing.assert_close(out[keep], ref[keep], atol=SBM_TOL, rtol=0)
    torch.testing.assert_close(ex["lse"][keep], rex["lse"][keep], atol=SBM_TOL, rtol=0)


def _sampled_grads(fn, q, k, v, spec, aux, rate, dseed, go):
    """graph_sum and the gradients (q, k, v, R, K̂) of ``Σ out·go + 1e-3 ·
    Σ graph_sum`` through ``fn`` (the kernels or the plain path)."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, aux[0], aux[1])]
    out, ex = fn(*leaves[:3], spec, (*leaves[3:], *aux[2:]), rate, dseed)
    loss = torch.sum(out * go) + 1e-3 * torch.sum(ex["graph_sum"])
    return ex["graph_sum"].detach(), torch.autograd.grad(loss, leaves)


def _check_sampled_backward(q, k, v, spec, aux, rate, dseed, go):
    from csat_tpu_torch.ops import build, flex_core

    before = build.launch_counts()
    gsum, got = _sampled_grads(flex_core.flex_attention, q, k, v, spec, aux, rate, dseed, go)
    ref_gsum, want = _sampled_grads(flex_core.flex_reference, q, k, v, spec, aux, rate, dseed, go)
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
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a[same], w[same], atol=GRAD_TOL, rtol=GRAD_TOL, msg=name)
    return got


# K3/K4 (the tensor-core kernels of csrc/flex_bwd_tc.cu) at every bucket
# length, at serving and training batch sizes and at both head widths, with
# and without attention dropout; and the ragged shapes of the first port
@pytest.mark.parametrize("b,n,dh,rate", [
    *[(b, n, dh, rate) for n in (37, 75, 150) for b in (1, 4, 64) for dh in (64, 96)
      for rate in (0.0, RATE)],
    (3, 37, 64, RATE), (3, 75, 64, RATE), (2, 130, 96, RATE),
    # the long-AST configs' N 512
    (2, 512, 64, RATE), (2, 512, 96, RATE), (4, 512, 64, 0.0)])
def test_sbm_sampled_backward_matches_plain(dev, b, n, dh, rate):
    q, k, v, spec, aux, dseed = _train_case("sbm_sampled", b, n, dh, dev, seed=1)
    go = torch.randn(q.shape, generator=torch.Generator().manual_seed(5)).to(dev)
    _check_sampled_backward(q, k, v, spec, aux, rate, dseed, go)


def test_sampled_backward_repeats_bit_for_bit(dev):
    """Two backward passes of K3/K4 on the same inputs give the same bits:
    every output row belongs to one block and every sum runs in one order."""
    from csat_tpu_torch.ops import flex_core

    q, k, v, spec, aux, dseed = _train_case("sbm_sampled", 64, 150, 64, dev, seed=4, h=8)
    go = torch.randn(q.shape, generator=torch.Generator().manual_seed(8)).to(dev)
    first = _sampled_grads(flex_core.flex_attention, q, k, v, spec, aux, RATE, dseed, go)[1]
    second = _sampled_grads(flex_core.flex_attention, q, k, v, spec, aux, RATE, dseed, go)[1]
    for name, a, w in zip(("dq", "dk", "dv", "dr", "dkh"), first, second):
        assert torch.equal(a, w), name


@pytest.mark.parametrize("n_real", [16, 20])
def test_sampled_backward_with_keys_padded_past_a_row_group(dev, n_real):
    """Every key from ``n_real`` on is padding in every sample: whole 16-key
    groups past it carry no attention weight, so the kernels skip their
    dh-deep products, yet their raw graph still brings the graph_sum
    cotangent to dK̂ there."""
    from csat_tpu_torch.ops.mods import sbm_sampled_mod

    g = torch.Generator().manual_seed(n_real)
    b, h, n, dh, kk = 4, 4, 150, 64, 10
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)
    q, k, v = rnd(b, h, n, dh), rnd(b, h, n, dh), rnd(b, h, n, dh)
    pad = torch.zeros((b, n), dtype=torch.bool)
    pad[:, n_real:] = True
    s_aff = torch.softmax(torch.randn(h, kk * kk, generator=g), -1).reshape(h, kk, kk).to(dev)
    spec, aux = sbm_sampled_mod(rnd(b, h, n, kk).sigmoid(), rnd(b, h, n, kk).sigmoid(), s_aff,
                                pad.to(dev), torch.tensor([11], dtype=torch.int32, device=dev))
    dseed = torch.tensor([12], dtype=torch.int32, device=dev)
    go = rnd(b, h, n, dh)
    _, dk, dv, _, dkh = _check_sampled_backward(q, k, v, spec, aux, RATE, dseed, go)
    assert dk[:, :, n_real:].abs().sum() == 0 and dv[:, :, n_real:].abs().sum() == 0
    assert dkh[:, :, n_real:].abs().sum() > 0


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


DEAD_FROM = (20, 70, 100, 150)  # "dead_rows": sample i's query rows from DEAD_FROM[i % 4] on


def _expected_case(b, n, dh, dev, floor, variant, seed=2, h=4, kk=10):
    """Leaves (q, k, v, R, K̂) and the key-pad mask of an expected-mod call.
    ``ties``: exact ties of R·K̂ᵀ at both clip bounds (0.99, and ``floor``)
    and at 0; ``padded_tile``: every key from 60 on is padding in row 0, so
    k-tiles 1.. are dead there; ``dead_rows``: sample i's rows and keys past
    ``DEAD_FROM[i % 4]`` are padding, and those rows' R is 0 (at floor 0
    they have no live weight: lse −1e30, and R·K̂ᵀ == 0 leaves the clip
    gate half open)."""
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
    if variant == "dead_rows":
        for i in range(b):
            m = DEAD_FROM[i % 4]
            pad[i] = False
            pad[i, m:] = True
            r[i, :, m:] = 0.0
    return [t.to(dev) for t in (q, k, v, r, kh)], pad.to(dev)


def _expected_grads(fn, leaves0, spec, pad, rate, dseed, go):
    """``out``, the extras and the gradients (q, k, v, R, K̂) of ``Σ out·go +
    1e-3 · Σ graph_sum`` through ``fn`` (the kernels or the plain path)."""
    leaves = [t.detach().clone().requires_grad_() for t in leaves0]
    out, ex = fn(*leaves[:3], spec, (leaves[3], leaves[4], pad.float()), rate, dseed)
    loss = torch.sum(out * go) + 1e-3 * torch.sum(ex["graph_sum"])
    return out.detach(), ex, torch.autograd.grad(loss, leaves)


# K8/K9 (the expected mod on the tensor-core template of csrc/flex_bwd_tc.cu)
# at K3/K4's grid — every bucket length, serving and training batch sizes,
# both head widths, with and without dropout — and the ragged shapes of the
# first port, with exact clip ties, whole padded key tiles and whole groups
# of dead query rows, at the default floor and at floor 0
@pytest.mark.parametrize("b,n,dh,rate,floor,variant", [
    *[(b, n, dh, rate, 0.01, "plain") for n in (37, 75, 150) for b in (1, 4, 64)
      for dh in (64, 96) for rate in (0.0, RATE)],
    (3, 37, 64, RATE, 0.01, "plain"), (3, 75, 64, 0.0, 0.01, "ties"),
    (2, 130, 96, RATE, 0.01, "ties"), (2, 150, 64, RATE, 0.0, "ties"),
    (2, 150, 64, RATE, 0.01, "padded_tile"), (2, 150, 64, 0.0, 0.0, "padded_tile"),
    (4, 150, 64, 0.0, 0.0, "dead_rows"), (4, 150, 96, RATE, 0.0, "dead_rows")])
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

    before = build.launch_counts()
    out, ex, got = _expected_grads(flex_core.flex_attention, leaves0, spec, pad, rate, dseed, go)
    ref, rex, want = _expected_grads(flex_core.flex_reference, leaves0, spec, pad, rate, dseed,
                                     go)
    torch.cuda.synchronize()
    after = build.launch_counts()
    for fn in ("flex_fwd_sbm_expected", "flex_bwd_q_sbm_expected", "flex_bwd_k_sbm_expected"):
        assert after[fn] == before[fn] + 1, fn
    torch.testing.assert_close(out, ref, atol=SBM_TOL, rtol=0)
    torch.testing.assert_close(ex["graph_sum"], rex["graph_sum"], rtol=1e-5, atol=1e-3)
    if variant == "padded_tile":
        assert ex["skipped_blocks"][0].min() >= 2 * 3   # k-tiles 1, 2 × 3 q-tiles
        assert got[4][0, :, 64:].abs().sum() > 0        # gs still reaches dK̂ there
    if variant == "dead_rows":
        for i in range(b):
            m = DEAD_FROM[i % 4]
            assert torch.all(ex["lse"][i, :, m:] == flex_core.NEG)  # no live weight
            assert torch.all(out[i, :, m:] == 0)
            if m < n:  # the half-open gate brings gs to their dR
                assert got[3][i, :, m:].abs().min() > 0
    for name, a, w in zip(("q", "k", "v", "r", "k_hat"), got, want):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, w, atol=GRAD_TOL, rtol=GRAD_TOL, msg=name)


def test_expected_backward_repeats_bit_for_bit(dev):
    """Two backward passes of K8/K9 on the same inputs give the same bits:
    every output row belongs to one block and every sum runs in one order."""
    from csat_tpu_torch.ops import flex_core
    from csat_tpu_torch.ops.mods import SBMExpectedSpec

    leaves0, pad = _expected_case(64, 150, 64, dev, 0.01, "plain", seed=4, h=8)
    spec = SBMExpectedSpec(n=150, heads=8, kk=10, floor=0.01)
    dseed = torch.tensor([779], dtype=torch.int32, device=dev)
    go = torch.randn(leaves0[0].shape, generator=torch.Generator().manual_seed(8)).to(dev)
    for rate in (0.0, RATE):
        first = _expected_grads(flex_core.flex_attention, leaves0, spec, pad, rate, dseed, go)[2]
        second = _expected_grads(flex_core.flex_attention, leaves0, spec, pad, rate, dseed, go)[2]
        for name, a, w in zip(("dq", "dk", "dv", "dr", "dkh"), first, second):
            assert torch.equal(a, w), (name, rate)


def test_mod_without_a_kernel_raises_on_the_card(dev):
    import dataclasses

    from csat_tpu_torch.ops import flex_core

    @dataclasses.dataclass(frozen=True)
    class Unknown:
        name = "unknown"

    q = torch.zeros((1, 1, 8, 64), device=dev)
    with pytest.raises(NotImplementedError, match="unknown"):
        flex_core.flex_attention(q, q, q, Unknown(), ())


# ---------------------------------------------------------------------------
# the other encoders: the laplacian PE, full attention and treepos on the
# card, and the java width's SBM kernels on java's own inputs
# ---------------------------------------------------------------------------

def _ast_adjacency(n_pad, sizes, seed):
    """(adj, num_node) of random ASTs padded to ``n_pad`` through the collate."""
    import numpy as np

    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.dataset import collate
    from csat_tpu_torch.data.synthetic import random_ast, request_sample

    cfg = get_config("python", max_src_len=n_pad)
    rng = np.random.default_rng(seed)
    samples = [request_sample(random_ast(rng, int(m)), cfg, 100) for m in sizes]
    arrs = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    arrs["tgt_seq"] = arrs["target"] = np.zeros((len(sizes), 1), np.int32)
    batch = collate(arrs, n_pad)
    return torch.as_tensor(batch.adj), torch.as_tensor(batch.num_node)


@pytest.mark.parametrize("n_pad", [37, 75, 150])
def test_laplacian_pe_on_card_meets_invariants(dev, n_pad):
    """The card's eigenvectors (cuSOLVER, in float64) form a basis of the
    same eigenspaces as the CPU's: the same zero padding, orthonormal
    columns, ``‖Lv − λv‖ ≤ 1e-4`` and eigenvalues within 1e-5 of the
    CPU's."""
    from csat_tpu_torch.models.pe import laplacian_pe, padded_laplacian

    adj, num_node = _ast_adjacency(n_pad, (n_pad, n_pad - 6, n_pad // 2, 7), seed=n_pad)
    card = laplacian_pe(adj.to(dev), num_node.to(dev), n_pad).cpu().double()
    cpu = laplacian_pe(adj, num_node, n_pad).double()
    lap = padded_laplacian(adj, num_node).double()
    for i, n in enumerate(num_node.tolist()):
        assert not card[i, n:].any() and not card[i, :, n:].any()
        v, w, lp = card[i, :n, :n], cpu[i, :n, :n], lap[i, :n, :n]
        torch.testing.assert_close(v.T @ v, torch.eye(n, dtype=v.dtype), atol=1e-5, rtol=0)
        lam = torch.einsum("ji,jk,ki->i", v, lp, v)
        assert (lp @ v - v * lam).abs().max() <= 1e-4
        torch.testing.assert_close(lam, torch.einsum("ji,jk,ki->i", w, lp, w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["python_full_att", "python_treepos"])
def test_variant_forward_on_card_matches_cpu(dev, name):
    """A full-attention and a treepos model (heads 64 wide, as the kernels
    are built) from one seed: the card's deterministic forward, through K1
    or K2, equals the CPU's plain forward within FLEX_TOL."""
    import numpy as np

    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.dataset import batch_to_device, collate
    from csat_tpu_torch.data.synthetic import random_ast, train_sample
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.ops import build

    cfg = get_config(name, eval_graph="expected", num_heads=2, hidden_size=128,
                     sbm_enc_dim=128, pegen_dim=128, pe_dim=64, dim_feed_forward=256,
                     num_layers=2, sbm_layers=2, clusters=(10, 10), decoder_layers=1)
    rng = np.random.default_rng(1)
    samples = [train_sample(random_ast(rng, n), cfg, 500, 700, rng) for n in (20, 150, 90, 7)]
    arrs = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    batch = collate(arrs, cfg.max_src_len)
    out = {}
    for device in ("cuda", "cpu"):
        model = CSATrans(cfg, 500, 700, device=device, seed=4)
        before = build.launch_counts()
        with torch.no_grad():
            out[device] = model(batch_to_device(batch, torch.device(device)))[0].cpu()
        launched = {fn for fn, c in build.launch_counts().items() if c > before[fn]}
        kernel = "flex_fwd_cse" if cfg.full_att else "flex_fwd_sbm_expected"
        assert launched == ({kernel} if device == "cuda" else set())
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=2e-5, rtol=0)


def test_dh96_kernels_on_java_captured_inputs(dev):
    """K2 and K7 at java's SBM width (dh 96) on what java's first SBM layer
    gives them: the largest prefill group of a serving drain (K2) and a
    shared-noise training step at B 64 (K7, its graph and dropout seed)."""
    import chip_smoke
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.ops import flex_core

    serve_cfg = get_config("java", eval_graph="expected", serve_slots=8, max_tgt_len=8)
    k2 = chip_smoke.capture_prefill_inputs(serve_cfg, *chip_smoke.make_requests(serve_cfg, 8),
                                           layer="sbm")
    train_cfg = get_config("java")
    k7 = chip_smoke.capture_sbm_inputs(train_cfg, chip_smoke.train_batch(train_cfg, 64))[0]
    for cap, tol in ((k2, 2e-5), (k7, GRAPH_TOL)):
        q, k, v, spec, aux, rate, dseed = (cap[key] for key in (
            "q", "k", "v", "spec", "aux", "rate", "dseed"))
        assert q.shape[-1] == 96
        out, ex = flex_core.flex_attention(q, k, v, spec, aux, rate, dseed)
        ref, rex = flex_core.flex_reference(q, k, v, spec, aux, rate, dseed)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, atol=tol, rtol=0)
        torch.testing.assert_close(ex["lse"], rex["lse"], atol=tol, rtol=0)
        assert torch.equal(ex["skipped_blocks"],
                           flex_core.reference_block_skip(spec, aux, flex_core.geometry(q)))


# the production precision: bf16 compute with f32 attention islands, bf16 /
# int8 KV pages, and java's dh-96 SBM kernels under its counter gate and
# expected-graph gradient, at a small size (heads 64 and 96 wide, as the
# kernels are built)
SMALL_DH64 = dict(num_heads=2, hidden_size=128, sbm_enc_dim=128, pegen_dim=128, pe_dim=64,
                  dim_feed_forward=256, num_layers=2, sbm_layers=2, clusters=(10, 10),
                  decoder_layers=1)


def _small_batch(cfg, sizes=(20, 150, 90, 7), seed=1):
    import numpy as np

    from csat_tpu_torch.data.dataset import collate
    from csat_tpu_torch.data.synthetic import random_ast, train_sample

    rng = np.random.default_rng(seed)
    samples = [train_sample(random_ast(rng, n), cfg, 500, 700, rng) for n in sizes]
    return collate({k: np.stack([s[k] for s in samples]) for k in samples[0]}, cfg.max_src_len)


@pytest.mark.parametrize("compute,pages", [("bfloat16", "bfloat16"), ("float32", "int8"),
                                           ("bfloat16", "int8")])
def test_paged_kernel_on_quantized_drain(dev, compute, pages):
    """K5 on one self- and one cross-attention launch from the middle of a
    drain whose pool stores ``pages``: the kernel reads the stored bytes and
    equals the plain path's dequantise-on-read within 1e-5."""
    import chip_smoke
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.ops import build, paged_decode as pd
    from csat_tpu_torch.serve.pages import KV_PAGE_DTYPES

    cfg = get_config("python", eval_graph="expected", serve_slots=4, max_tgt_len=12,
                     compute_dtype=compute, serve_kv_page_dtype=pages)
    got = chip_smoke.capture_decode_inputs(cfg, *chip_smoke.make_requests(cfg, 6))
    for side in ("self", "cross"):
        inputs, merge = got[side]["inputs"], got[side]["merge"]
        assert inputs[1].dtype == KV_PAGE_DTYPES[pages]
        before = build.launch_counts()["paged_decode"]
        out, skipped = pd.paged_attend(*inputs, **merge)
        ref, ref_skip = pd._attend_reference(*inputs, merge.get("idx"), merge.get("k_tok"),
                                             merge.get("v_tok"))
        torch.cuda.synchronize()
        assert build.launch_counts()["paged_decode"] == before + 1
        live = ~inputs[6].all(dim=1)
        torch.testing.assert_close(out[live], ref[live], atol=1e-5, rtol=0)
        assert torch.equal(skipped, ref_skip)


def test_bf16_model_forward_on_card_matches_cpu(dev):
    """The same bf16 model from one seed, its deterministic expected-graph
    forward on the card (K1, K2, cuBLAS bf16 GEMMs) and on the CPU (plain
    paths): log-probs within 1e-2 relative L2.  The two sum their bf16
    products in other orders, and a rounding flip spreads through the later
    layers at bf16's resolution (2^-8 relative); f32, by contrast, agrees
    within 2e-5 (``test_variant_forward_on_card_matches_cpu``)."""
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.dataset import batch_to_device
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.ops import build

    cfg = get_config("python", eval_graph="expected", compute_dtype="bfloat16", **SMALL_DH64)
    batch = _small_batch(cfg)
    out = {}
    for device in ("cuda", "cpu"):
        model = CSATrans(cfg, 500, 700, device=device, seed=4)
        assert model.dtype == torch.bfloat16
        before = build.launch_counts()
        with torch.no_grad():
            out[device] = model(batch_to_device(batch, torch.device(device)))[0].cpu()
        launched = {fn for fn, c in build.launch_counts().items() if c > before[fn]}
        assert launched == ({"flex_fwd_cse", "flex_fwd_sbm_expected"} if device == "cuda"
                            else set())
    assert out["cuda"].dtype == torch.float32
    rel = torch.linalg.vector_norm(out["cuda"] - out["cpu"]) / torch.linalg.vector_norm(out["cpu"])
    assert float(rel) <= 1e-2, float(rel)


@pytest.mark.parametrize("mode", ["shared", "counter"])
def test_bf16_step_and_same_graph_gates(dev, mode):
    """A bf16 kernel step against a bf16 plain step on the card within the
    precision phase's limits, and each SBM layer's kernels against the plain
    ones on that layer's f32 inputs at the f32 limits (0 edges apart)."""
    import chip_smoke
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.dataset import batch_to_device

    cfg = get_config("python", compute_dtype="bfloat16", noise_mode=mode, **SMALL_DH64)
    batch = batch_to_device(_small_batch(cfg), dev)
    model, state, _, metrics, launches, rec = chip_smoke.step_gate(
        cfg, batch, loss_rtol=chip_smoke.BF16_LOSS_RTOL, gnorm_rtol=chip_smoke.BF16_GNORM_RTOL)
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in state.params.values())
    kernel = "flex_fwd_sbm_graph" if mode == "shared" else "flex_fwd_sbm_sampled"
    assert launches["flex_fwd_cse"] > 0 and launches[kernel] > 0
    res = chip_smoke.same_graph_gate(cfg, batch)
    assert all(layer["ok"] and layer["edges_apart"] == 0 for layer in res["layers"])


def test_dh96_counter_and_expected_gates(dev, tmp_path, monkeypatch):
    """Java's SBM width (dh 96) through the counter gate (K6, K3, K4) and
    the expected-graph gradient (K2, K8, K9), kernels against the plain paths
    on the card at the f32 limits."""
    import chip_smoke
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.dataset import batch_to_device

    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    cfg = get_config("java", **{**SMALL_DH64, "sbm_enc_dim": 192, "pe_dim": 64})
    assert cfg.head_dim == 96
    batch = batch_to_device(_small_batch(cfg), dev)
    counter = cfg.replace(noise_mode="counter")
    *_, launches, _ = chip_smoke.step_gate(counter, batch)
    assert all(launches[fn] > 0 for fn in ("flex_fwd_sbm_sampled", "flex_bwd_q_sbm_sampled",
                                           "flex_bwd_k_sbm_sampled"))
    assert all(layer["ok"] for layer in chip_smoke.same_graph_gate(counter, batch)["layers"])
    expected = cfg.replace(eval_graph="expected")
    _, _, counts, _ = chip_smoke.expected_grad_gate(expected, batch, "err.json")
    assert all(counts[fn] > 0 for fn in ("flex_fwd_sbm_expected", "flex_bwd_q_sbm_expected",
                                         "flex_bwd_k_sbm_expected"))
    res = chip_smoke.same_graph_gate(expected, batch, deterministic=True)
    assert all(layer["ok"] for layer in res["layers"])


# ---------------------------------------------------------------------------
# the trainer's resilience on the card: the device-side guard, the prefetch
# copy stream, the watchdog's device probe
# ---------------------------------------------------------------------------

def _bits(t):
    return t.detach().reshape(-1).view(torch.int32)


def test_guarded_update_on_card_is_bitwise(dev):
    """AdamW on the card: a rejected (``ok`` false) update with NaN
    gradients leaves parameters, moments and count bitwise as they were; an
    accepted one is bitwise the unguarded update."""
    from csat_tpu_torch.train.optimizer import AdamW

    g = torch.Generator().manual_seed(0)
    shapes = {"w": (512, 2048), "b": (2048,), "s": (), "e": (37, 7)}
    params = {k: torch.randn(s, generator=g).to(dev) for k, s in shapes.items()}
    twin = {k: p.clone() for k, p in params.items()}
    opt = AdamW(1e-4, eps=1e-6)
    st, st_twin = opt.init(params), opt.init(twin)
    for _ in range(3):
        grads = {k: torch.randn(s, generator=g).to(dev) for k, s in shapes.items()}
        opt.update(params, grads, st, ok=torch.ones((), dtype=torch.bool, device=dev))
        opt.update(twin, grads, st_twin)
    for a, b in ((params, twin), (st.mu, st_twin.mu), (st.nu, st_twin.nu)):
        for k in a:
            assert torch.equal(_bits(a[k]), _bits(b[k])), k
    before = [_bits(t).clone() for d in (params, st.mu, st.nu) for t in d.values()]
    nan = {k: torch.full(s, float("nan"), device=dev) for k, s in shapes.items()}
    opt.update(params, nan, st, ok=torch.zeros((), dtype=torch.bool, device=dev))
    after = [_bits(t) for d in (params, st.mu, st.nu) for t in d.values()]
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert int(st.count) == 3


def _host_batches(n_batches, b=8, n=64, seed=0):
    import numpy as np

    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.dataset import collate
    from csat_tpu_torch.data.synthetic import random_ast, train_sample

    cfg = get_config("python", max_src_len=n)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        samples = [train_sample(random_ast(rng, int(rng.integers(10, n))), cfg, 300, 400, rng)
                   for _ in range(b)]
        out.append(collate({k: np.stack([s[k] for s in samples]) for k in samples[0]}, n))
    return out


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_copy_stream_delivers_the_plain_batches(dev, depth):
    """``prefetch_batches`` on the card while the consuming stream is busy
    (a queued ``torch.cuda._sleep``): the copies run on the worker's stream,
    the consumer's stream waits for them, and every field equals
    ``batch_to_device``'s, on the card in its compute dtype."""
    from csat_tpu_torch.data.dataset import DEVICE_FIELDS, batch_to_device
    from csat_tpu_torch.train.loop import prefetch_batches

    batches = _host_batches(6)
    want = [batch_to_device(b, dev) for b in batches]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e8))  # ~0.1 s of the consumer's stream busy
    got = []
    for batch in prefetch_batches(iter(batches), dev, depth=depth):
        # read on the consumer's stream right away: correct only if it waited
        got.append({name: getattr(batch, name).clone() for name, _ in DEVICE_FIELDS})
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name, dtype in DEVICE_FIELDS:
            t = g[name]
            assert t.device.type == "cuda" and t.dtype == dtype == getattr(w, name).dtype
            assert torch.equal(t, getattr(w, name)), name


def test_device_probe_trips_on_a_wedged_stream(dev):
    """The probe queues behind the training stream: with that stream wedged
    by ``torch.cuda._sleep`` the watchdog's device leg trips while the host
    keeps beating; with the stream free it does not."""
    import threading
    import time

    from csat_tpu_torch.resilience import StepWatchdog, device_liveness_probe

    probe = device_liveness_probe(dev)
    probe()
    tripped, what = threading.Event(), []
    with StepWatchdog(0.4, on_timeout=tripped.set, log=lambda m: None, probe=probe,
                      probe_interval_s=0.05, on_trip=lambda w, s: what.append(w)) as wd:
        t0 = time.monotonic()
        torch.cuda._sleep(int(4e9))  # ~2 s
        while not tripped.is_set() and time.monotonic() - t0 < 6:
            wd.beat()
            time.sleep(0.02)
    torch.cuda.synchronize()
    assert tripped.is_set() and what == ["no completed device probe"]

    healthy = threading.Event()
    with StepWatchdog(0.4, on_timeout=healthy.set, log=lambda m: None, probe=probe,
                      probe_interval_s=0.05) as wd:
        end = time.monotonic() + 1.0
        x = torch.ones(256, 256, device=dev)
        while time.monotonic() < end:
            x = (x @ x).clamp_(-1, 1)  # the stream busy with short kernels
            wd.beat()
            time.sleep(0.02)
    torch.cuda.synchronize()
    assert not healthy.is_set()


# ---------------------------------------------------------------------------
# serving as production runs it: shared cross chains, scrubbed reuse, the
# admission-side surgeries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_paged_kernel_on_a_cross_chain_shared_by_slots(dev, dtype):
    """A prefix-cache hit: three slots' tables name one cross chain (two with
    the same mask, one a shorter request's); K5 against its plain version,
    and each sharer's output equal to the same query on a private copy of
    the chain."""
    from csat_tpu_torch.ops import build, paged_decode as pd

    g = torch.Generator().manual_seed(11)
    s, h, page, dh, width = 4, 8, 16, 64, 150
    nb = -(-width // page)
    n_pages = 1 + 2 * nb
    raw = [torch.randn(n_pages, h, page, dh, generator=g) for _ in range(2)]
    for r in raw:
        r[pd.NULL_PAGE] = 0.0
    (pk, sk), (pv, sv) = (pd.quantize_kv(r, dtype) for r in raw)
    shared = torch.arange(1, 1 + nb, dtype=torch.int32)
    private = torch.arange(1 + nb, 1 + 2 * nb, dtype=torch.int32)
    for x in (pk, pv, sk, sv):  # the private chain: a copy of the shared one
        x[1 + nb:1 + 2 * nb] = x[1:1 + nb]
    table = torch.stack([shared, shared, shared, private])
    mask = torch.ones((s, width), dtype=torch.bool)
    mask[0, :120] = mask[1, :120] = mask[3, :120] = False
    mask[2, :37] = False
    q0 = torch.randn(1, h, 1, dh, generator=g)
    q = torch.cat([q0, torch.randn(1, h, 1, dh, generator=g), torch.randn(1, h, 1, dh,
                                                                           generator=g), q0])
    inputs = [t.to(dev) for t in (q, pk, pv, sk, sv, table, mask)] + [width]
    before = build.launch_counts()["paged_decode"]
    out, _ = pd.paged_attend(*inputs)
    torch.cuda.synchronize()
    assert build.launch_counts()["paged_decode"] == before + 1
    ref, _ = pd.paged_attend(*[t.cpu() if torch.is_tensor(t) else t for t in inputs])
    torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=0)
    assert torch.equal(out[0], out[3])  # shared chain = a private copy, bit for bit


def _drill_cfg():
    from csat_tpu_torch.configs import get_config

    return get_config("python", eval_graph="expected", serve_slots=4, max_tgt_len=12)


def test_paged_kernel_on_self_pages_reused_after_a_nan_drill(dev, tmp_path):
    """A NaN drill poisons slot 0's self page; the request retires FAILED and
    its page goes back to the free list; a prefix hit admitted next gets that
    page, scrubbed by ``attach``, and decodes exactly its original's tokens —
    on the card (K5) as on the CPU (the plain path)."""
    import numpy as np

    from csat_tpu_torch.data.synthetic import random_ast, request_sample
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.resilience import FaultInjector
    from csat_tpu_torch.serve import ServeEngine

    cfg = _drill_cfg().replace(obs_postmortem_dir=str(tmp_path))
    rng = np.random.default_rng(1)
    samples = [request_sample(random_ast(rng, 5 + i), cfg, 500) for i in range(4)]
    got = {}
    for device in ("cuda", "cpu"):
        eng = ServeEngine(CSATrans(cfg, 500, 700, device=device, seed=3), cfg, device=device,
                          fault_injector=FaultInjector(serve_nan_logits=[(1, 0)]))
        ids = [eng.submit(s, 6) for s in samples]
        eng.tick()
        victim = set(eng._slot_meta[0].self_chain)
        eng.tick()
        eng.tick()
        eng.fault_injector = None
        assert eng.poll(ids[0]).status == "FAILED"
        hit = eng.submit(samples[1], 6)
        eng.tick()
        slot = next(r.slot for r in eng._slots if r is not None and r.id == hit)
        assert victim & set(eng._slot_meta[slot].self_chain)
        eng.drain()
        assert eng.stats.prefix_hits == 1 and eng.page_leaks() == 0
        res = [eng.poll(i) for i in ids + [hit]]
        assert all(r.ok for r in res[1:])
        np.testing.assert_array_equal(res[-1].tokens, res[1].tokens)
        got[device] = [r.tokens.tolist() for r in res]
        eng.close()
    assert got["cuda"] == got["cpu"]


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_attach_and_release_on_card_equal_cpu(dev, kv):
    """``attach`` (scrub fresh self pages, tables, mask, BOS, budget) and
    ``release`` (budget 0, null tables) on the card leave the pool exactly as
    on the CPU."""
    import numpy as np

    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.serve.pages import attach, init_paged_pool, page_geometry, release

    cfg = _drill_cfg().replace(serve_kv_page_dtype=kv)
    geo = page_geometry(cfg)
    pools = {}
    for device in ("cuda", "cpu"):
        pool = init_paged_pool(CSATrans(cfg, 500, 700, device=device, seed=3), 4, geo, kv)
        g = torch.Generator().manual_seed(5)
        for e in pool.pages:
            for key in ("k", "v"):
                vals = torch.randn(e[key].shape, generator=g) * 20
                e[key].copy_(vals.to(e[key].dtype).to(device))
                e[f"{key}_scale"].copy_(torch.rand(e[f"{key}_scale"].shape, generator=g))
            e["k_scale"][3] = float("nan")  # a page a NaN drill poisoned
        smask = np.ones((2, geo.mem_len), bool)
        smask[0, :30] = smask[1, :75] = False
        attach(pool, geo, [2, 0], [6, 11], [[3], [4]], [[7, 8], [7, 8, 9, 10, 11]], smask)
        release(pool, [0, 3])
        pools[device] = pool
    for name in ("self_pt", "cross_pt", "src_mask", "tok", "pos", "limit", "done", "prev_pad",
                 "toks"):
        assert torch.equal(getattr(pools["cuda"], name).cpu(), getattr(pools["cpu"], name)), name
    for a, b in zip(pools["cuda"].pages, pools["cpu"].pages):
        for key in a:
            assert torch.equal(a[key].cpu(), b[key]), key  # no NaN left: page 3 was scrubbed
        assert torch.equal(a["k_scale"][3], torch.ones_like(a["k_scale"][3]))


# ---------------------------------------------------------------------------
# the long-AST configs and data parallelism
# ---------------------------------------------------------------------------

# K1 on real AST distances at N 512 with python_long's relative tables (512
# rows): ASTs of 10 to 512 nodes, and of 10 to 300 nodes at N 300
@pytest.mark.parametrize("b,n", [(2, 512), (8, 512), (4, 300)])
def test_cse_kernel_on_long_ast_distances(dev, b, n):
    from csat_tpu_torch.ops import flex_core

    q, k, v, spec, aux = _ast_cse_case(b, n, "ast", dev, config="python_long")
    assert spec.r_len == 512
    out, ex = flex_core.flex_attention(q, k, v, spec, aux)
    ref, rex = flex_core.flex_reference(q, k, v, spec, aux)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(ex["lse"], rex["lse"], atol=2e-5, rtol=0)
    assert torch.equal(ex["skipped_blocks"],
                       flex_core.reference_block_skip(spec, aux, flex_core.geometry(q)))


# K6, K3/K4 and K7 at a batch·head offset (rank r of a data-parallel step
# holding rows [b0, b0 + B) of 8 heads: bh0 = 8·b0) against the plain path,
# whose field at the offset is the slice of the global one
@pytest.mark.parametrize("mod,b,n,dh,b0", [
    ("sbm_sampled", 4, 150, 64, 32), ("sbm_sampled", 2, 512, 64, 32),
    ("sbm_sampled", 2, 512, 96, 32), ("sbm_graph", 4, 150, 64, 32),
    ("sbm_graph", 2, 512, 96, 1)])
def test_kernels_at_a_batch_head_offset_match_the_plain_slice(dev, mod, b, n, dh, b0):
    from csat_tpu_torch.ops import build, flex_core
    from csat_tpu_torch.ops.hashrng import uniform_field

    h = 8
    q, k, v, spec, aux, dseed = _train_case(mod, b, n, dh, dev, seed=3, h=h, bh0=b0 * h)
    assert spec.bh0 == b0 * h
    whole = uniform_field(dseed, b0 + b, h, n, n, spec.stride)
    assert torch.equal(uniform_field(dseed, b, h, n, n, spec.stride, bh0=spec.bh0),
                       whole[b0:])
    out, ex = flex_core.flex_attention(q, k, v, spec, aux, RATE, dseed)
    ref, rex = flex_core.flex_reference(q, k, v, spec, aux, RATE, dseed)
    at_zero, _ = flex_core.flex_attention(q, k, v, dataclasses.replace(spec, bh0=0), aux,
                                          RATE, dseed)
    torch.cuda.synchronize()
    assert not torch.equal(at_zero, out)  # the offset moves the draws
    if mod == "sbm_graph":
        torch.testing.assert_close(out, ref, atol=GRAPH_TOL, rtol=0)
        return
    near_rows, near_count = _near_rows(spec, aux)
    assert torch.all((ex["graph_sum"] - rex["graph_sum"]).abs() <= near_count)
    torch.testing.assert_close(out[~near_rows], ref[~near_rows], atol=SBM_TOL, rtol=0)
    go = torch.randn(q.shape, generator=torch.Generator().manual_seed(9)).to(dev)
    before = build.launch_counts()
    _check_sampled_backward(q, k, v, spec, aux, RATE, dseed, go)
    assert build.launch_counts()["flex_bwd_q_sbm_sampled"] == before["flex_bwd_q_sbm_sampled"] + 1


# the seq and pipe axes on the card: two gloo ranks sharing cuda:0, as the
# parallel phase of chip_smoke.py runs them (gloo stages CUDA tensors
# through the host)

def test_seq_collectives_on_cuda_tensors_over_gloo(dev, tmp_path):
    import numpy as np

    import torch_dist

    ranks = torch_dist.run_ranks(torch_dist.card_collectives, 2, tmp_path, timeout=180)
    x = [np.arange(6.0, dtype=np.float32).reshape(2, 3) + 10 * r for r in range(2)]
    w = np.arange(12.0, dtype=np.float32).reshape(4, 3)
    for r, got in enumerate(ranks):
        assert got["on_card"]
        np.testing.assert_array_equal(got["a"], x[1 - r])
        np.testing.assert_array_equal(got["b"], np.full((4,), float(1 - r), np.float32))
        np.testing.assert_array_equal(got["c"], np.zeros((2, 3)) if r == 0 else x[0])
        np.testing.assert_array_equal(got["g"], np.concatenate(x))
        np.testing.assert_array_equal(got["s"], x[0] + x[1])
        # the hop's cotangent comes back from the rank it went to (weight 2 - r),
        # the open hop's to rank 0 only, the gather's is the ranks' sum of its
        # rows, the sum's the ranks' sum
        want = (2 - r) + (3 if r == 0 else 0) + 2 * w[2 * r:2 * r + 2] + 2
        np.testing.assert_array_equal(got["x_grad"], want)
        np.testing.assert_array_equal(got["y_grad"], np.ones(4, np.float32))


def test_gpipe_step_through_kernels_equals_plain(dev, tmp_path):
    """One wavefront pass and its backward over two stages (one SBM block
    each, 4 microbatches, attention dropout 0.2) through K6 / K3 / K4 against
    the plain path on the card, the same ranks: output within 1e-4, the
    per-head sparsity within 1e-4 (a sampled edge may flip where the second
    block's inputs differ by rounding), every gradient within 1e-3 relative
    (of its largest entry)."""
    import numpy as np

    import torch_dist
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.ops import build

    cfg = get_config("python_pp", sbm_layers=2, clusters=(10, 10), sbm_enc_dim=128,
                     num_heads=2, pe_dim=64, max_src_len=64, batch_size=8, dropout=0.0,
                     attention_dropout=0.2, mesh_shape=(("data", 1), ("pipe", 2)))
    blocks = CSATrans(cfg, 50, 60, device="cpu", seed=1).encoder.blocks.state_dict()
    rng = np.random.default_rng(0)
    payload = dict(cfg=cfg, state_dict=blocks, deterministic=False, remat=False,
                   x=rng.standard_normal((8, 64, 128)).astype(np.float32),
                   pad=rng.random((8, 64)) < 0.2,
                   seeds=rng.integers(0, 2**31 - 1, (2, 2, 4)).astype(np.int32),
                   go=rng.standard_normal((8, 64, 128)).astype(np.float32),
                   gsp=rng.standard_normal((2, 2)).astype(np.float32))
    build.build_all()  # once here, not in both ranks at once
    ranks = torch_dist.run_ranks(torch_dist.card_gpipe, 2, tmp_path, payload, timeout=300)
    for r in ranks:
        k, p = r["kernel"], r["plain"]
        for fn in ("flex_fwd_sbm_sampled", "flex_bwd_q_sbm_sampled", "flex_bwd_k_sbm_sampled"):
            assert k["launches"][fn] > 0, fn
        np.testing.assert_allclose(k["out"], p["out"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(k["sparsity"], p["sparsity"], atol=1e-4, rtol=0)
        for name, g in p["grads"].items():
            assert np.max(np.abs(k["grads"][name] - g)) <= 1e-3 * max(np.max(np.abs(g)), 1e-6), name
        assert np.max(np.abs(k["x_grad"] - p["x_grad"])) <= 1e-3 * np.max(np.abs(p["x_grad"]))
