"""The port's CUDA kernels against their plain versions, on the card.

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
