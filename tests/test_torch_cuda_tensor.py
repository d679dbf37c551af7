"""The kernels at a head shard on the card: a ``model`` axis's member runs
its heads ``[h0, h0 + h)`` of ``h_total`` with the hash streams at the
global batch·head index ``bh0 + b·h_total + h``.  These tests need an
NVIDIA GPU; they carry the ``cuda`` marker and skip elsewhere (run them on a
GPU machine with ``pytest tests/test_torch_cuda_tensor.py -m cuda
--noconftest``).

* K2, K6, K7, K3/K4 and K8/K9 at a head shard (model 2 and 4, with a batch
  offset too) against the head slice of the full launch on the same inputs
  — the same graph_sum, output within 1e-6, gradients within 1e-5
  (relative L2) — and against their plain versions;
* one shard (``h_total`` = H) reproduces the launch without a stride bit
  for bit; a stride below the launch's heads is refused;
* K1 on the heads of one plane (the plane's slice of ``rel`` / ``mask``,
  ``group`` = the shard's heads) against the full launch's slice.
"""

import dataclasses

import pytest
import torch

pytestmark = pytest.mark.cuda

RATE = 0.2
GS_COEF = 1e-3


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(mod, b, n, h, dev, seed=0, bh0=0):
    from csat_tpu_torch.ops.mods import sbm_expected_mod, sbm_graph_mod, sbm_sampled_mod

    g = torch.Generator().manual_seed(seed)
    kk, dh = 10, 64
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)
    q, k, v = rnd(b, h, n, dh), rnd(b, h, n, dh), rnd(b, h, n, dh)
    pad = torch.zeros((b, n), dtype=torch.bool)
    for i in range(b):
        pad[i, max(1, n - 1 - (i * 37) % n):] = i > 0
    pad = pad.to(dev)
    s_aff = torch.softmax(torch.randn(h, kk * kk, generator=g), -1).reshape(h, kk, kk).to(dev)
    if mod == "sbm_sampled":
        spec, aux = sbm_sampled_mod(torch.sigmoid(2 * rnd(b, h, n, kk)),
                                    torch.sigmoid(2 * rnd(b, h, n, kk)), s_aff, pad,
                                    torch.tensor([4321 + seed], dtype=torch.int32, device=dev),
                                    bh0=bh0)
    elif mod == "sbm_expected":
        spec, aux = sbm_expected_mod(torch.sigmoid(rnd(b, h, n, kk)),
                                     torch.sigmoid(rnd(b, h, n, kk)), s_aff, pad, bh0=bh0)
    else:
        graph = (torch.rand((b, h, n, n), generator=g) < 0.4).float().to(dev)
        spec, aux = sbm_graph_mod(graph, pad, bh0)
    return q, k, v, spec, aux


def _shard(mod, q, k, v, spec, aux, h0, h):
    part = lambda t: t[:, h0:h0 + h].contiguous()
    s_spec = dataclasses.replace(spec, heads=h, bh0=spec.bh0 + h0, h_total=spec.heads)
    s_aux = (part(aux[0]), aux[1]) if mod == "sbm_graph" else (part(aux[0]), part(aux[1]),
                                                                *aux[2:])
    return part(q), part(k), part(v), s_spec, s_aux


def _run(fn, q, k, v, spec, aux, rate, dseed, go, gs, grads):
    leaves = [t.detach().clone().requires_grad_(grads) for t in (q, k, v)]
    facs = [t.detach().clone().requires_grad_(grads) for t in aux[:2]] if grads else []
    out, ex = fn(*leaves, spec, (*facs, *aux[len(facs):]), rate, dseed)
    got = None
    if grads:
        got = torch.autograd.grad(torch.sum(out * go) + torch.sum(gs * ex["graph_sum"]),
                                  leaves + facs)
    return out.detach(), ex, got


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()).clamp_min(1e-30))


@pytest.mark.parametrize("mod,b,n,model,shard,b0", [
    (mod, b, n, model, shard, b0)
    for mod in ("sbm_sampled", "sbm_expected", "sbm_graph")
    for b, n, model, shard, b0 in ((64, 150, 2, 1, 0), (4, 75, 4, 2, 0), (2, 150, 2, 0, 3))])
def test_kernels_at_a_head_shard_match_the_full_slice(dev, mod, b, n, model, shard, b0):
    from csat_tpu_torch.ops import build, flex_core

    h_total = 8
    h = h_total // model
    h0 = shard * h
    q, k, v, spec, aux = _inputs(mod, b, n, h_total, dev, seed=model + shard, bh0=b0 * h_total)
    rate = RATE
    dseed = torch.tensor([99], dtype=torch.int32, device=dev)
    grads = mod != "sbm_graph"
    g = torch.Generator().manual_seed(5)
    go = torch.randn(q.shape, generator=g).to(dev)
    gs = torch.full((b, h_total), GS_COEF, device=dev)
    sq, sk, sv, s_spec, s_aux = _shard(mod, q, k, v, spec, aux, h0, h)
    assert s_spec.hstride == h_total and s_spec.bh0 == b0 * h_total + h0
    full, fex, fg = _run(flex_core.flex_attention, q, k, v, spec, aux, rate, dseed, go, gs,
                         grads)
    before = build.launch_counts()
    out, ex, sg = _run(flex_core.flex_attention, sq, sk, sv, s_spec, s_aux, rate, dseed,
                       go[:, h0:h0 + h].contiguous(), gs[:, h0:h0 + h].contiguous(), grads)
    torch.cuda.synchronize()
    after = build.launch_counts()
    assert after[f"flex_fwd_{mod}"] == before[f"flex_fwd_{mod}"] + 1
    assert torch.equal(ex["graph_sum"], fex["graph_sum"][:, h0:h0 + h])  # 0 edges apart
    assert float(torch.max(torch.abs(out - full[:, h0:h0 + h]))) <= 1e-6
    if grads:
        assert after[f"flex_bwd_q_{mod}"] == before[f"flex_bwd_q_{mod}"] + 1
        for a, w in zip(sg, fg):
            assert _rel(a, w[:, h0:h0 + h]) <= 1e-5
    # and against the plain version at the shard's own index
    ref, rex, rg = _run(flex_core.flex_reference, sq, sk, sv, s_spec, s_aux, rate, dseed,
                        go[:, h0:h0 + h].contiguous(), gs[:, h0:h0 + h].contiguous(), grads)
    if mod == "sbm_graph":
        torch.testing.assert_close(out, ref, atol=5e-6, rtol=0)
        return
    if mod == "sbm_sampled":
        same = ex["graph_sum"] == rex["graph_sum"]
        assert same.float().mean() >= 0.9  # a draw at its threshold may flip (phase 3's rule)
    else:  # the expected graph's ΣA sums soft weights: equal up to summation order
        torch.testing.assert_close(ex["graph_sum"], rex["graph_sum"], atol=0, rtol=1e-5)
        same = torch.ones_like(ex["graph_sum"], dtype=torch.bool)
    torch.testing.assert_close(out[same], ref[same], atol=2e-5, rtol=0)
    for a, w in zip(sg, rg):
        torch.testing.assert_close(a[same], w[same], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mod", ["sbm_sampled", "sbm_expected", "sbm_graph"])
def test_one_shard_is_todays_index_and_a_short_stride_is_refused(dev, mod):
    from csat_tpu_torch.ops import flex_core

    q, k, v, spec, aux = _inputs(mod, 4, 150, 8, dev, seed=1, bh0=3 * 8)
    dseed = torch.tensor([7], dtype=torch.int32, device=dev)
    a, aex = flex_core.flex_attention(q, k, v, spec, aux, RATE, dseed)
    b, bex = flex_core.flex_attention(q, k, v, dataclasses.replace(spec, h_total=8), aux,
                                      RATE, dseed)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(aex["graph_sum"], bex["graph_sum"])
    with pytest.raises(ValueError, match="head stride"):
        flex_core.flex_attention(q, k, v, dataclasses.replace(spec, h_total=4), aux, RATE,
                                 dseed)


@pytest.mark.parametrize("model,shard", [(2, 0), (2, 1), (4, 1), (4, 3), (8, 5)])
def test_cse_kernel_on_one_plane_matches_the_full_slice(dev, model, shard):
    from csat_tpu_torch.ops import flex_core
    from csat_tpu_torch.ops.mods import cse_mod

    g = torch.Generator().manual_seed(model * 10 + shard)
    b, h, n, dh, r_len = 8, 8, 150, 64, 150
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)
    q, k, v = rnd(b, h, n, dh), rnd(b, h, n, dh), rnd(b, h, n, dh)
    rel = torch.randint(0, r_len, (b, 2, n, n), generator=g).to(dev)
    mask = (torch.rand((b, 2, n, n), generator=g) < 0.3).to(dev)
    lq, lk = rnd(h, r_len, dh), rnd(h, r_len, dh)
    spec, aux = cse_mod(lq, lk, rel, mask)
    full, _ = flex_core.flex_attention(q, k, v, spec, aux)
    per = h // model
    h0 = shard * per
    plane = h0 // (h // 2)
    part = lambda t: t[:, h0:h0 + per].contiguous()
    s_spec, s_aux = cse_mod(lq[h0:h0 + per], lk[h0:h0 + per], rel[:, plane:plane + 1],
                            mask[:, plane:plane + 1])
    assert s_spec.planes == 1 and s_spec.group == per
    out, _ = flex_core.flex_attention(part(q), part(k), part(v), s_spec, s_aux)
    ref, _ = flex_core.flex_reference(part(q), part(k), part(v), s_spec, s_aux)
    torch.cuda.synchronize()
    assert float(torch.max(torch.abs(out - full[:, h0:h0 + per]))) <= 1e-6
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
