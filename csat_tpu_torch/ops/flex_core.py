"""Blocked weighted-softmax attention: the CUDA kernels and their plain version.

Counterpart of the JAX package's ``ops/flex_core.py``.  Every attention on
the encoder path is the weighted-softmax-cancelled form

    attn_ij = w_ij e^{s_ij} / Σ_k w_ik e^{s_ik}      (rows with no live w: 0)

with the score ``s`` and the weight ``w`` defined by a mod
(``ops/mods.py``), and attention dropout as a hash keep-field on ``attn``
before ·V (the normalizer and ``lse`` stay pre-dropout).
:func:`flex_attention` is the one entry point: for CUDA tensors it runs the
hand-written Hopper kernels inside one ``torch.autograd.Function`` — the
forward ``csrc/flex_fwd_tc.cu`` (``flex_fwd_cse`` and
``flex_fwd_sbm_{expected,sampled,graph}``, tensor cores) and,
for the sampled and the expected SBM mods, the two-pass
backward of ``csrc/flex_bwd_tc.cu`` (tensor cores, one template for both
mods: ``flex_bwd_q_sbm_{sampled,expected}``, dq and dR over the keys;
``flex_bwd_k_sbm_{sampled,expected}``, dk, dv and dK̂ over the query
rows).  The CSE and graph mods' backward is the autograd of
:func:`flex_reference` recomputed from the saved inputs, as the JAX package's
reference backward is.  For CPU tensors it
evaluates :func:`flex_reference`, the plain PyTorch composition of the same
mod definitions, under plain autograd.  Anything else raises.

The kernels count dead tiles in blocks of :data:`FLEX_BLOCK` = 64 (the TPU
kernels used 128) and stream key tiles with online max/sum statistics, so
they agree with the plain path to rounding, not bitwise; ``skipped_blocks``
counts dead (q-tile, k-tile) pairs at the kernels' block size and equals
:func:`reference_block_skip` at that size exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from csat_tpu_torch.ops import build
from csat_tpu_torch.ops.hashrng import uniform_field
from csat_tpu_torch.ops.mods import CSESpec, SBMExpectedSpec, SBMGraphSpec, SBMSampledSpec

__all__ = [
    "FLEX_BLOCK", "NEG", "Geometry", "geometry", "num_blocks", "select_impl",
    "flex_attention", "flex_reference", "reference_block_skip", "kernel_args",
    "bwd_kernel_args", "keep_field",
]

FLEX_BLOCK = 64  # the CUDA kernels' q-tile and k-tile (csrc/flex_{fwd_tc,bwd_tc}.cu)
NEG = -1e30      # masked-max sentinel of a row that has seen no live weight


@dataclasses.dataclass(frozen=True)
class Geometry:
    b: int
    h: int
    n: int
    dh: int


def geometry(q: torch.Tensor) -> Geometry:
    b, h, n, dh = q.shape
    return Geometry(b=b, h=h, n=n, dh=dh)


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def num_blocks(n: int, block: int = FLEX_BLOCK) -> int:
    """(q-tile, k-tile) pairs per (batch, head) at ``block``."""
    return (round_up(n, block) // block) ** 2


def select_impl(x: torch.Tensor) -> str:
    """``"kernel"`` for a CUDA tensor, ``"reference"`` (the plain path) for
    a CPU one — the single dispatch rule of the port's kernels."""
    if x.device.type == "cuda":
        return "kernel"
    if x.device.type == "cpu":
        return "reference"
    raise ValueError(f"no kernel or plain path for device {x.device}")


def _finalize(s: torch.Tensor, w: torch.Tensor, exact_ratio: bool = False):
    """Weighted-softmax-cancelled normalization over the last axis (the
    JAX ``_finalize``, ``flex_core.py:148-177``).  The exp is guarded on its
    input: dead entries exponentiate 0, never ``s + 1e30``.  Rows with no
    live weight come out exactly 0.  Returns ``(attn, lse, ratio)`` with
    ``ratio = e^{s - lse}``, the weight gradient's factor
    (``∂attn_ij/∂w_ik = e^{s_ik - lse_i}(δ_jk − attn_ij)``, whatever ``w_ik``).

    At an entry whose weight is 0 the guarded ``ratio`` is ``1 / l``, not
    that derivative.  The STE and pad gates zero it there, so most mods never
    see the difference.  With ``exact_ratio`` those entries get the
    derivative itself, ``exp(min(s - lse, 80))`` in a row that has live
    weight and 0 in a row that has none (a row that is identically 0 passes
    nothing back), as ``csrc/flex_bwd_tc.cu`` and JAX's ``_bwd_tile`` compute
    it.  A mod asks for it through ``spec.exact_weight_grad``."""
    live_e = w > 0
    m = torch.amax(torch.where(live_e, s, torch.full_like(s, NEG)), dim=-1, keepdim=True)
    eexp = torch.exp(torch.where(live_e, s, m) - m)
    e = eexp * w
    l = torch.sum(e, dim=-1, keepdim=True)
    live = l > 0
    l_safe = torch.where(live, l, torch.ones_like(l))
    lse = torch.where(live, m + torch.log(l_safe), torch.full_like(l, NEG))
    ratio = eexp / l_safe
    if exact_ratio:
        dead = torch.exp(torch.clamp(s - torch.where(live, lse, torch.zeros_like(lse)),
                                     max=80.0))
        ratio = torch.where(live_e, ratio, torch.where(live, dead, torch.zeros_like(dead)))
    return e / l_safe, lse, ratio


class _WeightedSoftmax(torch.autograd.Function):
    """``_finalize`` with the closed-form backward of the JAX package
    (``flex_core.py:195-208``): with ``t = g − Σ attn·g``, ``d_s = attn ⊙ t``
    and ``d_w = ratio ⊙ t`` (summed over the axes ``w`` broadcasts along).
    ``exact_ratio`` picks ``d_w``'s factor at weight-0 entries (see
    :func:`_finalize`).  Returns ``(attn, lse)``; ``lse`` carries no gradient."""

    @staticmethod
    def forward(ctx, s, w, exact_ratio: bool = False):
        attn, lse, ratio = _finalize(s, w, exact_ratio and ctx.needs_input_grad[1])
        ctx.save_for_backward(attn, ratio)
        ctx.w_shape = w.shape
        ctx.mark_non_differentiable(lse)
        return attn, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        attn, ratio = ctx.saved_tensors
        t = g - torch.sum(attn * g, dim=-1, keepdim=True)
        d_w = None
        if ctx.needs_input_grad[1]:
            d_w = ratio * t
            axes = tuple(i for i, (a, b) in enumerate(zip(d_w.shape, ctx.w_shape))
                         if b == 1 and a != 1)
            if axes:
                d_w = torch.sum(d_w, dim=axes, keepdim=True)
        return attn * t, d_w, None


def keep_field(seed, b: int, h: int, n: int, stride: int, rate: float, device=None,
               bh0: int = 0, h_total: int = 0):
    """Dropout ``keep / (1 - rate)`` field (B, H, N, N) from the hash stream
    under ``seed``: ``1{u >= rate} · 1/(1 - rate)`` (JAX ``keep_field``,
    ``flex_core.py:214-219``), the same bits the kernels draw per tile;
    ``bh0`` the batch·head offset of a process's rows and heads, ``h_total``
    the head stride (:func:`~csat_tpu_torch.ops.hashrng.uniform_field`)."""
    u = uniform_field(seed, b, h, n, n, stride, device, bh0, h_total)
    return (u >= rate).to(torch.float32) * (1.0 / (1.0 - rate))


def flex_reference(q, k, v, spec, aux, dropout_rate: float = 0.0,
                   dropout_seed: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain PyTorch evaluation of a mod, differentiable by plain autograd.
    Returns ``(out, extras)`` with ``graph_sum`` (B, H), ``skipped_blocks``
    (B, H, zeros — the plain path skips nothing) and ``lse`` (B, H, N,
    before dropout)."""
    b, h, n, dh = q.shape
    s = torch.einsum("bhnd,bhmd->bhnm", q, k) * spec.scale(dh)
    w_raw, w_eff = spec.full_weight(q, k, aux)
    s = spec.full_score(s, q, k, aux)
    attn, lse = _WeightedSoftmax.apply(s, w_eff, spec.exact_weight_grad)
    gsum = torch.sum(torch.broadcast_to(w_raw, s.shape), dim=(2, 3))
    if dropout_rate > 0.0:
        attn = attn * keep_field(dropout_seed, b, h, n, spec.stride, dropout_rate, q.device,
                                 spec.bh0, spec.hstride)
    out = torch.einsum("bhnm,bhmd->bhnd", attn, v)
    return out, {
        "graph_sum": gsum,
        "skipped_blocks": torch.zeros((b, h), dtype=torch.float32, device=q.device),
        "lse": lse[..., 0],
    }


def reference_block_skip(spec, aux, geom: Geometry, block: int = FLEX_BLOCK) -> torch.Tensor:
    """Dead (q-tile, k-tile) count per (batch, head) at ``block``, from the
    mod's full weight field on the padded geometry — the oracle the kernel's
    ``skipped_blocks`` must equal at its own block size."""
    n_pad = round_up(geom.n, block)
    nt = n_pad // block
    w = spec.full_weight_padded(aux, geom.b, geom.h, n_pad)
    blocks = w.reshape(geom.b, geom.h, nt, block, nt, block)
    dead = torch.all(torch.all(blocks <= 0, dim=5), dim=3)
    return torch.sum(dead.to(torch.float32), dim=(2, 3))


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _dropout_args(q, rate: float, dseed):
    """``(dseed pointer, rate, keep scale)`` of a launch: the keep field is
    ``1{u >= rate} · 1/(1 - rate)``, the scale rounded to f32 as JAX does."""
    if rate <= 0.0:
        return None, 0.0, 1.0
    check_cuda("dropout_seed", dseed, torch.int32, (1,))
    return dseed.data_ptr(), float(rate), 1.0 / (1.0 - float(rate))


def _bh0(spec) -> Tuple[int, int]:
    """The spec's batch·head offset and head stride as the kernels take
    them: ints below 2³¹, the hash index ``bh0 + b·h_total + h`` wrapping in
    uint32 as the plain path's does, the stride at least the launch's
    heads."""
    if not 0 <= spec.bh0 < 2**31:
        raise ValueError(f"batch·head offset {spec.bh0} outside [0, 2^31)")
    if not spec.heads <= spec.hstride < 2**31:
        raise ValueError(f"head stride {spec.hstride} below the launch's {spec.heads} heads")
    return int(spec.bh0), int(spec.hstride)


def _sbm_factor_args(spec, aux, b, h, n):
    r, kh, padf = aux[:3]
    check_cuda("r", r, torch.float32, (b, h, n, spec.kk))
    check_cuda("k_hat", kh, torch.float32, (b, h, n, spec.kk))
    check_cuda("key_pad", padf, torch.float32, (b, n))
    return [r.data_ptr(), kh.data_ptr(), padf.data_ptr()]


def kernel_args(spec, q, k, v, aux, rate: float = 0.0, dseed=None):
    """Check the inputs of one forward launch and allocate its outputs.
    Returns ``(fn, args, outs)``: the C entry point, its argument list and
    the output tensors ``out`` (B, H, N, dh), ``lse`` (B, H, N), and the
    per-q-tile partials ``gsum`` / ``skip`` (B, H, n_qtiles)."""
    b, h, n, dh = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda(name, t, torch.float32, (b, h, n, dh))
    nqt = round_up(n, FLEX_BLOCK) // FLEX_BLOCK
    outs = {
        "out": torch.empty_like(q),
        "lse": torch.empty((b, h, n), dtype=torch.float32, device=q.device),
        "gsum": torch.empty((b, h, nqt), dtype=torch.float32, device=q.device),
        "skip": torch.empty((b, h, nqt), dtype=torch.int32, device=q.device),
    }
    tail = [outs[key].data_ptr() for key in ("out", "lse", "gsum", "skip")]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    qkv = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    if rate > 0.0 and isinstance(spec, CSESpec):  # the CSE layers never pass a rate
        raise NotImplementedError(f"no attention-dropout kernel for mod {spec.name!r}")
    dptr, rate, keep_scale = _dropout_args(q, rate, dseed)
    if isinstance(spec, CSESpec):
        lq, lk, rel, mask = aux
        check_cuda("rel_q", lq, torch.float32, (h, spec.r_len, dh))
        check_cuda("rel_k", lk, torch.float32, (h, spec.r_len, dh))
        check_cuda("rel", rel, torch.int32, (b, spec.planes, n, n))
        check_cuda("mask", mask, torch.bool, (b, spec.planes, n, n))
        if mask.data_ptr() % 4:  # a view at an odd offset: the kernel copies aligned words
            mask = mask.clone()
            outs["mask"] = mask  # kept alive with the outputs
        fn = "flex_fwd_cse"
        args = [*qkv, lq.data_ptr(), lk.data_ptr(), rel.data_ptr(), mask.data_ptr(), *tail,
                b, h, n, dh, spec.r_len, spec.group, spec.scale(dh), stream]
    elif isinstance(spec, SBMExpectedSpec):
        fn = "flex_fwd_sbm_expected"
        args = [*qkv, *_sbm_factor_args(spec, aux, b, h, n), dptr, *tail, b, h, n, dh,
                spec.kk, spec.stride, *_bh0(spec), spec.floor, spec.scale(dh), rate, keep_scale,
                stream]
    elif isinstance(spec, SBMSampledSpec):
        check_cuda("sample_seed", aux[3], torch.int32, (1,))
        fn = "flex_fwd_sbm_sampled"
        args = [*qkv, *_sbm_factor_args(spec, aux, b, h, n), aux[3].data_ptr(), dptr, *tail,
                b, h, n, dh, spec.kk, spec.stride, *_bh0(spec), spec.floor, spec.scale(dh), rate,
                keep_scale, stream]
    elif isinstance(spec, SBMGraphSpec):
        graph, padf = aux
        check_cuda("graph", graph, torch.float32, (b, h, n, n))
        check_cuda("key_pad", padf, torch.float32, (b, n))
        fn = "flex_fwd_sbm_graph"
        args = [*qkv, graph.data_ptr(), padf.data_ptr(), dptr, *tail, b, h, n, dh,
                spec.stride, *_bh0(spec), spec.scale(dh), rate, keep_scale, stream]
    else:
        raise NotImplementedError(f"no CUDA kernel for mod {spec.name!r}")
    build.check_head_dim(fn, dh)
    return fn, args, outs


def bwd_kernel_args(spec, q, k, v, aux, lse, dvec, g_out, gs, rate: float = 0.0, dseed=None):
    """Check the inputs of the two backward launches of the sampled or the
    expected SBM mod and allocate their outputs.  Returns ``(q_fn, q_args,
    k_fn, k_args, grads)`` with ``grads`` = dq, dk, dv (B, H, N, dh), dr, dkh
    (B, H, N, kk)."""
    if not isinstance(spec, (SBMSampledSpec, SBMExpectedSpec)):
        raise NotImplementedError(f"no CUDA backward kernel for mod {spec.name!r}")
    sampled = isinstance(spec, SBMSampledSpec)
    q_fn, k_fn = f"flex_bwd_q_{spec.name}", f"flex_bwd_k_{spec.name}"
    b, h, n, dh = q.shape
    for name, t in (("q", q), ("k", k), ("v", v), ("g_out", g_out)):
        check_cuda(name, t, torch.float32, (b, h, n, dh))
    check_cuda("lse", lse, torch.float32, (b, h, n))
    check_cuda("dvec", dvec, torch.float32, (b, h, n))
    check_cuda("gs", gs, torch.float32, (b, h))
    if sampled:
        check_cuda("sample_seed", aux[3], torch.int32, (1,))
    build.check_head_dim(q_fn, dh)
    dptr, rate, keep_scale = _dropout_args(q, rate, dseed)
    grads = {"dq": torch.empty_like(q), "dk": torch.empty_like(k), "dv": torch.empty_like(v),
             "dr": torch.empty_like(aux[0]), "dkh": torch.empty_like(aux[1])}
    stream = torch.cuda.current_stream(q.device).cuda_stream
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), *_sbm_factor_args(spec, aux, b, h, n),
            *([aux[3].data_ptr()] if sampled else []), dptr, lse.data_ptr(),
            dvec.data_ptr(), g_out.data_ptr(), gs.data_ptr()]
    tail = [b, h, n, dh, spec.kk, spec.stride, *_bh0(spec), spec.floor, spec.scale(dh), rate,
            keep_scale, stream]
    q_args = head + [grads["dq"].data_ptr(), grads["dr"].data_ptr()] + tail
    k_args = head + [grads[key].data_ptr() for key in ("dk", "dv", "dkh")] + tail
    return q_fn, q_args, k_fn, k_args, grads


def _kernel_fwd(spec, q, k, v, aux, rate, dseed):
    fn, args, outs = kernel_args(spec, q, k, v, aux, rate, dseed)
    build.launch(fn, args)
    return outs["out"], outs["gsum"].sum(dim=2), outs["skip"].sum(dim=2).to(torch.float32), \
        outs["lse"]


class _FlexKernel(torch.autograd.Function):
    """The CUDA forward, with the two-pass kernel backward for the sampled
    and the expected SBM mods and the recomputed plain backward for the CSE
    and graph mods."""

    @staticmethod
    def forward(ctx, spec, rate, dseed, q, k, v, *aux):
        out, gsum, skip, lse = _kernel_fwd(spec, q, k, v, aux, rate, dseed)
        ctx.spec, ctx.rate, ctx.dseed = spec, rate, dseed
        ctx.save_for_backward(q, k, v, out, lse, *aux)
        ctx.mark_non_differentiable(skip, lse)
        return out, gsum, skip, lse

    @staticmethod
    def backward(ctx, g_out, g_gsum, _g_skip, _g_lse):
        q, k, v, out, lse, *aux = ctx.saved_tensors
        spec, rate, dseed = ctx.spec, ctx.rate, ctx.dseed
        b, h = q.shape[:2]
        g_out = torch.zeros_like(out) if g_out is None else g_out.contiguous()
        g_gsum = (torch.zeros((b, h), dtype=torch.float32, device=q.device)
                  if g_gsum is None else g_gsum.contiguous())
        if isinstance(spec, (SBMSampledSpec, SBMExpectedSpec)):
            dvec = torch.sum(g_out * out, dim=-1)
            q_fn, q_args, k_fn, k_args, grads = bwd_kernel_args(
                spec, q, k, v, aux, lse, dvec, g_out, g_gsum, rate, dseed)
            build.launch(q_fn, q_args)
            build.launch(k_fn, k_args)
            return (None, None, None, grads["dq"], grads["dk"], grads["dv"],
                    grads["dr"], grads["dkh"], *([None] * (len(aux) - 2)))
        # the plain backward, recomputed from the saved inputs
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(bool(need)) for t, need in zip((q, k, v, *aux), needs)]
            out_r, ex_r = flex_reference(*leaves[:3], spec, tuple(leaves[3:]), rate, dseed)
            outputs, cots = [out_r], [g_out]
            if ex_r["graph_sum"].requires_grad:
                outputs.append(ex_r["graph_sum"])
                cots.append(g_gsum)
            wanted = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(outputs, wanted, cots, allow_unused=True))
        return (None, None, None, *(next(got) if t.requires_grad else None for t in leaves))


def flex_attention(q, k, v, spec, aux, dropout_rate: float = 0.0,
                   dropout_seed: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Evaluate a mod: the CUDA kernels for CUDA tensors, the plain path for
    CPU tensors; differentiable either way.  ``q``/``k``/``v`` (B, H, N, dh)
    f32; ``dropout_seed`` a (1,) int32 tensor when ``dropout_rate > 0``.
    Returns ``(out, extras)`` with ``graph_sum`` (Σ w_raw per (batch, head)),
    ``skipped_blocks`` and ``lse``."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("attention dropout needs a dropout_seed")
    if select_impl(q) == "kernel":
        out, gsum, skip, lse = _FlexKernel.apply(spec, float(dropout_rate), dropout_seed,
                                                 q, k, v, *aux)
        return out, {"graph_sum": gsum, "skipped_blocks": skip, "lse": lse}
    return flex_reference(q, k, v, spec, aux, dropout_rate, dropout_seed)
