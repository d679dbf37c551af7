"""Blocked weighted-softmax attention: the CUDA kernel and its plain version.

Counterpart of the JAX package's ``ops/flex_core.py``.  Every attention on
the encoder path is the weighted-softmax-cancelled form

    attn_ij = w_ij e^{s_ij} / Σ_k w_ik e^{s_ik}      (rows with no live w: 0)

with the score ``s`` and the weight ``w`` defined by a mod
(``ops/mods.py``).  :func:`flex_attention` is the one entry point: for CUDA
tensors it launches the hand-written Hopper kernel
(``csrc/flex_fwd.cu``, one templated kernel per mod: ``flex_fwd_cse``,
``flex_fwd_sbm_expected``); for CPU tensors it evaluates
:func:`flex_reference`, the plain PyTorch composition of the same mod
definitions.  Anything else raises.

The kernel tiles the node axis in blocks of :data:`FLEX_BLOCK` = 64 (the TPU
kernel used 128) and streams key tiles with online max/sum statistics, so it
agrees with the plain path to rounding, not bitwise; its ``skipped_blocks``
counts dead (q-tile, k-tile) pairs at its own block size and equals
:func:`reference_block_skip` at that size exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from csat_tpu_torch.ops import build
from csat_tpu_torch.ops.mods import CSESpec, SBMExpectedSpec

__all__ = [
    "FLEX_BLOCK", "NEG", "Geometry", "geometry", "num_blocks", "select_impl",
    "flex_attention", "flex_reference", "reference_block_skip",
]

FLEX_BLOCK = 64  # the CUDA kernel's q-tile and k-tile (csrc/flex_fwd.cu BM/BN)
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


def _finalize(s: torch.Tensor, w: torch.Tensor):
    """Weighted-softmax-cancelled normalization over the last axis (the
    JAX ``_finalize``, ``flex_core.py:148-177``, without the backward's
    ratio).  The exp is guarded on its input: dead entries exponentiate 0,
    never ``s + 1e30``.  Rows with no live weight come out exactly 0.
    Returns ``(attn, lse)``."""
    live_e = w > 0
    m = torch.amax(torch.where(live_e, s, torch.full_like(s, NEG)), dim=-1, keepdim=True)
    e = torch.exp(torch.where(live_e, s, m) - m) * w
    l = torch.sum(e, dim=-1, keepdim=True)
    live = l > 0
    l_safe = torch.where(live, l, torch.ones_like(l))
    lse = torch.where(live, m + torch.log(l_safe), torch.full_like(l, NEG))
    return e / l_safe, lse


def flex_reference(q, k, v, spec, aux) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain PyTorch evaluation of a mod (no dropout: the serving path is
    deterministic).  Returns ``(out, extras)`` with ``graph_sum`` (B, H),
    ``skipped_blocks`` (B, H, zeros — the plain path skips nothing) and
    ``lse`` (B, H, N)."""
    b, h, n, dh = q.shape
    s = torch.einsum("bhnd,bhmd->bhnm", q, k) * spec.scale(dh)
    w_raw, w_eff = spec.full_weight(q, k, aux)
    s = spec.full_score(s, q, k, aux)
    attn, lse = _finalize(s, w_eff)
    gsum = torch.sum(torch.broadcast_to(w_raw, s.shape), dim=(2, 3))
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


def kernel_args(spec, q, k, v, aux):
    """Check the inputs of one kernel launch and allocate its outputs.
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
    if isinstance(spec, CSESpec):
        lq, lk, rel, mask = aux
        check_cuda("rel_q", lq, torch.float32, (h, spec.r_len, dh))
        check_cuda("rel_k", lk, torch.float32, (h, spec.r_len, dh))
        check_cuda("rel", rel, torch.int32, (b, 2, n, n))
        check_cuda("mask", mask, torch.bool, (b, 2, n, n))
        fn = "flex_fwd_cse"
        build.check_head_dim(fn, dh)
        args =[q.data_ptr(), k.data_ptr(), v.data_ptr(), lq.data_ptr(), lk.data_ptr(),
                rel.data_ptr(), mask.data_ptr(), *tail, b, h, n, dh, spec.r_len,
                spec.group, spec.scale(dh), stream]
    elif isinstance(spec, SBMExpectedSpec):
        r, kh, padf = aux
        check_cuda("r", r, torch.float32, (b, h, n, spec.kk))
        check_cuda("k_hat", kh, torch.float32, (b, h, n, spec.kk))
        check_cuda("key_pad", padf, torch.float32, (b, n))
        fn = "flex_fwd_sbm_expected"
        build.check_head_dim(fn, dh)
        args =[q.data_ptr(), k.data_ptr(), v.data_ptr(), r.data_ptr(), kh.data_ptr(),
                padf.data_ptr(), *tail, b, h, n, dh, spec.kk, spec.floor,
                spec.scale(dh), stream]
    else:
        raise NotImplementedError(f"no CUDA kernel for mod {spec.name!r}")
    return fn, args, outs


def _kernel_fwd(spec, q, k, v, aux):
    fn, args, outs = kernel_args(spec, q, k, v, aux)
    build.launch(fn, args)
    return outs["out"], {
        "graph_sum": outs["gsum"].sum(dim=2),
        "skipped_blocks": outs["skip"].sum(dim=2).to(torch.float32),
        "lse": outs["lse"],
    }


def flex_attention(q, k, v, spec, aux) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Evaluate a mod: the CUDA kernel for CUDA tensors, the plain path for
    CPU tensors.  ``q``/``k``/``v`` (B, H, N, dh) f32.  Returns ``(out,
    extras)`` with ``graph_sum`` (Σ w_raw per (batch, head)),
    ``skipped_blocks`` and ``lse``."""
    if select_impl(q) == "kernel":
        return _kernel_fwd(spec, q, k, v, aux)
    return flex_reference(q, k, v, spec, aux)
