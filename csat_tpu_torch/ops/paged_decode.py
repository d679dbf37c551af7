"""Ragged paged-decode attention: one token per slot, read through the page table.

Counterpart of the JAX package's ``ops/paged_decode.py``.  K/V live in page
arrays ``(NP, H, page, dh)`` (f32, bf16 or int8 storage, with f32 per-row
scales ``(NP, H, page, 1)``); slot ``s`` reads chain position ``j`` from page
``table[s, j // page]`` at row ``j % page``.  :func:`paged_attend` launches
the hand-written CUDA kernel (``csrc/paged_decode.cu``) for CUDA tensors —
which walks the table, dequantises, merges the current token, masks,
softmaxes and multiplies by V in one launch — and the plain gather path
:func:`_attend_reference` for CPU tensors.

NULL_PAGE lanes: the plain path gathers the null page's contents, the kernel
treats those lanes as zeros (as the TPU kernel does).  A row with at least
one admissible lane cannot tell the difference (masked lanes get exactly zero
weight, and the kernel reads only the admissible ones); fully masked rows
(frozen slots), the mean of their ``width`` V rows on both paths, may differ
and are discarded by the engine.
"""

from __future__ import annotations

import math

import torch

from csat_tpu_torch.ops import build
from csat_tpu_torch.ops.flex_core import check_cuda, select_impl

__all__ = ["NULL_PAGE", "NEG_INF", "quantize_kv", "dequantize_kv", "paged_attend",
           "reference_page_skip", "rect_attend"]

#: Reserved page id 0: never allocated; target of unallocated table entries
#: and of frozen rows' dead writes.
NULL_PAGE = 0
NEG_INF = -1e9  # masked-score fill (models/components.py's)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def quantize_kv(x: torch.Tensor, dtype: torch.dtype):
    """K/V rows ``x (..., dh)`` → ``(values, scale)``: int8 is symmetric
    per-row absmax/127 with round-half-to-even (``torch.round``, as
    ``jnp.round``), scale 1.0 on all-zero rows; f32/bf16 are a plain cast with
    scale 1.0."""
    if dtype == torch.int8:
        x = x.to(torch.float32)
        absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
        scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
        q = torch.clamp(torch.round(x / scale), -127.0, 127.0)
        return q.to(torch.int8), scale.to(torch.float32)
    ones = torch.ones(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    return x.to(dtype), ones


def dequantize_kv(values: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return values.to(torch.float32) * scale


def _gather(pages: torch.Tensor, table: torch.Tensor, width: int) -> torch.Tensor:
    """(NP, H, page, dh) pages through (S, W) table rows → (S, H, width, dh)."""
    _, h, page, dh = pages.shape
    s, w = table.shape
    g = pages[table.long()]                              # (S, W, H, page, dh)
    g = g.permute(0, 2, 1, 3, 4).reshape(s, h, w * page, dh)
    return g[:, :, :width, :]


def _finalize(q, k, v, mask, idx, k_tok, v_tok):
    """Token merge → scores → mask fill → softmax → ·V (the decode attention
    of ``models/components.py:MultiHeadAttention``)."""
    width = k.shape[2]
    if idx is not None:
        hot = torch.arange(width, device=q.device)[None, :] == idx[:, None].long()
        sel = hot[:, None, :, None]
        k = torch.where(sel, k_tok, k)
        v = torch.where(sel, v_tok, v)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    scores = torch.where(mask[:, None, None, :] != 0, torch.full_like(scores, NEG_INF), scores)
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v)


def reference_page_skip(table: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(S, H) count of NULL_PAGE entries per table row (every head walks the
    same chain)."""
    cnt = torch.sum((table == NULL_PAGE).to(torch.int32), dim=1)
    return cnt[:, None].expand(table.shape[0], num_heads).contiguous()


def _attend_reference(q, pages_k, pages_v, scale_k, scale_v, table, mask, width,
                      idx, k_tok, v_tok):
    k = dequantize_kv(_gather(pages_k, table, width), _gather(scale_k, table, width))
    v = dequantize_kv(_gather(pages_v, table, width), _gather(scale_v, table, width))
    out = _finalize(q, k, v, mask, idx, k_tok, v_tok)
    return out, reference_page_skip(table, q.shape[1])


def rect_attend(q, k, v, mask, *, idx=None, k_tok=None, v_tok=None) -> torch.Tensor:
    """One decode step of attention over per-slot rectangles ``k``/``v`` (S,
    H, width, dh) — the rectangle layout's read (``serve/slots.py``), the
    paged plain path's arithmetic in f32 without the table walk; ``idx`` /
    ``k_tok`` / ``v_tok`` merge the current token as :func:`paged_attend`
    does.  Plain PyTorch on every device: the JAX rect engine reads through
    its XLA reference path, not the paged kernel.  → (S, H, 1, dh) f32."""
    f32 = lambda t: None if t is None else t.to(torch.float32).contiguous()
    if idx is not None:
        idx = idx.to(torch.int32).contiguous()
    return _finalize(f32(q), f32(k), f32(v), mask, idx, f32(k_tok), f32(v_tok))


def kernel_args(q, pages_k, pages_v, scale_k, scale_v, table, mask, width,
                idx, k_tok, v_tok):
    """Check the inputs of one kernel launch and allocate its outputs.
    Returns ``(args, outs)``: the C argument list of ``paged_decode`` and
    the output tensors ``out`` (S, H, 1, dh) and ``skipped`` (S, H)."""
    s, h, _, dh = q.shape
    np_, _, page, _ = pages_k.shape
    nb = table.shape[1]
    if pages_k.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported page dtype {pages_k.dtype}")
    build.check_head_dim("paged_decode", dh)
    check_cuda("q", q, torch.float32, (s, h, 1, dh))
    check_cuda("pages_k", pages_k, pages_k.dtype, (np_, h, page, dh))
    check_cuda("pages_v", pages_v, pages_k.dtype, (np_, h, page, dh))
    check_cuda("scale_k", scale_k, torch.float32, (np_, h, page, 1))
    check_cuda("scale_v", scale_v, torch.float32, (np_, h, page, 1))
    check_cuda("table", table, torch.int32, (s, nb))
    check_cuda("mask", mask, torch.bool, (s, width))
    if idx is not None:
        check_cuda("idx", idx, torch.int32, (s,))
        check_cuda("k_tok", k_tok, torch.float32, (s, h, 1, dh))
        check_cuda("v_tok", v_tok, torch.float32, (s, h, 1, dh))
    outs = {"out": torch.empty_like(q),
            "skipped": torch.empty((s, h), dtype=torch.int32, device=q.device)}
    merge = [t.data_ptr() if t is not None else None for t in (idx, k_tok, v_tok)]
    args = [_DTYPE_CODE[pages_k.dtype], q.data_ptr(), pages_k.data_ptr(),
            pages_v.data_ptr(), scale_k.data_ptr(), scale_v.data_ptr(),
            table.data_ptr(), mask.data_ptr(), *merge, outs["out"].data_ptr(),
            outs["skipped"].data_ptr(), s, h, nb, page, width, dh,
            torch.cuda.current_stream(q.device).cuda_stream]
    return args, outs


def _attend_kernel(*inputs):
    args, outs = kernel_args(*inputs)
    build.launch("paged_decode", args)
    return outs["out"], outs["skipped"]


def paged_attend(q, pages_k, pages_v, scale_k, scale_v, table, mask, width,
                 *, idx=None, k_tok=None, v_tok=None):
    """One decode step of attention through a page table.

    ``q`` (S, H, 1, dh); ``pages_k/v`` (NP, H, page, dh) storage dtype with
    f32 ``scale_k/v`` (NP, H, page, 1); ``table`` (S, NB) int32; ``mask``
    (S, width) bool, True on disallowed lanes; ``width`` the chain width
    attended over.  Self attention passes ``idx`` (S,) int32 and
    ``k_tok``/``v_tok`` (S, H, 1, dh) to merge the current token at each
    slot's position.  → ``(out (S, H, 1, dh) f32, skipped (S, H) int32)``."""
    q = q.to(torch.float32).contiguous()
    if idx is not None:
        idx = idx.to(torch.int32).contiguous()
        k_tok = k_tok.to(torch.float32).contiguous()
        v_tok = v_tok.to(torch.float32).contiguous()
    fn = _attend_kernel if select_impl(q) == "kernel" else _attend_reference
    return fn(q, pages_k, pages_v, scale_k, scale_v, table, mask, width,
              idx, k_tok, v_tok)
