"""Attention mods: CSE relative bias and the SBM graph family.

Torch counterparts of the JAX package's ``ops/mods.py``: ``CSESpec`` +
``cse_mod`` (``:374-501``), ``SBMSampledSpec`` + ``sbm_sampled_mod``
(``:170-226, :469-478``), ``SBMExpectedSpec`` + ``sbm_expected_mod``
(``:229-279, :481-485``) and ``SBMGraphSpec`` + ``sbm_graph_mod``
(``:282-326, :488-491``).  A mod is a frozen spec of static facts plus the
``aux`` tuple of tensors it needs; ``full_weight`` / ``full_score`` evaluate
it over whole arrays (the plain path,
:func:`~csat_tpu_torch.ops.flex_core.flex_reference`), ``full_weight_padded``
gives the weight field on a padded geometry (the block-skip oracle).  The
CUDA kernels (``csrc/flex_fwd_tc.cu``, ``csrc/flex_fwd.cu``,
``csrc/flex_bwd.cu``) compute the same
definitions tile by tile.

The SBM adjacency ``expA = R K̂ᵀ`` (``R = Q̂ S``) is summed one cluster at a
time, as the kernels sum it (:func:`exp_adjacency`), so the sampled mod's
Bernoulli draw ``u < clip(expA, floor, .99)`` cannot flip between the kernel
and the plain path on an entry where ``u`` and ``p`` are an ulp apart.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from csat_tpu_torch.ops.hashrng import noise_stride, uniform_field

__all__ = ["CSESpec", "SBMExpectedSpec", "SBMSampledSpec", "SBMGraphSpec", "cse_mod",
           "sbm_expected_mod", "sbm_sampled_mod", "sbm_graph_mod", "exp_adjacency", "clip",
           "rel_gather", "NEG_CSE"]

NEG_CSE = -1e9  # the reference's CSE mask fill for a live (weight 1) entry


def _real_gate(n: int, n_pad: int, device) -> torch.Tensor:
    idx = torch.arange(n_pad, device=device)
    return ((idx[:, None] < n) & (idx[None, :] < n)).to(torch.float32)


def exp_adjacency(r: torch.Tensor, kh: torch.Tensor) -> torch.Tensor:
    """``R K̂ᵀ`` (B, H, N, M) from (B, H, N, kk) and (B, H, M, kk), summed
    over the clusters in order j = 0, 1, … with one rounding per product and
    per sum — the CUDA kernels' order (``__fmul_rn``/``__fadd_rn``)."""
    acc = r[..., :, None, 0] * kh[..., None, :, 0]
    for j in range(1, r.shape[-1]):
        acc = acc + r[..., :, None, j] * kh[..., None, :, j]
    return acc


class _Clip(torch.autograd.Function):
    """``min(max(x, lo), hi)`` with the gradient ``jnp.clip`` has: 1 strictly
    inside ``(lo, hi)``, 0 outside, and 1/2 where ``x`` equals a bound (JAX
    splits a tie of ``max``/``min`` evenly; ``torch.clamp`` passes the whole
    gradient there).  The expected mod's backward kernel applies the same
    factor, so the plain path and the kernel agree at exact ties."""

    @staticmethod
    def forward(ctx, x, lo: float, hi: float):
        lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
        hi_t = torch.tensor(hi, dtype=x.dtype, device=x.device)
        ctx.save_for_backward(x, lo_t, hi_t)
        return torch.minimum(torch.maximum(x, lo_t), hi_t)

    @staticmethod
    def backward(ctx, g):
        x, lo, hi = ctx.saved_tensors
        inside = ((x > lo) & (x < hi)).to(g.dtype)
        tie = ((x == lo) | (x == hi)).to(g.dtype)
        return g * (inside + 0.5 * tie), None, None


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``, its gradient at the bounds included."""
    return _Clip.apply(x, lo, hi)


class _RelGather(torch.autograd.Function):
    """The CSE mod's two table gathers, ``x[b, h, i, rel[b, h // group, i,
    j]]`` for ``x`` = c2p_full and p2c_full (B, H, N, R), with a backward
    that adds the cotangents landing on one table entry in a fixed order.
    ``torch.gather``'s own backward on the card is ``scatter_add_``, which
    adds them with atomics in an order that changes from run to run, so two
    backward passes on the same inputs differ in the last bits.  Here one
    ``index_put_`` with ``accumulate=True`` takes both tables and every head
    of a plane as the columns of one row per (b, plane, i, j) — on the card
    it sorts the indices (stably) and adds each entry's terms in that
    order."""

    @staticmethod
    def forward(ctx, c2p_full, p2c_full, rel):
        group = c2p_full.shape[1] // rel.shape[1]
        rel_h = rel.long().repeat_interleave(group, dim=1)
        ctx.save_for_backward(rel)
        ctx.shape = c2p_full.shape
        return torch.gather(c2p_full, -1, rel_h), torch.gather(p2c_full, -1, rel_h)

    @staticmethod
    def backward(ctx, g_c2p, g_p2c):
        (rel,) = ctx.saved_tensors
        b, h, n, r = ctx.shape
        planes = rel.shape[1]
        group = h // planes
        vals = torch.stack((g_c2p, g_p2c), dim=-1).view(b, planes, group, n, n, 2)
        vals = vals.permute(0, 1, 3, 4, 2, 5).reshape(-1, group * 2)
        rows = torch.arange(b * planes * n, device=rel.device).mul_(r)
        idx = (rel.long().view(-1, n) + rows[:, None]).reshape(-1)
        grad = torch.zeros((b * planes * n * r, group * 2), dtype=vals.dtype, device=vals.device)
        grad.index_put_((idx,), vals, accumulate=True)
        grad = grad.view(b, planes, n, r, group, 2).permute(0, 1, 4, 2, 3, 5).reshape(b, h, n, r, 2)
        return grad[..., 0], grad[..., 1], None


def rel_gather(c2p_full: torch.Tensor, p2c_full: torch.Tensor, rel: torch.Tensor):
    """``(c2p_full[..., rel], p2c_full[..., rel])`` along the last axis,
    ``rel`` (B, planes, N, N) fanned out to the heads of each plane, with a
    backward that gives the same bits on every run."""
    return _RelGather.apply(c2p_full, p2c_full, rel)


def _pad_nodes(x: torch.Tensor, n_pad: int, value: float = 0.0) -> torch.Tensor:
    """Pad the node axis (second to last) of a (..., N, kk) factor."""
    return torch.nn.functional.pad(x, (0, 0, 0, n_pad - x.shape[-2]), value=value)


@dataclasses.dataclass(frozen=True)
class CSESpec:
    """Disentangled L/T relative bias: the two planes of ``rel``/``mask``
    (B, 2, N, N) fan out to ``heads // 2`` pseudo-heads each."""

    n: int
    heads: int
    dk: int
    r_len: int

    name = "cse"
    exact_weight_grad = False  # the weight is the constant 1

    @property
    def group(self) -> int:
        return self.heads // 2

    def scale(self, dh: int) -> float:
        return 1.0 / math.sqrt(dh * 3)

    def full_weight(self, q, k, aux):
        w = torch.ones((1, 1, 1, k.shape[2]), dtype=torch.float32, device=k.device)
        return w, w

    def full_score(self, s, q, k, aux):
        lq, lk, rel, mask = aux
        mask8 = mask.repeat_interleave(self.group, dim=1)
        inv = self.scale(q.shape[-1])
        c2p_full = torch.einsum("bhnd,hrd->bhnr", q, lk)          # (B, H, N, R)
        p2c_full = torch.einsum("bhmd,hrd->bhmr", k, lq)          # (B, H, N, R)
        # c2p[i, j] = (q_i · lk)[rel[i, j]]; p2c[i, j] = (k_j · lq)[rel[j, i]]
        c2p, p2c_t = rel_gather(c2p_full, p2c_full, rel)
        s = s + c2p * inv + p2c_t.transpose(-1, -2) * inv
        return torch.where(mask8, torch.full_like(s, NEG_CSE), s)

    def full_weight_padded(self, aux, b: int, h: int, n_pad: int):
        real = _real_gate(self.n, n_pad, aux[0].device)
        return real.expand(b, h, n_pad, n_pad)


class _SBMBase:
    """Shared facts of the SBM family: plain ``q·k / sqrt(dh)`` scores and
    the hash stride of the node count.

    ``exact_weight_grad`` says which factor the weighted softmax's backward
    takes for ``∂/∂w`` at an entry whose weight is 0
    (``flex_core._finalize``).  A mod whose own gates zero the gradient there
    (the STE's ``A · g``, the pad gate) leaves it False; a mod that can pass
    gradient into a weight of exactly 0 sets it."""

    exact_weight_grad = False

    def scale(self, dh: int) -> float:
        return 1.0 / math.sqrt(dh)

    @property
    def stride(self) -> int:
        return noise_stride(self.n)

    def full_score(self, s, q, k, aux):
        return s


@dataclasses.dataclass(frozen=True)
class SBMExpectedSpec(_SBMBase):
    """Bernoulli mean ``clip(R K̂ᵀ, floor, .99)`` as a soft weight, with the
    real-extent gate and the key-padding gate (``R = Q̂ S``)."""

    n: int
    heads: int
    kk: int
    floor: float

    name = "sbm_expected"
    # at floor == 0 an entry with R·K̂ᵀ == 0 has weight 0 and a half-open clip
    exact_weight_grad = True

    def full_weight(self, q, k, aux):
        r, kh, padf = aux
        w_raw = clip(exp_adjacency(r, kh), self.floor, 0.99)
        return w_raw, w_raw * (1.0 - padf)[:, None, None, :]

    def full_weight_padded(self, aux, b: int, h: int, n_pad: int):
        r, kh, padf = aux
        rp, khp = _pad_nodes(r, n_pad), _pad_nodes(kh, n_pad)
        padp = torch.nn.functional.pad(padf, (0, n_pad - self.n), value=1.0)
        w_raw = torch.clamp(exp_adjacency(rp, khp), self.floor, 0.99) * _real_gate(
            self.n, n_pad, r.device)
        return w_raw * (1.0 - padp[:, None, None, :])


@dataclasses.dataclass(frozen=True)
class SBMSampledSpec(_SBMBase):
    """Bernoulli graph ``1{u < clip(R K̂ᵀ, floor, .99)}`` drawn from the hash
    stream under ``sample_seed`` (aux ``(r, k_hat, key_pad_f32,
    sample_seed)``), with the STE gradient ``hardtanh(A · g)`` into ``R K̂ᵀ``.
    ``graph_sum`` counts the raw graph, padded key columns included; the
    attention weight is ``A · (1 - pad)``."""

    n: int
    heads: int
    kk: int
    floor: float

    name = "sbm_sampled"

    def full_weight(self, q, k, aux):
        from csat_tpu_torch.models.ste import sample_graph  # lazy: package cycle

        r, kh, padf, sseed = aux
        b, h, n, _ = r.shape
        noise = uniform_field(sseed, b, h, n, n, self.stride, r.device)
        graph = sample_graph(exp_adjacency(r, kh), noise, self.floor)
        return graph, graph * (1.0 - padf)[:, None, None, :]

    def full_weight_padded(self, aux, b: int, h: int, n_pad: int):
        r, kh, padf, sseed = aux
        rp, khp = _pad_nodes(r, n_pad), _pad_nodes(kh, n_pad)
        padp = torch.nn.functional.pad(padf, (0, n_pad - self.n), value=1.0)
        noise = uniform_field(sseed, b, h, n_pad, n_pad, self.stride, r.device)
        p = torch.clamp(exp_adjacency(rp, khp), self.floor, 0.99)
        a_raw = (noise < p).to(torch.float32) * _real_gate(self.n, n_pad, r.device)
        return a_raw * (1.0 - padp[:, None, None, :])


@dataclasses.dataclass(frozen=True)
class SBMGraphSpec(_SBMBase):
    """A materialised 0/1 graph (``noise_mode="shared"``), sampled outside
    through the STE and read as the weight (aux ``(graph, key_pad_f32)``);
    its cotangent flows back out through the plain backward."""

    n: int
    heads: int

    name = "sbm_graph"

    def full_weight(self, q, k, aux):
        graph, padf = aux
        return graph, graph * (1.0 - padf)[:, None, None, :]

    def full_weight_padded(self, aux, b: int, h: int, n_pad: int):
        graph, padf = aux
        extra = n_pad - self.n
        gp = torch.nn.functional.pad(graph, (0, extra, 0, extra))
        padp = torch.nn.functional.pad(padf, (0, extra), value=1.0)
        return gp * (1.0 - padp[:, None, None, :])


def cse_mod(rel_q, rel_k, rel, mask):
    """``rel_q``/``rel_k`` (H, R, dk) projected relative tables, ``rel``
    (B, 2, N, N) offset distances, ``mask`` (B, 2, N, N) bool (True = the raw
    distance was 0)."""
    h, r_len, dk = rel_q.shape
    n = rel.shape[-1]
    aux = (rel_q.float().contiguous(), rel_k.float().contiguous(),
           rel.to(torch.int32).contiguous(), mask.to(torch.bool).contiguous())
    return CSESpec(n=n, heads=h, dk=dk, r_len=r_len), aux


def sbm_expected_mod(q_hat, k_hat, s_aff, key_pad, floor: float = 0.01):
    """``q_hat``/``k_hat`` (B, H, N, kk) memberships, ``s_aff`` (H, kk, kk)
    cluster affinity, ``key_pad`` (B, N) truthy on padded keys."""
    b, h, n, kk = q_hat.shape
    r = torch.einsum("bhnk,hkj->bhnj", q_hat, s_aff)
    aux = (r.contiguous(), k_hat.contiguous(), key_pad.to(torch.float32).contiguous())
    return SBMExpectedSpec(n=n, heads=h, kk=kk, floor=float(floor)), aux


def sbm_sampled_mod(q_hat, k_hat, s_aff, key_pad, sample_seed, floor: float = 0.01):
    """Counter-mode sampled graph.  ``R = Q̂ S`` is formed here, so the
    cotangent of ``R`` reaches ``Q̂`` and ``S`` through plain autograd;
    ``sample_seed`` is a (1,) int32 tensor on the data's device (the kernels
    read it there: no host sync)."""
    b, h, n, kk = q_hat.shape
    r = torch.einsum("bhnk,hkj->bhnj", q_hat, s_aff)
    seed = torch.as_tensor(sample_seed, dtype=torch.int32, device=q_hat.device).reshape(1)
    aux = (r.contiguous(), k_hat.contiguous(), key_pad.to(torch.float32).contiguous(), seed)
    return SBMSampledSpec(n=n, heads=h, kk=kk, floor=float(floor)), aux


def sbm_graph_mod(graph, key_pad):
    """``graph`` (B, H, N, N) 0/1 f32, ``key_pad`` (B, N) truthy on padded keys."""
    b, h, n, _ = graph.shape
    aux = (graph.contiguous(), key_pad.to(torch.float32).contiguous())
    return SBMGraphSpec(n=n, heads=h), aux
