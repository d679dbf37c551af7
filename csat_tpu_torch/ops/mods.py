"""Attention mods on the serving path: CSE relative bias and SBM expected graph.

Torch counterparts of the JAX package's ``ops/mods.py`` ``CSESpec`` +
``cse_mod`` (``:374-501``) and ``SBMExpectedSpec`` + ``sbm_expected_mod``
(``:229-279, :481-485``).  A mod is a frozen spec of static facts plus the
``aux`` tuple of tensors it needs; ``full_weight`` / ``full_score`` evaluate
it over whole arrays (the plain path, :func:`~csat_tpu_torch.ops.flex_core.
flex_reference`), ``full_weight_padded`` gives the weight field on a padded
geometry (the block-skip oracle).  The CUDA kernel (``csrc/flex_fwd.cu``)
computes the same definitions tile by tile.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["CSESpec", "SBMExpectedSpec", "cse_mod", "sbm_expected_mod", "NEG_CSE"]

NEG_CSE = -1e9  # the reference's CSE mask fill for a live (weight 1) entry


def _real_gate(n: int, n_pad: int, device) -> torch.Tensor:
    idx = torch.arange(n_pad, device=device)
    return ((idx[:, None] < n) & (idx[None, :] < n)).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class CSESpec:
    """Disentangled L/T relative bias: the two planes of ``rel``/``mask``
    (B, 2, N, N) fan out to ``heads // 2`` pseudo-heads each."""

    n: int
    heads: int
    dk: int
    r_len: int

    name = "cse"

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
        rel8 = rel.repeat_interleave(self.group, dim=1).long()    # (B, H, N, N)
        mask8 = mask.repeat_interleave(self.group, dim=1)
        inv = self.scale(q.shape[-1])
        c2p_full = torch.einsum("bhnd,hrd->bhnr", q, lk)          # (B, H, N, R)
        c2p = torch.gather(c2p_full, 3, rel8)
        p2c_full = torch.einsum("hrd,bhmd->bhrm", lq, k)          # (B, H, R, N)
        # p2c[i, j] = (k_j · lq)[rel[j, i]]: the transpose of c2p's index
        p2c = torch.gather(p2c_full, 2, rel8.transpose(-1, -2))
        s = s + c2p * inv + p2c * inv
        return torch.where(mask8, torch.full_like(s, NEG_CSE), s)

    def full_weight_padded(self, aux, b: int, h: int, n_pad: int):
        real = _real_gate(self.n, n_pad, aux[0].device)
        return real.expand(b, h, n_pad, n_pad)


@dataclasses.dataclass(frozen=True)
class SBMExpectedSpec:
    """Bernoulli mean ``clip(R K̂ᵀ, floor, .99)`` as a soft weight, with the
    real-extent gate and the key-padding gate (``R = Q̂ S``)."""

    n: int
    heads: int
    kk: int
    floor: float

    name = "sbm_expected"

    def scale(self, dh: int) -> float:
        return 1.0 / math.sqrt(dh)

    def full_weight(self, q, k, aux):
        r, kh, padf = aux
        w_raw = torch.clamp(torch.einsum("bhnj,bhmj->bhnm", r, kh), self.floor, 0.99)
        return w_raw, w_raw * (1.0 - padf)[:, None, None, :]

    def full_score(self, s, q, k, aux):
        return s

    def full_weight_padded(self, aux, b: int, h: int, n_pad: int):
        r, kh, padf = aux
        extra = n_pad - self.n
        rp = torch.nn.functional.pad(r, (0, 0, 0, extra))
        khp = torch.nn.functional.pad(kh, (0, 0, 0, extra))
        padp = torch.nn.functional.pad(padf, (0, extra), value=1.0)
        exp_a = torch.einsum("bhnj,bhmj->bhnm", rp, khp)
        w_raw = torch.clamp(exp_a, self.floor, 0.99) * _real_gate(self.n, n_pad, r.device)
        return w_raw * (1.0 - padp[:, None, None, :])


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
