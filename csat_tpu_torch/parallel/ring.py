"""Ring attention: sequence-parallel SBM (and dense) attention over a ``seq`` axis.

Counterpart of the JAX package's ``parallel/ring.py``.  Each process of a
``seq`` line holds its own N/P node rows of q, k, v and the cluster
memberships; the K/V/K̂/pad blocks rotate one hop around the line
(:func:`~csat_tpu_torch.parallel.collectives.ppermute`) while each process
accumulates flash-style streaming softmax statistics over one incoming block
at a time: a running max, the running weight sum and the weighted V sum,
scores outside the sampled graph filled with ``-1e30``.

The Bernoulli draw of every (i, j) pair comes from the counter hash at the
global (batch·head, row, col) indices (:func:`~csat_tpu_torch.ops.hashrng.
block_uniform`, ``bh = (b0 + b)·H + h0 + h`` with ``b0`` the data
coordinate's first row and ``h0`` the ``model`` coordinate's first head, JAX
``ring.py:137-139``), so the sampled graph is the one-process graph bit for
bit — also on a head shard, where the ring runs this member's heads; the
adjacency ``R K̂ᵀ`` is summed cluster by cluster as the plain path and the
kernels sum it, and the straight-through estimator enters through
:func:`~csat_tpu_torch.models.ste.sample_graph`.  Attention dropout is the
counter keep-field at the same indices; ``graph_sums`` (ΣA per batch row and
head) is summed over the line.

The step body is plain PyTorch, as it is plain ``jnp`` in JAX (no Pallas
kernel there to port).  JAX checkpoints the whole step body, rotation
included; here the rotated blocks are kept (O(N·d/P) each) and only each
step's block scores (O(N²/P²)) are recomputed in the backward
(``torch.utils.checkpoint``), so the backward's only communication is the
reverse rotation of the block cotangents, which every process of the line
makes in the same order.  The last rotation, which only restores the layout,
is not made.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from csat_tpu_torch.ops.hashrng import block_uniform, global_bh, noise_stride
from csat_tpu_torch.ops.mods import exp_adjacency
from csat_tpu_torch.parallel.collectives import ppermute, psum_axis

BIG = 1e30

__all__ = ["ring_active", "node_block", "ring_sbm_attention", "ring_full_attention"]


def ring_active(shard) -> bool:
    """True when ``shard`` (a :class:`~csat_tpu_torch.parallel.mesh.DataShard`)
    splits the node axis over a ``seq`` axis of more than one process — the
    only case where the ring differs from the plain computation."""
    return shard is not None and shard.seq is not None and shard.seq.size > 1


def node_block(n: int, axis) -> Tuple[int, int]:
    """``(n0, nl)``: the node rows ``[n0, n0 + nl)`` of ``n`` that this
    process of ``axis`` holds.  Refuses an ``n`` the axis does not divide
    (JAX ``ring.py:174-177``)."""
    if n % axis.size:
        raise ValueError(f"ring attention needs N ({n}) divisible by the seq axis ({axis.size})")
    nl = n // axis.size
    return axis.index * nl, nl


def _step(q, r, k_cur, v_cur, kh_cur, pad_cur, m, l, acc, sseed, dseed, bh, row0: int,
          col0: int, stride: int, rate: float, scale: float, floor: float):
    """One block: the (local q rows, current k block) scores, the sampled
    graph (``r`` None: the dense variant, the live set the unpadded keys),
    the streaming-softmax update.  → ``(m, l, acc, ΣA of the block or
    None)``."""
    from csat_tpu_torch.models.ste import sample_graph  # lazy: the models import this module

    nl, nk = q.shape[2], k_cur.shape[2]
    live_keys = (1.0 - pad_cur)[:, None, None, :]
    if r is None:
        a_raw = None
        a_eff = live_keys.expand(q.shape[0], q.shape[1], nl, nk)
    else:
        u = block_uniform(sseed, bh, row0, col0, nl, nk, stride)
        a_raw = sample_graph(exp_adjacency(r, kh_cur), u, floor)
        a_eff = a_raw * live_keys
    s = torch.einsum("bhnd,bhmd->bhnm", q, k_cur) * scale
    s = torch.where(a_eff > 0, s, torch.full_like(s, -BIG))
    m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    w = torch.exp(s - m_new) * a_eff
    l = l * alpha + torch.sum(w, dim=-1, keepdim=True)
    if rate > 0.0:
        ud = block_uniform(dseed, bh, row0, col0, nl, nk, stride)
        w = w * torch.where(ud >= rate, torch.full_like(ud, 1.0 / (1.0 - rate)),
                            torch.zeros_like(ud))
    acc = acc * alpha + torch.einsum("bhnm,bhmd->bhnd", w, v_cur)
    return m_new, l, acc, (None if a_raw is None else torch.sum(a_raw, dim=(2, 3)))


def _ring(q, k, v, r, k_hat, key_pad, sseed, dseed, axis, rate: float, floor: float,
          bh0: int, h_total: int = 0):
    b, h, nl, dh = q.shape
    p, my = axis.size, axis.index
    n = nl * p
    row0, stride, scale = my * nl, noise_stride(n), 1.0 / math.sqrt(dh)
    bh = global_bh(b, h, q.device, bh0, h_total)
    m = torch.full((b, h, nl, 1), -BIG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, nl, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, nl, dh), dtype=torch.float32, device=q.device)
    spars = None
    pad = key_pad.to(torch.float32)
    blocks = (k, v, pad) if r is None else (k, v, k_hat, pad)
    grad = torch.is_grad_enabled()
    for t in range(p):
        # after t hops this process holds shard (my - t) mod p's block
        col0 = ((my - t) % p) * nl
        k_cur, v_cur = blocks[0], blocks[1]
        kh_cur = None if r is None else blocks[2]
        args = (q, r, k_cur, v_cur, kh_cur, blocks[-1], m, l, acc, sseed, dseed, bh, row0,
                col0, stride, rate, scale, floor)
        if grad:
            from torch.utils.checkpoint import checkpoint

            m, l, acc, blk = checkpoint(_step, *args, use_reentrant=False,
                                        preserve_rng_state=False)
        else:
            m, l, acc, blk = _step(*args)
        if blk is not None:
            spars = blk if spars is None else spars + blk
        if t + 1 < p:
            blocks = ppermute(blocks, axis, 1)
    out = torch.where(l > 0.0, acc / torch.clamp(l, min=1e-30), torch.zeros_like(acc))
    return out, spars


def ring_sbm_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_hat: torch.Tensor,
                       k_hat: torch.Tensor, s_aff: torch.Tensor, key_pad: torch.Tensor,
                       sample_seed: torch.Tensor, axis, dropout_rate: float = 0.0,
                       dropout_seed: Optional[torch.Tensor] = None, floor: float = 0.01,
                       bh0: int = 0, h_total: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ring SBM attention over ``axis`` (the ``seq`` line).  ``q`` / ``k`` /
    ``v`` (B, H, N/P, dh), ``q_hat`` / ``k_hat`` (B, H, N/P, kk) and
    ``key_pad`` (B, N/P) are this process's node rows; ``s_aff`` (H, kk, kk)
    the cluster affinity; ``sample_seed`` / ``dropout_seed`` (1,) int32 hash
    seeds; ``bh0`` the batch·head offset of this process's batch rows and
    heads, ``h_total`` the global head count (0: ``H``, no head shard).
    → ``(out (B, H, N/P, dh), graph_sums (B, H))``, ``graph_sums`` the ΣA of
    the whole rows (the same on every process of the line)."""
    r = torch.einsum("bhnk,hkj->bhnj", q_hat, s_aff)
    dseed = dropout_seed if dropout_rate > 0.0 else None
    out, spars = _ring(q, k, v, r, k_hat, key_pad, sample_seed, dseed, axis,
                       float(dropout_rate), float(floor), bh0, h_total)
    return out, psum_axis(spars, axis)


def ring_full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_pad: torch.Tensor, axis, dropout_rate: float = 0.0,
                        dropout_seed: Optional[torch.Tensor] = None,
                        bh0: int = 0, h_total: int = 0) -> torch.Tensor:
    """Ring dense masked attention (the ``full_att`` family) over ``axis``;
    attention dropout from the counter keep-field (JAX ``ring.py:241-263``:
    the distribution of ``nn.Dropout``, another realisation)."""
    dseed = dropout_seed if dropout_rate > 0.0 else None
    out, _ = _ring(q, k, v, None, None, key_pad, None, dseed, axis, float(dropout_rate), 0.0,
                   bh0, h_total)
    return out
