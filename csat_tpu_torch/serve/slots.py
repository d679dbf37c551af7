"""The rectangle layout: per-slot KV rectangles and their decode step.

Counterpart of the JAX package's ``serve/slots.py`` (``serve_kv_layout=
"rect"``), the paged layout's A/B reference.  The pool holds ``S =
serve_slots`` in-flight requests: per decoder layer one ``(S, H, T, dh)``
self-attention K and V written one position per step and one ``(S, H, N,
dh)`` cross-attention K and V written once at prefill
(``serve/prefill.py:rect_prefill``), in the model's compute dtype, beside the
same per-slot decode state as the paged pool (``src_mask``, ``tok``,
``pos``, ``limit``, ``done``, ``prev_pad``, ``toks``; admission resets it
through the shared ``serve/pages.py:admit_slot_state``).

One decode step advances every live slot at its own position.  A slot is
live while ``pos < limit`` and not ``done``; frozen rows still flow through
the math, and their writes land on their own dead state (at a position past
the token capacity they write nothing, as JAX's one-hot write does).  The
attention reads the rectangles through the plain path
(``ops/paged_decode.py:rect_attend``): JAX's rect engine pins its XLA
reference path, and there is no Pallas kernel to port.  On f32 the step is
the paged plain path's arithmetic on the same values, so the two layouts
give the same tokens bit for bit on the CPU.

As everywhere in the port, the pool is updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from csat_tpu_torch.utils import EOS, PAD

__all__ = ["SlotPool", "init_pool", "build_decode_step"]


@dataclasses.dataclass
class SlotPool:
    """Device-resident rectangle slot state, updated in place."""

    # per layer: k, v (S, H, T, dh) self; cross_k, cross_v (S, H, N, dh)
    cache: List[Dict[str, torch.Tensor]]
    src_mask: torch.Tensor   # (S, N) bool — True = pad key (all True when free)
    tok: torch.Tensor        # (S, 1) int64 — current decoder input token
    pos: torch.Tensor        # (S,) int32 — tokens generated so far
    limit: torch.Tensor      # (S,) int32 — budget; 0 ⇒ slot frozen
    done: torch.Tensor       # (S,) bool — row emitted EOS
    prev_pad: torch.Tensor   # (S, T) bool — pad-ness of decoder inputs so far
    toks: torch.Tensor       # (S, T) int64 — generated ids (PAD beyond pos)


def init_pool(model, num_slots: int, steps: int, mem_len: int) -> SlotPool:
    """``num_slots`` empty slots (every one frozen, ``limit = 0``) with a
    ``steps``-token capacity and ``mem_len``-wide encoder memory, zeroed
    rectangles in the model's compute dtype."""
    cfg = model.cfg
    dev = model.device
    dh = cfg.hidden_size // cfg.num_heads

    def zeros(width):
        return torch.zeros((num_slots, cfg.num_heads, width, dh), dtype=model.dtype, device=dev)

    return SlotPool(
        cache=[{"k": zeros(steps), "v": zeros(steps), "cross_k": zeros(mem_len),
                "cross_v": zeros(mem_len)} for _ in model.decoder.layers],
        src_mask=torch.ones((num_slots, mem_len), dtype=torch.bool, device=dev),
        tok=torch.full((num_slots, 1), PAD, dtype=torch.long, device=dev),
        pos=torch.zeros((num_slots,), dtype=torch.int32, device=dev),
        limit=torch.zeros((num_slots,), dtype=torch.int32, device=dev),
        done=torch.zeros((num_slots,), dtype=torch.bool, device=dev),
        prev_pad=torch.zeros((num_slots, steps), dtype=torch.bool, device=dev),
        toks=torch.full((num_slots, steps), PAD, dtype=torch.long, device=dev),
    )


def build_decode_step(model):
    """→ ``step(pool) -> status``: advance every live slot one token,
    writing each row's K/V at its own position; ``status`` is the ``(S, 3)``
    int32 ``[pos, done, bad]`` snapshot of the paged step."""

    @torch.no_grad()
    def step(pool: SlotPool) -> torch.Tensor:
        caches = [{"self": {"k": c["k"], "v": c["v"], "idx": pool.pos},
                   "cross": {"k": c["cross_k"], "v": c["cross_v"]}} for c in pool.cache]
        log_probs, steps = model.decode_step(pool.tok, pool.pos, caches, pool.src_mask,
                                             pool.prev_pad)
        nxt = torch.argmax(log_probs, dim=-1)                       # (S,)
        act = (~pool.done) & (pool.pos < pool.limit)
        bad = act & torch.any(~torch.isfinite(log_probs), dim=-1)
        nxt = torch.where(act, nxt, torch.full_like(nxt, PAD))

        pos = pool.pos.long()
        t_cap = pool.toks.shape[1]
        rows = torch.arange(pos.shape[0], device=pos.device)
        # every row writes at its own position (frozen rows on their dead
        # state); a position past the capacity writes nothing
        fits = (pos < t_cap)[:, None, None]
        at = torch.clamp(pos, max=t_cap - 1)
        for c, (k_step, v_step) in zip(pool.cache, steps):
            for key, new in (("k", k_step), ("v", v_step)):
                old = c[key][rows, :, at]                            # (S, H, dh)
                c[key][rows, :, at] = torch.where(fits, new[:, :, 0].to(c[key].dtype), old)

        ar = torch.arange(t_cap, device=pos.device)[None, :]
        write = (ar == pos[:, None]) & act[:, None]
        pool.toks.copy_(torch.where(write, nxt[:, None], pool.toks))
        write_next = (ar == (pos + 1)[:, None]) & act[:, None]
        pool.prev_pad.copy_(torch.where(write_next, (nxt == PAD)[:, None], pool.prev_pad))
        pool.done |= act & (nxt == EOS)
        pool.pos.copy_(torch.where(act, pool.pos + 1, pool.pos))
        pool.tok.copy_(torch.where(act[:, None], nxt[:, None], pool.tok))
        return torch.stack([pool.pos, pool.done.to(torch.int32), bad.to(torch.int32)], dim=1)

    return step
