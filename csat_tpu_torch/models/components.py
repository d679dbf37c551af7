"""Shared model blocks: embeddings, feed-forward, decoder, output head.

Counterparts of the JAX package's ``models/components.py:39-420``.  The
decoder runs two ways: teacher-forced over the whole target sequence
(training, :meth:`Decoder.teacher_forced`, plain tensor ops as JAX leaves
them to XLA) and one token per slot per step with self and cross attention
reading K/V through the paged pool (serving, :meth:`Decoder.forward`,
``ops/paged_decode.py``).

Numerics follow the reference: LayerNorm eps 1e-5, exact GELU, -1e9
masked-score fill, and the Generator's ``log(max(softmax, 1e-30))`` form
when ``generator_dropout`` is set.  Dropout runs where the flax modules put
it, only when ``deterministic`` is False, with its keep mask drawn from the
caller's explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from csat_tpu_torch.ops.paged_decode import paged_attend
from csat_tpu_torch.utils import PAD

LN_EPS = 1e-5
NEG_INF = -1e9


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as flax applies it (``where(keep, x / (1 - rate),
    0)``), with the keep mask drawn from ``gen`` on ``x``'s device; the
    identity when ``deterministic`` or ``rate == 0``."""
    if deterministic or rate == 0.0:
        return x
    if gen is None:
        raise ValueError("dropout in training mode needs an explicit torch.Generator")
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """(size, size) bool, True above the diagonal (future positions)."""
    return torch.triu(torch.ones((size, size), dtype=torch.bool, device=device), diagonal=1)


def make_std_mask(seq: torch.Tensor, pad: int = PAD) -> torch.Tensor:
    """(B, T, T) bool mask hiding padding and future words. True = masked."""
    return (seq == pad)[:, None, :] | subsequent_mask(seq.shape[-1], seq.device)[None]


def sinusoidal_rows(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """Rows ``pos`` of the sin/cos position table, ``(|pos|, dim)`` f32."""
    position = pos.to(torch.float32)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=pos.device)
                    * -(math.log(10000.0) / dim))
    ang = position * div
    pe = torch.zeros((pos.shape[0], dim), dtype=torch.float32, device=pos.device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang[:, : dim // 2])
    return pe


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


class Embeddings(nn.Module):
    """Token embedding → optional sinusoidal position → LayerNorm → dropout.
    PAD lookups are zeroed (``pad_row="zero"``) or keep the table's row with
    its gradient blocked (``"frozen"``, the reference's padding_idx row)."""

    def __init__(self, vocab_size: int, hidden_size: int, dropout: float = 0.0,
                 with_pos: bool = False, pad_row: str = "zero"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab_size, hidden_size))
        self.norm = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.dropout = dropout
        self.with_pos = with_pos
        self.pad_row = pad_row

    def forward(self, x: torch.Tensor, pos: Optional[torch.Tensor] = None,
                deterministic: bool = True, gen: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``pos`` (B,) gives every row its own position (one token per
        slot); None uses positions ``0..T-1``."""
        emb = F.embedding(x, self.weight)
        is_pad = (x == PAD)[..., None]
        if self.pad_row == "zero":
            emb = torch.where(is_pad, torch.zeros_like(emb), emb)
        else:
            emb = torch.where(is_pad, emb.detach(), emb)
        if self.with_pos:
            dim = self.weight.shape[1]
            if pos is None:
                emb = emb + sinusoidal_rows(
                    torch.arange(x.shape[-1], device=x.device), dim)[None]
            else:
                emb = emb + sinusoidal_rows(pos, dim)[:, None, :]
        return dropout(self.norm(emb), self.dropout, deterministic, gen)


class FeedForward(nn.Module):
    """Linear → exact GELU → dropout → Linear."""

    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(d_model, d_ff)
        self.fc2 = nn.Linear(d_ff, d_model)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.gelu(self.fc1(x), approximate="none")
        return self.fc2(dropout(h, self.dropout, deterministic, gen))


class MultiHeadAttention(nn.Module):
    """Separate q/k/v/out projections; whole-sequence attention with
    attention-weight dropout (training), or decode-time attention through
    the paged KV pool (serving)."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.q = nn.Linear(d_model, d_model)
        self.k = nn.Linear(d_model, d_model)
        self.v = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def attend(self, q_in: torch.Tensor, kv_in: torch.Tensor, mask: torch.Tensor,
               deterministic: bool = True, gen: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """``q_in`` (B, Tq, D) attends over ``kv_in`` (B, Tk, D); ``mask``
        bool, broadcastable to (B, H, Tq, Tk), True on disallowed keys
        (score filled with -1e9 before the softmax)."""
        q = split_heads(self.q(q_in), self.num_heads)
        k = split_heads(self.k(kv_in), self.num_heads)
        v = split_heads(self.v(kv_in), self.num_heads)
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
        scores = torch.where(mask, torch.full_like(scores, NEG_INF), scores)
        attn = dropout(torch.softmax(scores, dim=-1), self.dropout, deterministic, gen)
        return self.out(merge_heads(torch.einsum("bhqk,bhkd->bhqd", attn, v)))

    def project_kv(self, kv_in: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Split-head K/V of the encoder memory, computed once at prefill."""
        return {"k": split_heads(self.k(kv_in), self.num_heads),
                "v": split_heads(self.v(kv_in), self.num_heads)}

    def attend_self(self, x: torch.Tensor, mask: torch.Tensor,
                    cache: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Self attention of one token per slot over its page chain, the
        current token merged at ``cache["idx"]``.  ``mask`` (S, width) True
        on disallowed lanes.  Returns ``(out, k_step, v_step)``; the caller
        writes ``k_step``/``v_step`` (S, H, 1, dh) into the pages."""
        q = split_heads(self.q(x), self.num_heads)
        k = split_heads(self.k(x), self.num_heads)
        v = split_heads(self.v(x), self.num_heads)
        out4, _ = paged_attend(
            q, cache["pages_k"], cache["pages_v"], cache["scale_k"],
            cache["scale_v"], cache["table"], mask, cache["width"],
            idx=cache["idx"], k_tok=k, v_tok=v)
        return self.out(merge_heads(out4)), k, v

    def attend_cross(self, x: torch.Tensor, mask: torch.Tensor,
                     kv: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Cross attention of one token per slot over the encoder memory's
        pages.  ``mask`` (S, mem_len) True on padded keys."""
        q = split_heads(self.q(x), self.num_heads)
        out4, _ = paged_attend(
            q, kv["pages_k"], kv["pages_v"], kv["scale_k"], kv["scale_v"],
            kv["table"], mask, kv["width"])
        return self.out(merge_heads(out4))


class DecoderLayer(nn.Module):
    """Pre-norm self-attention, cross-attention and FFN sublayers, each
    followed by dropout before its residual."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, dropout: float = 0.0):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout)
        self.cross_attn = MultiHeadAttention(d_model, num_heads, dropout)
        self.ff = FeedForward(d_model, d_ff, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = dropout

    def teacher_forced(self, tgt, memory, tgt_mask, mem_mask, deterministic, gen):
        drop = lambda x: dropout(x, self.dropout, deterministic, gen)
        normed = self.norm1(tgt)
        tgt = tgt + drop(self.self_attn.attend(normed, normed, tgt_mask, deterministic, gen))
        tgt = tgt + drop(self.cross_attn.attend(self.norm2(tgt), memory, mem_mask,
                                                deterministic, gen))
        return tgt + drop(self.ff(self.norm3(tgt), deterministic, gen))

    def forward(self, tgt, self_mask, mem_mask, cache):
        h, k_step, v_step = self.self_attn.attend_self(self.norm1(tgt), self_mask, cache["self"])
        tgt = tgt + h
        tgt = tgt + self.cross_attn.attend_cross(self.norm2(tgt), mem_mask, cache["cross"])
        tgt = tgt + self.ff(self.norm3(tgt))
        return tgt, k_step, v_step


class Decoder(nn.Module):
    """Stack of :class:`DecoderLayer` + final LayerNorm."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int, d_ff: int,
                 dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, num_heads, d_ff, dropout) for _ in range(num_layers))
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def teacher_forced(self, tgt, memory, tgt_mask, memory_key_pad,
                       deterministic: bool = True, gen: Optional[torch.Generator] = None):
        """Whole target sequence at once: ``tgt`` (B, T, D) embeddings,
        ``tgt_mask`` (B, T, T) from :func:`make_std_mask`, ``memory_key_pad``
        (B, N) True on padded nodes."""
        self_mask = tgt_mask[:, None]
        mem_mask = memory_key_pad[:, None, None, :]
        for layer in self.layers:
            tgt = layer.teacher_forced(tgt, memory, self_mask, mem_mask, deterministic, gen)
        return self.norm(tgt)

    def forward(self, tgt, self_mask, mem_mask, caches: List[Dict]):
        steps = []
        for layer, cache in zip(self.layers, caches):
            tgt, k_step, v_step = layer(tgt, self_mask, mem_mask, cache)
            steps.append((k_step, v_step))
        return self.norm(tgt), steps


class Generator(nn.Module):
    """Output head: linear → dropout → softmax → log(max(p, 1e-30)) (the
    reference's order) or plain ``log_softmax`` without dropout."""

    def __init__(self, d_model: int, vocab_size: int, reference_dropout: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(d_model, vocab_size)
        self.reference_dropout = reference_dropout
        self.dropout = dropout

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        logits = self.fc1(x)
        if self.reference_dropout:
            logits = dropout(logits, self.dropout, deterministic, gen)
            return torch.log(torch.clamp(torch.softmax(logits, dim=-1), min=1e-30))
        return torch.log_softmax(logits, dim=-1)
