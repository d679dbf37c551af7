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

Precision follows flax's ``dtype`` semantics module by module (not
``torch.autocast``, whose op lists put the casts elsewhere): the parameters
are f32 master weights; each module computes in its ``dtype`` (the config's
``compute_dtype``) by casting its input and weights, as ``Dense(dtype=…)``
does (:func:`dense`); LayerNorms compute in f32 and return ``dtype``
(:func:`layer_norm`); the attention scores, softmax, dropout and ·V are an
f32 island (:func:`attention`, the paged decode) whose merged heads are cast
back to ``dtype`` before the output projection; the output head and its
log-softmax stay f32.  In f32 every cast is the identity.

Under tensor parallelism (a module's ``tp``, the ``model`` line that
``parallel.mesh.shard_model`` hands it) the modules hold their shards of
the parameters the JAX ``PARAM_RULES`` split and run Megatron's layout:
q/k/v and the first FFN dense column-parallel (this member's heads and
hidden units; :func:`col_dense`, their input entering through
``copy_to_model``), the out-projections and the second FFN dense
row-parallel (:func:`row_dense`: the partial products summed over the line
before the bias), the embedding tables split on features and gathered, and
the output head row-parallel on its replicated input.  Dropout on a sharded
activation draws its mask at the whole width and keeps this member's part.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from csat_tpu_torch.ops.hashrng import KeyedStream
from csat_tpu_torch.ops.paged_decode import paged_attend, rect_attend
from csat_tpu_torch.parallel.collectives import (
    copy_to_model, gather_features, reduce_from_model, scatter_features)
from csat_tpu_torch.utils import PAD

LN_EPS = 1e-5
NEG_INF = -1e9


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied as flax's ``Dense(dtype=dtype)`` over f32
    parameters: input, weight and bias cast to ``dtype``, the product
    rounded to it, then the bias added in it — two roundings in bf16, as
    XLA's (``F.linear`` with a bf16 bias fuses the add: one rounding).  In
    f32, ``layer`` itself."""
    if dtype == torch.float32:
        return layer(x.to(dtype))
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


def col_dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype, tp=None) -> torch.Tensor:
    """A column-parallel ``layer`` (its weight this member's output rows, its
    bias whole) as :func:`dense`: the product with the bias's slice of this
    member's outputs.  ``x`` has entered through ``copy_to_model`` (the
    caller's, once for the layers sharing it).  Without ``tp``,
    :func:`dense`."""
    if tp is None:
        return dense(layer, x, dtype)
    rows = layer.weight.shape[0]
    bias = layer.bias.narrow(0, tp.index * rows, rows)
    if dtype == torch.float32:
        return F.linear(x, layer.weight, bias)
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + bias.to(dtype)


def row_dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype, tp=None) -> torch.Tensor:
    """A row-parallel ``layer`` (its weight this member's input columns, its
    bias whole) on this member's input features ``x``: the partial products
    summed over ``tp``, then the bias.  Without ``tp``, :func:`dense`."""
    if tp is None:
        return dense(layer, x, dtype)
    part = F.linear(x.to(dtype), layer.weight.to(dtype))
    return reduce_from_model(part, tp) + layer.bias.to(dtype)


def head_range(tp, heads: int) -> Tuple[int, int]:
    """``(h0, h)``: the first of this ``model`` member's heads and their
    count, of ``heads`` (all of them without ``tp``)."""
    if tp is None:
        return 0, heads
    h = heads // tp.size
    return tp.index * h, h


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``norm`` as flax's ``LayerNorm(dtype=dtype)``: statistics, scale and
    shift in f32, the result rounded to ``dtype``.  An f32 ``x`` goes
    through ``norm`` itself.  A lower-precision ``x`` is cast to f32 twice,
    as flax casts it: once for the statistics (``E[x]`` and ``E[x²]``, the
    variance ``E[x²] − E[x]²`` clipped at 0) and once for ``x − E[x]``, so
    that the backward rounds each cast's cotangent to ``x``'s dtype before
    adding them, as JAX's does."""
    if x.dtype == torch.float32:
        return norm(x).to(dtype)
    xs = x.to(torch.float32)
    mean = xs.mean(dim=-1, keepdim=True)
    var = torch.clamp(torch.square(xs).mean(dim=-1, keepdim=True) - torch.square(mean), min=0.0)
    mul = torch.rsqrt(var + norm.eps) * norm.weight
    return ((x.to(torch.float32) - mean) * mul + norm.bias).to(dtype)


class _Erfc(torch.autograd.Function):
    """``erfc`` whose backward is JAX's, ``(−2/√π · g) · exp(−x²)`` op by op
    in ``x``'s dtype (torch's own rounds those products in another order)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.special.erfc(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        c = float(torch.tensor(-2.0 / math.sqrt(math.pi), dtype=x.dtype))
        return (c * g) * torch.exp(-torch.square(x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU.  In f32 ``F.gelu``; in another dtype flax's
    ``nn.gelu(approximate=False)`` expression, ``0.5·x·erfc(−x·√½)`` with
    √½ in that dtype, op by op, forward and backward, each result rounded
    to it as jnp's are (``F.gelu`` rounds only its result, and lands an ulp
    from JAX's where they differ)."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="none")
    sqrt_half = float(torch.tensor(0.5 ** 0.5, dtype=x.dtype))
    return 0.5 * x * _Erfc.apply(-x * sqrt_half)


def uniform(gen, shape, device) -> torch.Tensor:
    """Uniform [0, 1) f32 of ``shape`` from ``gen``: a ``torch.Generator``
    on ``device``, or a pipeline stage's
    :class:`~csat_tpu_torch.ops.hashrng.KeyedStream`."""
    if isinstance(gen, KeyedStream):
        return gen.rand(shape)
    return torch.rand(tuple(shape), generator=gen, device=device)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            gen: Optional[torch.Generator], shard=None, node_axis: Optional[int] = None,
            part: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Inverted dropout as flax applies it (``where(keep, x / (1 - rate),
    0)``), with the keep mask drawn from ``gen`` on ``x``'s device; the
    identity when ``deterministic`` or ``rate == 0``.  ``x``'s leading axis
    is the batch.  With ``shard`` (a
    :class:`~csat_tpu_torch.parallel.mesh.DataShard`) the mask is drawn at
    the global batch's shape and ``x``'s rows take their slice of it: every
    process of a data-parallel step advances ``gen`` alike and drops what one
    process would drop for these rows of the global batch.  When the shard
    splits the node axis (``shard.nodes``, inside the SBM stack under a
    ``seq`` axis) and ``x``'s ``node_axis`` is that axis, the mask is drawn
    at the whole node count and the shard's node rows are kept too.
    ``part`` ``(dim, offset, total)`` marks ``x``'s ``dim`` as a ``model``
    member's slice ``[offset, offset + x.shape[dim])`` of ``total`` (its
    heads, its hidden units): the mask is drawn at ``total`` and sliced."""
    if deterministic or rate == 0.0:
        return x
    if gen is None:
        raise ValueError("dropout in training mode needs an explicit torch.Generator")
    row0, rows = (0, x.shape[0]) if shard is None else (shard.row0, shard.rows)
    shape = [rows] + list(x.shape[1:])
    split = shard is not None and shard.nodes is not None and node_axis is not None
    if split:
        shape[node_axis] = shard.nodes
    if part is not None:
        shape[part[0]] = part[2]
    u = uniform(gen, shape, x.device)[row0:row0 + x.shape[0]]
    if split:
        u = u.narrow(node_axis, shard.node0, x.shape[node_axis])
    if part is not None:
        u = u.narrow(part[0], part[1], x.shape[part[0]])
    keep = u >= rate
    # flax divides by the keep probability as a weak-typed scalar: in bf16,
    # by 1 - rate rounded to bf16
    keep_prob = float(torch.tensor(1.0 - rate, dtype=x.dtype))
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def remat(fn, generators, *args):
    """``fn(*args)`` with its activations dropped after the forward and
    recomputed in the backward (``torch.utils.checkpoint``, non-reentrant):
    the JAX package's ``nn.remat``.  The recompute must draw what the
    forward drew — the dropout masks and the hash seeds, or it would sample
    another graph — so each explicit generator in ``generators`` (None
    entries are skipped) is set back to its state at the forward's start
    for the recompute and restored to its current state after it.
    Checkpoint's own stash covers only the default generators, which the
    model never draws from.  Outside autograd (``torch.no_grad``) it is the
    plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint

    gens = [g for g in generators if g is not None]
    start = [g.get_state() for g in gens]
    calls = []

    def run(*a):
        if not calls:  # the forward
            calls.append(1)
            return fn(*a)
        now = [g.get_state() for g in gens]
        for g, state in zip(gens, start):
            g.set_state(state)
        try:
            return fn(*a)
        finally:
            for g, state in zip(gens, now):
                g.set_state(state)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
              rate: float = 0.0, deterministic: bool = True,
              gen: Optional[torch.Generator] = None, shard=None,
              heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The decoder's f32 attention island: ``q`` (B, H, Tq, dh) over ``k``/
    ``v`` (B, H, Tk, dh), whatever their dtype, scores over √dh, -1e9 where
    ``mask`` (broadcastable bool, True = disallowed), softmax, dropout at
    ``rate``, ·V — all in f32.  ``heads`` ``(h0, total)`` places a ``model``
    member's heads among all of them (the dropout mask's draw).  → (B, H,
    Tq, dh) f32."""
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    scores = torch.where(mask, torch.full_like(scores, NEG_INF), scores)
    part = None if heads is None else (1, heads[0], heads[1])
    attn = dropout(torch.softmax(scores, dim=-1), rate, deterministic, gen, shard, part=part)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v)


class Embeddings(nn.Module):
    """Token embedding → optional sinusoidal position → LayerNorm → dropout.
    PAD lookups are zeroed (``pad_row="zero"``) or keep the table's row with
    its gradient blocked (``"frozen"``, the reference's padding_idx row)."""

    def __init__(self, vocab_size: int, hidden_size: int, dropout: float = 0.0,
                 with_pos: bool = False, pad_row: str = "zero",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab_size, hidden_size))
        self.norm = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.dropout = dropout
        self.with_pos = with_pos
        self.pad_row = pad_row
        self.dtype = dtype
        self.tp = None  # the model line: the table split on features

    def forward(self, x: torch.Tensor, pos: Optional[torch.Tensor] = None,
                deterministic: bool = True, gen: Optional[torch.Generator] = None,
                shard=None) -> torch.Tensor:
        """``pos`` (B,) gives every row its own position (one token per
        slot); None uses positions ``0..T-1``.  The lookup and the position
        add are f32, the LayerNorm returns ``dtype``."""
        # indexing, not F.embedding: its backward on the card is index_put_
        # with accumulate, which sorts the indices and adds the rows of a
        # repeated token in a fixed order; F.embedding's adds them in an
        # order that changes from run to run
        emb = self.weight[x]
        is_pad = (x == PAD)[..., None]
        if self.pad_row == "zero":
            emb = torch.where(is_pad, torch.zeros_like(emb), emb)
        else:
            emb = torch.where(is_pad, emb.detach(), emb)
        emb = gather_features(emb, self.tp, emb.dim() - 1)
        if self.with_pos:
            dim = emb.shape[-1]
            if pos is None:
                emb = emb + sinusoidal_rows(
                    torch.arange(x.shape[-1], device=x.device), dim)[None]
            else:
                emb = emb + sinusoidal_rows(pos, dim)[:, None, :]
        return dropout(layer_norm(self.norm, emb, self.dtype), self.dropout, deterministic, gen,
                       shard)


class FeedForward(nn.Module):
    """Linear → exact GELU → dropout → Linear."""

    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(d_model, d_ff)
        self.fc2 = nn.Linear(d_ff, d_model)
        self.dropout = dropout
        self.dtype = dtype
        self.tp = None  # the model line: fc1 column-, fc2 row-parallel

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                gen: Optional[torch.Generator] = None, shard=None) -> torch.Tensor:
        tp = self.tp
        h = gelu(col_dense(self.fc1, copy_to_model(x, tp), self.dtype, tp))
        part = None
        if tp is not None:
            width = h.shape[-1]
            part = (h.dim() - 1, tp.index * width, width * tp.size)
        h = dropout(h, self.dropout, deterministic, gen, shard, part=part)
        return row_dense(self.fc2, h, self.dtype, tp)


class MultiHeadAttention(nn.Module):
    """Separate q/k/v/out projections in ``dtype``; whole-sequence attention
    with attention-weight dropout (training), or decode-time attention
    through the paged KV pool (serving) — either an f32 island."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.dtype = dtype
        self.q = nn.Linear(d_model, d_model)
        self.k = nn.Linear(d_model, d_model)
        self.v = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)
        self.tp = None  # the model line: q/k/v column-, out row-parallel

    @property
    def local_heads(self) -> int:
        """The heads this module runs (its ``model`` member's share)."""
        return head_range(self.tp, self.num_heads)[1]

    def project(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """(B, T, D) through one of the q/k/v projections → split heads
        (B, H, T, dh) in ``dtype`` (this member's heads; ``x`` entered
        through ``copy_to_model`` under ``tp``)."""
        return split_heads(col_dense(layer, x, self.dtype, self.tp), self.local_heads)

    def merge_out(self, out4: torch.Tensor) -> torch.Tensor:
        """The f32 island's (B, H, T, dh) heads merged, cast back to
        ``dtype`` and through the output projection."""
        return row_dense(self.out, merge_heads(out4).to(self.dtype), self.dtype, self.tp)

    def attend(self, q_in: torch.Tensor, kv_in: torch.Tensor, mask: torch.Tensor,
               deterministic: bool = True, gen: Optional[torch.Generator] = None,
               shard=None) -> torch.Tensor:
        """``q_in`` (B, Tq, D) attends over ``kv_in`` (B, Tk, D; None: over
        ``q_in`` itself); ``mask`` bool, broadcastable to (B, H, Tq, Tk), True
        on disallowed keys (score filled with -1e9 before the softmax)."""
        tp = self.tp
        q_in = copy_to_model(q_in, tp)
        kv_in = q_in if kv_in is None else copy_to_model(kv_in, tp)
        q, k, v = (self.project(w, x) for w, x in ((self.q, q_in), (self.k, kv_in),
                                                      (self.v, kv_in)))
        # a model member's heads among all of them: its dropout mask's slice
        kw = {} if tp is None else {"heads": (head_range(tp, self.num_heads)[0], self.num_heads)}
        return self.merge_out(attention(q, k, v, mask, self.dropout, deterministic, gen, shard,
                                        **kw))

    def project_kv(self, kv_in: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Split-head K/V of the encoder memory in ``dtype``, computed once
        at prefill."""
        return {"k": self.project(self.k, kv_in), "v": self.project(self.v, kv_in)}

    def attend_self(self, x: torch.Tensor, mask: torch.Tensor,
                    cache: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Self attention of one token per slot over its page chain, the
        current token merged at ``cache["idx"]``.  ``mask`` (S, width) True
        on disallowed lanes.  Returns ``(out, k_step, v_step)``; the caller
        writes ``k_step``/``v_step`` (S, H, 1, dh), in ``dtype``, into the
        pages."""
        q, k, v = (self.project(w, x) for w in (self.q, self.k, self.v))
        out4 = _paged(cache, q, mask, k, v)
        return self.merge_out(out4), k, v

    def attend_cross(self, x: torch.Tensor, mask: torch.Tensor,
                     kv: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Cross attention of one token per slot over the encoder memory's
        pages.  ``mask`` (S, mem_len) True on padded keys."""
        return self.merge_out(_paged(kv, self.project(self.q, x), mask))


def _paged(cache: Dict, q: torch.Tensor, mask: torch.Tensor,
           k: Optional[torch.Tensor] = None, v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``q`` (S, H, 1, dh) through the page views ``cache`` (with ``k``/``v``,
    self attention merging the current token) → (S, H, 1, dh) f32.  A serve
    mesh's views (``cache["shards"]``: ``(h0, h1, views)`` per head shard)
    attend each shard's heads on its device; the head outputs are gathered
    back on ``q``'s before the replicated output projection.  The rectangle
    layout's views (``cache["k"]`` / ``cache["v"]``, ``serve/slots.py``) go
    through the plain rectangle read."""
    if "k" in cache:
        return rect_attend(q, cache["k"], cache["v"], mask, idx=cache.get("idx"), k_tok=k,
                           v_tok=v)
    if "shards" not in cache:
        return paged_attend(q, cache["pages_k"], cache["pages_v"], cache["scale_k"],
                            cache["scale_v"], cache["table"], mask, cache["width"],
                            idx=cache.get("idx"), k_tok=k, v_tok=v)[0]
    outs = []
    for h0, h1, c in cache["shards"]:
        dev = c["pages_k"].device
        part = lambda t: None if t is None else t[:, h0:h1].to(dev)
        out, _ = paged_attend(part(q), c["pages_k"], c["pages_v"], c["scale_k"], c["scale_v"],
                              c["table"], mask.to(dev), c["width"], idx=c.get("idx"),
                              k_tok=part(k), v_tok=part(v))
        outs.append(out.to(q.device))
    return torch.cat(outs, dim=1)


class DecoderLayer(nn.Module):
    """Pre-norm self-attention, cross-attention and FFN sublayers, each
    followed by dropout before its residual; the residual stream in
    ``dtype``."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout, dtype)
        self.cross_attn = MultiHeadAttention(d_model, num_heads, dropout, dtype)
        self.ff = FeedForward(d_model, d_ff, dropout, dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = dropout
        self.dtype = dtype

    def normed(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """``x`` through LayerNorm ``norm{i}``, in ``dtype``."""
        return layer_norm(getattr(self, f"norm{i}"), x, self.dtype)

    def teacher_forced(self, tgt, memory, tgt_mask, mem_mask, deterministic, gen, shard=None):
        drop = lambda x: dropout(x, self.dropout, deterministic, gen, shard)
        tgt = tgt + drop(self.self_attn.attend(self.normed(1, tgt), None, tgt_mask,
                                               deterministic, gen, shard))
        tgt = tgt + drop(self.cross_attn.attend(self.normed(2, tgt), memory, mem_mask,
                                                deterministic, gen, shard))
        return tgt + drop(self.ff(self.normed(3, tgt), deterministic, gen, shard))

    def forward(self, tgt, self_mask, mem_mask, cache):
        h, k_step, v_step = self.self_attn.attend_self(self.normed(1, tgt), self_mask,
                                                       cache["self"])
        tgt = tgt + h
        tgt = tgt + self.cross_attn.attend_cross(self.normed(2, tgt), mem_mask, cache["cross"])
        tgt = tgt + self.ff(self.normed(3, tgt))
        return tgt, k_step, v_step


class Decoder(nn.Module):
    """Stack of :class:`DecoderLayer` + final LayerNorm (in ``dtype``)."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int, d_ff: int,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, num_heads, d_ff, dropout, dtype) for _ in range(num_layers))
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dtype = dtype

    def final_norm(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(self.norm, x, self.dtype)

    def teacher_forced(self, tgt, memory, tgt_mask, memory_key_pad,
                       deterministic: bool = True, gen: Optional[torch.Generator] = None,
                       shard=None):
        """Whole target sequence at once: ``tgt`` (B, T, D) embeddings,
        ``tgt_mask`` (B, T, T) from :func:`make_std_mask`, ``memory_key_pad``
        (B, N) True on padded nodes."""
        self_mask = tgt_mask[:, None]
        mem_mask = memory_key_pad[:, None, None, :]
        for layer in self.layers:
            tgt = layer.teacher_forced(tgt, memory, self_mask, mem_mask, deterministic, gen,
                                       shard)
        return self.final_norm(tgt)

    def forward(self, tgt, self_mask, mem_mask, caches: List[Dict]):
        steps = []
        for layer, cache in zip(self.layers, caches):
            tgt, k_step, v_step = layer(tgt, self_mask, mem_mask, cache)
            steps.append((k_step, v_step))
        return self.final_norm(tgt), steps


class Generator(nn.Module):
    """Output head, f32 whatever the compute dtype: linear → dropout →
    softmax → log(max(p, 1e-30)) (the reference's order) or plain
    ``log_softmax`` without dropout."""

    def __init__(self, d_model: int, vocab_size: int, reference_dropout: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(d_model, vocab_size)
        self.reference_dropout = reference_dropout
        self.dropout = dropout
        self.tp = None  # the model line: row-parallel on the replicated input

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                gen: Optional[torch.Generator] = None, shard=None) -> torch.Tensor:
        if self.tp is not None:
            x = scatter_features(x, self.tp, x.dim() - 1)
        logits = row_dense(self.fc1, x, torch.float32, self.tp)
        if self.reference_dropout:
            logits = dropout(logits, self.dropout, deterministic, gen, shard)
            return torch.log(torch.clamp(torch.softmax(logits, dim=-1), min=1e-30))
        return torch.log_softmax(logits, dim=-1)
