"""Greedy decoding for evaluation.

Counterpart of the JAX package's ``train/decode.py`` (the reference's
``GreedyGenerator``): encode once, then emit ``T - 1`` tokens by argmax from
BOS, with no early stop (truncation at ``</s>`` happens in the metric
transform).  ``T - 1`` is the width of ``batch.tgt_seq``, so length-bucketed
batches decode at their bucket's capacity.

* :func:`greedy_decode` keeps a rectangular per-layer KV cache
  ``(B, H, T - 1, dh)`` and the cross-attention K/V projected once from the
  memory; ``prev_pad`` reproduces the reference's ``make_std_mask(ys, 0)``: a
  *generated* PAD token is masked out of later self attention.
* :func:`greedy_decode_early_eos` (``cfg.decode_early_eos``) runs the same
  steps and stops once every row has emitted ``</s>``; positions after the
  exit stay PAD, and each row's prefix up to its first EOS is identical.

JAX runs this decode as plain XLA code outside any Pallas kernel, so it is
plain PyTorch here (the paged-decode kernel belongs to the serving engine).
The encoder under it runs the flex-attention kernels on the card: the CSE
forward and, per ``cfg.eval_graph``, the expected- or sampled-graph SBM
forward.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from csat_tpu_torch.data.dataset import Batch
from csat_tpu_torch.models.components import NEG_INF, merge_heads, split_heads
from csat_tpu_torch.utils import BOS, EOS, PAD

__all__ = ["greedy_decode", "greedy_decode_early_eos", "decode_fn"]


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor):
    """One query per row: ``q`` (B, H, 1, dh) over ``k``/``v`` (B, H, W, dh),
    ``mask`` (B, W) True on disallowed keys (-1e9 fill, as the decoder's
    teacher-forced attention)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    scores = torch.where(mask[:, None, None, :], torch.full_like(scores, NEG_INF), scores)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), v)


def _decode_step(model, tok, i: int, caches, src_mask, prev_pad):
    """One lockstep decoder step at position ``i`` over the rectangular
    cache (the JAX ``CSATrans.decode_step`` with a scalar position).
    Returns log-probs (B, V); writes this step's self K/V into ``caches``."""
    steps = prev_pad.shape[1]
    pos = torch.full((tok.shape[0],), i, dtype=torch.long, device=tok.device)
    x = model.tgt_embedding(tok, pos=pos)
    future = torch.arange(steps, device=tok.device)[None, :] > i
    self_mask = prev_pad | future
    for layer, cache in zip(model.decoder.layers, caches):
        attn, h = layer.self_attn, layer.self_attn.num_heads
        normed = layer.norm1(x)
        cache["k"][:, :, i] = split_heads(attn.k(normed), h)[:, :, 0]
        cache["v"][:, :, i] = split_heads(attn.v(normed), h)[:, :, 0]
        out = _attend(split_heads(attn.q(normed), h), cache["k"], cache["v"], self_mask)
        x = x + attn.out(merge_heads(out))
        cross = layer.cross_attn
        out = _attend(split_heads(cross.q(layer.norm2(x)), h), cache["cross_k"],
                      cache["cross_v"], src_mask)
        x = x + cross.out(merge_heads(out))
        x = x + layer.ff(layer.norm3(x))
    return model.generator(model.decoder.norm(x)[:, -1])


@torch.no_grad()
def _greedy(model, batch: Batch, gen: Optional[torch.Generator], early_eos: bool):
    steps = batch.tgt_seq.shape[1]
    memory, _ = model.encode(batch, deterministic=True, gen=gen)
    b, dev = memory.shape[0], memory.device
    src_mask = batch.src_seq == PAD
    cfg = model.cfg
    shape = (b, cfg.num_heads, steps, cfg.hidden_size // cfg.num_heads)
    caches = []
    for layer in model.decoder.layers:
        kv = layer.cross_attn.project_kv(memory)
        caches.append({"k": torch.zeros(shape, device=dev), "v": torch.zeros(shape, device=dev),
                       "cross_k": kv["k"], "cross_v": kv["v"]})
    prev_pad = torch.zeros((b, steps), dtype=torch.bool, device=dev)  # BOS is not pad
    tok = torch.full((b, 1), BOS, dtype=torch.long, device=dev)
    toks = torch.full((b, steps), PAD, dtype=torch.long, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for i in range(steps):
        nxt = torch.argmax(_decode_step(model, tok, i, caches, src_mask, prev_pad), dim=-1)
        toks[:, i] = nxt
        if i + 1 < steps:  # pad-ness of the token that will sit at input position i+1
            prev_pad[:, i + 1] = nxt == PAD
        tok = nxt[:, None]
        if early_eos:
            done |= nxt == EOS
            if bool(done.all()):
                break
    return toks


def greedy_decode(model, batch: Batch, gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """→ (B, T-1) generated token ids (BOS excluded), T from the batch.
    ``batch`` holds tensors on the model's device; ``gen`` feeds the sampled
    graph under ``eval_graph="sample"``."""
    return _greedy(model, batch, gen, early_eos=False)


def greedy_decode_early_eos(model, batch: Batch,
                            gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """:func:`greedy_decode` that exits once every row has emitted EOS."""
    return _greedy(model, batch, gen, early_eos=True)


def decode_fn(model) -> Callable:
    """The decoder ``cfg.decode_early_eos`` selects."""
    return greedy_decode_early_eos if model.cfg.decode_early_eos else greedy_decode
