"""Greedy decoding for evaluation.

Counterpart of the JAX package's ``train/decode.py`` (the reference's
``GreedyGenerator``): encode once, then emit ``T - 1`` tokens by argmax from
BOS, with no early stop (truncation at ``</s>`` happens in the metric
transform).  ``T - 1`` is the width of ``batch.tgt_seq``, so length-bucketed
batches decode at their bucket's capacity.

* :func:`greedy_decode` keeps a rectangular per-layer KV cache
  ``(B, H, T - 1, dh)`` in the model's compute dtype and the cross-attention
  K/V projected once from the memory, and attends over them in f32, as the
  decoder's attention island does; ``prev_pad`` reproduces the reference's
  ``make_std_mask(ys, 0)``: a *generated* PAD token is masked out of later
  self attention.
* :func:`greedy_decode_early_eos` (``cfg.decode_early_eos``) runs the same
  steps and stops once every row has emitted ``</s>``; positions after the
  exit stay PAD, and each row's prefix up to its first EOS is identical.

JAX runs this decode as plain XLA code outside any Pallas kernel, so it is
plain PyTorch here (the paged-decode kernel belongs to the serving engine).
Under a ``model`` axis every member decodes the same rows in lockstep, each
with its heads' caches; the row-parallel sums give every member the same
log-probabilities, so the same tokens.
The encoder under it runs the flex-attention kernels on the card: the CSE
forward and, per ``cfg.eval_graph``, the expected- or sampled-graph SBM
forward.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from csat_tpu_torch.data.dataset import Batch
from csat_tpu_torch.models.components import attention
from csat_tpu_torch.utils import BOS, EOS, PAD

__all__ = ["greedy_decode", "greedy_decode_early_eos", "decode_fn"]


def _decode_step(model, tok, i: int, caches, src_mask, prev_pad):
    """One lockstep decoder step at position ``i`` over the rectangular
    cache (the JAX ``CSATrans.decode_step`` with a scalar position).
    Returns log-probs (B, V); writes this step's self K/V, in the model's
    compute dtype, into ``caches``."""
    steps = prev_pad.shape[1]
    pos = torch.full((tok.shape[0],), i, dtype=torch.long, device=tok.device)
    x = model.tgt_embedding(tok, pos=pos)
    future = torch.arange(steps, device=tok.device)[None, :] > i
    self_mask = (prev_pad | future)[:, None, None, :]
    cross_mask = src_mask[:, None, None, :]
    for layer, cache in zip(model.decoder.layers, caches):
        attn = layer.self_attn
        normed = layer.normed(1, x)
        cache["k"][:, :, i] = attn.project(attn.k, normed)[:, :, 0]
        cache["v"][:, :, i] = attn.project(attn.v, normed)[:, :, 0]
        out = attention(attn.project(attn.q, normed), cache["k"], cache["v"], self_mask)
        x = x + attn.merge_out(out)
        cross = layer.cross_attn
        out = attention(cross.project(cross.q, layer.normed(2, x)), cache["cross_k"],
                        cache["cross_v"], cross_mask)
        x = x + cross.merge_out(out)
        x = x + layer.ff(layer.normed(3, x))
    return model.generator(model.decoder.final_norm(x)[:, -1])


@torch.no_grad()
def _greedy(model, batch: Batch, gen: Optional[torch.Generator], early_eos: bool, shard=None):
    steps = batch.tgt_seq.shape[1]
    memory, _ = model.encode(batch, deterministic=True, gen=gen, shard=shard)
    b, dev = memory.shape[0], memory.device
    src_mask = batch.src_seq == PAD
    cfg = model.cfg
    # this process's heads (all of them but under a model axis)
    heads = model.decoder.layers[0].self_attn.local_heads
    shape = (b, heads, steps, cfg.hidden_size // cfg.num_heads)
    caches = []
    for layer in model.decoder.layers:
        kv = layer.cross_attn.project_kv(memory)
        caches.append({"k": torch.zeros(shape, dtype=model.dtype, device=dev),
                       "v": torch.zeros(shape, dtype=model.dtype, device=dev),
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


def greedy_decode(model, batch: Batch, gen: Optional[torch.Generator] = None,
                  shard=None) -> torch.Tensor:
    """→ (B, T-1) generated token ids (BOS excluded), T from the batch.
    ``batch`` holds tensors on the model's device; ``gen`` feeds the sampled
    graph under ``eval_graph="sample"``.  ``shard`` (a
    :class:`~csat_tpu_torch.parallel.mesh.DataShard`) runs the encoder along
    its ``seq`` or ``pipe`` axis; every process of the axis decodes the whole
    batch from the gathered memory, to the same tokens."""
    return _greedy(model, batch, gen, early_eos=False, shard=shard)


def greedy_decode_early_eos(model, batch: Batch, gen: Optional[torch.Generator] = None,
                            shard=None) -> torch.Tensor:
    """:func:`greedy_decode` that exits once every row has emitted EOS."""
    return _greedy(model, batch, gen, early_eos=True, shard=shard)


def decode_fn(model) -> Callable:
    """The decoder ``cfg.decode_early_eos`` selects."""
    return greedy_decode_early_eos if model.cfg.decode_early_eos else greedy_decode
