"""SBM encoder: stochastic-block-model sparse attention.

Counterpart of the JAX package's ``models/sbm.py:69-375`` (the reference's
``sbm_model.py``/``sbm_attn.py``).  The attention graph is one of three mods
(``ops/mods.py``), chosen as the JAX ``SBMAttention`` chooses
(``sbm.py:143-188``):

* ``noise_mode="counter"`` — the Bernoulli graph is drawn inside the kernel
  from the counter hash under a per-layer sample seed (``sbm_sampled``);
* ``noise_mode="shared"`` — uniform noise from the generator is turned into
  a 0/1 graph through the STE outside the attention (``sbm_graph``);
* deterministic with ``eval_graph="expected"`` — the Bernoulli mean
  ``clip(Q̂ S K̂ᵀ, floor, .99)`` as a soft weight (``sbm_expected``, the
  serving graph).

Attention dropout (``attention_dropout``, training only) is the hash
keep-field under a per-layer dropout seed.  ``full_att`` configs replace the
SBM attention with :class:`FullAttention` (``sbm.py:214-240``), dense masked
softmax in plain PyTorch as JAX leaves it to XLA; the ``sequential`` PE
variant adds a sinusoidal table to the token embedding in place of the
projected PE (``sbm.py:315-320``).  Seeds and noise come from the
caller's explicit ``torch.Generator`` (:func:`draw_seed`, where JAX calls
``draw_counter_seed``).  Under data parallelism the caller also passes a
:class:`~csat_tpu_torch.parallel.mesh.DataShard`: the hash streams then run
at the rows' global batch·head index (``bh0 = row0 · H``), the shared noise
and the model-dropout masks are the rows' slices of draws at the global
batch's shape (so every process draws the same hash seeds), and the
sparsity is normalised by the global batch — what one process would compute
for these rows of the global batch.  Under ``cfg.remat`` each block is
recomputed in the backward with the generator set back to its state at the
forward, so the recompute samples the same graph and drops the same
units.

Under a ``seq`` axis (``shard.seq``) the block stack keeps this process's
N/P node rows: with ``seq_impl="ring"`` and counter noise the sampled
attention is the ring (``parallel/ring.py``, JAX ``sbm.py:158-176``; full
attention its dense ring), otherwise the attention gathers whole rows
(``all_gather_axis``), runs the kernels on them and keeps its rows; the
model-dropout masks are drawn at the whole node count and sliced; the
encoder output is gathered before the decoder.  A block is then not
recomputed as a whole (a recompute would repeat its collectives): the ring
recomputes its block scores instead.  Under a ``pipe`` axis
(``shard.pipe``, ``cfg.pipeline_stages`` > 1) the blocks run as the GPipe
wavefront (``parallel/pipeline.py``, JAX ``sbm.py:336-356``), each
(layer, microbatch) drawing from its own
:class:`~csat_tpu_torch.ops.hashrng.KeyedStream`.  ``ClusterProj`` drops
at 0.2 whatever ``cfg.dropout`` is, as the JAX module hard-codes it.

Under a ``model`` axis (``tp``, the line ``parallel.mesh.shard_model``
hands the modules) each member runs its own heads: ``wq``/``wk``/``wv`` and
the MLP's ``fc1`` column-, ``wo``, ``fc2`` and the encoder's ``out``
row-parallel; the replicated cluster centres cut to its heads (the JAX
ring's ``s_aff`` is sharded ``P(model, None, None)``); the hash streams at
the global index (``bh0 = row0 · H + h0``, head stride ``H``); the shared
mode's noise drawn at ``(rows, H, n, n)`` and sliced on rows and heads; the
cluster MLP's and the hidden units' dropout masks drawn at the whole head
count and width and sliced; the per-head sparsities gathered over the line.

The attention is an f32 island whatever the compute dtype (``sbm.py:17,
259-260`` of the JAX package): a block's LayerNorms, projections, MLP and
residual stream run in its ``dtype``, and q/k/v go to f32 before the cluster
memberships, the graph and the kernels; the sparsity term stays f32 and the
merged heads are cast back before ``wo``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from csat_tpu_torch.configs import Config
from csat_tpu_torch.models.components import (
    LN_EPS, col_dense, dense, dropout, gelu, head_range, layer_norm, merge_heads, remat,
    row_dense, sinusoidal_rows, split_heads)
from csat_tpu_torch.models.ste import bernoulli_noise, sample_graph
from csat_tpu_torch.ops.flex_core import flex_attention
from csat_tpu_torch.ops.hashrng import KeyedStream
from csat_tpu_torch.ops.mods import sbm_expected_mod, sbm_graph_mod, sbm_sampled_mod
from csat_tpu_torch.parallel.collectives import (
    all_gather_axis, copy_to_model, gather_features, scatter_features)
from csat_tpu_torch.parallel.mesh import DataShard
from csat_tpu_torch.parallel.pipeline import draw_streams, gpipe_blocks, pipeline_ready
from csat_tpu_torch.parallel.ring import (
    node_block, ring_active, ring_full_attention, ring_sbm_attention)


def draw_seed(gen: torch.Generator, name: str) -> torch.Tensor:
    """A (1,) int32 seed in [0, 2³¹ − 1) for the ``name`` ("sample" or
    "dropout") hash stream, drawn from ``gen`` on its own device — no host
    sync; the kernels read it there.  A pipeline stage's
    :class:`~csat_tpu_torch.ops.hashrng.KeyedStream` hands out its
    (layer, microbatch) seed of that name."""
    if isinstance(gen, KeyedStream):
        return gen.seed(name)
    # one generator serves both streams; the name documents the call
    return torch.randint(0, 2**31 - 1, (1,), generator=gen, device=gen.device,
                         dtype=torch.int32)


class ClusterProj(nn.Module):
    """3-layer MLP applied to Q and K head vectors, dropout after the first
    two layers."""

    dropout = 0.2  # fixed in the JAX module and the reference

    def __init__(self, head_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(head_dim, head_dim)
        self.fc2 = nn.Linear(head_dim, head_dim)
        self.fc3 = nn.Linear(head_dim, head_dim)

    def forward(self, x, deterministic: bool = True, gen: Optional[torch.Generator] = None,
                shard=None, heads=None):
        # x is (B, H, N, dh): the node axis is 2; ``heads`` (h0, total) places
        # a model member's heads among all of them
        part = None if heads is None else (1, heads[0], heads[1])
        h = F.relu(dropout(self.fc1(x), self.dropout, deterministic, gen, shard, 2, part))
        h = F.relu(dropout(self.fc2(h), self.dropout, deterministic, gen, shard, 2, part))
        return self.fc3(h)


class SBMAttention(nn.Module):
    """Cluster memberships → the layer's graph mod → blocked attention.
    Returns ``(out, per-head sparsity)``."""

    def __init__(self, num_heads: int, head_dim: int, num_clusters: int, floor: float,
                 noise_mode: str, eval_graph: str, attention_dropout: float,
                 seq_impl: str = "allgather"):
        super().__init__()
        self.num_heads, self.head_dim, self.kk = num_heads, head_dim, num_clusters
        self.floor = floor
        self.noise_mode, self.eval_graph = noise_mode, eval_graph
        self.seq_impl = seq_impl
        self.attention_dropout = attention_dropout
        self.clusters = nn.Parameter(torch.empty(num_heads * num_clusters, head_dim))
        self.proj = ClusterProj(head_dim)
        self.tp = None  # the model line: this member's heads

    def forward(self, q, k, v, key_pad, deterministic: bool = True,
                gen: Optional[torch.Generator] = None, shard=None):
        out, sparsity = self._attend(q, k, v, key_pad, deterministic, gen, shard)
        # every head's sparsity on every model member
        return out, gather_features(sparsity, self.tp, 0)

    def _attend(self, q, k, v, key_pad, deterministic, gen, shard):
        b, h, n, dh = q.shape
        # where the rows sit in the global batch (one process: row 0, b rows)
        # and the heads among all of them (one process: head 0, all h)
        row0, rows = (0, b) if shard is None else (shard.row0, shard.rows)
        h0 = head_range(self.tp, self.num_heads)[0]
        heads = None if self.tp is None else (h0, self.num_heads)
        bh0, h_total = row0 * self.num_heads + h0, self.num_heads
        c = self.clusters.reshape(self.num_heads, self.kk, dh)[h0:h0 + h]
        dist = torch.einsum("hkd,hjd->hkj", c, c)
        s_aff = torch.softmax(dist.reshape(h, self.kk * self.kk), dim=-1).reshape(h, self.kk, self.kk)
        q_hat = torch.sigmoid(torch.einsum("bhnd,hkd->bhnk", self.proj(q, deterministic, gen, shard,
                                                                        heads), c))
        k_hat = torch.sigmoid(torch.einsum("bhnd,hkd->bhnk", self.proj(k, deterministic, gen, shard,
                                                                        heads), c))

        rate = 0.0 if deterministic else self.attention_dropout
        expected = deterministic and self.eval_graph == "expected"
        if not expected and gen is None:
            raise ValueError("a sampled SBM graph needs an explicit torch.Generator")
        split = ring_active(shard)  # this process holds node rows of a seq axis
        if split and self.seq_impl == "ring" and self.noise_mode == "counter" and not expected:
            # the K/V/K̂ blocks rotate over the seq axis; the counter stream
            # samples the one-process graph (JAX sbm.py:158-176)
            sample_seed = draw_seed(gen, "sample")
            drop_seed = draw_seed(gen, "dropout") if rate > 0.0 else None
            out, graph_sums = ring_sbm_attention(
                q, k, v, q_hat, k_hat, s_aff, key_pad, sample_seed, shard.seq, rate, drop_seed,
                self.floor, bh0, h_total)
            return out, torch.sum(graph_sums, dim=0) / (rows * shard.nodes * shard.nodes)
        if split:  # whole rows on every process, this process's rows kept
            q, k, v, q_hat, k_hat = (all_gather_axis(t, shard.seq, 2)
                                     for t in (q, k, v, q_hat, k_hat))
            key_pad = all_gather_axis(key_pad.to(torch.float32), shard.seq, 1) > 0.5
            nl, n = n, shard.nodes
        if expected:
            spec, aux = sbm_expected_mod(q_hat, k_hat, s_aff, key_pad, self.floor, bh0, h_total)
        elif self.noise_mode == "counter":
            spec, aux = sbm_sampled_mod(q_hat, k_hat, s_aff, key_pad,
                                        draw_seed(gen, "sample"), self.floor, bh0, h_total)
        else:
            exp_a = torch.einsum("bhnk,hkj,bhmj->bhnm", q_hat, s_aff, k_hat)
            # the global batch's noise, of which these rows and heads take
            # their slice
            noise = bernoulli_noise(gen, (rows, self.num_heads, n, n))[row0:row0 + b, h0:h0 + h]
            graph = sample_graph(exp_a, noise, self.floor)
            spec, aux = sbm_graph_mod(graph, key_pad, bh0, h_total)
        drop_seed = draw_seed(gen, "dropout") if rate > 0.0 else None
        out, extras = flex_attention(q, k, v, spec, aux, rate, drop_seed)
        if split:
            out = out[:, :, shard.node0:shard.node0 + nl]
        # per-head sparsity Σ graph / (b·n·n) over the padded node axis, b the
        # global batch's rows: the processes' terms sum to the global mean
        return out, torch.sum(extras["graph_sum"], dim=0) / (rows * n * n)


def l1_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Divide by ``max(‖x‖₁, eps)`` over the last axis (torch
    ``F.normalize(p=1)``, the JAX ``l1_normalize``)."""
    return x / torch.clamp(torch.sum(torch.abs(x), dim=-1, keepdim=True), min=eps)


class FullAttention(nn.Module):
    """Dense masked softmax attention, in JAX's order: scores over √dh,
    ``-inf`` on padded keys, softmax, ``l1_normalize``, dropout (keep mask
    from the caller's generator), then the product with V.  No parameters;
    no sparsity."""

    def __init__(self, head_dim: int, attention_dropout: float, seq_impl: str = "allgather",
                 num_heads: int = 8):
        super().__init__()
        self.head_dim = head_dim
        self.attention_dropout = attention_dropout
        self.seq_impl = seq_impl
        self.num_heads = num_heads
        self.tp = None  # the model line: this member's heads

    def forward(self, q, k, v, key_pad, deterministic: bool = True,
                gen: Optional[torch.Generator] = None, shard=None):
        split = ring_active(shard)
        h0 = head_range(self.tp, self.num_heads)[0]
        if split and self.seq_impl == "ring":
            # the dense ring: dropout from the counter keep-field (JAX
            # sbm.py:222-233), the distribution of the generator's mask
            rate = 0.0 if deterministic else self.attention_dropout
            drop_seed = draw_seed(gen, "dropout") if rate > 0.0 else None
            return ring_full_attention(q, k, v, key_pad, shard.seq, rate, drop_seed,
                                       shard.row0 * self.num_heads + h0, self.num_heads), None
        if split:  # whole rows on every process, this process's rows kept
            nl = q.shape[2]
            q, k, v = (all_gather_axis(t, shard.seq, 2) for t in (q, k, v))
            key_pad = all_gather_axis(key_pad.to(torch.float32), shard.seq, 1) > 0.5
        dot = torch.einsum("bhnd,bhmd->bhnm", q, k) / math.sqrt(self.head_dim)
        dot = dot.masked_fill(key_pad[:, None, None, :], float("-inf"))
        attn = l1_normalize(torch.softmax(dot, dim=-1))
        attn = dropout(attn, self.attention_dropout, deterministic, gen,
                       dataclasses.replace(shard, nodes=None) if split else shard,
                       part=None if self.tp is None else (1, h0, self.num_heads))
        out = torch.einsum("bhnm,bhmd->bhnd", attn, v)
        if split:
            out = out[:, :, shard.node0:shard.node0 + nl]
        return out, None


class SBMBlock(nn.Module):
    """Pre-norm block: SBM (or, under ``full_att``, dense) attention + GELU
    MLP, each with dropout before its residual."""

    def __init__(self, cfg: Config, layer_idx: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = cfg.sbm_enc_dim
        self.num_heads = cfg.num_heads
        self.dropout = cfg.dropout
        self.dtype = dtype
        self.attn_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.wq, self.wk, self.wv, self.wo = (nn.Linear(d, d) for _ in range(4))
        if cfg.full_att:
            self.attn = FullAttention(cfg.head_dim, cfg.attention_dropout, cfg.seq_impl,
                                      cfg.num_heads)
        else:
            self.attn = SBMAttention(cfg.num_heads, cfg.head_dim, cfg.clusters[layer_idx],
                                     cfg.sbm_floor, cfg.noise_mode, cfg.eval_graph,
                                     cfg.attention_dropout, cfg.seq_impl)
        self.ff_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.fc1 = nn.Linear(d, d)
        self.fc2 = nn.Linear(d, d)
        self.tp = None  # the model line: q/k/v and fc1 column-, wo and fc2 row-parallel

    def forward(self, x, key_pad, deterministic: bool = True,
                gen: Optional[torch.Generator] = None, shard=None):
        tp = self.tp
        drop = lambda t, part=None: dropout(t, self.dropout, deterministic, gen, shard, 1, part)
        col = lambda layer, t: col_dense(layer, t, self.dtype, tp)
        row = lambda layer, t: row_dense(layer, t, self.dtype, tp)
        h = copy_to_model(layer_norm(self.attn_norm, x, self.dtype), tp)
        heads = head_range(tp, self.num_heads)[1]
        # the f32 island
        q, k, v = (split_heads(col(w, h), heads).to(torch.float32).contiguous()
                   for w in (self.wq, self.wk, self.wv))
        out, sparsity = self.attn(q, k, v, key_pad, deterministic, gen, shard)
        x = x + drop(row(self.wo, merge_heads(out).to(self.dtype)))
        h = gelu(col(self.fc1, copy_to_model(layer_norm(self.ff_norm, x, self.dtype), tp)))
        part = None if tp is None else (2, tp.index * h.shape[2], h.shape[2] * tp.size)
        return x + drop(row(self.fc2, drop(h, part))), sparsity


class SBMEncoder(nn.Module):
    """``concat([src_emb, pe_expand(pe)])`` (or, for ``sequential``,
    ``src_emb`` plus the sinusoidal table's first N rows) → blocks →
    LayerNorm → zero padded positions AFTER the norm (reference quirk) →
    ``out``.  Returns ``(x, per-layer sparsities, pe)``: a sparsity is None
    under ``full_att``, and ``pe`` is the post-expansion PE the probe reads
    (None for ``sequential``)."""

    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sequential = cfg.use_pegen == "sequential"
        if not self.sequential:
            self.pe_expand = nn.Linear(cfg.pegen_dim, cfg.pe_dim)
        self.blocks = nn.ModuleList(SBMBlock(cfg, i, dtype) for i in range(cfg.sbm_layers))
        self.norm = nn.LayerNorm(cfg.sbm_enc_dim, eps=LN_EPS)
        self.out = nn.Linear(cfg.sbm_enc_dim, cfg.hidden_size)
        self.tp = None  # the model line: out row-parallel on the replicated input
        self.dtype = dtype
        self.remat = cfg.remat
        self.stages = cfg.pipeline_stages
        self.n_micro = cfg.pipeline_microbatches or cfg.pipeline_stages
        self.num_heads = cfg.num_heads

    def forward(self, src_emb, src_pe, key_pad, deterministic: bool = True,
                gen: Optional[torch.Generator] = None, shard=None):
        if self.sequential:
            # the leading rows of the max_src_len table: a bucketed batch
            # (N < max_src_len) adds the same rows as a full-width one
            pe = None
            n = src_emb.shape[1]
            x = src_emb + sinusoidal_rows(torch.arange(n, device=src_emb.device),
                                          src_emb.shape[-1])[None].to(self.dtype)
        else:
            pe = dense(self.pe_expand, src_pe, self.dtype)
            x = torch.cat([src_emb, pe], dim=-1)
        if pipeline_ready(self.stages, shard):
            x, sparsities = self._wavefront(x, key_pad, deterministic, gen, shard)
        else:
            x, sparsities, key_pad = self._blocks(x, key_pad, deterministic, gen, shard)
        x = layer_norm(self.norm, x, self.dtype) * (1.0 - key_pad.to(self.dtype))[:, :, None]
        if self.tp is not None:
            x = scatter_features(x, self.tp, 2)
        x = row_dense(self.out, x, self.dtype, self.tp)
        if ring_active(shard):  # every process's node rows, for the decoder
            x = all_gather_axis(x, shard.seq, 1)
        return x, sparsities, pe

    def _blocks(self, x, key_pad, deterministic, gen, shard):
        """The sequential loop.  Under a ``seq`` axis the stack keeps this
        process's node rows (the ring rotates the K/V blocks, or a non-ring
        attention gathers whole rows); each block is then not recomputed as a
        whole, since a recompute would repeat its collectives — the ring
        recomputes its block scores instead.  → ``(x, sparsities, the
        rows' key_pad)``."""
        remat_blocks = self.remat
        if ring_active(shard):
            n = x.shape[1]
            n0, nl = node_block(n, shard.seq)
            x, key_pad = x[:, n0:n0 + nl], key_pad[:, n0:n0 + nl]
            shard = dataclasses.replace(shard, node0=n0, nodes=n)
            remat_blocks = False
        sparsities = []
        for block in self.blocks:
            if remat_blocks:  # recomputed in the backward (JAX sbm.py:357-361)
                x, sparsity = remat(block, (gen,), x, key_pad, deterministic, gen, shard)
            else:
                x, sparsity = block(x, key_pad, deterministic, gen, shard)
            sparsities.append(sparsity)
        return x, sparsities, key_pad

    def _wavefront(self, x, key_pad, deterministic, gen, shard):
        """The blocks as a GPipe wavefront over ``shard.pipe``
        (``parallel/pipeline.py``; JAX ``sbm.py:336-356, 377-421``): each
        (layer, microbatch) with its own stream, each microbatch hashed from
        batch row 0.  → ``(x, per-layer sparsities)``."""
        layers = len(self.blocks)
        streams = draw_streams(gen, layers, self.n_micro, not deterministic)
        full_att = isinstance(self.blocks[0].attn, FullAttention)

        def block_apply(l, xm, padm, stream):
            stream.set_state(0)
            mshard = DataShard(row0=0, rows=xm.shape[0])
            if self.remat:
                y, sp = remat(self.blocks[l], (stream,), xm, padm, deterministic, stream, mshard)
            else:
                y, sp = self.blocks[l](xm, padm, deterministic, stream, mshard)
            if sp is None:  # full attention reports no sparsity
                sp = torch.zeros((self.num_heads,), dtype=torch.float32, device=xm.device)
            return y, sp

        pipe = shard.pipe
        mine = range(pipe.index * layers // pipe.size, (pipe.index + 1) * layers // pipe.size)
        params = [p for l in mine for p in self.blocks[l].parameters()]
        x, sparsity = gpipe_blocks(block_apply, params, x, key_pad, streams, self.n_micro, pipe,
                                   layers, shard.pipe_data_groups, shard.rows // x.shape[0])
        return x, [None] * layers if full_att else list(sparsity)
