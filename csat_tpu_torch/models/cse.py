"""CSE — Code Structure Embedder: disentangled relative-position attention.

Counterpart of the JAX package's ``models/cse.py:42-171`` (the reference's
``csa_trans.py:180-236`` and ``disentangled_attn.py``).  The attention core is
the ``cse`` mod through :func:`~csat_tpu_torch.ops.flex_core.flex_attention`:
the CUDA kernel on the card, the plain path on the CPU.  The L and T distance
planes fan out to ``H/2`` pseudo-heads each inside the mod.  The attention
carries no attention dropout (as in JAX); the residual branches and the FFN
drop at ``cfg.dropout`` in training mode.  In bf16 (``dtype``) the
projections, LayerNorms and residual stream run in bf16, the relative tables
are stacked in bf16, and q/k/v and the projected tables go to f32 before the
kernel; its output is cast back before ``wo`` (the JAX module's casts).
Under ``cfg.remat`` each layer is recomputed in the backward
(:func:`~csat_tpu_torch.models.components.remat`), its dropout redrawn from
the generator's state at the forward.  Under a ``seq`` or ``pipe`` axis
every process runs the CSE on whole rows (the kernel's q rows are all N):
the SBM stack takes its own node rows after it, as JAX runs the CSE's
kernel on gathered operands on every ``seq`` device.  Under a ``model`` axis
(``tp``) each member runs its own heads: ``wq``/``wk``/``wv`` column- and
``wo`` row-parallel, the replicated ``l_q``/``l_k``/``t_q``/``t_k`` (no
``PARAM_RULES`` entry) projected whole and cut to this member's heads, and
the kernel launched once per plane its heads lie in (with ``H`` 8 and a
``model`` axis of 2, 4 or 8, one), on that plane's slice of ``rel`` /
``mask``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from csat_tpu_torch.configs import Config
from csat_tpu_torch.models.components import (
    LN_EPS, FeedForward, col_dense, dense, dropout, head_range, layer_norm, merge_heads, remat,
    row_dense)
from csat_tpu_torch.ops.flex_core import flex_attention
from csat_tpu_torch.ops.mods import cse_mod
from csat_tpu_torch.parallel.collectives import copy_to_model


class DisentangledAttn(nn.Module):
    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        d, h = cfg.pegen_dim, cfg.num_heads
        self.cfg = cfg
        self.dtype = dtype
        self.dk = d // h
        self.half = h // 2  # L-heads then T-heads
        self.wq, self.wk, self.wv, self.wo = (nn.Linear(d, d) for _ in range(4))
        self.l_q, self.l_k, self.t_q, self.t_k = (
            nn.Linear(d, self.dk * self.half) for _ in range(4))
        self.tp = None  # the model line: this member's heads

    def _heads(self, layer: nn.Linear, table: torch.Tensor) -> torch.Tensor:
        """A (R, d) table through ``layer`` → (half, R, dk)."""
        t = dense(layer, table, self.dtype)
        return t.reshape(t.shape[0], self.half, self.dk).transpose(0, 1)

    def forward(self, x, rel_tables, rel, mask):
        """``x`` (B, N, d); ``rel_tables`` (2, R, d) stacked L_q/T_q; ``rel``
        (B, 2, N, N) int32 offset distances; ``mask`` (B, 2, N, N) bool."""
        b, n, _ = x.shape
        tp = self.tp
        h0, h = head_range(tp, self.cfg.num_heads)
        x = copy_to_model(x, tp)
        q, k, v = (col_dense(w, x, self.dtype, tp).reshape(b, n, h, self.dk).transpose(1, 2)
                   .to(torch.float32).contiguous() for w in (self.wq, self.wk, self.wv))
        l_table, t_table = rel_tables[0], rel_tables[1]
        rel_q = torch.cat([self._heads(self.l_q, l_table),
                           self._heads(self.t_q, t_table)]).to(torch.float32)
        rel_k = torch.cat([self._heads(self.l_k, l_table),
                           self._heads(self.t_k, t_table)]).to(torch.float32)
        if tp is None:
            spec, aux = cse_mod(rel_q, rel_k, rel, mask)
            out, _ = flex_attention(q, k, v, spec, aux)
        else:
            outs = []
            for a, e in self._plane_runs(h0, h):
                plane = (h0 + a) // self.half
                spec, aux = cse_mod(rel_q[h0 + a:h0 + e], rel_k[h0 + a:h0 + e],
                                    rel[:, plane:plane + 1], mask[:, plane:plane + 1])
                outs.append(flex_attention(*(t[:, a:e].contiguous() for t in (q, k, v)), spec,
                                           aux)[0])
            out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
        if self.cfg.cse_empty_rows == "zero":
            # rows with no related pair take nothing from attention
            planes = (h0 + torch.arange(h, device=mask.device)) // self.half
            empty = mask.all(dim=-1)[:, planes]  # (B, H, N)
            out = torch.where(empty[..., None], torch.zeros_like(out), out)
        return row_dense(self.wo, merge_heads(out).to(self.dtype), self.dtype, tp)

    def _plane_runs(self, h0: int, h: int):
        """The runs ``[a, e)`` of this member's ``h`` heads from ``h0`` that
        lie in one plane each (local indices)."""
        runs, a = [], 0
        while a < h:
            e = min(h, (h0 + a) // self.half * self.half + self.half - h0)
            runs.append((a, e))
            a = e
        return runs


class CSELayer(nn.Module):
    """Pre-norm disentangled attention + FFN."""

    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attn_norm = nn.LayerNorm(cfg.pegen_dim, eps=LN_EPS)
        self.attn = DisentangledAttn(cfg, dtype)
        self.ff_norm = nn.LayerNorm(cfg.pegen_dim, eps=LN_EPS)
        self.ff = FeedForward(cfg.pegen_dim, cfg.pegen_dim, cfg.dropout, dtype)
        self.dropout = cfg.dropout
        self.dtype = dtype

    def forward(self, x, rel_tables, rel, mask, deterministic: bool = True,
                gen: Optional[torch.Generator] = None, shard=None):
        h = self.attn(layer_norm(self.attn_norm, x, self.dtype), rel_tables, rel, mask)
        x = x + dropout(h, self.dropout, deterministic, gen, shard)
        h = self.ff(layer_norm(self.ff_norm, x, self.dtype), deterministic, gen, shard)
        return x + dropout(h, self.dropout, deterministic, gen, shard)


class CSE(nn.Module):
    """Stack of CSE layers producing the per-node positional encoding."""

    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.L_q = nn.Parameter(torch.empty(cfg.max_src_len, cfg.pegen_dim))
        self.T_q = nn.Parameter(torch.empty(cfg.max_src_len, cfg.pegen_dim))
        self.layers = nn.ModuleList(CSELayer(cfg, dtype) for _ in range(cfg.num_layers))
        self.norm = nn.LayerNorm(cfg.pegen_dim, eps=LN_EPS)
        self.dtype = dtype
        self.remat = cfg.remat

    def forward(self, src_pe_emb, L, T, L_mask, T_mask, deterministic: bool = True,
                gen: Optional[torch.Generator] = None, shard=None):
        rel = torch.stack([L, T], dim=1).to(torch.int32)
        mask = torch.stack([L_mask, T_mask], dim=1)
        rel_tables = torch.stack([self.L_q, self.T_q]).to(self.dtype)
        x = src_pe_emb
        for layer in self.layers:
            if self.remat:  # recomputed in the backward (JAX cse.py:165)
                x = remat(layer, (gen,), x, rel_tables, rel, mask, deterministic, gen, shard)
            else:
                x = layer(x, rel_tables, rel, mask, deterministic, gen, shard)
        return layer_norm(self.norm, x, self.dtype)
