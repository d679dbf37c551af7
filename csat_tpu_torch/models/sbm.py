"""SBM encoder: stochastic-block-model attention, expected-graph evaluation.

Counterpart of the JAX package's ``models/sbm.py:69-375`` (the reference's
``sbm_model.py``/``sbm_attn.py``).  Serving runs deterministically, so the
graph is the Bernoulli mean ``clip(Q̂ S K̂ᵀ, floor, .99)``
(``eval_graph="expected"``, the ``sbm_expected`` mod) and attention dropout
is off.  The sampled graphs (hash-stream or shared noise) belong to the
training slice and raise here.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from csat_tpu_torch.configs import Config
from csat_tpu_torch.models.components import LN_EPS, merge_heads, split_heads
from csat_tpu_torch.ops.flex_core import flex_attention
from csat_tpu_torch.ops.mods import sbm_expected_mod


class ClusterProj(nn.Module):
    """3-layer MLP applied to Q and K head vectors."""

    def __init__(self, head_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(head_dim, head_dim)
        self.fc2 = nn.Linear(head_dim, head_dim)
        self.fc3 = nn.Linear(head_dim, head_dim)

    def forward(self, x):
        return self.fc3(F.relu(self.fc2(F.relu(self.fc1(x)))))


class SBMAttention(nn.Module):
    """Cluster memberships → expected adjacency weight → blocked attention.
    Returns ``(out, per-head sparsity)``."""

    def __init__(self, num_heads: int, head_dim: int, num_clusters: int,
                 floor: float, eval_graph: str):
        super().__init__()
        if eval_graph != "expected":
            raise NotImplementedError(
                "the port serves eval_graph='expected'; sampled SBM graphs "
                "(sbm_sampled/sbm_graph mods) are queued for the training slice "
                "in ROADMAP.md")
        self.num_heads, self.head_dim, self.kk = num_heads, head_dim, num_clusters
        self.floor = floor
        self.clusters = nn.Parameter(torch.empty(num_heads * num_clusters, head_dim))
        self.proj = ClusterProj(head_dim)

    def forward(self, q, k, v, key_pad):
        b, h, n, dh = q.shape
        c = self.clusters.reshape(h, self.kk, dh)
        dist = torch.einsum("hkd,hjd->hkj", c, c)
        s_aff = torch.softmax(dist.reshape(h, self.kk * self.kk), dim=-1).reshape(h, self.kk, self.kk)
        q_hat = torch.sigmoid(torch.einsum("bhnd,hkd->bhnk", self.proj(q), c))
        k_hat = torch.sigmoid(torch.einsum("bhnd,hkd->bhnk", self.proj(k), c))
        spec, aux = sbm_expected_mod(q_hat, k_hat, s_aff, key_pad, self.floor)
        out, extras = flex_attention(q, k, v, spec, aux)
        return out, torch.sum(extras["graph_sum"], dim=0) / (b * n * n)


class SBMBlock(nn.Module):
    """Pre-norm block: SBM attention + GELU MLP, each with a residual."""

    def __init__(self, cfg: Config, layer_idx: int):
        super().__init__()
        d = cfg.sbm_enc_dim
        self.num_heads = cfg.num_heads
        self.attn_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.wq, self.wk, self.wv, self.wo = (nn.Linear(d, d) for _ in range(4))
        self.attn = SBMAttention(cfg.num_heads, cfg.head_dim, cfg.clusters[layer_idx],
                                 cfg.sbm_floor, cfg.eval_graph)
        self.ff_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.fc1 = nn.Linear(d, d)
        self.fc2 = nn.Linear(d, d)

    def forward(self, x, key_pad):
        h = self.attn_norm(x)
        q, k, v = (split_heads(w(h), self.num_heads).contiguous()
                   for w in (self.wq, self.wk, self.wv))
        out, sparsity = self.attn(q, k, v, key_pad)
        x = x + self.wo(merge_heads(out))
        x = x + self.fc2(F.gelu(self.fc1(self.ff_norm(x)), approximate="none"))
        return x, sparsity


class SBMEncoder(nn.Module):
    """``concat([src_emb, pe_expand(pe)])`` → SBM blocks → LayerNorm →
    zero padded positions AFTER the norm (reference quirk) → ``out``."""

    def __init__(self, cfg: Config):
        super().__init__()
        if cfg.full_att:
            raise NotImplementedError(
                "full-attention encoders (full_att=True) are queued in ROADMAP.md")
        self.pe_expand = nn.Linear(cfg.pegen_dim, cfg.pe_dim)
        self.blocks = nn.ModuleList(SBMBlock(cfg, i) for i in range(cfg.sbm_layers))
        self.norm = nn.LayerNorm(cfg.sbm_enc_dim, eps=LN_EPS)
        self.out = nn.Linear(cfg.sbm_enc_dim, cfg.hidden_size)

    def forward(self, src_emb, src_pe, key_pad):
        x = torch.cat([src_emb, self.pe_expand(src_pe)], dim=-1)
        sparsities = []
        for block in self.blocks:
            x, sparsity = block(x, key_pad)
            sparsities.append(sparsity)
        x = self.norm(x) * (1.0 - key_pad.to(x.dtype))[:, :, None]
        return self.out(x), sparsities
