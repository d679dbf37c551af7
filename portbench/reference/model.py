"""CSA-Trans in plain PyTorch: the yardstick that decides ``correct``.

A frozen, self-contained copy of the port's plain path (its models' module
code as the CPU runs it), written over a flat ``{name: tensor}`` parameter
dict whose names are the port's ``named_parameters()``.  It imports nothing
of the port: the sizes come from the configuration file, the weights and
inputs from the benchmark.

What it computes (arXiv 2404.05767; the reference repository's
``csa_trans.py``, ``sbm_model.py``):

* source embeddings (``sbm_enc_dim - pe_dim`` wide) and a second token
  embedding fed to the CSE: ``num_layers`` pre-norm layers of disentangled
  relative attention, the L (ancestor) and T (sibling) distance planes each
  read by half of the heads, scores ``(q·k + q·lk[rel] + k·lq[rel]ᵀ) /
  √(3·dk)`` filled with -1e9 where the raw distance is 0;
* the PE expanded to ``pe_dim`` and concatenated; ``sbm_layers`` pre-norm
  SBM blocks: cluster memberships ``Q̂ = σ(MLP(q)·C)``, ``K̂`` alike,
  affinity ``S = softmax(C Cᵀ)``, the graph either sampled (training,
  ``noise_mode="shared"``: ``1{u < clip(Q̂ S K̂ᵀ, floor, .99)}`` with the
  straight-through gradient, ``Q̂ S K̂ᵀ`` taken in float64 and rounded once) or its expectation (serving,
  ``eval_graph="expected"``), attention ``w·e^{s} / Σ w·e^{s}`` over the
  unpadded keys, attention dropout from the counter hash;
* a pre-norm decoder (self, cross, FFN), the output head ``log(max(softmax,
  1e-30))`` after dropout, the NLL plus ``sw`` times the mean graph density.

The random draws of a training step (dropout masks, the graph noise, the
hash seeds) come from a ``torch.Generator`` the caller seeds, in the order
the port draws them, so a step from the same seed samples the same graph.
``precision="tf32"`` rounds every matrix product's operands to TF32 (10
mantissa bits, accumulation in f32): the control that a correct comparison
must reject.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

PAD, UNK, BOS, EOS = 0, 1, 2, 3  # the reference vocabulary's special ids
LN_EPS = 1e-5
NEG = -1e9
_TILE = 128  # the hash stream's row stride is N rounded up to this


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to the nearest TF32 value (ties to even), as a
    tensor core reads an f32 operand in TF32 mode."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


class _TF32Operand(torch.autograd.Function):
    """An operand read in TF32; its gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _TF32Cotangent(torch.autograd.Function):
    """The identity whose backward reads the incoming gradient in TF32, as
    the backward's products read it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


class Ops:
    """The matrix products of one reference run, in f32 or — forward and
    backward — with TF32 operands and f32 accumulation."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.tf32 = precision == "tf32"

    def _product(self, fn, *ops):
        if not self.tf32:
            return fn(*ops)
        return _TF32Cotangent.apply(fn(*(_TF32Operand.apply(o) for o in ops)))

    def lin(self, x, w, b=None):
        out = self._product(F.linear, x, w)
        return out if b is None else out + b

    def ein(self, eq, *ops):
        return self._product(lambda *o: torch.einsum(eq, *o), *ops)

    def ein_rounded(self, eq, *ops):
        """``ein`` with the product taken in float64 and rounded to f32 once."""
        return self._product(lambda *o: torch.einsum(eq, *(t.double() for t in o)).float(), *ops)


# ---------------------------------------------------------------- randomness

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def hash_uniform(seed: torch.Tensor, b: int, h: int, n: int) -> torch.Tensor:
    """The (B, H, N, N) uniform field of the counter hash under ``seed``:
    murmur3's finalizer over (seed, batch·head, row, col), row stride N
    rounded up to 128, the top 24 bits scaled to [0, 1)."""
    dev = seed.device
    stride = (n + _TILE - 1) // _TILE * _TILE
    bh = (torch.arange(b, device=dev)[:, None] * h + torch.arange(h, device=dev)[None, :])
    bh = bh[:, :, None, None].to(torch.int64)
    rows = torch.arange(n, device=dev)[None, None, :, None]
    cols = torch.arange(n, device=dev)[None, None, None, :]
    x = (_mul32(rows.to(torch.int64), stride) + cols) & 0xFFFFFFFF
    x = x ^ _mul32(seed.to(torch.int64) & 0xFFFFFFFF, 0x9E3779B9)
    x = x ^ _mul32(bh, 0x85EBCA6B)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.int32).to(torch.float32) * (1.0 / (1 << 24))


def dropout(x, rate: float, gen: Optional[torch.Generator]):
    if gen is None or rate == 0.0:
        return x
    u = torch.rand(tuple(x.shape), generator=gen, device=x.device)
    keep_prob = float(torch.tensor(1.0 - rate, dtype=x.dtype))
    return torch.where(u >= rate, x / keep_prob, torch.zeros_like(x))


def draw_seed(gen: torch.Generator) -> torch.Tensor:
    return torch.randint(0, 2**31 - 1, (1,), generator=gen, device=gen.device,
                         dtype=torch.int32)


class _STE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, exp_a, noise, floor):
        a = (noise < torch.clamp(exp_a, floor, 0.99)).to(exp_a.dtype)
        ctx.save_for_backward(a)
        return a

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        return torch.clamp(a * g, -1.0, 1.0), None, None


# ---------------------------------------------------------------- the model

class Reference:
    """The model over ``params`` for configuration ``cfg`` (the dict of the
    configuration file).  ``gen`` None runs it deterministically (serving's
    expected graph, no dropout)."""

    def __init__(self, cfg: Dict, params: Dict[str, torch.Tensor], precision: str = "f32"):
        self.c = cfg
        self.p = params
        self.o = Ops(precision)

    def _lin(self, name, x):
        return self.o.lin(x, self.p[f"{name}.weight"], self.p[f"{name}.bias"])

    def _ln(self, name, x):
        return F.layer_norm(x, (x.shape[-1],), self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                            LN_EPS)

    def _embed(self, name, ids, gen, with_pos=False):
        emb = self.p[f"{name}.weight"][ids]
        emb = torch.where((ids == PAD)[..., None], torch.zeros_like(emb), emb)
        if with_pos:
            emb = emb + sinusoid(ids.shape[-1], emb.shape[-1], ids.device)[None]
        return dropout(self._ln(f"{name}.norm", emb), self.c["dropout"], gen)

    # ------------------------------------------------------------ CSE
    def _cse(self, x, L, T, L_mask, T_mask, gen):
        c = self.c
        h, d = c["num_heads"], c["pegen_dim"]
        dk, half = d // h, h // 2
        rel = torch.stack([L, T], dim=1).long()              # (B, 2, N, N)
        mask = torch.stack([L_mask, T_mask], dim=1)          # (B, 2, N, N)
        tables = (self.p["pegen.L_q"], self.p["pegen.T_q"])
        b, n, _ = x.shape
        mask_h = mask.repeat_interleave(half, dim=1)          # (B, H, N, N)
        rel_h = rel.repeat_interleave(half, dim=1)
        inv = 1.0 / math.sqrt(dk * 3)
        for i in range(c["num_layers"]):
            pre = f"pegen.layers.{i}"
            y = self._ln(f"{pre}.attn_norm", x)
            q, k, v = (self._lin(f"{pre}.attn.{w}", y).reshape(b, n, h, dk).transpose(1, 2)
                       for w in ("wq", "wk", "wv"))

            def heads(name, table):
                t = self._lin(f"{pre}.attn.{name}", table)
                return t.reshape(t.shape[0], half, dk).transpose(0, 1)

            lq = torch.cat([heads("l_q", tables[0]), heads("t_q", tables[1])])  # (H, R, dk)
            lk = torch.cat([heads("l_k", tables[0]), heads("t_k", tables[1])])
            s = self.o.ein("bhnd,bhmd->bhnm", q, k) * inv
            c2p = torch.gather(self.o.ein("bhnd,hrd->bhnr", q, lk), -1, rel_h)
            p2c = torch.gather(self.o.ein("bhmd,hrd->bhmr", k, lq), -1, rel_h)
            s = s + c2p * inv + p2c.transpose(-1, -2) * inv
            s = torch.where(mask_h, torch.full_like(s, NEG), s)
            attn = torch.softmax(s, dim=-1)
            out = self.o.ein("bhnm,bhmd->bhnd", attn, v).transpose(1, 2).reshape(b, n, d)
            x = x + dropout(self._lin(f"{pre}.attn.wo", out), c["dropout"], gen)
            y = F.gelu(self._lin(f"{pre}.ff.fc1", self._ln(f"{pre}.ff_norm", x)))
            y = self._lin(f"{pre}.ff.fc2", dropout(y, c["dropout"], gen))
            x = x + dropout(y, c["dropout"], gen)
        return self._ln("pegen.norm", x)

    # ------------------------------------------------------------ SBM
    def _proj(self, pre, x, gen):
        y = F.relu(dropout(self._lin(f"{pre}.fc1", x), 0.2, gen))
        y = F.relu(dropout(self._lin(f"{pre}.fc2", y), 0.2, gen))
        return self._lin(f"{pre}.fc3", y)

    def _sbm_attention(self, i, q, k, v, key_pad, gen):
        c = self.c
        b, h, n, dh = q.shape
        kk = c["clusters"][i]
        pre = f"encoder.blocks.{i}.attn"
        cl = self.p[f"{pre}.clusters"].reshape(h, kk, dh)
        dist = self.o.ein("hkd,hjd->hkj", cl, cl)
        s_aff = torch.softmax(dist.reshape(h, kk * kk), dim=-1).reshape(h, kk, kk)
        q_hat = torch.sigmoid(self.o.ein("bhnd,hkd->bhnk", self._proj(f"{pre}.proj", q, gen), cl))
        k_hat = torch.sigmoid(self.o.ein("bhnd,hkd->bhnk", self._proj(f"{pre}.proj", k, gen), cl))
        padf = key_pad.to(torch.float32)[:, None, None, :]
        if gen is None:  # the expected graph, summed one cluster at a time
            r = self.o.ein("bhnk,hkj->bhnj", q_hat, s_aff)
            acc = r[..., :, None, 0] * k_hat[..., None, :, 0]
            for j in range(1, kk):
                acc = acc + r[..., :, None, j] * k_hat[..., None, :, j]
            w_raw = torch.clamp(acc, c["sbm_floor"], 0.99)
        else:
            # the edge probabilities correctly rounded: an edge whose draw
            # sits within an f32 product's rounding of its probability would
            # otherwise flip with this product's own summation order
            exp_a = self.o.ein_rounded("bhnk,hkj,bhmj->bhnm", q_hat, s_aff, k_hat)
            noise = torch.rand((b, h, n, n), generator=gen, device=q.device)
            w_raw = _STE.apply(exp_a, noise, float(c["sbm_floor"]))
        w = w_raw * (1.0 - padf)
        s = self.o.ein("bhnd,bhmd->bhnm", q, k) * (1.0 / math.sqrt(dh))
        live = w > 0
        m = torch.amax(torch.where(live, s, torch.full_like(s, -1e30)), dim=-1, keepdim=True)
        e = torch.exp(torch.where(live, s, m) - m) * w
        l = torch.sum(e, dim=-1, keepdim=True)
        attn = e / torch.where(l > 0, l, torch.ones_like(l))
        if gen is not None and c["attention_dropout"] > 0.0:
            rate = c["attention_dropout"]
            u = hash_uniform(draw_seed(gen), b, h, n)
            attn = attn * ((u >= rate).to(torch.float32) * (1.0 / (1.0 - rate)))
        out = self.o.ein("bhnm,bhmd->bhnd", attn, v)
        sparsity = torch.sum(torch.sum(w_raw, dim=(2, 3)), dim=0) / (b * n * n)
        return out, sparsity

    def encode(self, src_seq, L, T, L_mask, T_mask, gen=None):
        """→ ``(memory (B, N, hidden), sparsity scalar)``."""
        c = self.c
        src = self._embed("src_embedding", src_seq, gen)
        pe = self._cse(self._embed("src_pe_embedding", src_seq, gen), L, T, L_mask, T_mask, gen)
        x = torch.cat([src, self._lin("encoder.pe_expand", pe)], dim=-1)
        key_pad = src_seq == PAD
        b, n, d = x.shape
        h = c["num_heads"]
        dh = d // h
        sparsities = []
        for i in range(c["sbm_layers"]):
            pre = f"encoder.blocks.{i}"
            y = self._ln(f"{pre}.attn_norm", x)
            q, k, v = (self._lin(f"{pre}.{w}", y).reshape(b, n, h, dh).transpose(1, 2)
                       for w in ("wq", "wk", "wv"))
            out, sp = self._sbm_attention(i, q, k, v, key_pad, gen)
            sparsities.append(sp)
            out = out.transpose(1, 2).reshape(b, n, d)
            x = x + dropout(self._lin(f"{pre}.wo", out), c["dropout"], gen)
            y = F.gelu(self._lin(f"{pre}.fc1", self._ln(f"{pre}.ff_norm", x)))
            x = x + dropout(self._lin(f"{pre}.fc2", dropout(y, c["dropout"], gen)),
                            c["dropout"], gen)
        x = self._ln("encoder.norm", x) * (1.0 - key_pad.to(x.dtype))[:, :, None]
        sparsity = torch.mean(torch.stack([torch.mean(s) for s in sparsities]))
        return self._lin("encoder.out", x), sparsity

    # ------------------------------------------------------------ decoder
    def _attend(self, pre, x, kv, mask, gen):
        c = self.c
        h = c["num_heads"]
        b, t, d = x.shape
        split = lambda y: y.reshape(b, y.shape[1], h, d // h).transpose(1, 2)
        q = split(self._lin(f"{pre}.q", x))
        k, v = split(self._lin(f"{pre}.k", kv)), split(self._lin(f"{pre}.v", kv))
        s = self.o.ein("bhqd,bhkd->bhqk", q, k) / math.sqrt(d // h)
        s = torch.where(mask, torch.full_like(s, NEG), s)
        attn = dropout(torch.softmax(s, dim=-1), c["dropout"], gen)
        out = self.o.ein("bhqk,bhkd->bhqd", attn, v).transpose(1, 2).reshape(b, t, d)
        return self._lin(f"{pre}.out", out)

    def decode(self, tgt_seq, memory, src_pad, gen=None):
        """Teacher-forced decoder → logits (B, T, V) before the head's dropout."""
        c = self.c
        rate = c["dropout"]
        x = self._embed("tgt_embedding", tgt_seq, gen, with_pos=True)
        t = tgt_seq.shape[1]
        future = torch.triu(torch.ones((t, t), dtype=torch.bool, device=x.device), diagonal=1)
        self_mask = ((tgt_seq == PAD)[:, None, :] | future[None])[:, None]
        mem_mask = src_pad[:, None, None, :]
        for i in range(c["decoder_layers"]):
            pre = f"decoder.layers.{i}"
            y = self._ln(f"{pre}.norm1", x)
            x = x + dropout(self._attend(f"{pre}.self_attn", y, y, self_mask, gen), rate, gen)
            x = x + dropout(self._attend(f"{pre}.cross_attn", self._ln(f"{pre}.norm2", x),
                                         memory, mem_mask, gen), rate, gen)
            y = F.gelu(self._lin(f"{pre}.ff.fc1", self._ln(f"{pre}.norm3", x)))
            x = x + dropout(self._lin(f"{pre}.ff.fc2", dropout(y, rate, gen)), rate, gen)
        return self._lin("generator.fc1", self._ln("decoder.norm", x))

    def forward(self, batch, gen=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``batch``: the model's inputs on one device (``src_seq``,
        ``tgt_seq``, ``L``, ``T``, ``L_mask``, ``T_mask``) → ``(log_probs,
        sparsity)``."""
        memory, sparsity = self.encode(batch["src_seq"], batch["L"], batch["T"],
                                       batch["L_mask"], batch["T_mask"], gen)
        logits = self.decode(batch["tgt_seq"], memory, batch["src_seq"] == PAD, gen)
        logits = dropout(logits, self.c["dropout"], gen)
        return torch.log(torch.clamp(torch.softmax(logits, dim=-1), min=1e-30)), sparsity


def relation_planes(L_raw, T_raw, max_src_len: int) -> Dict[str, np.ndarray]:
    """The model's relation inputs from raw signed distances (NumPy, any
    leading shape): the masks from the raw planes (distance 0: unrelated),
    then the distances offset by ``max_src_len // 2`` and clipped to the
    table (the reference's mask-before-offset order)."""
    L_raw, T_raw = np.asarray(L_raw, np.int64), np.asarray(T_raw, np.int64)
    off, hi = max_src_len // 2, max_src_len - 1
    return {"L": np.clip(L_raw + off, 0, hi), "T": np.clip(T_raw + off, 0, hi),
            "L_mask": L_raw == 0, "T_mask": T_raw == 0}


def sinusoid(t: int, dim: int, device) -> torch.Tensor:
    position = torch.arange(t, device=device, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / dim))
    ang = position * div
    pe = torch.zeros((t, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang[:, : dim // 2])
    return pe


def loss(cfg: Dict, log_probs: torch.Tensor, target: torch.Tensor,
         sparsity: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(nll, total)``: the mean NLL of the non-PAD targets, plus ``sw`` ×
    sparsity."""
    lp = torch.gather(log_probs, -1, target.long()[..., None])[..., 0]
    real = target != PAD
    nll = -torch.sum(torch.where(real, lp, torch.zeros_like(lp))) / torch.clamp(
        torch.sum(real), min=1).to(torch.float32)
    return nll, nll + cfg["sw"] * sparsity


class AdamW:
    """The reference repository's AdamW (HuggingFace's, ``correct_bias=False``):
    ``m ← b1 m + (1−b1) g``, ``v ← b2 v + (1−b2) g²``, ``p ← p − lr · m / (√v
    + eps)``; no weight decay."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, b1=0.9, b2=0.999, eps=1e-6):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g * (1 - self.b1))
            self.v[k].mul_(self.b2).add_(g * g * (1 - self.b2))
            p.add_(self.m[k] / (torch.sqrt(self.v[k]) + self.eps) * -self.lr)
