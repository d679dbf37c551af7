"""The weights of a run, made on the device from the seed.

:func:`param_table` lists CSA-Trans's parameters (the ``pegen`` model with
SBM attention) by the port's ``named_parameters()`` names, in its
registration order, from the configuration file alone.  :func:`make_weights`
draws them on the device with one ``torch.Generator``: one uniform draw
covers every matrix, embedding table and cluster table, each scaled to its
xavier bound ``√(6 / (fan_in + fan_out))``; LayerNorm scales are one, biases
and LayerNorm shifts zero — the distributions the port's own initialiser
uses, so the numbers stay in the ranges a trained-from-scratch model starts
in.  Both sides of a run get copies of the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

__all__ = ["param_table", "make_weights", "weight_seed"]

# what a leaf is drawn as
MATRIX, BIAS, LN_W, LN_B = "matrix", "bias", "ln_w", "ln_b"


def param_table(c: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """``[(name, shape, kind)]`` of configuration ``c``'s parameters."""
    out: List[Tuple[str, Tuple[int, ...], str]] = []

    def lin(name, d_in, d_out):
        out.append((f"{name}.weight", (d_out, d_in), MATRIX))
        out.append((f"{name}.bias", (d_out,), BIAS))

    def ln(name, d):
        out.append((f"{name}.weight", (d,), LN_W))
        out.append((f"{name}.bias", (d,), LN_B))

    def emb(name, vocab, d):
        out.append((f"{name}.weight", (vocab, d), MATRIX))
        ln(f"{name}.norm", d)

    h, pg, sd, hid = c["num_heads"], c["pegen_dim"], c["sbm_enc_dim"], c["hidden_size"]
    emb("src_embedding", c["src_vocab_size"], sd - c["pe_dim"])
    emb("tgt_embedding", c["tgt_vocab_size"], hid)
    emb("src_pe_embedding", c["src_vocab_size"], pg)
    out.append(("pegen.L_q", (c["max_src_len"], pg), MATRIX))
    out.append(("pegen.T_q", (c["max_src_len"], pg), MATRIX))
    for i in range(c["num_layers"]):
        pre = f"pegen.layers.{i}"
        ln(f"{pre}.attn_norm", pg)
        for w in ("wq", "wk", "wv", "wo"):
            lin(f"{pre}.attn.{w}", pg, pg)
        for w in ("l_q", "l_k", "t_q", "t_k"):
            lin(f"{pre}.attn.{w}", pg, (pg // h) * (h // 2))
        ln(f"{pre}.ff_norm", pg)
        lin(f"{pre}.ff.fc1", pg, pg)
        lin(f"{pre}.ff.fc2", pg, pg)
    out.append(("pegen.norm.weight", (pg,), LN_W))
    out.append(("pegen.norm.bias", (pg,), LN_B))
    lin("encoder.pe_expand", pg, c["pe_dim"])
    dh = sd // h
    for i in range(c["sbm_layers"]):
        pre = f"encoder.blocks.{i}"
        ln(f"{pre}.attn_norm", sd)
        for w in ("wq", "wk", "wv", "wo"):
            lin(f"{pre}.{w}", sd, sd)
        out.append((f"{pre}.attn.clusters", (h * c["clusters"][i], dh), MATRIX))
        for w in ("fc1", "fc2", "fc3"):
            lin(f"{pre}.attn.proj.{w}", dh, dh)
        ln(f"{pre}.ff_norm", sd)
        lin(f"{pre}.fc1", sd, sd)
        lin(f"{pre}.fc2", sd, sd)
    ln("encoder.norm", sd)
    lin("encoder.out", sd, hid)
    for i in range(c["decoder_layers"]):
        pre = f"decoder.layers.{i}"
        for att in ("self_attn", "cross_attn"):
            for w in ("q", "k", "v", "out"):
                lin(f"{pre}.{att}.{w}", hid, hid)
        lin(f"{pre}.ff.fc1", hid, c["dim_feed_forward"])
        lin(f"{pre}.ff.fc2", c["dim_feed_forward"], hid)
        for j in (1, 2, 3):
            ln(f"{pre}.norm{j}", hid)
    ln("decoder.norm", hid)
    lin("generator.fc1", hid, c["tgt_vocab_size"])
    return out


def weight_seed(seed: int) -> int:
    """The weights' generator seed: apart from the step's own stream, which
    the train state seeds with ``seed`` itself."""
    return (int(seed) * 0x9E3779B1 + 0x5EED) % (2**63)


@torch.no_grad()
def make_weights(c: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{name: f32 tensor on device}`` for configuration ``c``, from ``seed``."""
    table = param_table(c)
    gen = torch.Generator(device=device).manual_seed(weight_seed(seed))
    mats = [(name, shape) for name, shape, kind in table if kind == MATRIX]
    total = sum(math.prod(s) for _, s in mats)
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for name, shape in mats:
        n = math.prod(shape)
        bound = math.sqrt(6.0 / (shape[0] + shape[1]))
        out[name] = flat[offset:offset + n].view(shape).mul_(bound)
        offset += n
    for name, shape, kind in table:
        if kind == LN_W:
            out[name] = torch.ones(shape, device=device)
        elif kind in (BIAS, LN_B):
            out[name] = torch.zeros(shape, device=device)
    return {name: out[name] for name, _, _ in table}
