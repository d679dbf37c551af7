"""Seeded initialization, the JAX package's distributions in PyTorch.

Dense kernels, embeddings (the triplet table too) and the CSE relative
tables are xavier-uniform, biases and LayerNorm shifts zero, LayerNorm
scales one, the SBM ``clusters`` orthogonal and the tree-PE decays ``p``
uniform in [0.7, 0.999) — as the flax modules initialize them.  All draws
come from one CPU ``torch.Generator`` walked over ``named_parameters()`` in
registration order (which a variant's modules only extend: the pegen
models' order and weights are what they were), built before the model moves
to its device and copied there, so a seed gives the same weights on the CPU
and on the card (the bits differ from flax's: ``jax.random`` is not
reproduced; converted flax params are the way to share weights).

``init_scheme="reference"`` then redraws what :func:`apply_reference_init`
names, the twin of the JAX package's ``models/init.py``: the reference's
torch packaging realises two families differently from flax's per-module
xavier — ``nn.MultiheadAttention`` packs the decoder's q/k/v into one
``(3d, d)`` matrix, so their xavier bound is ``√(6 / (d_in + 3·d_out))``,
and ``nn.Linear`` biases start ``U(±1/√fan_in)`` (attention biases stay
zero).  JAX draws each redrawn leaf from ``fold_in(key(seed),
crc32(path))``, which torch cannot reproduce; the port draws it from a
``torch.Generator`` seeded from ``seed`` and the same crc32 of the leaf's
flax path (``convert.flax_path``), so the set of leaves redrawn, their
bounds and the determinism in the seed are the same, the bits are not.
"""

from __future__ import annotations

import math
import zlib

import torch
from torch import nn

__all__ = ["init_params", "apply_reference_init", "reference_bound"]

# decoder attention modules whose q/k/v kernels torch draws with the packed
# (3d, d) fan; their biases (and the output projection's) stay zero
_ATTN = ("self_attn", "cross_attn")
_PACKED = ("q", "k", "v")


def _xavier(shape, g: torch.Generator) -> torch.Tensor:
    fan_out, fan_in = shape[0], shape[1]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-bound, bound, generator=g)


def _orthogonal(shape, g: torch.Generator) -> torch.Tensor:
    rows, cols = shape
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=g)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q if rows >= cols else q.T


@torch.no_grad()
def init_params(model: nn.Module, seed: int, scheme: str = "flax") -> None:
    """Fill every parameter of ``model`` from ``seed``, in place, under
    ``scheme`` (``"flax"`` or ``"reference"``, ``cfg.init_scheme``)."""
    g = torch.Generator().manual_seed(int(seed))
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
        if isinstance(owner, nn.LayerNorm):
            val = torch.ones(p.shape) if leaf == "weight" else torch.zeros(p.shape)
        elif leaf == "bias":
            val = torch.zeros(p.shape)
        elif leaf == "clusters":
            val = _orthogonal(tuple(p.shape), g)
        elif leaf == "p":  # TreePositionalEncodings' decays
            val = torch.empty(p.shape).uniform_(0.7, 0.999, generator=g)
        else:  # Linear weights, embedding tables, L_q / T_q
            val = _xavier(tuple(p.shape), g)
        p.copy_(val.to(p.device))
    if scheme == "reference":
        apply_reference_init(model, seed)


def reference_bound(model: nn.Module, name: str):
    """The half-width of the uniform the reference scheme redraws parameter
    ``name`` from, or None where it keeps the flax draw: a Linear bias
    outside the decoder's attention, ``1/√fan_in``; a decoder q/k/v weight
    ``(d_out, d_in)``, the packed ``√(6 / (d_in + 3·d_out))``."""
    owner_name, _, leaf = name.rpartition(".")
    owner = model.get_submodule(owner_name)
    if not isinstance(owner, nn.Linear):
        return None
    parts = owner_name.split(".")
    in_attn = any(a in parts for a in _ATTN)
    if leaf == "bias":
        return None if in_attn else 1.0 / math.sqrt(owner.in_features)
    if in_attn and parts[-1] in _PACKED:
        return math.sqrt(6.0 / (owner.in_features + 3 * owner.out_features))
    return None


@torch.no_grad()
def apply_reference_init(model: nn.Module, seed: int) -> None:
    """Redraw, in place, every parameter :func:`reference_bound` names,
    uniform in ``±bound``, each from its own generator seeded by the crc32
    of its flax path continued over ``seed``'s digits (32 bits: the CPU
    generator reads no more); every other parameter is kept."""
    from csat_tpu_torch.convert import flax_path

    for name, p in model.named_parameters():
        bound = reference_bound(model, name)
        if bound is None:
            continue
        crc = zlib.crc32(flax_path(name).encode())
        g = torch.Generator().manual_seed(zlib.crc32(str(int(seed)).encode(), crc))
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g).to(p.device))
