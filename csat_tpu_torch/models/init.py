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
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["init_params"]


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
def init_params(model: nn.Module, seed: int) -> None:
    """Fill every parameter of ``model`` from ``seed``, in place."""
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
