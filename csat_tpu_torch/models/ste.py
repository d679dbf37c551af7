"""Straight-through Bernoulli graph sampler.

Counterpart of the JAX package's ``models/ste.py`` (the reference's
``STE.py``): the forward samples ``A = 1{noise < clamp(expA, floor, .99)}``,
the backward is the straight-through estimator gated by the sample,
``hardtanh(A · g)``.  The uniform noise enters as an argument; the shared
noise mode draws it from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from csat_tpu_torch.models.components import uniform

__all__ = ["sample_graph", "bernoulli_noise"]


def bernoulli_noise(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """Uniform(0, 1) f32 noise on ``gen``'s device for :func:`sample_graph`
    (``gen`` a ``torch.Generator`` or a pipeline stage's ``KeyedStream``)."""
    return uniform(gen, shape, gen.device)


class _SampleGraph(torch.autograd.Function):
    @staticmethod
    def forward(ctx, exp_a, noise, floor):
        a = (noise < torch.clamp(exp_a, floor, 0.99)).to(exp_a.dtype)
        ctx.save_for_backward(a)
        return a

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        return torch.clamp(a * g, -1.0, 1.0), None, None


def sample_graph(exp_a: torch.Tensor, noise: torch.Tensor, floor: float = 0.01) -> torch.Tensor:
    """0/1 graph ``1{noise < clamp(exp_a, floor, .99)}`` with the STE
    gradient ``clamp(A · g, -1, 1)`` into ``exp_a``."""
    return _SampleGraph.apply(exp_a, noise, float(floor))
