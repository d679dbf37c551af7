"""AdamW as the reference runs it: no bias correction, eps 1e-6, decoupled decay.

Counterpart of the JAX package's ``train/optimizer.py`` at
``correct_bias=False``, the only setting the reference runs (it vendors
HuggingFace's AdamW, ``script/optimizer.py:49-106``):

    m ← b1·m + (1 − b1)·g,   v ← b2·v + (1 − b2)·g²
    p ← p − lr·(m / (√v + eps) + wd·p)

with ``m``, ``v`` the uncorrected moments.  ``torch.optim.AdamW`` always
bias-corrects, so the update is written here.
Parameters and moments are updated in place (no second copy of either), with
``torch._foreach_*`` so one step is a few launches over all tensors rather
than several per tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

__all__ = ["AdamW", "AdamWState"]


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class AdamW:
    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-6, weight_decay: float = 0.0):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        return AdamWState(count=0,
                          mu={k: torch.zeros_like(p) for k, p in params.items()},
                          nu={k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: AdamWState) -> None:
        """One step on ``params`` and ``state``, in place."""
        keys = list(params)
        p: List[torch.Tensor] = [params[k] for k in keys]
        g = [grads[k] for k in keys]
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2))
        state.count += 1
        step = torch._foreach_div(mu, torch._foreach_add(torch._foreach_sqrt(nu), self.eps))
        if self.weight_decay > 0:
            step = torch._foreach_add(step, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_add_(p, torch._foreach_mul(step, -self.lr))
