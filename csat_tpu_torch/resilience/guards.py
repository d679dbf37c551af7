"""The in-step non-finite guard.

Counterpart of the JAX package's ``resilience/guards.py:guarded_apply``: the
optimizer update runs only when the loss and the global gradient norm are
finite, so one NaN/Inf step leaves parameters and moments untouched and the
consecutive-bad counter rises.  JAX decides on the device under
``lax.cond``; here the verdict is read on the host, one sync per step.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["global_norm", "guarded_apply"]


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``sqrt(Σ g²)`` over every gradient tensor (optax ``global_norm``)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))


def guarded_apply(optimizer, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                  opt_state, total_loss: torch.Tensor, bad_steps: int
                  ) -> Tuple[bool, torch.Tensor, int]:
    """Apply ``optimizer`` in place only when ``total_loss`` and the grad
    norm are finite.  Returns ``(ok, grad_norm, bad_steps)``, the counter
    reset on a good step."""
    gnorm = global_norm(grads)
    ok = bool(torch.isfinite(total_loss) & torch.isfinite(gnorm))
    if ok:
        optimizer.update(params, grads, opt_state)
    return ok, gnorm, 0 if ok else bad_steps + 1
