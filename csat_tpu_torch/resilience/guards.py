"""The in-step non-finite guard and the rollback snapshots.

Counterpart of the JAX package's ``resilience/guards.py``.
:func:`guarded_apply`: the optimizer update runs only when the loss and the
global gradient norm are finite, so one NaN/Inf step leaves parameters and
moments untouched and the consecutive-bad counter rises.  As JAX decides on
the device under ``lax.cond``, the verdict here stays on the device: ``ok``
is a 0-d bool tensor the optimizer selects with, the counter a 0-d int32
tensor, and the guard reads nothing on the host — the trainer reads the
counter every ``guard_check_every`` steps.  :func:`host_snapshot` /
:func:`restore_snapshot`: a host copy of the whole train state (parameters,
AdamW moments, step, the noise generator's state) that the trainer rolls
back to after consecutive guarded steps; a run whose rollbacks are
exhausted raises :class:`TrainingDivergedError`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

__all__ = ["TrainingDivergedError", "global_norm", "guarded_apply", "HostSnapshot",
           "host_snapshot", "restore_snapshot"]


class TrainingDivergedError(RuntimeError):
    """Raised when rollback retries are exhausted: the run cannot make
    progress and continuing would only burn accelerator time."""


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``sqrt(Σ g²)`` over every gradient tensor (optax ``global_norm``)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))


def guarded_apply(optimizer, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                  opt_state, total_loss: torch.Tensor, bad_steps: Union[int, torch.Tensor],
                  gnorm: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Apply ``optimizer`` in place only where ``total_loss`` and the grad
    norm are finite, without a host read.  Returns ``(ok, grad_norm,
    bad_steps)``: ``ok`` a 0-d bool tensor, ``bad_steps`` (an int or the
    previous step's tensor on input) a 0-d int32 tensor, ``where(ok, 0,
    bad_steps + 1)``.  ``gnorm`` is the grad norm when the caller has it
    (a tensor-parallel step's, over the whole parameters); default
    :func:`global_norm` of ``grads``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    ok = torch.isfinite(total_loss) & torch.isfinite(gnorm)
    optimizer.update(params, grads, opt_state, ok=ok)
    return ok, gnorm, torch.where(ok, 0, bad_steps + 1).to(torch.int32)


class HostSnapshot(NamedTuple):
    """Host copy of a train state; the step's in-place updates cannot reach it."""

    step: int
    params: Dict[str, torch.Tensor]
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    gen_state: torch.Tensor


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: t.detach().to("cpu", copy=True) for k, t in tensors.items()}


def host_snapshot(state) -> HostSnapshot:
    """Detach ``state`` (a ``train.state.TrainState``) to CPU copies."""
    opt = state.opt_state
    return HostSnapshot(step=int(state.step), params=_to_host(state.params), count=int(opt.count),
                        mu=_to_host(opt.mu), nu=_to_host(opt.nu),
                        gen_state=state.generator.get_state().clone())


@torch.no_grad()
def restore_snapshot(snap: HostSnapshot, state, resplit: int = 0):
    """Write ``snap`` back into ``state`` in place (the parameters are the
    model's own tensors) and return it.  ``resplit > 0`` reseeds the noise
    generator from its seed and the rollback ordinal, so a retry after a
    rollback draws a different Bernoulli graph / dropout path: replaying the
    trajectory that just diverged would diverge again at the same step."""
    for k, p in state.params.items():
        p.copy_(snap.params[k])
    for k in state.opt_state.mu:
        state.opt_state.mu[k].copy_(snap.mu[k])
        state.opt_state.nu[k].copy_(snap.nu[k])
    state.opt_state.count = snap.count
    state.step = snap.step
    state.generator.set_state(snap.gen_state)
    if resplit:
        seed = (state.generator.initial_seed() + (0x5E511 + resplit) * 0x9E3779B97F4A7C15)
        state.generator.manual_seed(seed % (1 << 63))
    return state
