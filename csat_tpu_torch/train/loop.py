"""The train step.

Counterpart of the JAX package's ``train/loop.py:make_train_step``
(``:107-205``): one step is the teacher-forced forward in training mode,
``nll + sw · sparsity`` (times an optional ``loss_scale``), the backward —
through the hand-written kernels on the card — the non-finite guard and the
AdamW update.  The trainer around it (epochs, bucketed programs,
checkpoints, rollback, eval decode and BLEU) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from csat_tpu_torch.configs import Config
from csat_tpu_torch.data.dataset import Batch
from csat_tpu_torch.resilience.guards import global_norm, guarded_apply
from csat_tpu_torch.train.loss import label_smoothing_loss
from csat_tpu_torch.train.optimizer import AdamW
from csat_tpu_torch.train.state import TrainState

__all__ = ["make_train_step"]


def make_train_step(model: torch.nn.Module, optimizer: AdamW, cfg: Config
                    ) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, batch, bad_steps=0, loss_scale=1.0) → (state,
    metrics)``.  ``batch`` holds tensors on the model's device
    (``data.dataset.batch_to_device``).  The state's parameters and moments
    are updated in place; after the call every parameter's ``.grad`` holds
    this step's gradient.  ``metrics``: ``loss`` (the NLL), ``sparsity``,
    ``total``, and with ``cfg.nonfinite_guard`` (the default) ``grad_norm``,
    ``nonfinite`` and ``bad_steps`` — a non-finite loss or grad-norm skips
    the update."""

    def train_step(state: TrainState, batch: Batch, bad_steps: int = 0,
                   loss_scale: float = 1.0):
        for p in state.params.values():
            p.grad = None
        log_probs, sparsity = model(batch, deterministic=False, gen=state.generator)
        nll = label_smoothing_loss(log_probs, batch.target, cfg.smoothing)
        total = (nll + cfg.sw * sparsity) * loss_scale
        total.backward()
        grads = {k: p.grad for k, p in state.params.items()}
        metrics = {"loss": nll.detach(), "sparsity": sparsity.detach(), "total": total.detach()}
        if cfg.nonfinite_guard:
            ok, gnorm, bad = guarded_apply(optimizer, state.params, grads, state.opt_state,
                                           total.detach(), bad_steps)
            metrics.update(grad_norm=gnorm, nonfinite=not ok, bad_steps=bad)
        else:
            optimizer.update(state.params, grads, state.opt_state)
            metrics.update(grad_norm=global_norm(grads))
        state.step += 1
        return state, metrics

    return train_step
