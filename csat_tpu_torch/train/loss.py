"""Label-smoothing KL-divergence loss.

Counterpart of the JAX package's ``train/loss.py`` (the reference's
``utils/label_smooth.py:15-40``): smoothed one-hot target distribution
(mass ``smoothing / (V - 2)`` off-target), PAD column zeroed, PAD target rows
zeroed, KL divergence with *sum* reduction, normalised by the count of
non-PAD target tokens.  At ``smoothing=0`` (the configs' default) it is the
mean NLL of the non-PAD tokens.
"""

from __future__ import annotations

from typing import Optional

import torch

from csat_tpu_torch.utils import PAD

__all__ = ["label_smoothing_loss"]


def label_smoothing_loss(log_probs: torch.Tensor, target: torch.Tensor,
                         smoothing: float = 0.0,
                         ntokens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``log_probs`` (..., V) log-probabilities, ``target`` (...) token ids
    → scalar loss.  ``ntokens`` replaces the normaliser, the count of
    ``target``'s non-PAD tokens: a data-parallel process passes the global
    batch's count, so its loss is its term of the global batch's mean and
    the processes' terms (and gradients) sum to it."""
    v = log_probs.shape[-1]
    x = log_probs.reshape(-1, v).to(torch.float32)
    t = target.reshape(-1).long()
    true_dist = torch.full_like(x, smoothing / (v - 2))
    true_dist.scatter_(1, t[:, None], 1.0 - smoothing)
    true_dist[:, PAD] = 0.0
    true_dist = torch.where((t == PAD)[:, None], torch.zeros_like(true_dist), true_dist)
    # KL(sum): Σ p·(log p − x), with 0·log 0 := 0
    log_td = torch.where(true_dist > 0, torch.log(torch.clamp(true_dist, min=1e-30)),
                         torch.zeros_like(true_dist))
    loss = torch.sum(true_dist * (log_td - x))
    if ntokens is None:
        ntokens = torch.sum(t != PAD)
    return loss / torch.clamp(ntokens, min=1).to(torch.float32)
