"""Train state: the parameters, the optimizer moments, the step and the noise.

Counterpart of the JAX package's ``train/state.py``.  The parameters are the
model's own ``named_parameters()`` (updated in place by the step); the
randomness of training — dropout masks, sampled-graph seeds, shared graph
noise — comes from one explicit ``torch.Generator`` on the model's device,
where JAX threads a PRNG key.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from csat_tpu_torch.configs import Config
from csat_tpu_torch.train.optimizer import AdamW, AdamWState

__all__ = ["TrainState", "create_train_state", "default_optimizer"]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.nn.Parameter]
    opt_state: AdamWState
    generator: torch.Generator


def default_optimizer(cfg: Config) -> AdamW:
    """The reference's optimizer: AdamW at ``cfg.learning_rate``, eps 1e-6,
    no weight decay, no bias correction."""
    return AdamW(cfg.learning_rate, eps=1e-6, weight_decay=0.0)


def create_train_state(model: torch.nn.Module, optimizer: AdamW, seed: int) -> TrainState:
    """A fresh state over ``model``'s parameters, its noise generator seeded
    with ``seed`` on the model's device."""
    params = dict(model.named_parameters())
    gen = torch.Generator(device=next(iter(params.values())).device).manual_seed(int(seed))
    return TrainState(step=0, params=params, opt_state=optimizer.init(params), generator=gen)
