"""Token-level match accuracy.

Capability parity with the reference's ``valid_metrices/acc_metric.py``
(``MatchAccMetric``): fraction of non-PAD target tokens whose prediction
matches, accumulated across batches. The reference masks predictions at PAD
positions and then counts ``(y_pred == y) − #PAD`` over ``#non-PAD`` —
algebraically the same as counting matches at non-PAD positions, which is
what this does directly. Cross-replica reduction (the reference's ignite
``@sync_all_reduce``) is a ``jax.lax.psum`` in the caller's jitted eval
step or a host-side sum over per-shard counts, as used here.

The port's own copy of the JAX package's ``metrics/acc.py`` (host-only code, no JAX
in it); ``tests/test_torch_metrics.py`` holds the two together.
"""

from __future__ import annotations

import numpy as np

from csat_tpu_torch.utils import PAD

__all__ = ["MatchAccMetric", "match_accuracy"]


def match_accuracy(y_pred: np.ndarray, y: np.ndarray, pad: int = PAD) -> tuple:
    """Returns (matched, total) over non-PAD target positions."""
    mask = y != pad
    matched = int(np.sum((y_pred == y) & mask))
    return matched, int(np.sum(mask))


class MatchAccMetric:
    """Accumulating metric with the reference's reset/update/compute API."""

    def __init__(self, pad: int = PAD):
        self.pad = pad
        self.reset()

    def reset(self) -> None:
        self._match_token = 0
        self._total_token = 0

    def update(self, y_pred: np.ndarray, y: np.ndarray) -> None:
        m, t = match_accuracy(np.asarray(y_pred), np.asarray(y), self.pad)
        self._match_token += m
        self._total_token += t

    def compute(self) -> float:
        if self._total_token == 0:
            raise ValueError("MatchAccMetric needs at least one example")
        return self._match_token / self._total_token
