"""Bounded retry/backoff and the data-pipeline error budget (the JAX
package's ``resilience/retry.py``).

Two distinct policies:

* :func:`retry` — for *transient* infrastructure faults (a checkpoint save
  hitting a flaky filesystem): bounded attempts with exponential backoff,
  then fail loud.
* :class:`ErrorBudget` — for *data* faults (a malformed sample breaking
  collate): retrying cannot fix bad bytes, so the policy is
  quarantine-and-skip with a budget.  Every skip is logged with the sample
  indices (the quarantine list); exhausting the budget raises
  :class:`DataErrorBudgetExceeded`, because a pipeline skipping large
  fractions of its corpus is a corruption event, not noise.
"""

from __future__ import annotations

import time
from typing import Callable, List, Sequence, Tuple, Type

import numpy as np

__all__ = ["DataErrorBudgetExceeded", "ErrorBudget", "retry"]


def retry(fn: Callable, *args, attempts: int = 3, backoff_s: float = 0.5,
          retry_on: Tuple[Type[BaseException], ...] = (Exception,),
          desc: str = "operation", log: Callable[[str], None] = print,
          sleep: Callable[[float], None] = time.sleep, **kwargs):
    """Call ``fn(*args, **kwargs)`` with up to ``attempts`` tries.  Backoff
    doubles per failure starting at ``backoff_s``; the final failure
    re-raises the original exception."""
    assert attempts >= 1, attempts
    for attempt in range(1, attempts + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if attempt == attempts:
                raise
            delay = backoff_s * (2 ** (attempt - 1))
            log(f"# retry: {desc} failed (attempt {attempt}/{attempts}: "
                f"{type(e).__name__}: {e}); retrying in {delay:.2f}s")
            sleep(delay)


class DataErrorBudgetExceeded(RuntimeError):
    """The data pipeline produced more malformed batches than the
    configured budget tolerates — the corpus (or its readers) are broken
    and training on the remainder would be silently biased."""


class ErrorBudget:
    """Quarantine-and-skip policy for the batch iterators' ``on_batch_error``
    hook.

    Returns True (skip and continue) while under budget, recording the
    quarantined sample indices; raises when the budget is exhausted.
    ``budget=0`` tolerates nothing — the first malformed batch fails loud,
    which is the default training posture."""

    def __init__(self, budget: int, log: Callable[[str], None] = print) -> None:
        assert budget >= 0, budget
        self.budget = int(budget)
        self.log = log
        self.quarantined: List[Sequence[int]] = []

    @property
    def count(self) -> int:
        return len(self.quarantined)

    def __call__(self, chunk_indices, exc: BaseException) -> bool:
        idx = np.asarray(chunk_indices).tolist()
        if self.count >= self.budget:
            raise DataErrorBudgetExceeded(
                f"data error budget ({self.budget}) exhausted: "
                f"{self.count} batch(es) already quarantined "
                f"{self.quarantined}, next failure on samples {idx}: "
                f"{type(exc).__name__}: {exc}") from exc
        self.quarantined.append(idx)
        self.log(f"# data: quarantined malformed batch (samples {idx}; "
                 f"{type(exc).__name__}: {exc}) — "
                 f"{self.budget - self.count} budget remaining")
        return True
