"""Resilience: the in-step non-finite guard, rollback snapshots and bounded
retry (the JAX package's ``resilience/guards.py`` and ``retry.py``)."""

from csat_tpu_torch.resilience.guards import (
    TrainingDivergedError, global_norm, guarded_apply, host_snapshot, restore_snapshot)
from csat_tpu_torch.resilience.retry import retry

__all__ = ["TrainingDivergedError", "global_norm", "guarded_apply", "host_snapshot",
           "restore_snapshot", "retry"]
