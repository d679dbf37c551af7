"""Fault tolerance for long training runs (the JAX package's
``resilience/``, its train side):

* :mod:`~csat_tpu_torch.resilience.guards` — the in-step non-finite guard,
  decided on the device, and host-side rollback to the last good snapshot
  after K consecutive bad steps;
* :mod:`~csat_tpu_torch.resilience.preemption` — SIGTERM/SIGINT-driven
  final synchronous checkpoint + resume marker, so ``fit(resume=True)``
  loses at most the in-flight step (exit :data:`EXIT_PREEMPTED`);
* :mod:`~csat_tpu_torch.resilience.watchdog` — a heartbeat thread that
  turns a hung step into diagnostics plus a resumable abort (exit
  :data:`EXIT_WATCHDOG`), with a device-liveness leg;
* :mod:`~csat_tpu_torch.resilience.retry` — bounded retry/backoff for
  checkpoint saves, and a quarantine-with-error-budget policy for malformed
  data batches;
* :mod:`~csat_tpu_torch.resilience.faults` — a deterministic fault
  injector, so every behaviour above is exercised by CPU tests.

and for serving, the chaos layer over the engine and the replica fleet:

* :mod:`~csat_tpu_torch.resilience.chaos` — declarative fault plans
  compiled onto the injector, :func:`run_chaos`, which drives an engine or a
  fleet through a traffic trace, and :func:`run_net_chaos`, the same behind
  the network front door with the network fault kinds;
* :mod:`~csat_tpu_torch.resilience.invariants` — the serving invariants a
  chaos run is judged by, checked live and at quiescence.
"""

from csat_tpu_torch.resilience.chaos import (
    NET_KINDS, ChaosReport, FaultEvent, FaultPlan, run_chaos, run_net_chaos)
from csat_tpu_torch.resilience.faults import CorruptBatchError, FaultInjector
from csat_tpu_torch.resilience.guards import (
    TrainingDivergedError, global_norm, guarded_apply, host_snapshot, restore_snapshot)
from csat_tpu_torch.resilience.invariants import (
    InvariantMonitor, InvariantViolationError, Violation)
from csat_tpu_torch.resilience.preemption import (
    EXIT_PREEMPTED, Preempted, PreemptionHandler, abort_barrier, coordinated_trigger,
    read_resume_marker, write_resume_marker)
from csat_tpu_torch.resilience.retry import DataErrorBudgetExceeded, ErrorBudget, retry
from csat_tpu_torch.resilience.watchdog import (
    EXIT_WATCHDOG, StepWatchdog, device_liveness_probe)

__all__ = ["NET_KINDS", "ChaosReport", "FaultEvent", "FaultPlan", "run_chaos", "run_net_chaos",
           "InvariantMonitor",
           "InvariantViolationError", "Violation", "CorruptBatchError", "FaultInjector", "TrainingDivergedError", "global_norm",
           "guarded_apply", "host_snapshot", "restore_snapshot", "EXIT_PREEMPTED", "Preempted",
           "PreemptionHandler", "abort_barrier", "coordinated_trigger", "read_resume_marker",
           "write_resume_marker", "DataErrorBudgetExceeded", "ErrorBudget", "retry",
           "EXIT_WATCHDOG", "StepWatchdog", "device_liveness_probe"]
