"""Preemption safety: signal-triggered final checkpoint + resume marker.

Counterpart of the JAX package's ``resilience/preemption.py``.  Preemptible
machines deliver SIGTERM with a short grace window; an unhandled one loses
everything since the last ``save_interval`` checkpoint.  The handler here
only sets a flag — the training loop polls it at step granularity, performs
one final *synchronous* checkpoint of the full train state, writes a resume
marker recording how many iterations of the in-flight epoch completed, and
raises :class:`Preempted`; the command line exits :data:`EXIT_PREEMPTED`.
On ``fit(resume=True)`` the marker replays the epoch's deterministic batch
sequence, skips the completed iterations and continues bit for bit — at most
the in-flight step is lost.

The snapshot lives in its own ``preempt/`` subdirectory: its step key
encodes the *in-progress* epoch and iteration, which would collide with the
boundary checkpoints' completed-epoch keys in one directory.

:func:`coordinated_trigger` and :func:`abort_barrier` are the multi-process
gates of the JAX package (``preemption.py:108-172``): under a
``torch.distributed`` group of several processes every process polls the
flag of all of them — an all-reduce MAX on the host group
(``parallel/host.py``), which reads nothing from the card — so a SIGTERM to
one process stops every process at the same step boundary, and they
rendezvous before the save, which rank 0 alone writes.  On one process they
are the local flag and no barrier.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import threading
from typing import Iterator, Optional, Tuple

__all__ = ["EXIT_PREEMPTED", "Preempted", "PreemptionHandler", "abort_barrier",
           "coordinated_trigger", "preempt_dir", "read_resume_marker", "snapshot_step",
           "write_resume_marker"]

# sysexits EX_TEMPFAIL: "try again later" — schedulers treat it as resumable
EXIT_PREEMPTED = 75

_MARKER = "resume_marker.json"
# step keys are integers; (epoch, iteration) is encoded injectively so a
# second stop in the same epoch gets a fresh key
_STEP_STRIDE = 10_000_000


class Preempted(RuntimeError):
    """Raised by the training loop after the final checkpoint is durable.

    Carries the checkpoint location so callers (the command line, tests) can
    report where to resume from before exiting with :data:`EXIT_PREEMPTED`."""

    def __init__(self, directory: str, epoch: int, iterations_done: int):
        super().__init__(
            f"preempted during epoch {epoch} after {iterations_done} "
            f"iterations; resumable checkpoint at {directory}")
        self.directory = directory
        self.epoch = epoch
        self.iterations_done = iterations_done


class PreemptionHandler:
    """Latching stop flag settable from a signal, a thread, or a test.

    The signal handler does nothing but set an event (async-signal-safe);
    all checkpoint work happens in the training loop at a step boundary,
    where the state is well defined."""

    def __init__(self) -> None:
        self._flag = threading.Event()
        self._signum: Optional[int] = None

    @property
    def triggered(self) -> bool:
        return self._flag.is_set()

    def trigger(self, signum: Optional[int] = None) -> None:
        """Request a graceful stop (signal handler / fault harness)."""
        self._signum = signum
        self._flag.set()

    @contextlib.contextmanager
    def installed(self, signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)
                  ) -> Iterator["PreemptionHandler"]:
        """Install the flag-setting handler for ``signals``, restoring the
        previous handlers on exit.  Outside the main thread (where Python
        forbids ``signal.signal``) this degrades to flag-only mode — the
        harness can still :meth:`trigger` programmatically."""
        previous = {}
        try:
            for s in signals:
                try:
                    previous[s] = signal.signal(s, lambda signum, frame: self.trigger(signum))
                except ValueError:  # not the main thread
                    break
            yield self
        finally:
            for s, old in previous.items():
                signal.signal(s, old)


def coordinated_trigger(handler: PreemptionHandler) -> bool:
    """Whether any process has been asked to stop.  On one process that is
    ``handler.triggered``; under a group of several, the local flags are
    all-reduced with MAX over the host group, so every process gets the
    same answer at the same step, and a process that learns of another's
    stop latches it on its own handler."""
    from csat_tpu_torch.parallel import host

    if host.world() <= 1:
        return handler.triggered
    import torch
    import torch.distributed as dist

    flag = torch.tensor([1 if handler.triggered else 0], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=host.host_group())
    stop = bool(flag.item())
    if stop and not handler.triggered:
        handler.trigger()
    return stop


def abort_barrier(tag: str = "preempt_save") -> str:
    """The sync point every process enters immediately before the preemption
    save; returns how it synced: ``"single"`` (one process — nothing to
    sync) or ``"barrier"`` (every process arrived).  A failed rendezvous
    propagates: it means some process is not entering the save."""
    from csat_tpu_torch.parallel import host

    del tag  # names the call site for readers; the rendezvous is the same
    if host.world() <= 1:
        return "single"
    host.barrier()
    return "barrier"


def preempt_dir(checkpoint_dir: str) -> str:
    """The mid-epoch snapshot directory under a run's checkpoint dir."""
    return os.path.join(checkpoint_dir, "preempt")


def snapshot_step(epoch: int, iterations_done: int) -> int:
    """Step key of a mid-epoch snapshot."""
    assert 0 <= iterations_done < _STEP_STRIDE, iterations_done
    return int(epoch) * _STEP_STRIDE + int(iterations_done)


def write_resume_marker(checkpoint_dir: str, epoch: int, iterations_done: int,
                        plan: Optional[str] = None) -> str:
    """Record that the snapshot holds mid-epoch state: ``epoch`` is the
    epoch in flight and ``iterations_done`` how many of its iterations the
    saved state already contains.  ``plan`` names the deterministic batch
    sequence the count addresses (``data.bucketing.plan_signature`` plus the
    host count); a resume under another plan is refused.  Written atomically
    (rename) next to the snapshot."""
    d = preempt_dir(checkpoint_dir)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, _MARKER)
    marker = {"epoch": int(epoch), "iterations_done": int(iterations_done),
              "step": snapshot_step(epoch, iterations_done)}
    if plan is not None:
        marker["plan"] = str(plan)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(marker, f)
    os.replace(tmp, path)
    return path


def read_resume_marker(checkpoint_dir: str) -> Optional[dict]:
    """The resume marker, or None when there is none, it is malformed, or
    the snapshot it names is not the newest one on disk (a stale marker is
    ignored rather than trusted)."""
    from csat_tpu_torch.train.checkpoint import latest_step

    d = preempt_dir(checkpoint_dir)
    path = os.path.join(d, _MARKER)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            marker = json.load(f)
        out = {"epoch": int(marker["epoch"]),
               "iterations_done": int(marker["iterations_done"]),
               "step": int(marker["step"])}
    except (ValueError, KeyError, TypeError):
        return None
    if latest_step(d) != out["step"]:
        return None
    if "plan" in marker:
        out["plan"] = str(marker["plan"])
    return out
