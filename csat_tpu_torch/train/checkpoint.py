"""Checkpoints: the full train state, and the best model's parameters.

Counterpart of the JAX package's ``train/checkpoint.py`` on ``torch.save`` /
``torch.load``.  A state checkpoint ``state_<step>.pt`` holds the parameters,
both AdamW moments and their count, the step and the noise generator's
state, all on the host, so a resumed run reproduces the uninterrupted one.
Files are written to a temporary name and renamed, so a reader never sees a
torn file; the three newest steps of a directory are kept.

Epoch snapshots are asynchronous, as JAX's orbax manager makes them:
:func:`save_state_async` copies the state to host tensors on the calling
thread — it must, the AdamW step updates parameters and moments in place
(``train/optimizer.py``), the port's counterpart of JAX's buffer donation —
and the write (``torch.save`` to the temporary name, the rename, the keep-3
cleanup) runs in one background thread per directory while the next epoch
trains.  A save is durable only after the barrier, :func:`wait_for_saves`:
the host copy stays in a durability ledger until the barrier confirms its
write, and a background fault is retried there once, synchronously, from
that copy (a second failure propagates).  Each async save first confirms
the previous one of its directory through the same barrier, and a
synchronous operation on a directory (:func:`save_state`,
:func:`latest_step`, :func:`restore_state`) drains its pending save first.
At interpreter exit a bounded drain (120 s) confirms what is pending and
reports a failure on stderr with the directory's name.  A hard kill loses at
most the newest snapshot, never leaves a torn one.
:func:`make_checkpoint_fn` saves asynchronously by default and its
``fn.wait`` is the barrier of its own directory; ``Trainer.fit`` calls it
before it returns.

A mid-epoch snapshot lives under ``<checkpoints>/preempt`` beside a resume
marker (``resilience/preemption.py``, re-exported here): which epoch was in
flight, how many of its iterations the state contains, and the batch plan
that count addresses.  ``Trainer.fit(resume=...)`` replays that epoch's
deterministic batch sequence and skips the completed iterations.  That
snapshot is written synchronously.

Under a ``model`` axis a process holds its shards of the parameters and
moments: :func:`whole_state` gathers them over the ``model`` line (every
member makes the call), so the file holds whole arrays, exactly what one
process writes — a tensor-parallel checkpoint restores into one process and
serves solo — and ``restore_state(..., mesh=...)`` cuts a file back to this
process's shards.  Under any mesh the gather runs on every rank and only the
primary's write goes to the background, so the trainer's barrier after an
epoch save no longer means the file is on disk: a resume reads the newest
file that was committed.
"""

from __future__ import annotations

import atexit
import dataclasses
import os
import re
import sys
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from csat_tpu_torch.resilience.guards import HostSnapshot, host_snapshot, restore_snapshot
from csat_tpu_torch.resilience.preemption import (
    Preempted, preempt_dir, read_resume_marker, snapshot_step, write_resume_marker)
from csat_tpu_torch.resilience.retry import retry
from csat_tpu_torch.train.state import TrainState

__all__ = ["whole_state", "save_state", "save_state_async", "wait_for_saves", "restore_state",
           "latest_step", "restore_latest", "save_params", "restore_params",
           "make_checkpoint_fn", "Preempted", "preempt_dir", "snapshot_step",
           "write_resume_marker", "read_resume_marker"]

MAX_TO_KEEP = 3
_STATE_RE = re.compile(r"state_(\d+)\.pt$")


def _atomic_save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STATE_RE.match, os.listdir(directory)) if m)


def _state_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"state_{int(step)}.pt")


def whole_state(state: TrainState, mesh=None) -> TrainState:
    """``state`` with its parameters and AdamW moments whole: gathered over
    ``mesh``'s ``model`` line (a collective: each member makes the call), or
    ``state`` itself without a ``model`` axis.  The step, the count and the
    generator are the state's own."""
    from csat_tpu_torch.parallel.mesh import gather_params, model_axis

    if model_axis(mesh) is None:
        return state
    opt = state.opt_state
    return TrainState(step=state.step, params=gather_params(state.params, mesh),
                      opt_state=dataclasses.replace(opt, mu=gather_params(opt.mu, mesh),
                                                    nu=gather_params(opt.nu, mesh)),
                      generator=state.generator)


def _write_state(directory: str, snap: HostSnapshot, step: int) -> None:
    """Write a host snapshot as step ``step`` of ``directory``; drop all but
    the :data:`MAX_TO_KEEP` newest steps."""
    _atomic_save(snap._asdict(), _state_path(directory, step))
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        os.remove(_state_path(directory, old))


class _Writer:
    """One directory's background writer: at most one write in flight, its
    exception kept for the barrier."""

    def __init__(self) -> None:
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def submit(self, directory: str, snap: HostSnapshot, step: int) -> None:
        def write() -> None:
            try:
                _write_state(directory, snap, step)
            except BaseException as e:  # noqa: BLE001 — handed to the barrier
                self.error = e

        self.thread = threading.Thread(target=write, name=f"checkpoint {directory}",
                                       daemon=True)
        self.thread.start()

    def wait_until_finished(self) -> None:
        """Join the write in flight; raise its exception, once."""
        if self.thread is not None:
            self.thread.join()
            self.thread = None
        error, self.error = self.error, None
        if error is not None:
            raise error


# directory → its background writer (absolute paths)
_WRITERS: Dict[str, _Writer] = {}

# Durability ledger: directory → (step, host snapshot) of the newest async
# save whose write has NOT been confirmed.  The AdamW step updates the state
# in place, so once the next step runs the tensors that produced a snapshot
# hold other values: the saver owns the host copy until the barrier confirms
# the write, so the barrier can RETRY the save instead of losing the epoch.
# Dropped as soon as a barrier passes.
_PENDING_SAVES: Dict[str, Tuple[int, HostSnapshot]] = {}

_ATEXIT_DRAIN_S = 120.0  # bound the exit-time drain: a wedged write must
# not hang interpreter exit forever


def _writer(directory: str) -> _Writer:
    w = _WRITERS.get(directory)
    if w is None:
        w = _WRITERS[directory] = _Writer()
        atexit.register(_close_async, directory)
    return w


def _close_async(directory: str) -> None:
    """The exit drain of one directory, bounded by :data:`_ATEXIT_DRAIN_S`:
    confirm its pending save (with the barrier's retry) and report a failure
    on stderr, since nothing is left to raise to."""
    if directory not in _WRITERS:
        return

    def drain() -> None:
        # errors are reported HERE: the joining thread never sees them
        try:
            _confirm_durable(directory)
        except Exception as e:  # noqa: BLE001 — atexit: report, don't raise
            print(f"# checkpoint: async save to {directory} failed at exit: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    t.join(_ATEXIT_DRAIN_S)
    if t.is_alive():
        print(f"# checkpoint: async save to {directory} still pending after "
              f"{_ATEXIT_DRAIN_S:.0f}s at exit — abandoning (the newest snapshot may be "
              "missing; files are renamed into place, so none is left torn)",
              file=sys.stderr)
    _WRITERS.pop(directory, None)


def _confirm_durable(directory: str) -> None:
    """Durability barrier for one directory: wait for the write in flight; on
    a background fault, retry ONCE synchronously from the ledger's host copy
    (the device state has moved on).  A second failure propagates — that is a
    broken filesystem, not a blip.  The ledger entry is dropped only on
    confirmed durability."""
    w = _WRITERS.get(directory)
    if w is None:
        return
    try:
        w.wait_until_finished()
    except Exception as e:  # noqa: BLE001 — deferred background fault
        pending = _PENDING_SAVES.get(directory)
        if pending is None:
            raise
        step, snap = pending
        print(f"# checkpoint: async save of step {step} to {directory} failed at the "
              f"durability barrier ({type(e).__name__}: {e}); retrying synchronously "
              "from the retained host copy", file=sys.stderr)
        _write_state(directory, snap, step)
    _PENDING_SAVES.pop(directory, None)


def save_state_async(directory: str, state: TrainState, step: int) -> None:
    """Snapshot ``state`` as step ``step`` of ``directory``: the host copy
    now, the write in the directory's background thread.  Durable only after
    :func:`wait_for_saves`; the previous save of the directory is confirmed
    (or recovered from its host copy) first."""
    d = os.path.abspath(directory)
    w = _writer(d)
    snap = host_snapshot(state)
    _confirm_durable(d)
    _PENDING_SAVES[d] = (step, snap)
    w.submit(d, snap, step)


def wait_for_saves(directory: Optional[str] = None) -> None:
    """Block until pending async snapshots are durable (every directory, or
    ``directory``'s); a background fault is retried from the retained host
    copy."""
    for d in list(_WRITERS):
        if directory is None or d == os.path.abspath(directory):
            _confirm_durable(d)


def save_state(directory: str, state: TrainState, step: int) -> None:
    """Write ``state`` as step ``step`` of ``directory`` now, after its
    pending async save; drop all but the :data:`MAX_TO_KEEP` newest steps."""
    wait_for_saves(directory)
    _write_state(directory, host_snapshot(state), step)


def latest_step(directory: str) -> Optional[int]:
    """Newest checkpointed step (epoch) under ``directory``, or None (after
    its pending async save)."""
    wait_for_saves(directory)
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_state(directory: str, state: TrainState, step: Optional[int] = None,
                  mesh=None) -> TrainState:
    """Load step ``step`` (default: the newest) into ``state`` in place —
    parameter names and shapes must match, after the whole arrays are cut
    to this process's shards of ``mesh``'s ``model`` axis — and return
    it.  A pending async save of ``directory`` is made durable first."""
    from csat_tpu_torch.parallel.mesh import shard_params

    wait_for_saves(directory)
    step = latest_step(directory) if step is None else step
    assert step is not None, f"no checkpoints under {directory}"
    blob = torch.load(_state_path(directory, step), map_location="cpu", weights_only=True)
    missing = set(state.params) ^ set(blob["params"])
    if missing:
        raise KeyError(f"checkpoint and model disagree on parameters: {sorted(missing)}")
    if mesh is not None:
        blob.update({key: shard_params(blob[key], mesh) for key in ("params", "mu", "nu")})
    return restore_snapshot(HostSnapshot(**blob), state)


def restore_latest(directory: str, state: TrainState, step: Optional[int] = None,
                   mesh=None) -> Tuple[TrainState, int]:
    """→ ``(state, epoch)`` from the newest checkpoint (the resume surface)."""
    step = latest_step(directory) if step is None else step
    assert step is not None, f"no checkpoints under {directory}"
    return restore_state(directory, state, step, mesh), step


def save_params(directory: str, params: Dict[str, torch.Tensor],
                name: str = "best_model") -> None:
    """Write a parameter dict (``named_parameters`` names) as ``<name>.pt``."""
    _atomic_save({k: v.detach().to("cpu") for k, v in params.items()},
                 os.path.join(directory, f"{name}.pt"))


def restore_params(directory: str, name: str = "best_model") -> Dict[str, torch.Tensor]:
    path = os.path.join(directory, f"{name}.pt")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no saved params at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def make_checkpoint_fn(directory: str, retries: int = 3, backoff_s: float = 0.5,
                       save: Optional[Callable[[str, TrainState, int], None]] = None,
                       injector=None) -> Callable[[TrainState, int], None]:
    """Periodic-save hook for ``Trainer.fit``: ``fn(state, epoch)`` snapshots
    ``<directory>/checkpoints/state_<epoch>.pt``, asynchronously by default
    (:func:`save_state_async`), under bounded retry with exponential backoff.
    The retry covers the host copy and the confirmation of the directory's
    previous save; a fault in this save's own background write surfaces at
    the barrier, which retries it once from the host copy.  ``save`` is
    injectable, and a fault injector's ``flaky_save`` wraps it (a drill's
    failing saves); ``fn.directory`` is where the checkpoints go and
    ``fn.wait`` the barrier scoped to it (a process may host several
    trainers: an unscoped wait would serialise them on each other's
    snapshots)."""
    ck_dir = os.path.join(directory, "checkpoints")
    save = save or save_state_async
    if injector is not None:
        save = injector.flaky_save(save)

    def fn(state: TrainState, epoch: int) -> None:
        retry(save, ck_dir, state, epoch, attempts=retries, backoff_s=backoff_s,
              desc=f"checkpoint save (epoch {epoch}, {ck_dir})")

    fn.wait = lambda: wait_for_saves(ck_dir)
    fn.directory = ck_dir
    return fn
