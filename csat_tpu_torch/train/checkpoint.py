"""Checkpoints: the full train state, and the best model's parameters.

Counterpart of the JAX package's ``train/checkpoint.py`` on ``torch.save`` /
``torch.load``.  A state checkpoint ``state_<step>.pt`` holds the parameters,
both AdamW moments and their count, the step and the noise generator's
state, all on the host, so a resumed run reproduces the uninterrupted one.
Files are written to a temporary name and renamed, so a reader never sees a
torn file; the three newest steps of a directory are kept.  Saves are
synchronous (the JAX package's asynchronous orbax manager has no
counterpart here); :func:`make_checkpoint_fn` wraps them in bounded retry.

A mid-epoch snapshot lives under ``<checkpoints>/preempt`` beside a resume
marker (the marker half of the JAX package's ``resilience/preemption.py``):
which epoch was in flight, how many of its iterations the state contains,
and the batch plan that count addresses.  ``Trainer.fit(resume=...)`` replays
that epoch's deterministic batch sequence and skips the completed iterations.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Dict, Optional, Tuple

import torch

from csat_tpu_torch.resilience.guards import HostSnapshot, host_snapshot, restore_snapshot
from csat_tpu_torch.resilience.retry import retry
from csat_tpu_torch.train.state import TrainState

__all__ = ["save_state", "restore_state", "latest_step", "restore_latest", "save_params",
           "restore_params", "make_checkpoint_fn", "Preempted", "preempt_dir", "snapshot_step",
           "write_resume_marker", "read_resume_marker"]

MAX_TO_KEEP = 3
_STATE_RE = re.compile(r"state_(\d+)\.pt$")
_MARKER = "resume_marker.json"
# step keys are integers; (epoch, iteration) is encoded injectively so a
# second stop in the same epoch gets a fresh key
_STEP_STRIDE = 10_000_000


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


def save_state(directory: str, state: TrainState, step: int) -> None:
    """Write ``state`` as step ``step`` of ``directory``; drop all but the
    :data:`MAX_TO_KEEP` newest steps."""
    snap = host_snapshot(state)
    _atomic_save({"step": snap.step, "params": snap.params, "count": snap.count,
                  "mu": snap.mu, "nu": snap.nu, "gen_state": snap.gen_state},
                 _state_path(directory, step))
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        os.remove(_state_path(directory, old))


def latest_step(directory: str) -> Optional[int]:
    """Newest checkpointed step (epoch) under ``directory``, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_state(directory: str, state: TrainState, step: Optional[int] = None) -> TrainState:
    """Load step ``step`` (default: the newest) into ``state`` in place —
    parameter names and shapes must match — and return it."""
    step = latest_step(directory) if step is None else step
    assert step is not None, f"no checkpoints under {directory}"
    blob = torch.load(_state_path(directory, step), map_location="cpu", weights_only=True)
    missing = set(state.params) ^ set(blob["params"])
    if missing:
        raise KeyError(f"checkpoint and model disagree on parameters: {sorted(missing)}")
    return restore_snapshot(HostSnapshot(**blob), state)


def restore_latest(directory: str, state: TrainState,
                   step: Optional[int] = None) -> Tuple[TrainState, int]:
    """→ ``(state, epoch)`` from the newest checkpoint (the resume surface)."""
    step = latest_step(directory) if step is None else step
    assert step is not None, f"no checkpoints under {directory}"
    return restore_state(directory, state, step), step


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
                       save: Optional[Callable[[str, TrainState, int], None]] = None
                       ) -> Callable[[TrainState, int], None]:
    """Periodic-save hook for ``Trainer.fit``: ``fn(state, epoch)`` writes
    ``<directory>/checkpoints/state_<epoch>.pt`` under bounded retry with
    exponential backoff.  ``save`` is injectable (a drill substitutes a
    flaky one); ``fn.directory`` is where the checkpoints go."""
    ck_dir = os.path.join(directory, "checkpoints")
    save = save or save_state

    def fn(state: TrainState, epoch: int) -> None:
        retry(save, ck_dir, state, epoch, attempts=retries, backoff_s=backoff_s,
              desc=f"checkpoint save (epoch {epoch}, {ck_dir})")

    fn.directory = ck_dir
    return fn


class Preempted(RuntimeError):
    """Raised by the training loop after a requested stop's snapshot is on disk."""

    def __init__(self, directory: str, epoch: int, iterations_done: int):
        super().__init__(
            f"stopped during epoch {epoch} after {iterations_done} "
            f"iterations; resumable checkpoint at {directory}")
        self.directory = directory
        self.epoch = epoch
        self.iterations_done = iterations_done


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
