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
marker (``resilience/preemption.py``, re-exported here): which epoch was in
flight, how many of its iterations the state contains, and the batch plan
that count addresses.  ``Trainer.fit(resume=...)`` replays that epoch's
deterministic batch sequence and skips the completed iterations.

Under a ``model`` axis a process holds its shards of the parameters and
moments: :func:`whole_state` gathers them over the ``model`` line (every
member makes the call), so the file holds whole arrays, exactly what one
process writes — a tensor-parallel checkpoint restores into one process and
serves solo — and ``restore_state(..., mesh=...)`` cuts a file back to this
process's shards.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, Dict, Optional, Tuple

import torch

from csat_tpu_torch.resilience.guards import HostSnapshot, host_snapshot, restore_snapshot
from csat_tpu_torch.resilience.preemption import (
    Preempted, preempt_dir, read_resume_marker, snapshot_step, write_resume_marker)
from csat_tpu_torch.resilience.retry import retry
from csat_tpu_torch.train.state import TrainState

__all__ = ["whole_state", "save_state", "restore_state", "latest_step", "restore_latest",
           "save_params", "restore_params", "make_checkpoint_fn", "Preempted", "preempt_dir",
           "snapshot_step", "write_resume_marker", "read_resume_marker"]

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


def restore_state(directory: str, state: TrainState, step: Optional[int] = None,
                  mesh=None) -> TrainState:
    """Load step ``step`` (default: the newest) into ``state`` in place —
    parameter names and shapes must match, after the whole arrays are cut
    to this process's shards of ``mesh``'s ``model`` axis — and return
    it."""
    from csat_tpu_torch.parallel.mesh import shard_params

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
    """Periodic-save hook for ``Trainer.fit``: ``fn(state, epoch)`` writes
    ``<directory>/checkpoints/state_<epoch>.pt`` under bounded retry with
    exponential backoff.  ``save`` is injectable, and a fault injector's
    ``flaky_save`` wraps it (a drill's failing saves); ``fn.directory`` is
    where the checkpoints go."""
    ck_dir = os.path.join(directory, "checkpoints")
    save = save or save_state
    if injector is not None:
        save = injector.flaky_save(save)

    def fn(state: TrainState, epoch: int) -> None:
        retry(save, ck_dir, state, epoch, attempts=retries, backoff_s=backoff_s,
              desc=f"checkpoint save (epoch {epoch}, {ck_dir})")

    fn.directory = ck_dir
    return fn
