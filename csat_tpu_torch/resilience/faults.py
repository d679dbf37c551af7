"""Deterministic fault injection for the trainer's resilience machinery.

The train hooks of the JAX package's ``resilience/faults.py``.  Every
mechanism in this package exists because of a failure that is hard to
reproduce on demand, so none of them can be trusted on faith.  The injector
creates each fault at a chosen step:

* **non-finite grads / loss spikes** — a per-step loss multiplier passed to
  the train step (``NaN`` poisons loss *and* grads; a huge finite spike
  overflows only the grad-norm, exercising the guard's second leg);
* **corrupt batches** — raised from the data pipeline's per-batch hook,
  exactly where a malformed sample would break collate;
* **preemption** — triggers the trainer's stop flag (or delivers a real
  ``SIGTERM`` to the process) at a chosen step;
* **hung step** — a host-side stall between heartbeats, standing in for a
  wedged device step;
* **failing saves** — a wrapper that makes the first N checkpoint saves
  raise, exercising the bounded retry.

Step ordinals are global train-step attempts (0-based, counted by the
Trainer across epochs within one ``fit`` call); batch ordinals count batches
produced by the training iterator.  Both are deterministic for a fixed
config, which is what makes the drills' assertions exact.  The serving
engine's fault hooks are not ported with this module.
"""

from __future__ import annotations

import math
import os
import signal
import time
from typing import Callable, Collection, Optional

__all__ = ["CorruptBatchError", "FaultInjector"]


class CorruptBatchError(RuntimeError):
    """Stands in for any exception a malformed sample raises in collate."""


class FaultInjector:
    def __init__(
        self,
        nan_loss_steps: Collection[int] = (),
        spike_steps: Collection[int] = (),
        spike_scale: float = 1e30,
        corrupt_batches: Collection[int] = (),
        preempt_at_step: Optional[int] = None,
        deliver_signal: bool = False,
        hang_at_step: Optional[int] = None,
        hang_seconds: float = 0.0,
        save_failures: int = 0,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self.nan_loss_steps = frozenset(int(s) for s in nan_loss_steps)
        self.spike_steps = frozenset(int(s) for s in spike_steps)
        self.spike_scale = float(spike_scale)
        self.corrupt_batches = frozenset(int(b) for b in corrupt_batches)
        self.preempt_at_step = preempt_at_step
        self.deliver_signal = deliver_signal
        self.hang_at_step = hang_at_step
        self.hang_seconds = float(hang_seconds)
        self.save_failures_remaining = int(save_failures)
        self._sleep = sleep
        self._batch_ordinal = 0
        self.injected_saves_failed = 0
        # optional flight recorder (obs/events.py): the trainer attaches its
        # own, so every fired fault is stamped into the SAME timeline the
        # post-mortem dumps — a drill's dump shows cause next to effect
        self.recorder = None

    def _note(self, kind: str, **fields) -> None:
        if self.recorder is not None:
            self.recorder.emit(f"fault.injected.{kind}", **fields)

    # -- train-step faults -------------------------------------------------

    def loss_scale(self, step: int) -> Optional[float]:
        """Loss multiplier for global step ``step`` (None = no fault)."""
        if step in self.nan_loss_steps:
            self._note("nan_loss", step=step)
            return math.nan
        if step in self.spike_steps:
            self._note("spike", step=step)
            return self.spike_scale
        return None

    def maybe_hang(self, step: int) -> None:
        """Stall the loop between heartbeats, simulating a hung step from
        the watchdog's point of view."""
        if self.hang_at_step is not None and step == self.hang_at_step:
            self._note("hang", step=step, seconds=self.hang_seconds)
            self._sleep(self.hang_seconds)

    def fire_preemption(self, step: int, handler) -> bool:
        """Trigger preemption at the configured step — through the real
        signal path when ``deliver_signal`` (the handler must be installed),
        else directly on the handler's flag."""
        if self.preempt_at_step is None or step != self.preempt_at_step:
            return False
        self._note("preemption", step=step)
        if self.deliver_signal:
            os.kill(os.getpid(), signal.SIGTERM)
        else:
            handler.trigger()
        return True

    @staticmethod
    def poison_sample(sample: dict, mode: str = "missing_key") -> dict:
        """A malformed copy of a sample: ``missing_key`` drops a required
        field, ``oversize`` claims more nodes than max_src_len, ``dtype``
        turns token ids into floats, ``shape`` truncates the source row —
        each a distinct way real data goes wrong."""
        import numpy as np

        bad = dict(sample)
        if mode == "missing_key":
            bad.pop("L_raw")
        elif mode == "oversize":
            bad["num_node"] = np.asarray(2 ** 14, np.int32)
        elif mode == "dtype":
            bad["src_seq"] = np.asarray(bad["src_seq"], np.float32) + 0.5
        elif mode == "shape":
            bad["src_seq"] = bad["src_seq"][:-1]
        else:
            raise ValueError(f"unknown poison mode {mode!r}")
        return bad

    # -- data faults -------------------------------------------------------

    def batch_hook(self, chunk_indices, batch):
        """The batch iterators' per-batch hook: raises on the configured
        batch ordinals, passes everything else through unchanged."""
        ordinal = self._batch_ordinal
        self._batch_ordinal += 1
        if ordinal in self.corrupt_batches:
            self._note("corrupt_batch", batch=ordinal)
            raise CorruptBatchError(
                f"injected corrupt batch at ordinal {ordinal} "
                f"(samples {list(map(int, chunk_indices))})")
        return batch

    # -- checkpoint faults -------------------------------------------------

    def flaky_save(self, save_fn: Callable) -> Callable:
        """Wrap a save function so its first ``save_failures`` calls raise
        ``IOError`` — the transient-filesystem fault the retry bounds."""

        def wrapped(*args, **kwargs):
            if self.save_failures_remaining > 0:
                self.save_failures_remaining -= 1
                self.injected_saves_failed += 1
                raise IOError(f"injected checkpoint save failure "
                              f"({self.save_failures_remaining} more to come)")
            return save_fn(*args, **kwargs)

        return wrapped
