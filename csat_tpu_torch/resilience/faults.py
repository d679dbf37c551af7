"""Deterministic fault injection for the resilience machinery.

The train and serve hooks of the JAX package's ``resilience/faults.py``.  Every
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

The serving engine (``serve/engine.py``) consults the injector at exact
scheduler points, so every serving failure mode is reproducible on a chosen
tick:

* **NaN logits** — poison one slot's self-attention KV (its pages' scales)
  before a chosen tick's decode, exercising the per-row retire-as-FAILED
  guard;
* **prefill failure** — a chosen prefill call raises, standing in for a
  device fault inside admission;
* **tick hang** — a host stall inside ``ServeEngine.tick``, the wedged
  dispatch the tick watchdog bounds (``sleep`` is injectable, so a drill
  can advance a virtual clock instead of waiting);
* **wedged slot** — silently freeze a slot's row (limit → 0) without
  telling the scheduler, exercising the stuck-slot reaper;
* **decode fault** — the decode dispatch raises on a chosen tick,
  exercising the bounded rebuild-and-resubmit;
* **poison sample** — :meth:`poison_sample` malforms a request payload,
  exercising the submit-time quarantine;
* **spill storm** — a chosen tick force-spills every unreferenced prefix-cache
  chain down the KV tiers (``ServeEngine.spill_all``), the whole warm set
  evicted at once;
* **corrupt tier** — a chosen tick flips payload bytes in every tiered
  snapshot (``ServeEngine.corrupt_tiers``), so the next restores must fail
  their digest check and re-prefill.

Step ordinals are global train-step attempts (0-based, counted by the
Trainer across epochs within one ``fit`` call); batch ordinals count batches
produced by the training iterator; tick ordinals count engine ticks and
prefill ordinals prefill calls (both 0-based).  All are deterministic for a
fixed config and trace, which is what makes the drills' assertions exact.
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
        serve_nan_logits: Collection[tuple] = (),
        serve_prefill_fail_calls: Collection[int] = (),
        serve_hang_at_tick: Optional[int] = None,
        serve_wedge_slots: Collection[tuple] = (),
        serve_decode_fail_ticks: Collection[int] = (),
        serve_spill_storm_ticks: Collection[int] = (),
        serve_corrupt_tier_ticks: Collection[int] = (),
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
        # serve faults: (tick, slot) pairs for cache poison / wedge, call
        # ordinals for prefill failure, tick ordinals for decode failure
        self.serve_nan_logits = {int(t): int(s) for t, s in serve_nan_logits}
        self.serve_prefill_fail_calls = frozenset(int(c) for c in serve_prefill_fail_calls)
        self.serve_hang_at_tick = serve_hang_at_tick
        self.serve_wedge_slots = {int(t): int(s) for t, s in serve_wedge_slots}
        self.serve_decode_fail_ticks = frozenset(int(t) for t in serve_decode_fail_ticks)
        # KV tier faults: tick ordinals
        self.serve_spill_storm_ticks = frozenset(int(t) for t in serve_spill_storm_ticks)
        self.serve_corrupt_tier_ticks = frozenset(int(t) for t in serve_corrupt_tier_ticks)
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

    # -- serve faults (consulted by ServeEngine.tick / admission) -----------

    def nan_logits_slot(self, tick: int) -> Optional[int]:
        """Slot whose self-KV should be NaN-poisoned before this tick's
        decode (None = no fault).  The poison reaches the logits once the
        row attends to a poisoned cached position, i.e. on rows with
        ``pos >= 1`` — inject after the row's first step."""
        slot = self.serve_nan_logits.get(tick)
        if slot is not None:
            self._note("nan_logits", tick=tick, slot=slot)
        return slot

    def wedge_slot(self, tick: int) -> Optional[int]:
        """Slot whose row should be silently frozen at this tick (the host
        scheduler is NOT told — the row just stops retiring)."""
        slot = self.serve_wedge_slots.get(tick)
        if slot is not None:
            self._note("wedge_slot", tick=tick, slot=slot)
        return slot

    def maybe_hang_tick(self, tick: int) -> None:
        """Host stall inside the scheduler tick — the wedged dispatch the
        tick watchdog turns into a bounded outage."""
        if self.serve_hang_at_tick is not None and tick == self.serve_hang_at_tick:
            self._note("hang_tick", tick=tick, seconds=self.hang_seconds)
            self._sleep(self.hang_seconds)

    def spill_storm(self, tick: int) -> bool:
        """Should this tick force-spill every unreferenced prefix-cache
        entry down the tiers (``ServeEngine.spill_all``)?  A page-pressure
        storm evicting the whole warm set at once."""
        if tick in self.serve_spill_storm_ticks:
            self._note("spill_storm", tick=tick)
            return True
        return False

    def corrupt_tier(self, tick: int) -> bool:
        """Should this tick corrupt every tiered snapshot
        (``ServeEngine.corrupt_tiers``)?  Bit rot or torn writes in the host
        and disk tiers: later restores must degrade to a re-prefill through
        the digest check, never write garbage into the pool."""
        if tick in self.serve_corrupt_tier_ticks:
            self._note("corrupt_tier_restore", tick=tick)
            return True
        return False

    def maybe_fail_prefill(self, call_ordinal: int) -> None:
        """Raise on the configured prefill call ordinals — a device fault
        inside admission."""
        if call_ordinal in self.serve_prefill_fail_calls:
            self._note("prefill_fail", call=call_ordinal)
            raise RuntimeError(f"injected prefill failure at call {call_ordinal}")

    def maybe_fail_decode(self, tick: int) -> None:
        """Raise on the configured decode ticks — a device fault escaping the
        decode dispatch, exercising rebuild-and-resubmit."""
        if tick in self.serve_decode_fail_ticks:
            self._note("decode_fail", tick=tick)
            raise RuntimeError(f"injected decode fault at tick {tick}")

    @staticmethod
    def poison_sample(sample: dict, mode: str = "missing_key") -> dict:
        """A malformed copy of a sample (a training row or a request):
        ``missing_key`` drops a required
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
