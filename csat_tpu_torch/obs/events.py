"""Event flight recorder: a bounded ring buffer of structured events.

The port's copy of the JAX package's ``obs/events.py``, in the same dump
format, so either package's :meth:`EventRecorder.load` reads the other's
dumps.  The Trainer records train-step phases and resilience actions, and
the fault injector stamps the faults it fires into the same timeline.  When
a fault path fires, the owner dumps the ring to a post-mortem JSONL file — an
incident leaves a *timeline* (what the loop was doing in the seconds before
the fault) instead of a single log line.

Design constraints, in order:

* **cheap-on** — recording is the default.  An event is one tuple append
  into a ``deque(maxlen=...)``; a phase span is two ``perf_counter`` reads
  and one append.  No locks (CPython deque appends are atomic), no device
  traffic, no allocation beyond the tuple (field dicts only when fields
  are passed).
* **bounded** — the ring holds the most recent ``capacity`` events.
  Per-span totals are additionally accumulated into
  :attr:`EventRecorder.totals` so phase-time aggregates survive ring
  wraparound.
* **post-mortem, not logging** — :meth:`postmortem` writes one ROLLING
  file per fault reason (``postmortem_<component>_<reason>.jsonl``,
  overwritten on each recurrence), so a fault storm rewrites a handful of
  files instead of filling the disk.

Event tuples are ``(ts, name, dur, fields)`` with ``ts`` from
``time.perf_counter()`` (monotonic, sub-microsecond).  The dump header
records the wall-clock/perf offset so timelines can be correlated across
components and with external logs.
"""

from __future__ import annotations

import json
import os
import re
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

__all__ = ["EventRecorder", "Span"]

_REASON_RE = re.compile(r"[^A-Za-z0-9_.-]+")

EventTuple = Tuple[float, str, float, Optional[dict]]


class Span:
    """Context manager recording one complete phase span on exit.

    With ``annotate`` the body is also bracketed with
    ``torch.profiler.record_function`` so the host span lines up with the
    device trace of a profiled epoch (the bracket is only built when
    ``annotate`` is set — the common path imports nothing)."""

    __slots__ = ("_rec", "_name", "_fields", "_ann", "_t0")

    def __init__(self, rec: "EventRecorder", name: str,
                 annotate: bool = False, fields: Optional[dict] = None):
        self._rec = rec
        self._name = name
        self._fields = fields
        self._ann = None
        if annotate:
            from torch.profiler import record_function

            self._ann = record_function(name)

    def __enter__(self) -> "Span":
        if self._ann is not None:
            self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._rec.span_from(self._name, self._t0, **(self._fields or {}))


class EventRecorder:
    def __init__(self, capacity: int = 4096, component: str = "obs",
                 max_dump_events: int = 0):
        self.component = component
        self.capacity = int(capacity)
        self._ring: Optional[deque] = (
            deque(maxlen=self.capacity) if self.capacity > 0 else None)
        # per-name cumulative span seconds/counts: survives ring wraparound
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        # wall↔perf correlation base, stamped once at construction
        self.wall_t0 = time.time()
        self.perf_t0 = time.perf_counter()
        self.max_dump_events = int(max_dump_events)  # 0 = whole ring
        self.dumps_written = 0

    @property
    def enabled(self) -> bool:
        return self._ring is not None

    # ---------------- recording ----------------

    def emit(self, name: str, **fields) -> None:
        """One instant event (a lifecycle transition, a resilience action)."""
        if self._ring is None:
            return
        self._ring.append((time.perf_counter(), name, 0.0, fields or None))

    def span_from(self, name: str, t0: float, **fields) -> None:
        """Close a phase span opened at ``t0 = time.perf_counter()`` —
        the allocation-light form hot loops use instead of :meth:`span`.
        A disabled recorder (capacity 0) skips the totals too, so the
        telemetry-off posture really is a no-op."""
        if self._ring is None:
            return
        dur = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dur
        self.counts[name] = self.counts.get(name, 0) + 1
        self._ring.append((t0, name, dur, fields or None))

    def span(self, name: str, annotate: bool = False, **fields) -> Span:
        return Span(self, name, annotate=annotate, fields=fields or None)

    def events(self) -> List[EventTuple]:
        """Snapshot of the ring, oldest first.

        Dumps can run on a watchdog monitor thread while the owner thread
        is still appending; ``list(deque)`` over a concurrently-mutated
        deque raises RuntimeError, so the copy retries (the mutation
        window is one append — a handful of attempts always lands) and
        degrades to an empty snapshot rather than ever raising."""
        if self._ring is None:
            return []
        for _ in range(8):
            try:
                return list(self._ring)
            except RuntimeError:
                continue
        return []

    def phase_totals(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name aggregate: ``{name: {count, total_s, mean_ms}}``."""
        return {
            name: {
                "count": self.counts[name],
                "total_s": round(total, 6),
                "mean_ms": round(total / self.counts[name] * 1e3, 4),
            }
            for name, total in sorted(self.totals.items())
        }

    # ---------------- dumping ----------------

    def _header(self, reason: str) -> dict:
        return {
            "meta": {
                "component": self.component,
                "reason": reason,
                "wall_t0": round(self.wall_t0, 6),
                "perf_t0": round(self.perf_t0, 6),
                "dumped_at": round(time.time(), 3),
                "events": len(self._ring) if self._ring is not None else 0,
                "capacity": self.capacity,
            }
        }

    def dump(self, path: str, reason: str = "") -> str:
        """Write the ring to ``path`` as JSONL: one ``{"meta": ...}`` header
        line, then one event per line (oldest first)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        events = self.events()
        if self.max_dump_events and len(events) > self.max_dump_events:
            events = events[-self.max_dump_events:]
        with open(path, "w") as f:
            f.write(json.dumps(self._header(reason)) + "\n")
            for ts, name, dur, fields in events:
                rec = {"ts": round(ts, 6), "name": name}
                if dur:
                    rec["dur"] = round(dur, 6)
                if fields:
                    rec.update(fields)
                f.write(json.dumps(rec) + "\n")
        self.dumps_written += 1
        return path

    def postmortem(self, directory: str, reason: str) -> Optional[str]:
        """Rolling per-reason post-mortem dump; never raises (a failing
        post-mortem must not compound the incident it documents)."""
        if self._ring is None or not directory:
            return None
        slug = _REASON_RE.sub("_", reason).strip("_") or "fault"
        path = os.path.join(
            directory, f"postmortem_{self.component}_{slug}.jsonl")
        try:
            return self.dump(path, reason)
        except Exception:  # noqa: BLE001 — diagnostics must not mask faults
            return None

    @staticmethod
    def load(path: str) -> Tuple[dict, List[dict]]:
        """Read a dump back: ``(meta, [event dicts])``."""
        meta: dict = {}
        events: List[dict] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if "meta" in rec and not events and not meta:
                    meta = rec["meta"]
                else:
                    events.append(rec)
        return meta, events
