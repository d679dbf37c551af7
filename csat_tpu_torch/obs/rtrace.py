"""Request-scoped tracing: one trace per submitted request, spans for
every lifecycle phase.

A copy of the JAX package's ``obs/rtrace.py`` (which imports no JAX; the
port imports nothing of that package).  The flight recorder
(``obs/events.py``) answers "what did the ENGINE do recently"; this module
answers "where did THIS request spend its time".  Every
``ServeEngine.submit`` mints (or adopts) a trace id; the engine records
spans for queue wait, admission, per-bucket prefill (or the prefix-cache
attach), the decode segment, brownout capping and the terminal retirement.
:meth:`Tracer.reopen` lets a caller that resubmits a retired request make
the retry an attempt-numbered continuation of the SAME trace.

Discipline (same contract as the rest of ``obs/``):

* **Host-side only** — timestamps come from the caller (the engine's
  injectable clock), never from a device read; tracing adds zero syncs.
* **Bounded memory** — at most ``capacity`` finished traces (newest
  kept) plus a ``slowest``-sized high-water set that survives ring
  eviction, a per-trace span cap, and a bounded active table; overflow
  increments drop counters instead of growing.
* **Cheap off switch** — ``capacity=0`` makes every method a no-op and
  :meth:`begin` mint ``""``; callers guard span calls on the request's
  (then empty) trace id, so the disabled path does no per-request work.

Trace records and spans are plain public-attribute objects; consumers read
them via :meth:`Tracer.slowest` / :meth:`Tracer.dump` (JSONL, read back by
:func:`load_traces`).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
from collections import deque
from typing import Any, Deque, Dict, List, Optional

__all__ = ["Tracer", "TraceRecord", "TraceSpan", "load_traces"]

# per-trace span cap: a runaway instrumentation loop degrades to a drop
# counter on that trace, never unbounded growth
MAX_SPANS_PER_TRACE = 64

# active-table headroom over the finished ring: in-flight traces are
# bounded by queue + slots in practice, but a caller that begins traces
# and never finishes them must not leak
ACTIVE_HEADROOM = 4


@dataclasses.dataclass
class TraceSpan:
    """One timed (or instant, ``dur == 0``) phase inside a trace."""

    name: str
    t0: float
    dur: float = 0.0
    attempt: int = 1
    fields: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name, "t0": round(self.t0, 6),
                             "dur": round(self.dur, 6),
                             "attempt": self.attempt}
        if self.fields:
            d.update(self.fields)
        return d


@dataclasses.dataclass
class TraceRecord:
    """One request's whole story; ``status`` is set exactly once at
    :meth:`Tracer.finish` (the exactly-one-terminal trace invariant)."""

    trace_id: str
    t0: float
    spans: List[TraceSpan] = dataclasses.field(default_factory=list)
    attempt: int = 1          # current attempt; bumped by Tracer.reopen
    status: str = ""          # terminal RequestStatus; "" while active
    end_t: Optional[float] = None
    finishes: int = 0         # terminal transitions (invariant: exactly 1)
    dropped_spans: int = 0

    @property
    def dur(self) -> float:
        return (self.end_t - self.t0) if self.end_t is not None else 0.0

    def add_span(self, span: TraceSpan) -> None:
        if len(self.spans) >= MAX_SPANS_PER_TRACE:
            self.dropped_spans += 1
            return
        self.spans.append(span)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "trace_id": self.trace_id,
            "t0": round(self.t0, 6),
            "dur": round(self.dur, 6),
            "status": self.status,
            "attempt": self.attempt,
            "spans": [s.to_dict() for s in self.spans],
        }
        if self.dropped_spans:
            d["dropped_spans"] = self.dropped_spans
        return d


class Tracer:
    """Bounded store of request traces; the engine/fleet write side.

    All timestamps are caller-supplied so the tracer lives in whatever
    clock domain its engine does (virtual clocks in the chaos drills,
    monotonic wall time in production) — it never reads a clock itself.
    """

    def __init__(self, capacity: int = 256, slowest: int = 8,
                 component: str = "serve"):
        self.capacity = max(int(capacity), 0)
        self.n_slowest = max(int(slowest), 0)
        self.component = component
        self.active: Dict[str, TraceRecord] = {}
        self.finished: Deque[TraceRecord] = deque(maxlen=max(self.capacity, 1))
        self.slow: List[TraceRecord] = []  # high-water set, eviction-proof
        self.minted = 0
        self.completed = 0
        self.dropped = 0          # active-table evictions
        self.reopened = 0
        # id prefix: distinct per tracer instance so fleet-level ids never
        # collide with a stray engine-minted id in merged artifacts
        self._prefix = f"{component[:1]}{os.getpid() & 0xFFFF:04x}"
        self._seq = itertools.count(1)

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    # ---------------- write side ----------------

    def begin(self, trace_id: Optional[str] = None, t: float = 0.0,
              **fields: Any) -> str:
        """Mint a new trace (or adopt ``trace_id``) and return its id.

        Idempotent on an already-active id: the fleet mints before
        routing, then the replica engine's submit calls ``begin`` with
        the inherited id — the second call is a no-op returning the same
        id, so both layers share one record.  Disabled tracers return
        ``""`` (callers guard span calls on the request's trace id).
        """
        if not self.enabled:
            return ""
        if trace_id and trace_id in self.active:
            return trace_id
        tid = trace_id or f"{self._prefix}-{next(self._seq):06x}"
        rec = TraceRecord(trace_id=tid, t0=t)
        rec.add_span(TraceSpan("submit", t, fields=dict(fields) or None))
        self._admit(rec)
        self.minted += 1
        return tid

    def event(self, trace_id: str, name: str, t: float = 0.0,
              **fields: Any) -> None:
        """Instant span (``dur=0``) on an active trace; no-op otherwise."""
        rec = self.active.get(trace_id)
        if rec is None:
            return
        rec.add_span(TraceSpan(name, t, attempt=rec.attempt,
                               fields=dict(fields) or None))

    def span_from(self, trace_id: str, name: str, t0: float, t1: float,
                  **fields: Any) -> None:
        """Timed span ``[t0, t1]`` on an active trace; no-op otherwise."""
        rec = self.active.get(trace_id)
        if rec is None:
            return
        rec.add_span(TraceSpan(name, t0, dur=max(t1 - t0, 0.0),
                               attempt=rec.attempt,
                               fields=dict(fields) or None))

    def finish(self, trace_id: str, status: str, t: float = 0.0,
               **fields: Any) -> None:
        """Terminal transition: move active → finished, stamp status.

        Double-finish on the same active record is impossible (the record
        leaves the active table); a finish for an unknown id is ignored.
        """
        rec = self.active.pop(trace_id, None)
        if rec is None:
            return
        rec.status = str(status)
        rec.end_t = t
        rec.finishes += 1
        rec.add_span(TraceSpan("terminal", t, attempt=rec.attempt,
                               fields={"status": rec.status,
                                       **fields} if fields
                               else {"status": rec.status}))
        self.completed += 1
        self._retain(rec)

    def reopen(self, trace_id: str, attempt: int, t: float = 0.0,
               **fields: Any) -> bool:
        """Fleet resubmission: pull a finished trace back to active so the
        retry becomes attempt ``attempt`` of the SAME trace.

        The replica engine already ran its terminal funnel (SHED on
        retirement) before the fleet schedules the retry, so the record
        is in the finished store; reopening clears the provisional
        terminal state.  Returns False (and starts a fresh record under
        the same id, preserving continuity of ids if not of spans) when
        the record was already evicted from the bounded ring.
        """
        if not self.enabled:
            return False
        rec = self._take_finished(trace_id)
        found = rec is not None
        if rec is None:
            rec = TraceRecord(trace_id=trace_id, t0=t)
            self.minted += 1
        else:
            self.completed -= 1
            rec.status = ""
            rec.end_t = None
        rec.attempt = max(int(attempt), rec.attempt + 1)
        rec.add_span(TraceSpan("retry", t, attempt=rec.attempt,
                               fields=dict(fields) or None))
        self._admit(rec)
        self.reopened += 1
        return found

    # ---------------- read side ----------------

    def slowest(self, n: int = 0) -> List[TraceRecord]:
        """The ``n`` (default: the configured ``slowest``) longest finished
        traces, newest-window ring ∪ high-water set, longest first."""
        n = n or self.n_slowest or 8
        seen = {id(rec): rec for rec in
                itertools.chain(self.slow, self.finished)}
        out = sorted(seen.values(), key=lambda r: r.dur, reverse=True)
        return out[:n]

    def recent(self, n: int = 0) -> List[TraceRecord]:
        """Newest ``n`` finished traces, newest first."""
        out = list(self.finished)[::-1]
        return out[: n or len(out)]

    def finished_count(self, trace_id: str) -> int:
        """How many retained finished records carry ``trace_id`` — the
        exactly-one-terminal-trace test hook (reopen consumes the
        provisional record, so a resubmitted request still counts 1)."""
        seen = {id(rec): rec for rec in
                itertools.chain(self.finished, self.slow)}
        return sum(1 for rec in seen.values() if rec.trace_id == trace_id)

    def summary(self) -> Dict[str, int]:
        return {"traces_minted": self.minted,
                "traces_completed": self.completed,
                "traces_reopened": self.reopened,
                "traces_active": len(self.active),
                "traces_dropped": self.dropped}

    def dump(self, path: str) -> str:
        """Write finished traces (slowest-first union, then the active
        stragglers) as JSONL: a ``{"meta": ...}`` header then one record
        per line — the artifact ``obs_report --traces`` and ``serve_top``
        read."""
        records = self.slowest(n=max(self.capacity, self.n_slowest))
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps({"meta": {"component": self.component,
                                         **self.summary()}}) + "\n")
            for rec in records:
                f.write(json.dumps(rec.to_dict()) + "\n")
            for rec in self.active.values():
                f.write(json.dumps(rec.to_dict()) + "\n")
        return path

    # ---------------- internals ----------------

    def _admit(self, rec: TraceRecord) -> None:
        bound = max(self.capacity * ACTIVE_HEADROOM, 64)
        while len(self.active) >= bound:
            # evict the oldest in-flight trace (insertion-ordered dict)
            victim = next(iter(self.active))
            del self.active[victim]
            self.dropped += 1
        self.active[rec.trace_id] = rec

    def _retain(self, rec: TraceRecord) -> None:
        self.finished.append(rec)
        if self.n_slowest:
            self.slow.append(rec)
            self.slow.sort(key=lambda r: r.dur, reverse=True)
            del self.slow[self.n_slowest:]

    def _take_finished(self, trace_id: str) -> Optional[TraceRecord]:
        """Remove and return the newest finished record for ``trace_id``
        from both retention structures."""
        rec = None
        for cand in reversed(self.finished):
            if cand.trace_id == trace_id:
                rec = cand
                break
        if rec is not None:
            self.finished.remove(rec)
        for i, cand in enumerate(self.slow):
            if cand.trace_id == trace_id and (rec is None or cand is rec):
                if rec is None:
                    rec = cand
                del self.slow[i]
                break
        return rec


def load_traces(path: str) -> List[Dict[str, Any]]:
    """Parse a :meth:`Tracer.dump` artifact → list of trace dicts
    (meta header skipped); tolerant of truncated trailing lines."""
    out: List[Dict[str, Any]] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "meta" in rec and "trace_id" not in rec:
                continue
            out.append(rec)
    return out
