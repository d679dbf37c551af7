"""Chrome/Perfetto trace-event export for the flight recorder.

The port's copy of the JAX package's ``obs/trace.py``.  Host-side phase
spans (train-step phases) become complete ``"X"`` trace events and lifecycle
markers become instant ``"i"`` events in the Trace Event JSON format
(``{"traceEvents": [...]}``) that chrome://tracing and ui.perfetto.dev load
directly.  Span names group into pseudo-threads by their dot prefix
(``train.data`` → thread ``train``), so phases and resilience events render
as parallel tracks.

Alignment with device traces: during a profiled epoch the spans are also
bracketed with ``torch.profiler.record_function`` (``Span(annotate=True)``),
so the same phase names appear inside the ``torch.profiler`` trace and the
exported host timeline can be read against the device one.

:func:`validate_chrome_trace` is the schema contract the tests pin:
events sorted by ``ts``, ``"X"`` events carry a non-negative ``dur``,
``"B"``/``"E"`` events nest and match per ``(pid, tid)``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Union

from csat_tpu_torch.obs.events import EventRecorder, EventTuple

__all__ = [
    "to_chrome_events", "write_chrome_trace", "validate_chrome_trace",
    "load_chrome_trace",
]

_PHASES = {"X", "B", "E", "i", "I", "M", "C"}


def _tid_of(name: str, tids: Dict[str, int]) -> int:
    group = name.split(".", 1)[0]
    if group not in tids:
        tids[group] = len(tids) + 1
    return tids[group]


def to_chrome_events(events: Sequence[EventTuple], pid: int = 1,
                     process_name: str = "host") -> List[dict]:
    """Recorder event tuples → trace-event dicts (ts/dur in microseconds,
    rebased to the earliest event; sorted by ts; metadata events first)."""
    if not events:
        return []
    t0 = min(e[0] for e in events)
    tids: Dict[str, int] = {}
    out: List[dict] = []
    for ts, name, dur, fields in events:
        ev = {
            "name": name,
            "cat": name.split(".", 1)[0],
            "ph": "X" if dur else "i",
            "ts": round((ts - t0) * 1e6, 3),
            "pid": pid,
            "tid": _tid_of(name, tids),
        }
        if dur:
            ev["dur"] = round(dur * 1e6, 3)
        else:
            ev["s"] = "t"  # instant scope: thread
        if fields:
            ev["args"] = fields
        out.append(ev)
    out.sort(key=lambda e: e["ts"])
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": process_name}}]
    meta += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
              "args": {"name": group}} for group, tid in sorted(
                  tids.items(), key=lambda kv: kv[1])]
    return meta + out


def write_chrome_trace(path: str,
                       source: Union[EventRecorder, Sequence[EventTuple]],
                       process_name: Optional[str] = None) -> str:
    """Export a recorder (or raw event tuples) as a Chrome trace JSON file."""
    if isinstance(source, EventRecorder):
        events = source.events()
        process_name = process_name or source.component
    else:
        events = list(source)
    obj = {
        "traceEvents": to_chrome_events(
            events, process_name=process_name or "host"),
        "displayTimeUnit": "ms",
    }
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


def load_chrome_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def validate_chrome_trace(obj: Union[dict, list]) -> List[str]:
    """Schema check for trace-event JSON; returns a list of violations
    (empty = valid).  Accepts the object form (``{"traceEvents": [...]}``)
    or the bare array form."""
    errors: List[str] = []
    events = obj.get("traceEvents") if isinstance(obj, dict) else obj
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    last_ts: Dict[int, float] = {}  # per-pid ts ordering for timed events
    stacks: Dict[tuple, List[str]] = {}  # (pid, tid) → open B names
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        name = ev.get("name")
        if not isinstance(name, str) or not name:
            errors.append(f"event {i}: missing name")
        if ph not in _PHASES:
            errors.append(f"event {i} ({name}): bad ph {ph!r}")
            continue
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {i} ({name}): bad ts {ts!r}")
            continue
        pid = ev.get("pid", 0)
        if ts < last_ts.get(pid, float("-inf")):
            errors.append(f"event {i} ({name}): ts not sorted")
        last_ts[pid] = ts
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i} ({name}): X without dur >= 0")
        elif ph == "B":
            stacks.setdefault((pid, ev.get("tid", 0)), []).append(name)
        elif ph == "E":
            stack = stacks.setdefault((pid, ev.get("tid", 0)), [])
            if not stack:
                errors.append(f"event {i} ({name}): E without matching B")
            else:
                stack.pop()
    for (pid, tid), stack in stacks.items():
        if stack:
            errors.append(
                f"unclosed B events on pid={pid} tid={tid}: {stack}")
    return errors
