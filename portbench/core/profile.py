"""The traced sub-window: the profiler's device timeline, summarised.

:class:`Tracer` runs ``torch.profiler`` (CPU and CUDA activities) over a
traced segment that follows the window, turns its host spans into
``record_function`` ranges while it runs, and records each kernel launch of the port (its C entry
point, its scalar arguments and what the record's ``launch_context`` notes of
it) by wrapping the port's one launch function.
:func:`summarise` reads the raw kineto events once: every device activity
(kernels, copies, fills) as an interval, the union of those intervals (the
busy time), the gaps in it named by the innermost host span open when each
gap began, and the device time by kernel name.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["Profile", "Tracer", "summarise", "union_length", "gaps"]

WINDOW = "portbench/window"


@dataclasses.dataclass
class Profile:
    window_s: float                          # the traced sub-window
    busy_s: float                            # union of device intervals inside it
    kernels: Dict[str, Tuple[float, int]]    # device op name → (seconds, count)
    idle_gaps: List[Tuple[str, float]]       # (host span at the gap, seconds), longest first


def union_length(intervals: List[Tuple[int, int]]) -> int:
    total, end = 0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def gaps(intervals: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def _name(ev) -> str:
    return ev.name() if callable(getattr(ev, "name", None)) else ev.name


def summarise(prof) -> Optional[Profile]:
    """:class:`Profile` of a finished ``torch.profiler.profile`` whose
    window was marked by a ``portbench/window`` range; None without one."""
    events = prof.profiler.kineto_results.events()
    window = None
    device: List[Tuple[int, int, str]] = []
    spans: List[Tuple[int, int, str]] = []
    for ev in events:
        name = _name(ev)
        start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        kind = str(ev.activity_type()) if hasattr(ev, "activity_type") else ""
        if name.startswith("portbench/"):
            # the host's ranges; their copies on the device timeline only
            # span the kernels launched inside them
            if "gpu" in kind or str(ev.device_type()).endswith("CUDA"):
                continue
            if name == WINDOW:
                if window is None or end - start > window[1] - window[0]:
                    window = (start, end)
            else:
                spans.append((start, end, name[len("portbench/"):]))
        elif str(ev.device_type()).endswith("CUDA") and "annotation" not in kind:
            device.append((start, end, name))
    if window is None:
        return None
    lo, hi = window
    inside = [(max(s, lo), min(e, hi), n) for s, e, n in device if e > lo and s < hi]
    busy = union_length([(s, e) for s, e, _ in inside])
    kernels: Dict[str, Tuple[float, int]] = {}
    for s, e, n in inside:
        t, c = kernels.get(n, (0.0, 0))
        kernels[n] = (t + (e - s) * 1e-9, c + 1)
    named = []
    spans.sort(key=lambda x: x[0])
    for a, b in gaps([(s, e) for s, e, _ in inside], lo, hi):
        open_ = [sp for sp in spans if sp[0] <= a < sp[1]]
        host = max(open_, key=lambda sp: sp[0])[2] if open_ else "none"
        named.append((host, (b - a) * 1e-9))
    named.sort(key=lambda x: -x[1])
    return Profile(window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9, kernels=kernels,
                   idle_gaps=named)


class Tracer:
    """The profiler over a traced segment, with the port's launches recorded
    in ``record`` and ``spans`` (a :class:`~portbench.core.record.Spans` of
    the segment's own, apart from the window's) marked on its timeline."""

    def __init__(self, record, spans):
        self.record = record
        self.spans = spans
        self.prof = None
        self._window = None
        self._launch = None
        self.started_at = None
        # the profiler's first use initialises CUPTI (seconds): pay it
        # now, in the set-up, not inside the window
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from csat_tpu_torch.ops import build

        record = self.record
        launches = record.launches
        original = build.launch

        def launch(fn, args):
            note = record.launch_context(fn) if record.launch_context is not None else None
            launches.append((fn, tuple(a if isinstance(a, (int, float)) else None
                                       for a in args), note))
            return original(fn, args)

        self._launch = (build, original)
        build.launch = launch
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._window = record_function(WINDOW)
        self._window.__enter__()
        self.spans.annotate = True
        self.started_at = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.spans.annotate = False
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        build, original = self._launch
        build.launch = original
        self.record.profile = summarise(self.prof)
        self.prof = None
