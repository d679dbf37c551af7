"""What one run leaves for the metric readers, and the host spans it keeps.

A driver fills a :class:`Record`: the window's bounds, one entry per
training step or per request, the host spans it timed around the calls into
each layer, the program's counters it read, and — in a traced run — the
kernel launches (with what the driver noted of each, where it notes
anything) and the profiler's summary of the traced sub-window.  Each
reader (``portbench/metrics/<name>.py``) computes one number from it, or
None where the run has nothing to read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["Record", "Spans"]


class Spans:
    """Host spans: ``(name, seconds)`` totals and counts, and — while a
    profiler runs — a ``record_function`` range of the same name, so the
    profiler's timeline can say what the host was doing."""

    def __init__(self):
        self.total: Dict[str, float] = {}
        self.count: Dict[str, int] = {}
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str):
        rf = None
        if self.annotate:
            import torch

            rf = torch.profiler.record_function(f"portbench/{name}")
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if rf is not None:
                rf.__exit__(None, None, None)
            self.total[name] = self.total.get(name, 0.0) + dt
            self.count[name] = self.count.get(name, 0) + 1


@dataclasses.dataclass
class Record:
    cell: str
    model: Dict                      # the configuration file
    mix: Dict                        # the mix file
    setup_s: float = 0.0             # process start → the window opens
    window_s: float = 0.0            # the measured window, closed by a synchronize
    steps: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    requests: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    spans: Spans = dataclasses.field(default_factory=Spans)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    launches: List[Tuple[str, Tuple, Any]] = dataclasses.field(default_factory=list)
    # while tracing: C entry point → what the driver knows of that launch
    # that its arguments do not say (see ``portbench/core/counts.py``)
    launch_context: Optional[Callable[[str], Any]] = None
    profile: Optional[Any] = None    # portbench.core.profile.Profile of the traced sub-window
