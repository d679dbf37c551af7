"""Declarative SLOs and multi-window burn-rate alerting — the JAX package's
``obs/slo.py`` for the port (``tests/test_torch_imports.py`` holds every
definition to the original's).

An :class:`Objective` declares what "good" means (availability, or
per-priority-class latency under a threshold); :class:`SLOEngine`
re-derives good / total counts from the metrics registry the serving stack
already keeps, on every :meth:`SLOEngine.step` — a pure reader, no new
instrumentation in the hot path, no tensor touched:

* **availability** — ``serve_requests_ok_total`` over all terminal
  outcomes (ok + failed + timeout + rejected + shed);
* **latency** — the per-class OK-latency histograms
  (``serve_class<p>_latency_seconds``); good = observations in buckets at
  or under the objective's threshold.

Burn rate follows the multi-window SRE pattern: with error budget
``1 - target``, ``burn = error_rate / (1 - target)`` over a window (burn
1.0 = spending the budget exactly on schedule).  An alert fires only when
both the fast window (sensitive, catches the spike) and the slow window
(stubborn, rejects blips) exceed their thresholds; it clears when either
drops back under.  Transitions are observe-only ``slo.alert`` / ``slo.ok``
events in the flight recorder; they change no scheduling decision.

Counts are cumulative, so windowed rates difference two registry samples;
the engine keeps a bounded deque of ``(t, good, total)`` per objective and
re-anchors the window when a registry is reset (a negative delta).
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import deque
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

from csat_tpu_torch.obs.metrics import Histogram, MetricsRegistry

__all__ = ["Objective", "SLOEngine", "objectives_from_config",
           "CLASS_LATENCY_METRIC"]

# per-priority-class OK-latency histogram name (written by ServeStats)
CLASS_LATENCY_METRIC = "serve_class{p}_latency_seconds"

# terminal-outcome counters (stats.py _METRICS exposition names)
_OK = "serve_requests_ok_total"
_BAD = ("serve_requests_failed_total", "serve_requests_timeout_total",
        "serve_requests_rejected_total", "serve_requests_shed_total")

# bounded per-objective sample history: sized for the slow window at a
# sub-second step cadence; prune keeps it tight regardless
_MAX_SAMPLES = 4096


@dataclasses.dataclass(frozen=True)
class Objective:
    """One service-level objective.

    ``kind="availability"``: ``target`` fraction of terminal requests OK.
    ``kind="latency"``: ``target`` fraction of class-``priority`` OK
    requests under ``latency_s`` seconds.
    """

    name: str
    kind: str
    target: float
    latency_s: float = 0.0
    priority: int = 0

    def __post_init__(self) -> None:
        assert self.kind in ("availability", "latency"), self.kind
        assert 0.0 < self.target < 1.0, self.target
        if self.kind == "latency":
            assert self.latency_s > 0, self.latency_s
            assert self.priority >= 0, self.priority


class _State:
    """Per-objective burn bookkeeping (internal to SLOEngine)."""

    def __init__(self) -> None:
        self.samples: Deque[Tuple[float, float, float]] = deque(
            maxlen=_MAX_SAMPLES)
        self.firing = False
        self.fired = 0
        self.burn_fast = 0.0
        self.burn_slow = 0.0


class SLOEngine:
    """Computes burn rates from live registries; call :meth:`step`
    periodically (serve loop, chaos loop, or the bench).

    ``source``: a zero-arg callable returning the registries to sum
    over (one per healthy replica for a fleet), a single registry, or a
    static sequence of them.  ``recorder``: an ``EventRecorder`` for the
    alert/clear events (optional).  ``gauges``: a registry that receives
    ``slo_burn_*`` / ``slo_alert_*`` gauges for the scrape surface →
    metrics JSONL → ``top`` (optional).
    """

    def __init__(self, source: Any, objectives: Sequence[Objective],
                 recorder: Any = None, fast_s: float = 60.0,
                 slow_s: float = 300.0, burn_fast: float = 14.0,
                 burn_slow: float = 6.0,
                 clock: Callable[[], float] = time.monotonic,
                 gauges: Optional[MetricsRegistry] = None):
        assert objectives, "SLOEngine needs at least one objective"
        assert fast_s > 0 and slow_s >= fast_s, (fast_s, slow_s)
        self.source = source
        self.objectives = tuple(objectives)
        self.recorder = recorder
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self.burn_fast_threshold = float(burn_fast)
        self.burn_slow_threshold = float(burn_slow)
        self.clock = clock
        self.gauges = gauges
        self.steps = 0
        self._state: Dict[str, _State] = {o.name: _State()
                                          for o in self.objectives}

    # ---------------- constructors ----------------

    @classmethod
    def for_target(cls, target: Any, cfg: Any, recorder: Any = None,
                   objectives: Optional[Sequence[Objective]] = None,
                   ) -> "SLOEngine":
        """Wire an engine-or-fleet target from its config: objectives
        from the ``slo_*`` knobs, alert events into the target's own
        flight recorder, burn gauges onto its scrape registry."""
        if hasattr(target, "replicas"):  # Fleet
            def source() -> List[MetricsRegistry]:
                return [rep.engine.stats.registry
                        for rep in target.replicas if not rep.closed]
            gauges = target.registry
        else:  # single ServeEngine
            def source() -> List[MetricsRegistry]:
                return [target.stats.registry]
            gauges = target.stats.registry
        return cls(source,
                   objectives or objectives_from_config(cfg),
                   recorder=recorder if recorder is not None else target.obs,
                   fast_s=cfg.slo_fast_window_s, slow_s=cfg.slo_slow_window_s,
                   burn_fast=cfg.slo_burn_fast, burn_slow=cfg.slo_burn_slow,
                   clock=target.clock, gauges=gauges)

    # ---------------- the evaluation step ----------------

    def step(self) -> List[Dict[str, Any]]:
        """Sample every objective, update burns, emit alert transitions.
        Returns the transitions taken this step (usually empty)."""
        now = self.clock()
        regs = self._registries()
        out: List[Dict[str, Any]] = []
        for obj in self.objectives:
            st = self._state[obj.name]
            good, total = self._good_total(obj, regs)
            if st.samples and total < st.samples[-1][2]:
                st.samples.clear()  # registry reset → re-anchor
            st.samples.append((now, good, total))
            while st.samples and now - st.samples[0][0] > 2 * self.slow_s:
                st.samples.popleft()
            st.burn_fast = self._burn(st, obj, now, self.fast_s)
            st.burn_slow = self._burn(st, obj, now, self.slow_s)
            firing = (st.burn_fast >= self.burn_fast_threshold
                      and st.burn_slow >= self.burn_slow_threshold)
            if firing and not st.firing:
                st.firing = True
                st.fired += 1
                info = {"objective": obj.name, "kind": obj.kind,
                        "target": obj.target,
                        "burn_fast": round(st.burn_fast, 2),
                        "burn_slow": round(st.burn_slow, 2)}
                if self.recorder is not None:
                    self.recorder.emit("slo.alert", **info)
                out.append({"state": "alert", **info})
            elif st.firing and not firing:
                st.firing = False
                info = {"objective": obj.name,
                        "burn_fast": round(st.burn_fast, 2),
                        "burn_slow": round(st.burn_slow, 2)}
                if self.recorder is not None:
                    self.recorder.emit("slo.ok", **info)
                out.append({"state": "ok", **info})
            if self.gauges is not None:
                self.gauges.gauge(
                    f"slo_burn_fast_{obj.name}",
                    "fast-window SLO burn rate").set(round(st.burn_fast, 3))
                self.gauges.gauge(
                    f"slo_burn_slow_{obj.name}",
                    "slow-window SLO burn rate").set(round(st.burn_slow, 3))
                self.gauges.gauge(
                    f"slo_alert_{obj.name}",
                    "1 while the SLO alert is firing").set(
                        1 if st.firing else 0)
        self.steps += 1
        return out

    # ---------------- read side ----------------

    @property
    def alerts(self) -> Dict[str, Dict[str, float]]:
        """Currently-firing objectives → burn snapshot."""
        return {name: {"burn_fast": round(st.burn_fast, 2),
                       "burn_slow": round(st.burn_slow, 2)}
                for name, st in self._state.items() if st.firing}

    @property
    def fired(self) -> Dict[str, int]:
        """Objective → total alert activations (the bench/chaos record)."""
        return {name: st.fired for name, st in self._state.items()}

    def burns(self) -> Dict[str, Tuple[float, float]]:
        return {name: (round(st.burn_fast, 3), round(st.burn_slow, 3))
                for name, st in self._state.items()}

    def summary(self) -> Dict[str, Any]:
        """Flat dict for heartbeat lines / metrics ``extra`` payloads."""
        out: Dict[str, Any] = {"slo_steps": self.steps,
                               "slo_alerts_active": len(self.alerts)}
        for name, st in self._state.items():
            out[f"slo_burn_fast_{name}"] = round(st.burn_fast, 3)
            out[f"slo_burn_slow_{name}"] = round(st.burn_slow, 3)
            out[f"slo_alert_{name}"] = 1 if st.firing else 0
            out[f"slo_fired_{name}"] = st.fired
        return out

    # ---------------- internals ----------------

    def _registries(self) -> List[MetricsRegistry]:
        src = self.source() if callable(self.source) else self.source
        if isinstance(src, MetricsRegistry):
            return [src]
        return list(src)

    def _good_total(self, obj: Objective,
                    regs: Sequence[MetricsRegistry]) -> Tuple[float, float]:
        good = total = 0.0
        if obj.kind == "availability":
            for reg in regs:
                ok = reg.get(_OK)
                ok_v = float(ok.value) if ok is not None else 0.0
                bad_v = 0.0
                for name in _BAD:
                    m = reg.get(name)
                    if m is not None:
                        bad_v += float(m.value)
                good += ok_v
                total += ok_v + bad_v
            return good, total
        name = CLASS_LATENCY_METRIC.format(p=obj.priority)
        for reg in regs:
            h = reg.get(name)
            if not isinstance(h, Histogram):
                continue
            # buckets are upper bounds: observations ≤ latency_s live in
            # counts[0 : bisect_right]; the overflow bucket is never good
            k = bisect.bisect_right(h.buckets, obj.latency_s)
            good += float(sum(h.counts[:k]))
            total += float(h.count)
        return good, total

    def _burn(self, st: _State, obj: Objective, now: float,
              window_s: float) -> float:
        """Error-budget burn over the trailing ``window_s``.  The baseline
        is the newest sample at least ``window_s`` old (falling back to
        the oldest sample while the history is still shorter than the
        window, so early overload is visible, just over a shorter span)."""
        if len(st.samples) < 2:
            return 0.0
        cutoff = now - window_s
        base = st.samples[0]
        for s in reversed(st.samples):
            if s[0] <= cutoff:
                base = s
                break
        d_good = st.samples[-1][1] - base[1]
        d_total = st.samples[-1][2] - base[2]
        if d_total <= 0:
            return 0.0
        err = max(0.0, min(1.0, (d_total - d_good) / d_total))
        budget = 1.0 - obj.target
        return err / budget if budget > 0 else 0.0


def objectives_from_config(cfg: Any) -> List[Objective]:
    """``slo_*`` knobs → objectives: one availability target plus one
    latency objective per priority class (``slo_latency_s`` entry ``p``
    applies to class ``p``; a shorter tuple reuses its last entry for
    the remaining classes; empty = no latency objectives)."""
    out = [Objective(name="availability", kind="availability",
                     target=cfg.slo_availability)]
    lats: Tuple[float, ...] = tuple(cfg.slo_latency_s)
    if lats:
        for p in range(int(cfg.serve_priority_classes)):
            thr = lats[min(p, len(lats) - 1)]
            out.append(Objective(name=f"latency_class{p}", kind="latency",
                                 target=cfg.slo_latency_target,
                                 latency_s=float(thr), priority=p))
    return out
