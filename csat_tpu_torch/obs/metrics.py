"""Typed metrics registry: counters, gauges, histograms.

A copy of the JAX package's ``obs/metrics.py`` (which imports no JAX, but the
port imports nothing of that package): the Trainer owns one registry, which
backs its ``history`` counters.  Two export surfaces, both machine-readable:

* :meth:`MetricsRegistry.prometheus` — Prometheus text exposition
  (``# HELP`` / ``# TYPE`` / samples; histograms expose cumulative
  ``_bucket{le=...}`` series plus ``_sum``/``_count``), byte for byte the
  JAX package's for the same calls;
* :meth:`MetricsRegistry.snapshot` + :class:`MetricsFile` — flat JSONL
  snapshots appended at a bounded cadence (``cfg.obs_metrics_file``).

Everything here is host-side plain Python — no device traffic; a metric
update is one attribute store, so the train step can update unconditionally.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "MetricsFile",
    "DEFAULT_BUCKETS", "merge_histograms",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

# latency-oriented default buckets (seconds), roughly log-spaced
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0)


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integers without a trailing ``.0`` so
    counters read naturally; floats via repr (shortest round-trip)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Counter:
    """Monotonic by convention; ``value`` is directly assignable (the trainer
    sets ``train_quarantined_total`` from the error budget's count)."""

    kind = "counter"
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: Union[int, float] = 0

    def inc(self, n: Union[int, float] = 1) -> None:
        self.value += n

    def samples(self) -> List[Tuple[str, Union[int, float]]]:
        return [(self.name, self.value)]


class Gauge:
    kind = "gauge"
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: Union[int, float] = 0

    def set(self, v: Union[int, float]) -> None:
        self.value = v

    def inc(self, n: Union[int, float] = 1) -> None:
        self.value += n

    def samples(self) -> List[Tuple[str, Union[int, float]]]:
        return [(self.name, self.value)]


# global recency stamp for histogram exemplars: lets merge_histograms
# keep the newest trace id per bucket without reading any clock
_EXEMPLAR_SEQ = iter(range(1, 1 << 62)).__next__


class Histogram:
    """Fixed-bucket histogram with Prometheus cumulative-``le`` exposition.

    ``observe`` is two int adds and a bisect — cheap enough for per-request
    latency recording.  An optional *exemplar* (a request trace id) is
    retained per bucket — newest wins — so
    "p95 regressed" jumps straight to a concrete trace; exemplars ride the
    JSONL snapshot (only when present) and never change the byte-stable
    Prometheus exposition."""

    kind = "histogram"
    __slots__ = ("name", "help", "buckets", "counts", "sum", "count",
                 "exemplars")

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets: Tuple[float, ...] = tuple(sorted(float(b) for b in buckets))
        assert self.buckets, "histogram needs at least one finite bucket"
        # per-bucket NON-cumulative counts; the +Inf overflow is the last slot
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0
        # lazily allocated [(exemplar_id, value, seq) | None] per bucket —
        # None until the first exemplar so plain histograms pay nothing
        self.exemplars: Optional[List[Optional[Tuple[str, float, int]]]] = None

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        i = bisect.bisect_left(self.buckets, v)
        self.counts[i] += 1
        self.sum += v
        self.count += 1
        if exemplar:
            if self.exemplars is None:
                self.exemplars = [None] * len(self.counts)
            self.exemplars[i] = (exemplar, v, _EXEMPLAR_SEQ())

    def exemplar_items(self) -> List[Tuple[str, str, float]]:
        """``(le_label, exemplar_id, observed_value)`` per populated bucket
        (``le`` formatted like the exposition labels; overflow = "+Inf")."""
        if self.exemplars is None:
            return []
        labels = [_fmt(b) for b in self.buckets] + ["+Inf"]
        return [(labels[i], ex[0], ex[1])
                for i, ex in enumerate(self.exemplars) if ex is not None]

    def samples(self) -> List[Tuple[str, Union[int, float]]]:
        out: List[Tuple[str, Union[int, float]]] = []
        cum = 0
        for le, c in zip(self.buckets, self.counts):
            cum += c
            out.append((f'{self.name}_bucket{{le="{_fmt(le)}"}}', cum))
        out.append((f'{self.name}_bucket{{le="+Inf"}}', self.count))
        out.append((f"{self.name}_sum", self.sum))
        out.append((f"{self.name}_count", self.count))
        return out

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile estimate from the bucket counts: the upper
        bound of the bucket holding rank ``ceil(q/100 * count)`` (overflow
        observations report the last finite bound).  Coarser than exact
        percentiles but — unlike percentiles — histograms MERGE across
        replicas, so this is the fleet-correct aggregate (``q`` in
        percent).  0.0 on an empty histogram."""
        if not self.count:
            return 0.0
        rank = max(1, -(-int(q) * self.count // 100))  # ceil without float
        cum = 0
        for le, c in zip(self.buckets, self.counts):
            cum += c
            if cum >= rank:
                return float(le)
        return float(self.buckets[-1])


class MetricsRegistry:
    """Get-or-create registry keyed by metric name (registration order is
    exposition order, so output is deterministic)."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram]] = {}

    def _get(self, cls, name: str, help: str, **kw):
        assert _NAME_RE.match(name), f"invalid metric name {name!r}"
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[Union[Counter, Gauge, Histogram]]:
        """Registered metric by exposition name, or None — the read-only
        lookup external consumers use instead of the
        get-or-create constructors (which would register phantom series)."""
        return self._metrics.get(name)

    def __iter__(self):
        return iter(self._metrics.values())

    def prometheus(self, labels: Optional[Dict[str, str]] = None,
                   prefix: str = "") -> str:
        """Prometheus text exposition (version 0.0.4).

        ``labels`` are injected into every sample (merged into the existing
        ``{le=...}`` braces on histogram buckets) — how a fleet scrapes N
        identical per-replica registries under ``replica="k"`` without the
        series colliding.  ``prefix`` prepends to every metric name."""
        assert not prefix or _NAME_RE.match(prefix), f"bad prefix {prefix!r}"
        lbl = ",".join(f'{k}="{v}"' for k, v in (labels or {}).items())
        lines: List[str] = []
        for m in self._metrics.values():
            if m.help:
                lines.append(f"# HELP {prefix}{m.name} {m.help}")
            lines.append(f"# TYPE {prefix}{m.name} {m.kind}")
            for sample, value in m.samples():
                sample = prefix + sample
                if lbl:
                    if "{" in sample:
                        head, rest = sample.split("{", 1)
                        sample = f"{head}{{{lbl},{rest}"
                    else:
                        sample = f"{sample}{{{lbl}}}"
                lines.append(f"{sample} {_fmt(value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self, prefix: str = "") -> Dict[str, float]:
        """Flat name→value dict (histograms contribute ``_sum``/``_count``
        only — buckets stay a Prometheus concern) for JSONL streaming.
        ``prefix`` namespaces the keys (per-replica fleet snapshots)."""
        out: Dict[str, float] = {}
        for m in self._metrics.values():
            if isinstance(m, Histogram):
                out[f"{prefix}{m.name}_sum"] = round(m.sum, 6)
                out[f"{prefix}{m.name}_count"] = m.count
                if m.exemplars is not None:
                    # only when traced requests actually landed — plain
                    # histograms keep the pinned two-key snapshot shape
                    out[f"{prefix}{m.name}_exemplars"] = {
                        le: [ex, round(val, 6)]
                        for le, ex, val in m.exemplar_items()}
            else:
                v = m.value
                out[f"{prefix}{m.name}"] = (
                    round(v, 6) if isinstance(v, float) else v)
        return out


def merge_histograms(hists: Sequence[Histogram], name: str = "",
                     help: str = "") -> Histogram:
    """One histogram whose buckets/counts/sum are the element-wise sum of
    ``hists`` (which must share identical bucket bounds) — the correct way
    to aggregate latency across fleet replicas: quantiles of the MERGED
    distribution, never an average of per-replica percentiles (averaging
    p95s underweights the replica actually taking the traffic)."""
    hists = list(hists)
    assert hists, "merge_histograms needs at least one histogram"
    buckets = hists[0].buckets
    for h in hists[1:]:
        assert h.buckets == buckets, (
            f"bucket mismatch: {h.name} {h.buckets} vs {buckets}")
    out = Histogram(name or hists[0].name, help or hists[0].help, buckets)
    for h in hists:
        for i, c in enumerate(h.counts):
            out.counts[i] += c
        out.sum += h.sum
        out.count += h.count
        if h.exemplars is not None:
            if out.exemplars is None:
                out.exemplars = [None] * len(out.counts)
            for i, ex in enumerate(h.exemplars):
                # newest exemplar per bucket wins across replicas
                if ex is not None and (out.exemplars[i] is None
                                       or ex[2] > out.exemplars[i][2]):
                    out.exemplars[i] = ex
    return out


class MetricsFile:
    """Periodic JSONL snapshot appender.

    ``maybe_write`` is called opportunistically from a training loop and
    only touches the filesystem once per ``every_s`` window (or when forced
    — the epoch boundary writes unconditionally).  The registry is looked
    up through a callable so a caller whose registry is replaced mid-run
    always snapshots the live one."""

    def __init__(self, path: str,
                 registry: Union[MetricsRegistry, Callable[[], MetricsRegistry]],
                 every_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.path = path
        self._registry = registry if callable(registry) else (lambda: registry)
        self.every_s = float(every_s)
        self._clock = clock
        self._last = -float("inf")
        self.written = 0

    def maybe_write(self, extra: Optional[Dict] = None, force: bool = False) -> bool:
        now = self._clock()
        if not force and now - self._last < self.every_s:
            return False
        self._last = now
        rec = {"t": round(time.time(), 3), **self._registry().snapshot()}
        if extra:
            rec.update(extra)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        self.written += 1
        return True
