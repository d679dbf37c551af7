"""Traffic zoo: seeded, serializable adversarial request traces — the JAX
package's ``serve/traffic.py`` for the port.

A copy, not an import (the port imports nothing of the JAX package): every
definition is the original's, statement for statement
(``tests/test_torch_imports.py``), and a trace's ``to_json()`` equals JAX's
byte for byte for the same spec, config shapes and vocabulary sizes.  A
trace is a pure function of ``(seed, spec)``:

* **arrival processes** — ``poisson``, ``bursty`` (a Markov ON/OFF switch
  whose ON state compresses inter-arrival gaps by ``burst_factor``) and
  ``diurnal`` (sinusoidal rate modulation);
* **multi-tenant priority classes** — each request carries a
  :class:`PriorityClass` drawn from the spec's weighted mix (priority 0 is
  the most important tier; the engine sheds and browns out the
  highest-numbered tier first);
* **adversarial mixes** — ``poison_frac`` of the trace is malformed by
  :meth:`~csat_tpu_torch.resilience.faults.FaultInjector.poison_sample`
  (every mode ``serve/ingest.validate_sample`` quarantines),
  ``duplicate_frac`` is a duplicate storm (byte-identical samples hammering
  the prefix cache), and ``length_skew`` shapes the node counts
  (``lognormal`` | ``bimodal`` | ``max_heavy``);
* **replayability** — a trace serializes to JSON (spec + per-item metadata,
  no arrays); :func:`replay` regenerates the samples and cross-checks the
  metadata.

Arrival times are in scheduler ticks (the engine / fleet ``.ticks`` clock),
as :func:`csat_tpu_torch.resilience.chaos.run_chaos` drives a trace.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from csat_tpu_torch.resilience.faults import FaultInjector

__all__ = [
    "PriorityClass", "TraceItem", "TraceSpec", "Trace",
    "DEFAULT_CLASSES", "POISON_MODES", "make_trace", "replay", "zoo_spec",
    "TRACE_ZOO",
]

ARRIVALS = ("poisson", "bursty", "diurnal")
LENGTH_SKEWS = ("uniform", "lognormal", "bimodal", "max_heavy")
# every mode ingest.validate_sample quarantines (resilience/faults.py)
POISON_MODES = ("missing_key", "oversize", "dtype", "shape")


@dataclasses.dataclass(frozen=True)
class PriorityClass:
    """One tenant tier: ``priority`` 0 is the most important (never shed
    first, never browned out); higher numbers degrade first.
    ``max_new_tokens`` overrides the spec default for the tier (0 = no
    override)."""

    name: str
    weight: float
    priority: int
    max_new_tokens: int = 0


# the canonical three-tier mix the bursty multi-tenant drills use
DEFAULT_CLASSES: Tuple[PriorityClass, ...] = (
    PriorityClass("gold", 0.2, 0),
    PriorityClass("silver", 0.3, 1),
    PriorityClass("batch", 0.5, 2),
)


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """The deterministic recipe for one trace — (seed, spec) is the whole
    identity; two calls with equal specs produce bit-identical traces."""

    name: str = "trace"
    n_requests: int = 32
    seed: int = 0
    arrival: str = "poisson"
    mean_interarrival: float = 1.0   # ticks between arrivals at base rate
    burst_factor: float = 6.0        # bursty: ON-state gap compression
    burst_dwell: float = 16.0        # bursty: mean ticks per ON/OFF dwell
    diurnal_period: float = 256.0    # diurnal: ticks per load cycle
    diurnal_amp: float = 0.8         # diurnal: rate swing in [0, 1)
    classes: Tuple[PriorityClass, ...] = ()  # empty = single class 0
    max_new_tokens: int = 8          # decode budget (0 = engine default)
    length_skew: str = "lognormal"
    min_len: int = 4
    poison_frac: float = 0.0
    duplicate_frac: float = 0.0
    duplicate_hot: int = 2           # distinct samples the storm repeats

    def __post_init__(self):
        assert self.arrival in ARRIVALS, self.arrival
        assert self.length_skew in LENGTH_SKEWS, self.length_skew
        assert self.n_requests >= 1, self.n_requests
        assert self.mean_interarrival > 0, self.mean_interarrival
        assert 0.0 <= self.poison_frac < 1.0, self.poison_frac
        assert 0.0 <= self.duplicate_frac < 1.0, self.duplicate_frac
        assert self.poison_frac + self.duplicate_frac < 1.0
        assert 0.0 <= self.diurnal_amp < 1.0, self.diurnal_amp

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["classes"] = [dataclasses.asdict(c) for c in self.classes]
        return json.dumps(d, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "TraceSpec":
        d = json.loads(s)
        d["classes"] = tuple(PriorityClass(**c) for c in d.get("classes", ()))
        return TraceSpec(**d)


@dataclasses.dataclass(frozen=True)
class TraceItem:
    """One generated request: its arrival tick, tier, budget, adversarial
    kind and the sample itself (excluded from equality/serialization — it
    is a pure function of ``sample_seed``/``n_real``/``poison_mode``)."""

    index: int
    arrival: int                 # tick ordinal (relative to trace start)
    priority: int
    pclass: str
    max_new_tokens: int
    kind: str                    # "normal" | "poison" | "duplicate"
    poison_mode: str             # poison items only ("" otherwise)
    sample_seed: int
    n_real: int
    dup_of: int                  # index of the repeated hot item (-1)
    sample: Dict[str, np.ndarray] = dataclasses.field(
        compare=False, repr=False, default=None)

    def meta(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("sample")
        return d


@dataclasses.dataclass
class Trace:
    """A realized trace: the spec plus its items in arrival order."""

    spec: TraceSpec
    items: List[TraceItem]

    def __len__(self) -> int:
        return len(self.items)

    @property
    def n_poison(self) -> int:
        return sum(1 for it in self.items if it.kind == "poison")

    @property
    def n_duplicates(self) -> int:
        return sum(1 for it in self.items if it.kind == "duplicate")

    def by_class(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for it in self.items:
            out[it.pclass] = out.get(it.pclass, 0) + 1
        return out

    def to_json(self) -> str:
        """Spec + per-item metadata (no arrays) — enough for
        :func:`replay` to regenerate and cross-check the exact trace."""
        return json.dumps({
            "spec": json.loads(self.spec.to_json()),
            "items": [it.meta() for it in self.items],
        }, sort_keys=True)


def _arrival_ticks(spec: TraceSpec, rng: np.random.Generator) -> np.ndarray:
    """Cumulative integer arrival ticks for ``n_requests`` arrivals."""
    n = spec.n_requests
    mean = spec.mean_interarrival
    if spec.arrival == "poisson":
        gaps = rng.exponential(mean, n)
    elif spec.arrival == "bursty":
        # two-state modulated arrivals: exponential dwells flip an ON/OFF
        # switch; ON compresses the mean gap by burst_factor, OFF restores
        # the base rate — arrivals inside a burst correlate tightly
        gaps = np.empty(n)
        on = bool(rng.integers(0, 2))
        dwell_left = rng.exponential(spec.burst_dwell)
        for i in range(n):
            g = rng.exponential(
                mean / spec.burst_factor if on else mean)
            gaps[i] = g
            dwell_left -= g
            while dwell_left <= 0:
                on = not on
                dwell_left += rng.exponential(spec.burst_dwell)
    else:  # diurnal: thinning via rate-modulated gap draws
        gaps = np.empty(n)
        t = 0.0
        for i in range(n):
            rate = 1.0 + spec.diurnal_amp * np.sin(
                2.0 * np.pi * t / spec.diurnal_period)
            gaps[i] = rng.exponential(mean / max(rate, 1e-3))
            t += gaps[i]
        del t
    return np.floor(np.cumsum(gaps)).astype(np.int64)


def _lengths(spec: TraceSpec, rng: np.random.Generator, max_len: int) -> np.ndarray:
    lo = max(1, min(spec.min_len, max_len))
    n = spec.n_requests
    if spec.length_skew == "uniform":
        lens = rng.integers(lo, max_len + 1, n)
    elif spec.length_skew == "lognormal":
        lens = (max_len * rng.lognormal(-1.2, 0.6, n)).astype(np.int64)
    elif spec.length_skew == "bimodal":
        tiny = rng.integers(lo, lo + 4, n)
        huge = rng.integers(max(max_len - 4, lo), max_len + 1, n)
        lens = np.where(rng.random(n) < 0.5, tiny, huge)
    else:  # max_heavy: 80% of the trace floods the top prefill bucket
        lens = np.where(rng.random(n) < 0.8, max_len,
                        rng.integers(lo, max_len + 1, n))
    return np.clip(lens, lo, max_len)


def make_trace(spec: TraceSpec, cfg, src_vocab_size: int,
               triplet_vocab_size: int) -> Trace:
    """Generate the trace — deterministic in ``(spec, cfg shapes, vocab
    sizes)``; every sample comes from
    :func:`csat_tpu_torch.data.toy.random_request_sample` under a seed derived
    from ``(spec.seed, index)``."""
    from csat_tpu_torch.data.toy import random_request_sample

    rng = np.random.default_rng(spec.seed)
    n = spec.n_requests
    arrivals = _arrival_ticks(spec, rng)
    lengths = _lengths(spec, rng, cfg.max_src_len)

    # tier assignment from the weighted class mix
    classes = spec.classes or (PriorityClass("default", 1.0, 0),)
    weights = np.array([c.weight for c in classes], float)
    weights = weights / weights.sum()
    tier_ix = rng.choice(len(classes), size=n, p=weights)

    # adversarial roles: poison and duplicate sets are disjoint, drawn
    # from the same seeded stream so the mix itself is replayable
    roles = np.array(["normal"] * n, dtype=object)
    n_poison = int(round(spec.poison_frac * n))
    n_dup = int(round(spec.duplicate_frac * n))
    perm = rng.permutation(n)
    # keep the first duplicate_hot indices normal: they are the storm's
    # hot set and must exist before anything can repeat them
    eligible = [int(i) for i in perm if i >= spec.duplicate_hot]
    for i in eligible[:n_poison]:
        roles[i] = "poison"
    for i in eligible[n_poison:n_poison + n_dup]:
        roles[i] = "duplicate"

    items: List[TraceItem] = []
    hot: List[int] = []  # indices of the duplicate storm's hot set
    for i in range(n):
        pc = classes[int(tier_ix[i])]
        budget = pc.max_new_tokens or spec.max_new_tokens
        kind = str(roles[i])
        sample_seed = spec.seed * 100_003 + i
        n_real = int(lengths[i])
        mode, dup_of = "", -1
        if kind == "duplicate" and hot:
            dup_of = hot[i % len(hot)]
            ref = items[dup_of]
            sample_seed, n_real = ref.sample_seed, ref.n_real
            sample = {k: np.array(v) for k, v in ref.sample.items()}
        else:
            if kind == "duplicate":  # hot set not built yet: degrade
                kind = "normal"
            sample = random_request_sample(
                cfg, src_vocab_size, triplet_vocab_size, n_real,
                seed=sample_seed)
            if kind == "poison":
                mode = POISON_MODES[i % len(POISON_MODES)]
                sample = FaultInjector.poison_sample(sample, mode)
            elif len(hot) < spec.duplicate_hot:
                hot.append(i)
        items.append(TraceItem(
            index=i, arrival=int(arrivals[i]), priority=pc.priority,
            pclass=pc.name, max_new_tokens=budget, kind=kind,
            poison_mode=mode, sample_seed=sample_seed, n_real=n_real,
            dup_of=dup_of, sample=sample))
    return Trace(spec=spec, items=items)


def replay(trace_json: str, cfg, src_vocab_size: int,
           triplet_vocab_size: int) -> Trace:
    """Rebuild a serialized trace and verify it regenerates identically —
    the replayability contract: a dumped incident trace IS the repro."""
    d = json.loads(trace_json)
    spec = TraceSpec.from_json(json.dumps(d["spec"]))
    trace = make_trace(spec, cfg, src_vocab_size, triplet_vocab_size)
    got = [it.meta() for it in trace.items]
    if got != d["items"]:
        raise ValueError(
            "trace replay diverged from the serialized metadata — "
            "spec/cfg/vocab mismatch")
    return trace


def zoo_spec(name: str, n_requests: int, seed: int = 0, **overrides) -> TraceSpec:
    """A named zoo entry at the requested size/seed."""
    base = TRACE_ZOO[name]
    return dataclasses.replace(
        base, name=name, n_requests=n_requests, seed=seed, **overrides)


# the canonical scenarios the bench, chaos runner and tests draw from
TRACE_ZOO: Dict[str, TraceSpec] = {
    "steady": TraceSpec(name="steady", arrival="poisson"),
    "diurnal": TraceSpec(name="diurnal", arrival="diurnal",
                         diurnal_period=128.0, diurnal_amp=0.8),
    "bursty_multitenant": TraceSpec(
        name="bursty_multitenant", arrival="bursty", burst_factor=6.0,
        burst_dwell=12.0, classes=DEFAULT_CLASSES,
        length_skew="lognormal"),
    "poison_flood": TraceSpec(
        name="poison_flood", arrival="poisson", poison_frac=0.3),
    "duplicate_storm": TraceSpec(
        name="duplicate_storm", arrival="poisson", duplicate_frac=0.6,
        duplicate_hot=2),
    "length_skew": TraceSpec(
        name="length_skew", arrival="poisson", length_skew="max_heavy"),
    "adversarial": TraceSpec(
        name="adversarial", arrival="bursty", burst_factor=5.0,
        burst_dwell=10.0, classes=DEFAULT_CLASSES, length_skew="bimodal",
        poison_frac=0.12, duplicate_frac=0.25, duplicate_hot=2),
}
