"""Serving observability: per-request latency records + engine counters.

The JAX package's ``serve/stats.py`` on the port's
:class:`~csat_tpu_torch.obs.metrics.MetricsRegistry`.  The engine calls
:meth:`ServeStats.record_compile` for each serving program it prepares —
the decode step, release and attach at construction, then one prefill per
occupied bucket, exactly as the JAX engine counts its compiled programs, so
the two summaries agree key for key; on the card the regression tripwire is
additionally "no CUDA extension build after warm-up" — and
:meth:`ServeStats.record_request` / :meth:`record_outcome` as each request
resolves.  :meth:`ServeStats.summary` renders request-latency percentiles,
generated-token throughput, page occupancy, the prefix-cache hit rate and
``effective_slots`` (concurrent slots per worst-case slot's worth of f32 KV
memory).

Every counter is backed by a registry metric (the attribute surface reads
and writes through descriptors), so the same numbers are scrapeable as
Prometheus text (:meth:`prometheus`, byte for byte the JAX package's for the
same calls) and streamable as JSONL snapshots.  The engine stamps the KV
tiers' gauges and counters from its tier store and books each kernel
library's warm-start provenance; the network front door's counters, a part
the port does not serve with, stay at zero.  ``mesh_devices`` is the span of the engine's serve
mesh (1 solo) and ``kv_pages_worst_chip`` the heaviest shard's pages, every
shard holding every allocated page's heads.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Optional, Sequence, Tuple

from csat_tpu_torch.obs.metrics import MetricsRegistry

__all__ = ["ServeStats", "percentile"]

# latency/wait percentile window: bounded so a long-running server's stats
# stay O(1) in memory (percentiles then describe the most recent window)
LATENCY_WINDOW = 10_000

# compile-event window: (kind, detail) tuples kept for shape forensics.
# Steady state builds ZERO programs, so any healthy server fits in this;
# the total lives in the `compiles` counter either way
COMPILE_EVENT_WINDOW = 256

# latency buckets for the serving histograms (seconds)
_LATENCY_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) without a NumPy dependency
    in the hot path; 0.0 on empty input."""
    if not values:
        return 0.0
    xs = sorted(values)
    k = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return float(xs[k])


class _Backed:
    """Attribute descriptor delegating to a registry metric's value, so the
    pre-existing ``stats.submitted += 1`` / ``stats.decode_steps = n``
    call sites double as metric updates with zero API change."""

    __slots__ = ("attr",)

    def __set_name__(self, owner, name: str) -> None:
        self.attr = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj._m[self.attr].value

    def __set__(self, obj, value) -> None:
        obj._m[self.attr].value = value


# attribute → (metric kind, prometheus name, help)
_METRICS = {
    "submitted": ("counter", "serve_requests_submitted_total",
                  "requests accepted by submit()"),
    "admitted": ("counter", "serve_requests_admitted_total",
                 "requests admitted to a decode slot"),
    "retired": ("counter", "serve_requests_ok_total",
                "OK retirements (tokens delivered)"),
    "rejected": ("counter", "serve_requests_rejected_total",
                 "queue-full rejections (policy reject)"),
    "shed": ("counter", "serve_requests_shed_total",
             "queue-full shed_oldest / graceful-drain sheds"),
    "timeouts": ("counter", "serve_requests_timeout_total",
                 "per-request deadline expiries"),
    "failed": ("counter", "serve_requests_failed_total",
               "FAILED outcomes (NaN logits, stuck slot, device fault, poison)"),
    "quarantined": ("counter", "serve_requests_quarantined_total",
                    "poison submits (subset of failed)"),
    "browned": ("counter", "serve_requests_browned_total",
                "low-tier requests brownout-capped at admission"),
    "reaped": ("counter", "serve_slots_reaped_total",
               "stuck slots force-retired by the reaper"),
    "rebuilds": ("counter", "serve_pool_rebuilds_total",
                 "slot-pool rebuilds after device faults"),
    "decode_steps": ("counter", "serve_decode_steps_total",
                     "engine ticks that ran the decode program"),
    "prefill_calls": ("counter", "serve_prefill_calls_total",
                      "compiled prefill dispatches"),
    "gen_tokens": ("counter", "serve_gen_tokens_total",
                   "real tokens delivered to finished requests"),
    "compiles": ("counter", "serve_compiled_programs_total",
                 "compiled-program builds (steady state: zero growth)"),
    "prefix_hits": ("counter", "serve_prefix_hits_total",
                    "admissions that skipped prefill via the prefix cache"),
    "prefix_misses": ("counter", "serve_prefix_misses_total",
                      "cache-enabled admissions that ran the encoder"),
    "pages_usable": ("gauge", "serve_kv_pages",
                     "allocatable KV pages (0 = rectangle layout)"),
    "rect_pages_per_slot": ("gauge", "serve_rect_pages_per_slot",
                            "equal-memory yardstick (SP + CP)"),
    "kv_page_ratio": ("gauge", "serve_kv_page_ratio",
                      "f32 bytes per page / storage bytes per page (1, 2 "
                      "or 4) — the equal-HBM multiplier quantized KV "
                      "pages fund"),
    "page_peak": ("gauge", "serve_kv_pages_peak",
                  "high-water KV pages in use"),
    "pages_in_use": ("gauge", "serve_kv_pages_in_use",
                     "KV pages in use at the last tick sample"),
    # mesh-sharded serving (the engine's head shards)
    "mesh_devices": ("gauge", "serve_mesh_devices",
                     "devices the engine's serve mesh spans (1 = solo)"),
    "pages_worst_chip": ("gauge", "serve_kv_pages_in_use_worst_chip",
                         "worst single chip's KV page occupancy — the "
                         "autoscaler's page-pressure signal under a mesh"),
    "queue_depth": ("gauge", "serve_queue_depth",
                    "queued (not yet admitted) requests"),
    "occupancy": ("gauge", "serve_slots_occupied",
                  "decode slots currently in flight"),
    # warm-start store (the port's: the kernel libraries, serve/warmstart.py)
    "warmstart_hits": ("counter", "serve_warmstart_hits_total",
                       "programs deserialized from the warm-start store"),
    "warmstart_misses": ("counter", "serve_warmstart_misses_total",
                         "store-enabled compiles that went cold (any reason)"),
    "cold_start_s": ("gauge", "serve_cold_start_s",
                     "engine bring-up wall time (ctor to programs live)"),
    # tiered KV page store (serve/tiering.py), stamped by the engine
    "tier_host_pages": ("gauge", "serve_tier_host_pages_in_use",
                        "KV pages resident in the host-RAM tier"),
    "tier_disk_pages": ("gauge", "serve_tier_disk_pages_in_use",
                        "KV pages resident in the disk tier"),
    "tier_spills": ("counter", "serve_tier_spills_total",
                    "cold chains spilled out of HBM into the tiers"),
    "tier_demotions": ("counter", "serve_tier_demotions_total",
                       "host-tier snapshots demoted to the disk tier"),
    "tier_restores": ("counter", "serve_tier_restores_total",
                      "digest-verified chains restored into HBM"),
    "tier_restore_misses": ("counter", "serve_tier_restore_miss_total",
                            "failed restores degraded to re-prefill"),
    # streaming network front door (zero in the port)
    "net_connections": ("gauge", "serve_net_connections",
                        "client connections currently open"),
    "net_stalled": ("gauge", "serve_net_stalled",
                    "connections over the send-buffer bound right now"),
    "net_frames": ("counter", "serve_net_frames_total",
                   "token/terminal frames queued to clients"),
    "net_stall_drops": ("counter", "serve_net_stall_drops_total",
                        "connections dropped after serve_net_stall_timeout_s "
                        "over the send-buffer bound"),
    "net_resumes": ("counter", "serve_net_resumes_total",
                    "streams resumed via {resume, have_seq} replay"),
    "net_disconnects": ("counter", "serve_net_disconnects_total",
                        "client connections closed (any reason)"),
    "net_malformed": ("counter", "serve_net_malformed_total",
                      "unparseable / protocol-violating client lines"),
}


class ServeStats:
    # counters / gauges (registry-backed; see _METRICS for exposition names)
    submitted = _Backed()
    admitted = _Backed()
    retired = _Backed()         # OK retirements (tokens delivered)
    # structured non-OK outcomes (serve/engine.py resilience layer)
    rejected = _Backed()        # queue-full, policy "reject"
    shed = _Backed()            # queue-full shed_oldest / graceful-drain shed
    timeouts = _Backed()        # per-request deadline expiry
    failed = _Backed()          # NaN logits, stuck slot, prefill/device
    #                             fault, poison submit — every FAILED outcome
    quarantined = _Backed()     # poison subset of `failed` (submit-time)
    browned = _Backed()         # low-tier decode budgets capped by brownout
    reaped = _Backed()          # stuck slots force-retired by the reaper
    rebuilds = _Backed()        # slot-pool rebuilds after a device fault
    decode_steps = _Backed()    # engine ticks that ran the decode program
    prefill_calls = _Backed()
    gen_tokens = _Backed()      # real tokens delivered to finished requests
    compiles = _Backed()        # TOTAL compiled-program builds (authoritative;
    #                             compile_events is a bounded window of it)
    # block-paged KV pool + prefix cache (serve/pages.py, serve/prefix.py)
    prefix_hits = _Backed()     # admissions that skipped prefill entirely
    prefix_misses = _Backed()   # cache-enabled admissions that encoded
    pages_usable = _Backed()    # allocatable pages (0 = rectangle layout)
    rect_pages_per_slot = _Backed()  # equal-memory yardstick (SP + CP)
    kv_page_ratio = _Backed()   # quantized-page HBM multiplier (1 at f32)
    page_peak = _Backed()       # high-water pages in use
    pages_in_use = _Backed()    # last per-tick occupancy sample
    # mesh-sharded serving: device span of this engine's serve
    # mesh (1 = solo) and the worst single chip's page occupancy. At rung
    # (1) the allocator is replicated so every chip holds the same chains
    # (page axis unsharded) and worst-chip == pages_in_use; rung (2+)
    # per-chip allocation will make these diverge, and the autoscaler's
    # occupancy signal keys off the worst chip either way
    mesh_devices = _Backed()
    pages_worst_chip = _Backed()
    queue_depth = _Backed()     # scrape-surface mirrors (engine-stamped)
    occupancy = _Backed()
    # warm-start provenance (serve/warmstart.py): hits deserialize a stored
    # executable, misses fell through to a fresh compile; cold_start_s is
    # the bring-up wall time the autoscaler's healing latency rides on
    warmstart_hits = _Backed()
    warmstart_misses = _Backed()
    cold_start_s = _Backed()
    # tiered KV page store (serve/tiering.py): engine-stamped mirrors of
    # the store's occupancy gauges and lifetime counters
    tier_host_pages = _Backed()
    tier_disk_pages = _Backed()
    tier_spills = _Backed()
    tier_demotions = _Backed()
    tier_restores = _Backed()
    tier_restore_misses = _Backed()
    # network front door (serve/netfront.py): connection / stream counters
    # stamped by the socket loop — never by the engine tick
    net_connections = _Backed()
    net_stalled = _Backed()
    net_frames = _Backed()
    net_stall_drops = _Backed()
    net_resumes = _Backed()
    net_disconnects = _Backed()
    net_malformed = _Backed()

    def __init__(self, num_slots: int,
                 registry: Optional[MetricsRegistry] = None):
        self.num_slots = num_slots
        self.registry = registry if registry is not None else MetricsRegistry()
        self._m = {
            attr: getattr(self.registry, kind)(name, help)
            for attr, (kind, name, help) in _METRICS.items()
        }
        self.registry.gauge(
            "serve_slots", "decode-slot pool size").set(num_slots)
        self.latency_hist = self.registry.histogram(
            "serve_request_latency_seconds",
            "submit-to-done latency of OK requests", buckets=_LATENCY_BUCKETS)
        self.wait_hist = self.registry.histogram(
            "serve_request_wait_seconds",
            "submit-to-admit wait of OK requests", buckets=_LATENCY_BUCKETS)
        # (kind, detail) per compiled-program build, newest-last, BOUNDED —
        # `compiles` carries the total; tests assert it stops growing after
        # warm-up
        self.compile_events: Deque[Tuple[str, Tuple]] = deque(
            maxlen=COMPILE_EVENT_WINDOW)
        self._page_sum = 0         # Σ per-tick pages in use (mean occupancy)
        self._page_samples = 0
        self.wait_s: Deque[float] = deque(maxlen=LATENCY_WINDOW)     # submit → admit
        self.latency_s: Deque[float] = deque(maxlen=LATENCY_WINDOW)  # submit → done
        # per-restore wall time (tier → HBM), the :tiering drill's p95
        self.tier_restore_s: Deque[float] = deque(maxlen=LATENCY_WINDOW)
        # per-priority-class latency windows: the autoscaler's p95 signal
        # reads class 0 (gold) so brownout-capped low tiers cannot mask an
        # SLO breach on the tier that matters
        self.latency_by_class: Dict[int, Deque[float]] = {}
        # per-class registry histograms (serve_class<p>_latency_seconds),
        # created lazily on the first request of each class: unlike the
        # deque windows these MERGE across replicas and are what the SLO
        # engine's per-class latency objectives read (obs/slo.py)
        self._class_hists: Dict[int, object] = {}
        self.first_done_t: Optional[float] = None
        self.last_done_t: Optional[float] = None
        self.started_t: Optional[float] = None

    # ---------------- recording ----------------

    def record_compile(self, kind: str, detail: Tuple) -> None:
        self.compile_events.append((kind, tuple(detail)))
        self.compiles += 1

    def carry_compiles(self, old: "ServeStats") -> None:
        """Inherit the compile history across a stats reset (the programs
        themselves survive, so the tripwire total must too)."""
        self.compile_events = deque(
            old.compile_events, maxlen=COMPILE_EVENT_WINDOW)
        self.compiles = old.compiles

    def set_page_info(self, usable: int, rect_pages_per_slot: int,
                      kv_ratio: int = 1) -> None:
        """Paged-pool geometry (engine init / reset): enables the page
        occupancy and effective-slots lines in :meth:`summary`.
        ``kv_ratio`` is the quantized-page HBM multiplier
        (``serve/pages.py:KV_PAGE_RATIO`` — 1 at f32, 2 at bf16, 4 at
        int8): a usable page of int8 storage holds a quarter the bytes a
        rectangle-pool f32 page would, so the equal-memory
        effective-slots ratio scales by it."""
        self.pages_usable = int(usable)
        self.rect_pages_per_slot = int(rect_pages_per_slot)
        self.kv_page_ratio = int(kv_ratio)

    def note_pages(self, used: int, worst_chip: Optional[int] = None) -> None:
        """One per-tick occupancy sample (pages currently allocated).
        ``worst_chip`` is the heaviest single chip's page count under a
        serve mesh; it defaults to ``used`` (solo, or the rung-1 mesh
        where the replicated allocator keeps every chip uniform)."""
        used = int(used)
        self.pages_in_use = used
        self.pages_worst_chip = int(used if worst_chip is None else worst_chip)
        if used > self.page_peak:
            self.page_peak = used
        self._page_sum += used
        self._page_samples += 1

    def note_tier_restore(self, seconds: float) -> None:
        """One tier → HBM restore completed (gather of the stored bytes,
        digest check, device scatter) in ``seconds`` wall time."""
        self.tier_restore_s.append(float(seconds))

    def record_request(self, submit_t: float, admit_t: float, done_t: float,
                       n_tokens: int, priority: int = 0,
                       trace_id: str = "") -> None:
        self.retired += 1
        self.gen_tokens += int(n_tokens)
        wait = admit_t - submit_t
        latency = done_t - submit_t
        self.wait_s.append(wait)
        self.latency_s.append(latency)
        # the trace id rides the histograms as a per-bucket exemplar
        # (newest wins): "p95 regressed" jumps straight to a trace
        ex = trace_id or None
        self.wait_hist.observe(wait, exemplar=ex)
        self.latency_hist.observe(latency, exemplar=ex)
        p = int(priority)
        cls = self.latency_by_class.setdefault(
            p, deque(maxlen=LATENCY_WINDOW))
        cls.append(latency)
        h = self._class_hists.get(p)
        if h is None:
            h = self.registry.histogram(
                f"serve_class{p}_latency_seconds",
                f"OK-request latency, priority class {p}",
                buckets=_LATENCY_BUCKETS)
            self._class_hists[p] = h
        h.observe(latency, exemplar=ex)
        if self.first_done_t is None:
            self.first_done_t = done_t
        self.last_done_t = done_t

    def class_p95(self, priority: int = 0) -> float:
        """OK-latency p95 for one priority class (0.0 with no samples)."""
        return percentile(self.latency_by_class.get(int(priority), ()), 95)

    def record_outcome(self, status: str) -> None:
        """Count one non-OK terminal outcome (``RequestStatus`` value) —
        latency percentiles stay OK-only so failure storms cannot make the
        service look faster than it is."""
        field = {"REJECTED": "rejected", "SHED": "shed",
                 "TIMEOUT": "timeouts", "FAILED": "failed"}[status]
        setattr(self, field, getattr(self, field) + 1)

    # ---------------- reporting ----------------

    def prometheus(self) -> str:
        """Prometheus text exposition of every serving metric."""
        return self.registry.prometheus()

    def summary(self, wall_s: Optional[float] = None, n_chips: int = 1) -> Dict[str, float]:
        """Throughput is credited over ``wall_s`` when the caller measured a
        whole run (the bench), else over the submit→last-retire span."""
        if wall_s is None:
            t0 = self.started_t
            t1 = self.last_done_t
            wall_s = (t1 - t0) if (t0 is not None and t1 is not None) else 0.0
        tps = self.gen_tokens / wall_s if wall_s > 0 else 0.0
        # paged-pool accounting: mean/peak occupancy over the tick samples,
        # the prefill-skip rate, and how many concurrent slots this pool
        # offers per RECTANGLE slot's worth of KV memory (1.0 for the
        # rectangle layout; 2.0 = the 2x-slots-at-equal-memory claim)
        usable = self.pages_usable
        occ = (self._page_sum / self._page_samples / usable
               if usable and self._page_samples else 0.0)
        peak = self.page_peak / usable if usable else 0.0
        planned = self.prefix_hits + self.prefix_misses
        hit_rate = self.prefix_hits / planned if planned else 0.0
        eff = (self.num_slots * self.rect_pages_per_slot
               * max(int(self.kv_page_ratio), 1) / usable
               if usable else 1.0)
        return {
            "num_slots": self.num_slots,
            "submitted": self.submitted,
            "admitted": self.admitted,
            "retired": self.retired,
            "rejected": self.rejected,
            "shed": self.shed,
            "timeouts": self.timeouts,
            "failed": self.failed,
            "quarantined": self.quarantined,
            "browned": self.browned,
            "reaped": self.reaped,
            "rebuilds": self.rebuilds,
            "decode_steps": self.decode_steps,
            "prefill_calls": self.prefill_calls,
            "compiles": self.compiles,
            "gen_tokens": self.gen_tokens,
            "wall_s": round(wall_s, 3),
            "gen_tokens_per_sec": round(tps, 2),
            "gen_tokens_per_sec_per_chip": round(tps / max(n_chips, 1), 2),
            "gen_tokens_per_sec_per_slot": round(tps / max(self.num_slots, 1), 2),
            "latency_p50_s": round(percentile(self.latency_s, 50), 4),
            "latency_p95_s": round(percentile(self.latency_s, 95), 4),
            "wait_p50_s": round(percentile(self.wait_s, 50), 4),
            "wait_p95_s": round(percentile(self.wait_s, 95), 4),
            "kv_pages": usable,
            "kv_page_occupancy": round(occ, 4),
            "kv_page_peak": round(peak, 4),
            "mesh_devices": max(int(self.mesh_devices), 1),
            "kv_pages_worst_chip": self.pages_worst_chip,
            "prefix_hit_rate": round(hit_rate, 4),
            "effective_slots": round(eff, 3),
            # tier ladder (zeros when serve_tiering is off)
            "tier_host_pages": self.tier_host_pages,
            "tier_disk_pages": self.tier_disk_pages,
            "tier_spills": self.tier_spills,
            "tier_restores": self.tier_restores,
            "restore_miss_total": self.tier_restore_misses,
            "tier_restore_p95_s": round(percentile(self.tier_restore_s, 95), 4),
            # network front door (zeros when serving without --net)
            "net_connections": self.net_connections,
            "net_stalled": self.net_stalled,
            "net_frames": self.net_frames,
            "net_stall_drops": self.net_stall_drops,
            "net_resumes": self.net_resumes,
            "net_disconnects": self.net_disconnects,
            "net_malformed": self.net_malformed,
        }
