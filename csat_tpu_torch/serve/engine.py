"""ServeEngine: continuous batching over the block-paged slot pool.

Counterpart of the JAX package's ``serve/engine.py`` with the same public
door — ``submit`` / ``poll`` / ``pop_result`` / ``tick`` / ``drain`` /
``generate`` / ``shed_all`` / ``shed_oldest``, ``stats`` (``ServeStats``),
``obs`` (the flight recorder), ``tracer`` (request traces),
``reset_stats``, ``page_leaks`` / ``chain_leaks`` — over ``cfg.serve_slots``
decode slots whose K/V live in pages of ``cfg.serve_kv_page_dtype`` (f32, or
bf16 / int8 rows quantized on write with f32 per-row scales), under the
model's compute dtype.  Each admission funds its chains from a host-side free
list: the self chain sized by the request's token budget, the cross chain by
its prefill bucket — or SHARED outright on a prefix-cache hit
(``serve/prefix.py``, on by default at ``serve_prefix_cache=64`` entries).
Each :meth:`tick` is one scheduler round:

1. **retire** — rows that emitted EOS or spent their token budget hand their
   tokens back (``OK``) and free their pages; a row whose log-probs went
   non-finite retires ``FAILED`` without its last token;
2. **expire / reap** — queued and in-flight requests past their deadline
   resolve ``TIMEOUT`` (in flight: with the tokens so far); an admitted row
   that stopped retiring (a wedged row) resolves ``FAILED`` once
   ``limit + serve_reap_margin`` ticks have passed;
3. **admit** — free slots refill from the queue head (by priority tier, then
   FIFO): requests group by smallest-fitting prefill bucket, each is funded
   first (an unfundable request waits at the head; unreferenced prefix-cache
   entries are evicted on demand), hits attach without running the encoder
   (``serve/pages.py:attach``) and each group of misses runs the encoder at
   its bucket width (``serve/prefill.py``, K1 and K2 on the card) and
   publishes its cross chains to the cache; a prefill that raises resolves
   its chunk ``FAILED`` with its pages refunded and the pool still serving;
4. **decode** — one step advances every live slot a token
   (``serve/pages.py``, K5 on the card), then one ``(S, 3)`` status read
   reaches the host; a fault escaping it rebuilds the pool (bounded by
   ``serve_max_rebuilds``) and resubmits in-flight work in order (bounded
   per request by ``serve_max_retries``).

Every request reaches exactly one terminal :class:`RequestStatus` —
``OK | FAILED | TIMEOUT | REJECTED | SHED``: malformed samples are
quarantined at submit under ``serve_poison_budget``, a bounded queue
(``serve_max_queue``) rejects or sheds, low priority tiers are
brownout-capped before anyone is refused.  The flight recorder carries the
JAX package's ``req.*`` / ``tick.*`` / ``fault.*`` events and writes a rolling
post-mortem per fault reason; a tick watchdog (``serve_watchdog_timeout_s``,
on the engine's clock, with the device-liveness leg when
``watchdog_device_probe``) bounds a wedged tick.  Deadlines, reaping, stats,
traces and the prefix cache are host bookkeeping: a tick that only decodes
reads the device once.

A serve mesh (``cfg.serve_mesh_shape`` spanning more than one device) puts
this ONE engine across head shards, as the JAX single controller does
(``engine.py:268-314``): each shard's KV pages and scales live on its device
(``mesh_devices``, default every visible card), while the scheduler, the
allocator, the page tables, the prefix cache, the encoder, the prefill and
every projection stay single on the engine's device; each layer's head
outputs are gathered before the replicated output projection.  The paged
decode kernel runs one block per (slot, head), so each shard runs it
unchanged on its heads and the tokens are the solo engine's bit for bit.

Storage, as the JAX engine holds it (``engine.py:296-550, 987-1317``):

* **the rectangle layout** (``serve_kv_layout="rect"``, ``serve/slots.py``):
  one ``(S, H, T, dh)`` self and ``(S, H, N, dh)`` cross rectangle per layer
  instead of pages — no allocator and no prefix cache (``page_leaks`` and
  ``chain_leaks`` read 0), prefill through ``serve/prefill.py:rect_prefill``
  (K1 and K2 on the card), decode through the plain rectangle read (JAX pins
  its reference path there);
* **KV tiering** (``serve_tiering``, ``serve/tiering.py``): under page
  pressure an evicted prefix-cache chain is spilled — its pages and scales
  gathered out of every layer (``serve/pages.py:tier_gather``) into a host
  tier, demoted to a digest-verified disk tier beyond its budget — instead
  of destroyed; a later admission of the same content hash restores it into
  fresh pages (``tier_restore``) and attaches it as a prefix hit, bit for bit
  the chain that never left the card.  Every failed restore is a structured
  ``tier.restore_miss{reason}`` and a re-prefill through the same kernels.
  Spills and restores happen at admission (or on :meth:`spill_all`), never
  on a tick that only decodes;
* **warm start** (``serve_warmstart``, ``serve/warmstart.py``): on the card
  the engine loads its kernel libraries at construction through the store,
  so a warm process runs no ``nvcc``; each library's provenance
  (``warmstart_provenance``: ``"hit"`` or the miss reason) is counted in
  ``stats`` and stamped as ``warmstart.hit`` / ``warmstart_miss{reason}``.
  The libraries are loaded once per process, so a second engine in the same
  process reports the first load's provenance.

Unlike the JAX engine, which donates an immutable pool through compiled
programs, the pool's tensors are updated in place.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from collections import defaultdict, deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Set, Union

import numpy as np
import torch

from csat_tpu_torch.configs import Config
from csat_tpu_torch.obs import EventRecorder, Tracer
from csat_tpu_torch.ops import build
from csat_tpu_torch.parallel.mesh import build_serve_mesh, serve_head_shards
from csat_tpu_torch.resilience.retry import ErrorBudget
from csat_tpu_torch.resilience.watchdog import StepWatchdog, device_liveness_probe
from csat_tpu_torch.serve.ingest import PoisonRequestError, validate_sample
from csat_tpu_torch.serve.pages import (
    KV_PAGE_RATIO, PageAllocator, attach, build_paged_decode_step, init_paged_pool,
    page_geometry, page_sets, release, tier_gather, tier_restore)
from csat_tpu_torch.serve.prefill import (
    assign_prefill_bucket, paged_prefill, prefill_plan, rect_prefill)
from csat_tpu_torch.serve.prefix import PrefixCache, sample_hash
from csat_tpu_torch.serve.slots import build_decode_step, init_pool
from csat_tpu_torch.serve.stats import ServeStats
from csat_tpu_torch.serve.tiering import TieredPageStore
from csat_tpu_torch.serve.warmstart import WarmStartStore, store_root
from csat_tpu_torch.utils import EOS_WORD, PAD, resolve_device

__all__ = ["Request", "RequestStatus", "PagePlan", "ServeEngine"]

#: a tier snapshot's header ``dtype`` per page storage dtype: numpy's
#: ``dtype.str`` of the JAX pool's arrays (ml_dtypes' bfloat16 is ``<V2``)
_TIER_DTYPE_STR = {"float32": "<f4", "bfloat16": "<V2", "int8": "|i1"}
#: the numpy dtype a snapshot's bytes are read as (bf16 as its raw 16 bits)
_TIER_NP = {"float32": np.float32, "bfloat16": np.int16, "int8": np.int8}
#: ``_restore_plan``'s "the restore failed, re-prefill" outcome
_RESTORE_MISS = object()


class RequestStatus:
    """Terminal request outcomes (str constants, JSON-friendly)."""

    PENDING = "PENDING"    # queued or in flight — the only non-terminal state
    OK = "OK"              # tokens delivered (EOS or budget)
    FAILED = "FAILED"      # poison input, NaN logits, stuck slot, device fault
    TIMEOUT = "TIMEOUT"    # deadline expired (queued: no tokens; in flight: partial)
    REJECTED = "REJECTED"  # admission control refused it (queue full, "reject")
    SHED = "SHED"          # dropped to make room ("shed_oldest") or at drain deadline

    TERMINAL = (OK, FAILED, TIMEOUT, REJECTED, SHED)


@dataclasses.dataclass
class Request:
    """One queued / in-flight / finished request.  ``sample`` is released at
    the terminal transition (its (N, N) planes are needed only until prefill,
    and while in flight so a rebuild can resubmit)."""

    id: int
    sample: Optional[Dict[str, np.ndarray]]
    limit: int                       # decode-token budget (<= steps)
    submit_t: float
    deadline_t: Optional[float] = None  # absolute clock deadline (None = none)
    admit_t: Optional[float] = None
    done_t: Optional[float] = None
    slot: Optional[int] = None
    bucket: Optional[int] = None     # prefill bucket index it was admitted at
    tokens: Optional[np.ndarray] = None  # generated ids incl. the EOS, if any
    n_tokens: int = 0
    status: str = RequestStatus.PENDING
    error: Optional[str] = None      # cause of a non-OK outcome
    attempts: int = 0                # resubmissions consumed by pool rebuilds
    priority: int = 0                # tenant tier (0 = most important)
    retry_after_s: Optional[float] = None  # backpressure hint on REJECTED / SHED
    browned: bool = False            # decode budget was brownout-capped
    admit_tick: Optional[int] = None  # engine tick at admission (reaper clock)
    phash: Optional[bytes] = None    # content hash (prefix cache on), once at submit
    trace_id: str = ""               # request trace ("" with tracing off)

    @property
    def finished(self) -> bool:
        return self.done_t is not None

    @property
    def ok(self) -> bool:
        return self.status == RequestStatus.OK


def _tf(req: Request) -> Dict[str, str]:
    """Trace-id fields of a request's recorder events (none with tracing off)."""
    return {"trace": req.trace_id} if req.trace_id else {}


@dataclasses.dataclass
class PagePlan:
    """One admitted request's page funding: the self chain is privately
    owned; the cross chain is private (``shared=False`` — freed at retire) or
    owned by the prefix cache (``shared=True`` — retire releases the
    refcount and the pages stay pinned for the next identical submission)."""

    self_chain: List[int]
    cross_chain: List[int]
    phash: Optional[bytes] = None  # content hash (None with the cache off)
    hit: bool = False              # cross chain came from a prefix-cache hit
    shared: bool = False           # cross chain is cache-owned


class ServeEngine:
    """submit / poll / tick / drain continuous-batching inference engine on
    ``device`` (default ``cuda``; ``device="cpu"`` runs the plain paths).

    ``clock`` is the engine's time base — deadlines, latencies, traces and
    the tick watchdog — so drills can run a virtual one.  ``tgt_vocab``
    enables :meth:`words`; ``fault_injector`` (``resilience/faults.py``) is
    consulted at fixed scheduler points; ``watchdog_on_timeout`` replaces the
    watchdog's default action (exit 76); ``mesh_devices`` gives a serve
    mesh's head shards their devices, in order (several may share one;
    default: every visible card, or the engine's device on the CPU);
    ``warmstart`` shares a caller's warm-start store (default: a fresh one
    when ``cfg.serve_warmstart``)."""

    # floor between same-reason post-mortem rewrites, wall seconds
    _POSTMORTEM_MIN_INTERVAL_S = 1.0

    def __init__(self, model, cfg: Config,
                 device: Optional[Union[str, torch.device]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 tgt_vocab=None, fault_injector=None,
                 watchdog_on_timeout: Optional[Callable[[], None]] = None,
                 log: Callable[[str], None] = lambda m: None,
                 mesh_devices: Optional[Sequence] = None,
                 warmstart: Optional[WarmStartStore] = None):
        t_build0 = time.perf_counter()
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, engine asked for {self.device}")
        self.model = model
        self.cfg = cfg
        self.tgt_vocab = tgt_vocab
        self.clock = clock
        self.log = log
        self.steps = cfg.max_tgt_len - 1
        self.num_slots = cfg.serve_slots
        self.specs = prefill_plan(cfg)
        self.stats = ServeStats(self.num_slots)
        self.stats.started_t = clock()
        self.obs = EventRecorder(capacity=cfg.obs_events, component="serve")
        self.tracer = Tracer(capacity=cfg.obs_traces, slowest=cfg.obs_trace_slowest,
                             component="serve")
        pm = cfg.obs_postmortem_dir
        self._postmortem_dir = os.path.join(cfg.output_dir, "postmortem") if pm == "auto" else pm
        # fault reasons whose dump is pending: coalesced per tick / submit and
        # rate-limited per reason, so a shed storm rewrites one rolling file
        self._pending_dumps: Set[str] = set()
        self._last_dump_t: Dict[str, float] = {}
        self.fault_injector = fault_injector

        # serve mesh: cfg.validate() pinned a unit data axis; the device
        # count and the head split are only checkable here
        self.mesh = None
        span = math.prod(cfg.serve_mesh_shape) if cfg.serve_mesh_shape else 1
        if span > 1:
            if mesh_devices is None and self.device.type != "cuda":
                mesh_devices = [self.device] * span
            self.mesh = build_serve_mesh(cfg.serve_mesh_shape, mesh_devices)
            hs = serve_head_shards(self.mesh)
            if cfg.num_heads % hs:
                raise ValueError(f"serve_mesh_shape={cfg.serve_mesh_shape}: num_heads="
                                 f"{cfg.num_heads} must divide evenly over {hs} head shards")
        # the rect layout has no pages: no allocator, no prefix cache
        # (cfg.validate() refused it under a serve mesh and with tiering)
        self.paged = cfg.serve_kv_layout == "paged"
        if self.paged:
            self.geo = page_geometry(cfg)
            self._allocator = PageAllocator(self.geo.num_pages)
            self._prefix: Optional[PrefixCache] = (
                PrefixCache(cfg.serve_prefix_cache) if cfg.serve_prefix_cache > 0 else None)
        else:
            self.geo = self._allocator = self._prefix = None
        self._pool = self._fresh_pool()
        self._step = (build_paged_decode_step(model, self.geo) if self.paged
                      else build_decode_step(model))

        # warm start: the serving kernels' libraries loaded now, through the
        # store, so that the start wall covers them and a warm process runs
        # no nvcc (the CPU path loads none)
        self.warmstart = warmstart if warmstart is not None else (
            WarmStartStore(store_root(cfg), log=log) if cfg.serve_warmstart else None)
        self.warmstart_provenance: Dict[str, str] = {}
        if self.warmstart is not None and self.device.type == "cuda":
            self._warm_libraries()

        # the serving programs, counted as the JAX engine counts its compiled
        # ones (decode, release, attach, the tier gather and restore now; one
        # prefill per occupied bucket at its first use), so the two summaries
        # agree key for key
        self.stats.record_compile("decode", (self.num_slots, self.steps))
        if self.paged:
            self.stats.record_compile("release", (self.num_slots,))
        if self._prefix is not None:
            self.stats.record_compile("attach", (self.num_slots,))
        # the KV tiers below the page pool: a snapshot is (layers, k|v, chain
        # width, H, page, dh) in the page storage dtype plus its f32 scales
        # (..., page, 1), a digest-covered byte string each
        self._tiers: Optional[TieredPageStore] = None
        if self.paged and cfg.serve_tiering and self._prefix is not None:
            self._tiers = TieredPageStore(
                host_pages=cfg.serve_tier_host_pages, disk_pages=cfg.serve_tier_disk_pages,
                root=cfg.serve_tier_dir or os.path.join(cfg.output_dir, "kv_tiers"),
                log=log, obs=self.obs)
            page_shape = (cfg.num_heads, self.geo.page, cfg.hidden_size // cfg.num_heads)
            self._tier_shape = (len(model.decoder.layers), 2, self.geo.cp) + page_shape
            self._tier_scale_shape = self._tier_shape[:-1] + (1,)
            self.stats.record_compile("tier_gather", (self.geo.cp,))
            self.stats.record_compile("tier_restore", self._tier_shape)
        self._prefill_built: Set[int] = set()
        self._slot_meta: List[Optional[PagePlan]] = [None] * self.num_slots
        self._slots: List[Optional[Request]] = [None] * self.num_slots
        self._queue: Deque[Request] = deque()
        self._results: Dict[int, Request] = {}
        # host mirror of the last decode step's (S, 3) [pos, done, bad]
        # snapshot — the only per-tick read besides retired token rows
        self._status: Optional[np.ndarray] = None
        self._next_id = 0
        self._n_prefills = 0
        self._tick_no = 0
        self._rebuilds = 0
        # the per-tick queue scan for expiry stays off the no-deadline path
        self._has_deadlines = False
        # poison quarantine at submit: each refused sample is a FAILED
        # outcome; past the budget the stream is upstream corruption
        self._poison_budget = ErrorBudget(cfg.serve_poison_budget, log=log)
        self._sync_page_stats()
        self.stats.cold_start_s = round(time.perf_counter() - t_build0, 4)
        self.obs.emit("engine.cold_start", cold_start_s=self.stats.cold_start_s,
                      warm=int(self.stats.warmstart_hits), cold=int(self.stats.warmstart_misses))

        # tick watchdog: beats once per completed tick while work is in
        # flight, disarms when idle, default action exit 76
        self._watchdog: Optional[StepWatchdog] = None
        if cfg.serve_watchdog_timeout_s > 0:
            probe = (device_liveness_probe(self.device)
                     if cfg.watchdog_device_probe and self.device.type == "cuda" else None)
            self._watchdog = StepWatchdog(
                cfg.serve_watchdog_timeout_s, on_timeout=watchdog_on_timeout,
                on_trip=self._watchdog_trip, log=log, probe=probe, clock=clock).start()
        self._closed = False

    def close(self) -> bool:
        """Stop the watchdog and flush pending post-mortems.  Idempotent: the
        first call returns True, later calls False."""
        if self._closed:
            return False
        self._closed = True
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
        if self._tiers is not None:
            # tiered snapshots are an in-lifetime optimisation, not a
            # persistence contract: both tiers go (disk files removed)
            self._tiers.clear()
        self._flush_postmortems(force=True)
        return True

    def _fresh_pool(self):
        """An empty pool of the engine's layout (every slot frozen)."""
        if self.paged:
            return init_paged_pool(self.model, self.num_slots, self.geo,
                                   self.cfg.serve_kv_page_dtype, self.mesh)
        return init_pool(self.model, self.num_slots, self.steps, self.cfg.max_src_len)

    def _warm_libraries(self) -> None:
        """Load the libraries of the engine's kernels (K1 and K2; K5 when
        paged) through the warm-start store and book each one's provenance:
        a hit, or a miss (counted when the store is enabled, as the JAX
        engine counts only store-enabled misses) with its reason."""
        for lib in build.SERVE_LIBRARIES if self.paged else ("flex_fwd_tc",):
            build.load_library(lib, self.warmstart)
            prov = build.PROVENANCE[lib]
            self.warmstart_provenance[lib] = prov
            if prov == "hit":
                self.stats.warmstart_hits += 1
                self.obs.emit("warmstart.hit", program=lib)
            elif prov != "off":
                if self.warmstart.enabled:
                    self.stats.warmstart_misses += 1
                self.obs.emit("warmstart_miss", program=lib, reason=prov)
                self.log(f"# warmstart_miss{{program={lib!r}, reason={prov!r}}}")

    # ---------------- observability plumbing ----------------

    @property
    def fault_injector(self):
        return self._fault_injector

    @fault_injector.setter
    def fault_injector(self, inj) -> None:
        self._fault_injector = inj
        if inj is not None and getattr(inj, "recorder", None) is None:
            inj.recorder = self.obs

    def _note_fault(self, reason: str) -> None:
        """Schedule a post-mortem dump for this fault class (flushed at the
        end of the current tick / submit)."""
        if self._postmortem_dir and self.obs.enabled:
            self._pending_dumps.add(reason)

    def _flush_postmortems(self, force: bool = False) -> None:
        """Write pending dumps; ``force`` (drain end, shed_all, close, an idle
        tick) ignores the per-reason rate limit."""
        if not self._pending_dumps:
            return
        now = time.monotonic()
        for reason in list(self._pending_dumps):
            if not force and (now - self._last_dump_t.get(reason, -1e9)
                              < self._POSTMORTEM_MIN_INTERVAL_S):
                continue
            self._pending_dumps.discard(reason)
            self._last_dump_t[reason] = now
            self.obs.postmortem(self._postmortem_dir, reason)

    def _watchdog_trip(self, what: str, stalled_s: float) -> None:
        """The watchdog's on_trip hook — runs while the scheduler is wedged,
        so the dump happens here, not at tick end."""
        self.obs.emit("fault.watchdog", what=what, stalled_s=round(stalled_s, 3))
        if self._postmortem_dir:
            self.obs.postmortem(self._postmortem_dir, "watchdog")

    # ---------------- public door ----------------

    def submit(self, sample: Dict[str, np.ndarray], max_new_tokens: int = 0,
               deadline_s: Optional[float] = None, priority: int = 0,
               trace_id: Optional[str] = None) -> int:
        """Queue one request and return its id — always, even when it is
        refused: admission control and the poison quarantine resolve it to a
        terminal REJECTED / SHED / FAILED at once.  ``max_new_tokens`` caps
        the decode budget (0 = ``max_tgt_len - 1``); ``deadline_s`` bounds
        its total latency (None = ``cfg.serve_deadline_s``, 0 = none);
        ``priority`` is its tier (0 = most important, clamped to
        ``cfg.serve_priority_classes``); ``trace_id`` adopts an existing
        trace.  The only exception is an exhausted poison budget
        (:class:`~csat_tpu_torch.resilience.retry.DataErrorBudgetExceeded`)."""
        now = self.clock()
        limit = self.steps if max_new_tokens <= 0 else min(max_new_tokens, self.steps)
        pr = max(0, min(int(priority), self.cfg.serve_priority_classes - 1))
        ddl = self.cfg.serve_deadline_s if deadline_s is None else deadline_s
        req = Request(id=self._next_id, sample=sample, limit=limit, submit_t=now, priority=pr,
                      deadline_t=(now + ddl) if ddl and ddl > 0 else None)
        self._next_id += 1
        self.stats.submitted += 1
        req.trace_id = self.tracer.begin(trace_id, t=now, id=req.id, priority=pr, limit=limit)
        self.obs.emit("req.submit", id=req.id, limit=limit, priority=pr, **_tf(req))
        if req.deadline_t is not None:
            self._has_deadlines = True

        try:
            validate_sample(sample, self.cfg, self.model.src_vocab_size,
                            self.model.triplet_vocab_size)
        except PoisonRequestError as e:
            self._poison_budget([req.id], e)  # raises once the budget is spent
            self.stats.quarantined = self._poison_budget.count
            self.obs.emit("fault.poison", id=req.id, error=str(e), **_tf(req))
            self._finish(req, RequestStatus.FAILED, error=f"poison request: {e}", now=now)
            self._flush_postmortems()
            return req.id
        if self._prefix is not None:
            req.phash = sample_hash(sample)

        # brownout: before anyone is refused, low tiers lose decode budget
        max_q = self.cfg.serve_max_queue
        if (req.priority > 0 and max_q and self.cfg.serve_brownout_max_new_tokens > 0
                and len(self._queue) >= max(
                    1, int(math.ceil(max_q * self.cfg.serve_brownout_queue_frac)))):
            cap = min(self.cfg.serve_brownout_max_new_tokens, req.limit)
            if cap < req.limit:
                req.limit = cap
                req.browned = True
                self.stats.browned += 1
                self.obs.emit("req.brownout", id=req.id, limit=cap, priority=req.priority,
                              **_tf(req))
                if req.trace_id:
                    self.tracer.event(req.trace_id, "brownout", t=now, limit=cap)

        # admission control: a bounded queue with a structured outcome
        if max_q and len(self._queue) >= max_q:
            if self.cfg.serve_queue_policy == "reject":
                self._finish(req, RequestStatus.REJECTED, error=f"queue full ({max_q})", now=now)
                self._flush_postmortems()
                return req.id
            shed = self._shed_victim(req)
            self._finish(shed, RequestStatus.SHED,
                         error=f"shed by admission control (queue {max_q})", now=now)
            self._flush_postmortems()
            if shed is req:
                return req.id
        self._queue.append(req)
        return req.id

    def _shed_victim(self, incoming: Request) -> Request:
        """The queued request to shed for ``incoming`` — the highest tier
        number, FIFO-oldest within it — or ``incoming`` itself when
        everything queued outranks it."""
        worst: Optional[Request] = None
        worst_j = -1
        for j, r in enumerate(self._queue):
            if worst is None or r.priority > worst.priority:
                worst, worst_j = r, j
        if worst is not None and worst.priority >= incoming.priority:
            del self._queue[worst_j]
            return worst
        return incoming

    def poll(self, req_id: int) -> Optional[Request]:
        """The finished request, or None while queued / in flight."""
        return self._results.get(req_id)

    def pop_result(self, req_id: int) -> Optional[Request]:
        """Like :meth:`poll`, but removes the finished request, so a
        long-running caller keeps the results map bounded."""
        return self._results.pop(req_id, None)

    def tick(self) -> int:
        """One scheduler round (retire → expire / reap → admit → decode);
        returns the number of slots live afterwards."""
        tick = self._tick_no
        self._tick_no += 1
        if self._watchdog is not None and (
                self._queue or any(r is not None for r in self._slots)):
            # arm before the work: a first tick after idle that wedges trips
            self._watchdog.beat()
        try:
            live = self._tick_body(tick)
        except BaseException:
            # a fatal fault leaving tick() must not leave the watchdog armed
            if self._watchdog is not None:
                self._watchdog.disarm()
            raise
        if self._watchdog is not None:
            if live or self._queue:
                self._watchdog.beat()
            else:
                self._watchdog.disarm()  # idle is not a hang
        self._flush_postmortems(force=not (live or self._queue))
        return live

    def _tick_body(self, tick: int) -> int:
        inj = self.fault_injector
        obs = self.obs
        if inj is not None:
            inj.maybe_hang_tick(tick)
            wedge = inj.wedge_slot(tick)
            if wedge is not None:
                # silently freeze the row — the scheduler is NOT told, so
                # only the reaper can recover the request
                self._freeze_rows([wedge])
            # tier chaos: a spill storm force-spills every unreferenced
            # cache entry; a corruption flips payload bytes so the next
            # restore must fail its digest check
            if inj.spill_storm(tick):
                self.spill_all()
            if inj.corrupt_tier(tick):
                self.corrupt_tiers()
        t0 = time.perf_counter()
        self._retire()
        self._expire_and_reap()
        obs.span_from("tick.retire", t0)
        t0 = time.perf_counter()
        self._admit()
        obs.span_from("tick.admit", t0)
        if self.paged:
            self.stats.note_pages(self._allocator.used_pages)
            if self._tiers is not None:
                self._stamp_tier_stats()
        self.stats.queue_depth = len(self._queue)
        live = sum(r is not None for r in self._slots)
        self.stats.occupancy = live
        if live:
            try:
                if inj is not None:
                    slot = inj.nan_logits_slot(tick)
                    if slot is not None:
                        self._inject_nan(slot)
                    inj.maybe_fail_decode(tick)
                # the step returns once its kernels are queued; the status
                # read is where the host waits on the device
                t0 = time.perf_counter()
                status = self._step(self._pool)
                obs.span_from("tick.decode_dispatch", t0, live=live)
                t0 = time.perf_counter()
                self._status = status.cpu().numpy()
                obs.span_from("tick.status_fetch", t0)
                self.stats.decode_steps += 1
            except Exception as e:  # noqa: BLE001 — a device fault: self-heal, bounded
                self._rebuild_and_resubmit(e)
                live = 0
        return live

    def drain(self, max_ticks: int = 0) -> Dict[int, Request]:
        """Tick until queue and pool are empty; returns all results.  The
        reaper guarantees progress, so the tick bound is a backstop for
        scheduler bugs."""
        max_ticks = max_ticks or (len(self._queue) + self.num_slots + 1) * (
            self.steps + self.cfg.serve_reap_margin + 2)
        ticks = 0
        while self._queue or any(r is not None for r in self._slots):
            self.tick()
            ticks += 1
            if ticks > max_ticks:
                if self._watchdog is not None:
                    self._watchdog.disarm()
                raise RuntimeError(f"drain exceeded {max_ticks} ticks — a slot is not retiring")
        self._retire()  # rows finished by the final decode step
        if self._watchdog is not None:
            self._watchdog.disarm()
        self._flush_postmortems(force=True)
        return self._results

    def shed_all(self, reason: str = "graceful drain deadline") -> int:
        """Resolve every queued AND in-flight request as SHED (in-flight rows
        with their partial tokens) — the bounded-shutdown escape hatch.
        Returns the number shed."""
        now = self.clock()
        n = 0
        while self._queue:
            self._finish(self._queue.popleft(), RequestStatus.SHED, error=reason, now=now)
            n += 1
        freeze = []
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            freeze.append(i)
            self._finish_slot(i, RequestStatus.SHED, error=reason, now=now)
            n += 1
        self._release_rows(freeze)
        if self._watchdog is not None:
            self._watchdog.disarm()
        self._flush_postmortems(force=True)
        return n

    def shed_oldest(self, reason: str = "shed by admission control") -> Optional[Request]:
        """Shed the QUEUED request at the head of the FIFO (SHED, no
        tokens); None when nothing is queued."""
        if not self._queue:
            return None
        req = self._queue.popleft()
        self._finish(req, RequestStatus.SHED, error=reason)
        self._flush_postmortems()
        return req

    def words(self, req: Request) -> List[str]:
        """Detokenized summary, truncated at the first EOS."""
        assert self.tgt_vocab is not None, "engine built without a tgt vocab"
        toks = req.tokens if req.tokens is not None else []
        out = [self.tgt_vocab.i2w.get(int(t), "<unk>") for t in toks]
        return out[: out.index(EOS_WORD)] if EOS_WORD in out else out

    def partial_tokens(self) -> Dict[int, np.ndarray]:
        """Tokens decoded so far for every IN-FLIGHT slot, by request id,
        from the last status snapshot (one read of the token rows, outside
        :meth:`tick`).  A row flagged non-finite excludes its newest token,
        the one its NaN-guard retire drops."""
        out: Dict[int, np.ndarray] = {}
        if self._status is None:
            return out
        pos, bad = self._status[:, 0], self._status[:, 2]
        toks = None
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            n = min(int(pos[i]) - (1 if bad[i] else 0), req.limit)
            if n <= 0:
                continue
            if toks is None:
                toks = self._pool.toks.cpu().numpy()
            out[req.id] = np.array(toks[i, :n], dtype=np.int32)
        return out

    @property
    def occupancy(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def ticks(self) -> int:
        """Next tick ordinal — the time base of the tick faults."""
        return self._tick_no

    @property
    def prefills(self) -> int:
        """Next prefill-call ordinal — the time base of prefill faults."""
        return self._n_prefills

    def page_leaks(self) -> int:
        """Pages allocated beyond what live slots hold and the prefix cache
        pins — at quiescence any positive value is a leaked chain (0 in the
        rect layout, which has no pages)."""
        if not self.paged:
            return 0
        pinned = self._prefix.pinned_pages if self._prefix is not None else 0
        held = sum(len(p.self_chain) + (0 if p.shared else len(p.cross_chain))
                   for p in self._slot_meta if p is not None)
        return self._allocator.used_pages - pinned - held

    def chain_leaks(self) -> int:
        """Tier-side chain accounting errors, meaningful at quiescence (0
        with tiering off): keys held both by the prefix cache and by a tier
        — a spill and a restore are moves, an entry lives in one place —
        plus the store's own audit (occupancy gauges against the indexed
        pages, the tiers disjoint).  :meth:`page_leaks` is the allocator's
        check; the two compose."""
        if self._tiers is None:
            return 0
        bad = self._tiers.accounting_errors()
        return bad + sum(1 for h in self._prefix.keys() if h in self._tiers)

    def spill_all(self) -> int:
        """Spill EVERY unreferenced prefix-cache entry down the tiers — the
        ``spill_storm`` fault's hook, and a lever before scale-down (empty
        the card's cache, keep the value).  Entries with live sharers stay.
        Returns the number of chains spilled."""
        if self._tiers is None:
            return 0
        pairs = self._prefix.evict_for(1 << 30)
        self._spill_chains(pairs)
        if pairs:
            self.obs.emit("tier.spill_all", chains=len(pairs))
        return len(pairs)

    def corrupt_tiers(self) -> int:
        """Flip payload bytes in every tiered snapshot (both tiers), keeping
        the recorded digests — the ``corrupt_tier_restore`` fault's hook: the
        next restore of each must be a structured ``tier.restore_miss`` and
        a re-prefill, never a wrong chain.  Returns the entries corrupted."""
        if self._tiers is None:
            return 0
        return self._tiers.corrupt_entries()

    def _stamp_tier_stats(self) -> None:
        """Mirror the store's occupancy gauges and lifetime counters onto
        the stats (the scrape surface reads only those)."""
        t = self._tiers
        self.stats.tier_host_pages = t.host_pages_in_use
        self.stats.tier_disk_pages = t.disk_pages_in_use
        self.stats.tier_spills = t.spills
        self.stats.tier_demotions = t.demotions
        self.stats.tier_restores = t.restores
        self.stats.tier_restore_misses = t.restore_misses

    def _retry_hint(self) -> Optional[float]:
        """Backpressure hint of REJECTED / SHED outcomes: the configured base
        scaled by queue depth over the slot pool (None when off)."""
        base = self.cfg.serve_retry_after_s
        if base <= 0:
            return None
        return round(base * (1.0 + len(self._queue) / max(self.num_slots, 1)), 3)

    def reset_stats(self) -> ServeStats:
        """Fresh counters (program count carried over): warm first, then
        measure a clean window."""
        old = self.stats
        self.stats = ServeStats(self.num_slots)
        self.stats.carry_compiles(old)
        self.stats.started_t = self.clock()
        self._sync_page_stats()
        return self.stats

    def _sync_page_stats(self) -> None:
        if self.paged:
            self.stats.set_page_info(self._allocator.usable, self.geo.rect_pages_per_slot,
                                     kv_ratio=KV_PAGE_RATIO[self.cfg.serve_kv_page_dtype])
        # the devices this engine's pages span (1 solo); every shard holds
        # every page's heads, so the worst shard's occupancy is the pool's
        self.stats.mesh_devices = 1 if self.mesh is None else len(self.mesh.devices)

    # ---------------- terminal transitions ----------------

    def _finish(self, req: Request, status: str, error: Optional[str] = None,
                now: Optional[float] = None) -> None:
        """One-way transition to a terminal outcome: timestamps, payload
        release, result publication, counters, events and the trace."""
        assert status in RequestStatus.TERMINAL, status
        now = self.clock() if now is None else now
        req.status = status
        req.error = error
        req.done_t = now
        req.sample = None
        if status == RequestStatus.OK:
            self.stats.record_request(req.submit_t, req.admit_t, now, req.n_tokens,
                                      priority=req.priority, trace_id=req.trace_id)
            self.obs.emit("req.ok", id=req.id, n_tokens=req.n_tokens, **_tf(req))
        else:
            if status in (RequestStatus.REJECTED, RequestStatus.SHED):
                req.retry_after_s = self._retry_hint()
            self.stats.record_outcome(status)
            # the terminal event first, so the dump that follows holds it
            self.obs.emit("req." + status.lower(), id=req.id, n_tokens=req.n_tokens,
                          error=error, retry_after_s=req.retry_after_s, **_tf(req))
            self._note_fault(status)
            if error:
                self.log(f"# serve: request {req.id} {status}: {error}")
        if req.trace_id:
            if req.admit_t is not None:
                self.tracer.span_from(req.trace_id, "decode", req.admit_t, now,
                                      n_tokens=req.n_tokens)
            self.tracer.finish(req.trace_id, status, t=now, n_tokens=req.n_tokens, id=req.id,
                               **({"error": error} if error else {}))
        self._results[req.id] = req

    def _finish_slot(self, i: int, status: str, error: Optional[str] = None,
                     now: Optional[float] = None, drop_last_token: bool = False) -> None:
        """Terminal transition of an IN-FLIGHT request: its tokens so far
        (from the last status snapshot), then the slot is freed.
        ``drop_last_token`` drops the newest token (argmax of non-finite
        log-probs)."""
        req = self._slots[i]
        assert req is not None
        pos = int(self._status[i, 0]) if self._status is not None else 0
        if drop_last_token:
            pos = max(pos - 1, 0)
        if pos > 0:
            req.n_tokens = pos
            req.tokens = np.array(self._pool.toks[i, :pos].cpu().numpy(), dtype=np.int32)
        self._slots[i] = None
        self._free_slot_meta(i)
        self._finish(req, status, error=error, now=now)

    # ---------------- page accounting ----------------

    def _free_slot_meta(self, i: int) -> None:
        """Return slot ``i``'s funding to the allocator / prefix cache — every
        terminal path of an admitted request goes through here."""
        plan = self._slot_meta[i]
        if plan is None:
            return
        self._slot_meta[i] = None
        self._free_plan(plan)

    def _free_plan(self, plan: PagePlan) -> None:
        self._allocator.free(plan.self_chain)
        if plan.shared:
            self._prefix.release(plan.phash)
        else:
            self._allocator.free(plan.cross_chain)

    def _alloc_with_evict(self, n: int) -> Optional[List[int]]:
        """``n`` pages, evicting unreferenced prefix-cache entries (LRU first)
        under pool pressure — entries with live sharers are never touched.
        With tiering on, the evicted chains are spilled, not destroyed."""
        chain = self._allocator.alloc(n)
        if chain is not None or self._prefix is None:
            return chain
        self._spill_chains(self._prefix.evict_for(n - self._allocator.free_pages))
        return self._allocator.alloc(n)

    def _spill_chains(self, pairs) -> None:
        """Retire evicted prefix-cache ``(hash, chain)`` pairs: with tiering
        on, each chain's pages and scales are snapshotted into the tier
        store FIRST (one gather, one read to the host, the digest recorded
        at put), then the pages go back to the allocator.  Only unreferenced
        entries get here: the prefix cache never evicts a chain a live slot
        reads."""
        for phash, chain in pairs:
            if self._tiers is not None and chain:
                vals, scales = tier_gather(self._pool, chain)
                payload = _host_array(vals)
                scales = scales.cpu().numpy()
                # values and their f32 scales travel as ONE digest-covered
                # byte string (values first); the header's kv_dtype makes a
                # restore into a differently stored pool a structured miss
                self._tiers.put(phash, payload.tobytes() + scales.tobytes(), {
                    "pages": len(chain),
                    "shape": list(payload.shape),
                    "dtype": _TIER_DTYPE_STR[self.cfg.serve_kv_page_dtype],
                    "scale_shape": list(scales.shape),
                    "scale_dtype": scales.dtype.str,
                    "kv_dtype": self.cfg.serve_kv_page_dtype,
                })
            self._allocator.free(chain)
        if pairs and self._tiers is not None:
            self._stamp_tier_stats()

    def _restore_miss(self, phash: bytes, reason: Optional[str], *chains) -> object:
        """A failed restore: the snapshot dropped with a structured miss
        (``reason``; None when the store already counted it), its chains
        refunded; the caller re-prefills."""
        if reason is not None:
            self._tiers.invalidate(phash, reason)
        for chain in chains:
            self._allocator.free(chain)
        self._stamp_tier_stats()
        return _RESTORE_MISS

    def _restore_plan(self, req: Request, phash: bytes, sp_need: int):
        """Fund an admission from a TIERED snapshot: fresh chains, the
        digest-verified bytes written into the cross chain, the chain put
        back into the prefix cache — from there the ordinary attach path, so
        a restored chain is bit-identical to one that never spilled.
        Returns a :class:`PagePlan`, None (unfundable this tick: the
        snapshot stays tiered and the request waits), or ``_RESTORE_MISS``
        (a structured ``tier.restore_miss{reason}`` was counted; the caller
        re-prefills)."""
        w = self._tiers.pages(phash)
        if w <= 0 or w > self.geo.cp:
            # an index entry no chain of this pool's geometry can match
            return self._restore_miss(phash, "truncated")
        self_chain = self._alloc_with_evict(sp_need)
        if self_chain is None:
            return None
        cross_chain = self._alloc_with_evict(w)
        if cross_chain is None:
            self._allocator.free(self_chain)
            return None
        t0 = time.perf_counter()
        payload, meta, _ = self._tiers.get(phash)
        if payload is None:
            return self._restore_miss(phash, None, cross_chain, self_chain)
        if meta.get("kv_dtype", "float32") != self.cfg.serve_kv_page_dtype:
            # digest-intact bytes of another storage dtype mean nothing to
            # this pool: an int8 snapshot must never land in an f32 pool
            return self._restore_miss(phash, "dtype_mismatch", cross_chain, self_chain)
        want = (self._tier_shape[0], 2, w) + self._tier_shape[3:]
        want_s = (self._tier_scale_shape[0], 2, w) + self._tier_scale_shape[3:]
        try:
            if list(meta["shape"]) != list(want) or list(meta["scale_shape"]) != list(want_s):
                raise ValueError("geometry")
            vdt = np.dtype(_TIER_NP[self.cfg.serve_kv_page_dtype])
            kb = int(np.prod(want)) * vdt.itemsize
            snap = np.frombuffer(payload[:kb], dtype=vdt).reshape(want)
            scales = np.frombuffer(payload[kb:], dtype=np.float32).reshape(want_s)
        except (KeyError, TypeError, ValueError):
            # digest-intact bytes that do not decode to THIS pool's snapshot
            # (geometry skew): never written into the pool
            return self._restore_miss(phash, "truncated", cross_chain, self_chain)
        if (meta["dtype"] != _TIER_DTYPE_STR[self.cfg.serve_kv_page_dtype]
                or meta.get("scale_dtype") != "<f4"):
            # a lying header: its kv_dtype names this pool's, its arrays'
            # dtypes do not
            return self._restore_miss(phash, "dtype_mismatch", cross_chain, self_chain)
        vals = torch.from_numpy(snap.copy())
        if self.cfg.serve_kv_page_dtype == "bfloat16":
            vals = vals.view(torch.bfloat16)
        tier_restore(self._pool, cross_chain, vals, torch.from_numpy(scales.copy()))
        self._tiers.drop(phash)  # moved back onto the card (a re-spill re-snapshots)
        self.stats.note_tier_restore(time.perf_counter() - t0)
        evicted = self._prefix.insert(phash, cross_chain)
        if evicted:
            self._spill_chains(evicted)
        # a restored admission IS a prefix hit: the encoder never runs
        self.stats.prefix_hits += 1
        self._prefix.count_hit(phash)
        self._stamp_tier_stats()
        return PagePlan(self_chain, cross_chain, phash, hit=True, shared=evicted is not None)

    def _plan_pages(self, req: Request) -> Optional[PagePlan]:
        """Fund one request's chains — self sized by its budget, cross by its
        bucket, or a prefix-cache hit sharing an existing cross chain, or a
        tiered snapshot restored into fresh pages (a failed restore falls
        back to the miss path).  None (no state change) when the pool cannot
        fund it this tick."""
        sp_need = self.geo.self_pages(req.limit)
        phash = None
        if self._prefix is not None:
            phash = req.phash if req.phash is not None else sample_hash(req.sample)
            entry = self._prefix.acquire(phash)
            if entry is not None:
                self_chain = self._alloc_with_evict(sp_need)
                if self_chain is None:
                    self._prefix.release(phash)
                    return None
                self.stats.prefix_hits += 1
                self._prefix.count_hit(phash)
                return PagePlan(self_chain, list(entry.chain), phash, hit=True, shared=True)
            if self._tiers is not None and self._tiers.has(phash):
                plan = self._restore_plan(req, phash, sp_need)
                if plan is not _RESTORE_MISS:
                    return plan
        self_chain = self._alloc_with_evict(sp_need)
        if self_chain is None:
            return None
        cross_chain = self._alloc_with_evict(self.geo.cross_pages(self.specs[req.bucket].n))
        if cross_chain is None:
            self._allocator.free(self_chain)
            return None
        # counted on the funded plan: a request waiting under backpressure is
        # re-planned every tick and must not deflate the hit rate
        if self._prefix is not None:
            self.stats.prefix_misses += 1
            self._prefix.count_miss()
        return PagePlan(self_chain, cross_chain, phash)

    def _release_rows(self, slots: Sequence[int]) -> None:
        """Pool half of retirement: zero the budget and null the page-table
        rows, so the rows' dead writes land on the null page while their
        freed pages serve other requests (the rect layout only zeroes the
        budget: its rows own their rectangles)."""
        if not len(slots):
            return
        if self.paged:
            release(self._pool, slots)
        else:
            self._freeze_rows(slots)

    def _freeze_rows(self, slots: Sequence[int]) -> None:
        """Zero the budget of ``slots`` only (the decode step then treats
        them as frozen); the host side is the caller's job."""
        if len(slots):
            self._pool.limit.index_fill_(
                0, torch.tensor(list(slots), dtype=torch.long, device=self.device), 0)

    def _inject_nan(self, slot: int) -> None:
        """Fault drill: NaN the scales of the slot's self pages, so its next
        logits are non-finite on f32, bf16 and int8 pages alike (the scales
        multiply every gathered lane).  The pages return to the free list
        NaN-laden when the row retires FAILED; admission scrubs them.  In
        the rect layout the slot's self rectangles are NaN'd (prefill zeroes
        them for the next request)."""
        if not self.paged:
            for c in self._pool.cache:
                c["k"][slot] = float("nan")
                c["v"][slot] = float("nan")
            return
        meta = self._slot_meta[slot]
        assert meta is not None, f"nan drill on an empty slot {slot}"
        ids = torch.tensor(meta.self_chain, dtype=torch.long, device=self.device)
        for _, _, layers in page_sets(self._pool):
            at = ids.to(layers[0]["k"].device)
            for e in layers:
                e["k_scale"].index_fill_(0, at, float("nan"))
                e["v_scale"].index_fill_(0, at, float("nan"))

    # ---------------- scheduler internals ----------------

    def _retire(self) -> None:
        if self._status is None or not any(r is not None for r in self._slots):
            return
        pos, done, bad = self._status[:, 0], self._status[:, 1], self._status[:, 2]
        now = self.clock()
        bad_rows = [i for i, req in enumerate(self._slots) if req is not None and bad[i]]
        if bad_rows:
            self._release_rows(bad_rows)
            for i in bad_rows:
                self.obs.emit("fault.nan_guard", slot=i, id=self._slots[i].id)
                self._finish_slot(i, RequestStatus.FAILED,
                                  error="non-finite logits during decode", now=now,
                                  drop_last_token=True)
        toks = None
        for i, req in enumerate(self._slots):
            if req is None or not (done[i] or pos[i] >= req.limit):
                continue
            if toks is None:
                toks = self._pool.toks.cpu().numpy()
            req.n_tokens = int(pos[i])
            req.tokens = np.array(toks[i, : req.n_tokens], dtype=np.int32)
            self._slots[i] = None
            self._free_slot_meta(i)
            self._finish(req, RequestStatus.OK, now=now)
        # no release for OK retires: a row that finishes nulls its own table
        # rows inside the decode step, before its pages can be handed out

    def _expire_and_reap(self) -> None:
        """Deadline expiry (queued and in flight) and stuck-slot reaping."""
        now = self.clock()
        if self._has_deadlines and self._queue and any(
                r.deadline_t is not None and now > r.deadline_t for r in self._queue):
            keep: Deque[Request] = deque()
            for req in self._queue:
                if req.deadline_t is not None and now > req.deadline_t:
                    self._finish(req, RequestStatus.TIMEOUT, error="deadline expired in queue",
                                 now=now)
                else:
                    keep.append(req)
            self._queue = keep
        freeze = []
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            if req.deadline_t is not None and now > req.deadline_t:
                freeze.append(i)
                self._finish_slot(i, RequestStatus.TIMEOUT, error="deadline expired in flight",
                                  now=now)
                continue
            # a healthy row retires within `limit` ticks of admission; past
            # limit + margin it is wedged — fail it so the pool keeps moving
            if (req.admit_tick is not None
                    and self._tick_no - req.admit_tick > req.limit + self.cfg.serve_reap_margin):
                freeze.append(i)
                self.stats.reaped += 1
                self.obs.emit("fault.reap", id=req.id, slot=i,
                              ticks=self._tick_no - req.admit_tick)
                self._finish_slot(
                    i, RequestStatus.FAILED,
                    error=f"stuck slot reaped after {self._tick_no - req.admit_tick} ticks",
                    now=now)
        self._release_rows(freeze)

    def _requeue_remainder(self, window: List[Request], remainder: List[Request]) -> None:
        """Put a window's unadmitted requests back at the queue head in
        SUBMISSION order (not the bucket-sorted admission order)."""
        pending = {id(r) for r in remainder}
        self._queue.extendleft(reversed([r for r in window if id(r) in pending]))

    def _admit(self) -> None:
        free = [i for i, r in enumerate(self._slots) if r is None]
        if not free or not self._queue:
            return
        take = min(len(free), len(self._queue))
        if self.cfg.serve_priority_classes > 1 and any(r.priority for r in self._queue):
            # the window is the `take` most important queued requests by
            # (tier, FIFO index); the skipped keep their queue positions
            qlist = list(self._queue)
            picked = sorted(range(len(qlist)), key=lambda j: (qlist[j].priority, j))[:take]
            picked_set = set(picked)
            window = [qlist[j] for j in picked]
            self._queue = deque(r for j, r in enumerate(qlist) if j not in picked_set)
        else:
            window = [self._queue.popleft() for _ in range(take)]
        groups: Dict[int, List[Request]] = defaultdict(list)
        for req in window:
            req.bucket = assign_prefill_bucket(self.specs, int(req.sample["num_node"]))
            groups[req.bucket].append(req)
        # buckets ascending, FIFO within one, slots in ascending order: the
        # request → (bucket, slot) map is a function of the trace alone
        order = [req for k in sorted(groups) for req in groups[k]]
        while order:
            k = order[0].bucket
            chunk: List[Request] = []
            plans: List[PagePlan] = []
            while order and order[0].bucket == k and len(chunk) < self.specs[k].batch_size:
                if self.paged:
                    plan = self._plan_pages(order[0])
                    if plan is None:
                        break  # the pool cannot fund this request this tick
                    plans.append(plan)
                chunk.append(order.pop(0))
            if not chunk:
                # page backpressure: a structured wait at the queue head
                self._requeue_remainder(window, order)
                return
            slot_ids = [free.pop(0) for _ in chunk]
            try:
                self._prefill_chunk(k, chunk, slot_ids, plans)
            except Exception as e:  # noqa: BLE001 — an admission fault fails its chunk
                now = self.clock()
                for j, req in enumerate(chunk):
                    if plans:
                        self._free_plan(plans[j])
                    self._finish(req, RequestStatus.FAILED,
                                 error=f"prefill failed: {type(e).__name__}: {e}", now=now)
                try:
                    self._release_rows(slot_ids)
                except Exception:  # noqa: BLE001 — the pool itself is gone
                    # a fault the pool cannot survive (a sticky device
                    # error): requeue the window's rest and rebuild, bounded
                    self._requeue_remainder(window, order)
                    self._rebuild_and_resubmit(e)
                    return
                free = sorted(slot_ids + free)

    def _prefill_chunk(self, k: int, chunk: List[Request], slot_ids: List[int],
                       plans: List[PagePlan]) -> None:
        """One bucket chunk's admission: misses run the encoder at the
        bucket's width and write their cross chains (then publish them to the
        prefix cache); hits attach without the encoder.  A fault fails the
        whole chunk (:meth:`_admit`).  The rect layout encodes every row."""
        spec = self.specs[k]
        if not self.paged:
            self._prefill_rect(k, chunk, slot_ids)
            return
        misses = [(r, s, p) for r, s, p in zip(chunk, slot_ids, plans) if not p.hit]
        hits = [(r, s, p) for r, s, p in zip(chunk, slot_ids, plans) if p.hit]
        if misses:
            call_ordinal = self._n_prefills
            self._n_prefills += 1
            if self.fault_injector is not None:
                self.fault_injector.maybe_fail_prefill(call_ordinal)
            if k not in self._prefill_built:
                self._prefill_built.add(k)
                self.stats.record_compile("prefill", (spec.n, spec.batch_size))
            t0 = time.perf_counter()
            traced = any(r.trace_id for r, _, _ in misses)
            c0 = self.clock() if traced else 0.0
            paged_prefill(self.model, self.cfg, self.geo, self._pool, spec.n,
                          [r.sample for r, _, _ in misses], [s for _, s, _ in misses],
                          [r.limit for r, _, _ in misses], [p.self_chain for _, _, p in misses],
                          [p.cross_chain for _, _, p in misses])
            self.obs.span_from(f"prefill.n{spec.n}", t0, rows=len(misses))
            if traced:
                c1 = self.clock()
                for r, _, _ in misses:
                    if r.trace_id:
                        self.tracer.span_from(r.trace_id, f"prefill.n{spec.n}", c0, c1,
                                              rows=len(misses))
            self.stats.prefill_calls += 1
            if self._prefix is not None:
                # publish the fresh chains: the cache owns them (refs=1, the
                # inserting request); a declined insert stays private.  What
                # the insert evicts to stay within capacity is spilled (freed
                # when tiering is off)
                for _, _, plan in misses:
                    evicted = self._prefix.insert(plan.phash, plan.cross_chain)
                    if evicted is not None:
                        plan.shared = True
                        self._spill_chains(evicted)
        if hits:
            smask = np.ones((len(hits), self.geo.mem_len), bool)
            for j, (r, _, _) in enumerate(hits):
                # identical hash ⇒ identical src_seq ⇒ identical pad mask;
                # keys past the bucket are masked as the miss path masks them
                sm = np.asarray(r.sample["src_seq"]) == PAD
                sm[spec.n:] = True
                smask[j] = sm
            t0 = time.perf_counter()
            traced = any(r.trace_id for r, _, _ in hits)
            c0 = self.clock() if traced else 0.0
            attach(self._pool, self.geo, [s for _, s, _ in hits], [r.limit for r, _, _ in hits],
                   [p.self_chain for _, _, p in hits], [p.cross_chain for _, _, p in hits], smask)
            self.obs.span_from("prefill.attach", t0, rows=len(hits))
            if traced:
                c1 = self.clock()
                for r, _, _ in hits:
                    if r.trace_id:
                        self.tracer.span_from(r.trace_id, "prefill.attach", c0, c1,
                                              rows=len(hits))
        self._mark_admitted(chunk, slot_ids, plans)

    def _prefill_rect(self, k: int, chunk: List[Request], slot_ids: List[int]) -> None:
        """One bucket chunk's admission in the rect layout: every row runs
        the encoder (no prefix cache) into its slot's rectangles."""
        spec = self.specs[k]
        call_ordinal = self._n_prefills
        self._n_prefills += 1
        if self.fault_injector is not None:
            self.fault_injector.maybe_fail_prefill(call_ordinal)
        if k not in self._prefill_built:
            self._prefill_built.add(k)
            self.stats.record_compile("prefill", (spec.n, spec.batch_size))
        t0 = time.perf_counter()
        traced = any(r.trace_id for r in chunk)
        c0 = self.clock() if traced else 0.0
        rect_prefill(self.model, self.cfg, self._pool, spec.n, [r.sample for r in chunk],
                     slot_ids, [r.limit for r in chunk])
        self.obs.span_from(f"prefill.n{spec.n}", t0, rows=len(chunk))
        if traced:
            c1 = self.clock()
            for r in chunk:
                if r.trace_id:
                    self.tracer.span_from(r.trace_id, f"prefill.n{spec.n}", c0, c1,
                                          rows=len(chunk))
        self.stats.prefill_calls += 1
        self._mark_admitted(chunk, slot_ids, [])

    def _mark_admitted(self, chunk: List[Request], slot_ids: List[int],
                       plans: List[PagePlan]) -> None:
        self.stats.admitted += len(chunk)
        now = self.clock()
        for j, (req, s) in enumerate(zip(chunk, slot_ids)):
            req.admit_t = now
            req.slot = s
            req.admit_tick = self._tick_no
            self._slots[s] = req
            self._slot_meta[s] = plans[j] if plans else None
            hit = bool(plans and plans[j].hit)
            self.obs.emit("req.admit", id=req.id, slot=s, bucket=req.bucket, hit=hit,
                          **_tf(req))
            if req.trace_id:
                self.tracer.span_from(req.trace_id, "queue_wait", req.submit_t, now)
                self.tracer.event(req.trace_id, "admit", t=now, slot=s, bucket=req.bucket,
                                  hit=hit)

    def _rebuild_and_resubmit(self, exc: BaseException) -> None:
        """Self-healing after a fault escaped the decode step or left the pool
        unusable: drop the pool, the free list and the prefix cache, build a
        fresh pool at the same shapes, and resubmit in-flight work at the
        queue head in submission order.  Tokens are delivered only at the
        terminal transition, so a resubmission is at-most-once per attempt;
        a request past ``serve_max_retries`` resolves FAILED, and past
        ``serve_max_rebuilds`` the fault propagates (so does a rebuild that
        itself fails, after counting: a sticky device error needs a new
        process, not a retry loop)."""
        if self._rebuilds >= self.cfg.serve_max_rebuilds:
            self.obs.emit("fault.rebuild_cap", rebuilds=self._rebuilds,
                          error=f"{type(exc).__name__}: {exc}")
            if self._postmortem_dir:
                self.obs.postmortem(self._postmortem_dir, "rebuild_cap")
            raise RuntimeError(
                f"device fault after {self._rebuilds} rebuilds (serve_max_rebuilds="
                f"{self.cfg.serve_max_rebuilds}): {type(exc).__name__}: {exc}") from exc
        self._rebuilds += 1
        self.stats.rebuilds += 1
        inflight = [r for r in self._slots if r is not None]
        self.obs.emit("fault.rebuild", rebuild=self._rebuilds, inflight=len(inflight),
                      error=f"{type(exc).__name__}: {exc}")
        self._note_fault("rebuild")
        self.log(f"# serve: device fault ({type(exc).__name__}: {exc}) — rebuild "
                 f"#{self._rebuilds}, resubmitting {len(inflight)} in-flight request(s)")
        self._slots = [None] * self.num_slots
        self._slot_meta = [None] * self.num_slots
        self._status = None
        # the free list, every prefix refcount and the tiers go with the
        # pool: in-flight sharers are requeued below and re-fund from
        # scratch, and snapshots gathered from a faulting device are not
        # trusted across a rebuild
        if self.paged:
            self._allocator = PageAllocator(self.geo.num_pages)
        if self._prefix is not None:
            self._prefix.clear()
        if self._tiers is not None:
            self._tiers.clear()
            self._stamp_tier_stats()
        self._pool = None
        self._pool = self._fresh_pool()
        now = self.clock()
        survivors = []
        for req in sorted(inflight, key=lambda r: r.id):
            req.attempts += 1
            req.slot = req.bucket = req.admit_t = req.admit_tick = None
            if req.attempts > self.cfg.serve_max_retries:
                self._finish(req, RequestStatus.FAILED,
                             error=f"device fault, retries exhausted ({req.attempts - 1} "
                                   f"resubmissions): {type(exc).__name__}: {exc}", now=now)
            else:
                survivors.append(req)
                if req.trace_id:
                    self.tracer.event(req.trace_id, "rebuild_requeue", t=now,
                                      attempt=req.attempts)
        self._queue.extendleft(reversed(survivors))  # FIFO order preserved

    # ---------------- conveniences ----------------

    def generate(self, samples: Sequence[Dict[str, np.ndarray]],
                 max_new_tokens: int = 0) -> List[Request]:
        """Submit-and-drain a list; results in submission order."""
        ids = [self.submit(s, max_new_tokens) for s in samples]
        self.drain()
        return [self._results[i] for i in ids]


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as a host numpy array (bf16 as its raw 16 bits)."""
    t = t.contiguous().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
