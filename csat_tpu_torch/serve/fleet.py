"""Replica fleet: N ServeEngines behind one health-aware front door — the
JAX package's ``serve/fleet.py`` for the port.

The fleet turns the one continuous-batching engine into a service: it owns N
:class:`~csat_tpu_torch.serve.engine.ServeEngine` replicas and exposes the
engine's submit / poll / tick / drain door, so the CLI loop and the chaos
runner take either.  Every replica shares the one ``nn.Module`` it is given
(the weights are on the card once, and the fleet never changes the module:
no ``eval()`` toggle, no cast, no sharding) and runs on the device the
module lives on; each replica owns its KV page pool, queue, fault budgets,
stats and metrics registry, and post-mortem directory.  What the layer adds:

* **Routing** — deterministic join-shortest-queue dispatch over HEALTHY
  replicas (:class:`~csat_tpu_torch.serve.router.Router`); request →
  replica is a pure function of the submitted trace.
* **Fault domains** — a replica whose rebuild cap exhausts, whose tick
  watchdog times out, or whose reaped-slot count reaches
  ``serve_fleet_reap_storm`` moves to ``SICK``: its work is shed, its engine
  closed (its pool, tier buffers and watchdog thread go with it), and only
  its zero-token requests are resubmitted to healthy replicas, bounded by
  ``serve_max_retries``, behind capped exponential backoff with
  deterministic jitter.  The fleet keeps serving at ``(N-1)/N`` capacity,
  and faults on replica k never touch the other replicas' schedules.
* **Fleet admission control** — a global queue bound across healthy
  replicas (``serve_fleet_max_queue``, else ``serve_max_queue × healthy``)
  under ``serve_queue_policy``: "reject" the new request, or "shed_oldest"
  from the deepest healthy queue through the engine's public
  :meth:`~csat_tpu_torch.serve.engine.ServeEngine.shed_oldest`.
* **Observability** — every replica's registry scrapes under a
  ``replica="k"`` label (:meth:`prometheus`) or a ``replica<k>_`` key
  prefix (:meth:`snapshot`); per-replica post-mortems land in
  ``postmortem/replica<k>/``; :meth:`summary` merges the replicas' latency
  histograms (``obs.metrics.merge_histograms``), never averaging
  percentiles.  One request tracer is shared by the fleet and every replica,
  and a resubmission reopens the same trace.
* **Elasticity** — :meth:`add_replica` brings up a fresh engine through the
  one shared warm-start store (``serve/warmstart.py``; on the card each new
  engine books the store's verdict for every kernel library it serves
  with) and enters it into rotation once it is built; :meth:`set_target` +
  :meth:`drain_replica` give scale-down the same drain-then-close path.
  ``capacity_frac`` is measured against the target count.  Replica indices
  are monotonic; a spawn that dies is a structured ``fleet.spawn_failed``,
  never an exception.  Replica k may serve on a serve mesh of its own
  (``mesh_shapes[k]``, its head shards on ``mesh_devices[k]``).  Tiered
  replicas share the config's ``serve_tier_dir``, as the JAX fleet's do.

The fleet composes engines through their public surface only
(``tests/test_torch_fleet.py`` scans this module, the router, the
autoscaler, the chaos runner and the invariant monitor for private reads).
Fleet ids are their own namespace: callers hold fleet ids, the fleet maps
them to (replica, engine id) and rewrites the id on the returned request.

Registry metric names, event names, ``summary`` keys and the Prometheus text
are JAX's.  Unlike the JAX fleet, which takes ``params`` beside the model and
a ``sample_seed`` for the sampled eval graph, the port's weights live in the
module, and its engine serves without a seed of its own.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from csat_tpu_torch.configs import Config
from csat_tpu_torch.obs import EventRecorder, Tracer
from csat_tpu_torch.obs.metrics import MetricsRegistry, merge_histograms
from csat_tpu_torch.serve.engine import Request, RequestStatus, ServeEngine
from csat_tpu_torch.serve.router import DRAINING, HEALTHY, SICK, Router
from csat_tpu_torch.serve.warmstart import WarmStartStore, store_root

__all__ = ["Fleet", "Replica"]

# numeric health encoding for the per-replica `serve_health_state` gauge
# (tools/obs_report.py renders it back to the state name)
_HEALTH_CODE = {HEALTHY: 0, DRAINING: 1, SICK: 2}


@dataclasses.dataclass
class Replica:
    """One engine plus its fleet-visible health record."""

    index: int
    engine: Optional[ServeEngine]
    health: str = HEALTHY
    sick_reason: Optional[str] = None
    # stamped by the engine watchdog's on_timeout (monitor thread); the
    # scheduler thread acts on it at the next fleet tick — retiring a
    # replica from the monitor thread would race the tick loop
    watchdog_tripped: bool = False
    closed: bool = False


@dataclasses.dataclass
class _PendingSubmit:
    """What the fleet retains to resubmit a queued request whose replica
    retired: the original submit arguments (the engine releases its copy
    of ``sample`` at any terminal transition, so the fleet keeps its own
    reference until the request reaches a terminal state it will not
    retry)."""

    sample: Dict[str, Any]
    max_new_tokens: int
    deadline_t: Optional[float]  # absolute; remaining time recomputed at retry
    attempts: int = 0
    priority: int = 0            # tenant tier, re-submitted verbatim
    backoff_s: float = 0.0       # total backoff this request has served
    trace_id: str = ""           # fleet-minted request trace — every retry
    #                              attempt lands on this SAME trace


@dataclasses.dataclass
class _ScheduledRetry:
    """A resubmission waiting out its backoff: the fleet holds the request
    off the routing table until ``due_t`` (capped exponential backoff with
    deterministic jitter), then re-routes it to a healthy replica."""

    fid: int
    due_t: float
    from_replica: int


class Fleet:
    """N ``ServeEngine`` replicas behind one submit/poll/tick/drain door."""

    def __init__(
        self,
        model: Any,
        cfg: Config,
        replicas: int = 0,
        tgt_vocab: Any = None,
        clock: Callable[[], float] = time.monotonic,
        log: Callable[[str], None] = lambda m: None,
        mesh_shapes: Optional[Sequence[Sequence[int]]] = None,
        mesh_devices: Optional[Sequence[Optional[Sequence]]] = None,
    ):
        n = replicas or cfg.serve_replicas
        assert n >= 1, n
        self.cfg = cfg
        # per-replica serve-mesh override: replica k gets mesh_shapes[k] as
        # its serve_mesh_shape (entries beyond the list inherit cfg) and its
        # head shards on mesh_devices[k] (None: the engine's default) — a
        # fleet can mix solo and mesh-sharded members, and every fleet
        # behavior (routing, retirement, resubmission, chaos) treats them
        # alike because a sharded engine is exactly engine-shaped
        self._mesh_shapes = (None if mesh_shapes is None
                             else [tuple(int(x) for x in s)
                                   for s in mesh_shapes])
        self._mesh_devices = None if mesh_devices is None else list(mesh_devices)
        self.clock = clock
        self.log = log
        self.router = Router()
        self.obs = EventRecorder(capacity=cfg.obs_events, component="fleet")
        # ONE tracer shared by the fleet and every replica engine
        # (_make_replica swaps it in): a trace minted at fleet submit
        # follows the request across routing, retirement, backoff and
        # resubmission — replica boundaries never split a trace
        self.tracer = Tracer(capacity=cfg.obs_traces,
                             slowest=cfg.obs_trace_slowest, component="fleet")
        pm = cfg.obs_postmortem_dir
        self._postmortem_dir = (
            os.path.join(cfg.output_dir, "postmortem") if pm == "auto" else pm)
        self.registry = MetricsRegistry()
        self._m_submitted = self.registry.counter(
            "fleet_requests_submitted_total", "requests accepted by the fleet")
        self._m_rejected = self.registry.counter(
            "fleet_requests_rejected_total",
            "fleet-level rejections (no healthy replica / fleet queue full)")
        self._m_shed = self.registry.counter(
            "fleet_sheds_total", "fleet admission-control shed_oldest calls")
        self._m_resubmitted = self.registry.counter(
            "fleet_resubmissions_total",
            "requests moved from a retired replica to a healthy one")
        self._m_retired_replicas = self.registry.counter(
            "fleet_replicas_retired_total", "replicas moved to SICK")
        self._m_spawned = self.registry.counter(
            "fleet_replicas_spawned_total",
            "replicas added after construction (healing / scale-up)")
        self._m_spawn_failed = self.registry.counter(
            "fleet_spawns_failed_total",
            "replica spawn attempts that died during bring-up")
        self._m_target = self.registry.gauge(
            "fleet_target_replicas",
            "desired replica count (autoscaler-adjusted)")
        self._m_healthy = self.registry.gauge(
            "fleet_healthy_replicas", "replicas currently in rotation")
        self._m_capacity = self.registry.gauge(
            "fleet_capacity_frac", "healthy decode slots / total decode slots")
        self._m_queue = self.registry.gauge(
            "fleet_queue_depth", "queued requests across live replicas")
        self._m_occupancy = self.registry.gauge(
            "fleet_slots_occupied", "busy decode slots across live replicas")
        self.registry.gauge("fleet_replicas", "configured replica count").set(n)

        # replica factory inputs, retained for add_replica (healing /
        # scale-up builds engines long after construction); every replica
        # serves the one module on the device it lives on
        self._model = model
        self._tgt_vocab = tgt_vocab
        # ONE warm-start store shared by every replica (public: the chaos
        # harness corrupts it through this handle): the first bring-up
        # builds and publishes the kernel libraries; every later engine
        # asks the store for each one and books its verdict
        self.warmstart = (WarmStartStore(store_root(cfg), log=log)
                          if cfg.serve_warmstart else None)
        # chaos hook (arm_spawn_kill): the next N spawns die mid-bring-up
        self._spawn_kills = 0
        self.replicas: List[Replica] = []
        for k in range(n):
            rep = self._make_replica(k)
            rep.health = HEALTHY
            self.replicas.append(rep)
        # desired replica count — capacity_frac's denominator. set_target
        # moves it; healing closes the gap between it and the healthy count
        self._target_replicas = n

        # fleet id → (replica index, engine-local id); the route is the
        # single source of truth for where a request currently lives
        self._routes: Dict[int, tuple] = {}
        # fleet id → retained submit args while non-terminal (resubmission)
        self._pending: Dict[int, _PendingSubmit] = {}
        # fleet id → scheduled resubmission serving its backoff; while an
        # entry is here, poll() reports the request in flight (the retired
        # replica's SHED is not the outcome unless the retry falls through)
        self._retrying: Dict[int, _ScheduledRetry] = {}
        # fleet-synthesized terminal results (fleet-level rejections)
        self._results: Dict[int, Request] = {}
        self._next_id = 0
        # fleet tick ordinal. Every replica engine is ticked exactly once
        # per fleet tick from construction on (warm-up included), so this
        # equals each live engine's next tick number — what fault drills
        # use to aim `serve_decode_fail_ticks` at a specific replica
        self.ticks = 0
        self.resubmissions = 0
        self.started_t = clock()
        self._update_gauges()

    # ---------------- public API (engine-shaped) ----------------

    def submit(
        self,
        sample: Dict[str, Any],
        max_new_tokens: int = 0,
        deadline_s: Optional[float] = None,
        priority: int = 0,
    ) -> int:
        """Route one request to the least-loaded HEALTHY replica; returns a
        fleet-scoped id — ALWAYS, matching the engine contract: fleet-level
        refusals (no healthy replica, fleet queue bound under policy
        "reject") resolve to a terminal REJECTED result immediately."""
        fid = self._next_id
        self._next_id += 1
        now = self.clock()
        self._m_submitted.inc()
        # mint the request trace HERE, before any outcome is possible, so
        # fleet-level rejections and routed requests alike have one
        tid = self.tracer.begin(None, t=now, id=fid, priority=priority)
        healthy = [r for r in self.replicas if r.health == HEALTHY]
        if not healthy:
            self._reject(fid, now, "no healthy replicas", trace_id=tid)
            return fid

        # fleet-wide admission control over the healthy queues
        bound = self.cfg.serve_fleet_max_queue or (
            self.cfg.serve_max_queue * len(healthy))
        if bound and sum(r.engine.queue_depth for r in healthy) >= bound:
            if self.cfg.serve_queue_policy == "reject":
                self._reject(fid, now, f"fleet queue full ({bound})",
                             trace_id=tid)
                return fid
            target = self.router.shed_target(self.replicas)
            if target is not None:
                shed = target.engine.shed_oldest(
                    f"shed by fleet admission control (queue {bound})")
                if shed is not None:
                    self._m_shed.inc()
                    self.obs.emit("fleet.shed_oldest",
                                  replica=target.index, engine_id=shed.id)

        rep = self.router.pick(self.replicas)
        if tid:
            # router placement decision as a span on the request's trace:
            # which replica won and against how much competition
            self.tracer.event(tid, "route", t=now, replica=rep.index,
                              **self.router.placement(rep, self.replicas))
        eid = rep.engine.submit(
            sample, max_new_tokens=max_new_tokens, deadline_s=deadline_s,
            priority=priority, trace_id=tid)
        self._routes[fid] = (rep.index, eid)
        self.obs.emit("fleet.route", id=fid, replica=rep.index, engine_id=eid,
                      **({"trace": tid} if tid else {}))
        if rep.engine.poll(eid) is None:
            # non-terminal: retain the submit args so a replica retirement
            # can move the request (terminal-at-submit outcomes stand)
            ddl = (self.cfg.serve_deadline_s if deadline_s is None
                   else deadline_s)
            self._pending[fid] = _PendingSubmit(
                sample=sample, max_new_tokens=max_new_tokens,
                deadline_t=(now + ddl) if ddl and ddl > 0 else None,
                priority=priority, trace_id=tid)
        self._update_gauges()
        return fid

    def poll(self, fid: int) -> Optional[Request]:
        """The finished request under its FLEET id, or None in flight."""
        req = self._results.get(fid)
        if req is not None:
            return req
        if fid in self._retrying:
            # a resubmission is serving its backoff: the retired replica's
            # SHED is not this request's outcome — it is still in flight
            return None
        route = self._routes.get(fid)
        if route is None:
            return None
        ri, eid = route
        req = self.replicas[ri].engine.poll(eid)
        if req is not None:
            req.id = fid  # callers hold fleet ids, not engine-local ids
            self._stamp_retry_record(req, self._pending.pop(fid, None))
        return req

    def pop_result(self, fid: int) -> Optional[Request]:
        """Like :meth:`poll` but removes the result (bounded memory under
        sustained traffic — same contract as the engine)."""
        req = self._results.pop(fid, None)
        if req is None:
            if fid in self._retrying:
                return None
            route = self._routes.get(fid)
            if route is None:
                return None
            ri, eid = route
            req = self.replicas[ri].engine.pop_result(eid)
            if req is None:
                return None
            req.id = fid
        self._routes.pop(fid, None)
        self._stamp_retry_record(req, self._pending.pop(fid, None))
        return req

    def partial_tokens(self) -> Dict[int, "np.ndarray"]:
        """In-flight tokens-so-far keyed by FLEET id (the engine-shaped
        streaming surface).  A request serving its resubmission backoff has
        no live slot and simply doesn't appear; after the retry lands its
        re-decoded prefix is identical (deterministic decode), so a
        streaming consumer's cursor stays valid across the move."""
        rev: Dict[Tuple[int, int], int] = {
            route: fid for fid, route in self._routes.items()}
        out: Dict[int, "np.ndarray"] = {}
        for rep in self.replicas:
            if rep.closed:
                continue
            for eid, toks in rep.engine.partial_tokens().items():
                fid = rev.get((rep.index, eid))
                if fid is not None:
                    out[fid] = toks
        return out

    @staticmethod
    def _stamp_retry_record(req: Request,
                            entry: Optional[_PendingSubmit]) -> None:
        """Surface the fleet's resubmission history on the terminal record
        (`attempts` / `backoff_s`) — postmortems and the CLI JSONL carry
        the same numbers the invariant monitors check."""
        if entry is not None and entry.attempts:
            req.attempts = max(req.attempts, entry.attempts)
            req.backoff_s = round(entry.backoff_s, 4)

    def tick(self) -> int:
        """One fleet round: tick every live replica, act on health trips
        (retire SICK replicas and move their work), close emptied DRAINING
        replicas; returns total slots still live."""
        self.ticks += 1
        self._flush_retries()
        live = 0
        storm = self.cfg.serve_fleet_reap_storm
        for rep in self.replicas:
            if rep.closed or rep.health == SICK:
                continue
            if rep.watchdog_tripped:
                self._retire_replica(rep, "watchdog timeout")
                continue
            try:
                live += rep.engine.tick()
            except Exception as e:  # noqa: BLE001 — engine-fatal: isolate it
                # the engine's own self-healing is exhausted (rebuild cap)
                # or its scheduler broke; in a fleet that retires ONE
                # replica instead of killing the service
                self._retire_replica(rep, str(e))
                continue
            if storm and rep.engine.stats.reaped >= storm:
                self._retire_replica(
                    rep, f"reap storm ({int(rep.engine.stats.reaped)} slots)")
                continue
            if (rep.health == DRAINING and not rep.engine.occupancy
                    and not rep.engine.queue_depth):
                rep.engine.close()
                rep.closed = True
        self._update_gauges()
        return live

    def drain(self, max_ticks: int = 0) -> Dict[int, Request]:
        """Tick until every live replica is idle; returns {fleet id:
        terminal Request} for every request the fleet still tracks."""
        steps = self.cfg.max_tgt_len - 1
        max_ticks = max_ticks or (
            (self.queue_depth + self.num_slots + 1)
            * (steps + self.cfg.serve_reap_margin + 2))
        ticks = 0
        while self._active():
            self.tick()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(
                    f"fleet drain exceeded {max_ticks} ticks — "
                    "a replica is not quiescing")
        return self.results()

    def generate(self, samples: Sequence[Dict[str, Any]],
                 max_new_tokens: int = 0) -> List[Request]:
        """Submit-all + drain convenience (warm-up, batch callers)."""
        ids = [self.submit(s, max_new_tokens=max_new_tokens) for s in samples]
        self.drain()
        return [self.poll(i) for i in ids]

    def shed_all(self, reason: str = "graceful drain deadline") -> int:
        """Shed every queued and in-flight request on every live replica
        (the graceful-shutdown escape hatch); returns the number shed."""
        n = 0
        for rep in self.replicas:
            if rep.closed or rep.health == SICK:
                continue
            n += rep.engine.shed_all(reason)
        # nothing survives to retry: the shed IS the terminal outcome —
        # scheduled resubmissions fall back to their replicas' SHED records
        self._pending.clear()
        self._retrying.clear()
        self._update_gauges()
        return n

    def drain_replica(self, k: int) -> None:
        """Operator-initiated retirement: replica ``k`` stops receiving
        new work, finishes what it holds, then closes (next ticks)."""
        rep = self.replicas[k]
        if rep.health == HEALTHY:
            rep.health = DRAINING
            self.obs.emit("fleet.draining", replica=k)
            self._update_gauges()

    # ---------------- elasticity ----------------

    def _make_replica(self, k: int) -> Replica:
        """Build replica ``k``: fresh engine, own postmortem dir, fleet
        watchdog override, shared warm-start store.  The replica starts
        DRAINING (invisible to the router — it is not in ``self.replicas``
        yet either); the caller promotes it to HEALTHY once the engine
        ctor has returned, i.e. once its kernel libraries are loaded."""
        cfg = self.cfg
        if self._postmortem_dir:
            cfg = cfg.replace(obs_postmortem_dir=os.path.join(
                self._postmortem_dir, f"replica{k}"))
        if self._mesh_shapes is not None and k < len(self._mesh_shapes):
            cfg = cfg.replace(serve_mesh_shape=self._mesh_shapes[k])
            cfg.validate()
        devices = (self._mesh_devices[k] if self._mesh_devices is not None
                   and k < len(self._mesh_devices) else None)
        rep = Replica(index=k, engine=None, health=DRAINING)

        def on_timeout(rep: Replica = rep) -> None:
            # replaces the engine watchdog's default os._exit(76): in a
            # fleet a wedged replica is a capacity event, not a process
            # event — flag it and let the next tick retire the replica
            rep.watchdog_tripped = True

        rep.engine = ServeEngine(
            self._model, cfg, device=self._model.device,
            tgt_vocab=self._tgt_vocab, clock=self.clock,
            watchdog_on_timeout=on_timeout, warmstart=self.warmstart,
            mesh_devices=devices,
            log=(lambda m, k=k: self.log(f"[replica{k}] {m}")))
        # replicas record spans into the FLEET's trace store: a trace
        # outlives the replica that served its first attempt
        rep.engine.tracer = self.tracer
        if self._spawn_kills > 0:
            # chaos kill_during_spawn: the replica dies after bring-up but
            # before promotion — stop its watchdog thread and fail the
            # spawn the way any mid-bring-up crash would
            self._spawn_kills -= 1
            rep.engine.close()
            raise RuntimeError("killed during spawn (chaos)")
        return rep

    def add_replica(self) -> Optional[Replica]:
        """Heal / scale up: bring up ONE fresh replica (monotonic index,
        own pool / queue / registry / postmortem dir) and enter it into
        rotation.  Never raises: a bring-up failure (chaos kill, OOM,
        corrupt store escalation) is a structured ``fleet.spawn_failed``
        event + None — the supervisor retries on its own cadence."""
        k = len(self.replicas)
        t0 = time.perf_counter()
        self.obs.emit("fleet.spawn_start", replica=k)
        try:
            rep = self._make_replica(k)
        except Exception as e:  # noqa: BLE001 — spawn failure is a capacity
            #                     event for the supervisor, never a crash
            self._m_spawn_failed.inc()
            self.obs.emit("fleet.spawn_failed", replica=k, error=str(e))
            self.log(f"# fleet: replica {k} spawn failed ({e})")
            return None
        # the engine is built (its kernel libraries loaded): promote
        rep.health = HEALTHY
        self.replicas.append(rep)
        self._m_spawned.inc()
        s = rep.engine.stats
        self.obs.emit(
            "fleet.spawn", replica=k, cold_start_s=s.cold_start_s,
            warm=int(s.warmstart_hits), cold=int(s.warmstart_misses),
            spawn_s=round(time.perf_counter() - t0, 4))
        self.log(
            f"# fleet: replica {k} spawned in {s.cold_start_s:.2f}s "
            f"({int(s.warmstart_hits)} warm / {int(s.warmstart_misses)} cold "
            f"libraries); capacity {self.capacity_frac:.2f}")
        self._update_gauges()
        return rep

    def set_target(self, n: int) -> None:
        """Move the desired replica count (the autoscaler's lever and
        ``capacity_frac``'s denominator). Floor 1 — a fleet with a zero
        target is a shutdown, which is :meth:`close`'s job."""
        self._target_replicas = max(1, int(n))
        self._update_gauges()

    def arm_spawn_kill(self, count: int = 1) -> None:
        """Chaos hook (``kill_during_spawn`` fault kind): the next
        ``count`` spawn attempts die during bring-up."""
        self._spawn_kills += int(count)

    def close(self) -> None:
        """Close every replica (idempotent — engine.close guards)."""
        for rep in self.replicas:
            rep.engine.close()
            rep.closed = True

    def words(self, req: Request) -> List[str]:
        return self.replicas[0].engine.words(req)

    # ---------------- state the router / callers read ----------------

    @property
    def num_slots(self) -> int:
        # live (non-closed) replicas: retired and drained-out engines no
        # longer contribute slots a drive loop could fill
        return sum(r.engine.num_slots for r in self.replicas if not r.closed)

    @property
    def occupancy(self) -> int:
        return sum(r.engine.occupancy for r in self.replicas if not r.closed)

    @property
    def queue_depth(self) -> int:
        # scheduled resubmissions count as queued: they are accepted work
        # that has not reached a slot yet (drive loops must keep ticking)
        return (sum(r.engine.queue_depth
                    for r in self.replicas if not r.closed)
                + len(self._retrying))

    @property
    def healthy_replicas(self) -> List[Replica]:
        return [r for r in self.replicas if r.health == HEALTHY]

    @property
    def target_replicas(self) -> int:
        return self._target_replicas

    @property
    def capacity_frac(self) -> float:
        """Healthy decode slots as a fraction of the TARGET capacity —
        one of N equal replicas down reads (N-1)/N, and healing it reads
        1.0 again (the denominator is what the fleet should be running,
        not the monotonic count of every replica that ever existed)."""
        total = self._target_replicas * self.cfg.serve_slots
        healthy = sum(r.engine.num_slots for r in self.healthy_replicas)
        return healthy / total if total else 0.0

    @property
    def routes(self) -> Dict[int, int]:
        """fleet id → replica index (the router's decision record; the
        determinism test replays a trace and asserts equality)."""
        return {fid: ri for fid, (ri, _) in self._routes.items()}

    def results(self) -> Dict[int, Request]:
        """Every tracked request that has reached a terminal state, keyed
        by fleet id (fleet-synthesized rejections included)."""
        out: Dict[int, Request] = {}
        for fid in list(self._routes):
            req = self.poll(fid)
            if req is not None:
                out[fid] = req
        out.update(self._results)
        return out

    # ---------------- observability ----------------

    def prometheus(self) -> str:
        """Fleet scrape surface: every replica's registry under a
        ``replica="k"`` label, then the fleet-level series unlabeled."""
        parts = [
            rep.engine.stats.registry.prometheus(
                labels={"replica": str(rep.index)})
            for rep in self.replicas
        ]
        parts.append(self.registry.prometheus())
        return "".join(parts)

    def snapshot(self) -> Dict[str, float]:
        """Flat JSONL snapshot (the ``MetricsFile`` surface): fleet-level
        series plus every replica's registry under a ``replica<k>_`` key
        prefix — ``tools/obs_report.py --fleet`` splits these back out."""
        out = dict(self.registry.snapshot())
        for rep in self.replicas:
            out.update(rep.engine.stats.registry.snapshot(
                prefix=f"replica{rep.index}_"))
        return out

    def summary(self, wall_s: Optional[float] = None,
                n_chips: int = 1) -> Dict[str, Any]:
        """ServeStats-shaped fleet aggregate: summed outcome counters,
        merged-histogram latency quantiles (percentiles of the union
        distribution, not averaged per-replica percentiles), capacity
        fraction, and a per-replica breakdown."""
        if wall_s is None:
            wall_s = self.clock() - self.started_t
        per = []
        for rep in self.replicas:
            s = rep.engine.stats.summary(wall_s=wall_s, n_chips=n_chips)
            per.append({"replica": rep.index, "health": rep.health,
                        "sick_reason": rep.sick_reason,
                        "cold_start_s": rep.engine.stats.cold_start_s, **s})

        def total(key: str) -> float:
            return sum(p[key] for p in per)

        lat = merge_histograms(
            [rep.engine.stats.latency_hist for rep in self.replicas],
            name="fleet_request_latency_seconds")
        wait = merge_histograms(
            [rep.engine.stats.wait_hist for rep in self.replicas],
            name="fleet_request_wait_seconds")
        tps = total("gen_tokens") / wall_s if wall_s and wall_s > 0 else 0.0
        return {
            "replicas": len(self.replicas),
            "healthy_replicas": len(self.healthy_replicas),
            "target_replicas": self._target_replicas,
            "replicas_spawned": int(self._m_spawned.value),
            "capacity_frac": round(self.capacity_frac, 4),
            "num_slots": self.num_slots,
            # fleet ids issued; per-replica `submitted` double-counts moved
            # requests (each attempt is an engine submit), so the fleet
            # total is the authoritative request count
            "submitted": self._next_id,
            "fleet_rejected": int(self._m_rejected.value),
            "fleet_shed": int(self._m_shed.value),
            "resubmissions": self.resubmissions,
            "replicas_retired": int(self._m_retired_replicas.value),
            "admitted": total("admitted"),
            "retired": total("retired"),
            "rejected": total("rejected") + int(self._m_rejected.value),
            "shed": total("shed"),
            "timeouts": total("timeouts"),
            "failed": total("failed"),
            "quarantined": total("quarantined"),
            "browned": total("browned"),
            "reaped": total("reaped"),
            "rebuilds": total("rebuilds"),
            "decode_steps": total("decode_steps"),
            "prefill_calls": total("prefill_calls"),
            "compiles": total("compiles"),
            "gen_tokens": total("gen_tokens"),
            "wall_s": round(wall_s, 3),
            "gen_tokens_per_sec": round(tps, 2),
            "gen_tokens_per_sec_per_chip": round(tps / max(n_chips, 1), 2),
            "latency_p50_s": round(lat.quantile(50), 4),
            "latency_p95_s": round(lat.quantile(95), 4),
            "wait_p50_s": round(wait.quantile(50), 4),
            "wait_p95_s": round(wait.quantile(95), 4),
            "per_replica": per,
        }

    # ---------------- internals ----------------

    def _active(self) -> bool:
        if self._retrying:
            return True  # resubmissions still serving their backoff
        for rep in self.replicas:
            if rep.closed or rep.health == SICK:
                continue
            if rep.watchdog_tripped:
                return True  # next tick retires it
            if rep.engine.occupancy or rep.engine.queue_depth:
                return True
        return False

    def _reject(self, fid: int, now: float, why: str,
                trace_id: str = "") -> None:
        req = Request(id=fid, sample=None,
                      limit=self.cfg.max_tgt_len - 1, submit_t=now)
        req.status = RequestStatus.REJECTED
        req.error = why
        req.done_t = now
        req.trace_id = trace_id
        self._results[fid] = req
        self._m_rejected.inc()
        self.obs.emit("fleet.reject", id=fid, error=why,
                      **({"trace": trace_id} if trace_id else {}))
        if trace_id:
            self.tracer.finish(trace_id, RequestStatus.REJECTED, t=now,
                               id=fid, error=why)

    def _retire_replica(self, rep: Replica, reason: str) -> None:
        """SICK transition: shed the replica's work, close its engine
        (one postmortem flush), then move zero-token sheds to healthy
        replicas — at-most-once per attempt: a request that got ANY
        tokens delivered keeps its terminal SHED outcome."""
        rep.health = SICK
        rep.sick_reason = reason
        rep.watchdog_tripped = False
        self._m_retired_replicas.inc()
        self.obs.emit("fleet.retire", replica=rep.index, reason=reason)
        self.log(f"# fleet: replica {rep.index} SICK ({reason}); "
                 f"capacity {self.capacity_frac:.2f}")
        eng = rep.engine
        shed_reason = f"replica {rep.index} retired: {reason}"
        eng.shed_all(shed_reason)
        eng.close()
        rep.closed = True
        if self._postmortem_dir and self.obs.enabled:
            self.obs.postmortem(self._postmortem_dir,
                                f"retire_replica{rep.index}")

        now = self.clock()
        for fid, (ri, eid) in sorted(self._routes.items()):
            if ri != rep.index:
                continue
            req = eng.poll(eid)
            entry = self._pending.get(fid)
            if (req is None or entry is None
                    or req.status != RequestStatus.SHED
                    or req.error != shed_reason or req.n_tokens):
                continue  # terminal before retirement, or tokens delivered
            entry.attempts += 1
            if entry.attempts > self.cfg.serve_max_retries:
                self._pending.pop(fid, None)
                continue  # retry budget spent: the SHED stands
            # schedule the resubmission behind capped exponential backoff
            # with deterministic jitter — a retirement under load must not
            # slam its whole queue onto the survivors in one tick
            backoff = self._backoff_s(fid, entry.attempts)
            entry.backoff_s += backoff
            self._retrying[fid] = _ScheduledRetry(
                fid=fid, due_t=now + backoff, from_replica=rep.index)
            self.obs.emit("fleet.backoff", id=fid, attempts=entry.attempts,
                          backoff_s=round(backoff, 4),
                          from_replica=rep.index,
                          **({"trace": entry.trace_id}
                             if entry.trace_id else {}))
            if entry.trace_id:
                # pull the trace back from its provisional SHED terminal
                # (the engine funnel ran during shed_all above): the retry
                # is attempt N+1 of the SAME request story
                self.tracer.reopen(entry.trace_id,
                                   attempt=entry.attempts + 1, t=now,
                                   from_replica=rep.index, reason=reason,
                                   backoff_s=round(backoff, 4))
        self._update_gauges()

    def _backoff_s(self, fid: int, attempts: int) -> float:
        """Capped exponential backoff with deterministic seeded jitter in
        ``[0.5x, 1.0x)`` — a pure function of (cfg.seed, fid, attempts),
        so a replayed trace backs off identically."""
        base = self.cfg.serve_resubmit_backoff_s
        if base <= 0:
            return 0.0
        raw = min(base * (2.0 ** (attempts - 1)),
                  self.cfg.serve_resubmit_backoff_max_s)
        j = ((fid * 1103515245 + attempts * 12345
              + self.cfg.seed * 2654435761) >> 7) % 1024
        return raw * (0.5 + 0.5 * (j / 1024.0))

    def _flush_retries(self) -> None:
        """Re-route scheduled resubmissions whose backoff has elapsed.
        When the fleet is otherwise quiescent the remaining backoff is
        collapsed — delaying a retry the survivors could serve *right now*
        protects nothing, and drain() must terminate under any clock."""
        if not self._retrying:
            return
        now = self.clock()
        idle = not any(
            (rep.engine.occupancy or rep.engine.queue_depth)
            for rep in self.replicas
            if not rep.closed and rep.health != SICK)
        for fid in sorted(self._retrying):
            item = self._retrying[fid]
            if item.due_t > now and not idle:
                continue
            del self._retrying[fid]
            entry = self._pending.get(fid)
            if entry is None:
                continue  # result already consumed
            if entry.deadline_t is not None and entry.deadline_t <= now:
                self._pending.pop(fid, None)
                continue  # would expire on arrival: the SHED stands
            target = self.router.pick(self.replicas)
            if target is None:
                self._pending.pop(fid, None)
                continue  # nowhere to go: the SHED stands
            ddl = (entry.deadline_t - now
                   if entry.deadline_t is not None else 0)
            if entry.trace_id:
                self.tracer.event(entry.trace_id, "resubmit", t=now,
                                  replica=target.index,
                                  from_replica=item.from_replica,
                                  **self.router.placement(
                                      target, self.replicas))
            eid2 = target.engine.submit(
                entry.sample, max_new_tokens=entry.max_new_tokens,
                deadline_s=ddl, priority=entry.priority,
                trace_id=entry.trace_id or None)
            self._routes[fid] = (target.index, eid2)
            self.resubmissions += 1
            self._m_resubmitted.inc()
            self.obs.emit("fleet.resubmit", id=fid, replica=target.index,
                          engine_id=eid2, from_replica=item.from_replica,
                          attempts=entry.attempts,
                          backoff_s=round(entry.backoff_s, 4),
                          **({"trace": entry.trace_id}
                             if entry.trace_id else {}))

    def _update_gauges(self) -> None:
        self._m_healthy.set(len(self.healthy_replicas))
        self._m_capacity.set(round(self.capacity_frac, 4))
        self._m_queue.set(self.queue_depth)
        self._m_occupancy.set(self.occupancy)
        self._m_target.set(self._target_replicas)
        for rep in self.replicas:
            # per-replica health on the replica's own scrape surface
            # (registry.gauge is get-or-create, so this is idempotent)
            rep.engine.stats.registry.gauge(
                "serve_health_state",
                "replica health: 0=HEALTHY 1=DRAINING 2=SICK",
            ).set(_HEALTH_CODE[rep.health])
