"""FaultPlan DSL: declarative fault schedules over the serve stack — the JAX
package's ``resilience/chaos.py`` for the port (``tests/test_torch_imports.py``
holds every definition to the original's).

* a plan is a tuple of :class:`FaultEvent` — named fault kinds with
  *relative* timing (``at`` = ticks from the moment the plan is applied;
  for ``prefill_fail``, prefill calls from that moment) and an optional
  ``replica`` target;
* :meth:`FaultPlan.apply` compiles the schedule onto the injector's public
  constructor keywords (``serve_nan_logits``, ``serve_wedge_slots``,
  ``serve_hang_at_tick``, ``serve_prefill_fail_calls``,
  ``serve_decode_fail_ticks``, ``serve_spill_storm_ticks``,
  ``serve_corrupt_tier_ticks``) and installs one injector per targeted
  engine, for a bare :class:`~csat_tpu_torch.serve.engine.ServeEngine` or a
  whole :class:`~csat_tpu_torch.serve.fleet.Fleet`;
* :func:`run_chaos` drives any target under any
  :class:`~csat_tpu_torch.serve.traffic.Trace`, feeding an optional
  :class:`~csat_tpu_torch.resilience.invariants.InvariantMonitor` every tick
  and failing loudly (``strict=True``) on any violation; the returned
  :class:`ChaosReport` carries outcome counts, per-class latency
  percentiles, capacity fraction and the violation list, and
  :meth:`ChaosReport.dump` writes the merged fault-vs-invariant timeline
  ``tools/chaos_report.py`` renders.

Fault kinds (compilation targets in parentheses):

====================  =====================================================
``nan_logits``        poison slot's self-KV on one tick (``serve_nan_logits``)
``wedge_slot``        silently freeze a slot's row (``serve_wedge_slots``)
``hang``              host stall inside tick() for ``seconds`` (``serve_hang_at_tick``)
``prefill_fail``      the prefill call ``at`` calls from now raises
``decode_fault``      ``count`` consecutive decode ticks raise (rebuild path)
``reap_storm``        wedge every slot over S consecutive ticks (the fleet's
                      reap-storm trip, ``serve_fleet_reap_storm``)
``retire_replica``    permanent decode faults on one replica — the fleet
                      retires it (rebuild cap) and resubmits its queue
``corrupt_warmstart`` flip payload bytes in every warm-start store entry
                      (fleet-level, latched at apply time): the next spawn
                      books ``digest_mismatch`` and repairs the store
``kill_during_spawn`` arm the fleet's spawn-kill hook: the next ``count``
                      ``add_replica`` bring-ups die mid-spawn (fleet-level)
``spill_storm``       force-spill every unreferenced prefix-cache entry to
                      the KV tiers for ``count`` consecutive ticks
                      (``ServeEngine.spill_all``)
``corrupt_tier_restore``  flip payload bytes in every tiered KV snapshot so
                      later restores fail verification and re-prefill
``disconnect_mid_stream``  drop the streaming client's connection
                      (:func:`run_net_chaos` only — fires on the client,
                      never the injector)
``slow_reader``       throttle the client's reads so the server must
                      stall-account, never block its tick
``malformed_frame``   inject protocol-violating lines at the server
``reconnect_storm``   consecutive disconnect / reconnect / resume cycles
====================  =====================================================

The :data:`NET_KINDS` family (drawn by ``FaultPlan.random(net=True)``)
faults the protocol boundary: :func:`run_net_chaos` drives a ``NetFront`` /
``NetClient`` pair over real loopback sockets, fires these against the
client's connection schedule, and closes with the stream delivery invariants
(``stream_no_token_loss`` / ``stream_no_duplicate`` /
``stream_terminal_frame``).

The two fleet-level kinds have no per-tick injector: they latch state at
:meth:`FaultPlan.apply` time (``at`` is ignored) and fire when the
supervisor next spawns.  Pass the supervisor to :func:`run_chaos`
(``supervisor=``) and it is stepped every loop iteration; fleet runs also
record ``time_to_recover_s`` (first capacity drop below 1.0 → first return
to 1.0) and ``replicas_spawned``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from csat_tpu_torch.resilience.faults import FaultInjector
from csat_tpu_torch.resilience.retry import DataErrorBudgetExceeded

__all__ = ["FaultEvent", "FaultPlan", "ChaosReport", "run_chaos",
           "run_net_chaos", "NET_KINDS"]

# network fault family: faults on the protocol boundary, not the device.
# They never compile onto the FaultInjector; run_net_chaos fires them
# against the client's connection schedule
NET_KINDS = ("disconnect_mid_stream", "slow_reader", "malformed_frame",
             "reconnect_storm")

KINDS = ("nan_logits", "wedge_slot", "hang", "prefill_fail",
         "decode_fault", "reap_storm", "retire_replica",
         "corrupt_warmstart", "kill_during_spawn",
         "spill_storm", "corrupt_tier_restore") + NET_KINDS

# kinds that act on the FLEET (warm-start store / spawn hook), not on any
# engine's injector — latched at apply time, no per-tick schedule
FLEET_KINDS = ("corrupt_warmstart", "kill_during_spawn")

# a retired replica must keep faulting through every rebuild attempt —
# effectively-infinite horizon (matches the sick-replica drills)
RETIRE_HORIZON = 10_000


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``at`` is RELATIVE: ticks (or prefill calls,
    for ``prefill_fail``) from the moment the plan is applied to a target,
    so the same plan works at any warm-up point."""

    kind: str
    at: int = 1
    slot: int = 0
    replica: int = 0
    count: int = 1          # decode_fault: consecutive faulting ticks
    seconds: float = 0.0    # hang: stall duration

    def __post_init__(self):
        assert self.kind in KINDS, self.kind
        assert self.at >= 0, self.at
        assert self.count >= 1, self.count


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A named, serializable schedule of :class:`FaultEvent`."""

    events: Tuple[FaultEvent, ...] = ()
    name: str = "plan"

    def to_json(self) -> str:
        return json.dumps({
            "name": self.name,
            "events": [dataclasses.asdict(e) for e in self.events],
        }, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "FaultPlan":
        d = json.loads(s)
        return FaultPlan(
            events=tuple(FaultEvent(**e) for e in d.get("events", ())),
            name=d.get("name", "plan"))

    @staticmethod
    def random(seed: int, n_events: int = 3, replicas: int = 1,
               slots: int = 4, tiered: bool = False,
               net: bool = False) -> "FaultPlan":
        """A seeded random storm for the property test.  ``hang`` is
        excluded (it sleeps real wall time) and ``retire_replica`` only
        appears with >1 replica, never aimed at replica 0 — the storm must
        leave at least one replica serving.  ``tiered=True`` (the target
        serves with ``serve_tiering``) adds the two tier kinds to the
        draw pool; ``net=True`` (the target serves behind a network
        front door) adds the :data:`NET_KINDS` family."""
        rng = np.random.default_rng(seed)
        kinds = ["nan_logits", "wedge_slot", "prefill_fail", "decode_fault"]
        if replicas > 1:
            kinds += ["reap_storm", "retire_replica"]
        if tiered:
            kinds += ["spill_storm", "corrupt_tier_restore"]
        if net:
            kinds += list(NET_KINDS)
        events = []
        for _ in range(n_events):
            kind = kinds[int(rng.integers(0, len(kinds)))]
            rep = int(rng.integers(0, replicas))
            if kind == "retire_replica" and replicas > 1:
                rep = int(rng.integers(1, replicas))
            events.append(FaultEvent(
                kind=kind,
                at=int(rng.integers(1, 12)),
                slot=int(rng.integers(0, slots)),
                replica=rep,
                count=int(rng.integers(1, 3))))
        return FaultPlan(events=tuple(events), name=f"storm{seed}")

    # ---------------- compilation ----------------

    def apply(self, target: Any) -> Dict[int, FaultInjector]:
        """Compile the plan against ``target`` (a ``ServeEngine`` or a
        ``Fleet``) and install one injector per targeted live engine;
        returns {replica index: injector} ({0: inj} for a bare engine).
        Offsets resolve against each engine's CURRENT public ``ticks`` /
        ``prefills`` clocks, so application time is the plan's t=0."""
        if hasattr(target, "replicas"):
            from csat_tpu_torch.serve.router import HEALTHY  # avoid package cycle

            engines = {rep.index: rep.engine for rep in target.replicas
                       if not rep.closed and rep.health == HEALTHY}
            for e in self.events:
                # fleet-level kinds latch now: the store is corrupted /
                # the spawn hook armed, and the fault fires whenever the
                # supervisor next brings a replica up
                if e.kind == "kill_during_spawn":
                    target.arm_spawn_kill(e.count)
                    target.obs.emit("fault.kill_during_spawn", count=e.count)
                elif e.kind == "corrupt_warmstart":
                    n = (target.warmstart.corrupt_entries()
                         if target.warmstart is not None else 0)
                    target.obs.emit("fault.corrupt_warmstart", entries=n)
        else:
            bad = [e for e in self.events if e.replica != 0]
            if bad:
                raise ValueError(
                    f"plan {self.name!r} targets replica "
                    f"{bad[0].replica} but the target is a bare engine")
            fleet_only = [e for e in self.events
                          if e.kind == "retire_replica"
                          or e.kind in FLEET_KINDS]
            if fleet_only:
                raise ValueError(
                    f"{fleet_only[0].kind} requires a Fleet target — a "
                    "bare engine has no replica lifecycle to fault")
            engines = {0: target}

        out: Dict[int, FaultInjector] = {}
        for k, eng in engines.items():
            # NET_KINDS never reach the injector: they fault the protocol
            # boundary, and run_net_chaos compiles them onto the client's
            # connection schedule instead
            evs = [e for e in self.events
                   if e.replica == k and e.kind not in FLEET_KINDS
                   and e.kind not in NET_KINDS]
            if not evs:
                continue
            t0 = eng.ticks
            p0 = eng.prefills
            slots = eng.cfg.serve_slots
            nan: List[tuple] = []
            wedge: List[tuple] = []
            prefill: List[int] = []
            decode: set = set()
            spill: set = set()
            corrupt: set = set()
            hang_tick: Optional[int] = None
            hang_s = 0.0
            for e in evs:
                if e.kind == "nan_logits":
                    nan.append((t0 + e.at, e.slot % slots))
                elif e.kind == "wedge_slot":
                    wedge.append((t0 + e.at, e.slot % slots))
                elif e.kind == "hang":
                    if hang_tick is not None:
                        raise ValueError(
                            f"plan {self.name!r}: at most one hang per "
                            f"replica (injector holds a single hang tick)")
                    hang_tick = t0 + e.at
                    hang_s = e.seconds
                elif e.kind == "prefill_fail":
                    prefill.append(p0 + e.at)
                elif e.kind == "decode_fault":
                    decode.update(range(t0 + e.at, t0 + e.at + e.count))
                elif e.kind == "reap_storm":
                    # one slot wedges per tick: S consecutive ticks freeze
                    # the whole pool, tripping the reaper on every slot
                    wedge.extend((t0 + e.at + s, s) for s in range(slots))
                elif e.kind == "retire_replica":
                    decode.update(
                        range(t0 + e.at, t0 + e.at + RETIRE_HORIZON))
                elif e.kind == "spill_storm":
                    spill.update(range(t0 + e.at, t0 + e.at + e.count))
                elif e.kind == "corrupt_tier_restore":
                    corrupt.add(t0 + e.at)
            inj = FaultInjector(
                serve_nan_logits=nan,
                serve_wedge_slots=wedge,
                serve_prefill_fail_calls=prefill,
                serve_decode_fail_ticks=frozenset(decode),
                serve_hang_at_tick=hang_tick,
                hang_seconds=hang_s,
                serve_spill_storm_ticks=frozenset(spill),
                serve_corrupt_tier_ticks=frozenset(corrupt))
            eng.fault_injector = inj
            out[k] = inj
        return out


@dataclasses.dataclass
class ChaosReport:
    """What one :func:`run_chaos` produced: outcome counts, per-class
    latency percentiles, the invariant record, and the merged timeline."""

    trace_name: str
    plan_name: str
    submitted: int
    outcomes: Dict[str, int]
    per_class: Dict[str, Dict[str, float]]
    violations: List[dict]
    checks: int
    capacity_frac: float
    resubmissions: int
    browned: int
    n_ticks: int
    poison_budget_hits: int
    timeline: List[dict]
    trace_json: str = ""
    plan_json: str = ""
    # elasticity: first capacity drop below 1.0 → first return
    # to 1.0, in the target's clock; -1.0 = never dropped / never recovered
    time_to_recover_s: float = -1.0
    replicas_spawned: int = 0
    # SLO burn-rate alerts: objective name -> times fired
    slo_alerts: Dict[str, int] = dataclasses.field(default_factory=dict)
    # network front door counters (run_net_chaos only): frames,
    # stall_drops, resumes, reconnects, disconnects, malformed,
    # dup_frames, gap_frames, forced_reconnects
    net: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def clean(self) -> bool:
        return not self.violations

    def dump(self, path: str) -> str:
        """Merged faults-vs-invariants timeline as JSONL: one
        ``{"meta": ...}`` header, then ts-sorted events from every
        component recorder — the surface ``tools/chaos_report.py`` reads."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(json.dumps({"meta": {
                "kind": "chaos", "trace": self.trace_name,
                "plan": self.plan_name, "submitted": self.submitted,
                "outcomes": self.outcomes, "violations": len(self.violations),
                "checks": self.checks,
                "capacity_frac": self.capacity_frac,
                "resubmissions": self.resubmissions,
                "time_to_recover_s": self.time_to_recover_s,
                "replicas_spawned": self.replicas_spawned,
                "slo_alerts": self.slo_alerts,
                "net": self.net,
                "trace_spec": self.trace_json, "fault_plan": self.plan_json,
            }}) + "\n")
            for rec in self.timeline:
                f.write(json.dumps(rec) + "\n")
        return path


def _merged_timeline(target: Any, monitor: Any,
                     extra: Tuple[Tuple[str, Any], ...] = ()) -> List[dict]:
    """Every component recorder's events as ts-sorted dicts, each stamped
    with its source component.  ``extra`` adds (component, recorder)
    pairs — the network drill merges the front door's recorder in."""
    recorders = []
    if hasattr(target, "replicas"):
        recorders.append(("fleet", target.obs))
        for rep in target.replicas:
            recorders.append((f"replica{rep.index}", rep.engine.obs))
    else:
        recorders.append(("serve", target.obs))
    if monitor is not None:
        recorders.append(("chaos", monitor.obs))
    recorders.extend(extra)
    out: List[dict] = []
    for comp, rec in recorders:
        for ts, name, dur, fields in rec.events():
            d = {"ts": round(ts, 6), "name": name, "component": comp}
            if dur:
                d["dur"] = round(dur, 6)
            if fields:
                d.update(fields)
            out.append(d)
    out.sort(key=lambda d: d["ts"])
    return out


def run_chaos(
    target: Any,
    trace: Any,
    plan: Optional[FaultPlan] = None,
    monitor: Any = None,
    strict: bool = True,
    tick_budget: int = 0,
    supervisor: Any = None,
    slo: Any = None,
) -> ChaosReport:
    """Drive ``target`` (engine or fleet) through ``trace`` with ``plan``'s
    faults firing on schedule, the monitor observing every tick, and a
    final invariant check over the drained state.  ``strict=True`` raises
    :class:`~csat_tpu_torch.resilience.invariants.InvariantViolationError` on
    any violation (a chaos run fails loudly); ``strict=False`` records the
    violations in the report — the bench uses that to mark the ledger
    record degraded instead of crashing the run.  ``supervisor`` (an
    :class:`~csat_tpu_torch.serve.autoscale.AutoScaler` or anything with a
    ``step()``) is stepped once per loop iteration, so healing happens
    under the same trace pressure the faults fire into.  ``slo`` (an
    :class:`~csat_tpu_torch.obs.slo.SLOEngine`) is likewise stepped per
    iteration; its fired-alert counts land in ``ChaosReport.slo_alerts``
    and its transitions in the merged timeline."""
    cfg = target.cfg
    injectors = plan.apply(target) if plan is not None else {}
    del injectors  # installed on the engines; the report reads the events
    is_fleet = hasattr(target, "replicas")
    n_replicas0 = len(target.replicas) if is_fleet else 0

    steps = cfg.max_tgt_len - 1
    items = trace.items
    last_arrival = items[-1].arrival if items else 0
    budget = tick_budget or (
        (last_arrival + len(items) + target.num_slots + 1)
        * (steps + cfg.serve_reap_margin + 2))

    t_start = target.ticks
    ids: Dict[int, int] = {}      # trace index -> target id
    poison_budget_hits = 0
    i = 0
    n_ticks = 0
    # capacity-recovery clock: first drop below 1.0 → first return to 1.0
    cap_drop_t: Optional[float] = None
    recover_s = -1.0
    while i < len(items) or target.occupancy or target.queue_depth:
        rel = target.ticks - t_start
        while i < len(items) and items[i].arrival <= rel:
            it = items[i]
            try:
                ids[it.index] = target.submit(
                    it.sample, max_new_tokens=it.max_new_tokens,
                    priority=it.priority)
            except DataErrorBudgetExceeded:
                # the poison budget tripping IS the designed outcome of a
                # flood that exceeds it — record and keep serving the rest
                poison_budget_hits += 1
            i += 1
        target.tick()
        n_ticks += 1
        if monitor is not None:
            monitor.observe_tick(target)
        if is_fleet and cap_drop_t is None and target.capacity_frac < 1.0:
            # latch the dip before the supervisor can heal it away within
            # the same iteration — tick() is where faults fire
            cap_drop_t = target.clock()
        if supervisor is not None:
            supervisor.step()
        if slo is not None:
            slo.step()
        if is_fleet:
            cap = target.capacity_frac
            if cap < 1.0 and cap_drop_t is None:
                cap_drop_t = target.clock()
            elif cap >= 1.0 and cap_drop_t is not None and recover_s < 0:
                recover_s = target.clock() - cap_drop_t
        if n_ticks > budget:
            raise RuntimeError(
                f"chaos run exceeded {budget} ticks — target not quiescing "
                f"({len(items) - i} unsubmitted, occupancy "
                f"{target.occupancy}, queue {target.queue_depth})")

    results = {ix: target.poll(rid) for ix, rid in ids.items()}
    outcomes: Dict[str, int] = {}
    per_class: Dict[str, Dict[str, Any]] = {}
    from csat_tpu_torch.serve.stats import percentile
    lat: Dict[str, List[float]] = {}
    for it in items:
        pc = per_class.setdefault(it.pclass, {
            "priority": it.priority, "submitted": 0, "ok": 0, "browned": 0,
            "shed": 0, "rejected": 0, "timeout": 0, "failed": 0,
            "unresolved": 0})
        pc["submitted"] += 1
        req = results.get(it.index)
        if req is None:
            pc["unresolved"] += 1
            outcomes["UNRESOLVED"] = outcomes.get("UNRESOLVED", 0) + 1
            continue
        outcomes[req.status] = outcomes.get(req.status, 0) + 1
        key = {"OK": "ok", "SHED": "shed", "REJECTED": "rejected",
               "TIMEOUT": "timeout", "FAILED": "failed"}.get(req.status)
        if key:
            pc[key] += 1
        if req.browned:
            pc["browned"] += 1
        if req.status == "OK":
            lat.setdefault(it.pclass, []).append(req.done_t - req.submit_t)
    for name, pc in per_class.items():
        xs = lat.get(name, [])
        pc["latency_p50_s"] = round(percentile(xs, 50), 4)
        pc["latency_p95_s"] = round(percentile(xs, 95), 4)

    violations: List[dict] = []
    checks = 0
    if monitor is not None:
        violations = [dataclasses.asdict(v) for v in monitor.check(
            target, results={ids[ix]: r for ix, r in results.items()
                             if r is not None},
            expected_ids=list(ids.values()))]
        checks = monitor.checks
    report = ChaosReport(
        trace_name=trace.spec.name,
        plan_name=plan.name if plan is not None else "none",
        submitted=len(ids),
        outcomes=outcomes,
        per_class=per_class,
        violations=violations,
        checks=checks,
        capacity_frac=round(target.capacity_frac, 4) if is_fleet else 1.0,
        resubmissions=target.resubmissions if is_fleet else 0,
        browned=sum(pc["browned"] for pc in per_class.values()),
        n_ticks=n_ticks,
        poison_budget_hits=poison_budget_hits,
        timeline=_merged_timeline(target, monitor),
        trace_json=trace.spec.to_json(),
        plan_json=plan.to_json() if plan is not None else "",
        time_to_recover_s=round(recover_s, 4) if recover_s >= 0 else -1.0,
        replicas_spawned=(len(target.replicas) - n_replicas0
                          if is_fleet else 0),
        slo_alerts=dict(slo.fired) if slo is not None else {},
    )
    if strict and monitor is not None:
        monitor.assert_clean(report)
    return report


def run_net_chaos(
    target: Any,
    trace: Any,
    plan: Optional[FaultPlan] = None,
    monitor: Any = None,
    strict: bool = True,
    tick_budget: int = 0,
    retries: int = 1,
    force_reconnect: bool = False,
    slow_reader_bytes: int = 64,
    slow_window_scale: int = 20,
) -> ChaosReport:
    """Drive ``target`` through ``trace`` over real loopback sockets: a
    :class:`~csat_tpu_torch.serve.netfront.NetFront` in front of the target, a
    :class:`~csat_tpu_torch.serve.netclient.NetClient` submitting the trace's
    arrivals and assembling the streams, single-threaded co-simulation
    (``front.step(); client.step()`` per loop iteration — the loop
    iteration is the schedule clock for arrivals AND net faults).

    ``plan``'s engine kinds compile onto the injector exactly as in
    :func:`run_chaos`; its :data:`NET_KINDS` fire against the client:

    * ``disconnect_mid_stream`` — drop the connection at iteration
      ``at``; the client reconnects and resumes.
    * ``reconnect_storm`` — disconnect on ``3 * count`` consecutive
      iterations (a thundering reconnect/resume herd).
    * ``malformed_frame`` — inject ``count`` protocol-violating lines.
    * ``slow_reader`` — throttle client reads to ``slow_reader_bytes``
      per step for ``count * slow_window_scale`` iterations (the server
      must stall-account, never block its tick).

    ``force_reconnect=True`` additionally forces ONE disconnect the
    moment any stream has partial tokens — the bench's guaranteed
    mid-stream reconnect.  ``retries`` lets the client honor
    ``retry_after_s`` refusal hints with resubmits.

    The final check is :meth:`InvariantMonitor.check` over the retained
    terminal results plus :meth:`InvariantMonitor.check_streams` —
    streamed assemblies bit-identical to the in-process engine's tokens.
    """
    from csat_tpu_torch.serve.netclient import NetClient  # avoid package cycle
    from csat_tpu_torch.serve.netfront import NetFront

    cfg = target.cfg
    items = trace.items
    front = NetFront(
        target,
        make_sample=lambda msg: items[int(msg["sample"])].sample)
    client = NetClient(front.address, clock=front.clock, retries=retries)
    if plan is not None:
        plan.apply(target)
    disconnect_at: set = set()
    garbage_at: set = set()
    slow_windows: List[Tuple[int, int]] = []
    for e in (plan.events if plan is not None else ()):
        if e.kind == "disconnect_mid_stream":
            disconnect_at.add(e.at)
        elif e.kind == "reconnect_storm":
            disconnect_at.update(range(e.at, e.at + 3 * e.count))
        elif e.kind == "malformed_frame":
            garbage_at.update(range(e.at, e.at + e.count))
        elif e.kind == "slow_reader":
            slow_windows.append((e.at, e.at + e.count * slow_window_scale))

    steps = cfg.max_tgt_len - 1
    last_arrival = items[-1].arrival if items else 0
    budget = tick_budget or (
        (last_arrival + len(items) + target.num_slots + 1)
        * (steps + cfg.serve_reap_margin + 4) + 500)

    tags: Dict[int, str] = {}     # trace index -> client tag
    i = 0
    it_no = 0
    forced = 0
    live = 0
    try:
        while True:
            while i < len(items) and items[i].arrival <= it_no:
                it = items[i]
                tags[it.index] = client.submit(
                    i, priority=it.priority,
                    max_new_tokens=it.max_new_tokens)
                i += 1
            if it_no in disconnect_at:
                client.disconnect()
            if it_no in garbage_at:
                client.send_garbage()
            client.max_read_bytes = (
                slow_reader_bytes
                if any(a <= it_no < b for a, b in slow_windows) else 0)
            if (force_reconnect and not forced
                    and any(st.tokens and not st.done
                            for st in client.streams.values())):
                client.disconnect()
                forced = 1
            live = front.step()
            client.step()
            if monitor is not None:
                monitor.observe_tick(target)
            it_no += 1
            if not (i < len(items) or client.pending()
                    or client.retry_pending() or live
                    or target.occupancy or target.queue_depth):
                break
            wait = client.next_retry_in()
            if (wait is not None and wait > 0
                    and not (i < len(items) or client.pending() or live
                             or target.occupancy or target.queue_depth)):
                # the run is idle except for a scheduled backoff resubmit:
                # honor the server's retry_after_s hint by actually waiting
                # (bounded slices — the clock may be real) instead of
                # spinning the iteration budget away polling dead sockets
                time.sleep(min(wait + 1e-3, 0.05))
            if it_no > budget:
                raise RuntimeError(
                    f"net chaos run exceeded {budget} iterations — not "
                    f"quiescing ({len(items) - i} unsubmitted, "
                    f"{client.pending()} client-pending, "
                    f"{client.retry_pending()} retry-pending, {live} live "
                    f"streams, occupancy {target.occupancy}, queue "
                    f"{target.queue_depth})")
    finally:
        client.close()
        front.close()

    reqs = front.results()
    outcomes: Dict[str, int] = {}
    per_class: Dict[str, Dict[str, Any]] = {}
    from csat_tpu_torch.serve.stats import percentile
    lat: Dict[str, List[float]] = {}
    for it in items:
        pc = per_class.setdefault(it.pclass, {
            "priority": it.priority, "submitted": 0, "ok": 0, "browned": 0,
            "shed": 0, "rejected": 0, "timeout": 0, "failed": 0,
            "unresolved": 0})
        pc["submitted"] += 1
        st = client.streams.get(tags.get(it.index, ""))
        if st is None or not st.done or st.lost:
            pc["unresolved"] += 1
            outcomes["UNRESOLVED"] = outcomes.get("UNRESOLVED", 0) + 1
            continue
        outcomes[st.status] = outcomes.get(st.status, 0) + 1
        key = {"OK": "ok", "SHED": "shed", "REJECTED": "rejected",
               "TIMEOUT": "timeout", "FAILED": "failed"}.get(st.status)
        if key:
            pc[key] += 1
        if st.browned:
            pc["browned"] += 1
        req = reqs.get(st.id) if st.id is not None else None
        if st.status == "OK" and req is not None:
            lat.setdefault(it.pclass, []).append(req.done_t - req.submit_t)
    for name, pc in per_class.items():
        xs = lat.get(name, [])
        pc["latency_p50_s"] = round(percentile(xs, 50), 4)
        pc["latency_p95_s"] = round(percentile(xs, 95), 4)

    violations: List[dict] = []
    checks = 0
    if monitor is not None:
        expected = [st.id for st in client.streams.values()
                    if st.id is not None and st.id >= 0]
        monitor.check(target, results=reqs, expected_ids=expected)
        violations = [dataclasses.asdict(v)
                      for v in monitor.check_streams(front, client)]
        checks = monitor.checks
    is_fleet = hasattr(target, "replicas")
    report = ChaosReport(
        trace_name=trace.spec.name,
        plan_name=plan.name if plan is not None else "none",
        submitted=len(tags),
        outcomes=outcomes,
        per_class=per_class,
        violations=violations,
        checks=checks,
        capacity_frac=round(target.capacity_frac, 4) if is_fleet else 1.0,
        resubmissions=target.resubmissions if is_fleet else 0,
        browned=sum(pc["browned"] for pc in per_class.values()),
        n_ticks=it_no,
        poison_budget_hits=0,
        timeline=_merged_timeline(target, monitor,
                                  extra=(("net", front.obs),)),
        trace_json=trace.spec.to_json(),
        plan_json=plan.to_json() if plan is not None else "",
        net={
            **front.counters,
            "reconnects": client.reconnects,
            "resumes_sent": client.resumes_sent,
            "dup_frames": client.dup_total(),
            "gap_frames": client.gap_total(),
            "forced_reconnects": forced,
            "client_errors": client.errors,
            "backoffs": len(client.backoffs),
        },
    )
    if strict and monitor is not None:
        monitor.assert_clean(report)
    return report
