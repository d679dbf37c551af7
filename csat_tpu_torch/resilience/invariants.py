"""Live invariant monitors for chaos runs — the JAX package's
``resilience/invariants.py`` for the port (``tests/test_torch_imports.py``
holds every definition to the original's).

A fault drill that only eyeballs counters can pass while the engine quietly
double-delivers a request or leaks KV pages.  The monitor turns the serving
layer's contracts into machine-checked invariants fed from surfaces that
already exist — the flight recorders and the ``ServeStats`` / fleet
registries:

* **exactly_one_terminal** — no request id reaches two terminal lifecycle
  events on one recorder, and every request the caller submitted resolved;
* **single_resubmit** — the fleet never resubmits one request more than
  ``serve_max_retries`` times;
* **page_leak** — at quiescence every live engine's allocated pages are the
  prefix cache's pinned pages
  (:meth:`~csat_tpu_torch.serve.engine.ServeEngine.page_leaks` == 0);
* **queue_bound** — sampled every tick: no engine queue exceeds
  ``serve_max_queue``, and a fleet's summed queues respect the fleet bound
  (``serve_fleet_max_queue`` or the per-replica bound × replicas);
* **fault_budget** — rebuilds never exceed ``serve_max_rebuilds`` and
  quarantines never exceed ``serve_poison_budget``;
* **drain_clean** — after the drain, occupancy and queue depth are zero;
* **no_double_serve** — every ``fleet.resubmit`` moved work off a replica
  that had already emitted ``fleet.retire``;
* **capacity_recovers** — opt-in (``expect_recovery=True``): after the
  drain ``capacity_frac`` is back at 1.0;
* **bit_identity** / **restore_bit_identity** — optional token identity
  against a fault-free reference (:meth:`InvariantMonitor.check_tokens`);
* **no_chain_leak** — at quiescence each engine's tier-chain accounting
  reconciles (:meth:`~csat_tpu_torch.serve.engine.ServeEngine.chain_leaks`
  == 0).
* **stream_no_token_loss / stream_no_duplicate / stream_terminal_frame** —
  the network front door: every ACKed stream's client-assembled frames equal
  the engine's tokens, duplicate-free and terminated, across any number of
  reconnects and resumes (:meth:`InvariantMonitor.check_streams`).

Violations are structured (:class:`Violation`), land in the monitor's own
event recorder, and :meth:`InvariantMonitor.assert_clean` dumps a
post-mortem and raises :class:`InvariantViolationError`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

from csat_tpu_torch.obs import EventRecorder

__all__ = ["Violation", "InvariantViolationError", "InvariantMonitor",
           "TERMINAL_EVENTS"]

TERMINAL_EVENTS = ("req.ok", "req.failed", "req.timeout",
                   "req.rejected", "req.shed")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken invariant, with enough structure for a postmortem."""

    invariant: str
    detail: str
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)


class InvariantViolationError(AssertionError):
    """A chaos run broke at least one serving invariant."""

    def __init__(self, violations: List[Violation]):
        self.violations = violations
        lines = "\n".join(
            f"  [{v.invariant}] {v.detail}" for v in violations)
        super().__init__(
            f"{len(violations)} serving invariant violation(s):\n{lines}")


class InvariantMonitor:
    """Feed :meth:`observe_tick` every scheduler round and :meth:`check`
    once the target has drained; read ``violations`` / call
    :meth:`assert_clean`."""

    def __init__(self, cfg, postmortem_dir: str = "",
                 expect_recovery: bool = False):
        self.cfg = cfg
        self.postmortem_dir = postmortem_dir
        # autoscaled drills set this: a fleet that ends the run below
        # capacity_frac 1.0 failed to heal — a violation, not a shrug
        self.expect_recovery = expect_recovery
        self.obs = EventRecorder(capacity=cfg.obs_events, component="chaos")
        self.violations: List[Violation] = []
        self.checks = 0            # invariant evaluations performed
        self._tick_samples = 0

    # ---------------- helpers ----------------

    def _violate(self, invariant: str, detail: str, **data) -> None:
        v = Violation(invariant=invariant, detail=detail, data=data)
        self.violations.append(v)
        self.obs.emit("invariant.violation", invariant=invariant,
                      detail=detail, **{k: val for k, val in data.items()
                                        if isinstance(val, (int, float, str))})

    @staticmethod
    def _engines(target) -> List[tuple]:
        """(label, engine) for every live engine behind ``target``."""
        if hasattr(target, "replicas"):
            return [(f"replica{rep.index}", rep.engine)
                    for rep in target.replicas if not rep.closed]
        return [("serve", target)]

    # ---------------- live sampling ----------------

    def observe_tick(self, target) -> None:
        """Per-tick queue-bound sampling (the only invariant that must be
        watched live — a bound breach heals by the time the run drains)."""
        self._tick_samples += 1
        max_q = self.cfg.serve_max_queue
        if hasattr(target, "replicas"):
            live = [rep for rep in target.replicas if not rep.closed]
            if max_q:
                for rep in live:
                    d = rep.engine.queue_depth
                    if d > max_q:
                        self._violate(
                            "queue_bound",
                            f"replica {rep.index} queue {d} > "
                            f"serve_max_queue {max_q}",
                            replica=rep.index, depth=d, bound=max_q)
            bound = self.cfg.serve_fleet_max_queue or (
                max_q * len(target.replicas))
            if bound:
                total = sum(rep.engine.queue_depth for rep in live)
                if total > bound:
                    self._violate(
                        "queue_bound",
                        f"fleet queues {total} > bound {bound}",
                        depth=total, bound=bound)
        elif max_q:
            d = target.queue_depth
            if d > max_q:
                self._violate(
                    "queue_bound",
                    f"queue {d} > serve_max_queue {max_q}",
                    depth=d, bound=max_q)

    # ---------------- post-drain checks ----------------

    def check(self, target, results: Optional[Dict[int, Any]] = None,
              expected_ids: Optional[List[int]] = None) -> List[Violation]:
        """Evaluate every invariant against the drained target; returns
        the accumulated violation list (live queue-bound breaches
        included)."""
        engines = self._engines(target)

        # exactly-one-terminal per request id per recorder window
        recorders = [(label, eng.obs) for label, eng in engines]
        if hasattr(target, "replicas"):
            recorders.append(("fleet", target.obs))
        for label, rec in recorders:
            self.checks += 1
            seen: Dict[Any, int] = {}
            for ts, name, dur, fields in rec.events():
                if name in TERMINAL_EVENTS and fields:
                    rid = fields.get("id")
                    if rid is not None:
                        seen[rid] = seen.get(rid, 0) + 1
            for rid, n in seen.items():
                if n > 1:
                    self._violate(
                        "exactly_one_terminal",
                        f"{label}: request {rid} reached {n} terminal "
                        f"events", component=label, id=rid, count=n)

        # every submitted request resolved to a terminal outcome
        if expected_ids is not None:
            self.checks += 1
            results = results or {}
            for rid in expected_ids:
                req = results.get(rid)
                if req is None:
                    self._violate(
                        "exactly_one_terminal",
                        f"request {rid} never resolved (no terminal "
                        f"result after drain)", id=rid)
                elif not req.finished:
                    self._violate(
                        "exactly_one_terminal",
                        f"request {rid} polled non-terminal after drain",
                        id=rid, status=req.status)

        # at-most-`serve_max_retries` resubmissions per fleet id
        if hasattr(target, "replicas"):
            self.checks += 1
            moves: Dict[Any, int] = {}
            for ts, name, dur, fields in target.obs.events():
                if name == "fleet.resubmit" and fields:
                    rid = fields.get("id")
                    moves[rid] = moves.get(rid, 0) + 1
            cap = self.cfg.serve_max_retries
            for rid, n in moves.items():
                if n > cap:
                    self._violate(
                        "single_resubmit",
                        f"request {rid} resubmitted {n}x > "
                        f"serve_max_retries {cap}", id=rid, count=n,
                        bound=cap)

        # no-double-serve across replacement: work only ever
        # moves OFF a replica that retired first — the fleet emits
        # fleet.retire before scheduling any resubmission, so a resubmit
        # whose source replica has no earlier retire event means the
        # request left a replica that was still live
        if hasattr(target, "replicas"):
            self.checks += 1
            retired_at: Dict[Any, float] = {}
            for ts, name, dur, fields in target.obs.events():
                if name == "fleet.retire" and fields:
                    src = fields.get("replica")
                    if src is not None and src not in retired_at:
                        retired_at[src] = ts
            for ts, name, dur, fields in target.obs.events():
                if name == "fleet.resubmit" and fields:
                    src = fields.get("from_replica")
                    t_ret = retired_at.get(src)
                    if t_ret is None or t_ret > ts:
                        self._violate(
                            "no_double_serve",
                            f"request {fields.get('id')} moved off replica "
                            f"{src} which had not retired",
                            id=fields.get("id"), replica=src)

        # capacity healed back to 1.0 (autoscaled drills only)
        if self.expect_recovery and hasattr(target, "replicas"):
            self.checks += 1
            cap = target.capacity_frac
            if cap < 1.0:
                self._violate(
                    "capacity_recovers",
                    f"capacity_frac {cap:.3f} < 1.0 after drain "
                    f"({len(target.healthy_replicas)} healthy / target "
                    f"{target.target_replicas})",
                    capacity_frac=cap,
                    healthy=len(target.healthy_replicas),
                    target=target.target_replicas)

        # zero KV-page leaks at quiescence
        for label, eng in engines:
            self.checks += 1
            if eng.occupancy:
                continue  # not quiescent: leak check undefined
            leaked = eng.page_leaks()
            if leaked:
                self._violate(
                    "page_leak",
                    f"{label}: {leaked} KV pages allocated beyond the "
                    f"prefix cache's pins at quiescence",
                    component=label, pages=leaked)

        # tier-ladder chain accounting reconciles at quiescence: no key
        # tracked as both device-resident and tiered, occupancy gauges
        # equal to the pages the tier indices actually hold
        for label, eng in engines:
            fn = getattr(eng, "chain_leaks", None)
            if fn is None:
                continue
            self.checks += 1
            if eng.occupancy:
                continue  # not quiescent: accounting check undefined
            bad = fn()
            if bad:
                self._violate(
                    "no_chain_leak",
                    f"{label}: {bad} tier-chain accounting errors at "
                    f"quiescence (double-tracked or mis-counted chains)",
                    component=label, errors=bad)

        # fault budgets never silently exceeded
        for label, eng in engines:
            self.checks += 1
            if eng.stats.rebuilds > self.cfg.serve_max_rebuilds:
                self._violate(
                    "fault_budget",
                    f"{label}: {int(eng.stats.rebuilds)} rebuilds > "
                    f"serve_max_rebuilds {self.cfg.serve_max_rebuilds}",
                    component=label, rebuilds=int(eng.stats.rebuilds))
            if eng.stats.quarantined > self.cfg.serve_poison_budget:
                self._violate(
                    "fault_budget",
                    f"{label}: {int(eng.stats.quarantined)} quarantines > "
                    f"serve_poison_budget {self.cfg.serve_poison_budget}",
                    component=label,
                    quarantined=int(eng.stats.quarantined))

        # drained means drained
        self.checks += 1
        if target.occupancy or target.queue_depth:
            self._violate(
                "drain_clean",
                f"non-quiescent after drain: occupancy "
                f"{target.occupancy}, queue {target.queue_depth}",
                occupancy=target.occupancy, queue=target.queue_depth)

        self.obs.emit("invariant.check", checks=self.checks,
                      violations=len(self.violations),
                      tick_samples=self._tick_samples)
        return self.violations

    def check_tokens(self, expected: Dict[Any, Any], got: Dict[Any, Any],
                     label: str = "bit_identity") -> None:
        """Healthy-replica bit-identity: every id in ``expected`` must have
        token-identical output in ``got`` (sick-replica drill: replicas the
        fault never touched must be unaffected by it).  ``label`` names the
        invariant the violation is filed under — the tiering drills pass
        ``restore_bit_identity`` so a restored-chain divergence is
        distinguishable from a healthy-replica one."""
        import numpy as np

        self.checks += 1
        for rid, toks in expected.items():
            other = got.get(rid)
            if other is None or not np.array_equal(
                    np.asarray(toks), np.asarray(other)):
                self._violate(
                    label,
                    f"{label}: request {rid} diverged from the fault-free "
                    f"reference", id=rid)

    def check_streams(self, front: Any, client: Any) -> List[Violation]:
        """Streaming delivery invariants: judge a network chaos run by
        comparing every client-assembled stream against the front door's
        authoritative per-stream tokens (the engine's own outputs) —
        across any number of reconnects/resumes.

        * ``stream_no_token_loss`` — a clean terminal stream's
          concatenated frames are bit-identical to the engine's tokens
          (OK: full equality; non-OK: the truncated-to-``n_tokens``
          assembly is exactly the engine's delivered partial); a stream
          the client had to mark lost (seq gap / ring reset) is loss by
          definition.
        * ``stream_no_duplicate`` — the client never received a frame at
          or below its ``have_seq`` (resume replays start strictly after
          ``have_seq``; duplicates are dropped client-side, but their
          existence is a protocol violation).
        * ``stream_terminal_frame`` — every stream the server ACKed
          reached a terminal ``done`` frame by the end of the run.
        """
        authority = front.streams()
        statuses = front.stream_status()
        self.checks += 3
        for st in client.streams.values():
            if st.id is None:
                continue  # never ACKed: no server-side stream exists
            if st.dups:
                self._violate(
                    "stream_no_duplicate",
                    f"stream {st.id}: client saw {st.dups} duplicate "
                    f"frame(s)", id=st.id, dups=st.dups)
            if st.lost:
                self._violate(
                    "stream_no_token_loss",
                    f"stream {st.id}: client lost frames "
                    f"({st.gaps} gap(s))", id=st.id, gaps=st.gaps)
                continue
            if not st.done:
                self._violate(
                    "stream_terminal_frame",
                    f"stream {st.id}: ACKed but never reached a "
                    f"terminal frame", id=st.id)
                continue
            if st.id < 0:
                continue  # synthetic drain refusal: no engine tokens
            ref = authority.get(st.id)
            if ref is None:
                continue  # evicted from bounded retention: uncheckable
            got = list(st.tokens)
            if statuses.get(st.id) == "OK":
                if got != list(ref):
                    self._violate(
                        "stream_no_token_loss",
                        f"stream {st.id}: assembled {len(got)} token(s) "
                        f"!= engine's {len(ref)} (bit identity)",
                        id=st.id, got=len(got), want=len(ref))
            elif got != list(ref)[:len(got)]:
                self._violate(
                    "stream_no_token_loss",
                    f"stream {st.id}: partial assembly diverges from "
                    f"the engine's delivered prefix ({st.status})",
                    id=st.id, got=len(got), want=len(ref))
        self.obs.emit("invariant.check_streams",
                      streams=len(client.streams),
                      violations=len(self.violations))
        return self.violations

    # ---------------- loud failure ----------------

    def assert_clean(self, report: Any = None) -> None:
        """Raise (with a postmortem on disk) if any invariant broke."""
        if not self.violations:
            return
        if self.postmortem_dir:
            self.obs.postmortem(self.postmortem_dir, "invariant_violation")
            try:
                os.makedirs(self.postmortem_dir, exist_ok=True)
                path = os.path.join(self.postmortem_dir,
                                    "postmortem_chaos_violations.json")
                with open(path, "w") as f:
                    json.dump({
                        "violations": [dataclasses.asdict(v)
                                       for v in self.violations],
                        "checks": self.checks,
                    }, f, indent=1, sort_keys=True)
            except OSError:
                pass  # diagnostics must not mask the violation itself
            if report is not None:
                try:
                    report.dump(os.path.join(
                        self.postmortem_dir, "postmortem_chaos_timeline.jsonl"))
                except OSError:
                    pass
        raise InvariantViolationError(self.violations)
