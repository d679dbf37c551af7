"""Chaos drills and the invariant monitor: the port's ``run_chaos``,
``FaultPlan`` and ``InvariantMonitor`` against the JAX package's, the drills
of ``tests/test_chaos.py`` run on both.

Each drill drives one engine per package (``fleet_parity.stack``, three
tenant tiers, fake clocks) through the same zoo trace and plan: the reports'
outcome counts, per-class records, violation lists, tick counts and the
traces' JSON must be equal, and so must every request's status, error and
tokens.  The poison flood's dumped timeline renders through
``tools/chaos_report.py``.  The monitor's seeded violations (``bit_identity``
and ``no_double_serve``) are structured and raise with a post-mortem on
disk.  JAX's slow drills have port-only twins here, which the port runs in a
second: the randomized fault storm on a 2-replica fleet and the tiered
fleet's spill-storm and corrupt-restore drill, both strict."""

import importlib.util
import json
import types
from pathlib import Path

import numpy as np
import pytest

import fleet_parity as fp
from torch_parity import SRC_V, TRIP_V, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ("jax", "port")


@pytest.fixture(scope="module")
def st():
    # one prefill bucket, three tenant tiers (JAX's chaos_cfg)
    return fp.stack(bucket_src_lens=(48,), serve_priority_classes=3)


@pytest.fixture(scope="module")
def pkgs():
    return {name: fp.package(name) for name in PACKAGES}


def _report(rep):
    return dict(outcomes=rep.outcomes, per_class=rep.per_class, violations=rep.violations,
                checks=rep.checks, n_ticks=rep.n_ticks, browned=rep.browned,
                poison_budget_hits=rep.poison_budget_hits, trace_json=rep.trace_json,
                plan_json=rep.plan_json, plan=rep.plan_name, clean=rep.clean)


def _drill(st, pkgs, zoo, n, seed, plan=None, cfg_over=None, **spec_over):
    """One zoo trace through a fresh engine per package; → {package: (report
    record, per-request outcomes, engine, trace)}."""
    got = {}
    for name, pkg in pkgs.items():
        cfg = fp.cfg_of(pkg, st, **(cfg_over or {}))
        eng = fp.engine(pkg, st, cfg=cfg)
        trace = pkg.make_trace(pkg.zoo_spec(zoo, n, seed=seed, **spec_over), cfg, SRC_V, TRIP_V)
        p = plan(pkg) if plan is not None else None
        rep = pkg.run_chaos(eng, trace, plan=p, monitor=pkg.InvariantMonitor(cfg), strict=True)
        outs = [fp.outcome(eng.poll(i)) for i in range(len(trace))]
        got[name] = (_report(rep), outs, eng, trace, rep)
    return got


def _close(got):
    for side in got.values():
        side[2].close()


def _chaos_report_tool():
    spec = importlib.util.spec_from_file_location("chaos_report",
                                                  REPO / "tools" / "chaos_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_poison_flood_drill_equals_jax(st, pkgs, tmp_path):
    """30 % malformed intake: every poison quarantined FAILED at submit, the
    rest OK, the invariants clean — as in JAX; the port's dumped timeline
    renders through ``tools/chaos_report.py`` as clean."""
    got = _drill(st, pkgs, "poison_flood", 12, 5)
    (j, jo, _, _, _), (t, to, eng, trace, rep) = got["jax"], got["port"]
    assert t == j and to == jo
    assert t["clean"] and t["checks"] > 0 and t["poison_budget_hits"] == 0
    assert t["outcomes"] == {"FAILED": trace.n_poison, "OK": len(trace) - trace.n_poison}
    assert trace.n_poison > 0 and eng.stats.quarantined == trace.n_poison
    tool = _chaos_report_tool()
    path = rep.dump(str(tmp_path / "chaos_run.jsonl"))
    assert tool.main([path]) == 0
    meta, events = tool.load_dump(path)
    assert meta["trace"] == "poison_flood" and meta["violations"] == 0
    assert sum(1 for e in events if e["name"] == "fault.poison") == trace.n_poison
    _close(got)


def test_duplicate_storm_drill_equals_jax(st, pkgs):
    """A 60 % duplicate storm: everything OK, each duplicate's tokens its hot
    original's, prefix hits — the same as JAX's."""
    got = _drill(st, pkgs, "duplicate_storm", 12, 6, mean_interarrival=2.0)
    (j, jo, jeng, _, _), (t, to, eng, trace, _) = got["jax"], got["port"]
    assert t == j and to == jo
    assert t["outcomes"] == {"OK": len(trace)} and trace.n_duplicates > 0
    assert int(eng.stats.prefix_hits) == int(jeng.stats.prefix_hits) > 0
    mon = pkgs["port"].InvariantMonitor(fp.cfg_of(pkgs["port"], st))
    expected = {it.index: to[it.dup_of][4] for it in trace.items if it.kind == "duplicate"}
    mon.check_tokens(expected, {it.index: to[it.index][4] for it in trace.items})
    mon.assert_clean()
    _close(got)


def test_fault_plan_drill_on_an_engine_equals_jax(st, pkgs):
    """A steady trace under a NaN + wedge plan: the afflicted requests fail
    structurally, the pool serves the rest, strict-clean — as in JAX."""
    def plan(pkg):
        return pkg.FaultPlan((pkg.FaultEvent("nan_logits", at=2, slot=0),
                              pkg.FaultEvent("wedge_slot", at=4, slot=1)), name="nan_wedge")

    got = _drill(st, pkgs, "steady", 8, 4, plan=plan, mean_interarrival=0.1)
    (j, jo, _, _, _), (t, to, _, trace, rep) = got["jax"], got["port"]
    assert t == j and to == jo
    assert t["clean"] and t["plan"] == "nan_wedge"
    assert t["outcomes"].get("FAILED", 0) >= 1 and t["outcomes"].get("OK", 0) >= 1
    assert sum(t["outcomes"].values()) == len(trace)
    assert "fault.injected.nan_logits" in {e["name"] for e in rep.timeline}
    assert pkgs["port"].FaultPlan.from_json(t["plan_json"]) == plan(pkgs["port"])
    _close(got)


def test_brownout_priority_shed_and_retry_hints_equal_jax(st, pkgs):
    """A tight queue: low tiers browned out first, shedding never evicts a
    more important request, gold untouched, every refusal carrying a
    queue-scaled retry hint — the same requests as JAX's, and the monitor
    clean over the drained engine."""
    reqs = fp.samples(st.jcfg, 12, seed=9)
    got = {}
    for name, pkg in pkgs.items():
        tight = fp.cfg_of(pkg, st, serve_max_queue=4, serve_queue_policy="shed_oldest",
                          serve_brownout_queue_frac=0.5, serve_brownout_max_new_tokens=2,
                          serve_retry_after_s=0.25)
        eng = fp.engine(pkg, st, cfg=tight)
        ids = [eng.submit(s, priority=i % 3) for i, s in enumerate(reqs)]
        results = eng.drain()
        mon = pkg.InvariantMonitor(tight)
        got[name] = ([fp.outcome(results[i]) for i in ids], int(eng.stats.browned),
                     mon.check(eng, results=results, expected_ids=ids))
        eng.close()
    assert got["port"] == got["jax"]
    outs, browned, violations = got["port"]
    assert violations == [] and browned > 0
    assert all(o[7] > 0 for o in outs if o[8])                   # browned: tiers > 0
    shed = [o for o in outs if o[1] == "SHED"]
    assert shed and all(o[7] > 0 and o[9] >= 0.25 for o in shed)
    assert all(o[1] == "OK" and not o[8] for o in outs if o[7] == 0)


# ---------------------------------------------------------------------------
# the invariant monitor's seeded violations
# ---------------------------------------------------------------------------

def test_monitor_bit_identity_violation_and_postmortem(st, pkgs, tmp_path):
    got = {}
    for name, pkg in pkgs.items():
        d = tmp_path / name
        mon = pkg.InvariantMonitor(fp.cfg_of(pkg, st), postmortem_dir=str(d))
        ok = np.array([1, 2, 3])
        mon.check_tokens({1: ok, 2: np.array([4])}, {1: ok, 2: np.array([4, 5])})
        mon.check_tokens({3: ok}, {}, label="restore_bit_identity")
        with pytest.raises(AssertionError) as info:
            mon.assert_clean()
        dumped = json.loads((d / "postmortem_chaos_violations.json").read_text())
        got[name] = ([(v.invariant, v.detail, v.data) for v in mon.violations],
                     str(info.value), dumped, type(info.value).__name__)
        clean = pkg.InvariantMonitor(fp.cfg_of(pkg, st))
        clean.check_tokens({1: ok}, {1: np.array(ok)})
        clean.assert_clean()
    assert got["port"] == got["jax"]
    assert [v[0] for v in got["port"][0]] == ["bit_identity", "restore_bit_identity"]
    assert got["port"][3] == "InvariantViolationError" and len(got["port"][2]["violations"]) == 2


def test_monitor_no_double_serve_and_queue_bound_on_a_fake_fleet(st, pkgs):
    """Seeded fleet records: a resubmit off a replica that never retired
    (``no_double_serve``), a second resubmit past ``serve_max_retries``
    (``single_resubmit``), two terminal events for one id
    (``exactly_one_terminal``) and a queue past its bound sampled live
    (``queue_bound``) — the same violations from both monitors."""
    got = {}
    for name, pkg in pkgs.items():
        if name == "jax":
            from csat_tpu.obs import EventRecorder
        else:
            from csat_tpu_torch.obs import EventRecorder
        cfg = fp.cfg_of(pkg, st, serve_max_queue=2)
        obs = EventRecorder(capacity=64, component="fleet")
        obs.emit("fleet.retire", replica=1, reason="x")
        for fid, src in ((7, 1), (7, 1), (8, 0)):
            obs.emit("fleet.resubmit", id=fid, replica=0, from_replica=src)
        eng_obs = EventRecorder(capacity=64, component="serve")
        eng_obs.emit("req.ok", id=3)
        eng_obs.emit("req.shed", id=3)
        eng = types.SimpleNamespace(
            queue_depth=3, occupancy=0, obs=eng_obs, page_leaks=lambda: 0,
            chain_leaks=lambda: 0, stats=types.SimpleNamespace(rebuilds=0, quarantined=0))
        target = types.SimpleNamespace(
            replicas=[types.SimpleNamespace(index=0, engine=eng, closed=False)], obs=obs,
            occupancy=0, queue_depth=3, capacity_frac=1.0, healthy_replicas=[],
            target_replicas=1)
        mon = pkg.InvariantMonitor(cfg)
        mon.observe_tick(target)
        got[name] = [(v.invariant, v.detail) for v in mon.check(target)]
    assert got["port"] == got["jax"]
    assert {"no_double_serve", "single_resubmit", "exactly_one_terminal", "queue_bound",
            "drain_clean"} <= {inv for inv, _ in got["port"]}


# ---------------------------------------------------------------------------
# port-only twins of JAX's slow drills
# ---------------------------------------------------------------------------

def test_randomized_fault_storms_on_a_fleet_stay_clean(st, pkgs):
    """Seeded random plans × zoo traces on a 2-replica fleet: every run
    strict-clean, every request resolved."""
    port = pkgs["port"]
    cfg = fp.cfg_of(port, st)
    for seed, zoo in enumerate(("bursty_multitenant", "poison_flood", "duplicate_storm")):
        f = fp.fleet(port, st)
        plan = port.FaultPlan.random(seed, n_events=3, replicas=2, slots=cfg.serve_slots)
        trace = port.make_trace(port.zoo_spec(zoo, 10, seed=100 + seed), cfg, SRC_V, TRIP_V)
        rep = port.run_chaos(f, trace, plan=plan, monitor=port.InvariantMonitor(cfg),
                             strict=True)
        assert rep.clean and rep.checks > 0 and "UNRESOLVED" not in rep.outcomes
        assert sum(rep.outcomes.values()) == len(trace)
        f.close()


def test_tiered_fleet_spill_storm_and_corrupt_restore(st, pkgs, tmp_path):
    """JAX's tiered fleet drill (``tests/test_tiering.py``): spill storms and
    a corrupt restore on both replicas of a tiered fleet under a duplicate
    storm, strict — clean, every request resolved, spills and digest
    misses on the timeline, no leak."""
    port = pkgs["port"]
    cfg = fp.cfg_of(port, st, serve_page_size=4, serve_tiering=True,
                    serve_tier_dir=str(tmp_path / "tiers"))
    f = fp.fleet(port, st, cfg=cfg)
    plan = port.FaultPlan(name="tier_storm", events=tuple(
        port.FaultEvent(kind=kind, at=at, count=3, replica=rep) for rep in (0, 1)
        for kind, at in (("spill_storm", 2), ("corrupt_tier_restore", 6), ("spill_storm", 9))))
    trace = port.make_trace(port.zoo_spec("duplicate_storm", 12, seed=5), cfg, SRC_V, TRIP_V)
    rep = port.run_chaos(f, trace, plan=plan, monitor=port.InvariantMonitor(cfg), strict=True)
    assert rep.clean and rep.checks > 0 and "UNRESOLVED" not in rep.outcomes
    assert sum(rep.outcomes.values()) == len(trace.items)
    names = {e["name"] for e in rep.timeline}
    assert {"fault.injected.spill_storm", "tier.spill"} <= names
    for r in f.replicas:
        assert r.engine.page_leaks() == 0 and r.engine.chain_leaks() == 0
    f.close()
