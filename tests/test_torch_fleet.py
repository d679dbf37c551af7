"""The replica fleet: the port's ``Fleet`` and ``Router`` against the JAX
package's, the cases of ``tests/test_fleet.py`` run on both.

Both fleets serve the same converted weights (``fleet_parity.stack``: the
micro configuration on the bit-identity paths, 2 slots a replica, rebuild
cap 0) under fake clocks that move 10 ms per fleet tick, so backoff, latency
and deadlines read the same time in both.  Held equal: each request's
status, error, tokens, attempts and backoff, the routes, ``sick_reason``,
``capacity_frac``, resubmission counts, the fleet's events, its summary and
every replica's Prometheus text (bring-up wall time aside).  Port-only:
routes replay identically, the survivors' tokens equal a solo engine's, a
retired or closed replica gives its pool back, the shared module is left
whole by a fleet that mixes a solo and a ``(1, 2)`` serve-mesh replica, and
no fleet-layer module reads a private attribute of another object (the
port's form of JAX's ``private-reach`` rule)."""

import ast
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import fleet_parity as fp
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ("jax", "port")


@pytest.fixture(scope="module")
def st():
    return fp.stack()


@pytest.fixture(scope="module")
def pkgs():
    return {name: fp.package(name) for name in PACKAGES}


def _both(pkgs, run):
    """``run(pkg)`` on both packages; → {package: result}."""
    return {name: run(pkg) for name, pkg in pkgs.items()}


def test_sick_replica_drill_equals_jax(st, pkgs):
    """A rebuild-cap trip on replica 1 after two ticks: the same requests
    finish OK or SHED with the same tokens, the same zero-token requests are
    moved after the same backoff, the same routes, capacity 0.5, the same
    fleet events, summary and per-replica Prometheus text; the survivors'
    tokens equal a fault-free solo engine's; the retired replica's pool is
    gone and replica 0 leaks nothing."""
    reqs = fp.samples(st.jcfg, 12, seed=1)

    def run(pkg):
        f = fp.fleet(pkg, st)
        ids = [f.submit(s) for s in reqs]
        f.tick()
        f.tick()
        pkg.FaultPlan((pkg.FaultEvent("retire_replica", at=0, replica=1),)).apply(f)
        results = f.drain()
        out = dict(fleet=f, ids=ids, outcomes=[fp.outcome(results[i]) for i in ids],
                   routes=dict(f.routes), resubmissions=f.resubmissions,
                   health=[(r.health, r.sick_reason, r.closed) for r in f.replicas],
                   capacity=f.capacity_frac, events=fp.events(f.obs),
                   summary=fp.summary(f), prometheus=fp.prometheus(f),
                   snapshot=f.snapshot())
        return out

    got = _both(pkgs, run)
    j, t = got["jax"], got["port"]
    assert t["outcomes"] == j["outcomes"]
    assert t["routes"] == j["routes"] and t["resubmissions"] == j["resubmissions"] > 0
    assert t["health"] == j["health"]
    assert t["health"][1][0] == "SICK" and "rebuild" in t["health"][1][1]
    assert t["capacity"] == j["capacity"] == 0.5
    assert t["events"] == j["events"]
    assert t["summary"] == j["summary"]
    assert t["prometheus"] == j["prometheus"]
    snap = {k: v for k, v in t["snapshot"].items() if not k.endswith("cold_start_s")}
    assert snap == {k: v for k, v in j["snapshot"].items() if not k.endswith("cold_start_s")}
    statuses = {o[1] for o in t["outcomes"]}
    assert statuses <= {"OK", "SHED"} and "OK" in statuses
    assert all(o[3] > 0 for o in t["outcomes"] if o[1] == "SHED")  # zero-token ones moved
    moved = [o for o in t["outcomes"] if o[5]]
    assert moved and all(o[1] == "OK" and o[6] > 0 for o in moved)

    # port only: the survivors' tokens are a fault-free solo engine's
    solo = fp.engine(pkgs["port"], st)
    ref = solo.generate(reqs)
    for o, r in zip(t["outcomes"], ref):
        if o[1] == "OK":
            assert o[4] == r.tokens.tolist()
    solo.close()
    f = t["fleet"]
    assert f.replicas[0].engine.page_leaks() == 0 and f.replicas[0].engine.chain_leaks() == 0
    assert f.replicas[1].engine._pool is None  # closed: its pages went back
    for side in got.values():
        side["fleet"].close()


def test_watchdog_trip_and_no_healthy_replica_equal_jax(st, pkgs):
    """A tripped watchdog flag retires ONE replica at the next tick (never
    the process); the survivor serves; with none healthy a submit is a
    terminal REJECTED under its fleet id — on both packages alike."""
    reqs = fp.samples(st.jcfg, 3, seed=3)

    def run(pkg):
        f = fp.fleet(pkg, st)
        f.replicas[0].watchdog_tripped = True
        f.tick()
        served = [fp.outcome(r) for r in f.generate(reqs[:2])]
        routes = dict(f.routes)
        f.replicas[1].watchdog_tripped = True
        f.tick()
        fid = f.submit(reqs[2])
        out = dict(served=served, routes=routes, rejected=fp.outcome(f.poll(fid)),
                   drained=sorted(f.drain()), health=[(r.health, r.sick_reason)
                                                      for r in f.replicas],
                   capacity=f.capacity_frac, events=fp.events(f.obs))
        f.close()
        f.close()  # idempotent
        assert all(r.closed for r in f.replicas)
        return out

    got = _both(pkgs, run)
    assert got["port"] == got["jax"]
    t = got["port"]
    assert t["health"][0] == ("SICK", "watchdog timeout")
    assert all(o[1] == "OK" for o in t["served"]) and set(t["routes"].values()) == {1}
    assert t["rejected"][1] == "REJECTED" and "no healthy replicas" in t["rejected"][2]


@pytest.fixture(scope="module")
def healthy(st, pkgs):
    """One 2-replica fleet per package, shared by the cases below in order
    (each leaves its fleet quiescent; the last drains replica 1 away)."""
    fleets = {name: fp.fleet(pkg, st) for name, pkg in pkgs.items()}
    yield fleets
    for f in fleets.values():
        f.close()


def test_routes_equal_jax_and_replay(st, pkgs, healthy):
    """Join-shortest-queue routes over a submit-and-tick trace are JAX's,
    use both replicas, and a fresh port fleet replays them exactly."""
    reqs = fp.samples(st.jcfg, 9, seed=4)

    def run(f):
        ids = []
        for s in reqs:
            ids.append(f.submit(s))
            f.tick()
        res = f.drain()
        return {fid: f.routes[fid] for fid in ids}, [fp.outcome(res[i])[1:5] for i in ids]

    got = {name: run(f) for name, f in healthy.items()}
    assert got["port"] == got["jax"]
    assert set(got["port"][0].values()) == {0, 1}
    again = fp.fleet(pkgs["port"], st)
    routes, _ = run(again)
    again.close()
    assert list(routes.values()) == list(got["port"][0].values())


@pytest.mark.parametrize("policy", ["reject", "shed_oldest"])
def test_fleet_queue_bound_equals_jax(st, healthy, policy):
    """Past the fleet-wide bound of 2, submits are REJECTED ("reject") or
    the deepest healthy queue sheds its head ("shed_oldest"): the same
    requests, errors and counters as JAX's, every request terminal."""
    reqs = fp.samples(st.jcfg, 10, seed=6 if policy == "reject" else 7)

    def run(f):
        base = f.cfg
        f.cfg = base.replace(serve_fleet_max_queue=2, serve_queue_policy=policy)
        try:
            ids = [f.submit(s) for s in reqs]  # no ticks: the queues only fill
            early = [fp.outcome(f.poll(i)) for i in ids]
            res = f.drain()
            snap = f.registry.snapshot()
        finally:
            f.cfg = base
        return (early, [fp.outcome(res[i]) for i in ids],
                {k: snap[k] for k in ("fleet_requests_rejected_total", "fleet_sheds_total")})

    got = {name: run(f) for name, f in healthy.items()}
    assert got["port"] == got["jax"]
    early, final, counters = got["port"]
    refused = [o for o in early if o is not None]
    want = "REJECTED" if policy == "reject" else "SHED"
    assert refused and all(o[1] == want for o in refused)
    assert all(o is not None for o in final)
    key = "fleet_requests_rejected_total" if policy == "reject" else "fleet_sheds_total"
    assert counters[key] >= len(refused)


def test_summary_snapshot_and_prometheus_equal_jax(st, healthy):
    """After the cases above, the fleet summary (merged latency quantiles,
    per-replica breakdown), the flat snapshot and the Prometheus text under
    ``replica="k"`` labels are JAX's."""
    reqs = fp.samples(st.jcfg, 6, seed=10)
    got = {}
    for name, f in healthy.items():
        reqs_out = [fp.outcome(r) for r in f.generate(reqs)]
        got[name] = (reqs_out, fp.summary(f), fp.prometheus(f),
                     {k: v for k, v in f.snapshot().items() if not k.endswith("cold_start_s")})
    assert got["port"] == got["jax"]
    summ, text = got["port"][1], "\n".join(got["port"][2])
    assert summ["replicas"] == summ["healthy_replicas"] == 2 and summ["capacity_frac"] == 1.0
    assert 0.0 <= summ["latency_p50_s"] <= summ["latency_p95_s"]
    assert 'replica="0"' in text and 'replica="1"' in text
    assert "fleet_healthy_replicas 2" in text


def test_backoff_values_equal_jax(healthy):
    """Capped exponential backoff with its deterministic integer jitter,
    over fleet ids, attempts and config seeds."""
    for seed in (0, 2021):
        vals = {}
        for name, f in healthy.items():
            base = f.cfg
            f.cfg = base.replace(seed=seed, serve_resubmit_backoff_s=0.05,
                                 serve_resubmit_backoff_max_s=0.3)
            vals[name] = [f._backoff_s(fid, a) for fid in range(40) for a in (1, 2, 3, 4, 9)]
            f.cfg = base
        assert vals["port"] == vals["jax"]
        assert max(vals["port"]) <= 0.3 and min(vals["port"]) >= 0.025


def test_draining_replica_finishes_then_closes(st, healthy):
    """``drain_replica``: no new work routes to the DRAINING replica; it
    finishes what it holds and closes (its pool returned); capacity 0.5 —
    on both packages alike."""
    reqs = fp.samples(st.jcfg, 6, seed=5)

    def run(f):
        ids = [f.submit(s) for s in reqs[:4]]
        f.tick()
        f.drain_replica(1)
        health = f.replicas[1].health
        late = [f.submit(s) for s in reqs[4:]]
        res = f.drain()
        return (health, [f.routes[i] for i in late], [fp.outcome(res[i])[1:5] for i in ids + late],
                f.replicas[1].closed, f.capacity_frac)

    got = {name: run(f) for name, f in healthy.items()}
    assert got["port"] == got["jax"]
    health, late_routes, outs, closed, cap = got["port"]
    assert health == "DRAINING" and late_routes == [0, 0] and closed and cap == 0.5
    assert all(o[0] == "OK" for o in outs)
    assert healthy["port"].replicas[1].engine._pool is None


def test_router_skips_unhealthy_replicas(pkgs):
    """Both routers: ``pick`` never selects SICK or DRAINING replicas and
    breaks load ties on the lowest index; ``shed_target`` is the deepest
    healthy queue."""
    from csat_tpu_torch.serve.router import DRAINING, HEALTHY, SICK

    def rep(index, health, queue=0, busy=0):
        return types.SimpleNamespace(index=index, health=health, engine=types.SimpleNamespace(
            queue_depth=queue, occupancy=busy))

    reps = [rep(0, SICK), rep(1, HEALTHY, queue=2), rep(2, HEALTHY, queue=1, busy=1),
            rep(3, DRAINING)]
    for pkg in pkgs.values():
        router = pkg.Router()
        assert router.pick(reps).index == 1
        assert router.shed_target(reps).index == 1
        assert router.pick([reps[0], reps[3]]) is None
        assert router.shed_target([rep(1, HEALTHY)]) is None
        assert pkg.Router.placement(reps[2], reps) == {"load": 2, "healthy": 2}


def test_mesh_replica_and_shared_module_left_whole(st, pkgs):
    """Replica 1 on a ``(1, 2)`` serve mesh (both shards on the CPU) beside a
    solo replica 0: tokens and statuses equal a 2-solo fleet's bit for bit,
    and the one module the replicas share keeps its parameters' bits, its
    dtypes and its mode."""
    port = pkgs["port"]
    model = st.tmodel
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mode = model.training
    reqs = fp.samples(st.jcfg, 8, seed=12)
    runs = []
    for shapes in (None, [(), (1, 2)]):
        f = fp.fleet(port, st, mesh_shapes=shapes)
        runs.append(([fp.outcome(r)[1:5] for r in f.generate(reqs)], dict(f.routes)))
        if shapes is not None:
            assert f.replicas[1].engine.mesh is not None and f.replicas[0].engine.mesh is None
        f.close()
    assert runs[0] == runs[1] and set(runs[1][1].values()) == {0, 1}
    after = model.state_dict()
    assert model.training == mode and sorted(after) == sorted(before)
    for k, v in before.items():
        assert after[k].dtype == v.dtype and torch.equal(after[k], v), k


def test_fleet_runs_on_the_models_device(st, pkgs, monkeypatch):
    """Every replica serves on the device of the module it is given; the
    fleet never picks a device of its own (a card module would put every
    replica on the card)."""
    f = fp.fleet(pkgs["port"], st)
    assert {r.engine.device.type for r in f.replicas} == {"cpu"}
    f.close()
    seen = []
    import csat_tpu_torch.serve.fleet as fleet_mod

    class Probe:
        def __init__(self, model, cfg, device=None, **kw):
            seen.append(device)
            raise RuntimeError("probe")

    monkeypatch.setattr(fleet_mod, "ServeEngine", Probe)
    fake = types.SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="probe"):
        fleet_mod.Fleet(fake, st.tcfg, replicas=1)
    assert seen == [torch.device("cuda", 0)]


FLEET_LAYER = ("serve/fleet.py", "serve/router.py", "serve/autoscale.py",
               "resilience/chaos.py", "resilience/invariants.py")


@pytest.mark.parametrize("rel", FLEET_LAYER)
def test_fleet_layer_reads_no_private_attribute(rel):
    """The fleet layer composes engines through their public surface only:
    no ``obj._name`` on anything but ``self`` (JAX's ``private-reach``
    lint rule over the same files)."""
    tree = ast.parse((REPO / "csat_tpu_torch" / rel).read_text())
    bad = [(node.lineno, node.attr) for node in ast.walk(tree)
           if isinstance(node, ast.Attribute) and node.attr.startswith("_")
           and not node.attr.startswith("__")
           and not (isinstance(node.value, ast.Name) and node.value.id == "self")]
    assert not bad, f"{rel} reads private attributes: {bad}"


def test_private_reach_scan_catches_a_reach():
    """The scan above is not vacuous: it flags a seeded reach-through."""
    tree = ast.parse("def f(rep):\n    return rep.engine._queue\n")
    hits = [n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
            and n.attr.startswith("_") and not n.attr.startswith("__")
            and not (isinstance(n.value, ast.Name) and n.value.id == "self")]
    assert hits == ["_queue"]


def test_engine_close_releases_its_pool(st, pkgs):
    """``ServeEngine.close`` drops the pool (and stays idempotent), so a
    fleet's retired or drained replica gives its pages back; results stay
    readable."""
    eng = fp.engine(pkgs["port"], st)
    res = eng.generate(fp.samples(st.jcfg, 2, seed=13))
    assert eng._pool is not None and all(r.ok for r in res)
    assert eng.close() is True and eng.close() is False
    assert eng._pool is None and eng.page_leaks() == 0
    assert [eng.poll(r.id).status for r in res] == ["OK", "OK"]
    assert np.asarray(eng.poll(res[0].id).tokens).size > 0


def test_closed_engine_refuses_what_needs_its_pool(st, pkgs):
    """An engine closed with rows in flight has no pool to read their
    tokens from: ticking it, reading its partial tokens or shedding its
    rows raise a clear error instead of failing on a missing pool."""
    eng = fp.engine(pkgs["port"], st)
    for x in fp.samples(st.jcfg, 2, seed=13):
        eng.submit(x, 4)
    eng.tick()
    eng.tick()
    assert eng.occupancy and eng.partial_tokens()
    eng.close()
    for call in (eng.tick, eng.partial_tokens, eng.shed_all):
        with pytest.raises(RuntimeError, match="engine closed"):
            call()
