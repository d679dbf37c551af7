"""The self-healing fleet: the port's ``AutoScaler`` and the fleet's
elasticity against the JAX package's, the cases of
``tests/test_autoscale.py`` run on both.

* The supervisor's control flow on a fake fleet (no engines): heal without
  cooldown, scale up behind hysteresis, cooldown and the ceiling, scale down
  of the highest index with the target lowered first, the churn bound
  capping a heal storm — the same action sequences, fleet states and
  events from both ``AutoScaler``s.
* The drills on real fleets (``fleet_parity.stack``, fake clocks): the
  bursty-trace heal drill run strict with the supervisor attached (same
  outcomes, heals, ``time_to_recover_s``, events; the replacement's
  cold prefix cache and own stats; tokens after the heal equal JAX's and a
  solo engine's), a killed spawn then a good one, and an unsupervised
  retirement tripping ``capacity_recovers`` (and a seeded resubmit tripping
  ``no_double_serve``).
* Warm start across a fleet on the CPU: one store shared by every replica,
  and ``corrupt_warmstart`` latching onto its entries.  The per-engine
  verdicts need the card's libraries (``tests/test_torch_warmstart.py``
  holds ``ops/build.py:warm_library`` with a stub compiler,
  ``tests/test_torch_cuda_fleet.py`` and ``chip_smoke.py``'s ``fleet`` phase
  hold them on the card)."""

import types

import pytest

import fleet_parity as fp
from torch_parity import SRC_V, TRIP_V, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PACKAGES = ("jax", "port")


@pytest.fixture(scope="module")
def st():
    # one prefill bucket, heal every tick, resubmit at once (JAX's auto_cfg)
    return fp.stack(bucket_src_lens=(48,), serve_resubmit_backoff_s=0.0,
                    serve_autoscale_every_ticks=1)


@pytest.fixture(scope="module")
def pkgs():
    return {name: fp.package(name) for name in PACKAGES}


# ---------------------------------------------------------------------------
# the supervisor's control flow on a fake fleet
# ---------------------------------------------------------------------------

class _FakeObs:
    def __init__(self):
        self.events = []

    def emit(self, name, **fields):
        self.events.append((name, fields))


class _FakeFleet:
    """The public surface ``AutoScaler`` reads and drives
    (``tests/test_autoscale.py:_FakeFleet``)."""

    def __init__(self, cfg, n=1):
        self.cfg = cfg
        self.ticks = 0
        self.now = 0.0
        self.queue_depth = 0
        self.occupancy = 0
        self.target_replicas = n
        self.healthy_replicas = [self._replica(k) for k in range(n)]
        self._next = n
        self.obs = _FakeObs()
        self.spawn_ok = True

    @staticmethod
    def _replica(index, slots=2):
        return types.SimpleNamespace(index=index, engine=types.SimpleNamespace(
            num_slots=slots, stats=types.SimpleNamespace(
                pages_in_use=0, pages_usable=10, class_p95=lambda priority=0: 0.0)))

    def clock(self):
        return self.now

    def set_target(self, n):
        self.target_replicas = max(1, int(n))

    def add_replica(self):
        if not self.spawn_ok:
            return None
        rep = self._replica(self._next)
        self._next += 1
        self.healthy_replicas.append(rep)
        return rep

    def drain_replica(self, k):
        self.healthy_replicas = [r for r in self.healthy_replicas if r.index != k]


def _scaler_cfg(pkg):
    if pkg.name == "jax":
        from csat_tpu.configs import get_config
    else:
        from csat_tpu_torch.configs import get_config
    return get_config(
        "python", serve_slots=2, serve_min_replicas=1, serve_max_replicas=3,
        serve_autoscale=True, serve_autoscale_every_ticks=1, serve_autoscale_hysteresis=2,
        serve_autoscale_cooldown_s=10.0, serve_autoscale_up_queue_frac=1.5,
        serve_autoscale_down_queue_frac=0.1, serve_autoscale_down_busy_frac=0.25,
        serve_autoscale_max_actions=4, serve_autoscale_churn_window_s=60.0)


def _heal(fleet, sc):
    fleet.healthy_replicas.pop()  # a retirement
    out = []
    for t in (1, 1, 2):
        fleet.ticks = t
        out.append(sc.step())
    return out


def _up(fleet, sc):
    fleet.queue_depth = 10  # 5 per slot >> 1.5
    out = []
    for t, now in ((1, 1.0), (2, 2.0), (3, 3.0), (4, 4.0), (5, 13.0), (6, 30.0), (7, 31.0)):
        fleet.ticks, fleet.now = t, now
        out.append(sc.step())
    return out


def _down(fleet, sc):
    fleet.target_replicas = 3
    out = []
    for t, now in ((1, 20.0), (2, 21.0), (3, 100.0), (4, 101.0), (5, 200.0), (6, 201.0)):
        fleet.ticks, fleet.now = t, now
        out.append(sc.step())
    return out


def _churn(fleet, sc):
    fleet.healthy_replicas.pop()
    fleet.spawn_ok = False  # every spawn fails: a crash loop
    out = []
    for t in range(1, 10):
        fleet.ticks, fleet.now = t, float(t)
        out.append(sc.step())
    return out


SCENARIOS = {"heal": (_heal, 2), "up": (_up, 1), "down": (_down, 3), "churn": (_churn, 2)}
WANT = {
    "heal": [["heal"], [], []],
    "up": [[], ["up"], [], [], ["up"], [], []],
    "down": [[], ["down"], [], ["down"], [], []],
    "churn": [["heal"]] * 4 + [[]] * 5,
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_supervisor_control_flow_equals_jax(pkgs, scenario):
    drive, n = SCENARIOS[scenario]
    got = {}
    for name, pkg in pkgs.items():
        fleet = _FakeFleet(_scaler_cfg(pkg), n=n)
        sc = pkg.AutoScaler(fleet)
        actions = drive(fleet, sc)
        got[name] = (actions, fleet.target_replicas,
                     [r.index for r in fleet.healthy_replicas], fleet.obs.events,
                     (sc.heals, sc.ups, sc.downs), sc.max_replicas, sc.min_replicas)
    assert got["port"] == got["jax"]
    assert got["port"][0] == WANT[scenario]
    if scenario == "down":
        assert got["port"][2] == [0] and got["port"][3][0][1]["replica"] == 2
    if scenario == "churn":
        assert all(f["ok"] == 0 for name, f in got["port"][3] if name == "autoscale.heal")


def test_supervisor_stamps_firing_slo_alerts(pkgs):
    """``slo`` is duck-typed (anything with ``alerts``): a decision taken
    while objectives fire carries them, as in JAX."""
    got = {}
    for name, pkg in pkgs.items():
        fleet = _FakeFleet(_scaler_cfg(pkg), n=2)
        sc = pkg.AutoScaler(fleet, slo=types.SimpleNamespace(alerts={"p95": 1, "avail": 2}))
        _heal(fleet, sc)
        got[name] = fleet.obs.events
    assert got["port"] == got["jax"]
    assert got["port"][0][1]["slo_firing"] == "avail,p95"


# ---------------------------------------------------------------------------
# drills on real fleets
# ---------------------------------------------------------------------------

def _spawn_fields(events):
    """Fleet events without bring-up wall times and warm-start counts (the
    CPU engine loads no kernel library; the JAX engine its programs)."""
    drop = ("cold_start_s", "spawn_s", "warm", "cold")
    return [(n, {k: v for k, v in (f or {}).items() if k not in drop}) for n, f in events]


def _chaos(pkg, f, trace, plan, monitor, supervisor=None, strict=True):
    rep = pkg.run_chaos(f, trace, plan=plan, monitor=monitor, strict=strict,
                        supervisor=supervisor)
    return dict(outcomes=rep.outcomes, per_class=rep.per_class, violations=rep.violations,
                checks=rep.checks, capacity=rep.capacity_frac, resubmissions=rep.resubmissions,
                n_ticks=rep.n_ticks, recover=rep.time_to_recover_s,
                spawned=rep.replicas_spawned, trace_json=rep.trace_json,
                plan_json=rep.plan_json)


def test_heal_drill_strict_equals_jax(st, pkgs, tmp_path):
    """A mid-burst retirement healed by the supervisor, run strict: the same
    outcomes, recovery time and fleet events; the replacement is HEALTHY
    with a cold prefix cache and its own stats and recorder; tokens after
    the heal equal JAX's fleet's and a fault-free solo engine's."""
    later = fp.samples(st.jcfg, 4, seed=9)
    got = {}
    for name, pkg in pkgs.items():
        cfg = fp.cfg_of(pkg, st, serve_warmstart=True,
                        serve_warmstart_dir=str(tmp_path / f"ws_{name}"),
                        serve_min_replicas=2, serve_max_replicas=2, serve_autoscale=True)
        f = fp.fleet(pkg, st, cfg=cfg)
        trace = pkg.make_trace(pkg.zoo_spec("bursty_multitenant", n_requests=6, seed=5,
                                            mean_interarrival=1.0), cfg, SRC_V, TRIP_V)
        plan = pkg.FaultPlan((pkg.FaultEvent("retire_replica", at=4, replica=1),),
                             name="heal_drill")
        scaler = pkg.AutoScaler(f)
        rec = _chaos(pkg, f, trace, plan, pkg.InvariantMonitor(cfg, expect_recovery=True),
                     scaler)
        spawned = [r for r in f.replicas if r.index >= 2]
        survivors = [r for r in f.replicas if r.health == "HEALTHY"]
        rec.update(heals=scaler.heals, events=_spawn_fields(fp.events(f.obs)),
                   health=[(r.index, r.health, r.closed) for r in f.replicas],
                   capacity_after=f.capacity_frac,
                   spawned_prefix_hits=[int(r.engine.stats.prefix_hits) for r in spawned],
                   own_stats=len({id(r.engine.stats) for r in survivors}) == len(survivors),
                   own_obs=len({id(r.engine.obs) for r in survivors}) == len(survivors),
                   shared_store=all(r.engine.warmstart is f.warmstart for r in f.replicas),
                   later=[fp.outcome(r)[1:5] for r in f.generate(later)])
        f.close()
        got[name] = rec
    assert got["port"] == got["jax"]
    t = got["port"]
    assert t["violations"] == [] and t["heals"] == 1 and t["spawned"] == 1
    assert t["recover"] >= 0 and t["capacity_after"] == 1.0
    assert [h[1] for h in t["health"] if h[0] >= 2] == ["HEALTHY"]
    assert t["spawned_prefix_hits"] == [0] and t["own_stats"] and t["own_obs"]
    assert t["shared_store"]
    names = [n for n, _ in t["events"]]
    assert {"fleet.retire", "fleet.spawn", "autoscale.heal"} <= set(names)
    solo = fp.engine(pkgs["port"], st)
    ref = [fp.outcome(r)[1:5] for r in solo.generate(later)]
    solo.close()
    assert t["later"] == ref and all(o[0] == "OK" for o in ref)


def test_killed_spawn_then_retry_equals_jax(st, pkgs):
    """A spawn killed mid-bring-up is a structured ``fleet.spawn_failed``
    and None — no half-built replica — and the next spawn succeeds."""
    got = {}
    for name, pkg in pkgs.items():
        f = fp.fleet(pkg, st, replicas=1)
        f.set_target(2)
        f.arm_spawn_kill(1)
        first = f.add_replica()
        state = (first is None, len(f.replicas), f.capacity_frac)
        rep = f.add_replica()
        got[name] = (state, rep.index, rep.health, f.capacity_frac,
                     _spawn_fields(fp.events(f.obs)), f.summary()["replicas_spawned"])
        f.close()
    assert got["port"] == got["jax"]
    t = got["port"]
    assert t[0] == (True, 1, 0.5) and t[1:4] == (1, "HEALTHY", 1.0)
    names = [n for n, _ in t[4]]
    assert names == ["fleet.spawn_start", "fleet.spawn_failed", "fleet.spawn_start",
                     "fleet.spawn"]


def test_add_replica_then_drain_restores_capacity(st, pkgs):
    """Scale up by hand then shrink: capacity against the target, both
    replicas serve, the drained replica closes, slots of closed replicas
    no longer count — on both packages alike."""
    reqs = fp.samples(st.jcfg, 4, seed=3)
    got = {}
    for name, pkg in pkgs.items():
        f = fp.fleet(pkg, st, replicas=1)
        f.set_target(2)
        caps = [f.capacity_frac]
        rep = f.add_replica()
        caps.append(f.capacity_frac)
        served = [fp.outcome(r)[1:5] for r in f.generate(reqs)]
        f.set_target(1)
        f.drain_replica(1)
        for _ in range(6):
            f.tick()
            if f.replicas[1].closed:
                break
        got[name] = (rep.index, caps, served, dict(f.routes), f.replicas[1].closed,
                     f.capacity_frac, f.num_slots, f.summary()["target_replicas"])
        f.close()
    assert got["port"] == got["jax"]
    t = got["port"]
    assert t[0] == 1 and t[1] == [0.5, 1.0] and t[4] and t[5] == 1.0 and t[6] == 2
    assert all(o[0] == "OK" for o in t[2]) and set(t[3].values()) == {0, 1}


def test_unsupervised_retirement_trips_capacity_recovers(st, pkgs):
    """Nobody heals: ``capacity_recovers`` is a violation (strict off), and
    a resubmit whose source never retired trips ``no_double_serve``."""
    got = {}
    for name, pkg in pkgs.items():
        cfg = fp.cfg_of(pkg, st)
        f = fp.fleet(pkg, st)
        trace = pkg.make_trace(pkg.zoo_spec("bursty_multitenant", n_requests=4, seed=7,
                                            mean_interarrival=1.0), cfg, SRC_V, TRIP_V)
        plan = pkg.FaultPlan((pkg.FaultEvent("retire_replica", at=3, replica=1),))
        rec = _chaos(pkg, f, trace, plan, pkg.InvariantMonitor(cfg, expect_recovery=True),
                     strict=False)
        fresh = pkg.InvariantMonitor(cfg)
        f.obs.emit("fleet.resubmit", id=999, replica=0, from_replica=0)
        rec["seeded"] = [(v.invariant, v.detail) for v in fresh.check(f)]
        f.close()
        got[name] = rec
    assert got["port"] == got["jax"]
    t = got["port"]
    assert t["capacity"] == 0.5 and t["spawned"] == 0
    assert "capacity_recovers" in {v["invariant"] for v in t["violations"]}
    assert "no_double_serve" in {inv for inv, _ in t["seeded"]}


def test_fleet_fault_kinds_refused_on_a_bare_engine(st, pkgs):
    for pkg in pkgs.values():
        eng = fp.engine(pkg, st)
        for kind in ("corrupt_warmstart", "kill_during_spawn"):
            with pytest.raises(ValueError, match="Fleet target"):
                pkg.FaultPlan((pkg.FaultEvent(kind, at=1),)).apply(eng)
        eng.close()


def test_corrupt_warmstart_latches_onto_the_shared_store(st, pkgs, tmp_path, monkeypatch):
    """On the CPU no engine loads a kernel library, so the store is seeded
    as a card process leaves it (``ops/build.py`` with a stub compiler):
    ``corrupt_warmstart`` corrupts every entry of the one store all
    replicas share, the plan's event says how many, and the next request
    for each library books ``digest_mismatch`` and repairs the entry."""
    from csat_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "PROVENANCE", {})

    def nvcc_build(todo):
        for n in todo:
            build.build_dir().mkdir(parents=True, exist_ok=True)
            build.library_path(n).write_bytes(b"\x7fELF built " + n.encode())

    monkeypatch.setattr(build, "_nvcc_build", nvcc_build)
    monkeypatch.setattr(build, "_open", lambda path: types.SimpleNamespace(
        **{fn: types.SimpleNamespace() for fn in build.KERNELS}))
    port = pkgs["port"]
    cfg = fp.cfg_of(port, st, serve_warmstart=True, serve_warmstart_dir=str(tmp_path / "ws"))
    f = fp.fleet(port, st, cfg=cfg)
    assert all(r.engine.warmstart is f.warmstart for r in f.replicas)
    assert [build.warm_library(lib, f.warmstart) for lib in build.SERVE_LIBRARIES] == [
        "absent", "absent"]
    port.FaultPlan((port.FaultEvent("corrupt_warmstart", at=0),)).apply(f)
    corrupt = [fields for name, fields in fp.events(f.obs) if name == "fault.corrupt_warmstart"]
    assert corrupt == [{"entries": len(build.SERVE_LIBRARIES)}]
    assert [build.warm_library(lib, f.warmstart) for lib in build.SERVE_LIBRARIES] == [
        "digest_mismatch", "digest_mismatch"]
    assert [build.warm_library(lib, f.warmstart) for lib in build.SERVE_LIBRARIES] == [
        "hit", "hit"]
    f.close()


def test_randomized_heal_storms_stay_clean_on_the_port(st, pkgs, tmp_path):
    """The port's twin of JAX's slow scale-storm property: seeded retire
    schedules crossed with two zoo traces on a 2-replica fleet with the
    supervisor attached, every run strict-clean with capacity healed."""
    port = pkgs["port"]
    for seed in range(3):
        cfg = fp.cfg_of(port, st, serve_warmstart=True,
                        serve_warmstart_dir=str(tmp_path / "ws"), serve_min_replicas=2,
                        serve_max_replicas=2, serve_autoscale=True)
        f = fp.fleet(port, st, cfg=cfg)
        spec = port.zoo_spec(["bursty_multitenant", "duplicate_storm"][seed % 2],
                             n_requests=6, seed=50 + seed, mean_interarrival=1.0)
        plan = port.FaultPlan((port.FaultEvent("retire_replica", at=3 + seed, replica=1),))
        scaler = port.AutoScaler(f)
        rec = _chaos(port, f, port.make_trace(spec, cfg, SRC_V, TRIP_V), plan,
                     port.InvariantMonitor(cfg, expect_recovery=True), scaler)
        assert rec["violations"] == [] and f.capacity_frac == 1.0 and scaler.heals >= 1
        f.close()
