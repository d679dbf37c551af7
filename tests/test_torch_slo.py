"""Burn-rate SLOs and the ``top`` console: the port's ``obs/slo.py`` and
``obs/top.py`` against the JAX package's ``obs/slo.py`` and the repo's
``tools/serve_top.py``.

The same registry samples on a fake clock (counters of every terminal
outcome, per-class latency histograms, a registry reset) go through both
packages' ``SLOEngine``: transitions, burns, alerts, the gauges, the
recorder's events and ``summary()`` must be equal, in JAX's drills of
``tests/test_rtrace.py`` and on seeded random streams.  ``for_target``
wires both packages' engines and fleets (``fleet_parity.stack``, fake
clocks) the same way: an overload leg fires the availability alert and
clean traffic clears it, equal to JAX's, and an ``AutoScaler`` stamps the
firing objective into its decision.  ``top --once`` prints what
``tools/serve_top.py`` prints on one metrics file: a synthetic fleet
snapshot carrying every column family, and a file the port's serve stack
wrote (a fleet behind the front door, SLO gauges, a trace dump)."""

import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest

import fleet_parity as fp
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("jax", "port")
_BAD = ("serve_requests_failed_total", "serve_requests_timeout_total",
        "serve_requests_rejected_total", "serve_requests_shed_total")


def slo_pkg(name):
    if name == "jax":
        from csat_tpu.obs import EventRecorder, MetricsRegistry
        from csat_tpu.obs.slo import Objective, SLOEngine, objectives_from_config
    else:
        from csat_tpu_torch.obs import EventRecorder, MetricsRegistry
        from csat_tpu_torch.obs.slo import Objective, SLOEngine, objectives_from_config
    return types.SimpleNamespace(EventRecorder=EventRecorder, MetricsRegistry=MetricsRegistry,
                                 Objective=Objective, SLOEngine=SLOEngine,
                                 objectives_from_config=objectives_from_config)


def _events(recorder):
    return [(name, fields) for _, name, _, fields in recorder.events()]


def _gauges(reg):
    return {k: v for k, v in reg.snapshot().items() if k.startswith("slo_")}


def _run(name, feed, objectives, steps, **kw):
    """Feed both registries the same samples step by step → the engine's
    transitions, burns, alerts, gauges and summary after each step."""
    p = slo_pkg(name)
    regs = [p.MetricsRegistry()]
    now = [0.0]
    rec = p.EventRecorder(capacity=256, component="slo")
    gauges = p.MetricsRegistry()
    objs = [p.Objective(**o) for o in objectives]
    slo = p.SLOEngine(lambda: regs, objs, recorder=rec, clock=lambda: now[0], gauges=gauges, **kw)
    out = []
    for i in range(steps):
        feed(i, regs, now, p)
        out.append((slo.step(), slo.burns(), slo.alerts, dict(slo.fired), _gauges(gauges),
                    slo.summary()))
    return out, _events(rec)


def _both(feed, objectives, steps, **kw):
    got = {name: _run(name, feed, objectives, steps, **kw) for name in PACKAGES}
    assert got["port"] == got["jax"]
    return got["port"]


AVAIL = [dict(name="availability", kind="availability", target=0.9)]


def test_alert_fires_on_both_windows_and_clears_as_jax():
    """JAX's drill: a shed storm fires the availability alert on both
    windows, all-good traffic clears it, a registry reset re-anchors."""
    def feed(i, regs, now, p):
        reg = regs[0]
        now[0] = float(i)
        if i == 1:
            reg.counter("serve_requests_shed_total").inc(10)
        elif 2 <= i < 16:
            reg.counter("serve_requests_ok_total").inc(10)
        elif i == 16:
            regs[0] = p.MetricsRegistry()
            regs[0].counter("serve_requests_ok_total")

    steps, events = _both(feed, AVAIL, 17, fast_s=4.0, slow_s=12.0, burn_fast=2.0,
                          burn_slow=1.0)
    assert steps[0][0] == [] and steps[1][0][0]["state"] == "alert"
    assert steps[1][4]["slo_alert_availability"] == 1 and steps[1][3] == {"availability": 1}
    states = [t["state"] for s in steps for t in s[0]]
    assert states == ["alert", "ok"] and steps[15][4]["slo_alert_availability"] == 0
    assert steps[16][0] == [] and [e[0] for e in events] == ["slo.alert", "slo.ok"]


def test_latency_objective_reads_class_histograms_as_jax():
    """1 observation under 0.5 s and 3 over, target 0.5: burn 1.5 on both
    windows fires the class-1 latency alert."""
    def feed(i, regs, now, p):
        h = regs[0].histogram("serve_class1_latency_seconds", buckets=(0.5, 2.0))
        if i == 1:
            now[0] = 1.0
            h.observe(0.1)
            for _ in range(3):
                h.observe(1.0)

    steps, _ = _both(feed, [dict(name="latency_batch", kind="latency", target=0.5,
                                 latency_s=0.5, priority=1)], 2,
                     fast_s=2.0, slow_s=4.0, burn_fast=1.5, burn_slow=1.0)
    assert steps[1][0][0]["state"] == "alert"
    assert steps[1][1]["latency_batch"] == pytest.approx((1.5, 1.5))


@pytest.mark.parametrize("seed", range(4))
def test_random_samples_give_jax_s_burns(seed):
    """A seeded stream of outcome counts and latency observations over two
    registries (one replaced mid-run, as a replica is), on an uneven clock:
    every step's transitions, burns, gauges and summary are JAX's."""
    rng = np.random.default_rng(seed)
    plan = [dict(dt=float(rng.uniform(0.05, 1.5)),
                 ok=int(rng.integers(0, 12)), bad=[int(x) for x in rng.integers(0, 4, 4)],
                 storm=bool(rng.random() < 0.15),
                 lat=[(int(rng.integers(0, 3)), float(rng.lognormal(-1.0, 1.0)))
                      for _ in range(int(rng.integers(0, 6)))], reset=bool(rng.random() < 0.03))
            for _ in range(120)]

    def feed(i, regs, now, p):
        step = plan[i]
        now[0] += step["dt"]
        if len(regs) < 2:
            regs.append(p.MetricsRegistry())
        if step["reset"]:
            regs[1] = p.MetricsRegistry()
        reg = regs[i % 2]
        reg.counter("serve_requests_ok_total").inc(step["ok"])
        for name, n in zip(_BAD, step["bad"]):
            reg.counter(name).inc(n * (8 if step["storm"] else 0))
        for pr, v in step["lat"]:
            reg.histogram(f"serve_class{pr}_latency_seconds",
                          buckets=(0.1, 0.25, 0.5, 1.0, 2.5)).observe(v)

    objectives = AVAIL + [dict(name=f"latency_class{p}", kind="latency", target=0.8,
                               latency_s=0.4, priority=p) for p in range(3)]
    steps, events = _both(feed, objectives, len(plan), fast_s=3.0, slow_s=15.0,
                          burn_fast=3.0, burn_slow=1.5)
    assert any(s[0] for s in steps) and events


@pytest.mark.parametrize("classes,lats", [(1, ()), (3, (1.0, 8.0)), (2, (0.25,)),
                                          (4, (0.5, 1.0, 2.0, 4.0))])
def test_objectives_from_config_equal_jax(classes, lats):
    from torch_parity import configs

    jcfg, tcfg = configs(serve_priority_classes=classes, slo_latency_s=lats)
    got = {name: [dataclasses.asdict(o) for o in slo_pkg(name).objectives_from_config(cfg)]
           for name, cfg in (("jax", jcfg), ("port", tcfg))}
    assert got["port"] == got["jax"]
    assert [o["name"] for o in got["port"]] == ["availability"] + (
        [f"latency_class{p}" for p in range(classes)] if lats else [])


@pytest.mark.parametrize("field,value", [
    ("slo_availability", 1.0), ("slo_latency_s", (0.5, 0.0)), ("slo_latency_target", 0.0),
    ("slo_fast_window_s", 0.0), ("slo_slow_window_s", 1.0), ("slo_burn_fast", 0.0),
    ("slo_burn_slow", -1.0), ("serve_net_port", -1), ("serve_net_client_buffer", 0),
    ("serve_net_frame_ring", 0), ("serve_net_done_retain", 0)])
def test_config_refuses_what_jax_refuses(field, value):
    """The ``slo_*`` and ``serve_net_*`` fields carry JAX's defaults and its
    asserts: each value JAX refuses, the port refuses."""
    from csat_tpu.configs import Config as JConfig, get_config as jget
    from csat_tpu_torch.configs import Config, get_config

    names = [f for f in Config.__dataclass_fields__
             if f.startswith(("slo_", "serve_net_"))]
    assert len(names) == 15
    assert all(Config.__dataclass_fields__[f].default == JConfig.__dataclass_fields__[f].default
               for f in names)
    with pytest.raises(AssertionError):
        jget("python", **{field: value})
    with pytest.raises(AssertionError):
        get_config("python", **{field: value})


# ---------------------------------------------------------------------------
# for_target over live engines and fleets
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def st():
    return fp.stack(bucket_src_lens=(48,), serve_priority_classes=3)


OVERLOAD = dict(serve_max_queue=2, serve_queue_policy="reject", slo_availability=0.9,
                slo_fast_window_s=0.5, slo_slow_window_s=2.0, slo_burn_fast=2.0,
                slo_burn_slow=1.0)


def _slo_leg(target, slo, samples):
    """Overload (all samples at once: most refused), then clean traffic (one
    request every four ticks) until the alert clears → the transitions."""
    tick = target.tick
    trans = []
    slo.step()
    for s in samples:
        target.submit(s, max_new_tokens=3)
    for _ in range(4):
        tick()
        trans += [dict(t, leg="overload") for t in slo.step()]
    fired = dict(slo.alerts)
    for k in range(400):
        if k % 4 == 0:
            for s in samples[:1]:
                target.submit(s, max_new_tokens=3)
        tick()
        trans += [dict(t, leg="clean") for t in slo.step()]
        if not slo.alerts and k > 100:
            break
    return trans, fired


def test_for_target_over_an_engine_fires_and_clears_as_jax(st):
    """An overload leg (a queue of 2, requests refused) fires the
    availability alert into the engine's recorder and gauges; clean traffic
    clears it — the same transitions, events and summary as JAX's."""
    samples = fp.samples(st.jcfg, 12, seed=3)
    got = {}
    for name in PACKAGES:
        pkg = fp.package(name)
        cfg = fp.cfg_of(pkg, st, **OVERLOAD)
        eng = fp.engine(pkg, st, cfg=cfg)
        slo = slo_pkg(name).SLOEngine.for_target(eng, cfg)
        assert slo.recorder is eng.obs and slo.gauges is eng.stats.registry
        trans, fired = _slo_leg(eng, slo, samples)
        got[name] = (trans, fired, slo.summary(),
                     [e for e in _events(eng.obs) if e[0].startswith("slo.")],
                     _gauges(eng.stats.registry), eng.stats.rejected)
        eng.close()
    assert got["port"] == got["jax"]
    trans, fired, summary, events, gauges, rejected = got["port"]
    assert rejected > 0 and "availability" in fired
    assert [(t["state"], t["leg"]) for t in trans] == [("alert", "overload"), ("ok", "clean")]
    assert [e[0] for e in events] == ["slo.alert", "slo.ok"]
    assert gauges["slo_alert_availability"] == 0 and summary["slo_fired_availability"] == 1


def test_for_target_over_a_fleet_and_the_autoscaler_stamp(st):
    """Over a 2-replica fleet the engine sums the live replicas' registries
    and writes its gauges onto the fleet's: the overload fires the alert
    (equal to JAX's), and an ``AutoScaler`` with ``scaler.slo`` set stamps
    the firing objective into the heal it takes while it fires."""
    samples = fp.samples(st.jcfg, 16, seed=4)
    got = {}
    for name in PACKAGES:
        pkg = fp.package(name)
        # shed_oldest: the fleet's admission sheds on a replica, whose
        # registry the SLO engine reads (a fleet-level REJECTED is the fleet's)
        cfg = fp.cfg_of(pkg, st, **{**OVERLOAD, "serve_queue_policy": "shed_oldest",
                                    "serve_max_replicas": 3, "serve_autoscale_every_ticks": 1})
        fleet = fp.fleet(pkg, st, cfg=cfg, replicas=2)
        slo = slo_pkg(name).SLOEngine.for_target(fleet, cfg)
        assert slo.recorder is fleet.obs and slo.gauges is fleet.registry
        scaler = pkg.AutoScaler(fleet, cfg)
        scaler.slo = slo
        slo.step()
        for s in samples:
            fleet.submit(s, max_new_tokens=3)
        fleet.tick()
        trans = slo.step()
        fleet.set_target(3)
        actions = scaler.step()
        heal = [f for n, f in _events(fleet.obs) if n == "autoscale.heal"]
        got[name] = (trans, actions, heal, _gauges(fleet.registry), slo.summary())
        fleet.close()
    assert got["port"] == got["jax"]
    trans, actions, heal, gauges, _ = got["port"]
    assert trans and trans[0]["state"] == "alert" and gauges["slo_alert_availability"] == 1
    assert actions == ["heal"] and heal[0]["slo_firing"] == "availability"


# ---------------------------------------------------------------------------
# top
# ---------------------------------------------------------------------------


def _jax_top():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tools import serve_top

    return serve_top


def _snapshot():
    """One fleet snapshot carrying every column family ``top`` renders."""
    snap = {"t": 1_700_000_000.0, "fleet_capacity_frac": 0.5, "fleet_healthy_replicas": 1,
            "fleet_target_replicas": 2, "fleet_queue_depth": 3, "fleet_slots_occupied": 5,
            "fleet_resubmissions_total": 2, "fleet_replicas_spawned_total": 1,
            "slo_burn_fast_availability": 15.25, "slo_burn_slow_availability": 7.5,
            "slo_alert_availability": 1, "slo_burn_fast_latency_class0": 0.0,
            "slo_burn_slow_latency_class0": 0.125, "slo_alert_latency_class0": 0}
    for k, health in ((0, 0), (2, 2)):
        snap.update({f"replica{k}_serve_health_state": health,
                     f"replica{k}_serve_requests_submitted_total": 10 + k,
                     f"replica{k}_serve_requests_ok_total": 8,
                     f"replica{k}_serve_requests_shed_total": k,
                     f"replica{k}_serve_queue_depth": k, f"replica{k}_serve_slots_occupied": 2,
                     f"replica{k}_serve_gen_tokens_total": 77 * (k + 1),
                     f"replica{k}_serve_request_latency_seconds_count": 8,
                     f"replica{k}_serve_request_latency_seconds_sum": 1.25 + k,
                     f"replica{k}_serve_kv_pages": 113, f"replica{k}_serve_kv_pages_in_use": 40,
                     f"replica{k}_serve_kv_pages_peak": 60,
                     f"replica{k}_serve_tier_host_pages_in_use": 4,
                     f"replica{k}_serve_mesh_devices": 1 + k // 2,
                     f"replica{k}_serve_net_connections": 2, f"replica{k}_serve_net_stalled": 1,
                     f"replica{k}_serve_net_frames_total": 300,
                     f"replica{k}_serve_net_stall_drops_total": 1,
                     f"replica{k}_serve_net_resumes_total": 3,
                     f"replica{k}_serve_net_disconnects_total": 4,
                     f"replica{k}_serve_net_malformed_total": 1})
    return snap


def _render_both(metrics, traces=""):
    from csat_tpu_torch.obs import top

    want = _jax_top().render(metrics, traces, 3)
    assert top.render(metrics, traces, 3) == want
    return want


@pytest.mark.parametrize("kind", ["fleet", "engine", "empty"])
def test_top_renders_jax_s_lines_on_one_metrics_file(tmp_path, capsys, kind):
    """``top --once`` prints what ``tools/serve_top.py`` prints: a fleet
    snapshot with every column family, a single engine's, and a file with
    no snapshot yet (a torn tail line skipped)."""
    from csat_tpu_torch.serve import cli

    path = tmp_path / "m.jsonl"
    if kind == "fleet":
        path.write_text(json.dumps({"t": 1.0}) + "\n" + json.dumps(_snapshot()) + "\n{torn")
    elif kind == "engine":
        path.write_text(json.dumps({"t": 2.0, "serve_queue_depth": 1, "serve_slots_occupied": 3,
                                    "serve_requests_ok_total": 9, "serve_mesh_devices": 2,
                                    "serve_kv_pages": 50, "serve_kv_pages_in_use": 10,
                                    "serve_net_connections": 0}) + "\n")
    else:
        path.write_text("")
    want = _render_both(str(path))
    with pytest.raises(SystemExit) as info:
        cli.main(["top", "--metrics", str(path), "--once", "--slowest", "3"])
    assert info.value.code == 0
    assert capsys.readouterr().out == want + "\n"
    if kind == "fleet":
        assert "== slo burn ==" in want and "active alerts: availability" in want
        assert "== net front door ==" in want and "replica2" in want


def test_top_on_what_the_port_s_serve_stack_wrote(st, tmp_path):
    """A fleet behind the front door with its SLO engine stepping writes a
    metrics file and a trace dump through the port's ``MetricsFile`` and
    tracer; ``top`` renders them as JAX's console does, the SLO rows and
    the net row included."""
    from csat_tpu_torch.obs import MetricsFile
    from csat_tpu_torch.obs.slo import SLOEngine
    from csat_tpu_torch.serve.netclient import NetClient
    from csat_tpu_torch.serve.netfront import NetFront

    pkg = fp.package("port")
    cfg = fp.cfg_of(pkg, st, **OVERLOAD)
    fleet = fp.fleet(pkg, st, cfg=cfg, replicas=2)
    slo = SLOEngine.for_target(fleet, cfg)
    samples = fp.samples(st.jcfg, 8, seed=5)
    front = NetFront(fleet, make_sample=lambda m: samples[int(m["sample"])])
    client = NetClient(front.address)
    for i in range(len(samples)):
        client.submit(i, max_new_tokens=3)
    for _ in range(300):
        front.step()
        client.step()
        slo.step()
        if not client.pending() and not front.summary()["live_streams"]:
            break
    metrics = str(tmp_path / "m.jsonl")
    MetricsFile(metrics, lambda: fleet, every_s=1.0).maybe_write(force=True)
    traces = str(tmp_path / "t.jsonl")
    fleet.tracer.dump(traces)
    front.close()
    client.close()
    fleet.close()
    want = _render_both(metrics, traces)
    assert "== slo burn ==" in want and "== net front door ==" in want
    assert "== slowest traces" in want
