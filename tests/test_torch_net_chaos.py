"""The network chaos drill: the port's ``FaultPlan.random(net=True)``,
``run_net_chaos`` and ``InvariantMonitor.check_streams`` against the JAX
package's.

Random storms with the network kinds serialise to JAX's JSON.  Each drill
drives one engine (or fleet) per package through the same zoo trace and plan
behind the front door over real loopback sockets (``fleet_parity.stack``,
fake clocks; ``run_net_chaos``'s wait for a backoff hint moves the fake
clock instead of sleeping): the reports' outcome counts, per-class records,
net counters, violation lists (none) and iteration counts must be equal, and
so must every client stream's status and tokens.  The dumped timeline, the
front's events merged in, renders through ``tools/chaos_report.py``."""

import importlib.util
import types
from pathlib import Path

import pytest

import fleet_parity as fp
from torch_parity import SRC_V, TRIP_V, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ("jax", "port")


def chaos_mod(name):
    import csat_tpu.resilience.chaos as jchaos
    import csat_tpu_torch.resilience.chaos as tchaos

    return jchaos if name == "jax" else tchaos


def client_mod(name):
    import csat_tpu.serve.netclient as jclient
    import csat_tpu_torch.serve.netclient as tclient

    return jclient if name == "jax" else tclient


@pytest.fixture(scope="module")
def st():
    return fp.stack(bucket_src_lens=(48,), serve_priority_classes=3)


@pytest.fixture(scope="module")
def pkgs():
    return {name: fp.package(name) for name in PACKAGES}


@pytest.mark.parametrize("replicas,slots,tiered", [(1, 4, False), (2, 2, False), (2, 8, True),
                                                  (3, 8, False)])
def test_random_net_storms_equal_jax(replicas, slots, tiered):
    """``FaultPlan.random(seed, net=True)`` draws JAX's plans for seeds
    0–7, the network kinds among them, and round-trips through JSON."""
    from csat_tpu.resilience.chaos import FaultPlan as JPlan
    from csat_tpu_torch.resilience.chaos import NET_KINDS, FaultPlan

    kinds = set()
    for seed in range(8):
        kw = dict(n_events=4, replicas=replicas, slots=slots, tiered=tiered, net=True)
        plan = FaultPlan.random(seed, **kw)
        assert plan.to_json() == JPlan.random(seed, **kw).to_json()
        assert FaultPlan.from_json(plan.to_json()) == plan
        kinds |= {e.kind for e in plan.events}
    assert kinds & set(NET_KINDS)


def _net_drill(st, pkgs, monkeypatch, target, zoo, n, seed, plan=None, cfg_over=None,
               spec=None, **kw):
    """One zoo trace through ``run_net_chaos`` per package → {package:
    (report record, client streams by trace index, report, target)}."""
    got = {}
    for name, pkg in pkgs.items():
        cfg = fp.cfg_of(pkg, st, **(cfg_over or {}))
        tgt = (fp.engine(pkg, st, cfg=cfg) if target == "engine"
               else fp.fleet(pkg, st, cfg=cfg, replicas=2))
        clock = tgt.clock
        # a wait on a backoff hint moves the fake clock
        monkeypatch.setattr(chaos_mod(name), "time", types.SimpleNamespace(
            sleep=lambda s, clock=clock: clock.advance(s)))
        clients = []
        base = client_mod(name).NetClient

        class Kept(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                clients.append(self)

        monkeypatch.setattr(client_mod(name), "NetClient", Kept)
        trace = pkg.make_trace(pkg.zoo_spec(zoo, n, seed=seed, **(spec or {})), cfg,
                               SRC_V, TRIP_V)
        p = plan(pkg) if plan is not None else None
        monitor = pkg.InvariantMonitor(cfg)
        rep = chaos_mod(name).run_net_chaos(tgt, trace, plan=p, monitor=monitor, strict=True,
                                            **kw)
        client = clients[0]
        streams = {i: (s.status, list(s.tokens), s.n_tokens, s.browned, s.retry_after_s,
                       s.dups, s.gaps, s.lost)
                   for i, s in enumerate(client.streams[f"c{k}"] for k in range(len(trace)))}
        record = dict(outcomes=rep.outcomes, per_class=rep.per_class,
                      violations=rep.violations, checks=rep.checks, n_ticks=rep.n_ticks,
                      browned=rep.browned, net=rep.net, trace_json=rep.trace_json,
                      plan_json=rep.plan_json, clean=rep.clean,
                      capacity_frac=rep.capacity_frac, resubmissions=rep.resubmissions)
        got[name] = (record, streams, rep, tgt)
        monkeypatch.undo()
    return got


def _plan_all_kinds(pkg):
    return pkg.FaultPlan((pkg.FaultEvent("slow_reader", at=2, count=1),
                          pkg.FaultEvent("disconnect_mid_stream", at=5),
                          pkg.FaultEvent("malformed_frame", at=8, count=2),
                          pkg.FaultEvent("reconnect_storm", at=12, count=1)), name="net_drill")


def _chaos_report_tool():
    spec = importlib.util.spec_from_file_location("chaos_report",
                                                  REPO / "tools" / "chaos_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_net_chaos_drill_equals_jax(st, pkgs, monkeypatch, tmp_path, capsys):
    """JAX's drill: all four network kinds and one forced mid-stream
    reconnect against a live engine, strict: the same report, net counters
    and streams as JAX's; zero violations, every request terminal, no
    duplicate or lost frame; the dumped timeline renders with the net line."""
    got = _net_drill(st, pkgs, monkeypatch, "engine", "bursty_multitenant", 10, 8,
                     plan=_plan_all_kinds, spec=dict(mean_interarrival=0.5), retries=1,
                     force_reconnect=True)
    (j, js, _, _), (t, ts, rep, eng) = got["jax"], got["port"]
    assert t == j and ts == js
    assert t["clean"] and t["checks"] > 0 and "UNRESOLVED" not in t["outcomes"]
    assert sum(t["outcomes"].values()) == 10
    net = t["net"]
    assert net["forced_reconnects"] == 1 and net["reconnects"] >= 2 and net["resumes_sent"] > 0
    assert net["malformed"] == 2 and net["dup_frames"] == 0 and net["gap_frames"] == 0
    assert eng.occupancy == 0 and eng.queue_depth == 0
    assert all(s[0] == "OK" and s[1] and s[5:] == (0, 0, False) for s in ts.values())
    tool = _chaos_report_tool()
    path = rep.dump(str(tmp_path / "net_chaos.jsonl"))
    assert tool.main([path]) == 0
    out = capsys.readouterr().out
    assert "net:" in out and "reconnects=" in out
    meta, events = tool.load_dump(path)
    assert meta["violations"] == 0 and meta["net"]["forced_reconnects"] == 1
    assert any(e["name"].startswith("net.") and e["component"] == "net" for e in events)
    for side in got.values():
        side[3].close()


def test_net_chaos_refusals_back_off_as_jax(st, pkgs, monkeypatch):
    """A tight queue refusing requests: the client backs off on each
    ``retry_after_s`` hint (``run_net_chaos``'s wait moves the fake clock) and
    resubmits once; the same backoffs, outcomes and streams as JAX's."""
    over = dict(serve_max_queue=2, serve_queue_policy="reject", serve_retry_after_s=0.2)
    got = _net_drill(st, pkgs, monkeypatch, "engine", "steady", 10, 3, cfg_over=over,
                     spec=dict(mean_interarrival=0.05), retries=1)
    (j, js, _, _), (t, ts, _, _) = got["jax"], got["port"]
    assert t == j and ts == js
    assert t["clean"] and t["net"]["backoffs"] > 0
    assert "UNRESOLVED" not in t["outcomes"] and t["outcomes"].get("OK", 0) > 0
    for side in got.values():
        side[3].close()


def test_net_chaos_over_a_fleet_with_a_retirement_equals_jax(st, pkgs, monkeypatch):
    """Two replicas, replica 1 retired at tick 4 and a disconnect mid-stream:
    the moved requests stream on under their fleet ids (no gap, no
    duplicate), strict-clean, the same as JAX's."""
    def plan(pkg):
        return pkg.FaultPlan((pkg.FaultEvent("retire_replica", at=4, replica=1),
                              pkg.FaultEvent("disconnect_mid_stream", at=6)), name="net_fleet")

    got = _net_drill(st, pkgs, monkeypatch, "fleet", "bursty_multitenant", 12, 5, plan=plan,
                     retries=1)
    (j, js, _, _), (t, ts, _, fleet) = got["jax"], got["port"]
    assert t == j and ts == js
    assert t["clean"] and t["capacity_frac"] == 0.5 and t["resubmissions"] > 0
    assert "UNRESOLVED" not in t["outcomes"]
    assert t["net"]["dup_frames"] == 0 and t["net"]["gap_frames"] == 0
    assert all(s[5:] == (0, 0, False) for s in ts.values())
    for side in got.values():
        side[3].close()


@pytest.mark.parametrize("seed", [2, 4, 7])
def test_random_net_storm_on_an_engine_equals_jax(st, pkgs, monkeypatch, seed):
    """A seeded random storm with the network kinds on one engine (rebuild
    cap 8, so a decode fault rebuilds): the same report and streams as
    JAX's, strict-clean."""
    def plan(pkg):
        return pkg.FaultPlan.random(seed, n_events=3, replicas=1, slots=2, net=True)

    got = _net_drill(st, pkgs, monkeypatch, "engine", "bursty_multitenant", 8, seed, plan=plan,
                     cfg_over=dict(serve_max_rebuilds=8), retries=1)
    (j, js, _, _), (t, ts, _, _) = got["jax"], got["port"]
    assert t == j and ts == js
    assert t["clean"] and "UNRESOLVED" not in t["outcomes"]
    for side in got.values():
        side[3].close()


def test_check_streams_flags_loss_duplicates_and_missing_terminals(st, pkgs):
    """The stream invariants are not vacuous: a client assembly that differs
    from the front's tokens, a duplicate frame, a lost stream and an ACKed
    stream with no terminal frame each give their violation — the same list
    as JAX's monitor gives."""
    def fake(front_tokens, statuses, streams):
        front = types.SimpleNamespace(streams=lambda: front_tokens,
                                      stream_status=lambda: statuses)
        client = types.SimpleNamespace(streams={
            str(i): types.SimpleNamespace(id=sid, tokens=toks, done=done, lost=lost,
                                          dups=dups, gaps=gaps, status=status)
            for i, (sid, toks, done, lost, dups, gaps, status) in enumerate(streams)})
        return front, client

    front, client = fake({0: [1, 2], 1: [3], 2: [4], 3: [5, 6], 4: [7, 8]},
                         {0: "OK", 1: "OK", 2: "OK", 3: "", 4: "SHED"},
                         [(0, [1, 9], True, False, 0, 0, "OK"),
                          (1, [3], True, False, 2, 0, "OK"),
                          (2, [], False, True, 0, 1, ""),
                          (3, [5], False, False, 0, 0, ""),
                          (4, [7, 9], True, False, 0, 0, "SHED"),
                          (-1, [], True, False, 0, 0, "REJECTED"),
                          (None, [], False, False, 0, 0, "")])
    got = {}
    for name, pkg in pkgs.items():
        mon = pkg.InvariantMonitor(fp.cfg_of(pkg, st))
        got[name] = [(v.invariant, v.detail) for v in mon.check_streams(front, client)]
    assert got["port"] == got["jax"]
    assert [v[0] for v in got["port"]] == ["stream_no_token_loss", "stream_no_duplicate",
                                          "stream_no_token_loss", "stream_terminal_frame",
                                          "stream_no_token_loss"]
