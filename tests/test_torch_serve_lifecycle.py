"""The five request outcomes: the JAX serving drill matrix on both engines.

Each drill runs on the JAX engine and on the port's (micro configuration,
converted weights, ``eval_graph="expected"``, the default prefix cache), each
under its own fake clock advanced the same way and its own fault injector
built from the same arguments.  Statuses, error strings, tokens, the
``stats.summary()`` counters and each request's ``req.*`` event names must
be equal, every request terminal exactly once, no page leaked, and a
post-mortem file must exist for the drill's reason.  The JAX engine runs its
Pallas kernels in interpret mode, as its own tests do."""

import os
import threading

import numpy as np
import pytest

from torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    SRC_V, TRIP_V, configs, jax_model_and_params, torch_model, one_torch_thread)

# one intra-op thread: the suite's workers share the host's cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

TIMING = ("wall_s", "gen_tokens_per_sec", "gen_tokens_per_sec_per_chip",
          "gen_tokens_per_sec_per_slot")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class Side:
    """One engine with its clock, its package's fault injector and budget."""

    def __init__(self, name, engine, clock, injector_cls, budget_cls):
        self.name, self.eng, self.clock = name, engine, clock
        self.Injector, self.Budget = injector_cls, budget_cls


def _bucket0(cfg, n, seed):
    """Same-bucket (<= 24 node) requests: admission maps the i-th submitted
    request to slot i, which the targeted drills rely on."""
    from csat_tpu.data.toy import random_request_sample

    return [random_request_sample(cfg, SRC_V, TRIP_V, 5 + (i % 12), seed=7000 * seed + i)
            for i in range(n)]


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    from csat_tpu.resilience.faults import FaultInjector as JInjector
    from csat_tpu.resilience.retry import ErrorBudget as JBudget
    from csat_tpu.serve.engine import ServeEngine as JServeEngine
    from csat_tpu_torch.resilience import ErrorBudget as TBudget, FaultInjector as TInjector
    from csat_tpu_torch.serve import ServeEngine

    jcfg, tcfg = configs()
    jmodel, params = jax_model_and_params(jcfg, seed=1)
    jclock, tclock = FakeClock(), FakeClock()
    jeng = JServeEngine(jmodel, params, jcfg.replace(
        backend="pallas", obs_postmortem_dir=str(tmp_path_factory.mktemp("jpm"))), clock=jclock)
    tcfg = tcfg.replace(obs_postmortem_dir=str(tmp_path_factory.mktemp("tpm")))
    teng = ServeEngine(torch_model(tcfg, params), tcfg, device="cpu", clock=tclock)
    out = (Side("jax", jeng, jclock, JInjector, JBudget),
           Side("port", teng, tclock, TInjector, TBudget), jcfg, tcfg, jmodel, params)
    yield out
    jeng.close()
    teng.close()


def _reset(side, cfg_of, **over):
    eng = side.eng
    assert eng.occupancy == 0 and eng.queue_depth == 0
    eng.cfg = cfg_of(side).replace(**over)
    eng.fault_injector = None
    eng._rebuilds = 0


def _events(eng, rid):
    return [e[1] for e in eng.obs.events()
            if e[1].startswith("req.") and (e[3] or {}).get("id") == rid]


def _postmortem(eng, reason):
    from csat_tpu_torch.obs import EventRecorder

    path = os.path.join(eng._postmortem_dir, f"postmortem_serve_{reason}.jsonl")
    assert os.path.exists(path), f"no post-mortem dump for {reason}"
    meta, events = EventRecorder.load(path)
    assert meta["component"] == "serve" and meta["reason"] == reason
    return [e["name"] for e in events]


def _outcome(side, ids):
    eng = side.eng
    out = []
    for rid in ids:
        r = eng.poll(rid)
        assert r is not None and r.status in ("OK", "FAILED", "TIMEOUT", "REJECTED", "SHED")
        toks = None if r.tokens is None else np.asarray(r.tokens).tolist()
        out.append((r.status, r.error, r.n_tokens, toks, r.attempts, _events(eng, rid)))
    summary = {k: v for k, v in eng.stats.summary().items() if k not in TIMING}
    return out, summary, eng.page_leaks()


def _both(sides, drill, reason=None, **over):
    """Run ``drill(side, cfg)`` on both engines; → the port's ids and
    outcome after holding it equal to JAX's."""
    jside, tside, jcfg, tcfg = sides[:4]
    cfg_of = {"jax": jcfg, "port": tcfg}
    results = []
    for side in (jside, tside):
        _reset(side, lambda s: cfg_of[s.name].replace(
            obs_postmortem_dir=side.eng.cfg.obs_postmortem_dir), **over)
        ids = drill(side, cfg_of[side.name])
        side.eng.fault_injector = None
        results.append((ids, _outcome(side, ids)))
        if reason:
            assert _postmortem(side.eng, reason)
        for rid in ids:  # terminal exactly once: the trace too
            tid = side.eng.poll(rid).trace_id
            assert tid and side.eng.tracer.finished_count(tid) == 1
    (j_ids, j_out), (t_ids, t_out) = results
    assert j_ids == t_ids
    assert t_out[0] == j_out[0]  # statuses, errors, tokens, attempts, req.* events
    assert t_out[1] == j_out[1]  # stats counters
    assert t_out[2] == j_out[2] == 0  # no page leaked
    assert tside.eng.occupancy == 0 and tside.eng.queue_depth == 0
    return t_ids, t_out


def test_poison_quarantined_under_budget(sides):
    from csat_tpu.resilience.faults import FaultInjector as J
    from csat_tpu_torch.resilience import DataErrorBudgetExceeded

    def drill(side, cfg):
        eng = side.eng
        old = eng._poison_budget
        eng._poison_budget = side.Budget(2, log=lambda m: None)
        try:
            good = _bucket0(cfg, 2, seed=1)
            ids = [eng.submit(J.poison_sample(good[0], "missing_key")),
                   eng.submit(J.poison_sample(good[0], "dtype"))]
            with pytest.raises(Exception) as info:
                eng.submit(J.poison_sample(good[0], "oversize"))
            # the raise is the outcome: a mostly-poison stream is upstream
            # corruption, so that submit resolves nothing
            assert type(info.value).__name__ == "DataErrorBudgetExceeded"
            ids += [r.id for r in eng.generate(good, max_new_tokens=3)]
            return ids
        finally:
            eng._poison_budget = old

    ids, (out, summary, _) = _both(sides, drill, reason="FAILED")
    assert [o[0] for o in out] == ["FAILED"] * 2 + ["OK"] * 2
    assert "poison request" in out[0][1] and summary["quarantined"] == 2
    assert out[0][5] == ["req.submit", "req.failed"]
    assert DataErrorBudgetExceeded.__module__.startswith("csat_tpu_torch")


def test_queue_full_reject_and_shed_oldest(sides):
    def drill(side, cfg):
        eng = side.eng
        samples = _bucket0(cfg, 5, seed=2)
        ids = [eng.submit(s, max_new_tokens=2) for s in samples[:3]]
        assert eng.queue_depth == 2
        eng.cfg = eng.cfg.replace(serve_queue_policy="shed_oldest")
        ids.append(eng.submit(samples[3], max_new_tokens=2))
        assert eng.queue_depth == 2
        eng.drain()
        eng.cfg = eng.cfg.replace(serve_max_queue=0, serve_queue_policy="reject")
        return ids

    _, (out, summary, _) = _both(sides, drill, reason="SHED", serve_max_queue=2)
    assert [o[0] for o in out] == ["SHED", "OK", "REJECTED", "OK"]
    assert "queue full" in out[2][1] and out[2][5] == ["req.submit", "req.rejected"]
    assert out[0][5] == ["req.submit", "req.shed"]
    assert summary["rejected"] >= 1 and summary["shed"] >= 1


def test_priority_shed_and_brownout(sides):
    def drill(side, cfg):
        eng = side.eng
        samples = _bucket0(cfg, 5, seed=13)
        ids = [eng.submit(samples[0], 9, priority=0), eng.submit(samples[1], 9, priority=2),
               eng.submit(samples[2], 9, priority=1)]  # the third is browned out
        ids.append(eng.submit(samples[3], 9, priority=0))  # sheds the tier-2 request
        ids.append(eng.submit(samples[4], 9, priority=2))  # outranked: shed itself
        eng.drain()
        return ids

    _, (out, summary, _) = _both(sides, drill, reason="SHED", serve_max_queue=3,
                                 serve_queue_policy="shed_oldest", serve_priority_classes=3,
                                 serve_brownout_queue_frac=0.5,
                                 serve_brownout_max_new_tokens=2)
    assert [o[0] for o in out] == ["OK", "SHED", "OK", "OK", "SHED"]
    assert summary["browned"] >= 1 and out[2][2] <= 2
    assert "req.brownout" in out[2][5]


def test_deadlines_queued_and_in_flight(sides):
    def drill(side, cfg):
        eng, clock = side.eng, side.clock
        samples = _bucket0(cfg, 2, seed=3)
        queued = eng.submit(samples[0], max_new_tokens=5, deadline_s=4.0)
        clock.advance(10.0)
        eng.tick()
        flying = eng.submit(samples[1], max_new_tokens=8, deadline_s=4.0)
        eng.tick()
        eng.tick()
        clock.advance(10.0)
        eng.tick()
        return [queued, flying] + [r.id for r in eng.generate(_bucket0(cfg, 1, seed=4), 2)]

    _, (out, summary, _) = _both(sides, drill, reason="TIMEOUT")
    assert [o[0] for o in out] == ["TIMEOUT", "TIMEOUT", "OK"]
    assert out[0][2] == 0 and "queue" in out[0][1]
    assert 0 < out[1][2] <= 8 and "in flight" in out[1][1]
    assert out[1][5] == ["req.submit", "req.admit", "req.timeout"]
    assert summary["timeouts"] >= 2


def test_nan_slot_fails_others_exact_then_hit_on_scrubbed_pages(sides):
    """One slot's self pages poisoned: it retires FAILED with its clean
    prefix, the others OK; then a prefix hit whose fresh self page is the
    poisoned one (the free list hands it out first) must decode exactly,
    since attach scrubs it."""
    chains = {}

    def drill(side, cfg):
        eng = side.eng
        samples = _bucket0(cfg, cfg.serve_slots, seed=5)
        eng.fault_injector = side.Injector(serve_nan_logits=[(eng.ticks + 1, 0)])
        ids = [eng.submit(s, max_new_tokens=6) for s in samples]
        eng.tick()
        victim = list(eng._slot_meta[0].self_chain)
        eng.tick()  # decode on the poisoned pages
        eng.tick()  # retire: slot 0 FAILED, its pages back on the free list
        assert eng.poll(ids[0]).status == "FAILED"
        eng.fault_injector = None
        ids.append(eng.submit(samples[1], max_new_tokens=6))  # a prefix hit
        eng.tick()
        slot = eng.poll(ids[-1]) or next(r for r in eng._slots if r and r.id == ids[-1])
        chains[side.name] = (victim, list(eng._slot_meta[slot.slot].self_chain))
        eng.drain()
        return ids

    _, (out, summary, _) = _both(sides, drill, reason="FAILED")
    victim, hit_chain = chains["port"]
    assert set(victim) & set(hit_chain), "the hit did not reuse the poisoned page"
    assert out[0][0] == "FAILED" and "non-finite logits" in out[0][1] and out[0][2] == 1
    assert out[0][5] == ["req.submit", "req.admit", "req.failed"]
    assert all(o[0] == "OK" for o in out[1:])
    assert out[-1][3] == out[1][3]  # the hit's tokens are its original's
    assert summary["failed"] >= 1


def test_wedged_slot_reaped(sides):
    def drill(side, cfg):
        eng = side.eng
        eng.fault_injector = side.Injector(serve_wedge_slots=[(eng.ticks + 1, 0)])
        ids = [eng.submit(s, max_new_tokens=4) for s in _bucket0(cfg, cfg.serve_slots, 6)]
        eng.drain()
        return ids

    _, (out, summary, _) = _both(sides, drill, reason="FAILED")
    assert out[0][0] == "FAILED" and "stuck slot reaped" in out[0][1]
    assert all(o[0] == "OK" for o in out[1:]) and summary["reaped"] >= 1


def test_prefill_failure_fails_chunk_pool_serves(sides):
    def drill(side, cfg):
        eng = side.eng
        eng.fault_injector = side.Injector(serve_prefill_fail_calls=[eng.prefills])
        samples = _bucket0(cfg, 2, seed=8)
        ids = [eng.submit(s, max_new_tokens=3) for s in samples]
        eng.drain()
        eng.fault_injector = None
        return ids + [r.id for r in eng.generate(samples, max_new_tokens=3)]

    _, (out, _, _) = _both(sides, drill, reason="FAILED")
    assert [o[0] for o in out] == ["FAILED", "FAILED", "OK", "OK"]
    assert "prefill failed" in out[0][1]


def test_decode_fault_rebuilds_and_resubmits_exactly(sides):
    def drill(side, cfg):
        eng = side.eng
        eng.fault_injector = side.Injector(serve_decode_fail_ticks=[eng.ticks + 1])
        samples = _bucket0(cfg, cfg.serve_slots + 2, seed=9)
        ids = [eng.submit(s, max_new_tokens=4) for s in samples]
        eng.drain()
        eng.fault_injector = None
        assert eng.stats.rebuilds >= 1
        return ids + [r.id for r in eng.generate(samples, max_new_tokens=4)]

    _, (out, _, _) = _both(sides, drill, reason="rebuild")
    n = len(out) // 2
    assert all(o[0] == "OK" for o in out)
    assert [o[3] for o in out[:n]] == [o[3] for o in out[n:]]  # = a clean run's
    assert any(o[4] == 1 for o in out[:n])


def test_retries_exhausted_then_rebuild_cap(sides):
    def drill(side, cfg):
        eng = side.eng
        eng.fault_injector = side.Injector(serve_decode_fail_ticks=[eng.ticks])
        samples = _bucket0(cfg, 2, seed=10)
        ids = [eng.submit(s, max_new_tokens=3) for s in samples]
        eng.drain()
        eng.cfg = eng.cfg.replace(serve_max_rebuilds=0, serve_max_retries=1)
        eng.fault_injector = side.Injector(serve_decode_fail_ticks=[eng.ticks])
        ids.append(eng.submit(samples[0], max_new_tokens=3))
        with pytest.raises(RuntimeError, match="serve_max_rebuilds"):
            eng.drain()
        assert "fault.rebuild_cap" in _postmortem(eng, "rebuild_cap")
        eng.fault_injector = None
        eng._rebuilds = 0
        eng.drain()  # the un-faulted retry completes
        return ids

    _, (out, _, _) = _both(sides, drill, serve_max_retries=0, serve_max_rebuilds=4)
    assert [o[0] for o in out] == ["FAILED", "FAILED", "OK"]
    assert "retries exhausted" in out[0][1]


def test_shed_all_resolves_everything(sides):
    def drill(side, cfg):
        eng = side.eng
        ids = [eng.submit(s, max_new_tokens=8) for s in _bucket0(cfg, cfg.serve_slots + 2, 11)]
        eng.tick()
        eng.tick()
        assert eng.shed_all("drill") == len(ids)
        return ids

    _, (out, _, _) = _both(sides, drill, reason="SHED")
    assert {o[0] for o in out} == {"SHED"}
    assert any(o[2] > 0 for o in out[:4]) and all(o[5][-1] == "req.shed" for o in out)


def test_tick_watchdog_trips_by_callback(sides, tmp_path, monkeypatch):
    """A hung tick trips the watchdog, with no wall-clock race.  The port's
    watchdog runs on the engine's fake clock: the injected hang advances it
    and asks the watchdog to look.  JAX's watchdog reads ``time.monotonic``
    on its own thread: here it reads the fake clock instead, and its hang
    advances that clock and lasts until the trip's callback fires."""
    import types

    import csat_tpu.resilience.watchdog as jwatchdog
    from csat_tpu.serve.engine import ServeEngine as JServeEngine
    from csat_tpu_torch.serve import ServeEngine

    jside, tside, jcfg, tcfg, jmodel, params = sides
    results = {}
    for name in ("jax", "port"):
        tripped = threading.Event()
        clock = FakeClock()
        pm = str(tmp_path / name)
        if name == "jax":
            monkeypatch.setattr(jwatchdog, "time", types.SimpleNamespace(
                monotonic=clock, sleep=jwatchdog.time.sleep))
            eng = JServeEngine(jmodel, params, jcfg.replace(
                backend="pallas", serve_watchdog_timeout_s=0.2, obs_postmortem_dir=pm),
                clock=clock, watchdog_on_timeout=tripped.set)

            def sleep(s, clock=clock, tripped=tripped):
                clock.advance(s)
                assert tripped.wait(30.0)

            inj_cls = jside.Injector
        else:
            eng = ServeEngine(torch_model(tcfg, params), tcfg.replace(
                serve_watchdog_timeout_s=3.0, obs_postmortem_dir=pm), device="cpu",
                clock=clock, watchdog_on_timeout=tripped.set)

            def sleep(s, eng=eng, clock=clock):
                clock.advance(s)
                assert eng._watchdog.check()

            inj_cls = tside.Injector
        try:
            eng.fault_injector = inj_cls(serve_hang_at_tick=1, hang_seconds=8.0, sleep=sleep)
            reqs = eng.generate(_bucket0(jcfg, 2, seed=12), max_new_tokens=4)
            assert tripped.is_set(), f"{name}: the hung tick did not trip the watchdog"
            names = _postmortem(eng, "watchdog")
            assert "fault.watchdog" in names and "fault.injected.hang_tick" in names
            results[name] = [(r.status, np.asarray(r.tokens).tolist()) for r in reqs]
        finally:
            eng.close()
    assert results["port"] == results["jax"] and {s for s, _ in results["port"]} == {"OK"}


def test_watchdog_check_is_idle_when_disarmed_and_trips_once():
    from csat_tpu_torch.resilience import StepWatchdog

    clock = FakeClock()
    trips = []
    wd = StepWatchdog(1.0, on_timeout=lambda: trips.append(1), log=lambda m: None, clock=clock)
    clock.advance(5.0)
    assert not wd.check()  # never armed
    wd.beat()
    clock.advance(0.5)
    assert not wd.check()
    wd.disarm()
    clock.advance(5.0)
    assert not wd.check()  # idle is not a hang
    wd.beat()
    clock.advance(1.5)
    assert wd.check() and wd.check() and trips == [1] and wd.tripped
