"""Serving telemetry against the JAX package's: the request tracer (the
cases of ``tests/test_rtrace.py`` on the port's copy, and its dump byte for
byte JAX's), ``ServeStats`` (summary, Prometheus text and per-class p95 for
the same calls), and the engine's trace spans per request (micro
configuration, converted weights, ``eval_graph="expected"``; the JAX engine
in interpret mode)."""

import json

import numpy as np
import pytest

from torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    configs, jax_model_and_params, request_samples, torch_model, one_torch_thread)

# one intra-op thread: the suite's workers share the host's cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ---------------------------------------------------------------------------
# the tracer (tests/test_rtrace.py:50-140 on the port's copy)
# ---------------------------------------------------------------------------

def test_tracer_lifecycle_and_dump_roundtrip(tmp_path):
    from csat_tpu_torch.obs import Tracer, load_traces

    tr = Tracer(capacity=8, slowest=4, component="serve")
    tid = tr.begin(None, t=1.0, id=7, priority=1)
    assert tid and tid in tr.active
    assert tr.begin(tid, t=1.5) == tid and tr.minted == 1  # idempotent adopt
    tr.event(tid, "admit", t=2.0, slot=0)
    tr.span_from(tid, "decode", 2.0, 3.5, tokens=9)
    tr.finish(tid, "OK", t=3.5)
    assert tid not in tr.active and tr.finished_count(tid) == 1
    rec = tr.recent(1)[0]
    assert rec.status == "OK" and rec.dur == pytest.approx(2.5)
    names = [s.name for s in rec.spans]
    assert names == ["submit", "admit", "decode", "terminal"]
    assert rec.spans[-1].fields["status"] == "OK"
    tr.event(tid, "late", t=9.0)  # late spans / double finish are ignored
    tr.finish(tid, "FAILED", t=9.0)
    assert tr.finished_count(tid) == 1 and tr.completed == 1
    path = tr.dump(str(tmp_path / "traces.jsonl"))
    with open(path, encoding="utf-8") as f:
        meta = json.loads(f.readline())["meta"]
    assert meta["component"] == "serve" and meta["traces_completed"] == 1
    loaded = load_traces(path)
    assert len(loaded) == 1 and loaded[0]["trace_id"] == tid
    assert [s["name"] for s in loaded[0]["spans"]] == names


def test_disabled_tracer_is_a_true_noop():
    from csat_tpu_torch.obs import Tracer

    tr = Tracer(capacity=0)
    assert not tr.enabled and tr.begin(None, t=0.0) == ""
    tr.event("", "x", t=0.0)
    tr.span_from("", "x", 0.0, 1.0)
    tr.finish("", "OK", t=1.0)
    assert not tr.reopen("x", attempt=2, t=0.0)
    assert tr.minted == 0 and tr.completed == 0
    assert not tr.active and not tr.slowest() and not tr.recent()


def test_tracer_bounded_ring_span_cap_and_active_table():
    from csat_tpu_torch.obs import Tracer
    from csat_tpu_torch.obs.rtrace import MAX_SPANS_PER_TRACE

    tr = Tracer(capacity=4, slowest=2)
    slow_tid = tr.begin(None, t=0.0)
    tr.finish(slow_tid, "OK", t=100.0)
    for i in range(10):
        tid = tr.begin(None, t=float(i))
        tr.finish(tid, "OK", t=float(i) + 0.1)
    assert len(tr.finished) == 4 and tr.slowest()[0].trace_id == slow_tid
    tid = tr.begin(None, t=0.0)
    for i in range(2 * MAX_SPANS_PER_TRACE):
        tr.event(tid, "e", t=float(i))
    rec = tr.active[tid]
    assert len(rec.spans) == MAX_SPANS_PER_TRACE and rec.dropped_spans > 0
    for i in range(200):
        tr.begin(None, t=float(i))
    assert len(tr.active) <= max(tr.capacity * 4, 64) and tr.dropped > 0


def test_tracer_reopen_links_retry_as_same_trace():
    from csat_tpu_torch.obs import Tracer

    tr = Tracer(capacity=8, slowest=4)
    tid = tr.begin(None, t=0.0)
    tr.finish(tid, "SHED", t=1.0)
    assert tr.reopen(tid, attempt=2, t=1.5, from_replica=1)
    assert tid in tr.active and tr.finished_count(tid) == 0
    tr.event(tid, "resubmit", t=2.0, replica=0)
    tr.finish(tid, "OK", t=3.0)
    assert tr.finished_count(tid) == 1
    rec = tr.recent(1)[0]
    assert rec.status == "OK" and rec.attempt == 2
    names = [(s.name, s.attempt) for s in rec.spans]
    assert ("terminal", 1) in names and ("retry", 2) in names
    assert ("resubmit", 2) in names and names[-1] == ("terminal", 2)
    assert next(s for s in rec.spans if s.name == "retry").fields["from_replica"] == 1
    assert tr.reopen("never-seen", attempt=2, t=0.0) is False and "never-seen" in tr.active


def test_tracer_dump_equals_jax_for_the_same_calls(tmp_path):
    from csat_tpu.obs.rtrace import Tracer as JTracer
    from csat_tpu_torch.obs import Tracer as TTracer

    dumps = []
    for cls, name in ((JTracer, "j"), (TTracer, "t")):
        tr = cls(capacity=3, slowest=2)
        rng = np.random.default_rng(4)
        tids = []
        for i in range(12):
            t = float(i)
            tids.append(tr.begin(None, t=t, id=i))
            tr.event(tids[-1], "admit", t=t + 0.1, slot=i % 4)
            if i % 3:
                tr.span_from(tids[-1], "decode", t + 0.1, t + rng.uniform(0.2, 3.0), n_tokens=i)
                tr.finish(tids[-1], "OK" if i % 2 else "SHED", t=t + 3.5)
        tr.reopen(tids[2], attempt=2, t=20.0)
        dumps.append(open(tr.dump(str(tmp_path / f"{name}.jsonl")), encoding="utf-8").read())
    assert dumps[0] == dumps[1]


# ---------------------------------------------------------------------------
# ServeStats
# ---------------------------------------------------------------------------

def _drive_stats(stats):
    rng = np.random.default_rng(9)
    stats.started_t = 0.0
    for kind, detail in (("decode", (8, 49)), ("release", (8,)), ("attach", (8,)),
                         ("prefill", (37, 8)), ("prefill", (150, 4))):
        stats.record_compile(kind, detail)
    stats.set_page_info(112, 14, kv_ratio=2)
    for i in range(40):
        stats.note_pages(int(rng.integers(0, 112)))
        stats.submitted += 1
        if i % 7 == 3:
            stats.record_outcome(("FAILED", "TIMEOUT", "REJECTED", "SHED")[i % 4])
            continue
        stats.admitted += 1
        sub = float(i)
        stats.record_request(sub, sub + rng.uniform(0, 0.3), sub + rng.uniform(0.3, 9.0),
                             int(rng.integers(1, 49)), priority=i % 3, trace_id=f"s{i:04x}")
    stats.prefix_hits += 9
    stats.prefix_misses += 22
    stats.decode_steps += 311
    stats.prefill_calls += 17
    stats.reaped += 1
    stats.rebuilds += 1
    stats.browned += 2
    stats.quarantined += 1


def test_serve_stats_summary_and_prometheus_equal_jax():
    from csat_tpu.serve.stats import ServeStats as JStats
    from csat_tpu_torch.serve.stats import ServeStats as TStats

    j, t = JStats(8), TStats(8)
    _drive_stats(j)
    _drive_stats(t)
    assert t.summary() == j.summary() and list(t.summary()) == list(j.summary())
    assert t.summary(wall_s=12.5, n_chips=1) == j.summary(wall_s=12.5, n_chips=1)
    assert t.prometheus() == j.prometheus()
    for p in range(4):
        assert t.class_p95(p) == j.class_p95(p)
    s = t.summary()
    assert s["effective_slots"] == round(8 * 14 * 2 / 112, 3) and s["compiles"] == 5
    assert 0 < s["prefix_hit_rate"] < 1 and s["tier_spills"] == 0 and s["mesh_devices"] == 1
    fresh = TStats(8)
    fresh.carry_compiles(t)
    assert fresh.compiles == 5 and list(fresh.compile_events) == list(t.compile_events)


# ---------------------------------------------------------------------------
# the engine's traces
# ---------------------------------------------------------------------------

def test_engine_trace_spans_per_request_equal_jax(tmp_path):
    """A trace with a prefix hit, a brownout, a shed and a timeout: each
    request's span names (and attempts) equal the JAX engine's, exactly one
    terminal trace each, and the dumps hold the same stories."""
    from csat_tpu.serve.engine import ServeEngine as JServeEngine
    from csat_tpu_torch.serve import ServeEngine

    over = dict(serve_max_queue=3, serve_queue_policy="shed_oldest", serve_priority_classes=2,
                serve_brownout_queue_frac=0.5, serve_brownout_max_new_tokens=2,
                obs_postmortem_dir=str(tmp_path))
    jcfg, tcfg = configs(**over)
    jmodel, params = jax_model_and_params(jcfg, seed=1)
    distinct = request_samples(jcfg, 4, seed=21, lo=2)
    plan = [(0, 9, 0, None), (1, 9, 1, None), (0, 6, 1, None), (2, 9, 0, 3.0),
            (3, 9, 1, None), (1, 4, 0, None)]

    def run(engine):
        ids = [engine.submit(distinct[i], b, priority=p, deadline_s=d) for i, b, p, d in plan]
        engine.clock.advance(5.0)
        engine.tick()
        ids.append(engine.submit(distinct[0], 9))  # a hit on a cached chain
        engine.drain()
        stories = []
        for rid in ids:
            req = engine.poll(rid)
            rec = next(r for r in engine.tracer.finished if r.trace_id == req.trace_id)
            assert engine.tracer.finished_count(req.trace_id) == 1
            stories.append((req.status, [(s.name, s.attempt) for s in rec.spans],
                            rec.spans[-1].fields["status"]))
        return stories

    jeng = JServeEngine(jmodel, params, jcfg.replace(backend="pallas"), clock=FakeClock())
    try:
        j = run(jeng)
    finally:
        jeng.close()
    teng = ServeEngine(torch_model(tcfg, params), tcfg, device="cpu", clock=FakeClock())
    t = run(teng)
    teng.close()
    assert t == j
    statuses = [s for s, _, _ in t]
    assert {"OK", "SHED", "TIMEOUT"} <= set(statuses)
    names = {n for _, spans, _ in t for n, _ in spans}
    assert {"submit", "queue_wait", "admit", "decode", "terminal", "brownout",
            "prefill.attach"} <= names
    assert any(n.startswith("prefill.n") for n in names)
    assert teng.page_leaks() == 0
