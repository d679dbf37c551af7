"""The traffic zoo and the fault-plan DSL: the port's copies against the JAX
package's, on the same micro configuration.

* ``data/toy.py``: ``random_request_sample`` and ``random_batch`` give the
  same arrays bit for bit for the same seed;
* ``serve/traffic.py``: every ``TRACE_ZOO`` entry at two seeds gives a trace
  whose ``to_json()`` equals JAX's byte for byte and whose every sample
  array (poisoned ones included) is JAX's bit for bit; ``replay`` round
  trips and refuses tampered metadata and another config's shapes;
* ``resilience/chaos.py``: ``FaultEvent`` / ``FaultPlan`` JSON, the seeded
  random storms and the compiled injectors equal JAX's; the guards refuse
  what JAX refuses, also for the network kinds' draw (``net=True``).

No engine runs here: these are pure functions of their seeds."""

import dataclasses
import json
import types

import numpy as np
import pytest

from torch_parity import SRC_V, TGT_V, TRIP_V, configs


@pytest.fixture(scope="module")
def cfgs():
    return configs(serve_slots=2, serve_priority_classes=3)


def _same_sample(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), k


@pytest.mark.parametrize("n_real,seed", [(1, 0), (8, 3), (30, 11), (48, 7), (200, 2)])
def test_random_request_sample_bitwise_equal(cfgs, n_real, seed):
    from csat_tpu.data.toy import random_request_sample as jsample
    from csat_tpu_torch.data.toy import random_request_sample as tsample

    jcfg, tcfg = cfgs
    _same_sample(jsample(jcfg, SRC_V, TRIP_V, n_real, seed=seed),
                 tsample(tcfg, SRC_V, TRIP_V, n_real, seed=seed))


@pytest.mark.parametrize("n_real", [None, 20])
def test_random_batch_bitwise_equal(cfgs, n_real):
    from csat_tpu.data.toy import random_batch as jbatch
    from csat_tpu_torch.data.toy import random_batch as tbatch

    jcfg, tcfg = cfgs
    j = jbatch(jcfg, 3, SRC_V, TGT_V, TRIP_V, seed=4, n_real_nodes=n_real)
    t = tbatch(tcfg, 3, SRC_V, TGT_V, TRIP_V, seed=4, n_real_nodes=n_real)
    assert j._fields == t._fields
    _same_sample(j._asdict(), t._asdict())


def test_zoo_names_and_specs_equal_jax():
    from csat_tpu.serve import traffic as jt
    from csat_tpu_torch.serve import traffic as tt

    assert sorted(tt.TRACE_ZOO) == sorted(jt.TRACE_ZOO) == [
        "adversarial", "bursty_multitenant", "diurnal", "duplicate_storm", "length_skew",
        "poison_flood", "steady"]
    assert tt.POISON_MODES == jt.POISON_MODES
    for name in tt.TRACE_ZOO:
        spec = tt.zoo_spec(name, 8, seed=1)
        assert spec.to_json() == jt.zoo_spec(name, 8, seed=1).to_json()
        assert tt.TraceSpec.from_json(spec.to_json()) == spec
    for bad in (dict(arrival="nope"), dict(length_skew="nope"),
                dict(poison_frac=0.6, duplicate_frac=0.5), dict(mean_interarrival=0.0)):
        with pytest.raises(AssertionError):
            tt.TraceSpec(**bad)


@pytest.mark.parametrize("name", ["adversarial", "bursty_multitenant", "diurnal",
                                  "duplicate_storm", "length_skew", "poison_flood", "steady"])
@pytest.mark.parametrize("seed", [5, 17])
def test_zoo_trace_equals_jax(cfgs, name, seed):
    """The trace JSON byte for byte and every sample array bit for bit."""
    from csat_tpu.serve.traffic import make_trace as jmake, zoo_spec as jspec
    from csat_tpu_torch.serve.traffic import make_trace as tmake, zoo_spec as tspec

    jcfg, tcfg = cfgs
    j = jmake(jspec(name, 24, seed=seed), jcfg, SRC_V, TRIP_V)
    t = tmake(tspec(name, 24, seed=seed), tcfg, SRC_V, TRIP_V)
    assert t.to_json() == j.to_json()
    assert (t.n_poison, t.n_duplicates, t.by_class()) == (j.n_poison, j.n_duplicates,
                                                           j.by_class())
    for a, b in zip(j.items, t.items):
        _same_sample(a.sample, b.sample)


def test_replay_round_trips_and_refuses_divergence(cfgs):
    from csat_tpu.serve.traffic import make_trace as jmake, zoo_spec as jspec
    from csat_tpu_torch.serve.traffic import make_trace, replay, zoo_spec

    jcfg, tcfg = cfgs
    trace = make_trace(zoo_spec("adversarial", 24, seed=7), tcfg, SRC_V, TRIP_V)
    again = replay(trace.to_json(), tcfg, SRC_V, TRIP_V)
    assert [it.meta() for it in again.items] == [it.meta() for it in trace.items]
    for a, b in zip(trace.items, again.items):
        _same_sample(a.sample, b.sample)
    # a JAX dump replays in the port (and a port dump is JAX's bytes)
    jtrace = jmake(jspec("adversarial", 24, seed=7), jcfg, SRC_V, TRIP_V)
    assert replay(jtrace.to_json(), tcfg, SRC_V, TRIP_V).to_json() == jtrace.to_json()
    d = json.loads(trace.to_json())
    d["items"][0]["n_real"] += 1
    with pytest.raises(ValueError, match="diverged"):
        replay(json.dumps(d), tcfg, SRC_V, TRIP_V)
    with pytest.raises(ValueError, match="diverged"):
        replay(trace.to_json(), tcfg.replace(max_src_len=24), SRC_V, TRIP_V)


def _plans(mod):
    E, P = mod.FaultEvent, mod.FaultPlan
    return [
        P((E("nan_logits", at=2, slot=1), E("decode_fault", at=4, count=2),
           E("retire_replica", at=3, replica=1)), name="p"),
        P((E("corrupt_warmstart", at=0), E("kill_during_spawn", count=2),
           E("hang", at=5, seconds=0.5)), name="fleet_kinds"),
        P(tuple(E(kind=k, at=at, count=3, replica=r) for r in (0, 1)
                for k, at in (("spill_storm", 2), ("corrupt_tier_restore", 6))),
          name="tier_storm"),
        P((E("slow_reader", at=1), E("reconnect_storm", count=2)), name="net"),
    ]


def test_fault_plan_json_equals_jax():
    from csat_tpu.resilience import chaos as jchaos
    from csat_tpu_torch.resilience import chaos as tchaos

    assert tchaos.KINDS == jchaos.KINDS and tchaos.NET_KINDS == jchaos.NET_KINDS
    assert tchaos.FLEET_KINDS == jchaos.FLEET_KINDS
    assert tchaos.RETIRE_HORIZON == jchaos.RETIRE_HORIZON
    for jp, tp in zip(_plans(jchaos), _plans(tchaos)):
        assert tp.to_json() == jp.to_json()
        assert tchaos.FaultPlan.from_json(jp.to_json()) == tp
        assert jchaos.FaultPlan.from_json(tp.to_json()) == jp
    for bad in (dict(kind="melt_down"), dict(kind="nan_logits", at=-1),
                dict(kind="decode_fault", count=0)):
        with pytest.raises(AssertionError):
            tchaos.FaultEvent(**bad)


@pytest.mark.parametrize("replicas,slots,tiered", [(2, 2, False), (1, 4, False), (2, 2, True),
                                                  (3, 8, True)])
def test_random_storms_equal_jax(replicas, slots, tiered):
    from csat_tpu.resilience.chaos import FaultPlan as JPlan
    from csat_tpu_torch.resilience.chaos import FaultPlan

    for seed in range(8):
        kw = dict(n_events=4, replicas=replicas, slots=slots, tiered=tiered)
        plan = FaultPlan.random(seed, **kw)
        assert plan.to_json() == JPlan.random(seed, **kw).to_json()
        for e in plan.events:
            assert e.kind != "hang" and not (e.kind == "retire_replica" and e.replica == 0)
        kw["net"] = True
        assert FaultPlan.random(seed, **kw).to_json() == JPlan.random(seed, **kw).to_json()


def _fake_engine(mod_cfg, ticks=5, prefills=2):
    return types.SimpleNamespace(ticks=ticks, prefills=prefills, cfg=mod_cfg,
                                 fault_injector=None)


def _injector_fields(inj):
    return {k: (sorted(v) if isinstance(v, frozenset) else v) for k, v in vars(inj).items()
            if k.startswith("serve_") or k == "hang_seconds"}


def test_plans_compile_onto_the_same_injectors(cfgs):
    """Relative offsets compile against the target's current clocks into
    injectors whose serve fields equal JAX's; a bare engine refuses
    replica-targeted and fleet-only plans, and two hangs on one replica."""
    from csat_tpu.resilience import chaos as jchaos
    from csat_tpu_torch.resilience import chaos as tchaos

    jcfg, tcfg = cfgs
    E = tchaos.FaultEvent
    events = (E("nan_logits", at=2, slot=1), E("prefill_fail", at=3),
              E("wedge_slot", at=1, slot=5), E("decode_fault", at=4, count=2),
              E("hang", at=6, seconds=0.25), E("spill_storm", at=2, count=3),
              E("corrupt_tier_restore", at=6), E("slow_reader", at=1))
    jeng, teng = _fake_engine(jcfg), _fake_engine(tcfg)
    jinj = jchaos.FaultPlan(tuple(jchaos.FaultEvent(**dataclasses.asdict(e))
                                  for e in events)).apply(jeng)
    tinj = tchaos.FaultPlan(events).apply(teng)
    assert list(tinj) == list(jinj) == [0] and teng.fault_injector is tinj[0]
    assert _injector_fields(tinj[0]) == _injector_fields(jinj[0])
    assert tinj[0].serve_nan_logits == {7: 1} and 5 in tinj[0].serve_prefill_fail_calls
    bare = types.SimpleNamespace()
    with pytest.raises(ValueError, match="bare engine"):
        tchaos.FaultPlan((E("nan_logits", replica=1),)).apply(bare)
    for kind in ("retire_replica", "corrupt_warmstart", "kill_during_spawn"):
        with pytest.raises(ValueError, match="Fleet target"):
            tchaos.FaultPlan((E(kind),)).apply(bare)
    with pytest.raises(ValueError, match="one hang"):
        tchaos.FaultPlan((E("hang", at=1, seconds=1.0),
                          E("hang", at=3, seconds=1.0))).apply(_fake_engine(tcfg))
