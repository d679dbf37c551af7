"""Shared set-up for the replica fleet's parity tests (``test_torch_fleet.py``,
``test_torch_autoscale.py``, ``test_torch_chaos.py``): the micro
configuration on the bit-identity paths in both packages (model dropout 0,
the expected SBM graph, shape-invariant CSE empty rows, 2 slots a replica,
rebuild cap 0 so one decode fault retires a replica), the same weights in
both models, each package's fleet-layer classes side by side, a fake clock
that moves only when a tick ends, and the outcome records the tests hold
equal.  The JAX side runs its plain reference path (the configuration's
default backend), as the JAX package's own fleet tests do."""

import types

import numpy as np

from torch_parity import SRC_V, TRIP_V, configs, jax_model_and_params, torch_model

TICK_S = 0.01
FLEET = dict(dropout=0.0, attention_dropout=0.0, cse_empty_rows="zero", serve_slots=2,
             serve_max_rebuilds=0)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def stack(**over):
    """(JAX config, port config, flax model, params, port model)."""
    jcfg, tcfg = configs(**{**FLEET, **over})
    jmodel, params = jax_model_and_params(jcfg, seed=0)
    return types.SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, params=params,
                                 tmodel=torch_model(tcfg, params))


def package(name):
    """The fleet layer of the JAX package (``"jax"``) or the port."""
    if name == "jax":
        from csat_tpu.resilience import FaultEvent, FaultPlan, InvariantMonitor, run_chaos
        from csat_tpu.serve import AutoScaler, Fleet, Router, ServeEngine
        from csat_tpu.serve.traffic import make_trace, zoo_spec
    else:
        from csat_tpu_torch.resilience import FaultEvent, FaultPlan, InvariantMonitor, run_chaos
        from csat_tpu_torch.serve import AutoScaler, Fleet, Router, ServeEngine
        from csat_tpu_torch.serve.traffic import make_trace, zoo_spec
    return types.SimpleNamespace(
        name=name, FaultEvent=FaultEvent, FaultPlan=FaultPlan,
        InvariantMonitor=InvariantMonitor, run_chaos=run_chaos, AutoScaler=AutoScaler,
        Fleet=Fleet, Router=Router, ServeEngine=ServeEngine, make_trace=make_trace,
        zoo_spec=zoo_spec)


def advancing(target, clock, dt=TICK_S):
    """``target`` whose every tick moves ``clock`` on by ``dt`` once it ends
    (the fleet's drain and ``run_chaos`` tick through this)."""
    inner = target.tick

    def tick():
        live = inner()
        clock.advance(dt)
        return live

    target.tick = tick
    return target


def cfg_of(pkg, st, **over):
    cfg = st.jcfg if pkg.name == "jax" else st.tcfg
    return cfg.replace(**over) if over else cfg


def fleet(pkg, st, replicas=2, cfg=None, **kw):
    """A fleet of ``replicas`` on the package's model, under a fake clock."""
    cfg = cfg if cfg is not None else cfg_of(pkg, st)
    clock = FakeClock()
    if pkg.name == "jax":
        f = pkg.Fleet(st.jmodel, st.params, cfg, replicas=replicas, clock=clock, **kw)
    else:
        f = pkg.Fleet(st.tmodel, cfg, replicas=replicas, clock=clock, **kw)
    return advancing(f, clock)


def engine(pkg, st, cfg=None):
    """One engine on the package's model, under a fake clock."""
    cfg = cfg if cfg is not None else cfg_of(pkg, st)
    clock = FakeClock()
    if pkg.name == "jax":
        e = pkg.ServeEngine(st.jmodel, st.params, cfg, clock=clock)
    else:
        e = pkg.ServeEngine(st.tmodel, cfg, device="cpu", clock=clock)
    return advancing(e, clock)


def samples(jcfg, n, seed=0, lo=5):
    """``n`` request samples of mixed real lengths (JAX's ``_requests``)."""
    from csat_tpu.data.toy import random_request_sample

    rng = np.random.default_rng(seed)
    return [random_request_sample(jcfg, SRC_V, TRIP_V, int(ln), seed=1000 * seed + i)
            for i, ln in enumerate(rng.integers(lo, jcfg.max_src_len, n))]


def outcome(req):
    """A terminal request as the tests hold it equal across packages."""
    if req is None:
        return None
    toks = None if req.tokens is None else np.asarray(req.tokens).tolist()
    return (req.id, req.status, req.error, req.n_tokens, toks, req.attempts,
            round(float(req.backoff_s), 4), req.priority, req.browned, req.retry_after_s,
            req.submit_t, req.done_t)


def events(recorder, prefix=""):
    """A flight recorder's events without their wall-clock stamps."""
    return [(name, fields) for _, name, _, fields in recorder.events()
            if name.startswith(prefix)]


#: summary keys that read the host's wall clock (engine bring-up)
WALL_KEYS = ("cold_start_s",)


def summary(f):
    """A fleet summary without its wall-clock readings."""
    s = f.summary(n_chips=1)
    s["per_replica"] = [{k: v for k, v in p.items() if k not in WALL_KEYS}
                        for p in s["per_replica"]]
    return s


def prometheus(f):
    """A fleet's Prometheus text without the engines' bring-up wall time."""
    return [line for line in f.prometheus().splitlines()
            if not line.startswith("serve_cold_start_s{")]
