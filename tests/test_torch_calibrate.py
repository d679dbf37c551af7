"""The port's calibration probes and run-history ledger against the JAX
package's (``csat_tpu_torch/obs/{calibrate,perfdb}.py`` against
``csat_tpu/obs/``), on the CPU.

The probes run real (tiny) work on the CPU device: finite, positive numbers,
and the compile probe skipped with ``ops/build.py``'s reason where no ``nvcc``
is found.  Skips, reasons and parameters equal JAX's ``run_calibration`` on
the same arguments; without CUDA the default device raises before any probe
runs.  Hypothesis-drawn calibration blocks and ledger entries go through
both packages' normalisation and ledger functions with equal results, and
the port's ``Config`` refuses every ``calib_*`` override JAX's refuses and
reads its fields into ``run_calibration``'s arguments as JAX's bench does.
"""

import json
import re
import sys

import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from csat_tpu.obs import calibrate as jcal
from csat_tpu.obs import perfdb as jdb
from csat_tpu_torch.obs import calibrate as tcal
from csat_tpu_torch.obs import perfdb as tdb

# the JAX package's own test sizes (tests/test_calibrate.py:CAL_KW)
CAL_KW = dict(matmul_n=128, memory_mb=4, dispatch_iters=10, repeats=2)
SETTINGS = settings(max_examples=60, deadline=None, derandomize=True, database=None,
                    suppress_health_check=[HealthCheck.too_slow])


@pytest.fixture
def no_nvcc(monkeypatch):
    """No ``nvcc`` on ``PATH`` (the fixture fails where the toolkit sits at
    its default place): the reason ``_nvcc()`` raises."""
    from csat_tpu_torch.ops import build

    monkeypatch.setenv("PATH", str(sys.executable).rsplit("/", 1)[0])
    with pytest.raises(RuntimeError) as err:
        build._nvcc()
    return f"RuntimeError: {err.value}"


def test_probes_on_the_cpu(no_nvcc):
    out = tcal.run_calibration(device="cpu", **CAL_KW)
    assert set(out["probes"]) == {"matmul_f32_gflops", "matmul_bf16_gflops", "memory_gbps",
                                  "dispatch_us"}
    assert all(v == v and 0 < v < float("inf") for v in out["probes"].values()), out
    assert out["skipped"] == {"compile": no_nvcc}
    assert out["params"] == dict(CAL_KW) and out["elapsed_s"] >= 0


@pytest.mark.parametrize("kw", [dict(probes=("dispatch", "nonesuch")),
                                dict(probes=("nonesuch", "memory", "other")),
                                dict(budget_s=-1.0), dict(budget_s=-1.0, probes=("compile",))],
                         ids=["subset", "unknown", "budget", "budget_compile"])
def test_skips_and_params_equal_jax(kw):
    port = tcal.run_calibration(device="cpu", **CAL_KW, **kw)
    ref = jcal.run_calibration(**CAL_KW, **kw)
    assert port["skipped"] == ref["skipped"]
    assert port["params"] == ref["params"]
    assert set(port["probes"]) == set(ref["probes"])


def test_cuda_absent_raises_before_any_probe(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    for name in ("_probe_matmul", "_probe_memory", "_probe_dispatch", "_probe_compile"):
        monkeypatch.setattr(tcal, name, lambda *a, _n=name: ran.append(_n))
    for call in (lambda: tcal.run_calibration(), lambda: tcal.run_calibration(device="cuda"),
                 lambda: tcal.machine_fingerprint()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert ran == []


def test_fingerprint_on_the_cpu():
    a, b = tcal.machine_fingerprint("cpu"), tcal.machine_fingerprint("cpu")
    assert a == b and re.fullmatch(r"[0-9a-f]{12}", a["id"])
    assert a["id"] == tcal.fingerprint_id(a)
    assert (a["platform"], a["device_kind"], a["device_count"]) == ("cpu", "cpu", 1)
    assert a["torch_version"] == torch.__version__ and "jax_version" not in a
    # the id digests the identity fields only
    assert tcal.fingerprint_id({**a, "extra": "x"}) == a["id"]
    assert tcal.fingerprint_id({**a, "host": "elsewhere"}) != a["id"]


# ---------------------------------------------------------------------------
# normalisation and the ledger, drawn by hypothesis, on both packages
# ---------------------------------------------------------------------------

_SCALAR = st.one_of(st.none(), st.floats(allow_nan=False), st.integers(-3, 3),
                    st.sampled_from(["1.5", "-2", "0", "abc", ""]))
_PROBES = st.dictionaries(st.sampled_from([tcal.REFERENCE_PROBE, "memory_gbps"]), _SCALAR,
                          max_size=2)
_BLOCK = st.one_of(st.none(), st.just({}), st.just({"probes": None}), st.just({"probes": "x"}),
                   st.builds(lambda p: {"probes": p, "skipped": {}}, _PROBES))


@SETTINGS
@given(_BLOCK, _BLOCK, st.floats(min_value=-1e6, max_value=1e6, allow_nan=False))
def test_normalization_equals_jax(now, ref, value):
    assert tcal.normalization_ratio(now, ref) == jcal.normalization_ratio(now, ref)
    assert tcal.normalize(value, now, ref) == jcal.normalize(value, now, ref)


_VALUE = st.one_of(st.none(), st.just(0.0), st.floats(min_value=-50.0, max_value=1e5,
                                                       allow_nan=False))
_CAL = st.one_of(st.none(), st.just({"probes": {}}),
                 st.builds(lambda g: {"probes": {tcal.REFERENCE_PROBE: g}, "skipped": {}},
                           st.floats(min_value=0.0, max_value=1e4, allow_nan=False)))
_OUT = st.fixed_dictionaries(
    {"metric": st.sampled_from([tdb.HEADLINE_METRIC, "other_metric"]), "value": _VALUE,
     "nodes_per_sec_per_chip_cal": _VALUE, "calibration": _CAL,
     "degraded_reasons": st.lists(st.sampled_from(["parity", "regression", "no_device"]),
                                  unique=True, max_size=2)},
    optional={"machine_fingerprint": st.just({"host": "box", "platform": "gpu", "id": "x"}),
              "regression": st.just({"kind": "code"})})


def _entries(outs):
    """The same entries from both packages' ``make_entry`` (fixed ``ts``)."""
    port = [tdb.make_entry(o, run_id=f"r{i}", ts=100.0 + i, git_rev="abc" if i % 2 else None,
                           reference={"run_id": "r0"} if i else None)
            for i, o in enumerate(outs)]
    ref = [jdb.make_entry(o, run_id=f"r{i}", ts=100.0 + i, git_rev="abc" if i % 2 else None,
                          reference={"run_id": "r0"} if i else None)
           for i, o in enumerate(outs)]
    return port, ref


@SETTINGS
@given(st.lists(_OUT, min_size=1, max_size=6), st.floats(min_value=0.0, max_value=0.3))
def test_ledger_functions_equal_jax(outs, tol):
    port, ref = _entries(outs)
    assert port == ref
    for metric in (tdb.HEADLINE_METRIC, "other_metric"):
        assert tdb.best_entry(port, metric) == jdb.best_entry(ref, metric)
        assert tdb.last_entry(port, metric) == jdb.last_entry(ref, metric)
    assert tdb.reference_entry(port) == jdb.reference_entry(ref)
    for a, b in zip(port, port[1:]):
        assert tdb.attribute_delta(a, b, noise_tol=tol) == jdb.attribute_delta(a, b,
                                                                               noise_tol=tol)
    *history, last = port
    assert (tdb.regression_check(last, history, drop_tol=tol) ==
            jdb.regression_check(last, history, drop_tol=tol))


def test_load_history_equal_jax(tmp_path):
    path = tmp_path / "history.jsonl"
    good = tdb.make_entry({"value": 3.0, "calibration": {"probes": {"x": 1.0}}}, run_id="a",
                          ts=1.0)
    path.write_text("\n".join(["", json.dumps(good), "{not json", "[1, 2]", '"text"',
                               json.dumps({"no_value": 1}), "   ", json.dumps(good),
                               '{"value": 0}']) + "\n")
    assert tdb.load_history(str(path)) == jdb.load_history(str(path))
    assert len(tdb.load_history(str(path))) == 3
    assert tdb.load_history(str(tmp_path / "missing.jsonl")) == []
    tdb.append_entry(str(tmp_path / "d" / "h.jsonl"), good)
    assert jdb.load_history(str(tmp_path / "d" / "h.jsonl")) == [good]


@pytest.mark.parametrize("override", [
    dict(calib_probes=("nonesuch",)), dict(calib_probes=("matmul_f32", "jit")),
    dict(calib_matmul_n=7), dict(calib_matmul_n=0), dict(calib_memory_mb=0),
    dict(calib_dispatch_iters=0), dict(calib_budget_s=0.0), dict(calib_budget_s=-1.0)],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_config_refuses_what_jax_refuses(override):
    from csat_tpu.configs import get_config as jax_config
    from csat_tpu_torch.configs import get_config

    with pytest.raises(AssertionError):
        jax_config("python", **override)
    with pytest.raises(AssertionError):
        get_config("python", **override)
    # the same fields within bounds: both accept
    fine = {"calib_probes": ("matmul_f32", "compile"), "calib_matmul_n": 8,
            "calib_memory_mb": 1, "calib_dispatch_iters": 1, "calib_budget_s": 0.5}
    key = next(iter(override))
    assert getattr(get_config("python", **{key: fine[key]}), key) == getattr(
        jax_config("python", **{key: fine[key]}), key)


@pytest.mark.parametrize("override", [
    {}, dict(calib_probes=("memory", "dispatch")), dict(calib_matmul_n=8192, calib_memory_mb=1024),
    dict(calib_dispatch_iters=7, calib_budget_s=2.5)],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()) or "defaults")
def test_calibration_kwargs_equal_jax_bench(override):
    """The port reads the ``calib_*`` fields into ``run_calibration``'s
    arguments as the JAX package's bench reads its own (``bench.py``'s
    calibration phase), and the two configs' defaults agree."""
    from csat_tpu.configs import get_config as jax_config
    from csat_tpu_torch.configs import get_config

    c = jax_config("python", **override)
    bench = dict(matmul_n=c.calib_matmul_n, memory_mb=c.calib_memory_mb,
                 dispatch_iters=c.calib_dispatch_iters, budget_s=c.calib_budget_s,
                 probes=c.calib_probes or jcal.PROBES)
    assert tcal.calibration_kwargs(get_config("python", **override)) == bench
