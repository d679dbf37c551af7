"""``chip_smoke.py``'s new card pieces rehearsed on the CPU: the
``calibration`` phase's gates (every probe run, finite and positive, the
card-size readings under the card's peaks, the kernel library store left as
it was), the compile probe building with a stand-in ``nvcc`` into a
temporary directory only, the suite's sizes read from the config's
``calib_*`` fields, the ``perfdb`` leg on a temporary history with its keys
held to the JAX package's, and the ``data_mesh`` phase at narrow
widths, its three legs' ranks at once in fresh interpreters, leg (c) —
python over data 2 × model 2 — held in full against the one-process step.  What needs the card — the probes' readings,
the kernels launched at checked shapes — is left to the card."""

import os
import stat
import sys

import pytest

import chip_smoke
from csat_tpu.obs import perfdb as jdb
from csat_tpu_torch.obs import calibrate

from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NARROW = dict(pe_dim=8, pegen_dim=16, sbm_enc_dim=32, hidden_size=32, num_heads=4,
              num_layers=1, sbm_layers=4, clusters=(4, 4, 4, 4), dim_feed_forward=64,
              decoder_layers=2, max_src_len=32, max_tgt_len=10)
SMALL = dict(calib_matmul_n=64, calib_memory_mb=2)


def _suite(**probes):
    values = {"matmul_f32_gflops": 50_000.0, "matmul_bf16_gflops": 600_000.0,
              "memory_gbps": 3000.0, "dispatch_us": 5.0, "compile_s": 3.0}
    values.update(probes)
    return {"probes": values, "skipped": {}, "elapsed_s": 1.0, "params": {}}


@pytest.fixture
def stores(tmp_path, monkeypatch):
    """``build/kernels/`` and the warm-start store moved into ``tmp_path``,
    each holding one library."""
    from csat_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CSAT_TPU_CACHE_DIR", str(tmp_path / "cache"))
    for d in chip_smoke.kernel_stores():
        d.mkdir(parents=True)
        (d / "libx.so").write_bytes(b"\0" * 8)
    return tmp_path


def test_calibration_gates():
    share = chip_smoke.calibration_gates({"defaults": _suite(), "card_size": _suite()})
    assert share == pytest.approx({"matmul_f32_gflops": 50 / 67, "matmul_bf16_gflops": 600 / 989,
                                   "memory_gbps": 3000 / 3350})
    skipped = dict(_suite(), skipped={"compile": "RuntimeError: nvcc not found"})
    bad = [{"defaults": skipped, "card_size": _suite()},
           {"defaults": _suite(dispatch_us=float("nan")), "card_size": _suite()},
           {"defaults": _suite(compile_s=0.0), "card_size": _suite()},
           {"defaults": _suite(), "card_size": _suite(memory_gbps=1.06 * 3350)},
           {"defaults": _suite(), "card_size": _suite(matmul_f32_gflops=1.1 * 67_000)}]
    for suites in bad:
        with pytest.raises(AssertionError, match="calibration"):
            chip_smoke.calibration_gates(suites)
    # 1.05× the peak is the limit, not past it
    chip_smoke.calibration_gates({"defaults": _suite(),
                                  "card_size": _suite(matmul_bf16_gflops=1.05 * 989_000)})


def test_calibration_phase_on_the_cpu(stores, monkeypatch):
    monkeypatch.setattr(chip_smoke, "emit", lambda *a, **kw: None)
    monkeypatch.setenv("PATH", os.path.dirname(sys.executable))
    # no nvcc: the compile probe is skipped, and a skipped probe fails the run
    with pytest.raises(AssertionError, match="compile"):
        chip_smoke.calibration_phase(device="cpu", card_size=SMALL)
    monkeypatch.setattr(calibrate, "_probe_compile", lambda: 2.5)
    rec = chip_smoke.calibration_phase("card", device="cpu", card_size=SMALL)
    assert rec["fingerprint"]["platform"] == "cpu"
    for name, n in (("defaults", 512), ("card_size", 64)):
        assert rec[name]["params"]["matmul_n"] == n and not rec[name]["skipped"]
        assert len(rec[name]["probes"]) == len(calibrate.PROBES)
    assert set(rec["peak_share"]) == set(chip_smoke.CALIB_PEAKS)


def test_compile_probe_builds_outside_the_store(stores, monkeypatch):
    """A stand-in ``nvcc`` on ``PATH`` writes what ``-o`` names: the probe
    times it, and it wrote into a temporary directory only."""
    fake = stores / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo "$2" >> "$(dirname "$0")/outputs"; : > "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{fake.parent}:{os.environ['PATH']}")
    before = [chip_smoke._tree_state(d) for d in chip_smoke.kernel_stores()]
    assert calibrate._probe_compile() > 0
    assert [chip_smoke._tree_state(d) for d in chip_smoke.kernel_stores()] == before
    (out,) = (fake.parent / "outputs").read_text().split()
    assert os.path.basename(os.path.dirname(out)).startswith("csat_calib_")
    assert not os.path.exists(out)  # the temporary directory is gone
    # a failing build raises with the compiler's output, and the suite skips it
    fake.write_text("#!/bin/sh\necho 'error: no' ; exit 2\n")
    with pytest.raises(RuntimeError, match="error: no"):
        calibrate._probe_compile()
    out = calibrate.run_calibration(device="cpu", probes=("compile",))
    assert out["skipped"]["compile"].startswith("RuntimeError: nvcc failed")


def test_perfdb_leg_on_the_cpu(stores, monkeypatch):
    monkeypatch.setattr(chip_smoke, "emit", lambda *a, **kw: None)
    monkeypatch.setattr(calibrate, "_probe_compile", lambda: 2.5)
    cal = chip_smoke.calibration_phase(device="cpu", card_size=SMALL)
    rec = chip_smoke.perfdb_leg(cal, 1234.5, device="cpu")
    assert rec["reference_run"] == "chip_smoke" and rec["headline"] == 1234.5
    assert rec["calibration_params"]["matmul_n"] == SMALL["calib_matmul_n"]
    # the JAX package's keys, from its own function on two calibrated entries
    a = jdb.make_entry({"value": 10.0, "calibration": cal["card_size"]}, run_id="a", ts=0.0)
    b = jdb.make_entry({"value": 5.0, "calibration": cal["card_size"]}, run_id="b", ts=1.0)
    assert tuple(jdb.attribute_delta(a, b)) == chip_smoke.ATTRIBUTION_KEYS
    # a ledger whose reference is not the entry read back fails the leg
    from csat_tpu_torch.obs import perfdb

    monkeypatch.setattr(perfdb, "reference_entry", lambda h: None)
    with pytest.raises(AssertionError, match="perfdb"):
        chip_smoke.perfdb_leg(cal, 1234.5, device="cpu")


def test_calibration_suite_reads_the_config(monkeypatch):
    """The suite's sizes come from the ``calib_*`` fields, which the config
    validates: an override it refuses never reaches a probe."""
    seen = []
    monkeypatch.setattr(calibrate, "run_calibration", lambda **kw: seen.append(kw) or kw)
    chip_smoke.calibration_suite("cpu", **SMALL)
    assert seen == [dict(device="cpu", probes=calibrate.PROBES, matmul_n=64, memory_mb=2,
                         dispatch_iters=50, budget_s=45.0)]
    with pytest.raises(AssertionError):
        chip_smoke.calibration_suite("cpu", calib_matmul_n=4)
    assert len(seen) == 1


def test_data_mesh_phase_on_the_cpu(monkeypatch):
    """The three legs at once, leg (c) held in full: python over data 2 ×
    model 2 against one process."""
    for check in ("_check_launched", "_check_rates", "_check_shapes"):
        monkeypatch.setattr(chip_smoke, check, lambda *a, **kw: None)
    lines = {}
    monkeypatch.setattr(chip_smoke, "emit", lambda phase, **kw: lines.setdefault(phase, kw))
    out = chip_smoke.data_mesh_phase(device="cpu", overrides=NARROW)
    assert set(out["launches"]) == set(chip_smoke.DATA_MESH_LEGS) == set(lines) - {"data_mesh"}
    for kind, mesh in (("data_pp", {"data": 2, "pipe": 2}), ("data_seq", {"data": 2, "seq": 2})):
        rec = lines[kind]
        assert rec["mesh"] == mesh and rec["ranks"] == 4 and rec["params_bitwise_equal"]
        assert rec["loss_rel"] <= 1e-6 and rec["grad_norm_rel"] <= 1e-5 and "decode" not in rec
    assert all(row[0] == 0 for row in lines["data_seq"]["graph_sum_entries_apart_by_layer"])
    rec = lines["data_tp"]
    assert rec["mesh"] == {"data": 2, "model": 2} and rec["ranks"] == 4
    assert sorted(map(tuple, rec["rows_by_rank"])) == [(0, 32), (0, 32), (32, 32), (32, 32)]
    assert rec["loss_rel"] <= 1e-6 and rec["grad_norm_rel"] <= 1e-5
    assert rec["params_equal_on_ranks"] and rec["metrics_equal"]
    assert rec["params_rel_l2_vs_one_process"] <= chip_smoke.TP_PARAMS_RTOL
    assert len(rec["losses"]) == 1 + chip_smoke.DATA_STEPS and "decode" not in rec
    # ΣA of every layer put back together from the four ranks' rows and heads
    assert rec["graph_sum_entries_apart_by_layer"] == [0, 0, 0, 0]
    assert {g["bh0"] for g in rec["same_graph"]} == {0, 2, 128, 130}
    assert all(g["edges_apart"] == 0 for g in rec["same_graph"])
    assert not rec["launches"]  # the plain path launches no kernel
