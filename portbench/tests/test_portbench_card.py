"""On the card, at the cells' own sizes: a run is correct; the control (the
reference in TF32 in the program's place) and each planted fault are not.

``python -m pytest portbench/tests -m card -q`` on a machine with an H100;
the limits these read against are ``portbench/limits/<cell>.json``."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = ["python-train-b64", "java-train-b64", "python-serve-poisson", "python-serve-repeats"]
SEEDS = "3900000001,3900000003,3900000005"


def _readings(cell, *extra):
    run = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", "0",
                          "--seconds", "0" if "train" in cell else "8", "--trace", "0",
                          "--readings", SEEDS, *extra], cwd=ROOT, capture_output=True,
                         text=True, timeout=1500)
    assert run.returncode == 0, run.stderr[-3000:]
    return [json.loads(line) for line in run.stdout.splitlines() if line.startswith("{")]


def _fails(cell, values):
    from portbench.core.gates import judge

    return not judge(cell, values)["ok"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_each_cell_on_the_card(cuda, cell):
    rows = _readings(cell, "--control")
    assert len(rows) == 3
    for row in rows:
        assert not _fails(cell, row["values"]), row
        assert _fails(cell, row["control"]), row


@pytest.mark.card
@pytest.mark.parametrize("cell,fault", [("python-train-b64", "half_batch"),
                                        ("java-train-b64", "half_batch"),
                                        ("python-train-b64", "unchanged"),
                                        ("python-serve-poisson", "token"),
                                        ("python-serve-repeats", "token")])
def test_a_planted_fault_fails_on_the_card(cuda, cell, fault):
    for row in _readings(cell, "--fault", fault):
        assert _fails(cell, row["values"]), row


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_prints_the_contract_s_line(cuda, cell):
    run = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "3900000007", "--seconds", "10", "--trace", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert run.returncode == 0, run.stderr[-3000:]
    res = json.loads(run.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["metrics"] and res["breakdown"]["device_ops"]
    for name, m in res["metrics"].items():
        if "roofline" in name or "mfu" in name:
            assert 0 < m["value"] <= 100, (name, m)
    assert run.stderr.strip().splitlines()[-1].startswith("check ")
