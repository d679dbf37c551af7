"""A run with its timed path broken underneath comes out not correct, and a
sound one correct: the harness's look for a card skipped, everything else of
a run driven at a tiny size on the CPU, under the cells' own limits.

The control (the reference in TF32 in the program's place) is measured on the
card at the cells' own sizes (``test_control_fails_each_cell_on_the_card``,
``PERF.md``); here it runs at the CPU size, where it must read above the
program by the margin the limits rely on."""

import pytest

from conftest import cpu_run, tiny_cell
from portbench.core.faults import make_fault

TRAIN = ["python-train-b64", "java-train-b64"]
SERVE = ["python-serve-poisson", "python-serve-repeats"]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_a_sound_run_is_correct(cell):
    res = cpu_run(tiny_cell(cell))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-3:] == ["checks", "_record", "_out"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in TRAIN for f in ("unchanged", "half_batch")]
                         + [(c, "token") for c in SERVE])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    c = tiny_cell(cell)
    res = cpu_run(c, fault=make_fault(fault, c))
    assert not res["correct"], res["checks"]


def test_the_control_reads_far_above_the_program_on_the_cpu():
    res = cpu_run(tiny_cell("python-train-b64"), control=True)
    prog, ctl = res["_out"]["values"], res["_out"]["control"]
    assert ctl["grad_gap"] > 100 * max(prog["grad_gap"], 1e-9)
    assert ctl["change_gap"] > 10 * max(prog["change_gap"], 1e-9)
    assert len(prog["loss_steps"]) == len(prog["widths"]) == 3
