"""``chip_smoke.py``'s resilience phase, rehearsed on the CPU at a narrow
width (nodes up to 64, batch 8, one layer of each kind) through the plain
paths: the NaN-step drill (parameters and moments bitwise unchanged, one
non-finite step, the device probe untripped), the rollback drill, the
quarantine drill with its scalar log, profiled epoch and over-budget raise,
the watchdog's host leg, the prefetch epochs' bitwise-equal losses, and the
command-line drills — a run
SIGTERM'd mid-epoch exiting 75 and resumed to an uninterrupted run's every
loss.  On the card the same functions run at full width; the sync counts,
the device leg and the update's launch counts need the card and run there
only.  The gates are the phase's own: exact counts and bitwise losses."""

import numpy as np
import pytest

import chip_smoke

from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NARROW = dict(hidden_size=32, sbm_enc_dim=32, pegen_dim=16, pe_dim=8, num_heads=2,
              dim_feed_forward=64, max_src_len=64, batch_size=8, num_layers=1, sbm_layers=1,
              clusters=(4,), decoder_layers=1, max_tgt_len=10)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from csat_tpu_torch.data.synthetic import make_corpus

    tmp = str(tmp_path_factory.mktemp("resilience_corpus"))
    data_dir = make_corpus(f"{tmp}/corpus", 96, 16, 16, seed=chip_smoke.SEED, max_ast_len=64,
                           node_range=(10, 64))
    return tmp, data_dir


def test_nan_step_drill_keeps_every_bit(corpus, tmp_path):
    rec = chip_smoke.nan_step_drill(corpus[1], str(tmp_path), device="cpu",
                                    watchdog_timeout_s=120.0, **NARROW)
    assert rec["nonfinite_steps"] == 1 and rec["tensors_unchanged"] > 0
    assert rec["registry"]["train_nonfinite_steps_total"] == 1


def test_rollback_drill_rolls_back_once(corpus, tmp_path):
    rec = chip_smoke.rollback_drill(corpus[1], str(tmp_path), device="cpu", **NARROW)
    assert rec["rollbacks"] == 1 and rec["registry"]["train_rollbacks_total"] == 1
    assert np.isfinite(rec["epoch_loss"]) and rec["final_step"] == rec["replayed_steps"]


def test_quarantine_drill_on_the_planned_chunks(corpus, tmp_path):
    rec = chip_smoke.quarantine_drill(corpus[1], str(tmp_path / "q"), device="cpu", **NARROW)
    assert rec["planned_batches"] > max(chip_smoke.QUARANTINED)
    assert len(rec["quarantined_chunks"]) == rec["budget"] == 2
    assert rec["steps"] == rec["planned_batches"] - 2
    assert rec["registry"]["train_quarantined_total"] == 2
    assert "exhausted" in rec["exceeded"] and rec["trace_files"]


def test_host_leg_drill_trips_and_finishes(corpus, tmp_path):
    rec = chip_smoke.host_leg_drill(corpus[1], str(tmp_path), device="cpu", **NARROW)
    assert {"fault.watchdog", "fault.injected.hang"} <= set(rec["postmortem_events"])
    assert rec["fit_s"] >= chip_smoke.HOST_LEG_S


def test_prefetch_epochs_give_bitwise_equal_losses(corpus, tmp_path):
    rec, _ = chip_smoke.prefetch_readings(corpus[1], str(tmp_path), device="cpu",
                                          order=(0, 2), profile_order=(), **NARROW)
    assert [r["prefetch"] for r in rec["runs"]] == [0, 2]
    assert rec["losses_bit_equal"] == rec["runs"][0]["steps"] > 0


def test_cli_drills_preempt_and_resume_bit_for_bit(corpus, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # three processes share the test's cores
    started = chip_smoke.start_cli_drills(corpus[0], corpus[1], device="cpu",
                                          sets=dict(NARROW))
    assert "watchdog" not in started["procs"]  # the wedged-stream child needs the card
    rec = chip_smoke.finish_cli_drills(started)
    assert rec["exit_preempted"] == 75 and rec["preempted"]["preempted"] is True
    assert 0 < rec["steps_before_stop"] < rec["steps"] == rec["losses_bit_equal"]
