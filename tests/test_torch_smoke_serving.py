"""``chip_smoke.py``'s serving phase, rehearsed on the CPU at micro width
through the plain paths: the trace (repeats, skewed budgets, Poisson
arrivals) driven twice from a cold prefix cache with equal tokens and hits
equal to their originals, the drill matrix on one engine under a virtual
clock (each request terminal once, no leak, a post-mortem per reason, the
survivors equal to a clean run, the watchdog tripped by its callback), and
the command line on a checkpoint of its own (``summarize`` against the
engine, a ``serve`` process SIGTERM'd mid-stream answering every line and
exiting 0).  On the card the same functions run at full width; the sync
counts and the kernel launches need the card and run there only."""

import numpy as np
import pytest

import chip_smoke

from torch_parity import MICRO, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _cfg(**kw):
    from csat_tpu_torch.configs import get_config

    return get_config("python", **{**MICRO, "serve_slots": 4, **kw})


@pytest.fixture(scope="module")
def model():
    from csat_tpu_torch.models import CSATrans

    return CSATrans(_cfg(), chip_smoke.SRC_VOCAB, 300, device="cpu", seed=chip_smoke.SEED)


def test_serving_trace_follows_the_bench_protocol():
    cfg = _cfg()
    trace = chip_smoke.serving_trace(cfg)
    n = chip_smoke.SERVING_REQUESTS
    assert len(trace["samples"]) == len(trace["budgets"]) == n
    repeats = [i for i in range(n) if trace["origin"][i] != i]
    assert len(repeats) == chip_smoke.SERVING_REPEATS
    for i in repeats:
        assert trace["origin"][i] < i and trace["samples"][i] is trace["samples"][trace["origin"][i]]
    assert all(2 <= b <= cfg.max_tgt_len - 1 for b in trace["budgets"])
    assert np.all(np.diff(trace["arrivals"]) > 0)
    again = chip_smoke.serving_trace(cfg)
    assert again["budgets"] == trace["budgets"] and again["origin"] == trace["origin"]


def test_trace_driven_twice_from_a_cold_cache(model, tmp_path):
    from csat_tpu_torch.serve import ServeEngine

    # the flagship's pool caches about ten chains beside its live slots; the
    # micro pool's worst case leaves none, so it gets room for a few
    cfg = _cfg(obs_postmortem_dir=str(tmp_path), serve_num_pages=48)
    trace = chip_smoke.serving_trace(cfg)
    engine = ServeEngine(model, cfg, device="cpu")
    first = chip_smoke.drive_trace(engine, trace)
    second = chip_smoke.drive_trace(engine, trace)
    checked = chip_smoke.check_trace_run(first, trace, "run 1")
    assert checked["hits"] == len(second["hits"]) > 0
    for a, b in zip(first["results"], second["results"]):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert engine.page_leaks() == 0 and engine.chain_leaks() == 0
    s = second["summary"]
    assert s["retired"] == chip_smoke.SERVING_REQUESTS and s["prefix_hit_rate"] > 0
    assert s["compiles"] == first["summary"]["compiles"]  # no program after warm-up
    # the CPU reference the card run is held to: the same trace, margins logged
    log = chip_smoke.MarginLog(model)
    try:
        ref_engine = ServeEngine(model, cfg, device="cpu", clock=lambda: len(log.calls))
        ref = chip_smoke.drive_trace(ref_engine, trace)
        ties, compared = chip_smoke.compare_tokens(
            first["results"], dict(results=ref["results"], log=log), "CPU twice")
    finally:
        del model.decode_step  # the instance attribute MarginLog set
    assert compared > 0


def test_reads_per_tick_gate():
    tick = dict(syncs=["csat_tpu_torch/serve/engine.py:1"], admitted=False, resolved=False,
                decoded=True)
    rec = chip_smoke.reads_per_tick([tick, dict(tick, admitted=True, syncs=["a", "b"])])
    assert rec["reads_per_tick"] == 1 and rec["decode_only_ticks"] == 1
    with pytest.raises(AssertionError, match="read the device"):
        chip_smoke.reads_per_tick([tick, dict(tick, syncs=["x", "y"])])


def test_serving_drills_on_the_plain_path(model, tmp_path):
    rec = chip_smoke.serving_drills(model, _cfg(), "cpu", str(tmp_path))
    assert set(rec) == {"poison", "admission", "deadlines", "nan_slot", "wedge",
                        "prefill_fault", "rebuild", "retries_cap", "shed_all", "watchdog"}
    assert rec["nan_slot"]["hit_tokens_exact"] and rec["nan_slot"]["hit_reused_poisoned_pages"]
    assert rec["rebuild"]["resubmitted"] > 0
    assert all(r["postmortem_events"] > 0 for r in rec.values())


def test_serving_command_line_on_its_own_checkpoint(tmp_path, monkeypatch):
    from csat_tpu_torch.data.synthetic import make_corpus

    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the serve process shares the test's cores
    sets = {k: v for k, v in MICRO.items() if k not in ("serve_slots", "eval_graph")}
    data_dir = make_corpus(str(tmp_path / "corpus"), 32, 8, 8, seed=chip_smoke.SEED,
                           max_ast_len=MICRO["max_src_len"])
    ckpt = chip_smoke.serving_checkpoint(data_dir, str(tmp_path / "fit"), device="cpu",
                                         batch_size=8, **sets)
    rec = chip_smoke.serving_cli(data_dir, ckpt, str(tmp_path), device="cpu", sets=sets)
    assert rec["serve_exit"] == 0 and rec["serve_answered"] == rec["serve_lines"]
    assert rec["summarize_equals_engine"] and rec["serve_failed_lines"] == 4
    assert set(rec["serve_ok"].values()) == {"OK"}
