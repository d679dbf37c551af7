"""``chip_smoke.py``'s ``net`` phase, rehearsed on the CPU at narrow widths:
(a) the network chaos drill in front of one engine (strict and clean,
resumes, the injected malformed lines counted, OK tokens a solo engine's)
with its wedged-reader leg (stalled, unstalled, stalled again and dropped,
its streams resumed exactly once), (b) the drill over a fleet losing a replica,
(c) the SLO alert firing and clearing and stamped into an autoscaler's heal,
(d) ``serve --net --slo --replicas 2`` in a process of its own, SIGTERM'd
mid-stream, and ``top`` on its metrics file.  What needs the card is left to
it: the kernels launched on each path at shapes phase 3 checked and the host
reads per tick and per front step (``tests/test_torch_cuda_net.py``)."""

import pytest

import chip_smoke

from torch_parity import MICRO, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NARROW = dict(pe_dim=8, pegen_dim=16, sbm_enc_dim=32, hidden_size=32, num_heads=4,
              num_layers=1, sbm_layers=1, clusters=(4,), dim_feed_forward=64, decoder_layers=2,
              max_src_len=48, max_tgt_len=12, serve_slots=4, serve_page_size=4)


@pytest.fixture(autouse=True)
def quiet(monkeypatch):
    for check in ("_check_launched", "_check_rates", "_check_shapes"):
        monkeypatch.setattr(chip_smoke, check, lambda *a, **kw: None)
    monkeypatch.setattr(chip_smoke, "emit", lambda *a, **kw: None)


def test_net_drill_on_the_cpu():
    rec = chip_smoke.net_drill(device="cpu", overrides=NARROW)
    assert rec["violations"] == 0 and "UNRESOLVED" not in rec["outcomes"]
    assert sum(rec["outcomes"].values()) == rec["requests"]
    net = rec["net"]
    assert net["resumes"] >= 1 and net["malformed"] == 2 and net["forced_reconnects"] == 1
    assert rec["tokens"]["gate"] == "bit" and rec["socket_buffers"]["granted"] > 0
    assert rec["reads"] is None and rec["drain_wall_s"]["net"] > 0
    wedge = rec["wedge"]
    assert wedge["exactly_once"] and wedge["stall_drops"] == 1
    assert wedge["unstalls"] >= 1 and wedge["stalls"] == wedge["unstalls"] + 1
    assert wedge["wedged_streams"] == chip_smoke.NET_WEDGE_REQUESTS and wedge["resumes"] == 4
    assert wedge["others_ok"] == chip_smoke.NET_WEDGE_OTHERS


def test_net_fleet_on_the_cpu():
    rec = chip_smoke.net_fleet(device="cpu", overrides=NARROW)
    assert rec["violations"] == 0 and rec["capacity_frac"] == 0.5
    assert rec["moved"] > 0 and rec["moved_ok"] > 0 and rec["tokens"]["gate"] == "bit"


def test_net_slo_on_the_cpu():
    rec = chip_smoke.net_slo(device="cpu", overrides=NARROW)
    assert [t["state"] for t in rec["transitions"]] == ["alert", "ok"]
    assert rec["gauges"] == [1, 0] and rec["recorder_events"] == ["slo.alert", "slo.ok"]
    assert rec["scaler_decision"]["slo_firing"] == "availability" and rec["rejected"] > 0


def test_net_cli_on_the_cpu(tmp_path, monkeypatch):
    from csat_tpu_torch.data.synthetic import make_corpus

    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the serve process shares the test's cores
    sets = {k: v for k, v in MICRO.items() if k not in ("serve_slots", "eval_graph")}
    data_dir = make_corpus(str(tmp_path / "corpus"), 32, 8, 8, seed=chip_smoke.SEED,
                           max_ast_len=MICRO["max_src_len"])
    ckpt = chip_smoke.serving_checkpoint(data_dir, str(tmp_path / "fit"), device="cpu",
                                         batch_size=8, **sets)
    rec = chip_smoke.net_cli(data_dir, ckpt, str(tmp_path), device="cpu", sets=sets)
    assert rec["exit_status"] == 0 and rec["ok"] == 8 and rec["failed"] == 4
    assert rec["tokens_equal_engine"] and rec["net"]["malformed"] == 1
    assert rec["net"]["refused"] == 0 and rec["drain_line"] and rec["top_lines"] > 5
