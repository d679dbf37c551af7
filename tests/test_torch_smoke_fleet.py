"""``chip_smoke.py``'s ``fleet`` phase, rehearsed on the CPU at narrow widths:
(a) the sick-replica drill (statuses, delivered sheds, moved requests
finishing OK, tokens against a solo engine, capacity, the retired pool
dropped) with its fault-free readings, (b) a ``(1, 2)`` serve-mesh replica
beside a solo one, (c) the three healing legs through the warm-start store,
(d) the tiered fleet's chaos drill, (e) the command line's fleet on a
checkpoint of its own, in a serve process of its own.  What
needs the card is left to it: the kernels launched on each path at shapes
phase 3 checked, the host reads per fleet tick, the allocated bytes, K5's
launches per shard and the per-spawn warm-start verdicts (the CPU engine
loads no kernel library; ``tests/test_torch_cuda_fleet.py``)."""

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


def test_fleet_sick_on_the_cpu():
    rec = chip_smoke.fleet_sick(device="cpu", overrides=NARROW)
    assert rec["capacity_frac"] == 0.5 and "serve_max_rebuilds" in rec["sick_reason"]
    assert rec["violations"] == 0 and "UNRESOLVED" not in rec["outcomes"]
    assert sum(rec["outcomes"].values()) == rec["requests"]
    assert set(rec["statuses"]) <= {"OK", "SHED"} and rec["statuses"]["OK"] > 0
    assert rec["tokens"]["gate"] == "bit" and rec["tokens"]["tokens_compared_requests"] > 0
    assert rec["memory"]["retired_pool_bytes"] > 0 and rec["reads"] is None
    assert set(rec["readings"]) == {"1x16", "2x8"}
    assert all(r["tokens"] > 0 for r in rec["readings"].values())


def test_fleet_mesh_on_the_cpu():
    rec = chip_smoke.fleet_mesh(device="cpu", overrides=NARROW)
    assert rec["tokens_and_statuses_equal"] and rec["routes"] == [0, 1]
    assert all(s > 0 for s in rec["decode_steps"].values())


def test_fleet_heal_on_the_cpu():
    rec = chip_smoke.fleet_heal(device="cpu", overrides=NARROW)
    legs = rec["legs"]
    assert set(legs) == {"heal", "corrupt_warmstart", "kill_during_spawn"}
    assert all(leg["replicas_spawned"] == 1 and leg["capacity_frac"] == 1.0
               for leg in legs.values())
    assert legs["kill_during_spawn"]["spawn_failed"] == 1
    assert legs["heal"]["tokens_after_heal"]["gate"] == "bit"
    assert all(len(leg["spawns"]) == 1 for leg in legs.values())


def test_fleet_tiers_on_the_cpu():
    rec = chip_smoke.fleet_tiers(device="cpu", overrides=NARROW)
    assert rec["violations"] == 0 and rec["spill_events"] > 0
    assert rec["restore_misses"].get("digest_mismatch", 0) > 0
    assert sum(rec["outcomes"].values()) == rec["requests"]


def test_fleet_cli_on_the_cpu(tmp_path, monkeypatch):
    from csat_tpu_torch.data.synthetic import make_corpus

    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the serve process shares the test's cores
    sets = {k: v for k, v in MICRO.items() if k not in ("serve_slots", "eval_graph")}
    data_dir = make_corpus(str(tmp_path / "corpus"), 32, 8, 8, seed=chip_smoke.SEED,
                           max_ast_len=MICRO["max_src_len"])
    ckpt = chip_smoke.serving_checkpoint(data_dir, str(tmp_path / "fit"), device="cpu",
                                         batch_size=8, **sets)
    rec = chip_smoke.fleet_cli(data_dir, ckpt, str(tmp_path), device="cpu", sets=sets)
    assert rec["answered"] == rec["lines"] and rec["failed_lines"] == 4
    assert rec["ok"] == rec["lines"] - 4 and rec["exit_status"] == 0
    assert rec["summaries_equal_engine"]
    assert rec["stats"]["replicas"] >= 2 and len(rec["per_replica"]) == rec["stats"]["replicas"]
