"""The network front door and the SLO engine on the card, at narrow widths
with the kernels' head width (64).  These tests need an NVIDIA GPU; they
carry the ``cuda`` marker and skip elsewhere (run them on a GPU machine with
``pytest tests/test_torch_cuda_net.py -m cuda --noconftest``).

* ``chip_smoke.net_drill``: behind the front door the engine still reads the
  device once per decode-only tick, the front reads the token pool at most
  once a step (none before a stream has a token), and K1, K2 and K5 launch;
  the OK streams' tokens are a solo engine's; the wedged reader's streams
  come back exactly once;
* ``chip_smoke.net_fleet``: a fleet losing a replica behind the front door
  launches the serving kernels, its moved requests stream OK;
* ``chip_smoke.net_slo``: the availability alert fires and clears on the
  card's engine, and the autoscaler's heal carries it.
"""

import os
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = dict(pe_dim=32, pegen_dim=128, sbm_enc_dim=128, hidden_size=128, num_heads=2,
            num_layers=1, sbm_layers=1, clusters=(4,), dim_feed_forward=256, decoder_layers=2,
            max_src_len=48, max_tgt_len=12, serve_slots=4, serve_page_size=4)
SERVING = ("flex_fwd_cse", "flex_fwd_sbm_expected", "paged_decode")


@pytest.fixture(scope="module")
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, REPO)
    import chip_smoke

    mp = pytest.MonkeyPatch()
    # phase 3's shape checks have not run in this process; each test reads
    # the launches it needs from the record
    for check in ("_check_launched", "_check_rates", "_check_shapes"):
        mp.setattr(chip_smoke, check, lambda *a, **kw: None)
    mp.setattr(chip_smoke, "emit", lambda *a, **kw: None)
    yield chip_smoke
    mp.undo()


def test_net_drill_reads_and_launches_on_the_card(smoke):
    rec = smoke.net_drill(overrides=CARD)
    reads = rec["reads"]
    assert reads["reads_per_tick"] == 1 and reads["decode_only_ticks"] > 0
    assert 0 < reads["front_pool_reads"] <= reads["front_steps_with_streams"]
    assert all(rec["launches"].get(fn, 0) > 0 for fn in SERVING), rec["launches"]
    assert rec["violations"] == 0
    assert rec["tokens"]["tokens_compared_requests"] > 0
    assert rec["wedge"]["exactly_once"] and rec["wedge"]["stall_drops"] == 1
    assert rec["wedge"]["unstalls"] >= 1


def test_net_fleet_launches_and_moves_on_the_card(smoke):
    rec = smoke.net_fleet(overrides=CARD)
    assert all(rec["launches"].get(fn, 0) > 0 for fn in SERVING), rec["launches"]
    assert rec["violations"] == 0 and rec["moved"] > 0 and rec["capacity_frac"] == 0.5


def test_net_slo_fires_and_clears_on_the_card(smoke):
    rec = smoke.net_slo(overrides=CARD)
    assert [t["state"] for t in rec["transitions"]] == ["alert", "ok"]
    assert rec["gauges"] == [1, 0] and rec["scaler_decision"]["slo_firing"] == "availability"
    assert all(rec["launches"].get(fn, 0) > 0 for fn in SERVING), rec["launches"]
