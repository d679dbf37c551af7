"""The replica fleet on the card, at narrow widths with the kernels' head
width (64).  These tests need an NVIDIA GPU; they carry the ``cuda`` marker
and skip elsewhere (run them on a GPU machine with
``pytest tests/test_torch_cuda_fleet.py -m cuda --noconftest``).

* ``chip_smoke.fleet_sick``: a retired replica's pool is given back (the
  allocated bytes fall by at least its pool's at the retiring tick), each
  decode-only fleet tick reads the device once per replica that decoded,
  and every replica that served launched K1, K2 and K5;
* ``chip_smoke.fleet_mesh``: a ``(1, 2)`` serve-mesh replica launches K5
  twice per decode step as often as the solo replica beside it, tokens
  equal;
* ``chip_smoke.fleet_heal``: every engine books its own warm-start verdict
  — a healed replacement ``hit`` for each library, after
  ``corrupt_warmstart`` ``digest_mismatch`` and the store repaired whole.
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


def test_retired_replica_gives_its_pool_back_and_replicas_launch(smoke):
    rec = smoke.fleet_sick(overrides=CARD)
    mem = rec["memory"]
    assert mem["freed_at_retirement"] >= mem["retired_pool_bytes"] > 0
    assert rec["reads"]["decode_only_fleet_ticks"] > 0
    for k, counts in rec["launches_by_replica"].items():
        assert all(c > 0 for c in counts.values()), (k, counts)
    assert rec["tokens"]["tokens_compared_requests"] > 0


def test_mesh_replica_launches_k5_per_shard(smoke):
    rec = smoke.fleet_mesh(overrides=CARD)
    per = rec["k5_per_decode_step"]
    assert per[1] == 2 * per[0] > 0 and rec["tokens_and_statuses_equal"]


def test_every_spawn_books_its_own_warm_start_verdict(smoke):
    from csat_tpu_torch.ops import build

    rec = smoke.fleet_heal(overrides=CARD)
    libs = sorted(build.SERVE_LIBRARIES)
    legs = rec["legs"]
    assert legs["heal"]["provenance_spawned"] == [{lib: "hit" for lib in libs}]
    assert legs["corrupt_warmstart"]["provenance_spawned"] == [
        {lib: "digest_mismatch" for lib in libs}]
    assert legs["corrupt_warmstart"]["store_after"] == {lib: "hit" for lib in libs}
    assert legs["corrupt_warmstart"]["corrupted_entries"][0] >= len(libs)
    # the first engine on a fresh store repaired it; the second hit it
    first = legs["heal"]["provenance_first"]
    assert first[1] == {lib: "hit" for lib in libs}
