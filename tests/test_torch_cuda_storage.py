"""The serving engine's storage on the card, at narrow widths with the
kernels' head width (64).  These tests need an NVIDIA GPU; they carry the
``cuda`` marker and skip elsewhere (run them on a GPU machine with
``pytest tests/test_torch_cuda_storage.py -m cuda --noconftest``).

* ``chip_smoke.tier_drill`` at f32, bf16 and int8 pages: a tiered engine's
  replay from restored chains (K5 reading them) equal to a never-tiered
  engine's bit for bit, restored pages gathered again equal to the spilled
  bytes, the corrupted replay re-prefilled to the same tokens, one device
  read per decode-only tick; int8 snapshots refused by an f32 pool;
* ``chip_smoke.tier_mesh``: a ``(1, 2)`` serve mesh on ``cuda:0`` spills the
  solo engine's bytes and replays its tokens;
* ``chip_smoke.rect_ab``: the rect layout against the paged engine up to a
  near tie, K5 never launched by the rect engine;
* the warm-start hook in fresh processes: a cold load builds and saves, a
  warm load builds nothing and its library's K5 equals the plain path, a
  corrupt entry is rebuilt.
"""

import json
import os
import subprocess
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


@pytest.fixture(scope="module")
def solo(smoke, tmp_path_factory):
    return smoke.tier_drill("float32", str(tmp_path_factory.mktemp("tiers")), overrides=CARD)


def test_tier_drill_f32_on_the_card(solo):
    assert solo["tokens_and_statuses_equal"] and solo["restores"] > 0
    assert solo["restored_chains_bytes_equal"] > 0 and solo["after_spill"]["disk_files"] > 0
    assert solo["corrupt_miss_reasons"] == ["digest_mismatch"]
    assert solo["reads"]["reads_per_tick"] == 1
    assert solo["launches"]["paged_decode"] > 0


@pytest.mark.parametrize("page_dtype", ["bfloat16", "int8"])
def test_tier_drill_quantized_pages_on_the_card(smoke, tmp_path, page_dtype):
    rec = smoke.tier_drill(page_dtype, str(tmp_path), overrides=CARD,
                           cross_dtype=page_dtype == "int8")
    assert rec["tokens_and_statuses_equal"] and rec["restores"] > 0
    assert rec["restored_chains_bytes_equal"] > 0 and rec["launches"]["paged_decode"] > 0
    if page_dtype == "int8":
        assert rec["cross_dtype"]["reasons"] == ["dtype_mismatch"]


def test_tier_mesh_on_the_card(smoke, solo, tmp_path):
    rec = smoke.tier_mesh(solo, str(tmp_path), overrides=CARD)
    assert rec["payloads_equal"] and rec["payloads_compared"] > 0
    assert rec["launches"]["paged_decode"] > 0


def test_rect_ab_on_the_card(smoke):
    rec = smoke.rect_ab(overrides=CARD)
    assert rec["tokens_equal_up_to_tie"] and "paged_decode" not in rec["launches"]
    assert rec["launches"]["flex_fwd_cse"] > 0


CHILD = """
import json, pathlib, sys, torch
from csat_tpu_torch.ops import build, paged_decode
from csat_tpu_torch.serve.warmstart import WarmStartStore
build.BUILD_DIR = pathlib.Path(sys.argv[2])
built = []
inner = build._nvcc_build
build._nvcc_build = lambda todo: (built.extend(todo), inner(todo))[1]
build.load_library("paged_decode", WarmStartStore(sys.argv[1]))
g = torch.Generator().manual_seed(0)
s, h, npages, page, dh, nb = 3, 2, 6, 4, 64, 3
q = torch.randn(s, h, 1, dh, generator=g).cuda()
pk, pv = (torch.randn(npages, h, page, dh, generator=g).cuda() for _ in range(2))
sk = sv = torch.ones(npages, h, page, 1).cuda()
table = torch.tensor([[1, 2, 3], [4, 5, 0], [2, 0, 0]], dtype=torch.int32).cuda()
mask = torch.zeros(s, nb * page, dtype=torch.bool).cuda()
mask[1, 8:] = True
mask[2, 3:] = True
out, _ = paged_decode.paged_attend(q, pk, pv, sk, sv, table, mask, nb * page)
ref, _ = paged_decode._attend_reference(q, pk, pv, sk, sv, table, mask, nb * page,
                                        None, None, None)
print(json.dumps(dict(prov=build.PROVENANCE["paged_decode"], built=built,
                      err=float((out - ref).abs().max()),
                      launches=build.launch_counts()["paged_decode"])))
"""


def test_warm_start_hook_in_fresh_processes(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from csat_tpu_torch.serve.warmstart import WarmStartStore

    store = str(tmp_path / "store")

    def leg(kernels):
        env = dict(os.environ, PYTHONPATH=REPO)
        env.pop("CSAT_TPU_NO_CACHE", None)
        res = subprocess.run([sys.executable, "-c", CHILD, store, str(tmp_path / kernels)],
                             cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-3000:]
        return json.loads(res.stdout.strip().splitlines()[-1])

    cold = leg("k_cold")
    assert cold["prov"] == "absent" and cold["built"] == ["paged_decode"]
    warm = leg("k_warm")
    assert warm["prov"] == "hit" and warm["built"] == []
    assert warm["launches"] == 1 and warm["err"] <= 1e-5
    assert WarmStartStore(store).corrupt_entries() == 1
    again = leg("k_again")
    assert again["prov"] == "digest_mismatch" and again["built"] == ["paged_decode"]
    assert again["err"] <= 1e-5
