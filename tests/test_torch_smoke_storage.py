"""``chip_smoke.py``'s ``storage`` phase, rehearsed on the CPU at narrow
widths: (a) the tiered drill at f32 and int8 pages (spill, disk demotion,
replay bit for bit against a never-tiered engine, restored bytes, the
corrupted replay, the int8-into-f32 refusal), (b) the serve mesh's payloads
and replay against the solo engine's, (c) the rect layout against the paged
engine up to a near tie.  What needs the card is left to it: the kernels
launched on each path at shapes phase 3 checked, the host reads per tick,
and (d) — warm start loads kernel libraries, which the CPU path never does
(``tests/test_torch_warmstart.py`` holds the store and the build hook)."""

import pytest

import chip_smoke

from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NARROW = dict(pe_dim=8, pegen_dim=16, sbm_enc_dim=32, hidden_size=32, num_heads=4,
              num_layers=1, sbm_layers=1, clusters=(4,), dim_feed_forward=64, decoder_layers=2,
              max_src_len=48, max_tgt_len=12, serve_slots=4, serve_page_size=4)


def _quiet(monkeypatch):
    for check in ("_check_launched", "_check_rates", "_check_shapes"):
        monkeypatch.setattr(chip_smoke, check, lambda *a, **kw: None)
    monkeypatch.setattr(chip_smoke, "emit", lambda *a, **kw: None)


@pytest.fixture(scope="module")
def solo(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    _quiet(mp)
    try:
        yield chip_smoke.tier_drill("float32", str(tmp_path_factory.mktemp("tiers")),
                                    device="cpu", overrides=NARROW)
    finally:
        mp.undo()


def test_tier_drill_f32_on_the_cpu(solo):
    assert solo["tokens_and_statuses_equal"] and solo["restores"] > 0
    assert solo["after_spill"]["disk_files"] > 0 and solo["after_spill"]["demotions"] > 0
    assert solo["restored_chains_bytes_equal"] > 0
    assert solo["corrupt_miss_reasons"] == ["digest_mismatch"] and solo["reprefills"] > 0
    assert solo["bytes_per_spilled_chain"] > 0 and solo["restore_p95_ms"] >= 0
    # every restore's get and writes were timed, and only the replay's
    assert solo["restore_get_ms"]["calls"] == solo["restores"]
    assert solo["restore_write_ms"]["calls"] == solo["restores"]


def test_tier_drill_int8_and_cross_dtype_on_the_cpu(tmp_path, monkeypatch):
    _quiet(monkeypatch)
    rec = chip_smoke.tier_drill("int8", str(tmp_path), device="cpu", overrides=NARROW,
                                cross_dtype=True)
    assert rec["tokens_and_statuses_equal"] and rec["restores"] > 0
    assert rec["cross_dtype"]["reasons"] == ["dtype_mismatch"]
    assert rec["cross_dtype"]["adopted_disk_entries"] > 0


def test_tier_mesh_on_the_cpu(solo, tmp_path, monkeypatch):
    _quiet(monkeypatch)
    rec = chip_smoke.tier_mesh(solo, str(tmp_path), device="cpu", overrides=NARROW)
    assert rec["payloads_equal"] and rec["payloads_compared"] > 0 and rec["restores"] > 0


def test_rect_ab_on_the_cpu(monkeypatch):
    _quiet(monkeypatch)
    rec = chip_smoke.rect_ab(device="cpu", overrides=NARROW)
    assert rec["tokens_equal_up_to_tie"] and rec["tokens_compared"] > 0
    # on the CPU the paged route is the plain one, and the two layouts agree bit for bit
    assert rec["bit_equal_paged_plain"] and rec["bit_equal_paged_k5"]
    assert rec["rect_kv_bytes"] > 0 and rec["paged_peak_pages"] > 0
