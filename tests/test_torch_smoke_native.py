"""``chip_smoke.py``'s native phase, rehearsed on the CPU at a narrow width
(nodes up to 48, batch 8, one layer of each kind) through the plain paths:
one fixed-shape epoch of ``Trainer.fit`` in the python config's defaults and
``run_test`` scoring BLEU / ROUGE-L / METEOR, every batch the NumPy collate of
its indices bit for bit and collated natively, the eval's METEOR the Python
scorer's on its own hypotheses; the collate timings' equality check; and
``lint`` in a process of its own, clean.  The kernels' launches at shapes
phase 3 checked need the card and are gated there only."""

import pytest

import chip_smoke

from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NARROW = dict(hidden_size=32, sbm_enc_dim=32, pegen_dim=16, pe_dim=8, num_heads=4,
              dim_feed_forward=64, max_src_len=48, batch_size=8, num_layers=1, sbm_layers=1,
              clusters=(4,), decoder_layers=2, max_tgt_len=12)


@pytest.fixture(autouse=True)
def quiet(monkeypatch):
    for check in ("_check_launched", "_check_rates", "_check_shapes"):
        monkeypatch.setattr(chip_smoke, check, lambda *a, **kw: None)


def test_native_fit_on_the_cpu(tmp_path):
    from csat_tpu_torch.data.synthetic import make_corpus

    data_dir = make_corpus(str(tmp_path / "corpus"), 32, 8, 16, seed=chip_smoke.SEED,
                           max_ast_len=48)
    rec = chip_smoke.native_fit(data_dir, str(tmp_path / "out"), device="cpu", **NARROW)
    assert (rec["bucketing"], rec["noise_mode"], rec["eval_graph"]) == (False, "shared", "sample")
    assert rec["steps"] == 4 and rec["batches"] == 6 and rec["native_collate_calls"] == 6
    assert rec["meteor_pairs"] == 16 and rec["native_meteor_calls"] >= 16
    assert rec["meteor_max_pair_err"] <= chip_smoke.NATIVE_METEOR_TOL
    assert rec["test"]["meteor"] == pytest.approx(rec["meteor_python"], abs=1e-7)


def test_collate_timings_and_lint():
    rec = chip_smoke.collate_timings(chip_smoke.synthetic_arrays(12, 64, 11), 6, 64, reps=2)
    assert rec["B"] == 6 and rec["N"] == 64 and rec["native_ms"] > 0 and rec["numpy_ms"] > 0
    lint = chip_smoke.lint_run()
    assert lint["exit"] == 0 and lint["findings"] == 0 and lint["files"] > 90
    assert lint["rules"] == 11 and lint["suppressed"] == 9
