"""``chip_smoke.py``'s ``real_corpus`` phase, rehearsed on the CPU at a narrow
width (one layer of each kind, dim 32–64, nodes up to 48) through the plain
paths: (a) a stdlib corpus built through the port's extraction and
preprocessing, every asked sample kept, both vocabularies larger than the
synthetic corpus's; (b) ``Trainer.fit`` in the python config's defaults,
bucketed, 2 epochs with asynchronous snapshots, the loss falling; (c) the
newest snapshot equal to the final state bit for bit when ``fit`` returns,
one background write fault retried once from the host copy and a second
raised; (d) the checkpoint readings; (e) the reference-shaped decode equal
to the cached one up to the near-tie rule, one full forward per step.  The
kernels' launches need the card and are gated there only."""

import pytest
import torch

import chip_smoke
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NARROW = dict(hidden_size=64, sbm_enc_dim=64, pegen_dim=16, pe_dim=8, num_heads=4,
              dim_feed_forward=64, max_src_len=48, batch_size=8, num_layers=1, sbm_layers=1,
              clusters=(4,), decoder_layers=2, max_tgt_len=12)
SAMPLES = (48, 16, 16)


@pytest.fixture(autouse=True)
def quiet(monkeypatch):
    for check in ("_check_launched", "_check_rates", "_check_shapes", "_each_step_launched"):
        monkeypatch.setattr(chip_smoke, check, lambda *a, **kw: None)


def test_real_corpus_phase_on_the_cpu(tmp_path):
    from csat_tpu_torch.data.synthetic import make_corpus
    from csat_tpu_torch.train import checkpoint

    data_dir = make_corpus(str(tmp_path / "corpus"), 32, 8, 8, seed=chip_smoke.SEED,
                           max_ast_len=48)
    rec = chip_smoke.real_corpus_phase((str(tmp_path), data_dir, 0.0), device="cpu",
                                       overrides=NARROW, samples=SAMPLES, max_ast_len=48)
    corpus = rec["corpus"]
    assert corpus["samples"] == dict(zip(("train", "dev", "test"), SAMPLES))
    assert all(v > s for v, s in zip(corpus["vocab"], corpus["synthetic_vocab"]))
    assert (rec["noise_mode"], rec["eval_graph"]) == ("shared", "sample")
    assert rec["epoch_loss"][1] < rec["epoch_loss"][0]
    # the fit's two epoch saves were asynchronous, and durable at its end
    assert len(rec["fit_checkpoint_s"]) == chip_smoke.FIT_EPOCHS
    assert rec["durable"]["step"] == rec["steps"]
    assert not checkpoint._PENDING_SAVES
    assert rec["fault"]["once"] == ["background", "main"]
    assert rec["fault"]["twice"] == ["background", "main"]
    assert "injected commit failure 2 of 2" in rec["fault"]["raised"]
    reads = rec["checkpoint"]
    assert len(reads["async_s"]) == len(reads["sync_s"]) == len(reads["host_copy_s"]) == 3
    assert len(reads["async_wait_s"]) == 3 and len(rec["fit_host_copy_s"]) == 2
    assert reads["state_bytes"] > 0
    dec = rec["decode"]
    assert dec["B"] == chip_smoke.REAL_DECODE_B and dec["steps"] == NARROW["max_tgt_len"] - 1
    assert dec["rows_apart"] == dec["near_ties"]
    assert rec["checkpoints"] == ["state_1.pt", "state_2.pt"]


def test_fault_drill_leaves_the_writer_as_it_found_it(tmp_path):
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.train import checkpoint, create_train_state, default_optimizer

    cfg = get_config("python", **NARROW)
    model = CSATrans(cfg, 50, 60, device="cpu", seed=0)
    state = create_train_state(model, default_optimizer(cfg), 0)
    inner = checkpoint._atomic_save
    rec = chip_smoke.background_fault_drill(str(tmp_path), state)
    assert checkpoint._atomic_save is inner and not checkpoint._PENDING_SAVES
    assert rec["once"] == rec["twice"] == ["background", "main"]
    # after the drill a save to the same directory works as ever
    d = tmp_path / "fault_checkpoints"
    checkpoint.save_state_async(str(d), state, 3)
    checkpoint.wait_for_saves(str(d))
    assert chip_smoke.snapshot_equal(str(d / "state_3.pt"), state)["step"] == 0
    assert torch.load(str(d / "state_3.pt"), weights_only=True)["step"] == 0
