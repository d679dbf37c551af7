"""The port's trainer against the JAX package's on the CPU, at micro widths.

Both packages read the synthetic corpus (each its own copy from the same
seed), start from the same weights (JAX's init, converted) and must agree:

* (a) ``greedy_decode`` tokens are identical to JAX's with
  ``eval_graph="expected"``, at the fixed shape and at bucketed shapes, and
  the early-EOS decoder keeps every row's prefix up to its first EOS;
* (b) a 1-epoch ``Trainer.fit``, with the prefetch thread and without:
  every step's loss within 1e-4 of the JAX ``Trainer``'s on the same
  batches, ``evaluate_bleu`` equal to 1e-6; with and without the thread,
  every loss bitwise equal.  Model
  dropout is 0 (flax draws it from ``jax.random``, which cannot be
  reproduced); attention dropout 0.2 comes from the shared hash stream, and
  the per-layer sample/dropout seeds are handed to both packages (JAX traces
  its step once, so one seed per layer and stream serves every step);
* (c) a checkpoint round trip, and a resume from an epoch-boundary checkpoint
  and from a mid-epoch stop, reproduce the uninterrupted run exactly (every
  later step's loss bit for bit, final parameters equal);
* (d) a planted non-finite loss (``loss_scale=nan`` for
  ``guard_rollback_after`` steps) triggers exactly one rollback and the fit
  ends finite; an exhausted rollback budget raises;
* (e) the gradient of the whole model's deterministic forward under
  ``eval_graph="expected"`` (the path of the ``flex_bwd_*_sbm_expected``
  kernels; here their plain version) within 3e-5 of ``jax.grad`` with
  ``backend="pallas"`` (interpret mode);
* the train state converts from and to the JAX ``TrainState``'s parts;
* the command line (``python -m csat_tpu_torch.cli``) trains, validates and
  saves with ``--device cpu``, scores the saved model with ``--is_test``, and
  raises without ``--device cpu`` where there is no GPU.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIT = dict(
    pe_dim=8, pegen_dim=16, sbm_enc_dim=32, hidden_size=32, num_heads=2, num_layers=1,
    sbm_layers=2, clusters=(4, 3), dim_feed_forward=64, decoder_layers=2, max_src_len=48,
    max_tgt_len=10, batch_size=8, dropout=0.0, attention_dropout=0.2, tree_pos_width=4,
    tree_pos_height=8, eval_graph="expected", noise_mode="counter", val_interval=1,
    save_interval=1, guard_check_every=1, num_epochs=1,
)
SEEDS = {("sample", 0): 11, ("sample", 1): 12, ("dropout", 0): 21, ("dropout", 1): 22}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    from csat_tpu.data.synthetic import make_corpus as jmake
    from csat_tpu_torch.data.synthetic import make_corpus as tmake

    jdir = str(tmp_path_factory.mktemp("jax_corpus"))
    tdir = str(tmp_path_factory.mktemp("torch_corpus"))
    jmake(jdir, n_train=96, n_dev=24, n_test=24, seed=0, max_ast_len=48)
    tmake(tdir, n_train=96, n_dev=24, n_test=24, seed=0, max_ast_len=48)
    return jdir, tdir


def _tcfg(corpora, out, **kw):
    from csat_tpu_torch.configs import get_config

    return get_config("python", data_dir=corpora[1], output_dir=str(out), **{**FIT, **kw})


def _jcfg(corpora, out, **kw):
    from csat_tpu.configs import get_config

    return get_config("python", data_dir=corpora[0], output_dir=str(out),
                      backend="pallas", **{**FIT, **kw})


class _Draws:
    def __init__(self):
        self.calls = {}

    def next(self, name, layers=2):
        i = self.calls.get(name, 0)
        self.calls[name] = i + 1
        return i % layers


def _fixed_seeds(monkeypatch):
    """Hand both packages the same per-layer hash-stream seeds, and switch
    the cluster projection's own dropout (fixed 0.2, drawn from each
    framework's generator) off in both."""
    from csat_tpu.models import sbm as jsbm
    from csat_tpu_torch.models import sbm as tsbm

    class ClusterProj(jsbm.ClusterProj):
        dropout: float = 0.0

    monkeypatch.setattr(jsbm, "ClusterProj", ClusterProj)
    monkeypatch.setattr(tsbm.ClusterProj, "dropout", 0.0)
    jdraws, tdraws = _Draws(), _Draws()
    monkeypatch.setattr(jsbm, "draw_counter_seed", lambda module, name: jnp.int32(
        SEEDS[(name, jdraws.next(name))]))
    monkeypatch.setattr(tsbm, "draw_seed", lambda gen, name: torch.tensor(
        [SEEDS[(name, tdraws.next(name))]], dtype=torch.int32))


def _datasets(trainer, cfg, pkg):
    if pkg == "jax":
        from csat_tpu.data.dataset import ASTDataset
    else:
        from csat_tpu_torch.data.dataset import ASTDataset
    return [ASTDataset(cfg, s, trainer.src_vocab, trainer.tgt_vocab) for s in ("train", "dev")]


@pytest.fixture(scope="module")
def jax_init(corpora, tmp_path_factory):
    """JAX trainer + its freshly initialised params as numpy."""
    from csat_tpu.data.dataset import iterate_batches
    from csat_tpu.train import Trainer as JTrainer

    jcfg = _jcfg(corpora, tmp_path_factory.mktemp("jout"))
    jtr = JTrainer(jcfg, log=lambda m: None)
    train_ds, _ = _datasets(jtr, jcfg, "jax")
    example = next(iterate_batches(train_ds, jcfg.batch_size, shuffle=False))
    params = jax.tree.map(np.asarray, jtr.init_state(example).params)
    return jcfg, params


def _port_trainer(corpora, out, params, **kw):
    from csat_tpu_torch.convert import convert_params
    from csat_tpu_torch.train import Trainer

    tcfg = _tcfg(corpora, out, **kw)
    tr = Trainer(tcfg, log=lambda m: None, device="cpu")
    tr.initial_params = convert_params(params, tr.model)
    return tcfg, tr


# ---------------------------------------------------------------------------
# (a) greedy decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucketing", [False, True], ids=["fixed", "bucketed"])
def test_greedy_decode_tokens_identical_to_jax(corpora, jax_init, tmp_path, bucketing):
    from csat_tpu.train.loop import _decode_dataset as jdecode
    from csat_tpu.train import Trainer as JTrainer
    from csat_tpu_torch.train.loop import _decode_dataset as tdecode

    jcfg, params = jax_init
    jcfg = jcfg.replace(bucketing=bucketing, bucket_src_lens=(20, 28) if bucketing else ())
    jtr = JTrainer(jcfg, log=lambda m: None)
    _, jdev = _datasets(jtr, jcfg, "jax")
    tcfg, ttr = _port_trainer(corpora, tmp_path, params, bucketing=bucketing,
                              bucket_src_lens=(20, 28) if bucketing else ())
    ttr.init_state()
    _, tdev = _datasets(ttr, tcfg, "torch")
    jparams = jax.tree.map(jnp.asarray, params)
    jout = list(jdecode(jtr.model, jparams, jdev, jcfg, jax.random.key(0), None))
    tout = list(tdecode(ttr.model, tdev, tcfg))
    assert len(jout) == len(tout) >= (2 if bucketing else 3)
    for (jy, jt), (ty, tt) in zip(jout, tout):
        np.testing.assert_array_equal(jt, tt)
        np.testing.assert_array_equal(np.asarray(jy), ty)
        assert ty.shape[1] == tcfg.max_tgt_len - 1
    assert sum(len(t) for _, t in tout) == 24


def test_early_eos_decode_keeps_prefix_to_first_eos(corpora, jax_init, tmp_path):
    from csat_tpu_torch.data.dataset import batch_to_device, iterate_batches
    from csat_tpu_torch.train import greedy_decode, greedy_decode_early_eos
    from csat_tpu_torch.utils import EOS, PAD

    _, params = jax_init
    tcfg, ttr = _port_trainer(corpora, tmp_path, params)
    ttr.init_state()
    with torch.no_grad():  # bias EOS so some rows stop early
        ttr.model.generator.fc1.bias[EOS] += 0.15
    _, tdev = _datasets(ttr, tcfg, "torch")
    batch = batch_to_device(next(iterate_batches(tdev, 8, shuffle=False)), ttr.model.device)
    full = greedy_decode(ttr.model, batch).numpy()
    early = greedy_decode_early_eos(ttr.model, batch).numpy()
    seen_eos = 0
    for f, e in zip(full, early):
        stop = np.flatnonzero(f == EOS)
        upto = stop[0] + 1 if len(stop) else len(f)
        seen_eos += bool(len(stop))
        np.testing.assert_array_equal(f[:upto], e[:upto])
    assert seen_eos >= 1
    last_needed = max((np.flatnonzero(f == EOS)[0] if (f == EOS).any() else len(f) - 1)
                      for f in full)
    assert (early[:, last_needed + 1:] == PAD).all()


# ---------------------------------------------------------------------------
# (b) one epoch against the JAX trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_fit(corpora, jax_init, tmp_path_factory):
    """One epoch of the JAX ``Trainer`` from ``jax_init``'s weights, with the
    fixed hash-stream seeds: its per-step losses and its history."""
    from csat_tpu.train import Trainer as JTrainer

    jcfg, params = jax_init
    with pytest.MonkeyPatch.context() as mp:
        _fixed_seeds(mp)
        jtr = JTrainer(jcfg.replace(output_dir=str(tmp_path_factory.mktemp("j"))),
                       log=lambda m: None)
        jtr.initial_params = params
        jlosses = []
        cache = jtr.program_cache

        def recording(state, batch, **kw):
            state, metrics = cache(state, batch, **kw)
            jlosses.append(metrics["loss"])
            return state, metrics

        jtr.program_cache = recording
        _, jhist = jtr.fit(*_datasets(jtr, jtr.cfg, "jax"))
    return [float(x) for x in jlosses], jhist


@pytest.mark.parametrize("prefetch", [0, 2])
def test_fit_losses_and_bleu_match_jax(corpora, jax_init, jax_fit, tmp_path, monkeypatch,
                                       prefetch):
    _fixed_seeds(monkeypatch)
    _, params = jax_init
    jlosses, jhist = jax_fit
    tcfg, ttr = _port_trainer(corpora, tmp_path / "t", params, prefetch=prefetch)
    state, thist = ttr.fit(*_datasets(ttr, tcfg, "torch"))
    tlosses = [r["loss"] for r in thist["steps"]]
    assert len(tlosses) == len(jlosses) == 12 and state.step == 12
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-4, rtol=0)
    assert abs(thist["loss"][0] - jhist["loss"][0]) <= 1e-4
    assert tlosses[-1] < tlosses[0]
    (jep, jbleu), (tep, tbleu) = jhist["val_bleu"][0], thist["val_bleu"][0]
    assert jep == tep == 1 and abs(jbleu - tbleu) <= 1e-6
    assert abs(thist["best_bleu"] - jhist["best_bleu"]) <= 1e-6
    assert all(r["shape"] == (8, 48, 9) for r in thist["steps"])


def test_prefetch_leaves_every_loss_bitwise_equal(corpora, jax_init, tmp_path):
    """The same bucketed 2-epoch fit with ``prefetch=0`` (the plain loop) and
    ``prefetch=2`` (the worker thread): every step's loss, every epoch's
    mean and the final parameters equal bit for bit."""
    runs = [_fit(corpora, tmp_path / f"p{depth}", jax_init[1], prefetch=depth)
            for depth in (0, 2)]
    (_, state_0, hist_0), (_, state_2, hist_2) = runs
    assert [r["loss"] for r in hist_0["steps"]] == [r["loss"] for r in hist_2["steps"]]
    assert [r["shape"] for r in hist_0["steps"]] == [r["shape"] for r in hist_2["steps"]]
    assert hist_0["loss"] == hist_2["loss"] and hist_0["val_bleu"] == hist_2["val_bleu"]
    for k in state_0.params:
        assert torch.equal(state_0.params[k], state_2.params[k]), k


# ---------------------------------------------------------------------------
# (c) checkpoints and resume, (d) guard rollback — the port alone
# ---------------------------------------------------------------------------

def _fit(corpora, out, params, num_epochs=2, resume=False, setup=None, **kw):
    from csat_tpu_torch.train.checkpoint import make_checkpoint_fn

    tcfg, tr = _port_trainer(corpora, out, params, num_epochs=num_epochs, bucketing=True,
                             bucket_src_lens=(20, 28), **kw)
    if setup:
        setup(tr)
    train_ds, dev_ds = _datasets(tr, tcfg, "torch")
    ck = make_checkpoint_fn(tr.output_dir, retries=2, backoff_s=0.0)
    state, hist = tr.fit(train_ds, dev_ds, checkpoint_fn=ck, resume=resume)
    return tr, state, hist


@pytest.fixture(scope="module")
def uninterrupted(corpora, jax_init, tmp_path_factory):
    out = tmp_path_factory.mktemp("run_a")
    tr, state, hist = _fit(corpora, out, jax_init[1])
    return out, tr, state, hist


def test_bucketed_fit_steps_several_shapes_and_saves(uninterrupted):
    out, tr, state, hist = uninterrupted
    assert len({r["shape"] for r in hist["steps"]}) >= 2
    assert len(hist["loss"]) == 2 and hist["loss"][1] < hist["loss"][0]
    assert [e for e, _ in hist["val_bleu"]] == [1, 2]
    ck = os.path.join(tr.output_dir, "checkpoints")
    assert sorted(os.listdir(ck)) == ["state_1.pt", "state_2.pt"]
    assert os.path.exists(os.path.join(tr.output_dir, "best_model.pt"))
    with open(os.path.join(tr.output_dir, "best.json")) as f:
        assert json.load(f)["bleu"] == hist["best_bleu"]


def test_checkpoint_round_trip_is_exact(uninterrupted, corpora, jax_init, tmp_path):
    from csat_tpu_torch.train.checkpoint import (
        latest_step, restore_latest, restore_params, save_state)

    out, tr, state, hist = uninterrupted
    save_state(str(tmp_path / "ck"), state, 7)
    assert latest_step(str(tmp_path / "ck")) == 7 and latest_step(str(tmp_path / "no")) is None
    _, other = _port_trainer(corpora, tmp_path / "o", jax_init[1], bucketing=True)
    fresh = other.init_state()
    fresh, step = restore_latest(str(tmp_path / "ck"), fresh)
    assert step == 7 and fresh.step == state.step and fresh.opt_state.count == state.opt_state.count
    for k in state.params:
        assert torch.equal(fresh.params[k], state.params[k]), k
        assert torch.equal(fresh.opt_state.mu[k], state.opt_state.mu[k]), k
        assert torch.equal(fresh.opt_state.nu[k], state.opt_state.nu[k]), k
    assert torch.equal(fresh.generator.get_state(), state.generator.get_state())
    best = restore_params(tr.output_dir)
    assert set(best) == set(state.params)
    for step_no in range(8, 12):  # only the three newest steps are kept
        save_state(str(tmp_path / "ck"), state, step_no)
    assert sorted(os.listdir(tmp_path / "ck")) == ["state_10.pt", "state_11.pt", "state_9.pt"]


def test_resume_from_epoch_checkpoint_reproduces_run(uninterrupted, corpora, jax_init,
                                                     tmp_path):
    out, tr_a, state_a, hist_a = uninterrupted
    # a run directory that holds only what existed after epoch 1
    rel = os.path.relpath(tr_a.output_dir, str(out))
    os.makedirs(tmp_path / rel / "checkpoints")
    shutil.copy(os.path.join(tr_a.output_dir, "checkpoints", "state_1.pt"),
                tmp_path / rel / "checkpoints" / "state_1.pt")
    tr_b, state_b, hist_b = _fit(corpora, tmp_path, jax_init[1], resume=True)
    want = [r for r in hist_a["steps"] if r["epoch"] == 2]
    got = hist_b["steps"]
    assert [(r["epoch"], r["it"], r["shape"]) for r in got] == \
        [(r["epoch"], r["it"], r["shape"]) for r in want]
    assert [r["loss"] for r in got] == [r["loss"] for r in want]
    assert hist_b["loss"] == hist_a["loss"][1:]
    for k in state_a.params:
        assert torch.equal(state_a.params[k], state_b.params[k]), k


def test_mid_epoch_stop_and_resume_reproduces_run(uninterrupted, corpora, jax_init, tmp_path):
    from csat_tpu_torch.train.checkpoint import Preempted, read_resume_marker

    _, _, state_a, hist_a = uninterrupted

    def stop_after_four(tr):
        def scale(global_step):
            if global_step == 3:   # asked during the 4th step: stop after it
                tr.request_stop()
            return None
        tr.loss_scale_fn = scale

    with pytest.raises(Preempted) as stop:
        _fit(corpora, tmp_path, jax_init[1], setup=stop_after_four)
    assert (stop.value.epoch, stop.value.iterations_done) == (1, 4)
    marker = read_resume_marker(stop.value.directory)
    assert marker["iterations_done"] == 4 and marker["plan"].startswith("bucketed-")
    tr_b, state_b, hist_b = _fit(corpora, tmp_path, jax_init[1], resume=True)
    want = hist_a["steps"][4:]
    assert [(r["epoch"], r["it"]) for r in hist_b["steps"]] == \
        [(r["epoch"], r["it"]) for r in want]
    assert [r["loss"] for r in hist_b["steps"]] == [r["loss"] for r in want]
    for k in state_a.params:
        assert torch.equal(state_a.params[k], state_b.params[k]), k
    # the marker addresses one batch plan: another plan is refused
    with pytest.raises(ValueError, match="batch plan"):
        for name in os.listdir(stop.value.directory):
            if name.startswith("state_"):  # boundary checkpoints: leave only the stop's
                os.remove(os.path.join(stop.value.directory, name))
        _fit(corpora, tmp_path, jax_init[1], resume=True, bucket_token_budget=100)


def test_planted_nan_triggers_one_rollback(corpora, jax_init, tmp_path):
    def plant(tr):
        tr.loss_scale_fn = lambda step: float("nan") if 2 <= step < 5 else None

    logs = []
    tr, state, hist = _fit(corpora, tmp_path, jax_init[1], num_epochs=1,
                           setup=lambda t: (plant(t), setattr(t, "log", logs.append)))
    assert hist["rollbacks"] == 1 and hist["nonfinite_steps"] == 3
    assert np.isfinite(hist["loss"][0])
    assert all(torch.isfinite(p).all() for p in state.params.values())
    assert any("rollback #1" in m for m in logs)
    # the replay ran the whole epoch again: attempts = 5 before + the epoch
    n_epoch = len({(r["epoch"], r["it"]) for r in hist["steps"]})
    assert len(hist["steps"]) == 5 + n_epoch and state.step == n_epoch


def test_exhausted_rollbacks_raise(corpora, jax_init, tmp_path):
    from csat_tpu_torch.resilience import TrainingDivergedError

    def plant(tr):
        tr.loss_scale_fn = lambda step: float("nan")

    with pytest.raises(TrainingDivergedError, match="consecutive non-finite"):
        _fit(corpora, tmp_path, jax_init[1], num_epochs=1, setup=plant, guard_max_rollbacks=1)


# ---------------------------------------------------------------------------
# (e) the expected-graph gradient of the whole model
# ---------------------------------------------------------------------------

def test_deterministic_forward_gradient_matches_jax(corpora, jax_init, tmp_path):
    from csat_tpu.data.dataset import iterate_batches as jiter
    from csat_tpu.train import Trainer as JTrainer
    from csat_tpu.train.loss import label_smoothing_loss as jloss
    from csat_tpu_torch.convert import convert_params
    from csat_tpu_torch.data.dataset import batch_to_device, iterate_batches as titer
    from csat_tpu_torch.train import label_smoothing_loss as tloss

    jcfg, params = jax_init
    jtr = JTrainer(jcfg, log=lambda m: None)
    jbatch = next(jiter(_datasets(jtr, jcfg, "jax")[0], 8, shuffle=False))

    def loss_fn(p):
        log_probs, sparsity, _, _, _ = jtr.model.apply({"params": p}, jbatch, deterministic=True)
        return jloss(log_probs, jbatch.target, jcfg.smoothing) + jcfg.sw * sparsity

    jval, jgrads = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, params))

    tcfg, ttr = _port_trainer(corpora, tmp_path, params)
    ttr.init_state()
    tbatch = batch_to_device(next(titer(_datasets(ttr, tcfg, "torch")[0], 8, shuffle=False)),
                             ttr.model.device)
    log_probs, sparsity = ttr.model(tbatch, deterministic=True)
    total = tloss(log_probs, tbatch.target, tcfg.smoothing) + tcfg.sw * sparsity
    total.backward()
    assert abs(float(total.detach()) - float(jval)) <= 1e-5
    want = convert_params(jax.device_get(jgrads), ttr.model)
    for name, p in ttr.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=3e-5, rtol=0,
                                   err_msg=name)
    clusters = ttr.model.encoder.blocks[0].attn.clusters.grad
    assert float(clusters.abs().max()) > 0  # the graph factors do get a gradient


# ---------------------------------------------------------------------------
# train state ↔ the JAX TrainState's parts
# ---------------------------------------------------------------------------

def test_train_state_converts_both_ways(corpora, jax_init, tmp_path):
    from csat_tpu_torch.convert import export_train_state, flatten, load_train_state

    _, params = jax_init
    _, ttr = _port_trainer(corpora, tmp_path, params)
    state = ttr.init_state()
    rng = np.random.default_rng(0)
    mu = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
    nu = jax.tree.map(lambda x: rng.random(x.shape).astype(np.float32), params)
    load_train_state(state, params, mu, nu, count=5, step=5)
    assert state.step == 5 and state.opt_state.count == 5
    back = export_train_state(state, params)
    assert back["count"] == 5 and back["step"] == 5
    for key, tree in (("params", params), ("mu", mu), ("nu", nu)):
        want, got = flatten(tree), flatten(back[key])
        assert set(want) == set(got)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path], err_msg=str(path))
    k = params["decoder"]["layer_0"]["self_attn"]["q"]["kernel"]
    assert torch.equal(state.params["decoder.layers.0.self_attn.q.weight"],
                       torch.from_numpy(k.T.copy()))


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _cli_args(corpora, out, *extra):
    sets = {**FIT, "output_dir": str(out)}
    args = ["--config", "python", "--data_dir", corpora[1], "--epochs", "1", "--bucketing"]
    for field, value in sets.items():
        args += ["--set", f"{field}={value!r}"]
    return args + list(extra)


def test_cli_trains_then_scores_on_the_cpu(corpora, tmp_path, capsys):
    from csat_tpu_torch.cli import main

    main(_cli_args(corpora, tmp_path, "--device", "cpu"))
    lines = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("epoch 1: loss=") and "val_bleu=" in line for line in lines)
    trained = json.loads(lines[-1])
    assert set(trained) == {"val_best_bleu", "bleu", "rouge_l", "meteor"}
    assert all(np.isfinite(v) for v in trained.values())
    run = tmp_path / "final_exp" / "default"
    found = {p.name for p in tmp_path.rglob("*") if p.is_file()}
    assert {"state_1.pt", "best_model.pt", "best.json"} <= found, (found, run)
    assert any(name.startswith("predict_results_bleu_") for name in found)

    main(_cli_args(corpora, tmp_path, "--device", "cpu", "--is_test"))
    scored = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert scored == {k: trained[k] for k in ("bleu", "rouge_l", "meteor")}


def test_cli_raises_without_a_gpu_unless_asked_for_the_cpu(corpora, tmp_path):
    from csat_tpu_torch.cli import main

    with pytest.raises(RuntimeError, match="(?i)cuda"):
        main(_cli_args(corpora, tmp_path))
    with pytest.raises(SystemExit):
        main(["--config", "nope", "--device", "cpu"])
