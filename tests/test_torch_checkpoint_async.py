"""Asynchronous epoch snapshots, the reference-shaped decode and the small
twins of this slice, against the JAX package's contracts:

* checkpoints (``train/checkpoint.py``): an async save and its barrier
  restore bit for bit what a synchronous save does; a background write
  fault is retried once, synchronously, from the retained host copy (the
  state mutated in place meanwhile), the ledger is cleared, and a second
  fault propagates; ``fn.wait`` of ``make_checkpoint_fn`` waits on its own
  directory only; a synchronous save, ``latest_step`` and ``restore_state``
  drain a pending async save first; the exit drain reports a failure with
  the directory's name and gives up on a wedged write past its bound; a
  ``Trainer.fit`` with the default hook writes its epoch files in the
  background and returns only once the newest equals its final state;
* ``greedy_decode_nocache`` equal to JAX's on converted weights (tokens
  exact) under ``eval_graph`` expected and sample (counter seeds handed to
  both), equal to the port's ``greedy_decode`` in every noise mode with the
  generator left where that leaves it, and ``(B, 0)`` at T ≤ 1;
* ``config_from_dict`` of every registry entry's JSON round trip equal to
  the config and to JAX's on their shared fields; ``sample_from_dataset``
  equal to JAX's and made of views; the CLI's ``--bucket_src_lens`` and
  ``--exp_type`` building the config JAX's command line builds."""

import dataclasses
import json
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import MICRO, SRC_V, TGT_V, configs, jax_model_and_params, torch_model
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state(seed=0):
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.train import create_train_state, default_optimizer

    cfg = get_config("python", **MICRO)
    model = CSATrans(cfg, SRC_V, TGT_V, device="cpu", seed=seed)
    state = create_train_state(model, default_optimizer(cfg), seed)
    with torch.no_grad():  # moments and count that are not all zeros
        for k, p in state.params.items():
            state.opt_state.mu[k].copy_(p * 0.5)
            state.opt_state.nu[k].copy_(p * p)
    state.opt_state.count, state.step = 7, 7
    torch.rand(3, generator=state.generator)
    return state


def _blob(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_blobs_equal(a, b):
    assert sorted(a) == sorted(b)
    for key in ("params", "mu", "nu"):
        assert sorted(a[key]) == sorted(b[key])
        for name in a[key]:
            assert a[key][name].dtype == b[key][name].dtype
            assert torch.equal(a[key][name], b[key][name]), (key, name)
    assert (a["step"], a["count"]) == (b["step"], b["count"])
    assert torch.equal(a["gen_state"], b["gen_state"])


@pytest.fixture
def writes(monkeypatch):
    """Every commit (``_atomic_save``) recorded as (file name, thread kind);
    ``plan`` maps a file name to a list of actions for its next commits,
    each a tuple of steps: ``"fail"`` raises, an ``Event`` is waited on, a
    number of seconds slept."""
    from csat_tpu_torch.train import checkpoint as ck

    inner, log, plan = ck._atomic_save, [], {}

    def commit(obj, path):
        name = os.path.basename(path)
        kind = "main" if threading.current_thread() is threading.main_thread() else "background"
        action = plan[name].pop(0) if plan.get(name) else ()
        for step in action:
            if isinstance(step, threading.Event):
                assert step.wait(30)
            elif isinstance(step, float):
                time.sleep(step)
        log.append((name, kind, "failed" if "fail" in action else "written"))
        if "fail" in action:
            raise OSError(f"injected commit failure of {name}")
        return inner(obj, path)

    monkeypatch.setattr(ck, "_atomic_save", commit)
    yield log, plan
    ck._PENDING_SAVES.clear()


def test_async_save_restores_like_a_sync_save(tmp_path, writes):
    from csat_tpu_torch.train import checkpoint as ck

    state = _state()
    ck.save_state_async(str(tmp_path / "a"), state, 3)
    ck.wait_for_saves(str(tmp_path / "a"))
    ck.save_state(str(tmp_path / "s"), state, 3)
    _assert_blobs_equal(_blob(tmp_path / "a" / "state_3.pt"), _blob(tmp_path / "s" / "state_3.pt"))
    log, _ = writes
    assert log == [("state_3.pt", "background", "written"), ("state_3.pt", "main", "written")]
    fresh = _state(seed=1)
    ck.restore_state(str(tmp_path / "a"), fresh)
    for k, p in state.params.items():
        assert torch.equal(fresh.params[k], p)
        assert torch.equal(fresh.opt_state.nu[k], state.opt_state.nu[k])
    assert fresh.step == 7 and fresh.opt_state.count == 7
    assert torch.equal(fresh.generator.get_state(), state.generator.get_state())
    assert not ck._PENDING_SAVES


def test_background_fault_retried_once_from_the_host_copy(tmp_path, writes, capsys):
    from csat_tpu_torch.resilience.guards import host_snapshot
    from csat_tpu_torch.train import checkpoint as ck

    log, plan = writes
    state, d = _state(), str(tmp_path / "ck")
    before = host_snapshot(state)
    gate = threading.Event()
    plan["state_1.pt"] = [(gate, "fail")]
    ck.save_state_async(d, state, 1)
    with torch.no_grad():  # the next epoch updates the state in place
        for p in state.params.values():
            p.add_(1.0)
    gate.set()
    ck.wait_for_saves(d)
    assert log == [("state_1.pt", "background", "failed"), ("state_1.pt", "main", "written")]
    assert not ck._PENDING_SAVES
    blob = _blob(os.path.join(d, "state_1.pt"))
    assert all(torch.equal(blob["params"][k], t) for k, t in before.params.items())
    err = capsys.readouterr().err
    assert "retrying synchronously from the retained host copy" in err and d in err
    # a second fault (the retry fails too) propagates from the barrier
    log.clear()
    plan["state_2.pt"] = [("fail",), ("fail",)]
    ck.save_state_async(d, state, 2)
    with pytest.raises(OSError, match="state_2.pt"):
        ck.wait_for_saves(d)
    assert log == [("state_2.pt", "background", "failed"), ("state_2.pt", "main", "failed")]
    assert ck.latest_step(d) == 1


def test_the_next_async_save_confirms_the_previous_first(tmp_path, writes):
    from csat_tpu_torch.train import checkpoint as ck

    log, plan = writes
    state, d = _state(), str(tmp_path / "ck")
    plan["state_1.pt"] = [("fail",)]
    ck.save_state_async(d, state, 1)
    ck.save_state_async(d, state, 2)  # recovers step 1 before submitting 2
    assert log[:2] == [("state_1.pt", "background", "failed"), ("state_1.pt", "main", "written")]
    ck.wait_for_saves()
    assert ck.latest_step(d) == 2 and sorted(os.listdir(d)) == ["state_1.pt", "state_2.pt"]
    for step in (3, 4, 5):
        ck.save_state_async(d, state, step)
    ck.wait_for_saves(d)
    assert sorted(os.listdir(d)) == ["state_3.pt", "state_4.pt", "state_5.pt"]  # keep 3


def test_fn_wait_waits_only_on_its_own_directory(tmp_path, writes):
    from csat_tpu_torch.train import checkpoint as ck

    log, plan = writes
    state = _state()
    fa = ck.make_checkpoint_fn(str(tmp_path / "a"))
    fb = ck.make_checkpoint_fn(str(tmp_path / "b"))
    gate = threading.Event()
    plan["state_2.pt"] = [(gate,)]
    fa(state, 1)
    fb(state, 2)
    fa.wait()
    assert ck.latest_step(fa.directory) == 1
    assert ("state_2.pt", "background", "written") not in log
    assert os.path.abspath(fb.directory) in ck._PENDING_SAVES
    gate.set()
    fb.wait()
    assert ("state_2.pt", "background", "written") in log and not ck._PENDING_SAVES


@pytest.mark.parametrize("sync_op", ["save_state", "latest_step", "restore_state"])
def test_sync_operations_drain_a_pending_async_save(tmp_path, writes, sync_op):
    from csat_tpu_torch.train import checkpoint as ck

    log, plan = writes
    state, d = _state(), str(tmp_path / "ck")
    gate = threading.Event()
    plan["state_1.pt"] = [(gate,)]
    ck.save_state_async(d, state, 1)
    threading.Timer(0.2, gate.set).start()
    if sync_op == "save_state":
        ck.save_state(d, state, 2)
        assert [name for name, _, _ in log] == ["state_1.pt", "state_2.pt"]
    elif sync_op == "latest_step":
        assert ck.latest_step(d) == 1
    else:
        ck.restore_state(d, _state(seed=1))
    assert gate.is_set() and ("state_1.pt", "background", "written") in log
    assert not ck._PENDING_SAVES


def test_exit_drain_reports_and_is_bounded(tmp_path, writes, capsys, monkeypatch):
    from csat_tpu_torch.train import checkpoint as ck

    _, plan = writes
    state = _state()
    bad = os.path.abspath(str(tmp_path / "bad"))
    plan["state_1.pt"] = [("fail",), ("fail",)]
    ck.save_state_async(bad, state, 1)
    ck._close_async(bad)
    err = capsys.readouterr().err
    assert f"async save to {bad} failed at exit: OSError" in err
    assert bad not in ck._WRITERS
    wedged = os.path.abspath(str(tmp_path / "wedged"))
    gate = threading.Event()
    plan["state_2.pt"] = [(gate,)]
    ck.save_state_async(wedged, state, 2)
    monkeypatch.setattr(ck, "_ATEXIT_DRAIN_S", 0.1)
    ck._close_async(wedged)
    assert f"async save to {wedged} still pending after 0s at exit" in capsys.readouterr().err
    gate.set()


def test_fit_with_the_default_hook_returns_durable_snapshots(tmp_path, writes):
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.dataset import ASTDataset
    from csat_tpu_torch.data.synthetic import make_corpus
    from csat_tpu_torch.resilience.guards import host_snapshot
    from csat_tpu_torch.train import Trainer
    from csat_tpu_torch.train import checkpoint as ck

    log, plan = writes
    data_dir = make_corpus(str(tmp_path / "corpus"), 32, 8, 8, seed=0, max_ast_len=48)
    cfg = get_config("python", data_dir=data_dir, output_dir=str(tmp_path / "out"),
                     num_epochs=2, save_interval=1, batch_size=8, **{
                         k: v for k, v in MICRO.items() if k not in ("bucket_src_lens",)})
    tr = Trainer(cfg, device="cpu", log=lambda m: None)
    train = ASTDataset(cfg, "train", tr.src_vocab, tr.tgt_vocab)
    fn = ck.make_checkpoint_fn(tr.output_dir)
    plan["state_2.pt"] = [(0.5,)]  # the last epoch's write still running at the loop's end
    state, hist = tr.fit(train, checkpoint_fn=fn)
    assert not ck._PENDING_SAVES
    assert log == [("state_1.pt", "background", "written"), ("state_2.pt", "background", "written")]
    blob, snap = _blob(os.path.join(fn.directory, "state_2.pt")), host_snapshot(state)
    _assert_blobs_equal(blob, snap._asdict())
    assert blob["step"] == len(hist["steps"]) > 0


# ---------------------------------------------------------------------------
# the reference-shaped decode
# ---------------------------------------------------------------------------

DECODE_SEEDS = (11, 12)  # the counter "sample" seed of SBM layers 0 and 1


def _hand_over_sample_seeds(monkeypatch):
    """Both packages' SBM layers draw ``DECODE_SEEDS`` by layer, every
    forward (one encoder forward draws one seed a layer)."""
    from csat_tpu.models import sbm as jsbm
    from csat_tpu_torch.models import sbm as tsbm

    calls = {"jax": 0, "torch": 0}

    def seed(pkg):
        i = calls[pkg] % len(DECODE_SEEDS)
        calls[pkg] += 1
        return DECODE_SEEDS[i]

    monkeypatch.setattr(jsbm, "draw_counter_seed",
                        lambda module, name: jnp.int32(seed("jax")))
    monkeypatch.setattr(tsbm, "draw_seed", lambda gen, name: torch.tensor(
        [seed("torch")], dtype=torch.int32))


def _batches(jcfg, tcfg, n=6, seed=0):
    from csat_tpu.data.dataset import collate as jcollate
    from csat_tpu_torch.data.dataset import batch_to_device, collate as tcollate
    from csat_tpu_torch.data.synthetic import random_ast, train_sample

    rng = np.random.default_rng(seed)
    samples = [train_sample(random_ast(rng, int(k)), tcfg, SRC_V, TGT_V, rng)
               for k in rng.integers(5, tcfg.max_src_len + 1, n)]
    arrs = {key: np.stack([s[key] for s in samples]) for key in samples[0]}
    return (jcollate(arrs, jcfg.max_src_len),
            batch_to_device(tcollate(arrs, tcfg.max_src_len), torch.device("cpu")))


@pytest.mark.parametrize("eval_graph", ["expected", "sample"])
def test_nocache_decode_equals_jax_and_cached(eval_graph, monkeypatch):
    from csat_tpu.train.decode import greedy_decode_nocache as jnocache
    from csat_tpu_torch.train.decode import greedy_decode, greedy_decode_nocache

    jcfg, tcfg = configs(sbm_layers=2, clusters=(4, 3), noise_mode="counter",
                         eval_graph=eval_graph)
    if eval_graph == "sample":
        _hand_over_sample_seeds(monkeypatch)
    jmodel, params = jax_model_and_params(jcfg)
    tmodel = torch_model(tcfg, params)
    jbatch, tbatch = _batches(jcfg, tcfg)
    want = np.asarray(jnocache(jmodel, {"params": jax.tree.map(jnp.asarray, params)}, jbatch,
                               jax.random.key(0)))
    got = greedy_decode_nocache(tmodel, tbatch, torch.Generator().manual_seed(0)).numpy()
    cached = greedy_decode(tmodel, tbatch, torch.Generator().manual_seed(0)).numpy()
    assert got.shape == want.shape == (6, tcfg.max_tgt_len - 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, cached)


@pytest.mark.parametrize("noise_mode", ["shared", "counter"])
def test_nocache_decode_equals_cached_under_a_generator(noise_mode):
    from csat_tpu_torch.train.decode import greedy_decode, greedy_decode_nocache

    jcfg, tcfg = configs(noise_mode=noise_mode, eval_graph="sample")
    tmodel = torch_model(tcfg, jax_model_and_params(jcfg)[1])
    _, tbatch = _batches(jcfg, tcfg, seed=1)
    ga, gb = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    got = greedy_decode_nocache(tmodel, tbatch, ga)
    np.testing.assert_array_equal(got.numpy(), greedy_decode(tmodel, tbatch, gb).numpy())
    assert torch.equal(ga.get_state(), gb.get_state())  # one encode's draws, as the cached


def test_nocache_decode_of_width_zero():
    from csat_tpu.train.decode import greedy_decode_nocache as jnocache
    from csat_tpu_torch.train.decode import greedy_decode_nocache

    jcfg, tcfg = configs()
    jbatch, tbatch = _batches(jcfg, tcfg, n=3)
    jbatch = jbatch._replace(tgt_seq=jbatch.tgt_seq[:, :0])
    tbatch = tbatch._replace(tgt_seq=tbatch.tgt_seq[:, :0])
    jmodel, params = jax_model_and_params(jcfg)
    want = jnocache(jmodel, {"params": params}, jbatch, jax.random.key(0))
    got = greedy_decode_nocache(torch_model(tcfg, params), tbatch)
    assert tuple(got.shape) == tuple(want.shape) == (3, 0)


# ---------------------------------------------------------------------------
# config_from_dict, sample_from_dataset, the CLI's flags
# ---------------------------------------------------------------------------

def _round_trip(cfg, extra=None):
    return json.loads(json.dumps({**dataclasses.asdict(cfg), **(extra or {})}))


@pytest.mark.parametrize("name", __import__("csat_tpu_torch.configs",
                                            fromlist=["list_configs"]).list_configs())
def test_config_from_dict_equals_jax(name):
    from csat_tpu.configs import config_from_dict as jfrom, get_config as jget
    from csat_tpu_torch.configs import config_from_dict, get_config

    over = dict(bucket_src_lens=(37, 75), slo_latency_s=(0.5, 2.0), calib_probes=("memory",))
    cfg = get_config(name, **over)
    back = config_from_dict(_round_trip(cfg, {"no_such_field": 1, "backend": "pallas"}))
    assert back == cfg and hash(back) == hash(cfg)
    jback = jfrom(_round_trip(jget(name, **over)))
    shared = [f.name for f in dataclasses.fields(back)]
    assert json.dumps({k: getattr(back, k) for k in shared}, sort_keys=True) == json.dumps(
        {k: getattr(jback, k) for k in shared}, sort_keys=True)


def test_config_from_dict_validates():
    from csat_tpu_torch.configs import config_from_dict, get_config

    d = _round_trip(get_config("python"))
    d["noise_mode"] = "neither"
    with pytest.raises((AssertionError, ValueError)):
        config_from_dict(d)


def test_sample_from_dataset_equals_jax(tmp_path):
    from csat_tpu.data.dataset import ASTDataset as JDS
    from csat_tpu.data.synthetic import make_corpus as jmake
    from csat_tpu.data.vocab import load_vocab as jload
    from csat_tpu.serve.ingest import sample_from_dataset as jsample
    from csat_tpu_torch.data.dataset import ASTDataset as TDS
    from csat_tpu_torch.data.synthetic import make_corpus as tmake
    from csat_tpu_torch.data.vocab import load_vocab as tload
    from csat_tpu_torch.serve.ingest import sample_from_dataset, validate_sample

    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jmake(jdir, 16, 4, 4, seed=2, max_ast_len=48)
    tmake(tdir, 16, 4, 4, seed=2, max_ast_len=48)
    jcfg, tcfg = configs(data_dir=jdir)[0], configs(data_dir=tdir)[1]
    jds = JDS(jcfg, "dev", *jload(jdir), use_cache=False)
    tds = TDS(tcfg, "dev", *tload(tdir), use_cache=False)
    for i in range(len(tds)):
        got, want = sample_from_dataset(tds, i), jsample(jds, i)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
            if key != "num_node":  # a row of each array is a view, no copy
                assert np.shares_memory(got[key], tds.arrays[key])
        validate_sample(got, tcfg)


def test_cli_bucket_src_lens_builds_jax_config(monkeypatch):
    import csat_tpu.cli as jcli
    import csat_tpu.configs as jconfigs
    import csat_tpu.utils.cache as jcache
    from csat_tpu_torch import cli

    argv = ["--config", "python", "--bucketing", "--bucket_src_lens", "37,75", "--exp_type",
            "summary", "--epochs", "3", "--data_dir", "/nonexistent"]
    got = {}

    class Built(Exception):
        pass

    def jget(name, **overrides):
        got["jax"] = jconfigs._REGISTRY[name].replace(**overrides)
        raise Built

    monkeypatch.setattr(jconfigs, "get_config", jget)
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a, **kw: None)
    monkeypatch.setattr(sys, "argv", ["csat_tpu.cli", *argv])
    with pytest.raises(Built):
        jcli._train_main()
    monkeypatch.setattr(cli, "_run", lambda args, cfg, device, primary: got.update(torch=cfg))
    cli.main(argv)
    tcfg, jcfg = got["torch"], got["jax"]
    assert tcfg.bucket_src_lens == jcfg.bucket_src_lens == (37, 75) and tcfg.bucketing
    shared = [f.name for f in dataclasses.fields(tcfg)]
    assert {k: getattr(tcfg, k) for k in shared} == {k: getattr(jcfg, k) for k in shared}
    with pytest.raises(SystemExit):
        cli.main(["--config", "python", "--exp_type", "translation"])
