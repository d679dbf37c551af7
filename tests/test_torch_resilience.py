"""Fault drills on the port's trainer, on the CPU at micro widths: the twins
of the train-side drills of ``tests/test_resilience.py`` and of
``tests/test_checkpoint.py::test_sigterm_preemption_resume_bit_identical``,
each fault planted by the port's ``FaultInjector`` and each recovery held
exactly (no tolerance: counts, bit patterns, equal losses):

* the device-side guard: a NaN step leaves every parameter and moment
  bitwise as it was, a spike trips the grad-norm leg, and a finite guarded
  step is bitwise the unguarded update's (the update as it was before the
  guard moved onto the device);
* rollback after K bad steps, rollbacks exhausted, the step-granular
  snapshot's narrowed replay;
* the step watchdog: unit trip and disarm, the device-probe leg despite
  host beats, a hung step in a fit with its post-mortem;
* checkpoint saves under retry; the data error budget, also through the
  prefetch thread, on the same chunks as the JAX package's iterators;
* preemption: the handler's flag and restore, the resume marker, a real
  SIGTERM mid-fit and a resume bit for bit, and the command line exiting 75
  in a subprocess;
* the prefetch pipeline: the same batches as the plain loop, worker
  errors re-raised, the worker stopped when the consumer leaves.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from csat_tpu_torch.data.dataset import ASTDataset, batch_to_device, iterate_batches
from csat_tpu_torch.resilience import (
    CorruptBatchError, DataErrorBudgetExceeded, ErrorBudget, FaultInjector, Preempted,
    PreemptionHandler, StepWatchdog, TrainingDivergedError, device_liveness_probe, retry)
from csat_tpu_torch.train import Trainer, create_train_state, default_optimizer, make_train_step
from csat_tpu_torch.train.checkpoint import make_checkpoint_fn
from csat_tpu_torch.train.loop import prefetch_batches
from csat_tpu_torch.train.state import make_model

from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MICRO = dict(pe_dim=8, pegen_dim=16, sbm_enc_dim=32, hidden_size=32, num_heads=2, num_layers=1,
             sbm_layers=1, clusters=(4,), dim_feed_forward=64, decoder_layers=2,
             max_src_len=48, max_tgt_len=10, batch_size=8, dropout=0.1, attention_dropout=0.0,
             tree_pos_width=4, tree_pos_height=8, full_att=True, num_epochs=1, val_interval=99,
             save_interval=99)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def port_corpus(tmp_path_factory):
    from csat_tpu_torch.data.synthetic import make_corpus

    data_dir = str(tmp_path_factory.mktemp("port_corpus"))
    make_corpus(data_dir, n_train=96, n_dev=24, n_test=24, seed=0)
    return data_dir


def _cfg(data_dir, out, **kw):
    from csat_tpu_torch.configs import get_config

    return get_config("python", data_dir=data_dir, output_dir=str(out), **{**MICRO, **kw})


def _trainer(cfg):
    tr = Trainer(cfg, log=lambda s: None, device="cpu")
    return tr, ASTDataset(cfg, "train", tr.src_vocab, tr.tgt_vocab)


@pytest.fixture(scope="module")
def rig(port_corpus, tmp_path_factory):
    """One Trainer reused across drills: 12 batches an epoch (96 samples /
    batch 8); rollback threshold 2 so two injected bad steps trigger it; the
    watchdog on with a no-op abort (tests swap in a recorder)."""
    cfg = _cfg(port_corpus, tmp_path_factory.mktemp("resilience_rig"),
               guard_rollback_after=2, guard_max_rollbacks=2, guard_check_every=1,
               data_error_budget=2, watchdog_timeout_s=2.0)
    trainer, ds = _trainer(cfg)
    trainer.watchdog_on_timeout = lambda: None
    return cfg, trainer, ds


def _bits(t):
    """A tensor's bit pattern (so -0.0 ≠ 0.0 and NaN payloads count)."""
    return t.detach().reshape(-1).view(torch.int32)


def _assert_bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(_bits(a[k]), _bits(b[k])), k


def _snapshot(state):
    return ({k: p.detach().clone() for k, p in state.params.items()},
            {k: t.clone() for k, t in state.opt_state.mu.items()},
            {k: t.clone() for k, t in state.opt_state.nu.items()})


# ---------------------------------------------------------------------------
# the in-step non-finite guard, on the device side
# ---------------------------------------------------------------------------

def test_nonfinite_step_skipped_params_unchanged(rig):
    """A NaN loss skips the update (params and moments bit-unchanged), sets
    the nonfinite flag and raises the consecutive-bad counter; a huge finite
    spike trips the grad-norm leg; a good step resets the counter and
    updates."""
    cfg, trainer, ds = rig
    batch = batch_to_device(next(iterate_batches(ds, cfg.batch_size, shuffle=False)), CPU)
    state = create_train_state(trainer.model, trainer.optimizer, seed=0)
    step = trainer.train_step
    state, m = step(state, batch)  # one good step, so the moments are not all zero
    p0, mu0, nu0 = _snapshot(state)

    state, m = step(state, batch, bad_steps=m["bad_steps"], loss_scale=float("nan"))
    assert isinstance(m["nonfinite"], torch.Tensor) and m["bad_steps"].dtype == torch.int32
    assert bool(m["nonfinite"]) and int(m["bad_steps"]) == 1
    assert state.step == 2 and int(state.opt_state.count) == 1  # attempts count; updates don't
    _assert_bitwise(state.params, p0)
    _assert_bitwise(state.opt_state.mu, mu0)
    _assert_bitwise(state.opt_state.nu, nu0)

    state, m = step(state, batch, bad_steps=m["bad_steps"], loss_scale=float("nan"))
    assert int(m["bad_steps"]) == 2
    _assert_bitwise(state.params, p0)

    # spike: the total stays finite but the squared grad-norm overflows
    state, m = step(state, batch, bad_steps=m["bad_steps"], loss_scale=1e30)
    assert bool(m["nonfinite"]) and int(m["bad_steps"]) == 3
    assert np.isfinite(float(m["total"])) and np.isinf(float(m["grad_norm"]))
    _assert_bitwise(state.params, p0)
    _assert_bitwise(state.opt_state.mu, mu0)

    state, m = step(state, batch, bad_steps=m["bad_steps"])
    assert not bool(m["nonfinite"]) and int(m["bad_steps"]) == 0
    assert int(state.opt_state.count) == 2
    assert any(not torch.equal(state.params[k], p0[k]) for k in p0), "good step did not update"


def test_guarded_step_is_bitwise_the_unguarded_update(port_corpus, tmp_path):
    """Two steps of the same model, batch and seed with the guard on and
    off: parameters and both moments bit for bit equal — the guarded
    update's selects change no bit of a finite step."""
    cfg = _cfg(port_corpus, tmp_path, full_att=False, sbm_layers=1, noise_mode="counter")
    tr, ds = _trainer(cfg)
    batch = batch_to_device(next(iterate_batches(ds, cfg.batch_size, shuffle=False)), CPU)
    runs = []
    for guard in (True, False):
        c = cfg.replace(nonfinite_guard=guard)
        model = make_model(c, tr.src_vocab.size(), tr.tgt_vocab.size(), device="cpu", seed=3)
        opt = default_optimizer(c)
        state = create_train_state(model, opt, seed=5)
        step = make_train_step(model, opt, c)
        for _ in range(2):
            state, metrics = step(state, batch)
        assert ("nonfinite" in metrics) == guard
        runs.append(_snapshot(state))
    for guarded, plain in zip(*runs):
        _assert_bitwise(guarded, plain)


def test_guard_makes_no_host_read(rig):
    """``guarded_apply`` converts no tensor to a Python value: inside it,
    every ``bool``/``int``/``float``/``item``/``tolist`` of a tensor raises."""
    from csat_tpu_torch.resilience import guards

    cfg, trainer, ds = rig
    batch = batch_to_device(next(iterate_batches(ds, cfg.batch_size, shuffle=False)), CPU)
    state = create_train_state(trainer.model, trainer.optimizer, seed=0)
    inner = guards.guarded_apply

    def refuse(name):
        def read(self, *args):
            raise AssertionError(f"host read in guarded_apply: Tensor.{name}")
        return read

    def watched(*args, **kw):
        with pytest.MonkeyPatch.context() as mp:
            for name in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist"):
                mp.setattr(torch.Tensor, name, refuse(name))
            return inner(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("csat_tpu_torch.train.loop.guarded_apply", watched)
        step = make_train_step(trainer.model, trainer.optimizer, cfg)
        for scale in (float("nan"), 1.0):
            state, m = step(state, batch, bad_steps=m["bad_steps"] if scale == 1.0 else 0,
                            loss_scale=scale)
    assert int(m["bad_steps"]) == 0 and not bool(m["nonfinite"])


def test_rollback_after_k_consecutive_and_quarantine(rig):
    """K=2 consecutive NaN steps roll the state back to the epoch-start
    snapshot and replay the epoch; a corrupt batch in the same run is
    quarantined under the error budget; the fit ends finite, with a
    post-mortem timeline of cause and reaction."""
    from csat_tpu_torch.obs import EventRecorder

    cfg, trainer, ds = rig
    trainer.fault_injector = FaultInjector(nan_loss_steps=(4, 5), corrupt_batches=(1,))
    try:
        state, hist = trainer.fit(ds, None)
    finally:
        trainer.fault_injector = None
    assert hist["rollbacks"] == 1
    assert hist["nonfinite_steps"] == 2
    assert hist["quarantined"] == 1
    assert np.isfinite(hist["loss"][0])
    pm = os.path.join(trainer.output_dir, "postmortem", "postmortem_train_rollback.jsonl")
    _, events = EventRecorder.load(pm)
    names = [e["name"] for e in events]
    assert "fault.injected.nan_loss" in names and "fault.injected.corrupt_batch" in names
    assert "fault.nan_guard" in names and "fault.rollback" in names
    snap = trainer.registry.snapshot()
    assert snap["train_rollbacks_total"] >= 1 and snap["train_nonfinite_steps_total"] >= 2
    # first attempt: 11 batches (1 quarantined), NaN at attempts 5-6 →
    # rollback to the step-0 snapshot; the replay's 12 batches are clean
    assert state.step == 12


def test_rollback_budget_exhausted_raises(rig):
    cfg, trainer, ds = rig
    trainer.fault_injector = FaultInjector(nan_loss_steps=range(64))
    try:
        with pytest.raises(TrainingDivergedError):
            trainer.fit(ds, None)
    finally:
        trainer.fault_injector = None
    assert os.path.exists(os.path.join(trainer.output_dir, "postmortem",
                                       "postmortem_train_diverged.jsonl"))


def test_step_granular_snapshot_narrows_replay_window(port_corpus, tmp_path):
    """``snapshot_every_steps=4``: the anchor refreshes at the guard-check
    cadence and a rollback replays only the window since the last good
    snapshot.  The tripwire: a spike planted at global step 18 would fire
    under whole-epoch replay (8 + 12 attempts) but is never reached under the
    narrowed one (8 + 8).  Also a healthy run with the device probe on."""
    cfg = _cfg(port_corpus, tmp_path, guard_rollback_after=2, guard_max_rollbacks=2,
               guard_check_every=1, snapshot_every_steps=4, watchdog_timeout_s=30.0,
               watchdog_device_probe=True)
    trainer, ds = _trainer(cfg)
    tripped = threading.Event()
    trainer.watchdog_on_timeout = tripped.set
    trainer.fault_injector = FaultInjector(nan_loss_steps=(6, 7), spike_steps=(18,))
    state, hist = trainer.fit(ds, None)
    assert hist["rollbacks"] == 1
    assert hist["nonfinite_steps"] == 2      # step 18 never ran
    assert hist["step_snapshots"] == 3       # at it_done 4, then 8 and 12 in the replay
    assert state.step == 12
    assert np.isfinite(hist["loss"][0])
    assert not tripped.is_set()


# ---------------------------------------------------------------------------
# step watchdog
# ---------------------------------------------------------------------------

def test_watchdog_unit_trip_and_disarm(tmp_path):
    ev = threading.Event()
    diag = str(tmp_path / "wd" / "diag.txt")
    with StepWatchdog(0.3, on_timeout=ev.set, diag_path=diag, log=lambda m: None) as wd:
        wd.beat()
        assert ev.wait(10.0), "watchdog did not trip on a stalled beat"
        assert wd.tripped
    assert os.path.exists(diag)

    ev2 = threading.Event()
    with StepWatchdog(0.3, on_timeout=ev2.set, log=lambda m: None) as wd2:
        wd2.beat()
        wd2.disarm()
        assert not ev2.wait(0.8), "disarmed watchdog tripped"


def test_device_liveness_probe_completes():
    probe = device_liveness_probe("cpu")
    probe()
    probe()


def test_watchdog_device_probe_leg_trips_despite_beats():
    """Host beats keep arriving while the probe stops completing: the
    probe-staleness leg trips anyway; a healthy probe under the same beat
    pattern does not."""
    ev = threading.Event()
    release = threading.Event()
    with StepWatchdog(0.4, on_timeout=ev.set, log=lambda m: None,
                      probe=lambda: release.wait(60), probe_interval_s=0.05) as wd:
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not ev.is_set():
            wd.beat()
            time.sleep(0.05)
        release.set()
        assert ev.is_set(), "stalled device probe did not trip the watchdog"
        assert wd.tripped

    ev2 = threading.Event()
    with StepWatchdog(2.0, on_timeout=ev2.set, log=lambda m: None,
                      probe=device_liveness_probe("cpu"), probe_interval_s=0.05) as wd2:
        end = time.monotonic() + 1.0
        while time.monotonic() < end:
            wd2.beat()
            time.sleep(0.05)
        assert not ev2.is_set(), "healthy probe tripped the watchdog"


def test_watchdog_trips_on_hung_step(rig):
    """A stall right after the first beat trips the watchdog within its
    timeout; training continues once the stall clears (the test's on_timeout
    records and ends the stall instead of aborting); the trip dumps a
    post-mortem that holds cause and effect."""
    from csat_tpu_torch.obs import EventRecorder

    cfg, trainer, ds = rig
    ev = threading.Event()
    trainer.watchdog_on_timeout = ev.set
    trainer.fault_injector = FaultInjector(hang_at_step=1, hang_seconds=60.0,
                                           sleep=lambda s: ev.wait(s))
    try:
        _, hist = trainer.fit(ds, None)
    finally:
        trainer.fault_injector = None
        trainer.watchdog_on_timeout = lambda: None
    assert ev.is_set(), "hung step did not trip the watchdog"
    assert os.path.exists(os.path.join(trainer.output_dir, "watchdog_diagnostics.txt"))
    assert np.isfinite(hist["loss"][0])
    pm = os.path.join(trainer.output_dir, "postmortem", "postmortem_train_watchdog.jsonl")
    _, events = EventRecorder.load(pm)
    names = [e["name"] for e in events]
    assert "fault.watchdog" in names and "fault.injected.hang" in names


def test_watchdog_default_action_exits_76(tmp_path):
    code = ("import time\n"
            "from csat_tpu_torch.resilience import StepWatchdog\n"
            "wd = StepWatchdog(0.3, log=lambda m: None).start()\n"
            "wd.beat()\n"
            "time.sleep(30)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": repo}, cwd=repo)
    assert res.returncode == 76, res.stderr[-2000:]


# ---------------------------------------------------------------------------
# checkpoint save retry
# ---------------------------------------------------------------------------

def test_save_succeeds_under_retry(tmp_path):
    saved = []
    inj = FaultInjector(save_failures=2)
    fn = make_checkpoint_fn(str(tmp_path), retries=3, backoff_s=0.0,
                            save=lambda d, s, e: saved.append((d, e)), injector=inj)
    fn(object(), 7)
    assert inj.injected_saves_failed == 2
    assert saved == [(os.path.join(str(tmp_path), "checkpoints"), 7)]


def test_save_retry_bounded(tmp_path):
    inj = FaultInjector(save_failures=5)
    fn = make_checkpoint_fn(str(tmp_path), retries=2, backoff_s=0.0,
                            save=inj.flaky_save(lambda d, s, e: None))
    with pytest.raises(IOError):
        fn(object(), 1)
    assert inj.injected_saves_failed == 2  # bounded: 2 attempts, not 5


def test_retry_helper_backoff_sequence():
    delays = []
    attempts = {"n": 0}

    def flaky():
        attempts["n"] += 1
        if attempts["n"] < 3:
            raise OSError("transient")
        return "done"

    assert retry(flaky, attempts=4, backoff_s=0.1, log=lambda m: None,
                 sleep=delays.append) == "done"
    assert delays == [0.1, 0.2]  # exponential, bounded by success


# ---------------------------------------------------------------------------
# data-pipeline quarantine
# ---------------------------------------------------------------------------

def test_error_budget_exhaustion_fails_loud(rig):
    cfg, trainer, ds = rig
    inj = FaultInjector(corrupt_batches=(0, 1))
    budget = ErrorBudget(1, log=lambda m: None)
    it = iterate_batches(ds, cfg.batch_size, shuffle=False, batch_hook=inj.batch_hook,
                         on_batch_error=budget)
    with pytest.raises(DataErrorBudgetExceeded):
        list(it)
    assert budget.count == 1  # first corrupt batch quarantined, second fatal


def test_corrupt_batch_skipped_within_budget(rig):
    cfg, trainer, ds = rig
    inj = FaultInjector(corrupt_batches=(2,))
    budget = ErrorBudget(2, log=lambda m: None)
    batches = list(iterate_batches(ds, cfg.batch_size, shuffle=False,
                                   batch_hook=inj.batch_hook, on_batch_error=budget))
    assert len(batches) == 11  # 12 minus the quarantined one
    assert budget.count == 1 and budget.quarantined[0] == list(range(16, 24))


def test_corrupt_error_without_handler_propagates(rig):
    cfg, trainer, ds = rig
    inj = FaultInjector(corrupt_batches=(0,))
    with pytest.raises(CorruptBatchError):
        list(iterate_batches(ds, cfg.batch_size, shuffle=False, batch_hook=inj.batch_hook))


@pytest.mark.parametrize("bucketing", [False, True], ids=["fixed", "bucketed"])
def test_quarantine_through_prefetch_matches_jax_chunks(rig, synthetic_corpus, micro_config,
                                                        bucketing):
    """Two corrupt batches under a budget of 2 go through the prefetch thread:
    both quarantined, on the chunks JAX's iterator quarantines from the same
    plan, and every other batch arrives; a third exhausts the budget and the
    worker's ``DataErrorBudgetExceeded`` reaches the consumer."""
    from csat_tpu.data.bucketing import iterate_bucketed_batches as jax_bucketed
    from csat_tpu.data.dataset import ASTDataset as JaxDataset
    from csat_tpu.data.dataset import iterate_batches as jax_batches
    from csat_tpu.data.vocab import load_vocab as jax_load_vocab
    from csat_tpu.resilience import ErrorBudget as JaxBudget
    from csat_tpu.resilience import FaultInjector as JaxInjector
    from csat_tpu_torch.data.bucketing import iterate_bucketed_batches

    cfg, trainer, ds = rig
    cfg = cfg.replace(bucketing=bucketing, bucket_src_lens=(24, 48) if bucketing else ())
    jcfg = micro_config.replace(data_dir=synthetic_corpus, bucketing=bucketing,
                                bucket_src_lens=cfg.bucket_src_lens)
    jds = JaxDataset(jcfg, "train", *jax_load_vocab(synthetic_corpus))

    def port_iter(**hooks):
        if bucketing:
            return iterate_bucketed_batches(ds, cfg, shuffle=True, seed=7, **hooks)
        return iterate_batches(ds, cfg.batch_size, shuffle=True, seed=7, **hooks)

    def jax_iter(**hooks):
        if bucketing:
            return jax_bucketed(jds, jcfg, shuffle=True, seed=7, **hooks)
        return jax_batches(jds, jcfg.batch_size, shuffle=True, seed=7, **hooks)

    n_all = len(list(port_iter()))
    inj, budget = FaultInjector(corrupt_batches=(1, 4)), ErrorBudget(2, log=lambda m: None)
    got = list(prefetch_batches(port_iter(batch_hook=inj.batch_hook, on_batch_error=budget),
                                CPU, depth=2))
    jinj, jbudget = JaxInjector(corrupt_batches=(1, 4)), JaxBudget(2, log=lambda m: None)
    jgot = list(jax_iter(batch_hook=jinj.batch_hook, on_batch_error=jbudget))
    assert budget.count == 2 and budget.quarantined == jbudget.quarantined
    assert len(got) == len(jgot) == n_all - 2

    inj, budget = FaultInjector(corrupt_batches=(0, 1, 2)), ErrorBudget(2, log=lambda m: None)
    with pytest.raises(DataErrorBudgetExceeded):
        list(prefetch_batches(port_iter(batch_hook=inj.batch_hook, on_batch_error=budget),
                              CPU, depth=2))
    assert budget.count == 2


# ---------------------------------------------------------------------------
# the prefetch pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetch_yields_the_plain_loops_batches(rig, depth):
    cfg, trainer, ds = rig
    plain = [batch_to_device(b, CPU) for b in iterate_batches(ds, 8, shuffle=True, seed=3)]
    got = list(prefetch_batches(iterate_batches(ds, 8, shuffle=True, seed=3), CPU, depth))
    assert len(got) == len(plain) == 12
    for a, b in zip(got, plain):
        for x, y in zip(a, b):
            if isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype and torch.equal(x, y)
            else:
                np.testing.assert_array_equal(x, y)


def test_prefetch_under_thread_switching_stress(rig):
    """More pipelines than cores, each a consumer thread and a worker, with
    the interpreter switching threads every microsecond: every consumer gets
    its plain loop's batches, in order."""
    cfg, trainer, ds = rig
    want = [b.src_seq.copy() for b in iterate_batches(ds, 8, shuffle=True, seed=5)]
    results = {}

    def consume(i):
        results[i] = [np.asarray(b.src_seq) for b in prefetch_batches(
            iterate_batches(ds, 8, shuffle=True, seed=5), CPU, depth=1 + i % 3)]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consume, args=(i,)) for i in range(2 * os.cpu_count())]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == len(threads)
    for got in results.values():
        assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


def test_prefetch_stops_its_worker_when_abandoned(rig):
    cfg, trainer, ds = rig
    before = {t.ident for t in threading.enumerate() if t.name == "prefetch"}
    feed = prefetch_batches(iterate_batches(ds, 8, shuffle=False), CPU, depth=2)
    next(feed)
    feed.close()
    alive = [t for t in threading.enumerate() if t.name == "prefetch" and t.ident not in before]
    assert alive == []

    def broken():
        yield next(iterate_batches(ds, 8, shuffle=False))
        raise CorruptBatchError("boom")

    feed = prefetch_batches(broken(), CPU, depth=2)
    next(feed)
    with pytest.raises(CorruptBatchError, match="boom"):
        next(feed)


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

def test_preemption_handler_flag_and_restore():
    h = PreemptionHandler()
    before = signal.getsignal(signal.SIGTERM)
    with h.installed((signal.SIGTERM,)):
        assert not h.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(1000):
            if h.triggered:
                break
        assert h.triggered
    assert signal.getsignal(signal.SIGTERM) is before


def test_resume_marker_roundtrip_and_stale_rejection(tmp_path):
    from csat_tpu_torch.resilience.preemption import (
        read_resume_marker, snapshot_step, write_resume_marker)
    from csat_tpu_torch.train import checkpoint

    ck = str(tmp_path / "checkpoints")
    write_resume_marker(ck, epoch=3, iterations_done=5)
    # no snapshot on disk at the marker's step: stale, ignored
    assert read_resume_marker(ck) is None
    assert snapshot_step(3, 5) != snapshot_step(3, 6) != snapshot_step(4, 5)
    # the checkpoint module re-exports the marker helpers it used to hold
    assert checkpoint.read_resume_marker is read_resume_marker
    assert checkpoint.Preempted is Preempted


def test_sigterm_preemption_resume_bit_identical(port_corpus, tmp_path):
    """A real SIGTERM mid-epoch (global step 17 = epoch 2, iteration 6)
    triggers a final snapshot + resume marker; a fresh Trainer's
    ``fit(resume=True)`` continues bit for bit with the uninterrupted run:
    every later step's loss, the parameters, the moments and the generator."""
    from csat_tpu_torch.resilience.preemption import read_resume_marker

    cfg = _cfg(port_corpus, tmp_path / "run", num_epochs=3)
    tr_a, ds = _trainer(cfg)
    state_a, hist_a = tr_a.fit(ds, None)

    tr_b, _ = _trainer(cfg)
    tr_b.fault_injector = FaultInjector(preempt_at_step=17, deliver_signal=True)
    with pytest.raises(Preempted) as stop:
        tr_b.fit(ds, None)
    assert (stop.value.epoch, stop.value.iterations_done) == (2, 6)
    marker = read_resume_marker(os.path.join(tr_b.output_dir, "checkpoints"))
    assert marker is not None and marker["epoch"] == 2

    tr_c, _ = _trainer(cfg)
    state_c, hist_c = tr_c.fit(ds, None, resume=True)
    assert state_c.step == state_a.step == 36
    assert [r["loss"] for r in hist_c["steps"]] == [r["loss"] for r in hist_a["steps"][18:]]
    assert hist_c["loss"][-1] == hist_a["loss"][-1]
    for k in state_a.params:
        assert torch.equal(state_a.params[k], state_c.params[k]), k
        assert torch.equal(state_a.opt_state.mu[k], state_c.opt_state.mu[k]), k
    assert torch.equal(state_a.generator.get_state(), state_c.generator.get_state())


def test_cli_exits_75_on_sigterm_and_resumes(port_corpus, tmp_path, capsys):
    """The command line in a subprocess: a SIGTERM once ``scalars.jsonl``
    shows iteration 3 of epoch 1 makes it save, print the ``preempted`` line
    and exit 75; ``--resume`` then finishes the run from that snapshot."""
    from csat_tpu_torch.cli import main

    sets = {**MICRO, "output_dir": str(tmp_path), "scalar_log_every": 1}
    args = ["--config", "python", "--data_dir", port_corpus, "--epochs", "4", "--device", "cpu"]
    for field, value in sets.items():
        args += ["--set", f"{field}={value!r}"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # two threads: the child shares the test's cores with the other workers
    child = subprocess.Popen([sys.executable, "-m", "csat_tpu_torch.cli", *args], cwd=repo,
                             env={**os.environ, "PYTHONPATH": repo, "OMP_NUM_THREADS": "2"},
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def reached():
        for path in tmp_path.rglob("scalars.jsonl"):
            recs = [json.loads(line) for line in path.read_text().splitlines()[:-1]]
            if any(r.get("epoch") == 1 and r.get("it", -1) >= 3 for r in recs):
                return True
        return False

    try:
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline and child.poll() is None and not reached():
            time.sleep(0.01)
        child.send_signal(signal.SIGTERM)
        out, err = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
    assert child.returncode == 75, err[-3000:]
    stopped = json.loads(out.strip().splitlines()[-1])
    assert stopped["preempted"] is True and (stopped["epoch"], stopped["iterations_done"]) > (1, 3)
    assert os.path.isdir(os.path.join(stopped["resume_from"], "preempt"))

    main(args + ["--resume"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("resumed ") for line in lines)
    assert any(line.startswith("epoch 4: loss=") for line in lines)
    assert set(json.loads(lines[-1])) == {"val_best_bleu", "bleu", "rouge_l", "meteor"}


def test_config_resilience_fields_refuse_what_jax_refuses():
    from csat_tpu.configs import Config as JaxConfig
    from csat_tpu_torch.configs import Config

    for field, bad in (("watchdog_timeout_s", -1.0), ("data_error_budget", -1),
                       ("scalar_log_every", -1), ("obs_events", -1),
                       ("obs_metrics_every_s", 0.0)):
        for cls in (Config, JaxConfig):
            with pytest.raises(AssertionError):
                cls(**{field: bad}).validate()
    assert Config().prefetch == JaxConfig().prefetch == 2
