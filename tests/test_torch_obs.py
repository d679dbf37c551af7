"""The port's telemetry (``csat_tpu_torch/obs``) against the JAX package's
``obs``, and its wiring through the port's ``Trainer``, on the CPU:

* the Prometheus exposition, byte for byte the JAX registry's for the same
  calls (the golden text of ``tests/test_obs.py`` included), the registry's
  get-or-create and snapshot, the JSONL snapshot cadence;
* the flight recorder: bounded ring, totals that survive wraparound, rolling
  post-mortem dumps — a port dump loads with JAX's ``EventRecorder.load``
  and a JAX dump with the port's;
* the Chrome trace export: valid by both packages' ``validate_chrome_trace``,
  grouped by dot prefix;
* a micro ``Trainer.fit`` with a profiled epoch: phase spans, registry-backed
  history counters equal to the JAX trainer's on the same corpus (12 steps
  for 96 samples at batch 8), the ``scalar_log_every`` cadence, and a valid
  ``host_trace.json`` beside the ``torch.profiler`` trace.

Exact comparisons throughout: the tolerance is none.
"""

import json
import os

import numpy as np
import pytest

from csat_tpu_torch.obs import (
    EventRecorder, MetricsFile, MetricsRegistry, load_chrome_trace, to_chrome_events,
    validate_chrome_trace, write_chrome_trace)

from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MICRO = dict(pe_dim=8, pegen_dim=16, sbm_enc_dim=32, hidden_size=32, num_heads=2, num_layers=1,
             sbm_layers=1, clusters=(4,), dim_feed_forward=64, decoder_layers=2,
             max_src_len=48, max_tgt_len=10, batch_size=8, dropout=0.1, attention_dropout=0.0,
             tree_pos_width=4, tree_pos_height=8, full_att=True, num_epochs=1, val_interval=99,
             save_interval=99)


@pytest.fixture(scope="module")
def port_corpus(tmp_path_factory):
    from csat_tpu_torch.data.synthetic import make_corpus

    data_dir = str(tmp_path_factory.mktemp("port_corpus"))
    make_corpus(data_dir, n_train=96, n_dev=24, n_test=24, seed=0)
    return data_dir


def _trainer(data_dir, out, **kw):
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.dataset import ASTDataset
    from csat_tpu_torch.train import Trainer

    cfg = get_config("python", data_dir=data_dir, output_dir=str(out), **{**MICRO, **kw})
    logged = []
    tr = Trainer(cfg, log=logged.append, device="cpu")
    return tr, ASTDataset(cfg, "train", tr.src_vocab, tr.tgt_vocab), logged


def _fill(reg):
    reg.counter("requests_total", "total requests served").inc(3)
    reg.gauge("queue_depth").set(2)
    h = reg.histogram("latency_seconds", "request latency", buckets=(0.25, 1.0))
    for v in (0.125, 0.5, 2.0):
        h.observe(v)
    reg.gauge("ratio", "a float gauge").set(0.1 + 0.2)
    reg.counter("big_total").inc(1e16)


# ---------------------------------------------------------------------------
# metrics registry + Prometheus exposition
# ---------------------------------------------------------------------------

def test_prometheus_exposition_golden():
    reg = MetricsRegistry()
    reg.counter("requests_total", "total requests served").inc(3)
    reg.gauge("queue_depth").set(2)
    h = reg.histogram("latency_seconds", "request latency", buckets=(0.25, 1.0))
    h.observe(0.125)
    h.observe(0.5)
    h.observe(2.0)
    assert reg.prometheus() == (
        "# HELP requests_total total requests served\n"
        "# TYPE requests_total counter\n"
        "requests_total 3\n"
        "# TYPE queue_depth gauge\n"
        "queue_depth 2\n"
        "# HELP latency_seconds request latency\n"
        "# TYPE latency_seconds histogram\n"
        'latency_seconds_bucket{le="0.25"} 1\n'
        'latency_seconds_bucket{le="1"} 2\n'
        'latency_seconds_bucket{le="+Inf"} 3\n'
        "latency_seconds_sum 2.625\n"
        "latency_seconds_count 3\n"
    )


@pytest.mark.parametrize("labels,prefix", [(None, ""), ({"replica": "1"}, "csat_")],
                         ids=["plain", "labelled"])
def test_prometheus_text_equals_jax_byte_for_byte(labels, prefix):
    from csat_tpu.obs import MetricsRegistry as JaxRegistry

    port, ref = MetricsRegistry(), JaxRegistry()
    _fill(port)
    _fill(ref)
    assert port.prometheus(labels, prefix) == ref.prometheus(labels, prefix)
    assert port.snapshot(prefix) == ref.snapshot(prefix)


def test_registry_get_or_create_and_type_conflict():
    reg = MetricsRegistry()
    assert reg.counter("a_total") is reg.counter("a_total")
    with pytest.raises(TypeError):
        reg.gauge("a_total")
    with pytest.raises(AssertionError):
        reg.counter("bad name")


def test_snapshot_flattens_histograms():
    reg = MetricsRegistry()
    reg.counter("c_total").inc(2)
    reg.histogram("h_seconds", buckets=(1.0,)).observe(0.5)
    assert reg.snapshot() == {"c_total": 2, "h_seconds_sum": 0.5, "h_seconds_count": 1}


def test_metrics_file_cadence_and_force(tmp_path):
    reg = MetricsRegistry()
    c = reg.counter("ticks_total")
    clock = {"t": 0.0}
    mf = MetricsFile(str(tmp_path / "m.jsonl"), reg, every_s=10.0, clock=lambda: clock["t"])
    assert mf.maybe_write()                 # first write always lands
    c.inc()
    clock["t"] = 5.0
    assert not mf.maybe_write()             # inside the window: skipped
    clock["t"] = 11.0
    assert mf.maybe_write(extra={"queue_depth": 4})
    assert mf.maybe_write(force=True)       # a forced write ignores cadence
    with open(tmp_path / "m.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["ticks_total"] for r in recs] == [0, 1, 1]
    assert recs[1]["queue_depth"] == 4
    assert all("t" in r for r in recs)


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def test_ring_bounded_and_totals_survive_wrap():
    rec = EventRecorder(capacity=3, component="t")
    for i in range(7):
        rec.span_from(f"phase.{i % 2}", rec.perf_t0)
    assert len(rec.events()) == 3            # ring keeps the newest 3
    totals = rec.phase_totals()
    assert totals["phase.0"]["count"] == 4   # aggregates saw all 7
    assert totals["phase.1"]["count"] == 3


def test_disabled_recorder_is_inert():
    rec = EventRecorder(capacity=0)
    rec.emit("x", id=1)
    with rec.span("s"):
        pass
    assert not rec.enabled and rec.events() == []
    assert rec.postmortem("/nonexistent", "FAILED") is None


def test_dump_roundtrip_and_rolling_postmortem(tmp_path):
    rec = EventRecorder(capacity=16, component="train")
    rec.emit("fault.injected.nan_loss", step=7)
    with rec.span("train.step", live=2):
        pass
    rec.emit("fault.rollback", it=7, error="boom")
    path = rec.postmortem(str(tmp_path), "rollback")
    meta, events = EventRecorder.load(path)
    assert meta["component"] == "train" and meta["reason"] == "rollback"
    assert [e["name"] for e in events] == [
        "fault.injected.nan_loss", "train.step", "fault.rollback"]
    assert events[0]["step"] == 7 and events[2]["error"] == "boom"
    assert events[1]["dur"] >= 0
    # rolling: a second incident of the same class OVERWRITES the file,
    # a different class gets its own
    rec.emit("fault.rollback", it=8)
    assert rec.postmortem(str(tmp_path), "rollback") == path
    rec.postmortem(str(tmp_path), "watchdog")
    assert sorted(os.listdir(tmp_path)) == ["postmortem_train_rollback.jsonl",
                                            "postmortem_train_watchdog.jsonl"]
    _, events2 = EventRecorder.load(path)
    assert events2[-1]["it"] == 8 and rec.dumps_written == 3


def test_dumps_load_across_packages(tmp_path):
    """A port dump reads back through JAX's loader and a JAX dump through
    the port's, to the same meta and events."""
    from csat_tpu.obs import EventRecorder as JaxRecorder

    for writer, reader in ((EventRecorder, JaxRecorder), (JaxRecorder, EventRecorder)):
        rec = writer(capacity=8, component="train")
        rec.emit("log", msg="epoch 1")
        with rec.span("train.data", rows=8):
            pass
        path = rec.dump(str(tmp_path / f"{writer.__module__}.jsonl"), reason="drill")
        assert reader.load(path) == writer.load(path)
        meta, events = reader.load(path)
        assert meta["reason"] == "drill" and [e["name"] for e in events] == ["log", "train.data"]


# ---------------------------------------------------------------------------
# trace export + schema validation
# ---------------------------------------------------------------------------

def test_trace_export_valid_and_grouped(tmp_path):
    from csat_tpu.obs import to_chrome_events as jax_to_chrome
    from csat_tpu.obs import validate_chrome_trace as jax_validate

    rec = EventRecorder(capacity=64, component="train")
    rec.emit("fault.nan_guard", it=1)
    with rec.span("train.step"):
        with rec.span("data.collate", rows=1):
            pass
    with rec.span("train.guard"):
        pass
    path = write_chrome_trace(str(tmp_path / "t.json"), rec)
    obj = load_chrome_trace(path)
    assert validate_chrome_trace(obj) == [] and jax_validate(obj) == []
    assert obj["traceEvents"] == jax_to_chrome(rec.events(), process_name="train")
    evs = obj["traceEvents"]
    by_name = {e["name"]: e for e in evs if e.get("ph") in ("X", "i")}
    assert set(by_name) == {"fault.nan_guard", "train.step", "data.collate", "train.guard"}
    # dot-prefix grouping: train.* share a tid distinct from data.*
    assert by_name["train.step"]["tid"] == by_name["train.guard"]["tid"]
    assert by_name["train.step"]["tid"] != by_name["data.collate"]["tid"]
    threads = {e["args"]["name"] for e in evs if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"fault", "train", "data"} <= threads
    assert by_name["data.collate"]["args"] == {"rows": 1}


def test_trace_validation_rejects_malformed():
    ok = {"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0, "dur": 5, "pid": 1, "tid": 1},
        {"name": "b", "ph": "B", "ts": 6, "pid": 1, "tid": 1},
        {"name": "b", "ph": "E", "ts": 9, "pid": 1, "tid": 1},
    ]}
    assert validate_chrome_trace(ok) == []
    assert validate_chrome_trace({"traceEvents": "nope"})
    assert validate_chrome_trace({"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0, "pid": 1}]})  # X without dur
    assert validate_chrome_trace({"traceEvents": [
        {"name": "a", "ph": "i", "ts": 10, "pid": 1},
        {"name": "b", "ph": "i", "ts": 3, "pid": 1}]})  # unsorted ts
    assert validate_chrome_trace({"traceEvents": [
        {"name": "b", "ph": "B", "ts": 0, "pid": 1, "tid": 1}]})  # unclosed B
    assert validate_chrome_trace({"traceEvents": [
        {"name": "e", "ph": "E", "ts": 0, "pid": 1, "tid": 1}]})  # E sans B
    assert validate_chrome_trace({"traceEvents": [
        {"name": "a", "ph": "?", "ts": 0}]})  # unknown phase


def test_event_tuples_to_chrome_instant_scope():
    evs = to_chrome_events([(1.0, "fault.preemption", 0.0, {"it_done": 3})])
    inst = [e for e in evs if e["ph"] == "i"]
    assert inst and inst[0]["s"] == "t" and inst[0]["args"] == {"it_done": 3}


def test_annotated_span_brackets_record_function():
    """``annotate=True`` puts the span's name into a running torch.profiler
    trace, so the host spans line up with the device trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rec = EventRecorder(capacity=8, component="train")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("train.step", annotate=True):
            torch.ones(4).sum()
    assert "train.step" in {e.key for e in prof.key_averages()}
    assert rec.phase_totals()["train.step"]["count"] == 1


# ---------------------------------------------------------------------------
# Trainer integration
# ---------------------------------------------------------------------------

def test_trainer_telemetry_end_to_end(port_corpus, tmp_path):
    tr, ds, logged = _trainer(port_corpus, tmp_path, profile=True, scalar_log=True,
                              scalar_log_every=5)
    _, history = tr.fit(ds, None)

    # registry-backed counters agree with the history dict
    snap = tr.registry.snapshot()
    assert snap["train_steps_total"] == len(history["steps"]) == 12   # 96 samples / batch 8
    assert snap["train_epochs_total"] == 1
    assert tr.registry.get("train_epoch_loss").value == history["loss"][0]
    assert np.isfinite(history["loss"][0])
    assert snap["train_quarantined_total"] == history["quarantined"] == 0
    text = tr.registry.prometheus()
    assert "# TYPE train_steps_total counter" in text
    assert "# TYPE train_epoch_loss gauge" in text

    # the phase breakdown covers the step pipeline
    assert {"train.data", "train.step"} <= set(history["phase_s"])
    assert all(v >= 0 for v in history["phase_s"].values())

    # every log line is a recorder event and still reaches the sink
    assert logged
    log_events = [f["msg"] for _, name, _, f in tr.obs.events() if name == "log"]
    assert logged[-1] in log_events

    # scalar_log_every=5 → per-iteration records at it 0, 5, 10
    with open(os.path.join(tr.output_dir, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["it"] for r in recs if "it" in r] == [0, 5, 10]
    assert [r["loss"] for r in recs if "it" in r] == [history["steps"][i]["loss"]
                                                      for i in (0, 5, 10)]

    # the profiled epoch leaves both traces
    assert os.listdir(os.path.join(tr.output_dir, "trace"))
    obj = load_chrome_trace(os.path.join(tr.output_dir, "host_trace.json"))
    assert validate_chrome_trace(obj) == []
    assert {"train.data", "train.step"} <= {e["name"] for e in obj["traceEvents"]}


def test_scalar_log_every_zero_disables_iteration_records(port_corpus, tmp_path):
    tr, ds, _ = _trainer(port_corpus, tmp_path, scalar_log=True, scalar_log_every=0)
    tr.fit(ds, None)
    with open(os.path.join(tr.output_dir, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert not any("it" in r for r in recs)
    assert any("loss" in r and r.get("epoch") == 1 for r in recs)


def test_metrics_file_written_each_epoch(port_corpus, tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    tr, ds, _ = _trainer(port_corpus, tmp_path, num_epochs=2, obs_metrics_file=path)
    tr.fit(ds, None)
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    assert [(r["epoch"], r["train_epochs_total"], r["train_steps_total"]) for r in recs] == \
        [(1, 1, 12), (2, 2, 24)]


def test_trainer_counters_equal_jax_trainers(synthetic_corpus, micro_config, port_corpus,
                                            tmp_path):
    """One epoch of each package's Trainer on the same corpus (each its own
    copy from one seed): the same counters under the same names and types."""
    from csat_tpu.data.dataset import ASTDataset as JaxDataset
    from csat_tpu.train import Trainer as JaxTrainer

    jcfg = micro_config.replace(data_dir=synthetic_corpus, full_att=True, num_epochs=1,
                                val_interval=99, save_interval=99,
                                output_dir=str(tmp_path / "jax"))
    jtr = JaxTrainer(jcfg, log=lambda m: None)
    jtr.fit(JaxDataset(jcfg, "train", jtr.src_vocab, jtr.tgt_vocab), None)
    tr, ds, _ = _trainer(port_corpus, tmp_path / "port")
    tr.fit(ds, None)
    jsnap, snap = jtr.registry.snapshot(), tr.registry.snapshot()
    assert snap["train_steps_total"] == jsnap["train_steps_total"] == 12
    for key in ("train_epochs_total", "train_quarantined_total"):
        assert snap[key] == jsnap[key], key
    assert set(snap) == set(jsnap)

    def types(text):
        return sorted(line for line in text.splitlines() if line.startswith("# TYPE"))

    assert types(tr.registry.prometheus()) == types(jtr.registry.prometheus())
