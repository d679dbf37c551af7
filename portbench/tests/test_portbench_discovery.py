"""Configurations, mixes and metrics are files found by name: in a copy of
the benchmark, a new configuration, mix, metric and cell — new files and new
entries of ``BENCHMARK.json`` — run without an edit to any file already
there."""

import hashlib
import json
import shutil
import subprocess
import sys

from conftest import ROOT, TINY_MODEL


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_config_mix_and_metric_run_without_an_edit(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())

    model = json.loads((ROOT / "portbench/configs/csat-python.json").read_text())
    model.update(TINY_MODEL, reduced=sorted(TINY_MODEL))
    (tmp_path / "portbench/configs/csat-tiny.json").write_text(json.dumps(model))
    mix = {"driver": "train", "generator": "corpus", "lengths": "stdlib_lengths",
           "corpus_size": 64, "settings": {"bucketing": True, "prefetch": 1, "batch_size": 8},
           "max_warmup_steps": 60, "profile_steps": 4}
    (tmp_path / "portbench/mixes/train-tiny.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/metrics/steps_in_window.py").write_text(
        "def read(rec):\n    return float(len(rec.steps)) if rec.steps else None\n")
    (tmp_path / "portbench/limits/tiny-train.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 1e-3}}))
    bench["configs"].append({"name": "csat-tiny", "source": "https://example.org/tiny",
                             "file": "portbench/configs/csat-tiny.json",
                             "reduced": sorted(TINY_MODEL), "why": "a test"})
    bench["workloads"].append({"name": "tiny-train", "config": "csat-tiny",
                               "traffic": "train-tiny", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_nodes_per_s":
            m["workloads"].append("tiny-train")
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "train step",
                               "moves": "train_nodes_per_s", "workloads": ["tiny-train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = """
import json, sys, time, torch
from portbench.run import Opts, measure
from portbench.core.spec import load_cell
cell = load_cell("tiny-train")
out = {}
for trace in (False, True):
    res = measure(cell, Opts(seed=2**31 + 99, seconds=1, trace=trace, device=torch.device("cpu"),
                             t_process=time.perf_counter()))
    out[str(trace)] = {k: res[k] for k in ("correct", "metrics")}
print(json.dumps(out))
"""
    run = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600,
                         env={"PYTHONPATH": f"{tmp_path}:{ROOT}", "PATH": "/usr/bin:/bin"})
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["False"]["correct"] and out["True"]["correct"]
    assert set(out["False"]["metrics"]) == {"train_nodes_per_s", "setup_s"}
    assert out["True"]["metrics"]["steps_in_window"]["value"] >= 1
    assert out["True"]["metrics"]["steps_in_window"]["unit"] == "steps"
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
