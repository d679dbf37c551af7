"""Shared fixtures of the benchmark's own tests.

These tests are not under the repository's ``tests/``: run them with
``python -m pytest portbench/tests -q`` (CPU) and, on a machine with a CUDA
card, ``python -m pytest portbench/tests -m card -q``.  Tests marked
``card`` decide inside the ``cuda`` fixture whether there is a card, and
skip without one.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: CPU-sized widths for the configurations (the published ones stay in the files)
TINY_MODEL = {"pe_dim": 16, "pegen_dim": 32, "sbm_enc_dim": 32, "hidden_size": 32,
              "num_heads": 4, "num_layers": 1, "sbm_layers": 2, "decoder_layers": 1,
              "clusters": [3, 3], "dim_feed_forward": 64, "max_src_len": 40,
              "max_tgt_len": 12, "src_vocab_size": 300, "tgt_vocab_size": 400}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (the benchmark's runs at the cells' own sizes); "
        "skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run at their own sizes only on the card")
    return torch.device("cuda", 0)


def tiny_cell(name: str):
    """Cell ``name`` of ``BENCHMARK.json`` at CPU-sized widths and traffic."""
    from portbench.core.spec import load_cell

    cell = load_cell(name)
    cell.model = dict(cell.model, **TINY_MODEL)
    mix = dict(cell.mix)
    if mix["driver"] == "train":
        mix.update(corpus_size=96, settings={"bucketing": True, "prefetch": 2, "batch_size": 8})
    else:
        mix.update(rate_per_s=20.0, warmup_per_bucket=2, check_block=8,
                   settings=dict(mix["settings"], serve_slots=4))
    cell.mix = mix
    return cell


def cpu_run(cell, seed: int = 2**31 + 7, seconds: int = 2, fault=None, control=False,
            trace=False):
    import time

    import torch

    from portbench.run import Opts, measure

    opts = Opts(seed=seed, seconds=seconds, trace=trace, device=torch.device("cpu"),
                t_process=time.perf_counter(), fault=fault, control=control)
    return measure(cell, opts)
