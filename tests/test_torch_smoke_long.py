"""``chip_smoke.py``'s ``long_ast`` phase, rehearsed on the CPU where it can
be: its batches and requests (AST sizes, the prefill groups they form at N
512), and the capture the same-graph gate and phase 3 read under remat — a
block recomputed in the backward must leave the first forward's inputs and
the real cotangents in the capture, the same as without remat.  The gates,
the world-1 NCCL fit and the two gloo ranks on the card run there only
(their CPU counterparts: tests/test_torch_long.py, tests/test_torch_parallel.py)."""

import numpy as np
import pytest
import torch

import chip_smoke

from torch_parity import MICRO, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_long_batches_and_requests_span_their_sizes():
    from csat_tpu_torch.configs import get_config

    cfg = get_config("python_long")
    batch = chip_smoke.long_batch(cfg, 6, device="cpu")
    assert tuple(batch.src_seq.shape) == (6, 512)
    real = (np.asarray(batch.src_seq) != 0).sum(1)
    assert real.min() >= chip_smoke.LONG_NODES[0] - 1 and real.max() <= 512
    scfg = chip_smoke.long_serve_cfg("java_long")
    samples, budgets = chip_smoke.long_requests(scfg)
    sizes = sorted(int(s["num_node"]) for s in samples)
    assert sizes[0] == chip_smoke.LONG_SERVE_NODES[0] and sizes[-1] == 512
    assert len(samples) == len(budgets) == chip_smoke.LONG_SERVE_REQUESTS
    # every request falls in the 512 bucket, grouped up to its batch size
    assert chip_smoke.long_serve_shapes(scfg, samples) == [(b, 512) for b in range(1, 5)]


@pytest.mark.parametrize("remat", [True, False])
def test_capture_under_remat_keeps_the_forward_and_its_cotangents(remat):
    from csat_tpu_torch.configs import get_config

    cfg = get_config("python_long", **{**MICRO, "max_src_len": 160, "bucket_src_lens": (),
                                        "sbm_layers": 2, "clusters": (4, 3),
                                        "eval_graph": "sample", "remat": remat})
    batch = chip_smoke.long_batch(cfg, 3, nodes=(60, 160), device="cpu")
    got = chip_smoke.capture_sbm_inputs(cfg, batch, device="cpu", layers=2)
    ref = chip_smoke.capture_sbm_inputs(cfg.replace(remat=not remat), batch, device="cpu",
                                        layers=2)
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        assert a["go"].abs().sum() > 0 and a["gs"].abs().sum() > 0
        for key in ("q", "k", "v"):
            assert torch.equal(a[key], b[key]), key
        assert torch.equal(a["aux"][3], b["aux"][3])  # the same sample seed
        torch.testing.assert_close(a["go"], b["go"], atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(a["gs"], b["gs"], atol=1e-6, rtol=1e-6)
