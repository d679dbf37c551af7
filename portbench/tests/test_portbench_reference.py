"""The yardstick of ``correct`` is right before it judges the card: at a tiny
size on the CPU, the reference's forward and loss equal the port's plain path
on the same weights, inputs and seed (one training step, dropout, the sampled
graph and its noise included), and its weights carry the port's names."""

import numpy as np
import pytest
import torch

from conftest import TINY_MODEL, tiny_cell
from portbench.core.weights import make_weights, param_table
from portbench.reference.model import Reference, loss, round_tf32


def _model(name):
    return tiny_cell(name).model


@pytest.mark.parametrize("cell", ["python-train-b64", "java-train-b64"])
def test_param_table_is_the_port_s_named_parameters(cell):
    from csat_tpu_torch.models import CSATrans
    from portbench.core.port import port_config
    from portbench.core.spec import ROOT, load_cell

    full = load_cell(cell)
    cfg = port_config(full.model, full.mix, ROOT)
    net = CSATrans(cfg.replace(**{k: (tuple(v) if isinstance(v, list) else v)
                                  for k, v in TINY_MODEL.items() if hasattr(cfg, k)}),
                   TINY_MODEL["src_vocab_size"], TINY_MODEL["tgt_vocab_size"], device="cpu")
    ours = [(n, s) for n, s, _ in param_table(_model(cell))]
    assert ours == [(n, tuple(p.shape)) for n, p in net.named_parameters()]


def _batch(model, seed):
    from csat_tpu_torch.data.dataset import batch_to_device, collate
    from portbench.traffic.corpus import generate

    arrays = generate({"lengths": "stdlib_lengths", "corpus_size": 6}, model, seed, 1)
    return batch_to_device(collate(arrays, model["max_src_len"]), torch.device("cpu"))


@pytest.mark.parametrize("seed", [2**31 + 1, 2**32 + 17])
def test_training_step_equals_the_port_s_plain_path(seed):
    from portbench.core.port import port_config, port_model
    from portbench.core.spec import ROOT, load_cell
    from csat_tpu_torch.train.state import create_train_state, default_optimizer
    from csat_tpu_torch.train.loop import make_train_step

    full = load_cell("python-train-b64")
    model = dict(full.model, **TINY_MODEL)
    cfg = port_config(model, full.mix, ROOT)
    dev = torch.device("cpu")
    net = port_model(cfg, model, make_weights(model, seed, dev), dev)
    opt = default_optimizer(cfg)
    state = create_train_state(net, opt, seed)
    batch = _batch(model, seed)
    state, metrics = make_train_step(net, opt, cfg)(state, batch)
    grads = {k: p.grad for k, p in state.params.items()}

    params = make_weights(model, seed, dev)
    for p in params.values():
        p.requires_grad_(True)
    gen = torch.Generator().manual_seed(seed)
    inputs = {k: getattr(batch, k) for k in ("src_seq", "tgt_seq", "L", "T", "L_mask", "T_mask")}
    log_probs, sparsity = Reference(model, params).forward(inputs, gen)
    nll, total = loss(model, log_probs, batch.target, sparsity)
    ref_grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
    assert float(nll.detach()) == pytest.approx(float(metrics["loss"]), rel=1e-6)
    assert float(total.detach()) == pytest.approx(float(metrics["total"]), rel=1e-6)
    for k, g in ref_grads.items():
        assert torch.allclose(g, grads[k], rtol=1e-4, atol=1e-7), k


def test_expected_graph_forward_equals_the_port_s_encoder():
    from portbench.core.port import port_config, port_model
    from portbench.core.spec import ROOT, load_cell

    full = load_cell("python-serve-poisson")
    model = dict(full.model, **TINY_MODEL)
    cfg = port_config(model, full.mix, ROOT)
    assert cfg.eval_graph == "expected"
    dev = torch.device("cpu")
    net = port_model(cfg, model, make_weights(model, 5, dev), dev)
    batch = _batch(model, 5)
    with torch.no_grad():
        lp, _ = net(batch)
        ref = Reference(model, make_weights(model, 5, dev))
        mem, _ = ref.encode(batch.src_seq, batch.L, batch.T, batch.L_mask, batch.T_mask)
        logits = ref.decode(batch.tgt_seq, mem, batch.src_seq == 0)
    assert torch.allclose(torch.log_softmax(logits, -1), lp, atol=1e-5)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -2.5e-3, 3.0e38])
    r = round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10
    assert r[2] == 1.0                        # a tie rounds to even
    assert r[3] == 1.0 + 2**-9
    bits = r.view(torch.int32)
    assert ((bits & 0x1FFF) == 0).all()
    assert torch.allclose(r, x, rtol=2**-11)
    assert np.isfinite(r.numpy()).all()
