"""Faults planted in the timed path, to show that ``correct`` catches them.

Each is a wrapper the training or serving driver module applies (``opts.fault``):

* ``unchanged`` (training): the step computes its loss and gradients, and
  the state comes back as it was — parameters and moments restored;
* ``half_batch`` (training): the step sees the first half of each batch's
  rows, so its loss is the mean over the rest;
* ``token`` (serving): one token of every finished request altered where the
  harness receives it.

A cell on one chip has no exchange between chips to leave out.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

__all__ = ["make_fault", "FAULTS"]


def _unchanged(cell) -> Callable:
    def wrap(step, state):
        def faulty(st, batch, bad=0, **kw):
            params = {k: p.detach().clone() for k, p in st.params.items()}
            bufs = [b.clone() for b in st.opt_state.buffers]
            st, metrics = step(st, batch, bad, **kw)
            with torch.no_grad():
                for k, p in st.params.items():
                    p.copy_(params[k])
                for b, old in zip(st.opt_state.buffers, bufs):
                    b.copy_(old)
            return st, metrics
        return faulty
    return wrap


def _half_batch(cell) -> Callable:
    def wrap(step, state):
        def faulty(st, batch, bad=0, **kw):
            half = batch.src_seq.shape[0] // 2
            return step(st, batch._replace(**{f: getattr(batch, f)[:half]
                                               for f in batch._fields}), bad, **kw)
        return faulty
    return wrap


def _token(cell) -> Callable:
    vocab = int(cell.model["tgt_vocab_size"])

    def alter(tokens: np.ndarray) -> np.ndarray:
        if not len(tokens):
            return tokens
        out = tokens.copy()
        k = len(out) // 2
        out[k] = 4 + (int(out[k]) - 4 + 1) % (vocab - 4)
        return out
    return alter


FAULTS: Dict[str, Callable] = {"unchanged": _unchanged, "half_batch": _half_batch,
                               "token": _token}


def make_fault(name: str, cell) -> Callable:
    if name not in FAULTS:
        raise SystemExit(f"unknown fault {name!r}; choose from {sorted(FAULTS)}")
    return FAULTS[name](cell)
