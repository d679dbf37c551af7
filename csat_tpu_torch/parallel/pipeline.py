"""GPipe pipeline parallelism for the SBM encoder stack, over a ``pipe`` axis.

Counterpart of the JAX package's ``parallel/pipeline.py``: the encoder's
homogeneous blocks become pipeline stages laid out over the ``pipe`` axis —
stage r runs blocks ``[r·L/P, (r+1)·L/P)`` — and microbatches stream through
them in the GPipe wavefront.  The parameters stay replicated across ``pipe``
(JAX v1, ``pipeline.py:37-41``), so checkpoints are interchangeable with the
sequential loop.

The formulation is JAX's, not a hand-scheduled 1F1B: with P stages and M
microbatches every stage runs all ``T = M + P − 1`` ticks; at tick t stage r
holds microbatch ``t − r``, clamped into range on the bubble ticks, which
compute on it and whose results are discarded by selection; after every
tick the activations hop ``r → r+1`` (one non-cyclic
:func:`~csat_tpu_torch.parallel.collectives.ppermute` per tick); the last
stage's outputs at ticks ``P−1 … T−1`` are microbatches ``0 … M−1``, summed
over ``pipe`` so every stage holds them.  The per-head sparsity of each
layer is the mean over the microbatches (then over the data shards, as the
port's data axis sums it), assembled over ``pipe``.

The wavefront is one ``torch.autograd.Function`` whose backward is the same
schedule in reverse: the cotangents of the outputs and the sparsities summed
over ``pipe``, then ticks ``T−1 … 0``, each one reverse hop ``r+1 → r`` of
the input cotangents followed by the backward of the stage's valid tick
(``torch.autograd.grad`` of the sub-graph the forward kept; a bubble tick
passes zeros).  Every collective is thus paired, forward and backward, on
every backend, whatever order autograd would otherwise pick.

Randomness follows JAX's keying (``models/sbm.py:392-402`` there): the
sample and dropout seeds of every (layer, microbatch) are drawn up front
from the step's generator, in the same order on every process
(:func:`draw_streams`), each pair a
:class:`~csat_tpu_torch.ops.hashrng.KeyedStream`; microbatches are formed
per data shard, the kernels hash each microbatch from batch row 0
(``bh0 = 0``), and key (l, m) is the same on every data shard — the
reference's documented behaviour (``tests/test_pipeline.py:42-50``).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from csat_tpu_torch.ops.hashrng import KeyedStream
from csat_tpu_torch.parallel.collectives import hop, sum_over

__all__ = ["pipeline_ready", "draw_streams", "gpipe_blocks"]


def pipeline_ready(stages: int, shard) -> bool:
    """True when the encoder runs as a wavefront: more than one configured
    stage and a ``pipe`` axis in ``shard`` (a
    :class:`~csat_tpu_torch.parallel.mesh.DataShard`; the one-process
    reference's axis has one member)."""
    return stages > 1 and shard is not None and shard.pipe is not None


def draw_streams(gen: torch.Generator, layers: int, n_micro: int,
                 training: bool) -> List[List[KeyedStream]]:
    """The (layer, microbatch) streams of one pass: an (L, M) grid of sample
    seeds and, when ``training``, an (L, M) grid of dropout seeds, drawn from
    ``gen`` on its own device (no host read)."""
    shape = (2 if training else 1, layers, n_micro)
    seeds = torch.randint(0, 2**31 - 1, shape, generator=gen, device=gen.device,
                          dtype=torch.int32)
    drop = seeds[1] if training else torch.zeros_like(seeds[0])
    return [[KeyedStream(seeds[0, l, m], drop[l, m]) for m in range(n_micro)]
            for l in range(layers)]


class _Plan:
    """One wavefront pass: what the forward computed and kept for the
    backward."""

    def __init__(self, block_apply, params, key_pad, streams, n_micro, axis, layers,
                 data_groups, data_shards):
        self.block_apply, self.params = block_apply, params
        self.key_pad, self.streams = key_pad, streams
        self.n_micro, self.axis, self.layers = n_micro, axis, layers
        self.micro = n_micro * data_groups  # microbatches of this process's rows
        self.ticks = self.micro + axis.size - 1
        self.mine = range(axis.index * layers // axis.size,
                          (axis.index + 1) * layers // axis.size)
        self.mean = 1.0 / (self.micro * data_shards)  # microbatch, then data-shard mean
        self.kept = {}

    def _stage(self, x_in, pad, k: int):
        """The stage's layers on microbatch ``k`` (key column ``k mod M``)."""
        y, sps = x_in, []
        for l in self.mine:
            y, sp = self.block_apply(l, y, pad, self.streams[l][k % self.n_micro])
            sps.append(sp)
        return y, torch.stack(sps)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        r, last = self.axis.index, self.axis.size - 1
        b = x.shape[0]
        if b % self.micro:
            raise ValueError(f"local batch {b} not divisible into {self.micro} microbatches")
        mb = b // self.micro
        x_all = x.reshape(self.micro, mb, *x.shape[1:])
        pads = self.key_pad.reshape(self.micro, mb, *self.key_pad.shape[1:])
        self.x_shape = x.shape
        build = self.build
        buf = torch.zeros_like(x_all[0])
        outs = [None] * self.micro
        sp_sum = None
        for t in range(self.ticks):
            k = t - r
            valid = 0 <= k < self.micro
            kc = min(max(k, 0), self.micro - 1)
            x_in = x_all[min(t, self.micro - 1)] if r == 0 else buf
            if build and valid:
                leaf = x_in.detach().requires_grad_()
                with torch.enable_grad():
                    y, sps = self._stage(leaf, pads[kc], kc)
                self.kept[t] = (leaf, y, sps)
            else:
                y, sps = self._stage(x_in, pads[kc], kc)
            y = y.detach()
            (buf,) = hop([y], self.axis, 1, cyclic=False)
            if valid:  # a bubble tick's results are dropped here, never multiplied
                sp_sum = sps.detach() if sp_sum is None else sp_sum + sps.detach()
                if r == last:
                    outs[k] = y
        out = torch.cat(outs) if r == last else torch.zeros_like(x)
        full = torch.zeros((self.layers, sp_sum.shape[1]), dtype=sp_sum.dtype,
                           device=sp_sum.device)
        full[self.mine.start:self.mine.stop] = sp_sum * self.mean
        return sum_over(out, self.axis), sum_over(full, self.axis)

    def backward(self, g_out: torch.Tensor, g_sp: torch.Tensor):
        r = self.axis.index
        g_out = sum_over(g_out.contiguous(), self.axis)
        g_sp = sum_over(g_sp.contiguous(), self.axis)
        g_out = g_out.reshape(self.micro, -1, *g_out.shape[1:])
        g_sps = g_sp[self.mine.start:self.mine.stop] * self.mean
        grads = [None] * len(self.params)
        g_x = torch.zeros((self.micro,) + tuple(g_out.shape[1:]), dtype=g_out.dtype,
                          device=g_out.device)
        g_next = torch.zeros_like(g_out[0])  # the cotangent of the tick after's input
        for t in reversed(range(self.ticks)):
            (g_y,) = hop([g_next], self.axis, -1, cyclic=False)
            k = t - r
            if t not in self.kept:  # a bubble tick: nothing flows back
                g_next = torch.zeros_like(g_next)
                continue
            if r == self.axis.size - 1:
                g_y = g_y + g_out[k]
            leaf, y, sps = self.kept.pop(t)
            outs, cots = [y], [g_y]
            if sps.requires_grad:  # full attention reports a constant sparsity
                outs.append(sps)
                cots.append(g_sps)
            got = torch.autograd.grad(outs, (leaf, *self.params), cots, allow_unused=True)
            for i, g in enumerate(got[1:]):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
            if r == 0:
                g_x[k] = got[0]
                g_next = torch.zeros_like(g_next)
            else:
                g_next = got[0]
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)]
        return g_x.reshape(self.x_shape), grads


class _Wavefront(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, x, *params):
        ctx.plan = plan
        return plan.forward(x)

    @staticmethod
    def backward(ctx, g_out, g_sp):
        g_x, grads = ctx.plan.backward(g_out, g_sp)
        return (None, g_x, *grads)


def gpipe_blocks(block_apply: Callable, params: Sequence[torch.Tensor], x: torch.Tensor,
                 key_pad: torch.Tensor, streams: List[List[KeyedStream]], n_micro: int,
                 axis, layers: int, data_groups: int = 1,
                 data_shards: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``layers`` blocks as a GPipe wavefront along ``axis`` (the
    ``pipe`` line).

    ``block_apply(l, x_mb, pad_mb, stream) → (x_mb, sparsity (H,))`` runs
    block l on one microbatch; ``params`` are the parameters of this stage's
    blocks (they get their gradients from the wavefront's backward); ``x``
    (B, N, D) and ``key_pad`` (B, N) this process's rows; ``streams[l][m]``
    the (layer, microbatch) randomness (:func:`draw_streams`).  The rows are
    split into ``data_groups · n_micro`` microbatches, microbatch k keyed by
    column ``k mod n_micro`` (``data_groups`` > 1: the one-process reference
    of that many data shards); ``data_shards`` is the data axis's size, over
    which the port sums the sparsity.  Returns ``(x_out (B, N, D),
    sparsity (L, H))``, the same on every stage."""
    plan = _Plan(block_apply, list(params), key_pad, streams, n_micro, axis, layers,
                 data_groups, data_shards)
    plan.build = torch.is_grad_enabled()
    if not plan.build:
        return plan.forward(x)
    return _Wavefront.apply(plan, x, *plan.params)
