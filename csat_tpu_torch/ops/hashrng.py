"""Counter-based uniform random bits, bit for bit as the JAX package draws them.

A copy of the JAX package's ``ops/hashrng.py``: a murmur3 finalizer over
``(seed, batch·head, global row, global col)`` gives the uniform draw of every
attention pair; batch·head is global too (``bh0`` and the head stride
``h_total``), so a data-parallel process draws its rows' slice of the one
global field and a tensor-parallel one its heads' slice.  The stream is a
pure function of indices, so the CUDA kernels
(``csrc/flex_fwd*.cu``, ``csrc/flex_bwd*.cu``) generate it tile by tile, the
backward regenerates it, and :func:`uniform_field` materialises the same
field for the plain path.

PyTorch's ``uint32`` has thin operator support on the CPU, so the arithmetic
runs in ``int64`` holding values below 2³²: every product is split into two
16-bit halves (no ``int64`` overflow) and masked back to 32 bits.  The row
stride is the TPU tile, ``round_up(n, 128)``, whatever block size a kernel
tiles by: it is part of the stream's definition.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["TILE", "round_up", "noise_stride", "hash_bits", "bits_to_uniform",
           "global_bh", "uniform_field", "block_uniform", "KeyedStream"]

TILE = 128  # the JAX kernels' node tile: the hash row stride is N padded to it

_C1 = 0x9E3779B9  # golden-ratio mix for the seed
_C2 = 0x85EBCA6B  # murmur3 constant, mixes batch·head
_C3 = 0xC2B2AE35
_M32 = 0xFFFFFFFF

IntLike = Union[int, torch.Tensor]


def round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def noise_stride(n: int) -> int:
    """Row stride of the (i, j) hash counter: N padded to the TPU tile."""
    return round_up(n, TILE)


def _u32(x: IntLike) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64) & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x · c mod 2³²`` for ``0 <= x, c < 2³²`` without leaving int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_bits(seed: IntLike, bh: IntLike, rows: IntLike, cols: IntLike,
              stride: int) -> torch.Tensor:
    """The uint32 hash (held in int64) of every broadcast ``(seed, bh, row,
    col)``; ``seed`` may be an int32 tensor, wrapped to uint32 as JAX casts
    it."""
    x = (_mul32(_u32(rows), stride) + _u32(cols)) & _M32
    x = x ^ _mul32(_u32(seed), _C1)
    x = x ^ _mul32(_u32(bh), _C2)
    x = x ^ (x >> 16)
    x = _mul32(x, _C2)
    x = x ^ (x >> 13)
    x = _mul32(x, _C3)
    return x ^ (x >> 16)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """Top 24 bits × 2⁻²⁴ as float32 in [0, 1): exact, through an integer
    below 2²⁴ (the JAX package's int32 step)."""
    top = (bits >> 8).to(torch.int32)
    return top.to(torch.float32) * (1.0 / (1 << 24))


def global_bh(b: int, h: int, device, bh0: int = 0, h_total: int = 0) -> torch.Tensor:
    """(B, H, 1, 1) global batch·head indices ``bh0 + b·h_total + h`` of a
    process's ``b`` rows and ``h`` heads (``h_total`` 0: the local ``h``)."""
    return (bh0 + torch.arange(b, device=device)[:, None] * (h_total or h)
            + torch.arange(h, device=device)[None, :])[:, :, None, None]


def _bh_rows_cols(b: int, h: int, n_rows: int, n_cols: int, device, bh0: int = 0,
                  h_total: int = 0):
    bh = global_bh(b, h, device, bh0, h_total)
    rows = torch.arange(n_rows, device=device)[None, None, :, None]
    cols = torch.arange(n_cols, device=device)[None, None, None, :]
    return bh, rows, cols


def uniform_field(seed: IntLike, b: int, h: int, n_rows: int, n_cols: int,
                  stride: int, device=None, bh0: int = 0, h_total: int = 0) -> torch.Tensor:
    """The full (B, H, n_rows, n_cols) uniform field the kernels generate tile
    by tile — the plain path's copy of exactly the tensor they avoid.
    ``bh0`` offsets the batch·head index and ``h_total`` (0: ``h``) is its
    head stride: a process holding rows ``[b0, b0 + B)`` of a global batch
    and heads ``[h0, h0 + h)`` of ``h_total`` passes ``b0 · h_total + h0``
    and draws its slice of the global field, as one process over the whole
    batch and every head would (the JAX ring's ``bh = (b0 + b)·H + h0 +
    h``)."""
    if device is None and torch.is_tensor(seed):
        device = seed.device
    bh, rows, cols = _bh_rows_cols(b, h, n_rows, n_cols, device, bh0, h_total)
    return bits_to_uniform(hash_bits(seed, bh, rows, cols, stride))



def block_uniform(seed: IntLike, bh: torch.Tensor, row0: int, col0: int, n_rows: int,
                  n_cols: int, stride: int) -> torch.Tensor:
    """The uniform draws of one (rows ``[row0, row0 + n_rows)``, cols
    ``[col0, col0 + n_cols)``) block of the field at the global batch·head
    indices ``bh`` (broadcastable to (B, H, 1, 1)): the same bits as the
    block of :func:`uniform_field` — the JAX ring's ``_block_uniform``
    (``parallel/ring.py:71-77``)."""
    device = bh.device
    rows = row0 + torch.arange(n_rows, device=device)[None, None, :, None]
    cols = col0 + torch.arange(n_cols, device=device)[None, None, None, :]
    return bits_to_uniform(hash_bits(seed, bh, rows, cols, stride))


class KeyedStream:
    """The randomness of one (layer, microbatch) of the GPipe wavefront, as a
    JAX block gets its own ``sample`` and ``dropout`` keys
    (``models/sbm.py:392-402`` of the JAX package): two int32 seeds, (1,)
    tensors on the device, drawn up front from the step's generator.

    It stands where the model takes a ``torch.Generator``: the SBM layer's
    hash seeds are the seeds themselves (:meth:`seed`: the sampled graph
    under ``sample``, the attention dropout under ``dropout``), and each
    model-dropout mask is a counter-hash field (:meth:`rand`) under a seed
    derived from ``dropout`` and the draw's ordinal — so any stage regenerates
    any microbatch's draws on its own, and a recompute that sets the ordinal
    back (:meth:`get_state` / :meth:`set_state`, as ``models.components.remat``
    does for a generator) draws the same masks.  Nothing is read on the
    host."""

    _MASK = 0x5EED  # the batch·head slot of the mask-seed derivation

    def __init__(self, sample_seed: torch.Tensor, dropout_seed: torch.Tensor):
        self.sample = sample_seed.reshape(1).to(torch.int32)
        self.dropout = dropout_seed.reshape(1).to(torch.int32)
        self.device = self.sample.device
        self.draws = 0

    def get_state(self) -> int:
        return self.draws

    def set_state(self, state: int) -> None:
        self.draws = state

    def seed(self, name: str) -> torch.Tensor:
        """The hash seed of the ``name`` stream ("sample" or "dropout")."""
        return self.sample if name == "sample" else self.dropout

    def rand(self, shape) -> torch.Tensor:
        """Uniform [0, 1) f32 of ``shape`` on the device: the next mask's
        field."""
        mask_seed = hash_bits(self.dropout, self._MASK, 0, self.draws, 1)
        self.draws += 1
        numel = 1
        for s in shape:
            numel *= int(s)
        flat = torch.arange(numel, device=self.device)
        return bits_to_uniform(hash_bits(mask_seed, 0, 0, flat, 0)).reshape(tuple(shape))
