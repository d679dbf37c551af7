"""Batch + collate: raw per-sample arrays → the model's input record.

A copy of the JAX package's ``data/dataset.py:Batch``/``collate`` with the
reference's mask-before-offset ordering (``base_data_set.py:20-75``):
relation masks come from the RAW distances (``L == 0`` / ``T == 0``), then
distances are offset by ``max_src_len // 2`` and clamped to
``[0, max_src_len - 1]``.  The offset is always the flagship one, also when a
smaller prefill bucket slices the arrays.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

__all__ = ["Batch", "collate", "batch_to_device"]


class Batch(NamedTuple):
    src_seq: np.ndarray   # (B, N) int32 — AST token ids, PAD-padded
    tgt_seq: np.ndarray   # (B, T-1) int32 — decoder input
    target: np.ndarray    # (B, T-1) int32
    L: np.ndarray         # (B, N, N) int16 — offset ancestor distances
    T: np.ndarray         # (B, N, N) int16 — offset sibling distances
    L_mask: np.ndarray    # (B, N, N) bool — raw L == 0
    T_mask: np.ndarray    # (B, N, N) bool — raw T == 0
    num_node: np.ndarray  # (B,) int32
    adj: np.ndarray       # (B, N, N) uint8 — |L| <= 1
    tree_pos: np.ndarray  # (B, N, width*height) uint8
    triplet: np.ndarray   # (B, N) int32


def collate(arrs: Dict[str, np.ndarray], max_src_len: int) -> Batch:
    """Raw per-sample arrays → :class:`Batch` (mask before offset)."""
    L_raw = arrs["L_raw"].astype(np.int32)
    T_raw = arrs["T_raw"].astype(np.int32)
    off = max_src_len // 2
    hi = max_src_len - 1
    return Batch(
        src_seq=arrs["src_seq"].astype(np.int32),
        tgt_seq=arrs["tgt_seq"].astype(np.int32),
        target=arrs["target"].astype(np.int32),
        L=np.clip(L_raw + off, 0, hi).astype(np.int16),
        T=np.clip(T_raw + off, 0, hi).astype(np.int16),
        L_mask=L_raw == 0,
        T_mask=T_raw == 0,
        num_node=arrs["num_node"].astype(np.int32),
        adj=(np.abs(L_raw) <= 1).astype(np.uint8),
        tree_pos=arrs["tree_pos"].astype(np.uint8),
        triplet=arrs["triplet"].astype(np.int32),
    )


def batch_to_device(batch: Batch, device: torch.device) -> Batch:
    """The model's inputs as tensors on ``device``, widened to the compute
    dtypes (int64 token ids, int32 distances, bool masks); fields the model
    never reads (``num_node``, ``adj``, ``tree_pos``, ``triplet``) stay on
    the host."""
    def put(x, dtype):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)

    return batch._replace(
        src_seq=put(batch.src_seq, torch.long),
        tgt_seq=put(batch.tgt_seq, torch.long),
        target=put(batch.target, torch.long),
        L=put(batch.L, torch.int32),
        T=put(batch.T, torch.int32),
        L_mask=put(batch.L_mask, torch.bool),
        T_mask=put(batch.T_mask, torch.bool),
    )
