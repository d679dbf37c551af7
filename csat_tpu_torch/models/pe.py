"""The positional encodings other than pegen: treepos, laplacian, triplet.

Counterparts of the JAX package's ``models/pe.py`` (and of
``TRIPLET_VOCAB_FALLBACK``, ``models/csa_trans.py:50``):

* :class:`TreePositionalEncodings` — learnable geometric-decay tree
  encodings over the one-hot child-index chains of ``tree_pos``;
* :func:`laplacian_pe` — eigenvectors of each sample's symmetric-normalized
  Laplacian, one batched ``torch.linalg.eigh`` on the input's device, in
  float64 (XLA's ``eigh`` in JAX: no Pallas kernel stands behind it, so the
  library call is its port);
* :class:`TripletEmbedding` — a table over node-triplet ids.

Eigenvectors are unique only up to sign, and inside a repeated eigenvalue
only up to a rotation of that eigenspace; AST Laplacians have many repeated
eigenvalues (sibling leaves under one parent share one).  The CPU, the card
and JAX each return their own basis, so the laplacian PE agrees with JAX's by
invariants (eigenvalues, eigenspace projectors), not value by value.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["TRIPLET_VOCAB_FALLBACK", "TreePositionalEncodings", "padded_laplacian",
           "eigenvectors", "laplacian_pe", "TripletEmbedding"]

#: triplet table sizes the reference hard-codes per language, used when no
#: triplet dictionary is on disk
TRIPLET_VOCAB_FALLBACK = {"python": 1246, "java": 1505}

#: diagonal of the pad block: its eigenvalues sort after the real spectrum,
#: whose normalized-Laplacian eigenvalues are at most 2
_PAD_EIGENVALUE = 1e3


class TreePositionalEncodings(nn.Module):
    """positions ``(B, N, depth·width)`` → ``(B, N, depth·width·n_feat)``;
    one learned decay ``p`` per feature."""

    def __init__(self, depth: int, width: int, n_feat: int):
        super().__init__()
        self.depth, self.width, self.n_feat = depth, width, n_feat
        self.p = nn.Parameter(torch.empty(n_feat))

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        d_pos = self.n_feat * self.depth * self.width
        tree_params = torch.tanh(self.p)
        depths = torch.arange(self.depth, dtype=torch.float32, device=positions.device)
        norm = torch.sqrt((1.0 - tree_params ** 2) * d_pos / 2.0)
        tiled = tree_params.expand(self.depth, self.width, self.n_feat)
        weights = (torch.pow(tiled, depths[:, None, None]) * norm).reshape(
            self.depth * self.width, self.n_feat)
        treeified = positions.to(torch.float32)[..., None] * weights
        return treeified.reshape(positions.shape[:-1] + (d_pos,))


@torch.no_grad()
def padded_laplacian(adj: torch.Tensor, num_node: torch.Tensor) -> torch.Tensor:
    """``adj`` (B, N, N) — the ``|L| <= 1`` pseudo-adjacency — and
    ``num_node`` (B,) → (B, N, N) f32: each sample's symmetric-normalized
    Laplacian on its ``[:n, :n]`` block, and on the pad rows and columns a
    large identity block whose eigenvalues sort after the real spectrum."""
    n = adj.shape[1]
    dev = adj.device
    valid = torch.arange(n, device=dev)[None, :] < num_node.to(dev)[:, None]
    pair = valid[:, :, None] & valid[:, None, :]
    a = torch.where(pair, adj.to(torch.float32), torch.zeros((), device=dev))
    deg = a.sum(dim=-1)
    dinv = torch.where(valid, deg.clamp_min(1.0) ** -0.5, torch.zeros((), device=dev))
    eye = torch.eye(n, device=dev)[None]
    lap = eye * valid[:, None, :] - dinv[:, :, None] * a * dinv[:, None, :]
    return lap + eye * (~valid[:, None, :]) * _PAD_EIGENVALUE


@torch.no_grad()
def eigenvectors(lap: torch.Tensor) -> torch.Tensor:
    """The ascending eigenvectors (columns) of the symmetric ``lap`` (B, N,
    N) f32, decomposed in float64 and rounded to f32.  On the card
    ``torch.linalg.eigh`` of an f32 batch (a cuSOLVER Jacobi solver) leaves
    ``‖Lv − λv‖`` up to 1.3e-3 on AST Laplacians and columns orthonormal
    only to 5e-5, where the CPU's f32 LAPACK stays near 1e-6; in float64 both
    devices give the eigenvectors to f32 rounding."""
    return torch.linalg.eigh(lap.to(torch.float64))[1].to(torch.float32)


@torch.no_grad()
def laplacian_pe(adj: torch.Tensor, num_node: torch.Tensor, pegen_dim: int) -> torch.Tensor:
    """(B, N, pegen_dim) f32: the ascending eigenvectors of
    :func:`padded_laplacian`, pad rows and the pad block's eigenvectors
    zeroed, the first ``min(N, pegen_dim)`` kept and zero-padded on the
    right."""
    b, n, _ = adj.shape
    dev = adj.device
    valid = torch.arange(n, device=dev)[None, :] < num_node.to(dev)[:, None]
    pair = valid[:, :, None] & valid[:, None, :]
    vecs = eigenvectors(padded_laplacian(adj, num_node))
    vecs = torch.where(pair, vecs, torch.zeros((), device=dev))
    keep = min(n, pegen_dim)
    out = torch.zeros((b, n, pegen_dim), dtype=torch.float32, device=dev)
    out[:, :, :keep] = vecs[:, :, :keep]
    return out


class TripletEmbedding(nn.Module):
    """Node-triplet ids ``(B, N)`` → ``(B, N, pegen_dim)`` rows of the table
    ``weight``, cast to ``dtype``."""

    def __init__(self, vocab_size: int, pegen_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab_size, pegen_dim))
        self.dtype = dtype
        self.tp = None  # the model line: the table split on features

    def forward(self, triplet: torch.Tensor) -> torch.Tensor:
        from csat_tpu_torch.parallel.collectives import gather_features

        # indexing, as Embeddings does: its backward adds repeated ids' rows
        # in a fixed order
        rows = self.weight[triplet]
        return gather_features(rows, self.tp, rows.dim() - 1).to(self.dtype)
