"""Length-bucketed batching: kill the O(N²) padding tax.

Every batch the fixed-shape pipeline emits is padded to the config's
``(max_src_len, max_tgt_len)`` flagship shape, and the AST relation
matrices ``L``/``T`` are ``(B, N, N)`` — so padding waste is *quadratic*
in N for the CSE/SBM attention hot path and linear for the host→HBM
transfer.  Real AST sizes are heavily skewed small (the stdlib corpus
medians ~a third of N=150), so most of every step is spent attending
PAD-to-PAD.

This module assigns each sample to the smallest of a small configurable
set of ``(N, T)`` buckets (``Config.bucket_src_lens`` ×
``Config.bucket_tgt_lens``, default a geometric ladder capped by the
flagship shape) and batches per bucket under a **node budget**
(``Config.bucket_token_budget``, default ``batch_size · max_src_len``):
smaller buckets get proportionally larger batch sizes, so the per-step
*linear* work stays roughly constant while the quadratic work shrinks
with the bucket.

Numerical contract: a sample collated at bucket shape ``(n, t)`` runs
through the model **bit-identically** to the same sample collated at the
flagship shape, because

* the distance offset/clamp keeps using the *config's* ``max_src_len``
  (the CSE relative tables are ``(max_src_len, pegen_dim)`` regardless
  of batch N), so gather indices are unchanged;
* every attention path masks padded keys to an additive -inf/-1e9 whose
  ``exp`` underflows to exactly 0.0, so shorter rows drop only
  exact-zero summands;
* the loss normalizes by non-PAD target tokens, which the T-slice
  preserves (only trailing PAD columns are dropped).

(Deterministic exceptions: shape-keyed RNG — dropout masks and sampled
SBM graphs draw per-shape streams, so stochastic *training* paths are
equivalent-in-distribution, not bit-equal; the laplacian PE
eigendecomposition sees the pad block; and CSE rows with *no related
pair* softmax to uniform-over-the-padded-width under the reference's
-1e9 mask fill — ``Config.cse_empty_rows="zero"`` is the flagged
quirk-fix that makes them shape-invariant.  ``tests/test_bucketing.py``
pins the bit-identity on the deterministic paths.)

Multi-host lockstep: the plan (assignment, per-bucket batch starts, and
the interleave permutation) is a pure function of ``(dataset, cfg,
seed)``, computed identically on every host; each global batch is a
contiguous run of ``num_shards × batch_size`` planned samples of which
host ``shard_index`` takes its ``[shard_index::num_shards]`` slice — so
every host steps through the *same bucket-shape sequence* with the same
batch count, which lockstep collectives require.  The same determinism is
what lets the preemption resume marker replay the epoch and skip the
completed iterations (``train/checkpoint.py``).

The port's own copy of the JAX package's ``data/bucketing.py`` (NumPy only);
``tests/test_torch_data.py`` holds plans, assignments and batch sequences equal.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from csat_tpu_torch.configs import Config
from csat_tpu_torch.data.dataset import ASTDataset, Batch, collate_indexed
from csat_tpu_torch.utils import PAD

__all__ = [
    "BucketSpec",
    "plan_buckets",
    "plan_signature",
    "src_bucket_ladder",
    "sample_lengths",
    "assign_buckets",
    "bucket_views",
    "bucket_histogram",
    "iterate_bucketed_batches",
    "pad_batch",
    "slice_batch",
]


class BucketSpec(NamedTuple):
    """One compiled-program shape: ``src_seq`` is (B, n), ``tgt_seq``
    (B, t-1), ``L``/``T`` (B, n, n) — ``t`` counts like
    ``Config.max_tgt_len`` so the flagship bucket is exactly the fixed
    shape."""

    n: int  # AST-node capacity
    t: int  # NL capacity (max_tgt_len semantics; tgt_seq width is t-1)
    batch_size: int  # per-host rows per batch (node-budget derived)


def _default_src_ladder(max_src_len: int, min_len: int = 32) -> Tuple[int, ...]:
    """Geometric halving ladder capped by the flagship N: 150 → (37, 75, 150)."""
    out = [max_src_len]
    while out[-1] // 2 >= min_len:
        out.append(out[-1] // 2)
    return tuple(sorted(out))


def src_bucket_ladder(cfg: Config) -> Tuple[int, ...]:
    """Ascending node-capacity ladder for a config — ``bucket_src_lens``
    capped by the flagship N (always appended), or the default geometric
    halving ladder.  Shared by the training bucket grid below and by the
    serving engine's prefill shapes (``csat_tpu_torch/serve/prefill.py``), so a
    trained run and its serving deployment compile the same encoder
    geometries and the persistent compilation cache carries over."""
    src_lens = tuple(cfg.bucket_src_lens) or _default_src_ladder(cfg.max_src_len)
    return tuple(sorted({min(n, cfg.max_src_len) for n in src_lens} | {cfg.max_src_len}))


def plan_buckets(cfg: Config) -> Tuple[BucketSpec, ...]:
    """The bucket grid for a config, sorted ascending by ``(n, t)``.

    The flagship ``(max_src_len, max_tgt_len)`` shape is always present
    (appended if the configured ladders omit it), so every sample fits
    *some* bucket.  Batch sizes follow the node budget ``budget // n``
    and never drop below 1; the flagship bucket under the default budget
    reproduces ``cfg.batch_size`` exactly.
    """
    src_lens = src_bucket_ladder(cfg)
    tgt_lens = tuple(cfg.bucket_tgt_lens) or (cfg.max_tgt_len,)
    tgt_lens = tuple(sorted({min(t, cfg.max_tgt_len) for t in tgt_lens} | {cfg.max_tgt_len}))
    assert all(t >= 2 for t in tgt_lens), tgt_lens  # tgt_seq width t-1 >= 1
    assert all(n >= 1 for n in src_lens), src_lens
    budget = cfg.bucket_token_budget or cfg.batch_size * cfg.max_src_len
    return tuple(
        BucketSpec(n, t, max(1, budget // n)) for n in src_lens for t in tgt_lens
    )


def plan_signature(cfg: Config) -> str:
    """Stable identifier of the plan geometry, stamped into the preemption
    resume marker: resuming a bucketed run under a *different* plan would
    silently replay a different batch sequence, so the Trainer refuses a
    marker whose signature does not match the current config."""
    if not cfg.bucketing:
        return f"fixed-{cfg.max_src_len}x{cfg.max_tgt_len}x{cfg.batch_size}"
    return "bucketed-" + ",".join(
        f"{s.n}x{s.t}x{s.batch_size}" for s in plan_buckets(cfg)
    )


def sample_lengths(arrays: Dict[str, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sample ``(num_node, tgt_width)`` — ``tgt_width`` is the non-PAD
    width of the stored ``tgt_seq`` row (BOS + words; its shifted
    ``target`` twin has the same count)."""
    num_node = np.asarray(arrays["num_node"], dtype=np.int64)
    tgt_width = np.asarray((arrays["tgt_seq"] != PAD).sum(axis=1), dtype=np.int64)
    return num_node, tgt_width


def assign_buckets(
    specs: Sequence[BucketSpec], num_node: np.ndarray, tgt_width: np.ndarray
) -> np.ndarray:
    """Smallest-fitting-bucket index per sample (first fit over the
    ``(n, t)``-sorted grid; the flagship bucket is a guaranteed fit)."""
    assign = np.full(len(num_node), len(specs) - 1, dtype=np.int64)
    unset = np.ones(len(num_node), dtype=bool)
    for k, spec in enumerate(specs):
        fits = unset & (num_node <= spec.n) & (tgt_width <= spec.t - 1)
        assign[fits] = k
        unset &= ~fits
    assert not unset.any(), (
        "samples exceed every bucket — the flagship bucket must fit all"
    )
    return assign


def bucket_views(arrays: Dict[str, np.ndarray], n: int, t: int) -> Dict[str, np.ndarray]:
    """Zero-copy sequence-dim views of the dataset-resident arrays at
    bucket shape ``(n, t)``.

    Safe because a sample assigned to the bucket has ``num_node <= n``
    and the build zero-fills beyond ``num_node`` — the slice drops only
    all-zero padding.  The views are non-contiguous, so
    :func:`collate_indexed` takes its NumPy fallback: the per-batch
    gather+collate cost becomes O(B·n²) instead of O(B·N²), which is the
    host-side half of the padding-tax win.
    """
    t1 = t - 1
    return {
        "src_seq": arrays["src_seq"][:, :n],
        "tgt_seq": arrays["tgt_seq"][:, :t1],
        "target": arrays["target"][:, :t1],
        "L_raw": arrays["L_raw"][:, :n, :n],
        "T_raw": arrays["T_raw"][:, :n, :n],
        "num_node": arrays["num_node"],
        "tree_pos": arrays["tree_pos"][:, :n, :],
        "triplet": arrays["triplet"][:, :n],
    }


def bucket_histogram(cfg: Config, arrays: Dict[str, np.ndarray]) -> Dict[str, object]:
    """Per-bucket occupancy + the padded-vs-real node accounting for a
    corpus: what fraction of fed nodes would be PAD under the fixed shape
    vs under this plan (``tools/padding_stats.py`` renders this)."""
    specs = plan_buckets(cfg)
    num_node, tgt_width = sample_lengths(arrays)
    assign = assign_buckets(specs, num_node, tgt_width)
    buckets = []
    for k, spec in enumerate(specs):
        sel = assign == k
        count = int(sel.sum())
        real = int(num_node[sel].sum())
        buckets.append(
            {
                "n": spec.n,
                "t": spec.t,
                "batch_size": spec.batch_size,
                "samples": count,
                "real_nodes": real,
                "bucketed_nodes": count * spec.n,
                "fixed_nodes": count * cfg.max_src_len,
            }
        )
    real = int(num_node.sum())
    bucketed = sum(b["bucketed_nodes"] for b in buckets)
    fixed = len(num_node) * cfg.max_src_len
    # the relation matrices scale with n², which is where the tax bites
    bucketed_sq = sum(b["samples"] * b["n"] ** 2 for b in buckets)
    fixed_sq = len(num_node) * cfg.max_src_len ** 2
    return {
        "samples": int(len(num_node)),
        "buckets": buckets,
        "real_nodes": real,
        "fixed_nodes": fixed,
        "bucketed_nodes": bucketed,
        "real_node_fraction_fixed": real / fixed if fixed else 0.0,
        "real_node_fraction_bucketed": real / bucketed if bucketed else 0.0,
        "relation_bytes_ratio_bucketed_vs_fixed": (
            bucketed_sq / fixed_sq if fixed_sq else 0.0
        ),
    }


def iterate_bucketed_batches(
    dataset: ASTDataset,
    cfg: Config,
    shuffle: bool,
    seed: int = 0,
    drop_last: bool = True,
    num_shards: int = 1,
    shard_index: int = 0,
    batch_hook=None,
    on_batch_error=None,
    with_spec: bool = False,
) -> Iterator:
    """Bucketed drop-in for :func:`~csat_tpu_torch.data.dataset.iterate_batches`.

    Same contract (host-sharding lockstep, deterministic under ``seed``,
    resilience hooks with identical semantics), different batch shapes:
    each yielded batch is collated at its bucket's ``(n, t)`` with the
    bucket's node-budget batch size.  With ``shuffle`` the sample
    permutation *and* the bucket-batch interleave both derive
    deterministically from ``seed``, so every host sees the identical
    bucket-shape sequence and a ``resume_marker`` iteration count replays
    exactly (``itertools.islice`` over this iterator is the resume path).

    With ``drop_last`` (training) a bucket's tail that cannot fill a
    whole ``num_shards × batch_size`` global batch **spills into the next
    bucket that fits those samples** (capacities only grow, so the
    flagship bucket is a guaranteed landing spot): without the cascade, a
    bucket populated below its batch size would silently never train its
    samples — and since assignment is length-determined, it would be the
    *same* samples every epoch.  Only the flagship bucket's final
    sub-batch tail is dropped, like the fixed-shape path's.

    ``drop_last=False`` (eval) keeps **every** sample: per-bucket tails
    come out as short batches — callers pad rows back to the bucket batch
    size with :func:`pad_batch` to reuse the compiled program
    (``with_spec=True`` yields ``(spec, batch)`` so they know the
    target).  Under multi-host sharding the per-host slices may be ragged
    (lengths differ by ≤ 1); the per-host *batch count* is computed from
    the longest host so every host steps in lockstep, shorter hosts
    yielding a short (possibly empty) final batch that row-padding
    absorbs.  No trim: unlike the fixed-shape eval path, bucketed eval
    scores the full dataset on any topology.
    """
    specs = plan_buckets(cfg)
    arrays = dataset.arrays
    num_node, tgt_width = sample_lengths(arrays)
    assign = assign_buckets(specs, num_node, tgt_width)

    idx = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)

    host_idx: Dict[int, np.ndarray] = {}
    order: List[Tuple[int, int]] = []  # (spec index, host-local start row)
    spilled: List[np.ndarray] = [np.zeros(0, np.int64)] * len(specs)
    for k, spec in enumerate(specs):
        pool = idx[assign[idx] == k]
        if len(spilled[k]):
            pool = np.concatenate([pool, spilled[k]])
        if drop_last:
            g = spec.batch_size * num_shards
            n_batches = len(pool) // g
            used, tail = pool[: n_batches * g], pool[n_batches * g:]
            if len(tail):
                # cascade the sub-batch tail to the next fitting bucket
                # (per sample — the (n, t) grid is not totally ordered)
                for i in tail:
                    for k2 in range(k + 1, len(specs)):
                        if (num_node[i] <= specs[k2].n
                                and tgt_width[i] <= specs[k2].t - 1):
                            spilled[k2] = np.append(spilled[k2], i)
                            break
        else:
            # keep every sample; batch count follows the LONGEST host's
            # slice so all hosts yield equally many batches per bucket
            # (shorter hosts end on a short / empty chunk)
            used = pool
            longest = math.ceil(len(pool) / num_shards)
            n_batches = math.ceil(longest / spec.batch_size)
        host_idx[k] = used[shard_index::num_shards]
        order.extend((k, s * spec.batch_size) for s in range(n_batches))
    if shuffle:
        # deterministic bucket interleave, identical on every host: without
        # it the epoch would train all-small then all-large batches
        perm = np.random.default_rng(seed + 0x5EED).permutation(len(order))
        order = [order[p] for p in perm]

    views: Dict[int, Dict[str, np.ndarray]] = {}
    for k, start in order:
        spec = specs[k]
        chunk = host_idx[k][start : start + spec.batch_size]
        if k not in views:
            views[k] = bucket_views(arrays, spec.n, spec.t)
        try:
            batch = collate_indexed(views[k], chunk, cfg.max_src_len)
            if batch_hook is not None:
                batch = batch_hook(chunk, batch)
        except Exception as e:  # noqa: BLE001 — policy decides, not us
            if on_batch_error is not None and on_batch_error(chunk, e):
                continue
            raise
        yield (spec, batch) if with_spec else batch


def slice_batch(batch: Batch, n: int, t: int) -> Batch:
    """Slice an already-collated batch down to bucket shape ``(n, t)``.

    For samples that *fit* the bucket (``num_node <= n``, tgt width
    ``<= t-1``) this is exactly the batch the bucketed collate would have
    produced — the sliced-away region holds only collate padding (offset
    distances, True masks, quirk-adjacency 1s, PAD tokens).  The inverse
    of :func:`pad_batch`'s sequence-dim growth; the parity tests pin the
    round-trip."""
    t1 = t - 1
    return batch._replace(
        src_seq=batch.src_seq[:, :n],
        tgt_seq=batch.tgt_seq[:, :t1],
        target=batch.target[:, :t1],
        L=batch.L[:, :n, :n],
        T=batch.T[:, :n, :n],
        L_mask=batch.L_mask[:, :n, :n],
        T_mask=batch.T_mask[:, :n, :n],
        adj=batch.adj[:, :n, :n],
        tree_pos=batch.tree_pos[:, :n, :],
        triplet=batch.triplet[:, :n],
    )


def _pad_to(x: np.ndarray, axis: int, size: int, value) -> np.ndarray:
    if x.shape[axis] >= size:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, size - x.shape[axis])
    return np.pad(x, widths, constant_values=value)


def pad_batch(
    batch: Batch,
    rows: Optional[int] = None,
    n: Optional[int] = None,
    t: Optional[int] = None,
    max_src_len: Optional[int] = None,
) -> Tuple[Batch, int]:
    """Pad a :class:`Batch` up to ``rows`` batch rows and/or sequence
    capacities ``(n, t)``, returning ``(padded, real_rows)``.

    The generalization of the old batch-dim-only tail padding: sequence
    dims are padded with the exact values :func:`collate` produces for
    absent nodes (``L``/``T`` at the offset ``max_src_len // 2``, masks
    ``True``, ``adj`` 1 — the reference's L==0 "unrelated counts as
    adjacent" quirk), so a padded batch is indistinguishable from one
    collated at the larger shape.  Row padding uses the same values —
    a pad row is the collate of an empty sample.  ``max_src_len`` is the
    *config* flagship length (the offset base), required when ``n`` or
    ``rows`` pads relation fields.
    """
    real = batch.src_seq.shape[0]
    rows = rows or real
    t1 = (t - 1) if t is not None else batch.tgt_seq.shape[1]
    n = n if n is not None else batch.src_seq.shape[1]
    if (
        rows == real
        and n == batch.src_seq.shape[1]
        and t1 == batch.tgt_seq.shape[1]
    ):
        return batch, real
    assert max_src_len is not None, "max_src_len needed to pad relation fields"
    off = max_src_len // 2
    b = Batch(*(np.asarray(x) for x in batch))
    out = Batch(
        src_seq=_pad_to(_pad_to(b.src_seq, 1, n, PAD), 0, rows, PAD),
        tgt_seq=_pad_to(_pad_to(b.tgt_seq, 1, t1, PAD), 0, rows, PAD),
        target=_pad_to(_pad_to(b.target, 1, t1, PAD), 0, rows, PAD),
        L=_pad_to(_pad_to(_pad_to(b.L, 1, n, off), 2, n, off), 0, rows, off),
        T=_pad_to(_pad_to(_pad_to(b.T, 1, n, off), 2, n, off), 0, rows, off),
        L_mask=_pad_to(_pad_to(_pad_to(b.L_mask, 1, n, True), 2, n, True), 0, rows, True),
        T_mask=_pad_to(_pad_to(_pad_to(b.T_mask, 1, n, True), 2, n, True), 0, rows, True),
        num_node=_pad_to(b.num_node, 0, rows, 0),
        adj=_pad_to(_pad_to(_pad_to(b.adj, 1, n, 1), 2, n, 1), 0, rows, 1),
        tree_pos=_pad_to(_pad_to(b.tree_pos, 1, n, 0), 0, rows, 0),
        triplet=_pad_to(_pad_to(b.triplet, 1, n, PAD), 0, rows, PAD),
    )
    return out, real
