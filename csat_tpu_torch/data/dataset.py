"""Dataset + collate: on-disk artifacts → batched arrays → the model's input record.

The port's own copy of the JAX package's ``data/dataset.py``:
:class:`ASTDataset` loads one split produced by ``data/preprocess.py`` into
stacked fixed-shape arrays (same ``processed_data_*.npz`` cache key),
:func:`collate` applies the reference's mask-before-offset ordering
(``base_data_set.py:20-75``): relation masks come from the RAW distances
(``L == 0`` / ``T == 0``), then distances are offset by ``max_src_len // 2``
and clamped to ``[0, max_src_len - 1]`` (the offset is always the flagship
one, also when a smaller bucket slices the arrays), and
:func:`iterate_batches` is the fixed-shape minibatch iterator, shuffled by
numpy from its seed.  ``tests/test_torch_data.py`` holds arrays and batch
sequences equal to the JAX package's.  :func:`batch_to_device` is the port's
own: the model's inputs as tensors.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from csat_tpu_torch.configs import Config
from csat_tpu_torch.data.ast_tools import TreeRecord
from csat_tpu_torch.data.vocab import Vocab
from csat_tpu_torch.utils import BOS_WORD, EOS_WORD, PAD, UNK

__all__ = ["Batch", "ASTDataset", "collate", "collate_indexed", "load_matrices",
           "save_matrices", "node_triplets", "gen_tree_positions", "iterate_batches",
           "batch_to_device"]


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


def save_matrices(
    path: str,
    records: Sequence[TreeRecord],
    levels: Sequence[np.ndarray],
    Ls: Sequence[np.ndarray],
    Ts: Sequence[np.ndarray],
) -> None:
    """Write ``split_matrices.npz`` with the reference's key set
    (``my_ast.py:88-96``); ``root_first_seq`` holds :class:`TreeRecord`
    objects instead of pickled linked ``Node`` graphs."""
    np.savez(
        path,
        root_first_seq=np.asarray(records, dtype=object),
        root_first_level=np.asarray(levels, dtype=object),
        L=np.asarray(Ls, dtype=object),
        T=np.asarray(Ts, dtype=object),
        parent=np.asarray([None] * len(records), dtype=object),
        brother=np.asarray([None] * len(records), dtype=object),
    )


def load_matrices(path: str):
    return np.load(path, allow_pickle=True)


def _effective_child_idx(rec: TreeRecord) -> np.ndarray:
    """child_idx after the reference's in-place mutation pass
    (``fast_ast_data_set.py:38-44,119-120``): root forced to 0, nodes whose
    label kind is ``"idx"`` forced to -1. The reference runs this *before*
    both triplet and tree-position generation, so both consume it here."""
    n = len(rec)
    child_idx = rec.child_idx.astype(np.int64).copy()
    if n:
        child_idx[0] = 0
    for i in range(n):
        if rec.labels[i].split(":")[0] == "idx":
            child_idx[i] = -1
    return child_idx


def node_triplets(rec: TreeRecord) -> List[str]:
    """``str((level, parent.child_idx, child_idx))`` per node
    (ref ``fast_ast_data_set.py:47-50,116-122``)."""
    n = len(rec)
    child_idx = _effective_child_idx(rec)
    out = ["(0, 0, 0)"] if n else []
    for i in range(1, n):
        p = int(rec.parent_idx[i])
        out.append(str((int(rec.levels[i]), int(child_idx[p]), int(child_idx[i]))))
    return out


def gen_tree_positions(rec: TreeRecord, width: int = 8, height: int = 16) -> np.ndarray:
    """(n, width*height) one-hot child-index chains, root-first.

    Each node's vector is ``[onehot(child_idx), parent_chain...]`` left-padded
    with zeros to ``width*height`` (deep chains keep the most recent levels),
    per ref ``gen_tree_positions`` + padding at ``fast_ast_data_set.py:136-147``.
    A child_idx of -1 (the "idx" kind quirk) wraps to the last slot, matching
    torch's negative indexing.
    """
    n = len(rec)
    budget = width * height
    child_idx = _effective_child_idx(rec)
    chains: List[np.ndarray] = []
    out = np.zeros((n, budget), dtype=np.float32)
    for i in range(n):
        if i == 0:
            chains.append(np.zeros(0, dtype=np.float32))
            continue
        ci = min(int(child_idx[i]), width - 1)
        own = np.zeros(width, dtype=np.float32)
        own[ci] = 1.0  # ci == -1 wraps to width-1, as in torch
        chain = np.concatenate([own, chains[int(rec.parent_idx[i])]])
        chains.append(chain)
        v = chain[-budget:] if chain.shape[0] > budget else chain
        out[i, budget - v.shape[0]:] = v
    return out


def _word2ids(tokens: Sequence[str], max_len: int, vocab: Vocab) -> np.ndarray:
    ids = [vocab.w2i.get(t, UNK) for t in tokens]
    ids = ids + [PAD] * (max_len - len(ids))
    return np.asarray(ids, dtype=np.int32)


class ASTDataset:
    """Loads one split from disk into stacked fixed-shape arrays.

    First use converts ``split_pot.seq`` + ``split_matrices.npz`` +
    ``nl.original`` into a cached ``processed_data.npz``
    (the analogue of the reference's ``processed_data.pt`` cache,
    ``fast_ast_data_set.py:66-82``).
    """

    def __init__(
        self,
        config: Config,
        split: str,
        src_vocab: Vocab,
        tgt_vocab: Vocab,
        use_cache: bool = True,
    ):
        self.config = config
        self.split = split
        split_dir = os.path.join(config.data_dir, split)
        # cache keyed by every config axis that shapes the arrays
        cache_key = (
            f"N{config.max_src_len}_T{config.max_tgt_len}"
            f"_tp{config.tree_pos_width}x{config.tree_pos_height}_{config.lang}"
            "_v2"  # v2: tree_pos stored uint8 (compressed device feed)
        )
        cache = os.path.join(split_dir, f"processed_data_{cache_key}.npz")
        if use_cache and os.path.exists(cache):
            arrs = np.load(cache)
            self.arrays = {k: arrs[k] for k in arrs.files}
        else:
            self.arrays = self._build(split_dir, src_vocab, tgt_vocab)
            if use_cache:
                # written aside and renamed: a process loading the corpus
                # beside this one sees no cache or a whole one, never a torn file
                tmp = f"{cache}.{os.getpid()}.tmp.npz"
                np.savez_compressed(tmp, **self.arrays)
                os.replace(tmp, cache)
        self.size = int(self.arrays["src_seq"].shape[0])

    def _build(self, split_dir: str, src_vocab: Vocab, tgt_vocab: Vocab) -> Dict[str, np.ndarray]:
        cfg = self.config
        N, Tmax = cfg.max_src_len, cfg.max_tgt_len
        with open(os.path.join(split_dir, "nl.original"), "r", encoding="utf-8") as f:
            nls = [line.split() for line in f]
        mats = load_matrices(os.path.join(split_dir, "split_matrices.npz"))
        records = mats["root_first_seq"]
        Ls, Ts = mats["L"], mats["T"]

        trip_vocab = self._triplet_vocab()

        n_samples = len(records)
        out = {
            "src_seq": np.zeros((n_samples, N), np.int32),
            "tgt_seq": np.zeros((n_samples, Tmax - 1), np.int32),
            "target": np.zeros((n_samples, Tmax - 1), np.int32),
            "L_raw": np.zeros((n_samples, N, N), np.int16),
            "T_raw": np.zeros((n_samples, N, N), np.int16),
            "num_node": np.zeros((n_samples,), np.int32),
            "tree_pos": np.zeros((n_samples, N, cfg.tree_pos_width * cfg.tree_pos_height), np.uint8),
            "triplet": np.zeros((n_samples, N), np.int32),
        }
        for i in range(n_samples):
            rec: TreeRecord = records[i]
            if len(rec) > N:
                rec = TreeRecord(
                    rec.labels[:N], rec.parent_idx[:N], rec.child_idx[:N], rec.levels[:N]
                )
            L = np.asarray(Ls[i])[:N, :N]
            T = np.asarray(Ts[i])[:N, :N]
            n = L.shape[0]
            out["L_raw"][i, :n, :n] = L.astype(np.int16)
            out["T_raw"][i, :n, :n] = T.astype(np.int16)
            # value field of each label, as the reference's convert_ast_to_tensor
            ast_tokens = [":".join(e.split(":")[1:-1]) for e in rec.labels[:N]]
            out["src_seq"][i] = _word2ids(ast_tokens, N, src_vocab)
            nl = nls[i][: Tmax - 2]
            nl_ids = _word2ids([BOS_WORD] + nl + [EOS_WORD], Tmax, tgt_vocab)
            out["tgt_seq"][i] = nl_ids[:-1]
            out["target"][i] = nl_ids[1:]
            out["num_node"][i] = min(len(rec), N)
            tp = gen_tree_positions(rec, cfg.tree_pos_width, cfg.tree_pos_height)
            out["tree_pos"][i, : tp.shape[0]] = tp
            trips = node_triplets(rec)
            out["triplet"][i, : len(trips)] = [
                trip_vocab.w2i.get(t, UNK) for t in trips
            ] if trip_vocab else [UNK] * len(trips)
        return out

    def _triplet_vocab(self) -> Optional[Vocab]:
        cfg = self.config
        for lang in (cfg.lang, "java", "python"):
            path = os.path.join(cfg.data_dir, f"node_triplet_dictionary_{lang}.pt")
            if os.path.exists(path):
                return Vocab(need_bos=False, file_path=path).load()
        return None

    def __len__(self) -> int:
        return self.size


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


def collate_indexed(
    arrays: Dict[str, np.ndarray], idx: np.ndarray, max_src_len: int
) -> Batch:
    """Gather rows ``idx`` off the dataset-resident arrays and collate them
    (NumPy fancy index + :func:`collate`; the JAX package's optional native
    single-pass gather is bit-identical to this path and is not carried)."""
    return collate({k: v[idx] for k, v in arrays.items()}, max_src_len)


def iterate_batches(
    dataset: ASTDataset,
    batch_size: int,
    shuffle: bool,
    seed: int = 0,
    drop_last: bool = True,
    num_shards: int = 1,
    shard_index: int = 0,
    batch_hook=None,
    on_batch_error=None,
) -> Iterator[Batch]:
    """Minibatch iterator with optional host-sharding (each host reads its
    own slice — the JAX-native replacement for ``DistributedSampler``,
    ref ``script/train.py:135-142``).

    Fixed-shape: every batch is padded to ``(max_src_len, max_tgt_len)``.
    The length-bucketed sibling with the same contract (determinism,
    lockstep sharding, resilience hooks) but per-bucket shapes is
    :func:`csat_tpu_torch.data.bucketing.iterate_bucketed_batches`.

    ``seed`` must be identical on every host (pass ``config.seed + epoch``):
    the permutation is derived from it deterministically so the shards form a
    partition. The index set is trimmed to a multiple of ``num_shards`` so
    every shard yields the same number of batches — required for lockstep
    multi-host collectives.

    Resilience hooks (``csat_tpu_torch/resilience``): ``batch_hook(chunk, batch)``
    runs per produced batch (the fault harness injects corrupt batches
    here); a collate/hook exception is offered to
    ``on_batch_error(chunk, exc)`` — return True to quarantine-and-skip
    the batch (the :class:`~csat_tpu_torch.resilience.retry.ErrorBudget`
    policy), anything else re-raises. The handling lives *inside* the
    generator because a generator that raises is closed — skipping must
    happen where iteration can continue.
    """
    idx = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    usable = (len(idx) // num_shards) * num_shards
    idx = idx[:usable][shard_index::num_shards]
    n_full = len(idx) // batch_size
    end = n_full * batch_size if drop_last else len(idx)
    for s in range(0, end, batch_size):
        chunk = idx[s : s + batch_size]
        if drop_last and len(chunk) < batch_size:
            break
        try:
            batch = collate_indexed(dataset.arrays, chunk, dataset.config.max_src_len)
            if batch_hook is not None:
                batch = batch_hook(chunk, batch)
        except Exception as e:  # noqa: BLE001 — policy decides, not us
            if on_batch_error is not None and on_batch_error(chunk, e):
                continue
            raise
        yield batch


#: the fields a batch carries to the device, with their compute dtypes
DEVICE_FIELDS = (("src_seq", torch.long), ("tgt_seq", torch.long), ("target", torch.long),
                 ("L", torch.int32), ("T", torch.int32), ("L_mask", torch.bool),
                 ("T_mask", torch.bool))


def batch_to_device(batch: Batch, device: torch.device) -> Batch:
    """The model's inputs as tensors on ``device``, widened to the compute
    dtypes (int64 token ids, int32 distances, bool masks; ``DEVICE_FIELDS``);
    the fields only a PE variant reads (``num_node``, ``adj``, ``tree_pos``,
    ``triplet``) stay on the host, and the model moves the one its variant
    reads."""
    return batch._replace(**{
        name: torch.as_tensor(np.asarray(getattr(batch, name))).to(device=device, dtype=dtype)
        for name, dtype in DEVICE_FIELDS})
