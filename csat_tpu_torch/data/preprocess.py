"""Preprocessing entry point: ``ast.original`` JSON lines → on-disk training artifacts.

Capability parity with the reference's ``process.py`` + ``my_ast.py``:
for each split, parse every JSON AST, truncate to ``max_ast_len`` nodes
pre-order, emit ``split_pot.seq`` (stringified label-list 1-tuples, one per
line) and ``split_matrices.npz`` (tree records + L/T matrices), copy
``nl.original``; then build vocabs.  Parallel over samples with a process
pool (the reference fans out with joblib n_jobs=30, ``my_ast.py:22,49-52``).

Usage::

    python -m csat_tpu_torch.data.preprocess --data_dir ./data/tree_sitter_python \
        --max_ast_len 150 --process --make_vocab

The port's own copy of the JAX package's ``data/preprocess.py`` (host-only code, no JAX
in it); ``tests/test_torch_data.py`` holds the two together.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from concurrent.futures import ProcessPoolExecutor
from typing import List, Tuple

import numpy as np

from csat_tpu_torch.data.ast_tools import (
    TreeRecord,
    ast_json_to_tree,
    build_matrices,
    tree_to_record,
    truncate_preorder,
)
from csat_tpu_torch.data.vocab import create_vocab

__all__ = ["process_split", "process_dataset"]

SPLITS = ("train", "dev", "test")


def _process_one(args: Tuple[str, int]):
    line, max_size = args
    root = ast_json_to_tree(json.loads(line))
    seq = truncate_preorder(root, max_size)
    L, T = build_matrices(seq, max_size)
    rec = tree_to_record(seq)
    levels = np.zeros(max_size, dtype=np.int32)
    levels[: len(rec)] = rec.levels
    return rec, levels, L, T


def process_split(
    split_dir: str, max_ast_len: int, n_jobs: int = 0, ignore_idx: Tuple[int, ...] = ()
) -> int:
    """Process one split directory containing ``ast.original`` (+ ``nl.original``).

    ``ignore_idx``: 0-based RAW line indices (shared by ``ast.original`` and
    ``nl.original``) to drop from both streams — the reference's ast-trans
    comparison mode (``process.py:15-28,34-40``,
    ``skip_code_and_nl_with_skip_id``), which filters samples the comparison
    pipeline cannot process so corpora stay aligned across frameworks.
    Idempotent: the first filtering run snapshots the pristine files to
    ``*.raw`` and every subsequent run re-filters from the snapshot.
    """
    ast_path = os.path.join(split_dir, "ast.original")
    nl_path = os.path.join(split_dir, "nl.original")
    if ignore_idx:
        skip = set(ignore_idx)
        # filter from pristine snapshots so re-running never double-drops
        for path in (ast_path, nl_path):
            if not os.path.exists(path) and not os.path.exists(path + ".raw"):
                continue
            if not os.path.exists(path + ".raw"):
                shutil.copy(path, path + ".raw")
            with open(path + ".raw", "r", encoding="utf-8", errors="replace") as f:
                raw = f.read().splitlines()
            kept = [ln for i, ln in enumerate(raw) if i not in skip]
            with open(path, "w", encoding="utf-8") as f:
                f.write("\n".join(kept) + "\n")
    with open(ast_path, "r", encoding="utf-8", errors="replace") as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]

    work = [(ln, max_ast_len) for ln in lines]
    if n_jobs and n_jobs > 1:
        with ProcessPoolExecutor(max_workers=n_jobs) as ex:
            results = list(ex.map(_process_one, work, chunksize=64))
    else:
        results = [_process_one(w) for w in work]

    records: List[TreeRecord] = []
    levels, Ls, Ts, pot_lines = [], [], [], []
    for rec, lvl, L, T in results:
        records.append(rec)
        levels.append(lvl)
        # store L/T compactly; collate re-derives masks from raw distances
        Ls.append(L.astype(np.int16))
        Ts.append(T.astype(np.int16))
        pot_lines.append(str((rec.labels,)))

    from csat_tpu_torch.data.dataset import save_matrices

    save_matrices(os.path.join(split_dir, "split_matrices.npz"), records, levels, Ls, Ts)
    with open(os.path.join(split_dir, "split_pot.seq"), "w", encoding="utf-8") as f:
        f.write("\n".join(pot_lines))
    return len(records)


def process_dataset(
    data_dir: str,
    max_ast_len: int,
    make_vocab: bool = True,
    n_jobs: int = 0,
    ignore_idx: dict = None,
) -> None:
    """``ignore_idx``: optional {split: (indices…)} for the ast-trans
    comparison mode (see :func:`process_split`)."""
    for split in SPLITS:
        split_dir = os.path.join(data_dir, split)
        if not os.path.exists(os.path.join(split_dir, "ast.original")):
            continue
        skip = tuple((ignore_idx or {}).get(split, ()))
        n = process_split(split_dir, max_ast_len, n_jobs=n_jobs, ignore_idx=skip)
        print(f"{split}: processed {n} ASTs (max {max_ast_len} nodes)")
    if make_vocab:
        src_v, tgt_v, trip_v = create_vocab(data_dir)
        print(
            f"vocabs: ast={src_v.size()} nl={tgt_v.size()} triplet={trip_v.size()}"
        )


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--max_ast_len", type=int, default=150)
    p.add_argument("--process", action="store_true")
    p.add_argument("--make_vocab", action="store_true")
    p.add_argument("--n_jobs", type=int, default=os.cpu_count() or 1)
    p.add_argument(
        "--ignore_idx",
        default=None,
        help='JSON {split: [indices]} to drop (ast-trans comparison mode, ref process.py:34-40)',
    )
    args = p.parse_args()
    ignore = json.loads(args.ignore_idx) if args.ignore_idx else None
    if args.process:
        process_dataset(
            args.data_dir, args.max_ast_len, make_vocab=False, n_jobs=args.n_jobs,
            ignore_idx=ignore,
        )
    if args.make_vocab:
        src_v, tgt_v, trip_v = create_vocab(args.data_dir)
        print(f"vocabs: ast={src_v.size()} nl={tgt_v.size()} triplet={trip_v.size()}")


if __name__ == "__main__":
    main()
