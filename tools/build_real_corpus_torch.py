"""Build a real code-summarization corpus from the Python standard library,
through the PyTorch port's data pipeline.

The twin of ``tools/build_real_corpus.py``: the same harvest, filters,
split and flags, with extraction and preprocessing from ``csat_tpu_torch``
(this tool imports nothing of the JAX package).  Pipeline:

1. walk ``sysconfig.get_path("stdlib")`` ``*.py`` files (and, with
   ``--site_packages``, the installed third-party packages);
2. collect top-level and class-level ``def``s that carry a docstring; the
   summary is the docstring's first sentence, lowercased and
   punctuation-tokenized;
3. filter: 4–30 ASCII summary tokens, source ≤ 60 lines, no dunder names,
   one pair per (name, summary); methods are re-indented to parse alone;
4. seeded shuffle → dev / test / train split (a twentieth each for dev and
   test unless asked otherwise);
5. ``csat_tpu_torch.data.extract.extract_corpus`` writes ``ast.original`` +
   ``nl.original`` per split;
6. ``csat_tpu_torch.data.preprocess.process_dataset`` builds
   ``split_pot.seq``, ``split_matrices.npz`` and the vocabularies.

It reads only the machine's own stdlib and site-packages.  Usage::

    python tools/build_real_corpus_torch.py --out ./data/stdlib_python \\
        --max_samples 4000 --max_ast_len 150
"""

from __future__ import annotations

import argparse
import ast
import os
import random
import re
import sys
import sysconfig
from typing import Dict, List, Optional, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from csat_tpu_torch.data.extract import extract_corpus  # noqa: E402
from csat_tpu_torch.data.preprocess import process_dataset  # noqa: E402

__all__ = ["harvest", "split_pairs", "build", "main"]

_WORD = re.compile(r"[A-Za-z0-9]+|[^\sA-Za-z0-9]")


def _nl_tokens(docstring: str) -> list:
    """First sentence of the docstring → lowercased word/punct tokens."""
    first = docstring.strip().split("\n\n")[0].replace("\n", " ")
    m = re.search(r"(?<=[a-z0-9\)])\.(?:\s|$)", first)
    if m:
        first = first[: m.start() + 1]
    return [t.lower() for t in _WORD.findall(first)]


def harvest(max_samples: int, seed: int = 0, site_packages: bool = False) -> list:
    """Collect (function_source, nl_summary) pairs from the stdlib — plus,
    with ``site_packages``, the installed third-party distributions — in a
    shuffle seeded by ``seed``, at most ``max_samples`` of them."""
    roots = [sysconfig.get_path("stdlib")]
    if site_packages:
        roots.append(sysconfig.get_path("purelib"))
    files = []
    for root in roots:
        # the stdlib root always skips its nested site-packages (pip's
        # vendored tree, and — on non-venv layouts — a duplicate of
        # purelib); only the purelib root itself is allowed to be one
        skip = ("test", "idlelib", "__pycache__")
        if root == roots[0]:
            skip += ("site-packages",)
        for base, dirs, names in os.walk(root):
            # prune by exact directory NAME, not path substring: a
            # substring match on 'test' also pruned pytest/, latest/,
            # unittest/, … silently shrinking the --site_packages harvest.
            # Pruning dirs in place is sufficient — os.walk
            # then never descends into a skipped component at all
            dirs[:] = [d for d in dirs if d not in skip]
            files.extend(os.path.join(base, n) for n in names if n.endswith(".py"))
    files.sort()

    pairs, seen = [], set()
    for path in files:
        try:
            src = open(path, encoding="utf-8", errors="replace").read()
            tree = ast.parse(src)
        except (SyntaxError, ValueError):
            continue
        defs = []
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.append(node)
            elif isinstance(node, ast.ClassDef):
                defs.extend(
                    n for n in node.body
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                )
        for fn in defs:
            doc = ast.get_docstring(fn)
            if not doc or not doc.isascii():
                continue
            nl = _nl_tokens(doc)
            if not 4 <= len(nl) <= 30:
                continue
            if fn.name.startswith("__"):
                continue
            seg = ast.get_source_segment(src, fn)
            if seg is None or seg.count("\n") > 60:
                continue
            # dedup identical bodies vendored into multiple modules
            key = (fn.name, " ".join(nl))
            if key in seen:
                continue
            seen.add(key)
            # re-indent methods so each sample parses standalone
            lines = seg.split("\n")
            indent = len(lines[0]) - len(lines[0].lstrip())
            if indent:
                lines = [ln[indent:] if len(ln) > indent else ln.lstrip() for ln in lines]
            pairs.append(("\n".join(lines), " ".join(nl)))

    random.Random(seed).shuffle(pairs)
    return pairs[:max_samples]


def split_pairs(pairs: List[Tuple[str, str]], n_dev: Optional[int] = None,
                n_test: Optional[int] = None) -> Dict[str, List[Tuple[str, str]]]:
    """→ ``{"dev", "test", "train"}``: the first ``n_dev`` pairs, the next
    ``n_test``, the rest.  Both default to a twentieth of the pairs (at
    least one), the JAX tool's split."""
    default = max(1, len(pairs) // 20)
    n_dev = default if n_dev is None else n_dev
    n_test = default if n_test is None else n_test
    return {"dev": pairs[:n_dev], "test": pairs[n_dev:n_dev + n_test],
            "train": pairs[n_dev + n_test:]}


def build(out: str, max_samples: int = 4000, max_ast_len: int = 150, seed: int = 0,
          site_packages: bool = False, n_dev: Optional[int] = None,
          n_test: Optional[int] = None, n_jobs: Optional[int] = None) -> Dict[str, int]:
    """Harvest, split, extract and preprocess into ``out``; → the number of
    samples extracted per split."""
    splits = split_pairs(harvest(max_samples, seed, site_packages=site_packages),
                         n_dev, n_test)
    kept = {}
    for split, split_pairs_ in splits.items():
        kept[split] = extract_corpus(split_pairs_, os.path.join(out, split), "python")
        print(f"{split}: {kept[split]}/{len(split_pairs_)} extracted")
    process_dataset(out, max_ast_len, make_vocab=True, n_jobs=n_jobs or os.cpu_count() or 1)
    return kept


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--max_samples", type=int, default=4000)
    p.add_argument("--max_ast_len", type=int, default=150)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--site_packages", action="store_true",
                   help="also harvest installed third-party packages "
                        "(scales past the stdlib's ~5k docstring'd functions)")
    args = p.parse_args(argv)
    build(args.out, args.max_samples, args.max_ast_len, args.seed, args.site_packages)


if __name__ == "__main__":
    main()
