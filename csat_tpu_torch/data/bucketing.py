"""The node-capacity bucket ladder shared by training and serving prefill
(a copy of the JAX package's ``data/bucketing.py:src_bucket_ladder``)."""

from __future__ import annotations

from typing import Tuple

from csat_tpu_torch.configs import Config

__all__ = ["src_bucket_ladder"]


def _default_src_ladder(max_src_len: int, min_len: int = 32) -> Tuple[int, ...]:
    """Geometric halving ladder capped by the flagship N: 150 → (37, 75, 150)."""
    out = [max_src_len]
    while out[-1] // 2 >= min_len:
        out.append(out[-1] // 2)
    return tuple(sorted(out))


def src_bucket_ladder(cfg: Config) -> Tuple[int, ...]:
    """Ascending node-capacity ladder: ``bucket_src_lens`` capped by the
    flagship N (always appended), or the default halving ladder."""
    src_lens = tuple(cfg.bucket_src_lens) or _default_src_ladder(cfg.max_src_len)
    return tuple(sorted({min(n, cfg.max_src_len) for n in src_lens} | {cfg.max_src_len}))
