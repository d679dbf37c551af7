"""Arithmetic the metric readers share: MFU, rooflines, the device's idle share."""

from __future__ import annotations

from typing import Optional

from portbench.core import counts
from portbench.core.peaks import PEAKS

__all__ = ["train_mfu", "serve_mfu", "kernel_roofline", "device_idle"]


def _tc_peak(rec) -> float:
    return PEAKS[rec.model.get("compute_dtype", "float32")]["tc"]


def train_mfu(rec) -> Optional[float]:
    if not rec.steps or rec.window_s <= 0:
        return None
    flops = sum(counts.model_flops(rec.model, s, backward=True) for s in rec.steps)
    return 100.0 * flops / rec.window_s / _tc_peak(rec)


def serve_mfu(rec) -> Optional[float]:
    """Model FLOPs of the requests finished in the window — each one's decode
    steps, and its prefill unless the prefix cache served it — over the
    window.  A repeat is charged the share of repeats that missed: the
    engine's hits over its admissions of repeats, which are its admissions
    (hits and misses) times the share of repeats among the requests that
    ended."""
    done = [r for r in rec.requests if r["done"] is not None and r["ok"]
            and r["done"] <= rec.window_s]
    if not done or rec.window_s <= 0:
        return None
    c = rec.model
    hits = rec.counters.get("prefix_hits", 0.0)
    admitted = hits + rec.counters.get("prefix_misses", 0.0)
    ended = [r for r in rec.requests if r["done"] is not None]
    repeat_share = sum(r["repeat"] for r in ended) / max(len(ended), 1)
    repeats = admitted * repeat_share
    miss_share = 1.0 if repeats <= 0 else min(1.0, max(0.0, 1.0 - hits / repeats))
    flops = 0.0
    for r in done:
        flops += counts.decode_flops(c, r["nodes"], r["tokens"])
        flops += counts.encoder_flops(c, r["nodes"]) * (miss_share if r["repeat"] else 1.0)
    return 100.0 * flops / rec.window_s / _tc_peak(rec)


def kernel_roofline(rec) -> Optional[float]:
    """Σ bound / Σ device time over the port's kernel launches the traced
    sub-window holds and :func:`counts.kernel_bound` can bound."""
    prof = rec.profile
    if prof is None or not rec.launches:
        return None
    dtype = rec.model.get("compute_dtype", "float32")
    bound, fns = 0.0, set()
    for fn, args, note in rec.launches:
        b = counts.kernel_bound(fn, args, dtype, note)
        if b is not None:
            bound += b
            fns.add(fn)
    names = [k for fn in fns for k in counts.KERNEL_NAMES[fn]]
    device = sum(t for name, (t, _) in prof.kernels.items() if any(k in name for k in names))
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound / device


def device_idle(rec) -> Optional[float]:
    prof = rec.profile
    if prof is None or prof.window_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)
