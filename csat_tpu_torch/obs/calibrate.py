"""Hardware calibration probes and the machine fingerprint of the port.

A throughput figure is evidence only if it can be compared across runs and
machines: a card held below its power limit, or a busier host, moves a
headline with no change to the code.  This module measures the *machine*
before a benchmark measures the port: a seeded suite of micro-benchmarks
("calibration probes"), so that a headline delta can be split into
environment (the probes moved too) and code (the probes held but the
headline moved) by ``obs/perfdb.py``.

Probes (fixed shapes and seeds, host-clock timed, median of ``repeats``
after one untimed warm-up call; on the card each timed call ends in
``torch.cuda.synchronize()``):

* ``matmul_f32_gflops`` / ``matmul_bf16_gflops`` — ``torch.matmul`` of two
  square operands drawn from generators seeded 0 and 1: the device's matrix
  throughput, and the f32 one normalises headlines (training steps are
  matmul-bound).  TF32 is whatever the process has set; the port leaves
  torch's default (off);
* ``memory_gbps`` — ``a + 1.0`` and ``a.sum()`` over an f32 array: memory
  bandwidth, counted as three times its bytes;
* ``dispatch_us`` — an in-place ``add_`` on an 8-element tensor in a loop
  with one synchronize at its end: the host's cost of one launch (the
  serving tick's floor);
* ``compile_s`` — one ``nvcc`` build of a small fixed CUDA source kept
  beside this module (``calib_probe.cu``), with the kernels' flags
  (``ops/build.py``), into a fresh temporary directory: the port's
  cold-start axis.  It never builds into ``build/kernels/`` nor through the
  warm-start store, so a warm store cannot turn it into a disk read.

The device is resolved as every entry point resolves it
(``utils.resolve_device``): ``cuda`` unless the caller asks for the CPU,
raising where CUDA is asked for and absent, before any probe runs.  On a
present device a probe that fails (no ``nvcc`` found, budget exhausted)
lands in ``skipped`` with its reason: a benchmark must not die of its own
instrumentation.

The fingerprint is the identity key for "same machine?" questions: host,
device platform / kind / count, torch version, CPU count — and a short
stable digest (``id``) that ledger tooling compares cheaply.
"""

from __future__ import annotations

import hashlib
import os
import platform as _platform
import socket
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

from csat_tpu_torch.utils import resolve_device

__all__ = [
    "PROBES", "REFERENCE_PROBE", "machine_fingerprint", "fingerprint_id",
    "run_calibration", "calibration_kwargs", "normalization_ratio", "normalize",
]

PROBES: Tuple[str, ...] = (
    "matmul_f32", "matmul_bf16", "memory", "dispatch", "compile")

# the probe whose ratio normalizes headline throughput across machines
# (training steps are matmul-bound; see ``normalization_ratio``)
REFERENCE_PROBE = "matmul_f32_gflops"

#: the fixed CUDA source the compile probe builds
PROBE_SOURCE = Path(__file__).resolve().parent / "calib_probe.cu"

_FP_KEYS = ("host", "platform", "device_kind", "device_count",
            "torch_version", "cpu_count")


def fingerprint_id(fp: Dict[str, object]) -> str:
    """Short stable digest of the identity fields (order-independent of the
    dict, independent of the ``id`` field itself)."""
    basis = "|".join(f"{k}={fp.get(k)}" for k in _FP_KEYS)
    return hashlib.blake2b(basis.encode(), digest_size=6).hexdigest()


def machine_fingerprint(device="cuda") -> Dict[str, object]:
    """Identity of the machine and software stack a record was taken on:
    platform ``"gpu"`` and the card's name and count on CUDA, ``"cpu"`` on
    the CPU.  Stable within a process (same inputs → same dict)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    fp: Dict[str, object] = {
        "host": socket.gethostname(),
        "platform": "gpu" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "torch_version": torch.__version__,
        "cpu_count": os.cpu_count() or 1,
        "python_version": _platform.python_version(),
    }
    fp["id"] = fingerprint_id(fp)
    return fp


def _median(xs) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn: Callable[[], object], repeats: int) -> float:
    """Median wall-clock of ``repeats`` calls, after one untimed warm-up
    call (allocations and library start-up never pollute the sample)."""
    fn()
    samples = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    return _median(samples)


def _probe_matmul(dev: torch.device, dtype: torch.dtype, n: int, repeats: int) -> float:
    x = torch.randn((n, n), generator=torch.Generator(dev).manual_seed(0), device=dev)
    y = torch.randn((n, n), generator=torch.Generator(dev).manual_seed(1), device=dev)
    x, y = x.to(dtype), y.to(dtype)

    def call():
        torch.matmul(x, y)
        _sync(dev)

    return (2.0 * n * n * n) / _timed(call, repeats) / 1e9  # GFLOP/s


def _probe_memory(dev: torch.device, mb: int, repeats: int) -> float:
    n = mb * (1 << 20) // 4  # f32 elements
    a = torch.arange(n, dtype=torch.float32, device=dev)

    def both():
        a + 1.0   # read + write: 2·bytes
        a.sum()   # read: 1·bytes
        _sync(dev)

    return (3.0 * n * 4) / _timed(both, repeats) / 1e9  # GB/s moved


def _probe_dispatch(dev: torch.device, iters: int, repeats: int) -> float:
    x = torch.zeros((8,), dtype=torch.float32, device=dev)

    def loop():
        for _ in range(iters):
            x.add_(1.0)
        _sync(dev)

    return _timed(loop, repeats) / iters * 1e6  # µs per in-place step


def _probe_compile() -> float:
    """One ``nvcc`` build of :data:`PROBE_SOURCE` with the kernels' flags
    into a fresh temporary directory (never ``build/kernels/``, never the
    warm-start store).  Raises ``ops/build.py``'s ``RuntimeError`` where no
    ``nvcc`` is found, and the compiler's output where the build fails."""
    from csat_tpu_torch.ops import build

    nvcc = build._nvcc()
    with tempfile.TemporaryDirectory(prefix="csat_calib_") as tmp:
        t0 = time.perf_counter()
        res = subprocess.run(
            [nvcc, *build.NVCC_FLAGS, "-o", os.path.join(tmp, "libcalib_probe.so"),
             str(PROBE_SOURCE)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {PROBE_SOURCE.name}:\n{res.stdout}")
    return seconds


def run_calibration(*, device="cuda", matmul_n: int = 512, memory_mb: int = 64,
                    dispatch_iters: int = 50, repeats: int = 3,
                    budget_s: float = 45.0,
                    probes: Tuple[str, ...] = PROBES) -> Dict[str, object]:
    """Run the probe suite on ``device``; returns the ``calibration{}``
    block a benchmark stamps into its record.

    Raises only when the device is absent (before any probe runs): on a
    present device a probe that fails or runs out of budget lands in
    ``skipped`` with a reason string.  Values are floats in the units the
    key names (``_gflops``, ``_gbps``, ``_us``, ``_s``).
    """
    dev = resolve_device(device)
    t0 = time.monotonic()
    out: Dict[str, float] = {}
    skipped: Dict[str, str] = {}
    runners: Dict[str, Tuple[str, Callable[[], float]]] = {
        "matmul_f32": ("matmul_f32_gflops",
                       lambda: _probe_matmul(dev, torch.float32, matmul_n, repeats)),
        "matmul_bf16": ("matmul_bf16_gflops",
                        lambda: _probe_matmul(dev, torch.bfloat16, matmul_n, repeats)),
        "memory": ("memory_gbps", lambda: _probe_memory(dev, memory_mb, repeats)),
        "dispatch": ("dispatch_us",
                     lambda: _probe_dispatch(dev, dispatch_iters, repeats)),
        "compile": ("compile_s", _probe_compile),
    }
    for name in probes:
        if name not in runners:
            skipped[name] = "unknown probe"
            continue
        if time.monotonic() - t0 > budget_s:
            skipped[name] = f"budget ({budget_s:.0f}s) exhausted"
            continue
        key, fn = runners[name]
        try:
            v = float(fn())
            if not (v == v and abs(v) != float("inf")):  # NaN/Inf guard
                raise FloatingPointError(f"non-finite probe value {v}")
            out[key] = round(v, 4)
        except Exception as e:  # noqa: BLE001 — skipped with its reason, never raised
            skipped[name] = f"{type(e).__name__}: {e}"
    return {
        "probes": out,
        "skipped": skipped,
        "elapsed_s": round(time.monotonic() - t0, 2),
        "params": {"matmul_n": matmul_n, "memory_mb": memory_mb,
                   "dispatch_iters": dispatch_iters, "repeats": repeats},
    }


def calibration_kwargs(cfg) -> Dict[str, object]:
    """:func:`run_calibration`'s keyword arguments from a ``Config``'s
    ``calib_*`` fields, every probe where ``calib_probes`` is empty: the
    suite a benchmark session runs before it measures the port.  At the
    fields' defaults (the JAX package's) a matmul on the card is a few µs,
    so the probes time the launch: a card's session sets
    ``calib_matmul_n`` and ``calib_memory_mb`` to its size."""
    return dict(probes=tuple(cfg.calib_probes) or PROBES, matmul_n=cfg.calib_matmul_n,
                memory_mb=cfg.calib_memory_mb, dispatch_iters=cfg.calib_dispatch_iters,
                budget_s=cfg.calib_budget_s)


def normalization_ratio(calibration: Optional[dict],
                        reference_calibration: Optional[dict]) -> float:
    """This machine's speed relative to the ledger's reference fingerprint,
    from the matmul probe: >1 = faster machine than the reference, <1 =
    slower.

    ``value_cal = value / ratio`` re-expresses a headline as "what the
    reference machine would have measured", so ``value == value_cal *
    ratio`` round-trips.  1.0 whenever either side lacks the probe (an
    uncalibrated entry stays raw == normalized).
    """
    try:
        now = float(calibration["probes"][REFERENCE_PROBE])  # type: ignore[index]
        ref = float(reference_calibration["probes"][REFERENCE_PROBE])  # type: ignore[index]
        if now > 0 and ref > 0:
            return now / ref
    except (KeyError, TypeError, ValueError):
        pass
    return 1.0


def normalize(value: float, calibration: Optional[dict],
              reference_calibration: Optional[dict]) -> float:
    """Calibration-normalized headline (see :func:`normalization_ratio`)."""
    return value / normalization_ratio(calibration, reference_calibration)
