"""Build and load the port's CUDA kernels; count their launches.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on first use
by ``nvcc`` into its own shared library under ``build/kernels/`` at the
repository root (listed in ``.gitignore``; :data:`BUILD_DIR`),
then loaded with ``ctypes``.  The libraries are keyed by a hash of their
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source is rebuilt and an unchanged one is reused.  All sources compile in
parallel, one ``nvcc`` process each.

Warm start (``serve/warmstart.py``): :func:`load_library` given a store asks
it first.  A hit writes the digest-verified bytes to the build path
atomically and loads them, with no ``nvcc`` run; a miss builds as above,
then saves the library.  :data:`PROVENANCE` records how each library of the
process was loaded (``"hit"``, a miss reason, or ``"off"`` without a store).

Nothing here runs at import time: the CPU path never needs ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

__all__ = [
    "KERNELS", "SOURCES", "REPLACES", "HEAD_DIMS", "SERVE_LIBRARIES", "PROVENANCE", "build_dir",
    "library_path", "check_head_dim", "load_library", "build_all", "kernel", "launch",
    "launch_counts", "reset_launches", "store_fields",
]

_CSRC = Path(__file__).resolve().parent / "csrc"
_REPO = Path(__file__).resolve().parents[2]

#: library name → CUDA source
SOURCES: Dict[str, Path] = {
    "flex_fwd_tc": _CSRC / "flex_fwd_tc.cu",
    "flex_bwd_tc": _CSRC / "flex_bwd_tc.cu",
    "paged_decode": _CSRC / "paged_decode.cu",
}

#: every kernel of the serving and training paths → the library that holds it
KERNELS: Dict[str, str] = {
    "flex_fwd_cse": "flex_fwd_tc",
    "flex_fwd_sbm_expected": "flex_fwd_tc",
    "flex_fwd_sbm_sampled": "flex_fwd_tc",
    "flex_fwd_sbm_graph": "flex_fwd_tc",
    "flex_bwd_q_sbm_sampled": "flex_bwd_tc",
    "flex_bwd_k_sbm_sampled": "flex_bwd_tc",
    "flex_bwd_q_sbm_expected": "flex_bwd_tc",
    "flex_bwd_k_sbm_expected": "flex_bwd_tc",
    "paged_decode": "paged_decode",
}

#: the libraries a serving engine launches: K1 and K2 at prefill, K5 at decode
SERVE_LIBRARIES = ("flex_fwd_tc", "paged_decode")

#: every kernel → the TPU (Pallas) kernel of the JAX package it replaces
REPLACES: Dict[str, str] = {
    "flex_fwd_cse": "csat_tpu/ops/flex_core.py:304 (_fwd_call, cse mod)",
    "flex_fwd_sbm_expected": "csat_tpu/ops/flex_core.py:304 (_fwd_call, sbm_expected mod)",
    "flex_fwd_sbm_sampled": "csat_tpu/ops/flex_core.py:304 (_fwd_call, sbm_sampled mod)",
    "flex_fwd_sbm_graph": "csat_tpu/ops/flex_core.py:304 (_fwd_call, sbm_graph mod)",
    "flex_bwd_q_sbm_sampled": "csat_tpu/ops/flex_core.py:498 (_kernel_bwd_calls q-pass, sbm_sampled mod)",
    "flex_bwd_k_sbm_sampled": "csat_tpu/ops/flex_core.py:519 (_kernel_bwd_calls k-pass, sbm_sampled mod)",
    "flex_bwd_q_sbm_expected": "csat_tpu/ops/flex_core.py:498 (_kernel_bwd_calls q-pass, sbm_expected mod)",
    "flex_bwd_k_sbm_expected": "csat_tpu/ops/flex_core.py:519 (_kernel_bwd_calls k-pass, sbm_expected mod)",
    "paged_decode": "csat_tpu/ops/paged_decode.py:237 (_attend_kernel)",
}

#: every kernel → the head widths it is instantiated for: the widths the
#: registry's configs give it (CSE and decoder 512 / 8 heads = 64; the SBM
#: encoder 512 / 8 = 64 for ``python``, 768 / 8 = 96 for ``java``).  The C
#: entry points return -1 for any other width.
HEAD_DIMS: Dict[str, tuple] = {
    "flex_fwd_cse": (64,),
    "flex_fwd_sbm_expected": (64, 96),
    "flex_fwd_sbm_sampled": (64, 96),
    "flex_fwd_sbm_graph": (64, 96),
    "flex_bwd_q_sbm_sampled": (64, 96),
    "flex_bwd_k_sbm_sampled": (64, 96),
    "flex_bwd_q_sbm_expected": (64, 96),
    "flex_bwd_k_sbm_expected": (64, 96),
    "paged_decode": (64,),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # q k v lq lk rel mask out lse gsum skip | B H N DH R group scale stream
    "flex_fwd_cse": [_P] * 11 + [_I] * 6 + [_F, _P],
    # q k v r kh pad dseed out lse gsum skip | B H N DH KK stride bh0 hstride
    # floor scale rate keep_scale stream
    "flex_fwd_sbm_expected": [_P] * 11 + [_I] * 8 + [_F] * 4 + [_P],
    # q k v r kh pad sseed dseed out lse gsum skip | B H N DH KK stride bh0
    # hstride floor scale rate keep_scale stream
    "flex_fwd_sbm_sampled": [_P] * 12 + [_I] * 8 + [_F] * 4 + [_P],
    # q k v graph pad dseed out lse gsum skip | B H N DH stride bh0 hstride
    # scale rate keep_scale stream
    "flex_fwd_sbm_graph": [_P] * 10 + [_I] * 7 + [_F] * 3 + [_P],
    # q k v r kh pad sseed dseed lse dvec gout gs dq dr | B H N DH KK stride
    # bh0 hstride floor scale rate keep_scale stream
    "flex_bwd_q_sbm_sampled": [_P] * 14 + [_I] * 8 + [_F] * 4 + [_P],
    # ... gs dk dv dkh | (as the q-pass)
    "flex_bwd_k_sbm_sampled": [_P] * 15 + [_I] * 8 + [_F] * 4 + [_P],
    # the sampled lists without sseed
    "flex_bwd_q_sbm_expected": [_P] * 13 + [_I] * 8 + [_F] * 4 + [_P],
    "flex_bwd_k_sbm_expected": [_P] * 14 + [_I] * 8 + [_F] * 4 + [_P],
    # dtype | q pk pv sk sv table mask idx ktok vtok out skip | S H NB page width DH stream
    "paged_decode": [_I] + [_P] * 12 + [_I] * 6 + [_P],
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
BUILD_LOG: Dict[str, str] = {}
#: library → how this process loaded it: "hit" (from the warm-start store),
#: a miss reason (built, then saved), or "off" (no store asked)
PROVENANCE: Dict[str, str] = {}


#: where the libraries are built and loaded from
BUILD_DIR = _REPO / "build" / "kernels"


def build_dir() -> Path:
    return BUILD_DIR


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return found


def _source_digest(name: str) -> str:
    """sha256 over library ``name``'s source, the shared headers and the flags."""
    headers = b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    return hashlib.sha256(
        SOURCES[name].read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()


def library_path(name: str) -> Path:
    """Where library ``name`` is built (it exists after :func:`build_all`)."""
    return build_dir() / f"lib{name}_{_source_digest(name)[:16]}.so"


def _nvcc_version() -> str:
    """The toolkit's version from its ``version.json`` beside ``bin/nvcc``
    (read, not run: a warm start runs no ``nvcc``), else ``nvcc --version``'s
    last line, else ``"absent"``."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    meta = Path(nvcc).resolve().parents[1] / "version.json"
    try:
        return json.loads(meta.read_text())["cuda_nvcc"]["version"]
    except (OSError, ValueError, KeyError, TypeError):
        pass
    if not os.path.exists(nvcc):
        return "absent"
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout
    return out.strip().splitlines()[-1] if out.strip() else "unknown"


def store_fields(name: str) -> Dict[str, str]:
    """The warm-start key of library ``name``: its source digest, the flags,
    the toolchain (``nvcc``, torch and its CUDA, the card's compute
    capability) and the git rev — everything that shapes the binary."""
    import torch

    from csat_tpu_torch.serve.warmstart import git_rev

    cap = (".".join(map(str, torch.cuda.get_device_capability(0)))
           if torch.cuda.is_available() else "none")
    return {"source": _source_digest(name), "flags": " ".join(NVCC_FLAGS), "git": git_rev(),
            "toolchain": f"nvcc {_nvcc_version()} / torch {torch.__version__} / "
                         f"cuda {torch.version.cuda} / sm {cap}"}


def build_all(names: Optional[List[str]] = None) -> float:
    """Compile every missing library in parallel; returns wall seconds.
    Raises with the compiler's output when a build fails."""
    names = list(SOURCES) if names is None else names
    todo = [n for n in names if not library_path(n).exists()]
    t0 = time.perf_counter()
    if todo:
        _nvcc_build(todo)
    return time.perf_counter() - t0


def _nvcc_build(todo: List[str]) -> None:
    """One ``nvcc`` process for each library of ``todo``, all at once."""
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}:\n{out}")
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def _restore(name: str, payload: bytes) -> None:
    """Write a store hit's verified bytes to the build path, atomically."""
    path = library_path(name)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_bytes(payload)
    os.replace(tmp, path)


def _open(path: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(path))


def load_library(name: str, store=None) -> ctypes.CDLL:
    """Library ``name``, loaded once per process.  With a warm-start
    ``store`` (``serve/warmstart.py:WarmStartStore``) a first load asks it
    before building and saves what it built on a miss; its outcome lands in
    :data:`PROVENANCE`."""
    lib = _LIBS.get(name)
    if lib is None:
        reason = "off"
        if store is not None:
            fields = store_fields(name)
            payload, reason = store.load(name, fields)
            if payload is not None:
                _restore(name, payload)
        build_all([name])
        if store is not None and reason != "hit":
            store.save(name, fields, library_path(name).read_bytes())
        lib = _open(library_path(name))
        for fn, lib_name in KERNELS.items():
            if lib_name == name:
                getattr(lib, fn).argtypes = _ARGTYPES[fn]
                getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
        PROVENANCE[name] = reason
    return lib


def check_head_dim(fn: str, dh: int) -> None:
    """Refuse a head width kernel ``fn`` has no instantiation for."""
    if dh not in HEAD_DIMS[fn]:
        raise ValueError(f"kernel {fn} is built for head widths {HEAD_DIMS[fn]}, got {dh}")


def kernel(fn: str):
    """The C entry point ``fn`` (building its library on first use)."""
    return getattr(load_library(KERNELS[fn]), fn)


def launch(fn: str, args) -> None:
    """Launch kernel ``fn`` with its C arguments and count the launch.
    Raises on a launch the runtime refused (``cudaGetLastError`` != 0) or
    on an argument the C side rejected (negative codes).  Every kernel
    wrapper launches through here, so the counts show which kernels a run
    went through."""
    rc = kernel(fn)(*args)
    if rc != 0:
        raise RuntimeError(f"kernel {fn} failed to launch: error code {rc}")
    _LAUNCHES[fn] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launches() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0
