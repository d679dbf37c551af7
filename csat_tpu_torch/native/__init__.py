"""Native (C++) host components of the port, built with ``g++`` and loaded
through ``ctypes``: the fused batch collate (``collate.cpp``) of the
fixed-shape input pipeline and the METEOR scorer (``meteor.cpp``) of the
eval path.

The sources are the JAX package's (``csat_tpu/native/``), and so are the C
ABI and the ``ctypes`` signatures below; ``tests/test_torch_native.py``
holds the copies equal to their originals and their results to the plain
versions, bit for bit (collate) and to 1e-9 (METEOR).  Two things differ
from the JAX loader:

* **Where it builds.** Each library is compiled from the checkout's source
  alone into ``build/native/`` at the repository root (:data:`BUILD_DIR`,
  under ``.gitignore``'s ``build/``), named by a digest of its source and
  flags as ``ops/build.py`` names the CUDA libraries: an edited source is
  rebuilt, an unchanged one reused.  A build writes a temporary file and
  renames it into place, so concurrent processes never load a half-written
  library.
* **No fallback that hides the library.** A failed build raises with the
  compiler's output; the plain versions (the NumPy ``collate`` and the
  Python METEOR scorer) run only when a caller asks for them:
  ``meteor_score(use_native=False)``, or ``CSAT_TPU_NO_NATIVE_COLLATE=1``
  for the collate.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

__all__ = ["BUILD_DIR", "SOURCES", "OPT", "BUILT", "library_path", "build_library", "load_collate",
           "load_meteor", "native_meteor_score"]

_HERE = Path(__file__).resolve().parent
_REPO = _HERE.parents[1]

#: where the libraries are built and loaded from
BUILD_DIR = _REPO / "build" / "native"

#: library name → its C++ source, and → its optimisation flag (the JAX loader's)
SOURCES: Dict[str, Path] = {"collate": _HERE / "collate.cpp", "meteor": _HERE / "meteor.cpp"}
OPT: Dict[str, str] = {"collate": "-O3", "meteor": "-O2"}
_FLAGS = ("-shared", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

#: library file → seconds ``g++`` took, for each library this process built
BUILT: Dict[str, float] = {}


def _flags(opt: str) -> list:
    return [opt, *_FLAGS]


def library_path(src: Path, opt: str, build_dir: Path = BUILD_DIR) -> Path:
    """The library built from ``src`` with ``opt``: keyed by a digest of the
    source's bytes and the flags."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(opt)).encode()).hexdigest()
    return Path(build_dir) / f"lib{src.stem}_{digest[:16]}.so"


def build_library(src: Path, opt: str, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``src`` unless its library exists; returns the library's path.
    Raises ``RuntimeError`` with the compiler's output when ``g++`` is missing
    or fails."""
    path = library_path(src, opt, build_dir)
    if path.exists():
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {src.name} builds on a machine with a C++ compiler")
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=path.parent)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        res = subprocess.run([gxx, *_flags(opt), "-o", tmp, str(src)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed for {src}:\n{res.stderr}")
        os.replace(tmp, path)
        BUILT[path.name] = time.perf_counter() - t0
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library(SOURCES[name], OPT[name])))


def load_meteor() -> ctypes.CDLL:
    """The native METEOR library, built and loaded once per process, its
    synonym table fed from ``metrics/synonyms_en.txt`` (the table the Python
    scorer reads)."""
    with _LOCK:
        lib = _LIBS.get("meteor")
        if lib is None:
            lib = _load("meteor")
            lib.meteor_score_c.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
            lib.meteor_score_c.restype = ctypes.c_double
            lib.meteor_set_synonyms_c.argtypes = [ctypes.c_char_p]
            lib.meteor_set_synonyms_c.restype = None
            lib.meteor_set_synonyms_c((_HERE.parent / "metrics" / "synonyms_en.txt").read_bytes())
            _LIBS["meteor"] = lib
        return lib


def load_collate() -> Optional[ctypes.CDLL]:
    """The fused batch-collate library, built and loaded once per process;
    None only when the caller opted out with ``CSAT_TPU_NO_NATIVE_COLLATE=1``."""
    if os.environ.get("CSAT_TPU_NO_NATIVE_COLLATE", "") == "1":
        return None
    with _LOCK:
        lib = _LIBS.get("collate")
        if lib is None:
            lib = _load("collate")
            lib.collate_rel_c.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.collate_rel_c.restype = None
            _LIBS["collate"] = lib
        return lib


def native_meteor_score(hyp: str, ref: str, version: str = "1.5") -> float:
    """Score whitespace-joined, normalized token strings with the C++ library.

    ``version`` selects the METEOR-1.5 (normalize+stem) or classic 2005
    exact-match formulation — see ``csat_tpu_torch/metrics/meteor.py``.
    """
    return float(load_meteor().meteor_score_c(
        hyp.encode(), ref.encode(), 1 if version == "1.5" else 0))
