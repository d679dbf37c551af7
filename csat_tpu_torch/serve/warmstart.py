"""Warm-start store: the built CUDA kernel libraries, digest-verified on disk.

The JAX package's ``serve/warmstart.py`` keeps each serving program's
``jax.export`` bytes so that a new engine skips trace and lower.  The
port's serving programs are eager PyTorch: the only thing a cold engine
compiles is the ``nvcc`` build of ``ops/csrc/*.cu`` into shared libraries
(``ops/build.py``).  So the port's warm start is a store of those
libraries: an entry is one library's ``.so`` bytes, and a new process on a
warm store loads them instead of running ``nvcc``.  A captured CUDA graph
cannot stand in for an exported program here: it lives inside one process,
and a store is what a new process starts from.

Layering and keying, as in the JAX package:

* the store lives under the cache root (``<root>/warmstart``, root from
  ``utils/cache.py``) or in ``serve_warmstart_dir``, and honours the same
  kill switch: ``CSAT_TPU_NO_CACHE`` disables it — every load is the
  structured miss ``disabled``, every save a no-op;
* an entry is keyed by a digest over the library name, its source and
  headers, ``NVCC_FLAGS``, the toolchain (``nvcc``, torch and its CUDA, the
  card's compute capability) and the git rev — everything that shapes the
  binary.  The weights are not in the key, where the JAX key has its params
  digest: no library closes over them;
* every entry is digest-verified at load (its header records the payload's
  sha256), so a truncated or flipped library never reaches ``ctypes``.

Miss reasons (the structured ``warmstart_miss{reason}`` vocabulary):
``disabled | absent | corrupt_header | io_error | toolchain_mismatch |
digest_mismatch``.  ``toolchain_mismatch`` stands where the JAX store has
``jaxlib_mismatch``: the key already holds the toolchain, so it catches an
entry copied or renamed by hand.  The JAX store's ``mesh_mismatch`` and
``dtype_mismatch`` cannot arise: a library is the same binary under any
serve mesh and any KV page dtype (the dtype is a kernel argument), so
neither is in the key nor a reason.  A miss means a build, and a failed
build still raises; :meth:`WarmStartStore.load` and
:meth:`WarmStartStore.save` never do.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

from csat_tpu_torch.utils.cache import cache_disabled, cache_root

__all__ = ["WarmStartStore", "MISS_REASONS", "store_root", "git_rev"]

_MAGIC = "csat-warmstart-v1"

#: every way a load can come back empty, none of them an exception
MISS_REASONS = ("disabled", "absent", "corrupt_header", "io_error", "toolchain_mismatch",
                "digest_mismatch")

_git_rev_cache: Optional[str] = None


def git_rev() -> str:
    """The repository's HEAD commit (cached; ``"unknown"`` outside a
    checkout).  Part of every key: a code change invalidates the entries."""
    global _git_rev_cache
    if _git_rev_cache is None:
        try:
            _git_rev_cache = subprocess.run(
                ["git", "rev-parse", "HEAD"], cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=5).stdout.strip() or "unknown"
        # csat-lint: disable=swallowed-fault key component, never a crash —
        except Exception:  # the key degrades to "unknown" (a cache miss)
            _git_rev_cache = "unknown"
    return _git_rev_cache


def store_root(cfg: Any = None) -> Optional[str]:
    """The store directory: None when ``CSAT_TPU_NO_CACHE`` disables it,
    else ``serve_warmstart_dir`` verbatim when set, else ``warmstart`` under
    the cache root (``utils/cache.py``: ``CSAT_TPU_CACHE_DIR`` or the
    repository's default; None when it cannot be created), so relocating the
    cache relocates the store."""
    if cache_disabled():
        return None
    explicit = getattr(cfg, "serve_warmstart_dir", "") if cfg is not None else ""
    if explicit:
        return explicit
    root = cache_root()
    return None if root is None else os.path.join(root, "warmstart")


class WarmStartStore:
    """Digest-verified file store of built kernel libraries.

    One file per entry: a JSON header line (magic, library name, key fields,
    payload sha256) followed by the library's bytes.  Every failure mode
    comes back as ``(None, reason)``; :meth:`load` and :meth:`save` never
    raise."""

    def __init__(self, root: Optional[str], log: Callable[[str], None] = lambda m: None):
        self.root = root
        self.log = log
        if root is not None:
            try:
                os.makedirs(root, exist_ok=True)
            except OSError as e:
                # an unwritable store must not turn warm start into a
                # bring-up failure: run with the store off
                log(f"# warmstart store disabled ({root}: {e})")
                self.root = None

    @property
    def enabled(self) -> bool:
        return self.root is not None

    # ---------------- keying ----------------

    @staticmethod
    def key(program: str, fields: Dict[str, Any]) -> str:
        material = json.dumps({"program": program, **fields}, sort_keys=True, default=str)
        return hashlib.sha256(material.encode()).hexdigest()[:40]

    def path(self, program: str, fields: Dict[str, Any]) -> Optional[str]:
        if self.root is None:
            return None
        return os.path.join(self.root, f"{program}-{self.key(program, fields)}.ws")

    # ---------------- load / save ----------------

    def load(self, program: str, fields: Dict[str, Any]) -> Tuple[Optional[bytes], str]:
        """→ ``(payload, "hit")`` or ``(None, reason)``, the reason one of
        :data:`MISS_REASONS`."""
        if self.root is None:
            return None, "disabled"
        path = self.path(program, fields)
        if not os.path.exists(path):
            return None, "absent"
        try:
            with open(path, "rb") as f:
                header_line = f.readline()
                payload = f.read()
        except OSError:
            return None, "io_error"
        try:
            header = json.loads(header_line)
            assert header["magic"] == _MAGIC
            want = header["payload_sha256"]
            stored = header["fields"]
        # csat-lint: disable=swallowed-fault any malformed header IS the
        except Exception:  # structured corrupt_header miss reason
            return None, "corrupt_header"
        if "toolchain" in fields and stored.get("toolchain") != str(fields["toolchain"]):
            # the key holds the toolchain already; an entry copied or
            # renamed by hand must still be refused
            return None, "toolchain_mismatch"
        if hashlib.sha256(payload).hexdigest() != want:
            return None, "digest_mismatch"
        return payload, "hit"

    def save(self, program: str, fields: Dict[str, Any], payload: bytes) -> bool:
        """Atomic write (temporary file + rename): a process reading the
        entry sees the old complete file or the new one, never a torn write.
        Returns False (never raises) on any failure."""
        path = self.path(program, fields)
        if path is None:
            return False
        header = json.dumps({
            "magic": _MAGIC, "program": program,
            "payload_sha256": hashlib.sha256(payload).hexdigest(),
            "fields": {k: str(v) for k, v in sorted(fields.items())},
        }).encode()
        try:
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                f.write(header + b"\n" + payload)
            os.replace(tmp, path)
            return True
        except OSError as e:
            self.log(f"# warmstart save failed ({program}: {e})")
            return False

    # ---------------- introspection / chaos hooks ----------------

    def entries(self) -> List[str]:
        """Entry file paths, sorted (empty when disabled)."""
        if self.root is None:
            return []
        try:
            return sorted(os.path.join(self.root, n) for n in os.listdir(self.root)
                          if n.endswith(".ws"))
        except OSError:
            return []

    def corrupt_entries(self) -> int:
        """Chaos hook: flip payload bytes in every entry, keeping the header,
        so the next load fails its digest check and rebuilds.  Returns the
        number of entries corrupted."""
        n = 0
        for path in self.entries():
            try:
                with open(path, "r+b") as f:
                    f.readline()  # keep the header
                    f.write(b"\xde\xad\xbe\xef")
                n += 1
            except OSError:
                continue
        return n
