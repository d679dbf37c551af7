"""Tiered KV page store: digest-verified host RAM and disk below the page pool.

The port's copy of the JAX package's ``serve/tiering.py``, definition for
definition (``tests/test_torch_imports.py`` holds the two equal): the same
``_MAGIC``, header, digest and :data:`MISS_REASONS`, so the same sequence of
``put`` / ``get`` / ``drop`` gives the same results, the same events and
byte-identical disk files in both packages.

Under page pressure the serving engine (``serve/engine.py``) spills an
evicted prefix-cache chain instead of destroying it: it gathers the chain's
K/V pages and their scales out of every layer (``serve/pages.py:
tier_gather``) and hands the bytes here; a later admission of the same
content hash restores them into fresh pages (``tier_restore``) and attaches
them like any prefix hit, so a restored chain is bit-identical to one that
never left the card.

The store is host-only byte storage:

* **host tier** — an LRU ``OrderedDict`` of payload bytes, bounded in pages
  (``serve_tier_host_pages``); overflow demotes LRU entries to
* **disk tier** — one file per entry under ``serve_tier_dir``: a JSON header
  line (magic, key, payload digest, meta) and then the raw payload, written
  atomically (temporary file + ``os.replace``), bounded in pages
  (``serve_tier_disk_pages``, LRU files deleted beyond it).

Every restore is checked against a blake2b-16 digest in both tiers, so a
corrupted snapshot never reaches the pool.  Every failure —
``absent | corrupt_header | digest_mismatch | io_error | truncated |
dtype_mismatch`` (the last stamped by the engine through
:meth:`TieredPageStore.invalidate` when a snapshot's ``kv_dtype`` is not the
pool's) — comes back as ``(None, None, reason)`` with a structured
``tier.restore_miss{reason}`` event, and the failed entry is dropped, so the
admission degrades to a clean re-prefill.  ``get``, ``put`` and ``clear``
never raise.  :meth:`TieredPageStore.corrupt_entries` is the
``corrupt_tier_restore`` fault's hook, :meth:`TieredPageStore.accounting_errors`
the audit the engine's ``chain_leaks`` reads.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["TieredPageStore", "MISS_REASONS"]

_MAGIC = "csat-kvtier-v1"

#: The structured ``tier.restore_miss{reason}`` vocabulary — every way a
#: restore can fail, none of them an exception.
MISS_REASONS = ("absent", "corrupt_header", "digest_mismatch", "io_error",
                "truncated", "dtype_mismatch")


def _digest(payload: bytes) -> str:
    """blake2b-16 over the payload bytes (same family as sample_hash)."""
    return hashlib.blake2b(payload, digest_size=16).hexdigest()


class _HostEntry:
    """One host-tier snapshot: payload bytes + meta + recorded digest."""

    __slots__ = ("payload", "meta", "digest", "pages")

    def __init__(self, payload: bytes, meta: Dict[str, Any], digest: str,
                 pages: int):
        self.payload = payload
        self.meta = meta
        self.digest = digest
        self.pages = pages


class TieredPageStore:
    """Digest-verified host-RAM → disk ladder for spilled KV page chains.

    Keys are the prefix cache's content hashes (``bytes``), so "the same
    code submitted again" is also "the same tiered snapshot".  ``put``
    lands in the host tier and demotes LRU overflow to disk; ``get``
    verifies the digest wherever the entry lives and NEVER raises — every
    failure is a structured miss.  ``host_pages``/``disk_pages`` budgets
    of 0 mean unbounded; ``root=None`` disables the disk tier (host-only
    ladder: overflow is dropped, the next admission re-prefills)."""

    def __init__(self, host_pages: int = 0, disk_pages: int = 0,
                 root: Optional[str] = None,
                 log: Callable[[str], None] = lambda m: None,
                 obs: Any = None):
        self.host_budget = int(host_pages)
        self.disk_budget = int(disk_pages)
        self.root = root
        self.log = log
        self.obs = obs
        self._host: "OrderedDict[bytes, _HostEntry]" = OrderedDict()
        # key -> (path, pages); insertion order is the disk LRU
        self._disk: "OrderedDict[bytes, Tuple[str, int]]" = OrderedDict()
        self.host_pages_in_use = 0
        self.disk_pages_in_use = 0
        self.spills = 0          # chains accepted by put()
        self.demotions = 0       # host entries demoted to disk
        self.restores = 0        # digest-verified hits handed back
        self.restore_misses = 0  # structured failures (any reason)
        if root is not None:
            try:
                os.makedirs(root, exist_ok=True)
            except OSError as e:
                # an unwritable disk tier must not turn spill into a
                # serving failure — run host-only
                log(f"# kv tier store: disk tier disabled ({root}: {e})")
                self.root = None

    # ---------------- events ----------------

    def _emit(self, name: str, **fields) -> None:
        if self.obs is not None:
            self.obs.emit(name, **fields)

    def _miss(self, reason: str, key: bytes,
              tier: str = "") -> Tuple[None, None, str]:
        """The ONLY way a restore comes back empty: count it, stamp the
        structured ``tier.restore_miss{reason}`` event, return the miss."""
        assert reason in MISS_REASONS, reason
        self.restore_misses += 1
        self._emit("tier.restore_miss", reason=reason, tier=tier,
                   key=key.hex()[:12])
        return None, None, reason

    # ---------------- index ----------------

    def __contains__(self, key: bytes) -> bool:
        return key in self._host or key in self._disk

    def __len__(self) -> int:
        return len(self._host) + sum(1 for k in self._disk
                                     if k not in self._host)

    def has(self, key: bytes) -> bool:
        """Is a snapshot indexed under ``key`` (either tier)?"""
        return key in self

    def pages(self, key: bytes) -> int:
        """Page count of the indexed snapshot (0 when absent)."""
        e = self._host.get(key)
        if e is not None:
            return e.pages
        d = self._disk.get(key)
        return d[1] if d is not None else 0

    def keys(self) -> List[bytes]:
        """Every indexed key, host tier first (LRU order within a tier)."""
        return list(self._host) + [k for k in self._disk
                                   if k not in self._host]

    # ---------------- spill (put) ----------------

    def put(self, key: bytes, payload: bytes, meta: Dict[str, Any]) -> None:
        """Accept one chain snapshot into the host tier (LRU-newest),
        recording its digest; overflow past the host page budget demotes
        LRU entries to disk.  Replaces any prior snapshot under ``key``.
        Never raises — a failed demotion drops the snapshot (the next
        admission re-prefills), it cannot fail the admission spilling."""
        self.drop(key)
        pages = int(meta.get("pages", 0))
        meta = dict(meta, nbytes=len(payload))
        self._host[key] = _HostEntry(payload, meta, _digest(payload), pages)
        self.host_pages_in_use += pages
        self.spills += 1
        self._emit("tier.spill", pages=pages, key=key.hex()[:12])
        while (self.host_budget
               and self.host_pages_in_use > self.host_budget and self._host):
            self._demote_lru()

    def _demote_lru(self) -> None:
        """Move the LRU host entry down the ladder: atomic header+payload
        file on disk (warm-start format), or dropped when no disk tier."""
        key, e = next(iter(self._host.items()))
        del self._host[key]
        self.host_pages_in_use -= e.pages
        if self.root is None:
            self._emit("tier.evict", tier="host", pages=e.pages,
                       key=key.hex()[:12])
            return
        path = os.path.join(self.root, f"{key.hex()}.kvp")
        header = json.dumps({"magic": _MAGIC, "key": key.hex(),
                             "digest": e.digest, "meta": e.meta}).encode()
        try:
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                f.write(header + b"\n" + e.payload)
            os.replace(tmp, path)
        except OSError as err:
            # demotion is best-effort: the snapshot is dropped and the
            # next identical admission pays a re-prefill, never a crash
            self.log(f"# kv tier store: demotion failed ({err})")
            self._emit("tier.evict", tier="host", pages=e.pages,
                       key=key.hex()[:12], error=str(err))
            return
        self._disk[key] = (path, e.pages)
        self.disk_pages_in_use += e.pages
        self.demotions += 1
        self._emit("tier.demote", pages=e.pages, key=key.hex()[:12])
        while (self.disk_budget
               and self.disk_pages_in_use > self.disk_budget and self._disk):
            dk, (dpath, dpages) = next(iter(self._disk.items()))
            del self._disk[dk]
            self.disk_pages_in_use -= dpages
            try:
                os.remove(dpath)
            except OSError:
                pass  # the index entry is gone either way
            self._emit("tier.evict", tier="disk", pages=dpages,
                       key=dk.hex()[:12])

    # ---------------- restore (get) ----------------

    def get(self, key: bytes) -> Tuple[Optional[bytes], Optional[dict], str]:
        """→ ``(payload, meta, tier)`` on a digest-verified hit (tier is
        ``"host"`` or ``"disk"``), or ``(None, None, reason)`` with reason
        in :data:`MISS_REASONS`.  Never raises; a failed entry is dropped
        so the caller's re-prefill repopulates it cleanly."""
        e = self._host.get(key)
        if e is not None:
            if len(e.payload) != e.meta["nbytes"]:
                self._drop_host(key)
                return self._miss("truncated", key, tier="host")
            if _digest(e.payload) != e.digest:
                self._drop_host(key)
                return self._miss("digest_mismatch", key, tier="host")
            self._host.move_to_end(key)
            self.restores += 1
            self._emit("tier.restore", tier="host", pages=e.pages,
                       key=key.hex()[:12])
            return e.payload, dict(e.meta), "host"
        d = self._disk.get(key)
        if d is None:
            return self._miss("absent", key)
        path, pages = d
        try:
            with open(path, "rb") as f:
                header_line = f.readline()
                payload = f.read()
        except OSError:
            self._drop_disk(key)
            return self._miss("io_error", key, tier="disk")
        try:
            header = json.loads(header_line)
            assert header["magic"] == _MAGIC
            want = header["digest"]
            meta = dict(header["meta"])
            nbytes = int(meta["nbytes"])
        except Exception:  # any malformed header IS the corrupt_header miss
            self._drop_disk(key)
            return self._miss("corrupt_header", key, tier="disk")
        if len(payload) != nbytes:
            self._drop_disk(key)
            return self._miss("truncated", key, tier="disk")
        if _digest(payload) != want:
            self._drop_disk(key)
            return self._miss("digest_mismatch", key, tier="disk")
        self.restores += 1
        self._emit("tier.restore", tier="disk", pages=pages,
                   key=key.hex()[:12])
        return payload, meta, "disk"

    # ---------------- retire / rebuild ----------------

    def drop(self, key: bytes) -> None:
        """Forget ``key`` in both tiers (restore moved it back into HBM,
        or a fresh put replaces it)."""
        self._drop_host(key)
        self._drop_disk(key)

    def _drop_host(self, key: bytes) -> None:
        e = self._host.pop(key, None)
        if e is not None:
            self.host_pages_in_use -= e.pages

    def _drop_disk(self, key: bytes) -> None:
        d = self._disk.pop(key, None)
        if d is not None:
            self.disk_pages_in_use -= d[1]
            try:
                os.remove(d[0])
            except OSError:
                pass  # the index entry is gone either way

    def invalidate(self, key: bytes, reason: str) -> None:
        """Caller-detected bad snapshot (geometry skew, undecodable
        payload): drop it and count a structured restore miss — the
        engine-side half of the never-a-silently-wrong-chain contract."""
        tier = ("host" if key in self._host
                else "disk" if key in self._disk else "")
        self.drop(key)
        self._miss(reason, key, tier=tier)

    def clear(self) -> None:
        """Pool rebuild / engine close: drop every entry in both tiers
        (disk files removed).  A rebuild resets allocator, prefix cache
        and tiers in the same breath — snapshots gathered from a faulting
        device are not trusted across it (zero leaked chains, pinned by
        ``tests/test_tiering.py``)."""
        self._host.clear()
        self.host_pages_in_use = 0
        for path, _ in self._disk.values():
            try:
                os.remove(path)
            except OSError:
                pass  # best-effort file cleanup; the index is authoritative
        self._disk.clear()
        self.disk_pages_in_use = 0

    # ---------------- chaos / audit hooks ----------------

    def corrupt_entries(self) -> int:
        """Chaos hook (``corrupt_tier_restore`` fault kind): flip payload
        bytes in every entry of BOTH tiers while keeping the recorded
        digests, so the next restore fails verification and degrades to
        re-prefill.  Returns the number of entries corrupted."""
        n = 0
        for e in self._host.values():
            if len(e.payload) >= 4:
                e.payload = b"\xde\xad\xbe\xef" + e.payload[4:]
                n += 1
        for path, _ in self._disk.values():
            try:
                with open(path, "r+b") as f:
                    f.readline()  # keep the header (and its digest)
                    f.write(b"\xde\xad\xbe\xef")
                n += 1
            except OSError:
                continue
        return n

    def accounting_errors(self) -> int:
        """Internal-consistency audit the ``no_chain_leak`` invariant
        reads at quiescence: each tier's occupancy gauge must equal the
        pages its index tracks, and no key may live in both tiers."""
        bad = 0
        if self.host_pages_in_use != sum(e.pages
                                         for e in self._host.values()):
            bad += 1
        if self.disk_pages_in_use != sum(p for _, p in self._disk.values()):
            bad += 1
        bad += sum(1 for k in self._disk if k in self._host)
        return bad
