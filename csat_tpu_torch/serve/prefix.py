"""Cross-request prefix cache: content-hashed, refcounted cross-KV chains.

A copy of the JAX package's ``serve/prefix.py`` (which imports no JAX; the
port imports nothing of that package).  Identical encoder inputs reach the
serving engine over and over — the same stdlib functions, the same
boilerplate — and the encoder output (so each layer's cross-attention K/V)
is a pure function of the validated request sample on deterministic
configs, while cross-KV pages are read-only during decode.  So the engine
can skip prefill on a repeat AND share one page chain across every
concurrent slot decoding the same input.

:func:`sample_hash` fingerprints the exact encoder input — the six fields
``ingest.validate_sample`` pins (``src_seq``, ``L_raw``, ``T_raw``,
``num_node``, ``tree_pos``, ``triplet``), shapes and dtypes included, in that
order — so it gives the JAX package's bytes for the same sample.

:class:`PrefixCache` maps that hash to a page chain with a reference count
of *live sharers*.  Ownership contract with the engine's
:class:`~csat_tpu_torch.serve.pages.PageAllocator`:

* on **insert** (a miss, after its prefill succeeded) the cache takes
  ownership of the chain — the pages stay pinned after the inserting
  request retires, which makes the next identical submission a free
  admission;
* a **hit** increments ``refs``; each sharer's retire/timeout/shed calls
  :meth:`release`;
* pages return to the allocator only through **eviction** — LRU at entry
  capacity, or on demand when an admission cannot fund its chains
  (:meth:`evict_for`) — and an entry is NEVER evicted while a live slot
  references it (freeing a chain mid-decode would let the allocator hand
  those pages to another request);
* a pool **rebuild** after a device fault calls :meth:`clear`: the pool is
  gone, so every entry and refcount drops with it (the allocator is reset
  in the same breath — no leaked pins).

Under ``eval_graph="sample"`` (or nonzero dropout) a hit reuses the FIRST
submission's encoder draw instead of drawing fresh; the outputs stay valid
samples.  The bit-identity contract is stated at ``eval_graph="expected"``,
as the engine's is.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["sample_hash", "PrefixEntry", "PrefixCache"]

# the exact field set validate_sample pins — hashed in this fixed order
_HASH_FIELDS = ("src_seq", "L_raw", "T_raw", "num_node", "tree_pos", "triplet")


def sample_hash(sample: Dict[str, np.ndarray]) -> bytes:
    """16-byte content fingerprint of one validated request sample.

    On the submit hot path (hashed once per request, ``Request.phash``), so
    it sticks to C-speed accessors: ``dtype.str`` / ``shape`` bytes instead
    of rendered reprs, and ``tobytes()`` directly (it emits C-order bytes
    for any layout — no explicit contiguous copy first)."""
    h = hashlib.blake2b(digest_size=16)
    for key in _HASH_FIELDS:
        a = np.asarray(sample[key])
        h.update(key.encode())
        h.update(a.dtype.str.encode())
        h.update(np.array(a.shape, np.int64).tobytes())
        h.update(a.tobytes())
    return h.digest()


@dataclass
class PrefixEntry:
    chain: List[int]          # cross-KV page ids, cache-owned
    refs: int = 0             # live slots currently decoding against it
    hits: int = 0             # lifetime hit count (observability)


class PrefixCache:
    """LRU cache of content-hash → refcounted cross-KV page chains."""

    def __init__(self, capacity: int):
        assert capacity >= 1, capacity
        self.capacity = capacity
        self._entries: "OrderedDict[bytes, PrefixEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def pinned_pages(self) -> int:
        """Pages currently owned by the cache (pinned out of the free list)."""
        return sum(len(e.chain) for e in self._entries.values())

    @property
    def referenced(self) -> int:
        """Entries with at least one live sharer (ineligible for eviction)."""
        return sum(1 for e in self._entries.values() if e.refs > 0)

    def acquire(self, h: bytes) -> Optional[PrefixEntry]:
        """Look up and pin: present → incref + LRU-touch + entry; absent →
        None.  No hit/miss counting here — an unfundable admission under
        page backpressure re-plans (and re-acquires) every tick, so the
        engine counts exactly once per FUNDED plan via :meth:`count_hit` /
        :meth:`count_miss`."""
        e = self._entries.get(h)
        if e is None:
            return None
        e.refs += 1
        self._entries.move_to_end(h)
        return e

    def count_hit(self, h: bytes) -> None:
        """One funded hit admission (called once per admitted request)."""
        self.hits += 1
        e = self._entries.get(h)
        if e is not None:
            e.hits += 1

    def count_miss(self) -> None:
        """One funded miss admission that will run the encoder."""
        self.misses += 1

    def release(self, h: bytes) -> None:
        """A sharer retired (OK/FAILED/TIMEOUT/SHED/reaped — every terminal
        path unpins).  Tolerates a cleared cache: a rebuild drops entries
        while their sharers are being torn down in the same breath."""
        e = self._entries.get(h)
        if e is None:
            return
        assert e.refs > 0, "release without a matching acquire"
        e.refs -= 1

    def insert(self, h: bytes,
               chain: List[int]) -> Optional[List[Tuple[bytes, List[int]]]]:
        """Take ownership of ``chain`` under ``h``; the inserting request
        counts as a live sharer (refs=1).  Returns ``(hash, chain)`` pairs
        EVICTED to make room (the caller frees the chains — or spills them
        to the tier store, which is why eviction carries the content hash:
        the hash IS the tier key), or None when the insert was declined
        (duplicate hash, or capacity full of referenced entries) — a
        declined chain stays privately owned by its request."""
        if h in self._entries:
            return None
        evicted: List[Tuple[bytes, List[int]]] = []
        while len(self._entries) >= self.capacity:
            victim = self._evict_one()
            if victim is None:
                return None  # every entry referenced: decline, don't grow
            evicted.append(victim)
        self._entries[h] = PrefixEntry(chain=list(chain), refs=1)
        return evicted

    def _evict_one(self) -> Optional[Tuple[bytes, List[int]]]:
        """Drop the least-recently-used UNREFERENCED entry; its
        ``(hash, chain)`` pair."""
        for h, e in self._entries.items():  # OrderedDict: LRU first
            if e.refs == 0:
                del self._entries[h]
                return h, e.chain
        return None

    def evict_for(self, n_pages: int) -> List[Tuple[bytes, List[int]]]:
        """Demand eviction: free unreferenced entries (LRU first) until at
        least ``n_pages`` pages are released or none remain eligible.
        Returns the evicted ``(hash, chain)`` pairs."""
        freed: List[Tuple[bytes, List[int]]] = []
        got = 0
        while got < n_pages:
            victim = self._evict_one()
            if victim is None:
                break
            freed.append(victim)
            got += len(victim[1])
        return freed

    def keys(self) -> List[bytes]:
        """Resident content hashes, LRU first (tier audits read this)."""
        return list(self._entries)

    def clear(self) -> None:
        """Pool rebuild: the device pages are gone — drop every entry and
        refcount (hit/miss counters survive; they describe the engine)."""
        self._entries.clear()
