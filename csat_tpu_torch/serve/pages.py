"""Block-paged KV pool: page allocator, paged slot state, the decode step.

Counterpart of the JAX package's ``serve/pages.py:109-449``.  Per decoder
layer, K and V live in page arrays ``(num_pages, H, page, dh)``; each slot
owns two fixed-width int32 page-table rows, ``self_pt`` (ceil(steps/page)
entries) and ``cross_pt`` (ceil(mem_len/page)).  One page id addresses the
same slice of every layer's arrays.  Page 0 is the reserved null page:
unallocated table entries point at it and frozen rows' dead writes land in
it.  Pages store ``cfg.serve_kv_page_dtype`` (f32, bf16 or int8) beside f32
per-row scales: rows are quantized on write (:func:`quantize_kv`, at the
decode scatter here and at prefill), dequantized on read — by the
paged-decode kernel from the stored bytes on the card, by the plain gather
path on the CPU.

Under a serve mesh (``cfg.serve_mesh_shape``, ``parallel/mesh.py:
build_serve_mesh``) the page arrays are split on the head axis: head shard
``s`` keeps heads ``[h0, h1)`` of every layer's pages and scales on its own
device (:attr:`PagedPool.shards`), the page tables and every other slot
field stay single on the engine's device, and every write lands each
shard's heads on its device (:func:`page_sets`).  A row's quantization scale
is per head, so a shard's pages hold the solo pool's bytes for its heads.

Unlike the JAX pool, which is an immutable pytree donated through compiled
programs, :class:`PagedPool` is updated IN PLACE: the decode step writes
each token's K/V into its page and advances the slot state on the tensors
themselves, and so do the two admission-side surgeries of the JAX package's
``:452-563``: :func:`attach` brings prefix-cache hits live without running
the encoder, and :func:`release` retires rows frozen outside the decode
step (NaN guard, timeout, reap, shed).  Neither is a kernel there or here:
both are a few indexed writes on the pool's tensors.  Nor are the KV
tiers' two (``:492-546``, XLA gathers and scatters in JAX):
:func:`tier_gather` snapshots a chain's pages and scales out of every layer
for a spill (``serve/tiering.py``), and :func:`tier_restore` writes a
snapshot back into fresh pages.  The snapshot stacks the layers in the JAX
pool's order (sorted ``layer_{i}`` names, :func:`tier_layer_order`) and
whole heads (a serve mesh's shards concatenated), so a payload means the
same pages in both packages and under any mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from csat_tpu_torch.configs import Config
from csat_tpu_torch.ops.paged_decode import NULL_PAGE, quantize_kv
from csat_tpu_torch.utils import BOS, EOS, PAD

__all__ = [
    "NULL_PAGE", "KV_PAGE_DTYPES", "KV_PAGE_RATIO", "PageGeometry", "page_geometry",
    "PageAllocator", "PagedPool", "chain_table_row", "init_paged_pool", "admit_slot_state",
    "scrub_pages", "attach", "release", "build_paged_decode_step", "page_sets",
    "tier_layer_order", "tier_gather", "tier_restore",
]

#: ``serve_kv_page_dtype`` → storage dtype of the K/V page arrays
KV_PAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
#: f32 bytes of a page over its stored bytes: the equal-memory multiplier a
#: quantized pool funds (``ServeStats.summary``'s ``effective_slots``)
KV_PAGE_RATIO = {"float32": 1, "bfloat16": 2, "int8": 4}


class PageGeometry(NamedTuple):
    page: int       # tokens per page
    num_pages: int  # total pages INCLUDING the null page
    sp: int         # self page-table width  = ceil(steps / page)
    cp: int         # cross page-table width = ceil(mem_len / page)
    steps: int      # decode budget capacity (max_tgt_len - 1)
    mem_len: int    # encoder memory width (max_src_len)

    @property
    def usable(self) -> int:
        """Allocatable pages (the null page is reserved)."""
        return self.num_pages - 1

    @property
    def rect_pages_per_slot(self) -> int:
        """Pages one worst-case slot occupies — the equal-memory yardstick of
        ``effective_slots``."""
        return self.sp + self.cp

    def self_pages(self, limit: int) -> int:
        return max(1, -(-int(limit) // self.page))

    def cross_pages(self, n: int) -> int:
        return max(1, -(-int(n) // self.page))


def page_geometry(cfg: Config) -> PageGeometry:
    """``serve_num_pages == 0`` sizes the pool for every slot's worst-case
    chain; an explicit pool must fund at least one worst-case request."""
    page = cfg.serve_page_size
    steps = cfg.max_tgt_len - 1
    mem_len = cfg.max_src_len
    sp = -(-steps // page)
    cp = -(-mem_len // page)
    num_pages = cfg.serve_num_pages or (1 + cfg.serve_slots * (sp + cp))
    if num_pages < 1 + sp + cp:
        raise ValueError(
            f"serve_num_pages={num_pages} cannot fund one worst-case request: "
            f"need >= 1 null + {sp} self + {cp} cross pages")
    return PageGeometry(page, num_pages, sp, cp, steps, mem_len)


class PageAllocator:
    """Host-side free list over page ids ``1..num_pages-1``: all-or-nothing
    :meth:`alloc`, and assertions against aliasing and double frees (either
    would silently corrupt another request's KV)."""

    def __init__(self, num_pages: int):
        assert num_pages >= 2, f"need >= 2 pages (one is the null page), got {num_pages}"
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))  # pop() yields 1, 2, …
        self._used: set = set()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._used)

    @property
    def usable(self) -> int:
        return self.num_pages - 1

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` pages, or None (and no state change) when the pool cannot
        fund them."""
        assert n >= 0, n
        if n > len(self._free):
            return None
        chain = [self._free.pop() for _ in range(n)]
        self._used.update(chain)
        return chain

    def free(self, chain: Sequence[int]) -> None:
        for p in chain:
            p = int(p)
            assert p != NULL_PAGE, "freeing the null page"
            assert p in self._used, f"double-free / foreign page {p}"
            self._used.remove(p)
            self._free.append(p)


@dataclasses.dataclass
class PagedPool:
    """Device-resident paged slot state, updated in place.  Under a serve
    mesh ``pages`` is None and ``shards`` holds, per head shard, ``(h0, h1,
    per-layer pages of heads [h0, h1) on the shard's device)``."""

    # per layer k, v (NP, H, page, dh); k_scale, v_scale (NP, H, page, 1)
    pages: Optional[List[Dict[str, torch.Tensor]]]
    self_pt: torch.Tensor    # (S, SP) int32 — self-KV chain (NULL_PAGE beyond)
    cross_pt: torch.Tensor   # (S, CP) int32 — cross-KV chain
    src_mask: torch.Tensor   # (S, N) bool — True = pad key (all True when free)
    tok: torch.Tensor        # (S, 1) int64 — current decoder input token
    pos: torch.Tensor        # (S,) int32 — tokens generated so far
    limit: torch.Tensor      # (S,) int32 — budget; 0 ⇒ slot frozen
    done: torch.Tensor       # (S,) bool — row emitted EOS
    prev_pad: torch.Tensor   # (S, T) bool — pad-ness of decoder inputs so far
    toks: torch.Tensor       # (S, T) int64 — generated ids (PAD beyond pos)
    shards: Optional[List[Tuple[int, int, List[Dict[str, torch.Tensor]]]]] = None


def page_sets(pool: PagedPool) -> List[Tuple[int, Optional[int], List[Dict[str, torch.Tensor]]]]:
    """``(h0, h1, per-layer pages)`` of each place the pool's pages live: the
    whole pool (``h1`` None: every head) solo, each head shard under a serve
    mesh.  A writer stores heads ``[h0, h1)`` of its values into each set, on
    the set's device."""
    if pool.shards is None:
        return [(0, None, pool.pages)]
    return pool.shards


def chain_table_row(chain: Sequence[int], width: int) -> np.ndarray:
    row = np.full((width,), NULL_PAGE, np.int32)
    row[: len(chain)] = chain
    return row


def init_paged_pool(model, num_slots: int, geo: PageGeometry,
                    kv_dtype: str = "float32", mesh=None) -> PagedPool:
    """Every slot frozen (``limit = 0``) with null page tables, the pages
    stored in ``kv_dtype`` (a ``serve_kv_page_dtype`` name) — under a serve
    ``mesh`` split on the head axis over its shards' devices."""
    dev = model.device
    pages = model.init_page_pool(geo.num_pages, geo.page, KV_PAGE_DTYPES[kv_dtype])
    shards = None
    if mesh is not None:
        from csat_tpu_torch.parallel.mesh import serve_head_shards, serve_pool_shardings

        per = model.cfg.num_heads // serve_head_shards(mesh)
        shards = [(s * per, (s + 1) * per, layers)
                  for s, layers in enumerate(serve_pool_shardings(pages, mesh))]
        pages = None
    return PagedPool(
        pages=pages, shards=shards,
        self_pt=torch.full((num_slots, geo.sp), NULL_PAGE, dtype=torch.int32, device=dev),
        cross_pt=torch.full((num_slots, geo.cp), NULL_PAGE, dtype=torch.int32, device=dev),
        src_mask=torch.ones((num_slots, geo.mem_len), dtype=torch.bool, device=dev),
        tok=torch.full((num_slots, 1), PAD, dtype=torch.long, device=dev),
        pos=torch.zeros((num_slots,), dtype=torch.int32, device=dev),
        limit=torch.zeros((num_slots,), dtype=torch.int32, device=dev),
        done=torch.zeros((num_slots,), dtype=torch.bool, device=dev),
        prev_pad=torch.zeros((num_slots, geo.steps), dtype=torch.bool, device=dev),
        toks=torch.full((num_slots, geo.steps), PAD, dtype=torch.long, device=dev),
    )


def _ids(values, device) -> torch.Tensor:
    return torch.tensor(list(values), dtype=torch.long, device=device)


def admit_slot_state(pool: PagedPool, ids: torch.Tensor, limits: Sequence[int],
                     smask: torch.Tensor) -> None:
    """The decode state every admission path resets at rows ``ids`` — BOS
    start token, position 0, a budget clamped to the token capacity, cleared
    done / prev_pad / toks — and the rows' source pad mask ``smask`` (b,
    mem_len): one definition for prefill and attach, as the JAX package's
    ``serve/slots.py:admit_slot_state``."""
    t_cap = pool.toks.shape[1]
    pool.src_mask[ids] = smask
    # index_fill_ takes its value as a scalar argument; `x[ids] = v` would
    # first copy a one-element tensor to the card, a host sync each
    pool.tok.index_fill_(0, ids, BOS)
    pool.pos.index_fill_(0, ids, 0)
    pool.limit[ids] = torch.tensor([min(int(x), t_cap) for x in limits],
                                   dtype=torch.int32, device=ids.device)
    pool.done.index_fill_(0, ids, False)
    pool.prev_pad.index_fill_(0, ids, False)
    pool.toks.index_fill_(0, ids, PAD)


def scrub_pages(pool: PagedPool, chains: Sequence[Sequence[int]]) -> None:
    """Zero the freshly allocated pages of ``chains`` (scales to 1.0, so they
    dequantize to exact zeros): a freed page may hold a predecessor's values
    — NaN after a NaN drill — and a masked lane's weight of 0 times a NaN
    still poisons the softmax."""
    scrub = _ids((p for c in chains for p in c), pool.self_pt.device)
    for _, _, layers in page_sets(pool):
        ids = scrub.to(layers[0]["k"].device)
        for e in layers:
            for key in ("k", "v"):
                e[key].index_fill_(0, ids, 0)
                e[f"{key}_scale"].index_fill_(0, ids, 1.0)


@torch.no_grad()
def attach(pool: PagedPool, geo: PageGeometry, slot_ids: Sequence[int],
           limits: Sequence[int], self_chains: Sequence[Sequence[int]],
           cross_chains: Sequence[Sequence[int]], smask: np.ndarray) -> None:
    """Bring ``slot_ids`` live WITHOUT running the encoder — the prefix-cache
    hit path (the JAX package's ``build_attach``), in place: each row's
    cross chain already holds an identical earlier request's projections,
    so only its page-table rows, source mask ``smask`` (b, mem_len; True =
    pad key), BOS and budget are written, after its freshly allocated self
    pages are scrubbed (:func:`scrub_pages` — the miss path's prefill
    scrubs them too)."""
    dev = pool.self_pt.device
    scrub_pages(pool, self_chains)
    ids = _ids(slot_ids, dev)
    pool.self_pt[ids] = torch.from_numpy(
        np.stack([chain_table_row(c, geo.sp) for c in self_chains])).to(dev)
    pool.cross_pt[ids] = torch.from_numpy(
        np.stack([chain_table_row(c, geo.cp) for c in cross_chains])).to(dev)
    admit_slot_state(pool, ids, limits, torch.from_numpy(np.asarray(smask, bool)).to(dev))


@torch.no_grad()
def release(pool: PagedPool, slots: Sequence[int]) -> None:
    """Retire ``slots`` on the pool (the JAX package's ``build_release``), in
    place: zero the budget (the decode step's ``act`` gate) AND null the
    page-table rows, so the rows' per-tick dead writes land on the null page
    instead of pages the free list may hand to another request."""
    ids = _ids(slots, pool.self_pt.device)
    pool.limit.index_fill_(0, ids, 0)
    pool.self_pt.index_fill_(0, ids, NULL_PAGE)
    pool.cross_pt.index_fill_(0, ids, NULL_PAGE)


def tier_layer_order(n_layers: int) -> List[int]:
    """The decoder layers in the order a tier snapshot stacks them: the JAX
    pool's ``layer_{i}`` keys sorted by name (``layer_10`` before
    ``layer_2``), so a payload's layer axis means the same layers in both
    packages."""
    return sorted(range(n_layers), key=lambda i: f"layer_{i}")


@torch.no_grad()
def tier_gather(pool: PagedPool, row: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Snapshot the pages ``row`` (W,) of every layer — values AND scales, so
    a quantized chain round-trips byte for byte: ``(L, 2, W, H, page, dh)``
    in the storage dtype and ``(L, 2, W, H, page, 1)`` f32, K before V, the
    layers in :func:`tier_layer_order`, on the engine's device.  A serve
    mesh's shards are concatenated on the head axis, so the snapshot is the
    solo pool's."""
    dev = pool.self_pt.device
    ids = _ids(row, dev)
    vals, scales = [], []
    for _, _, layers in page_sets(pool):
        at = ids.to(layers[0]["k"].device)
        order = tier_layer_order(len(layers))
        vals.append(torch.stack([torch.stack((layers[i]["k"][at], layers[i]["v"][at]))
                                 for i in order]).to(dev))
        scales.append(torch.stack([torch.stack((layers[i]["k_scale"][at],
                                                layers[i]["v_scale"][at]))
                                   for i in order]).to(dev))
    return torch.cat(vals, dim=3), torch.cat(scales, dim=3)


@torch.no_grad()
def tier_restore(pool: PagedPool, row: Sequence[int], payload: torch.Tensor,
                 scales: torch.Tensor) -> None:
    """Write a :func:`tier_gather` snapshot back into the pages ``row`` (W,),
    in place.  Lanes whose id is out of range (the ``num_pages`` sentinel
    that pads a row) are dropped, never written to the null page.  Each
    shard of a serve mesh takes its heads of the snapshot."""
    row = torch.as_tensor(np.asarray(row, np.int64))
    live = (row >= 0) & (row < page_sets(pool)[0][2][0]["k"].shape[0])
    payload, scales = payload[:, :, live.to(payload.device)], scales[:, :, live.to(scales.device)]
    ids = row[live]
    for h0, h1, layers in page_sets(pool):
        dev = layers[0]["k"].device
        at = ids.to(dev)
        for j, i in enumerate(tier_layer_order(len(layers))):
            e = layers[i]
            for side, key in enumerate(("k", "v")):
                e[key][at] = payload[j, side, :, h0:h1].to(dev)
                e[f"{key}_scale"][at] = scales[j, side, :, h0:h1].to(dev)


def build_paged_decode_step(model, geo: PageGeometry):
    """→ ``step(pool) -> status``: advance every live slot one token.

    Attention reads K/V through each row's page chain (the paged-decode
    kernel on the card); this step's K/V are then written into the page
    owning position ``pos`` (``self_pt[s, pos // page]`` at ``pos % page``),
    frozen rows writing to the null page.  A row that finishes this step
    nulls its own table rows, so its pages can be handed out again at once.
    ``status`` is the ``(S, 3)`` int32 ``[pos, done, bad]`` snapshot, ``bad``
    flagging an active row whose log-probs went non-finite."""
    page = geo.page

    def views(e, table, dev, **extra):
        return {"pages_k": e["k"], "pages_v": e["v"], "scale_k": e["k_scale"],
                "scale_v": e["v_scale"], "table": table.to(dev), **extra}

    @torch.no_grad()
    def step(pool: PagedPool) -> torch.Tensor:
        if pool.shards is None:
            caches = [
                {"self": views(e, pool.self_pt, pool.pos.device, width=geo.steps, idx=pool.pos),
                 "cross": views(e, pool.cross_pt, pool.pos.device, width=geo.mem_len)}
                for e in pool.pages]
        else:  # each head shard's pages, tables and positions on its device
            caches = []
            for layer in range(len(pool.shards[0][2])):
                parts = {"self": [], "cross": []}
                for h0, h1, layers in pool.shards:
                    e = layers[layer]
                    dev = e["k"].device
                    parts["self"].append((h0, h1, views(e, pool.self_pt, dev, width=geo.steps,
                                                        idx=pool.pos.to(dev))))
                    parts["cross"].append((h0, h1, views(e, pool.cross_pt, dev,
                                                         width=geo.mem_len)))
                caches.append({"self": {"shards": parts["self"]},
                               "cross": {"shards": parts["cross"]}})
        log_probs, steps = model.decode_step(
            pool.tok, pool.pos, caches, pool.src_mask, pool.prev_pad)
        nxt = torch.argmax(log_probs, dim=-1)                       # (S,)
        act = (~pool.done) & (pool.pos < pool.limit)
        bad = act & torch.any(~torch.isfinite(log_probs), dim=-1)
        nxt = torch.where(act, nxt, torch.full_like(nxt, PAD))

        pos = pool.pos.long()
        pidx = torch.clamp(pos // page, 0, geo.sp - 1)
        page_ids = torch.gather(pool.self_pt, 1, pidx[:, None])[:, 0].long()
        page_ids = torch.where(act, page_ids, torch.full_like(page_ids, NULL_PAGE))
        offs = pos % page
        # in place, where the JAX step returns new page arrays; frozen rows
        # all write the null page, whose contents no live lane reads
        for h0, h1, layers in page_sets(pool):
            dev = layers[0]["k"].device
            pids, poffs = page_ids.to(dev), offs.to(dev)
            for e, (k_step, v_step) in zip(layers, steps):
                kq, ks = quantize_kv(k_step[:, h0:h1, 0, :], e["k"].dtype)    # (S, H, dh)
                vq, vs = quantize_kv(v_step[:, h0:h1, 0, :], e["v"].dtype)
                e["k"][pids, :, poffs, :] = kq.to(dev)
                e["v"][pids, :, poffs, :] = vq.to(dev)
                e["k_scale"][pids, :, poffs, :] = ks.to(dev)
                e["v_scale"][pids, :, poffs, :] = vs.to(dev)

        t_cap = pool.toks.shape[1]
        ar = torch.arange(t_cap, device=pos.device)[None, :]
        write = (ar == pos[:, None]) & act[:, None]
        pool.toks.copy_(torch.where(write, nxt[:, None], pool.toks))
        write_next = (ar == (pos + 1)[:, None]) & act[:, None]
        pool.prev_pad.copy_(torch.where(write_next, (nxt == PAD)[:, None], pool.prev_pad))
        pool.done |= act & (nxt == EOS)
        pool.pos.copy_(torch.where(act, pool.pos + 1, pool.pos))
        pool.tok.copy_(torch.where(act[:, None], nxt[:, None], pool.tok))
        alive = (~pool.done) & (pool.pos < pool.limit)
        pool.self_pt.masked_fill_(~alive[:, None], NULL_PAGE)
        pool.cross_pt.masked_fill_(~alive[:, None], NULL_PAGE)
        return torch.stack([pool.pos, pool.done.to(torch.int32), bad.to(torch.int32)], dim=1)

    return step
