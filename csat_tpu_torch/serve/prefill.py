"""Bucketed prefill: encode admitted requests and write them into the pool.

Counterpart of the JAX package's ``serve/prefill.py:45-247``.  Admission
encodes a group of requests at the smallest fitting node capacity from the
config's bucket ladder and projects the per-layer cross-attention K/V from
the memory.  :func:`paged_prefill` cuts it into whole pages written into
each request's cross chain, scrubs its freshly allocated self pages to zero
(a freed page may hold a predecessor's values), and resets the slot's decode
state; :func:`rect_prefill` (``build_prefill``'s twin, the rectangle layout
of ``serve/slots.py``) writes it zero-padded into the slot's cross rectangle
and zeroes its self rectangle instead.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from csat_tpu_torch.configs import Config
from csat_tpu_torch.data.bucketing import src_bucket_ladder
from csat_tpu_torch.data.dataset import Batch, batch_to_device, collate
from csat_tpu_torch.ops.paged_decode import quantize_kv
from csat_tpu_torch.serve.pages import (
    PagedPool, PageGeometry, admit_slot_state, chain_table_row, page_sets, scrub_pages)
from csat_tpu_torch.utils import PAD

__all__ = ["PrefillSpec", "prefill_plan", "assign_prefill_bucket", "collate_requests",
           "paged_prefill", "rect_prefill"]


class PrefillSpec(NamedTuple):
    n: int           # AST-node capacity of this prefill shape
    batch_size: int  # requests admitted per call


def prefill_plan(cfg: Config) -> Tuple[PrefillSpec, ...]:
    """Ascending prefill ladder; batch sizes follow the node budget
    (``serve_prefill_budget``, default half the pool at flagship length),
    capped by the slot count."""
    budget = cfg.serve_prefill_budget or max(1, cfg.serve_slots // 2) * cfg.max_src_len
    return tuple(
        PrefillSpec(n, min(cfg.serve_slots, max(1, budget // n)))
        for n in src_bucket_ladder(cfg)
    )


def assign_prefill_bucket(specs: Sequence[PrefillSpec], num_node: int) -> int:
    """Smallest-fitting bucket index."""
    for k, spec in enumerate(specs):
        if num_node <= spec.n:
            return k
    raise ValueError(f"num_node={num_node} exceeds the flagship bucket {specs[-1].n}")


def collate_requests(samples: Sequence[Dict[str, np.ndarray]], n: int, cfg: Config) -> Batch:
    """Stack flagship-width request samples into a :class:`Batch` at node
    capacity ``n`` (slicing drops only zero padding: every sample here has
    ``num_node <= n``) with the shared mask-before-offset collate."""
    rows = len(samples)
    arrs = {
        "src_seq": np.stack([np.asarray(s["src_seq"])[:n] for s in samples]),
        "tgt_seq": np.zeros((rows, 1), np.int32),
        "target": np.zeros((rows, 1), np.int32),
        "L_raw": np.stack([np.asarray(s["L_raw"])[:n, :n] for s in samples]),
        "T_raw": np.stack([np.asarray(s["T_raw"])[:n, :n] for s in samples]),
        "num_node": np.asarray([int(s["num_node"]) for s in samples], np.int32),
        "tree_pos": np.stack([np.asarray(s["tree_pos"])[:n] for s in samples]),
        "triplet": np.stack([np.asarray(s["triplet"])[:n] for s in samples]),
    }
    return collate(arrs, cfg.max_src_len)


@torch.no_grad()
def paged_prefill(model, cfg: Config, geo: PageGeometry, pool: PagedPool, n: int,
                  samples: Sequence[Dict[str, np.ndarray]], slot_ids: List[int],
                  limits: List[int], self_chains: List[List[int]],
                  cross_chains: List[List[int]]) -> None:
    """Encode ``samples`` at bucket width ``n`` and admit them into
    ``slot_ids`` of ``pool`` (in place)."""
    dev = model.device
    page = geo.page
    cpn = geo.cross_pages(n)
    batch = batch_to_device(collate_requests(samples, n, cfg), dev)
    memory, _ = model.encode(batch)
    cross = model.project_cross_kv(memory)
    b = len(samples)

    def paginate(x):
        """(b, H, n, dh) → (b * cpn, H, page, dh) whole-page blocks."""
        x = torch.nn.functional.pad(x, (0, 0, 0, cpn * page - n))
        _, h, _, dh = x.shape
        return x.reshape(b, h, cpn, page, dh).transpose(1, 2).reshape(b * cpn, h, page, dh)

    flat_cross = torch.tensor([p for c in cross_chains for p in c], dtype=torch.long, device=dev)
    scrub_pages(pool, self_chains)
    # under a serve mesh each head shard's heads go to its device
    for h0, h1, layers in page_sets(pool):
        at = layers[0]["k"].device
        ids = flat_cross.to(at)
        for e, kv in zip(layers, cross):
            for key in ("k", "v"):
                vals, scale = quantize_kv(paginate(kv[key][:, h0:h1]), e[key].dtype)
                e[key][ids] = vals.to(at)
                e[f"{key}_scale"][ids] = scale.to(at)

    ids = torch.tensor(slot_ids, dtype=torch.long, device=dev)
    pool.self_pt[ids] = torch.from_numpy(
        np.stack([chain_table_row(c, geo.sp) for c in self_chains])).to(dev)
    pool.cross_pt[ids] = torch.from_numpy(
        np.stack([chain_table_row(c, geo.cp) for c in cross_chains])).to(dev)
    smask = torch.ones((b, geo.mem_len), dtype=torch.bool, device=dev)
    smask[:, :n] = batch.src_seq == PAD
    admit_slot_state(pool, ids, limits, smask)


@torch.no_grad()
def rect_prefill(model, cfg: Config, pool, n: int, samples: Sequence[Dict[str, np.ndarray]],
                 slot_ids: List[int], limits: List[int]) -> None:
    """Encode ``samples`` at bucket width ``n`` and admit them into
    ``slot_ids`` of the rectangle pool (``serve/slots.py``), in place: each
    row's cross K/V zero-padded to ``mem_len``, its self rectangle zeroed,
    its decode state reset.  A row whose slot id is the sentinel
    ``num_slots`` (padding) is encoded and dropped, as the JAX scatters drop
    it."""
    dev = model.device
    num_slots, mem_len = pool.src_mask.shape
    batch = batch_to_device(collate_requests(samples, n, cfg), dev)
    memory, _ = model.encode(batch)
    cross = model.project_cross_kv(memory)
    keep = [j for j, s in enumerate(slot_ids) if 0 <= s < num_slots]
    rows = torch.tensor(keep, dtype=torch.long, device=dev)
    ids = torch.tensor([slot_ids[j] for j in keep], dtype=torch.long, device=dev)
    for c, kv in zip(pool.cache, cross):
        c["k"].index_fill_(0, ids, 0)
        c["v"].index_fill_(0, ids, 0)
        for key in ("k", "v"):
            c[f"cross_{key}"][ids] = torch.nn.functional.pad(
                kv[key], (0, 0, 0, mem_len - n))[rows].to(c[f"cross_{key}"].dtype)
    smask = torch.ones((len(samples), mem_len), dtype=torch.bool, device=dev)
    smask[:, :n] = batch.src_seq == PAD
    admit_slot_state(pool, ids, [limits[j] for j in keep], smask[rows])
