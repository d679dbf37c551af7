"""ServeEngine: continuous batching over the block-paged slot pool.

Counterpart of the JAX package's ``serve/engine.py`` with the same public
door — ``submit`` / ``poll`` / ``tick`` / ``drain`` / ``generate`` and
``page_leaks`` — over ``cfg.serve_slots`` decode slots whose K/V live in
pages of ``cfg.serve_kv_page_dtype`` (f32, or bf16 / int8 rows quantized on
write with f32 per-row scales), under the model's compute dtype.  Each
:meth:`tick` is one scheduler round:

1. **retire** — rows that emitted EOS or spent their token budget hand their
   tokens back (``OK``) and free their pages; a row whose log-probs went
   non-finite retires ``FAILED`` without its last token;
2. **admit** — free slots refill from the queue head: requests group by
   smallest-fitting prefill bucket (buckets ascending, FIFO within one), each
   is funded with a self chain sized by its token budget and a cross chain
   sized by its bucket (an unfundable request waits at the head), and each
   group runs the encoder at its bucket width (``serve/prefill.py``);
3. **decode** — one step advances every live slot a token
   (``serve/pages.py``), then one ``(S, 3)`` status read reaches the host.

A sample that fails validation resolves ``FAILED`` at submit.  Prefix cache,
KV tiering, the rectangle layout, meshes, fleets, fault drills, deadlines,
priorities, warm start, the stats summary (``effective_slots`` among it),
observability and the network front door are not part of this port yet.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from csat_tpu_torch.configs import Config
from csat_tpu_torch.serve.ingest import PoisonRequestError, validate_sample
from csat_tpu_torch.serve.pages import (
    NULL_PAGE, PageAllocator, build_paged_decode_step, init_paged_pool, page_geometry)
from csat_tpu_torch.serve.prefill import assign_prefill_bucket, paged_prefill, prefill_plan
from csat_tpu_torch.utils import resolve_device

__all__ = ["Request", "RequestStatus", "PagePlan", "ServeEngine"]


class RequestStatus:
    PENDING = "PENDING"  # queued or in flight
    OK = "OK"            # tokens delivered (EOS or budget)
    FAILED = "FAILED"    # malformed sample or non-finite logits
    TERMINAL = (OK, FAILED)


@dataclasses.dataclass
class Request:
    id: int
    sample: Optional[Dict[str, np.ndarray]]
    limit: int                       # decode-token budget (<= steps)
    submit_t: float
    admit_t: Optional[float] = None
    done_t: Optional[float] = None
    slot: Optional[int] = None
    bucket: Optional[int] = None
    tokens: Optional[np.ndarray] = None  # generated ids incl. the EOS, if any
    status: str = RequestStatus.PENDING
    error: Optional[str] = None

    @property
    def finished(self) -> bool:
        return self.done_t is not None

    @property
    def ok(self) -> bool:
        return self.status == RequestStatus.OK


@dataclasses.dataclass
class PagePlan:
    self_chain: List[int]
    cross_chain: List[int]


class ServeEngine:
    """submit / poll / tick / drain continuous-batching inference engine on
    ``device`` (default ``cuda``; ``device="cpu"`` runs the plain paths)."""

    def __init__(self, model, cfg: Config,
                 device: Optional[Union[str, torch.device]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, engine asked for {self.device}")
        self.model = model
        self.cfg = cfg
        self.clock = clock
        self.steps = cfg.max_tgt_len - 1
        self.num_slots = cfg.serve_slots
        self.specs = prefill_plan(cfg)
        self.geo = page_geometry(cfg)
        self._allocator = PageAllocator(self.geo.num_pages)
        self._pool = init_paged_pool(model, self.num_slots, self.geo, cfg.serve_kv_page_dtype)
        self._step = build_paged_decode_step(model, self.geo)
        self._slots: List[Optional[Request]] = [None] * self.num_slots
        self._plans: List[Optional[PagePlan]] = [None] * self.num_slots
        self._queue: Deque[Request] = deque()
        self._results: Dict[int, Request] = {}
        self._status: Optional[np.ndarray] = None  # last (S, 3) [pos, done, bad]
        self._next_id = 0
        self.n_ticks = 0
        self.n_prefills = 0
        self.n_decode_steps = 0

    # ---------------- public door ----------------

    def submit(self, sample: Dict[str, np.ndarray], max_new_tokens: int = 0) -> int:
        """Queue one request and return its id; a malformed sample resolves
        ``FAILED`` at once.  ``max_new_tokens`` caps the decode budget (0 =
        ``max_tgt_len - 1``)."""
        now = self.clock()
        limit = self.steps if max_new_tokens <= 0 else min(max_new_tokens, self.steps)
        req = Request(id=self._next_id, sample=sample, limit=limit, submit_t=now)
        self._next_id += 1
        try:
            validate_sample(sample, self.cfg, self.model.src_vocab_size,
                            self.model.triplet_vocab_size)
        except PoisonRequestError as e:
            self._finish(req, RequestStatus.FAILED, error=f"poison request: {e}")
            return req.id
        self._queue.append(req)
        return req.id

    def poll(self, req_id: int) -> Optional[Request]:
        """The finished request, or None while queued/in flight."""
        return self._results.get(req_id)

    def tick(self) -> int:
        """One scheduler round (retire → admit → decode); returns the number
        of slots live afterwards."""
        self.n_ticks += 1
        self._retire()
        self._admit()
        live = sum(r is not None for r in self._slots)
        if live:
            self._status = self._step(self._pool).cpu().numpy()
            self.n_decode_steps += 1
        return live

    def drain(self, max_ticks: int = 0) -> Dict[int, Request]:
        """Tick until queue and pool are empty; returns all results."""
        max_ticks = max_ticks or (len(self._queue) + self.num_slots + 1) * (self.steps + 2)
        ticks = 0
        while self._queue or any(r is not None for r in self._slots):
            self.tick()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(f"drain exceeded {max_ticks} ticks — a slot is not retiring")
        self._retire()
        return self._results

    def generate(self, samples: Sequence[Dict[str, np.ndarray]],
                 max_new_tokens: int = 0) -> List[Request]:
        """Submit-and-drain a list; results in submission order."""
        ids = [self.submit(s, max_new_tokens) for s in samples]
        self.drain()
        return [self._results[i] for i in ids]

    def page_leaks(self) -> int:
        """Pages allocated beyond what live slots hold — at quiescence any
        positive value is a leaked chain."""
        held = sum(len(p.self_chain) + len(p.cross_chain) for p in self._plans if p is not None)
        return self._allocator.used_pages - held

    @property
    def occupancy(self) -> int:
        return sum(r is not None for r in self._slots)

    # ---------------- scheduler internals ----------------

    def _finish(self, req: Request, status: str, error: Optional[str] = None) -> None:
        req.status = status
        req.error = error
        req.done_t = self.clock()
        req.sample = None
        self._results[req.id] = req

    def _free_slot(self, i: int) -> None:
        plan = self._plans[i]
        self._slots[i] = None
        self._plans[i] = None
        if plan is not None:
            self._allocator.free(plan.self_chain)
            self._allocator.free(plan.cross_chain)

    def _retire(self) -> None:
        if self._status is None or not any(r is not None for r in self._slots):
            return
        pos, done, bad = self._status[:, 0], self._status[:, 1], self._status[:, 2]
        toks = None
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            if bad[i]:
                # the newest token is argmax of non-finite log-probs: drop it
                # and freeze the row (zero budget, null tables)
                n = max(int(pos[i]) - 1, 0)
                status, error = RequestStatus.FAILED, "non-finite logits during decode"
                self._pool.limit[i] = 0
                self._pool.self_pt[i] = NULL_PAGE
                self._pool.cross_pt[i] = NULL_PAGE
            elif done[i] or pos[i] >= req.limit:
                n, status, error = int(pos[i]), RequestStatus.OK, None
            else:
                continue
            if toks is None:
                toks = self._pool.toks.cpu().numpy()
            req.tokens = np.array(toks[i, :n], dtype=np.int32)
            self._free_slot(i)
            self._finish(req, status, error)

    def _plan_pages(self, req: Request) -> Optional[PagePlan]:
        self_chain = self._allocator.alloc(self.geo.self_pages(req.limit))
        if self_chain is None:
            return None
        cross_chain = self._allocator.alloc(self.geo.cross_pages(self.specs[req.bucket].n))
        if cross_chain is None:
            self._allocator.free(self_chain)
            return None
        return PagePlan(self_chain, cross_chain)

    def _admit(self) -> None:
        free = [i for i, r in enumerate(self._slots) if r is None]
        if not free or not self._queue:
            return
        window = [self._queue.popleft() for _ in range(min(len(free), len(self._queue)))]
        groups: Dict[int, List[Request]] = defaultdict(list)
        for req in window:
            req.bucket = assign_prefill_bucket(self.specs, int(req.sample["num_node"]))
            groups[req.bucket].append(req)
        order = [req for k in sorted(groups) for req in groups[k]]
        while order:
            k = order[0].bucket
            chunk: List[Request] = []
            plans: List[PagePlan] = []
            while order and order[0].bucket == k and len(chunk) < self.specs[k].batch_size:
                plan = self._plan_pages(order[0])
                if plan is None:
                    break  # the pool cannot fund this request this tick
                plans.append(plan)
                chunk.append(order.pop(0))
            if not chunk:
                # page backpressure: requeue the rest in submission order
                pending = {id(r) for r in order}
                self._queue.extendleft(reversed([r for r in window if id(r) in pending]))
                return
            slot_ids = [free.pop(0) for _ in chunk]
            paged_prefill(
                self.model, self.cfg, self.geo, self._pool, self.specs[k].n,
                [r.sample for r in chunk], slot_ids, [r.limit for r in chunk],
                [p.self_chain for p in plans], [p.cross_chain for p in plans])
            self.n_prefills += 1
            now = self.clock()
            for req, s, plan in zip(chunk, slot_ids, plans):
                req.admit_t = now
                req.slot = s
                self._slots[s] = req
                self._plans[s] = plan
