"""The serving driver: ``ServeEngine.submit`` / ``tick`` in process, open loop.

Set-up builds the model over the benchmark's weights and one
``serve.engine.ServeEngine`` (the configuration's slots and pages, the mix's
settings), then warms it with the mix's warm-up requests: every prefill
width of the engine's ladder, the decode step, and — in a mix with repeats —
the pool of earlier ASTs, which the window then finds in the prefix cache.

The window opens at ``t = 0`` and lasts ``seconds``.  Each request is
submitted once its due time has passed, whatever the engine is doing (open
loop: a slow tick makes later requests late, and their latency counts it);
between submissions the loop ticks the engine while it has work, and sleeps
to the next due time when it has none.  A request ends when the host reads
its result after the tick that finished it.  After the window closes
nothing new is submitted, and the engine ticks on for ``drain_cap_s`` more
at most, until every request due in the window has ended.  A mix offered
above the engine's capacity sets ``drain_cap_s`` to 0: the queue grows
through the window, every slot stays busy, and what has not ended at the
close is the backlog, not a failure.

A traced run (``--trace 1``) then profiles ``profile_seconds`` more of the
same open loop on traffic of its own (another stream of the seed), on the
engine as the window left it, so the profiler's cost stays out of the
window.  While it runs, each paged-decode launch is noted with the live
slots' memory nodes and decoded positions, which bound its bytes.  After
that the program is freed and the reference teacher-forces every finished
request of the window through the model from the same weights, and reads
the gap of each served token below its best logit.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.core import gates
from portbench.core.record import Record, Spans
from portbench.core.weights import make_weights
from portbench.reference.model import BOS, PAD, Reference, relation_planes

__all__ = ["run"]


def _engine(cell, seed: int, dev):
    from csat_tpu_torch.serve.engine import ServeEngine

    from portbench.core.port import port_config, port_model
    from portbench.core.spec import ROOT

    cfg = port_config(cell.model, cell.mix, ROOT)
    model = port_model(cfg, cell.model, make_weights(cell.model, seed, dev), dev)
    return ServeEngine(model, cfg, device=dev), model, cfg


def _ladder(cfg) -> List[int]:
    """The engine's prefill widths, ascending."""
    from csat_tpu_torch.data.bucketing import src_bucket_ladder

    return list(src_bucket_ladder(cfg))


def decode_lanes(engine) -> Optional[Dict[str, List[int]]]:
    """At a decode launch, what the live slots read through their page
    tables: ``cross``, the memory nodes of each distinct cross chain (slots
    that share a chain, prefix-cache hits of one AST, count once), and
    ``self``, each live slot's decoded positions.  None where the engine does
    not show its slots."""
    slots = getattr(engine, "_slots", None)
    status = getattr(engine, "_status", None)
    tick = getattr(engine, "_tick_no", None)
    if slots is None or tick is None:
        return None
    cross: Dict[object, int] = {}
    pos: List[int] = []
    for i, r in enumerate(slots):
        if r is None or r.sample is None:
            continue
        fresh = r.admit_tick == tick or status is None
        pos.append(0 if fresh else int(status[i, 0]))
        cross[r.phash if r.phash is not None else ("slot", i)] = int(r.sample["num_node"])
    return {"cross": list(cross.values()), "self": pos}


def _collect(engine, pending: Dict[int, int], done: List, t_open: float, fault) -> None:
    for rid in list(pending):
        r = engine.pop_result(rid)
        if r is None:
            continue
        i = pending.pop(rid)
        tokens = np.asarray(r.tokens if r.tokens is not None else [], np.int64)
        if fault is not None:
            tokens = fault(tokens)
        done[i] = (time.perf_counter() - t_open, r.status == "OK", tokens)


def _warm(engine, traffic) -> None:
    for group in traffic.warmup:
        for idx in group:
            engine.submit(traffic.request_sample(idx), max_new_tokens=int(traffic.warmup_max_new[idx]))
        engine.drain()


def _open_loop(engine, traffic, seconds: float, cap: float, spans, fault):
    """Submit each request of ``traffic`` once it is due, tick while the
    engine has work, sleep to the next due time while it has none, until
    every request has ended or ``cap`` seconds have passed.  → ``(done per
    request: (seconds after the opening, OK, tokens) or None, lateness of each
    submission, queue depth when ``seconds`` had passed, live slots summed
    over the ticks that began inside ``seconds``, those ticks)``."""
    due, n = traffic.due, len(traffic.due)
    done: List = [None] * n
    late: List[float] = []
    pending: Dict[int, int] = {}
    nxt, backlog = 0, None
    live_sum, ticks = 0, 0
    t_open = time.perf_counter()
    while True:
        now = time.perf_counter() - t_open
        while nxt < n and due[nxt] <= now:
            with spans.span("serve.submit"):
                rid = engine.submit(traffic.request_sample(int(traffic.sample[nxt])),
                                    max_new_tokens=int(traffic.max_new[nxt]))
            late.append(now - due[nxt])
            pending[rid] = nxt
            nxt += 1
        if backlog is None and now >= seconds:
            backlog = engine.queue_depth
        if engine.queue_depth or engine.occupancy:
            with spans.span("serve.tick"):
                live = engine.tick()
            if now < seconds:
                live_sum += live
                ticks += 1
            _collect(engine, pending, done, t_open, fault)
        elif nxt < n:
            with spans.span("serve.idle"):
                time.sleep(max(0.0, min(due[nxt] - now, 0.002)))
        if (nxt >= n and not pending) or now >= cap:
            break
    return (done, late, (engine.queue_depth if backlog is None else backlog), live_sum, ticks)


def run(cell, rec: Record, opts) -> Dict:
    from portbench.core.profile import Tracer
    from portbench.core.spec import load_part

    mix, dev = cell.mix, opts.device
    generator = load_part("traffic", mix["generator"])
    engine, model, cfg = _engine(cell, opts.seed, dev)
    ladder = _ladder(cfg)
    traffic = generator.generate(mix, cell.model, opts.seed, opts.seconds, ladder)
    _warm(engine, traffic)
    stats = engine.reset_stats()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    rec.setup_s = time.perf_counter() - opts.t_process

    drain = float(mix["drain_cap_s"])
    done, late, backlog, live_sum, ticks = _open_loop(engine, traffic, opts.seconds,
                                                      opts.seconds + drain, rec.spans, opts.fault)
    rec.window_s = float(opts.seconds)
    for i, d in enumerate(done):
        t_done, ok, tokens = d if d is not None else (None, False, np.zeros(0))
        rec.requests.append({"due": float(traffic.due[i]), "done": t_done, "ok": bool(ok),
                             "tokens": int(len(tokens)),
                             "nodes": int(traffic.arrays["num_node"][traffic.sample[i]]),
                             "repeat": bool(traffic.repeat[i])})
    rec.counters.update({
        "prefix_hits": float(stats.prefix_hits), "prefix_misses": float(stats.prefix_misses),
        "prefill_calls": float(stats.prefill_calls), "decode_steps": float(stats.decode_steps),
        "backlog_at_close": float(backlog), "submitted": float(len(late)),
        "ended": float(sum(d is not None for d in done)),
        "live_slot_ticks": float(live_sum), "window_ticks": float(ticks),
        "late_max_s": max(late) if late else 0.0,
        "late_mean_s": float(np.mean(late)) if late else 0.0, "wait_s": list(stats.wait_s)})

    if opts.trace and dev.type == "cuda":
        # the traced segment comes after the window, on traffic of its own,
        # so the profiler's cost stays out of the window's host-clock numbers
        seg = float(mix["profile_seconds"])
        traced = Spans()
        tracer = Tracer(rec, traced)
        more = generator.generate(mix, cell.model, opts.seed, seg, ladder, stream=4)
        rec.launch_context = lambda fn: decode_lanes(engine) if fn == "paged_decode" else None
        tracer.start()
        _open_loop(engine, more, seg, seg + drain, traced, None)
        tracer.stop()
        rec.launch_context = None
    # a request that ended other than OK failed; one still open at the end
    # of the drain failed too, unless the mix has none (above capacity)
    failed = sum(1 for r in rec.requests
                 if (r["done"] is not None and not r["ok"]) or (r["done"] is None and drain > 0))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    engine.close()
    del engine, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    finished = [i for i, d in enumerate(done) if d is not None and d[1] and len(d[2])]
    values, control = _check(cell, opts, traffic, done, finished, ladder)
    out = {"attempted": len(done), "failed": failed, "memory_peak_bytes": peak, "values": values}
    if opts.control:
        out["control"] = control
    return out


def reference_inputs(model: Dict, traffic, idx: List[int], n: int, device) -> Dict[str, torch.Tensor]:
    """Requests ``idx`` collated at node width ``n`` (mask before offset)."""
    a = traffic.arrays
    rows = [int(traffic.sample[i]) for i in idx]
    host = {"src_seq": a["src_seq"][rows][:, :n],
            **relation_planes(a["L_raw"][rows][:, :n, :n], a["T_raw"][rows][:, :n, :n],
                              model["max_src_len"])}
    return {k: torch.as_tensor(v).to(device) for k, v in host.items()}


def _check(cell, opts, traffic, done, finished, widths):
    """``({"logit_gap": widest gap}, control readings)`` over every finished
    request, in blocks of ``check_block`` requests of one prefill width
    (``widths``, the engine's)."""
    model, dev = cell.model, opts.device
    if not finished:
        return {"logit_gap": float("inf")}, {"logit_gap": float("inf")}
    params = make_weights(model, opts.seed, dev)
    refs = {"f32": Reference(model, params)}
    if opts.control:
        refs["tf32"] = Reference(model, params, "tf32")
    groups: Dict[int, List[int]] = {}
    for i in finished:
        nodes = int(traffic.arrays["num_node"][traffic.sample[i]])
        groups.setdefault(min(w for w in widths if w >= nodes), []).append(i)
    block = int(cell.mix["check_block"])
    gaps, ctrl = [], []
    with torch.no_grad():
        for width, members in groups.items():
            for b0 in range(0, len(members), block):
                idx = members[b0:b0 + block]
                inp = reference_inputs(model, traffic, idx, width, dev)
                toks = [done[i][2] for i in idx]
                t = max(len(x) for x in toks)
                tgt = np.full((len(idx), t), PAD, np.int64)
                served = np.zeros((len(idx), t), np.int64)
                for r, x in enumerate(toks):
                    tgt[r, 0] = BOS
                    tgt[r, 1:len(x)] = x[:-1]
                    served[r, :len(x)] = x
                tgt_t = torch.as_tensor(tgt, device=dev)
                served_t = torch.as_tensor(served, device=dev)
                lengths = [len(x) for x in toks]
                logits = {}
                for name, ref in refs.items():
                    mem, _ = ref.encode(inp["src_seq"], inp["L"], inp["T"], inp["L_mask"],
                                        inp["T_mask"])
                    logits[name] = ref.decode(tgt_t, mem, inp["src_seq"] == PAD)
                gaps += gates.served_gaps(logits["f32"], served_t, lengths)
                if "tf32" in logits:
                    ctrl += gates.served_gaps(logits["f32"], served_t, lengths,
                                              chosen=logits["tf32"].argmax(dim=-1))
                del logits
    return {"logit_gap": max(gaps)}, ({"logit_gap": max(ctrl)} if ctrl else None)
