"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # also trace one serving run with torch.profiler

Phases, each printing one JSON line:

1. ``device``  — the card, as ``nvidia-smi`` names it, with TF32 off;
2. ``build``   — compiles every CUDA kernel of the serving path from the
   checkout's sources (``csat_tpu_torch/ops/csrc``) with ``nvcc`` for sm_90a;
3. ``kernel``  — each kernel against its plain PyTorch version on the card, at
   the shapes the serving path gives it: max abs error (with its tolerance),
   exact skip counts, and times (CUDA events, median of several runs);
4. ``serve``   — the flagship ``python`` model at full width (random weights
   from a seed, ``eval_graph="expected"``) serves 16 synthetic requests
   through ``ServeEngine``; every request must be OK, no page may leak, every
   kernel must have launched, and the tokens must equal the same weights
   served on the CPU through the plain paths (up to a near-tie, see below);
5. ``kernels`` — one line listing every kernel with its route, source, the
   TPU kernel it replaces, its launches in phase 4, its error, times and
   bound.

The line before the last is the card's ``name, power.limit``; the last line
is ``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is
then non-zero and that line is not printed.  The script needs a CUDA device
and the ``csat_tpu_torch`` package beside it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out"  # run reports (ptxas log, profiler trace); in .gitignore

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s outside
# the tensor cores — the kernels here run f32 SIMT arithmetic.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12

SEED = 2021
SRC_VOCAB, TGT_VOCAB = 10000, 20000  # the reference's vocabulary caps
N_REQUESTS = 16
BUDGETS = (0, 12, 30, 0, 20, 8, 0, 40)  # 0 = the full max_tgt_len - 1
TIE_MARGIN = 1e-4
FLEX_TOL = 2e-5   # f32 kernel vs plain: summation order only
PAGED_TOL = 1e-5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int = 20, trials: int = 7) -> float:
    """Median over ``trials`` of the mean time of ``reps`` back-to-back
    calls, between CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound_ms(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — this run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))
    return smi


def build_phase() -> None:
    from csat_tpu_torch.ops import build

    seconds = build.build_all()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "ptxas.txt").write_text(
        "\n".join(f"== {name}\n{log}" for name, log in build.BUILD_LOG.items()))
    for fn in build.KERNELS:
        build.kernel(fn)  # load and bind every entry point
    emit("build", seconds=seconds, libraries=sorted(build.SOURCES), kernels=sorted(build.KERNELS))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _flex_inputs(mod: str, b: int, n: int, gen: torch.Generator, dev):
    from csat_tpu_torch.ops.mods import cse_mod, sbm_expected_mod

    h, dh, r_len, kk = 8, 64, 150, 10
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(dev)
    q, k, v = rnd(b, h, n, dh), rnd(b, h, n, dh), rnd(b, h, n, dh)
    # padded keys in every row but the first; the short rows leave whole
    # 64-key tiles padded, which the SBM kernel skips
    n_real = [n, n - 3, n // 2, n // 5, n - 1, n // 3, 2 * n // 3, max(1, n // 10)][:b]
    if mod == "cse":
        rel = torch.randint(0, r_len, (b, 2, n, n), generator=gen)  # not symmetric
        mask = torch.rand((b, 2, n, n), generator=gen) < 0.3
        for i, m in enumerate(n_real):
            mask[i, :, :, m:] = True
            mask[i, :, m:, :] = True
        mask[0, 0, 2, :] = True  # all-masked rows: uniform over the n columns
        mask[b - 1, 1, 5, :] = True
        spec, aux = cse_mod(rnd(h, r_len, dh), rnd(h, r_len, dh), rel.to(dev), mask.to(dev))
    else:
        pad = torch.zeros((b, n), dtype=torch.bool)
        for i, m in enumerate(n_real):
            pad[i, m:] = True
        logits = torch.randn(h, kk * kk, generator=gen)
        s_aff = torch.softmax(logits, -1).reshape(h, kk, kk)
        spec, aux = sbm_expected_mod(torch.sigmoid(rnd(b, h, n, kk)),
                                     torch.sigmoid(rnd(b, h, n, kk)), s_aff.to(dev), pad.to(dev))
    return q, k, v, spec, aux


def flex_check(mod: str, b: int, n: int, gen, dev) -> dict:
    from csat_tpu_torch.ops import build, flex_core

    q, k, v, spec, aux = _flex_inputs(mod, b, n, gen, dev)
    out, ex = flex_core.flex_attention(q, k, v, spec, aux)
    ref, rex = flex_core.flex_reference(q, k, v, spec, aux)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    lse_err = (ex["lse"] - rex["lse"]).abs().max().item()
    gsum_err = ((ex["graph_sum"] - rex["graph_sum"]).abs()
                / rex["graph_sum"].abs().clamp_min(1.0)).max().item()
    skips = flex_core.reference_block_skip(spec, aux, flex_core.geometry(q))
    skip_equal = bool(torch.equal(ex["skipped_blocks"], skips))
    if not (err <= FLEX_TOL and lse_err <= FLEX_TOL and gsum_err <= 1e-5 and skip_equal
            and torch.isfinite(out).all()):
        raise AssertionError(f"flex {mod} B={b} N={n}: err={err} lse_err={lse_err} "
                             f"gsum_rel_err={gsum_err} skips equal={skip_equal}")

    fn, args, _ = flex_core.kernel_args(spec, q, k, v, aux)
    lib = build.kernel(fn)
    ms = cuda_ms(lambda: lib(*args))
    plain_ms = cuda_ms(lambda: flex_core.flex_reference(q, k, v, spec, aux))
    _, h, _, dh = q.shape
    # operations this run's inputs need, not the most they could
    if mod == "cse":
        mask = aux[3]
        # an unmasked entry needs q·k, the c2p and p2c gathers and its P·V
        # term; a masked entry's score is the fixed fill and adds no weight to
        # P·V, unless its whole row is masked: that row is the mean of V
        live = int((~mask).sum()) * spec.group
        empty_rows = int(mask.all(dim=-1).sum()) * spec.group
        flops = live * 8 * dh + empty_rows * n * dh
        library_ms = None
    else:
        # q·k and P·V on live-weight entries; R·K̂ on every entry, since
        # graph_sum counts the weight of padded keys too
        _, w_eff = spec.full_weight(q, k, aux)
        live = int((torch.broadcast_to(w_eff, (b, h, n, n)) > 0).sum())
        flops = live * 4 * dh + b * h * n * n * 2 * spec.kk
        logw = torch.log(torch.broadcast_to(w_eff, (b, h, n, n)).contiguous())
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=logw))
    moved = nbytes(q, k, v, *aux, ex["lse"], out)
    bound, bound_by = bound_ms(moved, flops)
    rec = dict(kernel=fn, B=b, N=n, max_abs_err=err, lse_max_abs_err=lse_err, tol=FLEX_TOL,
               skipped_blocks=int(skips.sum()), skip_equal=skip_equal, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound, bound_by=bound_by,
               live_entries=live, flops=flops, bytes=moved)
    emit("kernel", **rec)
    return rec


def _paged_inputs(dtype, side: str, gen, dev):
    from csat_tpu_torch.ops.paged_decode import NULL_PAGE, quantize_kv

    s, h, page, dh = 8, 8, 16, 64
    sp, cp = 4, 10                       # self / cross table widths at the flagship
    width = 49 if side == "self" else 150
    nb = sp if side == "self" else cp
    n_pages = 1 + s * (sp + cp)
    raw_k, raw_v = (torch.randn(n_pages, h, page, dh, generator=gen) for _ in range(2))
    (pk, sk), (pv, sv) = quantize_kv(raw_k, dtype), quantize_kv(raw_v, dtype)
    ids = iter(torch.randperm(n_pages - 1, generator=gen).add(1).tolist())
    table = torch.full((s, nb), NULL_PAGE, dtype=torch.int32)
    mask = torch.ones((s, width), dtype=torch.bool)
    lens = torch.randint(1, width + 1, (s,), generator=gen).tolist()  # ragged chains
    lens[0], lens[1] = width, 1
    for i, ln in enumerate(lens):
        for j in range(-(-ln // page)):
            table[i, j] = next(ids)
        mask[i, :ln] = False
    mask[2, 0] = True
    mask[s - 1, :] = True  # a frozen row: compared nowhere
    q = torch.randn(s, h, 1, dh, generator=gen)
    merge = {}
    if side == "self":
        idx = torch.tensor([ln - 1 for ln in lens], dtype=torch.int32)
        merge = dict(idx=idx.to(dev), k_tok=torch.randn(s, h, 1, dh, generator=gen).to(dev),
                     v_tok=torch.randn(s, h, 1, dh, generator=gen).to(dev))
    inputs = [t.to(dev) for t in (q, pk, pv, sk, sv, table, mask)] + [width]
    return inputs, merge, lens


def paged_check(dtype, side: str, gen, dev) -> dict:
    from csat_tpu_torch.ops import build, paged_decode as pd

    inputs, merge, lens = _paged_inputs(dtype, side, gen, dev)
    q, pk, pv, sk, sv, table, mask, width = inputs
    out, skipped = pd.paged_attend(*inputs, **merge)
    ref, ref_skip = pd._attend_reference(*inputs, merge.get("idx"), merge.get("k_tok"),
                                         merge.get("v_tok"))
    torch.cuda.synchronize()
    live = ~mask.all(dim=1)
    err = (out[live] - ref[live]).abs().max().item()
    skip_equal = bool(torch.equal(skipped, pd.reference_page_skip(table, q.shape[1])))
    if not (err <= PAGED_TOL and skip_equal and torch.isfinite(out[live]).all()):
        raise AssertionError(f"paged {side} {dtype}: err={err} skips equal={skip_equal}")

    args, _ = pd.kernel_args(*inputs, merge.get("idx"), merge.get("k_tok"), merge.get("v_tok"))
    lib = build.kernel("paged_decode")
    ms = cuda_ms(lambda: lib(*args))
    plain_ms = cuda_ms(lambda: pd._attend_reference(
        *inputs, merge.get("idx"), merge.get("k_tok"), merge.get("v_tok")))
    s, h, _, dh = q.shape
    # what this run's inputs need: an unmasked lane's K and V rows (from the
    # pages, or k_tok/v_tok at the merged lane) and its score and P·V; a
    # masked lane adds no weight unless its whole row is masked, and then
    # the row is the mean of its `width` V rows
    unmasked = (~mask).sum(dim=1).cpu()
    frozen = mask.all(dim=1).cpu()
    lanes = int(unmasked.sum())
    merged = 0
    if side == "self":
        merged = int((~mask.gather(1, merge["idx"].long()[:, None])).sum())
    k_rows = lanes - merged
    v_rows = k_rows + int(frozen.sum()) * width
    row_bytes = dh * pk.element_size() + 4  # stored values + one f32 scale
    moved = (h * (k_rows + v_rows) * row_bytes
             + nbytes(q, table, mask, out, *merge.values()))
    flops = h * (lanes * 4 * dh + int(frozen.sum()) * width * dh)
    bound, bound_by = bound_ms(moved, flops)
    rec = dict(kernel="paged_decode", side=side, dtype=str(dtype).replace("torch.", ""),
               width=width, chain_lens=lens, max_abs_err=err, tol=PAGED_TOL,
               skipped=int(skipped[:, 0].sum()), skip_equal=skip_equal, ms=ms,
               plain_ms=plain_ms, library_ms=None, bound_ms=bound, bound_by=bound_by,
               lanes=lanes, flops=flops, bytes=moved)
    emit("kernel", **rec)
    return rec


#: (N, batch sizes) the serving path gives the flex kernels: prefill_plan
#: admits up to 8 requests at N 37 / 75 and 4 at N 150 with 8 slots, and an
#: admission chunk holds anything from one request to that many
FLEX_SHAPES = ((37, (1, 4, 8)), (75, (1, 4, 8)), (150, (1, 4)))


def kernel_phase(dev) -> dict:
    gen = torch.Generator().manual_seed(SEED)
    mods = ("cse", "sbm_expected")
    # B 4 and the paged cases draw their inputs first, so that they stay the
    # same whichever other batch sizes are checked after them
    flex = {(mod, 4, n): flex_check(mod, 4, n, gen, dev) for mod in mods for n, _ in FLEX_SHAPES}
    paged = {(dt, side): paged_check(dt, side, gen, dev)
             for dt in (torch.float32, torch.bfloat16, torch.int8) for side in ("self", "cross")}
    flex.update({(mod, b, n): flex_check(mod, b, n, gen, dev)
                 for mod in mods for n, bs in FLEX_SHAPES for b in bs if b != 4})
    return {"flex_fwd_cse": flex[("cse", 4, 150)],
            "flex_fwd_sbm_expected": flex[("sbm_expected", 4, 150)],
            "paged_decode": paged[(torch.float32, "cross")]}


# ---------------------------------------------------------------------------
# phase 4: serve the flagship model
# ---------------------------------------------------------------------------

def flagship():
    from csat_tpu_torch.configs import get_config

    return get_config("python", eval_graph="expected", serve_slots=8)


def make_requests(cfg):
    from csat_tpu_torch.data.synthetic import random_ast, request_sample

    rng = np.random.default_rng(SEED)
    sizes = np.linspace(20, cfg.max_src_len, N_REQUESTS).round().astype(int)
    rng.shuffle(sizes)
    samples = [request_sample(random_ast(rng, int(n)), cfg, SRC_VOCAB) for n in sizes]
    budgets = [BUDGETS[i % len(BUDGETS)] for i in range(N_REQUESTS)]
    return samples, budgets


class MarginLog:
    """Wraps ``model.decode_step`` to record, per call, each slot's position
    and the gap between its two largest log-probs."""

    def __init__(self, model):
        self.calls = []
        inner = model.decode_step

        def decode_step(tok, pos, caches, src_mask, prev_pad):
            log_probs, steps = inner(tok, pos, caches, src_mask, prev_pad)
            top2 = torch.topk(log_probs, 2, dim=-1).values
            self.calls.append((pos.tolist(), (top2[:, 0] - top2[:, 1]).tolist()))
            return log_probs, steps

        model.decode_step = decode_step

    def margins(self, admit_call: int, slot: int, n_tokens: int):
        out = []
        for j in range(n_tokens):
            pos, gap = self.calls[admit_call + j]
            assert pos[slot] == j, (admit_call, slot, j, pos[slot])
            out.append(gap[slot])
        return out


def serve(cfg, device: str, samples, budgets, profile: bool = False):
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.ops import build
    from csat_tpu_torch.serve import ServeEngine

    model = CSATrans(cfg, SRC_VOCAB, TGT_VOCAB, device=device, seed=SEED)
    log = MarginLog(model) if device == "cpu" else None
    clock = (lambda: len(log.calls)) if log else time.monotonic
    engine = ServeEngine(model, cfg, device=device, clock=clock)
    ids = [engine.submit(s, b) for s, b in zip(samples, budgets)]
    build.reset_launches()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.drain()
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = build.launch_counts()
    results = [engine.poll(i) for i in ids]
    trace = None
    if profile:
        trace = profile_serve(cfg, model, samples, budgets)
    return dict(engine=engine, results=results, seconds=seconds, counts=counts, log=log,
                trace=trace)


def profile_serve(cfg, model, samples, budgets) -> dict:
    """A second run of the same requests under torch.profiler: device time by
    kernel and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from csat_tpu_torch.serve import ServeEngine

    engine = ServeEngine(model, cfg, device="cuda")
    for s, b in zip(samples, budgets):
        engine.submit(s, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    def device_ms(e):  # the attribute's name changed across torch versions
        return (getattr(e, "self_device_time_total", 0.0)
                or getattr(e, "self_cuda_time_total", 0.0)) / 1e3

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel = sorted(((e.key, device_ms(e), e.count) for e in kernels),
                       key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms, _ in by_kernel)
    OUT_DIR.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(OUT_DIR / "serve_trace.json"))
    return dict(wall_s=wall, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / 1e3 / wall if wall else None,
                top=[[k[:80], ms, n] for k, ms, n in by_kernel[:15]])


def serve_phase(profile: bool) -> dict:
    from csat_tpu_torch.ops import build

    cfg = flagship()
    samples, budgets = make_requests(cfg)
    gpu = serve(cfg, "cuda", samples, budgets, profile=profile)
    bad = [r.id for r in gpu["results"] if not r.ok]
    if bad:
        raise AssertionError(f"requests not OK on the card: {bad}")
    leaks = gpu["engine"].page_leaks()
    if leaks:
        raise AssertionError(f"{leaks} pages leaked")
    idle = [fn for fn in build.KERNELS if gpu["counts"][fn] <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on the serving path: {idle}")
    n_tokens = sum(len(r.tokens) for r in gpu["results"])

    cpu = serve(cfg, "cpu", samples, budgets)
    mismatched, ties, compared = [], 0, 0
    for g, c in zip(gpu["results"], cpu["results"]):
        if not c.ok:
            raise AssertionError(f"request {c.id} not OK on the CPU")
        gaps = cpu["log"].margins(c.admit_t, c.slot, len(c.tokens))
        upto = next((j for j, gap in enumerate(gaps) if gap < TIE_MARGIN), None)
        if upto is not None:
            ties += 1
            same = np.array_equal(g.tokens[:upto], c.tokens[:upto])
            compared += upto
        else:
            same = np.array_equal(g.tokens, c.tokens)
            compared += len(c.tokens)
        if not same:
            mismatched.append(c.id)
    if mismatched:
        raise AssertionError(f"card and CPU tokens differ for requests {mismatched}")
    eng = gpu["engine"]
    rec = dict(model="python", eval_graph=cfg.eval_graph, widths=dict(
        pegen=cfg.pegen_dim, enc=cfg.sbm_enc_dim, hidden=cfg.hidden_size, heads=cfg.num_heads,
        cse_layers=cfg.num_layers, sbm_layers=cfg.sbm_layers, dec_layers=cfg.decoder_layers,
        clusters=list(cfg.clusters), max_src_len=cfg.max_src_len, max_tgt_len=cfg.max_tgt_len),
        vocab=[SRC_VOCAB, TGT_VOCAB], requests=len(samples),
        num_nodes=[int(s["num_node"]) for s in samples], budgets=budgets,
        # one drain of a closed batch of 16: a smoke reading, not a
        # throughput measurement (no arrivals, one short window)
        all_ok=True, page_leaks=leaks, tokens=n_tokens, seconds=gpu["seconds"],
        smoke_tokens_per_s=n_tokens / gpu["seconds"], ticks=eng.n_ticks,
        decode_steps=eng.n_decode_steps, prefills=eng.n_prefills,
        launches=gpu["counts"], launches_per_request={
            fn: c / len(samples) for fn, c in gpu["counts"].items()},
        cpu_seconds=cpu["seconds"], cpu_tokens_equal=True, near_ties=ties, tokens_compared=compared,
        tie_margin=TIE_MARGIN, profile=gpu["trace"])
    emit("serve", **rec)
    return rec


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace a second serving run with torch.profiler")
    args = ap.parse_args(argv)
    smi = device_phase()
    build_phase()
    from csat_tpu_torch.ops import build

    dev = torch.device("cuda")
    measured = kernel_phase(dev)
    served = serve_phase(args.profile)
    kernels = []
    for fn, lib in build.KERNELS.items():
        m = measured[fn]
        kernels.append(dict(
            name=fn, route="cuda", source=str(build.SOURCES[lib].relative_to(REPO)),
            replaces=build.REPLACES[fn],
            launches=served["launches"][fn], max_abs_err=m["max_abs_err"], ms=m["ms"],
            plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
            library_ms=m["library_ms"],
            shape={k: m[k] for k in ("B", "N", "side", "dtype", "width") if k in m},
            status="ported"))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
