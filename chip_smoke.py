"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # also trace a serving run, train steps and a fit epoch

Phases, each printing JSON lines:

1. ``device``  — the card, as ``nvidia-smi`` names it, with TF32 off;
2. ``build``   — compiles every CUDA kernel of the serving and training paths
   from the checkout's sources (``csat_tpu_torch/ops/csrc``) with ``nvcc`` for
   sm_90a, one process per source, all at once, and counts the tensor-core
   instructions in the SASS of K2 (``sass``: none fails the run);
3. ``kernel``  — each kernel against its plain PyTorch version on the card, at
   the shapes the driven paths give it — the serving batches, B 64 / N 150,
   and every bucket of the fit's plan (259×37, 128×75, 64×150), which each
   later phase checks against what it ran: max abs error (with its
   tolerance), exact skip counts, and times (CUDA events, median of several
   runs; at the plan's smaller buckets only K1 and K2 are timed, beside SDPA
   with the same score bias or weight as an additive float mask; K1 also on
   the distances and masks of the train phase's batch); every backward
   check also holds its forward's ``out`` and ``lse``; the expected-graph
   backward also on whole padded key tiles and on inputs with exact ties at
   both clip bounds, at the default floor and at floor 0, and without
   dropout against a float64 closed form that shares no code with the plain
   version;
4. ``serve``   — the flagship ``python`` model at full width (random weights
   from a seed, ``eval_graph="expected"``) serves 16 synthetic requests
   through ``ServeEngine``; every request must be OK, no page may leak, every
   serving kernel must have launched, and the tokens must equal the same
   weights served on the CPU through the plain paths (up to a near-tie, see
   below);
5. ``train``   — the same model trains at full width on a batch of 64
   synthetic ASTs (``noise_mode="counter"``): one step through the kernels
   and one through the plain paths on the card from the same weights, seeds
   and batch must agree (loss within 1e-5 relative, global grad-norm within
   1e-4 relative; every parameter's max abs gradient error is written out),
   then 8 kernel steps on that batch must stay finite and end below the first
   step's loss; two backward passes from the same weights, batch and noise
   must give bit-equal gradients; one ``noise_mode="shared"`` step runs the
   graph kernel;
   every training kernel must have launched in the step that uses it;
6. ``expected_grad`` — the gradient of the same model's deterministic forward
   under ``eval_graph="expected"`` (``nll + sw · sparsity``, batch 64):
   through the kernels and through the plain paths on the card, loss within
   1e-5 and global grad-norm within 1e-4 relative, every parameter's error
   written out;
7. ``fit``     — ``Trainer.fit`` at the published widths on a synthetic corpus
   made in a temporary directory (512 / 64 / 64 samples of 10 to 150 nodes; the
   vocabularies are the corpus's own, a few dozen words): 2 epochs with
   ``noise_mode="counter"``, ``eval_graph="expected"``, length buckets, batch
   64, validation (greedy decode + BLEU) and a checkpoint each epoch; every
   step finite, the second epoch's mean loss below the first's, at least two
   bucket shapes stepped, the train and eval kernels launched; a second
   ``Trainer`` restored from the epoch-1 checkpoint must reproduce every
   loss of epoch 2 bit for bit; then ``run_test`` scores BLEU / ROUGE-L /
   METEOR;
8. ``kernels`` — one line listing every kernel with its route, source, the
   TPU kernel it replaces, its launches in phases 4-7, its error, times and
   bound.

The line before the last is the card's ``name, power.limit``; the last line
is ``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is
then non-zero and that line is not printed.  The script needs a CUDA device
and the ``csat_tpu_torch`` package beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out"  # run reports (ptxas log, profiler trace); in .gitignore

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 FLOP/s
# outside the tensor cores (the SIMT kernels' rate) and TF32 FLOP/s on them.
# K2 runs its dot products as 3xTF32, three TF32 products per f32 one, so
# its bound takes those at a third of the TF32 rate.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
PEAK_3XTF32_FLOP_S = 495e12 / 3

SEED = 2021
SRC_VOCAB, TGT_VOCAB = 10000, 20000  # the reference's vocabulary caps
N_REQUESTS = 16
BUDGETS = (0, 12, 30, 0, 20, 8, 0, 40)  # 0 = the full max_tgt_len - 1
TIE_MARGIN = 1e-4
FLEX_TOL = 2e-5   # f32 kernel vs plain: summation order only
PAGED_TOL = 1e-5
GRAD_TOL = 1e-4   # backward kernels vs plain autograd, atol and rtol: order of N-key sums
NEAR = 1e-6       # a Bernoulli draw within this of its threshold may flip
TRAIN_B = 64      # the configs' batch_size
RATE = 0.2        # the configs' attention dropout
TRAIN_STEPS = 8
LOSS_RTOL, GNORM_RTOL = 1e-5, 1e-4
GS_COEF = 1e-3    # weight of Σ graph_sum in the backward checks' loss
GRAD_NAMES = ("dq", "dk", "dv", "dr", "dkh")

#: (kernel, B, N) held against its plain version in phase 3; each driven
#: path must find the shapes it gave its kernels in here
CHECKED: set = set()

#: the kernels each driven path must launch
PATH_KERNELS = {
    "serve": ("flex_fwd_cse", "flex_fwd_sbm_expected", "paged_decode"),
    "train_counter": ("flex_fwd_cse", "flex_fwd_sbm_sampled", "flex_bwd_q_sbm_sampled",
                      "flex_bwd_k_sbm_sampled"),
    "train_shared": ("flex_fwd_cse", "flex_fwd_sbm_graph"),
    "expected_grad": ("flex_fwd_cse", "flex_fwd_sbm_expected", "flex_bwd_q_sbm_expected",
                      "flex_bwd_k_sbm_expected"),
    # Trainer.fit: train steps (K1, K6, K3, K4) and the eval decode's encoder (K1, K2)
    "fit": ("flex_fwd_cse", "flex_fwd_sbm_sampled", "flex_bwd_q_sbm_sampled",
            "flex_bwd_k_sbm_sampled", "flex_fwd_sbm_expected"),
}
FIT_SAMPLES = (512, 64, 64)   # train / dev / test
FIT_NODES = (10, 150)         # node counts, uniform: the corpus spreads over the buckets
FIT_EPOCHS = 2


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


def bound_ms(n_bytes: float, flops: float, tc_flops: float = 0.0):
    """The larger of the bytes' time and the operations' time: ``flops`` at
    the f32 SIMT rate plus ``tc_flops`` at the 3xTF32 tensor-core rate."""
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = flops / PEAK_F32_FLOP_S + tc_flops / PEAK_3XTF32_FLOP_S
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
    counts = tensor_core_instructions(build.library_path("flex_fwd_tc"))
    emit("sass", library="flex_fwd_tc", tensor_core_instructions=counts)
    if len(counts) < 2 or not all(counts.values()):  # K2 at dh 64 and 96
        raise AssertionError(f"K2 was built without tensor-core instructions: {counts}")


def tensor_core_instructions(lib: Path) -> dict:
    """Tensor-core instructions (``HMMA``/``HGMMA``) per kernel function in
    the SASS of a built library, as ``cuobjdump -sass`` lists it."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    return counts


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _flex_inputs(mod: str, b: int, n: int, gen: torch.Generator, dev, floor: float = 0.01,
                 rel_mask=None):
    from csat_tpu_torch.ops.mods import (
        cse_mod, sbm_expected_mod, sbm_graph_mod, sbm_sampled_mod)

    h, dh, r_len, kk = 8, 64, 150, 10
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(dev)
    q, k, v = rnd(b, h, n, dh), rnd(b, h, n, dh), rnd(b, h, n, dh)
    # padded keys in every row but the first; the short rows leave whole
    # 64-key tiles padded, which the SBM kernels skip
    n_real = [n, n - 3, n // 2, n // 5, n - 1, n // 3, 2 * n // 3, max(1, n // 10)]
    n_real = (n_real * -(-b // len(n_real)))[:b]
    if mod == "cse" and rel_mask is not None:  # a real batch's distances and masks
        rel, mask = rel_mask
        spec, aux = cse_mod(rnd(h, r_len, dh), rnd(h, r_len, dh), rel, mask)
    elif mod == "cse":
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
        if mod == "sbm_expected":
            spec, aux = sbm_expected_mod(torch.sigmoid(rnd(b, h, n, kk)),
                                         torch.sigmoid(rnd(b, h, n, kk)), s_aff.to(dev),
                                         pad.to(dev), floor=floor)
        elif mod == "sbm_sampled":
            seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, dtype=torch.int32)
            spec, aux = sbm_sampled_mod(torch.sigmoid(2 * rnd(b, h, n, kk)),
                                        torch.sigmoid(2 * rnd(b, h, n, kk)), s_aff.to(dev),
                                        pad.to(dev), seed.to(dev))
        else:
            graph = (torch.rand((b, h, n, n), generator=gen) < 0.4).float()
            spec, aux = sbm_graph_mod(graph.to(dev), pad.to(dev))
    return q, k, v, spec, aux


def cse_bias(q, k, spec, aux):
    """The CSE mod's additive score bias (B, H, N, N): ``(c2p + p2c) ·
    scale`` on unmasked entries, -1e9 on masked ones."""
    from csat_tpu_torch.ops.mods import rel_gather

    lq, lk, rel, mask = aux
    mask8 = mask.repeat_interleave(spec.group, dim=1)
    c2p, p2c_t = rel_gather(torch.einsum("bhnd,hrd->bhnr", q, lk),
                            torch.einsum("bhmd,hrd->bhmr", k, lq), rel)
    bias = (c2p + p2c_t.transpose(-1, -2)) * spec.scale(q.shape[-1])
    return torch.where(mask8, torch.full_like(bias, -1e9), bias).contiguous()


def _near_draws(q, spec, aux):
    """(B, H, N, N) Bernoulli draws of the sampled mod within NEAR of their
    threshold — the only ones allowed to flip between kernel and plain path
    (their R·K̂ᵀ sums may round apart); all False for the other mods."""
    from csat_tpu_torch.ops.hashrng import uniform_field
    from csat_tpu_torch.ops.mods import SBMSampledSpec, exp_adjacency

    if not isinstance(spec, SBMSampledSpec):
        b, h, n, _ = q.shape
        return torch.zeros((b, h, n, n), dtype=torch.bool, device=q.device)
    r, kh, _, sseed = aux
    b, h, n, _ = r.shape
    p = torch.clamp(exp_adjacency(r, kh), spec.floor, 0.99)
    return (uniform_field(sseed, b, h, n, n, spec.stride) - p).abs() <= NEAR


def flex_check(mod: str, b: int, n: int, gen, dev, timed: bool = True, rel_mask=None) -> dict:
    """One forward kernel against its plain version at (B, N); ``timed``
    adds the times and the bound (left out for shapes checked for
    correctness only); ``rel_mask`` gives K1 a real batch's distances and
    masks in place of random ones."""
    from csat_tpu_torch.ops import build, flex_core

    q, k, v, spec, aux = _flex_inputs(mod, b, n, gen, dev, rel_mask=rel_mask)
    train = mod in ("sbm_sampled", "sbm_graph")
    rate = RATE if train else 0.0
    dseed = torch.tensor([SEED + 7], dtype=torch.int32, device=dev) if train else None
    with torch.no_grad():
        out, ex = flex_core.flex_attention(q, k, v, spec, aux, rate, dseed)
        ref, rex = flex_core.flex_reference(q, k, v, spec, aux, rate, dseed)
        near = _near_draws(q, spec, aux)
    torch.cuda.synchronize()
    # a flipped draw moves graph_sum of its (b, h) by one and changes its row:
    # flips are counted from graph_sum, gated to near-threshold draws, and
    # rows holding a near draw are left out of the comparison
    sampled = mod == "sbm_sampled"
    flips = int((ex["graph_sum"] - rex["graph_sum"]).abs().sum()) if sampled else 0
    near_ok = not sampled or bool(torch.all((ex["graph_sum"] - rex["graph_sum"]).abs()
                                            <= near.sum(dim=(2, 3))))
    rows = ~near.any(dim=-1)
    err = (out - ref)[rows].abs().max().item()
    lse_err = (ex["lse"] - rex["lse"])[rows].abs().max().item()
    gsum_err = ((ex["graph_sum"] - rex["graph_sum"]).abs()
                / rex["graph_sum"].abs().clamp_min(1.0)).max().item()
    skips = flex_core.reference_block_skip(spec, aux, flex_core.geometry(q))
    skip_equal = bool(torch.equal(ex["skipped_blocks"], skips))
    gsum_tol = float("inf") if sampled else 1e-5  # sampled: the flip gate instead
    if not (err <= FLEX_TOL and lse_err <= FLEX_TOL and gsum_err <= gsum_tol and near_ok
            and skip_equal and torch.isfinite(out).all()):
        raise AssertionError(f"flex {mod} B={b} N={n}: err={err} lse_err={lse_err} "
                             f"gsum_rel_err={gsum_err} flips={flips} near_ok={near_ok} "
                             f"skips equal={skip_equal}")
    CHECKED.add((f"flex_fwd_{mod}", b, n))
    if not timed:
        rec = dict(kernel=f"flex_fwd_{mod}", B=b, N=n, rate=rate, timed=False, max_abs_err=err,
                   lse_max_abs_err=lse_err, tol=FLEX_TOL, flips=flips,
                   near_draws=int(near.sum()), skipped_blocks=int(skips.sum()),
                   skip_equal=skip_equal)
        emit("kernel", **rec)
        return rec

    fn, args, _ = flex_core.kernel_args(spec, q, k, v, aux, rate, dseed)
    lib = build.kernel(fn)
    ms = cuda_ms(lambda: lib(*args))
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: flex_core.flex_reference(q, k, v, spec, aux, rate, dseed))
    _, h, _, dh = q.shape
    library_ms = None
    # operations this run's inputs need, not the most they could
    if mod == "cse":
        mask = aux[3]
        # an unmasked entry needs q·k, the c2p and p2c gathers and its P·V
        # term; a masked entry's score is the fixed fill and adds no weight to
        # P·V, unless its whole row is masked: that row is the mean of V
        live = int((~mask).sum()) * spec.group
        empty_rows = int(mask.all(dim=-1).sum()) * spec.group
        simt_flops, tc_flops = live * 8 * dh + empty_rows * n * dh, 0
        # SDPA with the relative bias as an additive float mask, formed
        # outside the timing: (c2p + p2c)·scale, and -1e9 where masked (added
        # to the score where the kernel replaces it: a yardstick of time)
        with torch.no_grad():
            bias = cse_bias(q, k, spec, aux)
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, scale=spec.scale(dh)))
    else:
        # q·k and P·V on live-weight entries; for the factor mods R·K̂ on
        # every entry, since graph_sum counts the weight of padded keys too
        # (the sampled mod's integer hashes are not counted)
        with torch.no_grad():
            _, w_eff = spec.full_weight(q, k, aux)
        w_eff = torch.broadcast_to(w_eff, (b, h, n, n))
        live = int((w_eff > 0).sum())
        # K2 runs q·k and P·V on the tensor cores, R·K̂ and K6/K7 on f32 SIMT
        tc_flops = live * 4 * dh if mod == "sbm_expected" else 0
        simt_flops = 0 if tc_flops else live * 4 * dh
        if mod != "sbm_graph":
            simt_flops += b * h * n * n * 2 * spec.kk
        if mod != "sbm_sampled":
            # SDPA with an additive log w mask: the same attention (for the
            # graph mod without its dropout: SDPA draws its own dropout bits)
            logw = torch.log(w_eff.contiguous())
            library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=logw))
    moved = nbytes(q, k, v, *aux, ex["lse"], out)
    bound, bound_by = bound_ms(moved, simt_flops, tc_flops)
    rec = dict(kernel=fn, B=b, N=n, rate=rate, max_abs_err=err, lse_max_abs_err=lse_err,
               tol=FLEX_TOL, flips=flips, near_draws=int(near.sum()),
               skipped_blocks=int(skips.sum()), skip_equal=skip_equal, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound, bound_by=bound_by,
               live_entries=live, flops=simt_flops + tc_flops, tensor_core_flops=tc_flops,
               bytes=moved, inputs="random" if rel_mask is None else "train batch")
    emit("kernel", **rec)
    return rec


def _plant_ties(spec, aux):
    """Exact ties of R·K̂ᵀ at both clip bounds, and at 0, in every (b, h):
    column 5 of K̂ is the unit vector e₀, so entry (i, 5) equals R[i, 0]."""
    r, kh = aux[0].clone(), aux[1].clone()
    kh[:, :, 3] = 0.0          # column 3: R·K̂ᵀ == 0 on every row
    kh[:, :, 5] = 0.0
    kh[:, :, 5, 0] = 1.0
    r[:, :, 7] = 0.0
    r[:, :, 7, 0] = 0.99       # (7, 5) == .99
    r[:, :, 8] = 0.0
    r[:, :, 8, 0] = spec.floor  # (8, 5) == floor
    return (r, kh, *aux[2:])


def expected_closed_form(q, k, v, aux, floor: float, go, gs_coef: float) -> dict:
    """The expected mod without dropout, written out from its definition in
    float64 over whole (N, N) fields: ``w = clip(R·K̂ᵀ, floor, .99)·(1 − pad)``,
    ``attn = w eˢ / Σ w eˢ``, ``out = attn·V``, and the gradients of
    ``Σ out·go + gs_coef · Σ clip(R·K̂ᵀ)`` by hand.  It shares no code with
    ``flex_reference`` or the kernels.  Two conventions are the mod's own: the
    clip passes half the gradient where R·K̂ᵀ equals a bound (``jnp.clip``),
    and a row with no live weight is identically 0 and passes nothing back.
    ``∂attn/∂w = e^{s − lse}(δ − attn)`` holds at ``w = 0`` as anywhere else,
    which is what a tie at ``floor == 0`` needs.  R·K̂ᵀ is summed in float32
    in the kernels' order, so its ties are the same entries."""
    r, kh, padf = aux[:3]
    ea = r[..., :, None, 0] * kh[..., None, :, 0]
    for j in range(1, r.shape[-1]):
        ea = ea + r[..., :, None, j] * kh[..., None, :, j]
    lo, hi = (torch.tensor(x, dtype=torch.float32, device=q.device) for x in (floor, 0.99))
    c = (((ea > lo) & (ea < hi)).double() + 0.5 * ((ea == lo) | (ea == hi)).double())
    w_raw = torch.minimum(torch.maximum(ea, lo), hi).double()
    keep = (1.0 - padf.double())[:, None, None, :]
    w = w_raw * keep
    q64, k64, v64, go64 = (t.double() for t in (q, k, v, go))
    scale = 1.0 / q.shape[-1] ** 0.5
    s = q64 @ k64.transpose(-1, -2) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = w * torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    live = (l > 0).double()
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    attn = p / l_safe
    lse = m + torch.log(l_safe)
    d_attn = go64 @ v64.transpose(-1, -2)
    t = d_attn - (attn * d_attn).sum(dim=-1, keepdim=True)
    d_s = attn * t
    d_ea = (torch.exp(s - lse) * t * live * keep + gs_coef) * c
    return dict(out=attn @ v64, lse=lse[..., 0], live_rows=l[..., 0] > 0,
                dq=d_s @ k64 * scale, dk=d_s.transpose(-1, -2) @ q64 * scale,
                dv=attn.transpose(-1, -2) @ go64, dr=d_ea @ kh.double(),
                dkh=d_ea.transpose(-1, -2) @ r.double())


def bwd_check(mod: str, b: int, n: int, gen, dev, rate: float = RATE,
              variant: str = "plain", floor: float = 0.01, timed: bool = True) -> dict:
    """The two backward passes of the sampled mod (K3/K4) or the expected mod
    (K8/K9) against the plain autograd of ``flex_reference`` on the same
    inputs; the forward's ``out`` and ``lse`` of the same call are held
    against the plain ones too.  ``variant="ties"`` plants exact ties at both
    clip bounds of the expected mod; ``"padded"`` names the run whose short
    rows leave whole key tiles padded (every run of ``_flex_inputs`` has them:
    it is checked).  Without dropout the expected mod's kernel and plain
    results are also held against :func:`expected_closed_form`."""
    from csat_tpu_torch.ops import build, flex_core
    from csat_tpu_torch.ops.mods import exp_adjacency

    q, k, v, spec, aux = _flex_inputs(mod, b, n, gen, dev, floor)
    sampled = mod == "sbm_sampled"
    if variant == "ties":
        aux = _plant_ties(spec, aux)
        ea = exp_adjacency(aux[0], aux[1])
        floor_t = torch.tensor(spec.floor, device=dev)
        if not ((ea == 0.99).any() and (ea == floor_t).any() and (ea == 0).any()):
            raise AssertionError("the tie input holds no exact tie")
    dseed = torch.tensor([SEED + 11], dtype=torch.int32, device=dev)
    go = torch.randn(q.shape, generator=gen).to(dev)

    def run(fn):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, aux[0], aux[1])]
        out, ex = fn(*leaves[:3], spec, (*leaves[3:], *aux[2:]), rate, dseed)
        loss = torch.sum(out * go) + GS_COEF * torch.sum(ex["graph_sum"])
        return leaves, out, ex, loss

    k_leaves, k_out, k_ex, k_loss = run(flex_core.flex_attention)
    got = torch.autograd.grad(k_loss, k_leaves)
    p_leaves, p_out, p_ex, p_loss = run(flex_core.flex_reference)
    want = torch.autograd.grad(p_loss, p_leaves, retain_graph=True)
    torch.cuda.synchronize()
    near = _near_draws(q, spec, aux)
    dg = (k_ex["graph_sum"] - p_ex["graph_sum"]).abs()
    if sampled:
        flips = int(dg.sum())
        same = dg == 0  # a flip changes its own (b, h) only
        if not (bool(torch.all(dg <= near.sum(dim=(2, 3)))) and same.float().mean() >= 0.9):
            raise AssertionError(f"K3/K4: {flips} flipped draws, not all near the threshold")
    else:  # nothing is drawn: every (b, h) is compared
        flips, same = 0, torch.ones_like(dg, dtype=torch.bool)
        skipped = int(k_ex["skipped_blocks"].sum())
        if variant == "padded" and skipped <= 0:
            raise AssertionError("the padded-tile input skipped no tile")
    label = f"{mod} backward B={b} N={n} ({variant}, rate {rate}, floor {spec.floor})"
    # the forward of the same call: rows holding a near-threshold draw left out
    rows = same[:, :, None] & ~near.any(dim=-1)
    fwd_err = (k_out.detach() - p_out.detach())[rows].abs().max().item()
    lse_err = (k_ex["lse"] - p_ex["lse"].detach())[rows].abs().max().item()
    if not (fwd_err <= FLEX_TOL and lse_err <= FLEX_TOL and torch.isfinite(k_out).all()):
        raise AssertionError(f"{label}: forward err {fwd_err}, lse err {lse_err} over {FLEX_TOL}")
    errs = {}
    for name, a, w in zip(GRAD_NAMES, got, want):
        a, w = a[same], w[same]
        errs[name] = (a - w).abs().max().item()
        worst = ((a - w).abs() - GRAD_TOL * (1 + w.abs())).max().item()
        if not (worst <= 0 and torch.isfinite(a).all()):
            raise AssertionError(f"{label} {name}: max abs err {errs[name]} over "
                                 f"{GRAD_TOL} (1 + |plain|)")
    closed_errs = None
    if not sampled and rate == 0.0:
        closed = expected_closed_form(q, k, v, aux, spec.floor, go, GS_COEF)
        live = closed["live_rows"]
        closed_errs = {"out": ((k_out.detach() - closed["out"])[live]).abs().max().item(),
                       "lse": ((k_ex["lse"] - closed["lse"])[live]).abs().max().item()}
        if max(closed_errs.values()) > FLEX_TOL:
            raise AssertionError(f"{label}: forward against the closed form {closed_errs}")
        for side, grads in (("kernel", got), ("plain", want)):
            for name, a in zip(GRAD_NAMES, grads):
                w = closed[name]
                closed_errs[f"{side}_{name}"] = (a - w).abs().max().item()
                if ((a - w).abs() - GRAD_TOL * (1 + w.abs())).max().item() > 0:
                    raise AssertionError(f"{label} {name}: {side} against the closed form, max "
                                         f"abs err {closed_errs[f'{side}_{name}']}")
    q_fn, k_fn = f"flex_bwd_q_{mod}", f"flex_bwd_k_{mod}"
    CHECKED.update({(q_fn, b, n), (k_fn, b, n), (f"flex_fwd_{mod}", b, n)})
    if not timed:
        rec = dict(kernel=[q_fn, k_fn], B=b, N=n, rate=rate, variant=variant, floor=spec.floor,
                   timed=False, grad_errs=errs, fwd_max_abs_err=fwd_err, lse_max_abs_err=lse_err,
                   closed_form_errs=closed_errs, tol=f"{GRAD_TOL} (1 + |plain|)", flips=flips,
                   near_draws=int(near.sum()))
        emit("kernel", **rec)
        return {q_fn: rec, k_fn: rec}

    with torch.no_grad():
        out = k_out.detach()
        lse = k_ex["lse"].detach()
        dvec = torch.sum(go * out, dim=-1)
        gs = torch.full((b, q.shape[1]), GS_COEF, device=dev)
        q_fn, q_args, k_fn, k_args, _ = flex_core.bwd_kernel_args(
            spec, q, k, v, aux, lse, dvec, go, gs, rate, dseed)
    lib_q, lib_k = build.kernel(q_fn), build.kernel(k_fn)
    ms_q, ms_k = cuda_ms(lambda: lib_q(*q_args)), cuda_ms(lambda: lib_k(*k_args))
    plain_ms = cuda_ms(lambda: torch.autograd.grad(p_loss, p_leaves, retain_graph=True),
                       reps=5, trials=5)
    # operations this run's data needs: live entries (a_eff > 0) take q·k and
    # g·v and, q-pass, d_s·K (6 dh) or, k-pass, d_sᵀ·Q and attnᵀ·g (8 dh); every
    # entry its R·K̂ (2 kk); its d_exp·K̂ or d_expᵀ·R (2 kk) every sampled edge
    # of the sampled mod and every entry of the expected mod (the soft weight
    # is live wherever the key is real)
    with torch.no_grad():
        a_raw, a_eff = spec.full_weight(q, k, aux)
    live, edges = int((a_eff > 0).sum()), int((a_raw > 0).sum())
    _, h, _, dh = q.shape
    every = b * h * n * n * 2 * spec.kk
    dexp = (edges if sampled else b * h * n * n) * 2 * spec.kk
    inputs = nbytes(q, k, v, *aux, lse, dvec, go, gs)
    recs = {}
    for fn, ms, flops, outs in (
            (q_fn, ms_q, live * 6 * dh + every + dexp, (q, aux[0])),
            (k_fn, ms_k, live * 8 * dh + every + dexp, (k, v, aux[1]))):
        moved = inputs + nbytes(*outs)
        bound, bound_by = bound_ms(moved, flops)
        errs_fn = {key: errs[key] for key in (("dq", "dr") if "_q_" in fn else ("dk", "dv", "dkh"))}
        recs[fn] = dict(kernel=fn, B=b, N=n, rate=rate, variant=variant, floor=spec.floor,
                        max_abs_err=max(errs_fn.values()), fwd_max_abs_err=fwd_err,
                        lse_max_abs_err=lse_err, closed_form_errs=closed_errs,
                        grad_errs=errs_fn, tol=f"{GRAD_TOL} (1 + |plain|)", flips=flips,
                        near_draws=int(near.sum()), ms=ms, plain_ms=plain_ms,
                        plain_is="the whole plain backward (both passes)", library_ms=None,
                        bound_ms=bound, bound_by=bound_by, live_entries=live, edges=edges,
                        flops=flops, bytes=moved)
        emit("kernel", **recs[fn])
    return recs


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


def plan_shapes():
    """(rows, N) of every bucket of the flagship plan: the batches the fit's
    train steps and eval decode give the kernels (259×37, 128×75, 64×150)."""
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.bucketing import plan_buckets

    return sorted({(s.batch_size, s.n) for s in plan_buckets(get_config("python", bucketing=True))})


def kernel_phase(dev) -> dict:
    from csat_tpu_torch.configs import get_config

    gen = torch.Generator().manual_seed(SEED)
    mods = ("cse", "sbm_expected")
    # B 4 and the paged cases draw their inputs first, so that they stay the
    # same whichever other batch sizes are checked after them
    flex = {(mod, 4, n): flex_check(mod, 4, n, gen, dev) for mod in mods for n, _ in FLEX_SHAPES}
    paged = {(dt, side): paged_check(dt, side, gen, dev)
             for dt in (torch.float32, torch.bfloat16, torch.int8) for side in ("self", "cross")}
    flex.update({(mod, b, n): flex_check(mod, b, n, gen, dev)
                 for mod in mods for n, bs in FLEX_SHAPES for b in bs if b != 4})
    # the training path: B 64, N 150 (the flagship bucket at batch_size)
    train = {mod: flex_check(mod, TRAIN_B, 150, gen, dev) for mod in ("sbm_sampled", "sbm_graph")}
    cse_train = flex_check("cse", TRAIN_B, 150, gen, dev)
    bwd = bwd_check("sbm_sampled", TRAIN_B, 150, gen, dev)
    # K8/K9: the training shape with and without dropout, a serving-sized
    # batch, exact clip ties (at the default floor, and at floor 0, where a
    # tie at the lower bound is a weight of 0 with the gate half open) and
    # whole padded key tiles
    bwd_exp = bwd_check("sbm_expected", TRAIN_B, 150, gen, dev, rate=RATE)
    bwd_check("sbm_expected", TRAIN_B, 150, gen, dev, rate=0.0)
    bwd_check("sbm_expected", 4, 150, gen, dev, rate=RATE)
    bwd_check("sbm_expected", 4, 150, gen, dev, rate=0.0, variant="ties")
    bwd_check("sbm_expected", 8, 150, gen, dev, rate=RATE, variant="padded")
    # drawn after everything above, so the inputs above stay as they were:
    # K2 at the expected-gradient path's shape, the floor-0 ties, and the
    # shapes of the fit's other buckets (the flagship bucket is above) for
    # the train kernels (K1, K6, K3, K4) and the eval encoder's (K1, K2);
    # K1 and K2 are timed there too, the others checked without the timing
    # loops
    flex_check("sbm_expected", TRAIN_B, 150, gen, dev)
    bwd_check("sbm_expected", 4, 150, gen, dev, rate=0.0, variant="ties", floor=0.0, timed=False)
    for b, n in plan_shapes():
        if (b, n) == (TRAIN_B, 150):
            continue
        for mod in ("cse", "sbm_expected"):
            flex_check(mod, b, n, gen, dev)
        flex_check("sbm_sampled", b, n, gen, dev, timed=False)
        bwd_check("sbm_sampled", b, n, gen, dev, timed=False)
        bwd_check("sbm_expected", b, n, gen, dev, rate=0.0, timed=False)
    # K1 on the train phase's batch (ASTs of 20-150 nodes padded to 150):
    # real distances, most entries masked, as the train and fit paths give it
    batch = train_batch(get_config("python", noise_mode="counter"), TRAIN_B)
    rel_mask = (torch.stack([batch.L, batch.T], dim=1).to(torch.int32).contiguous(),
                torch.stack([batch.L_mask, batch.T_mask], dim=1).contiguous())
    cse_real = flex_check("cse", TRAIN_B, 150, gen, dev, rel_mask=rel_mask)
    return {"flex_fwd_cse": flex[("cse", 4, 150)],
            "flex_fwd_cse@train": cse_train,
            "flex_fwd_cse@train_batch": cse_real,
            "flex_fwd_sbm_expected": flex[("sbm_expected", 4, 150)],
            "flex_fwd_sbm_sampled": train["sbm_sampled"],
            "flex_fwd_sbm_graph": train["sbm_graph"],
            **bwd, **bwd_exp,
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
    return _device_summary(prof, wall, "serve_trace.json")


def _device_summary(prof, wall: float, trace_name=None) -> dict:
    """Device time by kernel and the device's busy share of ``wall`` from a
    finished profiler; the Chrome trace goes to ``chiprun_out/trace_name``
    when one is named (the serve trace; a train trace would be too large to
    bring back)."""
    def device_ms(e):  # the attribute's name changed across torch versions
        return (getattr(e, "self_device_time_total", 0.0)
                or getattr(e, "self_cuda_time_total", 0.0)) / 1e3

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel = sorted(((e.key, device_ms(e), e.count) for e in kernels),
                       key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms, _ in by_kernel)
    if trace_name:
        OUT_DIR.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(OUT_DIR / trace_name))
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
    _check_launched("serve", gpu["counts"])
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
# phase 5: train the flagship model
# ---------------------------------------------------------------------------

def train_batch(cfg, b: int):
    """``b`` synthetic ASTs spread over 20..max_src_len nodes with random
    summaries, collated at the flagship width onto the card."""
    from csat_tpu_torch.data.dataset import batch_to_device, collate
    from csat_tpu_torch.data.synthetic import random_ast, train_sample

    rng = np.random.default_rng(SEED + 1)
    sizes = np.linspace(20, cfg.max_src_len, b).round().astype(int)
    rng.shuffle(sizes)
    samples = [train_sample(random_ast(rng, int(n)), cfg, SRC_VOCAB, TGT_VOCAB, rng)
               for n in sizes]
    arrs = {key: np.stack([s[key] for s in samples]) for key in samples[0]}
    return batch_to_device(collate(arrs, cfg.max_src_len), torch.device("cuda"))


def timed_step(step, state, batch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    return state, metrics, time.perf_counter() - t0


def trainer(cfg, model=None):
    """(model, train state, train step) at ``cfg``: a fresh full-width model
    from ``SEED`` unless ``model`` is given."""
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.train import create_train_state, default_optimizer, make_train_step

    model = model or CSATrans(cfg, SRC_VOCAB, TGT_VOCAB, device="cuda", seed=SEED)
    opt = default_optimizer(cfg)
    return model, create_train_state(model, opt, SEED), make_train_step(model, opt, cfg)


def _check_launched(path: str, counts) -> None:
    idle = [fn for fn in PATH_KERNELS[path] if counts[fn] <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on the {path} path: {idle}")


def _check_shapes(path: str, shapes) -> None:
    """Every (B, N) the path gave its flex kernels must be one at which
    phase 3 held them against their plain versions."""
    missing = sorted((fn, b, n) for fn in PATH_KERNELS[path] if fn.startswith("flex_")
                     for b, n in shapes if (fn, b, n) not in CHECKED)
    if missing:
        raise AssertionError(f"the {path} path ran kernels at shapes phase 3 did not check: "
                             f"{missing}")


def profile_steps(step, state, batch, n: int = 2) -> dict:
    """``n`` train steps under torch.profiler: device busy share of the wall
    time and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _device_summary(prof, wall)


def repeatable_backward(model, cfg, batch) -> dict:
    """Two backward passes of the model on the same weights, batch and noise
    must give bit-equal gradients: the CSE gathers (``ops/mods.py:rel_gather``)
    and the embedding lookups (``models/components.py:Embeddings``) add their
    cotangents in a fixed order."""
    from csat_tpu_torch.train import label_smoothing_loss

    def grads():
        for p in model.parameters():
            p.grad = None
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        log_probs, sparsity = model(batch, deterministic=False, gen=gen)
        total = label_smoothing_loss(log_probs, batch.target, cfg.smoothing) + cfg.sw * sparsity
        total.backward()
        return {name: p.grad.clone() for name, p in model.named_parameters()}

    first, second = grads(), grads()
    apart = sorted(k for k in first if not torch.equal(first[k], second[k]))
    if apart:
        raise AssertionError(f"two backward passes differ in {apart}")
    return {"params": len(first), "params_apart": apart}


def train_phase(profile: bool) -> dict:
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.ops import build, flex_core

    cfg = get_config("python", noise_mode="counter")
    batch = train_batch(cfg, cfg.batch_size)
    model, state, step = trainer(cfg)
    plain_model, plain_state, plain_step = trainer(cfg, copy.deepcopy(model))

    # one step through the kernels, one through the plain paths on the card,
    # from the same weights, seeds and batch
    build.reset_launches()
    state, m_k, first_s = timed_step(step, state, batch)
    counts = build.launch_counts()
    flex_core_select = flex_core.select_impl
    flex_core.select_impl = lambda x: "reference"
    try:
        build.reset_launches()
        plain_state, m_p, plain_s = timed_step(plain_step, plain_state, batch)
    finally:
        flex_core.select_impl = flex_core_select
    if any(build.launch_counts().values()):
        raise AssertionError(f"the plain step launched kernels: {build.launch_counts()}")
    loss_rel = abs(float(m_k["loss"]) - float(m_p["loss"])) / abs(float(m_p["loss"]))
    gnorm_rel = abs(float(m_k["grad_norm"]) - float(m_p["grad_norm"])) / float(m_p["grad_norm"])
    grad_err = {name: [(p.grad - pp.grad).abs().max().item(), pp.grad.abs().max().item()]
                for (name, p), (_, pp) in zip(model.named_parameters(),
                                              plain_model.named_parameters())}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "train_grad_err.json").write_text(json.dumps(
        {"columns": ["max_abs_err", "plain_max_abs_grad"], "params": grad_err}, indent=1))
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1][0])[:5]
    # edges the two steps' graphs differ by, net: the sampled graphs see
    # inputs that differ by rounding (K1 against the plain CSE upstream), so
    # draws within that rounding of their threshold may flip between steps
    edges = cfg.batch_size * cfg.max_src_len ** 2 * cfg.num_heads * cfg.sbm_layers
    step_flips = abs(float(m_k["sparsity"]) - float(m_p["sparsity"])) * edges
    grad_err = {name: err for name, (err, _) in grad_err.items()}
    if not (loss_rel <= LOSS_RTOL and gnorm_rel <= GNORM_RTOL
            and all(np.isfinite(list(grad_err.values())))):
        raise AssertionError(f"kernel vs plain step: loss rel {loss_rel}, grad-norm rel "
                             f"{gnorm_rel}, worst grads {worst}")
    del plain_model, plain_state, plain_step

    # TRAIN_STEPS more kernel steps on the same batch
    losses, times = [float(m_k["loss"])], []
    for _ in range(TRAIN_STEPS):
        state, m, seconds = timed_step(step, state, batch)
        if m["nonfinite"] or not np.isfinite(float(m["loss"])):
            raise AssertionError(f"non-finite train step: {m}")
        losses.append(float(m["loss"]))
        times.append(seconds)
    steps_counts = build.launch_counts()
    counts = {fn: counts[fn] + steps_counts[fn] for fn in counts}
    if not losses[-1] < losses[1]:
        raise AssertionError(f"loss did not fall over {TRAIN_STEPS} steps: {losses}")
    _check_launched("train_counter", counts)
    _check_shapes("train_counter", [tuple(batch.src_seq.shape)])
    repeat = repeatable_backward(model, cfg, batch)
    trace = profile_steps(step, state, batch) if profile else None
    del model, state, step

    # one step of the config's default noise mode: the shared graph
    shared_cfg = cfg.replace(noise_mode="shared")
    _, sh_state, sh_step = trainer(shared_cfg)
    build.reset_launches()
    sh_state, m_s, shared_s = timed_step(sh_step, sh_state, batch)
    shared_counts = build.launch_counts()
    if m_s["nonfinite"] or not np.isfinite(float(m_s["loss"])):
        raise AssertionError(f"non-finite shared-noise step: {m_s}")
    _check_launched("train_shared", shared_counts)
    _check_shapes("train_shared", [tuple(batch.src_seq.shape)])

    n_steps = 1 + TRAIN_STEPS
    rec = dict(model="python", noise_mode="counter", batch=cfg.batch_size, widths=dict(
        pegen=cfg.pegen_dim, enc=cfg.sbm_enc_dim, hidden=cfg.hidden_size, heads=cfg.num_heads,
        cse_layers=cfg.num_layers, sbm_layers=cfg.sbm_layers, dec_layers=cfg.decoder_layers,
        clusters=list(cfg.clusters), max_src_len=cfg.max_src_len, max_tgt_len=cfg.max_tgt_len),
        vocab=[SRC_VOCAB, TGT_VOCAB], dropout=cfg.dropout,
        attention_dropout=cfg.attention_dropout, learning_rate=cfg.learning_rate,
        kernel_loss=float(m_k["loss"]), plain_loss=float(m_p["loss"]), loss_rel=loss_rel,
        loss_rtol=LOSS_RTOL, kernel_grad_norm=float(m_k["grad_norm"]),
        plain_grad_norm=float(m_p["grad_norm"]), grad_norm_rel=gnorm_rel,
        grad_norm_rtol=GNORM_RTOL, grad_max_abs_err=max(grad_err.values()),
        worst_grad_errs=worst, kernel_sparsity=float(m_k["sparsity"]),
        plain_sparsity=float(m_p["sparsity"]), net_graph_edges_apart=step_flips,
        plain_step_s=plain_s, first_step_s=first_s,
        losses=losses, step_s=times, step_s_median=statistics.median(times[1:]),
        launches=counts, launches_per_step={fn: c / n_steps for fn, c in counts.items()},
        shared=dict(loss=float(m_s["loss"]), step_s=shared_s, launches=shared_counts),
        repeatable_backward=repeat,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, profile=trace)
    emit("train", **rec)
    return rec


# ---------------------------------------------------------------------------
# phase 6: the expected-graph gradient of the whole model
# ---------------------------------------------------------------------------

def expected_grad_phase() -> dict:
    """``model(batch, deterministic=True)`` under ``eval_graph="expected"``,
    ``nll + sw · sparsity``, ``backward()``: the kernels (K1, K2 forward;
    K8, K9 backward) against the plain paths on the card, same weights."""
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.ops import build, flex_core
    from csat_tpu_torch.resilience.guards import global_norm
    from csat_tpu_torch.train import label_smoothing_loss

    cfg = get_config("python", eval_graph="expected")
    batch = train_batch(cfg, cfg.batch_size)
    model = CSATrans(cfg, SRC_VOCAB, TGT_VOCAB, device="cuda", seed=SEED)
    plain_model = copy.deepcopy(model)

    def grad_pass(m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        log_probs, sparsity = m(batch, deterministic=True)
        nll = label_smoothing_loss(log_probs, batch.target, cfg.smoothing)
        total = nll + cfg.sw * sparsity
        total.backward()
        torch.cuda.synchronize()
        grads = {name: p.grad for name, p in m.named_parameters()}
        return (float(total.detach()), float(nll.detach()), float(global_norm(grads)),
                time.perf_counter() - t0)

    build.reset_launches()
    k_total, k_nll, k_gnorm, k_s = grad_pass(model)
    counts = build.launch_counts()
    select = flex_core.select_impl
    flex_core.select_impl = lambda x: "reference"
    try:
        build.reset_launches()
        p_total, p_nll, p_gnorm, p_s = grad_pass(plain_model)
    finally:
        flex_core.select_impl = select
    if any(build.launch_counts().values()):
        raise AssertionError(f"the plain pass launched kernels: {build.launch_counts()}")
    _check_launched("expected_grad", counts)
    _check_shapes("expected_grad", [tuple(batch.src_seq.shape)])
    loss_rel = abs(k_total - p_total) / abs(p_total)
    gnorm_rel = abs(k_gnorm - p_gnorm) / p_gnorm
    grad_err = {name: [(p.grad - pp.grad).abs().max().item(), pp.grad.abs().max().item()]
                for (name, p), (_, pp) in zip(model.named_parameters(),
                                              plain_model.named_parameters())}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "expected_grad_err.json").write_text(json.dumps(
        {"columns": ["max_abs_err", "plain_max_abs_grad"], "params": grad_err}, indent=1))
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1][0])[:5]
    finite = all(np.isfinite(err) for err, _ in grad_err.values())
    if not (loss_rel <= LOSS_RTOL and gnorm_rel <= GNORM_RTOL and finite):
        raise AssertionError(f"expected-graph gradient, kernel vs plain: loss rel {loss_rel}, "
                             f"grad-norm rel {gnorm_rel}, worst grads {worst}")
    graph_grads = [err for name, (err, mx) in grad_err.items() if "clusters" in name and mx > 0]
    if len(graph_grads) != cfg.sbm_layers:
        raise AssertionError("the cluster embeddings got no gradient through the graph")
    rec = dict(model="python", eval_graph="expected", batch=cfg.batch_size,
               kernel_loss=k_total, plain_loss=p_total, loss_rel=loss_rel, loss_rtol=LOSS_RTOL,
               kernel_grad_norm=k_gnorm, plain_grad_norm=p_gnorm, grad_norm_rel=gnorm_rel,
               grad_norm_rtol=GNORM_RTOL,
               grad_max_abs_err=max(err for err, _ in grad_err.values()),
               worst_grad_errs=worst, kernel_pass_s=k_s, plain_pass_s=p_s, launches=counts)
    emit("expected_grad", **rec)
    return rec


# ---------------------------------------------------------------------------
# phase 7: Trainer.fit at the published widths
# ---------------------------------------------------------------------------

def _by_shape(steps):
    """Per batch shape (B, N, T-1): step count and median seconds (the first
    step of a shape, which pays one-off allocation, left out when it can be)."""
    out = {}
    for shape in sorted({tuple(r["shape"]) for r in steps}):
        secs = [r["seconds"] for r in steps if tuple(r["shape"]) == shape]
        out["x".join(map(str, shape))] = dict(
            steps=len(secs), median_s=statistics.median(secs[1:] or secs), first_s=secs[0])
    return out


def fit_phase(profile: bool) -> dict:
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.dataset import ASTDataset
    from csat_tpu_torch.data.synthetic import make_corpus
    from csat_tpu_torch.ops import build
    from csat_tpu_torch.train import Trainer, run_test
    from csat_tpu_torch.train.checkpoint import make_checkpoint_fn

    tmp = tempfile.mkdtemp(prefix="csat_fit_")
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # keep stdout to the JSON lines
            data_dir = make_corpus(os.path.join(tmp, "corpus"), *FIT_SAMPLES, seed=SEED,
                                   max_ast_len=150, node_range=FIT_NODES)
        corpus_s = time.perf_counter() - t0

        def new_trainer(out):
            cfg = get_config("python", data_dir=data_dir, output_dir=os.path.join(tmp, out),
                             noise_mode="counter", eval_graph="expected", bucketing=True,
                             num_epochs=FIT_EPOCHS, val_interval=1, save_interval=1,
                             guard_check_every=1)
            logs = []
            tr = Trainer(cfg, log=logs.append)
            sets = {split: ASTDataset(cfg, split, tr.src_vocab, tr.tgt_vocab)
                    for split in ("train", "dev", "test")}
            return cfg, tr, sets, logs

        cfg, tr, sets, logs = new_trainer("run_a")
        ckpt = make_checkpoint_fn(tr.output_dir, retries=cfg.save_retries,
                                  backoff_s=cfg.save_retry_backoff_s)
        build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, hist = tr.fit(sets["train"], sets["dev"], checkpoint_fn=ckpt)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = build.launch_counts()
        steps = hist["steps"]
        if not all(np.isfinite(r["loss"]) for r in steps) or hist["nonfinite_steps"]:
            raise AssertionError(f"non-finite train step in the fit: {hist['nonfinite_steps']}")
        if not (len(hist["loss"]) == FIT_EPOCHS and hist["loss"][-1] < hist["loss"][0]):
            raise AssertionError(f"epoch loss did not fall: {hist['loss']}")
        shapes = _by_shape(steps)
        if len(shapes) < 2:
            raise AssertionError(f"fewer than two bucket shapes stepped: {list(shapes)}")
        _check_launched("fit", counts)
        # train steps come in the plan's shapes, and the eval decode pads
        # every batch to its bucket's rows
        _check_shapes("fit", {tuple(r["shape"][:2]) for r in steps} | set(plan_shapes()))
        ck_dir = os.path.join(tr.output_dir, "checkpoints")
        if sorted(os.listdir(ck_dir)) != [f"state_{e}.pt" for e in range(1, FIT_EPOCHS + 1)]:
            raise AssertionError(f"checkpoints missing: {os.listdir(ck_dir)}")

        # a second Trainer restored from the epoch-1 checkpoint replays epoch 2
        cfg_b, tr_b, sets_b, _ = new_trainer("run_b")
        os.makedirs(os.path.join(tr_b.output_dir, "checkpoints"))
        shutil.copy(os.path.join(ck_dir, "state_1.pt"),
                    os.path.join(tr_b.output_dir, "checkpoints", "state_1.pt"))
        trace = None
        if profile:
            from torch.profiler import ProfilerActivity, profile as profiler

            with profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _, hist_b = tr_b.fit(sets_b["train"], sets_b["dev"], resume=True)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            trace = _device_summary(prof, wall)
        else:
            _, hist_b = tr_b.fit(sets_b["train"], sets_b["dev"], resume=True)
        want = [r for r in steps if r["epoch"] == 2]
        got = hist_b["steps"]
        if not (got and [r["shape"] for r in got] == [r["shape"] for r in want]):
            raise AssertionError("the restored run stepped other batches")
        # every step of the replayed epoch, not only the first
        apart = [(i, g["loss"], w["loss"]) for i, (g, w) in enumerate(zip(got, want))
                 if g["loss"] != w["loss"]]
        if apart:
            raise AssertionError(f"the restored run's losses differ from the uninterrupted "
                                 f"run's (step, restored, uninterrupted): {apart}")

        tr.model.load_state_dict(hist["best_params"], strict=True)
        t0 = time.perf_counter()
        scores = run_test(tr.model, sets["test"], cfg, tr.tgt_vocab,
                          output_dir=tr.output_dir)
        test_s = time.perf_counter() - t0
        if not all(np.isfinite(v) for v in scores.values()):
            raise AssertionError(f"test scores not finite: {scores}")
        eval_tokens = len(sets["dev"]) * (cfg.max_tgt_len - 1)
        rec = dict(
            model="python", noise_mode="counter", eval_graph="expected", bucketing=True,
            batch=cfg.batch_size, epochs=FIT_EPOCHS, samples=list(FIT_SAMPLES),
            node_range=list(FIT_NODES), vocab=[tr.src_vocab.size(), tr.tgt_vocab.size()],
            corpus_s=corpus_s, fit_s=fit_s, epoch_loss=hist["loss"],
            step_losses=[r["loss"] for r in steps], steps=len(steps), by_shape=shapes,
            val_bleu=hist["val_bleu"], best_bleu=hist["best_bleu"], eval_s=hist["eval_s"],
            eval_tokens=eval_tokens,
            eval_tokens_per_s=eval_tokens / statistics.median(hist["eval_s"]),
            rollbacks=hist["rollbacks"], launches=counts,
            restored_first_loss=got[0]["loss"], uninterrupted_first_loss=want[0]["loss"],
            restored_steps_bit_equal=[len(want), len(want)],
            test=scores, test_s=test_s, test_tokens=len(sets["test"]) * (cfg.max_tgt_len - 1),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, profile=trace)
        emit("fit", **rec)
        return rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace a serving run, two train steps and the restored fit "
                         "epoch with torch.profiler")
    args = ap.parse_args(argv)
    smi = device_phase()
    build_phase()
    from csat_tpu_torch.ops import build

    dev = torch.device("cuda")
    measured = kernel_phase(dev)
    served = serve_phase(args.profile)
    trained = train_phase(args.profile)
    expected = expected_grad_phase()
    fitted = fit_phase(args.profile)
    by_path = {"serve": served["launches"], "train_counter": trained["launches"],
               "train_shared": trained["shared"]["launches"],
               "expected_grad": expected["launches"], "fit": fitted["launches"]}
    kernels = []
    for fn, lib in build.KERNELS.items():
        m = measured[fn]
        launches = {path: counts[fn] for path, counts in by_path.items() if counts[fn]}
        kernels.append(dict(
            name=fn, route="cuda", source=str(build.SOURCES[lib].relative_to(REPO)),
            replaces=build.REPLACES[fn],
            launches=sum(launches.values()), launches_by_path=launches,
            max_abs_err=m["max_abs_err"], ms=m["ms"],
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
