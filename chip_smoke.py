"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # also trace serving, train steps, the expected-graph
                                       # gradient, a fit epoch, the serving trace and two
                                       # python_long steps

Phases, each printing JSON lines:

1. ``device``  — the card, as ``nvidia-smi`` names it, with TF32 off;
2. ``build``   — compiles every CUDA kernel of the serving and training paths
   from the checkout's sources (``csat_tpu_torch/ops/csrc``) with ``nvcc`` for
   sm_90a, one process per source, all at once, and counts the tensor-core
   instructions in the SASS of K1/K2/K6/K7 and of K3/K4/K8/K9 (``sass``: an
   instantiation without any fails the run);
3. ``kernel``  — each kernel against its plain PyTorch version on the card, at
   the shapes the driven paths give it — the serving batches, B 64 / N 150,
   and every bucket of the fit's plan (259×37, 128×75, 64×150), which each
   later phase checks against what it ran: max abs error (with its
   tolerance), exact skip counts, and times (CUDA events, median of several
   runs; at the plan's smaller buckets every flex kernel is timed, K1 and
   K2 beside SDPA with the same score bias or weight as an additive float
   mask; K1 also on the distances and masks of the train phase's batch and
   of the serve phase's largest prefill group, K6
   and K3/K4 on what the first SBM layer of a training step on that batch
   gives them — factors, padding, seeds and cotangents —, K8/K9 on what the
   first SBM layer of the ``expected_grad`` phase's forward gives them, and
   K5 on what one
   self-attention and one cross-attention launch of the serve phase's drain
   gives it — pages, tables, masks, widths and merged lanes); K7, the
   graph kernel of the default noise mode, at every bucket at rate 0.2 and
   at rate 0, at B 4 / N 150 at rate 0 and on the graph of the first SBM
   layer of a ``noise_mode="shared"`` training step; every backward
   check also holds its forward's ``out`` and ``lse``; the expected-graph
   backward also on whole padded key tiles and on inputs with exact ties at
   both clip bounds, at the default floor and at floor 0, and without
   dropout against a float64 closed form that shares no code with the plain
   version; for the variants phase, K1 and K2 at every prefill group the
   serve ladder can form (K2 at dh 64 and at java's dh 96), K7 and K1 at the
   python variants' train batch, and, timed beside SDPA, K2 on the first SBM
   layer of java's largest serving prefill group and K7 on that of a java
   shared-noise step at B 64 (dh 96; the spill bytes of the dh-96 builds are
   printed, not gated), and K6, K3/K4 and K8/K9 at dh 96 on random inputs
   and on the first SBM layer of a java counter step and of java's
   expected-graph forward; for the precision phase, K5 on one self- and one
   cross-attention launch of its bf16-page and its int8-page drains;
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
   must give bit-equal gradients; each of the 4 SBM layers' kernel forward
   and backward against the plain ones on the inputs that layer got in a
   kernel step, so that both see the same sampled graph (no edge apart,
   output within 1e-6 and every gradient within 1e-5, relative L2);
   every training kernel must have launched in the step that uses it;
   ``train_shared`` — the same in the config's default noise mode,
   ``"shared"`` (the graph sampled through the STE from the train state's
   generator, read by K7): kernel step against plain step, the same-graph
   gate on each SBM layer's own graph (its cotangent included), 8 more
   steps, every forward launch at a shape and rate phase 3 checked;
6. ``expected_grad`` — the gradient of the same model's deterministic forward
   under ``eval_graph="expected"`` (``nll + sw · sparsity``, batch 64):
   through the kernels and through the plain paths on the card, loss within
   1e-5 and global grad-norm within 1e-4 relative, every parameter's error
   written out; then each SBM layer's K2 forward and K8/K9 backward against
   the plain ones on the inputs and cotangents that layer got in that
   forward (graph_sum within 1e-6, output within 1e-6 and every gradient
   within 1e-5, relative L2);
7. ``fit``     — ``Trainer.fit`` at the published widths on a synthetic corpus
   made in a temporary directory (512 / 64 / 64 samples of 10 to 150 nodes; the
   vocabularies are the corpus's own, a few dozen words): 2 epochs with
   ``noise_mode="counter"``, ``eval_graph="expected"``, length buckets, batch
   64, validation (greedy decode + BLEU) and a checkpoint each epoch; every
   step finite, the second epoch's mean loss below the first's, at least two
   bucket shapes stepped, the train and eval kernels launched; a second
   ``Trainer`` restored from the epoch-1 checkpoint must reproduce every
   loss of epoch 2 bit for bit; then ``run_test`` scores BLEU / ROUGE-L /
   METEOR; ``fit_default`` — a second ``Trainer.fit`` on the same corpus in
   the config's own defaults (``noise_mode="shared"``,
   ``eval_graph="sample"``): 2 epochs, every step finite, epoch loss
   falling, K1 and K7 launched at every train bucket and in the eval
   encoder, at shapes and rates phase 3 checked;
8. ``variants`` — the paper's other encoders, each at its published widths
   and full depth in its own defaults (``noise_mode="shared"``):
   ``python_full_att``, ``python_lap``, ``python_seq``, ``python_treepos``
   and ``python_triplet`` at B 16 — a kernel step against a plain step on
   the card, 4 more steps whose loss must fall — and ``java`` at B 64 — the
   step gate and the same-graph gate on each SBM layer at dh 96, then in
   ``noise_mode="counter"`` the same two gates (K6, K3, K4) and the
   expected-graph gradient gate with its same-layer gate (K2, K8, K9), at the
   python gates' limits; then each
   serves 4 (java 8) requests with ``eval_graph="expected"``, all OK, no page
   leak, tokens equal between the kernels and the plain route on the card
   up to a near tie; the tree positions and triplet ids fed in must not be
   blank; every forward launch at a (B, N, rate, dh) phase 3 checked; the
   lap line carries its ``eigh`` time, and the treepos model's PE goes
   through the RQ2 probe (finite accuracies, no threshold);
9. ``precision`` — the flagship model in the JAX package's production
   precision, ``compute_dtype="bfloat16"`` (bf16 layers, f32 attention
   islands, f32 master weights), on the train batch at B 64: a kernel step
   against a plain step in the default noise mode (loss within 1e-3 and
   grad-norm within 1e-2 relative), the same-graph gate on each SBM layer's
   f32 inputs in both noise modes at the f32 limits, 8 more steps whose loss
   must fall, the bf16 and the f32 step timed in turns, one step from
   ``init_scheme="reference"`` weights; then 16 requests served at (bf16
   compute, bf16 pages) and at (f32 compute, int8 pages) through the kernels
   and through the plain route: all OK, no leak, tokens equal up to a near
   tie, K5's launches counted by storage dtype;
10. ``resilience`` — the trainer's resilience and telemetry on the flagship
   at its published widths, batch 64, in its defaults (shared noise, sampled
   eval graph), bucketed on the fit phases' corpus: the host-device syncs of
   a train step between guard reads, counted and named by line (none may
   come from the guard, and ``guarded_apply`` alone must sync nothing); the
   guarded AdamW update's cost against the unguarded one and a
   three-``where``-per-tensor form; a NaN step that leaves parameters and
   moments bitwise unchanged and is counted once (the watchdog's device
   probe on, untripped); three NaN steps rolled back once, the replay
   finite; the command line SIGTERM'd mid-epoch exiting 75, then
   ``--resume`` reproducing an uninterrupted run's every loss bit for bit,
   each run its own process; a child whose ``StepWatchdog`` sees its stream
   wedged exiting 76; the watchdog's host leg tripping on a hung step with
   its diagnostics and post-mortem, its device leg on a stream wedged by
   ``torch.cuda._sleep`` while the host still beats; two corrupt batches
   quarantined on the planned chunks through the prefetch thread and a
   third raising; the registry's counters equal to the history's, the
   scalar log's cadence, a profiled epoch's traces; an epoch's syncs per
   step; epochs with prefetch 0 and 2 in turns, every loss bitwise equal,
   with their wall and ``train.data`` seconds and busy share printed;
11. ``serving`` — the serving engine as production runs it: the flagship at
   full width, 8 slots, the default prefix cache (64 entries), random
   weights from a seed, ``eval_graph="expected"``: 32 requests (8 exact
   repeats of one of the four before them, budgets and AST sizes skewed as
   ``bench.py``'s, Poisson arrivals in decode steps) driven twice from a
   cold cache — every request OK, tokens equal between the runs and to the
   CPU plain run up to a near tie, prefix hits > 0 each equal to its
   original, no page or chain leaked, exactly one device read on every tick
   that only decodes (counted by site), no kernel library built or loaded
   after the first run; the drill matrix of the JAX package's serving tests
   on one engine under a virtual clock (poison at submit, ``reject`` and
   ``shed_oldest``, deadlines queued and in flight, a NaN slot FAILED with
   the others exact, a wedged slot reaped, a prefill failure, a decode fault
   rebuilt with the tokens of a clean run, retries exhausted then the
   rebuild cap, ``shed_all``, a prefix hit on the NaN drill's scrubbed self
   page, exact, and the tick watchdog tripped by its callback), each leaving
   every request terminal once, no leak and a post-mortem; the command line
   on a checkpoint of a short fit: ``summarize`` equal to the engine, a
   ``serve`` process fed malformed lines and SIGTERM'd mid-stream answering
   every line and exiting 0;
12. ``long_ast`` — the long-AST configs, ``python_long`` and ``java_long``
   (N 512, counter noise, remat, SBM heads of 64 and 96), at their published
   widths: (a) for each, at B 64 in its defaults, the step gate, the
   same-graph gate on each SBM layer and 8 more steps whose loss must fall;
   (b) a kernel step with remat on against one with it off, loss the same
   bits, grad-norm within 1e-6, the peak memory of each; (c) a world-1 NCCL
   group driving a one-epoch ``Trainer.fit`` of python_long with validation
   on a synthetic corpus of 200 to 512 nodes; (d) two gloo ranks in two
   processes, both on ``cuda:0``, each taking half of the B 64 batch (rank
   1's hash streams at bh0 = 32 · 8), against the one-process B 64 step
   at python_long's own dropout (loss within 1e-5, grad-norm within 1e-4,
   parameters the same bits on both ranks); (e) for each, 8 requests of 300 to 512 nodes
   served through the kernels and the plain route, tokens equal up to a near
   tie; phase 3 checks and times their kernels at N 512 (``n512`` line);
13. ``parallel`` — the ``seq`` and ``pipe`` mesh axes, each as two gloo
   ranks in fresh interpreters sharing ``cuda:0`` against one process: (a)
   python_pp at ``("pipe", 2)``, B 64 in 4 microbatches, N 150 — a step
   (loss within 1e-5, grad-norm within 1e-4, the parameters the same bits
   on both ranks), 8 steps, 8 ASTs decoded on the sampled (K6 in the
   stages) and the expected graph (K2) up to a near tie; (b) python_long at
   ``("seq", 2)``, B 64, N 512 — the first SBM layer's ΣA the same bits as
   the one-process step's, the ring against K6 on layers 0 and 3's own
   gathered inputs (ΣA the same bits), the step at the python gates'
   limits, 8 ASTs decoded up to a near tie, the ranks' step times and peak
   memory beside one process's; phase 3 checks their kernels' shapes
   (``pp_micro`` line);
14. ``tensor`` — the ``model`` mesh axis and the serve mesh: (a) in phase 3,
   K2, K6, K7, K3/K4 and K8/K9 at 4 of 8 heads (h0 4, head stride 8), B 64,
   N 150, against the head slice of the full 8-head launch (0 edges apart,
   output within 1e-6, gradients within 1e-5 relative L2) and against their
   plain versions, timed, and K1 on the T plane's heads alone (``head_shard``
   lines); (b) python at its published widths, own dropout and shared noise
   at ``("data", 1), ("model", 2)``, B 64, two gloo ranks on ``cuda:0``
   against one process from the same weights and generator state — loss
   within 1e-5, grad-norm within 1e-4, the gathered parameters the same on
   both ranks and within 1e-6 (relative L2) of one process's, the edges
   apart per SBM layer recorded, K7 against plain on each gated layer's own
   inputs (0 edges), 8 steps falling, 8 ASTs decoded up to a near tie, rank
   step seconds and peak memory; (c) python_long at ``("data", 1), ("model",
   2), ("seq", 2)``, four ranks, N 512 — the ring on a head shard, the same
   step gate, the first SBM layer's ΣA equal, the decode; (d) the
   ``serving`` trace with ``serve_mesh_shape=(1, 2)``, both head shards on
   ``cuda:0``, at f32 and at bf16 compute with int8 pages — tokens and
   statuses equal to the solo engine's bit for bit, prefix hits, no leak,
   K5 launched once per shard for each solo launch;
15. ``storage`` — the serving engine's storage, on the flagship at full
   width: (a) KV tiering — the ``serving`` trace on a pool of half the slots'
   worst case with a 16-page host tier over a disk tier, against a
   never-tiered engine on the same pool: warm both, spill the tiered warm
   set, replay — tokens and statuses equal bit for bit, restores, demotions
   and disk entries > 0, every restored chain's pages gathered again equal
   to its spilled bytes, no page or chain leaked, one device read per
   decode-only tick; then every snapshot corrupted — each restore a
   ``digest_mismatch``, the requests re-prefilled, the tokens still equal;
   at f32 and at int8 pages, and an f32 engine over the int8 engine's disk
   tier refusing every snapshot (``dtype_mismatch``); restore p95, spill ms
   and bytes per chain; (b) the same on a ``(1, 2)`` serve mesh, both shards
   on ``cuda:0``: every spilled payload and the replay's tokens equal to the
   solo engine's; (c) the trace through the rect layout (prefix cache 0):
   tokens equal to the paged engine's up to a near tie, bit-equality to its
   plain and K5 routes printed, the rect pool's KV bytes beside the paged
   pool's peak; (d) warm start in four fresh processes over one store — cold
   (``absent`` misses, ``nvcc`` builds and saves), warm (hits, no ``nvcc``),
   corrupted entries (``digest_mismatch``, rebuilt), ``CSAT_TPU_NO_CACHE=1``
   (``disabled``) — 8 requests each, tokens equal across the four, the
   engine's start wall cold and warm;
16. ``kernels`` — one line listing every kernel with its route, source, the
   TPU kernel it replaces, its launches in phases 4-15 by path, its error,
   times and bound.

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
import re
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
# outside the tensor cores and TF32 FLOP/s on them.  A bound counts the
# matrix products of a kernel's work at the f32-faithful tensor-core rate,
# 3xTF32 (three TF32 products per f32 one, a third of the TF32 rate),
# whatever route implements them, and the other f32 work (R·K̂ᵀ, summed one
# rounding at a time in a fixed order) at the f32 rate.
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
# the same-graph gate: each SBM layer's kernel and plain paths on one set of
# inputs, so the sampled graphs agree and only the arithmetic differs
SAME_GRAPH_OUT_RTOL, SAME_GRAPH_GRAD_RTOL = 1e-6, 1e-5
# the expected mod draws nothing: its gate holds graph_sum (Σ soft weights)
SAME_GRAPH_GSUM_RTOL = 1e-6
GS_COEF = 1e-3    # weight of Σ graph_sum in the backward checks' loss
GRAD_NAMES = ("dq", "dk", "dv", "dr", "dkh")
GRAPH_TOL = 5e-6  # K7 against plain, max abs: its output feeds the next layer's graph
# the precision phase, bf16 compute: a kernel step against a plain step.  The
# kernels' f32 outputs differ from the plain path's by rounding (≤ 2e-5); the
# cast back to bf16 turns one f32 ulp at a rounding boundary into a bf16 ulp,
# which spreads through the later layers, so the gate is bf16-sized
BF16_LOSS_RTOL, BF16_GNORM_RTOL = 1e-3, 1e-2
# served tokens at bf16 compute are compared up to a top-2 log-prob gap this
# small: a logit of a few units carries a bf16 ulp of about 1e-2, and a
# rounding flip upstream moves it by that much (as tests/test_torch_precision.py)
BF16_TIE = 0.05
# the first decode step's log-probs of a drain's first admitted slots, the
# kernel route against the plain route on the card (relative L2), by compute
# dtype: f32 differs by the kernels' rounding; bf16 by what a rounding flip
# spreads into (added after this gate's first card run, which compared 9 of
# 514 bf16 tokens before a 0.05 near tie: the tie rule alone says little)
FIRST_STEP_LOGP_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}

#: (kernel, B, N, dh) held against its plain version in phase 3; each driven
#: path must find the shapes it gave its kernels in here
CHECKED: set = set()
#: (forward kernel, B, N, dropout rate, dh) held in phase 3: the default
#: path's K7 runs at rate 0.2 in train steps and at rate 0 in the eval
#: encoder, java's SBM kernels at dh 96
CHECKED_RATES: set = set()

#: library → the kernel instantiations in it that must hold tensor-core
#: instructions: K2, K6 and K7 at dh 64 and 96, K1 at 1, 2 and 4 slabs a
#: block; K3, K4, K8 and K9 at dh 64 and 96
TENSOR_CORE_LIBRARIES = {"flex_fwd_tc": 9, "flex_bwd_tc": 8}

#: the __global__ functions of csrc/*.cu, as the profiler names them
PORT_KERNEL_FUNCTIONS = ("flex_cse_kernel", "flex_tc_kernel", "flex_graph_kernel",
                         "bwd_tc_kernel", "paged_decode_kernel")

#: the kernels each driven path must launch
PATH_KERNELS = {
    "serve": ("flex_fwd_cse", "flex_fwd_sbm_expected", "paged_decode"),
    "train_counter": ("flex_fwd_cse", "flex_fwd_sbm_sampled", "flex_bwd_q_sbm_sampled",
                      "flex_bwd_k_sbm_sampled"),
    # the config's default noise mode: the materialised shared graph
    "train_shared": ("flex_fwd_cse", "flex_fwd_sbm_graph"),
    "expected_grad": ("flex_fwd_cse", "flex_fwd_sbm_expected", "flex_bwd_q_sbm_expected",
                      "flex_bwd_k_sbm_expected"),
    # Trainer.fit: train steps (K1, K6, K3, K4) and the eval decode's encoder (K1, K2)
    "fit": ("flex_fwd_cse", "flex_fwd_sbm_sampled", "flex_bwd_q_sbm_sampled",
            "flex_bwd_k_sbm_sampled", "flex_fwd_sbm_expected"),
    # Trainer.fit in the config's defaults (noise_mode="shared",
    # eval_graph="sample"): K1 and K7 in train steps and in the eval encoder
    "fit_default": ("flex_fwd_cse", "flex_fwd_sbm_graph"),
    # the variants phase, train steps (shared noise) and serving: full
    # attention keeps the CSE and drops the SBM kernels, the other PE
    # variants drop the CSE; java runs the SBM kernels at dh 96
    "python_full_att": ("flex_fwd_cse", "paged_decode"),
    **{name: ("flex_fwd_sbm_graph", "flex_fwd_sbm_expected", "paged_decode")
       for name in ("python_lap", "python_seq", "python_treepos", "python_triplet")},
    # java also takes a counter-mode step gate and the expected-graph
    # gradient: its SBM kernels at dh 96 forward and backward
    "java": ("flex_fwd_cse", "flex_fwd_sbm_graph", "flex_fwd_sbm_expected", "paged_decode",
             "flex_fwd_sbm_sampled", "flex_bwd_q_sbm_sampled", "flex_bwd_k_sbm_sampled",
             "flex_bwd_q_sbm_expected", "flex_bwd_k_sbm_expected"),
    # the precision phase: bf16 training in the default (shared) noise mode,
    # serving at (bf16 compute, bf16 pages) and (f32 compute, int8 pages)
    "precision_train": ("flex_fwd_cse", "flex_fwd_sbm_graph"),
    # the resilience phase: Trainer.fit epochs in the defaults, no validation
    "resilience": ("flex_fwd_cse", "flex_fwd_sbm_graph"),
    **{f"precision_serve_{pages}": ("flex_fwd_cse", "flex_fwd_sbm_expected", "paged_decode")
       for pages in ("bfloat16", "int8")},
    # the serving engine as production runs it: prefix-cache misses prefill
    # (K1, K2), hits attach, every slot decodes (K5)
    "serving": ("flex_fwd_cse", "flex_fwd_sbm_expected", "paged_decode"),
    # the long-AST configs at N 512: counter-mode train steps (K1, K6, K3,
    # K4; java's SBM at dh 96) and serving (K1, K2, K5); the world-1 NCCL fit
    # (train steps and the sampled eval encoder); the two gloo ranks
    **{name: ("flex_fwd_cse", "flex_fwd_sbm_sampled", "flex_bwd_q_sbm_sampled",
              "flex_bwd_k_sbm_sampled", "flex_fwd_sbm_expected", "paged_decode")
       for name in ("python_long", "java_long")},
    **{path: ("flex_fwd_cse", "flex_fwd_sbm_sampled", "flex_bwd_q_sbm_sampled",
              "flex_bwd_k_sbm_sampled") for path in ("long_fit", "long_dp")},
    # the parallel phase: python_pp's stages (K6, K3, K4 in training, K6 and
    # K2 in the decodes) behind the CSE (K1); python_long under the seq axis:
    # the CSE on whole rows (K1), the SBM stack the ring (plain PyTorch, as
    # it is plain jnp in JAX), train and eval alike
    "parallel_pp": ("flex_fwd_cse", "flex_fwd_sbm_sampled", "flex_bwd_q_sbm_sampled",
                    "flex_bwd_k_sbm_sampled", "flex_fwd_sbm_expected"),
    "parallel_seq": ("flex_fwd_cse",),
    # the tensor phase: python over a model axis in its defaults (shared
    # noise): K1 on a plane's heads and K7 on a head shard, train and eval;
    # python_long over model × seq: K1 on a plane's heads, the SBM stack the
    # ring on a head shard; the serve mesh: prefill K1 / K2 on the engine's
    # device, K5 on each head shard's pages
    "tensor_tp": ("flex_fwd_cse", "flex_fwd_sbm_graph"),
    "tensor_tp_seq": ("flex_fwd_cse",),
    **{f"tensor_serve_{pages}": ("flex_fwd_cse", "flex_fwd_sbm_expected", "paged_decode")
       for pages in ("float32", "int8")},
    # the storage phase: tiered engines (prefill K1 / K2 for misses and
    # re-prefills, K5 over restored chains too), alone and on a serve mesh;
    # the rect layout (prefill K1 / K2, a plain decode); warm-start processes
    **{path: ("flex_fwd_cse", "flex_fwd_sbm_expected", "paged_decode")
       for path in ("storage_tier_float32", "storage_tier_int8", "storage_mesh",
                    "storage_warm")},
    "storage_rect": ("flex_fwd_cse", "flex_fwd_sbm_expected"),
}
#: java's dh-96 kernels that only its counter gate and expected-graph
#: gradient run (at its train batch, B 64 / N 150)
JAVA_GATE_KERNELS = ("flex_fwd_sbm_sampled", "flex_bwd_q_sbm_sampled", "flex_bwd_k_sbm_sampled",
                     "flex_bwd_q_sbm_expected", "flex_bwd_k_sbm_expected")
#: the precision phase's serving runs: (compute dtype, KV page dtype)
PRECISION_SERVES = (("bfloat16", "bfloat16"), ("float32", "int8"))
#: the variants phase: (config, train batch, requests served); each config
#: at its published widths and its own defaults (noise_mode="shared"); B 16
#: keeps the five python variants' share of the run small
VARIANTS = (("python_full_att", 16, 4), ("python_lap", 16, 4), ("python_seq", 16, 4),
            ("python_treepos", 16, 4), ("python_triplet", 16, 4), ("java", TRAIN_B, 8))
VARIANT_STEPS = 4
PROBE_SAMPLES = 64
FIT_SAMPLES = (512, 64, 64)   # train / dev / test
FIT_NODES = (10, 150)         # node counts, uniform: the corpus spreads over the buckets
FIT_EPOCHS = 2
#: the long-AST phase: its configs, the train batch's and the corpus's AST
#: sizes, the fit corpus (train / dev / test), the served requests' sizes and
#: count, the data-parallel gate's ranks and their time limit
LONG_CONFIGS = ("python_long", "java_long")
LONG_NODES = (200, 512)
LONG_FIT_SAMPLES = (128, 64, 64)
LONG_SERVE_NODES = (300, 512)
LONG_SERVE_REQUESTS = 8
DP_RANKS = 2
DP_TIMEOUT_S = 300.0
REMAT_GNORM_RTOL = 1e-6  # remat on against off: the recompute's order of sums


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
    # K1 at 1, 2 and 4 slabs a block, K2, K6 and K7 at dh 64 and 96; K3, K4,
    # K8 and K9 at dh 64 and 96
    for lib, n_fns in TENSOR_CORE_LIBRARIES.items():
        counts = tensor_core_instructions(build.library_path(lib))
        emit("sass", library=lib, tensor_core_instructions=counts)
        if len(counts) < n_fns or not all(counts.values()):
            raise AssertionError(f"{lib} was built without tensor-core instructions: {counts}")
    # registers and spills of every kernel function; K1's must not spill
    usage = {lib: ptxas_usage(log) for lib, log in build.BUILD_LOG.items()}
    # java's SBM width: the DH template argument 96, mangled Li96E; reported,
    # not gated
    emit("ptxas", usage=usage, spilled_at_dh96={
        fn: u["spill_stores"] for fn, u in usage.get("flex_fwd_tc", {}).items()
        if "Li96E" in fn})
    spilled = {fn: u for fn, u in usage.get("flex_fwd_tc", {}).items()
               if "flex_cse_kernel" in fn and u["spill_stores"]}
    if spilled:
        raise AssertionError(f"K1 spills registers: {spilled}")


def ptxas_usage(log: str) -> dict:
    """Registers and spill-store bytes per kernel function, from the
    ``-Xptxas -v`` report of one library's build."""
    usage, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            usage[fn] = {"registers": None, "spill_stores": 0}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            usage[fn]["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[fn]["registers"] = int(m.group(1))
    return usage


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
                 rel_mask=None, dh: int = 64, bh0: int = 0, r_len: int = 150):
    """Random inputs of one flex launch at the flagship's heads and clusters;
    ``r_len`` is the CSE's table length (``max_src_len``), ``bh0`` the
    batch·head offset of the hash streams (a data-parallel rank's rows)."""
    from csat_tpu_torch.ops.mods import (
        cse_mod, sbm_expected_mod, sbm_graph_mod, sbm_sampled_mod)

    h, kk = 8, 10
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
                                         pad.to(dev), floor=floor, bh0=bh0)
        elif mod == "sbm_sampled":
            seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, dtype=torch.int32)
            spec, aux = sbm_sampled_mod(torch.sigmoid(2 * rnd(b, h, n, kk)),
                                        torch.sigmoid(2 * rnd(b, h, n, kk)), s_aff.to(dev),
                                        pad.to(dev), seed.to(dev), bh0=bh0)
        else:
            graph = (torch.rand((b, h, n, n), generator=gen) < 0.4).float()
            spec, aux = sbm_graph_mod(graph.to(dev), pad.to(dev), bh0)
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
    return (uniform_field(sseed, b, h, n, n, spec.stride, bh0=spec.bh0, h_total=spec.h_total)
            - p).abs() <= NEAR


def _plain_reps(n: int) -> dict:
    """``cuda_ms`` repeats of a plain-path or library timing: at N 512 one
    plain call materialises a dozen (B, H, N, N) fields and takes tens of
    ms, so the long path's timings take fewer (the kernels' keep theirs)."""
    return dict(reps=3, trials=3) if n >= 512 else {}


def flex_check(mod: str, b: int, n: int, gen, dev, timed: bool = True, rel_mask=None,
               captured=None, rate=None, dh: int = 64, bh0: int = 0,
               r_len: int = 150) -> dict:
    """One forward kernel against its plain version at (B, N); ``timed``
    adds the times and the bound (left out for shapes checked for
    correctness only); ``rel_mask`` gives K1 a real batch's distances and
    masks in place of random ones; ``captured`` (from
    :func:`capture_sbm_inputs`) gives K6 or K7 what an SBM layer of a
    training step got; ``rate`` replaces the dropout rate of random inputs
    (default: ``RATE`` for the train mods, 0 for the others); ``dh`` the
    head width of random inputs; ``bh0`` the batch·head offset of their
    hash streams (rank 1 of a data-parallel step), ``r_len`` K1's table
    length."""
    from csat_tpu_torch.ops import build, flex_core

    if captured is None:
        q, k, v, spec, aux = _flex_inputs(mod, b, n, gen, dev, rel_mask=rel_mask, dh=dh,
                                          bh0=bh0, r_len=r_len)
        if rate is None:
            rate = RATE if mod in ("sbm_sampled", "sbm_graph") else 0.0
        dseed = torch.tensor([SEED + 7], dtype=torch.int32, device=dev) if rate else None
    else:
        q, k, v, spec, aux, rate, dseed = (captured[key] for key in (
            "q", "k", "v", "spec", "aux", "rate", "dseed"))
        b, n = q.shape[0], q.shape[2]
    real_inputs = rel_mask is not None or captured is not None
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
    # sampled: the flip gate instead; graph: a count of 0/1 weights, exact
    gsum_tol = {"sbm_sampled": float("inf"), "sbm_graph": 0.0}.get(mod, 1e-5)
    tol = GRAPH_TOL if mod == "sbm_graph" else FLEX_TOL
    if not (err <= tol and lse_err <= tol and gsum_err <= gsum_tol and near_ok
            and skip_equal and torch.isfinite(out).all()):
        raise AssertionError(f"flex {mod} B={b} N={n} rate={rate}: err={err} lse_err={lse_err} "
                             f"gsum_rel_err={gsum_err} flips={flips} near_ok={near_ok} "
                             f"skips equal={skip_equal}")
    dh = q.shape[-1]
    CHECKED.add((f"flex_fwd_{mod}", b, n, dh))
    CHECKED_RATES.add((f"flex_fwd_{mod}", b, n, rate, dh))
    if not timed:
        rec = dict(kernel=f"flex_fwd_{mod}", B=b, N=n, dh=dh, rate=rate, timed=False,
                   bh0=getattr(spec, "bh0", 0), max_abs_err=err,
                   lse_max_abs_err=lse_err, tol=tol, flips=flips,
                   near_draws=int(near.sum()), skipped_blocks=int(skips.sum()),
                   skip_equal=skip_equal)
        emit("kernel", **rec)
        return rec

    fn, args, _ = flex_core.kernel_args(spec, q, k, v, aux, rate, dseed)
    lib = build.kernel(fn)
    ms = cuda_ms(lambda: lib(*args))
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: flex_core.flex_reference(q, k, v, spec, aux, rate, dseed),
                           **_plain_reps(n))
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
        # q·k and P·V at the tensor-core rate, as K2-K7's; the two dh-long
        # gathered dot products of the bias at the f32 rate (K1 forms them
        # on f32 SIMT)
        simt_flops, tc_flops = live * 4 * dh, live * 4 * dh + empty_rows * n * dh
        # SDPA with the relative bias as an additive float mask, formed
        # outside the timing: (c2p + p2c)·scale, and -1e9 where masked (added
        # to the score where the kernel replaces it: a yardstick of time)
        with torch.no_grad():
            bias = cse_bias(q, k, spec, aux)
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, scale=spec.scale(dh)), **_plain_reps(n))
    else:
        # q·k and P·V on live-weight entries; for the factor mods R·K̂ on
        # every entry, since graph_sum counts the weight of padded keys too
        # (the sampled mod's integer hashes are not counted)
        with torch.no_grad():
            _, w_eff = spec.full_weight(q, k, aux)
        w_eff = torch.broadcast_to(w_eff, (b, h, n, n))
        live = int((w_eff > 0).sum())
        # K2, K6 and K7 run q·k and P·V on the tensor cores, R·K̂ on f32 SIMT
        tc_flops, simt_flops = live * 4 * dh, 0
        if mod != "sbm_graph":
            simt_flops += b * h * n * n * 2 * spec.kk
        if mod != "sbm_sampled":
            # SDPA with an additive log w mask: the same attention (for the
            # graph mod without its dropout: SDPA draws its own dropout bits)
            logw = torch.log(w_eff.contiguous())
            library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=logw), **_plain_reps(n))
    moved = nbytes(q, k, v, *aux, ex["lse"], out)
    bound, bound_by = bound_ms(moved, simt_flops, tc_flops)
    rec = dict(kernel=fn, B=b, N=n, dh=dh, rate=rate, bh0=getattr(spec, "bh0", 0),
               max_abs_err=err, lse_max_abs_err=lse_err, tol=tol, flips=flips,
               near_draws=int(near.sum()),
               skipped_blocks=int(skips.sum()), skip_equal=skip_equal, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound, bound_by=bound_by,
               live_entries=live, flops=simt_flops + tc_flops, tensor_core_flops=tc_flops,
               bytes=moved, inputs=(captured["inputs"] if captured is not None else
                                    "train batch" if real_inputs else "random"))
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


def expected_closed_form(q, k, v, aux, floor: float, go, gs_coef) -> dict:
    """The expected mod without dropout, written out from its definition in
    float64 over whole (N, N) fields: ``w = clip(R·K̂ᵀ, floor, .99)·(1 − pad)``,
    ``attn = w eˢ / Σ w eˢ``, ``out = attn·V``, and the gradients of
    ``Σ out·go + Σ gs_coef · Σ clip(R·K̂ᵀ)`` by hand (``gs_coef`` a scalar or
    the (B, H) graph_sum cotangent).  It shares no code with
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
    gs = torch.as_tensor(gs_coef, dtype=torch.float64, device=q.device)
    gs = gs[..., None, None] if gs.dim() else gs
    d_ea = (torch.exp(s - lse) * t * live * keep + gs) * c
    return dict(out=attn @ v64, lse=lse[..., 0], live_rows=l[..., 0] > 0,
                dq=d_s @ k64 * scale, dk=d_s.transpose(-1, -2) @ q64 * scale,
                dv=attn.transpose(-1, -2) @ go64, dr=d_ea @ kh.double(),
                dkh=d_ea.transpose(-1, -2) @ r.double())


def capture_sbm_inputs(cfg, batch, device="cuda", layers: int = 1,
                       deterministic: bool = False) -> list:
    """What the first ``layers`` SBM layers give ``flex_attention`` in one
    forward of the flagship model on ``batch`` (weights from ``SEED``,
    through the kernels), and the cotangents that the backward of ``nll + sw
    · sparsity`` brings to their ``out`` and ``graph_sum``, one dict per
    layer.  A training forward gives the real inputs of K6 and K3/K4 (or of
    K7 in the shared noise mode; ``"inputs": "train batch"``); with
    ``deterministic``, under ``eval_graph="expected"``, the forward of the
    ``expected_grad`` phase gives those of K2 and K8/K9 (rate 0, ``"inputs":
    "expected_grad batch"``)."""
    from csat_tpu_torch.models import CSATrans, sbm
    from csat_tpu_torch.train import label_smoothing_loss

    model = CSATrans(cfg, SRC_VOCAB, TGT_VOCAB, device=device, seed=SEED)
    got = []
    inner = sbm.flex_attention

    def recorder(q, k, v, spec, aux, rate=0.0, dseed=None):
        out, ex = inner(q, k, v, spec, aux, rate, dseed)
        if len(got) < layers:
            rec = dict(q=q, k=k, v=v, spec=spec, aux=aux, rate=rate, dseed=dseed,
                       go=torch.zeros_like(out), gs=torch.zeros_like(ex["graph_sum"]),
                       inputs="expected_grad batch" if deterministic else "train batch")
            got.append(rec)
            out.register_hook(lambda g, rec=rec: rec["go"].copy_(g))
            if ex["graph_sum"].requires_grad:
                ex["graph_sum"].register_hook(lambda g, rec=rec: rec["gs"].copy_(g))
        return out, ex

    sbm.flex_attention = recorder
    try:
        gen = None if deterministic else torch.Generator(device=device).manual_seed(SEED)
        log_probs, sparsity = model(batch, deterministic=deterministic, gen=gen)
        total = label_smoothing_loss(log_probs, batch.target, cfg.smoothing) + cfg.sw * sparsity
        total.backward()
    finally:
        sbm.flex_attention = inner
    detach = lambda t: t.detach().clone().contiguous() if torch.is_tensor(t) else t
    return [{key: (tuple(detach(t) for t in val) if key == "aux" else detach(val))
             for key, val in rec.items()} for rec in got]


def backward_work(spec, a_raw, a_eff, dh: int) -> dict:
    """The operations one backward pass pair of the sampled or the expected
    mod needs on these inputs, whatever route computes them.  ``a_raw`` /
    ``a_eff`` are the mod's weight fields (``spec.full_weight``): a live
    entry (``a_eff > 0``) takes q·k and g·v and, q-pass, d_s·K (6·dh FLOP)
    or, k-pass, d_sᵀ·Q and attnᵀ·g (8·dh); every entry its R·K̂ᵀ (2·kk);
    d_exp·K̂ or d_expᵀ·R (2·kk) every sampled edge of the sampled mod and
    every entry of the expected mod (its gate passes gs wherever the clip
    is open, padded keys included).  The dh-deep and the cluster products
    count as tensor-core work (``tensor_core_flops``, at the 3xTF32 rate),
    R·K̂ᵀ as f32 work.  Returns the counts and, per pass (``"q"``, ``"k"``),
    ``flops`` (all of it) and ``tensor_core_flops``."""
    from csat_tpu_torch.ops.mods import SBMSampledSpec

    b, h, n, _ = torch.broadcast_shapes(a_raw.shape, a_eff.shape)
    entries = b * h * n * n
    live = int((torch.broadcast_to(a_eff, (b, h, n, n)) > 0).sum())
    edges = int((torch.broadcast_to(a_raw, (b, h, n, n)) > 0).sum())
    cluster = (edges if isinstance(spec, SBMSampledSpec) else entries) * 2 * spec.kk
    rkt = entries * 2 * spec.kk
    work = dict(live_entries=live, edges=edges, entries=entries)
    for side, deep in (("q", 6 * dh), ("k", 8 * dh)):
        tc = live * deep + cluster
        work[side] = dict(flops=tc + rkt, tensor_core_flops=tc)
    return work


def bwd_check(mod: str, b: int, n: int, gen, dev, rate: float = RATE,
              variant: str = "plain", floor: float = 0.01, timed: bool = True,
              captured=None, dh: int = 64, bh0: int = 0) -> dict:
    """The two backward passes of the sampled mod (K3/K4) or the expected mod
    (K8/K9) against the plain autograd of ``flex_reference`` on the same
    inputs; the forward's ``out`` and ``lse`` of the same call are held
    against the plain ones too.  ``variant="ties"`` plants exact ties at both
    clip bounds of the expected mod; ``"padded"`` names the run whose short
    rows leave whole key tiles padded (every run of ``_flex_inputs`` has them:
    it is checked).  Without dropout the expected mod's kernel and plain
    results are also held against :func:`expected_closed_form`.  ``captured``
    (from :func:`capture_sbm_inputs`) replaces the random inputs, the output
    cotangent and the graph_sum cotangent with a real batch's; ``dh`` is the
    head width of random inputs, ``bh0`` the batch·head offset of their hash
    streams."""
    from csat_tpu_torch.ops import build, flex_core
    from csat_tpu_torch.ops.mods import exp_adjacency

    if captured is None:
        q, k, v, spec, aux = _flex_inputs(mod, b, n, gen, dev, floor, dh=dh, bh0=bh0)
        dseed = torch.tensor([SEED + 11], dtype=torch.int32, device=dev)
        go = torch.randn(q.shape, generator=gen).to(dev)
        gs = torch.full((b, q.shape[1]), GS_COEF, device=dev)
    else:
        q, k, v, spec, aux, rate, dseed, go, gs = (captured[key] for key in (
            "q", "k", "v", "spec", "aux", "rate", "dseed", "go", "gs"))
        b, n = q.shape[0], q.shape[2]
    sampled = mod == "sbm_sampled"
    if variant == "ties":
        aux = _plant_ties(spec, aux)
        ea = exp_adjacency(aux[0], aux[1])
        floor_t = torch.tensor(spec.floor, device=dev)
        if not ((ea == 0.99).any() and (ea == floor_t).any() and (ea == 0).any()):
            raise AssertionError("the tie input holds no exact tie")

    def run(fn):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, aux[0], aux[1])]
        out, ex = fn(*leaves[:3], spec, (*leaves[3:], *aux[2:]), rate, dseed)
        loss = torch.sum(out * go) + torch.sum(gs * ex["graph_sum"])
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
        closed = expected_closed_form(q, k, v, aux, spec.floor, go, gs)
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
    dh = q.shape[-1]
    CHECKED.update({(q_fn, b, n, dh), (k_fn, b, n, dh), (f"flex_fwd_{mod}", b, n, dh)})
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
        q_fn, q_args, k_fn, k_args, _ = flex_core.bwd_kernel_args(
            spec, q, k, v, aux, lse, dvec, go, gs, rate, dseed)
    lib_q, lib_k = build.kernel(q_fn), build.kernel(k_fn)
    ms_q, ms_k = cuda_ms(lambda: lib_q(*q_args)), cuda_ms(lambda: lib_k(*k_args))
    plain_ms = cuda_ms(lambda: torch.autograd.grad(p_loss, p_leaves, retain_graph=True),
                       **(_plain_reps(n) or dict(reps=5, trials=5)))
    with torch.no_grad():
        work = backward_work(spec, *spec.full_weight(q, k, aux), q.shape[-1])
    inputs = nbytes(q, k, v, *aux, lse, dvec, go, gs)
    recs = {}
    for fn, ms, side, outs in ((q_fn, ms_q, "q", (q, aux[0])), (k_fn, ms_k, "k", (k, v, aux[1]))):
        flops, tc_flops = work[side]["flops"], work[side]["tensor_core_flops"]
        moved = inputs + nbytes(*outs)
        bound, bound_by = bound_ms(moved, flops - tc_flops, tc_flops)
        errs_fn = {key: errs[key] for key in (("dq", "dr") if "_q_" in fn else ("dk", "dv", "dkh"))}
        recs[fn] = dict(kernel=fn, B=b, N=n, dh=dh, rate=rate, variant=variant, floor=spec.floor,
                        bh0=spec.bh0, max_abs_err=max(errs_fn.values()), fwd_max_abs_err=fwd_err,
                        lse_max_abs_err=lse_err, closed_form_errs=closed_errs,
                        grad_errs=errs_fn, tol=f"{GRAD_TOL} (1 + |plain|)", flips=flips,
                        near_draws=int(near.sum()), ms=ms, plain_ms=plain_ms,
                        plain_is="the whole plain backward (both passes)", library_ms=None,
                        bound_ms=bound, bound_by=bound_by, live_entries=work["live_entries"],
                        edges=work["edges"], entries=work["entries"], flops=flops,
                        tensor_core_flops=tc_flops, bytes=moved,
                        inputs="random" if captured is None else captured["inputs"])
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


def capture_decode_inputs(cfg, samples, budgets, device="cuda") -> dict:
    """The arguments of one self-attention and one cross-attention K5 launch
    from the middle of the serving drain of ``samples`` (the serve phase's
    requests, the flagship model from ``SEED`` on the card): real page pools,
    tables, masks, widths and merged lanes.  A first drain counts each side's
    launches; a second, from a fresh engine, keeps the middle one of each."""
    from csat_tpu_torch.models import CSATrans, components
    from csat_tpu_torch.serve import ServeEngine

    model = CSATrans(cfg, SRC_VOCAB, TGT_VOCAB, device=device, seed=SEED)
    inner = components.paged_attend
    calls, keep, got = {"self": 0, "cross": 0}, {}, {}

    def recorder(q, pages_k, pages_v, scale_k, scale_v, table, mask, width, *, idx=None,
                 k_tok=None, v_tok=None):
        side = "cross" if idx is None else "self"
        if calls[side] == keep.get(side):
            copy = lambda t: t.detach().clone().contiguous()
            merge = {} if idx is None else dict(idx=copy(idx.to(torch.int32)),
                                                k_tok=copy(k_tok.float()),
                                                v_tok=copy(v_tok.float()))
            got[side] = dict(inputs=[copy(q.float()), *(copy(t) for t in (
                pages_k, pages_v, scale_k, scale_v, table, mask)), width], merge=merge,
                call=calls[side], of=keep[side] * 2)
        calls[side] += 1
        return inner(q, pages_k, pages_v, scale_k, scale_v, table, mask, width, idx=idx,
                     k_tok=k_tok, v_tok=v_tok)

    components.paged_attend = recorder
    try:
        for _ in range(2):
            engine = ServeEngine(model, cfg, device=device)
            for sample, budget in zip(samples, budgets):
                engine.submit(sample, budget)
            engine.drain()
            if not keep:
                keep = {side: n // 2 for side, n in calls.items()}
                calls = {side: 0 for side in calls}
    finally:
        components.paged_attend = inner
    return got


def capture_prefill_inputs(cfg, samples, budgets, device="cuda", layer: str = "cse") -> dict:
    """The arguments of the flex launch in the first CSE layer (K1; ``layer=
    "sbm"``: the first SBM layer, K2) of the serving drain's largest prefill
    group (most nodes, then most requests) for ``samples`` (a serve path's
    requests, ``cfg``'s model from ``SEED`` on the card): q, k, v, and the
    projected tables and the group's own distances and masks (K1) or its
    cluster factors and padding (K2)."""
    from csat_tpu_torch.models import CSATrans, cse, sbm
    from csat_tpu_torch.serve import ServeEngine

    module, n_layers = (cse, cfg.num_layers) if layer == "cse" else (sbm, cfg.sbm_layers)
    model = CSATrans(cfg, SRC_VOCAB, TGT_VOCAB, device=device, seed=SEED)
    inner = module.flex_attention
    got, shapes = {}, []

    def recorder(q, k, v, spec, aux, *args, **kwargs):
        key = (q.shape[2], q.shape[0])
        shapes.append(key)
        if key > got.get("key", (0, 0)):  # strictly larger: the group's first layer
            copy = lambda t: t.detach().clone().contiguous()
            got.update(key=key, q=copy(q), k=copy(k), v=copy(v), spec=spec,
                       aux=tuple(copy(t) for t in aux))
        return inner(q, k, v, spec, aux, *args, **kwargs)

    module.flex_attention = recorder
    try:
        engine = ServeEngine(model, cfg, device=device)
        for sample, budget in zip(samples, budgets):
            engine.submit(sample, budget)
        engine.drain()
    finally:
        module.flex_attention = inner
    n, b = got.pop("key")
    groups = len(shapes) // n_layers
    return dict(got, rate=0.0, dseed=None,
                inputs=f"{cfg.name} serve prefill, largest of {groups} groups (B {b}, N {n}), "
                       f"first {layer.upper()} layer")


def paged_check(dtype, side: str, gen, dev, captured=None) -> dict:
    """K5 against its plain version: on random ragged chains of ``dtype``
    pages, or on ``captured`` (from :func:`capture_decode_inputs`)."""
    from csat_tpu_torch.ops import build, paged_decode as pd

    if captured is None:
        inputs, merge, lens = _paged_inputs(dtype, side, gen, dev)
    else:
        inputs, merge = captured["inputs"], captured["merge"]
        lens = (~inputs[6]).sum(dim=1).tolist()
    q, pk, pv, sk, sv, table, mask, width = inputs
    out, skipped = pd.paged_attend(*inputs, **merge)
    ref, ref_skip = pd._attend_reference(*inputs, merge.get("idx"), merge.get("k_tok"),
                                         merge.get("v_tok"))
    torch.cuda.synchronize()
    # rows the engine reads: a row with an admissible lane, unless its table
    # row is all NULL_PAGE — a slot that finished this drain nulls its own
    # tables while its mask stays; on a NULL lane the kernel reads zeros and
    # the plain path the null page, which frozen rows write (by design, and
    # the engine discards both rows)
    nulled = ~mask.all(dim=1) & ~(table != pd.NULL_PAGE).any(dim=1)
    live = ~mask.all(dim=1) & ~nulled
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
    rec = dict(kernel="paged_decode", side=side, dtype=str(pk.dtype).replace("torch.", ""),
               width=width, chain_lens=lens, max_abs_err=err, tol=PAGED_TOL,
               skipped=int(skipped[:, 0].sum()), skip_equal=skip_equal, ms=ms,
               plain_ms=plain_ms, library_ms=None, bound_ms=bound, bound_by=bound_by,
               lanes=lanes, flops=flops, bytes=moved, rows_compared=int(live.sum()),
               rows_nulled=int(nulled.sum()),
               inputs="random" if captured is None else
               f"serve drain, {side} launch {captured['call']} of {captured['of']}")
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


def graph_checks(dev) -> dict:
    """K7 where the config's default path runs it, timed at each shape: every
    bucket of the plan at rate 0.2 (train steps) and at rate 0 (the eval
    encoder), B 4 / N 150 at rate 0, and what the first SBM layer of a
    ``noise_mode="shared"`` training step on the train phase's batch gives it
    (its graph, padding, dropout seed).  Its own generator: these inputs do
    not depend on the checks run before."""
    from csat_tpu_torch.configs import get_config

    gen = torch.Generator().manual_seed(SEED + 3)
    recs = {f"{b}x{n}@{rate}": flex_check("sbm_graph", b, n, gen, dev, rate=rate)
            for b, n in plan_shapes() for rate in (RATE, 0.0)}
    recs["4x150@0.0"] = flex_check("sbm_graph", 4, 150, gen, dev, rate=0.0)
    cfg = get_config("python")  # the defaults: the shared graph
    first_sbm = capture_sbm_inputs(cfg, train_batch(cfg, TRAIN_B))[0]
    recs["train_batch"] = flex_check("sbm_graph", TRAIN_B, 150, gen, dev, captured=first_sbm)
    return recs


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
    # the training path: B 64, N 150 (the flagship bucket at batch_size);
    # K7's checks are graph_checks'
    sampled = flex_check("sbm_sampled", TRAIN_B, 150, gen, dev)
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
    # every kernel is timed there too
    flex_check("sbm_expected", TRAIN_B, 150, gen, dev)
    bwd_check("sbm_expected", 4, 150, gen, dev, rate=0.0, variant="ties", floor=0.0)
    for b, n in plan_shapes():
        if (b, n) == (TRAIN_B, 150):
            continue
        for mod in ("cse", "sbm_expected", "sbm_sampled"):
            flex_check(mod, b, n, gen, dev)
        bwd_check("sbm_sampled", b, n, gen, dev)
        bwd_check("sbm_expected", b, n, gen, dev, rate=0.0)
    # K1 on the train phase's batch (ASTs of 20-150 nodes padded to 150):
    # real distances, most entries masked, as the train and fit paths give it
    cfg = get_config("python", noise_mode="counter")
    batch = train_batch(cfg, TRAIN_B)
    rel_mask = (torch.stack([batch.L, batch.T], dim=1).to(torch.int32).contiguous(),
                torch.stack([batch.L_mask, batch.T_mask], dim=1).contiguous())
    cse_real = flex_check("cse", TRAIN_B, 150, gen, dev, rel_mask=rel_mask)
    # K6 and K3/K4 on what the first SBM layer of a training step on that
    # batch gives them: its factors, padding, seeds and cotangents
    first_sbm = capture_sbm_inputs(cfg, batch)[0]
    sampled_real = flex_check("sbm_sampled", TRAIN_B, 150, gen, dev, captured=first_sbm)
    bwd_real = bwd_check("sbm_sampled", TRAIN_B, 150, gen, dev, captured=first_sbm)
    del first_sbm
    # K8/K9 on what the first SBM layer of the expected_grad phase's forward
    # (deterministic, eval_graph="expected") gives them, with its cotangents
    exp_cfg = get_config("python", eval_graph="expected")
    first_exp = capture_sbm_inputs(exp_cfg, train_batch(exp_cfg, TRAIN_B), deterministic=True)[0]
    bwd_exp_real = bwd_check("sbm_expected", TRAIN_B, 150, gen, dev, captured=first_exp)
    del first_exp
    # K5 on one self-attention and one cross-attention launch from the middle
    # of the serve phase's drain
    serve_cfg = flagship()
    decode = capture_decode_inputs(serve_cfg, *make_requests(serve_cfg))
    paged_real = {side: paged_check(None, side, gen, dev, captured=decode[side])
                  for side in ("self", "cross")}
    # K1 on the first CSE layer of the drain's largest prefill group: real
    # ASTs' distances and masks at a serving batch size
    cse_serve = flex_check("cse", 0, 0, gen, dev,
                           captured=capture_prefill_inputs(serve_cfg, *make_requests(serve_cfg)))
    graph = graph_checks(dev)
    variant = variant_checks(dev)
    precision = precision_checks(dev)
    long = long_checks(dev)
    parallel = parallel_checks(dev)
    tensor = tensor_checks(dev)
    return {"flex_fwd_cse": flex[("cse", 4, 150)],
            **variant, **precision, **long, **parallel, **tensor,
            "flex_fwd_cse@train": cse_train,
            "flex_fwd_cse@train_batch": cse_real,
            "flex_fwd_cse@serve": cse_serve,
            **{f"{fn}@train_batch": rec for fn, rec in bwd_real.items()},
            **{f"{fn}@expected_grad_batch": rec for fn, rec in bwd_exp_real.items()},
            "flex_fwd_sbm_expected": flex[("sbm_expected", 4, 150)],
            "flex_fwd_sbm_sampled": sampled,
            "flex_fwd_sbm_sampled@train_batch": sampled_real,
            "flex_fwd_sbm_graph": graph["train_batch"],
            **bwd, **bwd_exp,
            "paged_decode": paged[(torch.float32, "cross")],
            **{f"paged_decode@serve_{side}": rec for side, rec in paged_real.items()}}


def serve_shapes(cfg):
    """(B, N) of every prefill group the serving engine can form at ``cfg``:
    each bucket of its prefill ladder, from one request to its batch size."""
    from csat_tpu_torch.serve.prefill import prefill_plan

    return sorted({(b, spec.n) for spec in prefill_plan(cfg)
                   for b in range(1, spec.batch_size + 1)})


def variant_checks(dev) -> dict:
    """The kernels where the variants phase runs them.  Checked only: K1
    (dh 64) and K2 (dh 64 and 96) at every prefill group the serve ladder
    can form, K7 at rate 0.2 and K1 at the python variants' train batch (B
    16).  Checked and timed at java's SBM width, dh 96: K2 at B 4 and K7 at
    B 64 (rate 0.2) on random inputs of the dh-64 records' shapes, and on
    java's own inputs — K2 on the first SBM layer of its serving drain's
    largest prefill group, K7 on the first SBM layer of a shared-noise
    training step at B 64 (its graph, padding and dropout seed)."""
    from csat_tpu_torch.configs import get_config

    gen = torch.Generator().manual_seed(SEED + 5)
    for b, n in serve_shapes(flagship()):
        for mod, dh in (("cse", 64), ("sbm_expected", 64), ("sbm_expected", 96)):
            if (f"flex_fwd_{mod}", b, n, dh) not in CHECKED:
                flex_check(mod, b, n, gen, dev, timed=False, dh=dh)
    b_py = {b for name, b, _ in VARIANTS if name.startswith("python")}
    for b in b_py:
        flex_check("sbm_graph", b, 150, gen, dev, timed=False, rate=RATE)
        flex_check("cse", b, 150, gen, dev, timed=False)
    # beside the dh-64 records of kernel_phase: the same random shapes at dh 96
    k2_random = flex_check("sbm_expected", 4, 150, gen, dev, dh=96)
    k7_random = flex_check("sbm_graph", TRAIN_B, 150, gen, dev, rate=RATE, dh=96)
    java = get_config("java", eval_graph="expected", serve_slots=8)
    n_java = dict((name, n) for name, _, n in VARIANTS)["java"]
    k2 = flex_check("sbm_expected", 0, 0, gen, dev, captured=capture_prefill_inputs(
        java, *make_requests(java, n_java), layer="sbm"))
    java_train = get_config("java")
    first_sbm = capture_sbm_inputs(java_train, train_batch(java_train, TRAIN_B))[0]
    first_sbm["inputs"] = "java train batch"
    k7 = flex_check("sbm_graph", TRAIN_B, 150, gen, dev, captured=first_sbm)
    # java's counter-mode step gate and expected-graph gradient: K6, K3/K4
    # and K8/K9 at dh 96 on random inputs of the dh-64 records' shapes and on
    # java's own — the first SBM layer of a counter step and of the
    # deterministic expected-graph forward on its train batch (drawn after
    # the inputs above, which stay as they were)
    k6_random = flex_check("sbm_sampled", TRAIN_B, 150, gen, dev, dh=96)
    k34_random = bwd_check("sbm_sampled", TRAIN_B, 150, gen, dev, dh=96)
    flex_check("sbm_expected", TRAIN_B, 150, gen, dev, dh=96)  # the gradient's forward
    k89_random = bwd_check("sbm_expected", TRAIN_B, 150, gen, dev, rate=0.0, dh=96)
    java_counter = get_config("java", noise_mode="counter")
    first_sbm = capture_sbm_inputs(java_counter, train_batch(java_counter, TRAIN_B))[0]
    first_sbm["inputs"] = "java train batch, counter"
    k6 = flex_check("sbm_sampled", TRAIN_B, 150, gen, dev, captured=first_sbm)
    k34 = bwd_check("sbm_sampled", TRAIN_B, 150, gen, dev, captured=first_sbm)
    java_exp = get_config("java", eval_graph="expected")
    first_sbm = capture_sbm_inputs(java_exp, train_batch(java_exp, TRAIN_B), deterministic=True)[0]
    first_sbm["inputs"] = "java expected_grad batch"
    k89 = bwd_check("sbm_expected", TRAIN_B, 150, gen, dev, captured=first_sbm)
    del first_sbm
    timed = (("K2", "java_serve", k2), ("K2", "random", k2_random),
             ("K7", "java_train", k7), ("K7", "random", k7_random),
             ("K6", "java_train", k6), ("K6", "random", k6_random),
             *((name, inputs, recs[fn]) for inputs, recs in (
                 ("java_train", k34), ("random", k34_random)) for name, fn in (
                 ("K3", "flex_bwd_q_sbm_sampled"), ("K4", "flex_bwd_k_sbm_sampled"))),
             *((name, inputs, recs[fn]) for inputs, recs in (
                 ("java_expected_grad", k89), ("random", k89_random)) for name, fn in (
                 ("K8", "flex_bwd_q_sbm_expected"), ("K9", "flex_bwd_k_sbm_expected"))))
    emit("dh96", **{
        f"{name}@{inputs}": dict(ms=rec["ms"], bound_ms=rec["bound_ms"],
                                 plain_ms=rec["plain_ms"], B=rec["B"], N=rec["N"],
                                 live_entries=rec["live_entries"])
        for name, inputs, rec in timed})
    return {"flex_fwd_sbm_expected@java_serve": k2, "flex_fwd_sbm_graph@java_train": k7,
            "flex_fwd_sbm_expected@dh96": k2_random, "flex_fwd_sbm_graph@dh96": k7_random,
            "flex_fwd_sbm_sampled@java_train": k6, "flex_fwd_sbm_sampled@dh96": k6_random,
            **{f"{fn}@java_train": rec for fn, rec in k34.items()},
            **{f"{fn}@java_expected_grad": rec for fn, rec in k89.items()},
            **{f"{fn}@dh96": rec for fn, rec in (*k34_random.items(), *k89_random.items())}}


def precision_checks(dev) -> dict:
    """K5 on one self- and one cross-attention launch from the middle of each
    serving drain of the precision phase (``PRECISION_SERVES``: bf16 pages
    under bf16 compute, int8 pages under f32 compute): the stored bytes, the
    f32 scales, the tables and merged lanes those drains give it."""
    from csat_tpu_torch.serve.pages import KV_PAGE_DTYPES

    gen = torch.Generator().manual_seed(SEED + 6)  # unused: the inputs are captured
    recs = {}
    for compute, pages in PRECISION_SERVES:
        cfg = flagship().replace(compute_dtype=compute, serve_kv_page_dtype=pages)
        decode = capture_decode_inputs(cfg, *make_requests(cfg))
        for side in ("self", "cross"):
            if decode[side]["inputs"][1].dtype != KV_PAGE_DTYPES[pages]:
                raise AssertionError(f"the {pages} drain stored {decode[side]['inputs'][1].dtype}")
            recs[f"paged_decode@serve_{pages}_{side}"] = paged_check(
                None, side, gen, dev, captured=decode[side])
    return recs


# ---------------------------------------------------------------------------
# phase 4: serve the flagship model
# ---------------------------------------------------------------------------

def flagship():
    from csat_tpu_torch.configs import get_config

    return get_config("python", eval_graph="expected", serve_slots=8)


def make_requests(cfg, n_requests: int = N_REQUESTS):
    from csat_tpu_torch.data.synthetic import random_ast, request_sample

    rng = np.random.default_rng(SEED)
    sizes = np.linspace(20, cfg.max_src_len, n_requests).round().astype(int)
    rng.shuffle(sizes)
    samples = [request_sample(random_ast(rng, int(n)), cfg, SRC_VOCAB) for n in sizes]
    budgets = [BUDGETS[i % len(BUDGETS)] for i in range(n_requests)]
    return samples, budgets


class MarginLog:
    """Wraps ``model.decode_step`` to record, per call, each slot's position
    and the gap between its two largest log-probs, and the first call's
    log-probs (``first``, on the host)."""

    def __init__(self, model):
        self.calls = []
        self.first = None
        inner = model.decode_step

        def decode_step(tok, pos, caches, src_mask, prev_pad):
            log_probs, steps = inner(tok, pos, caches, src_mask, prev_pad)
            if self.first is None:
                self.first = log_probs.detach().to(torch.float32).cpu()
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


@contextlib.contextmanager
def plain_route():
    """Inside the block every kernel wrapper on the card takes its plain
    PyTorch version (``select_impl`` of ``ops/flex_core.py`` and
    ``ops/paged_decode.py`` patched to ``"reference"``); fails if a kernel
    launched there."""
    from csat_tpu_torch.ops import build, flex_core, paged_decode

    saved = flex_core.select_impl, paged_decode.select_impl
    flex_core.select_impl = paged_decode.select_impl = lambda x: "reference"
    before = build.launch_counts()
    try:
        yield
    finally:
        flex_core.select_impl, paged_decode.select_impl = saved
    if build.launch_counts() != before:
        raise AssertionError(f"the plain route launched kernels: {build.launch_counts()}")


def serve(cfg, device: str, samples, budgets, profile: bool = False, plain: bool = False,
          margins: bool = False):
    """``samples`` served by ``cfg``'s model from ``SEED`` on ``device``;
    ``plain`` takes the plain route on the card.  A CPU or plain run (or any
    with ``margins``) logs each step's top-2 log-prob gaps (``MarginLog``)
    and counts time in decode calls, so that admissions name the step they
    happened at."""
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.ops import build
    from csat_tpu_torch.serve import ServeEngine

    model = CSATrans(cfg, SRC_VOCAB, TGT_VOCAB, device=device, seed=SEED)
    log = MarginLog(model) if device == "cpu" or plain or margins else None
    clock = (lambda: len(log.calls)) if log else time.monotonic
    engine = ServeEngine(model, cfg, device=device, clock=clock)
    ids = [engine.submit(s, b) for s, b in zip(samples, budgets)]
    build.reset_launches()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with plain_route() if plain else contextlib.nullcontext():
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
    port = [[k[:80], ms, n] for k, ms, n in by_kernel
            if any(f"(anonymous namespace)::{fn}" in k for fn in PORT_KERNEL_FUNCTIONS)]
    # the matrix products cuBLAS runs (its GEMM and GEMV kernels, by name)
    gemm_ms = sum(ms for k, ms, _ in by_kernel if re.search(r"gemm|gemv|xmma|cutlass", k, re.I))
    return dict(wall_s=wall, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / 1e3 / wall if wall else None,
                gemm_ms=gemm_ms, gemm_share_of_busy=gemm_ms / busy_ms if busy_ms else None,
                top=[[k[:80], ms, n] for k, ms, n in by_kernel[:15]], port_kernels=port)


def compare_tokens(results, ref, label: str, margin: float = TIE_MARGIN):
    """Each request's tokens in ``results`` equal to those of ``ref`` (a
    :func:`serve` run with a ``MarginLog``) up to the first step where the
    reference's top-2 log-prob gap is below ``margin`` (a near tie may
    resolve either way under rounding).  Returns ``(requests cut at a near
    tie, tokens compared)``."""
    mismatched, ties, compared = [], 0, 0
    for g, c in zip(results, ref["results"]):
        if not c.ok:
            raise AssertionError(f"request {c.id} not OK on the reference run ({label})")
        gaps = ref["log"].margins(c.admit_t, c.slot, len(c.tokens))
        upto = next((j for j, gap in enumerate(gaps) if gap < margin), None)
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
        raise AssertionError(f"{label} tokens differ for requests {mismatched}")
    return ties, compared


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
    ties, compared = compare_tokens(gpu["results"], cpu, "card and CPU")
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
        smoke_tokens_per_s=n_tokens / gpu["seconds"], ticks=eng.ticks,
        decode_steps=eng.stats.decode_steps, prefills=eng.prefills,
        launches=gpu["counts"], launches_per_request={
            fn: c / len(samples) for fn, c in gpu["counts"].items()},
        cpu_seconds=cpu["seconds"], cpu_tokens_equal=True, near_ties=ties, tokens_compared=compared,
        tie_margin=TIE_MARGIN, profile=gpu["trace"])
    emit("serve", **rec)
    return rec


# ---------------------------------------------------------------------------
# phase 5: train the flagship model
# ---------------------------------------------------------------------------

def train_batch(cfg, b: int, device: str = "cuda"):
    """``b`` synthetic ASTs spread over 20..max_src_len nodes with random
    summaries, collated at the flagship width onto ``device`` (the card)."""
    from csat_tpu_torch.data.dataset import batch_to_device, collate
    from csat_tpu_torch.data.synthetic import random_ast, train_sample

    rng = np.random.default_rng(SEED + 1)
    sizes = np.linspace(20, cfg.max_src_len, b).round().astype(int)
    rng.shuffle(sizes)
    samples = [train_sample(random_ast(rng, int(n)), cfg, SRC_VOCAB, TGT_VOCAB, rng)
               for n in sizes]
    arrs = {key: np.stack([s[key] for s in samples]) for key in samples[0]}
    return batch_to_device(collate(arrs, cfg.max_src_len), torch.device(device))


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed_step(step, state, batch):
    sync()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    sync()
    return state, metrics, time.perf_counter() - t0


def trainer(cfg, model=None, device="cuda"):
    """(model, train state, train step) at ``cfg``: a fresh full-width model
    from ``SEED`` unless ``model`` is given."""
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.train import create_train_state, default_optimizer, make_train_step

    model = model or CSATrans(cfg, SRC_VOCAB, TGT_VOCAB, device=device, seed=SEED)
    opt = default_optimizer(cfg)
    return model, create_train_state(model, opt, SEED), make_train_step(model, opt, cfg)


@contextlib.contextmanager
def flex_launches():
    """Records (forward kernel, B, N, dropout rate, dh, q.requires_grad) of
    every flex forward launch made inside the block: a train step's q requires
    grad, the eval decode's does not (``train/decode.py`` runs under
    ``no_grad``)."""
    from csat_tpu_torch.ops import flex_core

    inner, got = flex_core._kernel_fwd, []

    def recorder(spec, q, k, v, aux, rate, dseed):
        got.append((f"flex_fwd_{spec.name}", q.shape[0], q.shape[2], rate, q.shape[3],
                    q.requires_grad))
        return inner(spec, q, k, v, aux, rate, dseed)

    flex_core._kernel_fwd = recorder
    try:
        yield got
    finally:
        flex_core._kernel_fwd = inner


@contextlib.contextmanager
def paged_launches():
    """Counts K5's launches inside the block by the storage dtype of the
    pages it read."""
    from csat_tpu_torch.ops import paged_decode

    inner, got = paged_decode._attend_kernel, {}

    def recorder(q, pages_k, *rest):
        key = str(pages_k.dtype).replace("torch.", "")
        got[key] = got.get(key, 0) + 1
        return inner(q, pages_k, *rest)

    paged_decode._attend_kernel = recorder
    try:
        yield got
    finally:
        paged_decode._attend_kernel = inner


def _check_launched(path: str, counts) -> None:
    idle = [fn for fn in PATH_KERNELS[path] if counts[fn] <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on the {path} path: {idle}")


def _head_dim(fn: str, cfg) -> int:
    """The head width ``cfg`` gives flex kernel ``fn``: the CSE's (pegen
    width over the heads) for K1, the SBM encoder's for the others."""
    return cfg.pegen_dim // cfg.num_heads if fn == "flex_fwd_cse" else cfg.head_dim


def _check_shapes(path: str, shapes, cfg, kernels=None) -> None:
    """Every (B, N) the path gave its flex kernels (``kernels``, default the
    path's) must be one at which phase 3 held them against their plain
    versions, at ``cfg``'s head widths."""
    missing = sorted((fn, b, n, _head_dim(fn, cfg)) for fn in kernels or PATH_KERNELS[path]
                     if fn.startswith("flex_") for b, n in shapes
                     if (fn, b, n, _head_dim(fn, cfg)) not in CHECKED)
    if missing:
        raise AssertionError(f"the {path} path ran kernels at shapes phase 3 did not check: "
                             f"{missing}")


def _check_rates(path: str, launched) -> None:
    """Every (forward kernel, B, N, dropout rate, dh) the path launched
    (:func:`flex_launches`) must be one phase 3 held against its plain
    version."""
    missing = sorted({rec[:5] for rec in launched} - CHECKED_RATES)
    if missing:
        raise AssertionError(f"the {path} path ran forward kernels at shapes or rates phase 3 "
                             f"did not check: {missing}")


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


def step_gate(cfg, batch, device="cuda", err_file=None, loss_rtol: float = LOSS_RTOL,
              gnorm_rtol: float = GNORM_RTOL):
    """One train step through the kernels and one through the plain paths
    (``flex_core.select_impl`` patched to ``"reference"``) from the same
    weights, generator state (so the same noise) and batch: loss within
    ``loss_rtol`` and global grad-norm within ``gnorm_rtol``, relative.
    Every parameter's max abs gradient error goes to ``OUT_DIR / err_file``
    when one is named.  Returns ``(model, state, step, metrics, launches,
    record)`` of the kernel side, after its step."""
    from csat_tpu_torch.ops import build, flex_core

    model, state, step = trainer(cfg, device=device)
    plain_model, plain_state, plain_step = trainer(cfg, copy.deepcopy(model), device)
    build.reset_launches()
    state, m_k, first_s = timed_step(step, state, batch)
    counts = build.launch_counts()
    select = flex_core.select_impl
    flex_core.select_impl = lambda x: "reference"
    try:
        build.reset_launches()
        plain_state, m_p, plain_s = timed_step(plain_step, plain_state, batch)
    finally:
        flex_core.select_impl = select
    if any(build.launch_counts().values()):
        raise AssertionError(f"the plain step launched kernels: {build.launch_counts()}")
    loss_rel = abs(float(m_k["loss"]) - float(m_p["loss"])) / abs(float(m_p["loss"]))
    gnorm_rel = abs(float(m_k["grad_norm"]) - float(m_p["grad_norm"])) / float(m_p["grad_norm"])
    grad_err = {name: [(p.grad - pp.grad).abs().max().item(), pp.grad.abs().max().item()]
                for (name, p), (_, pp) in zip(model.named_parameters(),
                                              plain_model.named_parameters())}
    if err_file:
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / err_file).write_text(json.dumps(
            {"columns": ["max_abs_err", "plain_max_abs_grad"], "params": grad_err}, indent=1))
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1][0])[:5]
    # edges the two steps' graphs differ by, net: the graphs see inputs that
    # differ by rounding (K1 against the plain CSE upstream), so draws within
    # that rounding of their threshold may flip between steps
    edges = batch.src_seq.shape[0] * cfg.max_src_len ** 2 * cfg.num_heads * cfg.sbm_layers
    step_flips = abs(float(m_k["sparsity"]) - float(m_p["sparsity"])) * edges
    grad_err = {name: err for name, (err, _) in grad_err.items()}
    if not (loss_rel <= loss_rtol and gnorm_rel <= gnorm_rtol
            and all(np.isfinite(list(grad_err.values())))):
        raise AssertionError(f"{cfg.noise_mode}: kernel vs plain step: loss rel {loss_rel}, "
                             f"grad-norm rel {gnorm_rel}, worst grads {worst}")
    rec = dict(kernel_loss=float(m_k["loss"]), plain_loss=float(m_p["loss"]), loss_rel=loss_rel,
               loss_rtol=loss_rtol, kernel_grad_norm=float(m_k["grad_norm"]),
               plain_grad_norm=float(m_p["grad_norm"]), grad_norm_rel=gnorm_rel,
               grad_norm_rtol=gnorm_rtol, grad_max_abs_err=max(grad_err.values()),
               worst_grad_errs=worst, kernel_sparsity=float(m_k["sparsity"]),
               plain_sparsity=float(m_p["sparsity"]), net_graph_edges_apart=step_flips,
               plain_step_s=plain_s, first_step_s=first_s)
    return model, state, step, m_k, counts, rec


def _gate_leaves(spec, aux):
    """The gradient names and the differentiable ``aux`` entries of a
    same-graph gate: the factors R, K̂ of the sampled mod, the graph itself of
    the graph mod (its cotangent flows back through the STE)."""
    from csat_tpu_torch.ops.mods import SBMGraphSpec

    if isinstance(spec, SBMGraphSpec):
        return ("dq", "dk", "dv", "dgraph"), 1
    return GRAD_NAMES, 2


def same_graph_gate(cfg, batch, device="cuda", deterministic: bool = False) -> dict:
    """Each SBM layer's kernels against the plain forward and its autograd on
    the inputs and cotangents that layer got in one kernel forward and
    backward on ``batch`` — a training step in counter mode: K6 forward, K3/K4
    backward, the graph drawn in one fixed order on both paths; in shared
    mode: K7 forward and the recomputed plain backward, the graph an input;
    with ``deterministic`` under ``eval_graph="expected"`` (the
    ``expected_grad`` phase's forward): K2 forward, K8/K9 backward, nothing
    drawn.  So both see the same graph and only the arithmetic differs: no
    edge may be apart (net, per (batch, head); for the expected mod,
    graph_sum within ``SAME_GRAPH_GSUM_RTOL``), the output must agree within
    ``SAME_GRAPH_OUT_RTOL`` and every gradient (q, k, v and R, K̂ or the
    graph) within ``SAME_GRAPH_GRAD_RTOL``, relative in L2 norm.  Every
    layer is read before the gate fails."""
    from csat_tpu_torch.ops import flex_core
    from csat_tpu_torch.ops.mods import SBMExpectedSpec

    rel = lambda a, w: (torch.linalg.vector_norm(a - w) / torch.linalg.vector_norm(w)).item()
    layers = []
    captured = capture_sbm_inputs(cfg, batch, device, layers=cfg.sbm_layers,
                                  deterministic=deterministic)
    for i, cap in enumerate(captured):
        q, k, v, spec, aux, rate, dseed, go, gs = (cap[key] for key in (
            "q", "k", "v", "spec", "aux", "rate", "dseed", "go", "gs"))
        names, n_diff = _gate_leaves(spec, aux)

        def run(fn):
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, *aux[:n_diff])]
            out, ex = fn(*leaves[:3], spec, (*leaves[3:], *aux[n_diff:]), rate, dseed)
            loss = torch.sum(out * go) + torch.sum(gs * ex["graph_sum"])
            grads = torch.autograd.grad(loss, leaves)
            return out.detach(), ex["graph_sum"].detach(), loss.item(), grads

        k_out, k_gs, k_loss, k_grads = run(flex_core.flex_attention)
        p_out, p_gs, p_loss, p_grads = run(flex_core.flex_reference)
        rec = dict(layer=i, mod=spec.name, out_rel=rel(k_out, p_out),
                   loss_rel=abs(k_loss - p_loss) / abs(p_loss),
                   grad_rel={name: rel(a, w) for name, a, w in zip(names, k_grads, p_grads)})
        if isinstance(spec, SBMExpectedSpec):
            rec.update(graph_sum=p_gs.sum().item(), graph_sum_rel=rel(k_gs, p_gs))
            graph_ok = rec["graph_sum_rel"] <= SAME_GRAPH_GSUM_RTOL
        else:
            rec.update(edges=int(p_gs.sum()), edges_apart=int((k_gs - p_gs).abs().sum()),
                       near_draws=int(_near_draws(q, spec, aux).sum()))
            graph_ok = rec["edges_apart"] == 0
        rec["ok"] = bool(graph_ok and rec["out_rel"] <= SAME_GRAPH_OUT_RTOL
                         and max(rec["grad_rel"].values()) <= SAME_GRAPH_GRAD_RTOL)
        layers.append(rec)
    res = dict(layers=layers, out_rtol=SAME_GRAPH_OUT_RTOL, grad_rtol=SAME_GRAPH_GRAD_RTOL)
    if deterministic:
        res["graph_sum_rtol"] = SAME_GRAPH_GSUM_RTOL
    if not all(rec["ok"] for rec in layers):
        raise AssertionError(f"same-graph gate: {res}")
    return res


def more_steps(step, state, batch, first_loss: float, counts: dict, n: int = TRAIN_STEPS):
    """``n`` more kernel steps on ``batch``: each finite, the last loss below
    the second (the first more step's).  Returns ``(state, record)``; the
    launches of these steps are added to ``counts``."""
    from csat_tpu_torch.ops import build

    build.reset_launches()
    losses, times = [first_loss], []
    for _ in range(n):
        state, m, seconds = timed_step(step, state, batch)
        if bool(m["nonfinite"]) or not np.isfinite(float(m["loss"])):
            raise AssertionError(f"non-finite train step: {m}")
        losses.append(float(m["loss"]))
        times.append(seconds)
    steps_counts = build.launch_counts()
    counts = {fn: counts[fn] + steps_counts[fn] for fn in counts}
    if not losses[-1] < losses[1]:
        raise AssertionError(f"loss did not fall over {n} steps: {losses}")
    n_steps = 1 + n
    return state, dict(losses=losses, step_s=times, step_s_median=statistics.median(times[1:]),
                       launches=counts,
                       launches_per_step={fn: c / n_steps for fn, c in counts.items()})


def _widths(cfg) -> dict:
    return dict(pegen=cfg.pegen_dim, enc=cfg.sbm_enc_dim, hidden=cfg.hidden_size,
                heads=cfg.num_heads, cse_layers=cfg.num_layers, sbm_layers=cfg.sbm_layers,
                dec_layers=cfg.decoder_layers, clusters=list(cfg.clusters),
                max_src_len=cfg.max_src_len, max_tgt_len=cfg.max_tgt_len)


def train_phase(profile: bool) -> dict:
    """The counter noise mode (K6, K3, K4): the step gate, the same-graph
    gate, ``TRAIN_STEPS`` more steps, bit-equal backward passes."""
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.ops import build

    cfg = get_config("python", noise_mode="counter")
    batch = train_batch(cfg, cfg.batch_size)
    model, state, step, m_k, counts, gate = step_gate(cfg, batch, err_file="train_grad_err.json")
    same_graph = same_graph_gate(cfg, batch)
    build.reset_launches()  # the gate's launches compare kernels; they do not count
    state, steps = more_steps(step, state, batch, float(m_k["loss"]), counts)
    _check_launched("train_counter", steps["launches"])
    _check_shapes("train_counter", [tuple(batch.src_seq.shape)], cfg)
    repeat = repeatable_backward(model, cfg, batch)
    trace = profile_steps(step, state, batch) if profile else None
    rec = dict(model="python", noise_mode="counter", batch=cfg.batch_size, widths=_widths(cfg),
               vocab=[SRC_VOCAB, TGT_VOCAB], dropout=cfg.dropout,
               attention_dropout=cfg.attention_dropout, learning_rate=cfg.learning_rate,
               **gate, **steps, repeatable_backward=repeat, same_graph=same_graph,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, profile=trace)
    emit("train", **rec)
    return rec


def train_shared_phase(profile: bool) -> dict:
    """The config's default noise mode, ``"shared"``: the uniform noise comes
    from the train state's generator, the graph is sampled through the STE
    and K7 reads it (with K1 in the CSE layers; the graph mod's backward is
    the recomputed plain one).  The step gate, the same-graph gate on each
    SBM layer's own graph, ``TRAIN_STEPS`` more steps, and with ``profile``
    two traced steps."""
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.ops import build

    cfg = get_config("python")
    if cfg.noise_mode != "shared":
        raise AssertionError(f"the python config's default noise mode is {cfg.noise_mode!r}")
    batch = train_batch(cfg, cfg.batch_size)
    with flex_launches() as launched:
        model, state, step, m_s, counts, gate = step_gate(
            cfg, batch, err_file="train_shared_grad_err.json")
    same_graph = same_graph_gate(cfg, batch)
    build.reset_launches()
    with flex_launches() as more:
        state, steps = more_steps(step, state, batch, float(m_s["loss"]), counts)
    _check_launched("train_shared", steps["launches"])
    _check_shapes("train_shared", [tuple(batch.src_seq.shape)], cfg)
    _check_rates("train_shared", launched + more)
    trace = profile_steps(step, state, batch) if profile else None
    rec = dict(model="python", noise_mode=cfg.noise_mode, batch=cfg.batch_size,
               widths=_widths(cfg), vocab=[SRC_VOCAB, TGT_VOCAB],
               attention_dropout=cfg.attention_dropout, **gate, **steps,
               same_graph=same_graph, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               profile=trace)
    emit("train_shared", **rec)
    return rec


# ---------------------------------------------------------------------------
# phase 6: the expected-graph gradient of the whole model
# ---------------------------------------------------------------------------

def expected_grad_gate(cfg, batch, err_file: str, device: str = "cuda"):
    """``model(batch, deterministic=True)`` under ``eval_graph="expected"``,
    ``nll + sw · sparsity``, ``backward()``, through the kernels (K1 or none,
    K2 forward; K8, K9 backward) and through the plain paths on the card from
    the same weights: loss within ``LOSS_RTOL`` and global grad-norm within
    ``GNORM_RTOL``, relative, every parameter's error written to ``OUT_DIR /
    err_file``; the cluster embeddings must get a gradient through the
    graph.  Returns ``(model, grad_pass, launches of the kernel pass,
    record)``."""
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.ops import build, flex_core
    from csat_tpu_torch.resilience.guards import global_norm
    from csat_tpu_torch.train import label_smoothing_loss

    model = CSATrans(cfg, SRC_VOCAB, TGT_VOCAB, device=device, seed=SEED)
    plain_model = copy.deepcopy(model)

    def grad_pass(m):
        sync()
        t0 = time.perf_counter()
        log_probs, sparsity = m(batch, deterministic=True)
        nll = label_smoothing_loss(log_probs, batch.target, cfg.smoothing)
        total = nll + cfg.sw * sparsity
        total.backward()
        sync()
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
    loss_rel = abs(k_total - p_total) / abs(p_total)
    gnorm_rel = abs(k_gnorm - p_gnorm) / p_gnorm
    grad_err = {name: [(p.grad - pp.grad).abs().max().item(), pp.grad.abs().max().item()]
                for (name, p), (_, pp) in zip(model.named_parameters(),
                                              plain_model.named_parameters())}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / err_file).write_text(json.dumps(
        {"columns": ["max_abs_err", "plain_max_abs_grad"], "params": grad_err}, indent=1))
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1][0])[:5]
    finite = all(np.isfinite(err) for err, _ in grad_err.values())
    if not (loss_rel <= LOSS_RTOL and gnorm_rel <= GNORM_RTOL and finite):
        raise AssertionError(f"{cfg.name} expected-graph gradient, kernel vs plain: loss rel "
                             f"{loss_rel}, grad-norm rel {gnorm_rel}, worst grads {worst}")
    graph_grads = [err for name, (err, mx) in grad_err.items() if "clusters" in name and mx > 0]
    if len(graph_grads) != cfg.sbm_layers:
        raise AssertionError("the cluster embeddings got no gradient through the graph")
    rec = dict(kernel_loss=k_total, plain_loss=p_total, loss_rel=loss_rel, loss_rtol=LOSS_RTOL,
               kernel_grad_norm=k_gnorm, plain_grad_norm=p_gnorm, grad_norm_rel=gnorm_rel,
               grad_norm_rtol=GNORM_RTOL,
               grad_max_abs_err=max(err for err, _ in grad_err.values()),
               worst_grad_errs=worst, kernel_pass_s=k_s, plain_pass_s=p_s)
    return model, grad_pass, counts, rec


def expected_grad_phase(profile: bool = False) -> dict:
    """The expected-graph gradient gate (:func:`expected_grad_gate`) on the
    flagship model; then the same-layer gate (:func:`same_graph_gate` on
    this forward's inputs); with ``profile`` one more kernel pass under
    torch.profiler, whose ``port_kernels`` give K8 + K9 device time over
    their launches."""
    from csat_tpu_torch.configs import get_config

    cfg = get_config("python", eval_graph="expected")
    batch = train_batch(cfg, cfg.batch_size)
    model, grad_pass, counts, gate = expected_grad_gate(cfg, batch, "expected_grad_err.json")
    _check_launched("expected_grad", counts)
    _check_shapes("expected_grad", [tuple(batch.src_seq.shape)], cfg)
    # each SBM layer's K2 and K8/K9 against the plain path on its own inputs
    same_layer = same_graph_gate(cfg, batch, deterministic=True)
    trace = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as profiler

        model.zero_grad(set_to_none=True)
        with profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = grad_pass(model)[3]
        trace = _device_summary(prof, wall)
    rec = dict(model="python", eval_graph="expected", batch=cfg.batch_size, **gate,
               launches=counts, same_layer=same_layer, profile=trace)
    emit("expected_grad", **rec)
    return rec


# ---------------------------------------------------------------------------
# phase 7: Trainer.fit at the published widths
# ---------------------------------------------------------------------------

def _by_shape(steps):
    """Per batch shape (B, N, T-1): step count and median seconds (the first
    step of a shape, which pays one-off allocation, left out when it can be).
    The seconds are ``Trainer.fit``'s: the host's time to issue a step, which
    is the whole step only where the guard is read every step (the fit
    phase's ``guard_check_every=1``)."""
    out = {}
    for shape in sorted({tuple(r["shape"]) for r in steps}):
        secs = [r["seconds"] for r in steps if tuple(r["shape"]) == shape]
        out["x".join(map(str, shape))] = dict(
            steps=len(secs), median_s=statistics.median(secs[1:] or secs), first_s=secs[0])
    return out


@contextlib.contextmanager
def fit_corpus():
    """A synthetic corpus in a temporary directory (``FIT_SAMPLES`` train /
    dev / test ASTs of ``FIT_NODES`` nodes), removed afterwards.  Yields
    ``(tmp, data_dir, seconds to make it)``."""
    from csat_tpu_torch.data.synthetic import make_corpus

    tmp = tempfile.mkdtemp(prefix="csat_fit_")
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # keep stdout to the JSON lines
            data_dir = make_corpus(os.path.join(tmp, "corpus"), *FIT_SAMPLES, seed=SEED,
                                   max_ast_len=150, node_range=FIT_NODES)
        yield tmp, data_dir, time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def fit_phase(profile: bool, corpus) -> dict:
    """``Trainer.fit`` in the counter noise mode with the expected eval graph,
    its restored replay and ``run_test``."""
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.dataset import ASTDataset
    from csat_tpu_torch.ops import build
    from csat_tpu_torch.train import Trainer, run_test
    from csat_tpu_torch.train.checkpoint import make_checkpoint_fn

    tmp, data_dir, corpus_s = corpus

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
    _check_shapes("fit", {tuple(r["shape"][:2]) for r in steps} | set(plan_shapes()), cfg)
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


def fit_default_phase(corpus) -> dict:
    """``Trainer.fit`` in the config's own defaults (``noise_mode="shared"``,
    ``eval_graph="sample"``): 2 bucketed epochs at batch 64 with validation
    each epoch under the trainer's eval generator.  Every step finite, the
    epoch loss falling, K1 and K7 launched at every train bucket (K7 at rate
    0.2) and in the eval encoder (K7 at rate 0), each at a shape and rate
    phase 3 checked."""
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.dataset import ASTDataset
    from csat_tpu_torch.ops import build
    from csat_tpu_torch.train import Trainer

    tmp, data_dir, _ = corpus
    cfg = get_config("python", data_dir=data_dir, output_dir=os.path.join(tmp, "run_default"),
                     bucketing=True, num_epochs=FIT_EPOCHS, val_interval=1)
    if (cfg.noise_mode, cfg.eval_graph) != ("shared", "sample"):
        raise AssertionError(f"the python config's defaults are {cfg.noise_mode!r} / "
                             f"{cfg.eval_graph!r}")
    tr = Trainer(cfg, log=lambda msg: None)
    sets = {split: ASTDataset(cfg, split, tr.src_vocab, tr.tgt_vocab) for split in ("train", "dev")}
    build.reset_launches()
    t0 = time.perf_counter()
    with flex_launches() as launched:
        _, hist = tr.fit(sets["train"], sets["dev"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = build.launch_counts()
    steps = hist["steps"]
    if not all(np.isfinite(r["loss"]) for r in steps) or hist["nonfinite_steps"]:
        raise AssertionError(f"non-finite train step in the default fit: {hist['nonfinite_steps']}")
    if not (len(hist["loss"]) == FIT_EPOCHS and hist["loss"][-1] < hist["loss"][0]):
        raise AssertionError(f"default fit: epoch loss did not fall: {hist['loss']}")
    _check_launched("fit_default", counts)
    train_shapes = {tuple(r["shape"][:2]) for r in steps}
    _check_shapes("fit_default", train_shapes | set(plan_shapes()), cfg)
    _check_rates("fit_default", launched)
    by_side = {}
    for fn in PATH_KERNELS["fit_default"]:
        for side, grad, rate in (("train", True, RATE), ("eval", False, 0.0)):
            want_rate = rate if fn == "flex_fwd_sbm_graph" else 0.0
            got = sorted({(b, n) for f, b, n, r, _, g in launched
                          if f == fn and g == grad and r == want_rate})
            by_side[f"{fn}@{side}"] = got
            if not got or (side == "train" and not train_shapes <= set(got)):
                raise AssertionError(f"default fit: {fn} at rate {want_rate} in the {side} "
                                     f"path ran at {got}, train buckets {sorted(train_shapes)}")
    eval_tokens = len(sets["dev"]) * (cfg.max_tgt_len - 1)
    rec = dict(
        model="python", noise_mode=cfg.noise_mode, eval_graph=cfg.eval_graph, bucketing=True,
        batch=cfg.batch_size, epochs=FIT_EPOCHS, samples=list(FIT_SAMPLES[:2]),
        fit_s=fit_s, epoch_loss=hist["loss"], steps=len(steps), by_shape=_by_shape(steps),
        val_bleu=hist["val_bleu"], eval_s=hist["eval_s"], eval_tokens=eval_tokens,
        eval_tokens_per_s=eval_tokens / statistics.median(hist["eval_s"]),
        launches=counts, launch_shapes=by_side)
    emit("fit_default", **rec)
    return rec


# ---------------------------------------------------------------------------
# phase 8: the other encoders — PE variants, full attention, the java width
# ---------------------------------------------------------------------------

def _check_nonblank(where: str, tree_pos, triplet, num_node) -> dict:
    """A batch's tree positions hold ones and its real nodes more than one
    triplet id: a blank field would give a treepos model a zero PE and a
    triplet model one id everywhere."""
    tree_pos, triplet = np.asarray(tree_pos), np.asarray(triplet)
    real = np.arange(triplet.shape[-1])[None, :] < np.asarray(num_node).reshape(-1, 1)
    ids = len(np.unique(triplet.reshape(real.shape)[real]))
    if not tree_pos.any() or ids < 2:
        raise AssertionError(f"{where}: blank PE inputs ({int(tree_pos.sum())} tree-position "
                             f"ones, {ids} distinct triplet ids)")
    return dict(tree_pos_ones=int(tree_pos.sum()), triplet_ids=ids)


def probe_run(model, cfg) -> dict:
    """The RQ2 probe on the card: the post-expansion PE of ``model`` for
    ``PROBE_SAMPLES`` synthetic ASTs, then ``run_probe(hops=3)``; the
    accuracies must be finite (the weights are random: no threshold)."""
    from csat_tpu_torch.data.ast_tools import ast_json_to_tree, tree_to_record, truncate_preorder
    from csat_tpu_torch.data.dataset import batch_to_device, collate
    from csat_tpu_torch.data.synthetic import random_ast, train_sample
    from csat_tpu_torch.probe import extract_pe, run_probe

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 9)
    sizes = np.linspace(20, cfg.max_src_len, PROBE_SAMPLES).round().astype(int)
    asts = [random_ast(rng, int(n)) for n in sizes]
    samples = [train_sample(a, cfg, SRC_VOCAB, TGT_VOCAB, rng) for a in asts]
    records = [tree_to_record(truncate_preorder(ast_json_to_tree(a), cfg.max_src_len))
               for a in asts]
    arrs = {key: np.stack([s[key] for s in samples]) for key in samples[0]}
    batch = batch_to_device(collate(arrs, cfg.max_src_len), torch.device("cuda"))
    pe = extract_pe(model, batch, torch.Generator(device="cuda").manual_seed(SEED))
    res = run_probe(pe, [np.maximum(r.parent_idx, 0) for r in records],
                    [len(r) for r in records], [s["src_seq"] for s in samples], hops=3,
                    epochs=100, device="cuda")
    if not (res["n_pairs"] >= 8 and np.isfinite([res["train_acc"], res["test_acc"]]).all()):
        raise AssertionError(f"probe: {res}")
    return dict(res, samples=PROBE_SAMPLES, pe_shape=list(pe.shape),
                seconds=time.perf_counter() - t0)


def variant_phase(name: str, b: int, n_requests: int) -> dict:
    """One registry config at its published widths and full depth, random
    weights from ``SEED``, in its own defaults (``noise_mode="shared"``):
    the step gate (kernel step against plain step on the card); java adds
    the same-graph gate on each SBM layer (K7 and the plain backward at dh
    96), the python variants ``VARIANT_STEPS`` more steps whose loss must
    fall; then ``n_requests`` requests served with ``eval_graph="expected"``
    through the kernels and through the plain route on the card: all OK, no
    page leak, equal tokens up to a near tie.  The path's kernels must have
    launched (the gate's kernel step, the steps and the kernel drain count),
    every forward launch at a (B, N, rate, dh) phase 3 checked."""
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.models.pe import eigenvectors, padded_laplacian

    t0 = time.perf_counter()
    cfg = get_config(name)
    if cfg.noise_mode != "shared":
        raise AssertionError(f"{name}: default noise mode {cfg.noise_mode!r}")
    batch = train_batch(cfg, b)
    inputs = _check_nonblank(f"{name} train batch", batch.tree_pos, batch.triplet,
                             batch.num_node)
    with flex_launches() as launched:
        model, state, step, m_k, counts, gate = step_gate(cfg, batch,
                                                          err_file=f"{name}_grad_err.json")
    rec = dict(model=name, use_pegen=cfg.use_pegen, full_att=cfg.full_att,
               noise_mode=cfg.noise_mode, batch=b, widths=_widths(cfg), inputs=inputs,
               loss_rel=gate["loss_rel"], grad_norm_rel=gate["grad_norm_rel"],
               kernel_loss=gate["kernel_loss"], grad_max_abs_err=gate["grad_max_abs_err"],
               first_step_s=gate["first_step_s"], plain_step_s=gate["plain_step_s"])
    if cfg.use_pegen == "laplacian":
        # the one eigh a step runs, on this batch's Laplacians
        lap = padded_laplacian(torch.as_tensor(batch.adj, device="cuda"),
                               torch.as_tensor(batch.num_node, device="cuda"))
        rec["eigh_ms_per_step"] = cuda_ms(lambda: eigenvectors(lap), reps=5, trials=5)
    more = []
    if name == "java":
        rec["same_graph"] = same_graph_gate(cfg, batch)
        rec.update(java_gates(cfg, batch, counts, launched))
    else:
        with flex_launches() as more:
            state, steps = more_steps(step, state, batch, float(m_k["loss"]), counts,
                                      n=VARIANT_STEPS)
        counts = steps["launches"]
        rec.update(losses=steps["losses"], step_s_median=steps["step_s_median"])
    if cfg.use_pegen == "treepos":
        rec["probe"] = probe_run(model, cfg)
    del model, state, step

    serve_cfg = get_config(name, eval_graph="expected", serve_slots=8)
    samples, budgets = make_requests(serve_cfg, n_requests)
    _check_nonblank(f"{name} requests", [s["tree_pos"] for s in samples],
                    [s["triplet"] for s in samples], [s["num_node"] for s in samples])
    with flex_launches() as served_launches:
        card = serve(serve_cfg, "cuda", samples, budgets)
    plain = serve(serve_cfg, "cuda", samples, budgets, plain=True)
    for run in (card, plain):
        bad = [r.id for r in run["results"] if not r.ok]
        leaks = run["engine"].page_leaks()
        if bad or leaks:
            raise AssertionError(f"{name} serving: requests not OK {bad}, {leaks} pages leaked")
    ties, compared = compare_tokens(card["results"], plain, f"{name} kernel and plain")
    counts = {fn: counts[fn] + card["counts"][fn] for fn in counts}
    _check_launched(name, counts)
    _check_rates(name, launched + more + served_launches)
    rec.update(requests=n_requests, all_ok=True, page_leaks=0,
               tokens=sum(len(r.tokens) for r in card["results"]), serve_s=card["seconds"],
               plain_serve_s=plain["seconds"], tokens_equal=True, near_ties=ties,
               tokens_compared=compared, launches={fn: c for fn, c in counts.items() if c},
               seconds=time.perf_counter() - t0)
    emit("variant", **rec)
    return rec


def java_gates(cfg, batch, counts: dict, launched: list) -> dict:
    """Java's SBM kernels at dh 96 that its default path leaves out: a
    ``noise_mode="counter"`` step gate with the same-graph gate on each SBM
    layer (K6, K3, K4), and the expected-graph gradient gate with the
    same-layer gate (K2, K8, K9), on java's own train batch, at the python
    gates' limits.  Adds the kernel runs' launches to ``counts`` and their
    forward launches to ``launched``; every one of these kernels must have
    launched, at a shape phase 3 checked."""
    counter = cfg.replace(noise_mode="counter")
    with flex_launches() as got:
        _, _, _, _, c_counts, c_gate = step_gate(counter, batch,
                                                 err_file="java_counter_grad_err.json")
    c_same = same_graph_gate(counter, batch)
    expected = cfg.replace(eval_graph="expected")
    with flex_launches() as got_e:
        _, _, e_counts, e_gate = expected_grad_gate(expected, batch, "java_expected_grad_err.json")
    e_same = same_graph_gate(expected, batch, deterministic=True)
    launched.extend(got + got_e)
    for fn in counts:
        counts[fn] += c_counts[fn] + e_counts[fn]
    b, n = batch.src_seq.shape
    idle = [fn for fn in JAVA_GATE_KERNELS if not (c_counts[fn] or e_counts[fn])]
    unchecked = [fn for fn in JAVA_GATE_KERNELS if (fn, b, n, cfg.head_dim) not in CHECKED]
    if idle or unchecked:
        raise AssertionError(f"java gates: kernels never launched {idle}, unchecked at "
                             f"(B {b}, N {n}, dh {cfg.head_dim}): {unchecked}")
    keep = ("loss_rel", "grad_norm_rel", "kernel_loss", "grad_max_abs_err")
    return dict(counter_gate={k: c_gate[k] for k in keep + ("net_graph_edges_apart",)},
                counter_same_graph=c_same,
                expected_grad_gate={k: e_gate[k] for k in keep},
                expected_same_layer=e_same)


def variants_phase() -> dict:
    t0 = time.perf_counter()
    recs = {name: variant_phase(name, b, n) for name, b, n in VARIANTS}
    emit("variants", seconds=time.perf_counter() - t0, configs=list(recs))
    return recs


# ---------------------------------------------------------------------------
# phase 9: the production precision — bf16 compute, bf16 / int8 KV pages,
# the reference initialisation
# ---------------------------------------------------------------------------

def alternating_step_times(runs: dict, batch, rounds: int = 4) -> dict:
    """Median step seconds of each named ``(step, state)`` in ``runs`` on
    ``batch``, the runs taken in turns (a b, b a, ...) so that neither gets
    the card's quieter moments."""
    names = list(runs)
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            step, state = runs[name]
            state, m, seconds = timed_step(step, state, batch)
            runs[name] = (step, state)
            times[name].append(seconds)
    return {name: dict(median_s=statistics.median(t), step_s=t) for name, t in times.items()}


def precision_phase(profile: bool) -> dict:
    """The flagship ``python`` model at its published widths and full depth
    in the JAX package's production precision, ``compute_dtype="bfloat16"``
    (bf16 layers, f32 attention islands, f32 master weights), on the train
    batch of phases 5-6 (B 64): a kernel step against a plain step in the
    default (shared) noise mode within ``BF16_LOSS_RTOL`` /
    ``BF16_GNORM_RTOL``; the same-graph gate on each SBM layer's f32 inputs
    in both noise modes at the f32 limits; ``TRAIN_STEPS`` more bf16 steps
    whose loss must fall, the parameters still f32; the bf16 and the f32
    step timed in turns (and, with ``profile``, traced: device busy share
    and the GEMMs' share); one step from ``init_scheme="reference"``
    weights; then 16 requests served at each of ``PRECISION_SERVES``
    through the kernels and through the plain route on the card: all OK, no
    page leak, tokens equal up to a near tie (``BF16_TIE`` at bf16
    compute), the first decode step's log-probs within
    ``FIRST_STEP_LOGP_RTOL``, K5's launches counted by the pages' storage
    dtype (the kernel drain logs margins too: its seconds include a host
    read a step)."""
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.models.init import reference_bound
    from csat_tpu_torch.ops import build
    from csat_tpu_torch.serve.pages import KV_PAGE_DTYPES

    t0 = time.perf_counter()
    cfg = get_config("python", compute_dtype="bfloat16")
    if cfg.noise_mode != "shared":
        raise AssertionError(f"the python config's default noise mode is {cfg.noise_mode!r}")
    batch = train_batch(cfg, TRAIN_B)
    with flex_launches() as launched:
        model, state, step, m_k, counts, gate = step_gate(
            cfg, batch, err_file="precision_grad_err.json", loss_rtol=BF16_LOSS_RTOL,
            gnorm_rtol=BF16_GNORM_RTOL)
    if model.dtype != torch.bfloat16:
        raise AssertionError(f"compute_dtype='bfloat16' built a {model.dtype} model")
    same_graph = {mode: same_graph_gate(cfg.replace(noise_mode=mode), batch)
                  for mode in ("shared", "counter")}
    build.reset_launches()
    with flex_launches() as more:
        state, steps = more_steps(step, state, batch, float(m_k["loss"]), counts)
    wrong = sorted({str(p.dtype) for p in state.params.values()} - {"torch.float32"})
    if wrong:
        raise AssertionError(f"master weights left f32: {wrong}")
    counts = steps["launches"]

    # the same batch in f32 and in bf16, in turns
    f32_model, f32_state, f32_step = trainer(get_config("python"))
    times = alternating_step_times({"float32": (f32_step, f32_state), "bfloat16": (step, state)},
                                   batch)
    traces = None
    if profile:
        traces = {"float32": profile_steps(f32_step, f32_state, batch),
                  "bfloat16": profile_steps(step, state, batch)}
    del f32_model, f32_state, f32_step, model, state, step

    # a step from the reference scheme's weights: every redrawn parameter
    # inside its bound
    ref_cfg = cfg.replace(init_scheme="reference")
    ref_model, ref_state, ref_step = trainer(ref_cfg)
    redrawn = {}
    for name, p in ref_model.named_parameters():
        bound = reference_bound(ref_model, name)
        if bound is not None:
            redrawn[name] = [float(p.abs().max()), bound]
            if not 0.5 * bound < float(p.abs().max()) <= bound:
                raise AssertionError(f"reference init: {name} max {redrawn[name][0]}, bound {bound}")
    build.reset_launches()
    with flex_launches() as ref_launched:
        ref_state, m_ref, ref_s = timed_step(ref_step, ref_state, batch)
    if bool(m_ref["nonfinite"]) or not np.isfinite(float(m_ref["loss"])):
        raise AssertionError(f"reference-init step not finite: {m_ref}")
    counts = {fn: c + build.launch_counts()[fn] for fn, c in counts.items()}
    del ref_model, ref_state, ref_step
    _check_launched("precision_train", counts)
    _check_shapes("precision_train", [tuple(batch.src_seq.shape)], cfg)
    _check_rates("precision_train", launched + more + ref_launched)

    served = {}
    paths = {"precision_train": counts}
    for compute, pages in PRECISION_SERVES:
        scfg = flagship().replace(compute_dtype=compute, serve_kv_page_dtype=pages)
        samples, budgets = make_requests(scfg)
        with flex_launches() as s_launched, paged_launches() as by_dtype:
            card = serve(scfg, "cuda", samples, budgets, margins=True)
        plain = serve(scfg, "cuda", samples, budgets, plain=True)
        # the first decode call: the same slots, admitted in the first tick
        first_k, first_p = card["log"].first, plain["log"].first
        first_rel = float(torch.linalg.vector_norm(first_k - first_p)
                          / torch.linalg.vector_norm(first_p))
        if first_rel > FIRST_STEP_LOGP_RTOL[compute]:
            raise AssertionError(f"({compute}, {pages}): first-step log-probs, kernel route "
                                 f"against plain, relative L2 {first_rel}")
        for run in (card, plain):
            bad = [r.id for r in run["results"] if not r.ok]
            leaks = run["engine"].page_leaks()
            if bad or leaks:
                raise AssertionError(f"serving at ({compute}, {pages} pages): requests not OK "
                                     f"{bad}, {leaks} pages leaked")
        stored = card["engine"]._pool.pages[0]["k"].dtype
        if stored != KV_PAGE_DTYPES[pages]:
            raise AssertionError(f"serve_kv_page_dtype={pages!r} allocated {stored} pages")
        margin = BF16_TIE if compute == "bfloat16" else TIE_MARGIN
        ties, compared = compare_tokens(card["results"], plain, f"({compute}, {pages}) kernel "
                                        "and plain", margin=margin)
        path = f"precision_serve_{pages}"
        _check_launched(path, card["counts"])
        _check_rates(path, s_launched)
        if by_dtype != {pages: card["counts"]["paged_decode"]}:
            raise AssertionError(f"K5 launches by storage dtype {by_dtype}, counted "
                                 f"{card['counts']['paged_decode']}")
        paths[path] = card["counts"]
        served[f"{compute}/{pages}"] = dict(
            requests=len(samples), all_ok=True, page_leaks=0, page_dtype=pages,
            tokens=sum(len(r.tokens) for r in card["results"]), serve_s=card["seconds"],
            plain_serve_s=plain["seconds"], first_step_logp_rel=first_rel,
            first_step_logp_max_abs=float((first_k - first_p).abs().max()),
            first_step_logp_rtol=FIRST_STEP_LOGP_RTOL[compute], tokens_equal=True,
            tie_margin=margin,
            near_ties=ties, tokens_compared=compared, paged_decode_by_dtype=by_dtype,
            launches={fn: c for fn, c in card["counts"].items() if c})
    rec = dict(model="python", compute_dtype=cfg.compute_dtype, noise_mode=cfg.noise_mode,
               batch=TRAIN_B, widths=_widths(cfg), **gate, same_graph=same_graph,
               losses=steps["losses"], bf16_step_s_median=steps["step_s_median"],
               alternating_step_s=times, profile=traces,
               reference_init=dict(redrawn=len(redrawn), loss=float(m_ref["loss"]),
                                   step_s=ref_s, max_over_bound=max(
                                       m / b for m, b in redrawn.values())),
               served=served, launches=paths, seconds=time.perf_counter() - t0)
    emit("precision", **rec)
    return rec


# ---------------------------------------------------------------------------
# phase 10: the trainer's resilience and telemetry
# ---------------------------------------------------------------------------

#: the modules a sync the guard made would be issued from
GUARD_MODULES = ("resilience/guards.py", "train/optimizer.py")
#: one corrupt-batch drill's batch ordinals, under a budget of their count
QUARANTINED = (1, 4)
#: the scalar log's cadence in the telemetry drill
SCALAR_EVERY = 2
#: the CLI's SIGTERM: sent once epoch 1's scalar log shows this iteration
PREEMPT_AT_IT = 3
#: the watchdog drills' timeouts, seconds: the host leg in a fit, the device
#: leg against a stream wedged for WEDGE_S
HOST_LEG_S, DEVICE_LEG_S, WEDGE_S = 2.0, 0.5, 2.0


def resilience_trainer(data_dir: str, out: str, device: str = "cuda", log=None, **kw):
    """``(Trainer, train set)``: the ``python`` config in its defaults
    (shared noise, sampled eval graph), bucketed, one epoch, on the corpus at
    ``data_dir``; ``kw`` overrides config fields."""
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.dataset import ASTDataset
    from csat_tpu_torch.train import Trainer

    cfg = get_config("python", **{"data_dir": data_dir, "output_dir": out, "bucketing": True,
                                  "num_epochs": 1, **kw})
    tr = Trainer(cfg, log=log or (lambda msg: None), device=device)
    return tr, ASTDataset(cfg, "train", tr.src_vocab, tr.tgt_vocab)


def _sync_site(stack) -> str:
    """A sync's site: the innermost frame of this repository on its Python
    stack, and the innermost frame of all where that is another."""
    def where(frame):
        path = Path(frame.filename).resolve()
        try:
            return f"{path.relative_to(REPO)}:{frame.lineno}", True
        except ValueError:
            return f"{path.name}:{frame.lineno}", False

    inner = where(stack[-1])[0]
    ours = next((site for site, mine in map(where, reversed(stack)) if mine), inner)
    return ours if ours == inner else f"{ours} (via {inner})"


@contextlib.contextmanager
def counted_syncs():
    """Records every host-device synchronisation inside the block
    (``torch.cuda.set_sync_debug_mode("warn")``), by its site
    (:func:`_sync_site`), in any thread."""
    import traceback
    import warnings

    caught = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stack = [f for f in traceback.extract_stack()[:-1]
                     if Path(f.filename).name != "warnings.py"]
            caught.append(_sync_site(stack))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        caught.clear()  # the block's syncs only
        try:
            yield caught
        finally:
            torch.cuda.set_sync_debug_mode("default")


def _tally(sites) -> dict:
    out = {}
    for site in sites:
        out[site] = out.get(site, 0) + 1
    return out


def step_syncs(tr, ds, steps: int = 3) -> dict:
    """The syncs of train steps between guard reads, step by step and by the
    line that made them, on a batch already on the card; the guard's own (any
    from ``GUARD_MODULES``) fail the gate, and so does any sync of
    ``guarded_apply`` run alone under ``set_sync_debug_mode("error")``."""
    from csat_tpu_torch.data.dataset import batch_to_device
    from csat_tpu_torch.resilience import guarded_apply

    state = tr.init_state()
    batch = batch_to_device(next(iter(tr._train_batches(ds, 1))), tr.device)
    state, m = tr.train_step(state, batch)  # allocations and handles of a first step
    bad = m["bad_steps"]
    sync()
    per_step, sites = [], []
    for _ in range(steps):
        with counted_syncs() as caught:
            state, m = tr.train_step(state, batch, bad_steps=bad)
            bad = m["bad_steps"]
        per_step.append(len(caught))
        sites += caught
    sites = _tally(sites)
    guard_sites = {s: n for s, n in sites.items() if any(g in s for g in GUARD_MODULES)}
    if guard_sites:
        raise AssertionError(f"the guard synchronises with the host: {guard_sites}")
    grads = {k: p.grad for k, p in state.params.items()}
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        guarded_apply(tr.optimizer, state.params, grads, state.opt_state, m["total"], bad)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync()
    return dict(per_step=per_step, sites=sites, guard_syncs=0)


def _copies_state(site: str) -> bool:
    """Whether a sync's site copies train-state tensors to the host (the
    rollback anchor, the best parameters): a line with ``.to("cpu", copy=True)``."""
    import linecache

    path, _, line = site.split(" ")[0].rpartition(":")
    return 'to("cpu", copy=True)' in linecache.getline(str(REPO / path), int(line))


def fit_syncs(tr, ds) -> dict:
    """One epoch of ``Trainer.fit`` (prefetch and guard-check cadence as
    configured) under the sync counter: its syncs by site, and per step
    those that do not copy train-state tensors to the host (the rollback
    anchor at the epoch's start and the best parameters at the end copy one
    tensor at a time)."""
    with counted_syncs() as caught:
        _, hist = tr.fit(ds, None)
    sites = _tally(caught)
    n = len(hist["steps"])
    copies = sum(c for site, c in sites.items() if _copies_state(site))
    return dict(steps=n, syncs=len(caught), state_copy_syncs=copies,
                other_per_step=(len(caught) - copies) / max(1, n), sites=sites)


def _bits(tensors) -> list:
    return [t.detach().reshape(-1).view(torch.int32).clone() for t in tensors]


def check_registry(tr, hist) -> dict:
    """The trainer's registry counters equal its ``history`` counters, and its
    Prometheus text carries their ``TYPE`` lines."""
    snap = tr.registry.snapshot()
    want = {"train_steps_total": len(hist["steps"]), "train_epochs_total": len(hist["loss"]),
            "train_quarantined_total": hist["quarantined"]}
    for key in ("rollbacks", "nonfinite_steps", "step_snapshots"):
        if hist[key]:
            want[f"train_{key}_total"] = hist[key]
    got = {k: snap.get(k) for k in want}
    text = tr.registry.prometheus()
    missing = [k for k in want if f"# TYPE {k} counter" not in text]
    if got != want or missing:
        raise AssertionError(f"registry {got} against history {want}; TYPE lines missing "
                             f"for {missing}")
    return got


def _events(tr) -> list:
    return [name for _, name, _, _ in tr.obs.events()]


def nan_step_drill(data_dir: str, out: str, device: str = "cuda", nan_at: int = 2,
                   watchdog_timeout_s: float = 5.0, **kw) -> dict:
    """A NaN loss at step ``nan_at`` of an epoch with the guard read every
    step and the watchdog's device probe on: the parameters and both moments
    after that step are bitwise those before it, the fit counts one
    non-finite step and records ``fault.nan_guard``, the probe never trips."""
    from csat_tpu_torch.resilience import FaultInjector

    tr, ds = resilience_trainer(data_dir, out, device, guard_check_every=1,
                                watchdog_timeout_s=watchdog_timeout_s,
                                watchdog_device_probe=True, **kw)
    tripped = []
    tr.watchdog_on_timeout = lambda: tripped.append(True)
    tr.fault_injector = FaultInjector(nan_loss_steps=(nan_at,))
    inner, calls, around = tr.train_step, [], {}

    def watched(state, batch, **kwargs):
        tensors = lambda: (list(state.params.values()) + list(state.opt_state.mu.values())
                           + list(state.opt_state.nu.values()))
        if len(calls) == nan_at:
            around["before"] = _bits(tensors())
        state, metrics = inner(state, batch, **kwargs)
        if len(calls) == nan_at:
            around["after"] = _bits(tensors())
            around["nonfinite"] = bool(metrics["nonfinite"])
        calls.append(1)
        return state, metrics

    tr.train_step = watched
    _, hist = tr.fit(ds, None)
    changed = sum(not torch.equal(a, b) for a, b in zip(around["before"], around["after"]))
    if changed or not around["nonfinite"]:
        raise AssertionError(f"NaN step {nan_at}: {changed} of {len(around['before'])} "
                             f"parameter / moment tensors changed, nonfinite "
                             f"{around['nonfinite']}")
    if hist["nonfinite_steps"] != 1 or "fault.nan_guard" not in _events(tr) or tripped:
        raise AssertionError(f"NaN drill: nonfinite_steps {hist['nonfinite_steps']}, events "
                             f"{sorted(set(_events(tr)))}, watchdog tripped {bool(tripped)}")
    return dict(nan_at=nan_at, tensors_unchanged=len(around["before"]),
                nonfinite_steps=hist["nonfinite_steps"], probe_tripped=False,
                steps=len(hist["steps"]), registry=check_registry(tr, hist))


def rollback_drill(data_dir: str, out: str, device: str = "cuda", nan_at=(2, 3, 4),
                   **kw) -> dict:
    """Three consecutive NaN steps, the guard read every step: one rollback
    to the epoch-start snapshot, and the replayed epoch finite."""
    from csat_tpu_torch.resilience import FaultInjector

    tr, ds = resilience_trainer(data_dir, out, device, guard_check_every=1, **kw)
    tr.fault_injector = FaultInjector(nan_loss_steps=nan_at)
    state, hist = tr.fit(ds, None)
    replay = hist["steps"][nan_at[-1] + 1:]
    finite = all(np.isfinite(r["loss"]) for r in replay) and np.isfinite(hist["loss"][0])
    if hist["rollbacks"] != 1 or not finite or "fault.rollback" not in _events(tr):
        raise AssertionError(f"rollback drill: rollbacks {hist['rollbacks']}, epoch loss "
                             f"{hist['loss']}, events {sorted(set(_events(tr)))}")
    return dict(nan_at=list(nan_at), rollbacks=1, nonfinite_steps=hist["nonfinite_steps"],
                replayed_steps=len(replay), epoch_loss=hist["loss"][0], final_step=state.step,
                registry=check_registry(tr, hist))


def _quarantined_chunks(tr) -> list:
    """The sample indices of every batch the error budget quarantined, from
    its log lines in the trainer's flight recorder."""
    return [json.loads(m.group(1)) for _, name, _, fields in tr.obs.events() if name == "log"
            for m in [re.search(r"quarantined malformed batch \(samples (\[[^\]]*\])",
                                fields["msg"])] if m]


def quarantine_drill(data_dir: str, out: str, device: str = "cuda", **kw) -> dict:
    """``QUARANTINED`` corrupt batches under a budget of as many, through the
    prefetch thread in a profiled epoch with the scalar log every
    ``SCALAR_EVERY`` iterations: quarantined on exactly the planned chunks,
    the epoch finishes; one more corrupt batch raises
    ``DataErrorBudgetExceeded``; the scalar log, the registry, the profiler
    trace and ``host_trace.json`` as the telemetry gates want them."""
    from csat_tpu_torch.obs import load_chrome_trace, validate_chrome_trace
    from csat_tpu_torch.resilience import DataErrorBudgetExceeded, FaultInjector

    budget = len(QUARANTINED)
    tr, ds = resilience_trainer(data_dir, out, device, data_error_budget=budget, prefetch=2,
                                profile=True, scalar_log=True, scalar_log_every=SCALAR_EVERY,
                                **kw)
    plan = []
    for i, _ in enumerate(tr._train_batches(ds, 1, batch_hook=lambda c, b: plan.append(
            np.asarray(c).tolist()) or b)):
        pass
    tr.fault_injector = FaultInjector(corrupt_batches=QUARANTINED)
    _, hist = tr.fit(ds, None)
    want = [plan[i] for i in QUARANTINED]
    got = _quarantined_chunks(tr)
    if hist["quarantined"] != budget or got != want or len(hist["steps"]) != len(plan) - budget:
        raise AssertionError(f"quarantine: {hist['quarantined']} batches, chunks {got}, planned "
                             f"{want}, {len(hist['steps'])} steps of {len(plan)} batches")
    with open(os.path.join(tr.output_dir, "scalars.jsonl")) as f:
        its = [r["it"] for r in map(json.loads, f) if "it" in r]
    if its != list(range(0, len(hist["steps"]), SCALAR_EVERY)):
        raise AssertionError(f"scalars.jsonl it records {its}")
    trace_files = os.listdir(os.path.join(tr.output_dir, "trace"))
    host = load_chrome_trace(os.path.join(tr.output_dir, "host_trace.json"))
    errors = validate_chrome_trace(host)
    spans = {e["name"] for e in host["traceEvents"]}
    if not trace_files or errors or not {"train.data", "train.step"} <= spans:
        raise AssertionError(f"profiled epoch: trace {trace_files}, host trace errors "
                             f"{errors[:5]}, spans {sorted(spans)}")
    registry = check_registry(tr, hist)

    over, _ = resilience_trainer(data_dir, out + "_over", device, data_error_budget=budget,
                                 prefetch=2, **kw)
    over.fault_injector = FaultInjector(corrupt_batches=range(budget + 1))
    try:
        over.fit(ds, None)
    except DataErrorBudgetExceeded as e:
        exceeded = str(e)[:160]
    else:
        raise AssertionError("a corrupt batch past the budget did not raise")
    return dict(budget=budget, corrupt_batches=list(QUARANTINED), quarantined_chunks=got,
                steps=len(hist["steps"]), planned_batches=len(plan), scalar_its=its,
                trace_files=sorted(trace_files), host_trace_events=len(host["traceEvents"]),
                phase_s=hist["phase_s"], registry=registry, exceeded=exceeded)


def host_leg_drill(data_dir: str, out: str, device: str = "cuda", hang_at: int = 1,
                   **kw) -> dict:
    """A hung step in a fit (``hang_at``, right after the first beat, so no
    slow step before it can trip the watchdog first): the host leg trips
    within ``HOST_LEG_S``, writes ``watchdog_diagnostics.txt`` and a
    post-mortem holding ``fault.watchdog`` and ``fault.injected.hang``; the
    recording timeout action ends the hang and the epoch finishes."""
    import threading

    from csat_tpu_torch.obs import EventRecorder
    from csat_tpu_torch.resilience import FaultInjector

    tr, ds = resilience_trainer(data_dir, out, device, watchdog_timeout_s=HOST_LEG_S, **kw)
    tripped = threading.Event()
    tr.watchdog_on_timeout = tripped.set
    tr.fault_injector = FaultInjector(hang_at_step=hang_at, hang_seconds=60.0,
                                      sleep=lambda s: tripped.wait(s))
    t0 = time.perf_counter()
    _, hist = tr.fit(ds, None)
    pm = os.path.join(tr.output_dir, "postmortem", "postmortem_train_watchdog.jsonl")
    names = {e["name"] for e in EventRecorder.load(pm)[1]} if os.path.exists(pm) else set()
    diag = os.path.exists(os.path.join(tr.output_dir, "watchdog_diagnostics.txt"))
    if not (tripped.is_set() and diag and {"fault.watchdog", "fault.injected.hang"} <= names):
        raise AssertionError(f"host leg: tripped {tripped.is_set()}, diagnostics {diag}, "
                             f"post-mortem events {sorted(names)}")
    return dict(timeout_s=HOST_LEG_S, hang_at=hang_at, fit_s=time.perf_counter() - t0,
                steps=len(hist["steps"]), postmortem_events=sorted(names))


def device_leg_drill() -> dict:
    """The training stream wedged by ``torch.cuda._sleep`` for ``WEDGE_S``
    while the host keeps beating: the device leg trips (``no completed device
    probe``) before the wedge clears."""
    import threading

    from csat_tpu_torch.resilience import StepWatchdog, device_liveness_probe

    probe = device_liveness_probe("cuda")
    probe()
    tripped, what = threading.Event(), []
    with StepWatchdog(DEVICE_LEG_S, on_timeout=tripped.set, log=lambda m: None, probe=probe,
                      probe_interval_s=0.05, on_trip=lambda w, s: what.append((w, s))) as wd:
        t0 = time.perf_counter()
        # clock64 cycles at up to 2 GHz: at least WEDGE_S; the wedge's real
        # length is measured below
        torch.cuda._sleep(int(WEDGE_S * 2e9))
        beats = 0
        while not tripped.is_set() and time.perf_counter() - t0 < 4 * WEDGE_S:
            wd.beat()
            beats += 1
            time.sleep(0.02)
        tripped_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wedge_s = time.perf_counter() - t0
    if not tripped.is_set() or what[0][0] != "no completed device probe" or tripped_s >= wedge_s:
        raise AssertionError(f"device leg: tripped {tripped.is_set()} ({what}) after "
                             f"{tripped_s:.2f} s of a {wedge_s:.2f} s wedge, {beats} beats")
    return dict(timeout_s=DEVICE_LEG_S, tripped_after_s=tripped_s, wedge_s=wedge_s,
                beats_while_wedged=beats, what=what[0][0])


WATCHDOG_CHILD = """
import time
import torch
from csat_tpu_torch.resilience import StepWatchdog, device_liveness_probe
probe = device_liveness_probe("cuda")
probe()
wd = StepWatchdog(1.0, probe=probe, probe_interval_s=0.1).start()
torch.cuda._sleep(int(1e10))
end = time.monotonic() + 60
while time.monotonic() < end:
    wd.beat()
    time.sleep(0.05)
"""


def cli_args(data_dir: str, out: str, device: str = "cuda", sets=(), epochs: int = 2) -> list:
    """The port's command line training the ``python`` config bucketed on
    ``data_dir`` into ``out``, with every iteration in ``scalars.jsonl``."""
    args = [sys.executable, "-m", "csat_tpu_torch.cli", "--config", "python", "--data_dir",
            data_dir, "--epochs", str(epochs), "--bucketing", "--set", f"output_dir={out!r}",
            "--set", "scalar_log=True", "--set", "scalar_log_every=1", "--set", "val_interval=99"]
    for field, value in dict(sets).items():
        args += ["--set", f"{field}={value!r}"]
    return args + (["--device", device] if device != "cuda" else [])


def _it_losses(out: str) -> list:
    """Every ``it`` record's ``(epoch, loss)`` in a run's ``scalars.jsonl``."""
    path = next(Path(out).rglob("scalars.jsonl"))
    return [(r["epoch"], r["loss"]) for r in map(json.loads, path.read_text().splitlines())
            if "it" in r]


def _reached(out: str, it: int) -> bool:
    for path in Path(out).rglob("scalars.jsonl"):
        lines = path.read_text().split("\n")[:-1]  # complete lines only
        if any(r.get("epoch") == 1 and r.get("it", -1) >= it for r in map(json.loads, lines)):
            return True
    return False


def start_cli_drills(tmp: str, data_dir: str, device: str = "cuda", sets=()) -> dict:
    """Starts the command-line drills, each its own process: an uninterrupted
    run; a run that gets a real SIGTERM once its scalar log shows iteration
    ``PREEMPT_AT_IT`` of epoch 1, followed — as soon as it has exited 75 — by
    a ``--resume`` run in its output dir (a thread watches, signals and
    resumes); and on the card a ``StepWatchdog`` child on its default action
    with its stream wedged."""
    import signal
    import threading

    env = {**os.environ, "PYTHONPATH": str(REPO)}

    def start(args):
        return subprocess.Popen(args, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    outs = {name: os.path.join(tmp, f"cli_{name}") for name in ("uninterrupted", "preempted")}
    procs = {name: start(cli_args(data_dir, out, device, sets)) for name, out in outs.items()}
    if device == "cuda":
        procs["watchdog"] = start([sys.executable, "-c", WATCHDOG_CHILD])
    child, out = procs["preempted"], outs["preempted"]
    done = {}

    def watch():
        while child.poll() is None and not _reached(out, PREEMPT_AT_IT):
            time.sleep(0.01)
        if child.poll() is None:
            child.send_signal(signal.SIGTERM)
        done["preempted"] = (child.wait(),) + child.communicate()
        if done["preempted"][0] == 75:
            done["before"] = _it_losses(out)
            done["resume_t0"] = time.perf_counter()
            done["resumed"] = start(cli_args(data_dir, out, device, sets) + ["--resume"])

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    return dict(procs=procs, outs=outs, done=done, watcher=watcher, t0=time.perf_counter())


def finish_cli_drills(started: dict) -> dict:
    """Waits for the command-line drills and gates them: the preempted run
    exits 75 with the ``preempted`` line, the watchdog child exits 76, and
    the ``--resume`` run completes the preempted one so that its per-step
    losses and the preempted run's are, bit for bit, the uninterrupted
    run's."""
    done, results = started["done"], {}
    try:
        started["watcher"].join(timeout=600)
        for name, proc in list(started["procs"].items()) + [("resumed", done.get("resumed"))]:
            if name != "preempted" and proc is not None:
                stdout, stderr = proc.communicate(timeout=600)
                results[name] = (proc.returncode, stdout, stderr)
    finally:
        for proc in list(started["procs"].values()) + [done.get("resumed")]:
            if proc is not None and proc.poll() is None:
                proc.kill()
    code, stdout, stderr = done.get("preempted", (None, "", ""))
    if code != 75:
        raise AssertionError(f"the preempted CLI exited {code}, not 75: {stderr[-2000:]}")
    stopped = json.loads(stdout.strip().splitlines()[-1])
    if not (stopped.get("preempted") is True and "resume_from" in stopped):
        raise AssertionError(f"the preempted CLI printed {stopped}")
    for name in ("uninterrupted", "resumed"):
        if results[name][0] != 0:
            raise AssertionError(f"the {name} CLI exited {results[name][0]}: "
                                 f"{results[name][2][-2000:]}")
    rec = dict(preempted=stopped, exit_preempted=75)
    if "watchdog" in results:
        code_w, _, err_w = results["watchdog"]
        if code_w != 76 or "no completed device probe" not in err_w:
            raise AssertionError(f"the watchdog child exited {code_w}, not 76: {err_w[-2000:]}")
        rec["exit_watchdog"] = 76
    before = done["before"]
    every = _it_losses(started["outs"]["preempted"])
    want = _it_losses(started["outs"]["uninterrupted"])
    if len(before) != _done(stopped, want) or every != want:
        apart = [(i, a, b) for i, (a, b) in enumerate(zip(every, want)) if a != b][:5]
        raise AssertionError(f"preempted + resumed CLI losses against the uninterrupted run's: "
                             f"{len(before)} before the stop, {len(every)} against "
                             f"{len(want)}, first apart {apart}")
    rec.update(steps=len(want), steps_before_stop=len(before), losses_bit_equal=len(want),
               resume_s=time.perf_counter() - done["resume_t0"],
               drills_s=time.perf_counter() - started["t0"])
    return rec


def _done(stopped: dict, want: list) -> int:
    """How many of the uninterrupted run's steps a stop at ``stopped``'s
    (epoch, iterations done) had taken."""
    return sum(1 for e, _ in want if e < stopped["epoch"]) + stopped["iterations_done"]


def prefetch_readings(data_dir: str, out: str, device: str = "cuda", order=(0, 2, 2, 0),
                      profile_order=(0, 2), **kw) -> dict:
    """One epoch per entry of ``order`` (prefetch depth), in turns, from one
    Trainer whose initial parameters are fixed (so each epoch starts from the
    same weights and seed): every step's loss bitwise equal across all of
    them; each epoch's wall seconds and ``train.data`` seconds, and — for
    ``profile_order``, under ``torch.profiler`` — the device's busy share.
    Readings, not limits.  Returns the record and the trainer."""
    from csat_tpu_torch.obs import EventRecorder

    tr, ds = resilience_trainer(data_dir, os.path.join(out, "prefetch"), device, **kw)
    tr.initial_params = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    base = tr.cfg
    runs, losses = [], []
    for i, depth in enumerate(tuple(order) + tuple(profile_order)):
        tr.cfg = base.replace(prefetch=depth)
        tr.obs = EventRecorder(capacity=base.obs_events, component="train")  # per-run totals
        profiled = i >= len(order)
        prof = None
        if profiled and device == "cuda":
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        sync()
        t0 = time.perf_counter()
        _, hist = tr.fit(ds, None)
        sync()
        wall = time.perf_counter() - t0
        rec = dict(prefetch=depth, profiled=profiled, wall_s=wall, steps=len(hist["steps"]),
                   data_s=hist["phase_s"].get("train.data", 0.0),
                   step_s=hist["phase_s"].get("train.step", 0.0))
        if prof is not None:
            prof.__exit__(None, None, None)
            summary = _device_summary(prof, wall)
            rec.update(device_busy_ms=summary["device_busy_ms"],
                       device_busy_share=summary["device_busy_share"])
        runs.append(rec)
        losses.append([r["loss"] for r in hist["steps"]])
    tr.cfg = base
    apart = [i for i, run in enumerate(losses) if run != losses[0]]
    if apart:
        raise AssertionError(f"prefetch changed the losses: runs {apart} differ from run 0 "
                             f"({[r['prefetch'] for r in runs]})")
    return dict(runs=runs, losses_bit_equal=len(losses[0])), (tr, ds)


def guard_update_costs(tr, ds, reps: int = 10) -> dict:
    """The AdamW update on the full model's parameters and this batch's
    gradients, three ways, in turns: unguarded, guarded as the port does it
    (the moments' buffers kept and selected with one ``torch.where`` each, the
    update times ``ok``), and guarded with three ``torch.where`` per
    parameter tensor: host seconds per call with the device's work done, and
    kernel launches per call (``torch.profiler``).  A reading for the choice
    of the guarded form, not a limit."""
    from torch.profiler import ProfilerActivity, profile

    from csat_tpu_torch.data.dataset import batch_to_device

    state = tr.init_state()
    batch = batch_to_device(next(iter(tr._train_batches(ds, 1))), tr.device)
    state, _ = tr.train_step(state, batch)
    opt, params = tr.optimizer, state.params
    grads = {k: p.grad for k, p in params.items()}
    ok = torch.ones((), dtype=torch.bool, device=tr.device)

    @torch.no_grad()
    def per_tensor():
        keys = list(params)
        old = [(params[k].clone(), opt_mu[k].clone(), opt_nu[k].clone()) for k in keys]
        opt.update(params, grads, state.opt_state)
        for k, (p0, m0, v0) in zip(keys, old):
            for t, t0 in ((params[k], p0), (opt_mu[k], m0), (opt_nu[k], v0)):
                torch.where(ok, t, t0, out=t)

    opt_mu, opt_nu = state.opt_state.mu, state.opt_state.nu
    forms = {"unguarded": lambda: opt.update(params, grads, state.opt_state),
             "flat_where": lambda: opt.update(params, grads, state.opt_state, ok=ok),
             "per_tensor_where": per_tensor}
    out = {name: dict(host_ms=[]) for name in forms}
    for r in range(4):
        for name in (list(forms) if r % 2 == 0 else list(forms)[::-1]):
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                forms[name]()
            sync()
            out[name]["host_ms"].append((time.perf_counter() - t0) / reps * 1e3)
    for name, fn in forms.items():
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        out[name].update(ms=statistics.median(out[name]["host_ms"]),
                         launches=sum(e.count for e in prof.key_averages()
                                      if e.device_type == torch.autograd.DeviceType.CUDA))
    return dict(param_tensors=len(params), **out)


def resilience_phase(corpus) -> dict:
    """The trainer's resilience and telemetry on the ``python`` config at its
    published widths, batch 64, in its defaults (shared noise, sampled eval
    graph), bucketed on the fit phases' corpus; each gate raises:

    (a) the guard: the syncs of a train step between guard reads, by line —
    none from the guard, and ``guarded_apply`` alone syncs nothing; a NaN
    step leaves parameters and moments bitwise unchanged, counts once and
    records ``fault.nan_guard`` (with the device probe on, untripped); three
    NaN steps roll back once and the replay is finite; (b) prefetch 0 and 2
    give bitwise-equal losses (epoch wall, ``train.data`` seconds and busy
    share printed); (c) the CLI, SIGTERM'd at iteration ``PREEMPT_AT_IT``,
    exits 75, and ``--resume`` reproduces an uninterrupted CLI run's every
    loss; (d) the watchdog's host leg trips on a hung step with its
    post-mortem, its device leg on a wedged stream while beats continue, and
    a child on the default action exits 76; (e) two corrupt batches under a
    budget of 2 are quarantined on the planned chunks through the prefetch
    thread, a third raises; (f) registry = history counters, the scalar
    log's cadence, a profiled epoch's traces."""
    from csat_tpu_torch.ops import build

    tmp, data_dir, _ = corpus
    out = os.path.join(tmp, "resilience")
    t0 = time.perf_counter()
    build.reset_launches()
    started = start_cli_drills(tmp, data_dir)
    with flex_launches() as launched:
        tr, ds = resilience_trainer(data_dir, os.path.join(out, "syncs"))
        syncs = step_syncs(tr, ds)
        guard_costs = guard_update_costs(tr, ds)
        del tr
        nan = nan_step_drill(data_dir, os.path.join(out, "nan"))
        rollback = rollback_drill(data_dir, os.path.join(out, "rollback"))
        quarantine = quarantine_drill(data_dir, os.path.join(out, "quarantine"))
        cli = finish_cli_drills(started)
        host_leg = host_leg_drill(data_dir, os.path.join(out, "host_leg"))
        device_leg = device_leg_drill()
        prefetch, (tr, ds) = prefetch_readings(data_dir, out)
        loop_syncs = fit_syncs(tr, ds)
        del tr
    counts = build.launch_counts()
    _check_launched("resilience", counts)
    _check_rates("resilience", launched)
    rec = dict(model="python", noise_mode="shared", eval_graph="sample", batch=TRAIN_B,
               step_syncs=syncs, fit_syncs=loop_syncs, guard_update=guard_costs, nan_step=nan,
               rollback=rollback, prefetch=prefetch, cli=cli, host_leg=host_leg,
               device_leg=device_leg, quarantine=quarantine, launches=counts,
               seconds=time.perf_counter() - t0)
    emit("resilience", **rec)
    return rec


# ---------------------------------------------------------------------------
# phase 11: the serving engine as production runs it
# ---------------------------------------------------------------------------

SERVING_REQUESTS, SERVING_REPEATS = 32, 8
#: snippets the serving command line summarises (raw Python through the
#: stdlib-ast extractor)
CLI_SNIPPETS = (
    "def add(a, b):\n    return a + b\n",
    "def parseHTTPResponse(raw_bytes, max_len=10):\n    head, _, body = raw_bytes.partition(b'x')\n"
    "    if len(body) > max_len:\n        raise ValueError('too long')\n    return head, body\n",
    "def walk(tree):\n    for child in tree.children:\n        yield from walk(child)\n    yield tree\n",
    "class Stack:\n    def push(self, item):\n        self.items.append(item)\n",
)


class DrillClock:
    """The drills' virtual clock: moves only when a drill advances it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def serving_trace(cfg, n: int = SERVING_REQUESTS, repeats: int = SERVING_REPEATS) -> dict:
    """``bench.py``'s serving protocol: AST sizes with the corpora's small
    skew (lognormal, median ≈ 0.3·N), token budgets skewed the same way
    (short summaries dominate), ``repeats`` requests exact repeats of one of
    the four before them (near-duplicate code arrives close together, so
    its chain is still cached or even live), arrivals a seeded Poisson
    process in decode-step units at ~1.4× the pool's service rate
    (``bench.py:736``)."""
    from csat_tpu_torch.data.synthetic import random_ast, request_sample

    rng = np.random.default_rng(SEED + 13)
    steps = cfg.max_tgt_len - 1
    sizes = np.clip((cfg.max_src_len * rng.lognormal(-1.2, 0.6, n)).astype(int), 4,
                    cfg.max_src_len)
    budgets = np.clip((steps * rng.lognormal(-1.0, 0.5, n)).astype(int), 2, steps)
    samples = [request_sample(random_ast(rng, int(k)), cfg, SRC_VOCAB) for k in sizes]
    origin = list(range(n))
    for i in sorted(rng.choice(np.arange(1, n), repeats, replace=False).tolist()):
        origin[i] = origin[max(0, i - int(rng.integers(1, 5)))]
        samples[i] = samples[origin[i]]
    arrivals = np.cumsum(rng.exponential(
        scale=float(budgets.mean()) / cfg.serve_slots / 1.4, size=n))
    return dict(samples=samples, budgets=[int(b) for b in budgets], arrivals=arrivals,
                origin=origin, sizes=[int(s) for s in sizes])


def drive_trace(engine, trace, count_syncs: bool = False) -> dict:
    """One run of ``trace`` from a cold prefix cache and fresh stats:
    requests arrive when the engine's decode-step count reaches their
    arrival (an idle gap jumps the count, as ``bench.py`` does).  With
    ``count_syncs`` every tick runs under :func:`counted_syncs`, tagged with
    whether it admitted or resolved a request."""
    engine.reset_stats()
    if engine._prefix is not None:
        for _, chain in engine._prefix.evict_for(1 << 30):
            engine._allocator.free(chain)
    samples, budgets, arrivals = trace["samples"], trace["budgets"], trace["arrivals"]
    ids, ticks, nxt = [], [], 0
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    while nxt < len(samples) or engine.occupancy or engine.queue_depth:
        while nxt < len(samples) and arrivals[nxt] <= engine.stats.decode_steps:
            ids.append(engine.submit(samples[nxt], budgets[nxt]))
            nxt += 1
        admitted, done, steps = (engine.stats.admitted, len(engine._results),
                                 engine.stats.decode_steps)
        with counted_syncs() if count_syncs else contextlib.nullcontext([]) as caught:
            live = engine.tick()
        if count_syncs:
            ticks.append(dict(syncs=list(caught), admitted=engine.stats.admitted > admitted,
                              resolved=len(engine._results) > done,
                              decoded=engine.stats.decode_steps > steps))
        if not live and not engine.queue_depth and nxt < len(samples):
            engine.stats.decode_steps = int(np.ceil(arrivals[nxt]))
    engine.drain()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hits = {fields["id"] for _, name, _, fields in engine.obs.events()
            if name == "req.admit" and fields and fields.get("hit")}
    return dict(results=[engine.poll(i) for i in ids], wall=wall, ticks=ticks,
                hits=[i for i, rid in enumerate(ids) if rid in hits],
                summary=engine.stats.summary(wall_s=wall))


def check_trace_run(run: dict, trace: dict, label: str) -> dict:
    """All OK, prefix hits > 0, each hit's tokens its original's (the
    shorter budget's tokens a prefix of the longer's)."""
    res = run["results"]
    bad = [r.id for r in res if not r.ok]
    if bad:
        raise AssertionError(f"{label}: requests not OK: {bad}")
    if not run["hits"]:
        raise AssertionError(f"{label}: no prefix-cache hit in a trace with repeats")
    for i in run["hits"]:
        a, b = res[i].tokens, res[trace["origin"][i]].tokens
        k = min(len(a), len(b))
        if trace["origin"][i] == i or not np.array_equal(a[:k], b[:k]):
            raise AssertionError(f"{label}: hit {i}'s tokens differ from its original's")
    return dict(hits=len(run["hits"]), tokens=sum(len(r.tokens) for r in res))


def reads_per_tick(ticks) -> dict:
    """Host syncs of the ticks that only decoded (a decode step, no
    admission, no request resolved): each must be exactly the one status
    read; the other ticks' syncs are tallied by site."""
    pure = [t for t in ticks if t["decoded"] and not t["admitted"] and not t["resolved"]]
    counts = [len(t["syncs"]) for t in pure]
    if not pure or set(counts) != {1}:
        raise AssertionError(f"decode-only ticks read the device {sorted(set(counts))} times "
                             f"(must be once): {_tally(s for t in pure for s in t['syncs'])}")
    return dict(decode_only_ticks=len(pure), reads_per_tick=counts[0], ticks=len(ticks),
                sites_decode_only=_tally(s for t in pure for s in t["syncs"]),
                sites_other_ticks=_tally(s for t in ticks if t not in pure
                                         for s in t["syncs"]))


def _bucket0(cfg, n: int, seed: int):
    """``n`` small requests (5-16 nodes): one prefill bucket, so the i-th
    submitted request lands in slot i."""
    from csat_tpu_torch.data.synthetic import random_ast, request_sample

    rng = np.random.default_rng(SEED + 7000 * seed)
    return [request_sample(random_ast(rng, 5 + i % 12), cfg, SRC_VOCAB) for i in range(n)]


def _clean_tokens(model, cfg, device, samples, budget):
    """The same requests through a fresh engine with no fault: the
    reference the drills' survivors must equal."""
    from csat_tpu_torch.serve import ServeEngine

    eng = ServeEngine(model, cfg, device=device, clock=DrillClock())
    res = eng.generate(samples, max_new_tokens=budget)
    eng.close()
    return [r.tokens for r in res]


def _drill_done(eng, ids, reason) -> dict:
    """After a drill: every request terminal exactly once (its trace too),
    no page or chain leaked, a post-mortem on disk for ``reason``."""
    from csat_tpu_torch.obs import EventRecorder

    for rid in ids:
        r = eng.poll(rid)
        if r is None or r.status not in ("OK", "FAILED", "TIMEOUT", "REJECTED", "SHED"):
            raise AssertionError(f"request {rid} not terminal: {r and r.status}")
        if eng.tracer.finished_count(r.trace_id) != 1:
            raise AssertionError(f"request {rid}: {eng.tracer.finished_count(r.trace_id)} traces")
    if eng.occupancy or eng.queue_depth or eng.page_leaks() or eng.chain_leaks():
        raise AssertionError(f"after the drill: {eng.occupancy} live, {eng.queue_depth} queued, "
                             f"{eng.page_leaks()} pages leaked")
    names = []
    if reason:
        path = os.path.join(eng._postmortem_dir, f"postmortem_serve_{reason}.jsonl")
        if not os.path.exists(path):
            raise AssertionError(f"no post-mortem for {reason}")
        names = [e["name"] for e in EventRecorder.load(path)[1]]
    return dict(statuses=[eng.poll(r).status for r in ids], postmortem=reason,
                postmortem_events=len(names))


def _same(tokens_a, tokens_b, label):
    for i, (a, b) in enumerate(zip(tokens_a, tokens_b)):
        if not np.array_equal(a, b):
            raise AssertionError(f"{label}: request {i}'s tokens differ from a clean run's")


def serving_drills(model, cfg, device: str, out: str) -> dict:
    """The drill matrix of the JAX package's serving tests, on one engine
    under a virtual clock: poison at submit; ``reject`` and ``shed_oldest``;
    deadlines queued and in flight; a NaN slot retiring FAILED with the
    others exact; a wedged slot reaped; a prefill failure; a decode fault
    rebuilding with the resubmitted tokens a clean run's; retries exhausted,
    then the rebuild cap; ``shed_all``; a prefix hit on NaN-scrubbed self
    pages, exact; and, on an engine of its own, the tick watchdog tripped by
    callback.  After each: every request terminal once, no leak, a
    post-mortem for the reason."""
    import threading

    from csat_tpu_torch.resilience import DataErrorBudgetExceeded, ErrorBudget, FaultInjector
    from csat_tpu_torch.serve import ServeEngine

    clock = DrillClock()
    base = cfg.replace(obs_postmortem_dir=os.path.join(out, "postmortem"))
    eng = ServeEngine(model, base, device=device, clock=clock)
    S = cfg.serve_slots
    rec = {}

    def reset(**over):
        eng.cfg = base.replace(**over)
        eng.fault_injector = None
        eng._rebuilds = 0

    # poison at submit, under a budget of 2
    reset()
    eng._poison_budget = ErrorBudget(2, log=lambda m: None)
    good = _bucket0(cfg, 2, 1)
    ids = [eng.submit(FaultInjector.poison_sample(good[0], m)) for m in ("missing_key", "dtype")]
    try:
        eng.submit(FaultInjector.poison_sample(good[0], "oversize"))
        raise AssertionError("the third poison submit did not exhaust the budget")
    except DataErrorBudgetExceeded:
        pass
    eng._poison_budget = ErrorBudget(cfg.serve_poison_budget, log=lambda m: None)
    ids += [r.id for r in eng.generate(good, max_new_tokens=3)]
    rec["poison"] = _drill_done(eng, ids, "FAILED")
    if rec["poison"]["statuses"] != ["FAILED", "FAILED", "OK", "OK"]:
        raise AssertionError(f"poison drill: {rec['poison']}")

    # admission control: reject, then shed_oldest
    reset(serve_max_queue=2)
    samples = _bucket0(cfg, 4, 2)
    ids = [eng.submit(s, max_new_tokens=2) for s in samples[:3]]
    eng.cfg = eng.cfg.replace(serve_queue_policy="shed_oldest")
    ids.append(eng.submit(samples[3], max_new_tokens=2))
    eng.drain()
    rec["admission"] = _drill_done(eng, ids, "SHED")
    if rec["admission"]["statuses"] != ["SHED", "OK", "REJECTED", "OK"]:
        raise AssertionError(f"admission drill: {rec['admission']}")

    # deadlines: queued, then in flight, on the virtual clock
    reset()
    samples = _bucket0(cfg, 2, 3)
    ids = [eng.submit(samples[0], max_new_tokens=5, deadline_s=4.0)]
    clock.advance(10.0)
    eng.tick()
    ids.append(eng.submit(samples[1], max_new_tokens=8, deadline_s=4.0))
    eng.tick()
    eng.tick()
    clock.advance(10.0)
    eng.tick()
    rec["deadlines"] = _drill_done(eng, ids, "TIMEOUT")
    partial = eng.poll(ids[1]).n_tokens
    if rec["deadlines"]["statuses"] != ["TIMEOUT", "TIMEOUT"] or not 0 < partial <= 8:
        raise AssertionError(f"deadline drill: {rec['deadlines']}, {partial} partial tokens")
    rec["deadlines"]["in_flight_tokens"] = partial

    # a NaN slot: FAILED with its clean prefix, the others exact; then a
    # prefix hit whose fresh self page is the poisoned one
    reset()
    samples = _bucket0(cfg, S, 5)
    clean = _clean_tokens(model, base, device, samples, 6)
    eng.fault_injector = FaultInjector(serve_nan_logits=[(eng.ticks + 1, 0)])
    ids = [eng.submit(s, max_new_tokens=6) for s in samples]
    eng.tick()
    victim_pages = set(eng._slot_meta[0].self_chain)
    eng.tick()
    eng.tick()
    eng.fault_injector = None
    if eng.poll(ids[0]) is None or eng.poll(ids[0]).status != "FAILED":
        raise AssertionError("NaN drill: the poisoned slot did not retire FAILED")
    ids.append(eng.submit(samples[1], max_new_tokens=6))  # cached: a hit
    eng.tick()
    hit = next(r for r in eng._slots if r is not None and r.id == ids[-1])
    reused = victim_pages & set(eng._slot_meta[hit.slot].self_chain)
    eng.drain()
    rec["nan_slot"] = _drill_done(eng, ids, "FAILED")
    victim = eng.poll(ids[0])
    if "non-finite logits" not in victim.error or victim.n_tokens != 1:
        raise AssertionError(f"NaN drill: victim {victim.error!r}, {victim.n_tokens} tokens")
    _same([victim.tokens], [clean[0][:1]], "NaN drill victim")
    _same([eng.poll(r).tokens for r in ids[1:S]], clean[1:], "NaN drill survivors")
    if not reused:
        raise AssertionError("NaN drill: the hit did not land on the poisoned page")
    _same([eng.poll(ids[-1]).tokens], [clean[1]], "prefix hit on scrubbed pages")
    rec["nan_slot"].update(hit_reused_poisoned_pages=len(reused), hit_tokens_exact=True)

    # a wedged slot, reaped
    reset()
    samples = _bucket0(cfg, S, 6)
    clean = _clean_tokens(model, base, device, samples, 4)
    eng.fault_injector = FaultInjector(serve_wedge_slots=[(eng.ticks + 1, 0)])
    ids = [eng.submit(s, max_new_tokens=4) for s in samples]
    eng.drain()
    rec["wedge"] = _drill_done(eng, ids, "FAILED")
    if "stuck slot reaped" not in (eng.poll(ids[0]).error or "") or eng.stats.reaped < 1:
        raise AssertionError(f"wedge drill: {eng.poll(ids[0]).error!r}")
    _same([eng.poll(r).tokens for r in ids[1:]], clean[1:], "wedge drill survivors")

    # a prefill failure: its chunk FAILED, the pool still serving
    reset()
    samples = _bucket0(cfg, 2, 8)
    eng.fault_injector = FaultInjector(serve_prefill_fail_calls=[eng.prefills])
    ids = [eng.submit(s, max_new_tokens=3) for s in samples]
    eng.drain()
    eng.fault_injector = None
    ids += [r.id for r in eng.generate(samples, max_new_tokens=3)]
    rec["prefill_fault"] = _drill_done(eng, ids, "FAILED")
    if rec["prefill_fault"]["statuses"] != ["FAILED", "FAILED", "OK", "OK"]:
        raise AssertionError(f"prefill drill: {rec['prefill_fault']}")

    # a decode fault: rebuild, resubmit, tokens a clean run's
    reset()
    samples = _bucket0(cfg, S + 2, 9)
    clean = _clean_tokens(model, base, device, samples, 4)
    eng.fault_injector = FaultInjector(serve_decode_fail_ticks=[eng.ticks + 1])
    rebuilds = eng.stats.rebuilds
    ids = [eng.submit(s, max_new_tokens=4) for s in samples]
    eng.drain()
    rec["rebuild"] = _drill_done(eng, ids, "rebuild")
    if set(rec["rebuild"]["statuses"]) != {"OK"} or eng.stats.rebuilds != rebuilds + 1:
        raise AssertionError(f"rebuild drill: {rec['rebuild']}")
    _same([eng.poll(r).tokens for r in ids], clean, "rebuild drill")
    rec["rebuild"]["resubmitted"] = sum(eng.poll(r).attempts for r in ids)

    # retries exhausted, then the rebuild cap
    reset(serve_max_retries=0, serve_max_rebuilds=4)
    samples = _bucket0(cfg, 2, 10)
    eng.fault_injector = FaultInjector(serve_decode_fail_ticks=[eng.ticks])
    ids = [eng.submit(s, max_new_tokens=3) for s in samples]
    eng.drain()
    eng.cfg = base.replace(serve_max_rebuilds=0)
    eng.fault_injector = FaultInjector(serve_decode_fail_ticks=[eng.ticks])
    ids.append(eng.submit(samples[0], max_new_tokens=3))
    try:
        eng.drain()
        raise AssertionError("the rebuild cap did not propagate the fault")
    except RuntimeError as e:
        if "serve_max_rebuilds" not in str(e):
            raise
    eng.fault_injector = None
    eng._rebuilds = 0
    eng.drain()
    rec["retries_cap"] = _drill_done(eng, ids, "rebuild_cap")
    if rec["retries_cap"]["statuses"] != ["FAILED", "FAILED", "OK"]:
        raise AssertionError(f"retries drill: {rec['retries_cap']}")

    # shed_all: queued and in flight
    reset()
    ids = [eng.submit(s, max_new_tokens=8) for s in _bucket0(cfg, S + 2, 11)]
    eng.tick()
    eng.tick()
    shed = eng.shed_all("drill")
    rec["shed_all"] = _drill_done(eng, ids, "SHED")
    if shed != len(ids) or set(rec["shed_all"]["statuses"]) != {"SHED"}:
        raise AssertionError(f"shed_all drill: {rec['shed_all']}")
    eng.close()

    # the tick watchdog on an engine of its own: the hang advances the
    # virtual clock and asks the watchdog to look — tripped by its callback
    wclock, tripped = DrillClock(), threading.Event()
    weng = ServeEngine(model, base.replace(serve_watchdog_timeout_s=3.0), device=device,
                       clock=wclock, watchdog_on_timeout=tripped.set)

    def hang(seconds):
        wclock.advance(seconds)
        weng._watchdog.check()

    weng.fault_injector = FaultInjector(serve_hang_at_tick=1, hang_seconds=8.0, sleep=hang)
    reqs = weng.generate(_bucket0(cfg, 2, 12), max_new_tokens=4)
    rec["watchdog"] = _drill_done(weng, [r.id for r in reqs], "watchdog")
    weng.close()
    if not tripped.is_set() or set(rec["watchdog"]["statuses"]) != {"OK"}:
        raise AssertionError(f"watchdog drill: tripped {tripped.is_set()}, {rec['watchdog']}")
    return rec


def serving_checkpoint(data_dir: str, out: str, device: str = "cuda", **kw) -> str:
    """A short fit on the corpus at ``data_dir`` (one bucketed epoch, no
    validation) whose parameters are saved where the trainer saves its best
    model; returns that directory."""
    from csat_tpu_torch.train.checkpoint import save_params

    tr, ds = resilience_trainer(data_dir, out, device=device, **kw)
    tr.fit(ds, None)
    save_params(tr.output_dir, dict(tr.model.named_parameters()))
    return tr.output_dir


def serving_cli(data_dir: str, ckpt: str, tmp: str, device: str = "cuda", sets=()) -> dict:
    """The command line on that checkpoint: ``summarize`` of
    ``CLI_SNIPPETS`` in this process, held against ``ServeEngine`` on the
    same snippets; then a ``serve`` process fed a JSONL burst with malformed
    lines, SIGTERM'd once its first response is out: every line answered,
    exit 0 (the JAX serve loop's)."""
    import io
    import signal

    from csat_tpu_torch.serve import cli

    base = ["--config", "python", "--data_dir", data_dir, "--checkpoint_dir", ckpt,
            "--device", device, "--postmortem_dir", os.path.join(tmp, "cli_pm"),
            "--set", "eval_graph='expected'", "--max_new_tokens", "8"]
    for k, v in dict(sets).items():
        base += ["--set", f"{k}={v!r}"]
    files = []
    for i, src in enumerate(CLI_SNIPPETS):
        files.append(os.path.join(tmp, f"snippet_{i}.py"))
        with open(files[-1], "w") as f:
            f.write(src)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        cli.main(["summarize", *base, *files])
    summaries = [json.loads(line) for line in buf.getvalue().splitlines()]
    engine, cfg, src_vocab, trip_vocab = cli.build_engine(cli._parser().parse_args(base))
    ids = [cli._ingest(engine, cfg, src_vocab, trip_vocab, s, 8) for s in CLI_SNIPPETS]
    engine.drain()
    words = [" ".join(engine.words(engine.poll(i))) for i in ids]
    engine.close()
    if [s.get("status") for s in summaries] != ["OK"] * len(files) or words != [
            s["summary"] for s in summaries]:
        raise AssertionError(f"summarize differs from ServeEngine: {summaries} / {words}")

    lines = [json.dumps({"id": f"r{i}", "code": s}) for i, s in enumerate(CLI_SNIPPETS)]
    lines[1:1] = ["42", json.dumps({"id": "nocode"}), json.dumps({"id": "syn", "code": "def f(:"})]
    lines.append(json.dumps({"id": "late", "code": CLI_SNIPPETS[0], "priority": "hi"}))
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out_path, err_path = os.path.join(tmp, "serve.out"), os.path.join(tmp, "serve.err")
    t0 = time.perf_counter()
    with open(out_path, "w") as out_f, open(err_path, "w") as err_f:
        proc = subprocess.Popen([sys.executable, "-m", "csat_tpu_torch.cli", "serve", *base],
                                cwd=REPO, env=env, stdin=subprocess.PIPE, stdout=out_f,
                                stderr=err_f, text=True)
        try:
            proc.stdin.write("\n".join(lines) + "\n")  # one burst; stdin stays open
            proc.stdin.flush()
            deadline = time.monotonic() + 300
            while proc.poll() is None and time.monotonic() < deadline:
                with open(out_path) as f:
                    if f.readline().endswith("\n"):  # the first response is out
                        break
                time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdin.close()
    with open(out_path) as f, open(err_path) as g:
        rest, err = f.read(), g.read()
    answered = {str(json.loads(x)["id"]): json.loads(x) for x in rest.splitlines() if x.strip()}
    want = {"r0", "r1", "r2", "r3", "0", "nocode", "syn", "late"}
    if proc.returncode != 0 or set(answered) != want or "shutdown signal" not in err:
        raise AssertionError(f"serve process: exit {proc.returncode}, answered "
                             f"{sorted(answered)}, stderr tail {err[-600:]}")
    failed = sorted(k for k, v in answered.items() if v["status"] == "FAILED")
    if failed != sorted(["0", "nocode", "syn", "late"]):
        raise AssertionError(f"serve process: FAILED lines {failed}")
    drained = re.search(r"draining (\d+) request", err)
    return dict(summarize=len(summaries), summarize_equals_engine=True,
                in_flight_at_signal=int(drained.group(1)) if drained else None,
                serve_exit=proc.returncode, serve_lines=len(lines),
                serve_answered=len(answered), serve_failed_lines=len(failed),
                serve_ok={k: v["status"] for k, v in answered.items() if k.startswith("r")},
                serve_stats=json.loads(err.strip().splitlines()[-1]),
                serve_s=time.perf_counter() - t0)


def serving_phase(corpus, card: str = "", profile: bool = False) -> dict:
    """The flagship at full width, 8 slots, the default prefix cache (64):
    the trace of ``serving_trace`` driven twice from a cold cache (the second
    under the sync counter) — all OK, equal tokens between the runs and to
    the CPU plain run up to ``TIE_MARGIN``, prefix hits each equal to their
    original, no leak, one device read per decode-only tick, no kernel
    library built after the first run; the drill matrix; the command line
    on a checkpoint of its own.  Launches of K1, K2, K5 are counted over the
    two trace runs; ``profile`` adds a third run under torch.profiler (the
    device's busy share of the drain).  ``card`` (``nvidia-smi``'s name and
    power limit) goes on the line beside the readings."""
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.ops import build
    from csat_tpu_torch.serve import ServeEngine

    tmp, data_dir, _ = corpus
    out = os.path.join(tmp, "serving")
    t0 = time.perf_counter()
    cfg = flagship()
    if cfg.serve_prefix_cache != 64:
        raise AssertionError(f"prefix cache {cfg.serve_prefix_cache}, not the default 64")
    trace = serving_trace(cfg)
    model = CSATrans(cfg, SRC_VOCAB, TGT_VOCAB, device="cuda", seed=SEED)
    engine = ServeEngine(model, cfg.replace(obs_postmortem_dir=os.path.join(out, "pm")),
                         device="cuda")
    build.reset_launches()
    with flex_launches() as launched:
        first = drive_trace(engine, trace)
        libs, builds = set(build._LIBS), dict(build.BUILD_LOG)
        second = drive_trace(engine, trace, count_syncs=True)
    counts = build.launch_counts()
    if set(build._LIBS) != libs or build.BUILD_LOG != builds:
        raise AssertionError("a kernel library was built or loaded after warm-up")
    _check_launched("serving", counts)
    _check_rates("serving", launched)
    checked = check_trace_run(first, trace, "serving, run 1")
    check_trace_run(second, trace, "serving, run 2")
    for a, b in zip(first["results"], second["results"]):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"serving: request {a.id}'s tokens differ between the runs")
    if engine.page_leaks() or engine.chain_leaks():
        raise AssertionError(f"serving: {engine.page_leaks()} pages leaked")
    reads = reads_per_tick(second["ticks"])
    traced = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            third = drive_trace(engine, trace)
        traced = _device_summary(prof, third["wall"])
    engine.close()

    cpu_model = CSATrans(cfg, SRC_VOCAB, TGT_VOCAB, device="cpu", seed=SEED)
    log = MarginLog(cpu_model)
    cpu_engine = ServeEngine(cpu_model, cfg, device="cpu", clock=lambda: len(log.calls))
    t_cpu = time.perf_counter()
    cpu = drive_trace(cpu_engine, trace)
    cpu_s = time.perf_counter() - t_cpu
    ties, compared = compare_tokens(first["results"], dict(results=cpu["results"], log=log),
                                    "serving: card and CPU")
    del cpu_model, cpu_engine

    drills = serving_drills(model, cfg, "cuda", out)
    del model, engine
    ckpt = serving_checkpoint(data_dir, os.path.join(out, "fit"))
    cli_rec = serving_cli(data_dir, ckpt, out)
    s = first["summary"]
    rec = dict(
        card=card, model="python", eval_graph=cfg.eval_graph, slots=cfg.serve_slots,
        prefix_cache=cfg.serve_prefix_cache, requests=len(trace["samples"]),
        repeats=SERVING_REPEATS, budgets=trace["budgets"], num_nodes=trace["sizes"],
        all_ok=True, page_leaks=0, chain_leaks=0, hits=checked["hits"],
        hits_second_run=len(second["hits"]), tokens=checked["tokens"],
        outcomes={k: s[k] for k in ("retired", "failed", "timeouts", "rejected", "shed",
                                     "rebuilds")},
        prefix_hit_rate=s["prefix_hit_rate"], effective_slots=s["effective_slots"],
        kv_page_occupancy=s["kv_page_occupancy"], kv_page_peak=s["kv_page_peak"],
        latency_p50_s=s["latency_p50_s"], latency_p95_s=s["latency_p95_s"],
        drain_wall_s=first["wall"], drain_wall_s_counted=second["wall"],
        tokens_per_s=checked["tokens"] / first["wall"], decode_steps=s["decode_steps"],
        prefill_calls=s["prefill_calls"], programs=s["compiles"], **reads,
        runs_tokens_equal=True, cpu_tokens_equal=True, near_ties=ties,
        tokens_compared=compared, tie_margin=TIE_MARGIN, cpu_seconds=cpu_s,
        launches=counts, drills=drills, cli=cli_rec, profile=traced,
        seconds=time.perf_counter() - t0)
    emit("serving", **rec)
    return rec

# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 12: long ASTs and data parallelism — python_long / java_long at N 512
# ---------------------------------------------------------------------------

def long_batch(cfg, b: int, nodes=LONG_NODES, device: str = "cuda"):
    """``b`` synthetic ASTs spread over ``nodes`` (200..512) with random
    summaries, collated at ``cfg.max_src_len`` onto ``device``."""
    from csat_tpu_torch.data.dataset import batch_to_device, collate
    from csat_tpu_torch.data.synthetic import random_ast, train_sample

    rng = np.random.default_rng(SEED + 12)
    sizes = np.linspace(nodes[0], nodes[1], b).round().astype(int)
    rng.shuffle(sizes)
    samples = [train_sample(random_ast(rng, int(n)), cfg, SRC_VOCAB, TGT_VOCAB, rng)
               for n in sizes]
    arrs = {key: np.stack([s[key] for s in samples]) for key in samples[0]}
    return batch_to_device(collate(arrs, cfg.max_src_len), torch.device(device))


def long_serve_cfg(name: str):
    from csat_tpu_torch.configs import get_config

    return get_config(name, eval_graph="expected", serve_slots=8)


def long_requests(cfg, n_requests: int = LONG_SERVE_REQUESTS):
    """``n_requests`` requests of ``LONG_SERVE_NODES`` (300..512) nodes with
    the serve phase's budgets."""
    from csat_tpu_torch.data.synthetic import random_ast, request_sample

    rng = np.random.default_rng(SEED + 13)
    sizes = np.linspace(*LONG_SERVE_NODES, n_requests).round().astype(int)
    rng.shuffle(sizes)
    samples = [request_sample(random_ast(rng, int(n)), cfg, SRC_VOCAB) for n in sizes]
    return samples, [BUDGETS[i % len(BUDGETS)] for i in range(n_requests)]


def long_serve_shapes(cfg, samples):
    """(B, N) of every prefill group the engine can form from ``samples``:
    every batch size up to the bucket's at each bucket they fall in."""
    from csat_tpu_torch.serve.prefill import assign_prefill_bucket, prefill_plan

    plan = prefill_plan(cfg)
    used = {assign_prefill_bucket(plan, int(s["num_node"])) for s in samples}
    return sorted((b, plan[k].n) for k in used for b in range(1, plan[k].batch_size + 1))


def long_checks(dev) -> dict:
    """The kernels where the ``long_ast`` phase runs them, at N 512.  Checked
    and timed: K1 on random inputs with python_long's 512-row tables and on
    its train batch's real distances; K6 (rate 0.2) and K3/K4 at dh 64 and 96
    on random inputs, on the first SBM layer of a python_long and of a
    java_long step, and at a data-parallel rank's half batch (B 32) with the
    batch·head offset of rank 1 of 2 (bh0 = 32 · 8); K1 and K2 (dh 64 and 96)
    on the first CSE / SBM layer of each config's serving drain's largest
    prefill group; K5 on one self and one cross launch of python_long's
    drain.  Checked only: K6 at rate 0 (the fit's sampled eval encoder), K1
    at B 32 (the ranks' CSE), K1 and K2 at every prefill group the long
    requests form."""
    from csat_tpu_torch.configs import get_config

    gen = torch.Generator().manual_seed(SEED + 8)
    py = get_config("python_long")
    b, n = TRAIN_B, py.max_src_len
    recs = {"flex_fwd_cse@n512": flex_check("cse", b, n, gen, dev, r_len=n)}
    batch = long_batch(py, b)
    rel_mask = (torch.stack([batch.L, batch.T], dim=1).to(torch.int32).contiguous(),
                torch.stack([batch.L_mask, batch.T_mask], dim=1).contiguous())
    recs["flex_fwd_cse@long_train_batch"] = flex_check("cse", b, n, gen, dev,
                                                       rel_mask=rel_mask, r_len=n)
    del batch, rel_mask
    for dh in (64, 96):
        recs[f"flex_fwd_sbm_sampled@n512_dh{dh}"] = flex_check("sbm_sampled", b, n, gen, dev,
                                                               dh=dh)
        recs.update({f"{fn}@n512_dh{dh}": rec for fn, rec in bwd_check(
            "sbm_sampled", b, n, gen, dev, dh=dh).items()})
    flex_check("sbm_sampled", b, n, gen, dev, rate=0.0, timed=False)
    half = b // DP_RANKS
    bh0 = half * py.num_heads  # rank 1 of 2
    recs["flex_fwd_sbm_sampled@bh0"] = flex_check("sbm_sampled", half, n, gen, dev, bh0=bh0)
    recs.update({f"{fn}@bh0": rec for fn, rec in bwd_check(
        "sbm_sampled", half, n, gen, dev, bh0=bh0).items()})
    flex_check("cse", half, n, gen, dev, timed=False, r_len=n)
    for name in LONG_CONFIGS:
        cfg = get_config(name)
        first = capture_sbm_inputs(cfg, long_batch(cfg, b))[0]
        if not (first["go"].abs().sum() > 0 and first["gs"].abs().sum() > 0):
            raise AssertionError(f"{name}: the captured cotangents are zero")
        first["inputs"] = f"{name} train batch"
        recs[f"flex_fwd_sbm_sampled@{name}"] = flex_check("sbm_sampled", b, n, gen, dev,
                                                          captured=first)
        recs.update({f"{fn}@{name}": rec for fn, rec in bwd_check(
            "sbm_sampled", b, n, gen, dev, captured=first).items()})
        del first
    for name in LONG_CONFIGS:
        cfg = long_serve_cfg(name)
        samples, budgets = long_requests(cfg)
        for bb, nn in long_serve_shapes(cfg, samples):
            for mod, dh in (("cse", 64), ("sbm_expected", cfg.head_dim)):
                if (f"flex_fwd_{mod}", bb, nn, dh) not in CHECKED:
                    flex_check(mod, bb, nn, gen, dev, timed=False, dh=dh, r_len=nn)
        recs[f"flex_fwd_cse@{name}_serve"] = flex_check(
            "cse", 0, 0, gen, dev, captured=capture_prefill_inputs(cfg, samples, budgets))
        recs[f"flex_fwd_sbm_expected@{name}_serve"] = flex_check(
            "sbm_expected", 0, 0, gen, dev,
            captured=capture_prefill_inputs(cfg, samples, budgets, layer="sbm"))
        if name == "python_long":
            decode = capture_decode_inputs(cfg, samples, budgets)
            for side in ("self", "cross"):
                recs[f"paged_decode@{name}_serve_{side}"] = paged_check(
                    None, side, gen, dev, captured=decode[side])
    emit("n512", **{key: dict(ms=rec["ms"], bound_ms=rec["bound_ms"],
                              plain_ms=rec["plain_ms"], library_ms=rec.get("library_ms"),
                              B=rec.get("B"), N=rec.get("N"), dh=rec.get("dh"),
                              bh0=rec.get("bh0", 0))
                    for key, rec in recs.items()})
    return recs


def long_train(name: str, profile: bool) -> dict:
    """(a) ``name`` in its defaults (counter noise, remat, dropout 0.2) at B
    64, N 512: the step gate, the same-graph gate on each SBM layer, 8 more
    steps whose loss must fall; then (e) 8 requests of 300 to 512 nodes
    served through the kernels and through the plain route on the card,
    tokens equal up to a near tie.  Every forward launch at a (B, N, rate,
    dh) phase 3 checked."""
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.ops import build

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(name)
    if not (cfg.remat and cfg.noise_mode == "counter" and cfg.max_src_len == 512):
        raise AssertionError(f"{name}: not the long-AST config: {cfg}")
    batch = long_batch(cfg, cfg.batch_size)
    with flex_launches() as launched:
        model, state, step, m_k, counts, gate = step_gate(cfg, batch,
                                                          err_file=f"{name}_grad_err.json")
    same = same_graph_gate(cfg, batch)
    build.reset_launches()
    with flex_launches() as more:
        state, steps = more_steps(step, state, batch, float(m_k["loss"]), counts)
    counts = steps["launches"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    trace = profile_steps(step, state, batch) if profile else None
    del model, state, step

    cfg_s = long_serve_cfg(name)
    samples, budgets = long_requests(cfg_s)
    with flex_launches() as served:
        card = serve(cfg_s, "cuda", samples, budgets)
    plain = serve(cfg_s, "cuda", samples, budgets, plain=True)
    for run in (card, plain):
        bad = [r.id for r in run["results"] if not r.ok]
        if bad or run["engine"].page_leaks():
            raise AssertionError(f"{name} serving: requests not OK {bad}, "
                                 f"{run['engine'].page_leaks()} pages leaked")
    ties, compared = compare_tokens(card["results"], plain, f"{name} kernel and plain")
    counts = {fn: counts[fn] + card["counts"][fn] for fn in counts}
    _check_launched(name, counts)
    _check_shapes(name, [tuple(batch.src_seq.shape)], cfg, kernels=PATH_KERNELS["long_fit"])
    _check_rates(name, launched + more + served)
    rec = dict(model=name, noise_mode=cfg.noise_mode, remat=cfg.remat, batch=cfg.batch_size,
               widths=_widths(cfg), sbm_head_dim=cfg.head_dim, **gate, same_graph=same,
               losses=steps["losses"], step_s=steps["step_s"],
               step_s_median=steps["step_s_median"], peak_mem_gb=peak, profile=trace,
               requests=len(samples), request_nodes=[int(s["num_node"]) for s in samples],
               serve_s=card["seconds"], plain_serve_s=plain["seconds"],
               tokens=sum(len(r.tokens) for r in card["results"]), near_ties=ties,
               tokens_compared=compared, launches={fn: c for fn, c in counts.items() if c},
               seconds=time.perf_counter() - t0)
    emit("long_train", **rec)
    return rec


def remat_compare(name: str = "python_long") -> dict:
    """(b) One kernel step with remat on and one with remat off from the
    same weights, generator and batch: the loss the same bits, the grad-norm
    within 1e-6 relative; the peak memory of each step."""
    from csat_tpu_torch.configs import get_config

    cfg = get_config(name)
    batch = long_batch(cfg, cfg.batch_size)
    on = trainer(cfg)
    off = trainer(cfg.replace(remat=False), copy.deepcopy(on[0]))
    got = {}
    for label, (_, state, step) in (("on", on), ("off", off)):
        sync()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state, m, seconds = timed_step(step, state, batch)
        got[label] = dict(metrics=m, step_s=seconds,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                          above_resident_gb=(torch.cuda.max_memory_allocated() - resident) / 1e9)
    m_on, m_off = got["on"].pop("metrics"), got["off"].pop("metrics")
    gnorm_rel = abs(float(m_on["grad_norm"]) / float(m_off["grad_norm"]) - 1)
    if not (torch.equal(m_on["loss"], m_off["loss"]) and gnorm_rel <= REMAT_GNORM_RTOL):
        raise AssertionError(f"remat on against off: loss {float(m_on['loss'])} / "
                             f"{float(m_off['loss'])}, grad-norm rel {gnorm_rel}")
    rec = dict(model=name, loss=float(m_on["loss"]), loss_bitwise_equal=True,
               grad_norm_rel=gnorm_rel, grad_norm_rtol=REMAT_GNORM_RTOL, **{
                   f"remat_{label}": r for label, r in got.items()})
    emit("remat", **rec)
    return rec


@contextlib.contextmanager
def process_group(backend: str, world: int, rank: int, store: str):
    """This process in a ``torch.distributed`` group through a ``file://``
    store, left at the end."""
    from csat_tpu_torch.parallel import host

    host.initialize_multihost(backend, f"file://{store}", world, rank)
    try:
        yield
    finally:
        host.shutdown()


def long_fit(tmp: str) -> dict:
    """(c) A world-1 NCCL group driving ``Trainer.fit`` of python_long for
    one epoch with validation on a synthetic corpus of 200 to 512 nodes
    (``LONG_FIT_SAMPLES``): every collective of the data-parallel step runs
    (as identities), every step finite, the validation BLEU read, rank 0's
    checkpoint written, the kernels launched at checked shapes and rates."""
    import torch.distributed as dist

    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.dataset import ASTDataset
    from csat_tpu_torch.data.synthetic import make_corpus
    from csat_tpu_torch.ops import build
    from csat_tpu_torch.train.checkpoint import make_checkpoint_fn
    from csat_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        data_dir = make_corpus(os.path.join(tmp, "long_corpus"), *LONG_FIT_SAMPLES, seed=SEED,
                               max_ast_len=512, node_range=LONG_NODES)
    corpus_s = time.perf_counter() - t0
    cfg = get_config("python_long", data_dir=data_dir, output_dir=os.path.join(tmp, "long_out"),
                     num_epochs=1, val_interval=1, save_interval=1, guard_check_every=1)
    logs = []
    with process_group("nccl", 1, 0, os.path.join(tmp, "nccl_store")):
        tr = Trainer(cfg, log=logs.append, device="cuda")
        backend = dist.get_backend()
        if backend != "nccl" or tr.mesh.group is None or tr.mesh.data != 1:
            raise AssertionError(f"long fit: not a world-1 NCCL mesh ({backend}, {tr.mesh})")
        train_ds = ASTDataset(cfg, "train", tr.src_vocab, tr.tgt_vocab)
        val_ds = ASTDataset(cfg, "dev", tr.src_vocab, tr.tgt_vocab)
        ckpt = make_checkpoint_fn(tr.output_dir)
        build.reset_launches()
        t1 = time.perf_counter()
        with flex_launches() as launched:
            _, hist = tr.fit(train_ds, val_ds, checkpoint_fn=ckpt)
        sync()
        fit_s = time.perf_counter() - t1
        counts = build.launch_counts()
        plan = tr._plan_id()
    losses = [s["loss"] for s in hist["steps"]]
    if not (losses and np.all(np.isfinite(losses)) and hist["val_bleu"]
            and os.path.exists(os.path.join(ckpt.directory, "state_1.pt"))
            and plan.endswith("@hosts=1")):
        raise AssertionError(f"long fit: losses {losses}, val {hist['val_bleu']}, plan {plan}")
    _check_launched("long_fit", counts)
    _check_rates("long_fit", launched)
    rec = dict(model="python_long", backend=backend, world=1, corpus=list(LONG_FIT_SAMPLES),
               nodes=list(LONG_NODES), corpus_s=corpus_s, fit_s=fit_s, steps=len(losses),
               losses=losses, epoch_loss=hist["loss"], val_bleu=hist["val_bleu"],
               eval_s=hist["eval_s"], by_shape=_by_shape(hist["steps"]), plan=plan,
               launches={fn: c for fn, c in counts.items() if c})
    emit("long_fit", **rec)
    return rec


def dp_rank(rank: int, world: int, store: str, out: str) -> None:
    """(d) One rank of the two-process gloo step on ``cuda:0``: this rank's
    half of the B 64 N 512 batch through the kernels (rank 1's hash streams
    at bh0 = 32 · 8), the gradients summed through gloo; writes its metrics,
    kernel launches (with the bh0 each took) and parameters after the step
    under ``out``."""
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.ops import build, flex_core
    from csat_tpu_torch.parallel.mesh import broadcast_params, build_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    with process_group("gloo", world, rank, store):
        cfg = get_config("python_long")
        batch = long_batch(cfg, TRAIN_B)
        half = TRAIN_B // world
        mine = batch._replace(**{f: getattr(batch, f)[rank * half:(rank + 1) * half]
                                 for f in batch._fields})
        _, state, step = trainer(cfg)
        broadcast_params(state.params, build_mesh(cfg.mesh_shape))
        seen = []
        fwd, bwd = flex_core.kernel_args, flex_core.bwd_kernel_args

        def fwd_rec(spec, q, *a, **kw):
            seen.append((f"flex_fwd_{spec.name}", q.shape[0], q.shape[2], q.shape[3],
                         getattr(spec, "bh0", 0)))
            return fwd(spec, q, *a, **kw)

        def bwd_rec(spec, q, *a, **kw):
            seen.append((f"flex_bwd_{spec.name}", q.shape[0], q.shape[2], q.shape[3], spec.bh0))
            return bwd(spec, q, *a, **kw)

        flex_core.kernel_args, flex_core.bwd_kernel_args = fwd_rec, bwd_rec
        build.reset_launches()
        state, m, seconds = timed_step(step, state, mine)
        flex_core.kernel_args, flex_core.bwd_kernel_args = fwd, bwd
        flat = torch.cat([p.detach().reshape(-1) for p in state.params.values()]).cpu()
        torch.save(flat, os.path.join(out, f"dp_params_{rank}.pt"))
        rec = dict(rank=rank, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   nonfinite=bool(m["nonfinite"]), step_s=seconds, rows=[rank * half, half],
                   launches=build.launch_counts(), seen=sorted(set(seen)))
        with open(os.path.join(out, f"dp_rank_{rank}.json"), "w") as f:
            json.dump(rec, f)


def dp_gate(tmp: str) -> dict:
    """(d) Two gloo ranks in two processes, both on ``cuda:0``, each taking
    half of the B 64 N 512 batch through the kernels, against the
    one-process B 64 step, at python_long's own dropout (model, cluster
    projection and attention 0.2: each rank's masks are its rows' slices of
    the global draw): loss within 1e-5 and grad-norm within 1e-4 relative,
    the parameters after the step the same bits on both ranks, rank 1's K6,
    K3 and K4 launched at bh0 = 32 · 8.  The parameters' largest difference
    from the one-process step is recorded.  Gloo stages a CUDA all-reduce
    through the host: the step time is no speed figure."""
    from csat_tpu_torch.configs import get_config

    t0 = time.perf_counter()
    cfg = get_config("python_long")
    batch = long_batch(cfg, TRAIN_B)
    _, state, step = trainer(cfg)
    state, m_one, one_s = timed_step(step, state, batch)
    one = dict(loss=float(m_one["loss"]), grad_norm=float(m_one["grad_norm"]), step_s=one_s)
    one_params = torch.cat([p.detach().reshape(-1) for p in state.params.values()]).cpu()
    del state, step, batch
    torch.cuda.empty_cache()
    # each rank a fresh interpreter importing this file as a module (whatever
    # script is the main one), its output on stderr
    store = os.path.join(tmp, "gloo_store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(REPO)!r}); "
         f"import chip_smoke; chip_smoke.dp_rank({r}, {DP_RANKS}, {store!r}, {tmp!r})"],
        cwd=str(REPO), stdout=sys.stderr, stderr=sys.stderr) for r in range(DP_RANKS)]
    deadline = time.monotonic() + DP_TIMEOUT_S
    hung = []
    for r, p in enumerate(procs):
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            hung.append(r)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(10)
    if hung or any(p.returncode != 0 for p in procs):
        raise AssertionError(f"two-rank step: ranks hung {hung}, exit codes "
                             f"{[p.returncode for p in procs]}")
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(tmp, f"dp_rank_{r}.json")) as f:
            ranks.append(json.load(f))
    params = [torch.load(os.path.join(tmp, f"dp_params_{r}.pt")) for r in range(DP_RANKS)]
    loss_rel = abs(ranks[0]["loss"] / one["loss"] - 1)
    gnorm_rel = abs(ranks[0]["grad_norm"] / one["grad_norm"] - 1)
    same_params = all(torch.equal(params[0], p) for p in params[1:])
    params_vs_one = float(torch.max(torch.abs(params[0] - one_params)))
    same_metrics = all((r["loss"], r["grad_norm"], r["nonfinite"]) == (
        ranks[0]["loss"], ranks[0]["grad_norm"], ranks[0]["nonfinite"]) for r in ranks)
    offset = {tuple(s[:1]) for s in ranks[1]["seen"] if s[4] == TRAIN_B // DP_RANKS * 8}
    wanted = {("flex_fwd_sbm_sampled",), ("flex_bwd_sbm_sampled",)}
    if not (loss_rel <= LOSS_RTOL and gnorm_rel <= GNORM_RTOL and same_params and same_metrics
            and not ranks[0]["nonfinite"] and wanted <= offset):
        raise AssertionError(f"two-rank step against one process: loss rel {loss_rel}, "
                             f"grad-norm rel {gnorm_rel}, parameters equal {same_params}, "
                             f"metrics equal {same_metrics}, offset launches {offset}")
    counts = {fn: sum(r["launches"][fn] for r in ranks) for fn in ranks[0]["launches"]}
    _check_launched("long_dp", counts)
    shapes = sorted({(s[1], s[2]) for r in ranks for s in r["seen"]})
    _check_shapes("long_dp", shapes, cfg)
    rec = dict(model="python_long", ranks=DP_RANKS, backend="gloo", device="cuda:0",
               dropout=cfg.dropout, attention_dropout=cfg.attention_dropout, one_process=one,
               rank_records=[{k: r[k] for k in ("rank", "loss", "grad_norm", "rows", "step_s")}
                             for r in ranks],
               loss_rel=loss_rel, loss_rtol=LOSS_RTOL, grad_norm_rel=gnorm_rel,
               grad_norm_rtol=GNORM_RTOL, params_bitwise_equal=same_params,
               params_max_abs_vs_one_process=params_vs_one,
               offset_launches=sorted(s for s in ranks[1]["seen"] if s[4]),
               launches={fn: c for fn, c in counts.items() if c},
               note="gloo stages the CUDA all-reduce through the host: a correctness gate, "
                    "not a speed figure", seconds=time.perf_counter() - t0)
    emit("long_dp", **rec)
    return rec


def long_ast_phase(profile: bool) -> dict:
    """Phase 12: (a) and (e) for each long config, (b) remat on against off,
    (c) the world-1 NCCL fit, (d) the two-rank gloo step."""
    t0 = time.perf_counter()
    recs = {name: long_train(name, profile) for name in LONG_CONFIGS}
    recs["remat"] = remat_compare()
    tmp = tempfile.mkdtemp(prefix="csat_long_")
    try:
        recs["long_fit"] = long_fit(tmp)
        recs["long_dp"] = dp_gate(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("long_ast", seconds=time.perf_counter() - t0, paths=list(recs))
    return {"launches": {path: recs[path]["launches"]
                         for path in (*LONG_CONFIGS, "long_fit", "long_dp")}}


# ---------------------------------------------------------------------------
# phase 13: the seq and pipe mesh axes, two gloo ranks on one card
# ---------------------------------------------------------------------------

PAR_RANKS = 2
PAR_STEPS = 8           # python_pp steps on the ranks (the first one gated)
PAR_DECODE = 8          # ASTs greedy-decoded on the ranks and in one process
PAR_SEQ_B = TRAIN_B     # python_long's batch at seq 2 (cut to 32 if the phase runs past 150 s)
PAR_TIMEOUT_S = 600.0
RING_GATE_LAYERS = (0, 3)  # the SBM layers whose ring inputs the same-graph gate replays


@contextlib.contextmanager
def recorded_launches():
    """Records (kernel, B, N, rate, dh) of every flex forward and (kernel, B,
    N, dh) of every flex backward launch inside the block."""
    from csat_tpu_torch.ops import flex_core

    fwd, bwd = flex_core.kernel_args, flex_core.bwd_kernel_args
    got = {"fwd": [], "bwd": []}

    def fwd_rec(spec, q, k, v, aux, rate=0.0, dseed=None):
        got["fwd"].append((f"flex_fwd_{spec.name}", q.shape[0], q.shape[2], float(rate),
                           q.shape[3]))
        return fwd(spec, q, k, v, aux, rate, dseed)

    def bwd_rec(spec, q, *a, **kw):
        got["bwd"].append((f"flex_bwd_{spec.name}", q.shape[0], q.shape[2], q.shape[3]))
        return bwd(spec, q, *a, **kw)

    flex_core.kernel_args, flex_core.bwd_kernel_args = fwd_rec, bwd_rec
    try:
        yield got
    finally:
        flex_core.kernel_args, flex_core.bwd_kernel_args = fwd, bwd


def greedy_with_gaps(model, batch, shard=None, seed: int = SEED):
    """Greedy decode of ``batch`` (eval mode, sampled graphs from a
    generator seeded with ``seed``) → ``(tokens (B, T-1), top-2 log-prob gap
    per row and step)``: the gaps say where two tokens were a near tie."""
    from csat_tpu_torch.train import decode as dec

    inner, gaps = dec._decode_step, []

    def step(*a, **kw):
        logp = inner(*a, **kw)
        top = torch.topk(logp.float(), 2, dim=-1).values
        gaps.append((top[:, 0] - top[:, 1]).cpu())
        return logp

    dec._decode_step = step
    try:
        gen = torch.Generator(device=model.device).manual_seed(seed)
        toks = dec.greedy_decode(model, batch, gen, shard)
    finally:
        dec._decode_step = inner
    return toks.cpu().numpy(), torch.stack(gaps, dim=1).numpy()


def tokens_up_to_tie(toks, ref, ref_gaps, label: str, margin: float = TIE_MARGIN) -> dict:
    """``toks`` equal to ``ref`` row by row, or first apart at a step where
    the reference's top two log-probs were within ``margin``."""
    apart, ties = 0, 0
    for row in range(ref.shape[0]):
        diff = np.nonzero(toks[row] != ref[row])[0]
        if diff.size == 0:
            continue
        apart += 1
        if ref_gaps[row, diff[0]] >= margin:
            raise AssertionError(f"{label}: row {row} first differs at step {diff[0]} with a "
                                 f"top-2 gap of {ref_gaps[row, diff[0]]} >= {margin}")
        ties += 1
    return dict(rows=int(ref.shape[0]), tokens=int(ref.size), rows_apart=apart,
                near_ties=ties, min_gap=float(ref_gaps.min()))


def _par_cfg(kind: str, overrides=None):
    """python_pp over ("data", 1) × ("pipe", 2), or python_long over
    ("data", 1) × ("seq", 2); ``overrides`` (narrow widths) only for the
    CPU rehearsal of the phase."""
    from csat_tpu_torch.configs import get_config

    over = dict(overrides or {})
    if kind == "pp":
        return get_config("python_pp", mesh_shape=(("data", 1), ("pipe", PAR_RANKS)), **over)
    return get_config("python_long", mesh_shape=(("data", 1), ("seq", PAR_RANKS)), **over)


def _par_batch(kind: str, cfg, device: str):
    if kind == "pp":
        return train_batch(cfg, TRAIN_B, device)
    return long_batch(cfg, PAR_SEQ_B, nodes=(min(LONG_NODES[0], cfg.max_src_len // 2),
                                             cfg.max_src_len), device=device)


def _rows(batch, n: int):
    return batch._replace(**{f: getattr(batch, f)[:n] for f in batch._fields})


def _flat_params(state) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in state.params.values()]).cpu()


def _reset_peak(device: str) -> int:
    """Reset the card's peak-memory counter → the bytes allocated now (0 on
    the CPU)."""
    if device != "cuda":
        return 0
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak(device: str) -> int:
    return torch.cuda.max_memory_allocated() if device == "cuda" else 0


def parallel_rank(kind: str, rank: int, world: int, store: str, out: str,
                  device: str = "cuda", overrides=None) -> None:
    """One rank of a two-process gloo gate on ``cuda:0`` (``kind`` "pp": the
    pipe axis, "seq": the seq axis): the decode of ``PAR_DECODE`` ASTs at the
    initial parameters (python_pp also on the expected graph, through K2 in
    the stages), then the train steps, the kernels' launches counted from 0
    just before and read just after; writes its record and parameters under
    ``out``."""
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.models import sbm as tsbm
    from csat_tpu_torch.ops import build
    from csat_tpu_torch.parallel import ring as ring_mod
    from csat_tpu_torch.parallel.mesh import broadcast_params, build_mesh

    if device == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2 if device == "cuda" else 1)
    cfg = _par_cfg(kind, overrides)
    with process_group("gloo", world, rank, store):
        mesh = build_mesh(cfg.mesh_shape)
        batch = _par_batch(kind, cfg, device)
        model, state, step = trainer(cfg, device=device)
        broadcast_params(state.params, mesh)
        few = _rows(batch, PAR_DECODE)
        gsums = []
        ring = tsbm.ring_sbm_attention

        def ring_rec(*a, **kw):
            out_, gs = ring(*a, **kw)
            gsums.append(gs.detach().cpu())
            return out_, gs

        tsbm.ring_sbm_attention = ring_rec
        # the inputs and outputs of the ring's body in the gated layers of the
        # timed step's forward, for the same-graph gate (RING_GATE_LAYERS)
        inner_ring, caps, calls = ring_mod._ring, [], []

        def ring_body(q, k, v, r, k_hat, key_pad, sseed, dseed, axis, rate, floor, bh0,
                      h_total=0):
            out_, spars = inner_ring(q, k, v, r, k_hat, key_pad, sseed, dseed, axis, rate,
                                     floor, bh0, h_total)
            if calls and len(calls) <= cfg.sbm_layers and len(calls) - 1 in RING_GATE_LAYERS:
                cpu = lambda t: None if t is None else t.detach().cpu().clone()
                caps.append(dict(layer=len(calls) - 1, q=cpu(q), k=cpu(k), v=cpu(v), r=cpu(r),
                                 k_hat=cpu(k_hat), key_pad=cpu(key_pad), sseed=cpu(sseed),
                                 dseed=cpu(dseed), rate=rate, floor=floor, bh0=bh0,
                                 h_total=h_total,
                                 out=cpu(out_), spars=cpu(spars)))
            if calls:
                calls.append(1)
            return out_, spars

        ring_mod._ring = ring_body
        build.reset_launches()
        rec = dict(rank=rank, mesh=mesh.shape)
        with recorded_launches() as seen:
            toks, gaps = greedy_with_gaps(model, few, mesh.decode_shard(PAR_DECODE))
            rec["tokens"], rec["gaps"] = toks.tolist(), gaps.tolist()
            if kind == "pp":
                exp = CSATrans(cfg.replace(eval_graph="expected"), SRC_VOCAB, TGT_VOCAB,
                               device=device, seed=SEED)
                exp.load_state_dict(model.state_dict())
                toks, gaps = greedy_with_gaps(exp, few, mesh.decode_shard(PAR_DECODE))
                rec["tokens_expected"], rec["gaps_expected"] = toks.tolist(), gaps.tolist()
                del exp
            gsums.clear()
            calls.append(1)  # from here on: the timed step's forward
            base = _reset_peak(device)
            state, m, seconds = timed_step(step, state, batch)
            peak = _peak(device)
            calls.clear()
            rec.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                       sparsity=float(m["sparsity"]), nonfinite=bool(m["nonfinite"]),
                       step_s=seconds, peak_gb=peak / 1e9, peak_above_start_gb=(peak - base) / 1e9,
                       graph_sums=[g.tolist() for g in gsums])
            torch.save(_flat_params(state), os.path.join(out, f"par_{kind}_params_{rank}.pt"))
            losses, times = [rec["loss"]], [seconds]
            # python_pp's 8 steps; python_long's second step, timed past warm-up
            for _ in range(PAR_STEPS - 1 if kind == "pp" else 1):
                state, m, seconds = timed_step(step, state, batch)
                losses.append(float(m["loss"]))
                times.append(seconds)
            rec.update(losses=losses, step_times=times)
        tsbm.ring_sbm_attention = ring
        ring_mod._ring = inner_ring
        if caps:
            torch.save(caps, os.path.join(out, f"par_{kind}_ring_{rank}.pt"))
        rec.update(launches=build.launch_counts(), fwd=sorted(set(seen["fwd"])),
                   bwd=sorted(set(seen["bwd"])))
        with open(os.path.join(out, f"par_{kind}_rank_{rank}.json"), "w") as f:
            json.dump(rec, f)


def _run_ranks(kind: str, tmp: str, device: str = "cuda", overrides=None) -> list:
    # each rank a fresh interpreter importing this file as a module, its
    # output on stderr
    store = os.path.join(tmp, f"gloo_{kind}")
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(REPO)!r}); "
         f"import chip_smoke; chip_smoke.parallel_rank({kind!r}, {r}, {PAR_RANKS}, {store!r}, "
         f"{tmp!r}, {device!r}, {overrides!r})"], cwd=str(REPO), stdout=sys.stderr,
        stderr=sys.stderr) for r in range(PAR_RANKS)]
    deadline = time.monotonic() + PAR_TIMEOUT_S
    hung = []
    for r, p in enumerate(procs):
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            hung.append(r)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(10)
    if hung or any(p.returncode != 0 for p in procs):
        raise AssertionError(f"{kind} ranks: hung {hung}, exit codes "
                             f"{[p.returncode for p in procs]}")
    ranks = []
    for r in range(PAR_RANKS):
        with open(os.path.join(tmp, f"par_{kind}_rank_{r}.json")) as f:
            ranks.append(json.load(f))
    params = [torch.load(os.path.join(tmp, f"par_{kind}_params_{r}.pt"))
              for r in range(PAR_RANKS)]
    ranks[0]["same_params"] = all(torch.equal(params[0], p) for p in params[1:])
    ranks[0]["params0"] = params[0]
    return ranks


def _one_process(kind: str, cfg, batch, device: str = "cuda") -> dict:
    """The one-process side on the card: python_pp's microbatched step
    (``pipeline_reference_mesh``: the sequential microbatched loop with the
    wavefront's keys) and its decodes, or python_long's counter step (ΣA of
    each layer recorded) and decode."""
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.models import sbm as tsbm
    from csat_tpu_torch.parallel.mesh import build_mesh, pipeline_reference_mesh
    from csat_tpu_torch.train import create_train_state, default_optimizer, make_train_step

    mesh = (pipeline_reference_mesh(cfg.mesh_shape) if kind == "pp"
            else build_mesh((("data", 1),)))
    model = CSATrans(cfg, SRC_VOCAB, TGT_VOCAB, device=device, seed=SEED)
    opt = default_optimizer(cfg)
    state = create_train_state(model, opt, SEED)
    step = make_train_step(model, opt, cfg, mesh)
    few = _rows(batch, PAR_DECODE)
    rec = {}
    rec["tokens"], rec["gaps"] = greedy_with_gaps(model, few, mesh.decode_shard(PAR_DECODE))
    if kind == "pp":  # the expected graph in one process: no mesh, the plain loop
        exp = CSATrans(cfg.replace(eval_graph="expected"), SRC_VOCAB, TGT_VOCAB, device=device,
                       seed=SEED)
        rec["tokens_expected"], rec["gaps_expected"] = greedy_with_gaps(exp, few)
        del exp
    gsums, first = [], {}
    flex = tsbm.flex_attention

    def flex_rec(q, k, v, spec, aux, *a, **kw):
        out_, ex = flex(q, k, v, spec, aux, *a, **kw)
        if spec.name == "sbm_sampled" and len(gsums) < cfg.sbm_layers:
            gsums.append(ex["graph_sum"].detach().cpu())  # the forward's, not remat's recompute
            if not first:  # the first SBM layer's q and R, beside the ranks' own
                first.update(q=q.detach().cpu(), r=aux[0].detach().cpu())
        return out_, ex

    tsbm.flex_attention = flex_rec
    try:
        base = _reset_peak(device)
        state, m, seconds = timed_step(step, state, batch)
    finally:
        tsbm.flex_attention = flex
    peak = _peak(device)
    rec.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               sparsity=float(m["sparsity"]), step_s=seconds, peak_gb=peak / 1e9,
               peak_above_start_gb=(peak - base) / 1e9, graph_sums=gsums, first=first,
               params=_flat_params(state))
    state, _, rec["second_step_s"] = timed_step(step, state, batch)  # past warm-up
    return rec


def ring_same_graph(tmp: str, one: dict, device: str = "cuda") -> dict:
    """The seq ranks' ring on the gated layers' own inputs, gathered to whole
    rows, against K6 (the plain path on the CPU) on them: ΣA the same bits,
    the output within ``FLEX_TOL``.  Also how far those inputs are from the
    one-process step's first SBM layer (the ranks form q on N/2 rows, one
    process on N: the GEMMs may round apart, and a draw near its threshold
    then flips)."""
    from csat_tpu_torch.ops.flex_core import flex_attention
    from csat_tpu_torch.ops.mods import SBMSampledSpec

    caps = [torch.load(os.path.join(tmp, f"par_seq_ring_{r}.pt")) for r in range(PAR_RANKS)]
    recs = []
    for i, layer in enumerate(caps[0]):
        parts = [c[i] for c in caps]
        cat = lambda key, dim: torch.cat([p[key] for p in parts], dim=dim).to(device)
        q, k, v, r, kh = (cat(key, 2) for key in ("q", "k", "v", "r", "k_hat"))
        padf = cat("key_pad", 1).to(torch.float32).contiguous()
        b, h, n, _ = q.shape
        spec = SBMSampledSpec(n=n, heads=h, kk=r.shape[-1], floor=layer["floor"],
                              bh0=layer["bh0"], h_total=layer.get("h_total", 0))
        aux = (r.contiguous(), kh.contiguous(), padf, layer["sseed"].to(device))
        dseed = None if layer["dseed"] is None else layer["dseed"].to(device)
        with torch.no_grad():
            out, ex = flex_attention(q.contiguous(), k.contiguous(), v.contiguous(), spec, aux,
                                     layer["rate"], dseed)
        ring_gs = sum(p["spars"] for p in parts)
        ring_out = torch.cat([p["out"] for p in parts], dim=2)
        gs_equal = torch.equal(ex["graph_sum"].cpu(), ring_gs)
        out_err = float(torch.max(torch.abs(out.cpu() - ring_out)))
        rec = dict(layer=layer["layer"], graph_sum_equal=gs_equal,
                   graph_sum_entries_apart=int(torch.sum(ex["graph_sum"].cpu() != ring_gs)),
                   out_max_abs_err=out_err, tol=FLEX_TOL)
        if layer["layer"] == 0 and one.get("first"):
            rec["inputs_max_abs_vs_one_process"] = {
                key: float(torch.max(torch.abs(one["first"][key] - val.cpu())))
                for key, val in (("q", q), ("r", r))}
        if not (gs_equal and out_err <= FLEX_TOL):
            raise AssertionError(f"seq: the ring against K6 on layer {layer['layer']}'s own "
                                 f"inputs: {rec}")
        recs.append(rec)
    return {"layers": recs}


def parallel_gate(kind: str, tmp: str, device: str = "cuda", overrides=None) -> dict:
    """(a) ``kind="pp"``: python_pp at its published widths over ("data",
    1) × ("pipe", 2), B 64 (4 microbatches of 16), N 150, against the
    one-process microbatched step: loss within 1e-5 and grad-norm within
    1e-4 relative, the parameters the same bits on both ranks; 8 steps
    finite; 8 ASTs decoded to the one-process tokens up to a near tie on the
    sampled graph (K6 in the stages, the reference mesh's keys) and on the
    expected graph (K2 in the stages, against the plain one-process loop).
    (b) ``kind="seq"``: python_long over ("data", 1) × ("seq", 2), B 64, N
    512, against the one-process counter step: ΣA of each layer the same
    bits, the step at the python gates' limits, the parameters the same bits
    on both ranks, 8 ASTs decoded to the one-process tokens up to a near
    tie; the ring step's time and each rank's peak memory beside the
    one-process step's.  Both: gloo stages the collectives through the host,
    so no time here is a speed figure.  ``device`` and ``overrides`` (narrow
    widths) serve the CPU rehearsal only."""
    t0 = time.perf_counter()
    cfg = _par_cfg(kind, overrides)
    batch = _par_batch(kind, cfg, device)
    one = _one_process(kind, cfg, batch, device)
    del batch
    if device == "cuda":
        torch.cuda.empty_cache()
    ranks = _run_ranks(kind, tmp, device, overrides)
    r0 = ranks[0]
    loss_rel = abs(r0["loss"] / one["loss"] - 1)
    gnorm_rel = abs(r0["grad_norm"] / one["grad_norm"] - 1)
    same_metrics = all((r["loss"], r["grad_norm"], r["sparsity"]) == (
        r0["loss"], r0["grad_norm"], r0["sparsity"]) for r in ranks)
    params_vs_one = float(torch.max(torch.abs(r0["params0"] - one["params"])))
    finite = all(np.all(np.isfinite(r["losses"])) and not r["nonfinite"] for r in ranks)
    rec = dict(model=cfg.name, mesh=r0["mesh"], ranks=PAR_RANKS, backend="gloo",
               device="cuda:0", batch=TRAIN_B if kind == "pp" else PAR_SEQ_B,
               nodes=cfg.max_src_len, one_process=dict(
                   loss=one["loss"], grad_norm=one["grad_norm"], step_s=one["step_s"],
                   second_step_s=one["second_step_s"],
                   peak_gb=one["peak_gb"], peak_above_start_gb=one["peak_above_start_gb"]),
               loss=r0["loss"], grad_norm=r0["grad_norm"], loss_rel=loss_rel,
               loss_rtol=LOSS_RTOL, grad_norm_rel=gnorm_rel, grad_norm_rtol=GNORM_RTOL,
               params_bitwise_equal=r0["same_params"], metrics_equal=same_metrics,
               params_max_abs_vs_one_process=params_vs_one,
               rank_step_s=[r["step_s"] for r in ranks],
               rank_peak_gb=[r["peak_gb"] for r in ranks],
               rank_peak_above_start_gb=[r["peak_above_start_gb"] for r in ranks])
    decodes = {"sampled": [tokens_up_to_tie(np.array(r["tokens"]), one["tokens"],
                                            one["gaps"], f"{kind} rank {r['rank']}")
                           for r in ranks]}
    if kind == "pp":
        decodes["expected"] = [tokens_up_to_tie(np.array(r["tokens_expected"]),
                                                one["tokens_expected"], one["gaps_expected"],
                                                f"{kind} rank {r['rank']} expected")
                               for r in ranks]
        rec.update(losses=r0["losses"], step_times=r0["step_times"], microbatches=4)
    else:
        rec.update(rank_second_step_s=[r["step_times"][1] for r in ranks])
        layers_seen = [len(r["graph_sums"]) for r in ranks]
        if not (all(n == cfg.sbm_layers for n in layers_seen)
                and len(one["graph_sums"]) == cfg.sbm_layers):
            raise AssertionError(f"seq: ΣA of {layers_seen} ring layers, "
                                 f"{len(one['graph_sums'])} one-process layers")
        # ΣA per layer against the one-process step: the first SBM layer sees
        # the same inputs and must draw the same graph; past it the ring's
        # output (plain PyTorch) and K6's round apart, so a later layer's
        # draw near its threshold may flip — a reading there, and the gate
        # on each gated layer's own inputs is ring_same_graph's
        apart = [[int(np.sum(np.array(g) != one_g.numpy()))
                  for g, one_g in zip(r["graph_sums"], one["graph_sums"])] for r in ranks]
        net = [float(sum(np.sum(np.abs(np.array(g) - one_g.numpy()))
                         for g, one_g in zip(r["graph_sums"], one["graph_sums"])))
               for r in ranks]
        rec.update(graph_sum_entries_apart_by_layer=apart, net_edges_apart=net,
                   graph_sums_equal=all(a == 0 for row in apart for a in row),
                   same_graph=ring_same_graph(tmp, one, device))
        if any(row[0] for row in apart):
            raise AssertionError(f"seq: the first SBM layer's ΣA apart from one process: {apart}")
    rec["decode"] = decodes
    if not (loss_rel <= LOSS_RTOL and gnorm_rel <= GNORM_RTOL and r0["same_params"]
            and same_metrics and finite):
        raise AssertionError(f"{kind}: two ranks against one process: loss rel {loss_rel}, "
                             f"grad-norm rel {gnorm_rel}, parameters equal {r0['same_params']}, "
                             f"metrics equal {same_metrics}, finite {finite}")
    path = f"parallel_{kind}"
    counts = {fn: sum(r["launches"][fn] for r in ranks) for fn in r0["launches"]}
    _check_launched(path, counts)
    launched = {tuple(f) for r in ranks for f in r["fwd"]}
    _check_rates(path, launched)
    shapes = sorted({(f[1], f[2]) for r in ranks for f in r["bwd"]})
    _check_shapes(path, shapes, cfg, kernels=[k for k in PATH_KERNELS[path]
                                              if k.startswith("flex_bwd")])
    rec.update(launches={fn: c for fn, c in counts.items() if c},
               forward_launch_shapes=sorted(launched), backward_launch_shapes=shapes,
               note="gloo stages every collective through the host: a correctness gate, "
                    "not a speed figure", seconds=time.perf_counter() - t0)
    emit(path, **rec)
    return rec


def parallel_phase() -> dict:
    """Phase 13: (a) python_pp over a pipe axis and (b) python_long over a
    seq axis, each as two gloo ranks on ``cuda:0`` against one process."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="csat_parallel_")
    try:
        recs = {kind: parallel_gate(kind, tmp) for kind in ("pp", "seq")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("parallel", seconds=time.perf_counter() - t0, paths=[f"parallel_{k}" for k in recs])
    return {"launches": {f"parallel_{k}": rec["launches"] for k, rec in recs.items()}}


def parallel_checks(dev) -> dict:
    """The kernels where the ``parallel`` phase runs them: K6 (rate 0.2) and
    K3/K4 at a python_pp microbatch (B 16, N 150), timed; checked only: K6
    at rate 0 and K2 at a decode microbatch (B 2), K1 at the decoded rows (B
    8, N 150 and N 512)."""
    gen = torch.Generator().manual_seed(SEED + 13)
    mb = TRAIN_B // 4
    recs = {"flex_fwd_sbm_sampled@pp_micro": flex_check("sbm_sampled", mb, 150, gen, dev)}
    recs.update({f"{fn}@pp_micro": rec for fn, rec in bwd_check(
        "sbm_sampled", mb, 150, gen, dev).items()})
    dmb = PAR_DECODE // 4
    flex_check("sbm_sampled", dmb, 150, gen, dev, rate=0.0, timed=False)
    flex_check("sbm_expected", dmb, 150, gen, dev, timed=False)
    flex_check("cse", PAR_DECODE, 150, gen, dev, timed=False)
    flex_check("cse", PAR_DECODE, 512, gen, dev, timed=False, r_len=512)
    emit("pp_micro", **{key: dict(ms=rec["ms"], bound_ms=rec["bound_ms"],
                                  plain_ms=rec["plain_ms"], library_ms=rec.get("library_ms"),
                                  B=rec.get("B"), N=rec.get("N"))
                        for key, rec in recs.items()})
    return recs


# ---------------------------------------------------------------------------
# phase 14: tensor parallelism and the serve mesh
# ---------------------------------------------------------------------------

TP_RANKS = 2            # the model axis of (b); (c) adds a seq axis of 2
TP_STEPS = 8            # python steps on the ranks (the first one gated)
TP_DECODE = 8           # ASTs greedy-decoded on the ranks and in one process
TP_SEQ_B = TRAIN_B      # python_long's batch at model 2 × seq 2 (cut to 32 past 150 s)
TP_TIMEOUT_S = 900.0
TP_HEADS = (4, 4, 8)    # (h0, heads, h_total): the phase-3 checks' head shard
TP_PARAMS_RTOL = 1e-6   # the gathered parameters after the step against one process (rel L2)
SHARD_OUT_TOL, SHARD_GRAD_RTOL = 1e-6, 1e-5  # a head shard's launch against the full one's slice
TP_GATE_LAYERS = (0, 3)  # the SBM layers whose K7 inputs the same-graph gate replays


def _shard_of(mod: str, q, k, v, spec, aux, h0: int, h: int):
    """Heads ``[h0, h0 + h)`` of one launch's inputs as a head shard of a
    ``model`` axis passes them: the SBM mods at the global hash index
    (``bh0 + h0``, head stride the full launch's heads), K1 on the plane
    its heads lie in."""
    import dataclasses as dc

    from csat_tpu_torch.ops.mods import cse_mod

    part = lambda t: t[:, h0:h0 + h].contiguous()
    if mod == "cse":
        lq, lk, rel, mask = aux
        plane = h0 // spec.group
        if (h0 + h - 1) // spec.group != plane:
            raise AssertionError("a K1 head shard must lie in one plane")
        s_spec, s_aux = cse_mod(lq[h0:h0 + h], lk[h0:h0 + h], rel[:, plane:plane + 1],
                                mask[:, plane:plane + 1])
        return part(q), part(k), part(v), s_spec, s_aux
    s_spec = dc.replace(spec, heads=h, bh0=spec.bh0 + h0, h_total=spec.heads)
    if mod == "sbm_graph":
        s_aux = (part(aux[0]), aux[1])
    else:
        s_aux = (part(aux[0]), part(aux[1]), *aux[2:])
    return part(q), part(k), part(v), s_spec, s_aux


def _rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()).clamp_min(1e-30))


def head_shard_check(mod: str, gen, dev, b: int = TRAIN_B, n: int = 150) -> dict:
    """One kernel at a head shard (``TP_HEADS``: 4 of 8 heads from head 4,
    the hash streams at the global index) against the head slice of the
    full 8-head launch on the same inputs: graph_sum the same (0 edges
    apart), output within ``SHARD_OUT_TOL`` (max abs), and — K3/K4, K8/K9 —
    every gradient within ``SHARD_GRAD_RTOL`` (relative L2) of the slice;
    then the shard's launch against its plain version and timed
    (:func:`flex_check`, :func:`bwd_check` on it, ``inputs`` "head shard").
    K1 runs on one plane's heads."""
    from csat_tpu_torch.ops import flex_core

    h0, h, h_total = TP_HEADS
    q, k, v, spec, aux = _flex_inputs(mod, b, n, gen, dev)
    if spec.heads != h_total:
        raise AssertionError(f"phase 3's inputs have {spec.heads} heads, not {h_total}")
    rate = 0.0 if mod == "cse" else RATE
    dseed = torch.tensor([SEED + 29], dtype=torch.int32, device=dev) if rate else None
    sq, sk, sv, s_spec, s_aux = _shard_of(mod, q, k, v, spec, aux, h0, h)
    grads = mod in ("sbm_sampled", "sbm_expected")
    go = torch.randn(q.shape, generator=gen).to(dev)
    gs = torch.full((b, h_total), GS_COEF, device=dev)

    def run(qq, kk, vv, sp, ax, g_out, g_s):
        leaves = [t.detach().clone().requires_grad_(grads) for t in (qq, kk, vv)]
        facs = [t.detach().clone().requires_grad_(grads) for t in ax[:2]] if grads else []
        out, ex = flex_core.flex_attention(*leaves, sp, (*facs, *ax[len(facs):]), rate, dseed)
        got = None
        if grads:
            loss = torch.sum(out * g_out) + torch.sum(g_s * ex["graph_sum"])
            got = torch.autograd.grad(loss, leaves + facs)
        return out.detach(), ex, got

    full_out, full_ex, full_g = run(q, k, v, spec, aux, go, gs)
    out, ex, got = run(sq, sk, sv, s_spec, s_aux, go[:, h0:h0 + h].contiguous(),
                       gs[:, h0:h0 + h].contiguous())
    torch.cuda.synchronize()
    edges = int(torch.sum(torch.abs(ex["graph_sum"] - full_ex["graph_sum"][:, h0:h0 + h])))
    out_err = float(torch.max(torch.abs(out - full_out[:, h0:h0 + h])))
    grad_errs = {}
    if grads:
        for name, a, w in zip(GRAD_NAMES, got, full_g):
            grad_errs[name] = _rel_l2(a, w[:, h0:h0 + h])
    if not (edges == 0 and out_err <= SHARD_OUT_TOL
            and all(e <= SHARD_GRAD_RTOL for e in grad_errs.values())):
        raise AssertionError(f"{mod} at heads [{h0}, {h0 + h}) of {h_total}: {edges} edges "
                             f"apart, output {out_err}, gradients {grad_errs} against the full "
                             "launch's slice")
    captured = dict(q=sq, k=sk, v=sv, spec=s_spec, aux=s_aux, rate=rate, dseed=dseed,
                    inputs=f"head shard: heads {h0}-{h0 + h - 1} of {h_total}")
    shard = dict(heads=[h0, h0 + h], h_total=h_total, bh0=getattr(s_spec, "bh0", None),
                 edges_apart=edges, out_max_abs_vs_full=out_err, out_tol=SHARD_OUT_TOL,
                 grad_rel_l2_vs_full=grad_errs, grad_tol=SHARD_GRAD_RTOL)
    recs = {f"flex_fwd_{mod}@head_shard": dict(flex_check(mod, b, n, gen, dev,
                                                          captured=captured), **shard)}
    if grads:
        captured.update(go=go[:, h0:h0 + h].contiguous(), gs=gs[:, h0:h0 + h].contiguous())
        for fn, rec in bwd_check(mod, b, n, gen, dev, captured=captured).items():
            recs[f"{fn}@head_shard"] = dict(rec, **shard)
    emit("head_shard", kernel=mod, **shard)
    return recs


def tensor_checks(dev) -> dict:
    """Phase 3's checks of the ``tensor`` phase's kernels: K1 (on one plane),
    K2, K6, K7, K3/K4 and K8/K9 at a head shard of B 64, N 150 against the
    full launch's slice and their plain versions, timed (``head_shard``
    line); checked only: the shapes the tensor paths add (K7 at rate 0 and
    K1 at the decoded rows, K1 at the model × seq batch at N 512)."""
    gen = torch.Generator().manual_seed(SEED + 16)
    recs = {}
    for mod in ("cse", "sbm_expected", "sbm_sampled", "sbm_graph"):
        recs.update(head_shard_check(mod, gen, dev))
    flex_check("sbm_graph", TP_DECODE, 150, gen, dev, rate=0.0, timed=False)
    flex_check("cse", TP_DECODE, 150, gen, dev, timed=False)
    for b in sorted({TP_DECODE, TP_SEQ_B, TRAIN_B // 2}):
        flex_check("cse", b, 512, gen, dev, timed=False, r_len=512)
    emit("head_shard_times", **{key: dict(ms=rec["ms"], bound_ms=rec["bound_ms"],
                                          plain_ms=rec["plain_ms"],
                                          library_ms=rec.get("library_ms"))
                                for key, rec in recs.items()})
    return recs


def _tp_cfg(kind: str, overrides=None):
    """python at ("data", 1) × ("model", 2), or python_long at ("data", 1) ×
    ("model", 2) × ("seq", 2); ``overrides`` (narrow widths) only for the
    CPU rehearsal of the phase."""
    from csat_tpu_torch.configs import get_config

    over = dict(overrides or {})
    if kind == "tp":
        return get_config("python", mesh_shape=(("data", 1), ("model", TP_RANKS)), **over)
    return get_config("python_long", mesh_shape=(("data", 1), ("model", TP_RANKS),
                                                 ("seq", 2)), **over)


def _tp_batch(kind: str, cfg, device: str):
    if kind == "tp":
        return train_batch(cfg, TRAIN_B, device)
    return long_batch(cfg, TP_SEQ_B, nodes=(min(LONG_NODES[0], cfg.max_src_len // 2),
                                            cfg.max_src_len), device=device)


@contextlib.contextmanager
def sbm_graph_sums(kind: str):
    """Records each SBM layer's ΣA (B, heads held) of the forwards inside the
    block: the flex launches' ``graph_sum`` (``kind`` "tp"), the ring's
    (``kind`` "tp_seq"), with the K7 launches' inputs and outputs for the
    same-graph gate (``"caps"``, layers ``TP_GATE_LAYERS`` of the first
    forward) and the first sampled launch's q and R (``"first"``)."""
    from csat_tpu_torch.models import sbm as tsbm

    got = {"sums": [], "caps": [], "first": {}}
    flex, ring = tsbm.flex_attention, tsbm.ring_sbm_attention

    def flex_rec(q, k, v, spec, aux, rate=0.0, dseed=None):
        out, ex = flex(q, k, v, spec, aux, rate, dseed)
        if spec.name.startswith("sbm"):
            layer = len(got["sums"])
            got["sums"].append(ex["graph_sum"].detach().cpu())
            if spec.name == "sbm_sampled" and not got["first"]:
                got["first"].update(q=q.detach().cpu(), r=aux[0].detach().cpu())
            if spec.name == "sbm_graph" and layer in TP_GATE_LAYERS and layer < 4:
                got["caps"].append(dict(layer=layer, q=q.detach(), k=k.detach(),
                                        v=v.detach(), spec=spec,
                                        aux=tuple(t.detach() for t in aux), rate=rate,
                                        dseed=dseed, out=out.detach(),
                                        graph_sum=ex["graph_sum"].detach()))
        return out, ex

    def ring_rec(*a, **kw):
        out, gs = ring(*a, **kw)
        got["sums"].append(gs.detach().cpu())
        return out, gs

    tsbm.flex_attention, tsbm.ring_sbm_attention = flex_rec, ring_rec
    try:
        yield got
    finally:
        tsbm.flex_attention, tsbm.ring_sbm_attention = flex, ring


def tp_same_graph(caps) -> list:
    """Each captured SBM layer's K7 launch (a rank's heads, its own inputs)
    against the plain path on them: graph_sum the same (0 edges), output
    within ``GRAPH_TOL``."""
    from csat_tpu_torch.ops import flex_core

    recs = []
    for cap in caps:
        with torch.no_grad():
            ref, rex = flex_core.flex_reference(cap["q"], cap["k"], cap["v"], cap["spec"],
                                                cap["aux"], cap["rate"], cap["dseed"])
        edges = int(torch.sum(torch.abs(rex["graph_sum"] - cap["graph_sum"])))
        err = float(torch.max(torch.abs(ref - cap["out"])))
        rec = dict(layer=cap["layer"], heads=cap["spec"].heads, bh0=cap["spec"].bh0,
                   h_total=cap["spec"].h_total, edges_apart=edges, out_max_abs_err=err,
                   tol=GRAPH_TOL)
        if not (edges == 0 and err <= GRAPH_TOL):
            raise AssertionError(f"tensor: K7 against plain on layer {cap['layer']}'s own "
                                 f"inputs: {rec}")
        recs.append(rec)
    return recs


def tensor_rank(kind: str, rank: int, world: int, store: str, out: str,
                device: str = "cuda", overrides=None) -> None:
    """One rank of a gloo gate on ``cuda:0`` (``kind`` "tp": python at model
    2; "tp_seq": python_long at model 2 × seq 2), holding its shard of the
    heads: the decode of ``TP_DECODE`` ASTs at the initial parameters, then
    the train steps, the kernels' launches counted from 0 just before and
    read just after, each SBM layer's ΣA and (tp) the same-graph gate on
    its own K7 inputs; writes its record and its gathered parameters under
    ``out``."""
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.ops import build
    from csat_tpu_torch.parallel import ring as ring_mod
    from csat_tpu_torch.parallel.mesh import (
        broadcast_params, build_mesh, gather_params, shard_model)
    from csat_tpu_torch.train import create_train_state, default_optimizer, make_train_step

    if device == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2 if device == "cuda" else 1)
    cfg = _tp_cfg(kind, overrides)
    with process_group("gloo", world, rank, store):
        mesh = build_mesh(cfg.mesh_shape)
        batch = _tp_batch(kind, cfg, device)
        model = shard_model(CSATrans(cfg, SRC_VOCAB, TGT_VOCAB, device=device, seed=SEED), mesh)
        opt = default_optimizer(cfg)
        state = create_train_state(model, opt, SEED)
        step = make_train_step(model, opt, cfg, mesh)
        broadcast_params(state.params, mesh)
        few = _rows(batch, TP_DECODE)
        # the ring's inputs and outputs in the gated layers of the timed
        # step's forward (tp_seq), for the same-graph gate on its own inputs
        inner_ring, caps, calls = ring_mod._ring, [], []

        def ring_body(q, k, v, r, k_hat, key_pad, sseed, dseed, axis, rate, floor, bh0,
                      h_total=0):
            out_, spars = inner_ring(q, k, v, r, k_hat, key_pad, sseed, dseed, axis, rate,
                                     floor, bh0, h_total)
            if calls and len(calls) <= cfg.sbm_layers and len(calls) - 1 in TP_GATE_LAYERS:
                cpu = lambda t: None if t is None else t.detach().cpu().clone()
                caps.append(dict(layer=len(calls) - 1, q=cpu(q), k=cpu(k), v=cpu(v), r=cpu(r),
                                 k_hat=cpu(k_hat), key_pad=cpu(key_pad), sseed=cpu(sseed),
                                 dseed=cpu(dseed), rate=rate, floor=floor, bh0=bh0,
                                 h_total=h_total, out=cpu(out_), spars=cpu(spars)))
            if calls:
                calls.append(1)
            return out_, spars

        ring_mod._ring = ring_body
        build.reset_launches()
        rec = dict(rank=rank, mesh=mesh.shape, model_index=mesh.coord("model"),
                   seq_index=mesh.coord("seq"))
        with recorded_launches() as seen:
            toks, gaps = greedy_with_gaps(model, few, mesh.decode_shard(TP_DECODE))
            rec["tokens"], rec["gaps"] = toks.tolist(), gaps.tolist()
            with sbm_graph_sums(kind) as sums:
                calls.append(1)  # from here on: the timed step's forward
                base = _reset_peak(device)
                state, m, seconds = timed_step(step, state, batch)
                peak = _peak(device)
                calls.clear()
            ring_mod._ring = inner_ring
            if caps:
                torch.save(caps, os.path.join(out, f"{kind}_ring_{rank}.pt"))
            n_layers = cfg.sbm_layers
            rec.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                       sparsity=float(m["sparsity"]), nonfinite=bool(m["nonfinite"]),
                       step_s=seconds, peak_gb=peak / 1e9,
                       peak_above_start_gb=(peak - base) / 1e9,
                       graph_sums=[g.tolist() for g in sums["sums"][:n_layers]],
                       same_graph=tp_same_graph(sums["caps"]))
            del sums
            whole = gather_params(state.params, mesh)
            if rank == 0:
                torch.save(torch.cat([p.reshape(-1) for p in whole.values()]).cpu(),
                           os.path.join(out, f"{kind}_params.pt"))
            rec["params_digest"] = float(sum(torch.sum(p.double() * (i + 1)).item()
                                             for i, p in enumerate(whole.values())))
            del whole
            losses, times = [rec["loss"]], [seconds]
            for _ in range(TP_STEPS - 1 if kind == "tp" else 1):
                state, m, seconds = timed_step(step, state, batch)
                losses.append(float(m["loss"]))
                times.append(seconds)
            rec.update(losses=losses, step_times=times)
        rec.update(launches=build.launch_counts(), fwd=sorted(set(seen["fwd"])),
                   bwd=sorted(set(seen["bwd"])))
        with open(os.path.join(out, f"{kind}_rank_{rank}.json"), "w") as f:
            json.dump(rec, f)


def _tp_run_ranks(kind: str, tmp: str, world: int, device: str = "cuda",
                  overrides=None) -> list:
    store = os.path.join(tmp, f"gloo_{kind}")
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(REPO)!r}); "
         f"import chip_smoke; chip_smoke.tensor_rank({kind!r}, {r}, {world}, {store!r}, "
         f"{tmp!r}, {device!r}, {overrides!r})"], cwd=str(REPO), stdout=sys.stderr,
        stderr=sys.stderr) for r in range(world)]
    deadline = time.monotonic() + TP_TIMEOUT_S
    hung = []
    for r, p in enumerate(procs):
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            hung.append(r)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(10)
    if hung or any(p.returncode != 0 for p in procs):
        raise AssertionError(f"{kind} ranks: hung {hung}, exit codes "
                             f"{[p.returncode for p in procs]}")
    ranks = []
    for r in range(world):
        with open(os.path.join(tmp, f"{kind}_rank_{r}.json")) as f:
            ranks.append(json.load(f))
    ranks[0]["params0"] = torch.load(os.path.join(tmp, f"{kind}_params.pt"))
    return ranks


def _tp_one_process(kind: str, cfg, batch, device: str = "cuda") -> dict:
    """The one-process side on the card: the same weights, batch and
    generator state through the step without a mesh (ΣA of each layer
    recorded), its decode and its second step time."""
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.parallel.mesh import build_mesh
    from csat_tpu_torch.train import create_train_state, default_optimizer, make_train_step

    model = CSATrans(cfg, SRC_VOCAB, TGT_VOCAB, device=device, seed=SEED)
    opt = default_optimizer(cfg)
    state = create_train_state(model, opt, SEED)
    step = make_train_step(model, opt, cfg, build_mesh((("data", 1),)))
    rec = {}
    rec["tokens"], rec["gaps"] = greedy_with_gaps(model, _rows(batch, TP_DECODE))
    # the one-process SBM stack runs K6 / K7 on whole rows and every head
    with sbm_graph_sums("tp") as sums:
        base = _reset_peak(device)
        state, m, seconds = timed_step(step, state, batch)
        peak = _peak(device)
    rec.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               sparsity=float(m["sparsity"]), step_s=seconds, peak_gb=peak / 1e9,
               peak_above_start_gb=(peak - base) / 1e9,
               graph_sums=[g.numpy() for g in sums["sums"][:cfg.sbm_layers]],
               first=sums["first"], params=_flat_params(state))
    del sums
    state, _, rec["second_step_s"] = timed_step(step, state, batch)
    return rec


def tp_ring_same_graph(tmp: str, ranks, one: dict, device: str = "cuda") -> list:
    """(c) The ring on each ``model`` member's heads, gathered over its
    ``seq`` members to whole rows, against K6 (the plain path on the CPU) on
    those inputs at the member's global hash index: ΣA the same bits, the
    output within ``FLEX_TOL``.  Also how far the first gated layer's q and
    R are from the one-process step's for those heads (the CSE's
    row-parallel sums round apart from one process's, which moves a draw at
    its threshold)."""
    from csat_tpu_torch.ops.flex_core import flex_attention
    from csat_tpu_torch.ops.mods import SBMSampledSpec

    members = {}
    for r in ranks:
        members.setdefault(r["model_index"], []).append(r)
    recs = []
    for m, rs in sorted(members.items()):
        rs = sorted(rs, key=lambda r: r["seq_index"])
        caps = [torch.load(os.path.join(tmp, f"tp_seq_ring_{r['rank']}.pt")) for r in rs]
        for i, layer in enumerate(caps[0]):
            parts = [c[i] for c in caps]
            cat = lambda key, dim: torch.cat([p[key] for p in parts], dim=dim).to(device)
            q, k, v, r_, kh = (cat(key, 2) for key in ("q", "k", "v", "r", "k_hat"))
            padf = cat("key_pad", 1).to(torch.float32).contiguous()
            b, h, n, _ = q.shape
            spec = SBMSampledSpec(n=n, heads=h, kk=r_.shape[-1], floor=layer["floor"],
                                  bh0=layer["bh0"], h_total=layer["h_total"])
            aux = (r_.contiguous(), kh.contiguous(), padf, layer["sseed"].to(device))
            dseed = None if layer["dseed"] is None else layer["dseed"].to(device)
            with torch.no_grad():
                out, ex = flex_attention(q.contiguous(), k.contiguous(), v.contiguous(), spec,
                                         aux, layer["rate"], dseed)
            ring_gs = sum(p["spars"] for p in parts)
            ring_out = torch.cat([p["out"] for p in parts], dim=2)
            gs_equal = torch.equal(ex["graph_sum"].cpu(), ring_gs)
            out_err = float(torch.max(torch.abs(out.cpu() - ring_out)))
            rec = dict(model_index=m, layer=layer["layer"], heads=h, bh0=layer["bh0"],
                       h_total=layer["h_total"], graph_sum_equal=gs_equal,
                       graph_sum_entries_apart=int(torch.sum(ex["graph_sum"].cpu() != ring_gs)),
                       out_max_abs_err=out_err, tol=FLEX_TOL)
            if layer["layer"] == 0 and one.get("first"):
                h0 = layer["bh0"] % layer["h_total"]
                rec["inputs_max_abs_vs_one_process"] = {
                    key: float(torch.max(torch.abs(one["first"][key][:, h0:h0 + h]
                                                   - val.cpu())))
                    for key, val in (("q", q), ("r", r_))}
            if not (gs_equal and out_err <= FLEX_TOL):
                raise AssertionError(f"tp_seq: the ring on model member {m}'s heads against K6 "
                                     f"on layer {layer['layer']}'s own inputs: {rec}")
            recs.append(rec)
    return recs


def tensor_gate(kind: str, tmp: str, device: str = "cuda", overrides=None) -> dict:
    """(b) ``kind="tp"``: python at its published widths, its own dropout and
    noise, over ("data", 1) × ("model", 2), B 64, N 150; (c) ``kind="tp_seq"``:
    python_long over ("data", 1) × ("model", 2) × ("seq", 2), B 64 (32 when
    cut), N 512 — the ring on a head shard.  Each against one process from
    the same weights and generator state: loss within 1e-5 and grad-norm
    within 1e-4 relative, the gathered parameters the same on every rank and
    within ``TP_PARAMS_RTOL`` (relative L2) of one process's, ΣA per layer
    and the net edges apart recorded (tp_seq: the first SBM layer's equal),
    the same-graph gate on each gated layer's own K7 inputs (tp), the steps
    finite (tp: 8, the last below the first), ``TP_DECODE`` ASTs decoded to
    the one-process tokens up to a near tie, rank step seconds and peak
    memory beside one process's.  gloo stages every collective through the
    host: a correctness gate, no speed figure.  ``device`` and
    ``overrides`` (narrow widths) serve the CPU rehearsal only."""
    t0 = time.perf_counter()
    cfg = _tp_cfg(kind, overrides)
    world = TP_RANKS * (2 if kind == "tp_seq" else 1)
    batch = _tp_batch(kind, cfg, device)
    one = _tp_one_process(kind, cfg, batch, device)
    del batch
    if device == "cuda":
        torch.cuda.empty_cache()
    ranks = _tp_run_ranks(kind, tmp, world, device, overrides)
    r0 = ranks[0]
    loss_rel = abs(r0["loss"] / one["loss"] - 1)
    gnorm_rel = abs(r0["grad_norm"] / one["grad_norm"] - 1)
    same_metrics = all((r["loss"], r["grad_norm"], r["sparsity"]) == (
        r0["loss"], r0["grad_norm"], r0["sparsity"]) for r in ranks)
    same_params = all(r["params_digest"] == r0["params_digest"] for r in ranks)
    params_rel = _rel_l2(r0["params0"], one["params"])
    finite = all(np.all(np.isfinite(r["losses"])) and not r["nonfinite"] for r in ranks)
    # ΣA per layer: each model member's heads, from the first seq member
    heads = {}
    for r in ranks:
        heads.setdefault(r["model_index"], r["graph_sums"])
    tp_sums = [np.concatenate([np.array(heads[i][layer]) for i in sorted(heads)], axis=1)
               for layer in range(cfg.sbm_layers)]
    apart = [int(np.sum(a != b)) for a, b in zip(tp_sums, one["graph_sums"])]
    net = [float(np.sum(np.abs(a - b))) for a, b in zip(tp_sums, one["graph_sums"])]
    rec = dict(model=cfg.name, mesh=r0["mesh"], ranks=world, backend="gloo",
               device="cuda:0", batch=TRAIN_B if kind == "tp" else TP_SEQ_B,
               nodes=cfg.max_src_len, noise_mode=cfg.noise_mode, dropout=cfg.dropout,
               one_process=dict(loss=one["loss"], grad_norm=one["grad_norm"],
                                step_s=one["step_s"], second_step_s=one["second_step_s"],
                                peak_gb=one["peak_gb"],
                                peak_above_start_gb=one["peak_above_start_gb"]),
               loss=r0["loss"], grad_norm=r0["grad_norm"], loss_rel=loss_rel,
               loss_rtol=LOSS_RTOL, grad_norm_rel=gnorm_rel, grad_norm_rtol=GNORM_RTOL,
               params_equal_on_ranks=same_params, metrics_equal=same_metrics,
               params_rel_l2_vs_one_process=params_rel, params_rtol=TP_PARAMS_RTOL,
               graph_sum_entries_apart_by_layer=apart, net_edges_apart_by_layer=net,
               losses=r0["losses"], rank_step_s=[r["step_times"] for r in ranks],
               rank_peak_gb=[r["peak_gb"] for r in ranks],
               rank_peak_above_start_gb=[r["peak_above_start_gb"] for r in ranks],
               same_graph=[g for r in ranks for g in r["same_graph"]])
    rec["decode"] = [tokens_up_to_tie(np.array(r["tokens"]), one["tokens"], one["gaps"],
                                      f"{kind} rank {r['rank']}") for r in ranks]
    if kind == "tp":
        if not r0["losses"][-1] < r0["losses"][0]:
            raise AssertionError(f"tp: loss did not fall over {TP_STEPS} steps: "
                                 f"{r0['losses']}")
        if not rec["same_graph"]:
            raise AssertionError("tp: no K7 launch captured for the same-graph gate")
    else:
        rec["same_graph"] = tp_ring_same_graph(tmp, ranks, one, device)
        first = [g["inputs_max_abs_vs_one_process"] for g in rec["same_graph"]
                 if "inputs_max_abs_vs_one_process" in g]
        # the first SBM layer draws the one-process graph where its inputs are
        # the one-process inputs' bits; where the CSE's row-parallel sums
        # rounded them apart, a draw at its threshold may flip (recorded)
        if apart[0] and first and all(max(d.values()) == 0.0 for d in first):
            raise AssertionError(f"tp_seq: the first SBM layer's ΣA apart from one process on "
                                 f"the same inputs: {apart}")
    if not (loss_rel <= LOSS_RTOL and gnorm_rel <= GNORM_RTOL and same_params
            and same_metrics and finite and params_rel <= TP_PARAMS_RTOL):
        raise AssertionError(f"{kind}: {world} ranks against one process: loss rel {loss_rel}, "
                             f"grad-norm rel {gnorm_rel}, parameters equal on the ranks "
                             f"{same_params}, vs one process {params_rel}, metrics equal "
                             f"{same_metrics}, finite {finite}")
    path = f"tensor_{kind}"
    counts = {fn: sum(r["launches"][fn] for r in ranks) for fn in r0["launches"]}
    _check_launched(path, counts)
    launched = {tuple(f) for r in ranks for f in r["fwd"]}
    _check_rates(path, launched)
    rec.update(launches={fn: c for fn, c in counts.items() if c},
               forward_launch_shapes=sorted(launched),
               note="gloo stages every collective through the host: a correctness gate, "
                    "not a speed figure", seconds=time.perf_counter() - t0)
    emit(path, **rec)
    return rec


def tensor_serve(page_dtype: str, compute: str, card: str = "", device: str = "cuda",
                 overrides=None) -> dict:
    """(d) The serving trace of the ``serving`` phase (32 requests, 8 exact
    repeats) on the flagship with ``serve_mesh_shape=(1, 2)``, both head
    shards' pages on ``cuda:0``, against the solo engine on the same model:
    tokens and statuses equal bit for bit, prefix hits > 0, no page or chain
    leaked, K5 launched once per shard for each solo launch.  ``device`` and
    ``overrides`` (narrow widths) serve the CPU rehearsal only."""
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.ops import build
    from csat_tpu_torch.serve import ServeEngine

    cfg = flagship().replace(compute_dtype=compute, serve_kv_page_dtype=page_dtype,
                             **(overrides or {}))
    trace = serving_trace(cfg)
    model = CSATrans(cfg, SRC_VOCAB, TGT_VOCAB, device=device, seed=SEED)
    shard_devices = [f"{device}:0" if device == "cuda" else device] * 2
    runs, counts = {}, {}
    for name, c, kw in (("solo", cfg, {}),
                        ("mesh", cfg.replace(serve_mesh_shape=(1, 2)),
                         dict(mesh_devices=shard_devices))):
        engine = ServeEngine(model, c, device=device, **kw)
        build.reset_launches()
        with flex_launches() as launched, paged_launches() as paged:
            runs[name] = drive_trace(engine, trace)
        counts[name] = build.launch_counts()
        check_trace_run(runs[name], trace, f"tensor serve {name} ({page_dtype} pages)")
        runs[name].update(leaks=(engine.page_leaks(), engine.chain_leaks()), paged=paged,
                          launched=launched,
                          shards=(1 if engine.mesh is None else len(engine.mesh.devices)),
                          pages_shape=(None if engine.mesh is None else
                                       list(engine._pool.shards[0][2][0]["k"].shape)))
        engine.close()
        del engine
    solo, mesh = runs["solo"], runs["mesh"]
    statuses = [r.status for r in solo["results"]] == [r.status for r in mesh["results"]]
    equal = statuses and all(np.array_equal(a.tokens, b.tokens)
                             for a, b in zip(solo["results"], mesh["results"]))
    k5 = (counts["solo"]["paged_decode"], counts["mesh"]["paged_decode"])
    leaks = solo["leaks"] + mesh["leaks"]
    path = f"tensor_serve_{page_dtype}"
    if not (equal and not any(leaks) and k5[1] == 2 * k5[0] > 0 and mesh["hits"]):
        raise AssertionError(f"{path}: tokens and statuses equal {equal}, leaks {leaks}, K5 "
                             f"launches solo / mesh {k5}, mesh hits {len(mesh['hits'])}")
    _check_launched(path, counts["mesh"])
    _check_rates(path, mesh["launched"])
    s = mesh["summary"]
    rec = dict(card=card, compute_dtype=compute, page_dtype=page_dtype,
               serve_mesh_shape=[1, 2], devices=shard_devices,
               shard_pages_shape=mesh["pages_shape"], requests=len(trace["samples"]),
               repeats=SERVING_REPEATS, tokens_and_statuses_equal=True,
               tokens=sum(len(r.tokens) for r in mesh["results"]), hits=len(mesh["hits"]),
               page_leaks=0, chain_leaks=0, mesh_devices=s["mesh_devices"],
               kv_pages_worst_chip=s["kv_pages_worst_chip"],
               k5_launches_solo=k5[0], k5_launches_mesh=k5[1],
               k5_launches_per_shard=k5[1] // 2, drain_wall_s=dict(
                   solo=solo["wall"], mesh=mesh["wall"]),
               launches={fn: c for fn, c in counts["mesh"].items() if c})
    emit(path, **rec)
    return rec


def tensor_phase(card: str = "") -> dict:
    """Phase 14: (b) python over a model axis and (c) python_long over model
    × seq, as gloo ranks on ``cuda:0`` against one process; (d) one serving
    engine across two head shards against the solo engine, at f32 and at
    bf16 compute with int8 pages.  (c) is cut to B 32 when (b) and (c) at B
    64 would pass 150 s (the phase's first card run decides; the cut is
    listed in PERF.md §4)."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="csat_tensor_")
    try:
        recs = {kind: tensor_gate(kind, tmp) for kind in ("tp", "tp_seq")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    serves = {f"tensor_serve_{pages}": tensor_serve(pages, compute, card)
              for compute, pages in (("float32", "float32"), ("bfloat16", "int8"))}
    emit("tensor", seconds=time.perf_counter() - t0,
         paths=[f"tensor_{k}" for k in recs] + list(serves))
    launches = {f"tensor_{k}": rec["launches"] for k, rec in recs.items()}
    launches.update({path: rec["launches"] for path, rec in serves.items()})
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase 15: the serving engine's storage — KV tiers, the rect layout, warm start
# ---------------------------------------------------------------------------

#: the host tier's budget in pages: a few chains, the rest demote to disk
STORAGE_HOST_PAGES = 16
#: requests each warm-start process serves, and its time limit
WARM_REQUESTS = 8
WARM_TIMEOUT_S = 300.0


def tier_cfg(page_dtype: str, tier_dir: str, overrides=None):
    """The flagship with KV tiering on a pool of half the slots' worst case
    (``1 + slots · rect_pages_per_slot // 2``, JAX's ``tier_pair``), a host
    tier of ``STORAGE_HOST_PAGES`` and its disk tier in ``tier_dir``."""
    from csat_tpu_torch.serve.pages import page_geometry

    cfg = flagship().replace(serve_kv_page_dtype=page_dtype, serve_tiering=True,
                             serve_tier_host_pages=STORAGE_HOST_PAGES, serve_tier_dir=tier_dir,
                             obs_postmortem_dir="", **(overrides or {}))
    geo = page_geometry(cfg)
    return cfg.replace(serve_num_pages=1 + cfg.serve_slots * geo.rect_pages_per_slot // 2)


class SpillLog:
    """Records the payload of every snapshot an engine puts into its tiers,
    by content hash (a chain's bytes never change while it lives)."""

    def __init__(self, engine):
        self.payloads = {}
        inner = engine._tiers.put

        def put(key, payload, meta):
            self.payloads[key] = payload
            return inner(key, payload, meta)

        engine._tiers.put = put


@contextlib.contextmanager
def timed_calls(owner, name: str):
    """Time every call of ``owner.name`` while the block runs: yields the
    list of host-wall seconds, one entry a call."""
    inner, own = getattr(owner, name), name in vars(owner)
    times = []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return inner(*args, **kwargs)
        finally:
            times.append(time.perf_counter() - t0)

    setattr(owner, name, timed)
    try:
        yield times
    finally:
        if own:
            setattr(owner, name, inner)
        else:
            delattr(owner, name)


def _ms(times) -> dict:
    ms = [1e3 * t for t in times] or [0.0]
    return dict(calls=len(times), mean=float(np.mean(ms)), p95=float(np.percentile(ms, 95)))


def restored_bytes(engine, spilled) -> tuple:
    """Every cached chain that was once spilled, gathered again: ``(chains
    compared, hashes whose bytes differ from the spilled payload)``."""
    from csat_tpu_torch.serve.engine import _host_array
    from csat_tpu_torch.serve.pages import tier_gather

    n, bad = 0, []
    for key, entry in engine._prefix._entries.items():
        if key in spilled:
            vals, scales = tier_gather(engine._pool, entry.chain)
            n += 1
            if _host_array(vals).tobytes() + scales.cpu().numpy().tobytes() != spilled[key]:
                bad.append(key.hex()[:12])
    return n, bad


def _equal_runs(a, b) -> bool:
    """Statuses and tokens of two runs of one trace equal, bit for bit."""
    return ([r.status for r in a["results"]] == [r.status for r in b["results"]]
            and all(np.array_equal(x.tokens, y.tokens) for x, y in zip(a["results"], b["results"])))


def _quiescent(engine, label: str) -> None:
    if engine.occupancy or engine.queue_depth or engine.page_leaks() or engine.chain_leaks():
        raise AssertionError(f"{label}: {engine.page_leaks()} pages, {engine.chain_leaks()} "
                             f"chains leaked ({engine.occupancy} live, {engine.queue_depth} queued)")


def _miss_reasons(engine) -> list:
    return [f["reason"] for _, name, _, f in engine.obs.events() if name == "tier.restore_miss"]


def tier_drill(page_dtype: str, tmp: str, card: str = "", device: str = "cuda",
               overrides=None, cross_dtype: bool = False) -> dict:
    """(a) The ``serving`` trace on the tight tiered pool against a
    never-tiered engine on the same pool and weights: warm both, spill the
    tiered engine's whole warm set (host tier, then disk), replay — tokens
    and statuses equal to the never-tiered engine's bit for bit, restores,
    demotions and disk entries > 0, every restored chain's pages gathered
    again equal to its spilled bytes, no leak, one device read on each tick
    that only decodes (the card); then every snapshot corrupted: every
    restore a ``digest_mismatch`` miss, the requests re-prefilled, the tokens
    still equal, no leak.  ``cross_dtype`` (int8 pages) adds an f32 engine
    that adopts the int8 engine's disk tier: every restore a
    ``dtype_mismatch``.  Readings: restore p95 ms, spill ms per chain,
    bytes per spilled chain.  ``device`` and ``overrides`` serve the CPU
    rehearsal."""
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.ops import build
    from csat_tpu_torch.serve import ServeEngine
    from csat_tpu_torch.serve import engine as engine_module

    cfg = tier_cfg(page_dtype, os.path.join(tmp, f"tiers_{page_dtype}"), overrides)
    trace = serving_trace(cfg)
    model = CSATrans(cfg, SRC_VOCAB, TGT_VOCAB, device=device, seed=SEED)
    plain = ServeEngine(model, cfg.replace(serve_tiering=False), device=device)
    tiered = ServeEngine(model, cfg, device=device)
    spills = SpillLog(tiered)
    label = f"storage tiers ({page_dtype} pages)"
    build.reset_launches()
    with flex_launches() as launched:
        ref = drive_trace(plain, trace)
        warm = drive_trace(tiered, trace, count_syncs=device == "cuda")
        warm_restores = tiered._tiers.restores
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        spilled = tiered.spill_all()
        spill_s = time.perf_counter() - t0
        after_spill = dict(chains=spilled, entries=len(tiered._tiers),
                           host_pages=tiered._tiers.host_pages_in_use,
                           disk_pages=tiered._tiers.disk_pages_in_use,
                           disk_files=len([f for f in os.listdir(cfg.serve_tier_dir)
                                           if f.endswith(".kvp")]),
                           demotions=tiered._tiers.demotions)
        r0 = tiered._tiers.restores
        # the restore's parts: the store's get (index, disk read, digest)
        # and the writes into the pool (host wall: the copies are queued)
        with timed_calls(tiered._tiers, "get") as gets, \
                timed_calls(engine_module, "tier_restore") as writes:
            replay = drive_trace(tiered, trace)
        restores = tiered._tiers.restores - r0
        restore_ms = [1e3 * t for t in tiered.stats.tier_restore_s]
        compared, bad_bytes = restored_bytes(tiered, spills.payloads)
        _quiescent(tiered, label)
        tiered.spill_all()
        corrupted = tiered.corrupt_tiers()
        m0, p0 = tiered._tiers.restore_misses, tiered.prefills
        corrupt = drive_trace(tiered, trace)
        corrupt_misses = tiered._tiers.restore_misses - m0
        reprefills = tiered.prefills - p0
    counts = build.launch_counts()
    for name, run in (("never-tiered", ref), ("tiered warm", warm), ("replay", replay),
                      ("corrupt replay", corrupt)):
        if not all(r.ok for r in run["results"]):
            raise AssertionError(f"{label}, {name}: requests not OK")
    reasons = sorted(set(_miss_reasons(tiered)))
    checks = dict(warm_equal=_equal_runs(ref, warm), replay_equal=_equal_runs(ref, replay),
                  corrupt_equal=_equal_runs(ref, corrupt))
    if not (all(checks.values()) and restores > 0 and after_spill["demotions"] > 0
            and after_spill["disk_files"] > 0 and compared > 0 and not bad_bytes
            and corrupted > 0 and corrupt_misses > 0 and reasons == ["digest_mismatch"]
            and reprefills > 0):
        raise AssertionError(f"{label}: {checks}, restores {restores}, {after_spill}, restored "
                             f"chains compared {compared}, bytes differ {bad_bytes}, corrupted "
                             f"{corrupted}, misses {corrupt_misses} {reasons}, re-prefills "
                             f"{reprefills}")
    _quiescent(tiered, label)
    reads = reads_per_tick(warm["ticks"]) if device == "cuda" else None
    sizes = [len(p) for p in spills.payloads.values()]
    rec = dict(card=card, page_dtype=page_dtype, requests=len(trace["samples"]),
               repeats=SERVING_REPEATS, num_pages=cfg.serve_num_pages,
               host_tier_pages=STORAGE_HOST_PAGES, tokens_and_statuses_equal=True,
               tokens=sum(len(r.tokens) for r in replay["results"]),
               restores_in_warm_run=warm_restores, spilled_chains=spilled, after_spill=after_spill,
               restores=restores, restored_chains_bytes_equal=compared,
               corrupted_entries=corrupted, corrupt_misses=corrupt_misses,
               corrupt_miss_reasons=reasons, reprefills=reprefills, page_leaks=0, chain_leaks=0,
               restore_p95_ms=float(np.percentile(restore_ms, 95)),
               restore_ms_mean=float(np.mean(restore_ms)),
               restore_get_ms=_ms(gets), restore_write_ms=_ms(writes),
               spill_ms_per_chain=1e3 * spill_s / max(spilled, 1),
               bytes_per_spilled_chain=float(np.mean(sizes)), reads=reads,
               drain_wall_s=dict(never_tiered=ref["wall"], warm=warm["wall"],
                                 replay=replay["wall"], corrupt=corrupt["wall"]),
               launches={fn: c for fn, c in counts.items() if c})
    _check_launched(f"storage_tier_{page_dtype}", counts)
    _check_rates(f"storage_tier_{page_dtype}", launched)
    if cross_dtype:
        rec["cross_dtype"] = cross_dtype_drill(model, cfg, tiered, trace, device)
    plain.close()
    tiered.close()
    emit(f"storage_tier_{page_dtype}", **rec)
    rec["model"], rec["spilled"], rec["replay"] = model, spills.payloads, replay
    return rec


def cross_dtype_drill(model, cfg, source, trace, device: str) -> dict:
    """An f32-page engine over the int8 engine's disk tier (it adopts the
    int8 engine's index: the store keeps its index in memory): every restore
    of an int8 snapshot must be a ``dtype_mismatch`` and a re-prefill."""
    from csat_tpu_torch.serve import ServeEngine

    source.spill_all()
    f32 = ServeEngine(model, cfg.replace(serve_kv_page_dtype="float32"), device=device)
    f32._tiers._disk.update(source._tiers._disk)
    f32._tiers.disk_pages_in_use = source._tiers.disk_pages_in_use
    adopted = len(source._tiers._disk)
    run = drive_trace(f32, trace)
    reasons = _miss_reasons(f32)
    ok = all(r.ok for r in run["results"])
    if not (adopted and ok and reasons and set(reasons) == {"dtype_mismatch"}):
        raise AssertionError(f"int8 snapshots into an f32 pool: {adopted} adopted, all OK {ok}, "
                             f"misses {reasons}")
    _quiescent(f32, "int8 snapshots into an f32 pool")
    f32.close()
    return dict(adopted_disk_entries=adopted, misses=len(reasons), reasons=["dtype_mismatch"])


def tier_mesh(solo: dict, tmp: str, card: str = "", device: str = "cuda",
              overrides=None) -> dict:
    """(b) The same tiered drill on a ``(1, 2)`` serve mesh, both head
    shards on the engine's device: every chain's spilled payload equal to the
    solo tiered engine's byte for byte (the gather joins the shards' heads),
    the replay's tokens and statuses equal to the solo replay's bit for bit."""
    from csat_tpu_torch.ops import build
    from csat_tpu_torch.serve import ServeEngine

    cfg = tier_cfg("float32", os.path.join(tmp, "tiers_mesh"), overrides).replace(
        serve_mesh_shape=(1, 2))
    trace = serving_trace(cfg)
    shard_devices = [f"{device}:0" if device == "cuda" else device] * 2
    engine = ServeEngine(solo["model"], cfg, device=device, mesh_devices=shard_devices)
    spills = SpillLog(engine)
    build.reset_launches()
    with flex_launches() as launched:
        drive_trace(engine, trace)
        engine.spill_all()
        r0 = engine._tiers.restores
        replay = drive_trace(engine, trace)
    counts = build.launch_counts()
    restores = engine._tiers.restores - r0
    common = set(spills.payloads) & set(solo["spilled"])
    differ = [k.hex()[:12] for k in common if spills.payloads[k] != solo["spilled"][k]]
    equal = _equal_runs(solo["replay"], replay)
    if not (equal and common and not differ and restores > 0
            and set(spills.payloads) <= set(solo["spilled"])):
        raise AssertionError(f"storage mesh: replay equal {equal}, payloads compared "
                             f"{len(common)}, differ {differ}, restores {restores}")
    _quiescent(engine, "storage mesh")
    _check_launched("storage_mesh", counts)
    _check_rates("storage_mesh", launched)
    rec = dict(card=card, serve_mesh_shape=[1, 2], devices=shard_devices,
               payloads_compared=len(common), payloads_equal=True, restores=restores,
               replay_tokens_and_statuses_equal=True, page_leaks=0, chain_leaks=0,
               launches={fn: c for fn, c in counts.items() if c})
    engine.close()
    emit("storage_mesh", **rec)
    return rec


def rect_ab(card: str = "", device: str = "cuda", overrides=None) -> dict:
    """(c) The ``serving`` trace through the rect layout (prefix cache 0, as
    JAX's A/B) against the paged engine: tokens equal to the paged engine's
    K5 route up to a near tie (the rect run's top-2 log-prob gaps, below
    ``TIE_MARGIN``); whether they are bit-equal to the paged plain route's
    and to the K5 route's is printed.  The rect decode reads its
    rectangles through plain attention: K1 and K2 launch, K5 must not.
    Reading: the rect pool's KV bytes against the paged pool's peak."""
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.ops import build
    from csat_tpu_torch.serve import ServeEngine

    cfg = flagship().replace(obs_postmortem_dir="", **(overrides or {}))
    trace = serving_trace(cfg)
    model = CSATrans(cfg, SRC_VOCAB, TGT_VOCAB, device=device, seed=SEED)
    paged = ServeEngine(model, cfg, device=device)
    k5 = drive_trace(paged, trace)
    peak_pages = int(paged.stats.page_peak)
    with plain_route():
        plain = drive_trace(paged, trace)
    e = paged._pool.pages[0]
    page_bytes = len(paged._pool.pages) * 2 * (e["k"][0].numel() * e["k"].element_size()
                                                + e["k_scale"][0].numel() * 4)
    paged.close()
    log = MarginLog(model)
    rect = ServeEngine(model, cfg.replace(serve_kv_layout="rect", serve_prefix_cache=0),
                       device=device, clock=lambda: len(log.calls))
    build.reset_launches()
    try:
        with flex_launches() as launched:
            run = drive_trace(rect, trace)
    finally:
        del model.decode_step  # MarginLog's wrapper off again
    counts = build.launch_counts()
    if not all(r.ok for r in run["results"]) or counts["paged_decode"]:
        raise AssertionError(f"storage rect: requests not OK or K5 launched "
                             f"({counts['paged_decode']})")
    ties, compared = compare_tokens(k5["results"], dict(results=run["results"], log=log),
                                    "storage rect against the paged K5 route")
    _quiescent(rect, "storage rect")
    _check_launched("storage_rect", counts)
    _check_rates("storage_rect", launched)
    rect_bytes = sum(t.numel() * t.element_size() for c in rect._pool.cache for t in c.values())
    rec = dict(card=card, requests=len(trace["samples"]), prefix_cache=0,
               tokens_equal_up_to_tie=True, near_ties=ties, tokens_compared=compared,
               tie_margin=TIE_MARGIN,
               bit_equal_paged_plain=_equal_runs(run, plain), bit_equal_paged_k5=_equal_runs(run, k5),
               rect_kv_bytes=rect_bytes, paged_peak_pages=peak_pages,
               paged_peak_kv_bytes=peak_pages * page_bytes,
               drain_wall_s=dict(rect=run["wall"], paged_k5=k5["wall"], paged_plain=plain["wall"]),
               launches={fn: c for fn, c in counts.items() if c})
    rect.close()
    emit("storage_rect", **rec)
    return rec


def warm_leg(store: str, out: str, kernels: str) -> None:
    """One process of (d): the flagship engine with ``serve_warmstart`` over
    ``store``, building and loading its libraries in the directory
    ``kernels``, serves ``WARM_REQUESTS`` requests; writes the
    libraries' provenance, the libraries ``nvcc`` built (counted by wrapping
    the build call), the engine's start wall, tokens, statuses and launches
    to ``out``."""
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.ops import build
    from csat_tpu_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.BUILD_DIR = Path(kernels)
    built = []
    inner = build._nvcc_build

    def counted(todo):
        built.extend(todo)
        return inner(todo)

    build._nvcc_build = counted
    cfg = flagship().replace(serve_warmstart=True, serve_warmstart_dir=store,
                             obs_postmortem_dir="")
    model = CSATrans(cfg, SRC_VOCAB, TGT_VOCAB, device="cuda", seed=SEED)
    samples, budgets = make_requests(cfg, WARM_REQUESTS)
    build.reset_launches()
    with flex_launches() as launched:
        engine = ServeEngine(model, cfg, device="cuda")
        ids = [engine.submit(x, b) for x, b in zip(samples, budgets)]
        engine.drain()
        torch.cuda.synchronize()
    results = [engine.poll(i) for i in ids]
    with open(out, "w") as f:
        json.dump(dict(
            provenance=engine.warmstart_provenance, built=sorted(built),
            cold_start_s=engine.stats.cold_start_s, hits=int(engine.stats.warmstart_hits),
            misses=int(engine.stats.warmstart_misses),
            events=[name for _, name, _, _ in engine.obs.events() if name.startswith("warmstart")],
            statuses=[r.status for r in results],
            tokens=[[] if r.tokens is None else r.tokens.tolist() for r in results],
            launches=build.launch_counts(), flex=[list(x) for x in launched]), f)
    engine.close()


def warm_start_drill(card: str = "") -> dict:
    """(d) Warm start in fresh processes over one temporary store, each with
    its own empty kernel directory: cold — every library an ``absent`` miss,
    built by ``nvcc`` and saved; warm — every library a hit, ``nvcc`` never
    runs; the entries corrupted — ``digest_mismatch`` misses and a rebuild;
    ``CSAT_TPU_NO_CACHE=1`` — ``disabled``, and a build, since no store is
    asked and the kernel directory is empty.  Each serves the same requests,
    and the tokens must be equal bit for bit across the four.  Reading: the
    engine's start wall in each."""
    from csat_tpu_torch.ops import build
    from csat_tpu_torch.serve.warmstart import WarmStartStore

    tmp = tempfile.mkdtemp(prefix="csat_warm_")
    store = os.path.join(tmp, "store")
    libs = sorted(build.SERVE_LIBRARIES)

    def start(leg: str, kernels: str, extra_env=None):
        env = dict(os.environ, PYTHONPATH=str(REPO))
        env.pop("CSAT_TPU_NO_CACHE", None)
        env.update(extra_env or {})
        out = os.path.join(tmp, f"{leg}.json")
        kdir = os.path.join(tmp, kernels)
        proc = subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke as c; c.warm_leg({store!r}, {out!r}, {kdir!r})"],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return leg, out, proc

    def finish(started) -> dict:
        leg, out, proc = started
        try:
            log, _ = proc.communicate(timeout=WARM_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"warm-start {leg} process passed {WARM_TIMEOUT_S} s")
        if proc.returncode != 0:
            raise AssertionError(f"warm-start {leg} process exited {proc.returncode}:\n"
                                 f"{log[-3000:]}")
        with open(out) as f:
            return json.load(f)

    try:
        legs = {"cold": finish(start("cold", "kernels_cold"))}
        legs["warm"] = finish(start("warm", "kernels_warm"))
        corrupted = WarmStartStore(store).corrupt_entries()
        pending = [start("corrupt", "kernels_corrupt"),
                   start("disabled", "kernels_disabled", {"CSAT_TPU_NO_CACHE": "1"})]
        legs.update((p[0], finish(p)) for p in pending)
        entries = len(WarmStartStore(store).entries())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = dict(cold=("absent", libs), warm=("hit", []), corrupt=("digest_mismatch", libs),
                disabled=("disabled", libs))
    for leg, (prov, built) in want.items():
        got = legs[leg]
        if (got["provenance"] != {lib: prov for lib in libs} or got["built"] != built
                or any(s != "OK" for s in got["statuses"])):
            raise AssertionError(f"warm-start {leg}: provenance {got['provenance']}, nvcc built "
                                 f"{got['built']}, statuses {got['statuses']} (want {prov}, "
                                 f"{built}, all OK)")
        if got["tokens"] != legs["cold"]["tokens"]:
            raise AssertionError(f"warm-start {leg}: tokens differ from the cold process's")
    if corrupted != len(libs) or entries != len(libs):
        raise AssertionError(f"warm-start store: {corrupted} entries corrupted, {entries} kept")
    counts = {fn: sum(leg["launches"][fn] for leg in legs.values()) for fn in build.KERNELS}
    _check_launched("storage_warm", counts)
    _check_rates("storage_warm", [tuple(x) for leg in legs.values() for x in leg["flex"]])
    rec = dict(card=card, requests=WARM_REQUESTS, libraries=libs,
               provenance={leg: got["provenance"] for leg, got in legs.items()},
               nvcc_built={leg: got["built"] for leg, got in legs.items()},
               start_wall_s={leg: got["cold_start_s"] for leg, got in legs.items()},
               hits_misses={leg: [got["hits"], got["misses"]] for leg, got in legs.items()},
               events={leg: got["events"] for leg, got in legs.items()},
               tokens_equal=True, corrupted_entries=corrupted,
               launches={fn: c for fn, c in counts.items() if c})
    emit("storage_warm", **rec)
    return rec


def storage_phase(card: str = "") -> dict:
    """Phase 15: (a) KV tiering at f32 and int8 pages (int8 snapshots also
    refused by an f32 pool), (b) tiering on a ``(1, 2)`` serve mesh, (c) the
    rect layout against the paged one, (d) warm start in fresh processes."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="csat_storage_")
    try:
        f32 = tier_drill("float32", tmp, card)
        i8 = tier_drill("int8", tmp, card, cross_dtype=True)
        mesh = tier_mesh(f32, tmp, card)
        del f32["model"], i8["model"]
        rect = rect_ab(card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    warm = warm_start_drill(card)
    recs = {"storage_tier_float32": f32, "storage_tier_int8": i8, "storage_mesh": mesh,
            "storage_rect": rect, "storage_warm": warm}
    emit("storage", seconds=time.perf_counter() - t0, paths=list(recs))
    return {"launches": {path: rec["launches"] for path, rec in recs.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace a serving run, two train steps of each noise mode, one "
                         "expected-graph gradient pass, the restored fit epoch, two "
                         "train steps each in f32 and bf16, a third run of the "
                         "serving trace and two steps of each long-AST config with "
                         "torch.profiler")
    args = ap.parse_args(argv)
    smi = device_phase()
    build_phase()
    from csat_tpu_torch.ops import build

    dev = torch.device("cuda")
    measured = kernel_phase(dev)
    served = serve_phase(args.profile)
    trained = train_phase(args.profile)
    shared = train_shared_phase(args.profile)
    expected = expected_grad_phase(args.profile)
    with fit_corpus() as corpus:
        fitted = fit_phase(args.profile, corpus)
        fitted_default = fit_default_phase(corpus)
        variants = variants_phase()
        precision = precision_phase(args.profile)
        resilience = resilience_phase(corpus)
        serving = serving_phase(corpus, smi, args.profile)
    long_ast = long_ast_phase(args.profile)
    parallel = parallel_phase()
    tensor = tensor_phase(smi)
    storage = storage_phase(smi)
    by_path = {"serve": served["launches"], "train_counter": trained["launches"],
               "train_shared": shared["launches"], "expected_grad": expected["launches"],
               "fit": fitted["launches"], "fit_default": fitted_default["launches"],
               **{name: rec["launches"] for name, rec in variants.items()},
               **precision["launches"], "resilience": resilience["launches"],
               "serving": serving["launches"], **long_ast["launches"],
               **parallel["launches"], **tensor["launches"], **storage["launches"]}
    kernels = []
    for fn, lib in build.KERNELS.items():
        m = measured[fn]
        launches = {path: counts[fn] for path, counts in by_path.items() if counts.get(fn)}
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
