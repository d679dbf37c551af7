"""Config: the fields of the JAX package's ``configs.Config`` that the port
reads, under the same names and defaults, plus the named registry.

Field names are identical to the reference's so one set of overrides builds
both configs.  The trainer's fields are here (data paths, epochs, validation
and save intervals, bucketing, eval decode, input prefetch, profiling, the
scalar log and telemetry, guard rollback, preemption saves, the step
watchdog, the data error budget, checkpoint retries), the serving engine's
(the slot and page pools, the prefix cache, admission control, deadlines,
priorities and brownout, the tick watchdog, the poison budget, rebuild and
retry caps, the reaper's margin, request traces), and the precision axes:
``compute_dtype`` (bf16 compute with f32 attention islands),
``init_scheme`` (flax's or the reference's realised initialisation) and
``serve_kv_page_dtype`` (f32, bf16 or int8 KV pages), and the parallel
layer's: ``mesh_shape`` (its ``data``, ``model``, ``seq`` and ``pipe`` axes
run over ``torch.distributed``, ``parallel/mesh.py``), ``remat`` (each CSE
layer and SBM block recomputed in the backward), ``seq_impl`` (the ring over
a ``seq`` axis, ``parallel/ring.py``), the pipeline's ``pipeline_stages`` /
``pipeline_microbatches`` (GPipe over a ``pipe`` axis,
``parallel/pipeline.py``) and ``serve_mesh_shape`` (one serving engine
across head shards), validated by the JAX rules, and the serving engine's
storage (``serve_kv_layout``: the paged pool or the per-slot rectangles;
``serve_tiering`` and its host / disk tiers below the page pool;
``serve_warmstart``: the kernel library store), and the replica fleet's
(``serve_replicas``, the fleet queue bound, the reap-storm trip, the
resubmission backoff) and its autoscaler's (``serve_min_replicas`` /
``serve_max_replicas``, ``serve_autoscale`` and the ``serve_autoscale_*``
signals, hysteresis, cooldown and churn bound), the network front door's
(``serve_net_*``) and the burn-rate SLOs' (``slo_*``), and the machine's
calibration probes' (``calib_*``, read by
``obs/calibrate.py:calibration_kwargs``).  Fields that only
select JAX/TPU machinery (``backend``, compilation caches, AOT warm-up,
``flex_bwd``) are absent, and so is the bench history's file
(``bench_history_file``), which the port's benchmark, still to come, will
name; and so is ``param_dtype``, which the JAX package declares but reads
nowhere (its master weights are f32 whatever it
says): the port picks kernel or plain path by the device a tensor lies on,
and a field it never reads is not one it pretends to honour.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

@dataclasses.dataclass(frozen=True)
class Config:
    name: str = "python"
    project_name: str = "final_exp"
    task_name: str = "default"
    lang: str = "python"  # "python" | "java": selects the triplet vocabulary

    # model (reference defaults: config/python.py)
    seed: int = 2021
    use_pegen: str = "pegen"
    pe_dim: int = 256
    pegen_dim: int = 512
    sbm_enc_dim: int = 512
    num_layers: int = 4  # CSE depth
    sbm_layers: int = 4
    clusters: Tuple[int, ...] = (10, 10, 10, 10)
    full_att: bool = False
    num_heads: int = 8
    hidden_size: int = 512
    dim_feed_forward: int = 2048
    decoder_layers: int = 4
    tree_pos_width: int = 8
    tree_pos_height: int = 16

    # data
    data_dir: str = "./processed/tree_sitter_python"
    max_tgt_len: int = 50
    max_src_len: int = 150

    # SBM graph: Bernoulli clamp floor, the noise of the sampled graph
    # ("shared": uniform noise from the generator through the STE, the
    # sbm_graph mod; "counter": the hash stream drawn in-kernel, the
    # sbm_sampled mod), and the eval-time graph ("expected" = the Bernoulli
    # mean clip(Q̂SK̂ᵀ, floor, .99), the deterministic graph served; "sample"
    # draws a graph at eval too)
    sbm_floor: float = 0.01
    noise_mode: str = "shared"
    eval_graph: str = "sample"

    # length-bucketed execution (data/bucketing.py): each sample goes to the
    # smallest fitting (N, T) bucket, batched under a node budget
    # (0 = batch_size · max_src_len); () ladders = the geometric halving
    # ladder for N and the flagship T only
    bucketing: bool = False
    bucket_src_lens: Tuple[int, ...] = ()
    bucket_tgt_lens: Tuple[int, ...] = ()
    bucket_token_budget: int = 0
    # eval decode stops once every row has emitted </s> (off: the reference
    # always runs max_tgt_len - 1 steps; the metric transform truncates at
    # the first </s> either way)
    decode_early_eos: bool = False

    # training (reference: config/python.py, script/train.py)
    dropout: float = 0.2
    attention_dropout: float = 0.2  # fixed 0.2 in the reference
    sw: float = 1e-2  # sparsity-regularizer weight
    learning_rate: float = 1e-4
    smoothing: float = 0.0  # label smoothing
    batch_size: int = 64
    num_epochs: int = 500
    val_interval: int = 5
    save_interval: int = 50
    is_test: bool = False
    output_dir: str = "./outputs"

    # host input pipeline: collate, widen and copy to the device up to this
    # many batches ahead on a worker thread (train/loop.py:prefetch_batches);
    # 0 = synchronous
    prefetch: int = 2

    # observability: one profiled epoch (torch.profiler trace under
    # output_dir/trace plus host_trace.json); scalars.jsonl with an `it`
    # record every scalar_log_every iterations (0 = epoch records only);
    # the flight recorder's ring (0 = off); post-mortem dumps ("auto" =
    # output_dir/postmortem, "" = none); JSONL metrics snapshots ("" = off)
    # and their cadence.  All host-side: no device syncs (the `it` records
    # read the loss, so they sync at their cadence, only when scalar_log)
    profile: bool = False
    scalar_log: bool = False
    scalar_log_every: int = 50
    obs_events: int = 4096
    obs_postmortem_dir: str = "auto"
    obs_metrics_file: str = ""
    obs_metrics_every_s: float = 10.0

    # resilience: the in-step non-finite guard (decided on the device); roll
    # back to the last good snapshot after this many consecutive guarded
    # steps (0 = never); read the device counter every guard_check_every
    # steps (each read is a host-device sync); give up after
    # guard_max_rollbacks; refresh the snapshot every snapshot_every_steps
    # known-good iterations (0 = at epoch starts only); SIGTERM/SIGINT → a
    # final snapshot + resume marker (preempt_save); abort resumably (exit
    # 76) when no step completes for watchdog_timeout_s (0 = off), with a
    # device-liveness probe (watchdog_device_probe); quarantine up to
    # data_error_budget malformed batches (0 = fail on the first); bounded
    # retry around checkpoint saves
    nonfinite_guard: bool = True
    guard_rollback_after: int = 3
    guard_check_every: int = 16
    guard_max_rollbacks: int = 3
    snapshot_every_steps: int = 0
    preempt_save: bool = True
    watchdog_timeout_s: float = 0.0
    watchdog_device_probe: bool = False
    data_error_budget: int = 0
    save_retries: int = 3
    save_retry_backoff_s: float = 0.5

    # serving: slot pool and the block-paged KV pool
    serve_slots: int = 8
    serve_prefill_budget: int = 0
    serve_page_size: int = 16
    serve_num_pages: int = 0

    # the parallel layer: named mesh axes, a size of -1 filled with the
    # process count (parallel/mesh.py:build_mesh); the "data" axis is data
    # parallelism over torch.distributed.  seq_impl selects the
    # sequence-parallel attention of a "seq" axis ("ring" requires counter
    # noise; without a seq axis it changes nothing); pipeline_stages > 1
    # splits the SBM blocks into GPipe stages over a "pipe" axis
    # (microbatches 0 = the stage count)
    mesh_shape: Tuple[Tuple[str, int], ...] = (("data", 1), ("model", 1))
    seq_impl: str = "allgather"
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0
    # one serving engine across devices: () or (h,) head shards, or (1, h) —
    # (data, head) axis sizes, the data axis 1; the KV pages split on the
    # head axis (the paged layout only)
    serve_mesh_shape: Tuple[int, ...] = ()
    # recompute each CSE layer and SBM block in the backward instead of
    # keeping its activations (torch.utils.checkpoint): the long-AST memory
    # lever, the JAX package's nn.remat
    remat: bool = False

    # precision: "bfloat16" runs the dense layers, LayerNorms and residual
    # stream in bf16 with the attention bodies (CSE and SBM cores, the
    # decoder's scores, softmax and ·V, the paged decode) as f32 islands and
    # the output head and loss in f32; the parameters stay f32 master weights
    compute_dtype: str = "float32"
    # "flax": per-module xavier; "reference": the reference's realised
    # distributions (packed-fan decoder q/k/v kernels, U(±1/√fan_in) Linear
    # biases outside attention; models/init.py)
    init_scheme: str = "flax"
    # storage dtype of the paged KV pool: "float32", "bfloat16" or "int8"
    # (rows quantized on write with an f32 per-row scale, dequantized on
    # read); anything but f32 requires the paged layout
    serve_kv_page_dtype: str = "float32"
    # KV layout of the serving pool: "paged" (block pages through per-slot
    # page tables, serve/pages.py) or "rect" (one (S, H, T, dh) self and
    # (S, H, N, dh) cross rectangle per layer, serve/slots.py: the paged
    # layout's A/B reference, bit-identical on deterministic configs)
    serve_kv_layout: str = "paged"
    # warm start (serve/warmstart.py): the built kernel libraries are kept,
    # digest-verified, in a store under the cache root, and a later engine
    # loads them instead of running nvcc; "" = <cache root>/warmstart
    # (CSAT_TPU_NO_CACHE disables the store regardless)
    serve_warmstart: bool = False
    serve_warmstart_dir: str = ""
    # tiered KV page store (serve/tiering.py): evicted prefix-cache chains
    # spill to host RAM and on to a digest-verified disk tier, and a later
    # identical admission restores them into fresh pages.  Requires the
    # paged layout and a prefix cache.  Budgets in KV pages (0 = unbounded);
    # the disk directory "" = <output_dir>/kv_tiers (unwritable: host only)
    serve_tiering: bool = False
    serve_tier_host_pages: int = 0
    serve_tier_disk_pages: int = 0
    serve_tier_dir: str = ""
    # cross-request prefix cache (serve/prefix.py): entries mapping a content
    # hash of a request's encoder input to a refcounted cross-KV page chain,
    # so an identical resubmission skips prefill and shares the pages; 0 = off
    serve_prefix_cache: int = 64
    # admission control: queue bound (0 = unbounded) and what a full queue
    # does — "reject" the newcomer, or "shed_oldest" (the least important
    # queued request, FIFO-oldest within its tier)
    serve_max_queue: int = 0
    serve_queue_policy: str = "reject"
    # default per-request deadline, seconds from submit (0 = none)
    serve_deadline_s: float = 0.0
    # tick watchdog: trip when no scheduler tick completes for this long while
    # work is in flight (0 = off; default action: exit 76)
    serve_watchdog_timeout_s: float = 0.0
    # malformed samples refused at submit before the budget raises
    serve_poison_budget: int = 64
    # pool rebuilds after device faults before the fault propagates; a
    # request's resubmissions across rebuilds
    serve_max_rebuilds: int = 2
    serve_max_retries: int = 1
    # an admitted row not retired within limit + this many ticks is reaped
    serve_reap_margin: int = 4
    # tenant tiers (0 = most important; 1 = single-class FIFO); brownout caps
    # tiers > 0 at serve_brownout_max_new_tokens once the queue crosses
    # serve_brownout_queue_frac of serve_max_queue; REJECTED / SHED carry a
    # retry hint of serve_retry_after_s scaled by queue depth (0 = none)
    serve_priority_classes: int = 1
    serve_brownout_queue_frac: float = 0.75
    serve_brownout_max_new_tokens: int = 8
    serve_retry_after_s: float = 0.5
    # the replica fleet (serve/fleet.py): engine replicas behind the router
    # (1 = one engine, the fleet bypassed by the CLI); the fleet-wide queue
    # bound over the healthy replicas (0 = serve_max_queue × healthy), under
    # serve_queue_policy; a replica whose reaped count reaches
    # serve_fleet_reap_storm retires (0 = off); a retired replica's
    # zero-token requests are resubmitted after base · 2^(attempt-1) seconds,
    # capped, with deterministic jitter in [0.5x, 1.0x) (0 = at once)
    serve_replicas: int = 1
    serve_fleet_max_queue: int = 0
    serve_fleet_reap_storm: int = 0
    serve_resubmit_backoff_s: float = 0.05
    serve_resubmit_backoff_max_s: float = 2.0
    # the autoscaler (serve/autoscale.py): heal and scale between these
    # bounds (serve_max_replicas 0 = the constructed size), evaluated every
    # serve_autoscale_every_ticks fleet ticks.  Scale up on any of queue per
    # healthy slot, worst page occupancy, class-0 p95 over its SLO (0 = off);
    # down on both queue per slot and busy-slot fraction under theirs; a
    # signal must hold serve_autoscale_hysteresis evaluations; scale actions
    # are serve_autoscale_cooldown_s apart, and every action (heals too)
    # counts against serve_autoscale_max_actions per churn window
    serve_min_replicas: int = 1
    serve_max_replicas: int = 0
    serve_autoscale: bool = False
    serve_autoscale_every_ticks: int = 8
    serve_autoscale_up_queue_frac: float = 1.5
    serve_autoscale_up_page_frac: float = 0.85
    serve_autoscale_p95_slo_s: float = 0.0
    serve_autoscale_down_queue_frac: float = 0.1
    serve_autoscale_down_busy_frac: float = 0.25
    serve_autoscale_hysteresis: int = 3
    serve_autoscale_cooldown_s: float = 5.0
    serve_autoscale_max_actions: int = 8
    serve_autoscale_churn_window_s: float = 60.0
    # the streaming network front door (serve/netfront.py): listen address
    # (loopback by default; port 0 = ephemeral, printed at start), the
    # per-connection send-buffer bound in bytes (past it the connection is
    # stalled and its streams stop enqueueing), how long a stalled
    # connection lives before it is dropped, the heartbeat cadence (0 =
    # off), the per-stream replay ring in frames, tokens per frame (0 = all
    # newly decoded ones) and the finished streams kept for late resumes
    serve_net_host: str = "127.0.0.1"
    serve_net_port: int = 0
    serve_net_client_buffer: int = 65536
    serve_net_stall_timeout_s: float = 5.0
    serve_net_heartbeat_s: float = 0.0
    serve_net_frame_ring: int = 256
    serve_net_frame_tokens: int = 0
    serve_net_done_retain: int = 512
    # request traces (obs/rtrace.py): finished traces kept (0 = tracing off)
    # and the longest ones kept past ring eviction
    obs_traces: int = 256
    obs_trace_slowest: int = 8
    # burn-rate SLOs (obs/slo.py): the availability target, the latency
    # threshold per priority class in seconds (entry p for class p, a shorter
    # tuple reusing its last entry, () = no latency objectives) and their
    # target fraction, and the multi-window alert: it fires while both the
    # fast and the slow window burn past their thresholds (burn 1.0 = the
    # error budget spent exactly on schedule).  Observe-only
    slo_availability: float = 0.999
    slo_latency_s: Tuple[float, ...] = ()
    slo_latency_target: float = 0.95
    slo_fast_window_s: float = 60.0
    slo_slow_window_s: float = 300.0
    slo_burn_fast: float = 14.0
    slo_burn_slow: float = 6.0
    # the machine's calibration probes (obs/calibrate.py), run before a
    # benchmark measures the port: which probes (() = all of them), the
    # square matmul operand's size, the bandwidth probe's array in MiB, the
    # dispatch probe's loop length, and the wall-clock budget of the whole
    # suite (a probe past it is skipped with its reason).  Read through
    # ``obs.calibrate.calibration_kwargs``, as the JAX package's bench reads
    # them.  The defaults are JAX's; on an H100 n 512 and 64 MiB time the
    # launch, so chip_smoke.py calibrates at n 8192 and 1024 MiB through
    # these fields
    calib_probes: Tuple[str, ...] = ()
    calib_matmul_n: int = 512
    calib_memory_mb: int = 64
    calib_dispatch_iters: int = 50
    calib_budget_s: float = 45.0

    # reference-compat quirk flags (same meanings as the JAX package)
    generator_dropout: bool = True
    pad_row: str = "zero"
    cse_empty_rows: str = "uniform"

    @property
    def head_dim(self) -> int:
        return self.sbm_enc_dim // self.num_heads

    @property
    def src_emb_dim(self) -> int:
        return self.sbm_enc_dim - self.pe_dim

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        assert self.use_pegen in (
            "pegen", "laplacian", "sequential", "treepos", "triplet"), self.use_pegen
        assert self.pad_row in ("zero", "frozen"), self.pad_row
        assert self.cse_empty_rows in ("uniform", "zero"), self.cse_empty_rows
        assert self.eval_graph in ("sample", "expected"), self.eval_graph
        assert self.noise_mode in ("shared", "counter"), self.noise_mode
        assert self.compute_dtype in ("float32", "bfloat16"), self.compute_dtype
        assert self.init_scheme in ("flax", "reference"), self.init_scheme
        assert self.serve_kv_page_dtype in ("float32", "bfloat16", "int8"), (
            self.serve_kv_page_dtype)
        assert 0.0 <= self.dropout < 1.0 and 0.0 <= self.attention_dropout < 1.0
        assert self.sbm_enc_dim % self.num_heads == 0
        assert self.hidden_size % self.num_heads == 0
        assert self.num_heads % 2 == 0, "CSE splits heads into L and T halves"
        assert len(self.clusters) == self.sbm_layers
        assert self.serve_slots >= 1, self.serve_slots
        assert self.serve_kv_layout in ("paged", "rect"), self.serve_kv_layout
        if self.serve_kv_page_dtype != "float32":
            # quantized storage exists only in the paged pool: the
            # rectangles have no scale arrays
            assert self.serve_kv_layout == "paged", (
                "serve_kv_page_dtype != 'float32' requires serve_kv_layout='paged'")
        assert self.serve_page_size >= 1, self.serve_page_size
        assert self.serve_num_pages >= 0, self.serve_num_pages
        assert self.serve_prefill_budget >= 0, self.serve_prefill_budget
        assert self.serve_prefix_cache >= 0, self.serve_prefix_cache
        assert self.serve_max_queue >= 0, self.serve_max_queue
        assert self.serve_queue_policy in ("reject", "shed_oldest"), (
            self.serve_queue_policy)
        assert self.serve_deadline_s >= 0, self.serve_deadline_s
        assert self.serve_watchdog_timeout_s >= 0, self.serve_watchdog_timeout_s
        assert self.serve_poison_budget >= 0, self.serve_poison_budget
        assert self.serve_max_rebuilds >= 0, self.serve_max_rebuilds
        assert self.serve_max_retries >= 0, self.serve_max_retries
        assert self.serve_reap_margin >= 1, self.serve_reap_margin
        assert self.serve_replicas >= 1, self.serve_replicas
        assert self.serve_fleet_max_queue >= 0, self.serve_fleet_max_queue
        assert self.serve_fleet_reap_storm >= 0, self.serve_fleet_reap_storm
        assert self.serve_priority_classes >= 1, self.serve_priority_classes
        assert 0 < self.serve_brownout_queue_frac <= 1, (
            self.serve_brownout_queue_frac)
        assert self.serve_brownout_max_new_tokens >= 0, (
            self.serve_brownout_max_new_tokens)
        assert self.serve_retry_after_s >= 0, self.serve_retry_after_s
        assert self.serve_resubmit_backoff_s >= 0, self.serve_resubmit_backoff_s
        assert self.serve_resubmit_backoff_max_s >= self.serve_resubmit_backoff_s, (
            self.serve_resubmit_backoff_max_s)
        assert self.serve_tier_host_pages >= 0, self.serve_tier_host_pages
        assert self.serve_tier_disk_pages >= 0, self.serve_tier_disk_pages
        if self.serve_tiering:
            # tier keys are prefix-cache content hashes and payloads are
            # page snapshots: tiering without both has nothing to spill
            assert self.serve_kv_layout == "paged", (
                "serve_tiering requires serve_kv_layout='paged'")
            assert self.serve_prefix_cache > 0, (
                "serve_tiering requires a prefix cache (serve_prefix_cache > 0)")
        assert self.serve_net_port >= 0, self.serve_net_port
        assert self.serve_net_client_buffer >= 1, self.serve_net_client_buffer
        assert self.serve_net_stall_timeout_s >= 0, self.serve_net_stall_timeout_s
        assert self.serve_net_heartbeat_s >= 0, self.serve_net_heartbeat_s
        assert self.serve_net_frame_ring >= 1, self.serve_net_frame_ring
        assert self.serve_net_frame_tokens >= 0, self.serve_net_frame_tokens
        assert self.serve_net_done_retain >= 1, self.serve_net_done_retain
        assert len(self.serve_mesh_shape) <= 2, (
            f"serve_mesh_shape {self.serve_mesh_shape}: at most (data, head) axis sizes")
        assert all(s >= 1 for s in self.serve_mesh_shape), self.serve_mesh_shape
        mesh_devs = 1
        for s in self.serve_mesh_shape:
            mesh_devs *= s
        if mesh_devs > 1 and len(self.serve_mesh_shape) == 2:
            # one replica sharded on the head axis: a data axis > 1 would
            # replicate work (the JAX package's rung (1))
            assert self.serve_mesh_shape[0] == 1, (
                f"serve_mesh_shape {self.serve_mesh_shape}: the leading (data) axis must be "
                "1 — only the head axis shards")
        if mesh_devs > 1:
            assert self.serve_kv_layout == "paged", (
                "serve_mesh_shape spanning >1 device requires serve_kv_layout='paged' (page "
                "arrays shard on the head axis; the rect pool has no sharded layout)")
        self._validate_autoscale()
        assert self.obs_traces >= 0, self.obs_traces
        assert self.obs_trace_slowest >= 0, self.obs_trace_slowest
        assert 0 < self.slo_availability < 1, self.slo_availability
        assert all(t > 0 for t in self.slo_latency_s), self.slo_latency_s
        assert 0 < self.slo_latency_target < 1, self.slo_latency_target
        assert self.slo_fast_window_s > 0, self.slo_fast_window_s
        assert self.slo_slow_window_s >= self.slo_fast_window_s, self.slo_slow_window_s
        assert self.slo_burn_fast > 0, self.slo_burn_fast
        assert self.slo_burn_slow > 0, self.slo_burn_slow
        self._validate_calibration()
        assert all(n >= 1 for n in self.bucket_src_lens), self.bucket_src_lens
        assert all(t >= 2 for t in self.bucket_tgt_lens), self.bucket_tgt_lens
        assert self.bucket_token_budget >= 0, self.bucket_token_budget
        assert self.guard_rollback_after >= 0, self.guard_rollback_after
        assert self.guard_check_every >= 1, self.guard_check_every
        assert self.guard_max_rollbacks >= 0, self.guard_max_rollbacks
        assert self.snapshot_every_steps >= 0, self.snapshot_every_steps
        assert self.watchdog_timeout_s >= 0, self.watchdog_timeout_s
        assert self.data_error_budget >= 0, self.data_error_budget
        assert self.scalar_log_every >= 0, self.scalar_log_every
        assert self.obs_events >= 0, self.obs_events
        assert self.obs_metrics_every_s > 0, self.obs_metrics_every_s
        assert self.save_retries >= 1, self.save_retries
        self._validate_parallel()
        if self.use_pegen == "sequential":
            assert self.pe_dim == 0
        else:
            assert 0 < self.pe_dim < self.sbm_enc_dim
        if self.use_pegen == "treepos":
            assert self.pegen_dim % (self.tree_pos_width * self.tree_pos_height) == 0

    def _validate_autoscale(self) -> None:
        """The JAX package's rules for the autoscaler's band and signals
        (``csat_tpu/configs.py:674-700``)."""
        assert self.serve_min_replicas >= 1, self.serve_min_replicas
        assert self.serve_max_replicas >= 0, self.serve_max_replicas
        if self.serve_max_replicas:
            assert self.serve_max_replicas >= self.serve_min_replicas, self.serve_max_replicas
        assert self.serve_autoscale_every_ticks >= 1, self.serve_autoscale_every_ticks
        assert self.serve_autoscale_up_queue_frac > 0, self.serve_autoscale_up_queue_frac
        assert 0 < self.serve_autoscale_up_page_frac <= 1, self.serve_autoscale_up_page_frac
        assert self.serve_autoscale_p95_slo_s >= 0, self.serve_autoscale_p95_slo_s
        assert self.serve_autoscale_down_queue_frac >= 0, self.serve_autoscale_down_queue_frac
        assert 0 <= self.serve_autoscale_down_busy_frac <= 1, (
            self.serve_autoscale_down_busy_frac)
        assert self.serve_autoscale_hysteresis >= 1, self.serve_autoscale_hysteresis
        assert self.serve_autoscale_cooldown_s >= 0, self.serve_autoscale_cooldown_s
        assert self.serve_autoscale_max_actions >= 1, self.serve_autoscale_max_actions
        assert self.serve_autoscale_churn_window_s > 0, self.serve_autoscale_churn_window_s

    def _validate_calibration(self) -> None:
        """The JAX package's rules for the calibration probes
        (``csat_tpu/configs.py:712-721``), against the port's own probes."""
        from csat_tpu_torch.obs.calibrate import PROBES

        assert all(p in PROBES for p in self.calib_probes), (
            f"calib_probes {self.calib_probes}: each must be one of {PROBES}")
        assert self.calib_matmul_n >= 8, self.calib_matmul_n
        assert self.calib_memory_mb >= 1, self.calib_memory_mb
        assert self.calib_dispatch_iters >= 1, self.calib_dispatch_iters
        assert self.calib_budget_s > 0, self.calib_budget_s

    def _validate_parallel(self) -> None:
        """The JAX package's rules for the parallel fields
        (``csat_tpu/configs.py:581-598, 734-818``), and the head split a
        ``model`` axis needs (JAX refuses it when it places the sharded
        parameters)."""
        axes = dict(self.mesh_shape)
        assert len(axes) == len(self.mesh_shape), f"repeated mesh axis in {self.mesh_shape}"
        assert all(size == -1 or size >= 1 for size in axes.values()), self.mesh_shape
        assert list(axes.values()).count(-1) <= 1, f"more than one -1 in {self.mesh_shape}"
        assert self.seq_impl in ("allgather", "ring"), self.seq_impl
        if self.seq_impl == "ring" and self.noise_mode != "counter" and not self.full_att:
            # full_att models never Bernoulli-sample, so ring works there
            raise ValueError(
                "seq_impl='ring' requires noise_mode='counter': every device must be able "
                "to regenerate any (q, k) block's Bernoulli draws from global indices")
        if self.eval_graph == "expected" and axes.get("seq", 1) > 1:
            raise ValueError("eval_graph='expected' does not compose with a sharded 'seq' "
                             "mesh axis (ring configs keep eval_graph='sample')")
        if self.bucketing:
            if self.pipeline_stages > 1:
                raise ValueError("bucketing does not compose with pipeline_stages>1 (v1): "
                                 "per-bucket batch sizes vary")
            if axes.get("seq", 1) > 1:
                raise ValueError("bucketing does not compose with a sharded 'seq' mesh axis "
                                 "(v1): bucket node counts need not divide the seq shard count")
        # the device feed ships offset distances as int16 in the JAX package
        # (its data/dataset.py:Batch): beyond this bound they would wrap
        assert self.max_src_len < 2 ** 15, (
            f"max_src_len={self.max_src_len} exceeds the int16 compressed batch feed")
        assert self.pipeline_stages >= 0 and self.pipeline_microbatches >= 0
        if self.pipeline_stages > 1:
            if self.sbm_layers % self.pipeline_stages:
                raise ValueError(f"pipeline_stages={self.pipeline_stages} must divide "
                                 f"sbm_layers={self.sbm_layers}")
            if not self.full_att and len(set(self.clusters)) != 1:
                raise ValueError("pipeline execution stacks stage params — clusters must be "
                                 f"uniform, got {self.clusters}")
            if any(name in ("model", "seq") and size != 1 for name, size in axes.items()):
                raise ValueError("pipeline_stages>1 composes with the 'data' mesh axis only")
            if axes.get("pipe") != self.pipeline_stages:
                raise ValueError(f"pipeline_stages={self.pipeline_stages} needs a ('pipe', "
                                 f"{self.pipeline_stages}) axis in mesh_shape (got "
                                 f"{self.mesh_shape})")
            n_micro = self.pipeline_microbatches or self.pipeline_stages
            data = axes.get("data", 1)
            divisor = n_micro if data == -1 else data * n_micro
            if self.batch_size % divisor:
                raise ValueError(f"batch_size={self.batch_size} must divide evenly into "
                                 f"data_shards×microbatches (= {divisor})")
        model = axes.get("model", 1)
        if model > 1 and self.num_heads % model:
            raise ValueError(f"num_heads={self.num_heads} must divide evenly over the "
                             f"('model', {model}) mesh axis")


# the registry: one named variant per reference config file, as the JAX
# package registers them (csat_tpu/configs.py:861-895), with its long-AST
# entries (N 512, remat, counter noise, data-parallel over every process,
# the ring under a seq axis) and its pipeline-parallel entry
_PY = Config(name="python", task_name="256_512_512_4_4_10_10_10_10_b64_tgt50_vanilla",
             lang="python", data_dir="./processed/tree_sitter_python")
_JAVA = _PY.replace(name="java", task_name="128_768_512_4_4_10_10_10_10_b64_tgt50_10k_20k_java",
                    lang="java", pe_dim=128, sbm_enc_dim=768,
                    data_dir="./processed/tree_sitter_java")

_REGISTRY = {}


def _reg(cfg: Config) -> Config:
    cfg.validate()
    _REGISTRY[cfg.name] = cfg
    return cfg


_reg(_PY)
_reg(_PY.replace(name="python_full_att", full_att=True))
_reg(_PY.replace(name="python_lap", use_pegen="laplacian"))
_reg(_PY.replace(name="python_seq", use_pegen="sequential", pe_dim=0, pegen_dim=0))
_reg(_PY.replace(name="python_treepos", use_pegen="treepos"))
_reg(_PY.replace(name="python_triplet", use_pegen="triplet"))
_reg(_PY.replace(name="python_compare_asttrans",
                 data_dir="./processed_ast_trans_data/tree_sitter_python"))
_reg(_PY.replace(name="python_compare_codescribe",
                 data_dir="./processed/compare_codescribe_python"))
_reg(_JAVA)
_reg(_JAVA.replace(name="java_full_att", full_att=True))
_reg(_JAVA.replace(name="java_lap", use_pegen="laplacian"))
_reg(_JAVA.replace(name="java_seq", use_pegen="sequential", pe_dim=0, pegen_dim=0))
_reg(_JAVA.replace(name="java_treepos", use_pegen="treepos"))
_reg(_JAVA.replace(name="java_triplet", use_pegen="triplet"))
_reg(_JAVA.replace(name="java_compare_codescribe",
                   data_dir="./processed/compare_codescribe_java"))
# Long-AST stress configs (max_ast_len=512, data-parallel over every
# process): the JAX entries' fields; seq_impl="ring" takes the SBM stack
# under a seq axis, e.g. --set "mesh_shape=(('data', -1), ('seq', 2))"
_reg(_JAVA.replace(name="java_long", task_name="long_ast_512", max_src_len=512,
                   mesh_shape=(("data", -1),), noise_mode="counter", remat=True,
                   seq_impl="ring"))
_reg(_PY.replace(name="python_long", task_name="long_ast_512", max_src_len=512,
                 mesh_shape=(("data", -1),), noise_mode="counter", remat=True,
                 seq_impl="ring"))

# the 4 SBM blocks as 2 GPipe stages over a pipe axis, composed with the
# data axis (4 microbatches, counter noise)
_reg(_PY.replace(name="python_pp", task_name="pp2_gpipe",
                 mesh_shape=(("data", -1), ("pipe", 2)),
                 pipeline_stages=2, pipeline_microbatches=4, noise_mode="counter"))

def list_configs():
    return sorted(_REGISTRY)


def get_config(name: str, **overrides) -> Config:
    """Look up a named variant; keyword overrides are applied on top."""
    cfg = _REGISTRY[name]
    if overrides:
        cfg = cfg.replace(**overrides)
        cfg.validate()
    return cfg


def config_from_dict(d: dict) -> Config:
    """Rebuild a :class:`Config` from ``dataclasses.asdict`` output that
    round-tripped through JSON (a run's resolved config, stamped into its
    records).  Tuple fields come back as lists and are restored (the SLO
    latencies and the calibration probe names too, which the JAX package
    leaves as lists); unknown keys (fields of a newer or older schema, or
    JAX-only ones) are dropped rather than fatal.  Validated."""
    known = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in d.items() if k in known}
    if "clusters" in kw:
        kw["clusters"] = tuple(int(c) for c in kw["clusters"])
    for lens in ("bucket_src_lens", "bucket_tgt_lens"):
        if lens in kw:
            kw[lens] = tuple(int(v) for v in kw[lens])
    if "mesh_shape" in kw:
        kw["mesh_shape"] = tuple((str(n), int(s)) for n, s in kw["mesh_shape"])
    if "serve_mesh_shape" in kw:
        kw["serve_mesh_shape"] = tuple(int(s) for s in kw["serve_mesh_shape"])
    if "slo_latency_s" in kw:
        kw["slo_latency_s"] = tuple(float(t) for t in kw["slo_latency_s"])
    if "calib_probes" in kw:
        kw["calib_probes"] = tuple(str(p) for p in kw["calib_probes"])
    cfg = Config(**kw)
    cfg.validate()
    return cfg


def cli_config(name: str, overrides: dict) -> Config:
    """:func:`get_config` for a command line: an unknown name, or overrides
    the config's rules refuse (``ValueError``, ``AssertionError``), exits
    with its one line."""
    if name not in _REGISTRY:
        raise SystemExit(f"unknown config {name!r}; choose from {list_configs()}")
    try:
        return get_config(name, **overrides)
    except (ValueError, AssertionError) as e:
        raise SystemExit(f"{name}: {e}")
