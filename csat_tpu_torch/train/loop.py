"""Training harness: the train step, validation, the epoch loop.

Counterpart of the JAX package's ``train/loop.py``:

* :func:`make_train_step` (``:107-205``): one step is the teacher-forced
  forward in training mode, ``nll + sw · sparsity`` (times an optional
  ``loss_scale``), the backward — through the hand-written kernels on the
  card — the non-finite guard, decided on the device, and the AdamW update;
  the step reads nothing on the host;
* :func:`prefetch_batches` (``:49-104``): a worker thread collates, widens
  and copies batches to the device ahead of the loop, on a copy stream of
  its own;
* :func:`evaluate_bleu` / :func:`run_test` (``:363-423``): greedy decodes of
  a dataset scored by mean per-sentence smoothed BLEU (validation) or corpus
  BLEU / ROUGE-L / METEOR with a dump of the predictions (test);
* :class:`Trainer` (``:385``): vocabularies, model and optimizer from a
  config; ``fit`` runs the epoch loop with fixed-shape or length-bucketed
  batches, validation every ``val_interval`` epochs, the best-by-BLEU
  parameters kept and saved, periodic checkpoints (asynchronous with the
  default hook, and durable before ``fit`` returns), guard-driven rollback to
  the last good snapshot (the guard's counter read every
  ``guard_check_every`` steps), a SIGTERM/SIGINT handler that saves a
  mid-epoch snapshot and raises ``Preempted``, the step watchdog, the data
  error budget, the fault injector's hooks, and resume from a boundary
  checkpoint or a mid-epoch snapshot by replaying the epoch's deterministic
  batch sequence.  Its telemetry: a metrics registry behind the history
  counters, a flight recorder of phase spans and resilience events dumped
  to post-mortem files on fault paths, ``scalars.jsonl`` and one epoch
  profiled with ``torch.profiler`` (``cfg.profile``).

The step runs the model in its compute dtype (``cfg.compute_dtype``: f32,
or bf16 with f32 attention islands), takes the loss in f32 and brings f32
gradients to the f32 master weights, with the non-finite guard as in f32;
the weights start from ``cfg.init_scheme``'s draw (``models/init.py``).

PyTorch runs eagerly, so a bucket shape needs no compiled program: the JAX
trainer's program cache and AOT warm-up have no counterpart.  Its mesh's
``data`` axis is data parallelism over ``torch.distributed``
(``parallel/mesh.py``): each process of the group steps on its own shard of
every epoch, the gradients are summed in the step, the validation decode is
sharded and its sums reduced, and rank 0 alone writes checkpoints, the
scalar log and the resume marker, with barriers around them.  Under a
``model`` axis each process holds its shard of the parameters
(``parallel.mesh.shard_model``); checkpoints and the best parameters are
gathered whole over the ``model`` line before rank 0 writes them, so a
state file is what one process writes, and a restore cuts it back to this
process's shard.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from csat_tpu_torch.configs import Config
from csat_tpu_torch.data.bucketing import (
    iterate_bucketed_batches, pad_batch, plan_signature)
from csat_tpu_torch.data.dataset import (
    DEVICE_FIELDS, ASTDataset, Batch, batch_to_device, iterate_batches)
from csat_tpu_torch.data.vocab import Vocab, load_vocab
from csat_tpu_torch.metrics import batch_bleu, bleu_output_transform, eval_accuracies
from csat_tpu_torch.models import CSATrans
from csat_tpu_torch.obs import EventRecorder, MetricsFile, MetricsRegistry, write_chrome_trace
from csat_tpu_torch.parallel import host
from csat_tpu_torch.parallel.mesh import (
    DATA_AXIS, Mesh, allreduce_grads, allreduce_sums, broadcast_params, build_mesh,
    gather_params, global_grad_norm, shard_model, shard_params)
from csat_tpu_torch.resilience.guards import (
    TrainingDivergedError, guarded_apply, host_snapshot, restore_snapshot)
from csat_tpu_torch.resilience.preemption import (
    Preempted, PreemptionHandler, abort_barrier, coordinated_trigger, preempt_dir,
    read_resume_marker, snapshot_step, write_resume_marker)
from csat_tpu_torch.resilience.retry import ErrorBudget, retry
from csat_tpu_torch.resilience.watchdog import StepWatchdog, device_liveness_probe
from csat_tpu_torch.train.checkpoint import (
    latest_step, restore_latest, restore_params, restore_state, save_params, save_state,
    wait_for_saves, whole_state)
from csat_tpu_torch.train.decode import decode_fn
from csat_tpu_torch.train.loss import label_smoothing_loss
from csat_tpu_torch.train.optimizer import AdamW
from csat_tpu_torch.train.state import (
    TrainState, create_train_state, default_optimizer, make_model, triplet_dictionary)
from csat_tpu_torch.utils import PAD, resolve_device

__all__ = ["make_train_step", "evaluate_bleu", "prefetch_batches", "run_test", "Trainer"]


def make_train_step(model: torch.nn.Module, optimizer: AdamW, cfg: Config,
                    mesh: Optional[Mesh] = None
                    ) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, batch, bad_steps=0, loss_scale=1.0) → (state,
    metrics)``.  ``batch`` holds tensors on the model's device
    (``data.dataset.batch_to_device``).  The state's parameters and moments
    are updated in place; after the call every parameter's ``.grad`` holds
    this step's gradient.  ``metrics``, all 0-d tensors on the device (the
    step reads none of them on the host): ``loss`` (the NLL), ``sparsity``,
    ``total``, ``grad_norm``, and with ``cfg.nonfinite_guard`` (the
    default) ``nonfinite`` and ``bad_steps`` — a non-finite loss or
    grad-norm skips the update; ``bad_steps`` is the consecutive count,
    threaded from one step's metrics to the next call.

    The randomness (the hash seeds of the sampled graphs and the attention
    dropout, the shared mode's graph noise, the model-dropout masks) comes
    from ``state.generator``.

    Data parallelism (``mesh``, default ``build_mesh(cfg.mesh_shape)`` over
    the current ``torch.distributed`` group): each process passes its own
    rows of the global batch — the rank-ordered concatenation of the
    processes' batches — and the step equals the one-process step on the
    global batch.  The graphs are drawn at the rows' global indices, the
    NLL is normalised by the global count of non-PAD targets (one small
    all-reduce before the forward), the sparsity by the global row count,
    the gradients are summed with one flat all-reduce per dtype before the
    guarded update, and the metrics are the global batch's; the guard
    decides on the summed gradients, so every process decides alike and
    the parameters stay the same bits everywhere.  The graph noise and the
    dropout masks are the rows' slices of draws at the global batch's shape,
    so every process draws the same hash seeds and the masks one process
    would draw.  Nothing is read on the host.

    Sequence and pipeline parallelism (the mesh's ``seq`` / ``pipe`` axes):
    the processes of one data shard pass the same rows; the SBM stack runs
    as the ring over ``seq`` or the GPipe wavefront over ``pipe``
    (``models/sbm.py``), everything else on whole rows on each of them.
    Each backpropagates ``1/(seq·pipe)`` of the loss and the gradients are
    summed over every process, so a parameter computed on every process
    (the CSE, the decoder) gets its gradient once and one computed on a
    shard (a ring block, a stage's layers) gets the shards' sum; the
    metrics are summed over the data axis only.  Over gloo a card's
    point-to-point hops go through the host.

    Tensor parallelism (the mesh's ``model`` axis; ``model`` carries its
    shards, ``parallel.mesh.shard_model``): the members of a ``model`` line
    pass the same rows and each holds the whole loss; a shard's gradient is
    summed over the processes holding that shard, a replicated parameter's
    is whole on every member already, and one a member applies to its own
    heads only is summed over every process (``allreduce_grads``); the
    grad-norm counts each shard and each replicated parameter once
    (``global_grad_norm``), so the guard decides alike everywhere."""
    mesh = mesh if mesh is not None else build_mesh(cfg.mesh_shape)

    def train_step(state: TrainState, batch: Batch, bad_steps=0,
                   loss_scale: float = 1.0):
        for p in state.params.values():
            p.grad = None
        shard = mesh.shard(batch.src_seq.shape[0])
        log_probs, sparsity = model(batch, deterministic=False, gen=state.generator,
                                    shard=shard)
        ntokens = allreduce_sums(torch.sum(batch.target != PAD), mesh)
        nll = label_smoothing_loss(log_probs, batch.target, cfg.smoothing, ntokens)
        total = (nll + cfg.sw * sparsity) * loss_scale
        # the seq · pipe processes of a data shard each hold its whole loss:
        # each backpropagates its share, and the all-reduce below sums them
        (total / mesh.replicas if mesh.replicas > 1 else total).backward()
        for p in state.params.values():
            if p.grad is None:  # a pipeline stage's blocks on the other stages
                p.grad = torch.zeros_like(p)
        grads = {k: p.grad for k, p in state.params.items()}
        allreduce_grads(grads, mesh)
        nll, sparsity, total = allreduce_sums(
            torch.stack([nll.detach(), sparsity.detach(), total.detach()]), mesh)
        metrics = {"loss": nll, "sparsity": sparsity, "total": total}
        gnorm = global_grad_norm(grads, mesh)
        if cfg.nonfinite_guard:
            ok, gnorm, bad = guarded_apply(optimizer, state.params, grads, state.opt_state,
                                           total, bad_steps, gnorm)
            metrics.update(grad_norm=gnorm, nonfinite=~ok, bad_steps=bad)
        else:
            optimizer.update(state.params, grads, state.opt_state)
            metrics.update(grad_norm=gnorm)
        state.step += 1
        return state, metrics

    return train_step


def _pad_batch(batch: Batch, size: int, max_src_len: Optional[int] = None) -> Tuple[Batch, int]:
    """Pad a ragged tail batch to ``size`` rows (the collate of empty
    samples), so every eval batch of a bucket has one shape; callers slice
    the results back to the real row count."""
    return pad_batch(batch, rows=size, max_src_len=max_src_len)


def _decode_dataset(model: CSATrans, dataset: ASTDataset, cfg: Config,
                    gen: Optional[torch.Generator] = None, decode: Optional[Callable] = None,
                    num_shards: int = 1, shard_index: int = 0, mesh: Optional[Mesh] = None
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(y_pred, target)`` per batch, tail-padded to a static shape.

    With ``cfg.bucketing`` each batch arrives at its bucket's node capacity
    and is row-padded to the bucket's node-budget batch size, so short
    sequences decode in proportionally less time and per-sample outputs are
    unchanged.  Eval buckets the NODE axis only: a T bucket is chosen by the
    sample's REFERENCE length, so decoding ``t - 1`` steps would truncate
    hypotheses as a function of the label — metrics get the full
    ``max_tgt_len - 1`` decode budget whatever the bucketing.  ``num_shards``
    / ``shard_index`` decode one process's share of the dataset (the JAX
    ``host_shard``); under ``mesh``'s ``seq`` / ``pipe`` axes each batch's
    encoder runs along them (:meth:`Mesh.decode_shard`)."""
    decode = decode or decode_fn(model)
    if cfg.bucketing:
        eval_cfg = cfg.replace(bucket_tgt_lens=(cfg.max_tgt_len,))
        batches = ((batch, spec.batch_size) for spec, batch in iterate_bucketed_batches(
            dataset, eval_cfg, shuffle=False, drop_last=False, num_shards=num_shards,
            shard_index=shard_index, with_spec=True))
    else:
        batches = ((batch, cfg.batch_size) for batch in iterate_batches(
            dataset, cfg.batch_size, shuffle=False, drop_last=False, num_shards=num_shards,
            shard_index=shard_index))
    for batch, rows in batches:
        batch, real = _pad_batch(batch, rows, max_src_len=cfg.max_src_len)
        target = np.asarray(batch.target)[:real]
        shard = None if mesh is None else mesh.decode_shard(rows)
        y_pred = decode(model, batch_to_device(batch, model.device), gen, shard)
        yield y_pred[:real].cpu().numpy(), target


def evaluate_bleu(model: CSATrans, dataset: ASTDataset, cfg: Config, tgt_vocab: Vocab,
                  gen: Optional[torch.Generator] = None,
                  decode: Optional[Callable] = None, mesh: Optional[Mesh] = None) -> float:
    """Mean per-sentence smoothed BLEU over greedy decodes (the reference's
    BLEU4 validation metric).  With a data-parallel ``mesh`` each process
    decodes its share of the dataset and the sums are reduced over the
    processes (the JAX ``host_shard`` and ``_allreduce_sums``): every
    process returns the same score."""
    shards = (1, 0) if mesh is None else (mesh.data, mesh.coord(DATA_AXIS))
    total, count = 0.0, 0
    for y_pred, target in _decode_dataset(model, dataset, cfg, gen, decode, *shards, mesh):
        hyps, refs = bleu_output_transform(y_pred, target, tgt_vocab.i2w)
        scores = batch_bleu(hyps, refs)
        total += float(np.sum(scores))
        count += len(scores)
    if mesh is not None and mesh.axis(DATA_AXIS).group is not None:
        sums = allreduce_sums(torch.tensor([total, float(count)], dtype=torch.float64,
                                           device=_collective_device(model.device)), mesh)
        total, count = float(sums[0]), int(sums[1])
    return total / count if count else 0.0


def _collective_device(device: torch.device) -> torch.device:
    """Where a collective's tensor lives: the card under NCCL, else the CPU."""
    import torch.distributed as dist

    return device if dist.get_backend() == "nccl" else torch.device("cpu")


def run_test(model: CSATrans, dataset: ASTDataset, cfg: Config, tgt_vocab: Vocab,
             gen: Optional[torch.Generator] = None,
             output_dir: Optional[str] = None) -> Dict[str, float]:
    """Full test evaluation of the model as it stands: corpus BLEU, ROUGE-L
    and METEOR over greedy decodes; with ``output_dir`` also dumps
    ``predict_results_bleu_X_rouge_Y_meteor_Z.json``."""
    all_hyps, all_refs = [], []
    for y_pred, target in _decode_dataset(model, dataset, cfg, gen):
        hyps, refs = bleu_output_transform(y_pred, target, tgt_vocab.i2w)
        all_hyps.extend(hyps)
        all_refs.extend(refs)
    hypotheses = {i: [" ".join(h)] for i, h in enumerate(all_hyps)}
    references = {i: [" ".join(r)] for i, r in enumerate(all_refs)}
    bleu, rouge_l, meteor, ind_bleu, ind_rouge = eval_accuracies(hypotheses, references)
    if output_dir:
        outputs = [{"predict": hypotheses[i][0], "true": references[i][0],
                    "bleu": ind_bleu[i], "rouge": float(ind_rouge[i])} for i in hypotheses]
        fname = f"predict_results_bleu_{bleu:.2f}_rouge_{rouge_l:.2f}_meteor_{meteor:.2f}.json"
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, fname), "w") as f:
            json.dump(outputs, f)
    return {"bleu": bleu, "rouge_l": rouge_l, "meteor": meteor}


def _stage(batch: Batch, device: torch.device, stream) -> Tuple[Batch, Any]:
    """One batch's device fields widened on the host; on the card also copied
    into pinned memory and on to the device asynchronously on ``stream``,
    with the event that marks the copies done."""
    host = {name: torch.as_tensor(np.asarray(getattr(batch, name))).to(dtype)
            for name, dtype in DEVICE_FIELDS}
    if stream is None:
        return batch._replace(**{k: t.to(device) for k, t in host.items()}), None
    with torch.cuda.stream(stream):
        moved = {k: t.pin_memory().to(device, non_blocking=True) for k, t in host.items()}
        ready = torch.cuda.Event()
        ready.record(stream)
    return batch._replace(**moved), ready


def prefetch_batches(batches: Iterable[Batch], device, depth: int = 2) -> Iterator[Batch]:
    """``batches`` on ``device`` as :func:`~csat_tpu_torch.data.dataset.batch_to_device`
    gives them, in the same order with the same contents, prepared up to
    ``depth`` batches ahead by a worker thread: it runs the host iterator
    (collate, the resilience hooks), widens the device fields, and on the
    card writes them into pinned memory and copies them with
    ``non_blocking=True`` on a copy stream of its own, recording an event.
    The consumer makes its current stream — the one the train step runs on —
    wait for that event and calls ``record_stream`` on each tensor, so the
    caching allocator cannot hand a buffer to another tensor while the step
    still reads it.  The host input pipeline thus overlaps the step instead
    of serialising with it (a pageable copy would also sync the host).

    An exception in the worker (``DataErrorBudgetExceeded`` among them) is
    re-raised on the consumer side; closing the generator (a rollback, a
    preemption, an error in the step) stops the worker, waits for it and
    drops what it queued.  ``depth=0`` is the plain synchronous loop.  The
    worker touches no generator of the train state: dropout and the sampled
    graphs keep drawing on the caller's thread."""
    device = torch.device(device)
    if depth <= 0:
        for b in batches:
            yield batch_to_device(b, device)
        return
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()  # set when the consumer abandons the generator

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def work() -> None:
        try:
            with torch.cuda.device(device) if stream is not None else contextlib.nullcontext():
                for b in batches:
                    if not put(_stage(b, device, stream)):
                        return  # consumer gone: stop instead of pinning batches
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer side
            put(e)
            return
        put(end)

    worker = threading.Thread(target=work, name="prefetch", daemon=True)
    worker.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            batch, ready = item
            if ready is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(ready)
                for name, _ in DEVICE_FIELDS:
                    getattr(batch, name).record_stream(current)
            yield batch
    finally:
        stop.set()
        while worker.is_alive():
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass
        worker.join()


def _timed_batches(batches: Iterable[Batch], obs: EventRecorder,
                   annotate: bool = False) -> Iterator[Batch]:
    """Wrap a batch iterator so the time spent WAITING on it (collate +
    host→device transfer not hidden by the prefetch thread) is recorded as
    ``train.data`` phase spans — the host-input share of the step."""
    it = iter(batches)
    while True:
        with obs.span("train.data", annotate=annotate):
            try:
                batch = next(it)
            except StopIteration:
                return
        yield batch


class Trainer:
    """End-to-end trainer: builds vocabularies, model and optimizer from a
    config (on ``device``, default ``cuda``) and runs the epoch loop with
    periodic validation and checkpointing.

    Telemetry: ``registry`` (a :class:`~csat_tpu_torch.obs.MetricsRegistry`
    behind the history counters) and ``obs`` (an
    :class:`~csat_tpu_torch.obs.EventRecorder` of phase spans and resilience
    events; every log line is one of its events too).

    Hooks: ``initial_params`` (a ``named_parameters``-keyed dict, e.g. from
    ``convert.convert_params``) replaces the seeded init;
    ``fault_injector`` (a :class:`~csat_tpu_torch.resilience.FaultInjector`)
    plants faults at chosen steps and batches; ``loss_scale_fn`` maps a
    train-step ordinal to a loss scale (the injector's ``loss_scale`` wins
    where both give one); ``watchdog_on_timeout`` replaces the watchdog's
    abort (``os._exit(76)``); ``request_stop()`` makes ``fit`` save a
    resumable snapshot at the next step boundary and raise ``Preempted``,
    as a SIGTERM or SIGINT does."""

    def __init__(self, cfg: Config, log: Callable[[str], None] = print,
                 device: Optional[str] = None):
        self.cfg = cfg
        self.registry = MetricsRegistry()
        self.obs = EventRecorder(capacity=cfg.obs_events, component="train")
        self._log_sink = log
        self.log = self._log
        self.device = resolve_device(device)
        # the data axis over the torch.distributed group (one process without
        # one); rank 0 alone writes checkpoints, logs and metrics files
        self.mesh = build_mesh(cfg.mesh_shape)
        self.primary = self.mesh.rank == 0
        self.metrics_file = (MetricsFile(cfg.obs_metrics_file, self.registry,
                                         every_s=cfg.obs_metrics_every_s)
                             if cfg.obs_metrics_file and self.primary else None)
        self.src_vocab, self.tgt_vocab = load_vocab(cfg.data_dir)
        # the triplet table is sized by the dictionary on disk, as in JAX
        self.model = make_model(cfg, self.src_vocab.size(), self.tgt_vocab.size(),
                                triplet_dictionary(cfg)[1], device=self.device)
        # under a model axis this process keeps its shards of the parameters
        shard_model(self.model, self.mesh)
        self.optimizer = default_optimizer(cfg)
        self.train_step = make_train_step(self.model, self.optimizer, cfg, self.mesh)
        self.decode_fn = decode_fn(self.model)
        self.output_dir = os.path.join(cfg.output_dir, cfg.project_name, cfg.task_name)
        self.initial_params: Optional[Dict[str, torch.Tensor]] = None
        self.loss_scale_fn: Optional[Callable[[int], Optional[float]]] = None
        self.fault_injector = None
        self.watchdog_on_timeout: Optional[Callable[[], None]] = None
        self._stop = False

    def _log(self, msg: str) -> None:
        """Every log line is also a flight-recorder event, so the narrative
        interleaves with the structured timeline in post-mortems."""
        self.obs.emit("log", msg=msg)
        self._log_sink(msg)

    def _postmortem(self, reason: str) -> None:
        """Dump the flight recorder on a fault path (rollback, divergence,
        watchdog trip): one rolling file per reason; never raises."""
        pm = self.cfg.obs_postmortem_dir
        if pm == "auto":
            pm = os.path.join(self.output_dir, "postmortem")
        if pm:
            self.obs.postmortem(self._per_rank(pm), reason)

    def _per_rank(self, path: str) -> str:
        """``path`` for rank 0, ``path-rank<r>`` for the other processes of a
        data-parallel run: their own files beside rank 0's."""
        return path if self.primary else f"{path}-rank{self.mesh.rank}"

    def _watchdog_trip(self, what: str, stalled_s: float) -> None:
        self.obs.emit("fault.watchdog", what=what, stalled_s=round(stalled_s, 3))
        self._postmortem("watchdog")

    def _scalar(self, **rec) -> None:
        """Append one record to ``scalars.jsonl`` (the JSONL stream standing
        in for the reference's TensorBoard logger), when ``cfg.scalar_log``."""
        if not (self.cfg.scalar_log and self.primary):
            return
        os.makedirs(self.output_dir, exist_ok=True)
        with open(os.path.join(self.output_dir, "scalars.jsonl"), "a") as f:
            f.write(json.dumps({"t": round(time.time(), 2), **rec}) + "\n")

    def request_stop(self) -> None:
        self._stop = True

    def _stop_requested(self, preempt: PreemptionHandler) -> bool:
        """Whether to stop at this step boundary: agreed by every process
        (a request on one of them stops them all at the same boundary)."""
        if self._stop:
            preempt.trigger()
        return coordinated_trigger(preempt)

    def init_state(self) -> TrainState:
        """A fresh train state; under data parallelism every process starts
        from rank 0's parameters, checked equal to its own."""
        if self.initial_params is not None:
            self.model.load_state_dict(shard_params(self.initial_params, self.mesh), strict=True)
        state = create_train_state(self.model, self.optimizer, self.cfg.seed)
        broadcast_params(state.params, self.mesh)
        n_params = sum(p.numel() for p in state.params.values())
        self.log(f"num_param: {n_params}")
        return state

    def _plan_id(self) -> str:
        """Identity of this run's deterministic batch sequence: the batch
        plan's signature (fixed shape or bucket grid) plus the host count.
        A marker's ``iterations_done`` only addresses a position within the
        sequence these pin down."""
        return f"{plan_signature(self.cfg)}@hosts={self.mesh.data}"

    def _train_batches(self, train_ds: ASTDataset, epoch: int, batch_hook=None,
                       on_batch_error=None) -> Iterable[Batch]:
        """One epoch's training batches: the fixed-shape iterator, or the
        length-bucketed one under ``cfg.bucketing`` — shuffled from
        ``cfg.seed + epoch`` either way, with the same resilience hooks, so
        the mid-epoch resume's skip is oblivious to which is active.  Each
        process of a data-parallel run reads its own shard in lockstep with
        the others (every shard yields as many batches, of the same shapes)."""
        cfg = self.cfg
        hooks = dict(shuffle=True, seed=cfg.seed + epoch, batch_hook=batch_hook,
                     on_batch_error=on_batch_error, num_shards=self.mesh.data,
                     shard_index=self.mesh.coord(DATA_AXIS))
        if cfg.bucketing:
            return iterate_bucketed_batches(train_ds, cfg, **hooks)
        return iterate_batches(train_ds, cfg.batch_size, **hooks)

    def _preempt_save(self, ck_dir: str, state: TrainState, epoch: int, it_done: int) -> None:
        """Final synchronous snapshot + resume marker (the SIGTERM path),
        under bounded retry: one flaky-filesystem blip must not cost the
        snapshot.  Every process enters it at the same step boundary (the
        stop is agreed, ``coordinated_trigger``); rank 0 alone writes, and the
        others wait until the snapshot and the marker are on disk."""
        synced = abort_barrier("preempt_save")
        self.log(f"preemption: saving synchronous snapshot (epoch {epoch}, {it_done} "
                 f"iterations done) under {ck_dir} [abort sync: {synced}]")
        self.obs.emit("fault.preemption", epoch=epoch, it_done=it_done, abort_sync=synced)
        state = whole_state(state, self.mesh)
        if self.primary:
            with self.obs.span("train.checkpoint"):
                retry(save_state, preempt_dir(ck_dir), state, snapshot_step(epoch, it_done),
                      attempts=self.cfg.save_retries, backoff_s=self.cfg.save_retry_backoff_s,
                      desc="preemption checkpoint", log=self.log)
            write_resume_marker(ck_dir, epoch, it_done, plan=self._plan_id())
        host.barrier()

    def _resume(self, state: TrainState, ckpt_dir: str) -> Tuple[TrainState, int, int, bool]:
        """→ ``(state, start_epoch, skip_iterations, resumed)``.  A stop
        snapshot newer than the newest boundary checkpoint resumes
        MID-epoch: the marker replays the epoch's shuffle and skips the
        completed iterations.  Its iteration count addresses one specific
        batch sequence, so a marker written under another plan is refused —
        only where it is consumed: a stale marker shadowed by a newer
        boundary checkpoint does not block that resume."""
        found = latest_step(ckpt_dir)
        marker = read_resume_marker(ckpt_dir)
        if marker is not None and (found is None or marker["epoch"] > found):
            if marker.get("plan") != self._plan_id():
                raise ValueError(
                    f"resume marker was written under batch plan {marker.get('plan')!r} "
                    f"but this run uses {self._plan_id()!r}; restore a boundary "
                    "checkpoint or rerun with the original bucketing config")
            state = restore_state(preempt_dir(ckpt_dir), state, marker["step"], self.mesh)
            self.log(f"resumed mid-epoch {marker['epoch']} after "
                     f"{marker['iterations_done']} iterations (preemption snapshot, {ckpt_dir})")
            return state, marker["epoch"], marker["iterations_done"], True
        if found is not None:
            state, done_epoch = restore_latest(ckpt_dir, state, found, self.mesh)
            self.log(f"resumed from epoch {done_epoch} ({ckpt_dir})")
            return state, done_epoch + 1, 0, True
        self.log(f"no checkpoint under {ckpt_dir}; starting fresh")
        return state, 1, 0, False

    def _profile_start(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        return prof

    def _profile_stop(self, prof) -> None:
        """End the profiled epoch: ``torch.profiler``'s trace under
        ``output_dir/trace`` and the recorder's phase spans beside it as
        ``host_trace.json`` (the spans carry the same names, bracketed with
        ``record_function`` during the epoch)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        trace_dir = self._per_rank(os.path.join(self.output_dir, "trace"))
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "device_trace.json"))
        write_chrome_trace(self._per_rank(os.path.join(self.output_dir, "host_trace.json")),
                           self.obs)

    def fit(self, train_ds: ASTDataset, val_ds: Optional[ASTDataset] = None,
            num_epochs: Optional[int] = None,
            checkpoint_fn: Optional[Callable[[TrainState, int], None]] = None,
            resume=False) -> Tuple[TrainState, Dict[str, Any]]:
        """Train for ``num_epochs`` (default ``cfg.num_epochs``).  ``resume``
        is a checkpoint directory, or True for the run's own.  Returns
        ``(state, history)``: per-epoch ``loss``, ``val_bleu`` pairs,
        ``best_bleu`` / ``best_params`` (CPU copies), the resilience
        counters (``rollbacks``, ``nonfinite_steps``, ``quarantined``,
        ``step_snapshots``), ``phase_s`` (seconds per ``train.*`` span), and
        ``steps`` — one record per train-step attempt (epoch, iteration,
        batch shape, loss, seconds).  The step ends in no host sync, so its
        seconds are the host's time to issue it, not the device's to run
        it; the guard's counter is read every ``cfg.guard_check_every``
        steps and the losses at the end of each epoch attempt."""
        cfg = self.cfg
        num_epochs = num_epochs or cfg.num_epochs
        state = self.init_state()
        start_epoch, skip_iterations, resumed = 1, 0, False
        best_bleu, best_params = 0.0, None
        best_meta = os.path.join(self.output_dir, "best.json")
        ck_dir = getattr(checkpoint_fn, "directory", None) or os.path.join(
            self.output_dir, "checkpoints")
        if resume:
            # full-state resume (params + AdamW moments + generator + step):
            # the continuation reproduces the uninterrupted run, since the
            # per-epoch shuffle is seeded by cfg.seed + epoch
            ckpt_dir = resume if isinstance(resume, str) and resume else ck_dir
            state, start_epoch, skip_iterations, resumed = self._resume(state, ckpt_dir)
            if resumed and os.path.exists(best_meta):
                # carry the earlier best-by-val-BLEU forward so the resumed
                # run cannot overwrite best_model with worse weights
                with open(best_meta) as f:
                    best_bleu = float(json.load(f).get("bleu", 0.0))
        eval_gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 777)
        history: Dict[str, Any] = {
            "loss": [], "val_bleu": [], "best_bleu": best_bleu, "rollbacks": 0,
            "nonfinite_steps": 0, "quarantined": 0, "step_snapshots": 0, "steps": [],
            "eval_s": [],
        }

        # the resilience counters in `history` are registry-backed: a scrape
        # of self.registry sees the numbers the caller gets back
        reg = self.registry

        def bump(key: str, n: int = 1) -> None:
            history[key] += n
            reg.counter(f"train_{key}_total").inc(n)

        steps_total = reg.counter("train_steps_total", "train-step attempts (incl. replays)")
        epochs_total = reg.counter("train_epochs_total", "completed epochs")
        loss_gauge = reg.gauge("train_epoch_loss", "last epoch's mean loss")
        bleu_gauge = reg.gauge("train_val_bleu", "last validation BLEU")
        obs = self.obs

        injector = self.fault_injector
        if injector is not None and injector.recorder is None:
            injector.recorder = obs  # injected faults land in the same timeline
        guard_on = cfg.nonfinite_guard
        rollback_after = cfg.guard_rollback_after if guard_on else 0
        preempt = PreemptionHandler()
        budget = ErrorBudget(cfg.data_error_budget, log=self.log)
        on_batch_error = budget if (cfg.data_error_budget > 0 or injector is not None) else None
        global_step = 0  # train-step attempts this fit: the fault ordinal
        bad = 0          # the guard's consecutive-bad counter, a device tensor after a step
        dev = self.device
        profiling = []   # the profiler of the profiled epoch while it runs

        with contextlib.ExitStack() as stack:
            if cfg.preempt_save:
                stack.enter_context(preempt.installed())
            stack.callback(lambda: profiling and profiling.pop().__exit__(None, None, None))
            watchdog = None
            if cfg.watchdog_timeout_s > 0:
                probe = None
                if cfg.watchdog_device_probe:
                    # host beats keep flowing while enqueued steps wait on a
                    # wedged device; the probe queues behind them.  Run once
                    # here so its first call is not mistaken for a stall
                    probe = device_liveness_probe(dev)
                    probe()
                watchdog = stack.enter_context(StepWatchdog(
                    cfg.watchdog_timeout_s, on_timeout=self.watchdog_on_timeout,
                    diag_path=self._per_rank(os.path.join(self.output_dir,
                                                          "watchdog_diagnostics.txt")),
                    log=self.log, probe=probe, on_trip=self._watchdog_trip))
            for epoch in range(start_epoch, num_epochs + 1):
                if self._stop_requested(preempt):
                    # asked between epochs: snapshot at the boundary
                    self._preempt_save(ck_dir, state, epoch, 0)
                    raise Preempted(ck_dir, epoch, 0)
                # rollback anchor: the last state known good.  With
                # cfg.snapshot_every_steps the anchor is refreshed mid-epoch
                # at the guard-check cadence, and snap_it records the
                # iteration it corresponds to, so a rollback replays only
                # the window since
                snapshot = None
                if rollback_after:
                    with obs.span("train.snapshot"):
                        snapshot = host_snapshot(state)
                snap_it = skip_iterations if epoch == start_epoch else 0
                skip = snap_it
                # loss accumulators captured WITH each anchor: a narrowed
                # replay resumes the epoch sums from the snapshot position
                snap_loss = (torch.zeros((), device=dev), torch.zeros((), device=dev))
                annotate = cfg.profile and epoch == start_epoch
                if annotate:
                    profiling.append(self._profile_start())
                t0 = time.monotonic()
                while True:
                    # one epoch ATTEMPT: a guard rollback abandons it and
                    # replays from the restored snapshot (same batch order,
                    # reseeded generator); non-finite losses of guarded
                    # steps stay out of the running mean
                    loss_sum, loss_cnt = snap_loss
                    rolled_back = False
                    batches = self._train_batches(
                        train_ds, epoch, batch_hook=injector.batch_hook if injector else None,
                        on_batch_error=on_batch_error)
                    if skip:
                        batches = itertools.islice(batches, skip, None)
                    it_done = skip
                    records = []
                    feed = prefetch_batches(batches, dev, depth=cfg.prefetch)
                    with contextlib.closing(feed):
                        for it, batch in enumerate(_timed_batches(feed, obs, annotate=annotate)):
                            scale = self.loss_scale_fn(global_step) if self.loss_scale_fn else None
                            if injector is not None:
                                injected = injector.loss_scale(global_step)
                                scale = scale if injected is None else injected
                                injector.maybe_hang(global_step)
                            t_step = time.perf_counter()
                            with obs.span("train.step", annotate=annotate):
                                state, metrics = self.train_step(
                                    state, batch, bad_steps=bad,
                                    loss_scale=1.0 if scale is None else scale)
                            steps_total.inc()
                            bad = metrics.get("bad_steps", bad)
                            it_done += 1
                            if watchdog is not None:
                                watchdog.beat()
                            loss = metrics["loss"]
                            finite = torch.isfinite(loss)
                            loss_sum = loss_sum + torch.where(finite, loss, torch.zeros_like(loss))
                            loss_cnt = loss_cnt + finite
                            records.append((epoch, it_done - 1, tuple(batch.src_seq.shape)
                                            + (batch.tgt_seq.shape[1],), loss,
                                            time.perf_counter() - t_step))
                            if (cfg.scalar_log and cfg.scalar_log_every
                                    and it % cfg.scalar_log_every == 0):
                                # the read syncs: only when someone reads the log
                                self._scalar(epoch=epoch, it=it, loss=float(loss))
                            if injector is not None:
                                injector.fire_preemption(global_step, preempt)
                            global_step += 1
                            if self._stop_requested(preempt):
                                if watchdog is not None:
                                    watchdog.disarm()
                                self._preempt_save(ck_dir, state, epoch, it_done)
                                raise Preempted(ck_dir, epoch, it_done)
                            if not (guard_on and it % cfg.guard_check_every == 0):
                                continue
                            # the device counter is authoritative: > 0 means the
                            # LAST step was non-finite (it resets on a good one);
                            # the read is a host-device sync, so guard_check_every
                            # trades detection latency against overlap
                            with obs.span("train.guard", annotate=annotate):
                                n_bad = int(bad)
                            if n_bad > 0:
                                bump("nonfinite_steps")
                                obs.emit("fault.nan_guard", epoch=epoch, it=it, consecutive=n_bad)
                                self.log(f"guard: non-finite step skipped (epoch {epoch} "
                                         f"it {it}; {n_bad} consecutive)")
                            elif (rollback_after and cfg.snapshot_every_steps
                                    and it_done - snap_it >= cfg.snapshot_every_steps):
                                # distance-based, not modulo: refresh whenever
                                # >= N iterations passed since the anchor, and
                                # only a state the guard has vetted
                                with obs.span("train.snapshot"):
                                    snapshot = host_snapshot(state)
                                snap_it = it_done
                                snap_loss = (loss_sum, loss_cnt)
                                bump("step_snapshots")
                            if rollback_after and n_bad >= rollback_after:
                                if history["rollbacks"] >= cfg.guard_max_rollbacks:
                                    obs.emit("fault.diverged", epoch=epoch, it=it,
                                             consecutive=n_bad, rollbacks=history["rollbacks"])
                                    self._postmortem("diverged")
                                    raise TrainingDivergedError(
                                        f"{n_bad} consecutive non-finite steps after "
                                        f"{history['rollbacks']} rollbacks (epoch {epoch} "
                                        f"it {it}) — aborting")
                                bump("rollbacks")
                                obs.emit("fault.rollback", epoch=epoch, it=it,
                                         consecutive=n_bad, replay_from=snap_it)
                                state = restore_snapshot(snapshot, state,
                                                         resplit=history["rollbacks"])
                                bad = 0
                                rolled_back = True
                                skip = snap_it
                                self.log(f"guard: rollback #{history['rollbacks']} — restored "
                                         f"the snapshot at iteration {snap_it} of epoch "
                                         f"{epoch} with a reseeded generator; replaying")
                                self._postmortem("rollback")
                                break
                    history["steps"].extend(
                        {"epoch": e, "it": i, "shape": shape, "loss": float(l), "seconds": s}
                        for e, i, shape, l, s in records)
                    if not rolled_back:
                        break
                if watchdog is not None:
                    # validation decodes and checkpoint saves run at their own
                    # cadence: the next step's beat re-arms
                    watchdog.disarm()
                if annotate:
                    self._profile_stop(profiling.pop())
                epochs_total.inc()
                cnt = float(loss_cnt)
                mean_loss = float(loss_sum) / cnt if cnt else float("nan")
                history["loss"].append(mean_loss)
                loss_gauge.set(mean_loss)
                self._scalar(epoch=epoch, loss=mean_loss, wall_s=round(time.monotonic() - t0, 1))
                msg = f"epoch {epoch}: loss={mean_loss:.4f} ({time.monotonic() - t0:.1f}s)"
                if val_ds is not None and (epoch % cfg.val_interval == 0 or epoch == num_epochs):
                    t_eval = time.perf_counter()
                    with obs.span("train.eval"):
                        bleu = evaluate_bleu(self.model, val_ds, cfg, self.tgt_vocab, eval_gen,
                                             self.decode_fn, self.mesh)
                    history["eval_s"].append(time.perf_counter() - t_eval)
                    history["val_bleu"].append((epoch, bleu))
                    bleu_gauge.set(bleu)
                    self._scalar(epoch=epoch, val_bleu=bleu)
                    if bleu > history["best_bleu"]:
                        history["best_bleu"] = bleu
                        best_params = {k: p.detach().to("cpu", copy=True) for k, p in
                                       gather_params(state.params, self.mesh).items()}
                        if checkpoint_fn is not None and self.primary:
                            # persist the best immediately so a later kill +
                            # resume keeps it
                            save_params(self.output_dir, best_params)
                            with open(best_meta, "w") as f:
                                json.dump({"bleu": bleu, "epoch": epoch}, f)
                    msg += f" val_bleu={bleu:.4f}"
                if checkpoint_fn is not None and epoch % cfg.save_interval == 0:
                    whole = whole_state(state, self.mesh)
                    if self.primary:
                        with obs.span("train.checkpoint"):
                            checkpoint_fn(whole, epoch)
                    # the write runs in rank 0's background thread: past this
                    # barrier the snapshot is submitted, not durable — a resume
                    # reads the newest file that was committed
                    host.barrier()
                self.log(msg)
                if self.metrics_file is not None:
                    self.metrics_file.maybe_write(extra={"epoch": epoch}, force=True)
        history["quarantined"] = budget.count
        reg.counter("train_quarantined_total").value = budget.count
        # per-phase wall-clock totals, cumulative over this Trainer's recorder
        history["phase_s"] = {name: rec["total_s"] for name, rec in obs.phase_totals().items()
                              if name.startswith("train.")}
        if checkpoint_fn is not None:
            # epoch snapshots persist asynchronously (train/checkpoint.py):
            # make them durable before handing the state back, scoped to this
            # run's directory when the hook provides it
            getattr(checkpoint_fn, "wait", wait_for_saves)()
        if best_params is None and resumed and os.path.exists(best_meta):
            # resumed run that never beat the earlier best: the on-disk
            # best_model is still the winner
            best_params = restore_params(self.output_dir)
        history["best_params"] = best_params if best_params is not None else {
            k: p.detach().to("cpu", copy=True)
            for k, p in gather_params(state.params, self.mesh).items()}
        return state, history
