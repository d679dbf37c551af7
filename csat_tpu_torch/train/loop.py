"""Training harness: the train step, validation, the epoch loop.

Counterpart of the JAX package's ``train/loop.py``:

* :func:`make_train_step` (``:107-205``): one step is the teacher-forced
  forward in training mode, ``nll + sw · sparsity`` (times an optional
  ``loss_scale``), the backward — through the hand-written kernels on the
  card — the non-finite guard and the AdamW update;
* :func:`evaluate_bleu` / :func:`run_test` (``:363-423``): greedy decodes of
  a dataset scored by mean per-sentence smoothed BLEU (validation) or corpus
  BLEU / ROUGE-L / METEOR with a dump of the predictions (test);
* :class:`Trainer` (``:426``): vocabularies, model and optimizer from a
  config; ``fit`` runs the epoch loop with fixed-shape or length-bucketed
  batches, validation every ``val_interval`` epochs, the best-by-BLEU
  parameters kept and saved, periodic checkpoints, guard-driven rollback to
  the last good snapshot, and resume from a boundary checkpoint or — after
  ``request_stop`` — from a mid-epoch snapshot by replaying the epoch's
  deterministic batch sequence.

The step runs the model in its compute dtype (``cfg.compute_dtype``: f32,
or bf16 with f32 attention islands), takes the loss in f32 and brings f32
gradients to the f32 master weights, with the non-finite guard as in f32;
the weights start from ``cfg.init_scheme``'s draw (``models/init.py``).

PyTorch runs eagerly, so a bucket shape needs no compiled program: the JAX
trainer's program cache and AOT warm-up have no counterpart.  Its prefetch
threads, mesh placement, watchdog, signal handling (preemption), data error
budget, fault injector, scalar logs and telemetry registry are not carried
over.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from csat_tpu_torch.configs import Config
from csat_tpu_torch.data.bucketing import (
    iterate_bucketed_batches, pad_batch, plan_signature)
from csat_tpu_torch.data.dataset import ASTDataset, Batch, batch_to_device, iterate_batches
from csat_tpu_torch.data.vocab import Vocab, load_vocab
from csat_tpu_torch.metrics import batch_bleu, bleu_output_transform, eval_accuracies
from csat_tpu_torch.models import CSATrans
from csat_tpu_torch.resilience.guards import (
    TrainingDivergedError, global_norm, guarded_apply, host_snapshot, restore_snapshot)
from csat_tpu_torch.resilience.retry import retry
from csat_tpu_torch.train.checkpoint import (
    Preempted, latest_step, preempt_dir, read_resume_marker, restore_latest, restore_params,
    restore_state, save_params, save_state, snapshot_step, write_resume_marker)
from csat_tpu_torch.train.decode import decode_fn
from csat_tpu_torch.train.loss import label_smoothing_loss
from csat_tpu_torch.train.optimizer import AdamW
from csat_tpu_torch.train.state import (
    TrainState, create_train_state, default_optimizer, make_model, triplet_dictionary)
from csat_tpu_torch.utils import resolve_device

__all__ = ["make_train_step", "evaluate_bleu", "run_test", "Trainer"]


def make_train_step(model: torch.nn.Module, optimizer: AdamW, cfg: Config
                    ) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, batch, bad_steps=0, loss_scale=1.0) → (state,
    metrics)``.  ``batch`` holds tensors on the model's device
    (``data.dataset.batch_to_device``).  The state's parameters and moments
    are updated in place; after the call every parameter's ``.grad`` holds
    this step's gradient.  ``metrics``: ``loss`` (the NLL), ``sparsity``,
    ``total``, and with ``cfg.nonfinite_guard`` (the default) ``grad_norm``,
    ``nonfinite`` and ``bad_steps`` — a non-finite loss or grad-norm skips
    the update."""

    def train_step(state: TrainState, batch: Batch, bad_steps: int = 0,
                   loss_scale: float = 1.0):
        for p in state.params.values():
            p.grad = None
        log_probs, sparsity = model(batch, deterministic=False, gen=state.generator)
        nll = label_smoothing_loss(log_probs, batch.target, cfg.smoothing)
        total = (nll + cfg.sw * sparsity) * loss_scale
        total.backward()
        grads = {k: p.grad for k, p in state.params.items()}
        metrics = {"loss": nll.detach(), "sparsity": sparsity.detach(), "total": total.detach()}
        if cfg.nonfinite_guard:
            ok, gnorm, bad = guarded_apply(optimizer, state.params, grads, state.opt_state,
                                           total.detach(), bad_steps)
            metrics.update(grad_norm=gnorm, nonfinite=not ok, bad_steps=bad)
        else:
            optimizer.update(state.params, grads, state.opt_state)
            metrics.update(grad_norm=global_norm(grads))
        state.step += 1
        return state, metrics

    return train_step


def _pad_batch(batch: Batch, size: int, max_src_len: Optional[int] = None) -> Tuple[Batch, int]:
    """Pad a ragged tail batch to ``size`` rows (the collate of empty
    samples), so every eval batch of a bucket has one shape; callers slice
    the results back to the real row count."""
    return pad_batch(batch, rows=size, max_src_len=max_src_len)


def _decode_dataset(model: CSATrans, dataset: ASTDataset, cfg: Config,
                    gen: Optional[torch.Generator] = None, decode: Optional[Callable] = None
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(y_pred, target)`` per batch, tail-padded to a static shape.

    With ``cfg.bucketing`` each batch arrives at its bucket's node capacity
    and is row-padded to the bucket's node-budget batch size, so short
    sequences decode in proportionally less time and per-sample outputs are
    unchanged.  Eval buckets the NODE axis only: a T bucket is chosen by the
    sample's REFERENCE length, so decoding ``t - 1`` steps would truncate
    hypotheses as a function of the label — metrics get the full
    ``max_tgt_len - 1`` decode budget whatever the bucketing."""
    decode = decode or decode_fn(model)
    if cfg.bucketing:
        eval_cfg = cfg.replace(bucket_tgt_lens=(cfg.max_tgt_len,))
        batches = ((batch, spec.batch_size) for spec, batch in iterate_bucketed_batches(
            dataset, eval_cfg, shuffle=False, drop_last=False, with_spec=True))
    else:
        batches = ((batch, cfg.batch_size) for batch in iterate_batches(
            dataset, cfg.batch_size, shuffle=False, drop_last=False))
    for batch, rows in batches:
        batch, real = _pad_batch(batch, rows, max_src_len=cfg.max_src_len)
        target = np.asarray(batch.target)[:real]
        y_pred = decode(model, batch_to_device(batch, model.device), gen)
        yield y_pred[:real].cpu().numpy(), target


def evaluate_bleu(model: CSATrans, dataset: ASTDataset, cfg: Config, tgt_vocab: Vocab,
                  gen: Optional[torch.Generator] = None,
                  decode: Optional[Callable] = None) -> float:
    """Mean per-sentence smoothed BLEU over greedy decodes (the reference's
    BLEU4 validation metric)."""
    total, count = 0.0, 0
    for y_pred, target in _decode_dataset(model, dataset, cfg, gen, decode):
        hyps, refs = bleu_output_transform(y_pred, target, tgt_vocab.i2w)
        scores = batch_bleu(hyps, refs)
        total += float(np.sum(scores))
        count += len(scores)
    return total / count if count else 0.0


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


class Trainer:
    """End-to-end trainer: builds vocabularies, model and optimizer from a
    config (on ``device``, default ``cuda``) and runs the epoch loop with
    periodic validation and checkpointing.

    Hooks: ``initial_params`` (a ``named_parameters``-keyed dict, e.g. from
    ``convert.convert_params``) replaces the seeded init; ``loss_scale_fn``
    maps a train-step ordinal to a loss scale (a fault drill plants a NaN
    with it); ``request_stop()`` makes ``fit`` save a resumable snapshot at
    the next step boundary and raise ``Preempted``."""

    def __init__(self, cfg: Config, log: Callable[[str], None] = print,
                 device: Optional[str] = None):
        self.cfg = cfg
        self.log = log
        self.device = resolve_device(device)
        self.src_vocab, self.tgt_vocab = load_vocab(cfg.data_dir)
        # the triplet table is sized by the dictionary on disk, as in JAX
        self.model = make_model(cfg, self.src_vocab.size(), self.tgt_vocab.size(),
                                triplet_dictionary(cfg)[1], device=self.device)
        self.optimizer = default_optimizer(cfg)
        self.train_step = make_train_step(self.model, self.optimizer, cfg)
        self.decode_fn = decode_fn(self.model)
        self.output_dir = os.path.join(cfg.output_dir, cfg.project_name, cfg.task_name)
        self.initial_params: Optional[Dict[str, torch.Tensor]] = None
        self.loss_scale_fn: Optional[Callable[[int], Optional[float]]] = None
        self._stop = False

    def request_stop(self) -> None:
        self._stop = True

    def init_state(self) -> TrainState:
        if self.initial_params is not None:
            self.model.load_state_dict(self.initial_params, strict=True)
        state = create_train_state(self.model, self.optimizer, self.cfg.seed)
        n_params = sum(p.numel() for p in state.params.values())
        self.log(f"num_param: {n_params}")
        return state

    def _plan_id(self) -> str:
        """Identity of this run's deterministic batch sequence: the batch
        plan's signature (fixed shape or bucket grid) plus the host count.
        A marker's ``iterations_done`` only addresses a position within the
        sequence these pin down."""
        return f"{plan_signature(self.cfg)}@hosts=1"

    def _train_batches(self, train_ds: ASTDataset, epoch: int) -> Iterable[Batch]:
        """One epoch's training batches: the fixed-shape iterator, or the
        length-bucketed one under ``cfg.bucketing`` — shuffled from
        ``cfg.seed + epoch`` either way, so the mid-epoch resume's skip is
        oblivious to which is active."""
        cfg = self.cfg
        if cfg.bucketing:
            return iterate_bucketed_batches(train_ds, cfg, shuffle=True, seed=cfg.seed + epoch)
        return iterate_batches(train_ds, cfg.batch_size, shuffle=True, seed=cfg.seed + epoch)

    def _stop_save(self, ck_dir: str, state: TrainState, epoch: int, it_done: int) -> None:
        """Synchronous snapshot + resume marker, under bounded retry."""
        self.log(f"stop requested: saving snapshot (epoch {epoch}, {it_done} iterations "
                 f"done) under {ck_dir}")
        retry(save_state, preempt_dir(ck_dir), state, snapshot_step(epoch, it_done),
              attempts=self.cfg.save_retries, backoff_s=self.cfg.save_retry_backoff_s,
              desc="stop checkpoint", log=self.log)
        write_resume_marker(ck_dir, epoch, it_done, plan=self._plan_id())

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
            state = restore_state(preempt_dir(ckpt_dir), state, marker["step"])
            self.log(f"resumed mid-epoch {marker['epoch']} after "
                     f"{marker['iterations_done']} iterations (stop snapshot, {ckpt_dir})")
            return state, marker["epoch"], marker["iterations_done"], True
        if found is not None:
            state, done_epoch = restore_latest(ckpt_dir, state, found)
            self.log(f"resumed from epoch {done_epoch} ({ckpt_dir})")
            return state, done_epoch + 1, 0, True
        self.log(f"no checkpoint under {ckpt_dir}; starting fresh")
        return state, 1, 0, False

    def fit(self, train_ds: ASTDataset, val_ds: Optional[ASTDataset] = None,
            num_epochs: Optional[int] = None,
            checkpoint_fn: Optional[Callable[[TrainState, int], None]] = None,
            resume=False) -> Tuple[TrainState, Dict[str, Any]]:
        """Train for ``num_epochs`` (default ``cfg.num_epochs``).  ``resume``
        is a checkpoint directory, or True for the run's own.  Returns
        ``(state, history)``: per-epoch ``loss``, ``val_bleu`` pairs,
        ``best_bleu`` / ``best_params`` (CPU copies), the resilience
        counters, and ``steps`` — one record per train-step attempt (epoch,
        iteration, batch shape, loss, seconds; the guard's verdict ends every
        step in a host sync, so the seconds are whole steps)."""
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
            "nonfinite_steps": 0, "step_snapshots": 0, "steps": [], "eval_s": [],
        }
        guard_on = cfg.nonfinite_guard
        rollback_after = cfg.guard_rollback_after if guard_on else 0
        global_step = 0  # train-step attempts this fit: the loss_scale_fn ordinal
        bad = 0          # consecutive non-finite steps
        dev = self.device

        for epoch in range(start_epoch, num_epochs + 1):
            if self._stop:  # asked between epochs: snapshot at the boundary
                self._stop_save(ck_dir, state, epoch, 0)
                raise Preempted(ck_dir, epoch, 0)
            # rollback anchor: the last state known good.  With
            # cfg.snapshot_every_steps the anchor is refreshed mid-epoch at
            # the guard-check cadence, and snap_it records the iteration it
            # corresponds to, so a rollback replays only the window since
            snapshot = host_snapshot(state) if rollback_after else None
            snap_it = skip_iterations if epoch == start_epoch else 0
            skip = snap_it
            # loss accumulators captured WITH each anchor: a narrowed replay
            # resumes the epoch sums from the snapshot position
            snap_loss = (torch.zeros((), device=dev), torch.zeros((), device=dev))
            t0 = time.monotonic()
            while True:
                # one epoch ATTEMPT: a guard rollback abandons it and replays
                # from the restored snapshot (same batch order, reseeded
                # generator); non-finite losses of guarded steps stay out of
                # the running mean
                loss_sum, loss_cnt = snap_loss
                rolled_back = False
                batches = self._train_batches(train_ds, epoch)
                if skip:
                    batches = itertools.islice(batches, skip, None)
                it_done = skip
                records = []
                for it, batch in enumerate(batches):
                    scale = self.loss_scale_fn(global_step) if self.loss_scale_fn else None
                    t_step = time.perf_counter()
                    state, metrics = self.train_step(
                        state, batch_to_device(batch, dev), bad_steps=bad,
                        loss_scale=1.0 if scale is None else scale)
                    bad = metrics.get("bad_steps", 0)
                    it_done += 1
                    global_step += 1
                    loss = metrics["loss"]
                    finite = torch.isfinite(loss)
                    loss_sum = loss_sum + torch.where(finite, loss, torch.zeros_like(loss))
                    loss_cnt = loss_cnt + finite
                    records.append((epoch, it_done - 1, tuple(batch.src_seq.shape)
                                    + (batch.tgt_seq.shape[1],), loss,
                                    time.perf_counter() - t_step))
                    if self._stop:
                        self._stop_save(ck_dir, state, epoch, it_done)
                        raise Preempted(ck_dir, epoch, it_done)
                    if guard_on and it % cfg.guard_check_every == 0:
                        if bad > 0:
                            history["nonfinite_steps"] += 1
                            self.log(f"guard: non-finite step skipped (epoch {epoch} "
                                     f"it {it}; {bad} consecutive)")
                        elif (rollback_after and cfg.snapshot_every_steps
                                and it_done - snap_it >= cfg.snapshot_every_steps):
                            # distance-based, not modulo: refresh whenever
                            # >= N iterations passed since the anchor, and
                            # only a state the guard has vetted
                            snapshot = host_snapshot(state)
                            snap_it = it_done
                            snap_loss = (loss_sum, loss_cnt)
                            history["step_snapshots"] += 1
                        if rollback_after and bad >= rollback_after:
                            if history["rollbacks"] >= cfg.guard_max_rollbacks:
                                raise TrainingDivergedError(
                                    f"{bad} consecutive non-finite steps after "
                                    f"{history['rollbacks']} rollbacks (epoch {epoch} "
                                    f"it {it}) — aborting")
                            history["rollbacks"] += 1
                            state = restore_snapshot(snapshot, state,
                                                     resplit=history["rollbacks"])
                            bad = 0
                            rolled_back = True
                            skip = snap_it
                            self.log(f"guard: rollback #{history['rollbacks']} — restored "
                                     f"the snapshot at iteration {snap_it} of epoch "
                                     f"{epoch} with a reseeded generator; replaying")
                            break
                history["steps"].extend(
                    {"epoch": e, "it": i, "shape": shape, "loss": float(l), "seconds": s}
                    for e, i, shape, l, s in records)
                if not rolled_back:
                    break
            cnt = float(loss_cnt)
            mean_loss = float(loss_sum) / cnt if cnt else float("nan")
            history["loss"].append(mean_loss)
            msg = f"epoch {epoch}: loss={mean_loss:.4f} ({time.monotonic() - t0:.1f}s)"
            if val_ds is not None and (epoch % cfg.val_interval == 0 or epoch == num_epochs):
                t_eval = time.perf_counter()
                bleu = evaluate_bleu(self.model, val_ds, cfg, self.tgt_vocab, eval_gen,
                                     self.decode_fn)
                history["eval_s"].append(time.perf_counter() - t_eval)
                history["val_bleu"].append((epoch, bleu))
                if bleu > history["best_bleu"]:
                    history["best_bleu"] = bleu
                    best_params = {k: p.detach().to("cpu", copy=True)
                                   for k, p in state.params.items()}
                    if checkpoint_fn is not None:
                        # persist the best immediately so a later kill +
                        # resume keeps it
                        save_params(self.output_dir, best_params)
                        with open(best_meta, "w") as f:
                            json.dump({"bleu": bleu, "epoch": epoch}, f)
                msg += f" val_bleu={bleu:.4f}"
            if checkpoint_fn is not None and epoch % cfg.save_interval == 0:
                checkpoint_fn(state, epoch)
            self.log(msg)
        if best_params is None and resumed and os.path.exists(best_meta):
            # resumed run that never beat the earlier best: the on-disk
            # best_model is still the winner
            best_params = restore_params(self.output_dir)
        history["best_params"] = best_params if best_params is not None else {
            k: p.detach().to("cpu", copy=True) for k, p in state.params.items()}
        return state, history
