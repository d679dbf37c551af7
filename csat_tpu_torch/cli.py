"""Train / test / serve entry point of the port.

The JAX package's ``cli.py``::

    python -m csat_tpu_torch.cli --config python --data_dir ./processed/tree_sitter_python
    python -m csat_tpu_torch.cli --config python --data_dir DIR --is_test --checkpoint_dir OUT
    python -m csat_tpu_torch.cli summarize --config python --data_dir DIR --checkpoint_dir OUT f.py
    python -m csat_tpu_torch.cli serve --config python --data_dir DIR --checkpoint_dir OUT

Runs on the card; ``--device cpu`` runs the plain PyTorch path on the CPU
(``--device`` stands where the JAX CLI has ``--platform``).  Without a GPU and
without ``--device cpu`` it raises.  ``--set field=value`` overrides any config
field (the value is parsed as a Python literal), e.g. the widths of a small
run, ``nonfinite_guard=False``, ``bucket_src_lens=(37,75)``, the
production precision ``compute_dtype='bfloat16'`` or
``init_scheme='reference'``.  The resilience and telemetry flags are the JAX
command line's.  Training streams ``scalars.jsonl`` into the output dir
(``--set scalar_log=False`` turns it off).  A SIGTERM or SIGINT during
training saves a resumable snapshot, prints one ``{"preempted": true, ...}``
line and exits 75; a stalled step under ``--watchdog_timeout_s`` exits 76;
either run continues with ``--resume``.  ``summarize`` and ``serve`` go to
the serving command line (``serve/cli.py``), as the JAX ``cli.py`` dispatches
them.

Data, sequence and pipeline parallelism: under ``torchrun`` (its ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) each
process joins the group — NCCL on the card, gloo with ``--device cpu`` —
binds ``cuda:LOCAL_RANK`` and trains on its data shard of every epoch; the
config's mesh must cover the processes (the long-AST configs' ``("data",
-1)`` and python_pp's ``("data", -1), ("pipe", 2)`` do; others take
``--set "mesh_shape=(('data', -1),)"``).  A ``seq`` axis runs the long
configs' ring, a ``pipe`` axis python_pp's GPipe stages, a ``model`` axis
tensor parallelism (each process its shard of the heads and the FFN hidden;
checkpoints hold whole arrays).  Only rank 0 prints the lines above, writes
checkpoints and scores the test split (under a ``model`` axis with a
one-process model of the whole parameters)::

    torchrun --nproc_per_node=8 -m csat_tpu_torch.cli --config python_long --data_dir DIR
    torchrun --nproc_per_node=8 -m csat_tpu_torch.cli --config python_long --data_dir DIR \\
        --set "mesh_shape=(('data', -1), ('seq', 2))"
    torchrun --nproc_per_node=8 -m csat_tpu_torch.cli --config python_pp --data_dir DIR
    torchrun --nproc_per_node=8 -m csat_tpu_torch.cli --config python --data_dir DIR \\
        --set "mesh_shape=(('data', -1), ('model', 2))"
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
from typing import Optional, Sequence

__all__ = ["main"]


def _parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True, help="named variant, e.g. python, java")
    p.add_argument("--data_dir", default="", help="override the config's data_dir")
    p.add_argument("--epochs", type=int, default=0, help="override num_epochs")
    p.add_argument("--batch_size", type=int, default=0)
    p.add_argument("--is_test", action="store_true",
                   help="skip training, evaluate a saved best model")
    p.add_argument("--checkpoint_dir", default="",
                   help="directory of best_model.pt for --is_test, or of the state "
                        "checkpoints for --resume (default: the run's output dir)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest full-state checkpoint")
    p.add_argument("--bucketing", action="store_true",
                   help="length-bucketed execution: each sample is collated at the "
                        "smallest fitting (N, T) bucket with node-budget batch sizes")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; never falls back on its own")
    p.add_argument("--profile", action="store_true",
                   help="trace the first epoch with torch.profiler (output_dir/trace) and "
                        "write its host phase spans as output_dir/host_trace.json")
    p.add_argument("--no_guard", action="store_true",
                   help="disable the in-step non-finite guard")
    p.add_argument("--watchdog_timeout_s", type=float, default=-1.0,
                   help="abort (resumable, exit 76) when no train step completes for this "
                        "long; 0 disables, default keeps the config's value")
    p.add_argument("--watchdog_device_probe", action="store_true",
                   help="add the device-liveness leg to the step watchdog (catches a "
                        "stalled device while the host still enqueues steps)")
    p.add_argument("--data_error_budget", type=int, default=-1,
                   help="malformed training batches to quarantine-and-skip before failing "
                        "loud; default keeps the config's value")
    p.add_argument("--snapshot_every_steps", type=int, default=-1,
                   help="refresh the guard's rollback snapshot every N known-good "
                        "iterations; 0 = at epoch starts, default keeps the config's value")
    p.add_argument("--scalar_log_every", type=int, default=-1,
                   help="per-iteration scalars.jsonl cadence (0 = epoch records only; "
                        "default keeps the config's value)")
    p.add_argument("--metrics_file", default="",
                   help="append JSONL training-metrics snapshots here (at each epoch "
                        "boundary)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="FIELD=VALUE", help="override a config field")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("serve", "summarize", "top"):
        from csat_tpu_torch.serve.cli import main as serve_main

        serve_main(argv)
        return
    args = _parse(argv)
    import torch

    from csat_tpu_torch.configs import cli_config
    from csat_tpu_torch.parallel import host

    overrides = {}
    for item in args.overrides:
        field, _, value = item.partition("=")
        overrides[field] = ast.literal_eval(value)
    if args.data_dir:
        overrides["data_dir"] = args.data_dir
    if args.epochs:
        overrides["num_epochs"] = args.epochs
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.bucketing:
        overrides["bucketing"] = True
    if args.profile:
        overrides["profile"] = True
    if args.no_guard:
        overrides["nonfinite_guard"] = False
    if args.watchdog_timeout_s >= 0:
        overrides["watchdog_timeout_s"] = args.watchdog_timeout_s
    if args.watchdog_device_probe:
        overrides["watchdog_device_probe"] = True
    if args.data_error_budget >= 0:
        overrides["data_error_budget"] = args.data_error_budget
    if args.snapshot_every_steps >= 0:
        overrides["snapshot_every_steps"] = args.snapshot_every_steps
    if args.scalar_log_every >= 0:
        overrides["scalar_log_every"] = args.scalar_log_every
    if args.metrics_file:
        overrides["obs_metrics_file"] = args.metrics_file
    overrides.setdefault("scalar_log", True)
    cfg = cli_config(args.config, overrides)

    device, primary = args.device, True
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # a torchrun process: join the group, bind this process's card
        local = int(os.environ.get("LOCAL_RANK", "0"))
        on_card = device is None or torch.device(device).type == "cuda"
        if on_card:
            device = f"cuda:{local}"
            torch.cuda.set_device(local)
        host.initialize_multihost("nccl" if on_card else "gloo")
        primary = host.is_primary()
    try:
        _run(args, cfg, device, primary)
    finally:
        host.shutdown()


def _run(args: argparse.Namespace, cfg, device, primary: bool) -> None:
    import torch

    from csat_tpu_torch.data.dataset import ASTDataset
    from csat_tpu_torch.resilience import EXIT_PREEMPTED, Preempted
    from csat_tpu_torch.train.checkpoint import (
        make_checkpoint_fn, restore_params, save_params)
    from csat_tpu_torch.train.loop import Trainer, run_test

    trainer = Trainer(cfg, device=device, log=print if primary else (lambda msg: None))
    test_ds = ASTDataset(cfg, "test", trainer.src_vocab, trainer.tgt_vocab)
    # the test decode's sampled graphs (eval_graph="sample") draw from the
    # seed, as the JAX CLI's key(cfg.seed)
    test_gen = torch.Generator(device=trainer.device).manual_seed(cfg.seed)

    if args.is_test:
        if not primary:
            return
        params = restore_params(args.checkpoint_dir or trainer.output_dir)
        scores = run_test(_scoring_model(trainer, params), test_ds, cfg, trainer.tgt_vocab,
                          test_gen, output_dir=trainer.output_dir)
        print(json.dumps(scores))
        return

    train_ds = ASTDataset(cfg, "train", trainer.src_vocab, trainer.tgt_vocab)
    val_ds = ASTDataset(cfg, "dev", trainer.src_vocab, trainer.tgt_vocab)
    ckpt_fn = make_checkpoint_fn(trainer.output_dir, retries=cfg.save_retries,
                                 backoff_s=cfg.save_retry_backoff_s)
    # --resume honours an explicit --checkpoint_dir, else the output dir
    resume = (args.checkpoint_dir or True) if args.resume else False
    try:
        _, history = trainer.fit(train_ds, val_ds, checkpoint_fn=ckpt_fn, resume=resume)
    except Preempted as p:
        # the snapshot is already on disk: exit resumable (EX_TEMPFAIL), so a
        # supervisor restarts with --resume and loses at most one step
        if primary:
            print(json.dumps({"preempted": True, "epoch": p.epoch,
                              "iterations_done": p.iterations_done,
                              "resume_from": p.directory}), flush=True)
        raise SystemExit(EXIT_PREEMPTED)
    if not primary:
        return
    # persist the best-by-val-BLEU weights and score them on the test split
    save_params(trainer.output_dir, history["best_params"])
    scores = run_test(_scoring_model(trainer, history["best_params"]), test_ds, cfg,
                      trainer.tgt_vocab, test_gen, output_dir=trainer.output_dir)
    print(json.dumps({"val_best_bleu": history["best_bleu"], **scores}))


def _scoring_model(trainer, params):
    """The model rank 0 scores the test split with, holding the whole
    ``params``: the trainer's own, or — under a ``model`` axis, whose
    sharded modules would wait on the other members — a one-process model
    of the same config."""
    from csat_tpu_torch.parallel.mesh import model_axis
    from csat_tpu_torch.train.state import make_model, triplet_dictionary

    model = trainer.model
    if model_axis(trainer.mesh) is not None:
        cfg = trainer.cfg
        model = make_model(cfg, trainer.src_vocab.size(), trainer.tgt_vocab.size(),
                           triplet_dictionary(cfg)[1], device=trainer.device)
    model.load_state_dict(params, strict=True)
    return model


if __name__ == "__main__":
    main()
