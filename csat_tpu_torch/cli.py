"""Train / test entry point of the port.

The train half of the JAX package's ``cli.py``::

    python -m csat_tpu_torch.cli --config python --data_dir ./processed/tree_sitter_python
    python -m csat_tpu_torch.cli --config python --data_dir DIR --is_test --checkpoint_dir OUT

Runs on the card; ``--device cpu`` runs the plain PyTorch path on the CPU
(``--device`` stands where the JAX CLI has ``--platform``).  Without a GPU and
without ``--device cpu`` it raises.  ``--set field=value`` overrides any config
field (the value is parsed as a Python literal), e.g. the widths of a small
run, ``nonfinite_guard=False``, ``bucket_src_lens=(37,75)``, the
production precision ``compute_dtype='bfloat16'`` or
``init_scheme='reference'``.  Serving has its own entry points (``serve.ServeEngine``).
"""

from __future__ import annotations

import argparse
import ast
import json
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
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="FIELD=VALUE", help="override a config field")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parse(argv)
    import torch

    from csat_tpu_torch.configs import get_config, list_configs
    from csat_tpu_torch.data.dataset import ASTDataset
    from csat_tpu_torch.train.checkpoint import (
        make_checkpoint_fn, restore_params, save_params)
    from csat_tpu_torch.train.loop import Trainer, run_test

    if args.config not in list_configs():
        raise SystemExit(f"unknown config {args.config!r}; choose from {list_configs()}")
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
    cfg = get_config(args.config, **overrides)

    trainer = Trainer(cfg, device=args.device)
    test_ds = ASTDataset(cfg, "test", trainer.src_vocab, trainer.tgt_vocab)
    # the test decode's sampled graphs (eval_graph="sample") draw from the
    # seed, as the JAX CLI's key(cfg.seed)
    test_gen = torch.Generator(device=trainer.device).manual_seed(cfg.seed)

    if args.is_test:
        params = restore_params(args.checkpoint_dir or trainer.output_dir)
        trainer.model.load_state_dict(params, strict=True)
        scores = run_test(trainer.model, test_ds, cfg, trainer.tgt_vocab, test_gen,
                          output_dir=trainer.output_dir)
        print(json.dumps(scores))
        return

    train_ds = ASTDataset(cfg, "train", trainer.src_vocab, trainer.tgt_vocab)
    val_ds = ASTDataset(cfg, "dev", trainer.src_vocab, trainer.tgt_vocab)
    ckpt_fn = make_checkpoint_fn(trainer.output_dir, retries=cfg.save_retries,
                                 backoff_s=cfg.save_retry_backoff_s)
    # --resume honours an explicit --checkpoint_dir, else the output dir
    resume = (args.checkpoint_dir or True) if args.resume else False
    _, history = trainer.fit(train_ds, val_ds, checkpoint_fn=ckpt_fn, resume=resume)
    # persist the best-by-val-BLEU weights and score them on the test split
    save_params(trainer.output_dir, history["best_params"])
    trainer.model.load_state_dict(history["best_params"], strict=True)
    scores = run_test(trainer.model, test_ds, cfg, trainer.tgt_vocab, test_gen,
                      output_dir=trainer.output_dir)
    print(json.dumps({"val_best_bleu": history["best_bleu"], **scores}))


if __name__ == "__main__":
    main()
