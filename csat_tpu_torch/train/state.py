"""Train state: the parameters, the optimizer moments, the step and the noise.

Counterpart of the JAX package's ``train/state.py``.  The parameters are the
model's own ``named_parameters()`` (updated in place by the step); the
randomness of training — dropout masks, sampled-graph seeds, shared graph
noise — comes from one explicit ``torch.Generator`` on the model's device,
where JAX threads a PRNG key.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple, Union

import torch

from csat_tpu_torch.configs import Config
from csat_tpu_torch.models import CSATrans
from csat_tpu_torch.models.pe import TRIPLET_VOCAB_FALLBACK
from csat_tpu_torch.train.optimizer import AdamW, AdamWState

__all__ = ["TrainState", "create_train_state", "default_optimizer", "make_model",
           "triplet_dictionary"]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.nn.Parameter]
    opt_state: AdamWState
    generator: torch.Generator


def triplet_dictionary(cfg: Config) -> Tuple[Optional[str], int]:
    """``(path, entries)`` of the triplet dictionary the dataset reads ids
    from (``node_triplet_dictionary_{lang}.pt`` under ``cfg.data_dir``, the
    config's language first, as ``data.dataset.ASTDataset`` looks it up), or
    ``(None, 0)`` when there is none."""
    from csat_tpu_torch.data.vocab import Vocab

    for lang in (cfg.lang, "java", "python"):
        path = os.path.join(cfg.data_dir, f"node_triplet_dictionary_{lang}.pt")
        if os.path.exists(path):
            return path, Vocab(need_bos=False, file_path=path).load().size()
    return None, 0


def make_model(cfg: Config, src_vocab_size: int, tgt_vocab_size: int,
               triplet_vocab_size: int = 0,
               device: Optional[Union[str, torch.device]] = None,
               seed: Optional[int] = None) -> CSATrans:
    """:class:`CSATrans` in the compute dtype ``cfg.compute_dtype`` names
    (bf16 or f32, as the JAX ``make_model`` picks it), its weights drawn under
    ``cfg.init_scheme`` (the reference scheme's redraw is where the JAX
    package's ``create_train_state`` applies it: at initialisation), with the
    JAX ``make_model``'s guard: a triplet model left to the reference's
    fallback table size (``triplet_vocab_size`` 0) is refused with
    ``ValueError`` when the dictionary on disk — the source of the ids the
    dataset emits — does not fit in it.  On the card an id past the table is
    a device-side assert that ends the process."""
    if cfg.use_pegen == "triplet" and triplet_vocab_size == 0:
        path, size = triplet_dictionary(cfg)
        fallback = TRIPLET_VOCAB_FALLBACK[cfg.lang]
        if size > fallback:
            raise ValueError(
                f"triplet dictionary {path} has {size} entries but "
                f"the model would be sized by the reference fallback "
                f"({fallback}); pass triplet_vocab_size={size} to "
                f"make_model (the Trainer does this automatically)")
    return CSATrans(cfg, src_vocab_size, tgt_vocab_size, device=device, seed=seed,
                    triplet_vocab_size=triplet_vocab_size)


def default_optimizer(cfg: Config) -> AdamW:
    """The reference's optimizer: AdamW at ``cfg.learning_rate``, eps 1e-6,
    no weight decay, no bias correction."""
    return AdamW(cfg.learning_rate, eps=1e-6, weight_decay=0.0)


def create_train_state(model: torch.nn.Module, optimizer: AdamW, seed: int) -> TrainState:
    """A fresh state over ``model``'s parameters, its noise generator seeded
    with ``seed`` on the model's device."""
    params = dict(model.named_parameters())
    gen = torch.Generator(device=next(iter(params.values())).device).manual_seed(int(seed))
    return TrainState(step=0, params=params, opt_state=optimizer.init(params), generator=gen)
