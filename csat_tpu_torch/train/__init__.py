"""Training: loss, AdamW, train state, the train step and the trainer around
it (the JAX package's ``train/{loss,optimizer,state,loop,decode,checkpoint}.py``)."""

from csat_tpu_torch.train.decode import greedy_decode, greedy_decode_early_eos
from csat_tpu_torch.train.loop import Trainer, evaluate_bleu, make_train_step, run_test
from csat_tpu_torch.train.loss import label_smoothing_loss
from csat_tpu_torch.train.optimizer import AdamW
from csat_tpu_torch.train.state import TrainState, create_train_state, default_optimizer

__all__ = ["make_train_step", "label_smoothing_loss", "AdamW", "TrainState",
           "create_train_state", "default_optimizer", "Trainer", "evaluate_bleu", "run_test",
           "greedy_decode", "greedy_decode_early_eos"]
