"""Training: loss, AdamW, train state and the train step (the JAX package's
``train/{loss,optimizer,state,loop}.py``)."""

from csat_tpu_torch.train.loop import make_train_step
from csat_tpu_torch.train.loss import label_smoothing_loss
from csat_tpu_torch.train.optimizer import AdamW
from csat_tpu_torch.train.state import TrainState, create_train_state, default_optimizer

__all__ = ["make_train_step", "label_smoothing_loss", "AdamW", "TrainState",
           "create_train_state", "default_optimizer"]
