"""LM training on one device: AdamW, the losses and the step (port of
``repro.train``)."""

from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state, lr_schedule
from .step import TrainConfig, lm_loss, make_train_step
