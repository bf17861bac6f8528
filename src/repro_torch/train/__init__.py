"""Training of the port (port of ``repro/train``): AdamW, the training
state and the train-step factory."""

from .optimizer import AdamConfig, TrainState, adamw_update, cosine_lr, global_norm, init_train_state
from .train_step import make_train_step

__all__ = ["AdamConfig", "TrainState", "adamw_update", "cosine_lr", "global_norm",
           "init_train_state", "make_train_step"]
