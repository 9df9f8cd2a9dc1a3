"""repro_torch.train — the loss, the train step and the one-device trainer
with checkpoint and restart (port of ``repro/train``)."""
from .loss import softmax_xent
from .steps import loss_and_grads, make_train_step
from .trainer import SimulatedFailure, TrainConfig, Trainer, run_with_restarts

__all__ = ["softmax_xent", "loss_and_grads", "make_train_step", "TrainConfig", "Trainer",
           "SimulatedFailure", "run_with_restarts"]
