"""repro_torch.train — the loss, the train step and the one-device trainer
(port of ``repro/train``; checkpoints and ``run_with_restarts`` are not
ported yet)."""
from .loss import softmax_xent
from .steps import loss_and_grads, make_train_step
from .trainer import TrainConfig, Trainer

__all__ = ["softmax_xent", "loss_and_grads", "make_train_step", "TrainConfig", "Trainer"]
