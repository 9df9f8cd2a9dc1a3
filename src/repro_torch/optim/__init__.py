"""repro_torch.optim — AdamW/SGD with global-norm clipping and the
learning-rate schedules (port of ``repro/optim``; gradient compression is
not ported)."""
from .adamw import OptimizerSpec, adamw, clip_by_global_norm, global_norm, make_optimizer, sgd
from .schedule import constant, cosine_warmup

__all__ = ["OptimizerSpec", "adamw", "sgd", "make_optimizer", "global_norm",
           "clip_by_global_norm", "constant", "cosine_warmup"]
