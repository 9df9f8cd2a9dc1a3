"""repro_torch.data — the synthetic LM token pipeline (port of
``repro/data/lm.py``; the vision pipelines are not ported)."""
from .lm import LMDataConfig, lm_batch

__all__ = ["LMDataConfig", "lm_batch"]
