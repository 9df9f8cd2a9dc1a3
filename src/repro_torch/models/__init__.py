"""repro_torch.models — the lm family (every registered config) and the
build_model dispatcher."""
from .base import (ArchConfig, KVCacheLayout, ModelAPI, PagedKVLayout, kv_cache_layout,
                   make_norm, paged_kv_layout)
from .lm import build_lm

_FAMILIES = {"lm": build_lm}


def build_model(cfg: ArchConfig, *, phase: str = "serve") -> ModelAPI:
    try:
        builder = _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown model family {cfg.family!r} (the port serves 'lm')") from None
    return builder(cfg, phase=phase)


__all__ = ["ArchConfig", "KVCacheLayout", "ModelAPI", "PagedKVLayout", "build_lm",
           "build_model", "kv_cache_layout", "make_norm", "paged_kv_layout"]
