"""repro_torch.models — the lm, hybrid (zamba2), xlstm and encdec
(seamless) families and the build_model dispatcher."""
from .base import (ArchConfig, KVCacheLayout, ModelAPI, PagedKVLayout, kv_cache_layout,
                   make_norm, paged_kv_layout, views_of)
from .encdec import build_encdec
from .hybrid import build_hybrid
from .lm import build_lm
from .xlstm import build_xlstm

_FAMILIES = {"lm": build_lm, "hybrid": build_hybrid, "xlstm": build_xlstm,
             "encdec": build_encdec}


def build_model(cfg: ArchConfig, *, phase: str = "serve") -> ModelAPI:
    try:
        build = _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown model family {cfg.family!r} (the port serves "
                         f"{sorted(_FAMILIES)})") from None
    return build(cfg, phase=phase)


__all__ = ["ArchConfig", "KVCacheLayout", "ModelAPI", "PagedKVLayout", "build_encdec",
           "build_hybrid", "build_lm", "build_model", "build_xlstm", "kv_cache_layout",
           "make_norm", "paged_kv_layout", "views_of"]
