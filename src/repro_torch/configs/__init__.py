"""Config registry: every architecture of the reference, the ``lm``,
``hybrid`` (zamba2), ``xlstm`` and ``encdec`` (seamless-m4t-large-v2)
families.

``get_config(name, **overrides)`` returns the public ArchConfig,
``get_smoke(name)`` the reduced same-family config for CPU tests.
"""
from __future__ import annotations

from repro_torch.models.base import ArchConfig

from . import (
    chameleon_34b,
    grok1_314b,
    mixtral_8x22b,
    nemotron4_15b,
    phi3_mini_38b,
    qwen15_32b,
    seamless_m4t_large_v2,
    smollm_360m,
    xlstm_125m,
    zamba2_27b,
)
from .shapes import SHAPES, ShapeSpec, applicable_shapes

_MODULES = (
    smollm_360m,
    qwen15_32b,
    nemotron4_15b,
    phi3_mini_38b,
    grok1_314b,
    mixtral_8x22b,
    chameleon_34b,
    zamba2_27b,
    xlstm_125m,
    seamless_m4t_large_v2,
)

REGISTRY = {m.CONFIG.name: m for m in _MODULES}
ARCH_NAMES = tuple(REGISTRY)


def get_config(name: str, **overrides) -> ArchConfig:
    cfg = REGISTRY[name].CONFIG
    return cfg.replace(**overrides) if overrides else cfg


def get_smoke(name: str, **overrides) -> ArchConfig:
    cfg = REGISTRY[name].SMOKE
    return cfg.replace(**overrides) if overrides else cfg


__all__ = [
    "ARCH_NAMES",
    "REGISTRY",
    "SHAPES",
    "ShapeSpec",
    "applicable_shapes",
    "get_config",
    "get_smoke",
]
