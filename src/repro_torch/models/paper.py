"""The paper's evaluation models (§III-A; port of
``repro/models/paper.py``): the TFC / SFC / LFC MLPs (MNIST-like) and the
VGG-like CNV (CIFAR-like), each in dense, bika, bnn or qnn8 mode through
the switchable linear backend: the four-way comparison of Table II.

Mode conventions (the reference's):
  bika — every layer is sum_k Sign(w x + beta), with NO activation between
         layers (the Sign is the nonlinearity);
  bnn  — sign(x) @ sign(w), the Sign is the activation;
  qnn8 / dense — ReLU between layers (``QuantBackend.inter_act``).
The last layer's raw class scores are the float32 logits.

Parameters are plain tensors: a list of layer dicts (mlp) or
``{"conv": [...], "fc": [...]}`` (cnv). ``build_paper_model`` resolves the
device once: CUDA unless ``device="cpu"``, raising without a GPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple, Union

import torch

from repro_torch.core.backend import get_backend
from repro_torch.core.convert import tree_to_serve
from repro_torch.device import resolve_device
from repro_torch.nn.conv import conv2d_apply, conv2d_init, maxpool2d
from repro_torch.nn.linear import LinearSpec, linear_apply, linear_init

__all__ = [
    "PaperConfig",
    "TFC",
    "SFC",
    "LFC",
    "CNV",
    "PAPER_MODELS",
    "build_paper_model",
    "paper_model_to_serve",
]


@dataclasses.dataclass(frozen=True)
class PaperConfig:
    name: str
    kind: str  # 'mlp' | 'cnv'
    features: Tuple[int, ...]  # hidden + output widths (mlp) / fc head (cnv)
    in_dim: int = 784
    image_hw: Tuple[int, int, int] = (32, 32, 3)
    conv_plan: Tuple[Any, ...] = (64, 64, "P", 128, 128, "P", 256, 256, "P")
    mode: str = "bika"
    m: int = 1

    def spec(self) -> LinearSpec:
        """rsqrt(K) and a learned per-channel gamma stand in for the
        normalization FINN-style training interposes and the hardware folds
        into the next layer's thresholds (without them the raw +-K integer
        logits saturate softmax). Modes with an ANN's additive bias declare
        it on their backend (``default_bias``) and ignore out_scale."""
        return LinearSpec(mode=self.mode, m=self.m, out_scale="rsqrt_k",
                          bias=get_backend(self.mode).default_bias)

    def replace(self, **kw) -> "PaperConfig":
        return dataclasses.replace(self, **kw)


# Table II structures (input 784 for the MNIST MLPs)
TFC = PaperConfig("tfc", "mlp", (64, 32, 10))
SFC = PaperConfig("sfc", "mlp", (256, 256, 256, 10))
LFC = PaperConfig("lfc", "mlp", (1024, 1024, 1024, 10))
CNV = PaperConfig("cnv", "cnv", (512, 512, 10))

PAPER_MODELS = {"tfc": TFC, "sfc": SFC, "lfc": LFC, "cnv": CNV}


def _dense_stack(x: torch.Tensor, layers: List, cfg: PaperConfig, phase: str) -> torch.Tensor:
    spec, be = cfg.spec(), get_backend(cfg.mode)
    x = x.reshape(x.shape[0], -1)
    for i, p in enumerate(layers):
        x = linear_apply(p, x, spec, phase=phase)
        if i < len(layers) - 1:
            x = be.inter_act(x)
    return x.to(torch.float32)


def _cnv_flat(cfg: PaperConfig) -> int:
    """Features after the conv stack: each SAME pool halves H and W (ceil)."""
    hw = cfg.image_hw[0]
    for _ in [c for c in cfg.conv_plan if c == "P"]:
        hw = -(-hw // 2)
    return hw * hw * [c for c in cfg.conv_plan if c != "P"][-1]


def _init(gen: torch.Generator, cfg: PaperConfig, phase: str, device):
    spec = cfg.spec()
    convs, c_in = [], cfg.image_hw[2]
    if cfg.kind == "cnv":
        for c in cfg.conv_plan:
            if c != "P":
                convs.append(conv2d_init(gen, c_in, c, spec, phase=phase, device=device))
                c_in = c
    dims = (cfg.in_dim if cfg.kind == "mlp" else _cnv_flat(cfg),) + cfg.features
    fc = [linear_init(gen, dims[i], dims[i + 1], spec, phase=phase, device=device)
          for i in range(len(cfg.features))]
    return fc if cfg.kind == "mlp" else {"conv": convs, "fc": fc}


def _cnv_apply(params, x: torch.Tensor, cfg: PaperConfig, phase: str) -> torch.Tensor:
    spec, be = cfg.spec(), get_backend(cfg.mode)
    if x.dim() == 2:
        x = x.reshape((-1,) + tuple(cfg.image_hw))
    ci = 0
    for c in cfg.conv_plan:
        if c == "P":
            x = maxpool2d(x)
        else:
            x = be.inter_act(conv2d_apply(params["conv"][ci], x, spec, phase=phase))
            ci += 1
    return _dense_stack(x, params["fc"], cfg, phase)


def build_paper_model(cfg: PaperConfig, *, phase: str = "train", device=None):
    """(init, apply): ``init(seed or torch.Generator)`` -> parameters in
    ``phase`` form on the device; ``apply(params, x)`` -> (B, 10) float32
    logits for images x (B, H, W, C) (or flattened rows)."""
    if cfg.kind not in ("mlp", "cnv"):
        raise ValueError(f"unknown paper model kind {cfg.kind!r}")
    device = resolve_device(device)

    def init(seed: Union[int, torch.Generator] = 0):
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=device).manual_seed(int(seed))
        return _init(gen, cfg, phase, device)

    if cfg.kind == "mlp":
        return init, lambda p, x: _dense_stack(x, p, cfg, phase)
    return init, lambda p, x: _cnv_apply(p, x, cfg, phase)


def paper_model_to_serve(params, cfg: PaperConfig) -> Union[List, Dict]:
    """Trained parameters -> the hardware serve form that
    ``build_paper_model(cfg, phase="serve")``'s apply takes: every linear
    and conv leaf rewritten by its backend's ``to_serve``."""
    return tree_to_serve(params, cfg.spec())
