"""Trainer on one device (port of ``repro/train/trainer.py``, without the
mesh, the sharding and the checkpoints: ``run_with_restarts`` and the
checkpoint manager wait for a later slice).

Parameters are initialised from a seed on the device, the batch of each
step is a function of the step (``data/lm.py``), and the optimizer updates
in place. Runs on CUDA unless ``device="cpu"``; raises without a GPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.data.lm import LMDataConfig, lm_batch
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.base import ArchConfig
from repro_torch.optim.adamw import OptimizerSpec, make_optimizer
from .steps import make_train_step

__all__ = ["TrainConfig", "Trainer"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    arch: ArchConfig
    seq_len: int = 128
    global_batch: int = 8
    microbatches: int = 1
    steps: int = 50
    aux_weight: float = 0.01
    z_loss: float = 1e-4
    data_seed: int = 0
    log_every: int = 10


class Trainer:
    def __init__(self, cfg: TrainConfig, opt: Optional[OptimizerSpec] = None, *,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.api = build_model(cfg.arch, phase="train")
        self.opt_spec = opt or OptimizerSpec(total_steps=cfg.steps)
        self.opt_init, opt_update = make_optimizer(self.opt_spec)
        self.data_cfg = LMDataConfig(vocab=cfg.arch.vocab, seq_len=cfg.seq_len,
                                     global_batch=cfg.global_batch, seed=cfg.data_seed)
        self.step_fn = make_train_step(self.api, opt_update, aux_weight=cfg.aux_weight,
                                       z_loss=cfg.z_loss, microbatches=cfg.microbatches)
        self.metrics_log: List[Dict[str, float]] = []

    def init(self):
        """(params, optimizer state, start step 0); parameters from seed 42,
        as the reference's ``init_or_restore``."""
        params = self.api.init(42, device=self.device)
        return params, self.opt_init(params), 0

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        return lm_batch(self.data_cfg, step, device=self.device)

    def train_step(self, params, opt_state, step: int):
        """One step on the batch of ``step``; returns (params, opt_state,
        metrics), the trees updated in place."""
        return self.step_fn(params, opt_state, self.batch(step))

    def run(self, params=None, opt_state=None, start_step: Optional[int] = None):
        if params is None:
            params, opt_state, start_step = self.init()
        t0 = time.perf_counter()
        for step in range(start_step, self.cfg.steps):
            params, opt_state, metrics = self.train_step(params, opt_state, step)
            if (step + 1) % self.cfg.log_every == 0 or step == start_step:
                m = {k: float(v) for k, v in metrics.items()}  # float() syncs the step
                m["step"] = step
                m["wall_s"] = time.perf_counter() - t0
                self.metrics_log.append(m)
        return params, opt_state, self.metrics_log
