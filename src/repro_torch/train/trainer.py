"""Trainer on one device with checkpoint and restart (port of
``repro/train/trainer.py``, without the mesh and the sharding).

Parameters are initialised from a seed on the device, the batch of each
step is a function of the step (``data/lm.py``), and the optimizer updates
in place. With ``ckpt_dir`` the trainer saves every ``ckpt_every`` steps
and at the end (``checkpoint/manager.py``), and ``init_or_restore`` picks
up the latest checkpoint and its step. ``run_with_restarts`` is the
supervisor: a trainer may die at any step (tests inject
``SimulatedFailure`` through ``fail_at_step``), a new one restores the
latest checkpoint, and since the data is a function of the step and every
op of the step is deterministic, the restarted run equals the
uninterrupted one bit for bit. Runs on CUDA unless ``device="cpu"``;
raises without a GPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.data.lm import LMDataConfig, lm_batch
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.base import ArchConfig
from repro_torch.optim.adamw import OptimizerSpec, make_optimizer
from .steps import make_train_step

__all__ = ["TrainConfig", "Trainer", "SimulatedFailure", "run_with_restarts"]


class SimulatedFailure(RuntimeError):
    """Raised by the failure-injection hook to stand for a preemption or a
    crash."""


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    arch: ArchConfig
    seq_len: int = 128
    global_batch: int = 8
    microbatches: int = 1
    steps: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 25
    keep: int = 3
    aux_weight: float = 0.01
    z_loss: float = 1e-4
    data_seed: int = 0
    log_every: int = 10
    async_ckpt: bool = False


class Trainer:
    def __init__(self, cfg: TrainConfig, opt: Optional[OptimizerSpec] = None, *,
                 device=None, fail_at_step: Optional[int] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.fail_at_step = fail_at_step
        self.api = build_model(cfg.arch, phase="train")
        self.opt_spec = opt or OptimizerSpec(total_steps=cfg.steps)
        self.opt_init, opt_update = make_optimizer(self.opt_spec)
        # the encoder-decoder family trains its encoder on (B, S, d_model)
        # frames beside the tokens, as the reference's trainer sets it
        self.data_cfg = LMDataConfig(
            vocab=cfg.arch.vocab, seq_len=cfg.seq_len, global_batch=cfg.global_batch,
            seed=cfg.data_seed,
            frames_dim=cfg.arch.d_model if cfg.arch.family == "encdec" else 0)
        self.step_fn = make_train_step(self.api, opt_update, aux_weight=cfg.aux_weight,
                                       z_loss=cfg.z_loss, microbatches=cfg.microbatches)
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep) if cfg.ckpt_dir else None
        self.metrics_log: List[Dict[str, float]] = []

    def init(self):
        """(params, optimizer state, start step 0); parameters from seed 42,
        as the reference's ``init_or_restore``."""
        params = self.api.init(42, device=self.device)
        return params, self.opt_init(params), 0

    def init_or_restore(self):
        """``init``, then, when the checkpoint directory holds a checkpoint,
        the latest one restored into that template on this device, and its
        step as the start step."""
        params, opt_state, start = self.init()
        if self.ckpt and latest_step(self.cfg.ckpt_dir) is not None:
            state, manifest = self.ckpt.restore_latest({"params": params, "opt": opt_state},
                                                       device=self.device)
            params, opt_state = state["params"], state["opt"]
            start = int(manifest["step"])
        return params, opt_state, start

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        return lm_batch(self.data_cfg, step, device=self.device)

    def train_step(self, params, opt_state, step: int):
        """One step on the batch of ``step``; returns (params, opt_state,
        metrics), the trees updated in place."""
        return self.step_fn(params, opt_state, self.batch(step))

    def run(self, params=None, opt_state=None, start_step: Optional[int] = None):
        if params is None:
            params, opt_state, start_step = self.init_or_restore()
        t0 = time.perf_counter()
        saved = None  # the step of the last checkpoint this run wrote
        for step in range(start_step, self.cfg.steps):
            if self.fail_at_step is not None and step == self.fail_at_step:
                raise SimulatedFailure(f"injected failure at step {step}")
            params, opt_state, metrics = self.train_step(params, opt_state, step)
            if (step + 1) % self.cfg.log_every == 0 or step == start_step:
                m = {k: float(v) for k, v in metrics.items()}  # float() syncs the step
                m["step"] = step
                m["wall_s"] = time.perf_counter() - t0
                self.metrics_log.append(m)
            if self.ckpt and (step + 1) % self.cfg.ckpt_every == 0:
                self.ckpt.save(step + 1, {"params": params, "opt": opt_state},
                               blocking=not self.cfg.async_ckpt)
                saved = step + 1
        if self.ckpt:
            # the final state; the reference writes it again even when the
            # last periodic save holds it, which rewrites the same bytes
            if saved != self.cfg.steps:
                self.ckpt.save(self.cfg.steps, {"params": params, "opt": opt_state})
            self.ckpt.wait()
        return params, opt_state, self.metrics_log


def run_with_restarts(make_trainer: Callable[[], Trainer], *, max_restarts: int = 5):
    """The supervisor: make a trainer and run it; on ``SimulatedFailure``
    make a new one (which restores the latest checkpoint) until a run
    completes. Returns ``(params, opt_state, metrics_log, restarts)``;
    raises the failure after ``max_restarts`` restarts."""
    attempts = 0
    while True:
        trainer = make_trainer()
        try:
            return trainer.run() + (attempts,)
        except SimulatedFailure:
            attempts += 1
            if attempts > max_restarts:
                raise
