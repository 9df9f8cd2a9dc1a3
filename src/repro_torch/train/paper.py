"""Training and evaluation of the paper's models (the port's counterpart of
``benchmarks/common.py``'s ``train_paper_model``).

The same recipe as the reference: softmax cross-entropy with no z-loss;
AdamW at ``lr`` with warmup max(steps // 20, 10), cosine decay and no
weight decay; batch ``step`` of the seed's stream for step ``step``; the
validation accuracy over 8 batches of seed + 10_000 at indices 90_000 + j.
The steps are ``train/steps.py``'s ``loss_and_grads`` and
``make_eval_step`` over ``image_api``. Every projection trains through its
backend's ``apply_train``: on CUDA, bika through the training CAC kernels
(2 forward; 5, or 3 and 4 with ``kernels.ops.FUSED_BWD_DEFAULT = False``,
backward) and bnn through the sign-product kernels (6 forward, 8 and 9
backward). Runs on CUDA unless ``device="cpu"``; raises without a GPU.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Dict, Tuple

import torch

from repro_torch.data.vision import digits_batch, textures_batch
from repro_torch.device import resolve_device
from repro_torch.models.paper import PaperConfig, build_paper_model
from repro_torch.optim.adamw import OptimizerSpec, make_optimizer
from repro_torch.train.steps import loss_and_grads, make_eval_step

__all__ = ["dataset_batch", "fit", "image_api", "train_paper_model", "val_accuracy"]

# the paper recipe's loss: cross-entropy alone (no auxiliary loss, no z-loss)
PAPER_LOSS = {"aux_weight": 0.0, "z_loss": 0.0}


def dataset_batch(name: str) -> Callable:
    """The batch function of dataset ``name`` ("digits" or "textures")."""
    if name not in ("digits", "textures"):
        raise ValueError(f"unknown dataset {name!r}; known: digits, textures")
    return digits_batch if name == "digits" else textures_batch


def image_api(apply: Callable) -> SimpleNamespace:
    """The members of ``models.base.ModelAPI`` that ``train/steps.py``
    reads (``apply``, ``apply_aux``), over an image model's ``apply(params,
    x)``: batches are ``{"x", "labels"}`` and the auxiliary loss is 0."""

    def apply_aux(params, batch):
        return apply(params, batch["x"]), torch.zeros((), device=batch["x"].device)

    return SimpleNamespace(apply=lambda params, batch: apply(params, batch["x"]),
                           apply_aux=apply_aux)


def fit(apply: Callable, params, dataset: str, *, steps: int, batch: int, lr: float,
        warmup: int, seed: int = 0, device=None) -> Tuple[object, float]:
    """``steps`` AdamW steps (peak ``lr``, ``warmup``, cosine decay, no
    weight decay) on batches 0 .. steps - 1 of ``seed``'s stream; returns
    (params, the last batch's accuracy)."""
    device = resolve_device(device)
    opt_init, opt_update = make_optimizer(OptimizerSpec(
        peak_lr=lr, warmup=warmup, total_steps=steps, weight_decay=0.0))
    opt, api, get_batch = opt_init(params), image_api(apply), dataset_batch(dataset)
    acc = torch.zeros(())
    for s in range(steps):
        x, y = get_batch(seed, s, batch, device=device)
        metrics, grads = loss_and_grads(api, params, {"x": x, "labels": y}, **PAPER_LOSS)
        params, opt, _ = opt_update(grads, opt, params)
        acc = metrics["accuracy"]
    return params, float(acc)


def val_accuracy(apply: Callable, params, dataset: str, *, seed: int = 0, batch: int = 128,
                 batches: int = 8, device=None) -> float:
    """Mean accuracy over ``batches`` validation batches of seed + 10_000
    at indices 90_000 + j (the reference's held-out split)."""
    get_batch, device = dataset_batch(dataset), resolve_device(device)
    eval_step = make_eval_step(image_api(apply))
    accs = []
    for j in range(batches):
        x, y = get_batch(seed + 10_000, 90_000 + j, batch, device=device)
        accs.append(eval_step(params, {"x": x, "labels": y})["accuracy"])
    return float(torch.stack(accs).mean())


def train_paper_model(cfg: PaperConfig, dataset: str = "digits", *, steps: int = 300,
                      batch: int = 128, lr: float = 1e-3, seed: int = 0, device=None) -> Dict:
    """A short training run from seed ``seed``; returns {"train_acc" (the
    last step's batch), "val_acc", "params" (train form)}."""
    device = resolve_device(device)
    init, apply = build_paper_model(cfg, phase="train", device=device)
    params, train_acc = fit(apply, init(seed), dataset, steps=steps, batch=batch, lr=lr,
                            warmup=max(steps // 20, 10), seed=seed, device=device)
    val = val_accuracy(apply, params, dataset, seed=seed, batch=batch, device=device)
    return {"train_acc": train_acc, "val_acc": val, "params": params}
