"""train_step / eval_step builders (port of ``repro/train/steps.py``).

``make_train_step`` composes optional microbatch gradient accumulation
(bounded activation memory), the aux-loss weighting, the skip of a
non-finite step (it updates nothing but advances the step counter) and the
optimizer update, which runs in place (``optim/adamw.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.models.base import ModelAPI
from repro_torch.optim.adamw import global_norm, tree_leaves
from .loss import softmax_xent

__all__ = ["make_eval_step", "make_train_step", "loss_and_grads"]


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(tree)


def loss_and_grads(api: ModelAPI, params, batch: Dict[str, torch.Tensor], *,
                   aux_weight: float = 0.01, z_loss: float = 1e-4
                   ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(metrics, gradient tree shaped like ``params``) of the weighted loss
    ``xent + aux_weight * aux`` on one batch. The parameters need not
    require grad; detached leaves that do stand in for them."""
    leaves = tree_leaves(params)
    live = [leaf.detach().requires_grad_(True) for leaf in leaves]
    tracked = _unflatten(params, live)
    logits, aux = api.apply_aux(tracked, batch)
    loss, metrics = softmax_xent(logits, batch["labels"], batch.get("mask"), z_loss=z_loss)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["aux_loss"] = aux.detach()
    grads = torch.autograd.grad(loss + aux_weight * aux, live)
    return metrics, _unflatten(params, list(grads))


def make_train_step(
    api: ModelAPI,
    opt_update: Callable,
    *,
    aux_weight: float = 0.01,
    z_loss: float = 1e-4,
    microbatches: int = 1,
):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). The update is in place: the returned trees are the ones passed
    in. A step whose loss or gradient norm is not finite updates nothing
    and advances the step counter; the check reads both on the host (one
    synchronisation per step)."""

    def compute_grads(params, batch):
        if microbatches == 1:
            metrics, grads = loss_and_grads(api, params, batch, aux_weight=aux_weight,
                                            z_loss=z_loss)
            return grads, metrics
        b = batch["tokens"].shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
        size = b // microbatches
        g_acc, m_acc = None, None
        for i in range(microbatches):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            metrics, grads = loss_and_grads(api, params, mb, aux_weight=aux_weight,
                                            z_loss=z_loss)
            g_leaves = [g.to(torch.float32) for g in tree_leaves(grads)]
            if g_acc is None:
                g_acc, m_acc = g_leaves, dict(metrics)
            else:
                for a, g in zip(g_acc, g_leaves):
                    a.add_(g)
                m_acc = {k: m_acc[k] + metrics[k] for k in m_acc}
        inv = 1.0 / microbatches
        grads = _unflatten(params, [g * inv for g in g_acc])
        metrics = {k: v * inv for k, v in m_acc.items()}
        metrics["tokens"] = metrics["tokens"] * microbatches
        return grads, metrics

    def train_step(params, opt_state, batch):
        grads, metrics = compute_grads(params, batch)
        gnorm = global_norm(grads)
        # repro: noqa-RPA001 -- the non-finite check on the host, one sync a step;
        # Queue 1 item 1 moves it to the device (the reference's jnp.where)
        ok = bool(torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm))
        metrics["skipped"] = torch.tensor(0.0 if ok else 1.0)
        if not ok:  # keep the step counter advancing on a skipped update
            opt_state["step"] = opt_state["step"] + 1
            metrics["grad_norm"] = gnorm
            return params, opt_state, metrics
        params, opt_state, stats = opt_update(grads, opt_state, params)
        metrics.update(stats)
        return params, opt_state, metrics

    return train_step


def make_eval_step(api: ModelAPI, *, z_loss: float = 0.0):
    """Returns eval_step(params, batch) -> metrics {"loss", "accuracy",
    "tokens"} of ``api.apply`` on the batch, with no autograd graph."""

    @torch.no_grad()
    def eval_step(params, batch):
        logits = api.apply(params, batch)
        return softmax_xent(logits, batch["labels"], batch.get("mask"), z_loss=z_loss)[1]

    return eval_step
