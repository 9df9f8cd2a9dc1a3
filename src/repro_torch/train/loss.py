"""Losses (port of ``repro/train/loss.py``): softmax cross-entropy in
float32 with an optional z-loss (stabilizes the large-vocab head) and
label masking.

The label's logit is picked by ``_LabelLogit``, whose backward writes each
row's one gradient by a compare against the vocabulary index: the backward
of ``torch.gather`` is a ``scatter_add_``, which PyTorch counts as
nondeterministic on CUDA, and a restarted run must equal an uninterrupted
one bit for bit. The values are the same (one term added to zeros)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = ["softmax_xent"]


class _LabelLogit(torch.autograd.Function):
    """logits[..., labels[...]] with an elementwise (compare-and-select)
    backward in place of gather's scatter-add."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(labels)
        ctx.vocab = logits.shape[-1]
        return torch.gather(logits.detach(), -1, labels[..., None])[..., 0]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (labels,) = ctx.saved_tensors
        hit = torch.arange(ctx.vocab, device=labels.device) == labels[..., None]
        return torch.where(hit, g[..., None], torch.zeros((), dtype=g.dtype,
                                                          device=g.device)), None


def softmax_xent(
    logits: torch.Tensor,
    labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    z_loss: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits (..., V); labels (...) int; mask (...) weights. Returns (mean
    loss, metrics {"loss", "accuracy", "tokens"}), all 0-dim float32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = _LabelLogit.apply(logits, labels.long())
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse.square()
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.to(torch.float32)
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = (nll * mask).sum() / denom
    acc = ((logits.argmax(-1) == labels).to(torch.float32) * mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}
