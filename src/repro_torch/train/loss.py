"""Losses (port of ``repro/train/loss.py``): softmax cross-entropy in
float32 with an optional z-loss (stabilizes the large-vocab head) and
label masking."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = ["softmax_xent"]


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
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
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
