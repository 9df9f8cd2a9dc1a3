"""Synthetic LM token pipeline (port of ``repro/data/lm.py``).

Tokens come from an order-1 Markov chain over "topic" states, each of
which prefers a band of a Zipf-tilted vocabulary, so there is next-token
structure to learn. A batch is a function of ``(seed, step)`` only, drawn
from a ``torch.Generator`` on the target device: no iterator state exists
outside the step counter. The draws are not JAX's bits (the two generators
differ), so parity tests feed one batch, as numpy, to both packages. With
``frames_dim`` a batch also carries the encoder-decoder family's frame
embeddings, drawn from the same generator after every token draw, so the
tokens of a batch do not depend on ``frames_dim``. The reference's
multi-host sharding of a batch is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

__all__ = ["LMDataConfig", "lm_batch"]


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_classes: int = 64  # Markov "topic" states; the vocab is banded among them
    frames_dim: int = 0  # > 0: also emit (B, seq_len, frames_dim) frame embeddings


def _zipf_logits(vocab: int, n_classes: int, device) -> torch.Tensor:
    """Per-state next-token logits: each Markov state prefers a vocab band."""
    v = torch.arange(vocab, dtype=torch.float32, device=device)
    zipf = -torch.log1p(v)  # global Zipf tilt
    state = torch.arange(n_classes, dtype=torch.float32, device=device)[:, None]
    band = vocab / n_classes
    center = (state + 0.5) * band
    pref = -0.5 * ((v[None, :] - center) / (2.0 * band)) ** 2
    return zipf[None, :] + 4.0 * pref  # (C, V)


def lm_batch(cfg: LMDataConfig, step: int, *,
             device: Optional[Union[str, torch.device]] = "cpu") -> Dict[str, torch.Tensor]:
    """Batch for ``step``: {"tokens" (B, S) int32, "labels" (B, S) int32 (the
    next token), "mask" (B, S) float32 ones}, B = global_batch; with
    ``frames_dim`` also "frames" (B, S, frames_dim) float32, 0.1 x a
    standard normal, as the reference's."""
    b = cfg.global_batch
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed((cfg.seed * 1_000_003 + step) & 0x7FFF_FFFF_FFFF_FFFF)
    logits = _zipf_logits(cfg.vocab, cfg.n_classes, device)
    state = torch.randint(0, cfg.n_classes, (b,), generator=gen, device=device)
    toks = []
    for _ in range(cfg.seq_len + 1):
        # categorical draw by Gumbel-max, as jax.random.categorical does
        u = torch.rand((b, cfg.vocab), generator=gen, device=device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        tok = torch.argmax(logits[state] + gumbel, dim=-1)
        # the topic persists w.p. 7/8, else is re-drawn from the token
        switch = torch.rand((b,), generator=gen, device=device) < 0.125
        state = torch.where(switch, tok % cfg.n_classes, state)
        toks.append(tok)
    toks = torch.stack(toks, dim=1).to(torch.int32)  # (b, S+1)
    out = {
        "tokens": toks[:, :-1].contiguous(),
        "labels": toks[:, 1:].contiguous(),
        "mask": torch.ones((b, cfg.seq_len), dtype=torch.float32, device=device),
    }
    if cfg.frames_dim:
        out["frames"] = 0.1 * torch.randn((b, cfg.seq_len, cfg.frames_dim), generator=gen,
                                          device=device)
    return out
