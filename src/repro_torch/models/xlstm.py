"""xLSTM-125m (port of ``repro/models/xlstm.py``): a stack of mLSTM blocks
with sLSTM blocks interleaved (``slstm_every``; layer i is sLSTM when i %
slstm_every == 0).

The blocks are heterogeneous, so ``layers`` is a list of per-layer trees,
never stacked, and the serve cache is a list of per-layer states (mLSTM
{"C", "n", "m"}, sLSTM {"h", "c", "n", "m"}). ``init_cache`` and
``prefill`` take and ignore ``quantized``: there is no KV. Recurrent, so
the family runs the long_500k cell.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.nn import embedding
from repro_torch.nn.xlstm_blocks import (
    XLSTMConfig,
    init_mlstm_state,
    init_slstm_state,
    mlstm_apply,
    mlstm_decode_step,
    mlstm_init,
    slstm_apply,
    slstm_decode_step,
    slstm_init,
)

from .base import ArchConfig, ModelAPI, make_generator, make_norm

__all__ = ["build_xlstm"]


def _xcfg(cfg: ArchConfig) -> XLSTMConfig:
    return XLSTMConfig(d_model=cfg.d_model, n_heads=cfg.n_heads)


def _is_slstm(cfg: ArchConfig, i: int) -> bool:
    return cfg.slstm_every > 0 and i % cfg.slstm_every == 0


def build_xlstm(cfg: ArchConfig, *, phase: str = "serve") -> ModelAPI:
    xcfg = _xcfg(cfg)
    spec = cfg.linear_spec()
    cdtype = spec.cdtype
    norm_init, norm = make_norm(cfg)

    def init(seed: Union[int, torch.Generator] = 0, device=None):
        """Parameters in ``phase`` form from a seed (or a generator on
        ``device``). On CUDA unless ``device="cpu"``; raises without a GPU."""
        device = resolve_device(device)
        gen = make_generator(seed, device)
        layers: List[Any] = []
        for i in range(cfg.n_layers):
            cell_init = slstm_init if _is_slstm(cfg, i) else mlstm_init
            layers.append({"ln": norm_init(cfg.d_model, device=device),
                           "cell": cell_init(gen, xcfg, spec, phase=phase, device=device)})
        return {
            "embed": embedding.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                          spec.pdtype, device=device),
            "layers": layers,
            "ln_f": norm_init(cfg.d_model, device=device),
        }

    def _block(i, p, x, return_state=False):
        fn = slstm_apply if _is_slstm(cfg, i) else mlstm_apply
        y = fn(p["cell"], norm(p["ln"], x), xcfg, spec, phase=phase, return_state=return_state)
        if return_state:
            y, st = y
            return x + y, st
        return x + y

    def apply(params, batch: Dict[str, Any]) -> torch.Tensor:
        """batch["tokens"] (B, S) -> logits (B, S, V') float32; with
        ``remat`` each block runs under ``torch.utils.checkpoint``."""
        x = embedding.embed_apply(params["embed"], batch["tokens"], cdtype)
        for i, p in enumerate(params["layers"]):
            if cfg.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(_block, i, p, x, use_reentrant=False)
            else:
                x = _block(i, p, x)
        x = norm(params["ln_f"], x)
        return embedding.unembed_apply(params["embed"], x)

    def apply_aux(params, batch):
        logits = apply(params, batch)
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    def init_cache(batch: int, max_len: int = 0, *, quantized: bool = False, dtype=None,
                   device=None):
        """Every layer's zero state (``max_len`` and ``quantized`` have no
        part in it). On CUDA unless ``device="cpu"``."""
        device = resolve_device(device)
        return [(init_slstm_state if _is_slstm(cfg, i) else init_mlstm_state)(
            batch, xcfg, device=device) for i in range(cfg.n_layers)]

    def decode_step(params, tokens, cache, position):
        """One-token decode: tokens (B, 1) -> (logits (B, 1, V), the new
        states); ``position`` has no part in a recurrence."""
        x = embedding.embed_apply(params["embed"], tokens, cdtype)
        new_cache = []
        for i, (p, st) in enumerate(zip(params["layers"], cache)):
            fn = slstm_decode_step if _is_slstm(cfg, i) else mlstm_decode_step
            y, ns = fn(p["cell"], norm(p["ln"], x), st, xcfg, spec, phase=phase)
            x = x + y
            new_cache.append(ns)
        x = norm(params["ln_f"], x)
        return embedding.unembed_apply(params["embed"], x), new_cache

    def prefill(params, batch, *, max_len: Optional[int] = None, quantized: bool = False):
        """Prompt pass: (last-token logits (B, 1, V), every layer's final
        state)."""
        x = embedding.embed_apply(params["embed"], batch["tokens"], cdtype)
        states = []
        for i, p in enumerate(params["layers"]):
            x, st = _block(i, p, x, return_state=True)
            states.append(st)
        x = norm(params["ln_f"], x[:, -1:])
        return embedding.unembed_apply(params["embed"], x), states

    return ModelAPI(init=init, init_cache=init_cache, apply=apply, apply_aux=apply_aux,
                    decode_step=decode_step, prefill=prefill)
