"""zamba2-style hybrid (port of ``repro/models/hybrid.py``): a Mamba2
backbone and one *shared* attention+MLP block applied after every
``attn_every`` SSM blocks. The block's weights are shared across its
applications; each application (group) keeps its own KV stream.

Parameters keep the reference's tree: ``{"embed", "mamba", "shared",
"ln_f"}`` with every ``mamba`` leaf stacked ``(L, ...)``; layer i belongs to
group i // attn_every. The serve cache is ``{"mamba": {"h", "conv"}``
stacked ``(L, ...)``, ``"shared":`` the dense KV cache stacked ``(groups,
...)}``; ``decode_step`` updates both in place. The layer loops are Python
loops over per-layer views (``layer_views`` makes them once). Sub-quadratic
in sequence length, so the family runs the long_500k cell.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.nn import embedding
from repro_torch.nn.attention import (
    AttnConfig,
    attn_apply,
    attn_decode_step,
    attn_init,
    attn_prefill,
    init_kv_cache,
)
from repro_torch.nn.mlp import mlp_apply, mlp_init
from repro_torch.nn.module import stack_trees
from repro_torch.nn.ssm import SSMConfig, init_ssm_state, ssm_apply, ssm_decode_step, ssm_init

from .base import ArchConfig, ModelAPI, make_generator, make_norm, unbind_layers

__all__ = ["build_hybrid"]


def _ssm_cfg(cfg: ArchConfig) -> SSMConfig:
    return SSMConfig(d_model=cfg.d_model, d_state=cfg.ssm_state, expand=cfg.ssm_expand,
                     head_dim=cfg.ssm_head_dim)


def _attn_cfg(cfg: ArchConfig) -> AttnConfig:
    return AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                      head_dim=cfg.hd, rope_theta=cfg.rope_theta, block_q=cfg.block_q)


def layer_views(params):
    """The tree with ``mamba`` as a list of per-layer views (no copies)."""
    return dict(params, mamba=unbind_layers(params["mamba"]))


def build_hybrid(cfg: ArchConfig, *, phase: str = "serve") -> ModelAPI:
    assert cfg.attn_every > 0 and cfg.n_layers % cfg.attn_every == 0, (
        cfg.n_layers, cfg.attn_every)
    groups = cfg.n_layers // cfg.attn_every
    scfg, acfg = _ssm_cfg(cfg), _attn_cfg(cfg)
    spec = cfg.linear_spec()
    cdtype = spec.cdtype
    norm_init, norm = make_norm(cfg)

    def init(seed: Union[int, torch.Generator] = 0, device=None):
        """Parameters in ``phase`` form from a seed (or a generator on
        ``device``); ``mamba`` leaves stacked (L, ...). On CUDA unless
        ``device="cpu"``; raises without a GPU."""
        device = resolve_device(device)
        gen = make_generator(seed, device)
        embed = embedding.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                     spec.pdtype, device=device)
        mamba = stack_trees([{"ln": norm_init(cfg.d_model, device=device),
                              "ssm": ssm_init(gen, scfg, spec, phase=phase, device=device)}
                             for _ in range(cfg.n_layers)])
        shared = {
            "ln1": norm_init(cfg.d_model, device=device),
            "attn": attn_init(gen, acfg, spec, phase=phase, device=device),
            "ln2": norm_init(cfg.d_model, device=device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, spec, gated=cfg.gated_mlp,
                            phase=phase, device=device),
        }
        return {"embed": embed, "mamba": mamba, "shared": shared,
                "ln_f": norm_init(cfg.d_model, device=device)}

    def _mamba_block(p, x, return_state=False):
        y = ssm_apply(p["ssm"], norm(p["ln"], x), scfg, spec, phase=phase,
                      return_state=return_state)
        if return_state:
            y, st = y
            return x + y, st
        return x + y

    def _mlp_half(shared, x):
        return x + mlp_apply(shared["mlp"], norm(shared["ln2"], x), spec,
                             activation=cfg.activation, phase=phase)

    def _shared_block(shared, x):
        x = x + attn_apply(shared["attn"], norm(shared["ln1"], x), acfg, spec, phase=phase)
        return _mlp_half(shared, x)

    def _grouped(params):
        """(group, [its mamba layers' (index, params)]) in order."""
        layers = unbind_layers(params["mamba"])
        k = cfg.attn_every
        return [(g, [(i, layers[i]) for i in range(g * k, (g + 1) * k)])
                for g in range(groups)]

    def apply(params, batch: Dict[str, Any]) -> torch.Tensor:
        """Training or serve forward: batch["tokens"] (B, S) -> logits (B, S,
        V') float32; with ``remat`` each block runs under
        ``torch.utils.checkpoint``."""
        def run(fn, *args):
            if cfg.remat and torch.is_grad_enabled():
                return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
            return fn(*args)

        x = embedding.embed_apply(params["embed"], batch["tokens"], cdtype)
        for _, members in _grouped(params):
            for _, p in members:
                x = run(_mamba_block, p, x)
            x = run(_shared_block, params["shared"], x)
        x = norm(params["ln_f"], x)
        return embedding.unembed_apply(params["embed"], x)

    def apply_aux(params, batch):
        logits = apply(params, batch)
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    def init_cache(batch: int, max_len: int, *, quantized: bool = False, dtype=None,
                   device=None):
        """{"mamba": the SSM states stacked (L, ...), "shared": the dense KV
        cache stacked (groups, ...)}. On CUDA unless ``device="cpu"``."""
        device = resolve_device(device)
        one = init_ssm_state(batch, scfg, device=device)
        return {
            "mamba": {k: torch.zeros((cfg.n_layers,) + v.shape, dtype=v.dtype, device=device)
                      for k, v in one.items()},
            "shared": init_kv_cache(batch, acfg, max_len, dtype=dtype or cdtype,
                                    quantized=quantized, layers=groups, device=device),
        }

    def decode_step(params, tokens, cache, position):
        """One-token decode: tokens (B, 1), position scalar or (B,) ->
        (logits (B, 1, V), cache updated in place)."""
        x = embedding.embed_apply(params["embed"], tokens, cdtype)
        shared, states = params["shared"], cache["mamba"]
        for g, members in _grouped(params):
            for i, p in members:
                y, new = ssm_decode_step(p["ssm"], norm(p["ln"], x),
                                         {k: v[i] for k, v in states.items()}, scfg, spec,
                                         phase=phase)
                x = x + y
                for k, v in new.items():
                    states[k][i] = v
            kv = {name: leaf[g] for name, leaf in cache["shared"].items()}
            a, _ = attn_decode_step(shared["attn"], norm(shared["ln1"], x), kv, position,
                                    acfg, spec, phase=phase)
            x = _mlp_half(shared, x + a)
        x = norm(params["ln_f"], x)
        return embedding.unembed_apply(params["embed"], x), cache

    def prefill(params, batch, *, max_len: Optional[int] = None, quantized: bool = False):
        """Prompt pass: (last-token logits (B, 1, V), the cache: every
        layer's final SSM state and every group's KV over max_len
        positions)."""
        tokens = batch["tokens"]
        ml = max_len or tokens.shape[1]
        x = embedding.embed_apply(params["embed"], tokens, cdtype)
        shared = params["shared"]
        states, kvs = [], []
        for _, members in _grouped(params):
            for _, p in members:
                x, st = _mamba_block(p, x, return_state=True)
                states.append(st)
            a, kv = attn_prefill(shared["attn"], norm(shared["ln1"], x), acfg, spec,
                                 max_len=ml, phase=phase, quantized=quantized,
                                 cache_dtype=cdtype)
            kvs.append(kv)
            x = _mlp_half(shared, x + a)
        x = norm(params["ln_f"], x[:, -1:])
        logits = embedding.unembed_apply(params["embed"], x)
        return logits, {"mamba": stack_trees(states), "shared": stack_trees(kvs)}

    return ModelAPI(init=init, init_cache=init_cache, apply=apply, apply_aux=apply_aux,
                    decode_step=decode_step, prefill=prefill, layer_views=layer_views)
