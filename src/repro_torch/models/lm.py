"""Decoder-only LM family (port of ``repro/models/lm.py``): smollm, qwen
(q/k/v bias), nemotron (LayerNorm, squared ReLU), phi3, grok (MoE), mixtral
(MoE + sliding-window attention) and chameleon (LayerNorm; its VQ image
tokens are ordinary vocabulary ids). ``init``, the training forward
``apply`` / ``apply_aux`` (the MoE aux loss averaged over layers), the
dense-cache serve path of the continuous and static engines —
``init_cache``, ``prefill``, ``decode_step`` (over the SWA ring cache where
the config has a window) and the speculative ``decode_verify`` — and the
paged serve path: ``decode_paged``, ``prefill_chunk`` and
``decode_verify_paged``. A layer's FFN is the MLP, or with ``n_experts``
the mixture of experts (``p["moe"]`` in place of ``p["mlp"]``).

Parameters keep the reference's tree: ``{"embed", "layers", "ln_f"}`` with
every ``layers`` leaf stacked ``(L, ...)``. The layer loop is a Python loop
over per-layer views (``split_layers`` makes them once; the functions
accept either form). Caches and pools are updated in place.
``param_axes`` gives every leaf's logical axes (``distributed.sharding``).

Under a tensor-parallel group (``distributed.comm``, placed by
``distributed.tp``) the same functions run a rank's part: the embedding
and head by vocab rows, attention by heads, the MLP by ffn columns, and
``init_cache`` makes a cache of the rank's kv heads
(``distributed.tp.placement``, the ``kv_cache_shardings`` rule with its
fallback).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import comm
from repro_torch.distributed.tp import placement
from repro_torch.nn import embedding
from repro_torch.nn.attention import (
    AttnConfig,
    attn_apply,
    attn_axes,
    attn_decode_step,
    attn_decode_step_paged,
    attn_init,
    attn_prefill,
    attn_prefill_chunk,
    attn_verify_step,
    init_kv_cache,
)
from repro_torch.nn.mlp import mlp_apply, mlp_axes, mlp_init
from repro_torch.nn.module import stack_trees
from repro_torch.nn.moe import MoEConfig, moe_apply, moe_axes, moe_init
from repro_torch.nn.norms import norm_axes

from .base import (ArchConfig, ModelAPI, make_generator, make_norm, scan_blocks_aux,
                   unbind_layers)

__all__ = ["build_lm", "lm_param_axes", "split_layers"]


def _attn_cfg(cfg: ArchConfig) -> AttnConfig:
    return AttnConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd,
        rope_theta=cfg.rope_theta,
        window=cfg.window,
        qkv_bias=cfg.qkv_bias,
        block_q=cfg.block_q,
        paged_route=cfg.paged_attn_route,
        tp_pad_heads=cfg.tp_pad_heads,
    )


def _moe_cfg(cfg: ArchConfig) -> MoEConfig:
    return MoEConfig(
        n_experts=cfg.n_experts,
        top_k=cfg.top_k,
        capacity_factor=cfg.capacity_factor,
        gated=cfg.gated_mlp,
        activation=cfg.activation,
    )


def split_layers(params) -> Dict[str, Any]:
    """Params with ``layers`` as a list of per-layer views of the stacked
    leaves (no copies), so the layer loop indexes nothing per call."""
    return dict(params, layers=unbind_layers(params["layers"]))


def _layer_list(params) -> List[Dict]:
    return split_layers(params)["layers"]


def lm_param_axes(params):
    """The logical axes of every leaf of an lm tree (train or serve phase;
    stacked ``layers`` get the leading "layers" axis, per-layer views none),
    as the reference's boxes carry them."""

    def layer(p, prefix):
        out = {"ln1": norm_axes(p["ln1"], prefix), "ln2": norm_axes(p["ln2"], prefix),
               "attn": attn_axes(p["attn"], prefix)}
        if "moe" in p:
            out["moe"] = moe_axes(p["moe"], prefix)
        else:
            out["mlp"] = mlp_axes(p["mlp"], prefix)
        return out

    layers = params["layers"]
    return {"embed": dict(embedding.EMBED_AXES),
            "layers": ([layer(p, ()) for p in layers] if isinstance(layers, list)
                       else layer(layers, ("layers",))),
            "ln_f": norm_axes(params["ln_f"])}


def _layer_init(gen, cfg: ArchConfig, phase: str, device):
    spec = cfg.linear_spec()
    norm_init, _ = make_norm(cfg)
    p = {
        "ln1": norm_init(cfg.d_model, device=device),
        "ln2": norm_init(cfg.d_model, device=device),
        "attn": attn_init(gen, _attn_cfg(cfg), spec, phase=phase, device=device),
    }
    if cfg.n_experts:
        p["moe"] = moe_init(gen, cfg.d_model, cfg.d_ff, _moe_cfg(cfg), spec, phase=phase,
                            device=device)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, spec, gated=cfg.gated_mlp,
                            phase=phase, device=device)
    return p


def _layer_ffn_aux(p, x: torch.Tensor, cfg: ArchConfig, phase: str):
    """The residual MLP / MoE half of a layer: (x + FFN(norm(x)), aux)."""
    _, norm_apply = make_norm(cfg)
    h = norm_apply(p["ln2"], x)
    spec = cfg.linear_spec()
    if cfg.n_experts:
        y, aux = moe_apply(p["moe"], h, _moe_cfg(cfg), spec, phase=phase)
    else:
        y = mlp_apply(p["mlp"], h, spec, activation=cfg.activation, phase=phase,
                      d_ff=cfg.d_ff)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def _layer_ffn(p, x: torch.Tensor, cfg: ArchConfig, phase: str) -> torch.Tensor:
    """The FFN half of every cached-attention step (the MoE aux loss is the
    training forward's and is dropped here)."""
    return _layer_ffn_aux(p, x, cfg, phase)[0]


def _layer_apply(p, x: torch.Tensor, cfg: ArchConfig, phase: str):
    _, norm_apply = make_norm(cfg)
    x = x + attn_apply(p["attn"], norm_apply(p["ln1"], x), _attn_cfg(cfg),
                       cfg.linear_spec(), phase=phase)
    return _layer_ffn_aux(p, x, cfg, phase)


def _pool_layer(cache, i: int):
    return {name: leaf[i] for name, leaf in cache.items()}


def build_lm(cfg: ArchConfig, *, phase: str = "serve") -> ModelAPI:
    cdtype = cfg.linear_spec().cdtype
    acfg = _attn_cfg(cfg)
    norm_init, norm = make_norm(cfg)
    vocab = cfg.padded_vocab

    def embed(params, tokens):
        return embedding.embed_apply(params["embed"], tokens, cdtype, vocab=vocab)

    def unembed(params, x):
        return embedding.unembed_apply(params["embed"], x, vocab=vocab)

    def init(seed: Union[int, torch.Generator] = 0, device=None):
        """Parameters in ``phase`` form from a seed (or a generator on
        ``device``); layer leaves stacked (L, ...). On CUDA unless
        ``device="cpu"``; raises without a GPU."""
        device = resolve_device(device)
        gen = make_generator(seed, device)
        return {
            "embed": embedding.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                          cfg.linear_spec().pdtype, device=device),
            "layers": stack_trees([_layer_init(gen, cfg, phase, device)
                                   for _ in range(cfg.n_layers)]),
            "ln_f": norm_init(cfg.d_model, device=device),
        }

    def apply_aux(params, batch: Dict[str, Any]):
        """Training forward: batch["tokens"] (B, S) -> (logits (B, S, V')
        float32, aux loss / n_layers). V' is the padded vocab, as in the
        reference; the aux loss is the MoE layers' load-balance loss (0
        without experts)."""
        x = embed(params, batch["tokens"])
        x, aux = scan_blocks_aux(unbind_layers(params["layers"]), x,
                                 lambda p, h: _layer_apply(p, h, cfg, phase), remat=cfg.remat)
        x = norm(params["ln_f"], x)
        return unembed(params, x), aux / max(cfg.n_layers, 1)

    def apply(params, batch: Dict[str, Any]) -> torch.Tensor:
        return apply_aux(params, batch)[0]

    def init_cache(batch: int, max_len: int, *, quantized: bool = False,
                   dtype=None, device=None):
        """``init_kv_cache`` stacked over the layers: leaves (L, batch,
        max_len, Hkv, hd), the dense slot cache (with a window, max_len is
        the ring's min(window, max_len)), or with (n_phys_blocks,
        block_size) the paged pool (the same function serves both, as in the
        reference). On CUDA unless ``device="cpu"``; raises without a GPU.
        Under a tensor-parallel group the heads are the rank's kv heads."""
        heads = placement(cfg, comm.active()).kv_heads
        return init_kv_cache(batch, dataclasses.replace(acfg, n_kv_heads=heads), max_len,
                             dtype=dtype or cdtype, quantized=quantized, layers=cfg.n_layers,
                             device=resolve_device(device))

    def decode_paged(params, tokens, cache, position, tables):
        """Paged one-token decode: tokens (S, 1), position (S,), tables
        (S, T) -> (logits (S, 1, V), pool updated in place)."""
        x = embed(params, tokens)
        spec = cfg.linear_spec()
        for i, p in enumerate(_layer_list(params)):
            a, _ = attn_decode_step_paged(
                p["attn"], norm(p["ln1"], x), _pool_layer(cache, i), position,
                tables, acfg, spec, phase=phase,
            )
            x = _layer_ffn(p, x + a, cfg, phase)
        x = norm(params["ln_f"], x)
        return unembed(params, x), cache

    def _head(params, x):
        return unembed(params, norm(params["ln_f"], x))

    def decode_step(params, tokens, cache, position):
        """Dense one-token decode: tokens (B, 1), position scalar or (B,) ->
        (logits (B, 1, V), cache updated in place; a ring cache where the
        config has a window)."""
        x = embed(params, tokens)
        spec = cfg.linear_spec()
        for i, p in enumerate(_layer_list(params)):
            a, _ = attn_decode_step(p["attn"], norm(p["ln1"], x), _pool_layer(cache, i),
                                    position, acfg, spec, phase=phase)
            x = _layer_ffn(p, x + a, cfg, phase)
        return _head(params, x), cache

    def decode_verify(params, tokens, cache, position):
        """Speculative verify: the (B, C) window scored at per-row positions
        ``position + [0, C)`` in one step, K/V written in place. Returns all
        (B, C, V) logits: slot j's argmax is the greedy successor of window
        token j, what C sequential ``decode_step`` calls would give."""
        x = embed(params, tokens)
        spec = cfg.linear_spec()
        for i, p in enumerate(_layer_list(params)):
            a, _ = attn_verify_step(p["attn"], norm(p["ln1"], x), _pool_layer(cache, i),
                                    position, acfg, spec, phase=phase)
            x = _layer_ffn(p, x + a, cfg, phase)
        return _head(params, x), cache

    def decode_verify_paged(params, tokens, cache, position, tables):
        """Paged speculative verify through ``attn_prefill_chunk`` (kernel 11
        with C = window queries per row on the fused route): all (B, C, V)
        logits."""
        x = embed(params, tokens)
        spec = cfg.linear_spec()
        for i, p in enumerate(_layer_list(params)):
            a, _ = attn_prefill_chunk(p["attn"], norm(p["ln1"], x),
                                      _pool_layer(cache, i), tables, position, acfg, spec,
                                      phase=phase)
            x = _layer_ffn(p, x + a, cfg, phase)
        return _head(params, x), cache

    def prefill(params, batch, *, max_len=None, quantized: bool = False, last_index=None):
        """Prompt pass: (logits (B, 1, V), stacked dense cache of max_len
        positions, or with a window the ring holding the prompt's last
        min(window, max_len) positions). ``last_index`` ((B,) int32) selects
        the position whose logits are returned (the last real token of a
        right-padded bucket), else the last column."""
        tokens = batch["tokens"]
        ml = max_len or tokens.shape[1]
        x = embed(params, tokens)
        spec = cfg.linear_spec()
        caches = []
        for p in _layer_list(params):
            a, c = attn_prefill(p["attn"], norm(p["ln1"], x), acfg, spec, max_len=ml,
                                phase=phase, quantized=quantized, cache_dtype=cdtype)
            caches.append(c)
            x = _layer_ffn(p, x + a, cfg, phase)
        if last_index is None:
            x = x[:, -1:]
        else:
            idx = torch.as_tensor(last_index, device=x.device).to(torch.long).reshape(-1)
            x = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
        return _head(params, x), stack_trees(caches)

    def prefill_chunk(params, tokens, cache, tables, start, last_in_chunk):
        """One fixed-size prompt chunk through every layer, appending its KV
        to the pool. ``last_in_chunk`` ((B,), position within the chunk)
        selects which token's logits to return."""
        x = embed(params, tokens)
        spec = cfg.linear_spec()
        for i, p in enumerate(_layer_list(params)):
            a, _ = attn_prefill_chunk(
                p["attn"], norm(p["ln1"], x), _pool_layer(cache, i), tables, start,
                acfg, spec, phase=phase,
            )
            x = _layer_ffn(p, x + a, cfg, phase)
        idx = last_in_chunk.to(torch.long).reshape(-1)
        x = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
        x = norm(params["ln_f"], x)
        return unembed(params, x), cache

    return ModelAPI(init=init, init_cache=init_cache, decode_paged=decode_paged,
                    prefill_chunk=prefill_chunk, apply=apply, apply_aux=apply_aux,
                    decode_step=decode_step, prefill=prefill, decode_verify=decode_verify,
                    decode_verify_paged=decode_verify_paged, layer_views=split_layers,
                    param_axes=lm_param_axes)
