"""seamless-m4t-v2-style encoder-decoder backbone (port of
``repro/models/encdec.py``): a text decoder over a modality encoder. The
modality frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings ``batch["frames"]`` (B, S_enc, d_model) beside
``batch["tokens"]`` (B, S); the family implements everything after the
frontend: the encoder stack, cross-attention, the decoder stack and
generation.

Parameters keep the reference's tree: ``{"embed", "enc_ln_in", "encoder",
"decoder", "enc_ln_f", "ln_f"}`` with every ``encoder`` leaf (ln1, attn,
ln2, mlp) and ``decoder`` leaf (ln1, attn, lnx, xattn, ln2, mlp) stacked
``(L, ...)``; the head is the tied ``embed`` table. The encoder's
self-attention is non-causal with RoPE, the decoder's causal with RoPE,
cross-attention has no RoPE and sees every frame.

The serve cache is ``{"self": the decoder's dense KV cache stacked (L,
...), "cross_k", "cross_v": (L, B, S_enc, Hkv, hd)}``. ``prefill`` runs the
encoder once and keeps each decoder layer's cross K/V in the compute dtype
(also under int8 self KV); ``decode_step`` writes the self cache in place
and only reads the cross cache. The reference projects each layer's cross
K/V twice at prefill (inside its cross ``attn_apply`` and again for the
cache, from the same input with the same weights); the port projects them
once and uses the result for both, which gives the same values and two
projections fewer a layer. The layer loops are Python loops over
per-layer views (``layer_views`` makes them once).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.nn import embedding
from repro_torch.nn.attention import (
    AttnConfig,
    _split_heads,
    attn_apply,
    attn_decode_step,
    attn_init,
    attn_prefill,
    cross_attention,
    dot_attention,
    init_kv_cache,
)
from repro_torch.nn.linear import linear_apply
from repro_torch.nn.mlp import mlp_apply, mlp_init
from repro_torch.nn.module import stack_trees

from .base import ArchConfig, ModelAPI, make_generator, make_norm, unbind_layers

__all__ = ["build_encdec"]


def _self_cfg(cfg: ArchConfig, causal: bool) -> AttnConfig:
    return AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                      head_dim=cfg.hd, rope_theta=cfg.rope_theta, causal=causal,
                      block_q=cfg.block_q)


def layer_views(params):
    """The tree with ``encoder`` and ``decoder`` as lists of per-layer views
    (no copies)."""
    return dict(params, encoder=unbind_layers(params["encoder"]),
                decoder=unbind_layers(params["decoder"]))


def build_encdec(cfg: ArchConfig, *, phase: str = "serve") -> ModelAPI:
    assert cfg.n_encoder_layers > 0, cfg.n_encoder_layers
    spec = cfg.linear_spec()
    cdtype = spec.cdtype
    norm_init, norm = make_norm(cfg)
    enc_cfg = _self_cfg(cfg, causal=False)
    dec_cfg = _self_cfg(cfg, causal=True)
    x_cfg = dataclasses.replace(enc_cfg, cross=True)

    def _mlp(p, x):
        return x + mlp_apply(p["mlp"], norm(p["ln2"], x), spec, activation=cfg.activation,
                             phase=phase)

    def init(seed: Union[int, torch.Generator] = 0, device=None):
        """Parameters in ``phase`` form from a seed (or a generator on
        ``device``); ``encoder`` and ``decoder`` leaves stacked (L, ...). On
        CUDA unless ``device="cpu"``; raises without a GPU."""
        device = resolve_device(device)
        gen = make_generator(seed, device)

        def ln():
            return norm_init(cfg.d_model, device=device)

        def mlp():
            return mlp_init(gen, cfg.d_model, cfg.d_ff, spec, gated=cfg.gated_mlp,
                            phase=phase, device=device)

        def attn(acfg):
            return attn_init(gen, acfg, spec, phase=phase, device=device)

        embed = embedding.embed_init(gen, cfg.padded_vocab, cfg.d_model, spec.pdtype,
                                     device=device)
        encoder = stack_trees([{"ln1": ln(), "attn": attn(enc_cfg), "ln2": ln(), "mlp": mlp()}
                               for _ in range(cfg.n_encoder_layers)])
        decoder = stack_trees([{"ln1": ln(), "attn": attn(dec_cfg), "lnx": ln(),
                                "xattn": attn(x_cfg), "ln2": ln(), "mlp": mlp()}
                               for _ in range(cfg.n_layers)])
        return {"embed": embed, "enc_ln_in": ln(), "encoder": encoder, "decoder": decoder,
                "enc_ln_f": ln(), "ln_f": ln()}

    def _run(fn, *args):
        """fn(*args), under ``torch.utils.checkpoint`` when ``remat`` is set
        and gradients are recorded (the reference's remat'ed scan body)."""
        if cfg.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _enc_block(p, x):
        x = x + attn_apply(p["attn"], norm(p["ln1"], x), enc_cfg, spec, phase=phase)
        return _mlp(p, x)

    def _encode(params, frames) -> torch.Tensor:
        """frames (B, S_enc, d_model) -> the encoder's output, in the
        compute dtype."""
        x = norm(params["enc_ln_in"], torch.as_tensor(frames).to(cdtype))
        for p in unbind_layers(params["encoder"]):
            x = _run(_enc_block, p, x)
        return norm(params["enc_ln_f"], x)

    def _dec_block(p, x, enc_out):
        x = x + attn_apply(p["attn"], norm(p["ln1"], x), dec_cfg, spec, phase=phase)
        x = x + attn_apply(p["xattn"], norm(p["lnx"], x), x_cfg, spec, phase=phase,
                           kv_x=enc_out)
        return _mlp(p, x)

    def apply(params, batch: Dict[str, Any]) -> torch.Tensor:
        """Training or serve forward: batch {"frames" (B, S_enc, d_model),
        "tokens" (B, S)} -> logits (B, S, V') float32."""
        enc_out = _encode(params, batch["frames"])
        x = embedding.embed_apply(params["embed"], batch["tokens"], cdtype)
        for p in unbind_layers(params["decoder"]):
            x = _run(_dec_block, p, x, enc_out)
        x = norm(params["ln_f"], x)
        return embedding.unembed_apply(params["embed"], x)

    def apply_aux(params, batch):
        logits = apply(params, batch)
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    def init_cache(batch: int, max_len: int, *, encoder_len: Optional[int] = None,
                   quantized: bool = False, dtype=None, device=None):
        """{"self": the decoder's dense KV cache stacked (L, ...), int8 with
        ``quantized``; "cross_k", "cross_v": zeros (L, batch, encoder_len
        (default ``encoder_seq``), Hkv, hd) in ``dtype`` (the compute dtype
        by default), never quantized}. On CUDA unless ``device="cpu"``."""
        device = resolve_device(device)
        dtype = dtype or cdtype
        cross = (cfg.n_layers, batch, encoder_len or cfg.encoder_seq, cfg.n_kv_heads, cfg.hd)
        return {
            "self": init_kv_cache(batch, dec_cfg, max_len, dtype=dtype, quantized=quantized,
                                  layers=cfg.n_layers, device=device),
            "cross_k": torch.zeros(cross, dtype=dtype, device=device),
            "cross_v": torch.zeros(cross, dtype=dtype, device=device),
        }

    def _cross_decode(p, x, ck, cv):
        """Cross-attention of one decode token against a layer's cached
        encoder K/V (read only)."""
        b = x.shape[0]
        q = _split_heads(linear_apply(p["wq"], x, spec, phase=phase), cfg.hd)
        out = dot_attention(
            q, ck.to(x.dtype), cv.to(x.dtype),
            q_positions=torch.zeros((1,), dtype=torch.int32, device=x.device),
            kv_positions=torch.arange(ck.shape[1], dtype=torch.int32, device=x.device),
            causal=False,
        )
        return linear_apply(p["wo"], out.reshape(b, 1, -1), spec, phase=phase)

    def decode_step(params, tokens, cache, position):
        """One-token decode: tokens (B, 1), position scalar or (B,) ->
        (logits (B, 1, V), cache: the self KV written in place at
        ``position``, the cross K/V untouched)."""
        x = embedding.embed_apply(params["embed"], tokens, cdtype)
        for i, p in enumerate(unbind_layers(params["decoder"])):
            kv = {name: leaf[i] for name, leaf in cache["self"].items()}
            a, _ = attn_decode_step(p["attn"], norm(p["ln1"], x), kv, position, dec_cfg, spec,
                                    phase=phase)
            x = x + a
            x = x + _cross_decode(p["xattn"], norm(p["lnx"], x), cache["cross_k"][i],
                                  cache["cross_v"][i])
            x = _mlp(p, x)
        x = norm(params["ln_f"], x)
        return embedding.unembed_apply(params["embed"], x), cache

    def prefill(params, batch, *, max_len: Optional[int] = None, quantized: bool = False):
        """The encoder over batch["frames"], then the decoder over the
        prompt batch["tokens"]: (last-token logits (B, 1, V), the cache: the
        self KV over max_len positions, each layer's cross K/V projected
        once from the encoder's output and kept in the compute dtype)."""
        enc_out = _encode(params, batch["frames"])
        tokens = batch["tokens"]
        ml = max_len or tokens.shape[1]
        x = embedding.embed_apply(params["embed"], tokens, cdtype)
        selfs, cks, cvs = [], [], []
        for p in unbind_layers(params["decoder"]):
            a, sc = attn_prefill(p["attn"], norm(p["ln1"], x), dec_cfg, spec, max_len=ml,
                                 phase=phase, quantized=quantized, cache_dtype=cdtype)
            x = x + a
            a, ck, cv = cross_attention(p["xattn"], norm(p["lnx"], x), enc_out, x_cfg, spec,
                                        phase=phase)
            x = _mlp(p, x + a)
            selfs.append(sc)
            cks.append(ck.to(cdtype))
            cvs.append(cv.to(cdtype))
        x = norm(params["ln_f"], x[:, -1:])
        logits = embedding.unembed_apply(params["embed"], x)
        return logits, {"self": stack_trees(selfs), "cross_k": torch.stack(cks),
                        "cross_v": torch.stack(cvs)}

    return ModelAPI(init=init, init_cache=init_cache, apply=apply, apply_aux=apply_aux,
                    decode_step=decode_step, prefill=prefill, layer_views=layer_views)
