"""Architecture config, the KV layout contracts and the training layer loop
(port of ``repro/models/base.py``: ``ArchConfig``, ``KVCacheLayout``,
``kv_cache_layout``, ``PagedKVLayout``, ``paged_kv_layout``,
``scan_blocks_aux``, ``make_norm``), plus ``unbind_layers`` and
``views_of`` (a family's per-layer views of its stacked leaves). Layers
run as a Python loop; ``scan_blocks_aux`` is the training forward's, with
``torch.utils.checkpoint`` around each layer when ``remat`` is set."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core.backend import LinearSpec

__all__ = ["ArchConfig", "KVCacheLayout", "ModelAPI", "PagedKVLayout",
           "kv_cache_layout", "make_generator", "make_norm", "paged_kv_layout",
           "scan_blocks_aux", "unbind_layers", "views_of"]


class KVCacheLayout(NamedTuple):
    """Every leaf of the dense slot cache is ``(n_layers, n_slots, max_len,
    n_kv_heads, head_dim)`` (scale leaves end in 1): the batch axis is the
    slot axis the continuous scheduler hands to requests."""

    n_layers: int
    n_slots: int
    max_len: int
    n_kv_heads: int
    head_dim: int


class PagedKVLayout(NamedTuple):
    """Every leaf of the paged pool is ``(n_layers, n_phys_blocks,
    block_size, n_kv_heads, head_dim)`` (scale leaves end in 1). Block
    ``n_phys_blocks - 1`` is the parking block inactive decode rows write
    into."""

    n_layers: int
    n_phys_blocks: int
    block_size: int
    n_kv_heads: int
    head_dim: int


def kv_cache_layout(cache) -> KVCacheLayout:
    """Read the (layers, slots, max_len, heads, hd) layout off a cache dict,
    validating the rank-5 contract."""
    if not cache:
        raise ValueError("empty cache")
    lead = None
    for leaf in cache.values():
        if leaf.dim() != 5:
            raise ValueError(
                f"KV cache leaves must be rank-5 (layers, slots, max_len, heads, hd); "
                f"got shape {tuple(leaf.shape)}"
            )
        if lead is None:
            lead = tuple(leaf.shape[:4])
        elif tuple(leaf.shape[:4]) != lead:
            raise ValueError(f"inconsistent cache leaves: {tuple(leaf.shape[:4])} vs {lead}")
    return KVCacheLayout(*cache["k"].shape)


def paged_kv_layout(cache) -> PagedKVLayout:
    """The paged layout: structurally a dense cache with (slots, max_len) =
    (n_phys_blocks, block_size)."""
    return PagedKVLayout(*kv_cache_layout(cache))


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """The reference's ArchConfig, cut to the fields the lm, hybrid, xlstm
    and encdec families read (same names and defaults)."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    activation: str = "silu"
    gated_mlp: bool = True
    norm: str = "rmsnorm"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None  # sliding-window attention (SWA)
    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    # SSM / hybrid / xlstm
    ssm_state: int = 64
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    attn_every: int = 0  # zamba2: shared attention block every k ssm blocks
    slstm_every: int = 0  # xlstm: sLSTM block every k blocks (0 = all mLSTM)
    # enc-dec
    n_encoder_layers: int = 0
    encoder_seq: int = 1024  # stub frontend sequence length
    # frontend: tokens | frames (encdec: precomputed frame embeddings)
    frontend: str = "tokens"
    compute_mode: str = "dense"  # dense | bika | bnn | qnn8
    bika_m: int = 1
    bika_impl: str = "cvjp"
    pack_signs: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    block_q: int = 256  # blockwise attention query tile (training)
    remat: bool = True
    # paged serving attention: "fused" block-table kernel | "gather" oracle
    paged_attn_route: str = "fused"
    tp_pad_heads: bool = False  # pad attention heads to the tensor-parallel group
    full_attention: bool = True  # False: sub-quadratic (SWA), runs long_500k

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // 256) * 256

    def linear_spec(self, **over) -> LinearSpec:
        return LinearSpec(
            mode=self.compute_mode,
            m=self.bika_m,
            impl=self.bika_impl,
            pack_signs=self.pack_signs,
            param_dtype=self.param_dtype,
            compute_dtype=self.compute_dtype,
            **over,
        )

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def make_generator(seed, device) -> torch.Generator:
    """``seed`` itself where it is a generator, else a generator on
    ``device`` seeded with it (every family's ``init``)."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def make_norm(cfg: ArchConfig):
    """(init, apply) of the config's norm: RMSNorm or LayerNorm."""
    from repro_torch.nn import norms

    if cfg.norm == "rmsnorm":
        return norms.rmsnorm_init, norms.rmsnorm_apply
    return norms.layernorm_init, norms.layernorm_apply


def scan_blocks_aux(layers: Sequence[Any], x: torch.Tensor, body: Callable, *,
                    remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> body(params_i, x) for each layer's params, where ``body`` returns
    (x, aux scalar); returns (x, the aux summed in float32). With ``remat``
    each layer runs under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward instead of kept, as the
    reference's ``jax.checkpoint`` body does."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in layers:
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(body, p, x, use_reentrant=False)
        else:
            x, a = body(p, x)
        aux = aux + a.to(torch.float32)
    return x, aux


def unbind_layers(layers) -> List[Any]:
    """Per-layer views of a stacked ``(L, ...)`` dict tree through one
    ``torch.unbind`` per leaf, whose backward stacks the layers' gradients
    in one op (indexing each layer would add a full-size zero-filled
    gradient per layer and leaf); a list passes through."""
    if isinstance(layers, list):
        return layers

    def split(node):
        if isinstance(node, dict):
            parts = {k: split(v) for k, v in node.items()}
            n = len(next(iter(parts.values())))
            return [{k: parts[k][i] for k in parts} for i in range(n)]
        return list(torch.unbind(node))

    return split(layers)


class ModelAPI(NamedTuple):
    """What the trainer and the serving runtime consume (the reference's,
    plus ``layer_views``). The paged and speculative entries are the lm
    family's; a recurrent or encoder-decoder family has none of them. The
    encdec family's ``init_cache`` also takes ``encoder_len``, and its
    ``apply``, ``prefill`` batches carry ``"frames"`` (B, S_enc, d_model)
    beside ``"tokens"``."""

    init: Callable[..., Any]  # (seed, device) -> params
    # (batch, max_len, quantized, device): the dense slot cache (a
    # recurrent family's: its states), or with (n_phys_blocks, block_size)
    # the paged pool
    init_cache: Callable[..., Any]
    apply: Optional[Callable[..., Any]] = None  # (params, batch) -> logits
    apply_aux: Optional[Callable[..., Any]] = None  # (params, batch) -> (logits, aux)
    # (params, tok (B,1), cache, positions (B,) or scalar) -> (logits, cache)
    decode_step: Optional[Callable[..., Any]] = None
    # (params, {"tokens": (B,S)}, max_len, quantized, ...) -> (logits (B,1,V), cache)
    prefill: Optional[Callable[..., Any]] = None
    # (params, tok (S,1), pool, positions (S,), tables (S,T)) -> (logits, pool)
    decode_paged: Optional[Callable[..., Any]] = None
    # (params, chunk (1,C), pool, table (1,T), start (1,), last_in_chunk (1,))
    # -> (last-token logits (1,1,V), pool)
    prefill_chunk: Optional[Callable[..., Any]] = None
    # (params, window (B,C), cache, positions (B,)) -> (logits (B,C,V), cache)
    decode_verify: Optional[Callable[..., Any]] = None
    # (params, window (B,C), pool, positions (B,), tables (B,T)) -> (logits (B,C,V), pool)
    decode_verify_paged: Optional[Callable[..., Any]] = None
    # params -> the same tree with each stacked (L, ...) subtree as a list of
    # per-layer views (no copies), made once by an engine so that the layer
    # loop indexes nothing per call; None: the tree is used as it is
    layer_views: Optional[Callable[[Any], Any]] = None
    # params (either phase, stacked or per-layer views) -> the same tree with
    # each leaf's logical axes, the reference's axes_of(eval_shape(init))
    param_axes: Optional[Callable[[Any], Any]] = None


def views_of(api: ModelAPI, params):
    """``params`` in the form the model's serve loop wants
    (``api.layer_views``), or as they are where the family has no views."""
    return api.layer_views(params) if api.layer_views is not None else params
