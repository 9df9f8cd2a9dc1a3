"""Grouped-query attention (port of ``repro/nn/attention.py``): the
full-sequence training forward ``attn_apply`` over ``dot_attention`` /
``blockwise_attention``, with cross-attention (``AttnConfig.cross``: K/V
projected from an encoder's output, no RoPE; ``cross_attention`` also
returns the projected K/V for the encdec family's cross cache); the
dense per-slot KV path of the continuous engine, the static engine and
speculative decoding: ``init_kv_cache``, ``attn_prefill``,
``attn_decode_step`` and ``attn_verify_step``, with the sliding-window
(SWA) ring cache; and the paged serve path: int8 KV quantization,
``paged_gather``, ``attn_decode_step_paged`` and ``attn_prefill_chunk``.
The score math is plain PyTorch (einsum and softmax), as the reference
leaves it to XLA.

Projections route through the switchable linear layer, so attention runs in
dense and bika mode alike; score math and softmax stay float32.

Unlike the functional reference, cache and pool writes here are IN PLACE:
the tensors passed in are updated and returned (the same objects).

Tensor parallelism (``distributed.tp``, under an active
``distributed.comm`` group): q/k/v hold the rank's heads where their
weights do (the head counts are read off the projections' widths, and the
cache holds the same heads), attention runs on them alone, and the output
is gathered to all heads before ``wo``, whose rank's d_model columns are
gathered in turn (``_out_proj``). ``tp_pad_heads`` pads a replicated
attention's heads so that its score math splits over the ranks (the
training forward ``attn_apply``, as in the reference).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.distributed import comm
from repro_torch.kernels import ops as kernel_ops
from .linear import LinearSpec, linear_apply, linear_axes, linear_init
from .rotary import apply_rope

__all__ = [
    "AttnConfig",
    "attn_apply",
    "attn_axes",
    "attn_decode_step",
    "attn_decode_step_paged",
    "attn_init",
    "attn_prefill",
    "attn_prefill_chunk",
    "attn_verify_step",
    "blockwise_attention",
    "cross_attention",
    "dot_attention",
    "init_kv_cache",
    "paged_gather",
    "ring_length",
]

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: Optional[int] = None
    qkv_bias: bool = False
    causal: bool = True
    block_q: int = 256  # blockwise attention query tile (training)
    cross: bool = False  # cross-attention (K/V from an encoder's output)
    # "fused": the block-table kernel (default); "gather": paged_gather +
    # dot_attention, the bit-parity oracle
    paged_route: str = "fused"
    # pad a replicated attention's heads to a multiple of the tensor-parallel
    # group so that its score math splits over the ranks (smollm's 15 heads)
    tp_pad_heads: bool = False


def attn_init(gen, cfg: AttnConfig, spec: LinearSpec, *, phase: str = "serve", device=None):
    qspec = dataclasses.replace(spec, bias=cfg.qkv_bias)
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": linear_init(gen, d, cfg.n_heads * hd, qspec, phase=phase, device=device),
        "wk": linear_init(gen, d, cfg.n_kv_heads * hd, qspec, phase=phase, device=device),
        "wv": linear_init(gen, d, cfg.n_kv_heads * hd, qspec, phase=phase, device=device),
        "wo": linear_init(gen, cfg.n_heads * hd, d, spec, phase=phase, device=device),
    }


def attn_axes(params, prefix=()):
    """Logical axes: wq ("embed", "heads"), wk/wv ("embed", "kv_heads"), wo
    ("heads", "embed"), as the reference boxes them."""
    names = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
             "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
    return {k: linear_axes(p, names[k], prefix) for k, p in params.items()}


def _split_heads(x: torch.Tensor, hd: int) -> torch.Tensor:
    """(..., H * hd) -> (..., H, hd): H is what the projection holds (all
    heads, or a tensor-parallel rank's)."""
    return x.reshape(x.shape[:-1] + (x.shape[-1] // hd, hd))


def _out_proj(params, out: torch.Tensor, cfg: AttnConfig, spec, phase) -> torch.Tensor:
    """wo over the attention output (B, S, H, hd): the heads gathered to all
    of them first, the rank's d_model columns after (no-ops without a
    tensor-parallel group)."""
    b, s = out.shape[:2]
    x = comm.gather_cols(out.reshape(b, s, -1), cfg.n_heads * cfg.head_dim)
    return comm.gather_cols(linear_apply(params["wo"], x, spec, phase=phase), cfg.d_model)


def _attend_padded_heads(q, k, v, cfg: AttnConfig, g) -> torch.Tensor:
    """Self-attention of a replicated attention split over the ranks by
    padded heads (the reference's ``_maybe_pad_heads``): GQA expanded to one
    kv head a query head, the heads zero-padded to a multiple of the group,
    the rank's block of them attended, the blocks gathered and the pad
    heads dropped. A pad head attends zero keys; nothing reads it."""
    hq, hkv = q.shape[2], k.shape[2]
    if hq // hkv > 1:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    pad = (-hq) % g.size
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
    per = (hq + pad) // g.size
    lo = g.rank * per
    out = blockwise_attention(q[:, :, lo:lo + per], k[:, :, lo:lo + per], v[:, :, lo:lo + per],
                              causal=cfg.causal, window=cfg.window, block_q=cfg.block_q)
    return comm.all_gather(out, dim=2)[:, :, :hq]


def dot_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    kv_valid_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Unblocked GQA attention. q: (B,Sq,Hq,D); k,v: (B,Skv,Hkv,D);
    positions (Sq,)/(Skv,) shared or (B,Sq)/(B,Skv) per row."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    scores = torch.einsum("bshgd,bthd->bhgst", qg.to(torch.float32), k.to(torch.float32))
    scores = scores / torch.full((), float(d), dtype=torch.float32, device=q.device).sqrt()
    qp = q_positions if q_positions.dim() == 2 else q_positions[None]
    kp = kv_positions if kv_positions.dim() == 2 else kv_positions[None]
    mask = kp[:, None, :] >= 0
    if causal:
        mask = mask & (kp[:, None, :] <= qp[:, :, None])
    if window is not None:
        mask = mask & (kp[:, None, :] > qp[:, :, None] - window)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)
    scores = torch.where(mask[:, None, None], scores, neg)
    if kv_valid_len is not None:
        valid = kp < kv_valid_len[:, None]
        scores = torch.where(valid[:, None, None, None, :], scores, neg)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", p, v.to(p.dtype))
    return out.reshape(b, sq, hq, d).to(q.dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        block_q: int = 256) -> torch.Tensor:
    """Self-attention over aligned positions 0..S-1 with bounded memory:
    query tiles of ``block_q`` rows, each recomputed in the backward
    (``torch.utils.checkpoint``) instead of keeping its score tile. Each
    query row's softmax is its own, so a ragged last tile (S not a multiple
    of ``block_q``, a long prompt the reference asserts against) gives the
    rows of one whole ``dot_attention``."""
    b, s, hq, d = q.shape
    pos = torch.arange(s, dtype=torch.int32, device=q.device)
    if s <= block_q:
        return dot_attention(q, k, v, q_positions=pos, kv_positions=pos, causal=causal,
                             window=window)

    def tile(qblk, qpos):
        return dot_attention(qblk, k, v, q_positions=qpos, kv_positions=pos, causal=causal,
                             window=window)

    outs = [torch.utils.checkpoint.checkpoint(tile, q[:, i:i + block_q], pos[i:i + block_q],
                                              use_reentrant=False)
            for i in range(0, s, block_q)]
    return torch.cat(outs, dim=1)


def attn_apply(params, x: torch.Tensor, cfg: AttnConfig, spec: LinearSpec, *,
               phase: str = "train", kv_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence (train / prefill) attention. x: (B, S, D). Self
    attention applies RoPE and attends through ``blockwise_attention``
    (causal per ``cfg.causal``); a ``cfg.cross`` layer takes its K/V from
    ``kv_x`` (``cross_attention``)."""
    if cfg.cross:
        return cross_attention(params, x, kv_x, cfg, spec, phase=phase)[0]
    s = x.shape[1]
    q, k, v = _project_qkv(params, x, cfg, spec, phase, kv_x)
    q = apply_rope(q, torch.arange(s, dtype=torch.int32, device=x.device), cfg.rope_theta)
    k = apply_rope(k, torch.arange(k.shape[1], dtype=torch.int32, device=x.device),
                   cfg.rope_theta)
    g = comm.active()
    if (cfg.tp_pad_heads and g is not None and g.size > 1 and q.shape[2] == cfg.n_heads
            and (cfg.n_heads % g.size or cfg.n_kv_heads % g.size)):
        out = _attend_padded_heads(q, k, v, cfg, g)
    else:
        out = blockwise_attention(q, k, v, causal=cfg.causal, window=cfg.window,
                                  block_q=cfg.block_q)
    return _out_proj(params, out, cfg, spec, phase)


def cross_attention(params, x: torch.Tensor, kv_x: torch.Tensor, cfg: AttnConfig,
                    spec: LinearSpec, *, phase: str = "train"):
    """Cross-attention of x (B, S, D) over kv_x (B, S_kv, D): q from x, k
    and v from kv_x (projected in that order, as the reference does), no
    RoPE, every key visible (``dot_attention``, non-causal, positions
    arange). Returns (y (B, S, D), k, v (B, S_kv, Hkv, hd)): the projected
    K/V are what the encdec family's prefill keeps as its cross cache."""
    s = x.shape[1]
    q, k, v = _project_qkv(params, x, cfg, spec, phase, kv_x)
    out = dot_attention(
        q, k, v,
        q_positions=torch.arange(s, dtype=torch.int32, device=x.device),
        kv_positions=torch.arange(k.shape[1], dtype=torch.int32, device=x.device),
        causal=False,
    )
    return _out_proj(params, out, cfg, spec, phase), k, v


def _quantize_kv(x: torch.Tensor):
    scale = x.abs().amax(dim=-1, keepdim=True).to(torch.float32) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _kv_leaves(k: torch.Tensor, v: torch.Tensor, quantized: bool, dtype):
    """New K/V in the cache's storage form: int8 payloads plus per-vector
    scales, or ``dtype``."""
    if quantized:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k.to(dtype), "v": v.to(dtype)}


def _cache_kv(cache, dtype):
    """The whole cache's K/V in ``dtype`` (dequantized from an int8 cache)."""
    if "k_scale" in cache:
        return (_dequantize_kv(cache["k"], cache["k_scale"], dtype),
                _dequantize_kv(cache["v"], cache["v_scale"], dtype))
    return cache["k"].to(dtype), cache["v"].to(dtype)


def ring_length(cfg: AttnConfig, max_len: int) -> int:
    """Positions a cache row holds: max_len, or with a sliding window the
    ring's L = min(window, max_len)."""
    return min(max_len, cfg.window) if cfg.window is not None else max_len


def init_kv_cache(batch: int, cfg: AttnConfig, max_len: int, dtype=torch.float32,
                  quantized: bool = False, *, layers: Optional[int] = None, device=None):
    """Dense per-slot cache of one layer: leaves (batch, L, Hkv, hd) with L
    = ``ring_length`` (max_len, or the SWA ring); with ``quantized`` int8
    keys/values plus (batch, L, Hkv, 1) float32 scales. ``layers`` stacks
    that many layers on a leading axis."""
    lead = () if layers is None else (layers,)
    shape = lead + (batch, ring_length(cfg, max_len), cfg.n_kv_heads, cfg.head_dim)
    if quantized:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_prefill(params, x: torch.Tensor, cfg: AttnConfig, spec: LinearSpec, *,
                 max_len: int, phase: str = "serve", quantized: bool = False,
                 cache_dtype=torch.float32):
    """Whole-prompt attention that also emits the dense cache: (y, cache)
    with the post-RoPE K/V at positions [0, S) of a max_len-long cache
    (zeros after). With a sliding window the cache is the ring of L =
    min(window, max_len) slots, position p at slot p % L: a prompt longer
    than L is folded in, its last L positions kept (the reference asserts S
    % L == 0, where the fold is the identity; the port rolls the slots for
    any S, and equals it there)."""
    s = x.shape[1]
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    q, k, v = _project_qkv(params, x, cfg, spec, phase)
    pos = torch.arange(s, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)  # the cache stores post-RoPE keys
    out = blockwise_attention(q, k, v, causal=cfg.causal, window=cfg.window,
                              block_q=cfg.block_q)
    y = _out_proj(params, out, cfg, spec, phase)
    length = ring_length(cfg, max_len)
    if s > length:  # a window's ring: slot j holds position s - L + ((j - s) mod L)
        kc = torch.roll(k[:, -length:], s % length, dims=1)
        vc = torch.roll(v[:, -length:], s % length, dims=1)
    else:
        pad = (0, 0, 0, 0, 0, length - s)
        kc, vc = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    return y, _kv_leaves(kc, vc, quantized, cache_dtype)


def _write_dense(cache, lp: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write a (B, C) window of new K/V (B, C, Hkv, hd) at per-row
    consecutive positions ``lp`` of one dense cache layer, in place.
    Positions >= max_len are dropped, as the reference's scatter drops them,
    without a host sync: each targets the row's last slot carrying the
    value that slot ends with (the window's own write there, or its old
    value), so the scatter's repeated indices all carry one value."""
    b, c = lp.shape
    cache_len = cache["k"].shape[1]
    at = torch.clamp(lp, max=cache_len - 1)
    src = at - lp[:, :1]  # the window slot whose value lands at ``at``; < 0: none
    own = (src >= 0)[:, :, None, None]
    src = src.clamp(min=0).long()
    at = at.long()
    rows = torch.arange(b, device=lp.device)[:, None].expand(b, c)
    for name, val in _kv_leaves(k, v, "k_scale" in cache, cache["k"].dtype).items():
        buf = cache[name]
        buf[rows, at] = torch.where(own, val[rows, src], buf[rows, at])


def attn_decode_step(params, x: torch.Tensor, cache, position: torch.Tensor,
                     cfg: AttnConfig, spec: LinearSpec, *, phase: str = "serve"):
    """One-token decode against one layer of the dense cache. x (B, 1, D);
    position a scalar (the whole batch) or (B,) per-row next-write positions
    (the continuous engine's slots). Writes K/V at ``position`` in place
    and attends positions <= it. A position >= max_len (a speculative
    draft step past the end of a row's budget) writes nothing, as the
    reference's scatter drops it (``_write_dense``). With a sliding window
    the cache is the ring of L slots: the write goes to slot ``position %
    L``, and slot j is read as position ``p - ((p - j) mod L)``, the latest
    position <= p that lands there (negative, hence masked, while
    unwritten), under the window mask."""
    b = x.shape[0]
    q, k, v = _project_qkv(params, x, cfg, spec, phase)
    position = torch.as_tensor(position, dtype=torch.int32, device=x.device)
    position = position.expand(b) if position.dim() == 0 else position
    pos = position[:, None]  # (B, 1) per-row RoPE / mask positions
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    cache_len = cache["k"].shape[1]
    slots = torch.arange(cache_len, dtype=torch.int32, device=x.device)
    if cfg.window is not None:
        rows = torch.arange(b, device=x.device)
        at = (position % cache_len).long()
        for name, val in _kv_leaves(k, v, "k_scale" in cache, cache["k"].dtype).items():
            cache[name][rows, at] = val[:, 0]
        kv_positions = pos - torch.remainder(pos - slots[None], cache_len)  # (B, L)
        valid_len = None
    else:
        _write_dense(cache, pos, k, v)
        kv_positions, valid_len = slots, position + 1
    k_all, v_all = _cache_kv(cache, x.dtype)
    out = dot_attention(
        q, k_all, v_all, q_positions=pos, kv_positions=kv_positions, causal=True,
        window=cfg.window, kv_valid_len=valid_len,
    )
    y = _out_proj(params, out, cfg, spec, phase)
    return y, cache


def attn_verify_step(params, x: torch.Tensor, cache, position: torch.Tensor,
                     cfg: AttnConfig, spec: LinearSpec, *, phase: str = "serve"):
    """Multi-token verify over the dense cache (speculative decoding).
    x (B, C, D): each row's window at logical positions ``position[i] +
    [0, C)``. The window's K/V are written there in place (positions >=
    max_len, a window overhanging the end of a row's budget, are dropped
    as the reference's scatter drops them: ``_write_dense``), then the
    window's queries attend the whole row under the causal
    ``kv_pos <= q_pos`` mask. Every round writes C consecutive positions and
    advances by 1..C, so stale keys of a rejected window sit inside the
    next round's write range or causally in the future of every query: the
    (B, C) outputs are those of C sequential ``attn_decode_step`` calls."""
    if cfg.window is not None:
        raise ValueError("speculative verify does not support sliding windows")
    c = x.shape[1]
    q, k, v = _project_qkv(params, x, cfg, spec, phase)
    position = torch.as_tensor(position, dtype=torch.int32, device=x.device)
    lp = position[:, None] + torch.arange(c, dtype=torch.int32, device=x.device)  # (B, C)
    q = apply_rope(q, lp, cfg.rope_theta)
    k = apply_rope(k, lp, cfg.rope_theta)
    _write_dense(cache, lp, k, v)
    cache_len = cache["k"].shape[1]
    k_all, v_all = _cache_kv(cache, x.dtype)
    out = dot_attention(
        q, k_all, v_all, q_positions=lp,
        kv_positions=torch.arange(cache_len, dtype=torch.int32, device=x.device),
        causal=True,
    )
    y = _out_proj(params, out, cfg, spec, phase)
    return y, cache


def paged_gather(leaf: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(n_phys, bs, H, D|1) pool layer + (B, T) table -> (B, T*bs, H, D|1)
    per-row logical views (row i position p = leaf[table[i, p//bs], p%bs])."""
    g = leaf[table.long()]
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])


def _project_qkv(params, x, cfg: AttnConfig, spec, phase, kv_x=None):
    """q from x; k and v from ``kv_x`` where given (cross-attention), else
    from x."""
    hd = cfg.head_dim
    src = x if kv_x is None else kv_x
    q = _split_heads(linear_apply(params["wq"], x, spec, phase=phase), hd)
    k = _split_heads(linear_apply(params["wk"], src, spec, phase=phase), hd)
    v = _split_heads(linear_apply(params["wv"], src, spec, phase=phase), hd)
    return q, k, v


def _write_pool(cache, blk: torch.Tensor, off: torch.Tensor, k, v) -> None:
    """Scatter new K/V at physical (blk, off) pairs, in place on the pool
    layer views. int8 pools store quantized payloads plus scales."""
    if "k_scale" in cache:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        upd = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        upd = {"k": k, "v": v}
    for name, val in upd.items():
        buf = cache[name]
        buf[blk, off] = val.to(buf.dtype)


def _attend(q, cache, table, q_pos, cfg: AttnConfig, dtype, kv_valid_len=None):
    """Attention of the (B, C) queries at ``q_pos`` over the pool, by route."""
    if cfg.paged_route == "fused":
        return kernel_ops.paged_attention(
            q, cache["k"], cache["v"], table, q_pos,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
            heads=(cfg.n_heads, cfg.n_kv_heads),
        )
    if "k_scale" in cache:
        k_all = _dequantize_kv(paged_gather(cache["k"], table),
                               paged_gather(cache["k_scale"], table), dtype)
        v_all = _dequantize_kv(paged_gather(cache["v"], table),
                               paged_gather(cache["v_scale"], table), dtype)
    else:
        k_all = paged_gather(cache["k"], table).to(dtype)
        v_all = paged_gather(cache["v"], table).to(dtype)
    max_len = table.shape[1] * cache["k"].shape[1]
    return dot_attention(
        q, k_all, v_all, q_positions=q_pos,
        kv_positions=torch.arange(max_len, dtype=torch.int32, device=q.device),
        causal=True, kv_valid_len=kv_valid_len,
    )


def attn_decode_step_paged(params, x: torch.Tensor, cache, position: torch.Tensor,
                           table: torch.Tensor, cfg: AttnConfig, spec: LinearSpec, *,
                           phase: str = "serve"):
    """One-token decode against one layer of the paged pool. x (B, 1, D);
    position (B,) next-write positions; table (B, T). Inactive rows point
    their whole table at the parking block. Writes the pool in place."""
    if cfg.window is not None:
        raise ValueError("paged decode does not support sliding-window caches")
    q, k, v = _project_qkv(params, x, cfg, spec, phase)
    position = position.to(torch.int32)
    pos = position[:, None]  # (B, 1) per-row RoPE / mask positions
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    bs = cache["k"].shape[1]
    blk = torch.gather(table.long(), 1, (position // bs).long()[:, None])[:, 0]
    off = (position % bs).long()
    _write_pool(cache, blk, off, k[:, 0], v[:, 0])
    out = _attend(q, cache, table, pos, cfg, x.dtype, kv_valid_len=position + 1)
    y = _out_proj(params, out, cfg, spec, phase)
    return y, cache


def attn_prefill_chunk(params, x: torch.Tensor, cache, table: torch.Tensor,
                       start: torch.Tensor, cfg: AttnConfig, spec: LinearSpec, *,
                       phase: str = "serve"):
    """One fixed-size prompt chunk appended to one layer of the paged pool.
    x (B, C, D) at logical positions ``start + [0, C)``. Positions past
    max_len (final-chunk overhang) are dropped, never clamped onto a live
    block; pad positions inside max_len write junk that stays causally in
    the future of every real query. Writes the pool in place."""
    if cfg.window is not None:
        raise ValueError("paged prefill does not support sliding-window caches")
    c = x.shape[1]
    q, k, v = _project_qkv(params, x, cfg, spec, phase)
    start = start.to(torch.int32)
    lp = start[:, None] + torch.arange(c, dtype=torch.int32, device=x.device)  # (B, C)
    q = apply_rope(q, lp, cfg.rope_theta)
    k = apply_rope(k, lp, cfg.rope_theta)
    bs = cache["k"].shape[1]
    t = table.shape[1]
    max_len = t * bs
    idx = torch.clamp(lp // bs, 0, t - 1).long()
    blk = torch.gather(table.long(), 1, idx)  # (B, C)
    keep = lp < max_len  # the out-of-range drop of the reference's scatter
    _write_pool(cache, blk[keep], (lp % bs).long()[keep], k[keep], v[keep])
    out = _attend(q, cache, table, lp, cfg, x.dtype)
    y = _out_proj(params, out, cfg, spec, phase)
    return y, cache
