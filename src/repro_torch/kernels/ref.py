"""Plain PyTorch versions of the ported kernels (port of
``repro/kernels/ref.py``). The CPU tests run them, and ``chip_smoke.py``
holds each CUDA kernel against them on the card."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["bnn_matmul_ref", "cac_matmul_ref", "cac_train_bwd_ref", "cac_train_fwd_ref",
           "paged_attention_ref", "qnn_matmul_ref"]


def cac_matmul_ref(x: torch.Tensor, tau: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Hardware CAC: y[m,n] = sum_k s[k,n] * (+1 if x[m,k] >= tau[k,n] else -1).

    x: (M, K); tau, s: (K, N) -> (M, N) float32, summed exactly in int32.
    s may contain 0 (padding)."""
    cmp = x[:, :, None] >= tau[None]  # (M, K, N)
    si = s.to(torch.int32)[None]
    return torch.where(cmp, si, -si).sum(dim=1, dtype=torch.int32).to(torch.float32)


def _pre(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """x[m,k] * w[k,n] + beta[k,n] as an (M, K, N) tensor: a rounded product,
    then a rounded sum (two eager ops, never one fused multiply-add)."""
    return x[:, :, None] * w[None] + beta[None]


def cac_train_fwd_ref(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Training CAC: y[m,n] = sum_k Sign(x[m,k]*w[k,n] + beta[k,n]); Sign(0)=+1.
    The +-1 terms are summed in int32 (exact), then cast to float32."""
    neg = (~(_pre(x, w, beta) >= 0)).sum(dim=1, dtype=torch.int32)  # NaN -> -1
    return (x.shape[1] - 2 * neg).to(torch.float32)


def cac_train_bwd_ref(
    x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """STE backward (hard-tanh window on the pre-activation):
    mask = 1[|x w + beta| <= 1];
    dx[m,k]    = sum_n g[m,n] mask[m,k,n] w[k,n]
    dw[k,n]    = sum_m g[m,n] mask[m,k,n] x[m,k]
    dbeta[k,n] = sum_m g[m,n] mask[m,k,n]
    """
    mask = (_pre(x, w, beta).abs() <= 1.0).to(g.dtype)
    gm = g[:, None, :] * mask  # (M, K, N)
    dx = (gm * w[None]).sum(dim=2)
    dw = (gm * x[:, :, None]).sum(dim=0)
    dbeta = gm.sum(dim=0)
    return dx, dw, dbeta


def bnn_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """XNOR-popcount == matmul of +/-1 values: y = sign(x) @ sign(w) in
    float32, Sign(0) = +1. Exact: every partial sum is an integer < 2^24."""
    xs = torch.where(x >= 0, 1.0, -1.0).to(torch.float32)
    ws = torch.where(w >= 0, 1.0, -1.0).to(torch.float32)
    return xs @ ws


def qnn_matmul_ref(x_int: torch.Tensor, w_int: torch.Tensor, x_scale: float,
                   w_scale: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> exact integer accumulate -> float32 dequant:
    ``float32(x_int @ w_int) * (w_scale * float32(x_scale))``, the scale
    product formed in float32 first. x_int (M, K), w_int (K, N) int8;
    w_scale (N,) or (1, N) float32 -> (M, N) float32.

    The product is taken in float64, on the CPU and on the card alike (CUDA
    has no integer matmul): every partial sum is an integer of magnitude
    <= K * 128 * 127 < 2^53, so it is exact in any order, and the one
    rounding to float32 is the same round-to-nearest as the int32 -> float32
    convert of the reference's int32 accumulator."""
    acc = (x_int.to(torch.float64) @ w_int.to(torch.float64)).to(torch.float32)
    xs = torch.full((), x_scale, dtype=torch.float32, device=acc.device)
    return acc * (w_scale.to(torch.float32).reshape(1, -1) * xs)


def paged_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tables: torch.Tensor,
    q_pos: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather oracle for the fused paged-attention kernel: assemble each
    row's logical KV window from the block pool, then one full fp32 softmax
    under the ``kv_pos <= q_pos`` mask.

    q: (B, C, Hq, D); k/v: (n_phys, bs, Hkv, D); tables: (B, T) int32;
    q_pos: (B, C) int32; scales: (n_phys, bs, Hkv, 1) f32 for int8 pools."""
    b, c, hq, d = q.shape
    bs, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    tl = tables.long()

    def gather(leaf):  # (B, T, bs, H, D|1) -> (B, T*bs, H, D|1)
        w = leaf[tl]
        return w.reshape(b, w.shape[1] * bs, *w.shape[3:])

    kw, vw = gather(k), gather(v)
    if k_scale is not None:
        kw = kw.to(torch.float32) * gather(k_scale)
        vw = vw.to(torch.float32) * gather(v_scale)
    qg = q.to(torch.float32).reshape(b, c, hkv, g, d)
    s = torch.einsum("bchgd,bthd->bchgt", qg, kw.to(torch.float32))
    s = s / torch.sqrt(torch.tensor(float(d), dtype=torch.float32, device=q.device))
    kvp = torch.arange(kw.shape[1], dtype=torch.int32, device=q.device)
    mask = kvp[None, None] <= q_pos[:, :, None]  # (B, C, T*bs)
    s = torch.where(mask[:, :, None, None], s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bchgt,bthd->bchgd", p, vw.to(torch.float32))
    return out.reshape(b, c, hq, d).to(q.dtype)
