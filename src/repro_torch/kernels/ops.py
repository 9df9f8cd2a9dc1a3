"""Public kernel wrappers (port of ``repro/kernels/ops.py``): the serve
routes, the training CAC ``cac_train_matmul``, the BNN sign products
(``bnn_matmul``, ``bnn_matmul_packed`` and the training ``bnn_train_matmul``)
and the QNN int8 product ``qnn_matmul``.

Each wrapper takes its plain PyTorch version only because the tensors it
was given lie on the CPU; on CUDA tensors it launches the hand-written
kernel or raises — there is no fallback. Launches are counted on the
kernel calls (``cac_matmul_kernel_call.launches``,
``paged_attn_kernel_call.launches``, ``cac_train_fwd_call.launches``,
``bnn_matmul_kernel_call.launches``, ``qnn_matmul_kernel_call.launches``, ...);
``launch_counts``/``reset_launches`` read and zero them.

Tensor parallelism (the reference's ``_tp_mesh`` / ``_tp_shard_call``
routes, in explicit SPMD: ``distributed.tp``): a rank holds its N/tp
columns of every column-parallel weight, so ``cac_matmul``,
``bnn_matmul``, ``bnn_matmul_packed`` and ``qnn_matmul`` run the unchanged
kernel on those columns and return them, the activations whole on every
rank; no reduction is split, so the columns equal the single-process
call's bit for bit. A weight whose N does not divide tp is whole on every
rank, and the same kernel runs on all of N (the reference falls back to
its XLA oracle there). ``paged_attention`` runs a rank's Hq/tp query and
Hkv/tp kv heads; given the unsharded head counts (``heads``) it launches
kernel 11 at the unsharded call's plan, so that each head's splits merge
in the order of one process's call.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import autotune, ref
from . import bnn_matmul as _bnn
from . import cac_matmul as _cac
from .cac_matmul import cac_matmul_kernel_call, cac_matmul_plain
from .paged_attn import paged_attn_kernel_call
from .qnn_matmul import qnn_matmul_kernel_call, qnn_matmul_plain

__all__ = [
    "KERNEL_ROUTES",
    "FUSED_BWD_DEFAULT",
    "bnn_matmul",
    "bnn_matmul_packed",
    "bnn_train_matmul",
    "cac_matmul",
    "cac_train_matmul",
    "kernel_route",
    "launch_counts",
    "paged_attention",
    "qnn_matmul",
    "reset_launches",
]


def cac_matmul(x_int: torch.Tensor, tau: torch.Tensor, s_packed: torch.Tensor) -> torch.Tensor:
    """Hardware-form CAC. x_int (..., K') int8; tau (K', N) int8; s_packed
    (K'/8, N) uint8 sign planes -> (..., N) float32 exact integer sums."""
    lead = x_int.shape[:-1]
    x2 = x_int.reshape(-1, x_int.shape[-1])
    if x2.is_cuda:
        y = cac_matmul_kernel_call(x2, tau, s_packed)
    else:
        y = cac_matmul_plain(x2, tau, s_packed)
    return y.reshape(lead + (tau.shape[1],))


def paged_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tables: torch.Tensor,
    q_pos: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    heads: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Fused block-table attention: q (B, C, Hq, D); k/v one pool layer
    (n_phys, bs, Hkv, D); tables (B, T) int32; q_pos (B, C) int32. With
    scales the int8 pool is dequantized inside the walk. ``heads`` = (Hq,
    Hkv) of the unsharded call, where q and the pool hold a
    tensor-parallel rank's block of them: the kernel takes that call's
    (q_tile, splits), which ``attn_plan`` sizes from B x Hkv."""
    if not q.is_cuda:
        return ref.paged_attention_ref(q, k, v, tables, q_pos, k_scale, v_scale)
    plan = None
    b, c, hq, d = q.shape
    if heads is not None and tuple(heads) != (hq, k.shape[2]):
        plan = autotune.get_paged_plan(b, c, heads[0], heads[1], d, k.shape[1],
                                       tables.shape[1], q.device.index, None)
    return paged_attn_kernel_call(q, k, v, tables, q_pos, k_scale=k_scale, v_scale=v_scale,
                                  plan=plan)


# The one-pass fused STE backward (kernel 5) is the default; False takes the
# split pair (kernels 3 + 4), as the reference's flag of the same name does.
FUSED_BWD_DEFAULT = True


class _CacTrain(torch.autograd.Function):
    """y = sum_k Sign(x w + beta) with the STE backward. Saves only (x, w,
    beta): the backward kernel recomputes the hard-tanh mask, so no (M, K, N)
    tensor outlives the forward. On CUDA tensors both directions launch the
    hand-written kernels; on CPU tensors they take the plain versions."""

    @staticmethod
    def forward(ctx, x2, w, beta, fused: bool):
        ctx.save_for_backward(x2, w, beta)
        ctx.fused = fused
        if x2.is_cuda:
            return _cac.cac_train_fwd_call(x2, w, beta)
        return _cac.cac_train_fwd_plain(x2, w, beta)

    @staticmethod
    def backward(ctx, g):
        x2, w, beta = ctx.saved_tensors
        g = g.contiguous()
        if x2.is_cuda:
            if ctx.fused:
                dx, dw, db = _cac.cac_train_bwd_fused_call(x2, w, beta, g)
            else:
                dx = _cac.cac_train_bwd_dx_call(x2, w, beta, g)
                dw, db = _cac.cac_train_bwd_dw_call(x2, w, beta, g)
        elif ctx.fused:
            dx, dw, db = _cac.cac_train_bwd_fused_plain(x2, w, beta, g)
        else:
            dx = _cac.cac_train_bwd_dx_plain(x2, w, beta, g)
            dw, db = _cac.cac_train_bwd_dw_plain(x2, w, beta, g)
        return dx, dw, db, None


def cac_train_matmul(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor, *,
                     fused_bwd: Optional[bool] = None) -> torch.Tensor:
    """Training CAC with the STE backward. x (..., K); w, beta (K, N) ->
    (..., N) float32. ``fused_bwd=None`` reads ``FUSED_BWD_DEFAULT``."""
    fused = FUSED_BWD_DEFAULT if fused_bwd is None else fused_bwd
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    y = _CacTrain.apply(x2, w.to(torch.float32), beta.to(torch.float32), bool(fused))
    return y.reshape(lead + (w.shape[1],))


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).to(torch.float32)


def bnn_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sign(x) @ sign(w). x (..., K) float; w (K, N) float32 or int8 +-1
    (read as stored) -> (..., N) float32 exact integer sums."""
    x2 = _rows(x)
    if x2.is_cuda:
        y = _bnn.bnn_matmul_kernel_call(x2, w)
    else:
        y = _bnn.bnn_matmul_plain(x2, w)
    return y.reshape(x.shape[:-1] + (w.shape[1],))


def bnn_matmul_packed(x: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """sign(x) @ unpack(wp) for uint8 bitplanes wp (K/8, N), the packed bnn
    serve form: the kernel reads the planes as stored, no per-call unpack."""
    x2 = _rows(x)
    if x2.is_cuda:
        y = _bnn.bnn_packed_matmul_kernel_call(x2, wp)
    else:
        y = _bnn.bnn_packed_matmul_plain(x2, wp)
    return y.reshape(x.shape[:-1] + (wp.shape[1],))


class _BnnTrain(torch.autograd.Function):
    """y = sign(x) @ sign(w) with the SignSTE backward
    dx = (g @ sign(w)^T) * 1[|x| <= 1], dw = (sign(x)^T @ g) * 1[|w| <= 1].
    Saves only (x, w): the backward kernels re-form the signs and masks. On
    CUDA tensors both directions launch the hand-written kernels; on CPU
    tensors they take the plain versions."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return bnn_matmul(x2, w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.contiguous()
        if x2.is_cuda:
            return _bnn.bnn_bwd_dx_call(x2, w, g), _bnn.bnn_bwd_dw_call(x2, w, g)
        return _bnn.bnn_bwd_dx_plain(x2, w, g), _bnn.bnn_bwd_dw_plain(x2, w, g)


def bnn_train_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Training BNN product with the SignSTE backward (the function of the
    reference's ``sign_ste(x) @ sign_ste(w)``). x (..., K); w (K, N) ->
    (..., N) float32."""
    y = _BnnTrain.apply(_rows(x), w.to(torch.float32))
    return y.reshape(x.shape[:-1] + (w.shape[1],))


def qnn_matmul(x_int: torch.Tensor, w_int: torch.Tensor, w_scale: torch.Tensor,
               x_scale: float) -> torch.Tensor:
    """int8 matmul + per-column dequant: x_int (..., K) int8, w_int (K, N)
    int8, w_scale (N,) or (1, N) float32 -> (..., N) float32
    ``float32(x_int @ w_int) * (w_scale * x_scale)``. Nothing is padded:
    the kernel masks its ragged edges."""
    lead = x_int.shape[:-1]
    x2 = x_int.reshape(-1, x_int.shape[-1])
    if x2.is_cuda:
        y = qnn_matmul_kernel_call(x2, w_int, w_scale, x_scale)
    else:
        y = qnn_matmul_plain(x2, w_int, w_scale, x_scale)
    return y.reshape(lead + (w_int.shape[1],))


KERNEL_ROUTES: dict = {
    "bnn": bnn_matmul,
    "bnn_packed": bnn_matmul_packed,
    "bnn_train": bnn_train_matmul,
    "cac_hw": cac_matmul,
    "cac_train": cac_train_matmul,
    "paged_attn": paged_attention,
    "qnn8": qnn_matmul,
}

_COUNTED = {
    "bnn": _bnn.bnn_matmul_kernel_call,
    "bnn_bwd_dw": _bnn.bnn_bwd_dw_call,
    "bnn_bwd_dx": _bnn.bnn_bwd_dx_call,
    "bnn_packed": _bnn.bnn_packed_matmul_kernel_call,
    "cac_hw": cac_matmul_kernel_call,
    "cac_train_bwd_dw": _cac.cac_train_bwd_dw_call,
    "cac_train_bwd_dx": _cac.cac_train_bwd_dx_call,
    "cac_train_bwd_fused": _cac.cac_train_bwd_fused_call,
    "cac_train_fwd": _cac.cac_train_fwd_call,
    "paged_attn": paged_attn_kernel_call,
    "qnn8": qnn_matmul_kernel_call,
}


def kernel_route(name: str):
    try:
        return KERNEL_ROUTES[name]
    except KeyError:
        raise KeyError(f"unknown kernel route {name!r}; known: {sorted(KERNEL_ROUTES)}") from None


def launch_counts() -> Dict[str, int]:
    """CUDA kernel launches per route since the last ``reset_launches``."""
    return {name: fn.launches for name, fn in sorted(_COUNTED.items())}


def reset_launches() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0
