"""The int8 matmul kernel's wrapper and its plain version (kernel 10).

The kernel (``csrc/qnn_matmul.cu``) replaces the reference's Pallas
``qnn_matmul_kernel_call`` (``repro/kernels/qnn_matmul.py``):
``y = float32(x_int @ w_int) * (w_scale * x_scale)`` with an exact int32
accumulator and the scale product rounded to float32 first. It masks its
own ragged edges, so nothing is padded (the reference pads M, K and N to
block multiples). The source says what bounds it.

It takes one of two routes by M (``qnn_plan``): up to ``QNN_STREAM_MAX_M``
rows (every serve path's M) the stream route, the streaming layout of
``csrc/stream_matmul.cuh`` with ``__dp4a`` into int32 sums and K split over
a cluster by ``cac_matmul.stream_plan`` (one launch, no workspace); above
it the tile route, which splits K over blocks that meet through integer
atomics in a workspace allocated here.

``qnn_matmul_kernel_call`` checks device, dtype, shape and contiguity,
launches on PyTorch's current stream, raises on a CPU tensor or a failed
launch, and adds one to ``.launches`` per launch. ``qnn_matmul_plain``
computes the same function in plain PyTorch (``ref.qnn_matmul_ref``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import autotune, build, ref
from .cac_matmul import _on_card, card_stream_plan, stream_plan

__all__ = ["QNN_STREAM_MAX_M", "qnn_matmul_kernel_call", "qnn_matmul_plain", "qnn_plan"]

# Kernel 10 takes the stream route up to this many rows and the tile route
# above. The serve path runs M = 4 (decode), 16 (the draft's bucketed
# prefill) and 32 (prefill chunks). Set from chip_smoke.py's route sweep on
# an NVIDIA H100 80GB HBM3 at 700.00 W (device ms per launch, stream / tile,
# gate/up and down; PERF.md has the run): the stream route is the faster at
# both up to M = 128 (64: 0.01820 / 0.02576 and 0.01787 / 0.02484; 128:
# 0.02800 / 0.02857 and 0.02251 / 0.03082), the tile route at M = 512
# (0.06718 / 0.05346 and 0.06564 / 0.05879).
QNN_STREAM_MAX_M = 128


def _check(x_int: torch.Tensor, w_int: torch.Tensor, w_scale: torch.Tensor) -> None:
    if x_int.dim() != 2 or w_int.dim() != 2:
        raise ValueError("the int8 matmul wants x_int (M, K) and w_int (K, N)")
    if x_int.dtype != torch.int8 or w_int.dtype != torch.int8:
        raise TypeError(f"the int8 matmul takes int8 operands; got {x_int.dtype}, {w_int.dtype}")
    if w_scale.dtype != torch.float32:
        raise TypeError(f"the int8 matmul takes a float32 w_scale; got {w_scale.dtype}")
    if x_int.shape[1] != w_int.shape[0] or w_scale.numel() != w_int.shape[1]:
        raise ValueError(f"shape mismatch: x_int {tuple(x_int.shape)}, w_int "
                         f"{tuple(w_int.shape)}, w_scale {tuple(w_scale.shape)}")


def qnn_matmul_plain(x_int: torch.Tensor, w_int: torch.Tensor, w_scale: torch.Tensor,
                     x_scale: float) -> torch.Tensor:
    """Plain PyTorch kernel 10: ``ref.qnn_matmul_ref``, exact integer sums."""
    _check(x_int, w_int, w_scale)
    return ref.qnn_matmul_ref(x_int, w_int, x_scale, w_scale)


def _route(m: int, route) -> str:
    return route or ("stream" if m <= QNN_STREAM_MAX_M else "tile")


def qnn_plan(m: int, k: int, n: int, max_blocks=None, route=None) -> tuple:
    """Kernel 10's route and plan at x (m, k), w (k, n): ``("stream", mt,
    splits, groups_per_split)`` (``cac_matmul.stream_plan``, ``max_blocks``
    as there) for m up to ``QNN_STREAM_MAX_M``, else ``("tile",)`` (the tile
    kernel cuts its own grid). ``route`` forces one ("stream" or "tile"), as
    the tests and chip_smoke.py's route sweep do."""
    route = _route(m, route)
    if route == "stream":
        return ("stream",) + stream_plan(m, k, n, max_blocks)
    if route != "tile":
        raise ValueError(f"unknown kernel-10 route {route!r}; known: stream, tile")
    return ("tile",)


@functools.lru_cache(maxsize=None)
def _card_plan(index: int, m: int, k: int, n: int, route=None) -> tuple:
    """``qnn_plan`` under card ``index``'s cluster occupancy, once per card,
    shape and route."""
    if _route(m, route) == "stream":
        return ("stream",) + card_stream_plan(index, m, k, n, "qnn_matmul")
    return qnn_plan(m, k, n, route=route)


def _lib(name: str, argtypes):
    fn = getattr(build.load("qnn_matmul"), name)
    if fn.argtypes is None:  # declare once: pointers must not pass as 32-bit ints
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int
_TILE_ARGS = [_P, _P, _P, ctypes.c_float, _P, _P, ctypes.c_longlong, _I, _I, _I, _P]
_STREAM_ARGS = [_P, _P, _P, ctypes.c_float, _P] + [_I] * 6 + [_P]


def qnn_matmul_kernel_call(x_int: torch.Tensor, w_int: torch.Tensor, w_scale: torch.Tensor,
                           x_scale: float, route=None, plan=None) -> torch.Tensor:
    """Launch kernel 10: x_int int8 (M, K), w_int int8 (K, N), w_scale
    float32 (N,) or (1, N), x_scale a float (taken as float32) -> (M, N)
    float32, by the plan ``autotune.get_plan("qnn8", ...)`` resolves: by
    default the route ``qnn_plan`` picks by M (``route`` forces "stream" or
    "tile"; ``plan`` overrides both). Adds one to
    ``qnn_matmul_kernel_call.launches`` per launch."""
    _check(x_int, w_int, w_scale)
    x_int, w_int, w_scale = _on_card("qnn_matmul_kernel_call", x_int, w_int, w_scale)
    m, k = x_int.shape
    n = w_int.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x_int.device)
    if m == 0 or n == 0:
        return y
    if k == 0:
        return y.zero_()
    plan = autotune.get_plan("qnn8", m, k, n, x_int.device.index, plan, route=route)
    stream = torch.cuda.current_stream(x_int.device).cuda_stream
    ptrs = (x_int.data_ptr(), w_int.data_ptr(), w_scale.data_ptr(), float(x_scale), y.data_ptr())
    if plan[0] == "stream":
        err = _lib("qnn_stream_launch", _STREAM_ARGS)(*ptrs, m, n, k, *plan[1:], stream)
    else:
        # split-K sums and per-tile counters (the kernel zeroes what it uses)
        n_ws = m * n + -(-m // 16) * -(-n // 64)
        ws = torch.empty((n_ws,), dtype=torch.int32, device=x_int.device)
        err = _lib("qnn_matmul_launch", _TILE_ARGS)(*ptrs, ws.data_ptr(), n_ws, m, n, k, stream)
    if err != 0:
        raise RuntimeError(f"qnn_matmul kernel launch failed: CUDA error {err}")
    qnn_matmul_kernel_call.launches += 1
    return y


qnn_matmul_kernel_call.launches = 0
