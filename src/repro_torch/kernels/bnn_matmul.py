"""The BNN kernels' wrappers and their plain versions: the sign product
(training forward and unpacked serve), its packed serve form, and the
SignSTE backward pair.

The kernels (``csrc/bnn_matmul.cu``) replace the reference's Pallas
``bnn_matmul_kernel_call``, ``bnn_packed_matmul_kernel_call``,
``bnn_bwd_dx_call`` and ``bnn_bwd_dw_call`` (``repro/kernels/bnn_matmul.py``).
Sign is ``+1 if v >= 0 else -1`` throughout (+0 and -0 give +1, NaN gives
-1), never ``torch.sign``. The forwards count sign agreements with XNOR and
popcount over 32-row words and read the weights as stored (float32 or int8
+-1, or the packed ``(K/8, N)`` bitplanes), so the serve routes make no
per-call cast; they mask their own ragged edges, so the reference's padding
constants do not carry over. The source says what bounds each kernel.

Each ``*_call`` checks device, dtype, shape and contiguity, launches on
PyTorch's current stream, raises on a CPU tensor or a failed launch, and
adds one to its ``.launches`` per launch. Its ``*_plain`` twin computes the
same function in plain PyTorch (``torch.where(v >= 0, 1., -1.)`` products,
the backward's summed in float64); none forms an (M, K, N) intermediate, so
the full-width training shape needs no chunking.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref
from .cac_matmul import _on_card

__all__ = [
    "bnn_bwd_dw_call",
    "bnn_bwd_dw_plain",
    "bnn_bwd_dx_call",
    "bnn_bwd_dx_plain",
    "bnn_matmul_kernel_call",
    "bnn_matmul_plain",
    "bnn_packed_matmul_kernel_call",
    "bnn_packed_matmul_plain",
]

_W_KIND = {torch.float32: 0, torch.int8: 1}  # the launcher's w_kind; 2 = packed
_PACKED = 2


def _check_fwd(x: torch.Tensor, w: torch.Tensor, packed: bool) -> None:
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError("the BNN forward wants x (M, K) and w (K, N) or wp (K/8, N)")
    if x.dtype != torch.float32:
        raise TypeError(f"the BNN forward takes float32 x; got {x.dtype}")
    if packed:
        if w.dtype != torch.uint8:
            raise TypeError(f"the packed BNN forward takes uint8 bitplanes; got {w.dtype}")
        if x.shape[1] != 8 * w.shape[0]:
            raise ValueError(f"shape mismatch: x {tuple(x.shape)}, wp {tuple(w.shape)} "
                             f"(need K = 8 * packed rows)")
    else:
        if w.dtype not in _W_KIND:
            raise TypeError(f"the BNN forward takes float32 or int8 w; got {w.dtype}")
        if x.shape[1] != w.shape[0]:
            raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")


def _check_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or g.dim() != 2:
        raise ValueError("the BNN backward wants x (M, K), w (K, N), g (M, N)")
    if any(t.dtype != torch.float32 for t in (x, w, g)):
        raise TypeError(f"the BNN backward takes float32; got {x.dtype}, {w.dtype}, {g.dtype}")
    if x.shape[1] != w.shape[0] or tuple(g.shape) != (x.shape[0], w.shape[1]):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"g {tuple(g.shape)}")


def _sgn(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 0, 1.0, -1.0).to(torch.float32)


def bnn_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch kernel 6: ``ref.bnn_matmul_ref``, exact integer sums
    (every partial sum of +-1 products is an integer below 2^24)."""
    _check_fwd(x, w, packed=False)
    return ref.bnn_matmul_ref(x, w)


def bnn_packed_matmul_plain(x: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch kernel 7: unpack the bitplanes, then kernel 6's product."""
    from repro_torch.core.backend import unpack_signs

    _check_fwd(x, wp, packed=True)
    return ref.bnn_matmul_ref(x, unpack_signs(wp, 8 * wp.shape[0]))


def bnn_bwd_dx_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch kernel 8: dx = (g @ sign(w)^T) * 1[|x| <= 1], the
    product summed in float64 and rounded once to float32, so that the
    oracle's own rounding stays far below the 1e-4 the kernels are held to
    (a float32 sum over the path's N = 2560 in some orders does not)."""
    _check_bwd(x, w, g)
    dx = (g.double() @ _sgn(w).double().T).to(torch.float32)
    return torch.where(x.abs() <= 1.0, dx, 0.0)


def bnn_bwd_dw_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch kernel 9: dw = (sign(x)^T @ g) * 1[|w| <= 1], summed in
    float64 as kernel 8's plain version is."""
    _check_bwd(x, w, g)
    dw = (_sgn(x).double().T @ g.double()).to(torch.float32)
    return torch.where(w.abs() <= 1.0, dw, 0.0)


def _lib(name: str, n_ptr: int):
    fn = getattr(build.load("bnn_matmul"), name)
    if fn.argtypes is None:  # declare once: pointers must not pass as 32-bit ints
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _fwd_call(caller, x: torch.Tensor, w: torch.Tensor, kind: int) -> torch.Tensor:
    x, w = _on_card(caller.__name__, x, w)
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    if k == 0:
        return y.zero_()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib("bnn_fwd_launch", 3)(x.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k, kind,
                                    stream)
    if err != 0:
        raise RuntimeError(f"{caller.__name__} kernel launch failed: CUDA error {err}")
    caller.launches += 1
    return y


def bnn_matmul_kernel_call(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch kernel 6: x float32 (M, K), w float32 or int8 (K, N) ->
    (M, N) float32 sign(x) @ sign(w), exact integers. Adds one to
    ``bnn_matmul_kernel_call.launches`` per launch."""
    _check_fwd(x, w, packed=False)
    return _fwd_call(bnn_matmul_kernel_call, x, w, _W_KIND[w.dtype])


def bnn_packed_matmul_kernel_call(x: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """Launch kernel 7: x float32 (M, K), wp uint8 bitplanes (K/8, N) ->
    (M, N) float32 sign(x) @ unpack(wp), exact integers. Adds one to
    ``bnn_packed_matmul_kernel_call.launches`` per launch."""
    _check_fwd(x, wp, packed=True)
    return _fwd_call(bnn_packed_matmul_kernel_call, x, wp, _PACKED)


def _bwd_call(caller, x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
              want_dx: bool) -> torch.Tensor:
    _check_bwd(x, w, g)
    x, w, g = _on_card(caller.__name__, x, w, g)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty_like(x if want_dx else w)  # the kernel writes every element
    if out.numel() == 0:
        return out
    if (n if want_dx else m) == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib("bnn_bwd_launch", 4)(x.data_ptr(), w.data_ptr(), g.data_ptr(), out.data_ptr(),
                                    m, n, k, int(want_dx), stream)
    if err != 0:
        raise RuntimeError(f"{caller.__name__} kernel launch failed: CUDA error {err}")
    caller.launches += 1
    return out


def bnn_bwd_dx_call(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch kernel 8: dx (M, K) = (g @ sign(w)^T) * 1[|x| <= 1]. Adds one
    to ``bnn_bwd_dx_call.launches`` per launch."""
    return _bwd_call(bnn_bwd_dx_call, x, w, g, want_dx=True)


def bnn_bwd_dw_call(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch kernel 9: dw (K, N) = (sign(x)^T @ g) * 1[|w| <= 1]. Adds one
    to ``bnn_bwd_dw_call.launches`` per launch."""
    return _bwd_call(bnn_bwd_dw_call, x, w, g, want_dx=False)


for _fn in (bnn_matmul_kernel_call, bnn_packed_matmul_kernel_call, bnn_bwd_dx_call,
            bnn_bwd_dw_call):
    _fn.launches = 0
