"""The BNN kernels' wrappers and their plain versions: the sign product
(training forward and unpacked serve), its packed serve form, and the
SignSTE backward pair.

The kernels (``csrc/bnn_matmul.cu``) replace the reference's Pallas
``bnn_matmul_kernel_call``, ``bnn_packed_matmul_kernel_call``,
``bnn_bwd_dx_call`` and ``bnn_bwd_dw_call`` (``repro/kernels/bnn_matmul.py``).
Sign is ``+1 if v >= 0 else -1`` throughout (+0 and -0 give +1, NaN gives
-1), never ``torch.sign``. The forwards read the weights as stored (float32
or int8 +-1, or the packed ``(K/8, N)`` bitplanes), so the serve routes make
no per-call cast; they mask their own ragged edges, so the reference's
padding constants do not carry over. The source says what bounds each
kernel.

Kernel 6 takes one of two routes by M (``fwd_plan``): up to
``FWD_STREAM_MAX_M`` rows (32 for int8 weights: decode, prefill buckets and
chunks; 16 for float32) the
streaming template of ``csrc/stream_matmul.cuh``, shared with the served
CAC (byte-lane sign mismatch counts, ``cac_matmul.stream_plan``); above it
the bf16 tensor cores, a sign pass writing sign(w)^T once and the backward
pair's product template with one plane. Kernel 7 runs on the streaming
template at every M (op SIGN_PACKED: one 16-byte plane load holds 8 K
rows of 16 columns), by ``cac_matmul.stream_plan`` under its own occupancy
with ``PACKED_MT``-row tiles.

The backward pair runs on the bf16 tensor cores (``wgmma``), g split into
three bf16 planes whose sum is g exactly, so every product is exact; the
contraction is cut into ranges by ``bwd_plan`` (computed here, checked by
the launcher) and the ranges of one output tile meet in a fixed order. The
+-1 side reaches the product as bf16, laid out by a first kernel of the
same call in scratch the wrapper allocates.

Each ``*_call`` checks device, dtype, shape and contiguity, launches on
PyTorch's current stream, raises on a CPU tensor or a failed launch, and
adds one to its ``.launches`` per launch. Its ``*_plain`` twin computes the
same function in plain PyTorch (``torch.where(v >= 0, 1., -1.)`` products,
the backward's summed in float64); none forms an (M, K, N) intermediate, so
the full-width training shape needs no chunking.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import autotune, build, ref
from .cac_matmul import _on_card, card_stream_plan, stream_plan

__all__ = [
    "bnn_bwd_dw_call",
    "bnn_bwd_dw_plain",
    "bnn_bwd_dx_call",
    "bnn_bwd_dx_plain",
    "bnn_matmul_kernel_call",
    "bnn_matmul_plain",
    "bnn_packed_matmul_kernel_call",
    "bnn_packed_matmul_plain",
    "PACKED_MT",
    "bwd_plan",
    "card_max_blocks",
    "fwd_plan",
]

_W_KIND = {torch.float32: 0, torch.int8: 1}  # the launchers' w_kind
# the backward kernels' tiling (csrc/bnn_matmul.cu): output tiles of 128 rows
# x 128 or 160 columns (the columns are K's), 64 contraction steps a stage,
# at most 8 splits (one cluster); the H100's SMs
BWD_TILE_ROWS, BWD_TILE_COLS, BWD_STAGE, BWD_MAX_SPLITS, NUM_SMS = 128, (128, 160), 64, 8, 132
# a block's epilogue (the partial tile through shared memory, the cluster's
# reduction, the stores), counted as this many stages: a weight set on the
# H100 so that the plan picks, at each path shape, the tile width that ran
# faster there (PERF.md, PR 15)
BWD_EPILOGUE_STAGES = 5
# the product template's modes (the launcher's bnn_bwd_max_blocks): 0 dw, 1 dx,
# 2 kernel 6's tensor-core route
FWD_MODE = 2
# Kernel 6 streams the weights (cac_matmul.stream_plan) for M up to this
# many rows, by weight dtype, and takes the tensor cores above it. The
# serve path runs int8 signs at M = 4 (decode) and at most 32 (prefill
# buckets and chunks); the training path float32 weights at M = 512. Set
# from chip_smoke.py's route sweep on an NVIDIA H100 80GB HBM3 at 700.00 W
# (device ms per launch, streaming / tensor cores, gate/up and down; PERF.md
# has the run): int8 M = 32 0.01649 / 0.01720 and 0.01579 / 0.01853, M =
# 48 0.01669 / 0.01850 and 0.02036 / 0.01847; float32 M = 16 0.01743 /
# 0.01956 and 0.02106 / 0.02066, M = 32 0.02574 / 0.01973 and 0.02259 /
# 0.02064.
FWD_STREAM_MAX_M = {torch.int8: 32, torch.float32: 16}
# Kernel 7's row tile at every M: on the H100, 4-row tiles (more blocks, each
# reading the 1-bit planes again from L2, one chunk a split) ran faster
# than 8-row ones at every serve shape, M = 4 to 32 (PERF.md has the runs).
PACKED_MT = 4


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


def bwd_plan(m: int, k: int, n: int, want_dx: bool, max_blocks=None) -> tuple:
    """(bn, splits, t_per_split) for kernel 8 (``want_dx``) or 9 at x (m, k),
    w (k, n): output tiles of 128 rows x ``bn`` columns, and the
    contraction (n for dx, m for dw) cut into ``splits`` ranges of
    ``t_per_split`` steps, split s taking [s t, (s + 1) t), each a whole
    number of 64-step stages and none empty. The splits of one tile run as
    one cluster, each block on its own SM; ``max_blocks(bn, splits)`` is how
    many such blocks can be resident at once (the card's own answer on
    CUDA; the 132 SMs when None). Picks the plan with the least waves x
    (stages a block + its epilogue) x bn, the work a block's SM does in
    sequence; ties go to the narrower tile and the fewer splits."""
    rows, t = (m, n) if want_dx else (n, m)
    stages = -(-t // BWD_STAGE)
    best = None
    for bn in BWD_TILE_COLS:
        tiles = -(-rows // BWD_TILE_ROWS) * -(-k // bn)
        for s in range(1, min(BWD_MAX_SPLITS, stages) + 1):
            per = -(-stages // s)
            s = -(-stages // per)  # no empty range
            cap = NUM_SMS if max_blocks is None else max_blocks(bn, s)
            if cap <= 0:
                continue
            cost = -(-tiles * s // cap) * (per + BWD_EPILOGUE_STAGES) * bn
            if best is None or cost < best[0]:
                best = (cost, bn, s, per)
    if best is None:
        raise RuntimeError("the card reports no room for a block of the BNN backward")
    return best[1], best[2], best[3] * BWD_STAGE


def _route(m: int, w_dtype, route) -> str:
    return route or ("stream" if m <= FWD_STREAM_MAX_M[w_dtype] else "tc")


def fwd_plan(m: int, k: int, n: int, w_dtype=torch.int8, max_blocks=None, route=None) -> tuple:
    """Kernel 6's route and plan at x (m, k), w (k, n) of ``w_dtype``:
    ``("stream", mt, splits, groups_per_split)`` (``cac_matmul.stream_plan``)
    for m up to ``FWD_STREAM_MAX_M[w_dtype]``, else ``("tc", bn, splits,
    k_per_split)``: the tensor-core product in the backward dx's layout,
    output tiles of 128 rows m x ``bn`` columns n, the contraction k cut as
    ``bwd_plan`` cuts dx's (``max_blocks`` as there). ``route`` forces one
    ("stream" or "tc"), as the tests and chip_smoke.py's route sweep do."""
    route = _route(m, w_dtype, route)
    if route == "stream":
        return ("stream",) + stream_plan(m, k, n)
    if route != "tc":
        raise ValueError(f"unknown kernel-6 route {route!r}; known: stream, tc")
    return ("tc",) + bwd_plan(m, n, k, True, max_blocks)


def card_max_blocks(index: int, mode: int, bn: int, splits: int) -> int:
    """How many blocks of the product template in ``mode`` (0 or False:
    kernel 9; 1 or True: kernel 8; ``FWD_MODE``: kernel 6's tensor-core
    route) with ``bn`` tile columns card ``index`` keeps resident in
    clusters of ``splits`` (the launcher's ``bnn_bwd_max_blocks``); 0 where
    none fits."""
    fn = build.load("bnn_matmul").bnn_bwd_max_blocks
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    with torch.cuda.device(index):
        return max(0, fn(int(mode), bn, splits))


@functools.lru_cache(maxsize=None)
def _card_plan(index: int, m: int, k: int, n: int, want_dx: bool) -> tuple:
    """``bwd_plan`` under card ``index``'s occupancy, once per card, shape
    and kernel."""
    return bwd_plan(m, k, n, want_dx, lambda bn, s: card_max_blocks(index, want_dx, bn, s))


@functools.lru_cache(maxsize=None)
def _card_fwd_plan(index: int, m: int, k: int, n: int, w_dtype, route=None) -> tuple:
    """``fwd_plan`` under card ``index``'s occupancy, once per card, shape,
    weight dtype and route."""
    if _route(m, w_dtype, route) == "stream":
        return ("stream",) + card_stream_plan(index, m, k, n, "bnn_matmul")
    return fwd_plan(m, k, n, w_dtype, lambda bn, s: card_max_blocks(index, FWD_MODE, bn, s),
                    route)


def _lib(name: str, n_ptr: int, n_int: int):
    fn = getattr(build.load("bnn_matmul"), name)
    if fn.argtypes is None:  # declare once: pointers must not pass as 32-bit ints
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _fwd_call(caller, x: torch.Tensor, w: torch.Tensor, launch) -> torch.Tensor:
    x, w = _on_card(caller.__name__, x, w)
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    if k == 0:
        return y.zero_()
    err = launch(x, w, y, m, k, n, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{caller.__name__} kernel launch failed: CUDA error {err}")
    caller.launches += 1
    return y


def bnn_matmul_kernel_call(x: torch.Tensor, w: torch.Tensor, route=None,
                           plan=None) -> torch.Tensor:
    """Launch kernel 6: x float32 (M, K), w float32 or int8 (K, N) ->
    (M, N) float32 sign(x) @ sign(w), exact integers, by the plan
    ``autotune.get_plan("bnn", ...)`` resolves: by default the route
    ``fwd_plan`` picks by M (``route`` forces "stream" or "tc"; ``plan``
    overrides both). Adds one to ``bnn_matmul_kernel_call.launches`` per
    call (the tensor-core route is two kernels, a sign pass and the
    product)."""
    _check_fwd(x, w, packed=False)
    kind = _W_KIND[w.dtype]

    def launch(x, w, y, m, k, n, stream):
        got = autotune.get_plan("bnn", m, k, n, x.device.index, plan, w_dtype=w.dtype,
                                route=route)
        if got[0] == "stream":
            return _lib("bnn_fwd_stream_launch", 3, 7)(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                                       m, n, k, kind, *got[1:], stream)
        kp = -(-k // 8) * 8
        sgn = torch.empty(n * kp, dtype=torch.int16, device=x.device)  # sign(w)^T as bf16
        return _lib("bnn_fwd_tc_launch", 4, 7)(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                               sgn.data_ptr(), m, n, k, kind, *got[1:], stream)

    return _fwd_call(bnn_matmul_kernel_call, x, w, launch)


def bnn_packed_matmul_kernel_call(x: torch.Tensor, wp: torch.Tensor,
                                  plan=None) -> torch.Tensor:
    """Launch kernel 7: x float32 (M, K), wp uint8 bitplanes (K/8, N) ->
    (M, N) float32 sign(x) @ unpack(wp), exact integers, on the streaming
    template by ``autotune.get_plan("bnn_packed", ...)``
    (``cac_matmul.stream_plan`` with ``PACKED_MT`` by default; ``plan``
    overrides it). Adds one to ``bnn_packed_matmul_kernel_call.launches``
    per launch."""
    _check_fwd(x, wp, packed=True)

    def launch(x, wp, y, m, k, n, stream):
        got = autotune.get_plan("bnn_packed", m, k, n, x.device.index, plan)
        return _lib("bnn_packed_launch", 3, 6)(x.data_ptr(), wp.data_ptr(), y.data_ptr(), m, n,
                                               k, *got, stream)

    return _fwd_call(bnn_packed_matmul_kernel_call, x, wp, launch)


def _bwd_call(caller, x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
              want_dx: bool, plan=None) -> torch.Tensor:
    _check_bwd(x, w, g)
    x, w, g = _on_card(caller.__name__, x, w, g)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty_like(x if want_dx else w)  # the kernel writes every element
    if out.numel() == 0:
        return out
    if (n if want_dx else m) == 0:
        return out.zero_()
    bn, splits, per = autotune.get_plan("bnn_bwd", m, k, n, x.device.index, plan,
                                        want_dx=want_dx)
    t = n if want_dx else m
    sgn = torch.empty(k * -(-t // 8) * 8, dtype=torch.int16, device=x.device)  # +-1 as bf16
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib("bnn_bwd_launch", 5, 7)(x.data_ptr(), w.data_ptr(), g.data_ptr(), out.data_ptr(),
                                       sgn.data_ptr(), m, n, k, int(want_dx), bn, splits, per,
                                       stream)
    if err != 0:
        raise RuntimeError(f"{caller.__name__} kernel launch failed: CUDA error {err}")
    caller.launches += 1
    return out


def bnn_bwd_dx_call(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                    plan=None) -> torch.Tensor:
    """Launch kernel 8: dx (M, K) = (g @ sign(w)^T) * 1[|x| <= 1], by the
    dx half of ``autotune.get_plan("bnn_bwd", ...)`` (``plan`` overrides
    it). Adds one to ``bnn_bwd_dx_call.launches`` per launch."""
    return _bwd_call(bnn_bwd_dx_call, x, w, g, True, plan)


def bnn_bwd_dw_call(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                    plan=None) -> torch.Tensor:
    """Launch kernel 9: dw (K, N) = (sign(x)^T @ g) * 1[|w| <= 1], by the
    dw half of ``autotune.get_plan("bnn_bwd", ...)`` (``plan`` overrides
    it). Adds one to ``bnn_bwd_dw_call.launches`` per launch."""
    return _bwd_call(bnn_bwd_dw_call, x, w, g, False, plan)


for _fn in (bnn_matmul_kernel_call, bnn_packed_matmul_kernel_call, bnn_bwd_dx_call,
            bnn_bwd_dw_call):
    _fn.launches = 0
