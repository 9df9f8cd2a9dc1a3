"""The CAC kernels' wrappers and their plain versions: the hardware form
(serve) and the training form with its STE backward.

The kernel (``csrc/cac_matmul.cu``) replaces the reference's Pallas
``cac_matmul_kernel_call`` (``repro/kernels/cac_matmul.py``). It reads int8
activations and thresholds and the packed ``(K'/8, N)`` sign planes of the
serve form directly, so no per-call unpack happens on the card, and masks
its own ragged M, N and K' edges (the Pallas s=0 padding contract does not
carry over). It is the streaming template of ``csrc/stream_matmul.cuh``
(shared with the sign product's small-M route): byte-lane mismatch counts,
K split over the warps of a block and, where the tiles are few, over a
cluster, by ``stream_plan`` (computed here, checked by the launcher).

The training kernels (``csrc/cac_train.cu``) replace the reference's
``cac_train_fwd_call``, ``cac_train_bwd_dx_call``, ``cac_train_bwd_dw_call``
and ``cac_train_bwd_fused_call``. All four are bound by operations on the
CUDA cores at the training path's shapes (no tensor-core form of a
compare-select; the source says how each reduces across blocks). The
forward (kernel 2) splits K, and the fused backward (kernel 5) and its dx
half (kernel 3) the N tiles, over a thread block cluster by
``train_fwd_plan`` and ``train_bwd_plan``; the dw half (kernel 4) splits
its N tiles over blocks by ``train_bwd_dw_plan`` (all computed here from
the card's SM count and occupancy, checked by the launchers). Every one
writes each output once, in a fixed order; kernels 3 and 4 sum in kernel
5's order (kernel 3 takes kernel 5's cluster size), so the split pair
equals kernel 5 bit for bit. Each
wrapper takes float32 (M, K) x, (K, N) w and beta (and (M, N) g), launches
on PyTorch's current stream, raises on a CPU tensor or a failed launch, and
counts its launches; its ``*_plain`` twin computes the same function in
plain PyTorch, a few rows of M at a time.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import autotune, build, ref

__all__ = [
    "STREAM_BN",
    "STREAM_GROUP",
    "STREAM_MAX_SPLITS",
    "TRAIN_MAX_SPLITS",
    "cac_matmul_kernel_call",
    "cac_matmul_plain",
    "cac_train_bwd_dw_call",
    "cac_train_bwd_dw_plain",
    "cac_train_bwd_dx_call",
    "cac_train_bwd_dx_plain",
    "cac_train_bwd_fused_call",
    "cac_train_bwd_fused_plain",
    "cac_train_fwd_call",
    "cac_train_fwd_plain",
    "card_stream_plan",
    "card_train_bwd_dw_plan",
    "card_train_bwd_plan",
    "card_train_fwd_plan",
    "stream_plan",
    "train_bwd_dw_plan",
    "train_bwd_plan",
    "train_fwd_plan",
]

_M_CHUNK = 8  # rows per slice of the plain version's (M, K, N) broadcast
_CPU_COLS, _CPU_ELEMS = 64, 1 << 20  # the CPU plain version's slices: columns, elements
# the streaming template's tiling (csrc/stream_matmul.cuh): 128 columns a
# block, 8-row groups of K, at most 8 splits (one cluster); row tiles of 4
# at decode, 8 otherwise; two blocks an SM on the H100's 132
STREAM_BN, STREAM_GROUP, STREAM_MAX_SPLITS, STREAM_SMS = 128, 8, 8, 132
STREAM_MT = (4, 8)
_TRAIN_CHUNK_ELEMS = 1 << 24  # (rows, K, N) elements per slice of the plain training versions
# the training kernels' tiling (csrc/cac_train.cu): kernel 2 owns 128 x 64
# tiles of y and walks K in slices of 16 rows, split over at most 8 cluster
# ranks; kernels 5 and 3 own a 32-row K tile and walk 64-column N tiles,
# split over at most 16 ranks (a non-portable cluster size); two blocks an
# SM. Kernel 4 takes 64- or 32-column N tiles, a block each
TRAIN_FWD_TILE, TRAIN_FWD_SLICE = (128, 64), 16
TRAIN_BWD_TILE = (32, 64)
TRAIN_MAX_SPLITS, TRAIN_BWD_MAX_CLUSTER, TRAIN_BLOCKS_PER_SM = 8, 16, 2


def _check(x_int: torch.Tensor, tau: torch.Tensor, s_packed: torch.Tensor) -> None:
    if x_int.dim() != 2 or tau.dim() != 2 or s_packed.dim() != 2:
        raise ValueError("cac_matmul wants x (M, K), tau (K, N), s (K/8, N)")
    if x_int.dtype != torch.int8 or tau.dtype != torch.int8 or s_packed.dtype != torch.uint8:
        raise TypeError(
            f"cac_matmul wants int8 x/tau and uint8 packed s; got "
            f"{x_int.dtype}, {tau.dtype}, {s_packed.dtype}"
        )
    k, n = tau.shape
    if x_int.shape[1] != k or k % 8 or tuple(s_packed.shape) != (k // 8, n):
        raise ValueError(
            f"shape mismatch: x {tuple(x_int.shape)}, tau {tuple(tau.shape)}, "
            f"s {tuple(s_packed.shape)} (need K % 8 == 0 and s = (K/8, N))"
        )


def _cac_plain_cpu(x_int: torch.Tensor, tau: torch.Tensor, s_packed: torch.Tensor
                   ) -> torch.Tensor:
    """The CAC's integers on the CPU: with every s = +-1, y[m, n] = 2 #{k :
    (x[m, k] >= tau[k, n]) == (s[k, n] = +1)} - K. Walked in slices of
    ``_CPU_COLS`` columns (each slice's sign bits unpacked there) and a few
    rows, so that the (rows, K, cols) compare stays in cache: ~10x the
    broadcast's rate on a CPU, which a full-width model's CPU run needs."""
    m, k = x_int.shape
    n = tau.shape[1]
    y = torch.empty((m, n), dtype=torch.int32)
    shifts = torch.arange(8, dtype=torch.uint8)
    rows = max(1, _CPU_ELEMS // (k * _CPU_COLS))
    for j in range(0, n, _CPU_COLS):
        t = tau[:, j:j + _CPU_COLS]
        pos = ((s_packed[:, None, j:j + _CPU_COLS] >> shifts[:, None]) & 1).bool()
        pos = pos.reshape(k, t.shape[1])
        for i in range(0, m, rows):
            agree = torch.eq(torch.ge(x_int[i:i + rows, :, None], t), pos)
            y[i:i + rows, j:j + _CPU_COLS] = agree.sum(1, dtype=torch.int32)
    return (2 * y - k).to(torch.float32)


def cac_matmul_plain(x_int: torch.Tensor, tau: torch.Tensor, s_packed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch CAC with the kernel's signature. On the CPU
    ``_cac_plain_cpu``; elsewhere unpack the sign planes, then
    ``ref.cac_matmul_ref``'s broadcast compare, a few rows at a time so the
    (M, K, N) intermediate stays bounded. Both give the same integers."""
    from repro_torch.core.backend import unpack_signs

    _check(x_int, tau, s_packed)
    if x_int.device.type == "cpu":
        return _cac_plain_cpu(x_int, tau, s_packed)
    s = unpack_signs(s_packed, tau.shape[0])
    return torch.cat(
        [ref.cac_matmul_ref(x_int[i:i + _M_CHUNK], tau, s)
         for i in range(0, x_int.shape[0], _M_CHUNK)]
    ) if x_int.shape[0] else torch.zeros((0, tau.shape[1]), dtype=torch.float32,
                                         device=x_int.device)


def stream_plan(m: int, k: int, n: int, max_blocks=None, mt=None) -> tuple:
    """(mt, splits, groups_per_split) for the streaming template at x (m,
    k), weights (k, n): row tiles of ``mt`` (4 when m <= 4, the decode
    tick; else 8, and ceil(m / 8) tiles; a kernel that takes one row tile
    at every M passes it), and the ceil(k / 8) row groups
    cut into ``splits`` ranges of ``groups_per_split``, split s taking [s g,
    (s + 1) g), none empty. ``max_blocks(mt, splits)`` is how many blocks
    the card keeps resident in clusters of ``splits`` (two an SM when
    None). Takes the most splits whose blocks all fit in one wave (so the
    most SMs share the loads and the compares), one split where even that
    does not fit. chip_smoke.py times every split count at the serve path's
    shapes beside it (PERF.md)."""
    mt = mt or (STREAM_MT[0] if m <= STREAM_MT[0] else STREAM_MT[1])
    groups = -(-k // STREAM_GROUP)
    tiles = -(-m // mt) * -(-n // STREAM_BN)
    best = (1, groups)
    for s in range(2, min(STREAM_MAX_SPLITS, groups) + 1):
        per = -(-groups // s)
        if -(-groups // per) != s:  # the same ranges as fewer splits
            continue
        cap = 2 * STREAM_SMS if max_blocks is None else max_blocks(mt, s)
        if tiles * s <= cap:
            best = (s, per)
    return (mt,) + best


def card_stream_max_blocks(index: int, mt: int, splits: int, source: str = "cac_matmul",
                           symbol: str = "stream_max_blocks") -> int:
    """Blocks of a streaming kernel of ``csrc/<source>.cu`` with ``mt``-row
    tiles that card ``index`` keeps resident in clusters of ``splits``, as
    its occupancy query ``symbol`` reports (kernel 1's ``stream_max_blocks``;
    in ``bnn_matmul`` kernel 6's small-M route, or kernel 7's
    ``packed_max_blocks``; in ``qnn_matmul`` kernel 10's stream route); 0
    where none fits."""
    fn = getattr(build.load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    with torch.cuda.device(index):
        return max(0, fn(mt, splits))


@functools.lru_cache(maxsize=None)
def card_stream_plan(index: int, m: int, k: int, n: int, source: str = "cac_matmul",
                     symbol: str = "stream_max_blocks", mt=None) -> tuple:
    """``stream_plan`` (``mt`` as there) under card ``index``'s occupancy
    for the streaming kernel that ``source``'s ``symbol`` reports on, once
    per card, shape and kernel."""
    return stream_plan(m, k, n,
                       lambda t, s: card_stream_max_blocks(index, t, s, source, symbol), mt)


def _lib():
    lib = build.load("cac_matmul")
    fn = lib.cac_matmul_launch
    if fn.argtypes is None:  # declare once: pointers must not pass as 32-bit ints
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def cac_matmul_kernel_call(x_int: torch.Tensor, tau: torch.Tensor,
                           s_packed: torch.Tensor, plan=None) -> torch.Tensor:
    """Launch the CUDA CAC kernel on PyTorch's current stream.
    x_int (M, K') int8, tau (K', N) int8, s_packed (K'/8, N) uint8 ->
    (M, N) float32, by the plan ``autotune.get_plan("hw_fwd", ...)``
    resolves (``plan`` overrides it). Raises on a CPU tensor or a failed
    launch; adds one to ``cac_matmul_kernel_call.launches`` per launch."""
    _check(x_int, tau, s_packed)
    for t in (x_int, tau, s_packed):
        if not t.is_cuda:
            raise ValueError("cac_matmul_kernel_call needs CUDA tensors")
    x_int, tau, s_packed = x_int.contiguous(), tau.contiguous(), s_packed.contiguous()
    m, k = x_int.shape
    n = tau.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x_int.device)
    if m == 0 or n == 0:
        return y
    if k == 0:
        return y.zero_()
    stream = torch.cuda.current_stream(x_int.device).cuda_stream
    err = _lib()(x_int.data_ptr(), tau.data_ptr(), s_packed.data_ptr(), y.data_ptr(),
                 m, n, k, *autotune.get_plan("hw_fwd", m, k, n, x_int.device.index, plan),
                 stream)
    if err != 0:
        raise RuntimeError(f"cac_matmul kernel launch failed: CUDA error {err}")
    cac_matmul_kernel_call.launches += 1
    return y


cac_matmul_kernel_call.launches = 0


# ---------------------------------------------------------------------------
# Training form: y = sum_k Sign(x w + beta) and its STE backward
# ---------------------------------------------------------------------------


def _check_train(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor,
                 g: torch.Tensor = None) -> None:
    ops = (x, w, beta) if g is None else (x, w, beta, g)
    if any(t.dim() != 2 for t in ops):
        raise ValueError("the training CAC wants x (M, K), w and beta (K, N), g (M, N)")
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError(f"the training CAC takes float32; got {[t.dtype for t in ops]}")
    m, k = x.shape
    if w.shape[0] != k or beta.shape != w.shape or (g is not None and
                                                    tuple(g.shape) != (m, w.shape[1])):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, beta "
            f"{tuple(beta.shape)}" + ("" if g is None else f", g {tuple(g.shape)}"))


def _row_chunks(m: int, k: int, n: int):
    step = max(1, _TRAIN_CHUNK_ELEMS // max(k * n, 1))
    return [(i, min(m, i + step)) for i in range(0, m, step)]


def cac_train_fwd_plain(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch kernel 2: ``ref.cac_train_fwd_ref`` a few rows at a time."""
    _check_train(x, w, beta)
    out = torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    for a, b in _row_chunks(*x.shape, w.shape[1]):
        out[a:b] = ref.cac_train_fwd_ref(x[a:b], w, beta)
    return out


def _bwd_plain(x, w, beta, g, want_dx: bool, want_dw: bool):
    """The STE backward a slice of rows at a time; dw and dbeta sum the
    slices in float64 (one slice: the float32 sums themselves), so that at
    a large M (CNV's im2col: 131,072 rows, hundreds of slices) the plain
    version's own rounding stays below the bound the kernels are held to."""
    _check_train(x, w, beta, g)
    m, k = x.shape
    dx = torch.empty_like(x) if want_dx else None
    dw = torch.zeros_like(w, dtype=torch.float64) if want_dw else None
    db = torch.zeros_like(w, dtype=torch.float64) if want_dw else None
    for a, b in _row_chunks(m, k, w.shape[1]):
        cdx, cdw, cdb = ref.cac_train_bwd_ref(x[a:b], w, beta, g[a:b])
        if want_dx:
            dx[a:b] = cdx
        if want_dw:
            dw += cdw
            db += cdb
    if want_dw:
        dw, db = dw.to(torch.float32), db.to(torch.float32)
    return dx, dw, db


def cac_train_bwd_dx_plain(x, w, beta, g) -> torch.Tensor:
    """Plain PyTorch kernel 3: dx = sum_n g * 1[|x w + beta| <= 1] * w."""
    return _bwd_plain(x, w, beta, g, True, False)[0]


def cac_train_bwd_dw_plain(x, w, beta, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch kernel 4: (dw, dbeta) = sum_m g * mask * (x, 1)."""
    _, dw, db = _bwd_plain(x, w, beta, g, False, True)
    return dw, db


def cac_train_bwd_fused_plain(x, w, beta, g):
    """Plain PyTorch kernel 5: (dx, dw, dbeta) from one mask per row slice."""
    return _bwd_plain(x, w, beta, g, True, True)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def train_fwd_plan(m: int, k: int, n: int, max_blocks=None, sms: int = STREAM_SMS) -> tuple:
    """(splits, slices_per_split) for kernel 2 at x (m, k), w (k, n): the
    ceil(k / 16) K slices cut into ``splits`` ranges (a cluster of that many
    blocks per 128 x 64 tile of y), none empty. Takes the split count of 1,
    2, 4 or 8 that needs the fewest K slices counted one after another: the
    waves of blocks the card holds at once (``max_blocks(splits)``, or two
    an SM of ``sms``) times a block's slices, plus one for a split block's
    cluster reduction; the larger on a tie. A count of which no cluster
    fits is skipped. (On the H100, clusters of 3, 6 and 7 were slower than
    4 at all four path shapes: chip_smoke.py's split sweep, PERF.md.)"""
    bm, bn = TRAIN_FWD_TILE
    tiles = _cdiv(m, bm) * _cdiv(n, bn)
    slices = _cdiv(k, TRAIN_FWD_SLICE)
    best = None
    for s in (1, 2, 4, 8):
        if s > slices:
            break
        per = _cdiv(slices, s)
        if _cdiv(slices, per) != s:  # the same ranges as fewer splits
            continue
        cap = TRAIN_BLOCKS_PER_SM * sms if max_blocks is None else max_blocks(s)
        if cap < s:
            continue
        cost = _cdiv(tiles * s, cap) * (per + (s > 1))
        if best is None or cost <= best[0]:
            best = (cost, s, per)
    return best[1:]


def train_bwd_plan(m: int, k: int, n: int, max_blocks=None, sms: int = STREAM_SMS) -> int:
    """The cluster size of kernel 5 at x (m, k), w (k, n): each of the
    ceil(k / 32) K tiles is a cluster whose ranks split the ceil(n / 64) N
    tiles between them (M is walked inside every block). Takes the size
    that needs the fewest N tiles walked one after another: the waves of
    clusters the card holds at once (``max_blocks(size)`` blocks, or two an
    SM of ``sms``) times the most N tiles a rank takes; the larger on a
    tie. A size of which no cluster fits is skipped."""
    bk, bn = TRAIN_BWD_TILE
    k_tiles, n_tiles = _cdiv(k, bk), _cdiv(n, bn)
    best = None
    for c in range(1, min(TRAIN_BWD_MAX_CLUSTER, n_tiles) + 1):
        cap = TRAIN_BLOCKS_PER_SM * sms if max_blocks is None else max_blocks(c)
        if cap < c:
            continue
        cost = _cdiv(k_tiles * c, cap) * _cdiv(n_tiles, c)
        if best is None or cost <= best[0]:
            best = (cost, c)
    return best[1]


def train_bwd_dw_plan(m: int, k: int, n: int, max_blocks=None, sms: int = STREAM_SMS) -> tuple:
    """(nt, parts) for kernel 4 at x (m, k), w (k, n): ``nt`` columns a
    thread, 8 (64-column N tiles, two blocks an SM) where the ceil(k / 32) x
    ceil(n / 64) tiles fill the blocks the card holds at once
    (``max_blocks(8)``, or two an SM of ``sms``), else 4 (32-column tiles,
    four blocks an SM: twice the blocks, at a few more instructions a
    term); and ``parts``, the blocks that split a K tile's N tiles, one a
    tile (M is walked inside every block; no cluster: dw and dbeta are
    summed over M inside a block), which the card's block scheduler spreads
    best (chip_smoke.py's sweep times fewer)."""
    k_tiles = _cdiv(k, TRAIN_BWD_TILE[0])
    cap = TRAIN_BLOCKS_PER_SM * sms if max_blocks is None else max_blocks(8)
    nt = 8 if k_tiles * _cdiv(n, 64) >= cap else 4
    return nt, _cdiv(n, 8 * nt)


def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def card_train_fwd_plan(index: int, m: int, k: int, n: int) -> tuple:
    """``train_fwd_plan`` under card ``index``'s SM count and occupancy."""
    fn = _train_lib("cac_train_fwd_max_blocks")
    with torch.cuda.device(index):
        return train_fwd_plan(m, k, n, fn, _sms(index))


@functools.lru_cache(maxsize=None)
def card_train_bwd_plan(index: int, m: int, k: int, n: int) -> int:
    """``train_bwd_plan`` under card ``index``'s SM count and kernel 5's
    cluster occupancy: the cluster size of kernel 5, and of kernel 3, which
    needs no more shared memory or registers a block and so sums dx in
    kernel 5's order."""
    fn = _train_lib("cac_train_bwd_fused_max_blocks")
    with torch.cuda.device(index):
        return train_bwd_plan(m, k, n, lambda c: fn(c, m), _sms(index))


@functools.lru_cache(maxsize=None)
def card_train_bwd_dw_plan(index: int, m: int, k: int, n: int) -> tuple:
    """``train_bwd_dw_plan`` under card ``index``'s SM count and occupancy."""
    fn = _train_lib("cac_train_bwd_dw_max_blocks")
    with torch.cuda.device(index):
        return train_bwd_dw_plan(m, k, n, lambda nt: fn(nt, m), _sms(index))


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_TRAIN_ARGTYPES = {
    "cac_train_fwd_launch": [_PTR] * 4 + [_INT] * 4 + [_PTR],
    "cac_train_fwd_max_blocks": [_INT],
    "cac_train_bwd_fused_launch": [_PTR] * 7 + [_INT] * 4 + [_PTR],
    "cac_train_bwd_fused_max_blocks": [_INT] * 2,
    "cac_train_bwd_dx_launch": [_PTR] * 5 + [_INT] * 4 + [_PTR],
    "cac_train_bwd_dx_max_blocks": [_INT] * 2,
    "cac_train_bwd_dw_launch": [_PTR] * 6 + [_INT] * 5 + [_PTR],
    "cac_train_bwd_dw_max_blocks": [_INT] * 2,
}


def _train_lib(name: str):
    fn = getattr(build.load("cac_train"), name)
    if fn.argtypes is None:  # declare once: pointers must not pass as 32-bit ints
        fn.argtypes, fn.restype = _TRAIN_ARGTYPES[name], ctypes.c_int
    return fn


def _on_card(what: str, *ts: torch.Tensor):
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{what} needs CUDA tensors")
    return [t.contiguous() for t in ts]


def cac_train_fwd_call(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor,
                       plan=None) -> torch.Tensor:
    """Launch kernel 2: (M, N) float32 y = sum_k Sign(x w + beta), exact
    integers, K split by ``autotune.get_plan("train_fwd", ...)``
    (``card_train_fwd_plan`` by default; ``plan`` overrides it). Adds one to
    ``cac_train_fwd_call.launches`` per launch."""
    _check_train(x, w, beta)
    x, w, beta = _on_card("cac_train_fwd_call", x, w, beta)
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    if k == 0:
        return y.zero_()
    splits, _ = autotune.get_plan("train_fwd", m, k, n, x.device.index, plan)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _train_lib("cac_train_fwd_launch")(x.data_ptr(), w.data_ptr(), beta.data_ptr(),
                                             y.data_ptr(), m, n, k, splits, stream)
    if err != 0:
        raise RuntimeError(f"cac_train_fwd kernel launch failed: CUDA error {err}")
    cac_train_fwd_call.launches += 1
    return y


def _bwd_call(fn, x, w, beta, g, want_dx: bool, want_dw: bool, plan=None):
    _check_train(x, w, beta, g)
    x, w, beta, g = _on_card(fn.__name__, x, w, beta, g)
    m, k = x.shape
    n = w.shape[1]
    dx = torch.empty_like(x) if want_dx else None
    dw = torch.empty_like(w) if want_dw else None
    db = torch.empty_like(w) if want_dw else None
    if m == 0 or k == 0 or n == 0:
        return tuple(None if t is None else t.zero_() for t in (dx, dw, db))
    ops = [x.data_ptr(), w.data_ptr(), beta.data_ptr(), g.data_ptr()]
    outs = [t.data_ptr() for t in (dx, dw, db) if t is not None]
    index, stream = x.device.index, torch.cuda.current_stream(x.device).cuda_stream
    if want_dx:  # kernel 5, or 3 at kernel 5's cluster size: one path, one plan
        name = "cac_train_bwd_fused_launch" if want_dw else "cac_train_bwd_dx_launch"
        plan = (autotune.get_plan("train_bwd", m, k, n, index, plan),)
    else:
        name = "cac_train_bwd_dw_launch"
        plan = autotune.get_plan("train_bwd_dw", m, k, n, index, plan)
    err = _train_lib(name)(*ops, *outs, m, n, k, *plan, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error {err}")
    fn.launches += 1
    return dx, dw, db


def cac_train_bwd_dx_call(x, w, beta, g, plan=None) -> torch.Tensor:
    """Launch kernel 3: dx (M, K), the N tiles split by the cluster size
    ``autotune.get_plan("train_bwd", ...)`` resolves, kernel 5's
    (``card_train_bwd_plan`` by default; ``plan`` overrides it);
    bit-repeatable. Adds one to ``.launches`` per launch."""
    return _bwd_call(cac_train_bwd_dx_call, x, w, beta, g, True, False, plan)[0]


def cac_train_bwd_dw_call(x, w, beta, g, plan=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel 4: (dw, dbeta), each (K, N), the N tiles split by
    ``autotune.get_plan("train_bwd_dw", ...)`` (``card_train_bwd_dw_plan``
    by default; ``plan`` overrides it); bit-repeatable. Adds one to
    ``.launches`` per launch."""
    _, dw, db = _bwd_call(cac_train_bwd_dw_call, x, w, beta, g, False, True, plan)
    return dw, db


def cac_train_bwd_fused_call(x, w, beta, g, plan=None):
    """Launch kernel 5: (dx, dw, dbeta) from one mask recompute, the N tiles
    split by ``autotune.get_plan("train_bwd", ...)`` (``card_train_bwd_plan``
    by default; ``plan`` overrides it); bit-repeatable. Adds one to
    ``.launches`` per launch."""
    return _bwd_call(cac_train_bwd_fused_call, x, w, beta, g, True, True, plan)


for _fn in (cac_train_fwd_call, cac_train_bwd_dx_call, cac_train_bwd_dw_call,
            cac_train_bwd_fused_call):
    _fn.launches = 0
