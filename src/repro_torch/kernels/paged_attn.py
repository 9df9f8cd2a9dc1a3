"""Fused paged attention: the CUDA kernel's wrapper and its plan.

The kernel (``csrc/paged_attn.cu``) replaces the reference's Pallas
``paged_attn_kernel_call`` (``repro/kernels/paged_attn.py``): attention over
each row's block table with the ``kv_pos <= q_pos`` mask, GQA, whole-block
skip and fused int8 K/V dequantization. Decode (C = 1), the speculative
verify and chunked prefill (C = chunk) use the same kernel. Each row's
table is split over a thread block cluster of ``splits`` blocks (rank r
takes table blocks r, r + splits, ...), each rank keeps an online softmax
over its blocks, and rank 0 merges the ranks' (m, l, acc) in rank order.
Its plain version is ``ref.paged_attention_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import autotune, build

__all__ = ["attn_plan", "attn_smem_bytes", "card_max_blocks", "card_plan",
           "paged_attn_kernel_call"]

# the kernel's constants (csrc/paged_attn.cu)
MAX_WARPS = 8
SPLITS = 8          # the portable cluster size
MAX_SPLITS = 16     # a non-portable cluster: T > 8, where the grid stays one wave
QTILE = 8           # query tokens a tile, at most, in the kernel's own plan
MAX_QTILE = 32      # a caller's plan: a warp reduces the tile's positions
MAX_D = 256
MAX_BS = 128
SMS = 132                 # the H100's SMs: the plan's one wave
SMEM_BUDGET = 110 * 1024  # bytes a block, so that two fit an SM
SMEM_MAX = 232448         # a block's most on the H100 (227 KB)


def dims_per_lane(d: int) -> int:
    """Output dims a lane owns: the least power of two with 32 x it >= D."""
    return 1 if d <= 32 else 2 if d <= 64 else 4 if d <= 128 else 8


def qmax(d: int) -> int:
    """Query vectors a warp holds in registers at head dim ``d``."""
    di = dims_per_lane(d)
    return 4 if di <= 2 else 2 if di == 4 else 1


def attn_smem_bytes(q_tile: int, g: int, d: int, bs: int, t: int, splits: int) -> int:
    """Shared memory of one block: rank 0's mbarrier (16 bytes), q (q_tile
    G rows), K and V of one table block (K rows padded to 32 bytes past a
    multiple of 128), each warp's p row, rank 0's slots for ranks
    1..splits-1 ((m, l) and acc per query vector), the tile's positions and
    the rank's table entries."""
    dp = -(-d // 4) * 4
    kp = -(-d // 32) * 32 + 8
    qv = q_tile * g
    nt = -(-t // splits)
    return 16 + 4 * (qv * dp + bs * kp + bs * dp + MAX_WARPS * bs + (splits - 1) * qv * (2 + d)
                     + q_tile + nt)


def resident_per_sm(smem: int, threads: int) -> int:
    """Blocks an H100 SM keeps: 228 KB of shared memory (1 KB a block
    reserved), 2,048 threads, 64 K registers at the kernel's 128 a thread,
    32 blocks."""
    return min(233472 // (smem + 1024), 2048 // threads, 65536 // (128 * threads), 32)


def one_wave(blocks: int, smem: int, threads: int) -> bool:
    """Whether ``blocks`` such blocks, in clusters, are one wave of the
    card: 7/8 of the SMs' sum, for clusters place less densely (the
    streaming kernels' clusters of 8 keep 240 of the 264 blocks two an SM
    would give)."""
    return 8 * blocks <= 7 * SMS * resident_per_sm(smem, threads)


def _fit_tile(c, g, d, bs, t, splits):
    cap = MAX_WARPS * qmax(d)
    tiles = -(-c // QTILE)
    qt = -(-c // tiles)

    def fits(q, budget=SMEM_BUDGET):
        return q * g <= cap and attn_smem_bytes(q, g, d, bs, t, splits) <= budget

    while qt > 1 and not fits(qt):
        qt -= 1
    return qt if fits(qt, SMEM_MAX) else 0  # one token a tile may take a whole SM


def attn_plan(b: int, c: int, hq: int, hkv: int, d: int, bs: int, t: int) -> Tuple[int, int]:
    """(q_tile, splits) of a call, as the kernel takes it. A cluster of
    min(T, 8) ranks, or of min(T, 16) when T > 8 and the grid of such
    clusters, at the same query tile, is one wave of the card. One query
    token a tile (a query vector a warp) where the grid of one-token tiles is
    one wave of the card; else at most 8 tokens a tile, the tiles of a chunk
    as even as they can be, fewer where the tile's query vectors (q_tile x
    G) would pass what 8 warps hold in registers or the shared memory would
    not let two blocks share an SM (down to one token, which may take an SM
    alone). Raises ValueError for a shape the kernel does not take (D > 256,
    bs > 128, a GQA group past the registers)."""
    if min(b, c, hq, hkv, d, bs, t) <= 0 or hq % hkv:
        raise ValueError(f"paged attention shape B={b} C={c} Hq={hq} Hkv={hkv} D={d} "
                         f"bs={bs} T={t}")
    if d > MAX_D or bs > MAX_BS:
        raise ValueError(f"the paged attention kernel takes D <= {MAX_D} and block size <= "
                         f"{MAX_BS}, got D={d}, bs={bs}")
    g = hq // hkv
    splits = min(t, SPLITS)
    qt = _fit_tile(c, g, d, bs, t, splits)
    if not qt:
        raise ValueError(f"a GQA group of {g} query heads at D={d} does not fit one block")
    if qt > 1 and one_wave(b * hkv * c * splits, attn_smem_bytes(1, g, d, bs, t, splits),
                           32 * min(MAX_WARPS, g)):
        qt = 1  # one token a tile (one query vector a warp) where that grid is one wave
    if t > SPLITS:
        wide = min(t, MAX_SPLITS)
        threads = 32 * min(MAX_WARPS, min(qt, c) * g)
        blocks = b * hkv * -(-c // qt) * wide
        if (_fit_tile(c, g, d, bs, t, wide) == qt
                and one_wave(blocks, attn_smem_bytes(qt, g, d, bs, t, wide), threads)):
            splits = wide
    return qt, splits


def _lib():
    lib = build.load("paged_attn")
    fn = lib.paged_attn_launch_plan
    if fn.argtypes is None:  # declare once: pointers must not pass as 32-bit ints
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.paged_attn_plan.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
        lib.paged_attn_plan.restype = ctypes.c_int
        lib.paged_attn_max_blocks.argtypes = [ctypes.c_int] * 10
        lib.paged_attn_max_blocks.restype = ctypes.c_int
    return lib


def card_plan(b: int, c: int, hq: int, hkv: int, d: int, bs: int, t: int):
    """The compiled kernel's own plan: (q_tile, splits, shared memory bytes,
    threads) a block, or None for a shape it does not take."""
    out = (ctypes.c_int * 4)()
    if _lib().paged_attn_plan(b, c, hq, hkv, d, bs, t, out) != 0:
        return None
    return tuple(out)


def card_max_blocks(b, c, hq, hkv, d, bs, t, quantized, q_tile, splits) -> int:
    """Blocks of a plan the card keeps resident at once, or -1."""
    return _lib().paged_attn_max_blocks(b, c, hq, hkv, d, bs, t, int(quantized), q_tile, splits)


def paged_attn_kernel_call(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tables: torch.Tensor,
    q_pos: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    plan: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """q (B, C, Hq, D) f32; k/v one pool layer (n_phys, bs, Hkv, D), f32 or
    int8 with (n_phys, bs, Hkv, 1) f32 scales; tables (B, T) int32; q_pos
    (B, C) int32 -> (B, C, Hq, D) f32, by the (q_tile, splits) that
    ``autotune.get_paged_plan`` resolves (``attn_plan``, the compiled
    kernel's own rule, by default; ``plan`` overrides it: sweeps, splits up
    to 16, refused by the launcher where the kernel does not take it).
    Launches on PyTorch's current stream; raises on a CPU tensor, a shape
    the kernel does not take or a failed launch; adds one to
    ``paged_attn_kernel_call.launches`` per launch."""
    b, c, hq, d = q.shape
    n_phys, bs, hkv, dk = k.shape
    quantized = k_scale is not None
    if (v_scale is not None) != quantized:
        raise ValueError("k_scale/v_scale come together")
    if d != dk or hq % hkv or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.dtype != torch.float32:
        raise TypeError(f"paged attention kernel takes float32 q, got {q.dtype}")
    want = torch.int8 if quantized else torch.float32
    if k.dtype != want or v.dtype != want:
        raise TypeError(f"pool dtype {k.dtype}/{v.dtype}, expected {want}")
    if quantized:
        for sc in (k_scale, v_scale):
            if sc.dtype != torch.float32 or tuple(sc.shape) != (n_phys, bs, hkv, 1):
                raise ValueError(f"scales must be (n_phys, bs, Hkv, 1) float32, got "
                                 f"{tuple(sc.shape)} {sc.dtype}")
    if tables.dim() != 2 or tables.shape[0] != b or tuple(q_pos.shape) != (b, c):
        raise ValueError(f"tables {tuple(tables.shape)} / q_pos {tuple(q_pos.shape)} "
                         f"do not match q {tuple(q.shape)}")
    operands = [q, k, v, tables, q_pos] + ([k_scale, v_scale] if quantized else [])
    if not all(t.is_cuda for t in operands):
        raise ValueError("paged_attn_kernel_call needs CUDA tensors")
    t_len = tables.shape[1]
    # raises for a shape the kernel does not take
    q_tile, splits = autotune.get_paged_plan(b, c, hq, hkv, d, bs, t_len, q.device.index, plan)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    tables = tables.to(torch.int32).contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    ks = k_scale.contiguous() if quantized else None
    vs = v_scale.contiguous() if quantized else None
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ks.data_ptr() if quantized else None, vs.data_ptr() if quantized else None,
            tables.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
            b, c, hq, hkv, d, bs, t_len, int(quantized))
    err = lib.paged_attn_launch_plan(*args, int(q_tile), int(splits), stream)
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA error {err}")
    paged_attn_kernel_call.launches += 1
    return out


paged_attn_kernel_call.launches = 0
