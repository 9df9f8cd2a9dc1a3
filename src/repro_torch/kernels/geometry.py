"""Launch geometry of every plan path: what the launchers of ``csrc/*.cu``
configure for a plan, and which of it they refuse.

``launches(path, shape, plan)`` rebuilds, from a plan (``autotune``'s
paths and plan tuples), each launch the plan makes: entry function and
the template arguments that pick it, grid, cluster and whether the
launcher sets ``cudaFuncAttributeNonPortableClusterSizeAllowed``,
threads, dynamic shared memory, the axes the grid tiles, the split axis,
the template's tile choices and the TMA maps. ``launch_errors(launch)``
checks one launch against the launcher's limits and the H100's
(``repro_torch.hwsim``). Both ``autotune.plan_error`` (which plans the
cache, the overrides and the measured search take) and the kernel
contracts (``analysis.kernel_contracts``, KCV002-004) read this one copy;
the tiles, limits and plan rules come from the kernel modules (imported
inside the functions: the kernel modules import ``autotune``, which
imports this module).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.hwsim import DEVICE_TERMS, KERNEL_SMEM_BUDGET

__all__ = ["COUNT_LIMIT", "GRID_YZ_MAX", "PAGED_ATTN_PATH", "launch_errors", "launches",
           "plan_error", "shape_error", "tma_errors"]

H100 = DEVICE_TERMS["h100_sxm"]
PAGED_ATTN_PATH = "paged_attn"
GRID_YZ_MAX = 65535
COUNT_LIMIT = 1 << 24  # exact float32 counts of K terms: K < 2^24
THREADS = 256
# the stream template's op (its first template argument) by path and weights
STREAM_OP = {"hw_fwd": 0, "bnn_float32": 1, "bnn_int8": 2, "bnn_packed": 3}
TRAIN_FWD_SMEM = 55296  # kernel 2's dynamic shared memory (csrc/cac_train.cu)
QNN_TILE_BN, QNN_TILE_BK = 64, 64  # kernel 10's tile route (csrc/qnn_matmul.cu)
DW_COLUMNS = (4, 8)  # kernel 4's columns a thread: 32- or 64-column tiles


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def train_bwd_smem(m: int, rows_pass: int, nt: int, with_dx: bool) -> int:
    """Dynamic shared memory of kernels 5, 3 (nt 8, 16-row passes) and 4
    (nt 8 or 4, 32-row passes): two stages of x and g, the handover sums,
    and with dx the rows of dx a block sums (``range_rows``)."""
    bn, xs = 8 * nt, 40
    gs = bn + 4 if nt == 8 else bn
    rows = min(_cdiv(m, rows_pass) * rows_pass, 512)
    stage = rows_pass * xs + rows_pass * gs
    return 4 * (2 * stage + 4 * nt * 128 + (rows * xs if with_dx else 0))


def product_smem(bn: int) -> int:
    """The product template's dynamic shared memory (``BwdSmem::BYTES``)."""
    from . import bnn_matmul as bnn

    return (1024 + 4 * (bn * bnn.BWD_STAGE * 2 + bnn.BWD_TILE_ROWS * bnn.BWD_STAGE * 4)
            + 8 * 4)


def _stream(op, m, k, n, plan, stem="stream_kernel", mts=None):
    """The streaming template (kernels 1, 6 at small M, 7, and kernel 10's
    stream route): 128-column blocks, row tiles of ``mt``, K's 8-row groups
    split over a cluster."""
    from . import cac_matmul as cac

    mts = cac.STREAM_MT if mts is None else mts
    mt, splits, per = plan
    groups = _cdiv(k, cac.STREAM_GROUP)
    bn = cac.STREAM_BN
    targs = {0: op, 2: mt} if stem == "stream_kernel" else {1: mt}
    return dict(entry=stem, targs=targs, grid=(_cdiv(n, bn), _cdiv(m, mt), splits),
                cluster=splits, nonportable=False, threads=THREADS, smem=0,
                tiles=[("row tile mt", mt, tuple(mts))], count_k=k,
                axes=[("n", n, bn, _cdiv(n, bn)), ("m", m, mt, _cdiv(m, mt))],
                split=("k groups", groups, per, splits),
                packed_k=k if op in (0, 3) else None)


def _product(mode, m, k, n, plan, w_name="w"):
    """Kernel 6's tensor-core route (mode 2) or kernels 8 (1) / 9 (0) in the
    product's convention: rows (m, or n for dw), contraction t, output
    columns k; TMA maps where the launcher takes them (N and K multiples of
    4, which also keeps the strides whole 16-byte units)."""
    from . import bnn_matmul as bnn

    bn, splits, per = plan
    bm, tk = bnn.BWD_TILE_ROWS, bnn.BWD_STAGE
    if mode == bnn.FWD_MODE:  # g := x (m, k), the +-1 side sign(w)^T, contraction k
        rows, t, cols, g_shape = m, k, n, (m, k)
        vec = k % 4 == 0 and n % 4 == 0
    else:
        rows, t, cols = (m if mode == 1 else n), (n if mode == 1 else m), k
        g_shape, vec = (m, n), n % 4 == 0 and k % 4 == 0
    tp = _cdiv(t, 8) * 8
    tma = []
    if vec:
        tma = [dict(name="g", rows=g_shape[0], cols=g_shape[1], ld=g_shape[1], elem=4,
                    box_rows=bm if mode else tk, box_cols=32),
               dict(name=f"sign({w_name})", rows=cols, cols=tp, ld=tp, elem=2, box_rows=bn,
                    box_cols=tk)]
    return dict(entry="bnn_bwd_kernel", targs={0: mode, 2: bn},
                grid=(_cdiv(cols, bn), _cdiv(rows, bm), splits), cluster=splits,
                nonportable=False, threads=THREADS, smem=product_smem(bn),
                tiles=[("product tile width", bn, tuple(bnn.BWD_TILE_COLS))],
                count_k=k if mode == bnn.FWD_MODE else None,
                axes=[("cols", cols, bn, _cdiv(cols, bn)), ("rows", rows, bm, _cdiv(rows, bm))],
                split=("contraction", t, per, splits), tma=tma, stage=tk)


_SIGN_PASS = dict(entry="bnn_sign_kernel", targs={}, grid=None)


def shape_error(path: str, shape: tuple) -> Optional[str]:
    """None where ``path``'s kernels take ``shape`` at all; else why not."""
    from . import paged_attn as pa

    if path == PAGED_ATTN_PATH:
        b, c, hq, hkv, d, bs, t = shape
        if min(b, c, hq, hkv, d, bs, t) <= 0 or hq % hkv or d > pa.MAX_D or bs > pa.MAX_BS:
            return f"shape {shape} is not one the kernel takes"
        return None
    if min(shape) <= 0:
        return f"shape {shape} is empty"
    return None


def launches(path: str, shape: tuple, plan, *, w_dtype: str = "float32",
             want_dx: Optional[bool] = None) -> List[dict]:
    """The launches a plan of ``path`` makes at ``shape`` ((m, k, n), or
    (b, c, hq, hkv, d, bs, t) for paged attention), as its launcher
    configures them. ``bnn_bwd`` takes both halves ``{"dx": ..., "dw":
    ...}``, or one half with ``want_dx``."""
    from . import bnn_matmul as bnn
    from . import cac_matmul as cac
    from . import paged_attn as pa

    if path == PAGED_ATTN_PATH:
        b, c, hq, hkv, d, bs, t = shape
        q_tile, splits = plan
        g = hq // hkv if hkv and hq % hkv == 0 else 1
        q_tiles = _cdiv(c, q_tile)
        return [dict(entry="paged_attn_kernel", targs={1: pa.dims_per_lane(d)},
                     grid=(b, hkv, q_tiles * splits), cluster=splits, nonportable=True,
                     threads=32 * min(pa.MAX_WARPS, min(q_tile, c) * g),
                     smem=pa.attn_smem_bytes(q_tile, g, d, bs, t, splits),
                     tiles=[("q_tile", q_tile, range(1, pa.MAX_QTILE + 1)),
                            ("query vectors of 8 warps' registers", q_tile * g,
                             range(1, pa.MAX_WARPS * pa.qmax(d) + 1))],
                     axes=[("query tokens", c, q_tile, q_tiles)],
                     split=("table blocks", t, 1, splits), ranks_stride=True)]
    m, k, n = shape
    if path == "hw_fwd":
        return [_stream(STREAM_OP["hw_fwd"], m, k, n, plan)]
    if path == "bnn_packed":
        return [_stream(STREAM_OP["bnn_packed"], m, k, n, plan, mts=(bnn.PACKED_MT,))]
    if path == "train_fwd":
        splits, per = plan
        bm, bn = cac.TRAIN_FWD_TILE
        slices = _cdiv(k, cac.TRAIN_FWD_SLICE)
        return [dict(entry="cac_train_fwd_kernel", targs={},
                     grid=(_cdiv(n, bn), _cdiv(m, bm), splits), cluster=splits,
                     nonportable=False, threads=THREADS, smem=TRAIN_FWD_SMEM,
                     tiles=[("slices a split (the launcher's own cut)", per,
                             (_cdiv(slices, splits),))], count_k=k,
                     axes=[("n", n, bn, _cdiv(n, bn)), ("m", m, bm, _cdiv(m, bm))],
                     split=("k slices", slices, per, splits))]
    if path == "train_bwd":  # kernels 5 and 3 at one cluster size
        bk, bn = cac.TRAIN_BWD_TILE
        return [dict(entry=entry, targs={}, grid=(plan, _cdiv(k, bk), 1), cluster=plan,
                     nonportable=True, threads=THREADS, smem=train_bwd_smem(m, 16, 8, True),
                     axes=[("k", k, bk, _cdiv(k, bk))],
                     split=("n tiles", _cdiv(n, bn), 1, plan), ranks_stride=True)
                for entry in ("cac_train_bwd_fused_kernel", "cac_train_bwd_dx_kernel")]
    if path == "train_bwd_dw":
        nt, parts = plan
        bk = cac.TRAIN_BWD_TILE[0]
        return [dict(entry="cac_train_bwd_dw_kernel", targs={1: nt},
                     grid=(parts, _cdiv(k, bk), 1), cluster=1, nonportable=False,
                     threads=THREADS, smem=train_bwd_smem(m, 32, nt, False),
                     tiles=[("columns a thread nt", nt, DW_COLUMNS)],
                     axes=[("k", k, bk, _cdiv(k, bk))],
                     split=("n tiles", _cdiv(n, 8 * nt), 1, parts), ranks_stride=True)]
    if path == "bnn":
        if plan[0] == "stream":
            return [_stream(STREAM_OP[f"bnn_{w_dtype}"], m, k, n, plan[1:])]
        return [_SIGN_PASS, _product(bnn.FWD_MODE, m, k, n, plan[1:])]
    if path == "bnn_bwd":
        halves = plan if isinstance(plan, dict) else {("dx" if want_dx else "dw"): plan}
        out = []
        for half, p in sorted(halves.items()):
            out += [_SIGN_PASS, _product(1 if half == "dx" else 0, m, k, n, p,
                                         "w" if half == "dx" else "x")]
        return out
    if path == "qnn8":
        if plan[0] == "stream":
            return [_stream(None, m, k, n, plan[1:], stem="qnn_stream_kernel")]
        # the tile route cuts its own grid: 16-, 32- or 64-row tiles, K split
        # toward two blocks an SM
        bm = 16 if m <= 16 else 32 if m <= 32 else 64
        bn, bk = QNN_TILE_BN, QNN_TILE_BK
        gn, gm = _cdiv(n, bn), _cdiv(m, bm)
        parts = min(max(1, _cdiv(2 * H100["sms"], gn * gm)), _cdiv(k, bk))
        kps = _cdiv(_cdiv(k, parts), bk) * bk
        parts = _cdiv(k, kps)
        return [dict(entry="qnn_kernel", targs={0: bm}, grid=(gn, gm, parts), cluster=1,
                     nonportable=False, threads=THREADS, smem=0,
                     axes=[("n", n, bn, gn), ("m", m, bm, gm)], split=("k", k, kps, parts))]
    raise ValueError(f"unknown path {path!r}")


def tma_errors(tmap: dict) -> List[Tuple[str, str, str, Dict]]:
    """One TMA map: global stride a multiple of 16 bytes, each box dimension
    at most 256, and the inner box at most 128 bytes (the 128-byte swizzle)."""
    out = []
    stride = tmap["ld"] * tmap["elem"]
    if stride % 16:
        out.append(("KCV002", f"TMA map {tmap['name']}: global stride {stride} B is not a "
                    "multiple of 16 bytes",
                    "take the cp.async route for such a shape (the launchers' VEC test)",
                    dict(stride=stride)))
    for dim in ("box_rows", "box_cols"):
        if not 1 <= tmap[dim] <= 256:
            out.append(("KCV002", f"TMA map {tmap['name']}: {dim}={tmap[dim]} outside 1..256",
                        "cut the box", {dim: tmap[dim]}))
    if tmap["box_cols"] * tmap["elem"] > 128:
        out.append(("KCV002", f"TMA map {tmap['name']}: inner box "
                    f"{tmap['box_cols'] * tmap['elem']} B passes the 128-byte swizzle",
                    "narrow the inner box", {}))
    return out


def launch_errors(launch: dict, *, static_smem: int = 0,
                  smem_budget: int = KERNEL_SMEM_BUDGET) -> List[Tuple[str, str, str, Dict]]:
    """(code, message, hint, extra) of every limit one launch breaks:
    KCV002 the template's tile choices, exact counts, the cluster (8, or
    16 with the non-portable attribute), grid y and z, a split that covers
    its units exactly once with none empty (or one rank a unit), whole
    stages, packed K in whole bytes, the TMA maps; KCV003 the grid's last
    tile inside its operand on every axis; KCV004 static plus dynamic
    shared memory within ``smem_budget``."""
    out: List[Tuple[str, str, str, Dict]] = []
    total = static_smem + launch.get("smem", 0)
    if launch.get("grid") is not None:
        for name, value, allowed in launch.get("tiles", ()):
            if value not in allowed:
                shown = (f"{allowed.start}..{allowed.stop - 1}" if isinstance(allowed, range)
                         else str(tuple(allowed)))
                out.append(("KCV002", f"{name} = {value} is not one the launcher takes "
                            f"({shown})", "take a tile the template instantiates",
                            dict(tile=name, value=value)))
        if launch.get("count_k") is not None and launch["count_k"] >= COUNT_LIMIT:
            out.append(("KCV002", f"K = {launch['count_k']} >= 2^24: float32 counts are no "
                        "longer exact", "split K across launches", {}))
        grid, cluster = launch["grid"], launch["cluster"]
        limit = H100["cluster_nonportable"] if launch["nonportable"] else H100["cluster_portable"]
        if not 1 <= cluster <= limit:
            out.append(("KCV002", f"cluster of {cluster} blocks outside 1..{limit}"
                        + ("" if launch["nonportable"] else " (the launcher does not set "
                           "cudaFuncAttributeNonPortableClusterSizeAllowed)"),
                        "cut the plan's cluster", dict(cluster=cluster, limit=limit)))
        for axis, size in (("y", grid[1]), ("z", grid[2])):
            if not 1 <= size <= GRID_YZ_MAX:
                out.append(("KCV002", f"grid {axis} = {size} outside 1..{GRID_YZ_MAX}",
                            "move the axis to grid x or cut it", dict(axis=axis, size=size)))
        units_name, units, per, splits = launch["split"]
        if launch.get("ranks_stride"):  # rank r takes units r, r + splits, ...
            if not 1 <= splits <= units:
                out.append(("KCV002", f"{splits} ranks for {units} {units_name}: a rank with "
                            "nothing to do", "at most one rank per unit",
                            dict(units=units, splits=splits)))
        elif per < 1 or splits * per < units or (splits - 1) * per >= units:
            out.append(("KCV002", f"{splits} splits of {per} do not cover {units} {units_name} "
                        "exactly once (an empty or a missing split)",
                        "per = ceil(units / splits), no empty split",
                        dict(units=units, per=per, splits=splits)))
        if launch.get("stage") and per % launch["stage"]:
            out.append(("KCV002", f"split of {per} {units_name} is not whole "
                        f"{launch['stage']}-step stages", "round the split to stages", {}))
        if launch.get("packed_k") is not None and launch["packed_k"] % 8:
            out.append(("KCV002", f"packed K = {launch['packed_k']} is not whole bytes",
                        "pad K to a multiple of 8 before packing", {}))
        for tmap in launch.get("tma", ()):
            out += tma_errors(tmap)
        for axis, extent, tile, count in launch["axes"]:
            if count < 1 or (count - 1) * tile >= extent or count * tile < extent:
                out.append(("KCV003", f"{axis}: {count} tiles of {tile} against {extent}: the "
                            "last tile starts outside its operand or the grid stops short",
                            "grid = ceil(extent / tile)",
                            dict(axis=axis, count=count, tile=tile, extent=extent)))
    if total > smem_budget:
        out.append(("KCV004", f"{launch['entry']}: {total} B of shared memory (static "
                    f"{static_smem} + dynamic {launch.get('smem', 0)}) past the budget "
                    f"{smem_budget} B", "shrink the plan's tile or its stages",
                    dict(smem=total, budget=smem_budget)))
    return out


def plan_error(path: str, shape: tuple, plan) -> Optional[str]:
    """None where the launcher of ``path``'s kernels accepts ``plan`` at
    ``shape``; else the first limit it breaks (``launch_errors`` of each of
    its launches, which the launchers answer with
    ``cudaErrorInvalidValue``). For ``bnn_bwd`` the plan is both halves."""
    reason = shape_error(path, shape)
    if reason is not None:
        return reason
    values = [v for half in (plan.values() if isinstance(plan, dict) else [plan])
              for v in (half if isinstance(half, (tuple, list)) else (half,))]
    bad = [v for v in values if not isinstance(v, str) and (isinstance(v, bool) or
                                                              not isinstance(v, int) or v < 1)]
    if bad:
        return f"plan {plan!r}: {bad[0]!r} is not a positive int"
    for launch in launches(path, shape, plan):
        errors = launch_errors(launch)
        if errors:
            return errors[0][1]
    return None
