"""Seeded numpy inputs for the port's kernel tests (jax-free, so the
card-only tests can import them on a machine without JAX)."""
import numpy as np

__all__ = ["BNN_KERNEL_SHAPES", "H100_STREAM_BLOCKS", "LANE_FLUSH_ROWS", "PAGED_CASES",
           "QNN_KERNEL_SHAPES", "TRAIN_KERNEL_SHAPES", "bnn_case", "byte_lane_mismatches", "cac_case",
           "cac_train_case", "cac_train_dyadic_case", "cac_train_split_order_model", "paged_case",
           "paged_ids", "qnn_case", "to_words", "window_clear"]

HI = 0x80808080
# the streaming kernels' byte-lane flush: a thread counts at most 16 rows a
# chunk and a warp's four k-lanes are summed in byte lanes, so no lane holds
# more than 64 rows' mismatches before it is widened (csrc/stream_matmul.cuh)
LANE_FLUSH_ROWS = 64
# resident blocks of a streaming kernel by cluster size 1..8 that the
# occupancy query reported on an NVIDIA H100 80GB HBM3 (two blocks an SM)
H100_STREAM_BLOCKS = (264, 264, 237, 248, 235, 234, 224, 240)

# the training path's (K, N) projections at M = batch 4 x seq 128, and two
# ragged shapes that cut every tile edge
TRAIN_KERNEL_SHAPES = [(512, 960, 960), (512, 960, 320), (512, 960, 2560),
                       (512, 2560, 960), (37, 100, 130), (129, 968, 65)]

# the BNN kernels: a decode shape and the training path's four (K, N) at
# M = 512 (q/o, k/v, gate/up, down: every contraction split and both tile
# widths of the backward pair), then ragged M and N with K not a multiple of
# 32 (968, packed too) and not a multiple of 8 (100, unpacked only), and a
# ragged N at the down shape; the ragged shapes take the backward's 4-byte
# load route (N = 65, 130, 962), the last one with 160-column tiles
BNN_KERNEL_SHAPES = [(4, 960, 2560), (512, 960, 960), (512, 960, 320), (512, 960, 2560),
                     (512, 2560, 960), (129, 968, 65), (37, 100, 130), (512, 2560, 962)]


# kernel 10: the serve path's (K, N) projections at decode (M = 4), the
# draft's bucketed prefill (M = 16) and chunk prefill (M = 32), and ragged
# M, K, N (K = 99 and 100: rows of x not 4-byte aligned; N = 33, 65, 130:
# rows of w not aligned either)
QNN_KERNEL_SHAPES = [(4, 960, 2560), (32, 960, 320), (4, 2560, 960), (32, 960, 960),
                     (16, 960, 2560), (16, 2560, 960),
                     (37, 100, 130), (129, 968, 65), (5, 99, 33)]


def qnn_case(rng, m, k, n):
    """Kernel 10's operands: x int8 codes over the full -128..127, w int8 in
    -127..127 (both extremes present), w_scale float32 (N,) per-column
    scales with column 1 all zero in w and its scale at the 1e-12 floor."""
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    w = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    x.flat[:2] = (-128, 127)
    w.flat[:2] = (-127, 127)
    ws = rng.uniform(1e-3, 1e-2, size=(n,)).astype(np.float32)
    if n > 1:
        w[:, 1] = 0
        ws[1] = 1e-12
    return x, w, ws


def bnn_case(rng, m, k, n, nan=False):
    """BNN operands: x, g ~ N(0, 1) and w ~ N(0, 0.25), float32, with about
    2% of x and w set to exact +0.0, 2% to exact -0.0 (Sign gives +1 for
    both) and 1% to exact +-1 (inside the inclusive hard-tanh window); with
    ``nan`` one x is NaN (Sign gives -1)."""
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.5).astype(np.float32)
    for a in (x, w):
        u = rng.random(a.shape)
        a[u < 0.02] = 0.0
        a[(u >= 0.02) & (u < 0.04)] = -0.0
        edge = (u >= 0.04) & (u < 0.05)
        a[edge] = np.where(rng.random(int(edge.sum())) < 0.5, 1.0, -1.0)
    if nan:
        x[rng.integers(m), rng.integers(k)] = np.nan
    g = rng.normal(size=(m, n)).astype(np.float32)
    return x, w, g


def cac_case(rng, m, k, n):
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    tau = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    s = np.where(rng.random((k, n)) < 0.5, 1, -1).astype(np.int8)
    return x, tau, s


def cac_train_case(rng, m, k, n, scale=0.5):
    """Training CAC operands as the reference's kernel tests draw them:
    x, g ~ N(0, 1) and w, beta ~ N(0, scale^2), float32."""
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * scale).astype(np.float32)
    beta = (rng.normal(size=(k, n)) * scale).astype(np.float32)
    g = rng.normal(size=(m, n)).astype(np.float32)
    return x, w, beta, g


SPECIAL_VALUES = (0.0, -0.0, np.inf, -np.inf, np.nan)


def cac_train_dyadic_case(rng, m, k, n, sparse=False):
    """Training CAC operands on a dyadic grid, so that every product and sum
    of the forward and of the STE backward is exact in float32 (in any
    order) and many pre-activations are exactly 0 (Sign's tie) or exactly
    +-1 (the window's edges): x and g multiples of 1/4 in [-2, 2], w in
    {+-0.5, +-1, +-2}, beta = -x' w with x' from x's grid. Rows 1.. of x and
    columns 1.. of w take +0, -0, +inf, -inf, NaN in turn, and columns 2.. of
    beta all five. With ``sparse`` x and w take them at one element each
    (x[1 + i, i], w[i, 1 + i]): a non-finite x or w makes a whole row of dw
    or column of dx NaN (g 0 x, g 0 w outside the window), and the rest stays
    to compare."""
    x = (rng.integers(-8, 9, size=(m, k)) * 0.25).astype(np.float32)
    w = rng.choice(np.array([-2, -1, -0.5, 0.5, 1, 2], np.float32), size=(k, n))
    beta = -(rng.integers(-8, 9, size=(k, n)) * 0.25).astype(np.float32) * w
    g = (rng.integers(-8, 9, size=(m, n)) * 0.25).astype(np.float32)
    for i, v in enumerate(SPECIAL_VALUES):
        if 1 + i < m:
            x[1 + i, i % k if sparse else slice(None)] = v
        if 1 + i < n:
            w[i % k if sparse else slice(None), 1 + i] = v
        if 2 + i < n:
            beta[:, 2 + i] = v
    return x, w, beta.astype(np.float32), g


def window_clear(x, w, beta, eps=1e-4, rows=8):
    """Torch tensors x (M, K), w and beta (K, N) -> (dx_keep (M, K), dw_keep
    (K, N)): the gradient elements whose reduction touches no pre-activation
    within ``eps`` of the STE window edge |pre| = 1 (where a reassociated
    product may fall on either side), computed a few rows at a time."""
    import torch

    dx_keep = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    dw_keep = torch.ones(w.shape, dtype=torch.bool, device=x.device)
    for a in range(0, x.shape[0], rows):
        near = ((x[a:a + rows, :, None] * w[None] + beta[None]).abs() - 1.0).abs() <= eps
        dx_keep[a:a + rows] = ~near.any(dim=2)
        dw_keep &= ~near.any(dim=0)
    return dx_keep, dw_keep


def _fma(acc, a, b, keep):
    """fl32(a b + acc) where ``keep``, else acc: fma.rn.f32's one rounding,
    from a b exact in float64 (a second rounding could differ at a tie of
    the float64 sum; on the dyadic grid every sum is exact)."""
    import torch

    return torch.where(keep, (a.double() * b.double() + acc.double()).float(), acc)


def cac_train_split_order_model(x, w, beta, g, cluster):
    """The STE backward's sums in the order of the split kernels (3: dx, 4:
    dw and dbeta; kernel 5's order, csrc/cac_train.cu), in plain PyTorch
    float32 on the CPU: torch (M, K) x, (K, N) w and beta, (M, N) g ->
    (dx, dw, dbeta).

    The window is the plain version's |fl(fl(x w) + beta)| <= 1. dw and
    dbeta: over M ranges of 512 rows, each (k, n) sums two row groups apart,
    rows 16 p + (s ^ o) and 16 p + 8 + (s ^ o) for p in order and s = 0..7,
    o the octet of n in a 64-column frame (at kernel 4's 32-column tiles too:
    tile t's lane h has o = 4 (t & 1) + h / 2), each term one fma, both
    groups from 0; at a range's end its sum is group 0 + group 1, and dw is
    the earlier ranges' dw + that sum (NaN in a k column where x holds a
    non-finite value). dx: per 64-column tile and
    row, each of 8 lanes sums its 8 columns (fma, from 0), the lanes meet in
    the butterfly ((P_r + P_r^1) + (P_r^2 + P_r^3)) + ((P_r^4 + P_r^5) +
    (P_r^6 + P_r^7)), r the row's index in its group of 8, which is added
    to the row's sum, then NaN where the tile's w row holds a non-finite
    value; the ``cluster`` ranks take the tiles [q T / C, (q + 1) T / C) and
    their sums are added in rank order."""
    import torch

    m, k = x.shape
    n = w.shape[1]
    inside = (x[:, :, None] * w[None] + beta[None]).abs() <= 1.0  # (M, K, N)
    cols = torch.arange(n)
    octet = (cols % 64) // 8
    dw = torch.zeros(k, n)
    db = torch.zeros(k, n)
    for base in range(0, m, 512):
        end = min(m, base + 512)
        sums = [[torch.zeros(k, n), torch.zeros(k, n)], [torch.zeros(k, n), torch.zeros(k, n)]]
        for p in range(base, end, 16):
            for s in range(8):
                for half in (0, 1):
                    rows = p + 8 * half + (s ^ octet)
                    ok = rows < end
                    r = rows.clamp(max=m - 1)
                    gv = torch.where(ok, g[r, cols], 0.0)[None]  # (1, N)
                    keep = inside[r, :, cols].T & ok[None]  # (K, N)
                    sw, sb = sums[half]
                    sums[half] = [_fma(sw, gv.expand(k, n), x[r].T, keep),
                                  torch.where(keep, sb + gv, sb)]
        part_w, part_b = sums[0][0] + sums[1][0], sums[0][1] + sums[1][1]
        dw, db = (part_w, part_b) if base == 0 else (dw + part_w, db + part_b)
        bad = ~torch.isfinite(x[:end]).all(dim=0)
        dw = torch.where(bad[:, None], torch.nan, dw)
    tiles = -(-n // 64)
    lane = torch.arange(m) % 8
    ranks = []
    for q in range(cluster):
        acc = torch.zeros(m, k)
        for t in range(q * tiles // cluster, (q + 1) * tiles // cluster):
            part = []
            for h in range(8):
                ph = torch.zeros(m, k)
                for j in range(8):
                    c = 64 * t + 8 * h + j
                    if c < n:
                        ph = _fma(ph, g[:, c][:, None].expand(m, k), w[:, c][None].expand(m, k),
                                  inside[:, :, c])
                part.append(ph)
            p = torch.stack(part)  # (8 lanes, M, K)
            at = lambda c: p[lane ^ c, torch.arange(m)]
            tile = ((at(0) + at(1)) + (at(2) + at(3))) + ((at(4) + at(5)) + (at(6) + at(7)))
            cols_t = slice(64 * t, min(n, 64 * t + 64))
            poison = torch.where(torch.isfinite(w[:, cols_t]).all(dim=1), 0.0, torch.nan)
            acc = (acc + tile) + poison[None]
        ranks.append(acc)
    dx = ranks[0]
    for r in ranks[1:]:
        dx = dx + r
    return dx, dw, db


def paged_case(rng, b, c, hq, hkv, d, bs, t, quantized, positions=None):
    """Shuffled physical pool, each row's table naming t distinct blocks,
    query positions ending inside a partial last block. ``positions``: None
    draws them at random; "tail" ends every row's queries in the table's
    last block (every rank of the kernel's cluster live, ranks walking
    several blocks when t > 8); "head" starts every row's chunk at position 0
    (its first bs queries see block 0 alone, so every other rank has nothing
    unmasked for them); "zero" puts row 0's decode query at position 0."""
    n_phys = b * t + 3
    q = rng.normal(size=(b, c, hq, d)).astype(np.float32)
    tables = rng.permutation(n_phys)[: b * t].reshape(b, t).astype(np.int32)
    if c == 1:
        q_pos = rng.integers(0, t * bs, size=(b, 1)).astype(np.int32)
    else:
        start = rng.integers(0, t * bs - c, size=(b,))
        q_pos = (start[:, None] + np.arange(c)[None]).astype(np.int32)
    if positions == "tail":
        last = rng.integers((t - 1) * bs, t * bs, size=(b,))
        q_pos = (last[:, None] - (c - 1) + np.arange(c)[None]).astype(np.int32)
    elif positions == "head":
        q_pos = np.repeat(np.arange(c, dtype=np.int32)[None], b, axis=0)
    elif positions == "zero":
        q_pos[0] = 0
    elif positions is not None:
        raise ValueError(f"positions {positions!r}")
    if quantized:
        k = rng.integers(-127, 128, size=(n_phys, bs, hkv, d)).astype(np.int8)
        v = rng.integers(-127, 128, size=(n_phys, bs, hkv, d)).astype(np.int8)
        ks = rng.uniform(1e-3, 2e-2, size=(n_phys, bs, hkv, 1)).astype(np.float32)
        vs = rng.uniform(1e-3, 2e-2, size=(n_phys, bs, hkv, 1)).astype(np.float32)
    else:
        k = rng.normal(size=(n_phys, bs, hkv, d)).astype(np.float32)
        v = rng.normal(size=(n_phys, bs, hkv, d)).astype(np.float32)
        ks = vs = None
    return q, k, v, tables, q_pos, ks, vs


# (b, c, hq, hkv, d, bs, t, quantized, positions) for ``paged_case``; the
# kernel splits each row's table over min(t, 8) ranks of a cluster
PAGED_CASES = [
    (2, 1, 6, 2, 16, 8, 4, False, None),  # GQA decode
    (3, 1, 6, 3, 16, 8, 5, True, None),   # int8 decode
    (2, 8, 6, 2, 16, 8, 4, False, None),  # GQA chunk (C=8)
    (2, 8, 4, 4, 16, 8, 4, True, None),   # int8 chunk, MHA
    (4, 4, 6, 2, 16, 8, 4, False, None),  # speculative verify window (B=4, C=4)
    (4, 4, 6, 2, 16, 8, 4, True, None),   # int8 verify window
    (2, 1, 6, 2, 16, 8, 11, False, "tail"),  # T = 11: ranks 0-2 walk two blocks
    (3, 1, 6, 2, 16, 8, 20, True, "tail"),   # int8, T = 20: ranks 0-3 walk three
    (2, 6, 6, 2, 16, 8, 20, False, "tail"),  # a chunk at T = 20
    (1, 8, 6, 2, 16, 2, 8, False, "head"),   # chunk from 0, block 2: queries 0-1 see rank 0 only
    (2, 8, 4, 4, 16, 4, 6, True, "head"),    # the same, int8, MHA, block 4
    (3, 1, 6, 3, 16, 8, 5, False, "zero"),   # decode, row 0 at position 0
]


def paged_ids(cases=PAGED_CASES):
    """Test ids of PAGED_CASES: the eight shape fields joined by "-" (as
    pytest names them), then the positions where they are not random."""
    return ["-".join(str(f) for f in case[:8]) + (f"-{case[8]}" if case[8] else "")
            for case in cases]


def to_words(b):
    """Torch uint8 or int8 (..., N) -> int64 (..., ceil(N / 4)) 32-bit words
    of four byte lanes, column 4 c + i in byte i (the kernels' little-endian
    uint32 view of 16-byte row loads); N is zero-padded to a multiple of 4."""
    import torch

    b = b.to(torch.uint8).to(torch.int64)
    pad = -b.shape[-1] % 4
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(b.shape[:-1] + (-1, 4))
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def byte_lane_mismatches(mis, n, flush_rows=LANE_FLUSH_ROWS):
    """The streaming kernels' count, modelled in plain PyTorch: ``mis``
    int64 (M, K, W) words whose bit 7 of each byte lane is a mismatch bit
    (other bits anything), reduced as the kernels do: ``(mis & 0x80808080)
    >> 7`` added into 32-bit words of byte-lane counters over runs of
    ``flush_rows`` consecutive rows (a lane that passes 255 carries into the
    next one, and the top lane out of the word, as in uint32 arithmetic),
    each run's lanes then widened into int32 sums. -> int64 (M, n)
    mismatch counts."""
    import torch

    lanes = (mis & HI) >> 7
    m, k, w = lanes.shape
    total = torch.zeros((m, w, 4), dtype=torch.int64)
    for a in range(0, k, flush_rows):
        packed = lanes[:, a:a + flush_rows].sum(dim=1) & 0xFFFFFFFF  # uint32 wrap
        total += torch.stack([(packed >> (8 * i)) & 0xFF for i in range(4)], dim=-1)
    return total.reshape(m, 4 * w)[:, :n]
