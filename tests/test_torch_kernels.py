"""PyTorch port vs the JAX reference: the two ported kernels' plain
versions and their wrappers, on the CPU.

The JAX side runs the Pallas kernels as the reference's own tests run them
(``interpret=True``). CAC sums are held bit-exact; paged attention at
2e-5, the reference's own bound for the fused kernel against its gather
oracle (online vs full softmax reorders float32 sums). The CUDA kernels
themselves run only on a GPU: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold them against these plain versions on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import functools

from _torch_cases import (H100_STREAM_BLOCKS, LANE_FLUSH_ROWS, PAGED_CASES,
                          byte_lane_mismatches, cac_case, paged_case, paged_ids, to_words)

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.paged_attn import paged_attn_kernel_call as jax_paged_attn
from repro_torch.core.backend import pack_signs
from repro_torch.kernels import ops, ref
from repro_torch.kernels import cac_matmul as cac
from repro_torch.kernels import paged_attn as pa
from repro_torch.kernels.cac_matmul import cac_matmul_kernel_call, cac_matmul_plain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the tier-1 run
    holds several test processes at once, and torch's default of a thread
    a core in each of them oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("m,k,n", [(4, 64, 40), (9, 24, 7), (1, 8, 1), (33, 40, 130)])
def test_cac_plain_matches_reference_kernel(m, k, n):
    """Ragged M, N and K' (K' % 8 == 0): the port's plain CAC (packed s)
    equals the JAX Pallas kernel in interpret mode, bit for bit."""
    rng = np.random.default_rng(m * 7 + n)
    x, tau, s = cac_case(rng, m, k, n)
    sp = pack_signs(torch.from_numpy(s))
    got = cac_matmul_plain(torch.from_numpy(x), torch.from_numpy(tau), sp)
    want = jops.cac_matmul(jnp.asarray(x, jnp.float32), jnp.asarray(tau, jnp.float32),
                           jnp.asarray(s, jnp.float32), interpret=True)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ref.cac_matmul_ref(torch.from_numpy(x), torch.from_numpy(tau),
                           torch.from_numpy(s)).numpy(),
        np.asarray(jref.cac_matmul_ref(jnp.asarray(x), jnp.asarray(tau), jnp.asarray(s))))


def test_cac_wrapper_flattens_and_takes_plain_on_cpu():
    rng = np.random.default_rng(11)
    x, tau, s = cac_case(rng, 6, 16, 5)
    sp = pack_signs(torch.from_numpy(s))
    before = cac_matmul_kernel_call.launches
    y = ops.cac_matmul(torch.from_numpy(x).reshape(2, 3, 16), torch.from_numpy(tau), sp)
    assert y.shape == (2, 3, 5)
    np.testing.assert_array_equal(
        y.reshape(6, 5).numpy(), cac_matmul_plain(torch.from_numpy(x), torch.from_numpy(tau),
                                                  sp).numpy())
    assert cac_matmul_kernel_call.launches == before  # no kernel launch on the CPU
    with pytest.raises(ValueError):
        cac_matmul_kernel_call(torch.from_numpy(x), torch.from_numpy(tau), sp)
    with pytest.raises(ValueError):  # K' not a multiple of 8
        cac_matmul_plain(torch.from_numpy(x[:, :12]), torch.from_numpy(tau[:12]), sp)


HI = 0x80808080


def cac_byte_lane_model(x, tau, s_packed, flush_rows=LANE_FLUSH_ROWS):
    """Kernel 1's arithmetic in plain PyTorch, word for word: x (M, K) and
    tau (K, N) int8, s_packed (K/8, N) uint8 -> (M, N) float32. With xw the
    x byte in all four lanes, t = (xw | 0x80808080) - (tau & 0x7F7F7F7F)
    (no borrow between lanes), f = (~xw & tau) | (~(xw ^ tau) & t) holds
    [x >= tau] in bit 7 of each lane; the s bit of row 8r + j is shifted to
    bit 7, and (f ^ s) & 0x80808080 marks the terms that are -1; the marks
    are counted in byte lanes (``byte_lane_mismatches``) and y = K - 2 *
    mismatches."""
    m, k = x.shape
    n = tau.shape[1]
    xw = (x.to(torch.uint8).to(torch.int64) * 0x01010101)[:, :, None]  # (M, K, 1)
    tw = to_words(tau)[None]  # (1, K, W)
    t = ((xw | HI) - (tw & 0x7F7F7F7F)) & 0xFFFFFFFF
    f = ((~xw & tw) | (~(xw ^ tw) & t)) & 0xFFFFFFFF
    sw = to_words(s_packed)  # (K/8, W): byte i of word c is column 4 c + i's plane
    j = torch.arange(k) % 8
    sb = ((sw.repeat_interleave(8, dim=0) << (7 - j)[:, None]) & 0xFFFFFFFF)[None]
    mis = byte_lane_mismatches(f ^ sb, n, flush_rows)
    return (k - 2 * mis).to(torch.float32)


# ragged M, N and K (K = 8; K not a multiple of 16; K past 255 rows, so a
# lane's count passes a byte before its flush), x and tau at -128 and 127
CAC_MODEL_SHAPES = [(4, 8, 5), (3, 24, 130), (1, 40, 7), (5, 200, 33), (2, 1000, 20),
                    (4, 968, 16)]


@pytest.mark.parametrize("m,k,n", CAC_MODEL_SHAPES)
def test_cac_byte_lane_model_matches_reference_kernel(m, k, n):
    """The byte-lane compare-and-count of the streaming kernel, modelled in
    plain PyTorch, equals the JAX Pallas kernel (interpret mode) and the
    port's plain version bit for bit, extremes and a saturated row
    included."""
    rng = np.random.default_rng(13 * m + k + n)
    x, tau, s = cac_case(rng, m, k, n)
    x.flat[:2], tau.flat[:2] = (-128, 127), (127, -128)
    x[-1, :3], tau[:3, -1] = -128, 127  # -128 >= 127 is false: a -s term at each
    sp = pack_signs(torch.from_numpy(s))
    got = cac_byte_lane_model(torch.from_numpy(x), torch.from_numpy(tau), sp)
    want = jops.cac_matmul(jnp.asarray(x, jnp.float32), jnp.asarray(tau, jnp.float32),
                           jnp.asarray(s, jnp.float32), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), cac_matmul_plain(torch.from_numpy(x), torch.from_numpy(tau), sp).numpy())


@pytest.mark.parametrize("flush_rows,exact", [(LANE_FLUSH_ROWS, True), (255, True),
                                              (256, False)])
def test_cac_byte_lane_counts_need_their_flush(flush_rows, exact):
    """With every term a mismatch (x = -128 < tau = 127, s = +1) over 512
    rows, the byte-lane counters are exact when they are widened at most
    every 255 rows (the kernel widens every 64) and wrong when a lane must
    hold 256."""
    k = 512
    x = torch.full((2, k), -128, dtype=torch.int8)
    tau = torch.full((k, 6), 127, dtype=torch.int8)
    sp = pack_signs(torch.ones((k, 6), dtype=torch.int8))
    got = cac_byte_lane_model(x, tau, sp, flush_rows)
    assert torch.equal(cac_matmul_plain(x, tau, sp), torch.full((2, 6), -float(k)))
    assert torch.equal(got, cac_matmul_plain(x, tau, sp)) == exact


SERVE_KN = [(960, 960), (960, 320), (960, 2560), (2560, 960)]


def _h100_stream_blocks(mt, splits):
    return H100_STREAM_BLOCKS[splits - 1]


@pytest.mark.parametrize("m", [1, 4, 5, 16, 17, 32, 33])
@pytest.mark.parametrize("k,n", SERVE_KN + [(8, 1), (24, 130), (2568, 2560)])
def test_stream_plan_covers_k_once(m, k, n):
    """The streaming plan, with the H100's occupancy and with the CPU
    default: 4-row tiles at decode (M <= 4) and 8-row ones otherwise, 1-8
    splits of whole 8-row groups that cover K exactly once, none empty; at
    the serve path's shapes every block resident in one wave, on at least
    half the SMs where the tiles allow it."""
    groups = -(-k // 8)
    for max_blocks in (None, _h100_stream_blocks):
        mt, splits, per = cac.stream_plan(m, k, n, max_blocks)
        assert mt == (4 if m <= 4 else 8)
        assert 1 <= splits <= cac.STREAM_MAX_SPLITS and per >= 1
        assert (splits - 1) * per < groups <= splits * per
        if max_blocks is not None and m in (4, 32) and (k, n) in SERVE_KN:
            tiles = -(-m // mt) * -(-n // cac.STREAM_BN)
            blocks = tiles * splits
            assert blocks <= H100_STREAM_BLOCKS[splits - 1]
            assert blocks >= min(cac.STREAM_SMS // 2, tiles * min(8, groups))


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


PAGED_ARGS = "b,c,hq,hkv,d,bs,t,quantized,positions"


@functools.lru_cache(maxsize=None)
def _paged_reference(case):
    """A PAGED_CASES case's operands (numpy) and the JAX fused kernel's
    (interpret mode) and gather oracle's outputs, made once per case."""
    b, c, hq, hkv, d, bs, t, quantized, positions = case
    rng = np.random.default_rng(b * 100 + c * 10 + hq)
    ops_np = paged_case(rng, b, c, hq, hkv, d, bs, t, quantized, positions)
    q, k, v, tables, q_pos, ks, vs = ops_np
    want_kernel = jax_paged_attn(_j(q), _j(k), _j(v), _j(tables), _j(q_pos),
                                 k_scale=_j(ks), v_scale=_j(vs), interpret=True)
    want_ref = jref.paged_attention_ref(_j(q), _j(k), _j(v), _j(tables), _j(q_pos), _j(ks), _j(vs))
    return ops_np, np.asarray(want_kernel), np.asarray(want_ref)


@pytest.mark.parametrize(PAGED_ARGS, PAGED_CASES, ids=paged_ids())
def test_paged_attention_plain_matches_reference(b, c, hq, hkv, d, bs, t, quantized, positions):
    """The port's paged attention (CPU -> plain gather oracle) against the
    JAX fused kernel (interpret mode) and the JAX gather oracle."""
    ops_np, want_kernel, want_ref = _paged_reference((b, c, hq, hkv, d, bs, t, quantized,
                                                      positions))
    q, k, v, tables, q_pos, ks, vs = (_t(a) for a in ops_np)
    got = ops.paged_attention(q, k, v, tables, q_pos, k_scale=ks, v_scale=vs).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, want_ref, atol=2e-5, rtol=2e-5)


def _rank_partials(q, k, v, tables, q_pos, k_scale, v_scale, row, c0, splits, q_tile,
                   masked_rule=True):
    """The live ranks' (m, l, acc) of one row's tile of ``q_tile`` query
    tokens from ``c0``, as kernel 11 forms them: the tile's live blocks are
    those up to its largest q_pos (whole-block skip); rank r of ``splits``
    walks blocks r, r + splits, ... with an online softmax from (m, l, acc)
    = (-1e30, 0, 0), p = 0 at a masked position (``masked_rule``; without it
    a rank that sees nothing unmasked for a query sums exp(-1e30 + 1e30) = 1
    over its positions). float32 throughout."""
    d = q.shape[3]
    bs, hkv = k.shape[1], k.shape[2]
    g = q.shape[2] // hkv
    t = tables.shape[1]
    neg = torch.tensor(-1e30)
    root_d = torch.sqrt(torch.tensor(float(d)))
    qt = q[row, c0:c0 + q_tile].float()  # (nc, Hq, D)
    qp = q_pos[row, c0:c0 + q_tile].long()
    nblk = min(t, max(int(qp.max()), 0) // bs + 1)
    parts = []
    for r in range(min(splits, nblk)):
        m = torch.full(qt.shape[:2], -1e30)
        l = torch.zeros(qt.shape[:2])
        acc = torch.zeros(qt.shape)
        for j in range(r, nblk, splits):
            phys = int(tables[row, j])
            kb, vb = k[phys].float(), v[phys].float()  # (bs, Hkv, D)
            if k_scale is not None:
                kb, vb = kb * k_scale[phys], vb * v_scale[phys]
            kb, vb = kb.repeat_interleave(g, dim=1), vb.repeat_interleave(g, dim=1)
            s = torch.einsum("chd,thd->cht", qt, kb) / root_d
            ok = ((j * bs + torch.arange(bs))[None] <= qp[:, None])[:, None, :]
            s = torch.where(ok, s, neg)
            m_new = torch.maximum(m, s.max(-1).values)
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            if masked_rule:
                p = torch.where(ok, p, torch.zeros(()))
            l = alpha * l + p.sum(-1)
            acc = alpha[..., None] * acc + torch.einsum("cht,thd->chd", p, vb)
            m = m_new
        parts.append((m, l, acc))
    return parts


def paged_attn_split_model(q, k, v, tables, q_pos, k_scale, v_scale, splits, q_tile,
                           masked_rule=True):
    """Kernel 11's order in plain PyTorch: each row's tiles of ``q_tile``
    query tokens, each tile's table split over ``splits`` ranks
    (``_rank_partials``), and rank 0's merge of the live ranks in rank
    order: m* = max m_r, a_r = exp(m_r - m*), l = sum a_r l_r, acc = sum a_r
    acc_r, out = acc / l. Shapes as ``ref.paged_attention_ref``."""
    b, c = q.shape[:2]
    out = torch.empty(q.shape)
    for row in range(b):
        for c0 in range(0, c, q_tile):
            parts = _rank_partials(q, k, v, tables, q_pos, k_scale, v_scale, row, c0, splits,
                                   q_tile, masked_rule)
            m_star = torch.stack([pm for pm, _, _ in parts]).max(0).values
            l_sum, acc_sum = 0.0, 0.0
            for pm, pl, pacc in parts:  # rank order
                a = torch.exp(pm - m_star)
                l_sum = l_sum + a * pl
                acc_sum = acc_sum + a[..., None] * pacc
            out[row, c0:c0 + q_tile] = acc_sum / l_sum[..., None]
    return out


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize(PAGED_ARGS, PAGED_CASES, ids=paged_ids())
def test_paged_attn_split_model_matches_reference(b, c, hq, hkv, d, bs, t, quantized, positions,
                                                  splits):
    """The kernel's split order (strided table blocks a rank, the masked-rank
    rule, the rank-order merge) within 2e-5 of the JAX fused kernel
    (interpret mode) and the JAX gather oracle: at 8 ranks with the
    kernel's own query tile, at 1, 2 and 3 with tiles of 4, 3 and 2 tokens
    (a chunk's last tile short)."""
    ops_np, want_kernel, want_ref = _paged_reference((b, c, hq, hkv, d, bs, t, quantized,
                                                      positions))
    q, k, v, tables, q_pos, ks, vs = (_t(a) for a in ops_np)
    q_tile = {1: 4, 2: 3, 3: 2}.get(splits) or pa.attn_plan(b, c, hq, hkv, d, bs, t)[0]
    got = paged_attn_split_model(q, k, v, tables, q_pos, ks, vs, splits, q_tile).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, want_ref, atol=2e-5, rtol=2e-5)


HEAD_CASES = [cs for cs in PAGED_CASES if cs[8] == "head"]


@pytest.mark.parametrize("case", HEAD_CASES, ids=paged_ids(HEAD_CASES))
def test_paged_attn_split_model_masked_rank_rule(case):
    """The "head" cases reach the trap the split opens: queries whose every
    position lies in block 0 see nothing unmasked in ranks 1... There the
    rule gives l_r = 0 and acc_r = 0 exactly; summing exp(s - m) instead
    gives l_r = the rank's positions (exp(-1e30 + 1e30) = 1 each). The merge
    weighs such a rank by exp(-1e30 - m*) = 0 either way, so both orders
    stay within 2e-5 of the oracle: the rule and the weight each guard it."""
    ops_np, _, want_ref = _paged_reference(case)
    q, k, v, tables, q_pos, ks, vs = (_t(a) for a in ops_np)
    b, c, bs = case[0], case[1], case[5]
    splits = pa.attn_plan(*case[:7])[1]
    blind = q_pos[0] < bs  # queries that see block 0 alone
    assert blind.any() and not blind.all()
    for rule in (True, False):
        parts = _rank_partials(q, k, v, tables, q_pos, ks, vs, 0, 0, splits, c, rule)
        assert len(parts) > 1
        for m, l, acc in parts[1:]:
            assert torch.all(m[blind] == -1e30)
            if rule:
                assert torch.all(l[blind] == 0) and torch.all(acc[blind] == 0)
            else:
                assert torch.all(l[blind] == bs)
        got = paged_attn_split_model(q, k, v, tables, q_pos, ks, vs, splits, c, rule).numpy()
        np.testing.assert_allclose(got, want_ref, atol=2e-5, rtol=2e-5)


# (B, C, T) at smollm-360m's heads (Hq 15, Hkv 5, D 64) and block 16: decode,
# the speculative verify and a prefill chunk at max_len 128 (T = 8), and
# decode and a chunk at T = 64 (max_len 1024)
SMOKE_ATTN = [(4, 1, 8), (4, 4, 8), (1, 32, 8), (4, 1, 64), (1, 32, 64)]
H100_SMS = 132


def _resident_blocks_per_sm(smem, threads, regs=128):
    """What an H100 SM holds of a block: 228 KB of shared memory (1 KB a
    block reserved), 2,048 threads, 64 K registers, 32 blocks."""
    return min((233472) // (smem + 1024), 2048 // threads, 65536 // (regs * threads), 32)


@pytest.mark.parametrize("b,c,t", SMOKE_ATTN)
def test_attn_plan_fits_the_card(b, c, t):
    """The plan at the smoke shapes: a cluster of min(T, 8) (of min(T, 16)
    past T = 8 where that grid is one wave), the query vectors of a tile
    within 8 warps' registers, the slots fitting two blocks an SM, and the
    whole grid resident on the H100 at once."""
    hq, hkv, d, bs = 15, 5, 64, 16
    q_tile, splits = pa.attn_plan(b, c, hq, hkv, d, bs, t)
    g = hq // hkv
    assert splits == min(t, 8) or (t > 8 and splits == min(t, 16))
    assert 1 <= q_tile <= min(c, pa.QTILE)
    assert q_tile * g <= pa.MAX_WARPS * pa.qmax(d)
    smem = pa.attn_smem_bytes(q_tile, g, d, bs, t, splits)
    threads = 32 * min(pa.MAX_WARPS, q_tile * g)
    assert smem <= pa.SMEM_BUDGET and _resident_blocks_per_sm(smem, threads) >= 2
    blocks = b * hkv * -(-c // q_tile) * splits
    assert 8 * blocks <= 7 * H100_SMS * _resident_blocks_per_sm(smem, threads)  # clusters' 7/8
    if c > 1:  # a chunk's tiles even: sizes differ by at most one
        sizes = [min(q_tile, c - c0) for c0 in range(0, c, q_tile)]
        assert max(sizes) - min(sizes) <= 1 or c % q_tile == 0


def test_attn_plan_shrinks_the_tile_and_refuses_what_it_cannot_take():
    """One token a tile where that grid is one wave of the card, else up to
    4; a large GQA group at a wide head takes fewer tokens a tile (its query
    vectors must fit the warps' registers) or fewer where the slots would
    keep two blocks from an SM; a long table takes 16 ranks where that grid
    is one wave; D > 256, a block past 128 positions or a group past the
    registers of 8 warps is refused before any launch."""
    assert pa.attn_plan(64, 32, 32, 4, 128, 16, 2) == (2, 2)  # G = 8: 2 query vectors a warp
    assert pa.attn_plan(64, 32, 64, 4, 128, 16, 8) == (1, 8)  # G = 16
    assert pa.attn_plan(1, 4, 32, 4, 256, 64, 8) == (1, 8)    # 201 KB: one block an SM
    assert pa.attn_plan(64, 5, 6, 2, 16, 8, 3) == (5, 3)      # T < 8: a cluster of T
    assert pa.attn_plan(64, 12, 6, 2, 16, 8, 3) == (6, 3)     # 12 tokens: two tiles of 6
    assert pa.attn_plan(2, 5, 6, 2, 16, 8, 3) == (1, 3)       # one-token tiles: one wave
    assert pa.attn_plan(2, 4, 15, 5, 64, 16, 8) == (1, 8)     # 320 one-token blocks: one wave
    assert pa.attn_plan(4, 4, 15, 5, 64, 16, 8) == (4, 8)     # the verify: 640 would not be
    assert pa.attn_plan(1, 32, 15, 5, 64, 16, 8) == (8, 8)    # a chunk: 1,280 would not be
    assert pa.attn_plan(4, 1, 15, 5, 64, 16, 64) == (1, 16)   # 320 small blocks: one wave
    assert pa.attn_plan(1, 32, 15, 5, 64, 16, 64) == (8, 8)   # 16 ranks' slots: not one tile
    for shape in [(1, 1, 2, 1, 320, 16, 8), (1, 1, 2, 1, 64, 256, 8), (1, 1, 64, 4, 256, 16, 8)]:
        with pytest.raises(ValueError):
            pa.attn_plan(*shape)


def test_kernel_routes_and_counters():
    assert sorted(ops.KERNEL_ROUTES) == ["bnn", "bnn_packed", "bnn_train", "cac_hw",
                                         "cac_train", "paged_attn", "qnn8"]
    assert ops.kernel_route("cac_hw") is ops.cac_matmul
    assert ops.kernel_route("cac_train") is ops.cac_train_matmul
    assert ops.kernel_route("bnn") is ops.bnn_matmul
    assert ops.kernel_route("bnn_packed") is ops.bnn_matmul_packed
    assert ops.kernel_route("bnn_train") is ops.bnn_train_matmul
    assert ops.kernel_route("qnn8") is ops.qnn_matmul
    with pytest.raises(KeyError):
        ops.kernel_route("nope")
    ops.reset_launches()
    assert ops.launch_counts() == {
        "bnn": 0, "bnn_bwd_dw": 0, "bnn_bwd_dx": 0, "bnn_packed": 0,
        "cac_hw": 0, "cac_train_bwd_dw": 0, "cac_train_bwd_dx": 0, "cac_train_bwd_fused": 0,
        "cac_train_fwd": 0, "paged_attn": 0, "qnn8": 0}
