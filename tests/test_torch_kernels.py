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
from _torch_cases import (H100_STREAM_BLOCKS, LANE_FLUSH_ROWS, PAGED_CASES,
                          byte_lane_mismatches, cac_case, paged_case, to_words)

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.paged_attn import paged_attn_kernel_call as jax_paged_attn
from repro_torch.core.backend import pack_signs
from repro_torch.kernels import ops, ref
from repro_torch.kernels import cac_matmul as cac
from repro_torch.kernels.cac_matmul import cac_matmul_kernel_call, cac_matmul_plain


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


@pytest.mark.parametrize("b,c,hq,hkv,d,bs,t,quantized", PAGED_CASES)
def test_paged_attention_plain_matches_reference(b, c, hq, hkv, d, bs, t, quantized):
    """The port's paged attention (CPU -> plain gather oracle) against the
    JAX fused kernel (interpret mode) and the JAX gather oracle."""
    rng = np.random.default_rng(b * 100 + c * 10 + hq)
    q, k, v, tables, q_pos, ks, vs = paged_case(rng, b, c, hq, hkv, d, bs, t, quantized)
    got = ops.paged_attention(_t(q), _t(k), _t(v), _t(tables), _t(q_pos),
                              k_scale=_t(ks), v_scale=_t(vs)).numpy()
    want_kernel = jax_paged_attn(_j(q), _j(k), _j(v), _j(tables), _j(q_pos),
                                 k_scale=_j(ks), v_scale=_j(vs), interpret=True)
    want_ref = jref.paged_attention_ref(_j(q), _j(k), _j(v), _j(tables), _j(q_pos), _j(ks), _j(vs))
    np.testing.assert_allclose(got, np.asarray(want_kernel), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(want_ref), atol=2e-5, rtol=2e-5)


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
