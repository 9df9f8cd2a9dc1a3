"""PyTorch port vs the JAX reference: the BNN slice (serve and train in
``bnn`` mode) on the CPU, through the plain versions of kernels 6-9.

The same numpy inputs go through both packages; the reference reaches its
Pallas kernels as its own tests run them (interpret mode). Tolerances:

- the sign products (kernels 6 and 7) are exact integer sums on both
  sides: bit-exact, with exact +0.0, -0.0 (Sign gives +1 for both) and NaN
  (-1) in the inputs;
- the SignSTE backward (kernels 8 and 9) within atol/rtol 1e-4 (the
  reference's own bound, ``tests/test_backend_registry.py``), here on every
  element: the hard-tanh masks read the operands themselves, so exact +-1
  (inside the inclusive window) mask alike on both sides and only the
  summation order differs;
- backend applies within 1e-6;
- SMOKE serve logits within 1e-4 with greedy tokens equal. The two
  packages compute the float parts (RMSNorm, RoPE, softmax) with other
  kernels, which leaves a few float32 ulps; a projection input within those
  ulps of 0 may take the other Sign, and an int8 pool code within them of a
  half-way point the other code. ``held_signs`` holds both to the
  reference's at such genuine ties only (|x| <= 1e-5; codes as
  ``test_torch_lm.held_codes`` does) and fails on any other difference;
- engine tokens token for token.
"""
import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cases import (H100_STREAM_BLOCKS, LANE_FLUSH_ROWS, bnn_case, byte_lane_mismatches,
                          to_words)
from test_torch_lm import _hold, port_cfg

import repro.core.backend as jax_backend
import repro.nn.attention as jax_attention
import repro_torch.nn.attention as port_attention
from repro.configs import get_smoke as jax_get_smoke
from repro.core import bnn as jbnn
from repro.core.convert import tree_to_serve as jax_tree_to_serve
from repro.core.ste import sign_ste as jax_sign_ste
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build_model as jax_build_model
from repro.nn.module import unbox
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.core import bnn as tbnn
from repro_torch.core.backend import LinearSpec, get_backend, pack_signs
from repro_torch.core.convert import from_reference, tree_to_serve
from repro_torch.core.ste import sign
from repro_torch.kernels import bnn_matmul as tk
from repro_torch.kernels import cac_matmul
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine

# BNN_SHAPES of tests/test_backend_registry.py, then ragged M and N with K
# not a multiple of 8 (100, unpacked only) and of 32 (968)
SHAPES = [(8, 16, 8), (33, 100, 17), (64, 512, 128), (5, 40, 24), (9, 968, 33)]
SIGN_TIE = 1e-5  # |x| at or below which the two packages may split a Sign
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the tier-1 run
    holds several test processes at once, and torch's default of a thread
    a core in each of them oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


# ---------------------------------------------------------------------------
# kernels 6-9: plain versions against the reference's kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_sign_products_bit_exact_against_reference(m, k, n):
    """Kernel 6's plain version (float32 and int8 w) against the reference's
    ``ops.bnn_matmul`` (Pallas, interpret mode) and ``ref.bnn_matmul_ref``;
    kernel 7's (packed planes, K % 8 == 0) against ``ops.bnn_matmul_packed``."""
    x, w, _ = bnn_case(np.random.default_rng(m * 31 + k), m, k, n, nan=True)
    want = np.asarray(jref.bnn_matmul_ref(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_array_equal(
        np.asarray(jops.bnn_matmul(jnp.asarray(x), jnp.asarray(w), interpret=True)), want)
    wb = sign(_t(w)).to(torch.int8)
    for got in (tk.bnn_matmul_plain(_t(x), _t(w)), tk.bnn_matmul_plain(_t(x), wb),
                ops.bnn_matmul(_t(x), wb), ref.bnn_matmul_ref(_t(x), _t(w))):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    if k % 8 == 0:
        jwp = jax_backend.pack_signs(jax_backend.sign(jnp.asarray(w)).astype(jnp.int8))
        wp = pack_signs(wb)
        np.testing.assert_array_equal(wp.numpy(), np.asarray(jwp))
        np.testing.assert_array_equal(
            np.asarray(jops.bnn_matmul_packed(jnp.asarray(x), jwp, interpret=True)), want)
        np.testing.assert_array_equal(tk.bnn_packed_matmul_plain(_t(x), wp).numpy(), want)
        np.testing.assert_array_equal(ops.bnn_matmul_packed(_t(x), wp).numpy(), want)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_bnn_train_matmul_vjp_matches_reference(m, k, n):
    """``ops.bnn_train_matmul`` forward and VJP (the plain kernels 6, 8, 9)
    against ``jax.vjp`` of the reference's Pallas op and of the XLA
    ``sign_ste(x) @ sign_ste(w)``."""
    x, w, g = bnn_case(np.random.default_rng(m + 7 * n), m, k, n)
    x[0, 0], x[-1, -1] = 1.0, -1.0  # on the window's edges
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    y = ops.bnn_train_matmul(tx, tw)
    y.backward(_t(g))
    for fn in (lambda a, b: jops.bnn_train_matmul(a, b, interpret=True),
               lambda a, b: jax_sign_ste(a) @ jax_sign_ste(b)):
        jy, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
        jdx, jdw = vjp(jnp.asarray(g))
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=ATOL, rtol=ATOL)
    # the inclusive window: an exact |x| = 1 passes the gradient, |x| > 1 not
    assert tx.grad[0, 0] != 0 and tx.grad[-1, -1] != 0
    assert np.all(tx.grad.numpy()[np.abs(x) > 1.0] == 0)


def sign_byte_lane_model(x, w, flush_rows=LANE_FLUSH_ROWS):
    """Kernel 6's small-M arithmetic in plain PyTorch, word for word: x
    float32 (M, K), w float32 or int8 (K, N) -> (M, N) float32. Each side's
    negative bit is formed as !(v >= 0) (so +0 and -0 give +1 and NaN -1)
    into bit 7 of a byte lane; the mismatch bits (xn ^ wn) & 0x80808080 are
    counted in byte lanes (``byte_lane_mismatches``), and y = K - 2 *
    mismatches."""
    k = x.shape[1]
    xn = torch.where(x >= 0, 0, 0x80808080).to(torch.int64)[:, :, None]  # (M, K, 1)
    wn = to_words(torch.where(w >= 0, 0, 0x80).to(torch.uint8))[None]  # (1, K, W)
    mis = byte_lane_mismatches(xn ^ wn, w.shape[1], flush_rows)
    return (k - 2 * mis).to(torch.float32)


@pytest.mark.parametrize("m,k,n", SHAPES + [(4, 1000, 20), (2, 8, 3)])
def test_sign_byte_lane_model_bit_exact_against_reference(m, k, n):
    """The streaming kernel's sign-mismatch count, modelled in plain
    PyTorch, equals the reference's Pallas kernel (interpret mode) and the
    plain version bit for bit: float32 w with exact +0.0, -0.0 and NaN in x
    and w, and int8 +-1 w; K not a multiple of 8, 16 or 32, and K past 255
    rows."""
    x, w, _ = bnn_case(np.random.default_rng(m + 11 * k + n), m, k, n, nan=True)
    w[0, 0], w[-1, -1] = -0.0, np.nan
    want = np.asarray(jops.bnn_matmul(jnp.asarray(x), jnp.asarray(w), interpret=True))
    wb = sign(_t(w)).to(torch.int8)
    for wt in (_t(w), wb):
        got = sign_byte_lane_model(_t(x), wt)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), tk.bnn_matmul_plain(_t(x), wt).numpy())
    np.testing.assert_array_equal(
        np.asarray(jops.bnn_matmul(jnp.asarray(x), jnp.asarray(wb.numpy()), interpret=True)),
        want)


def packed_byte_lane_model(x, wp, flush_rows=LANE_FLUSH_ROWS):
    """Kernel 7's arithmetic in plain PyTorch, word for word: x float32 (M,
    K), wp uint8 planes (K/8, N) -> (M, N) float32. x's positive bit [x >=
    0] (so +0 and -0 give +1 and NaN -1) is staged in bit 7 of every byte
    lane; row 8 r + j's plane bits are byte r's words shifted left by 7 - j,
    which moves bit j of each lane to its bit 7; the two differ exactly where
    the term is -1, and the mismatch bits are counted in byte lanes
    (``byte_lane_mismatches``), y = K - 2 * mismatches."""
    k = x.shape[1]
    xp = torch.where(x >= 0, 0x80808080, 0).to(torch.int64)[:, :, None]  # (M, K, 1)
    planes = to_words(wp).repeat_interleave(8, dim=0)  # (K, W): row k holds byte k // 8
    shift = (7 - torch.arange(k) % 8)[:, None]
    sb = (planes << shift) & 0xFFFFFFFF  # the plane bit of row k in bit 7 of each lane
    mis = byte_lane_mismatches(xp ^ sb[None], wp.shape[1], flush_rows)
    return (k - 2 * mis).to(torch.float32)


# the reference's kernel module (``repro.kernels`` re-exports a function of
# the same name)
jbnn_kernels = importlib.import_module("repro.kernels.bnn_matmul")
# shapes at which the reference's packed kernel runs without padding (K a
# multiple of its 512-row block or below it, N of its 256 columns or below)
PACKED_SHAPES = [(4, 512, 256), (32, 1024, 64), (5, 64, 24), (9, 256, 33), (2, 8, 3)]


@pytest.mark.parametrize("m,k,n", PACKED_SHAPES)
def test_packed_byte_lane_model_bit_exact_against_reference(m, k, n):
    """Kernel 7's sign-mismatch count on the planes, modelled in plain
    PyTorch, equals the reference's Pallas kernel 7 (interpret mode, called
    where it needs no pad correction) and the plain version bit for bit,
    with exact +0.0, -0.0 and NaN in x; K past 255 rows."""
    x, w, _ = bnn_case(np.random.default_rng(m + 13 * k + n), m, k, n, nan=True)
    x[0, 0], x[-1, -1] = -0.0, 0.0
    wp = pack_signs(sign(_t(w)).to(torch.int8))
    got = packed_byte_lane_model(_t(x), wp)
    want = np.asarray(jbnn_kernels.bnn_packed_matmul_kernel_call(
        jnp.asarray(x), jnp.asarray(wp.numpy()), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tk.bnn_packed_matmul_plain(_t(x), wp).numpy())
    np.testing.assert_array_equal(got.numpy(), sign_byte_lane_model(_t(x), _t(w)).numpy())


# the serve path's and the training path's (K, N)
PATH_KN = [(960, 960), (960, 320), (960, 2560), (2560, 960)]


@pytest.mark.parametrize("m", [1, 4, 15, 16, 17, 31, 32, 33, 64, 512])
@pytest.mark.parametrize("w_dtype", [torch.int8, torch.float32], ids=["int8", "float32"])
def test_fwd_route_by_rows(m, w_dtype):
    """Kernel 6's route: the streaming template up to FWD_STREAM_MAX_M rows
    of the weight dtype (int8: decode M = 4, prefill buckets and chunks of
    16 and 32), the tensor cores above it (float32 at training M = 512);
    the thresholds' neighbours on either side; a forced route is taken as
    asked; each plan is the one its route's planner gives."""
    for k, n in PATH_KN + [(100, 130)]:
        plan = tk.fwd_plan(m, k, n, w_dtype)
        assert plan[0] == ("stream" if m <= tk.FWD_STREAM_MAX_M[w_dtype] else "tc")
        assert tk.fwd_plan(m, k, n, w_dtype, route="stream")[1:] == \
            cac_matmul.stream_plan(m, k, n)
        assert tk.fwd_plan(m, k, n, w_dtype, route="tc")[1:] == tk.bwd_plan(m, n, k, True)
    assert tk.FWD_STREAM_MAX_M[torch.int8] >= 32  # every unpacked serve M streams
    assert tk.FWD_STREAM_MAX_M[torch.float32] < 512  # the training M takes the tensor cores
    with pytest.raises(ValueError):
        tk.fwd_plan(m, 960, 960, w_dtype, route="nope")


@pytest.mark.parametrize("m", [1, 4, 5, 16, 17, 32, 33, 129])
def test_packed_plan_takes_four_row_tiles(m):
    """Kernel 7's plan (``stream_plan`` with ``PACKED_MT``), with the CPU
    default and the H100's occupancy: 4-row tiles at every M, and 1-8
    splits of whole 8-row groups that cover K exactly once, none empty; at
    the serve path's shapes every block resident in one wave."""
    assert tk.PACKED_MT == 4
    for k, n in PATH_KN + [(8, 3), (968, 65)]:
        groups = k // 8
        for max_blocks in (None, lambda mt, s: H100_STREAM_BLOCKS[s - 1]):
            mt, splits, per = cac_matmul.stream_plan(m, k, n, max_blocks, tk.PACKED_MT)
            assert mt == 4 and 1 <= splits <= cac_matmul.STREAM_MAX_SPLITS
            assert (splits - 1) * per < groups <= splits * per
            if max_blocks is not None and m <= 32 and (k, n) in PATH_KN:
                tiles = -(-m // 4) * -(-n // cac_matmul.STREAM_BN)
                assert tiles * splits <= H100_STREAM_BLOCKS[splits - 1]


@pytest.mark.parametrize("k,n", PATH_KN + [(100, 130), (968, 65)])
def test_fwd_tc_plan_covers_k_once(k, n):
    """The tensor-core route's plan at the training path's M = 512 (and a
    ragged M), with the H100's occupancy: 128-row tiles of 128 or 160
    columns, K cut into 1-8 ranges of whole 64-step stages, none empty."""
    for m in (512, 129):
        _, bn, splits, per = tk.fwd_plan(m, k, n, torch.float32, _h100_max_blocks)
        assert bn in tk.BWD_TILE_COLS and 1 <= splits <= tk.BWD_MAX_SPLITS
        assert per % tk.BWD_STAGE == 0
        assert (splits - 1) * per < k <= splits * per


def test_wrappers_take_plain_on_cpu_and_check_inputs():
    x, w, g = bnn_case(np.random.default_rng(3), 6, 16, 5)
    x, w, g = _t(x), _t(w), _t(g)
    wp = pack_signs(sign(w).to(torch.int8))
    before = ops.launch_counts()
    y = ops.bnn_matmul(x.reshape(2, 3, 16), w)
    assert y.shape == (2, 3, 5)
    np.testing.assert_array_equal(y.reshape(6, 5).numpy(), tk.bnn_matmul_plain(x, w).numpy())
    assert ops.bnn_matmul_packed(x.reshape(3, 2, 16), wp).shape == (3, 2, 5)
    assert ops.launch_counts() == before  # CPU: plain versions, no launch
    for call, args in ((tk.bnn_matmul_kernel_call, (x, w)),
                       (tk.bnn_packed_matmul_kernel_call, (x, wp)),
                       (tk.bnn_bwd_dx_call, (x, w, g)), (tk.bnn_bwd_dw_call, (x, w, g))):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call(*args)
    with pytest.raises(ValueError):  # K != 8 * packed rows
        tk.bnn_packed_matmul_plain(x[:, :8], wp)
    with pytest.raises(TypeError):
        tk.bnn_matmul_plain(x, w.double())
    with pytest.raises(TypeError):
        tk.bnn_bwd_dx_plain(x, sign(w).to(torch.int8), g)
    with pytest.raises(ValueError):
        tk.bnn_bwd_dw_plain(x, w, g[:, :4])


# ---------------------------------------------------------------------------
# kernels 8 and 9 on the card: a plain model of their arithmetic and plan
# ---------------------------------------------------------------------------

# resident blocks by cluster size 1..8 that bnn_bwd_max_blocks reported on an
# NVIDIA H100 80GB HBM3 (chip_smoke.py's bnn-kernels phase prints them), the
# same for both tile widths
H100_MAX_BLOCKS = dict(enumerate((132, 132, 117, 120, 110, 102, 105, 120), start=1))
BWD_PATH_SHAPES = [(512, 960, 960), (512, 960, 320), (512, 960, 2560), (512, 2560, 960)]


def _h100_max_blocks(bn, splits):
    return H100_MAX_BLOCKS[splits]


def _bf16_planes(g):
    """The kernels' split of float32 g into three bf16 planes (round to
    nearest even, as __floats2bfloat162_rn): g1 = bf16(g), g2 = bf16(g -
    g1), g3 = bf16(g - g1 - g2)."""
    g1 = g.to(torch.bfloat16).float()
    r = g - g1
    g2 = r.to(torch.bfloat16).float()
    return g1, g2, (r - g2).to(torch.bfloat16).float()


def _split_values(kind, rng):
    if kind == "normal":  # the operands of the kernel checks
        return bnn_case(rng, 64, 8, 96)[2].ravel()
    if kind == "zeros_ones":
        return np.array([0.0, -0.0, 1.0, -1.0, 0.5, -2.0, 3.0, 255.0], dtype=np.float32)
    mant = rng.uniform(1.0, 2.0, size=4096)
    sign_ = np.where(rng.random(4096) < 0.5, -1.0, 1.0)
    if kind == "large":  # up to just below bf16's overflow point, 3.3961776e38
        return (sign_ * mant * 2.0 ** rng.integers(100, 127, size=4096)).clip(
            -3.39e38, 3.39e38).astype(np.float32)
    # small normals whose residuals stay normal too
    return (sign_ * mant * 2.0 ** rng.integers(-100, -60, size=4096)).astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "zeros_ones", "large", "small"])
def test_bwd_bf16_planes_sum_back_to_g(kind):
    """The three bf16 planes of g sum back to g exactly in float32, so every
    (+-1 x plane) product on the tensor cores is exact (the sum of -0 is +0,
    the same value)."""
    g = torch.from_numpy(_split_values(kind, np.random.default_rng(17)))
    g1, g2, g3 = _bf16_planes(g)
    for plane in (g1, g2, g3):
        assert torch.equal(plane.to(torch.bfloat16).float(), plane)  # bf16 values
    assert torch.equal((g1 + g2) + g3, g)
    assert torch.isfinite(g3).all()


def _kernel_model(x, w, g, want_dx):
    """A plain model of kernels 8 and 9's numerics in float32: per split of
    the card's plan (``bwd_plan`` under the H100's cluster occupancy), the
    g1 plane's products summed in one accumulator and the g2 and g3 planes'
    in another, the split's partial hi + lo, the partials added in split
    order, then the hard-tanh mask of the output's own operand."""
    m, k = x.shape
    n = w.shape[1]
    _, splits, per = tk.bwd_plan(m, k, n, want_dx, _h100_max_blocks)
    sx, sw = tk._sgn(x), tk._sgn(w)
    g1, g2, g3 = _bf16_planes(g)
    total = None
    for s in range(splits):
        sl = slice(s * per, (s + 1) * per)
        if want_dx:  # contraction over n
            hi = g1[:, sl] @ sw[:, sl].T
            lo = torch.cat([g2[:, sl], g3[:, sl]], 1) @ torch.cat([sw[:, sl], sw[:, sl]], 1).T
        else:  # contraction over m
            hi = sx[sl].T @ g1[sl]
            lo = torch.cat([sx[sl], sx[sl]]).T @ torch.cat([g2[sl], g3[sl]])
        part = hi + lo
        total = part if total is None else total + part
    own = x if want_dx else w
    return torch.where(own.abs() <= 1.0, total, 0.0)


@pytest.mark.parametrize("want_dx", [True, False], ids=["dx", "dw"])
def test_bwd_plane_sums_meet_the_tolerance_at_gate_up(want_dx):
    """At the training path's gate/up shape (512, 960, 2560), the model of
    the kernels' plane-wise float32 sums is within atol = rtol = 1e-4 of the
    float64 plain version on every element (the bound the card is held
    to), and far inside it."""
    x, w, g = (torch.from_numpy(a) for a in bnn_case(np.random.default_rng(7), 512, 960, 2560))
    got = _kernel_model(x, w, g, want_dx)
    want = (tk.bnn_bwd_dx_plain if want_dx else tk.bnn_bwd_dw_plain)(x, w, g)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=ATOL)
    assert float(((got - want).abs() / (ATOL + ATOL * want.abs())).max()) < 0.5


@pytest.mark.parametrize("want_dx", [True, False], ids=["dx", "dw"])
@pytest.mark.parametrize("m,k,n", BWD_PATH_SHAPES + [(4, 960, 2560), (129, 968, 65),
                                                     (37, 100, 130), (512, 2560, 962)])
def test_bwd_plan_covers_the_contraction_once(m, k, n, want_dx):
    """Every plan, with the card's occupancy and with the CPU default, cuts
    the contraction into 1-8 non-empty ranges of whole 64-step stages that
    cover it exactly once; at the path's shapes the H100 plan keeps every
    block resident in one wave on at least half of the 132 SMs."""
    t = n if want_dx else m
    rows = m if want_dx else n
    for max_blocks in (None, _h100_max_blocks):
        bn, splits, per = tk.bwd_plan(m, k, n, want_dx, max_blocks)
        assert bn in tk.BWD_TILE_COLS and 1 <= splits <= tk.BWD_MAX_SPLITS
        assert per % tk.BWD_STAGE == 0
        covered = np.zeros(t, dtype=int)
        for s in range(splits):
            lo, hi = s * per, min(t, (s + 1) * per)
            assert hi > lo
            covered[lo:hi] += 1
        assert (covered == 1).all()
        if max_blocks is not None and (m, k, n) in BWD_PATH_SHAPES:
            blocks = -(-rows // tk.BWD_TILE_ROWS) * -(-k // bn) * splits
            assert tk.NUM_SMS // 2 <= blocks <= H100_MAX_BLOCKS[splits]


def test_core_bnn_matches_reference():
    rng = np.random.default_rng(4)
    x, w, _ = bnn_case(rng, 5, 24, 7)
    thresh = rng.integers(-3, 4, size=(7,)).astype(np.float32)
    for binarize_input in (True, False):
        for activation in (True, False):
            want = jbnn.bnn_linear_apply({"w": jnp.asarray(w), "thresh": jnp.asarray(thresh)},
                                         jnp.asarray(x), binarize_input=binarize_input,
                                         activation=activation)
            got = tbnn.bnn_linear_apply({"w": _t(w), "thresh": _t(thresh)}, _t(x),
                                        binarize_input=binarize_input, activation=activation)
            if binarize_input:  # integer sums: exact
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:  # float x @ +-1: summed in another order
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)
    xb = (rng.random((3, 40)) < 0.5).astype(np.int32)
    wb = (rng.random((40, 6)) < 0.5).astype(np.int32)
    got = tbnn.xnor_popcount_dot(_t(xb), _t(wb))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jbnn.xnor_popcount_dot(jnp.asarray(xb),
                                                                    jnp.asarray(wb))))
    # the hardware formulation is the +-1 product
    np.testing.assert_array_equal(got.numpy(), (2 * xb - 1) @ (2 * wb - 1))
    p = tbnn.bnn_linear_init(torch.Generator().manual_seed(0), 40, 6)
    assert p["w"].shape == (40, 6) and float(p["w"].abs().max()) <= 40**-0.5
    assert bool((p["thresh"] == 0).all())


# ---------------------------------------------------------------------------
# BnnBackend against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pack", [True, False])
def test_tree_to_serve_on_stacked_bnn_tree(pack):
    """``tree_to_serve`` and ``from_reference`` on a bnn tree with stacked
    (L, K, N) leaves: int8 signs or packed planes, bit for bit."""
    rng = np.random.default_rng(5)
    _, w, _ = bnn_case(rng, 1, 3 * 24, 10)
    tree = {"layers": {"q": {"w": w.reshape(3, 24, 10),
                             "gamma": rng.normal(size=(3, 10)).astype(np.float32)},
                       "ln": {"scale": np.ones((3, 24), np.float32)}}}
    jspec = jax_backend.LinearSpec(mode="bnn", pack_signs=pack)
    want = jax.tree_util.tree_map(np.asarray, jax_tree_to_serve(
        jax.tree_util.tree_map(jnp.asarray, tree), jspec))
    got = tree_to_serve(from_reference(tree), LinearSpec(mode="bnn", pack_signs=pack))
    q = got["layers"]["q"]
    assert set(q) == {"wb", "gamma"}
    assert q["wb"].dtype == (torch.uint8 if pack else torch.int8)
    assert tuple(q["wb"].shape) == ((3, 3, 10) if pack else (3, 24, 10))
    for leaf in ("wb", "gamma"):
        np.testing.assert_array_equal(q[leaf].numpy(), want["layers"]["q"][leaf])
    np.testing.assert_array_equal(got["layers"]["ln"]["scale"].numpy(), tree["layers"]["ln"]["scale"])
    # the reference's serve tree comes over as it is
    back = from_reference(want)
    assert torch.equal(back["layers"]["q"]["wb"], q["wb"])


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("impl", ["cvjp", "fused", "pallas"])
def test_bnn_apply_matches_reference(impl, pack):
    """``apply_train`` (value and gradients of x, w and gamma) and
    ``apply_serve`` against the reference's backend on each of its routes,
    with both output scalings and a non-trivial gamma."""
    rng = np.random.default_rng(6)
    x, w, _ = bnn_case(rng, 10, 24, 16)
    x = x.reshape(2, 5, 24)
    gamma = rng.uniform(0.5, 1.5, size=(16,)).astype(np.float32)
    r = rng.normal(size=(2, 5, 16)).astype(np.float32)
    jbe, tbe = jax_backend.get_backend("bnn"), get_backend("bnn")
    for out_scale in ("rsqrt_k", "none"):
        jspec = jax_backend.LinearSpec(mode="bnn", impl=impl, pack_signs=pack,
                                       out_scale=out_scale)
        tspec = LinearSpec(mode="bnn", impl=impl, pack_signs=pack, out_scale=out_scale)
        jp = {"w": jnp.asarray(w), "gamma": jnp.asarray(gamma)}

        def jloss(p, xx):
            return jnp.sum(jbe.apply_train(p, xx, jspec) * jnp.asarray(r))

        jy = jbe.apply_train(jp, jnp.asarray(x), jspec)
        jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
        tp = {k: _t(v).requires_grad_() for k, v in (("w", w), ("gamma", gamma))}
        tx = _t(x).requires_grad_()
        ty = tbe.apply_train(tp, tx, tspec)
        (ty * _t(r)).sum().backward()
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-6, rtol=1e-6)
        for key in ("w", "gamma"):
            np.testing.assert_allclose(tp[key].grad.numpy(), np.asarray(jg[key]), atol=1e-6,
                                       rtol=1e-6, err_msg=key)
        jserve = jbe.to_serve(jp, jspec)
        tserve = tbe.to_serve({"w": _t(w), "gamma": _t(gamma)}, tspec)
        for key in ("wb", "gamma"):
            np.testing.assert_array_equal(tserve[key].numpy(), np.asarray(jserve[key]))
        np.testing.assert_allclose(
            tbe.apply_serve(tserve, _t(x), tspec).numpy(),
            np.asarray(jbe.apply_serve(jserve, jnp.asarray(x), jspec)), atol=1e-6, rtol=1e-6)
    assert tbe.kernel_route(tspec, "train") == "bnn_train"
    assert tbe.kernel_route(tspec, "serve") == ("bnn_packed" if pack else "bnn")
    assert tbe.train_param_keys(tspec) == jbe.train_param_keys(jspec)
    init = tbe.init_serve(torch.Generator(), 24, 16, tspec, device="cpu")
    jinit = jax.tree_util.tree_map(np.asarray, unbox(
        jbe.init_serve(jax.random.PRNGKey(0), 24, 16, jspec, axes=(None, None))))
    for key in ("wb", "gamma"):
        np.testing.assert_array_equal(init[key].numpy(), jinit[key])


# ---------------------------------------------------------------------------
# the SMOKE model: paged serve logits, engine tokens, a train step
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def held_signs():
    """Hold the port's projection-input Signs and int8 K/V codes to the
    reference's at genuine ties. The reference sends ``x >= 0`` of every
    bnn projection input and every K/V code tensor it makes to the host, in
    call order; the port's ``ops.bnn_matmul``/``bnn_matmul_packed`` compare
    their input's Signs with them and take the reference's only where
    |x| <= SIGN_TIE (K/V codes through ``test_torch_lm._hold``). Yields
    ``taken(n_sign, n_kv)``, which checks after a step that the port took
    exactly the reference's tensors; ``stats["held"]`` counts held Signs."""
    jbe = jax_backend.get_backend("bnn")
    jax_kv, plain_kv = jax_attention._quantize_kv, port_attention._quantize_kv
    routes = {name: getattr(ops, name) for name in ("bnn_matmul", "bnn_matmul_packed")}
    queues, counts, stats = {"sign": [], "kv": []}, {"sign": 0, "kv": 0}, {"held": 0}

    def send(kind, v):
        jax.debug.callback(lambda c: queues[kind].append(np.asarray(c)), v, ordered=True)

    def take(kind):
        if not queues[kind]:
            jax.effects_barrier()
        counts[kind] += 1
        return queues[kind].pop(0)

    def j_apply_serve(params, x, spec, *, blocks=None):
        send("sign", x >= 0)
        return type(jbe).apply_serve(jbe, params, x, spec, blocks=blocks)

    def j_quantize_kv(x):
        q, scale = jax_kv(x)
        send("kv", q)
        return q, scale

    def hold(route):
        def held(x, w):
            want = torch.from_numpy(take("sign").copy()).reshape(x.shape)
            diff = (x >= 0) != want
            if bool(diff.any()):
                worst = float(x[diff].abs().max())
                assert worst <= SIGN_TIE, (
                    f"{int(diff.sum())} Signs differ, at |x| up to {worst:.3e} "
                    f"(a tie is within {SIGN_TIE})")
                stats["held"] += int(diff.sum())
                x = torch.where(diff, torch.where(want, 1.0, -1.0), x)
            return route(x, w)
        return held

    def t_quantize_kv(x):
        q, scale = plain_kv(x)
        return _hold(take("kv"), q, x.float() / scale, "K/V"), scale

    def taken(n_sign: int, n_kv: int) -> None:
        jax.effects_barrier()
        got = (len(queues["sign"]), len(queues["kv"]), counts["sign"], counts["kv"])
        assert got == (0, 0, n_sign, n_kv), got
        counts.update(sign=0, kv=0)

    jbe.apply_serve = j_apply_serve
    jax_attention._quantize_kv = j_quantize_kv
    port_attention._quantize_kv = t_quantize_kv
    for name, route in routes.items():
        setattr(ops, name, hold(route))
    try:
        yield taken, stats
    finally:
        del jbe.apply_serve  # back to the class's method
        jax_attention._quantize_kv = jax_kv
        port_attention._quantize_kv = plain_kv
        for name, route in routes.items():
            setattr(ops, name, route)


def _bnn_cfg(pack: bool, **kw):
    return jax_get_smoke("smollm-360m", compute_mode="bnn", remat=False, pack_signs=pack, **kw)


def _train_tree(jcfg, seed):
    return unbox(jax_build_model(jcfg, phase="train").init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("pack,quantized", [(True, False), (False, False), (True, True)])
def test_paged_logits_match_reference(pack, quantized):
    """``prefill_chunk`` (two chunks) then ``decode_paged`` (4 steps, a
    parked row) of the SMOKE bnn model, its serve tree converted by the
    reference and brought over, against the reference's: logits within 1e-4,
    greedy tokens and the live pool blocks equal."""
    jcfg = _bnn_cfg(pack)
    jparams = jax_tree_to_serve(_train_tree(jcfg, 3), jcfg.linear_spec())
    tparams = from_reference(jax.tree_util.tree_map(np.asarray, jparams))
    assert tparams["layers"]["attn"]["wq"]["wb"].dtype == (torch.uint8 if pack else torch.int8)
    japi = jax_build_model(jcfg, phase="serve")
    tapi = build_model(port_cfg(jcfg), phase="serve")
    n_sign, n_kv = 7 * jcfg.n_layers, (2 * jcfg.n_layers if quantized else 0)
    bs, chunk, n_phys = 8, 8, 9
    jpool = japi.init_cache(n_phys, bs, quantized=quantized)
    tpool = tapi.init_cache(n_phys, bs, quantized=quantized, device="cpu")
    prompt = np.random.RandomState(5).randint(0, jcfg.vocab, 13).astype(np.int32)
    table = np.array([[5, 2, 7, 0]], np.int32)

    def close(got, want, what):
        g, w = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=what)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1), err_msg=what)

    with held_signs() as (taken, stats):
        for start in (0, chunk):
            toks = np.zeros((1, chunk), np.int32)
            seg = prompt[start:start + chunk]
            toks[0, :len(seg)] = seg
            last = np.array([len(seg) - 1], np.int32)
            jl, jpool = japi.prefill_chunk(jparams, jnp.asarray(toks), jpool, jnp.asarray(table),
                                           jnp.asarray([start], jnp.int32), jnp.asarray(last))
            tl, tpool = tapi.prefill_chunk(tparams, _t(toks), tpool, _t(table),
                                           torch.tensor([start], dtype=torch.int32), _t(last))
            taken(n_sign, n_kv)
            close(tl, jl, f"prefill chunk at {start}")
        tables = np.array([[5, 2, 7, 0], [8, 8, 8, 8]], np.int32)
        tok = np.array([[int(np.asarray(jl).argmax())], [0]], np.int32)
        pos = np.array([13, 0], np.int32)
        for _ in range(4):
            jl, jpool = japi.decode_paged(jparams, jnp.asarray(tok), jpool, jnp.asarray(pos),
                                          jnp.asarray(tables))
            tl, tpool = tapi.decode_paged(tparams, _t(tok), tpool, _t(pos), _t(tables))
            taken(n_sign, n_kv)
            close(tl[:1], jl[:1], f"decode at {pos[0]}")
            tok = np.array([[int(np.asarray(jl)[0, -1].argmax())], [0]], np.int32)
            pos = pos + np.array([1, 0], np.int32)
    assert stats["held"] <= 2, stats  # a tie is rare: many would hide a fault
    for name in jpool:
        g = tpool[name][:, [5, 2, 7]].numpy().reshape(jcfg.n_layers, 24, -1)[:, :17]
        w = np.asarray(jpool[name])[:, [5, 2, 7]].reshape(jcfg.n_layers, 24, -1)[:, :17]
        if g.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("pack,quantized", [(True, False), (False, False), (True, True)])
def test_paged_engine_tokens_match_reference(pack, quantized):
    """``ServeEngine.from_trained`` on the same bnn train tree in both
    packages (paged engine, a shared-prefix hit, a block crossing, a queue
    longer than n_slots): tokens equal, token for token, with Signs and K/V
    codes held at genuine ties as in the logits test (at this seed the
    packed int8-pool drain meets one K/V code tie, and without the hold
    request 1 takes other tokens from its second on)."""
    jcfg = _bnn_cfg(pack)
    train = _train_tree(jcfg, 2)
    kw = dict(max_len=48, n_slots=3, kv_block_size=8, prefill_chunk=8, quantized_kv=quantized)
    rng = np.random.RandomState(3)
    shared = rng.randint(0, jcfg.vocab, 16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(0, jcfg.vocab, 3).astype(np.int32)]),
               np.concatenate([shared, rng.randint(0, jcfg.vocab, 5).astype(np.int32)]),
               rng.randint(0, jcfg.vocab, 6).astype(np.int32),
               rng.randint(0, jcfg.vocab, 11).astype(np.int32)]
    jeng = JaxServeEngine.from_trained(train, jcfg, engine="paged", **kw)
    teng = ServeEngine.from_trained(from_reference(jax.tree_util.tree_map(np.asarray, train)),
                                    port_cfg(jcfg), engine="paged", device="cpu", **kw)
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=7))
        teng.submit(Request(rid=i, prompt=p, max_new_tokens=7))
    with held_signs() as (taken, stats):
        jdone = {r.rid: r.output for r in jeng.run()}  # the reference goes first
        tdone = {r.rid: r.output for r in teng.run()}
        m = teng.metrics.summary()
        ticks = m["decode_steps"] + m["prefill_chunks"]
        taken(7 * jcfg.n_layers * ticks, 2 * jcfg.n_layers * ticks if quantized else 0)
    assert stats["held"] <= 2, stats
    assert sorted(tdone) == list(range(len(prompts)))
    for i in range(len(prompts)):
        np.testing.assert_array_equal(tdone[i], jdone[i], err_msg=f"request {i}")
    assert m["prefix_hit_tokens"] == 16


def test_launchers_in_bnn_mode(capsys):
    assert launch_serve.main(["--smoke", "--mode", "bnn", "--device", "cpu", "--requests", "3",
                              "--new-tokens", "3", "--max-len", "32", "--kv-block-size", "8",
                              "--prefill-chunk", "8"]) == 0
    out = capsys.readouterr().out
    assert "mode=bnn" in out and "completed 3 requests" in out
    assert launch_train.main(["--smoke", "--mode", "bnn", "--device", "cpu", "--steps", "2",
                              "--seq-len", "8", "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "mode=bnn" in out and "loss" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch_serve.main(["--smoke", "--mode", "bnn", "--requests", "1",
                               "--new-tokens", "1"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch_train.main(["--smoke", "--mode", "bnn", "--steps", "1", "--seq-len", "8",
                               "--batch", "2"])


# ---------------------------------------------------------------------------
# chip_smoke.py's bnn parity phases, rehearsed on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def chip_smoke(monkeypatch):
    """``chip_smoke.py`` imported from the repo root, and a ``noisy(hooks)``
    that wraps a phase's hooks so that its "card" side (here the CPU too)
    adds noise of 3e-7 x RMS to every attention output, paged (serving) and
    blockwise (training): the size of the card's own attention kernel
    against its plain version, standing in for another device's reduction
    orders. (Relative noise in RMSNorm would keep every Sign: a bnn
    projection reads only the Signs of its input.)"""
    import os

    import repro_torch.nn.attention as attn

    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs

    plain = {"paged": ops.paged_attention, "block": attn.blockwise_attention}
    gen = torch.Generator().manual_seed(11)

    def with_noise(fn):
        def noisy_fn(*a, **kw):
            y = fn(*a, **kw)
            rms = y.detach().pow(2).mean().sqrt()
            return y + 3e-7 * rms * torch.randn(y.shape, generator=gen)
        return noisy_fn

    def noisy(hooks):
        install, restore, report = hooks

        def install_noisy(side):
            if side == "card":
                ops.paged_attention = with_noise(plain["paged"])
                attn.blockwise_attention = with_noise(plain["block"])
            install(side)

        def restore_all():
            ops.paged_attention, attn.blockwise_attention = plain["paged"], plain["block"]
            restore()

        return install_noisy, restore_all, report

    no_hold = (lambda side: None, lambda: None, lambda: "no holding")
    yield cs, noisy, no_hold
    ops.paged_attention, attn.blockwise_attention = plain["paged"], plain["block"]


def test_chip_smoke_bnn_parity_holds_injected_noise(chip_smoke, monkeypatch):
    """With the noise, the 2-layer full-width serve and train parity phases
    pass only through their hooks: held Signs (all within the stated
    epsilons of 0) make the two sides agree, and without the hooks one
    flipped Sign moves the logits and gradients far past the limits."""
    from repro_torch.configs import get_config

    cs, noisy, no_hold = chip_smoke
    cpu = torch.device("cpu")
    arch = get_config("smollm-360m", compute_mode="bnn", pack_signs=True, remat=False,
                      paged_attn_route="fused", n_layers=2)
    train = build_model(arch, phase="train").init(torch.Generator().manual_seed(0), device=cpu)
    serve = tree_to_serve(train, arch.linear_spec())
    held = cs.phase_parity(torch, np, arch, serve, cpu,
                           noisy(cs._bnn_sign_hooks(torch, "bnn_matmul_packed")))
    assert held["max_abs_dlogit"] <= cs.PARITY_ATOL and not held["held"].startswith("0 of")
    with pytest.raises(SystemExit):  # a flipped Sign cascades past PARITY_ATOL
        cs.phase_parity(torch, np, arch, serve, cpu, noisy(no_hold), tag="bnn-parity-unheld")
    out = cs.phase_train_parity(torch, np, cpu, "bnn", noisy(cs._bnn_train_hooks(torch)))
    assert out["loss_rel"] <= cs.TRAIN_PARITY_LOSS and "of 4259840" in out["held"]
    assert max(out["grad_rel"], out["param_rel"]) <= cs.TRAIN_PARITY_REL
    monkeypatch.setattr(cs, "TRAIN_PARITY_LOSS", 1.0)  # report instead of failing
    monkeypatch.setattr(cs, "TRAIN_PARITY_REL", 1.0)
    loose = cs.phase_train_parity(torch, np, cpu, "bnn", noisy(no_hold), tag="unheld")
    assert loose["loss_rel"] > 1e-5 and loose["grad_rel"] > 1e-4
