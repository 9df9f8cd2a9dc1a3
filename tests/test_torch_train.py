"""PyTorch port vs the JAX reference: the training slice on the CPU (plain
versions of the kernels).

The same numpy inputs go through both packages. The reference reaches its
Pallas kernels as its own tests run them (interpret mode). Tolerances:

- the training CAC forward is bit-exact on every output whose K reduction
  holds no pre-activation within 1e-6 of 0, where a fused multiply-add on
  one side and a rounded product on the other may take opposite signs
  (the reference's convention, ``tests/test_kernels.py:_sign_nonboundary_out_mask``);
- the STE backward agrees within atol/rtol 1e-4 off the ``|pre| = 1``
  boundary (``tests/test_kernel_stack.py``'s convention);
- losses and metrics within 1e-6 relative, and the whole SMOKE train step's
  gradients within 1e-4 relative plus 1e-5 of each leaf's largest entry
  (the parameters after its AdamW update within 1e-5 relative plus
  1e-2 * lr, except where |g| is near AdamW's eps: see the test):
  the two packages compute the float parts (RMSNorm, RoPE, softmax, the
  head) with other kernels and summation orders, which leaves ~1e-7 relative.
  At this seed no pre-activation lands within those ulps of a Sign or STE
  boundary; one that did would move a whole ±1 term and fail the check.
  qnn8's amax gradients, sums whose terms cancel to ~1e-3 of their
  absolute sum, are held within 1e-4 of that absolute sum instead.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cases import (cac_train_case, cac_train_dyadic_case, cac_train_split_order_model,
                          window_clear)

from repro.configs import get_smoke as jax_get_smoke
from repro.core import bika as jbika
from repro.core import ste as jste
from repro.data.lm import LMDataConfig as JaxLMDataConfig
from repro.data.lm import lm_batch as jax_lm_batch
from repro.kernels import ops as jops
from repro.models import build_model as jax_build_model
from repro.nn.module import unbox
from repro.optim.adamw import OptimizerSpec as JaxOptimizerSpec
from repro.optim.adamw import make_optimizer as jax_make_optimizer
from repro.optim import schedule as jschedule
from repro.train import steps as jsteps
from repro.train.loss import softmax_xent as jax_softmax_xent
from repro_torch.core import backend as tbackend
from repro_torch.core import bika as tbika
from repro_torch.core import qnn as tqnn
from repro_torch.core import ste as tste
from repro_torch.core.convert import from_reference
from repro_torch.data.lm import LMDataConfig, lm_batch
from repro_torch.kernels import cac_matmul as tcac
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.base import ArchConfig
from repro_torch.optim.adamw import OptimizerSpec, make_optimizer, tree_leaves
from repro_torch.optim.schedule import cosine_warmup
from repro_torch.train.loss import softmax_xent
from repro_torch.train.steps import loss_and_grads, make_train_step
from repro_torch.train.trainer import TrainConfig, Trainer

TRAIN_SHAPES = [(8, 16, 8), (33, 100, 17), (64, 96, 40), (5, 7, 130)]


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


def _pre(x, w, beta):
    with np.errstate(invalid="ignore"):  # inf - inf, 0 * inf in the special-value cases
        return x[:, :, None] * w[None] + beta[None]


def _sign_clear_rows(x, w, beta, eps=1e-6):
    """(M, N) outputs whose K reduction holds no |pre| <= eps."""
    return (np.abs(_pre(x, w, beta)) > eps).all(axis=1)


def _window_clear(x, w, beta, eps=1e-4):
    """(M, K, N): elements not within eps of the |pre| = 1 window edge."""
    return np.abs(np.abs(_pre(x, w, beta)) - 1.0) > eps


@pytest.mark.parametrize("m,k,n", TRAIN_SHAPES)
def test_cac_train_fwd_plain_matches_reference_kernel(m, k, n):
    x, w, beta, _ = cac_train_case(np.random.default_rng(m * 31 + n), m, k, n)
    got = tcac.cac_train_fwd_plain(_t(x), _t(w), _t(beta)).numpy()
    want = np.asarray(jops.cac_train_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(beta),
                                            interpret=True))
    clear = _sign_clear_rows(x, w, beta)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(np.where(clear, got, 0), np.where(clear, want, 0))
    # the port's reference oracle is the same function
    np.testing.assert_array_equal(
        got, tcac.ref.cac_train_fwd_ref(_t(x), _t(w), _t(beta)).numpy())
    assert np.all(got == np.round(got)) and np.all(np.abs(got) <= k)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("m,k,n", TRAIN_SHAPES)
def test_cac_train_matmul_vjp_matches_reference(m, k, n, fused):
    """ops.cac_train_matmul's backward (CPU: the fused plain version, or the
    split dx + dw pair) against jax.vjp of the reference's op."""
    x, w, beta, g = cac_train_case(np.random.default_rng(m + 7 * k + n), m, k, n)
    _, pull = jax.vjp(lambda *a: jops.cac_train_matmul(*a, interpret=True, fused_bwd=fused),
                      jnp.asarray(x), jnp.asarray(w), jnp.asarray(beta))
    want = [np.asarray(a) for a in pull(jnp.asarray(g))]
    tx, tw, tb = (_t(a).requires_grad_(True) for a in (x, w, beta))
    before = ops.launch_counts()
    y = ops.cac_train_matmul(tx, tw, tb, fused_bwd=fused)
    y.backward(_t(g))
    assert ops.launch_counts() == before  # the CPU takes the plain versions
    clear = _window_clear(x, w, beta)
    masks = (clear.all(axis=2), clear.all(axis=0), clear.all(axis=0))
    for name, got, ref, keep in zip(("dx", "dw", "dbeta"), (tx.grad, tw.grad, tb.grad),
                                    want, masks):
        np.testing.assert_allclose(np.where(keep, got.numpy(), 0), np.where(keep, ref, 0),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_fused_and_split_plain_backward_agree():
    x, w, beta, g = (_t(a) for a in cac_train_case(np.random.default_rng(3), 20, 48, 36))
    dx, dw, db = tcac.cac_train_bwd_fused_plain(x, w, beta, g)
    np.testing.assert_allclose(dx, tcac.cac_train_bwd_dx_plain(x, w, beta, g),
                               atol=1e-5, rtol=1e-5)
    dw2, db2 = tcac.cac_train_bwd_dw_plain(x, w, beta, g)
    np.testing.assert_allclose(dw, dw2, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(db, db2, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):  # the kernels need CUDA tensors
        tcac.cac_train_fwd_call(x, w, beta)
    with pytest.raises(ValueError):
        tcac.cac_train_bwd_fused_call(x, w, beta, g)
    with pytest.raises(TypeError):
        tcac.cac_train_fwd_plain(x.double(), w, beta)


def test_plain_versions_chunk_over_m(monkeypatch):
    """Slicing M into few-row chunks changes nothing but the dw/dbeta sum order."""
    x, w, beta, g = (_t(a) for a in cac_train_case(np.random.default_rng(4), 37, 24, 18))
    whole_y = tcac.cac_train_fwd_plain(x, w, beta)
    whole = tcac.cac_train_bwd_fused_plain(x, w, beta, g)
    monkeypatch.setattr(tcac, "_TRAIN_CHUNK_ELEMS", 24 * 18 * 5)  # 5 rows a slice
    np.testing.assert_array_equal(tcac.cac_train_fwd_plain(x, w, beta), whole_y)
    for a, b in zip(tcac.cac_train_bwd_fused_plain(x, w, beta, g), whole):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)


def cac_train_threshold_model(x, w, beta):
    """Kernel 2's arithmetic in plain PyTorch, term for term: x (M, K), w
    and beta (K, N) float32 -> (M, N) float32 y = 2 sum_k [fl(x w) >= nb]
    - K, with nb = -beta, except nb(+inf) = -FLT_MAX (only a -inf or NaN
    product fails) and nb(-inf) = NaN (nothing passes). Equal to
    sum_k Sign(fl(fl(x w) + beta)) wherever nothing flushes subnormals."""
    inf = torch.tensor(float("inf"))
    nb = torch.where(beta == inf, -torch.finfo(torch.float32).max,
                     torch.where(beta == -inf, torch.nan, -beta))
    count = (x[:, :, None] * w[None] >= nb[None]).sum(dim=1, dtype=torch.int32)
    return (2 * count - x.shape[1]).to(torch.float32)


# ragged and small; (9, 40, 12) holds every special row of x against every
# special column of w and beta
DYADIC_SHAPES = [(9, 40, 12), (33, 100, 17), (6, 7, 130)]


@pytest.mark.parametrize("m,k,n", DYADIC_SHAPES)
def test_cac_train_threshold_model_matches_reference_kernel(m, k, n):
    """On the dyadic grid (products and sums exact, many pre-activations
    exactly 0) with rows and columns of +-0, +-inf and NaN in x, w and beta,
    the compare against nb(beta) equals the JAX Pallas kernel (interpret
    mode) and the port's plain version bit for bit: no output is left out."""
    x, w, beta, _ = cac_train_dyadic_case(np.random.default_rng(m + k + n), m, k, n)
    assert np.count_nonzero(_pre(x, w, beta) == 0) > 50  # Sign's tie is exercised
    got = cac_train_threshold_model(_t(x), _t(w), _t(beta)).numpy()
    want = np.asarray(jops.cac_train_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(beta),
                                            interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tcac.cac_train_fwd_plain(_t(x), _t(w), _t(beta)).numpy())


@pytest.mark.parametrize("scale_exp", [-70, -64])
def test_cac_train_threshold_model_on_subnormal_products(scale_exp):
    """Products and beta in the subnormal range (the card does not flush
    them; XLA's CPU does, so the reference is not asked): exactly
    cancelling pairs, pairs an ulp apart and random ones; the compare equals
    the port's plain version bit for bit."""
    rng = np.random.default_rng(-scale_exp)
    m, k, n = 7, 48, 9
    scale = np.float32(2.0 ** scale_exp)
    x, w, beta, _ = cac_train_dyadic_case(rng, m, k, n, sparse=True)
    x, w = x * scale, w * scale
    beta = (beta * scale * scale).astype(np.float32)  # -x' w at the products' scale
    beta[:, -1] += np.float32(2.0 ** -149)  # one ulp of the subnormals past the tie
    x[-1] = (rng.normal(size=k) * scale).astype(np.float32)
    assert np.any((np.abs(x[:, :, None] * w[None]) < np.finfo(np.float32).tiny)
                  & (x[:, :, None] * w[None] != 0))
    got = cac_train_threshold_model(_t(x), _t(w), _t(beta))
    np.testing.assert_array_equal(got.numpy(),
                                  tcac.cac_train_fwd_plain(_t(x), _t(w), _t(beta)).numpy())


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("m,k,n", DYADIC_SHAPES)
def test_cac_train_backward_exact_on_dyadic_grid(m, k, n, fused):
    """Every product and sum of the STE backward is exact on the dyadic
    grid, so the port's plain backward (fused or split) equals jax.vjp of
    the reference's op bit for bit, the |pre| = 1 window edges included,
    and with them the NaN a non-finite x or w leaves in its dw row or dx
    column (single +-0, +-inf and NaN elements in x and w; whole columns of
    them in beta, which the window leaves out)."""
    x, w, beta, g = cac_train_dyadic_case(np.random.default_rng(k + 3), m, k, n,
                                          sparse=True)
    if not fused:  # the reference's split dx kernel selects the product g w after it is
        # formed, so a non-finite w outside the window adds 0 there and NaN in its fused
        # kernel and the port's plain versions: the split case keeps x and w finite
        x[~np.isfinite(x)], w[~np.isfinite(w)] = 0.0, 0.0
    assert np.count_nonzero(np.abs(_pre(x, w, beta)) == 1) > 50  # the edges are hit
    _, pull = jax.vjp(lambda *a: jops.cac_train_matmul(*a, interpret=True, fused_bwd=fused),
                      jnp.asarray(x), jnp.asarray(w), jnp.asarray(beta))
    want = [np.asarray(a) for a in pull(jnp.asarray(g))]
    if fused:
        got = tcac.cac_train_bwd_fused_plain(_t(x), _t(w), _t(beta), _t(g))
    else:
        got = (tcac.cac_train_bwd_dx_plain(_t(x), _t(w), _t(beta), _t(g)),
               *tcac.cac_train_bwd_dw_plain(_t(x), _t(w), _t(beta), _t(g)))
    for name, a, b in zip(("dx", "dw", "dbeta"), got, want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def window_on_p(b):
    """Kernel 5's STE window as bounds on the rounded product (``window_on_p``
    in csrc/cac_train.cu) in numpy: (lo, hi) float32 with |fl(p + b)| <= 1
    exactly when lo <= p <= hi."""
    b = np.float32(b)
    if not np.isfinite(b):
        return np.float32(np.nan), np.float32(np.nan)
    if abs(b) >= 2.0 ** 25:
        return -b, -b
    lo_d, hi_d = (-1.0 - 2.0 ** -24) - np.float64(b), (1.0 + 2.0 ** -24) - np.float64(b)
    lo, hi = np.float32(lo_d), np.float32(hi_d)  # to nearest, then inwards
    if np.float64(lo) < lo_d:
        lo = np.nextafter(lo, np.float32(np.inf))
    if np.float64(hi) > hi_d:
        hi = np.nextafter(hi, np.float32(-np.inf))
    return lo, hi


def _beta_family(name):
    rng = np.random.default_rng(len(name))
    if name == "normal":  # the training path's beta ~ N(0, 0.25)
        return (rng.normal(size=4000) * 0.5).astype(np.float32)
    if name == "wide":  # every binade, subnormals to 3e38
        return (rng.normal(size=4000) * 10.0 ** rng.uniform(-45, 38, size=4000)).astype(np.float32)
    if name == "binades":  # powers of two and their neighbours, 2^-40 .. 2^40
        v = np.float32([s * 2.0 ** e for e in range(-40, 41) for s in (1, -1)])
        return np.concatenate([v, np.nextafter(v, np.float32(np.inf)),
                               np.nextafter(v, np.float32(-np.inf))])
    return np.float32([0.0, -0.0, 1.0, -1.0, 1 + 2 ** -23, -1 - 2 ** -23, 0.99999994,
                       -0.99999994, 2.0 ** -24, -2.0 ** -24, 2.0 ** 24, 2.0 ** 25 - 2,
                       2.0 ** 25, -2.0 ** 25, 3e38, -3e38, 1e-45, -1e-45, 2.0, -2.0])


@pytest.mark.parametrize("family", ["normal", "wide", "binades", "edges"])
def test_kernel5_window_bounds_on_p(family):
    """|fl(p + b)| <= 1 holds at lo and hi and fails one float outside each,
    for every b of the family (the window is monotone in p, so it is exactly
    [lo, hi]; an empty one has no float in it)."""
    one = np.float32(1)
    for b in _beta_family(family):
        lo, hi = window_on_p(b)
        inside = lambda p: abs(np.float32(p) + b) <= one
        below, above = np.nextafter(lo, np.float32(-np.inf)), np.nextafter(hi, np.float32(np.inf))
        if lo <= hi:
            assert inside(lo) and inside(hi) and not inside(below) and not inside(above), b
        else:
            assert not inside(lo) and not inside(hi), b


def _order_key(v):
    i = int(np.array(v, np.float32).view(np.int32))
    return i ^ 0x7FFFFFFF if i < 0 else i


def _from_key(k):
    return np.array(k ^ 0x7FFFFFFF if k < 0 else k, np.int32).view(np.float32)[()]


def _first_in(guess, inside):
    """``first_in`` of csrc/cac_train.cu: the first float in [-inf, inf]
    where ``inside`` holds (false, then true along the floats), stepping
    from ``guess`` and bisecting the whole range after 8 steps."""
    lo_key, hi_key = _order_key(-np.inf), _order_key(np.inf)
    k = 0 if np.isnan(guess) else _order_key(guess)
    for _ in range(8):
        if inside(_from_key(k)):
            if k == lo_key or not inside(_from_key(k - 1)):
                return _from_key(k)
            k -= 1
        elif k == hi_key:
            return np.float32(np.nan)
        else:
            k += 1
    a, z = lo_key, hi_key
    if not inside(_from_key(z)):
        return np.float32(np.nan)
    while a < z:
        mid = (a + z) >> 1
        a, z = (a, mid) if inside(_from_key(mid)) else (mid + 1, z)
    return _from_key(a)


def window_on_x(w, b):
    """Kernel 5's STE window as bounds on x (``window_on_x`` in
    csrc/cac_train.cu) in numpy: (lo, hi) float32 with |fl(fl(x w) + b)|
    <= 1 exactly when lo <= x <= hi (NaN: never)."""
    w, b = np.float32(w), np.float32(b)
    plo, phi = window_on_p(b)
    nan = np.float32(np.nan)
    if np.isnan(plo) or not np.isfinite(w):
        return nan, nan
    if w == 0:
        big = np.finfo(np.float32).max
        return (-big, big) if plo <= 0 <= phi else (nan, nan)
    up = w > 0
    q = lambda x: np.float32(np.float32(x) * w)
    with np.errstate(all="ignore"):
        lo = _first_in(np.float32((plo if up else phi) / w),
                       lambda x: q(x) >= plo if up else q(x) <= phi)
        past = _first_in(np.float32((phi if up else plo) / w),
                         lambda x: q(x) > phi if up else q(x) < plo)
    return lo, (np.float32(np.inf) if np.isnan(past) else _from_key(_order_key(past) - 1))


@pytest.mark.parametrize("family", ["normal", "wide", "edges"])
def test_kernel5_window_bounds_on_x(family):
    """lo <= x <= hi decides |fl(fl(x w) + b)| <= 1 for every x tried: random
    x, the bounds and two floats either side of each, -b / w and its
    neighbours, +-0, +-inf, NaN and +-FLT_MAX, over (w, b) pairs of the
    family (w +-0, +-inf, NaN and extremes among them)."""
    rng = np.random.default_rng(len(family) + 7)
    ws = np.concatenate([_beta_family(family), np.float32([0.0, -0.0, np.inf, -np.inf, np.nan,
                                                           1e-45, -3e38, 0.5, -2.0])])
    bs = np.concatenate([_beta_family(family), np.float32([np.inf, -np.inf, np.nan])])
    inf, big = np.float32(np.inf), np.finfo(np.float32).max
    specials = np.float32([0.0, -0.0, np.inf, -np.inf, np.nan, big, -big])
    for _ in range(400):
        w, b = rng.choice(ws), rng.choice(bs)
        lo, hi = window_on_x(w, b)
        xs = list((rng.normal(size=12) * 3).astype(np.float32)) + list(specials)
        with np.errstate(all="ignore"):
            for c in (lo, hi, np.float32(-b / w)):
                if np.isfinite(c):
                    up1, dn1 = np.nextafter(c, inf), np.nextafter(c, -inf)
                    xs += [c, up1, dn1, np.nextafter(up1, inf), np.nextafter(dn1, -inf)]
            for x in xs:
                want = abs(np.float32(np.float32(x * w) + b)) <= np.float32(1)
                assert bool(lo <= x <= hi) == bool(want), (w, b, x, lo, hi)


TRAIN_PLAN_SHAPES = [(512, 960, 960), (512, 960, 320), (512, 960, 2560), (512, 2560, 960),
                     (37, 100, 130), (129, 968, 65), (1, 1, 1), (4096, 17, 64)]


@pytest.mark.parametrize("m,k,n", TRAIN_PLAN_SHAPES)
def test_train_plans_cover_k_and_n(m, k, n):
    """Kernel 2's plan cuts the K slices into non-empty ranges that cover K
    (at most 8 ranks) and kernel 5's cluster has an N tile for every rank
    (at most 16); a size the card cannot keep resident is never taken."""
    bm, bn = tcac.TRAIN_FWD_TILE
    slices = -(-k // tcac.TRAIN_FWD_SLICE)
    for max_blocks in (None, lambda s: 3 * 132 if s <= 2 else 0):
        splits, per = tcac.train_fwd_plan(m, k, n, max_blocks)
        assert 1 <= splits <= tcac.TRAIN_MAX_SPLITS
        assert (splits - 1) * per < slices <= splits * per
        cluster = tcac.train_bwd_plan(m, k, n, max_blocks)
        assert 1 <= cluster <= min(tcac.TRAIN_BWD_MAX_CLUSTER, -(-n // tcac.TRAIN_BWD_TILE[1]))
        if max_blocks is not None:
            assert splits <= 2 and cluster <= 2
        nt, parts = tcac.train_bwd_dw_plan(m, k, n, max_blocks)
        assert nt in (4, 8) and parts == -(-n // (8 * nt))  # a block a (K tile, N tile)


# the H100's cluster occupancy (cudaOccupancyMaxActiveClusters x size) for
# kernels 2 and 5 at M = 512, sizes 1, 2, ..., and kernel 4's resident
# blocks with 8 and 4 columns a thread, as chip_smoke.py prints them
H100_FWD_BLOCKS = (264, 264, 237, 248, 235, 234, 224, 240)
H100_BWD_BLOCKS = (264, 264, 237, 248, 235, 234, 224, 240, 207, 210, 176, 192, 182, 196, 210, 224)
H100_DW_BLOCKS = {8: 264, 4: 528}


@pytest.mark.parametrize("k,n,splits,cluster", [(960, 960, 4, 8), (960, 320, 8, 5),
                                                  (960, 2560, 4, 8), (2560, 960, 4, 15)])
def test_train_plans_at_the_path_shapes(k, n, splits, cluster):
    """At M = 512 under the H100's occupancy: kernel 2's split count and
    kernel 5's cluster size at the path's four projections. Gate/up: 160
    tiles of y x 4 splits take three waves of 15 + 1 slices, 8 splits six
    of 8 + 1; kernel 5's 30 K tiles x 8 ranks of 5 N tiles fill one wave of
    240. Down: 80 K tiles x 15 ranks of one N tile (six waves of 210) tie
    with 8 ranks (three waves of 2 tiles) and 5: the larger is taken."""
    assert tcac.train_fwd_plan(512, k, n, lambda s: H100_FWD_BLOCKS[s - 1])[0] == splits
    assert tcac.train_bwd_plan(512, k, n, lambda c: H100_BWD_BLOCKS[c - 1]) == cluster


@pytest.mark.parametrize("k,n,nt,parts", [(960, 960, 8, 15), (960, 320, 4, 10),
                                           (960, 2560, 8, 40), (2560, 960, 8, 15)])
def test_dw_plan_at_the_path_shapes(k, n, nt, parts):
    """At M = 512 under the H100's occupancy, kernel 4 takes 64-column
    tiles where the 30 or 80 K tiles x N tiles fill the 264 blocks the card
    holds (q/o 450, gate/up and down 1,200) and 32-column tiles at k/v (150
    would leave the card half idle: 300 blocks of the 528), one block a
    tile."""
    assert tcac.train_bwd_dw_plan(512, k, n, H100_DW_BLOCKS.get) == (nt, parts)


SPLIT_MODEL_CASES = [(37, 24, 130, 3), (600, 16, 70, 2), (40, 33, 200, 4), (20, 8, 64, 1)]


def _split_reference(x, w, beta, g):
    """jax.vjp of the reference's op on its split backward (kernels 3 and
    4, interpret mode)."""
    _, pull = jax.vjp(lambda *a: jops.cac_train_matmul(*a, interpret=True, fused_bwd=False),
                      jnp.asarray(x), jnp.asarray(w), jnp.asarray(beta))
    return [np.asarray(a) for a in pull(jnp.asarray(g))]


@pytest.mark.parametrize("m,k,n,cluster", SPLIT_MODEL_CASES)
def test_split_order_model_matches_reference_split_kernels(m, k, n, cluster):
    """The split kernels' order (``cac_train_split_order_model``: kernel 5's
    row groups and lane order for dw and dbeta over M ranges of 512, the
    8-lane butterfly and the rank-order cluster sum for dx) against the
    reference's split pair in interpret mode, within atol = rtol = 1e-4 off
    the |pre| = 1 edge: one, two, three and four ranks, a ragged last tile,
    and M past one 512-row range."""
    x, w, beta, g = cac_train_case(np.random.default_rng(m + k + n), m, k, n)
    want = _split_reference(x, w, beta, g)
    got = cac_train_split_order_model(_t(x), _t(w), _t(beta), _t(g), cluster)
    dx_keep, dw_keep = window_clear(_t(x), _t(w), _t(beta))
    for name, a, b, keep in zip(("dx", "dw", "dbeta"), got, want, (dx_keep, dw_keep, dw_keep)):
        np.testing.assert_allclose(np.where(keep, a.numpy(), 0), np.where(keep, b, 0),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("m,k,n,cluster", SPLIT_MODEL_CASES)
def test_split_order_model_exact_on_dyadic_grid(m, k, n, cluster):
    """On the dyadic grid every sum is exact in any order: the order model
    equals the reference's split pair bit for bit with finite x and w (its
    dx kernel leaves 0 where a non-finite w lies outside the window), and
    the port's plain versions with the +-0, +-inf and NaN elements in."""
    x, w, beta, g = cac_train_dyadic_case(np.random.default_rng(k + 5), m, k, n, sparse=True)
    got = cac_train_split_order_model(_t(x), _t(w), _t(beta), _t(g), cluster)
    want = (tcac.cac_train_bwd_dx_plain(_t(x), _t(w), _t(beta), _t(g)),
            *tcac.cac_train_bwd_dw_plain(_t(x), _t(w), _t(beta), _t(g)))
    for name, a, b in zip(("dx", "dw", "dbeta"), got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    x[~np.isfinite(x)], w[~np.isfinite(w)] = 0.0, 0.0
    got = cac_train_split_order_model(_t(x), _t(w), _t(beta), _t(g), cluster)
    for name, a, b in zip(("dx", "dw", "dbeta"), got, _split_reference(x, w, beta, g)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("name", ["sign_ste", "round_ste", "clip_ste"])
def test_ste_functions_match_reference(name):
    """Forward values and gradients, with points on every boundary: Sign(0)
    = +1, the inclusive |x| <= 1 window, round-half-to-even, clip edges."""
    edges = np.float32([0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 1.5, 2.5, -2.5, 0.3, -0.3])
    nudged = np.nextafter(np.float32([1.0, -1.0]), np.float32([2.0, -2.0]))
    x = np.concatenate([edges, nudged, np.random.default_rng(0).normal(size=20)
                        .astype(np.float32) * 2])
    g = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    args = (-0.5, 1.5) if name == "clip_ste" else ()
    y, pull = jax.vjp(lambda a: getattr(jste, name)(a, *args), jnp.asarray(x))
    (dx,) = pull(jnp.asarray(g))
    tx = _t(x).requires_grad_(True)
    ty = getattr(tste, name)(tx, *args)
    ty.backward(_t(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(y))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(dx))


@pytest.mark.parametrize("chunk", [None, 16, 24])
def test_bika_matmul_forms_match_reference(chunk):
    """core/bika.py training forms (fused, K-chunked with the padding
    constant, custom-VJP) against the reference's, values and gradients."""
    x, w, beta, g = cac_train_case(np.random.default_rng(9), 12, 40, 10)
    x = x.reshape(3, 4, 40)
    g = g.reshape(3, 4, 10)
    jfn = lambda *a: jbika.bika_matmul(*a, chunk=chunk)
    y, pull = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(beta))
    want = [np.asarray(a) for a in pull(jnp.asarray(g))]
    x2 = x.reshape(12, 40)
    clear_y = _sign_clear_rows(x2, w, beta).reshape(3, 4, 10)
    clear = _window_clear(x2, w, beta)
    masks = (clear.all(axis=2).reshape(3, 4, 40), clear.all(axis=0), clear.all(axis=0))
    for fn in (lambda *a: tbika.bika_matmul(*a, chunk=chunk), tbika.bika_matmul_cvjp):
        tx, tw, tb = (_t(a).requires_grad_(True) for a in (x, w, beta))
        ty = fn(tx, tw, tb)
        ty.backward(_t(g))
        np.testing.assert_array_equal(np.where(clear_y, ty.detach().numpy(), 0),
                                      np.where(clear_y, np.asarray(y), 0))
        for got, ref, keep in zip((tx.grad, tw.grad, tb.grad), want, masks):
            np.testing.assert_allclose(np.where(keep, got.numpy(), 0), np.where(keep, ref, 0),
                                       atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("m,impl", [(1, "cvjp"), (2, "fused"), (2, "pallas")])
def test_bika_apply_train_matches_reference(m, impl):
    """BikaBackend.apply_train (always the cac_train route) against the
    reference's on every impl: the fold for m > 1, out_scale and gamma."""
    rng = np.random.default_rng(m)
    k, n = 24, 9
    w = rng.uniform(-0.3, 0.3, size=(m, k, n)).astype(np.float32)
    beta = rng.uniform(-0.3, 0.3, size=(m, k, n)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, size=(n,)).astype(np.float32)
    x = rng.normal(size=(2, 3, k)).astype(np.float32)
    g = rng.normal(size=(2, 3, n)).astype(np.float32)
    from repro.core import backend as jbackend

    jspec = jbackend.LinearSpec(mode="bika", m=m, impl=impl)
    jbe = jbackend.get_backend("bika")
    jp = {"w": jnp.asarray(w), "beta": jnp.asarray(beta), "gamma": jnp.asarray(gamma)}
    y, pull = jax.vjp(lambda p, a: jbe.apply_train(p, a, jspec), jp, jnp.asarray(x))
    jgp, jgx = pull(jnp.asarray(g))
    tspec = tbackend.LinearSpec(mode="bika", m=m, impl=impl)
    tbe = tbackend.get_backend("bika")
    assert tbe.kernel_route(tspec) == "cac_train"
    assert tbe.kernel_route(tspec, "serve") == "cac_hw"
    assert tbackend.get_backend("dense").kernel_route(tspec) is None
    tp = {k2: _t(v).requires_grad_(True) for k2, v in
          (("w", w), ("beta", beta), ("gamma", gamma))}
    tx = _t(x).requires_grad_(True)
    ty = tbe.apply_train(tp, tx, tspec)
    ty.backward(_t(g))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5, rtol=1e-5)
    for name in ("w", "beta", "gamma"):
        np.testing.assert_allclose(tp[name].grad.numpy(), np.asarray(jgp[name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(3, 5, 40)) * 3).astype(np.float32)
    labels = rng.integers(0, 40, size=(3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.7).astype(np.float32)
    for m, z in ((None, 0.0), (mask, 1e-4)):
        loss, met = softmax_xent(_t(logits), _t(labels), None if m is None else _t(m), z_loss=z)
        jl, jm = jax_softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                  None if m is None else jnp.asarray(m), z_loss=z)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
        for key in ("accuracy", "tokens"):
            np.testing.assert_allclose(float(met[key]), float(jm[key]), rtol=1e-6)


def test_adamw_sgd_and_schedule_match_reference():
    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(size=(4, 3)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    grads = [{"a": (rng.normal(size=(4, 3)) * s).astype(np.float32),
              "b": {"c": (rng.normal(size=(5,)) * s).astype(np.float32)}} for s in (3.0, 0.01)]
    for name in ("adamw", "sgd"):
        jspec = JaxOptimizerSpec(name=name, peak_lr=1e-2, warmup=1, total_steps=10)
        tspec = OptimizerSpec(name=name, peak_lr=1e-2, warmup=1, total_steps=10)
        jinit, jupd = jax_make_optimizer(jspec)
        tinit, tupd = make_optimizer(tspec)
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        tp = from_reference(tree)
        js, ts = jinit(jp), tinit(tp)
        for gr in grads:  # the first one is clipped (norm > 1), the second not
            jp, js, jst = jupd(jax.tree_util.tree_map(jnp.asarray, gr), js, jp)
            tp, ts, tst = tupd(from_reference(gr), ts, tp)
            np.testing.assert_allclose(float(tst["grad_norm"]), float(jst["grad_norm"]),
                                       rtol=1e-6)
            np.testing.assert_allclose(tst["lr"], float(jst["lr"]), rtol=1e-6)
            np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]), atol=1e-7, rtol=1e-6)
            np.testing.assert_allclose(tp["b"]["c"].numpy(), np.asarray(jp["b"]["c"]),
                                       atol=1e-7, rtol=1e-6)
        assert ts["step"] == int(js["step"]) == 2
    fn, jfn = cosine_warmup(3e-4, 10, 100), jschedule.cosine_warmup(3e-4, 10, 100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(fn(step), float(jfn(step)), rtol=1e-6, atol=1e-12)


def _port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ArchConfig)})


def _assert_tree_close(got, want, path, rtol, sum_bounds=None):
    """Each leaf within ``rtol`` relative plus 1e-5 of its largest entry;
    a leaf named in ``sum_bounds`` (path -> per-element absolute terms)
    within ``rtol`` of that instead (see ``_amax_grad_terms``)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _assert_tree_close(got[key], want[key], f"{path}/{key}", rtol, sum_bounds)
        return
    if isinstance(want, (list, tuple)):  # xLSTM's list of layers
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_close(g, w, f"{path}/{i}", rtol, sum_bounds)
        return
    g, w = got.detach().numpy(), np.asarray(want)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    if sum_bounds and path in sum_bounds:
        bound = rtol * sum_bounds[path]
        assert np.all(np.abs(g - w) <= bound), (path, g, w, bound)
        return
    np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-5 * float(np.abs(w).max()),
                               err_msg=path)


def _amax_grad_terms(api, params, batch, monkeypatch):
    """qnn8: {"grad/.../amax": (L,) float64} — for each layer's PACT
    ceiling, the sum of the absolute terms its gradient adds up. Through
    the round STE that gradient is the sum over the projection's inputs of
    g * ((round(u) - u) / 255 + [x > amax]), u = min(relu(x), amax) * 255 /
    amax: terms of either sign that cancel to as little as 1e-3 of their
    absolute sum, so the two packages' ~1e-7 relative differences in g
    (float parts summed in other orders) reach ~1e-4 of the result there.
    Such a sum is held to ``rtol`` of its absolute terms, the bound of any
    float sum. The terms are taken from the port's own forward (the input
    of each fake-quant call, and the gradient reaching its output) and their
    sum is checked against the port's own amax gradient first."""
    paths = {}

    def track(node, path):
        if isinstance(node, dict):
            return {k: track(v, f"{path}/{k}") for k, v in node.items()}
        leaf = node.detach().requires_grad_(True)
        paths[id(leaf)] = path
        return leaf

    tracked = track(params, "grad")
    recs = []
    real = tqnn.fake_quant_activations

    def spy(x, amax):
        out = real(x, amax)
        if out.requires_grad and amax._base is not None and id(amax._base) in paths:
            key = (paths[id(amax._base)], amax.storage_offset())
            xs, a = x.detach().double(), float(amax.detach())
            out.register_hook(lambda g: recs.append((key, xs, a, g.detach().double())))
        return out

    monkeypatch.setattr(tqnn, "fake_quant_activations", spy)
    logits, aux = api.apply_aux(tracked, batch)
    loss, _ = softmax_xent(logits, batch["labels"], batch.get("mask"), z_loss=1e-4)
    (loss + 0.01 * aux).backward()
    monkeypatch.setattr(tqnn, "fake_quant_activations", real)
    grads = {paths[id(leaf)]: leaf.grad.numpy() for leaf in _leaves_of(tracked)}
    sums, abs_sums = {}, {}
    for (path, layer), x, a, g in recs:
        x1 = x.clamp_min(0.0)
        u = torch.minimum(x1, torch.tensor(a, dtype=torch.float64)) * 255.0 / a
        terms = g * ((torch.round(u) - u) / 255.0 + (x1 > a).double())
        n = grads[path].shape[0]
        sums.setdefault(path, np.zeros(n))[layer] += float(terms.sum())
        abs_sums.setdefault(path, np.zeros(n))[layer] += float(terms.abs().sum())
    assert len(abs_sums) == 7 and all(v.min() > 0 for v in abs_sums.values())
    for path, total in sums.items():  # the terms are the port's own gradient
        assert np.all(np.abs(grads[path] - total) <= 1e-5 * abs_sums[path]), (path, total)
    return abs_sums


def _leaves_of(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves_of(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves_of(v)]
    return [tree]


@pytest.mark.parametrize("mode", ["bika", "dense", "bnn", "qnn8"])
def test_train_step_matches_reference_at_smoke(mode, monkeypatch):
    """One whole train step at SMOKE (2 layers, remat on): the
    reference's train-form params from its own init, unboxed and brought over
    with ``from_reference``, one batch from its data pipeline, both packages'
    ``make_train_step`` with AdamW. In bika mode the reference takes its
    Pallas route (kernels 2 and 5 in interpret mode), in bnn mode likewise
    (kernels 6, 8 and 9); qnn8 trains through fake quantization in both
    (no kernel). The qnn8 reference runs op by op (``jax.disable_jit``):
    compiled, its scanned layers turn the weight scale's ``/ 127`` into a
    multiply by the reciprocal, 1 ulp off the port's IEEE divide, which puts
    columns' largest weights beyond the +-127 clip bound (gradient 0) where
    the port's sit on it (half), as the paper slice's tests note. Its amax
    gradients, sums that cancel, are held to 1e-4 of their absolute terms
    (``_amax_grad_terms``). Loss and metrics,
    every gradient leaf and every parameter after the update are compared;
    the reference's gradient is the one its step takes, captured at its
    optimizer call (one reference pass)."""
    jcfg = jax_get_smoke("smollm-360m", compute_mode=mode, bika_impl="pallas")
    japi = jax_build_model(jcfg, phase="train")
    np_params = jax.tree_util.tree_map(np.asarray, unbox(japi.init(jax.random.PRNGKey(7))))
    batch = jax.tree_util.tree_map(
        np.asarray, jax_lm_batch(JaxLMDataConfig(vocab=jcfg.vocab, seq_len=16,
                                                 global_batch=2, seed=3), 0))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    tbatch = {k: _t(v) for k, v in batch.items()}

    spec = dict(peak_lr=1e-3, warmup=0, total_steps=10)
    seen = {}

    def capture(grads, state, params):  # the step's own gradient, then AdamW
        seen["grads"] = grads
        return jupd(grads, state, params)

    with jax.disable_jit() if mode == "qnn8" else contextlib.nullcontext():
        jinit, jupd = jax_make_optimizer(JaxOptimizerSpec(**spec))
        jp = jax.tree_util.tree_map(jnp.asarray, np_params)
        jstep = jsteps.make_train_step(japi, capture)
        jp, jopt, jmet = jstep(jp, jinit(jp), jbatch)
    jgrads = seen["grads"]

    api = build_model(_port_cfg(jcfg), phase="train")
    tp = from_reference(np_params)
    met, tgrads = loss_and_grads(api, tp, tbatch)
    sum_bounds = _amax_grad_terms(api, tp, tbatch, monkeypatch) if mode == "qnn8" else None
    _assert_tree_close(tgrads, jgrads, "grad", rtol=1e-4, sum_bounds=sum_bounds)
    tinit, tupd = make_optimizer(OptimizerSpec(**spec))
    before = ops.launch_counts()
    tp, topt, tmet = make_train_step(api, tupd)(tp, tinit(tp), tbatch)
    assert ops.launch_counts() == before  # CPU: plain versions, no launch
    for key in ("loss", "accuracy", "tokens", "aux_loss", "grad_norm", "skipped"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-6, atol=1e-7,
                                   err_msg=key)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-6)
    # AdamW's first step moves each element by lr * g / (|g| + eps). Where
    # |g| >= 100 eps that move is lr * sign(g) to within 1e-2 of the
    # gradients' ~1e-7 relative difference, so those parameters are held to
    # 1e-5 relative plus 1e-2 * lr. Where |g| is near eps (1e-8) the same
    # difference shifts the move by a visible fraction of lr; those
    # elements are held only to the step's reach, 2 * lr: 187 of 246,240
    # in dense mode and 154,594 of 444,576 in bika mode, whose q/k/v/gate/up
    # gradients are ~1e-5 at most (their values are held above).
    # (A gradient that is exactly 0, as for the embedding rows no token
    # reads, moves nothing but the decay: held tightly too.)
    lr = spec["peak_lr"]
    for got, want, grad in zip(tree_leaves(tp), tree_leaves(jax.tree_util.tree_map(
            np.asarray, jp)), tree_leaves(jax.tree_util.tree_map(np.asarray, jgrads))):
        steady = (np.abs(grad) >= 100 * 1e-8) | (grad == 0)
        g = got.numpy()
        np.testing.assert_allclose(g[steady], want[steady], rtol=1e-5, atol=1e-2 * lr)
        assert np.all(np.abs(g - want) <= 2 * lr)
    assert topt["step"] == int(jopt["step"]) == 1


def test_remat_microbatches_and_skip():
    """Port-side invariants at SMOKE: remat changes no value; two
    microbatches give the mean gradient; a non-finite loss skips the update
    but advances the step."""
    cfg = _port_cfg(jax_get_smoke("smollm-360m", compute_mode="bika"))
    params = build_model(cfg, phase="train").init(5, device="cpu")
    batch = lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=8, global_batch=4, seed=1), 2)
    runs = {}
    for remat in (True, False):
        runs[remat] = loss_and_grads(build_model(cfg.replace(remat=remat), phase="train"),
                                     params, batch)
    assert float(runs[True][0]["loss"]) == float(runs[False][0]["loss"])
    for a, b in zip(tree_leaves(runs[True][1]), tree_leaves(runs[False][1])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    api = build_model(cfg, phase="train")
    halves = [loss_and_grads(api, params, {k: v[i:i + 2] for k, v in batch.items()})[1]
              for i in (0, 2)]
    seen = {}

    def capture(grads, state, p):
        seen["g"] = grads
        state["step"] += 1
        return p, state, {"lr": 0.0, "grad_norm": torch.zeros(())}

    make_train_step(api, capture, microbatches=2)(params, {"step": 0}, batch)
    for got, a, b in zip(tree_leaves(seen["g"]), tree_leaves(halves[0]),
                         tree_leaves(halves[1])):
        np.testing.assert_allclose(got.numpy(), ((a + b) * 0.5).numpy(), atol=1e-7, rtol=1e-6)
    init, upd = make_optimizer(OptimizerSpec())
    bad = dict(params, embed={"table": params["embed"]["table"].clone()})
    bad["embed"]["table"][0, 0] = float("nan")
    nan_batch = dict(batch, tokens=torch.zeros_like(batch["tokens"]))  # reads the NaN row
    snapshot = bad["ln_f"]["scale"].clone()
    state = init(bad)
    _, state, met = make_train_step(api, upd)(bad, state, nan_batch)
    assert float(met["skipped"]) == 1.0 and state["step"] == 1
    np.testing.assert_array_equal(bad["ln_f"]["scale"].numpy(), snapshot.numpy())


def test_lm_batch_shapes_and_shift():
    cfg = LMDataConfig(vocab=300, seq_len=12, global_batch=6, seed=4)
    b = lm_batch(cfg, 3)
    assert set(b) == {"tokens", "labels", "mask"}
    assert b["tokens"].shape == b["labels"].shape == b["mask"].shape == (6, 12)
    assert b["tokens"].dtype == b["labels"].dtype == torch.int32
    assert b["mask"].dtype == torch.float32 and bool((b["mask"] == 1).all())
    np.testing.assert_array_equal(b["labels"][:, :-1].numpy(), b["tokens"][:, 1:].numpy())
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 300
    again = lm_batch(cfg, 3)
    np.testing.assert_array_equal(again["tokens"].numpy(), b["tokens"].numpy())
    assert not torch.equal(lm_batch(cfg, 4)["tokens"], b["tokens"])


def test_trainer_and_launcher_on_cpu(capsys):
    cfg = _port_cfg(jax_get_smoke("smollm-360m", compute_mode="bika"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(TrainConfig(arch=cfg, steps=1))
    trainer = Trainer(TrainConfig(arch=cfg, seq_len=8, global_batch=2, steps=2, log_every=1),
                      device="cpu")
    _, opt, log = trainer.run()
    assert [m["step"] for m in log] == [0, 1] and opt["step"] == 2
    assert all(np.isfinite(m["loss"]) for m in log)
    assert launch_train.main(["--smoke", "--device", "cpu", "--steps", "2", "--seq-len", "8",
                              "--batch", "2"]) == 0
    assert "loss" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--smoke", "--steps", "1", "--seq-len", "8", "--batch", "2"])


@pytest.mark.parametrize("s,block_q,window", [(16, 32, None), (16, 8, None), (24, 8, 5)])
def test_blockwise_attention_matches_reference(s, block_q, window):
    """Query tiles (recomputed in the backward) and the sliding window,
    values and gradients, against the reference's blockwise attention."""
    from repro.nn.attention import blockwise_attention as jax_blockwise
    from repro_torch.nn.attention import blockwise_attention

    rng = np.random.default_rng(s + block_q)
    q, k, v = (rng.normal(size=(2, s, h, 8)).astype(np.float32) for h in (4, 2, 2))
    g = rng.normal(size=(2, s, 4, 8)).astype(np.float32)
    out, pull = jax.vjp(lambda *a: jax_blockwise(*a, window=window, block_q=block_q),
                        *(jnp.asarray(a) for a in (q, k, v)))
    want = pull(jnp.asarray(g))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    got = blockwise_attention(tq, tk, tv, window=window, block_q=block_q)
    got.backward(_t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5, rtol=1e-5)
    for a, b in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
