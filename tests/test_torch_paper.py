"""PyTorch port vs the JAX reference: the paper's models (TFC, SFC, LFC,
CNV in dense, bika, bnn and qnn8 mode), the KAN baseline and the
threshold math, the vision data, and the train -> export -> serve path,
on the CPU (plain versions of the kernels).

The same numpy inputs, and the reference's own initial parameters brought
across by ``core/convert.from_reference``, go through both packages.
Tolerances:

- integer-valued results (thresholds, signs, CAC sums, the saturating
  accumulator, bnn products, bika and bnn serve logits) bit-exact;
- the threshold math exact or within 1e-6, the KAN layer within 1e-5
  (float sums in another order);
- bika training forwards: each CAC output equal, except where the two
  packages split a Sign at a pre-activation within 1e-6 of 0 (one side
  rounds the product before the add, the other may fuse them). There the
  port takes the reference's value, and the test counts those outputs;
- one training step (the loss, every gradient, every parameter after one
  AdamW update): the loss within 1e-5 relative, each leaf within 1e-4
  relative L2, the limits of chip_smoke.py's card-vs-CPU step;
- dense and qnn8 logits within 1e-5 (float matmuls summed in another
  order); digits images bit-exact; textures within 1e-5 (sin, cos, exp on
  other libraries), except where the checker's Sign flips at a product
  within 1e-5 of 0, which is counted.
"""
import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.core import bika as jbika
from repro.core import convert as jconvert
from repro.core import kan as jkan
from repro.core import thresholds as jthr
from repro.data import vision as jvision
from repro.models import paper as jpaper
from repro.nn import conv as jconv
from repro.nn.module import param_bytes as jparam_bytes
from repro.nn.module import unbox
from repro.optim.adamw import OptimizerSpec as JOptimizerSpec
from repro.optim.adamw import make_optimizer as j_make_optimizer
from repro.train import loss as jloss
from repro.train import steps as jsteps
from repro_torch.core import backend as tbackend
from repro_torch.core import bika as tbika
from repro_torch.core import convert as tconvert
from repro_torch.core import kan as tkan
from repro_torch.core import thresholds as tthr
from repro_torch.core.convert import from_reference
from repro_torch.data import vision as tvision
from repro_torch.kernels import ops
from repro_torch.launch import kan_to_bika, quickstart, table2
from repro_torch.models import paper as tpaper
from repro_torch.nn import conv as tconv
from repro_torch.nn.module import count_params, param_bytes
from repro_torch.optim.adamw import OptimizerSpec, make_optimizer, tree_leaves
from repro_torch.train import paper as tpaper_train
from repro_torch.train import steps as tsteps
from repro_torch.train.steps import make_eval_step

MODES = ("dense", "bika", "bnn", "qnn8")
SIGN_TIE = 1e-6  # |pre| within this of 0: a Sign the two packages may split
# one training step against the reference: the loss within this relative
# difference, every gradient and updated parameter within this relative L2
# difference (chip_smoke.py's card-vs-CPU limits for a training step)
TRAIN_LOSS_REL, TRAIN_REL = 1e-5, 1e-4
CNV_SMALL = dict(conv_plan=(16, 16, "P", 32, 32, "P", 64, 64, "P"), features=(64, 64, 10))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the tier-1 run
    holds several test processes at once, and torch's default of a thread
    a core in each of them oversubscribes the cores (the 200-step training
    test ran ~50x slower that way than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}/{i}")
    else:
        g, w = _np(got), np.asarray(want)
        assert g.dtype == w.dtype, (path, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=path)


# ---------------------------------------------------------------------------
# the two repairs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_backend_inter_act_and_default_bias(mode):
    """Every registered backend has the reference's default_bias and
    inter_act: the identity for bika and bnn, ReLU for dense and qnn8."""
    tbe, jbe = tbackend.get_backend(mode), jbackend.get_backend(mode)
    assert tbe.default_bias == jbe.default_bias
    assert tbe.default_bias == (mode in ("dense", "qnn8"))
    x = np.random.default_rng(0).normal(size=(5, 7)).astype(np.float32)
    np.testing.assert_array_equal(_np(tbe.inter_act(_t(x))),
                                  np.asarray(jbe.inter_act(jnp.asarray(x))))
    assert tpaper.TFC.replace(mode=mode).spec().bias == jpaper.TFC.replace(mode=mode).spec().bias


@pytest.mark.parametrize("k,m,fold", [(27, 1, True), (13, 2, True), (13, 2, False), (32, 1, True),
                                      (5, 3, True)])
def test_bika_serve_at_any_contraction_length(k, m, fold):
    """BikaBackend.apply_serve on an unpacked serve tree at a K' = m K that
    is not a multiple of 8 (CNV's first conv: 27): the integers equal the
    reference's bika_matmul_hw bit for bit, and so do the scaled outputs."""
    rng = np.random.default_rng(k * 7 + m)
    n = 11
    tau = rng.integers(-128, 128, size=(m, k, n)).astype(np.int8)
    s = np.where(rng.random((m, k, n)) < 0.5, 1, -1).astype(np.int8)
    tau[:, 0, :3] = -128  # always fires
    tau[:, 1, 3:5] = 127
    gamma = rng.uniform(0.5, 1.5, size=(n,)).astype(np.float32)
    x = rng.normal(scale=4.0, size=(3, 6, k)).astype(np.float32)
    x[0, 0, :2] = [-1e3, 1e3]  # clipped to the int8 range
    p = {"tau": tau, "s": s, "gamma": gamma}
    jspec = jbackend.LinearSpec(mode="bika", m=m, fold_m=fold)
    want = np.asarray(jbackend.get_backend("bika").apply_serve(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), jspec))
    tp = from_reference(p)
    tp["tau"], tp["s"] = tbackend.pad_contraction(tp["tau"], tp["s"])
    kp = -(-k // 8) * 8
    assert tuple(tp["tau"].shape) == tuple(tp["s"].shape) == (m, kp, n)
    assert bool((tp["tau"][:, k:] == -128).all()) and bool((tp["s"][:, k:] == 1).all())
    np.testing.assert_array_equal(_np(tp["tau"][:, :k]), tau)
    np.testing.assert_array_equal(_np(tp["s"][:, :k]), s)
    be = tbackend.get_backend("bika")
    tspec = tbackend.LinearSpec(mode="bika", m=m, fold_m=fold)
    np.testing.assert_array_equal(_np(be.apply_serve(tp, _t(x), tspec)), want)
    # the integers themselves: no scale, gamma 1
    x_int = np.clip(np.round(x / np.float32(0.05)), -128, 127).astype(np.int8).reshape(-1, k)
    ref_int = sum(np.asarray(jbika.bika_matmul_hw(jnp.asarray(x_int), jnp.asarray(tau[j]),
                                                  jnp.asarray(s[j]), clamp=False))
                  for j in range(m))
    got_int = be.apply_serve(dict(tp, gamma=torch.ones(n)), _t(x).reshape(-1, k),
                             tbackend.LinearSpec(mode="bika", m=m, fold_m=fold,
                                                 out_scale="none"))
    np.testing.assert_array_equal(_np(got_int), ref_int.astype(np.float32))


def _port_serve_layout(tree):
    """The reference's serve tree in the port's layout: an unpacked bika
    leaf's K padded to a multiple of 8 with rows tau = -128, s = +1."""
    if isinstance(tree, dict) and "tau" in tree and tree["s"].dtype == np.int8:
        pad = -tree["tau"].shape[-2] % 8
        widths = [(0, 0)] * (tree["tau"].ndim - 2) + [(0, pad), (0, 0)]
        return dict(tree, tau=np.pad(tree["tau"], widths, constant_values=-128),
                    s=np.pad(tree["s"], widths, constant_values=1))
    if isinstance(tree, dict):
        return {k: _port_serve_layout(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_port_serve_layout(v) for v in tree)
    return tree


# ---------------------------------------------------------------------------
# threshold math, KAN and the conversions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,m", [(1, 1), (8, 1), (16, 4), (24, 64), (5, 3)])
def test_thresholds_match_reference(t, m):
    rng = np.random.default_rng(t * 100 + m)
    outputs = rng.uniform(-5, 5, size=t).astype(np.float32)
    alphas = np.asarray(jthr.pwc_to_alphas(jnp.asarray(outputs)))
    np.testing.assert_array_equal(_np(tthr.pwc_to_alphas(_t(outputs))), alphas)
    np.testing.assert_allclose(_np(tthr.alphas_to_pwc(_t(alphas))),
                               np.asarray(jthr.alphas_to_pwc(jnp.asarray(alphas))), atol=1e-6)
    lo, hi = -1.5, 2.0
    bounds_j, outs_j = jthr.sample_to_pwc(lambda v: jnp.sin(3 * v), lo, hi, t)
    bounds_t, outs_t = tthr.sample_to_pwc(lambda v: torch.sin(3 * v), lo, hi, t)
    np.testing.assert_allclose(_np(bounds_t), np.asarray(bounds_j), atol=1e-6)
    np.testing.assert_allclose(_np(outs_t), np.asarray(outs_j), atol=1e-6)
    xs = rng.uniform(lo, hi, size=(3, 17)).astype(np.float32)
    bounds = np.asarray(bounds_j)
    np.testing.assert_allclose(_np(tthr.threshold_sum(_t(xs), _t(bounds), _t(alphas))),
                               np.asarray(jthr.threshold_sum(xs, bounds, alphas)), atol=1e-6)
    np.testing.assert_array_equal(_np(tthr.eval_pwc(_t(xs), _t(bounds), _t(outputs))),
                                  np.asarray(jthr.eval_pwc(jnp.asarray(xs), bounds, outputs)))
    q = np.asarray(jthr.quantize_alphas(jnp.asarray(alphas), m))
    np.testing.assert_array_equal(_np(tthr.quantize_alphas(_t(alphas), m)), q)
    assert np.abs(q).sum() == m or not alphas.any()
    taus_j, signs_j = jthr.expand_unit_thresholds(bounds, q)
    taus_t, signs_t = tthr.expand_unit_thresholds(_t(bounds), _t(q))
    np.testing.assert_array_equal(_np(taus_t), np.asarray(taus_j))
    np.testing.assert_array_equal(_np(signs_t), np.asarray(signs_j))
    fj = lambda v: 0.8 * jnp.sin(3 * v) + 0.1 * v
    ft = lambda v: 0.8 * torch.sin(3 * v) + 0.1 * v
    a_j = jthr.approximate_function(fj, lo, hi, t, m)
    a_t = tthr.approximate_function(ft, lo, hi, t, m)
    np.testing.assert_allclose(_np(a_t[0]), np.asarray(a_j[0]), atol=1e-6)
    np.testing.assert_array_equal(_np(a_t[1]), np.asarray(a_j[1]))
    assert a_t[2] == pytest.approx(a_j[2], rel=1e-6)
    # n = 509 (a prime): no point of the error's grid falls on a slot edge,
    # where an ulp between the two linspaces would flip a Sign
    err_j = jconvert.approximation_error(fj, a_j[0], a_j[1], a_j[2], lo, hi, n=509)
    err_t = tconvert.approximation_error(ft, a_t[0], a_t[1], a_t[2], lo, hi, n=509)
    assert err_t == pytest.approx(err_j, rel=1e-5, abs=1e-6)


def test_zero_function_thresholds():
    zero = np.zeros(6, np.float32)
    assert not _np(tthr.quantize_alphas(_t(zero), 4)).any()
    taus, signs, scale = tthr.approximate_function(lambda v: 0 * v, -1.0, 1.0, 6, 4)
    assert scale == 0.0 and not _np(signs).any()
    taus, signs = tthr.expand_unit_thresholds(_t(zero), _t(zero))
    assert _np(taus).tolist() == [0.0] and _np(signs).tolist() == [0.0]


def _kan_params(rng, k, n, grid, order):
    return {"coef": rng.normal(scale=0.3, size=(k, n, grid + order)).astype(np.float32),
            "w_base": (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)}


@pytest.mark.parametrize("grid,order", [(5, 3), (8, 2), (3, 1)])
def test_kan_matches_reference(grid, order):
    """bspline_basis (inside, on the knots and outside the grid),
    kan_linear_apply and kan_edge_fn within 1e-5."""
    rng = np.random.default_rng(grid + order)
    x = np.concatenate([rng.uniform(-1.3, 1.3, size=40), np.linspace(-1, 1, grid + 1)])
    x = x.astype(np.float32)
    np.testing.assert_allclose(_np(tkan.bspline_basis(_t(x), -1.0, 1.0, grid, order)),
                               np.asarray(jkan.bspline_basis(jnp.asarray(x), -1.0, 1.0, grid,
                                                             order)), atol=1e-5)
    p = _kan_params(rng, 6, 4, grid, order)
    xb = x[:42].reshape(7, 6)
    want = jkan.kan_linear_apply(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(xb),
                                 grid=grid, order=order)
    got = tkan.kan_linear_apply(from_reference(p), _t(xb), grid=grid, order=order)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    fj = jkan.kan_edge_fn(jax.tree_util.tree_map(jnp.asarray, p), 2, 3, grid=grid, order=order)
    ft = tkan.kan_edge_fn(from_reference(p), 2, 3, grid=grid, order=order)
    np.testing.assert_allclose(_np(ft(_t(x))), np.asarray(fj(jnp.asarray(x))), atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    init = tkan.kan_linear_init(gen, 6, 4, grid=grid, order=order)
    assert init["coef"].shape == (6, 4, grid + order) and init["w_base"].shape == (6, 4)


def test_kan_conversion_matches_reference():
    """kan_layer_to_thresholds (every edge to m unit thresholds) and the
    converted layer's forward against the reference."""
    rng = np.random.default_rng(4)
    p = _kan_params(rng, 5, 3, 5, 3)
    p["coef"][1, 2] = 0.0
    p["w_base"][1, 2] = 0.0  # an all-zero edge: no thresholds, scale 0
    want = jconvert.kan_layer_to_thresholds(jax.tree_util.tree_map(jnp.asarray, p), t_slots=12,
                                            m=4)
    got = tconvert.kan_layer_to_thresholds(from_reference(p), t_slots=12, m=4)
    np.testing.assert_allclose(_np(got["tau"]), np.asarray(want["tau"]), atol=1e-6)
    np.testing.assert_array_equal(_np(got["s"]), np.asarray(want["s"]))
    np.testing.assert_allclose(_np(got["scale"]), np.asarray(want["scale"]), rtol=1e-5, atol=1e-7)
    assert not _np(got["s"])[:, 1, 2].any()
    x = rng.uniform(-1, 1, size=(4, 5)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tconvert.threshold_layer_apply(got, _t(x))),
        np.asarray(jconvert.threshold_layer_apply(want, jnp.asarray(x))), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# BiKA layers: the saturating accumulator and the layer forms
# ---------------------------------------------------------------------------


def _bika_case(rng, m, k, n, b=6):
    w = rng.uniform(-0.5, 0.5, size=(m, k, n)).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, size=(m, k, n)).astype(np.float32)
    w[0, 0, 0] = 0.0  # a degenerate edge: always fires with Sign(beta)
    x = rng.normal(scale=2.0, size=(b, k)).astype(np.float32)
    return w, beta, x


@pytest.mark.parametrize("k", [9, 200, 400])
def test_saturating_accumulate_and_hw_exact(k):
    """The 8-bit PE's accumulator bit for bit: saturating after every term
    (K = 200 and 400 leave [-128, 127] and come back), and bika_matmul_hw
    with and without hw_exact, clamped and unclamped."""
    rng = np.random.default_rng(k)
    terms = np.where(rng.random((k, 4, 5)) < 0.8, 1, -1).astype(np.int32)
    terms[:, 0, 0] = 1  # runs into the upper bound and stays there
    np.testing.assert_array_equal(_np(tbika.saturating_accumulate(_t(terms))),
                                  np.asarray(jbika.saturating_accumulate(jnp.asarray(terms))))
    w, beta, x = _bika_case(rng, 1, k, 7)
    tau, s = (np.asarray(a) for a in jbika.to_hardware(jnp.asarray(w[0]), jnp.asarray(beta[0])))
    for kw in (dict(hw_exact=True), dict(), dict(clamp=False)):
        want = np.asarray(jbika.bika_matmul_hw(jnp.asarray(x), tau, s, **kw))
        got = tbika.bika_matmul_hw(_t(x), _t(tau), _t(s), **kw)
        np.testing.assert_array_equal(_np(got), want, err_msg=str(kw))
    np.testing.assert_array_equal(_np(tbika.bika_matmul_hw_tiled(_t(x), _t(tau), _t(s))),
                                  np.asarray(jbika.bika_matmul_hw_tiled(jnp.asarray(x), tau, s)))


def _sign_clear(x2, w, beta):
    """(rows, N) outputs whose K reduction holds no |pre| <= SIGN_TIE."""
    return (np.abs(x2[:, :, None] * w[None] + beta[None]) > SIGN_TIE).all(axis=1)


@pytest.mark.parametrize("cfg", [
    dict(), dict(m=2), dict(m=2, fold_m=False), dict(m=3, chunk=7), dict(out_scale="rsqrt_k"),
    dict(m=2, hw_exact=True), dict(hw_exact=True, out_scale="rsqrt_k")])
def test_bika_linear_and_conv_match_reference(cfg):
    """bika_linear_apply and bika_conv2d_apply under every BikaConfig
    option: bit-exact where no Sign lies within 1e-6 of 0."""
    rng = np.random.default_rng(len(cfg) * 13 + cfg.get("m", 1))
    m, k, n = cfg.get("m", 1), 12, 9
    w, beta, x = _bika_case(rng, m, k, n)
    jcfg, tcfg = jbika.BikaConfig(**cfg), tbika.BikaConfig(**cfg)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    p = {"w": w, "beta": beta}
    want = np.asarray(jbika.bika_linear_apply(jax.tree_util.tree_map(jnp.asarray, p),
                                              jnp.asarray(x), jcfg))
    got = _np(tbika.bika_linear_apply(from_reference(p), _t(x), tcfg))
    clear = np.all([_sign_clear(x, w[j], beta[j]) for j in range(m)], axis=0)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(np.where(clear, got, 0), np.where(clear, want, 0))
    # the conv form: C_in = 3, 3 x 3 patches (K = 27), an odd image
    w, beta, _ = _bika_case(rng, m, 27, 5)
    img = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    p = {"w": w, "beta": beta}
    want = np.asarray(jbika.bika_conv2d_apply(jax.tree_util.tree_map(jnp.asarray, p),
                                              jnp.asarray(img), cfg=jcfg))
    got = _np(tbika.bika_conv2d_apply(from_reference(p), _t(img), cfg=tcfg))
    assert got.shape == want.shape == (2, 5, 7, 5)
    patches = np.asarray(jax.lax.conv_general_dilated_patches(
        jnp.asarray(img), (3, 3), (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    clear = np.all([_sign_clear(patches.reshape(-1, 27), w[j], beta[j]) for j in range(m)],
                   axis=0).reshape(want.shape)
    np.testing.assert_array_equal(np.where(clear, got, 0), np.where(clear, want, 0))
    gen = torch.Generator().manual_seed(1)
    init = tbika.bika_conv2d_init(gen, 3, 5, m=m)
    assert init["w"].shape == init["beta"].shape == (m, 27, 5)
    assert float(init["w"].abs().max()) <= 1 / np.sqrt(27)


def test_bika_cvjp_tiled_and_hw_int8_export():
    """bika_matmul_cvjp(tiled=True): the reference's values and STE
    gradients from the row-sliced plain forms; bika_params_to_hw_int8 equal
    to the reference's."""
    rng = np.random.default_rng(11)
    w, beta, x = _bika_case(rng, 1, 30, 9, b=10)
    w, beta = w[0], beta[0]
    g = rng.normal(size=(10, 9)).astype(np.float32)
    y, pull = jax.vjp(lambda *a: jbika.bika_matmul_cvjp(*a, tiled=True), jnp.asarray(x),
                      jnp.asarray(w), jnp.asarray(beta))
    want = [np.asarray(a) for a in pull(jnp.asarray(g))]
    tx, tw, tb = (_t(a).requires_grad_(True) for a in (x, w, beta))
    ty = tbika.bika_matmul_cvjp(tx, tw, tb, tiled=True)
    ty.backward(_t(g))
    np.testing.assert_array_equal(_np(ty), np.asarray(y))
    for name, got, ref in zip(("dx", "dw", "dbeta"), (tx.grad, tw.grad, tb.grad), want):
        np.testing.assert_allclose(_np(got), ref, atol=1e-4, rtol=1e-4, err_msg=name)
    p = {"w": w, "beta": beta}
    want = jconvert.bika_params_to_hw_int8(jax.tree_util.tree_map(jnp.asarray, p), 0.05)
    got = tconvert.bika_params_to_hw_int8(from_reference(p), 0.05)
    for a, b in zip(got[:2], want[:2]):
        assert _np(a).dtype == np.asarray(b).dtype == np.int8
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert got[2] == want[2] == 0.05


# ---------------------------------------------------------------------------
# conv, pool and the module helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,kh,stride,padding", [
    (8, 8, 3, 1, "SAME"), (5, 7, 3, 1, "SAME"), (7, 6, 3, 2, "SAME"), (6, 9, 5, 2, "SAME"),
    (7, 7, 3, 1, "VALID"), (9, 8, 3, 2, "VALID")])
def test_extract_patches_match_reference(h, w, kh, stride, padding):
    """im2col in conv_general_dilated_patches' (C, kh, kw) order and its
    SAME padding, bit for bit."""
    x = np.random.default_rng(h * w).normal(size=(2, h, w, 3)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), (kh, kh), (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = tconv.extract_patches(_t(x), kh, kh, stride, padding)
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("h,w", [(8, 8), (5, 7), (1, 3)])
def test_maxpool2d_matches_reference(h, w):
    """SAME pooling, a ragged edge padded with -inf at the end."""
    x = np.random.default_rng(h + w).normal(size=(2, h, w, 4)).astype(np.float32)
    x[0, -1, -1, 0] = -50.0  # alone in its window at an odd size
    want = np.asarray(jconv.maxpool2d(jnp.asarray(x)))
    got = tconv.maxpool2d(_t(x))
    assert got.shape == want.shape
    np.testing.assert_array_equal(_np(got), want)


def test_module_sizes_match_reference():
    tree = {"a": [np.zeros((3, 4), np.float32), np.zeros((5,), np.int8)],
            "b": {"c": np.zeros((2, 2, 2), np.uint8)}}
    assert param_bytes(from_reference(tree)) == jparam_bytes(tree) == 48 + 5 + 8
    assert count_params(from_reference(tree)) == 12 + 5 + 8


@contextlib.contextmanager
def held_cac_outputs(monkeypatch):
    """Hold the port's bika training CAC outputs to the reference's. The
    reference records every ``bika_matmul`` output (in call order); the
    port's ``ops.cac_train_matmul`` compares its own: where they differ,
    each difference must be even and at most twice the number of the
    port's pre-activations in that output's reduction within SIGN_TIE of
    0, and the port takes the reference's value. Yields the counts."""
    queue = []
    stats = {"outputs": 0, "held": 0, "near_zero": 0}
    # the reference's CAC contractions each in one compilation (integer
    # sums: jit changes nothing but where a Sign ties, which is held here)
    j_mm = jax.jit(jbika.bika_matmul, static_argnames=("chunk",))
    j_hw = jax.jit(jbika.bika_matmul_hw, static_argnames=("hw_exact", "clamp", "acc_dtype"))
    t_mm = ops.cac_train_matmul

    def record(x, w, beta, chunk=None):
        y = j_mm(x, w, beta, chunk=chunk)
        queue.append(np.asarray(y))
        return y

    def follow(x, w, beta, **kw):
        y = t_mm(x, w, beta, **kw)
        ref = _t(queue.pop(0)).reshape(y.shape)
        stats["outputs"] += y.numel()
        diff = (ref != y.detach()).reshape(-1, w.shape[1])
        if bool(diff.any()):
            x2 = x.detach().reshape(-1, x.shape[-1])
            d = (ref - y.detach()).reshape(-1, w.shape[1]).abs()
            for r in diff.any(dim=1).nonzero()[:, 0].tolist():
                near = ((x2[r, :, None] * w + beta).abs() <= SIGN_TIE).sum(dim=0)
                assert not bool((diff[r] & ((d[r] > 2 * near) | (d[r] % 2 != 0))).any())
                stats["near_zero"] += int(near[diff[r]].sum())
            stats["held"] += int(diff.sum())
        return y + torch.where(ref != y.detach(), ref - y.detach(), 0)

    monkeypatch.setattr(jbika, "bika_matmul", record)
    monkeypatch.setattr(jbika, "bika_matmul_hw", j_hw)
    monkeypatch.setattr(ops, "cac_train_matmul", follow)
    yield stats
    assert not queue, "the port left reference outputs untaken"


@pytest.mark.parametrize("mode", MODES)
def test_conv2d_apply_all_modes(mode, monkeypatch):
    """One CNV conv (C_in 3 -> 16, K = 27) in every mode, train and serve
    form, from the reference's init."""
    jspec = jpaper.CNV.replace(mode=mode).spec()
    tspec = tpaper.CNV.replace(mode=mode).spec()
    jp = _np_tree(unbox(jconv.conv2d_init(jax.random.PRNGKey(1), 3, 16, jspec)))
    img = np.random.default_rng(2).uniform(-1, 1, size=(2, 6, 6, 3)).astype(np.float32)
    with held_cac_outputs(monkeypatch) as held:
        want = np.asarray(jconv.conv2d_apply(jax.tree_util.tree_map(jnp.asarray, jp),
                                             jnp.asarray(img), jspec))
        got = _np(tconv.conv2d_apply(from_reference(jp), _t(img), tspec))
    assert got.shape == want.shape == (2, 6, 6, 16)
    _assert_close(mode, got, want)
    assert held["held"] <= 2
    jsp = _np_tree(jconvert.tree_to_serve(jp, jspec))
    tsp = tconvert.tree_to_serve(from_reference(jp), tspec)
    _assert_tree_equal(tsp, _port_serve_layout(jsp))
    want = np.asarray(jconv.conv2d_apply(jax.tree_util.tree_map(jnp.asarray, jsp),
                                         jnp.asarray(img), jspec, phase="serve"))
    got = _np(tconv.conv2d_apply(tsp, _t(img), tspec, phase="serve"))
    _assert_close(mode, got, want)


def _assert_close(mode, got, want):
    if mode in ("dense", "qnn8"):  # float matmuls summed in another order
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the paper models
# ---------------------------------------------------------------------------


def _assert_same_config(tcfg, jcfg):
    """The port's PaperConfig fields equal the reference's. The reference's
    one field more, hw_exact, is read by none of its models; it stays False."""
    want = dataclasses.asdict(jcfg)
    assert want.pop("hw_exact") is False
    assert dataclasses.asdict(tcfg) == want


def _cfgs(name):
    base = {"tfc": "TFC", "sfc": "SFC", "lfc": "LFC", "cnv": "CNV"}[name]
    jcfg, tcfg = getattr(jpaper, base), getattr(tpaper, base)
    if name == "cnv":
        jcfg, tcfg = jcfg.replace(**CNV_SMALL), tcfg.replace(**CNV_SMALL)
    return jcfg, tcfg


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["tfc", "sfc", "lfc", "cnv"])
def test_paper_model_forward_matches_reference(name, mode, monkeypatch):
    """Every paper model in every mode (CNV at the reduced conv plan of
    tests/test_paper_models.py): the train-form logits from the reference's
    init, the serve trees from paper_model_to_serve and the served logits."""
    jcfg, tcfg = (c.replace(mode=mode) for c in _cfgs(name))
    _assert_same_config(tcfg, jcfg)
    jinit, japply = jpaper.build_paper_model(jcfg)
    # the initial values are the inputs of both sides: drawn in one
    # compilation; the forwards run op by op, as the reference's tests do
    jp = _np_tree(unbox(jax.jit(jinit)(jax.random.PRNGKey(0))))
    tinit, tapply = tpaper.build_paper_model(tcfg, device="cpu")
    tp = from_reference(jp)
    own = tinit(0)  # the port's own init: the same tree shapes
    assert ([tuple(a.shape) for a in tree_leaves(own)]
            == [a.shape for a in jax.tree_util.tree_leaves(jp)])
    batch = tvision.textures_batch if name == "cnv" else tvision.digits_batch
    x = _np(batch(0, 0, 2 if name == "cnv" else 4, device="cpu")[0])
    with held_cac_outputs(monkeypatch) as held:
        want = np.asarray(japply(jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x)))
        got = _np(tapply(tp, _t(x)))
    assert got.shape == want.shape == (x.shape[0], 10) and got.dtype == np.float32
    _assert_close(mode, got, want)
    # a held output is a Sign split at |pre| <= 1e-6; none at these seeds
    assert held["held"] == 0, held
    jsp = _np_tree(jpaper.paper_model_to_serve(jp, jcfg))
    tsp = tpaper.paper_model_to_serve(tp, tcfg)
    _assert_tree_equal(tsp, _port_serve_layout(jsp))
    _, jserve = jpaper.build_paper_model(jcfg, phase="serve")
    _, tserve = tpaper.build_paper_model(tcfg, phase="serve", device="cpu")
    want = np.asarray(jserve(jax.tree_util.tree_map(jnp.asarray, jsp), jnp.asarray(x)))
    _assert_close(mode, _np(tserve(tsp, _t(x))), want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["tfc", "cnv"])
def test_paper_model_train_step_matches_reference(name, mode, monkeypatch):
    """One training step of TFC and of CNV (the reduced conv plan) in every
    mode, from the reference's init on one batch, against the reference's
    recipe (benchmarks/common.py: value_and_grad of softmax_xent, then one
    AdamW update): the loss, every gradient (through im2col, the SAME
    max-pool and, in bika, the STE of every layer) and every parameter
    after the update. CAC outputs held as in the forward test."""
    jcfg, tcfg = (c.replace(mode=mode) for c in _cfgs(name))
    jinit, japply = jpaper.build_paper_model(jcfg)
    jp = _np_tree(unbox(jax.jit(jinit)(jax.random.PRNGKey(3))))
    batch = tvision.textures_batch if name == "cnv" else tvision.digits_batch
    x, y = (_np(a) for a in batch(0, 4, 2 if name == "cnv" else 4, device="cpu"))
    jtree = jax.tree_util.tree_map(jnp.asarray, jp)
    want_loss, want_g = jax.value_and_grad(
        lambda p: jloss.softmax_xent(japply(p, jnp.asarray(x)), jnp.asarray(y))[0])(jtree)
    ospec = dict(peak_lr=3e-3, warmup=10, total_steps=100, weight_decay=0.0)
    j_init, j_update = j_make_optimizer(JOptimizerSpec(**ospec))
    # the update in one compilation (float arithmetic only: no Sign to split)
    want_p = jax.jit(j_update)(want_g, jax.jit(j_init)(jtree), jtree)[0]
    _, tapply = tpaper.build_paper_model(tcfg, device="cpu")
    tp = from_reference(jp)
    with held_cac_outputs(monkeypatch) as held:
        japply(jtree, jnp.asarray(x))  # the reference's CAC outputs, in call order
        metrics, grads = tsteps.loss_and_grads(tpaper_train.image_api(tapply), tp,
                                               {"x": _t(x), "labels": _t(y)},
                                               **tpaper_train.PAPER_LOSS)
    assert held["held"] == 0, held  # none at these seeds
    t_init, t_update = make_optimizer(OptimizerSpec(**ospec))
    got_p = t_update(grads, t_init(tp), tp)[0]
    assert float(metrics["loss"]) == pytest.approx(float(want_loss), rel=TRAIN_LOSS_REL)
    for what, got, want in (("gradient", grads, want_g), ("parameter", got_p, want_p)):
        want = jax.tree_util.tree_leaves(want)
        assert len(tree_leaves(got)) == len(want)
        for i, (a, b) in enumerate(zip(tree_leaves(got), want)):
            a, b = _np(a), np.asarray(b)
            assert a.shape == b.shape, (what, i)
            rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            assert rel <= TRAIN_REL, (what, i, a.shape, rel)


def test_paper_models_and_kinds():
    assert set(tpaper.PAPER_MODELS) == set(jpaper.PAPER_MODELS)
    for name, cfg in tpaper.PAPER_MODELS.items():
        _assert_same_config(cfg, jpaper.PAPER_MODELS[name])
    with pytest.raises(ValueError):
        tpaper.build_paper_model(tpaper.TFC.replace(kind="rnn"), device="cpu")


# ---------------------------------------------------------------------------
# data, eval step, training and the launchers
# ---------------------------------------------------------------------------


def _reference_draws(kind, key, n):
    if kind == "digits":
        kl, kx, ky, ks, kn, kd = jax.random.split(key, 6)
        return {"labels": jax.random.randint(kl, (n,), 0, 10),
                "scale": jax.random.uniform(ks, (n,), minval=2.2, maxval=3.2),
                "ox": jax.random.uniform(kx, (n,), minval=2.0, maxval=26.0 - 5 * 2.2),
                "oy": jax.random.uniform(ky, (n,), minval=2.0, maxval=26.0 - 7 * 2.2),
                "blur": jax.random.uniform(kd, (n, 1, 1), minval=0.75, maxval=1.0),
                "noise": jax.random.uniform(kn, (n, 28, 28))}
    kl, kf, kp, kc, kn, kb = jax.random.split(key, 6)
    return {"labels": jax.random.randint(kl, (n,), 0, 10),
            "freq": jax.random.uniform(kf, (n,), minval=2.0, maxval=5.0),
            "phase": jax.random.uniform(kp, (n,), minval=0.0, maxval=2 * jnp.pi),
            "color": jax.random.uniform(kc, (n, 3), minval=0.3, maxval=1.0),
            "noise": jax.random.uniform(kn, (n, 32, 32, 3)),
            "bias": jax.random.uniform(kb, (n, 1, 1, 3))}


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5), (10_000, 90_001)])
def test_digits_render_matches_reference(seed, step):
    """The reference's draws through the port's render: bit-equal images."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    draws = {k: _t(v) for k, v in _reference_draws("digits", key, 64).items()}
    want_x, want_y = jvision.digits_batch(seed, step, 64)
    got_x, got_y = tvision.render_digits(**draws)
    np.testing.assert_array_equal(_np(got_x), np.asarray(want_x))
    np.testing.assert_array_equal(_np(got_y), np.asarray(want_y))


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5), (10_000, 90_001)])
def test_textures_render_matches_reference(seed, step):
    """The reference's draws through the port's render: within 1e-5, except
    where the checker's Sign flips at a product within 1e-5 of 0."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    rd = _reference_draws("textures", key, 64)
    draws = {k: _t(v) for k, v in rd.items()}
    want_x, want_y = jvision.textures_batch(seed, step, 64)
    got_x, got_y = tvision.render_textures(**draws)
    np.testing.assert_array_equal(_np(got_y), np.asarray(want_y))
    diff = np.abs(_np(got_x) - np.asarray(want_x))
    # where the checker class's product sin(.)sin(.) is within 1e-5 of 0
    lin = np.linspace(-1, 1, 32)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    lab = np.asarray(rd["labels"])
    ang = lab[:, None, None] * np.pi / 10
    f, ph = np.asarray(rd["freq"])[:, None, None], np.asarray(rd["phase"])[:, None, None]
    u = xx * np.cos(ang) + yy * np.sin(ang)
    v = -xx * np.sin(ang) + yy * np.cos(ang)
    prod = np.sin(2 * np.pi * f * u + ph) * np.sin(2 * np.pi * f * v)
    flip_ok = ((lab % 4 == 1)[:, None, None] & (np.abs(prod) < 1e-5))[..., None]
    flips = int(((diff > 1e-5) & flip_ok).sum())
    assert not ((diff > 1e-5) & ~flip_ok).any(), diff.max()
    assert flips <= 3 * 4  # a pixel or two, three channels each


def test_batches_are_device_independent_and_deterministic():
    x1, y1 = tvision.digits_batch(1, 2, 8, device="cpu")
    x2, y2 = tvision.make_digits(tvision._gen(1, 2), 8, device="cpu")
    np.testing.assert_array_equal(_np(x1), _np(x2))
    x3, _ = tvision.digits_batch(1, 3, 8, device="cpu")
    assert not np.array_equal(_np(x1), _np(x3))
    xt, yt = tvision.textures_batch(0, 0, 4, device="cpu")
    assert xt.shape == (4, 32, 32, 3) and float(xt.abs().max()) <= 1.0
    assert x1.shape == (8, 28, 28, 1) and y1.dtype == torch.int64


def test_make_eval_step_matches_reference():
    """make_eval_step on a paper model's apply: the reference's metrics."""
    jcfg, tcfg = jpaper.TFC.replace(mode="dense"), tpaper.TFC.replace(mode="dense")
    jinit, japply = jpaper.build_paper_model(jcfg)
    jp = _np_tree(unbox(jinit(jax.random.PRNGKey(2))))
    _, tapply = tpaper.build_paper_model(tcfg, device="cpu")
    x, y = (_np(a) for a in tvision.digits_batch(0, 7, 4, device="cpu"))
    mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    jbatch = {"x": x, "labels": y, "mask": jnp.asarray(mask)}
    want = jsteps.make_eval_step(types.SimpleNamespace(apply=lambda p, b: japply(p, b["x"])))(
        jax.tree_util.tree_map(jnp.asarray, jp), jbatch)
    tbatch = {"x": _t(x), "labels": _t(y), "mask": _t(mask)}
    got = make_eval_step(types.SimpleNamespace(apply=lambda p, b: tapply(p, b["x"])))(
        from_reference(jp), tbatch)
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6), k
    assert not got["loss"].requires_grad


def test_train_paper_model_bika_beats_chance():
    """A short BiKA TFC run beats chance by a wide margin, as the
    reference's tests/test_paper_models.py asserts; the trained tree keeps
    its shapes."""
    r = tpaper_train.train_paper_model(tpaper.TFC.replace(mode="bika"), "digits", steps=200,
                                       batch=128, lr=3e-3, device="cpu")
    assert r["val_acc"] > 0.3, r["val_acc"]  # chance = 0.1
    assert 0.0 <= r["train_acc"] <= 1.0
    assert [p["w"].shape for p in r["params"]] == [(1, 784, 64), (1, 64, 32), (1, 32, 10)]


def test_entry_points_raise_without_a_gpu(monkeypatch):
    """Every entry point of the slice defaults to CUDA and raises without
    it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tpaper.build_paper_model(tpaper.TFC),
                 lambda: tvision.digits_batch(0, 0, 2),
                 lambda: tvision.textures_batch(0, 0, 2),
                 lambda: tpaper_train.train_paper_model(tpaper.TFC, steps=1),
                 lambda: quickstart.main(["--steps", "1"]),
                 lambda: table2.main(["--steps", "1"]),
                 lambda: kan_to_bika.main([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_launchers_on_cpu(capsys, tmp_path):
    """The quickstart (its checks (a) >= 99 % and (b) bit-equal hold
    whatever the training reached), Table II at a few steps and the
    KAN -> BiKA demo, on the CPU."""
    assert quickstart.main(["--steps", "3", "--batch", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "agree on 100.00% of units" in out and "quickstart OK" in out
    path = tmp_path / "t2.json"
    assert table2.main(["--steps", "2", "--batch", "8", "--device", "cpu", "--out",
                        str(path)]) == 0
    import json

    res = json.loads(path.read_text())
    assert set(res["accuracy"]) == {"tfc", "sfc"}
    assert set(res["accuracy"]["sfc"]) == {"dense", "qnn8", "bnn", "bika", "kan"}
    assert set(res["claims"]) >= {"tfc_order_qnn>bnn>bika", "bnn_bika_gap_shrinks",
                                  "bika_overtakes_kan_at_sfc"}
    assert kan_to_bika.main(["--device", "cpu"]) == 0
    assert "conversion demo OK" in capsys.readouterr().out
