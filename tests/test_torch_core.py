"""PyTorch port vs the JAX reference: core conversion math and the
registry's bika/dense serve forwards, on the CPU (plain versions).

Same numpy inputs through both packages. Integer-valued results (packed
sign planes, tau/s, quantized thresholds, activation codes, CAC sums) are
held bit-exact; the bika projection output is an exact integer sum times
the same float scale, so it is held bit-exact too."""
import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.core import backend as jbackend
from repro.core import bika as jbika
from repro.core.convert import tree_to_serve as jax_tree_to_serve
from repro.models import build_model as jax_build_model
from repro.nn.module import unbox
from repro_torch.core import backend as tbackend
from repro_torch.core import bika as tbika
from repro_torch.core.convert import from_reference, tree_to_serve
from repro_torch.models.base import ArchConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the tier-1 run
    holds several test processes at once, and torch's default of a thread
    a core in each of them oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    g = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.dtype == w.dtype, (path, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("shape", [(16, 5), (3, 24, 7), (2, 1, 8, 3)])
def test_pack_unpack_bit_order(shape):
    rng = np.random.default_rng(0)
    s = np.where(rng.random(shape) < 0.5, 1, -1).astype(np.int8)
    packed = tbackend.pack_signs(torch.from_numpy(s))
    want = np.asarray(jbackend.pack_signs(jnp.asarray(s)))
    np.testing.assert_array_equal(packed.numpy(), want)
    assert packed.dtype == torch.uint8
    back = tbackend.unpack_signs(packed, shape[-2])
    np.testing.assert_array_equal(back.numpy(), s)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jbackend.unpack_signs(jnp.asarray(want), shape[-2])))


def test_to_hardware_edge_cases_bit_exact():
    """w<0 (nextafter nudge), |w|<1e-8 (always-fire tau, Sign(beta)), w==0
    with beta==0 (Sign(0)=+1) and exact ties on the threshold grid."""
    rng = np.random.default_rng(1)
    w = rng.uniform(-1, 1, size=(2, 12, 9)).astype(np.float32)
    beta = rng.uniform(-1, 1, size=(2, 12, 9)).astype(np.float32)
    w[0, 0, :4] = [0.0, 1e-9, -1e-9, 0.0]
    beta[0, 0, :4] = [0.3, -0.2, 0.0, 0.0]
    w[0, 1, :3] = [-1.0, -0.5, 2.0]
    beta[0, 1, :3] = [0.05, 0.125, -0.1]  # -beta/w lands on grid points
    beta[1, 2, :] = 0.0
    tau_t, s_t = tbika.to_hardware(torch.from_numpy(w), torch.from_numpy(beta))
    tau_j, s_j = jbika.to_hardware(jnp.asarray(w), jnp.asarray(beta))
    np.testing.assert_array_equal(tau_t.numpy(), np.asarray(tau_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    qt, _ = tbika.quantize_thresholds(tau_t, 0.05)
    qj, _ = jbika.quantize_thresholds(tau_j, 0.05)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    # half-way points round to even on both sides
    ties = ((np.arange(-8, 8) + 0.5) * 0.05).astype(np.float32)
    np.testing.assert_array_equal(
        tbika.quantize_thresholds(torch.from_numpy(ties), 0.05)[0].numpy(),
        np.asarray(jbika.quantize_thresholds(jnp.asarray(ties), 0.05)[0]))


def test_fold_and_tile_row_order():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(3, 4, 5)).astype(np.float32)
    b = rng.normal(size=(3, 4, 5)).astype(np.float32)
    x = rng.normal(size=(2, 6, 4)).astype(np.float32)
    for got, want in zip(tbika.fold_m_axis(torch.from_numpy(w), torch.from_numpy(b)),
                         jbika.fold_m_axis(jnp.asarray(w), jnp.asarray(b))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tbika.tile_m_axis(torch.from_numpy(x), 3).numpy(),
                                  np.asarray(jbika.tile_m_axis(jnp.asarray(x), 3)))


def test_bika_matmul_hw_plain_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.integers(-128, 128, size=(5, 24)).astype(np.int8)
    tau = rng.integers(-128, 128, size=(24, 7)).astype(np.int8)
    s = np.where(rng.random((24, 7)) < 0.5, 1, -1).astype(np.int8)
    for clamp in (True, False):
        got = tbika.bika_matmul_hw(torch.from_numpy(x), torch.from_numpy(tau),
                                   torch.from_numpy(s), clamp=clamp)
        want = jbika.bika_matmul_hw(jnp.asarray(x), jnp.asarray(tau), jnp.asarray(s),
                                    clamp=clamp)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tree_to_serve_on_stacked_tree():
    """A stacked (L, ...) JAX train tree converts to the same serve tree in
    both packages, leaf for leaf and bit for bit."""
    cfg = jax_get_smoke("smollm-360m", compute_mode="bika", pack_signs=True, bika_m=2,
                        remat=False)
    train = _np_tree(unbox(jax_build_model(cfg, phase="train").init(jax.random.PRNGKey(4))))
    want = _np_tree(jax_tree_to_serve(jax.tree_util.tree_map(jnp.asarray, train),
                                      cfg.linear_spec()))
    spec = ArchConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(ArchConfig)}
                      ).linear_spec()
    got = tree_to_serve(from_reference(train), spec)
    _assert_tree_equal(got, want)
    _assert_tree_equal(from_reference(want), want)


@pytest.mark.parametrize("m,pack", [(1, True), (2, True), (1, False)])
@pytest.mark.parametrize("impl", ["cvjp", "pallas"])
def test_bika_apply_serve_matches_reference(m, pack, impl):
    """The port's apply_serve (plain CAC on CPU) against the JAX cvjp
    (XLA bika_matmul_hw) and pallas (interpret-mode kernel) impls."""
    rng = np.random.default_rng(5 + m)
    k, n = 24, 20
    w = rng.uniform(-0.3, 0.3, size=(m, k, n)).astype(np.float32)
    beta = rng.uniform(-0.3, 0.3, size=(m, k, n)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, size=(n,)).astype(np.float32)
    x = (rng.normal(size=(3, 4, k)) * 2.0).astype(np.float32)
    x[0, 0, :4] = [0.025, -0.075, 0.125, 6.4]  # half-way codes and clipping
    jspec = jbackend.LinearSpec(mode="bika", m=m, impl=impl, pack_signs=pack)
    tspec = tbackend.LinearSpec(mode="bika", m=m, impl=impl, pack_signs=pack)
    jb, tb = jbackend.get_backend("bika"), tbackend.get_backend("bika")
    jserve = jb.to_serve({"w": jnp.asarray(w), "beta": jnp.asarray(beta),
                          "gamma": jnp.asarray(gamma)}, jspec)
    tserve = from_reference(_np_tree(jserve))
    want = np.asarray(jb.apply_serve(jserve, jnp.asarray(x), jspec))
    got = tb.apply_serve(tserve, torch.from_numpy(x), tspec).numpy()
    np.testing.assert_array_equal(got, want)


def test_dense_apply_serve_matches_reference():
    rng = np.random.default_rng(9)
    w = rng.normal(size=(16, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    spec = jbackend.LinearSpec(mode="dense", bias=True)
    want = np.asarray(jbackend.get_backend("dense").apply_serve(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), spec))
    got = tbackend.get_backend("dense").apply_serve(
        {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, torch.from_numpy(x),
        tbackend.LinearSpec(mode="dense", bias=True))
    # float32 products summed in another order: a few ulps
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _port_files():
    base = os.path.join(ROOT, "src", "repro_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(base):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_port_imports_neither_jax_nor_reference():
    """AST scan: src/repro_torch/ and chip_smoke.py import no jax and
    nothing of the repro package."""
    bad = []
    files = _port_files()
    assert len(files) > 20
    rel = {os.path.relpath(f, os.path.join(ROOT, "src", "repro_torch")) for f in files}
    for module in ("core/ste.py", "kernels/cac_matmul.py", "kernels/ops.py", "train/steps.py",
                   "train/trainer.py", "train/loss.py", "optim/adamw.py", "optim/schedule.py",
                   "data/lm.py", "launch/train.py", "core/bnn.py", "kernels/bnn_matmul.py",
                   "core/qnn.py", "kernels/qnn_matmul.py", "serve/kv.py", "serve/spec.py",
                   "models/paper.py", "nn/conv.py", "nn/module.py", "core/thresholds.py",
                   "core/kan.py", "data/vision.py", "train/paper.py", "launch/quickstart.py",
                   "launch/table2.py", "launch/kan_to_bika.py", "checkpoint/manager.py",
                   "obs/trace.py", "obs/registry.py", "obs/profile.py", "nn/ssm.py",
                   "nn/xlstm_blocks.py", "models/hybrid.py", "models/xlstm.py",
                   "configs/zamba2_27b.py", "configs/xlstm_125m.py", "models/encdec.py",
                   "configs/seamless_m4t_large_v2.py", "distributed/sharding.py",
                   "distributed/constraints.py", "distributed/meshes.py", "distributed/comm.py",
                   "distributed/tp.py", "distributed/spawn.py", "launch/mesh.py"):
        assert module in rel, module
    for path in files:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "repro"):
                    bad.append(f"{os.path.relpath(path, ROOT)}:{node.lineno} imports {name}")
    assert not bad, bad
