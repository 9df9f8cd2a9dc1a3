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
from _torch_cases import PAGED_CASES, cac_case, paged_case

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.paged_attn import paged_attn_kernel_call as jax_paged_attn
from repro_torch.core.backend import pack_signs
from repro_torch.kernels import ops, ref
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
