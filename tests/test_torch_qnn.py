"""PyTorch port vs the JAX reference: the qnn8 slice on the CPU.

- ``core/qnn.py`` function by function: integers exact, the fake-quant
  values and their straight-through gradients within 1e-6;
- ``ops.qnn_matmul``'s plain version (kernel 10's) bit-equal to the
  reference's Pallas kernel (interpret mode) where that kernel is exact
  (its float32 partials per 512-wide K block hold every integer while
  K * 128 * 127 < 2^24, K <= 1032), and to ``qnn_matmul_ref`` everywhere:
  K = 2560 with full-range codes, and ragged M, K, N;
- ``Qnn8Backend``: ``to_serve`` equal to the reference's, ``apply_serve``
  equal to its ``impl="pallas"`` and default (XLA) routes;
- the smoke model's paged prefill and decode logits within 1e-4, and the
  paged engine's tokens equal, fp and int8 KV, with activation and K/V codes
  held at genuine half-way ties (``test_torch_lm.held_codes``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cases import H100_STREAM_BLOCKS, QNN_KERNEL_SHAPES, qnn_case
from test_torch_lm import ATOL, held_codes, port_cfg

from repro.configs import get_smoke as jax_get_smoke
from repro.core import qnn as jqnn
from repro.core.backend import LinearSpec as JaxLinearSpec
from repro.core.backend import get_backend as jax_get_backend
from repro.core.convert import tree_to_serve as jax_tree_to_serve
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build_model as jax_build_model
from repro.nn.module import unbox
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.core import qnn as tqnn
from repro_torch.core.backend import LinearSpec, get_backend
from repro_torch.core.convert import from_reference, tree_to_serve
from repro_torch.kernels import ops
from repro_torch.kernels import qnn_matmul as tk
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine

FQ_TOL = 1e-6  # fake-quant values and gradients: float32 ops in other orders


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
    return torch.from_numpy(np.ascontiguousarray(a))


def test_quantize_weights_matches_reference():
    """Codes and scales equal, per channel and, on stacked (L, K, N) leaves,
    per layer and channel; an all-zero column takes the 1e-12 scale floor."""
    rng = np.random.default_rng(0)
    for shape in ((40, 24), (3, 40, 24)):
        w = rng.normal(size=shape).astype(np.float32) * 0.3
        w[..., 5] = 0.0
        wi, sc = tqnn.quantize_weights(_t(w))
        jwi, jsc = jqnn.quantize_weights(jnp.asarray(w))
        assert wi.dtype == torch.int8 and tuple(sc.shape) == shape[:-2] + (1, shape[-1])
        np.testing.assert_array_equal(wi.numpy(), np.asarray(jwi))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
        assert float(sc[..., 5].max()) == pytest.approx(1e-12)
        assert int(wi.abs().max()) == tqnn.QMAX_W


def test_fake_quant_matches_reference():
    """Fake-quant weights and PACT activations (x below 0, inside and above
    amax), forward and straight-through gradients (to x, w and amax)."""
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(32, 16)) * 0.2).astype(np.float32)
    x = (rng.normal(size=(8, 32)) * 4.0).astype(np.float32)
    g = rng.normal(size=(8, 16)).astype(np.float32)
    amax = np.float32(3.5)

    def jloss(x, w, amax):
        return jnp.sum((jqnn.fake_quant_activations(x, amax) @ jqnn.fake_quant_weights(w)) * g)

    jl, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(x, w, amax)
    tx, tw, ta = (_t(np.asarray(a)).requires_grad_() for a in (x, w, amax))
    fx = tqnn.fake_quant_activations(tx, ta)
    fw = tqnn.fake_quant_weights(tw)
    np.testing.assert_allclose(fx.detach().numpy(),
                               np.asarray(jqnn.fake_quant_activations(x, amax)), atol=FQ_TOL)
    np.testing.assert_allclose(fw.detach().numpy(), np.asarray(jqnn.fake_quant_weights(w)),
                               atol=FQ_TOL)
    loss = torch.sum((fx @ fw) * _t(g))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=FQ_TOL)
    for got, want in zip((tx.grad, tw.grad, ta.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FQ_TOL, rtol=FQ_TOL)


def test_qnn_linear_matches_reference():
    rng = np.random.default_rng(2)
    params = {"w": (rng.normal(size=(24, 12)) * 0.2).astype(np.float32),
              "b": (rng.normal(size=(12,)) * 0.1).astype(np.float32),
              "amax": np.float32(6.0)}
    x = (rng.normal(size=(5, 24)) * 3).astype(np.float32)
    tparams = {k: _t(np.asarray(v)) for k, v in params.items()}
    for kw in ({}, {"activation": False}, {"quant_input": False}):
        np.testing.assert_allclose(
            tqnn.qnn_linear_apply(tparams, _t(x), **kw).numpy(),
            np.asarray(jqnn.qnn_linear_apply(params, jnp.asarray(x), **kw)), atol=FQ_TOL)
    init = tqnn.qnn_linear_init(torch.Generator().manual_seed(0), 24, 12)
    jinit = jqnn.qnn_linear_init(jax.random.PRNGKey(0), 24, 12)
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        k: tuple(v.shape) for k, v in jinit.items()}
    assert float(init["w"].abs().max()) <= 1 / 24**0.5


def test_requantization_matches_reference():
    """Integer requantization exact: the multiplier, the round-half-up
    arithmetic form (M = 0.5 puts every odd accumulator on a .5 point, where
    round-half-even would differ), the FINN-R thresholds and their
    comparator form, equal to each other."""
    rng = np.random.default_rng(3)
    acc = rng.integers(-3000, 3000, size=(64,)).astype(np.int32)
    acc[:8] = [-1, 0, 1, 3, 5, 7, 509, 511]
    s_in, s_w, s_out = (np.float32(v) for v in (0.05, 0.013, 0.02))
    m = tqnn.requant_scale(_t(np.array(s_in)), _t(np.array(s_w)), _t(np.array(s_out)))
    assert float(m) == float(jqnn.requant_scale(s_in, s_w, s_out))
    for ms in (0.5, 0.0325, float(m)):
        arith = tqnn.requant_arith(_t(acc), ms)
        np.testing.assert_array_equal(arith.numpy(), np.asarray(jqnn.requant_arith(acc, ms)))
        thr = tqnn.requant_thresholds(ms)
        np.testing.assert_array_equal(thr.numpy(), np.asarray(jqnn.requant_thresholds(ms)))
        form = tqnn.requant_threshold_form(_t(acc), thr)
        np.testing.assert_array_equal(
            form.numpy(), np.asarray(jqnn.requant_threshold_form(acc, jnp.asarray(thr.numpy()))))
        np.testing.assert_array_equal(form.numpy(), arith.numpy())


@pytest.mark.parametrize("m,k,n", [s for s in QNN_KERNEL_SHAPES if s[1] * 128 * 127 < 2**24])
def test_qnn_matmul_plain_matches_pallas_kernel(m, k, n):
    """Bit-equal to the reference's Pallas kernel (interpret mode) and its
    plain ``qnn_matmul_ref`` at K <= 1032, extreme codes included."""
    x, w, ws = qnn_case(np.random.default_rng(m + k + n), m, k, n)
    got = ops.qnn_matmul(_t(x), _t(w), _t(ws), 0.05).numpy()
    jx, jw, jws = jnp.asarray(x), jnp.asarray(w), jnp.asarray(ws)
    np.testing.assert_array_equal(got, np.asarray(jops.qnn_matmul(jx, jw, jws, 0.05,
                                                                  interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jref.qnn_matmul_ref(jx, jw, 0.05, jws)))


@pytest.mark.parametrize("m,k,n", [s for s in QNN_KERNEL_SHAPES if s[1] * 128 * 127 >= 2**24])
def test_qnn_matmul_plain_matches_reference_beyond_2_24(m, k, n):
    """At K = 2560 the integer sums pass 2^24 (full-range codes): bit-equal
    to the reference's int32 ``qnn_matmul_ref``, which rounds the int32 once."""
    x, w, ws = qnn_case(np.random.default_rng(m + k + n), m, k, n)
    x[0], w[:, 0] = -128, -127  # |acc| = K * 128 * 127 in (0, 0): well past 2^24
    got = ops.qnn_matmul(_t(x), _t(w), _t(ws), 0.05).numpy()
    want = np.asarray(jref.qnn_matmul_ref(jnp.asarray(x), jnp.asarray(w), 0.05, jnp.asarray(ws)))
    np.testing.assert_array_equal(got, want)
    acc = x[:1].astype(np.int64) @ w[:, :1].astype(np.int64)
    assert abs(int(acc[0, 0])) > 2**24


def test_qnn_wrappers_take_plain_on_cpu_and_check_inputs():
    x, w, ws = (_t(a) for a in qnn_case(np.random.default_rng(9), 3, 20, 6))
    before = ops.launch_counts()
    y = ops.qnn_matmul(x.reshape(3, 1, 20), w, ws.reshape(1, -1), 0.05)
    assert tuple(y.shape) == (3, 1, 6) and y.dtype == torch.float32
    assert ops.launch_counts() == before  # CPU: the plain version, no launch
    with pytest.raises(ValueError, match="CUDA"):
        tk.qnn_matmul_kernel_call(x, w, ws, 0.05)
    with pytest.raises(TypeError):
        tk.qnn_matmul_plain(x.float(), w, ws, 0.05)
    with pytest.raises(ValueError, match="shape"):
        tk.qnn_matmul_plain(x, w[:-1], ws, 0.05)


# ---------------------------------------------------------------------------
# kernel 10's stream route: a plain model of its arithmetic, and its plan
# ---------------------------------------------------------------------------


def byte_perm(a, b, sel):
    """CUDA's ``__byte_perm(a, b, sel)`` on int64 tensors of 32-bit words:
    byte i of the result is byte ``(sel >> 4 i) & 7`` of the eight bytes
    {b:a} (a's four low, b's four high)."""
    out = torch.zeros_like(a)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        byte = ((a if src < 4 else b) >> (8 * (src % 4))) & 0xFF
        out |= byte << (8 * i)
    return out


def transpose4(r0, r1, r2, r3):
    """The kernel's 4 x 4 byte transpose: row words (byte b = column b) ->
    column words (byte j = row j), in its eight ``__byte_perm``."""
    t0, t1 = byte_perm(r0, r1, 0x5140), byte_perm(r2, r3, 0x5140)
    t2, t3 = byte_perm(r0, r1, 0x7362), byte_perm(r2, r3, 0x7362)
    return (byte_perm(t0, t1, 0x5410), byte_perm(t0, t1, 0x7632),
            byte_perm(t2, t3, 0x5410), byte_perm(t2, t3, 0x7632))


def dp4a(a, b):
    """``__dp4a(a, b, 0)``: the four signed byte products of two words,
    summed (int64 tensors of 32-bit words, broadcast)."""
    def byte(v, i):
        u = (v >> (8 * i)) & 0xFF
        return u - ((u & 0x80) << 1)  # as int8
    return sum(byte(a, i) * byte(b, i) for i in range(4))


def qnn_stream_model(x, w, ws, x_scale, plan):
    """Kernel 10's stream route in plain PyTorch, word for word: x int8 (M,
    K), w int8 (K, N), ws float32 (N,), plan (mt, splits, groups_per_split)
    -> (M, N) float32. K is cut into quads of 4 rows (bytes past K are 0 on
    both sides); w's rows are read as 4-byte words of 4 columns and each 4 x
    4 block transposed into column words; ``__dp4a`` against x's k-words
    adds each quad's four products into an int32; split z sums the quads
    [2 z per, 2 (z + 1) per), and the splits' sums are added in rank order;
    then the two float32 roundings of the epilogue."""
    _, splits, per = plan
    m, k = x.shape
    n = w.shape[1]
    quads = -(-k // 4)
    xb = torch.nn.functional.pad(x.to(torch.int64) & 0xFF, (0, 4 * quads - k))
    wb = torch.nn.functional.pad(w.to(torch.int64) & 0xFF, (0, -n % 4, 0, 4 * quads - k))
    xw = sum(xb[:, i::4] << (8 * i) for i in range(4))  # (M, quads): byte j = row 4 q + j
    rows = sum(wb[:, i::4] << (8 * i) for i in range(4))  # (4 quads, N / 4): byte b = column
    cols = torch.stack(transpose4(*(rows[j::4] for j in range(4))), dim=-1)  # (quads, N/4, 4)
    cols = cols.reshape(quads, -1)[:, :n]  # (quads, N): byte j = row 4 q + j
    terms = dp4a(xw[:, :, None], cols[None])  # (M, quads, N)
    acc = torch.zeros((m, n), dtype=torch.int64)
    for z in range(splits):  # rank order
        acc += terms[:, 2 * z * per:2 * (z + 1) * per].sum(dim=1)
    assert int(acc.abs().max()) < 2**31  # the kernel's int32 is exact
    scale = ws.reshape(-1) * torch.tensor(x_scale, dtype=torch.float32)
    return acc.to(torch.int32).to(torch.float32) * scale


@pytest.mark.parametrize("m,k,n", QNN_KERNEL_SHAPES)
def test_qnn_stream_model_bit_exact(m, k, n):
    """The stream route's arithmetic, modelled in plain PyTorch, equals the
    plain version bit for bit on its own plan, on one split and on the most
    splits, extreme codes included (one sum at K * 128 * 127, past 2^24 at K
    = 2560), and the reference's Pallas kernel (interpret mode) where that
    kernel is exact (K * 128 * 127 < 2^24)."""
    x, w, ws = qnn_case(np.random.default_rng(3 * m + k + n), m, k, n)
    x[0], w[:, 0] = -128, -127
    want = tk.qnn_matmul_plain(_t(x), _t(w), _t(ws), 0.05)
    groups = -(-k // 8)
    per8 = -(-groups // 8)
    for plan in (tk.qnn_plan(m, k, n, route="stream")[1:], (8, 1, groups),
                 (8, -(-groups // per8), per8)):
        got = qnn_stream_model(_t(x), _t(w), _t(ws), 0.05, plan)
        assert torch.equal(got, want), plan
    if k * 128 * 127 < 2**24:
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jops.qnn_matmul(jnp.asarray(x), jnp.asarray(w),
                                                    jnp.asarray(ws), 0.05, interpret=True)))


def test_qnn_transpose_and_dp4a_model():
    """The model's pieces: the 4 x 4 byte transpose puts row j of column b in
    byte j of column word b, and ``dp4a`` adds four signed products."""
    rows = [torch.tensor([sum((16 * j + b) << (8 * b) for b in range(4))]) for j in range(4)]
    cols = transpose4(*rows)
    for b in range(4):
        assert int(cols[b]) == sum((16 * j + b) << (8 * j) for j in range(4))
    a = torch.tensor([0x80_7F_FF_01])  # bytes 1, -1, 127, -128
    assert int(dp4a(a, a)) == 1 + 1 + 127 * 127 + 128 * 128
    assert int(dp4a(a, torch.tensor([0x7F_80_01_FF]))) == -1 - 1 - 127 * 128 - 128 * 127


@pytest.mark.parametrize("k,n", [(960, 960), (960, 320), (960, 2560), (2560, 960), (100, 130),
                                 (968, 65), (99, 33), (4, 1)])
def test_qnn_plan_routes_and_covers_k_once(k, n):
    """Kernel 10's route: the stream route at and below QNN_STREAM_MAX_M
    rows, the tile route above; a forced route is taken as asked. On the
    stream route, with the CPU default and the H100's occupancy, the plan
    has 4-row tiles at decode and 8-row ones otherwise, and its splits'
    quads [2 z per, 2 (z + 1) per) cover the ceil(K / 4) quads exactly once,
    none empty."""
    quads = -(-k // 4)
    for m in range(1, tk.QNN_STREAM_MAX_M + 3):
        stream = m <= tk.QNN_STREAM_MAX_M
        assert tk.qnn_plan(m, k, n)[0] == ("stream" if stream else "tile")
        assert tk.qnn_plan(m, k, n, route="tile") == ("tile",)
        for max_blocks in (None, lambda mt, s: H100_STREAM_BLOCKS[s - 1]):
            route, mt, splits, per = tk.qnn_plan(m, k, n, max_blocks, route="stream")
            assert route == "stream" and mt == (4 if m <= 4 else 8)
            covered = [q for z in range(splits)
                       for q in range(2 * z * per, min(quads, 2 * (z + 1) * per))]
            assert covered == list(range(quads))
            assert 2 * (splits - 1) * per < quads  # the last split is not empty
    assert tk.QNN_STREAM_MAX_M >= 32  # every serve path's M streams
    with pytest.raises(ValueError):
        tk.qnn_plan(4, k, n, route="nope")


def test_kernel_times_refuses_without_a_card():
    """``python -m repro_torch.launch.kernel_times`` times the card only: on
    a machine without CUDA it prints no row and exits non-zero."""
    from repro_torch.launch import kernel_times

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the card run is chip_smoke's and run C's")
    assert kernel_times.main([]) == 1


def _jspec(**kw):
    return JaxLinearSpec(mode="qnn8", **kw)


@pytest.mark.parametrize("bias", [False, True])
def test_qnn8_backend_matches_reference(bias):
    """``to_serve`` equal leaf for leaf; ``apply_serve`` equal to the
    reference's Pallas route and its default XLA route (the same integers,
    the same two roundings); ``apply_train`` (fake-quant) within 1e-6."""
    rng = np.random.default_rng(4)
    train = {"w": (rng.normal(size=(48, 20)) * 0.2).astype(np.float32),
             "amax": np.float32(4.0)}
    if bias:
        train["b"] = (rng.normal(size=(20,)) * 0.1).astype(np.float32)
    x = (rng.normal(size=(2, 3, 48)) * 2).astype(np.float32)
    tspec, jbe, tbe = LinearSpec(mode="qnn8", bias=bias), jax_get_backend("qnn8"), get_backend(
        "qnn8")
    jserve = jbe.to_serve({k: jnp.asarray(v) for k, v in train.items()}, _jspec(bias=bias))
    tserve = tbe.to_serve({k: _t(np.asarray(v)) for k, v in train.items()}, tspec)
    assert sorted(tserve) == sorted(jserve)
    for k in tserve:
        np.testing.assert_array_equal(tserve[k].numpy(), np.asarray(jserve[k]))
    got = tbe.apply_serve(tserve, _t(x), tspec).numpy()
    for impl in ("pallas", "fused"):
        want = jbe.apply_serve(jserve, jnp.asarray(x), _jspec(bias=bias, impl=impl))
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=impl)
    tt = tbe.apply_train({k: _t(np.asarray(v)) for k, v in train.items()}, _t(x), tspec)
    jt = jbe.apply_train({k: jnp.asarray(v) for k, v in train.items()}, jnp.asarray(x),
                         _jspec(bias=bias))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=FQ_TOL)
    assert (tbe.kernel_route(tspec, "serve"), tbe.kernel_route(tspec, "train")) == ("qnn8", None)
    assert tbe.default_bias and float(tbe.inter_act(torch.tensor(-1.0))) == 0.0


def test_tree_to_serve_on_stacked_qnn8_tree():
    """A stacked (L, ...) smoke train tree converts per layer and channel,
    equal to the reference's conversion."""
    jcfg = jax_get_smoke("smollm-360m", compute_mode="qnn8", remat=False)
    train = unbox(jax_build_model(jcfg, phase="train").init(jax.random.PRNGKey(1)))
    jserve = jax_tree_to_serve(train, jcfg.linear_spec())
    tserve = tree_to_serve(from_reference(jax.tree_util.tree_map(np.asarray, train)),
                           port_cfg(jcfg).linear_spec())
    flat_j = jax.tree_util.tree_leaves_with_path(jserve)
    assert tserve["layers"]["mlp"]["down"]["w_scale"].shape == (jcfg.n_layers, 1, jcfg.d_model)
    for path, want in flat_j:
        got = tserve
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(path))


def _qnn_cfg(**kw):
    return jax_get_smoke("smollm-360m", compute_mode="qnn8", remat=False, **kw)


def _serve_trees(seed):
    jcfg = _qnn_cfg()
    train = unbox(jax_build_model(jcfg, phase="train").init(jax.random.PRNGKey(seed)))
    jparams = jax_tree_to_serve(train, jcfg.linear_spec())
    return jcfg, train, jparams, from_reference(jax.tree_util.tree_map(np.asarray, jparams))


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_logits_match_reference(quantized):
    """Two prefill chunks, then 4 decode steps with a parked row, of the
    smoke qnn8 model: logits within 1e-4 (ATOL), greedy tokens and the live
    pool blocks equal, codes held at genuine ties."""
    jcfg, _, jparams, tparams = _serve_trees(3)
    japi = jax_build_model(jcfg, phase="serve")
    tapi = build_model(port_cfg(jcfg), phase="serve")
    n_act, n_kv = 7 * jcfg.n_layers, (2 * jcfg.n_layers if quantized else 0)
    bs, chunk, n_phys = 8, 8, 9
    jpool = japi.init_cache(n_phys, bs, quantized=quantized)
    tpool = tapi.init_cache(n_phys, bs, quantized=quantized, device="cpu")
    prompt = np.random.RandomState(5).randint(0, jcfg.vocab, 13).astype(np.int32)
    table = np.array([[5, 2, 7, 0]], np.int32)

    def close(got, want, what):
        g, w = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=what)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1), err_msg=what)

    with held_codes("qnn8") as taken:
        for start in (0, chunk):
            toks = np.zeros((1, chunk), np.int32)
            seg = prompt[start:start + chunk]
            toks[0, :len(seg)] = seg
            last = np.array([len(seg) - 1], np.int32)
            jl, jpool = japi.prefill_chunk(jparams, jnp.asarray(toks), jpool, jnp.asarray(table),
                                           jnp.asarray([start], jnp.int32), jnp.asarray(last))
            tl, tpool = tapi.prefill_chunk(tparams, _t(toks), tpool, _t(table),
                                           torch.tensor([start], dtype=torch.int32), _t(last))
            taken(n_act, n_kv)
            close(tl, jl, f"prefill chunk at {start}")
        tables = np.array([[5, 2, 7, 0], [8, 8, 8, 8]], np.int32)
        tok = np.array([[int(np.asarray(jl).argmax())], [0]], np.int32)
        pos = np.array([13, 0], np.int32)
        for _ in range(4):
            jl, jpool = japi.decode_paged(jparams, jnp.asarray(tok), jpool, jnp.asarray(pos),
                                          jnp.asarray(tables))
            tl, tpool = tapi.decode_paged(tparams, _t(tok), tpool, _t(pos), _t(tables))
            taken(n_act, n_kv)
            close(tl[:1], jl[:1], f"decode at {pos[0]}")
            tok = np.array([[int(np.asarray(jl)[0, -1].argmax())], [0]], np.int32)
            pos = pos + np.array([1, 0], np.int32)
    for name in jpool:
        g = tpool[name][:, [5, 2, 7]].numpy().reshape(jcfg.n_layers, 24, -1)[:, :17]
        w = np.asarray(jpool[name])[:, [5, 2, 7]].reshape(jcfg.n_layers, 24, -1)[:, :17]
        if g.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_engine_tokens_match_reference(quantized):
    """``ServeEngine.from_trained`` on the same qnn8 train tree in both
    packages (paged engine, a shared-prefix hit, a block crossing, a queue
    longer than n_slots): tokens equal, token for token, codes held at
    genuine ties."""
    jcfg, train, _, _ = _serve_trees(2)
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
    with held_codes("qnn8") as taken:
        jdone = {r.rid: r.output for r in jeng.run()}  # the reference goes first
        tdone = {r.rid: r.output for r in teng.run()}
        m = teng.metrics.summary()
        ticks = m["decode_steps"] + m["prefill_chunks"]
        taken(7 * jcfg.n_layers * ticks, 2 * jcfg.n_layers * ticks if quantized else 0)
    assert sorted(tdone) == list(range(len(prompts)))
    for i in range(len(prompts)):
        np.testing.assert_array_equal(tdone[i], jdone[i], err_msg=f"request {i}")
    assert m["prefix_hit_tokens"] == 16
