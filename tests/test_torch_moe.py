"""PyTorch port vs the JAX reference: the mixture of experts
(``nn/moe.py``), the sliding-window ring cache (``nn/attention.py``),
LayerNorm and GELU, and expert leaves through ``tree_to_serve`` /
``from_reference``, on the CPU at SMOKE sizes (plain versions).

Tolerances: routing slots bit-exact (integers), drops included; gates
within 1e-6; float outputs within 1e-5 absolute (dense, and the float
parts around exact integer sums); ring-cache attention within 2e-5 of the
reference and of windowed ``dot_attention`` over every position so far;
serve trees bit-exact. The router's softmax may differ by an ulp between
the packages, which can reorder two gates at a near tie: ``held_routes``
holds the port to the reference's top-k choice where the gates at the two
choices lie within ``ROUTE_TIE`` of each other, fails on any other
difference, and counts the ties it met (none at these seeds).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.nn.moe as jax_moe
import repro_torch.nn.moe as port_moe
from repro.core.backend import LinearSpec as JSpec
from repro.core.convert import tree_to_serve as jax_tree_to_serve
from repro.nn import attention as jattn
from repro.nn import norms as jnorms
from repro.nn.mlp import _act as jax_act
from repro.nn.module import unbox
from repro_torch.core.backend import LinearSpec
from repro_torch.core.convert import from_reference, tree_to_serve
from repro_torch.nn import attention as tattn
from repro_torch.nn import norms as tnorms
from repro_torch.nn.mlp import _act as port_act

ATOL = 1e-5
ATTN_TOL = 2e-5
ROUTE_TIE = 1e-6  # gates this close may be ordered either way by an ulp of softmax
MODES = ("dense", "bika", "bnn", "qnn8")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the tier-1 run
    holds several test processes at once, and torch's default of a thread
    a core in each of them oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tree):
    return from_reference(_np(tree))


@contextlib.contextmanager
def held_routes():
    """The reference sends every routing's top-k expert indices to the
    host (in call order, through any scan); the port's ``_top_k`` takes the
    reference's indices where its own differ at a genuine tie (the gates at
    the two choices within ROUTE_TIE) and fails on any other difference.
    Yields ``stats`` ({"routes": n, "ties": n}) and, on exit, checks that
    the port took every routing the reference made."""
    queue, stats = [], {"routes": 0, "ties": 0}
    j_route, t_top_k = jax_moe._route_sparse, port_moe._top_k

    def j_route_sparse(logits, cfg, capacity):
        _, topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
        jax.debug.callback(lambda i: queue.append(np.asarray(i)), topi, ordered=True)
        return j_route(logits, cfg, capacity)

    def p_top_k(gates, k):
        vals, idx = t_top_k(gates, k)
        if not queue:
            jax.effects_barrier()
        ref = torch.from_numpy(queue.pop(0).astype(np.int64))
        stats["routes"] += 1
        diff = idx != ref
        if bool(diff.any()):
            gap = (gates.gather(1, idx) - gates.gather(1, ref)).abs()[diff]
            assert float(gap.max()) <= ROUTE_TIE, (
                f"{int(diff.sum())} expert choices differ at gate gaps up to "
                f"{float(gap.max()):.3e} (a tie is within {ROUTE_TIE})")
            stats["ties"] += int(diff.sum())
            idx, vals = ref, gates.gather(1, ref)
        return vals, idx

    jax_moe._route_sparse, port_moe._top_k = j_route_sparse, p_top_k
    try:
        yield stats
        jax.effects_barrier()
        assert not queue, f"the port left {len(queue)} of the reference's routings untaken"
    finally:
        jax_moe._route_sparse, port_moe._top_k = j_route, t_top_k


def test_gelu_is_jax_default_tanh_form():
    """The port's gelu is jax.nn.gelu's default, the tanh approximation
    (within 1e-6 on [-6, 6]); the erf form differs from it by up to ~5e-4."""
    x = np.linspace(-6.0, 6.0, 4001, dtype=np.float32)
    want = np.asarray(jax_act("gelu", jnp.asarray(x)))
    got = port_act("gelu", torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    for name in ("silu", "relu2"):
        np.testing.assert_allclose(port_act(name, torch.from_numpy(x)).numpy(),
                                   np.asarray(jax_act(name, jnp.asarray(x))), atol=1e-6, rtol=0)


def test_layernorm_matches_reference():
    rng = np.random.RandomState(0)
    x = (3.0 * rng.randn(4, 7, 96) + 1.5).astype(np.float32)
    p = {"scale": rng.randn(96).astype(np.float32), "bias": rng.randn(96).astype(np.float32)}
    want = np.asarray(jnorms.layernorm_apply(p, jnp.asarray(x)))
    got = tnorms.layernorm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                                 torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    init = tnorms.layernorm_init(96)
    assert torch.equal(init["scale"], torch.ones(96)) and torch.equal(init["bias"], torch.zeros(96))


@pytest.mark.parametrize("t,e,k,cap", [(64, 4, 2, None), (4, 8, 2, 1), (16, 4, 2, 1),
                                       (33, 8, 2, None), (40, 4, 1, 3)])
def test_route_sparse_slots_and_gates(t, e, k, cap):
    """Slots bit-exact (j-major queues, the sentinel E*C for drops) and
    gates within 1e-6, at the model's capacity and at capacity 1 (a decode
    tick's), with exact gate ties (lower index first, as jax.lax.top_k)."""
    rng = np.random.RandomState(t + e)
    logits = rng.randn(t, e).astype(np.float32)
    logits[::5, 1] = logits[::5, 0]  # exact ties: the lower expert index first
    cfg = port_moe.MoEConfig(n_experts=e, top_k=k)
    jcfg = jax_moe.MoEConfig(n_experts=e, top_k=k)
    assert port_moe.capacity_of(t, cfg) == max(1, int(t * k / e * 1.25))
    cap = cap or port_moe.capacity_of(t, cfg)
    js, jg, jaux = jax_moe._route_sparse(jnp.asarray(logits), jcfg, cap)
    ts, tg, taux = port_moe._route_sparse(torch.from_numpy(logits), cfg, cap)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=1e-6)
    dropped = int((ts == e * cap).sum())
    assert dropped == int((np.asarray(js) == e * cap).sum())
    if cap == 1 and t * k > e:
        assert dropped > 0  # capacity 1 drops, as the reference does
    # the one-hot form: the same queues and weights
    jd, jc, _ = jax_moe._route(jnp.asarray(logits), jcfg, cap)
    td, tc, _ = port_moe._route(torch.from_numpy(logits), cfg, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)


def _moe_trees(mode: str, phase: str, gated: bool = True, seed: int = 1):
    spec = JSpec(mode=mode, pack_signs=(mode == "bika"))
    jcfg = jax_moe.MoEConfig(n_experts=4, top_k=2, gated=gated, activation="silu")
    p = unbox(jax_moe.moe_init(jax.random.PRNGKey(seed), 64, 96, jcfg, spec))
    if phase == "serve":
        p = jax_tree_to_serve(p, spec)
    tspec = LinearSpec(mode=mode, pack_signs=(mode == "bika"))
    tcfg = port_moe.MoEConfig(n_experts=4, top_k=2, gated=gated)
    return jcfg, spec, p, tcfg, tspec, _port(p)


@pytest.mark.parametrize("phase", ["train", "serve"])
@pytest.mark.parametrize("mode", MODES)
def test_moe_apply_matches_reference(mode, phase):
    """moe_apply (scatter) against the reference's, and against the port's
    own einsum dispatch, in every mode and form; routing held at ties."""
    jcfg, jspec, jp, tcfg, tspec, tp = _moe_trees(mode, phase)
    x = np.random.RandomState(7).randn(2, 9, 64).astype(np.float32)
    with held_routes() as stats:
        jy, jaux = jax_moe.moe_apply(jp, jnp.asarray(x), jcfg, jspec, phase=phase)
        ty, taux = port_moe.moe_apply(tp, torch.from_numpy(x), tcfg, tspec, phase=phase)
    assert stats == {"routes": 1, "ties": 0}, stats
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=1e-6)
    ey, eaux = port_moe.moe_apply(tp, torch.from_numpy(x), tcfg, tspec, phase=phase,
                                  dispatch="einsum")
    np.testing.assert_allclose(ey.detach().numpy(), ty.detach().numpy(), atol=ATOL, rtol=0)
    assert float(eaux) == float(taux)


def test_moe_decode_rows_drop_at_capacity_one():
    """Four rows at a decode tick: capacity 1 an expert, so of the 8
    assignments the later ones to a taken expert are dropped, exactly as in
    the reference, and a dropped choice adds nothing to its token."""
    jcfg, jspec, jp, tcfg, tspec, tp = _moe_trees("bika", "serve", seed=4)
    x = np.random.RandomState(3).randn(4, 1, 64).astype(np.float32)
    logits = torch.from_numpy(x.reshape(4, 64)) @ tp["router"]["w"]
    slot, _, _ = port_moe._route_sparse(logits, tcfg, 1)
    assert int((slot == 4).sum()) >= 4  # 8 assignments, 4 places
    with held_routes() as stats:
        jy, _ = jax_moe.moe_apply(jp, jnp.asarray(x), jcfg, jspec, phase="serve")
        ty, _ = port_moe.moe_apply(tp, torch.from_numpy(x), tcfg, tspec, phase="serve")
    assert stats["ties"] == 0
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_expert_leaves_to_serve_and_from_reference(mode):
    """Stacked (L, E, ...) expert leaves: the port's tree_to_serve equals
    the reference's bit for bit in every mode (the dense {"w"} router passes
    through every mode's conversion untouched, as in the reference), and
    from_reference keeps every leaf's shape, dtype and bits."""
    jspec = JSpec(mode=mode, pack_signs=(mode == "bika"))
    jcfg = jax_moe.MoEConfig(n_experts=4, top_k=2)
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    layers = [unbox(jax_moe.moe_init(k, 64, 96, jcfg, jspec)) for k in keys]
    train = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *layers)  # (L, E, ...)
    jserve = _np(jax_tree_to_serve(train, jspec))
    tserve = tree_to_serve(_port(train), LinearSpec(mode=mode, pack_signs=(mode == "bika")))
    np.testing.assert_array_equal(tserve["router"]["w"].numpy(), np.asarray(train["router"]["w"]))
    assert set(tserve["router"]) == {"w"}
    for path, want in jax.tree_util.tree_flatten_with_path(jserve)[0]:
        got = tserve
        for key in path:
            got = got[key.key]
        assert tuple(got.shape) == want.shape and got.numpy().dtype == want.dtype, path
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(path))
    back = _port(jserve)
    for path, want in jax.tree_util.tree_flatten_with_path(jserve)[0]:
        got = back
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got.numpy(), want)


def _attn_setup(window, hkv=2):
    jcfg = jattn.AttnConfig(d_model=64, n_heads=4, n_kv_heads=hkv, head_dim=16, window=window)
    tcfg = tattn.AttnConfig(d_model=64, n_heads=4, n_kv_heads=hkv, head_dim=16, window=window)
    spec = JSpec(mode="dense")
    p = unbox(jattn.attn_init(jax.random.PRNGKey(6), jcfg, spec))
    return jcfg, tcfg, spec, LinearSpec(mode="dense"), p, _port(p)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("quantized", [False, True])
def test_ring_cache_prefill_and_decode_match_reference(quantized, per_row):
    """mixtral SMOKE's window 16: a 32-token prompt folded into the 16-slot
    ring (max_len 64), then 20 decode steps that wrap it again; outputs and
    the ring within 2e-5 of the reference (int8 codes exactly), scalar and
    per-row positions."""
    jcfg, tcfg, jspec, tspec, jp, tp = _attn_setup(16)
    rng = np.random.RandomState(8)
    x = rng.randn(2, 32, 64).astype(np.float32)
    jy, jc = jattn.attn_prefill(jp, jnp.asarray(x), jcfg, jspec, max_len=64,
                                quantized=quantized, cache_dtype=jnp.float32)
    ty, tc = tattn.attn_prefill(tp, torch.from_numpy(x), tcfg, tspec, max_len=64,
                                quantized=quantized)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATTN_TOL, rtol=0)
    assert tc["k"].shape[1] == 16
    for step in range(20):
        xs = rng.randn(2, 1, 64).astype(np.float32)
        pos = 32 + step
        jpos = jnp.asarray([pos, pos], jnp.int32) if per_row else jnp.asarray(pos, jnp.int32)
        tpos = torch.tensor([pos, pos], dtype=torch.int32) if per_row else pos
        jy, jc = jattn.attn_decode_step(jp, jnp.asarray(xs), jc, jpos, jcfg, jspec)
        ty, tc = tattn.attn_decode_step(tp, torch.from_numpy(xs), tc, tpos, tcfg, tspec)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATTN_TOL, rtol=0,
                                   err_msg=f"decode at {pos}")
    for name in jc:
        g, w = tc[name].numpy(), np.asarray(jc[name])
        if g.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=ATTN_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("s", [5, 20, 37])
def test_ring_cache_matches_windowed_attention_oracle(s):
    """The ring against the whole history: a prompt of s tokens (shorter
    than the window, or folded in at any s, where the reference asserts s
    % 16 == 0), then 24 decode steps across the wrap, each within 2e-5 of
    ``dot_attention`` over every K/V so far under the window mask."""
    _, tcfg, _, tspec, _, tp = _attn_setup(16)
    rng = np.random.RandomState(s)
    x = torch.from_numpy(rng.randn(1, s + 24, 64).astype(np.float32))
    q_all, k_all, v_all = tattn._project_qkv(tp, x, tcfg, tspec, "serve")
    pos = torch.arange(s + 24, dtype=torch.int32)
    q_all = tattn.apply_rope(q_all, pos, tcfg.rope_theta)
    k_all = tattn.apply_rope(k_all, pos, tcfg.rope_theta)
    _, cache = tattn.attn_prefill(tp, x[:, :s], tcfg, tspec, max_len=96)
    for p in range(s, s + 24):
        y, cache = tattn.attn_decode_step(tp, x[:, p:p + 1], cache, p, tcfg, tspec)
        want = tattn.dot_attention(q_all[:, p:p + 1], k_all[:, :p + 1], v_all[:, :p + 1],
                                   q_positions=pos[p:p + 1], kv_positions=pos[:p + 1],
                                   window=16)
        want = tattn.linear_apply(tp["wo"], want.reshape(1, 1, -1), tspec)
        np.testing.assert_allclose(y.numpy(), want.numpy(), atol=ATTN_TOL, rtol=0,
                                   err_msg=f"decode at {p}")


def test_blockwise_attention_ragged_last_tile():
    """A prompt that is not a multiple of block_q gives the rows of one
    whole dot_attention (the reference asserts against it)."""
    rng = np.random.RandomState(2)
    q = torch.from_numpy(rng.randn(1, 21, 4, 16).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, 21, 2, 16).astype(np.float32))
    v = torch.from_numpy(rng.randn(1, 21, 2, 16).astype(np.float32))
    pos = torch.arange(21, dtype=torch.int32)
    for window in (None, 6):
        got = tattn.blockwise_attention(q, k, v, window=window, block_q=8)
        want = tattn.dot_attention(q, k, v, q_positions=pos, kv_positions=pos, window=window)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_verify_and_paged_paths_refuse_windows():
    """As the reference asserts: no speculative verify, paged decode or
    paged prefill over a sliding window."""
    _, tcfg, _, tspec, _, tp = _attn_setup(16)
    x = torch.zeros(1, 1, 64)
    cache = tattn.init_kv_cache(1, tcfg, 32)
    with pytest.raises(ValueError, match="sliding"):
        tattn.attn_verify_step(tp, x, cache, torch.tensor([0], dtype=torch.int32), tcfg, tspec)
    pool = tattn.init_kv_cache(3, tcfg, 8)
    table = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="sliding"):
        tattn.attn_decode_step_paged(tp, x, pool, torch.tensor([0], dtype=torch.int32), table,
                                     tcfg, tspec)
    with pytest.raises(ValueError, match="sliding"):
        tattn.attn_prefill_chunk(tp, x, pool, table, torch.tensor([0], dtype=torch.int32), tcfg,
                                 tspec)


def test_cac_plain_cpu_equals_broadcast():
    """The CPU plain CAC (column slices, agreement counts) gives the
    broadcast reference's integers, with codes and thresholds at -128 and
    127 and ragged N."""
    from repro_torch.core.backend import pack_signs
    from repro_torch.kernels import ref
    from repro_torch.kernels.cac_matmul import cac_matmul_plain

    rng = np.random.default_rng(0)
    for m, k, n in [(1, 8, 5), (13, 200, 130), (70, 64, 1), (3, 1024, 200)]:
        x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
        tau = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8))
        x[0, :4] = torch.tensor([-128, 127, -128, 127], dtype=torch.int8)
        tau[:4, 0] = torch.tensor([-128, -128, 127, 127], dtype=torch.int8)
        s = torch.from_numpy(np.where(rng.random((k, n)) < 0.5, -1, 1).astype(np.int8))
        assert torch.equal(cac_matmul_plain(x, tau, pack_signs(s)),
                           ref.cac_matmul_ref(x, tau, s))


def test_moe_init_shapes_and_dataclass():
    """moe_init's tree: the dense {"w"} router (D, E) and every expert leaf
    stacked (E, ...), in serve and train form, like the reference's."""
    spec = LinearSpec(mode="bika", pack_signs=True)
    cfg = port_moe.MoEConfig(n_experts=4)
    gen = torch.Generator().manual_seed(0)
    serve = port_moe.moe_init(gen, 64, 96, cfg, spec, device="cpu")
    train = port_moe.moe_init(gen, 64, 96, cfg, spec, phase="train", device="cpu")
    jp = unbox(jax_moe.moe_init(jax.random.PRNGKey(0), 64, 96,
                                jax_moe.MoEConfig(n_experts=4), JSpec(mode="bika",
                                                                     pack_signs=True)))
    jserve = jax_tree_to_serve(jp, JSpec(mode="bika", pack_signs=True))
    for port_tree, ref_tree in ((train, jp), (serve, jserve)):
        for path, want in jax.tree_util.tree_flatten_with_path(ref_tree)[0]:
            got = port_tree
            for key in path:
                got = got[key.key]
            assert tuple(got.shape) == tuple(want.shape), path
    assert [f.name for f in dataclasses.fields(port_moe.MoEConfig)] == \
        [f.name for f in dataclasses.fields(jax_moe.MoEConfig) if f.name != "expert_axis"]
