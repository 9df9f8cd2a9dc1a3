"""PyTorch port vs the JAX reference: the continuous engine and speculative
decoding on the CPU (the cases of ``tests/test_spec_decode.py``, held
against the reference package).

- the exactness oracle for {continuous, paged} x {qnn8, bnn, small} drafts
  of a dense target: the port's speculative tokens == its target-only
  tokens == the reference's tokens;
- ``decode_verify`` against sequential ``decode_step`` (greedy tokens equal,
  logits within 1e-5) and against the reference's verify (within 1e-4);
- ``spec_k = 1`` is plain decode, EOS inside a window, paged rollback across
  block boundaries, windows overhanging ``max_len`` (the draft's and the
  dense verify's writes past the cache are dropped), the rejections and the
  draft presets;
- the continuous engine's tokens equal the reference's continuous engine's,
  fp and int8 KV; ``KVSlotManager`` bookkeeping; ``BucketedPrefill`` logits
  and caches against the reference's at each bucket.

Tolerances: logits within 1e-4 (``test_torch_lm.ATOL``, float32 parts in
other kernels and orders) and greedy tokens equal; where qnn8 or an int8
pool quantizes, the codes are held at genuine half-way ties
(``test_torch_lm.held_codes``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import ATOL, held_codes, port_cfg

from repro.configs import get_smoke as jax_get_smoke
from repro.core.convert import tree_to_serve as jax_tree_to_serve
from repro.models import build_model as jax_build_model
from repro.nn.module import unbox
from repro.serve import BucketedPrefill as JaxBucketedPrefill
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.core.convert import from_reference, tree_to_serve
from repro_torch.models import build_model
from repro_torch.serve import (
    BucketedPrefill,
    KVSlotManager,
    Request,
    ServeEngine,
    SlotScheduler,
    bucket_for,
    build_draft_from_train,
    draft_arch,
)

MAX_NEW = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the tier-1 run
    holds several test processes at once, and torch's default of a thread
    a core in each of them oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_cfg(mode="dense"):
    return jax_get_smoke("smollm-360m", compute_mode=mode, remat=False)


@pytest.fixture(scope="module")
def lm():
    """(jax cfg, jax train tree, port cfg, port train tree) of the smoke
    dense target, and a cache of drains keyed by their arguments."""
    jcfg = _jax_cfg()
    train = unbox(jax_build_model(jcfg, phase="train").init(jax.random.PRNGKey(7)))
    ttrain = from_reference(jax.tree_util.tree_map(np.asarray, train))
    return jcfg, train, port_cfg(jcfg), ttrain, {}


def _prompts(vocab, n=4, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=int(rng.randint(3, 12))).astype(np.int32)
            for _ in range(n)]


def _drain(lm, *, jax_side=False, prompts=None, max_new=MAX_NEW, eos_id=None, **kw):
    """Tokens {rid: [...]} and the engine of one drain of the smoke prompts
    (batch 4, max_len 64 unless given), cached per argument set."""
    jcfg, jtrain, tcfg, ttrain, cache = lm
    prompts = _prompts(jcfg.vocab) if prompts is None else prompts
    key = (jax_side, max_new, eos_id, tuple(map(tuple, prompts)), tuple(sorted(kw.items())))
    if key in cache:
        return cache[key]
    kw = dict(dict(batch_size=4, max_len=64), **kw)
    if jax_side:
        eng = JaxServeEngine.from_trained(jtrain, jcfg, **kw)
        make = JaxRequest
    else:
        eng = ServeEngine.from_trained(ttrain, tcfg, device="cpu", **kw)
        make = Request
    for i, p in enumerate(prompts):
        eng.submit(make(rid=i, prompt=p, max_new_tokens=max_new, eos_id=eos_id))
    out = ({r.rid: [int(t) for t in r.output] for r in eng.run()}, eng)
    cache[key] = out
    return out


# ---------------------------------------------------------------------------
# the exactness oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["continuous", "paged"])
@pytest.mark.parametrize("draft", ["qnn8", "bnn", "small"])
def test_spec_parity(lm, engine, draft):
    """Greedy speculative decode is token for token target-only decode, for
    any draft, on both slot engines, and both equal the reference's."""
    base, _ = _drain(lm, engine=engine)
    ref, _ = _drain(lm, jax_side=True, engine=engine)
    spec, eng = _drain(lm, engine=engine, spec_draft=draft, spec_k=4)
    assert spec == base == ref
    m = eng.metrics
    assert m.spec_rounds > 0 and m.spec_drafted_tokens >= m.spec_accepted_tokens
    assert eng.scheduler._spec_arch.compute_mode == ("dense" if draft == "small" else draft)


def test_spec_weight_tied_draft_accepts(lm):
    """A dense draft of a dense target is the target itself: only the last
    round's budget truncation rejects, and the accept counts equal the
    reference's."""
    _, eng = _drain(lm, engine="continuous", spec_draft="dense", spec_k=4)
    _, jeng = _drain(lm, jax_side=True, engine="continuous", spec_draft="dense", spec_k=4)
    m, jm = eng.metrics, jeng.metrics
    assert m.spec_accept_rate > 0.5 and m.spec_tokens_per_round > 2.0
    assert (m.spec_rounds, m.spec_drafted_tokens, m.spec_accepted_tokens) == (
        jm.spec_rounds, jm.spec_drafted_tokens, jm.spec_accepted_tokens)


# ---------------------------------------------------------------------------
# multi-token verify == sequential decode steps
# ---------------------------------------------------------------------------


def test_decode_verify_matches_sequential_decode(lm):
    """The same window through C sequential ``decode_step`` calls and one
    ``decode_verify`` from the same prefilled cache: greedy tokens equal at
    every window position, logits within 1e-5, and the verify's logits within
    ATOL of the reference's verify."""
    jcfg, jtrain, tcfg, ttrain, _ = lm
    api = build_model(tcfg, phase="serve")
    params = tree_to_serve(ttrain, tcfg.linear_spec())
    prompt = np.arange(5, dtype=np.int32) % jcfg.vocab
    c = 4
    kv_a = KVSlotManager(api, n_slots=1, max_len=64, device="cpu")
    kv_b = KVSlotManager(api, n_slots=1, max_len=64, device="cpu")
    logits, cache = BucketedPrefill(api, max_len=64)(params, prompt)
    kv_a.write_prefill(0, cache)
    kv_b.write_prefill(0, cache)
    window, seq, seq_logits = [int(torch.argmax(logits))], [], []
    for j in range(c):
        lg, kv_a.cache = api.decode_step(params, torch.tensor([[window[j]]]), kv_a.cache,
                                         torch.tensor([len(prompt) + j], dtype=torch.int32))
        seq.append(int(torch.argmax(lg[0, -1])))
        seq_logits.append(lg[0, -1])
        if j + 1 < c:
            window.append(seq[-1])
    lg, _ = api.decode_verify(params, torch.tensor([window], dtype=torch.int32), kv_b.cache,
                              torch.tensor([len(prompt)], dtype=torch.int32))
    assert lg[0].argmax(-1).tolist() == seq
    torch.testing.assert_close(lg[0], torch.stack(seq_logits), atol=1e-5, rtol=0)
    # the reference's verify from its own prefill of the same prompt
    japi = jax_build_model(jcfg, phase="serve")
    jparams = jax_tree_to_serve(jtrain, jcfg.linear_spec())
    _, jcache = JaxBucketedPrefill(japi, max_len=64)(jparams, prompt)
    jlg, _ = japi.decode_verify(jparams, jnp.asarray([window], jnp.int32), jcache,
                                jnp.asarray([len(prompt)], jnp.int32))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# degeneration, EOS, rollback, overhang, validation
# ---------------------------------------------------------------------------


def test_spec_k1_degenerates_to_plain_decode(lm):
    base, _ = _drain(lm, engine="continuous")
    out, eng = _drain(lm, engine="continuous", spec_draft="qnn8", spec_k=1)
    assert out == base
    assert eng.scheduler._spec_api is None
    assert eng.metrics.spec_rounds == 0 and eng.metrics.spec_accept_rate == 0.0


def test_spec_eos_mid_window(lm):
    """A token the target emits mid-stream as eos_id: the speculative drain
    stops where the target-only drain does, even where the draft proposes
    past EOS inside a window, and frees every slot."""
    base, _ = _drain(lm, engine="continuous")
    eos = base[0][4]
    base_eos, _ = _drain(lm, engine="continuous", eos_id=eos)
    spec_eos, eng = _drain(lm, engine="continuous", eos_id=eos, spec_draft="dense", spec_k=4)
    ref_eos, _ = _drain(lm, jax_side=True, engine="continuous", eos_id=eos)
    assert spec_eos == base_eos == ref_eos
    assert any(len(v) < MAX_NEW for v in base_eos.values())
    assert eng.scheduler.n_active == 0


def test_spec_paged_rollback_across_block_boundary(lm):
    """kv_block_size 2 with spec_k 4: every window straddles blocks, and a
    half-depth draft guarantees rejections."""
    base, _ = _drain(lm, engine="paged", kv_block_size=2, max_new=12)
    spec, eng = _drain(lm, engine="paged", kv_block_size=2, max_new=12, spec_draft="small",
                       spec_k=4)
    ref, _ = _drain(lm, jax_side=True, engine="paged", kv_block_size=2, max_new=12)
    assert spec == base == ref
    m = eng.metrics
    assert m.spec_accepted_tokens < m.spec_drafted_tokens


@pytest.mark.parametrize("engine", ["continuous", "paged"])
def test_spec_window_overhanging_max_len(lm, engine):
    """Prompts that leave 2-6 tokens of room in a 16-token cache, so that
    the last rounds' draft steps and verify windows reach past max_len: the
    writes there are dropped, as the reference's scatter drops them, and the
    tokens equal target-only decode and the reference's speculative drain."""
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, lm[0].vocab, n).astype(np.int32) for n in (14, 11, 13, 10)]
    kw = dict(engine=engine, max_len=16, kv_block_size=4, prefill_chunk=8, max_new=12,
              prompts=prompts)
    base, _ = _drain(lm, **kw)
    spec, eng = _drain(lm, spec_draft="small", spec_k=4, **kw)
    ref, _ = _drain(lm, jax_side=True, spec_draft="small", spec_k=4, **kw)
    assert spec == base == ref
    assert [len(base[i]) for i in range(4)] == [16 - len(p) + 1 for p in prompts]
    assert eng.metrics.spec_rounds > 0


def test_dense_decode_drops_writes_past_max_len(lm):
    """``decode_step`` at a position >= max_len leaves the cache as it was
    (row 1 here; row 0 writes in range) and attends every position, as the
    reference's decode does."""
    jcfg, jtrain, tcfg, ttrain, _ = lm
    api = build_model(tcfg, phase="serve")
    params = tree_to_serve(ttrain, tcfg.linear_spec())
    rng = np.random.RandomState(1)
    cache = api.init_cache(2, 8, device="cpu")
    for leaf in cache.values():
        leaf.copy_(torch.from_numpy(rng.normal(size=tuple(leaf.shape)).astype(np.float32)))
    before = {k: v.clone() for k, v in cache.items()}
    tok, pos = np.array([[3], [5]], np.int32), np.array([6, 8], np.int32)
    lg, cache = api.decode_step(params, torch.from_numpy(tok), cache, torch.from_numpy(pos))
    for name in cache:
        assert torch.equal(cache[name][:, 1], before[name][:, 1]), name
        assert not torch.equal(cache[name][:, 0, 6], before[name][:, 0, 6]), name
    japi = jax_build_model(jcfg, phase="serve")
    jparams = jax_tree_to_serve(jtrain, jcfg.linear_spec())
    jcache = {k: jnp.asarray(v.numpy()) for k, v in before.items()}
    jlg, jcache = japi.decode_step(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL, rtol=0)
    for name in cache:
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), atol=ATOL)


@pytest.mark.parametrize("quantized", [False, True])
def test_dense_verify_drops_writes_past_max_len(lm, quantized):
    """``decode_verify`` with a 4-wide window at positions 5..8 of an
    8-long cache (row 0: the last slot written in range, one position
    dropped) and 9..12 (row 1: all dropped): row 0 keeps positions 0-4,
    row 1 is unchanged, and logits and cache equal the reference's verify
    (within ATOL; int8 payloads exact)."""
    jcfg, jtrain, tcfg, ttrain, _ = lm
    api = build_model(tcfg, phase="serve")
    params = tree_to_serve(ttrain, tcfg.linear_spec())
    rng = np.random.RandomState(2)
    cache = api.init_cache(2, 8, quantized=quantized, device="cpu")
    for leaf in cache.values():
        if leaf.dtype == torch.int8:
            fill = rng.randint(-127, 128, size=tuple(leaf.shape)).astype(np.int8)
        else:
            fill = rng.uniform(1e-3, 1.0, size=tuple(leaf.shape)).astype(np.float32)
        leaf.copy_(torch.from_numpy(fill))
    before = {k: v.clone() for k, v in cache.items()}
    tok = rng.randint(0, jcfg.vocab, size=(2, 4)).astype(np.int32)
    pos = np.array([5, 9], np.int32)
    lg, cache = api.decode_verify(params, torch.from_numpy(tok), cache, torch.from_numpy(pos))
    for name in cache:
        assert torch.equal(cache[name][:, 1], before[name][:, 1]), name
        assert torch.equal(cache[name][:, 0, :5], before[name][:, 0, :5]), name
        assert not torch.equal(cache[name][:, 0, 7], before[name][:, 0, 7]), name
    japi = jax_build_model(jcfg, phase="serve")
    jparams = jax_tree_to_serve(jtrain, jcfg.linear_spec())
    jcache = {k: jnp.asarray(v.numpy()) for k, v in before.items()}
    jlg, jcache = japi.decode_verify(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL, rtol=0)
    for name in cache:
        want = np.asarray(jcache[name])
        if want.dtype == np.int8:
            np.testing.assert_array_equal(cache[name].numpy(), want)
        else:
            np.testing.assert_allclose(cache[name].numpy(), want, atol=ATOL)


def test_spec_rejects_static_engine_and_bad_k(lm):
    _, _, tcfg, ttrain, _ = lm
    with pytest.raises(ValueError, match="spec"):
        ServeEngine.from_trained(ttrain, tcfg, engine="static", spec_draft="qnn8", spec_k=4,
                                 device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        ServeEngine.from_trained(ttrain, tcfg, engine="continuous", spec_draft="qnn8",
                                 spec_k=0, device="cpu")
    # without a draft the static engine serves (it is ported)
    assert ServeEngine.from_trained(ttrain, tcfg, engine="static",
                                    device="cpu").engine == "static"


def test_bika_target_rejects_matmul_draft():
    jcfg = _jax_cfg("bika")
    train = unbox(jax_build_model(jcfg, phase="train").init(jax.random.PRNGKey(7)))
    ttrain = from_reference(jax.tree_util.tree_map(np.asarray, train))
    for preset in ("dense", "bnn", "qnn8"):
        with pytest.raises(ValueError, match="bika"):
            build_draft_from_train(ttrain, port_cfg(jcfg), preset)


def test_draft_arch_presets(lm):
    _, _, tcfg, ttrain, _ = lm
    assert draft_arch(tcfg, "qnn8").compute_mode == "qnn8"
    small = draft_arch(tcfg, "small")
    assert small.compute_mode == "dense" and small.n_layers == max(1, tcfg.n_layers // 2)
    with pytest.raises(ValueError, match="preset"):
        draft_arch(tcfg, "nope")
    _, dparams, darch = build_draft_from_train(ttrain, tcfg, "bnn")
    wq = dparams["layers"]["attn"]["wq"]
    assert darch.compute_mode == "bnn" and sorted(wq) == ["gamma", "wb"]
    torch.testing.assert_close(wq["gamma"], ttrain["layers"]["attn"]["wq"]["w"].abs().mean(-2))
    _, sparams, _ = build_draft_from_train(ttrain, tcfg, "small")
    assert sparams["layers"]["mlp"]["up"]["w"].shape[0] == small.n_layers


# ---------------------------------------------------------------------------
# the continuous engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,quantized", [("dense", False), ("dense", True),
                                            ("qnn8", False), ("qnn8", True)])
def test_continuous_engine_tokens_match_reference(mode, quantized):
    """``ServeEngine(engine="continuous")`` (as ``"auto"`` resolves) against
    the reference's continuous engine on one train tree: a queue longer than
    n_slots, prompts in two buckets; tokens equal, codes held at ties."""
    jcfg = _jax_cfg(mode)
    train = unbox(jax_build_model(jcfg, phase="train").init(jax.random.PRNGKey(2)))
    kw = dict(max_len=48, n_slots=3, quantized_kv=quantized)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, jcfg.vocab, n).astype(np.int32) for n in (19, 6, 11, 3, 17)]
    jeng = JaxServeEngine.from_trained(train, jcfg, **kw)
    teng = ServeEngine.from_trained(from_reference(jax.tree_util.tree_map(np.asarray, train)),
                                    port_cfg(jcfg), device="cpu", **kw)
    assert teng.engine == jeng.engine == "continuous"
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=7))
        teng.submit(Request(rid=i, prompt=p, max_new_tokens=7))
    with held_codes("qnn8") as taken:
        jdone = {r.rid: r.output for r in jeng.run()}  # the reference goes first
        tdone = {r.rid: r.output for r in teng.run()}
        m = teng.metrics.summary()
        passes = m["decode_steps"] + m["prefills"]
        layers = jcfg.n_layers
        taken(7 * layers * passes if mode == "qnn8" else 0,
              2 * layers * passes if quantized else 0)
    assert sorted(tdone) == list(range(len(prompts)))
    for i in range(len(prompts)):
        np.testing.assert_array_equal(tdone[i], jdone[i], err_msg=f"request {i}")
    jm = jeng.metrics.summary()
    for key in ("decode_steps", "prefills", "prefill_compiles", "completed_tokens"):
        assert m[key] == jm[key], key


def test_kv_slot_manager(lm):
    _, _, tcfg, _, _ = lm
    api = build_model(tcfg, phase="serve")
    kv = KVSlotManager(api, n_slots=3, max_len=16, device="cpu")
    assert kv.layout == (tcfg.n_layers, 3, 16, tcfg.n_kv_heads, tcfg.hd)
    assert [kv.alloc() for _ in range(3)] == [0, 1, 2] and kv.alloc() is None
    kv.free(1)
    kv.free(0)
    assert kv.n_free == 2 and kv.alloc() == 0  # lowest index first
    with pytest.raises(ValueError, match="double free"):
        kv.free(1)
    with pytest.raises(ValueError, match="out of range"):
        kv.free(3)
    pcache = api.init_cache(1, 16, device="cpu")
    for leaf in pcache.values():
        leaf.fill_(2.0)
    kv.write_prefill(2, pcache)
    assert bool((kv.cache["k"][:, 2] == 2.0).all()) and bool((kv.cache["k"][:, :2] == 0).all())
    with pytest.raises(ValueError, match="layout"):
        kv.write_prefill(0, api.init_cache(1, 8, device="cpu"))


@pytest.mark.parametrize("mode", ["dense", "qnn8"])
def test_bucketed_prefill_matches_reference(mode):
    """Prompts of 3, 17 and 40 tokens (buckets 16, 32 and 64 at max_len 64):
    last-token logits and the max_len-long cache within ATOL of the
    reference's, int8 cache codes equal (held at ties), one miss per
    bucket."""
    jcfg = _jax_cfg(mode)
    train = unbox(jax_build_model(jcfg, phase="train").init(jax.random.PRNGKey(5)))
    jparams = jax_tree_to_serve(train, jcfg.linear_spec())
    tparams = from_reference(jax.tree_util.tree_map(np.asarray, jparams))
    japi, tapi = jax_build_model(jcfg, phase="serve"), build_model(port_cfg(jcfg), phase="serve")
    rng = np.random.RandomState(6)
    for quantized in (False, True):
        jpre = JaxBucketedPrefill(japi, max_len=64, quantized=quantized)
        tpre = BucketedPrefill(tapi, max_len=64, quantized=quantized)
        for n, bucket in ((3, 16), (17, 32), (40, 64)):
            assert tpre.bucket_for(n) == bucket_for(n, 64) == bucket
            prompt = rng.randint(0, jcfg.vocab, n).astype(np.int32)
            with held_codes("qnn8") as taken:
                jl, jc = jpre(jparams, prompt)
                tl, tc = tpre(tparams, prompt)
                taken(7 * jcfg.n_layers if mode == "qnn8" else 0,
                      2 * jcfg.n_layers if quantized else 0)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
            assert int(tl.argmax()) == int(np.asarray(jl).argmax())
            for name in jc:
                g, w = tc[name].numpy(), np.asarray(jc[name])
                assert g.shape == w.shape == g.shape[:2] + (64,) + g.shape[3:]
                if g.dtype == np.int8:
                    np.testing.assert_array_equal(g, w, err_msg=name)
                else:
                    np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)
        assert tpre.misses == jpre.misses == 3


def test_scheduler_requires_supported_arch(lm):
    _, _, tcfg, _, _ = lm
    api = build_model(tcfg, phase="serve")
    params = api.init(0, device="cpu")
    with pytest.raises(ValueError, match="SlotScheduler"):
        SlotScheduler(api, params, tcfg.replace(window=8), device="cpu")


def test_chip_smoke_qnn8_and_spec_phases_on_cpu(monkeypatch):
    """``chip_smoke.py``'s qnn8-serve and spec phases at 2 layers on the CPU,
    with each plain-version call of kernels 10 and 11 counted as a launch:
    the exact launch-count checks, the token comparisons under the tie rule
    and the parity pass as they must on the card."""
    import os

    import repro_torch.configs as configs
    from repro_torch.kernels import ops, ref

    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs

    full = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda name, **kw: full(name, **dict(kw, n_layers=2)))

    def counted(fn, route):
        def call(*a, **kw):
            ops._COUNTED[route].launches += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(ops, "qnn_matmul_plain", counted(ops.qnn_matmul_plain, "qnn8"))
    monkeypatch.setattr(ref, "paged_attention_ref", counted(ref.paged_attention_ref,
                                                            "paged_attn"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cpu = torch.device("cpu")
    serve = cs.phase_qnn8_serve(torch, np, cpu)
    assert serve["launches"]["qnn8"] == 7 * 2 * 38 and serve["parity"]["max_abs_dlogit"] == 0.0
    spec = cs.phase_spec(torch, np, cpu)
    m = spec["paged_spec"]["summary"]
    assert spec["paged_spec"]["launches"]["qnn8"] == 14 * (4 * m["decode_steps"] + 8)
    assert spec["continuous_target"]["launches"] == cs._NO_LAUNCHES
    assert m["spec_accept_rate"] > 0
