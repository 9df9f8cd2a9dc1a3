"""PyTorch port vs the JAX reference: the encoder-decoder family
(seamless-m4t-large-v2's SMOKE config: 2 encoder and 2 decoder layers,
d_model 64, encoder_seq 32) on the CPU (plain versions of kernels 1, 7,
10).

The same numpy inputs (frames and tokens) and the reference's parameters
(``from_reference``) go through both packages; the reference runs eagerly,
as its own tests run it, except its static engine, which jits prefill and
decode as it always does. Tolerances, as in ``test_torch_recurrent``:

- dense: 2e-5;
- bika, bnn, qnn8: 1e-4 on outputs, logits and caches, with greedy tokens
  equal. The codes a projection rounds (bika, qnn8) or binarizes (bnn) its
  input to, and int8 self-KV codes, are held to the reference's at genuine
  half-way ties only (``test_torch_lm.held_codes``,
  ``test_torch_bnn.held_signs``), which also check that the port made
  exactly the reference's number of code tensors.

The reference's prefill projects each decoder layer's cross K/V twice
(inside its cross ``attn_apply`` and again in ``cross_kv``, from the same
input with the same weights); the port projects them once. The codes of
the reference's second projection are the first one's, so they are not
sent to the hold's queue (``_one_cross_kv``).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_recurrent import _close_logits, _close_trees, _np, _pairs, _tol, held, port_cfg

import repro.core.backend as jax_backend
import repro.models.encdec as jax_encdec
import repro.nn.attention as jattn
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import get_smoke as jax_get_smoke
from repro.core.convert import tree_to_serve as jax_tree_to_serve
from repro.models import build_model as jax_build_model
from repro.nn.linear import LinearSpec as JaxSpec
from repro.nn.module import unbox
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import applicable_shapes, get_config, get_smoke
from repro_torch.core.backend import LinearSpec
from repro_torch.core.convert import from_reference, tree_to_serve
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, views_of
from repro_torch.nn import attention as tattn
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.scheduler import scheduler_supports

NAME = "seamless-m4t-large-v2"
MODES = ("dense", "bika", "bnn", "qnn8")
FRAMES, PROMPT, STEPS = 16, 9, 3  # encoder frames, prompt tokens, decode steps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the tier-1 run
    holds several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(seed: int, b: int, d: int = 64, s: int = FRAMES) -> np.ndarray:
    return (0.1 * np.random.RandomState(seed).normal(size=(b, s, d))).astype(np.float32)


def _tokens(seed: int, b: int, s: int, vocab: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(np.int32)


def _train(mode: str, seed: int = 3):
    jcfg = jax_get_smoke(NAME, compute_mode=mode, remat=False,
                         pack_signs=mode in ("bika", "bnn"))
    return jcfg, unbox(jax_build_model(jcfg, phase="train").init(jax.random.PRNGKey(seed)))


def _n_proj(cfg, prefill: bool) -> int:
    """Projection launches (code tensors) of a prefill (6 an encoder layer;
    4 self, 4 cross, 2 MLP a decoder layer) or a decode step (4 self, 2
    cross, 2 MLP a decoder layer)."""
    return 6 * cfg.n_encoder_layers + 10 * cfg.n_layers if prefill else 8 * cfg.n_layers


@contextlib.contextmanager
def _one_cross_kv(mode: str):
    """Inside a hold: the reference's second cross K/V projection
    (``encdec.cross_kv``, the one caller of that module's ``linear_apply``
    at prefill) sends no codes to the hold's queue."""
    if mode == "dense":
        yield
        return
    jbe = jax_backend.get_backend(mode)
    sending, real, muted = jbe.apply_serve, jax_encdec.linear_apply, [False]

    def apply_serve(params, x, spec, *, blocks=None):
        if muted[0]:
            return type(jbe).apply_serve(jbe, params, x, spec, blocks=blocks)
        return sending(params, x, spec, blocks=blocks)

    def linear_apply(*args, **kw):
        muted[0] = True
        try:
            return real(*args, **kw)
        finally:
            muted[0] = False

    jbe.apply_serve, jax_encdec.linear_apply = apply_serve, linear_apply
    try:
        yield
    finally:
        jbe.apply_serve, jax_encdec.linear_apply = sending, real


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["dense", "bika"])
def test_cross_attention_matches_reference(mode):
    """``attn_apply(kv_x=)`` of a cross layer (no RoPE, every key visible)
    in serve form, x (2, 5, 64) over kv_x (2, 16, 64), against the
    reference's; the port's ``cross_attention`` returns the same output and
    the projected K/V of kv_x."""
    kw = dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, causal=False, cross=True)
    jcfg, tcfg = jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)
    pack = mode == "bika"
    jspec, tspec = JaxSpec(mode=mode, pack_signs=pack), LinearSpec(mode=mode, pack_signs=pack)
    train = unbox(jattn.attn_init(jax.random.PRNGKey(5), jcfg, jspec))
    jp = jax_tree_to_serve(train, jspec)
    tp = from_reference(_np(jp))
    rng = np.random.RandomState(6)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    kv_x = rng.normal(size=(2, FRAMES, 64)).astype(np.float32)
    with held(mode) as taken, torch.inference_mode():
        want = jattn.attn_apply(jp, jnp.asarray(x), jcfg, jspec, phase="serve",
                                kv_x=jnp.asarray(kv_x))
        got = tattn.attn_apply(tp, torch.from_numpy(x), tcfg, tspec, phase="serve",
                               kv_x=torch.from_numpy(kv_x))
        taken(4 if mode == "bika" else 0, 0)
    _close_trees(got, _np(want), _tol(mode), "cross attention")
    with torch.inference_mode():  # the port against itself: no hold
        one = tattn.attn_apply(tp, torch.from_numpy(x), tcfg, tspec, phase="serve",
                               kv_x=torch.from_numpy(kv_x))
        again, k, v = tattn.cross_attention(tp, torch.from_numpy(x), torch.from_numpy(kv_x),
                                            tcfg, tspec, phase="serve")
    assert torch.equal(one, again) and k.shape == v.shape == (2, FRAMES, 4, 16)


# ---------------------------------------------------------------------------
# the whole model at SMOKE size
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,phase", [("dense", "train"), ("bika", "train"),
                                        ("bika", "serve")])
def test_forward_matches_reference(mode, phase):
    """``apply`` over 16 frames and 9 tokens in the train form (bika: the
    training CAC's plain version) or the serve form: logits against the
    reference's."""
    jcfg, train = _train(mode)
    frames, tokens = _frames(1, 2), _tokens(1, 2, PROMPT, jcfg.vocab)
    jparams = train if phase == "train" else jax_tree_to_serve(train, jcfg.linear_spec())
    japi = jax_build_model(jcfg, phase=phase)
    tapi = build_model(port_cfg(jcfg), phase=phase)
    with held(mode if phase == "serve" else "dense") as taken, torch.no_grad():
        jl = japi.apply(jparams, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)})
        tl = tapi.apply(from_reference(_np(jparams)), {"frames": torch.from_numpy(frames),
                                                       "tokens": torch.from_numpy(tokens)})
        taken(_n_proj(jcfg, True) if phase == "serve" else 0, 0)
    _close_logits(tl, jl, _tol(mode), f"{mode} {phase} forward")


@pytest.mark.parametrize("mode,quantized", [(m, q) for m in MODES for q in (False, True)])
def test_prefill_and_decode_match_reference(mode, quantized):
    """``prefill`` of 16 frames and 2 x 9 tokens (max_len 16) and 3
    ``decode_step``s in serve form, fp32 or int8 self KV: logits and the
    three caches (``self``, ``cross_k``, ``cross_v``; the cross cache in
    float32 also under int8 self KV) against the reference's."""
    jcfg, train = _train(mode)
    jparams = jax_tree_to_serve(train, jcfg.linear_spec())
    japi = jax_build_model(jcfg, phase="serve")
    tapi = build_model(port_cfg(jcfg), phase="serve")
    tparams = views_of(tapi, from_reference(_np(jparams)))
    frames, tokens = _frames(2, 2), _tokens(2, 2, PROMPT, jcfg.vocab)
    tol, n_kv = _tol(mode), (2 * jcfg.n_layers if quantized else 0)
    with held(mode) as taken, torch.inference_mode():
        with _one_cross_kv(mode):
            jl, jc = japi.prefill(jparams, {"frames": jnp.asarray(frames),
                                            "tokens": jnp.asarray(tokens)},
                                  max_len=16, quantized=quantized)
        tl, tc = tapi.prefill(tparams, {"frames": torch.from_numpy(frames),
                                        "tokens": torch.from_numpy(tokens)},
                              max_len=16, quantized=quantized)
        taken(_n_proj(jcfg, True), n_kv)
        assert tc["cross_k"].dtype == tc["cross_v"].dtype == torch.float32
        _close_logits(tl, jl, tol, "prefill")
        _close_trees(tc, _np(jc), tol, "prefill cache")
        cross = {k: tc[k].clone() for k in ("cross_k", "cross_v")}
        for t in range(PROMPT, PROMPT + STEPS):
            tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
            jl, jc = japi.decode_step(jparams, jnp.asarray(tok), jc, jnp.asarray(t, jnp.int32))
            tl, tc = tapi.decode_step(tparams, torch.from_numpy(tok), tc, t)
            taken(_n_proj(jcfg, False), 2 * jcfg.n_layers if quantized else 0)
            _close_logits(tl, jl, tol, f"decode {t}")
    _close_trees(tc, _np(jc), tol, "final cache")
    for k, v in cross.items():  # decode reads the cross cache and never writes it
        assert torch.equal(tc[k], v), k


def test_incremental_decode_matches_full_forward():
    """The port's twin of the reference's ``test_serve.py`` check: greedy
    prefill + decode equals growing the sequence through the full forward,
    the frames the same throughout."""
    cfg = get_smoke(NAME, compute_mode="dense", remat=False)
    api = build_model(cfg, phase="train")
    params = api.init(torch.Generator().manual_seed(3), device="cpu")
    frames = torch.from_numpy(_frames(3, 2))
    prompts = torch.from_numpy(_tokens(3, 2, 7, cfg.vocab))
    cache = api.init_cache(2, 16, encoder_len=FRAMES, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items() if k != "self"} == {
        "cross_k": (2, 2, FRAMES, 4, 16), "cross_v": (2, 2, FRAMES, 4, 16)}
    with torch.inference_mode():
        logits, cache = api.prefill(params, {"frames": frames, "tokens": prompts}, max_len=16)
        got = [logits[:, -1].argmax(-1).to(torch.int32)[:, None]]
        for t in range(7, 11):
            logits, cache = api.decode_step(params, got[-1], cache, t)
            got.append(logits[:, -1].argmax(-1).to(torch.int32)[:, None])
        toks, want = prompts, []
        for _ in range(5):
            nxt = api.apply(params, {"frames": frames, "tokens": toks})[:, -1].argmax(-1)
            want.append(nxt.to(torch.int32)[:, None])
            toks = torch.cat([toks, want[-1]], 1)
    np.testing.assert_array_equal(torch.cat(got, 1).numpy(), torch.cat(want, 1).numpy())


@pytest.mark.parametrize("mode", MODES)
def test_serve_tree_matches_reference(mode):
    """The port's ``tree_to_serve`` of the reference's train tree equals the
    reference's serve tree leaf for leaf: both stacks' projections (the
    decoder's self and cross attention) come through whole, and the tied
    head and every norm pass through float and untouched."""
    jcfg, train = _train(mode)
    want = _np(jax_tree_to_serve(train, jcfg.linear_spec()))
    src = from_reference(_np(train))
    got = tree_to_serve(src, port_cfg(jcfg).linear_spec())
    leaves = 0
    for path, g, w in _pairs(got, want):
        assert g.dtype == torch.from_numpy(np.asarray(w)).dtype, (path, g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
        leaves += 1
    assert leaves == len(jax.tree_util.tree_leaves(want))
    assert got["embed"]["table"] is src["embed"]["table"]
    assert got["embed"]["table"].dtype == torch.float32
    norms = [("enc_ln_in",), ("enc_ln_f",), ("ln_f",)] + [
        (stack, ln) for stack, lns in (("encoder", ("ln1", "ln2")),
                                       ("decoder", ("ln1", "lnx", "ln2"))) for ln in lns]
    for keys in norms:
        a, b = src, got
        for k in keys:
            a, b = a[k], b[k]
        for leaf in a:
            assert b[leaf] is a[leaf], keys  # passed through, not copied or converted


# ---------------------------------------------------------------------------
# the static engine, the launcher, the registry and the trainer
# ---------------------------------------------------------------------------


def _drain(eng, prompts, new, req_cls, extra):
    for i, p in enumerate(prompts):
        eng.submit(req_cls(rid=i, prompt=p, max_new_tokens=new))
    return {r.rid: np.asarray(r.output) for r in eng.run(extra_batch=extra)}


@pytest.mark.parametrize("mode", ["dense", "bika"])
def test_static_engine_drain_matches_reference(mode):
    """``ServeEngine.from_trained`` with engine="auto" resolves to static in
    both packages; 5 requests of 3-11 tokens in groups of 4 (left-padded
    decoder prompts; the frames are not padded), frames (4, 16, 64) given
    once as ``run(extra_batch=)``: both groups get the leading rows (the
    second ``frames[:1]``), as in the reference; 6 new tokens each, token
    for token the reference's."""
    jcfg, train = _train(mode)
    kw = dict(batch_size=4, max_len=32)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, jcfg.vocab, int(rng.randint(3, 12))).astype(np.int32)
               for _ in range(5)]
    assert len({len(p) for p in prompts[:4]}) > 1
    frames = _frames(4, 4)
    jeng = JaxServeEngine.from_trained(train, jcfg, **kw)
    teng = ServeEngine.from_trained(from_reference(_np(train)), port_cfg(jcfg), device="cpu",
                                    **kw)
    assert jeng.engine == teng.engine == "static" and teng.metrics is None
    jdone = _drain(jeng, prompts, 6, JaxRequest, {"frames": jnp.asarray(frames)})
    tdone = _drain(teng, prompts, 6, Request, {"frames": frames})
    assert sorted(tdone) == list(range(len(prompts)))
    for i in range(len(prompts)):
        assert len(tdone[i]) == 6
        np.testing.assert_array_equal(tdone[i], jdone[i], err_msg=f"request {i}")
    # the second group alone, with frames[:1]: the same tokens as in the drain
    teng.submit(Request(rid=4, prompt=prompts[4], max_new_tokens=6))
    alone = teng.run(extra_batch={"frames": torch.from_numpy(frames[:1])})
    np.testing.assert_array_equal(alone[0].output, tdone[4])


def test_registry_engines_and_trainer():
    """The registered config equals the reference's field for field; auto
    resolves to static, a slot engine refuses the family and a slot
    engine's ``run`` refuses ``extra_batch``; the Trainer takes the family
    and its batches carry (B, S, d_model) frames; the model has no paged or
    speculative entry."""
    from repro_torch.train.trainer import TrainConfig, Trainer

    from repro.configs import applicable_shapes as jax_shapes

    for attr, get in (("CONFIG", get_config), ("SMOKE", get_smoke)):
        assert get(NAME) == port_cfg(getattr(JAX_REGISTRY[NAME], attr)), attr
    assert applicable_shapes(get_config(NAME)) == jax_shapes(JAX_REGISTRY[NAME].CONFIG)
    assert get_config(NAME).padded_vocab == 256256
    cfg = get_smoke(NAME)
    assert not scheduler_supports(cfg)
    api = build_model(cfg)
    assert api.decode_paged is api.prefill_chunk is api.decode_verify is None
    params = api.init(0, device="cpu")
    assert ServeEngine(api, params, cfg, max_len=16, device="cpu").engine == "static"
    for engine in ("continuous", "paged"):
        with pytest.raises(ValueError, match="static engine"):
            ServeEngine(api, params, cfg, max_len=16, engine=engine, device="cpu")
    lm = get_smoke("smollm-360m")
    lm_api = build_model(lm)
    slot = ServeEngine(lm_api, lm_api.init(0, device="cpu"), lm, max_len=16, device="cpu")
    assert slot.engine == "continuous"
    with pytest.raises(ValueError, match="extra_batch"):
        slot.run(extra_batch={"frames": np.zeros((1, 4, lm.d_model), np.float32)})
    batch = Trainer(TrainConfig(arch=cfg, seq_len=8, global_batch=2, steps=1),
                    device="cpu").batch(0)
    assert batch["frames"].shape == (2, 8, cfg.d_model) and batch["tokens"].shape == (2, 8)


@pytest.mark.parametrize("mode", ["bika", "qnn8"])
def test_launcher_serves_seamless_on_cpu(capsys, mode):
    assert launch_serve.main(["--smoke", "--device", "cpu", "--arch", NAME, "--mode", mode,
                              "--requests", "5", "--new-tokens", "4", "--max-len", "32"]) == 0
    out = capsys.readouterr().out
    assert "engine=static" in out and "completed 5 requests" in out
