"""PyTorch port vs the JAX reference: the recurrent families, zamba2's
hybrid (Mamba2 blocks and one shared attention+MLP block) and xLSTM
(mLSTM and sLSTM blocks), on the CPU (plain versions of kernels 1, 7, 10).

The same numpy inputs and the reference's parameters (``from_reference``)
go through both packages; the reference runs eagerly, as its own tests run
it. Tolerances:

- dense: 2e-5, the bound of the reference's own scan-vs-step tests
  (``tests/test_nn_layers.py``); the port's scan against its own
  step-by-step decode within the same bound;
- bika, bnn, qnn8: 1e-4 on outputs, logits and states (``test_torch_lm``'s
  bound), with greedy tokens equal. A projection rounds (bika, qnn8) or
  binarizes (bnn) its input, and the two packages' float parts differ by a
  few ulps, so an input within those ulps of a half-way point (of 0 for a
  Sign) may take either code. The codes are held to the reference's at
  such genuine ties only (``test_torch_lm.held_codes``,
  ``test_torch_bnn.held_signs``), which also check that the port made
  exactly the reference's number of code tensors; any other difference
  fails. int8 KV codes are held alike and then compared exactly.
- serve trees leaf for leaf equal; engine drains token for token.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bnn import held_signs
from test_torch_lm import held_codes

import repro.nn.ssm as jssm
import repro.nn.xlstm_blocks as jxl
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
from repro_torch.models.base import ArchConfig
from repro_torch.nn import ssm, xlstm_blocks as xl
from repro_torch.serve import Request, ServeEngine, serve_batch
from repro_torch.serve.scheduler import scheduler_supports

DENSE_TOL = 2e-5
ATOL = 1e-4
MODES = ("dense", "bika", "bnn", "qnn8")
NAMES = ("zamba2-2.7b", "xlstm-125m")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the tier-1 run
    holds several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ArchConfig)})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tol(mode: str) -> float:
    return DENSE_TOL if mode == "dense" else ATOL


@contextlib.contextmanager
def held(mode: str):
    """The hold of ``mode``'s codes at genuine ties; yields ``taken(n_proj,
    n_kv)`` (a no-op for dense, where nothing is rounded but int8 KV)."""
    if mode in ("bika", "qnn8"):
        with held_codes(mode) as taken:
            yield taken
    elif mode == "bnn":
        with held_signs() as (taken, stats):
            yield taken
        assert stats["held"] <= 2, stats  # a tie is rare: many would hide a fault
    else:
        with held_codes("bika") as taken:  # K/V codes only: no bika projection runs
            yield lambda n_proj, n_kv: taken(0, n_kv)


def _pairs(got, want, path=""):
    """(path, port leaf, reference leaf) over two trees of one structure."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, set(got), set(want))
        for k in want:
            yield from _pairs(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            yield from _pairs(g, w, f"{path}[{i}]")
    else:
        yield path, got, want


def _close_trees(got, want, tol: float, what: str) -> None:
    for path, g, w in _pairs(got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, path, g.shape, w.shape,
                                                           g.dtype, w.dtype)
        if g.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {path}")  # held codes
        else:
            np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=f"{what} {path}")


def _close_logits(got, want, tol: float, what: str) -> None:
    g, w = got.detach().numpy(), np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=what)
    np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1), err_msg=what)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

# (reference module, port module, config, config kwargs, name prefix,
# projections a call); the SMOKE models' widths, so that the reference's
# eager ops compile once for the blocks and the models
BLOCKS = {
    "ssm": (jssm, ssm, "SSMConfig", dict(d_model=64, d_state=16, expand=2, head_dim=32),
            "ssm", 2),
    "mlstm": (jxl, xl, "XLSTMConfig", dict(d_model=64, n_heads=2), "mlstm", 5),
    "slstm": (jxl, xl, "XLSTMConfig", dict(d_model=64, n_heads=2), "slstm", 2),
}
PROMPT, STEPS = 9, 3  # tokens of a scan or prefill, then decode steps


def _block(block: str, mode: str):
    """(jax fns, port fns, jax cfg, port cfg, jax spec, port spec, jax serve
    params, port params, projections a call)."""
    jmod, tmod, cfg_name, kw, pre, n_proj = BLOCKS[block]
    jcfg, tcfg = getattr(jmod, cfg_name)(**kw), getattr(tmod, cfg_name)(**kw)
    pack = mode in ("bika", "bnn")
    jspec, tspec = JaxSpec(mode=mode, pack_signs=pack), LinearSpec(mode=mode, pack_signs=pack)
    train = unbox(getattr(jmod, f"{pre}_init")(jax.random.PRNGKey(7), jcfg, jspec))
    jparams = jax_tree_to_serve(train, jspec)
    state = "init_ssm_state" if pre == "ssm" else f"init_{pre}_state"
    jfn = [getattr(jmod, f"{pre}_{n}") for n in ("apply", "decode_step")] + [
        getattr(jmod, state)]
    tfn = [getattr(tmod, f"{pre}_{n}") for n in ("apply", "decode_step")] + [
        getattr(tmod, state)]
    return jfn, tfn, jcfg, tcfg, jspec, tspec, jparams, from_reference(_np(jparams)), n_proj


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_matches_reference(block, mode):
    """The block's scan with its final state, then 3 decode steps from that
    state, in serve form: outputs and states against the reference's."""
    (japply, jdecode, _), (tapply, tdecode, _), jcfg, tcfg, jspec, tspec, jp, tp, n_proj = (
        _block(block, mode))
    x = np.random.RandomState(1).normal(size=(2, PROMPT + STEPS, 64)).astype(np.float32)
    tol = _tol(mode)
    with held(mode) as taken, torch.inference_mode():
        jy, jst = japply(jp, jnp.asarray(x[:, :PROMPT]), jcfg, jspec, phase="serve",
                         return_state=True)
        ty, tst = tapply(tp, torch.from_numpy(x[:, :PROMPT]), tcfg, tspec, phase="serve",
                         return_state=True)
        taken(n_proj, 0)
        _close_trees(ty, jy, tol, f"{block} scan")
        _close_trees(tst, _np(jst), tol, f"{block} scan state")
        for t in range(PROMPT, PROMPT + STEPS):
            jy, jst = jdecode(jp, jnp.asarray(x[:, t:t + 1]), jst, jcfg, jspec, phase="serve")
            ty, tst = tdecode(tp, torch.from_numpy(x[:, t:t + 1]), tst, tcfg, tspec,
                              phase="serve")
            taken(n_proj, 0)
            _close_trees(ty, jy, tol, f"{block} decode {t}")
            _close_trees(tst, _np(jst), tol, f"{block} decode state {t}")


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_scan_equals_stepwise_decode(block):
    """The port's own scan equals its step-by-step decode from the zero
    state (dense), and the scan's final state the last step's."""
    _, (tapply, tdecode, tinit), _, tcfg, _, tspec, _, tp, _ = _block(block, "dense")
    x = torch.from_numpy(np.random.RandomState(2).normal(size=(2, 7, 64)).astype(np.float32))
    with torch.inference_mode():
        full, fst = tapply(tp, x, tcfg, tspec, return_state=True)
        st, outs = tinit(2, tcfg), []
        for t in range(x.shape[1]):
            y, st = tdecode(tp, x[:, t:t + 1], st, tcfg, tspec)
            outs.append(y)
    np.testing.assert_allclose(full.numpy(), torch.cat(outs, 1).numpy(), atol=DENSE_TOL, rtol=0)
    for path, g, w in _pairs(st, fst):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=DENSE_TOL, rtol=0, err_msg=path)


def test_ssm_conv_state_left_pads_a_short_prompt():
    """A prompt shorter than the conv's W-1 = 3 positions: the state holds
    its pre-conv inputs after zeros, as decode's window expects."""
    _, (tapply, tdecode, _), _, tcfg, _, tspec, _, tp, _ = _block("ssm", "dense")
    x = torch.from_numpy(np.random.RandomState(4).normal(size=(1, 5, 64)).astype(np.float32))
    with torch.inference_mode():
        full = tapply(tp, x, tcfg, tspec)
        y, st = tapply(tp, x[:, :2], tcfg, tspec, return_state=True)
        assert float(st["conv"][:, 0].abs().max()) == 0.0
        for t in range(2, 5):
            yt, st = tdecode(tp, x[:, t:t + 1], st, tcfg, tspec)
            y = torch.cat([y, yt], 1)
    np.testing.assert_allclose(y.numpy(), full.numpy(), atol=DENSE_TOL, rtol=0)


def test_softplus_has_no_threshold():
    """``ssm.softplus`` is jax.nn.softplus (logaddexp(x, 0)), which has no
    threshold of 20 as ``F.softplus`` has."""
    x = np.array([-30.0, -1.0, 0.0, 0.5, 19.9, 20.0, 20.1, 40.0], np.float32)
    got = ssm.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.nn.softplus(jnp.asarray(x))))


# ---------------------------------------------------------------------------
# the whole models at SMOKE size
# ---------------------------------------------------------------------------


def _train(name: str, mode: str, seed: int = 3):
    jcfg = jax_get_smoke(name, compute_mode=mode, remat=False,
                         pack_signs=mode in ("bika", "bnn"))
    return jcfg, unbox(jax_build_model(jcfg, phase="train").init(jax.random.PRNGKey(seed)))


def _n_proj(cfg) -> int:
    """Projection launches of one forward (prefill or decode step)."""
    if cfg.family == "hybrid":
        return 2 * cfg.n_layers + 7 * (cfg.n_layers // cfg.attn_every)
    n_s = sum(1 for i in range(cfg.n_layers) if i % cfg.slstm_every == 0)
    return 2 * n_s + 5 * (cfg.n_layers - n_s)


def _n_kv(cfg, quantized: bool) -> int:
    return 2 * (cfg.n_layers // cfg.attn_every) if quantized and cfg.family == "hybrid" else 0


@pytest.mark.parametrize("mode,phase", [("dense", "train"), ("bika", "train"),
                                        ("bika", "serve")])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name, mode, phase):
    """``apply`` over 9 tokens in the train form (bika: the training CAC's
    plain version) or the serve form: logits against the reference's (a
    dense tree serves in its train form; the serve form in bnn and qnn8 is
    held by the prefill test below)."""
    jcfg, train = _train(name, mode)
    tokens = np.random.RandomState(1).randint(0, jcfg.vocab, (2, PROMPT)).astype(np.int32)
    jparams = train if phase == "train" else jax_tree_to_serve(train, jcfg.linear_spec())
    japi = jax_build_model(jcfg, phase=phase)
    tapi = build_model(port_cfg(jcfg), phase=phase)
    with held(mode if phase == "serve" else "dense") as taken, torch.no_grad():
        jl = japi.apply(jparams, {"tokens": jnp.asarray(tokens)})
        tl = tapi.apply(from_reference(_np(jparams)), {"tokens": torch.from_numpy(tokens)})
        taken(_n_proj(jcfg) if phase == "serve" else 0, 0)
    _close_logits(tl, jl, _tol(mode), f"{name} {mode} {phase} forward")


@pytest.mark.parametrize("name,mode,quantized", [
    ("zamba2-2.7b", "dense", False), ("zamba2-2.7b", "bika", False),
    ("zamba2-2.7b", "bnn", False), ("zamba2-2.7b", "qnn8", False),
    ("zamba2-2.7b", "bika", True),
    ("xlstm-125m", "dense", False), ("xlstm-125m", "bika", False),
    ("xlstm-125m", "bnn", False), ("xlstm-125m", "qnn8", False)])
def test_prefill_and_decode_match_reference(name, mode, quantized):
    """``prefill`` of 2 x 9 tokens (max_len 16) and 3 ``decode_step``s in
    serve form, fp32 or int8 KV (the hybrid's shared block): logits and the
    final caches (SSM h / conv, mLSTM C / n / m, sLSTM h / c / n / m, each
    group's K/V) against the reference's."""
    jcfg, train = _train(name, mode)
    jparams = jax_tree_to_serve(train, jcfg.linear_spec())
    japi = jax_build_model(jcfg, phase="serve")
    tapi = build_model(port_cfg(jcfg), phase="serve")
    tparams = views_of(tapi, from_reference(_np(jparams)))
    tokens = np.random.RandomState(2).randint(0, jcfg.vocab, (2, PROMPT)).astype(np.int32)
    tol, n_proj, n_kv = _tol(mode), _n_proj(jcfg), _n_kv(jcfg, quantized)
    with held(mode) as taken, torch.inference_mode():
        jl, jc = japi.prefill(jparams, {"tokens": jnp.asarray(tokens)}, max_len=16,
                              quantized=quantized)
        tl, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, max_len=16,
                              quantized=quantized)
        taken(n_proj, n_kv)
        _close_logits(tl, jl, tol, "prefill")
        _close_trees(tc, _np(jc), tol, "prefill cache")
        for t in range(PROMPT, PROMPT + STEPS):
            tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
            jl, jc = japi.decode_step(jparams, jnp.asarray(tok), jc, jnp.asarray(t, jnp.int32))
            tl, tc = tapi.decode_step(tparams, torch.from_numpy(tok), tc, t)
            taken(n_proj, n_kv)
            _close_logits(tl, jl, tol, f"decode {t}")
    _close_trees(tc, _np(jc), tol, "final cache")


@pytest.mark.parametrize("name", NAMES)
def test_incremental_decode_matches_full_forward(name):
    """The port's twin of the reference's ``test_serve.py`` check: greedy
    prefill + decode equals growing the sequence through the full forward."""
    cfg = get_smoke(name, compute_mode="dense", remat=False)
    api = build_model(cfg, phase="train")
    params = api.init(torch.Generator().manual_seed(3), device="cpu")
    prompts = torch.from_numpy(
        np.random.RandomState(3).randint(0, cfg.vocab, (2, 7)).astype(np.int32))
    with torch.inference_mode():
        got = serve_batch(api, params, prompts, max_new_tokens=5, max_len=16)
        toks, want = prompts, []
        for _ in range(5):
            nxt = api.apply(params, {"tokens": toks})[:, -1].argmax(-1).to(torch.int32)[:, None]
            want.append(nxt)
            toks = torch.cat([toks, nxt], 1)
    np.testing.assert_array_equal(got.numpy(), torch.cat(want, 1).numpy())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_serve_tree_matches_reference(name, mode):
    """The port's ``tree_to_serve`` of the reference's train tree equals the
    reference's serve tree leaf for leaf: the stacked Mamba leaves, the
    list of heterogeneous xLSTM layers and the shared block come through
    whole, and the float leaves (conv_w, A_log, D, dt_bias, norm_scale,
    ifg, r) pass through untouched."""
    jcfg, train = _train(name, mode)
    want = _np(jax_tree_to_serve(train, jcfg.linear_spec()))
    src = from_reference(_np(train))
    got = tree_to_serve(src, port_cfg(jcfg).linear_spec())
    leaves = 0
    for path, g, w in _pairs(got, want):
        assert g.dtype == torch.from_numpy(np.asarray(w)).dtype, (path, g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
        leaves += 1
    assert leaves == len(jax.tree_util.tree_leaves(want))
    floats = ("conv_w", "A_log", "D", "dt_bias", "norm_scale") if name == "zamba2-2.7b" else (
        "ifg", "r", "norm_scale")
    cells = ([src["mamba"]["ssm"]], [got["mamba"]["ssm"]]) if name == "zamba2-2.7b" else (
        [lyr["cell"] for lyr in src["layers"]], [lyr["cell"] for lyr in got["layers"]])
    seen = set()
    for a, b in zip(*cells):
        for key in floats:
            if key in a:
                assert b[key] is a[key], key  # passed through, not copied or converted
                seen.add(key)
    assert seen == set(floats)


def _drain(eng, prompts, new, req_cls):
    for i, p in enumerate(prompts):
        eng.submit(req_cls(rid=i, prompt=p, max_new_tokens=new))
    return {r.rid: np.asarray(r.output) for r in eng.run()}


@pytest.mark.parametrize("mode", ["dense", "bika"])
@pytest.mark.parametrize("name", NAMES)
def test_static_engine_drain_matches_reference(name, mode):
    """``ServeEngine.from_trained`` with engine="auto" resolves to static
    for both families in both packages; 5 requests of 3-11 tokens in groups
    of 4, left-padded (the pads go through the recurrences, as in the
    reference), 6 new tokens each: token for token the reference's."""
    jcfg, train = _train(name, mode)
    kw = dict(batch_size=4, max_len=32)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, jcfg.vocab, int(rng.randint(3, 12))).astype(np.int32)
               for _ in range(5)]
    assert len({len(p) for p in prompts[:4]}) > 1
    jeng = JaxServeEngine.from_trained(train, jcfg, **kw)
    teng = ServeEngine.from_trained(from_reference(_np(train)), port_cfg(jcfg), device="cpu",
                                    **kw)
    assert jeng.engine == teng.engine == "static" and teng.metrics is None
    jdone = _drain(jeng, prompts, 6, JaxRequest)
    tdone = _drain(teng, prompts, 6, Request)
    assert sorted(tdone) == list(range(len(prompts)))
    for i in range(len(prompts)):
        assert len(tdone[i]) == 6
        np.testing.assert_array_equal(tdone[i], jdone[i], err_msg=f"request {i}")


@pytest.mark.parametrize("name", NAMES)
def test_registry_engine_and_trainer(name):
    """The registered config equals the reference's field for field (and
    runs long_500k); auto resolves to static and a slot engine refuses the
    family; the Trainer takes it (no frames; ``tests/test_torch_train_recurrent.py``
    trains it); the model has no paged or speculative entry."""
    from repro_torch.train.trainer import TrainConfig, Trainer

    from repro.configs import applicable_shapes as jax_shapes

    for attr, get in (("CONFIG", get_config), ("SMOKE", get_smoke)):
        assert get(name) == port_cfg(getattr(JAX_REGISTRY[name], attr)), attr
    assert applicable_shapes(get_config(name)) == jax_shapes(JAX_REGISTRY[name].CONFIG)
    assert "long_500k" in applicable_shapes(get_config(name))
    cfg = get_smoke(name)
    assert not scheduler_supports(cfg)
    api = build_model(cfg)
    assert api.decode_paged is api.prefill_chunk is api.decode_verify is None
    params = api.init(0, device="cpu")
    eng = ServeEngine(api, params, cfg, max_len=16, device="cpu")
    assert eng.engine == "static"
    with pytest.raises(ValueError, match="static engine"):
        ServeEngine(api, params, cfg, max_len=16, engine="continuous", device="cpu")
    trainer = Trainer(TrainConfig(arch=cfg, seq_len=8, global_batch=2, steps=1), device="cpu")
    assert trainer.data_cfg.frames_dim == 0 and trainer.api.apply is not None


@pytest.mark.parametrize("name,mode", [("zamba2-2.7b", "bika"), ("xlstm-125m", "qnn8")])
def test_launcher_serves_recurrent_configs_on_cpu(capsys, name, mode):
    assert launch_serve.main(["--smoke", "--device", "cpu", "--arch", name, "--mode", mode,
                              "--requests", "5", "--new-tokens", "4", "--max-len", "32"]) == 0
    out = capsys.readouterr().out
    assert "engine=static" in out and "completed 5 requests" in out
