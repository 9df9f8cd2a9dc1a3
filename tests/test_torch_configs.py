"""PyTorch port vs the JAX reference: the rest of the ``lm`` family's
configs (mixtral-8x22b, grok-1-314b, nemotron-4-15b, qwen1.5-32b,
phi3-mini-3.8b, chameleon-34b) and the static engine, on the CPU at SMOKE
sizes (plain versions).

- The registry: every port config equals the reference's field for field.
- ``build_model`` forward logits (train form, dense and bika) and serve
  prefill logits (bika) of every SMOKE config within 1e-4 of the
  reference's, with greedy tokens equal and the MoE routing held at ties
  (``held_routes``: none met at these seeds).
- Drains token for token against the reference's engines: mixtral and grok
  on the static engine (``engine="auto"`` resolves to it: MoE, SWA) in
  bika, bnn and qnn8; the four dense configs on the continuous and paged
  engines in bika.
- The reference's static-engine behaviour tests and its SWA -> static /
  slot-scheduler-refuses test, ported.
- The serve launcher end to end on the CPU for mixtral (static) and
  nemotron (paged); the trainer refusing a mixture of experts.
"""
import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import get_smoke as jax_get_smoke
from repro.models import build_model as jax_build_model
from repro.nn.module import unbox
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.core.convert import tree_to_serve as jax_tree_to_serve
from repro_torch.configs import ARCH_NAMES, REGISTRY, applicable_shapes, get_config, get_smoke
from repro_torch.core.convert import from_reference
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models.base import ArchConfig
from repro_torch.serve import Request, ServeEngine, serve_batch
from repro_torch.serve.scheduler import SlotScheduler, scheduler_supports
from test_torch_moe import held_routes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
NEW = ("mixtral-8x22b", "grok-1-314b", "nemotron-4-15b", "qwen1.5-32b", "phi3-mini-3.8b",
       "chameleon-34b")
DENSE = ("nemotron-4-15b", "qwen1.5-32b", "phi3-mini-3.8b", "chameleon-34b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the tier-1 run
    holds several test processes at once, and torch's default of a thread
    a core in each of them oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ArchConfig)})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _train(name: str, mode: str, seed: int = 3):
    jcfg = jax_get_smoke(name, compute_mode=mode, remat=False, pack_signs=(mode == "bika"))
    train = unbox(jax_build_model(jcfg, phase="train").init(jax.random.PRNGKey(seed)))
    return jcfg, train


def _close(got: torch.Tensor, want, what: str) -> None:
    g, w = got.detach().numpy(), np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=what)
    np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1), err_msg=what)


def test_registry_matches_reference():
    """Every registered port config (and its SMOKE) equals the reference's
    on every field the port keeps, and no reference config is missing."""
    assert set(ARCH_NAMES) == {"smollm-360m", "zamba2-2.7b", "xlstm-125m",
                               "seamless-m4t-large-v2"} | set(NEW)
    assert set(REGISTRY) == set(JAX_REGISTRY)
    seamless = get_config("seamless-m4t-large-v2")
    assert (seamless.family, seamless.n_encoder_layers, seamless.frontend) == (
        "encdec", 24, "frames")
    assert (get_smoke("seamless-m4t-large-v2").n_encoder_layers,
            get_smoke("seamless-m4t-large-v2").encoder_seq) == (2, 32)
    for name in ARCH_NAMES:
        for attr in ("CONFIG", "SMOKE"):
            want = getattr(JAX_REGISTRY[name], attr)
            assert getattr(REGISTRY[name], attr) == port_cfg(want), (name, attr)
        assert get_config(name).padded_vocab == JAX_REGISTRY[name].CONFIG.padded_vocab
        from repro.configs import applicable_shapes as jax_shapes

        assert applicable_shapes(get_config(name)) == jax_shapes(JAX_REGISTRY[name].CONFIG)
    assert get_smoke("mixtral-8x22b", n_layers=1).n_layers == 1


@pytest.mark.parametrize("mode", ["dense", "bika"])
@pytest.mark.parametrize("name", NEW)
def test_forward_logits_match_reference(name, mode):
    """Train-form forward (logits and the MoE aux loss) of every SMOKE
    config, then the bika serve prefill's last-token logits."""
    jcfg, train = _train(name, mode)
    tokens = np.random.RandomState(1).randint(0, jcfg.vocab, (2, 32)).astype(np.int32)
    tcfg = port_cfg(jcfg)
    with held_routes() as stats:
        jl, jaux = jax_build_model(jcfg, phase="train").apply_aux(train,
                                                                  {"tokens": jnp.asarray(tokens)})
        tl, taux = build_model(tcfg, phase="train").apply_aux(
            from_reference(_np(train)), {"tokens": torch.from_numpy(tokens)})
    assert stats["ties"] == 0, stats
    assert stats["routes"] == (jcfg.n_layers if jcfg.n_experts else 0)
    _close(tl, jl, f"{name} {mode} forward")
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=1e-6)
    if mode != "bika":
        return
    jserve = jax_tree_to_serve(train, jcfg.linear_spec())
    with held_routes() as stats:
        jl, _ = jax_build_model(jcfg, phase="serve").prefill(
            jserve, {"tokens": jnp.asarray(tokens)}, max_len=48)
        with torch.inference_mode():
            tl, _ = build_model(tcfg, phase="serve").prefill(
                from_reference(_np(jserve)), {"tokens": torch.from_numpy(tokens)}, max_len=48)
    assert stats["ties"] == 0, stats
    _close(tl, jl, f"{name} serve prefill")


def _drain_prompts(vocab, n=6, seed=4):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, int(rng.randint(3, 12))).astype(np.int32) for _ in range(n)]


def _drain(eng, prompts, new, req_cls):
    for i, p in enumerate(prompts):
        eng.submit(req_cls(rid=i, prompt=p, max_new_tokens=new))
    return {r.rid: np.asarray(r.output) for r in eng.run()}


@pytest.mark.parametrize("mode", ["bika", "bnn", "qnn8"])
@pytest.mark.parametrize("name", ["mixtral-8x22b", "grok-1-314b"])
def test_static_engine_drains_match_reference(name, mode):
    """engine="auto" resolves to static for MoE (and SWA); 6 requests of
    3-11 tokens in groups of 4, left-padded, 14 new tokens each: mixtral's
    decode wraps its 16-slot ring. Token for token the reference's."""
    jcfg, train = _train(name, mode)
    kw = dict(batch_size=4, max_len=64)
    prompts = _drain_prompts(jcfg.vocab)
    jeng = JaxServeEngine.from_trained(train, jcfg, **kw)
    teng = ServeEngine.from_trained(from_reference(_np(train)), port_cfg(jcfg), device="cpu",
                                    **kw)
    assert jeng.engine == teng.engine == "static" and teng.metrics is None
    with held_routes() as stats:
        jdone = _drain(jeng, prompts, 14, JaxRequest)
        tdone = _drain(teng, prompts, 14, Request)
    assert stats["ties"] == 0, stats
    assert sorted(tdone) == list(range(len(prompts)))
    for i in range(len(prompts)):
        assert len(tdone[i]) == 14
        np.testing.assert_array_equal(tdone[i], jdone[i], err_msg=f"request {i}")


@pytest.mark.parametrize("engine", ["continuous", "paged"])
@pytest.mark.parametrize("name", DENSE)
def test_dense_configs_drain_like_reference(name, engine):
    """The four dense configs (LayerNorm, squared ReLU, q/k/v bias, head_dim
    16 at SMOKE) in bika on the slot engines: token for token the
    reference's."""
    jcfg, train = _train(name, "bika")
    kw = dict(max_len=48, n_slots=3, kv_block_size=8, prefill_chunk=8)
    prompts = _drain_prompts(jcfg.vocab, n=5)
    jeng = JaxServeEngine.from_trained(train, jcfg, engine=engine, **kw)
    teng = ServeEngine.from_trained(from_reference(_np(train)), port_cfg(jcfg), engine=engine,
                                    device="cpu", **kw)
    jdone = _drain(jeng, prompts, 7, JaxRequest)
    tdone = _drain(teng, prompts, 7, Request)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(tdone[i], jdone[i], err_msg=f"request {i}")


@pytest.fixture(scope="module")
def lm():
    cfg = get_smoke("smollm-360m", compute_mode="dense", remat=False)
    api = build_model(cfg, phase="serve")
    gen = torch.Generator().manual_seed(0)
    params = build_model(cfg, phase="train").init(gen, device="cpu")
    return cfg, api, params


def _ref(api, params, prompt, n_new, max_len):
    """Per-request serve_batch reference (batch of one, unpadded)."""
    return serve_batch(api, params, torch.from_numpy(prompt)[None], max_new_tokens=n_new,
                       max_len=max_len)[0].numpy()


def test_static_breaks_host_loop_when_all_rows_done(lm):
    """All rows hit EOS on the prefill token: the decode loop never runs
    instead of running to max(max_new_tokens)."""
    cfg, api, params = lm
    rng = np.random.RandomState(11)
    prompts = rng.randint(0, cfg.vocab, size=(2, 6)).astype(np.int32)
    firsts = [int(_ref(api, params, prompts[i], 1, 64)[0]) for i in range(2)]
    eng = ServeEngine(api, params, cfg, batch_size=2, max_len=64, engine="static", device="cpu")
    calls = {"n": 0}
    inner = api.decode_step

    def counting_decode(*a, **k):
        calls["n"] += 1
        return inner(*a, **k)

    eng.api = eng.api._replace(decode_step=counting_decode)
    for i in range(2):
        eng.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=50, eos_id=firsts[i]))
    done = eng.run()
    assert all(len(r.output) == 1 for r in done)
    assert calls["n"] == 0  # every row finished on the prefill token


def test_static_caps_decode_at_cache_end(lm):
    """prompt_len + max_new_tokens > max_len: the static loop stops at the
    cache end (a truncated output) instead of overwriting the last row."""
    cfg, api, params = lm
    rng = np.random.RandomState(12)
    prompt = rng.randint(0, cfg.vocab, 12).astype(np.int32)
    eng = ServeEngine(api, params, cfg, batch_size=1, max_len=16, engine="static", device="cpu")
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=10))
    out = eng.run()[0].output
    assert len(out) == 16 - 12 + 1  # cache positions 12..15 + the prefill token
    np.testing.assert_array_equal(out, _ref(api, params, prompt, 5, 16))


def test_swa_arch_falls_back_to_static(lm):
    cfg, api, params = lm
    swa = cfg.replace(window=8)
    assert not scheduler_supports(swa)
    eng = ServeEngine(api, params, swa, max_len=32, device="cpu")  # auto
    assert eng.engine == "static"
    with pytest.raises(ValueError, match="SWA"):
        SlotScheduler(api, params, swa, max_len=32, device="cpu")
    moe = get_smoke("mixtral-8x22b", window=None)
    assert not scheduler_supports(moe)
    with pytest.raises(ValueError, match="MoE"):
        SlotScheduler(build_model(moe), {}, moe, max_len=32, device="cpu")


def test_static_engine_refuses_speculation_and_extra_batch(lm):
    cfg, api, params = lm
    with pytest.raises(ValueError, match="spec_draft"):
        ServeEngine(api, params, cfg, engine="static", spec_draft=(api, params, cfg),
                    spec_k=4, device="cpu")
    eng = ServeEngine(api, params, cfg, engine="static", max_len=32, device="cpu")
    # the lm family's prefill reads no "frames": a drain with extra frames
    # equals the drain without them, as in the reference
    outs = []
    for extra in ({"frames": np.ones((1, 4, cfg.d_model), np.float32)}, None):
        eng.submit(Request(rid=0, prompt=np.arange(3, dtype=np.int32), max_new_tokens=2))
        outs.append(eng.run(extra_batch=extra)[0].output)
    np.testing.assert_array_equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(rid=1, prompt=np.arange(32, dtype=np.int32)))


@pytest.mark.parametrize("argv,want", [
    (["--arch", "mixtral-8x22b"], "engine=static"),
    (["--arch", "grok-1-314b", "--mode", "qnn8", "--engine", "static"], "engine=static"),
    (["--arch", "nemotron-4-15b", "--engine", "paged", "--kv-block-size", "8",
      "--prefill-chunk", "8"], "engine=paged"),
])
def test_launcher_serves_new_configs_on_cpu(capsys, argv, want):
    assert launch_serve.main(["--smoke", "--device", "cpu", "--requests", "5",
                              "--new-tokens", "6", "--max-len", "32"] + argv) == 0
    out = capsys.readouterr().out
    assert want in out and "completed 5 requests" in out


def test_trainer_refuses_moe():
    """The Trainer and the launcher no longer refuse a mixture of experts:
    grok-1's SMOKE config trains a step with a positive aux loss, and the
    launcher trains mixtral's."""
    from repro_torch.launch import train as launch_train
    from repro_torch.train.trainer import TrainConfig, Trainer

    trainer = Trainer(TrainConfig(arch=get_smoke("grok-1-314b"), seq_len=8, global_batch=2,
                                  steps=1, log_every=1), device="cpu")
    _, opt, log = trainer.run()
    assert opt["step"] == 1 and np.isfinite(log[0]["loss"]) and log[0]["aux_loss"] > 0
    assert launch_train.main(["--smoke", "--arch", "mixtral-8x22b", "--device", "cpu",
                              "--steps", "1", "--seq-len", "8", "--batch", "2"]) == 0


def test_new_modules_import_neither_jax_nor_reference():
    """The modules this slice adds import no jax and nothing of repro."""
    new = ["nn/moe.py", "nn/norms.py", "configs/__init__.py", "configs/shapes.py"] + [
        f"configs/{m}.py" for m in ("mixtral_8x22b", "grok1_314b", "nemotron4_15b",
                                    "qwen15_32b", "phi3_mini_38b", "chameleon_34b")]
    for rel in new:
        path = os.path.join(ROOT, "src", "repro_torch", rel)
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (rel, name)
