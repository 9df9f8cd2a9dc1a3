"""PyTorch port vs the JAX reference: tensor-parallel serving on gloo ranks
(the CPU). The ranks are spawned processes joined through a ``FileStore``
in the test's tmp dir (``tests/_torch_tp_ranks.py``: one torch thread a
rank, a timeout on every collective, a deadline on every join); they import
no JAX, and the reference runs here in the parent.

- The reference test's arch (smollm SMOKE with 4 heads, 2 kv heads, head
  dim 24) at tp = 2 on the continuous, paged and static engines in dense,
  bika (packed), bnn (packed and unpacked) and qnn8: every rank's tokens
  equal the port's single-process engine's and the reference's; the first
  two prefill and decode logits equal single-process bit for bit (dense
  within 1e-5); each rank holds its block of every divisible projection,
  of the embedding and of the KV pool (Hkv / tp heads).
- The 1-kv-head SMOKE at tp = 2: attention and its pool replicated, the
  rest split, tokens equal.
- tp = 4 (the same arch: 2 kv heads do not divide 4, so attention stays
  whole): tokens equal.
- ``tp_pad_heads`` at 15 query heads and 5 kv heads, tp = 2: the padded
  heads' forward within 1e-5 of single-process and of the reference.
- A mesh with data > 1, speculation under a mesh and a mixture of experts
  under a mesh raise.
- ``launch/serve.py --smoke --device cpu --tp 2`` ends with its goodput line.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_tp_ranks as ranks_mod
from repro.configs import get_smoke as jax_get_smoke
from repro.core.convert import tree_to_serve as jax_tree_to_serve
from repro.models import build_model as jax_build_model
from repro.nn.module import unbox
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.core.convert import from_reference, tree_to_serve
from repro_torch.models.base import ArchConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP_ARCH = dict(n_heads=4, n_kv_heads=2, head_dim=24)  # the reference test's
MODES = {"dense": dict(compute_mode="dense"),
         "bika": dict(compute_mode="bika", pack_signs=True),
         "bnn_packed": dict(compute_mode="bnn", pack_signs=True),
         "bnn": dict(compute_mode="bnn"),
         "qnn8": dict(compute_mode="qnn8")}
ENGINES = ("continuous", "paged", "static")
ENGINE_KW = dict(max_len=32, n_slots=2, batch_size=2, kv_block_size=8, prefill_chunk=8)
NEW_TOKENS = 5
CASES = [(engine, mode) for mode in MODES for engine in ENGINES]
DENSE_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ArchConfig)})


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _prompts(vocab, seed=0, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, int(rng.randint(3, 12))).astype(np.int32) for _ in range(n)]


def _model(mode, **arch):
    """(reference config, its train tree (numpy), the port's config and
    serve tree (numpy)) from the reference's init: the same weights on
    every side."""
    jcfg = jax_get_smoke("smollm-360m", remat=False, **MODES[mode], **arch)
    jtrain = _np(unbox(jax_build_model(jcfg, phase="train").init(jax.random.PRNGKey(2))))
    cfg = _port_cfg(jcfg)
    serve = tree_to_serve(from_reference(jtrain), cfg.linear_spec())
    return jcfg, jtrain, cfg, _np(serve)


def _case(cfg, engine, seed=0):
    return {"arch": cfg, "engine": engine, "prompts": _prompts(cfg.vocab, seed),
            "new_tokens": NEW_TOKENS, "engine_kw": ENGINE_KW}


def _reference_tokens(jcfg, jtrain, case):
    kw = dict(ENGINE_KW)
    if case["engine"] != "paged":
        kw.pop("kv_block_size"), kw.pop("prefill_chunk")
    if case["engine"] == "static":
        kw.pop("n_slots")
    eng = JaxServeEngine.from_trained(jtrain, jcfg, engine=case["engine"], **kw)
    for i, p in enumerate(case["prompts"]):
        eng.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
    return {r.rid: [int(t) for t in r.output] for r in eng.run()}


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """One 2-rank session: the 15 cases, the 1-kv-head cases, the padded
    heads' forward and the refusals; and each case single-process."""
    models = {mode: _model(mode, **TP_ARCH) for mode in MODES}
    cases = [(_case(models[mode][2], engine), models[mode][3]) for engine, mode in CASES]
    one_kv = _model("bika")  # the SMOKE config as registered: 3 heads, 1 kv head
    one_kv_dense = _model("dense")
    cases += [(_case(one_kv[2], "paged", seed=1), one_kv[3]),
              (_case(one_kv_dense[2], "continuous", seed=1), one_kv_dense[3])]
    pad = _model("dense", n_heads=15, n_kv_heads=5, head_dim=8, tp_pad_heads=True)
    tokens = np.random.RandomState(4).randint(0, pad[2].vocab, (2, 12)).astype(np.int64)
    mcfg = jax_get_smoke("mixtral-8x22b", remat=False)
    mtrain = _np(unbox(jax_build_model(mcfg, phase="train").init(jax.random.PRNGKey(0))))
    moe_cfg = _port_cfg(mcfg)
    moe = (moe_cfg, _np(tree_to_serve(from_reference(mtrain), moe_cfg.linear_spec())))
    refuse = (models["bika"][2], models["bika"][3]) + moe
    got = ranks_mod.spawn(ranks_mod.serve_cases, 2, tmp_path_factory.mktemp("tp2"), cases,
                          (pad[2], pad[3], tokens), refuse)
    single = [ranks_mod.serve_case(case, tree) for case, tree in cases]
    return {"models": models, "one_kv": (one_kv, one_kv_dense), "cases": cases, "ranks": got,
            "single": single, "pad": (pad, tokens)}


def _expected_shape(path, shape, tp, heads=True):
    """A leaf's shape on a rank under the placement's rules: q/k/v by heads
    (where the kv heads divide tp), wo, gate/up, down by their last dim, the
    table by vocab rows, the rest whole."""
    parts = path.split("/")
    if parts[-2:] == ["embed", "table"]:
        return (shape[0] // tp,) + shape[1:]
    if len(parts) >= 5 and parts[-3] in ("attn", "mlp"):
        if parts[-2] in ("wq", "wk", "wv") and not heads:
            return shape
        return shape[:-1] + (shape[-1] // tp,)
    return shape


def _check_rank(rank, single, tp, dense, heads=True, kv_heads=None):
    assert rank["tokens"] == single["tokens"]
    for kind in ("prefill", "decode"):
        assert len(rank[kind]) == len(single[kind]) == 2
        for a, b in zip(rank[kind], single[kind]):
            if dense:
                np.testing.assert_allclose(a, b, atol=DENSE_ATOL, rtol=0)
            else:
                np.testing.assert_array_equal(a, b)
    for path, shape in single["param_shapes"].items():
        assert rank["param_shapes"][path] == _expected_shape(path, shape, tp, heads), path
    for key in ("pool_shapes", "cache_shapes"):
        if rank.get(key):
            for name, shape in rank[key].items():
                assert shape[3] == kv_heads, (key, name, shape)
                assert shape[:3] + shape[4:] == single[key][name][:3] + single[key][name][4:]


@pytest.mark.parametrize("engine,mode", CASES)
def test_tp2_equals_single_process_and_reference(tp2, engine, mode):
    i = CASES.index((engine, mode))
    case, _ = tp2["cases"][i]
    single = tp2["single"][i]
    jcfg, jtrain = tp2["models"][mode][:2]
    assert single["tokens"] == _reference_tokens(jcfg, jtrain, case)
    for rank in tp2["ranks"]:
        _check_rank(rank["cases"][i], single, 2, mode == "dense", kv_heads=1)
    r0 = tp2["ranks"][0]["cases"][i]
    assert r0["param_bytes"] < single["param_bytes"]
    if engine != "static":
        assert 2 * r0["pool_bytes"] == single["pool_bytes"]
    # 2 layers x (attention out, wo, h, down) + the logits a forward; one
    # all-reduce (the embedding) a forward
    forwards = r0["collectives"]["all_reduce"]
    assert forwards > 0 and r0["collectives"]["all_gather"] == 9 * forwards


@pytest.mark.parametrize("which", ["bika paged", "dense continuous"])
def test_tp2_one_kv_head_replicates_attention(tp2, which):
    j = len(CASES) + ["bika paged", "dense continuous"].index(which)
    case, _ = tp2["cases"][j]
    single = tp2["single"][j]
    jcfg, jtrain = tp2["one_kv"][0 if which.startswith("bika") else 1][:2]
    assert case["arch"].n_kv_heads == 1
    assert single["tokens"] == _reference_tokens(jcfg, jtrain, case)
    for rank in tp2["ranks"]:
        _check_rank(rank["cases"][j], single, 2, which.startswith("dense"), heads=False,
                    kv_heads=1)


def test_tp_pad_heads_at_15_heads(tp2):
    (jcfg, jtrain, cfg, serve), tokens = tp2["pad"]
    want, counts = ranks_mod.padded_forward(cfg, serve, tokens)
    assert counts == {"all_gather": 0, "all_reduce": 0}
    jserve = jax_tree_to_serve(jtrain, jcfg.linear_spec())
    ref = np.asarray(jax_build_model(jcfg, phase="serve").apply(jserve, {"tokens": tokens}))
    np.testing.assert_allclose(want, ref, atol=DENSE_ATOL, rtol=0)
    for rank in tp2["ranks"]:
        logits, counts = rank["pad"]
        np.testing.assert_allclose(logits, want, atol=DENSE_ATOL, rtol=0)
        # 2 layers x (padded heads, wo, h, down) + the logits; the embedding
        assert counts == {"all_gather": 9, "all_reduce": 1}


def test_mesh_refusals(tp2):
    for rank in tp2["ranks"]:
        msgs = rank["refused"]
        assert "data" in msgs["data"] and "ROADMAP" in msgs["data"]
        assert "speculative" in msgs["spec"]
        assert "ROADMAP" in msgs["moe"] and "mixtral" in msgs["moe"]
        # best_effort_mesh puts what divides the world on "model"; a
        # one-device mesh needs a group of one
        assert rank["meshes"]["model_2"] == (1, 2) and rank["meshes"]["model_3"] == (2, 1)
        assert "needs 1 ranks" in rank["meshes"]["single"]


def test_tp4_bika_paged(tmp_path):
    """4 ranks: 2 kv heads do not divide 4, so q/k/v and the pool stay whole
    on every rank; wo, the MLP and the embedding split four ways."""
    jcfg, jtrain, cfg, serve = _model("bika", **TP_ARCH)
    case = _case(cfg, "paged", seed=2)
    got = ranks_mod.spawn(ranks_mod.serve_cases, 4, tmp_path, [(case, serve)])
    single = ranks_mod.serve_case(case, serve)
    assert single["tokens"] == _reference_tokens(jcfg, jtrain, case)
    for rank in got:
        _check_rank(rank["cases"][0], single, 4, False, heads=False, kv_heads=2)


def test_launcher_tp2_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
         "--tp", "2", "--requests", "3", "--new-tokens", "4", "--max-len", "64",
         "--engine", "paged", "--kv-block-size", "8", "--prefill-chunk", "16"],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert "tp=2" in out.stdout and "completed 3 requests" in out.stdout
    assert any(line.startswith("[serve] goodput=") for line in lines[-6:]), out.stdout
