"""PyTorch port vs the JAX reference: the paged serving runtime on the CPU.

- ``PagedKVManager`` host state (chained hashes, block tables, refcounts,
  LRU, evictions, copy-on-write) after one scripted admit/free sequence;
- the paged engine's tokens against the JAX ``ServeEngine(engine="paged")``
  on the same weights and prompts: dense and bika, fp and int8 KV, with a
  shared-prefix hit, a request crossing a block boundary and a queue longer
  than ``n_slots`` — held token for token;
- the continuous engine (what ``engine="auto"`` resolves to) emits the
  paged engine's tokens with fp KV;
- the launcher runs on the CPU when asked: paged, ``--mode qnn8``, and
  ``--spec-draft qnn8 --spec-k 4`` on both slot engines;
- the entry points refuse to fall back to the CPU when CUDA is absent."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import build_model as jax_build_model
from repro.nn.module import unbox
from repro.serve import PagedKVManager as JaxPagedKVManager
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import hash_prompt_blocks as jax_hash_prompt_blocks
from repro_torch.core.convert import from_reference
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models.base import ArchConfig
from repro_torch.serve import (
    PagedKVManager,
    PagedSlotScheduler,
    Request,
    ServeEngine,
    hash_prompt_blocks,
)


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


def test_hash_chain_matches_reference():
    rng = np.random.RandomState(0)
    for plen, bs in ((5, 4), (33, 8), (64, 16)):
        prompt = rng.randint(0, 50000, plen).astype(np.int32)
        assert hash_prompt_blocks(prompt, bs) == jax_hash_prompt_blocks(prompt, bs)


def _state(kv):
    return dict(
        tables=kv.tables.copy(),
        ref=kv._ref.copy(),
        hash_to_block=dict(kv._hash_to_block),
        block_hash=dict(kv._block_hash),
        lru=list(kv._lru),
        free=sorted(kv._free_set),
        slot_free=sorted(kv._slot_free_set),
        slot_blocks=[list(b) for b in kv._slot_blocks],
        evictions=kv.evictions,
        cow=kv.cow_copies,
    )


def _assert_same_state(a, b, step):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{step}: {k}")
        else:
            assert a[k] == b[k], (step, k, a[k], b[k])


def test_paged_kv_manager_matches_reference():
    """One scripted admit/register/free/COW sequence through both managers:
    identical return values and host state after every step, and the COW
    block copy moves the same pool bytes."""
    jcfg = jax_get_smoke("smollm-360m", remat=False)
    japi = jax_build_model(jcfg, phase="serve")
    tapi = build_model(port_cfg(jcfg), phase="serve")
    kw = dict(n_slots=3, max_len=32, block_size=8, n_blocks=7)
    jkv = JaxPagedKVManager(japi, **kw)
    tkv = PagedKVManager(tapi, device="cpu", **kw)
    rng = np.random.RandomState(1)
    pool = {name: rng.normal(size=leaf.shape).astype(np.float32)
            for name, leaf in jkv.cache.items()}
    jkv.cache = {k: jnp.asarray(v) for k, v in pool.items()}
    tkv.cache = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    shared = rng.randint(0, 500, 16).astype(np.int32)
    prompts = {
        "a": np.concatenate([shared, rng.randint(0, 500, 4).astype(np.int32)]),
        "b": np.concatenate([shared, rng.randint(0, 500, 6).astype(np.int32)]),
        "c": rng.randint(0, 500, 9).astype(np.int32),
        "d": rng.randint(0, 500, 17).astype(np.int32),
        "e": np.concatenate([shared, rng.randint(0, 500, 2).astype(np.int32)]),
    }
    slots = {}

    def both(step, fn):
        rj, rt = fn(jkv), fn(tkv)
        assert rj == rt, (step, rj, rt)
        _assert_same_state(_state(jkv), _state(tkv), step)
        return rj

    def admit(name, budget):
        def go(kv):
            slot = kv.alloc_slot()
            got = kv.try_admit(slot, prompts[name], budget=budget, chunk=8)
            if got is None:
                kv.free_slot(slot)
                return None, slot
            kv.register_prompt(slot, prompts[name])
            return got, slot
        cached, slot = both(f"admit {name}", go)
        slots[name] = slot
        return cached

    assert admit("a", 4) == 0
    assert admit("b", 4) == 16  # shared-prefix hit on both full blocks
    both("free a", lambda kv: kv.free_slot(slots["a"]))
    assert admit("c", 4) == 0
    assert admit("d", 10) is None  # backpressure: deferred, nothing mutated
    both("free b", lambda kv: kv.free_slot(slots["b"]))
    assert admit("e", 4) == 16  # hit on blocks cached at refcount 0
    both("cow", lambda kv: kv.ensure_private(slots["e"], 0))
    both("free c", lambda kv: kv.free_slot(slots["c"]))
    assert admit("d", 10) == 0  # evicts LRU cached blocks
    for name in pool:
        np.testing.assert_array_equal(tkv.cache[name].numpy(), np.asarray(jkv.cache[name]))


def _prompts(vocab):
    rng = np.random.RandomState(3)
    shared = rng.randint(0, vocab, 16).astype(np.int32)
    return [
        np.concatenate([shared, rng.randint(0, vocab, 3).astype(np.int32)]),
        np.concatenate([shared, rng.randint(0, vocab, 5).astype(np.int32)]),
        rng.randint(0, vocab, 6).astype(np.int32),  # decode crosses the block at 8
        rng.randint(0, vocab, 11).astype(np.int32),
        rng.randint(0, vocab, 3).astype(np.int32),
    ]


@pytest.mark.parametrize("mode,quantized", [("dense", False), ("bika", False),
                                            ("bika", True), ("dense", True)])
def test_paged_engine_tokens_match_reference(mode, quantized):
    jcfg = jax_get_smoke("smollm-360m", compute_mode=mode, remat=False,
                         pack_signs=(mode == "bika"))
    train = unbox(jax_build_model(jcfg, phase="train").init(jax.random.PRNGKey(2)))
    kw = dict(max_len=48, n_slots=3, kv_block_size=8, prefill_chunk=8,
              quantized_kv=quantized)
    prompts = _prompts(jcfg.vocab)
    jeng = JaxServeEngine.from_trained(train, jcfg, engine="paged", **kw)
    teng = ServeEngine.from_trained(from_reference(jax.tree_util.tree_map(np.asarray, train)),
                                    port_cfg(jcfg), engine="paged", device="cpu", **kw)
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=7))
        teng.submit(Request(rid=i, prompt=p, max_new_tokens=7))
    jdone = {r.rid: r.output for r in jeng.run()}
    tdone = {r.rid: r.output for r in teng.run()}
    assert sorted(tdone) == list(range(len(prompts)))
    for i in range(len(prompts)):
        np.testing.assert_array_equal(tdone[i], jdone[i], err_msg=f"request {i}")
    jm, tm = jeng.metrics.summary(), teng.metrics.summary()
    assert tm["prefix_hit_tokens"] == jm["prefix_hit_tokens"] == 16
    for key in ("prefill_chunks", "blocks_in_use_peak", "decode_steps", "completed_tokens"):
        assert tm[key] == jm[key], key
    assert tm["prefill_compiles"] == 0  # eager chunk loop: nothing compiled


def test_entry_points_refuse_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--smoke", "--requests", "1", "--new-tokens", "1"])
    cfg = port_cfg(jax_get_smoke("smollm-360m", remat=False))
    api = build_model(cfg, phase="serve")
    params = api.init(0, device="cpu")
    for build in (
        lambda: api.init(0),
        lambda: api.init_cache(5, 8),
        lambda: PagedKVManager(api, n_slots=2, max_len=32, block_size=8),
        lambda: PagedSlotScheduler(api, params, cfg, n_slots=2, max_len=32, block_size=8),
        lambda: ServeEngine(api, params, cfg, max_len=32, kv_block_size=8),
        lambda: ServeEngine(api, params, cfg, engine="static", max_len=32),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    # the static engine is ported: on the CPU only when asked for
    assert ServeEngine(api, params, cfg, engine="static", device="cpu").engine == "static"


def test_continuous_engine_matches_paged_engine():
    """``engine="auto"`` resolves to the continuous engine, as in the
    reference, and with fp KV it emits the paged engine's tokens (the
    reference's claim for its two engines)."""
    cfg = port_cfg(jax_get_smoke("smollm-360m", remat=False))
    api = build_model(cfg, phase="serve")
    params = api.init(0, device="cpu")
    outs = {}
    for engine in ("auto", "paged"):
        eng = ServeEngine(api, params, cfg, engine=engine, max_len=48, n_slots=3,
                          kv_block_size=8, prefill_chunk=8, device="cpu")
        for i, p in enumerate(_prompts(cfg.vocab)):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=7))
        outs[eng.engine] = {r.rid: r.output.tolist() for r in eng.run()}
    assert sorted(outs) == ["continuous", "paged"]
    assert outs["continuous"] == outs["paged"]


def test_launcher_runs_on_cpu_when_asked(capsys):
    assert launch_serve.main(["--smoke", "--device", "cpu", "--engine", "paged",
                              "--requests", "3", "--new-tokens", "3", "--max-len", "32",
                              "--kv-block-size", "8", "--prefill-chunk", "8"]) == 0
    out = capsys.readouterr().out
    assert "engine=paged" in out and "completed 3 requests" in out


@pytest.mark.parametrize("flags,want", [
    (["--mode", "qnn8"], "engine=continuous"),
    (["--mode", "dense", "--spec-draft", "qnn8", "--spec-k", "4"], "spec: rounds="),
    (["--mode", "dense", "--spec-draft", "qnn8", "--spec-k", "4", "--engine", "paged",
      "--kv-block-size", "8", "--prefill-chunk", "8"], "spec: rounds="),
])
def test_launcher_qnn8_and_spec_on_cpu(capsys, flags, want):
    assert launch_serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                              "--new-tokens", "6", "--max-len", "32"] + flags) == 0
    out = capsys.readouterr().out
    assert want in out and "completed 3 requests" in out
