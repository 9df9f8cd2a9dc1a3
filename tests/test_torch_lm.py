"""PyTorch port vs the JAX reference: smoke-config paged LM logits
(``prefill_chunk`` then ``decode_paged``) for dense and bika, fused and
gather routes, fp32 and int8 pools, on the CPU (plain versions).

Tolerance: 1e-4 absolute on logits of magnitude ~1, with greedy tokens
equal and the live pool blocks equal (int8 codes exactly). The two
packages compute the float parts (RMSNorm, RoPE, SiLU, softmax, fp32
products) with other kernels and summation orders, which leaves a few
float32 ulps. Two roundings can turn those ulps into a whole code: a bika
projection rounds its input onto the 0.05 activation grid, and an int8
pool rounds K/V onto its per-vector scale. An input within the ulps of a
half-way point may take either code, and one flipped code moves the logits
by far more than the ulps. At this seed the bika + int8 pool case has one
such K/V tie (8 codes of one chunk, 4e-6 code units from half-way, since
RoPE's cos/sin are other kernels in the two packages). So the codes are
held equal at genuine ties (``held_codes``): the reference records every
code it makes, the port compares its own, takes the reference's only where
the two differ by one within 1e-3 code units of the half-way point, and
fails on any other difference."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.backend as jax_backend
import repro.nn.attention as jax_attention
import repro_torch.core.backend as port_backend
import repro_torch.nn.attention as port_attention
from repro.configs import get_smoke as jax_get_smoke
from repro.core.convert import tree_to_serve as jax_tree_to_serve
from repro.models import build_model as jax_build_model
from repro.nn.module import unbox
from repro_torch.core.convert import from_reference
from repro_torch.models import build_model
from repro_torch.models.base import ArchConfig

ATOL = 1e-4
TIE = 1e-3  # code units from a half-way point where the two codes may differ


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


def serve_trees(mode: str, route: str, seed: int = 3):
    """(jax cfg, jax serve params, port serve params) from one JAX init."""
    jcfg = jax_get_smoke("smollm-360m", compute_mode=mode, remat=False,
                         pack_signs=(mode == "bika"), paged_attn_route=route)
    train = unbox(jax_build_model(jcfg, phase="train").init(jax.random.PRNGKey(seed)))
    jparams = jax_tree_to_serve(train, jcfg.linear_spec())
    tparams = from_reference(jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, jparams, tparams


def _close(got: torch.Tensor, want, what: str) -> None:
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=what)
    np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1), err_msg=what)


def _hold(ref: np.ndarray, codes: torch.Tensor, u: torch.Tensor, what: str) -> torch.Tensor:
    """The port's ``codes`` (rounded from ``u``, in code units) with the
    reference's where the two differ at a genuine tie; any other difference
    fails."""
    assert ref.size == codes.numel(), (what, ref.shape, tuple(codes.shape))
    ref = torch.from_numpy(ref.copy()).reshape(codes.shape)  # the port may drop unit axes
    diff = codes != ref
    if not bool(diff.any()):
        return codes
    half = (codes[diff].double() + ref[diff].double()) / 2
    step = int((codes[diff].int() - ref[diff].int()).abs().max())
    dist = float((u[diff].double() - half).abs().max())
    assert step == 1 and dist <= TIE, (
        f"{int(diff.sum())} {what} codes differ by up to {step}, {dist:.3e} code units "
        f"from a half-way point (a tie is within {TIE})")
    return torch.where(diff, ref, codes)


@contextlib.contextmanager
def held_codes(mode: str = "bika"):
    """Hold the port's codes to the reference's at half-way ties: the
    activation codes of a ``mode`` projection (bika or qnn8, which quantize
    their input alike) and the int8 K/V pool codes. The reference sends each
    code tensor it makes to the host (in call order, through the layer
    scan); the port takes them in the same order. Yields ``taken(n_act,
    n_kv)``, which checks after a step that the port took exactly the
    reference's code tensors."""
    jbe = jax_backend.get_backend(mode)
    plain_act, plain_kv = port_backend.quantize_activations, port_attention._quantize_kv
    jax_kv = jax_attention._quantize_kv
    queues, counts = {"act": [], "kv": []}, {"act": 0, "kv": 0}

    def send(kind, codes):
        jax.debug.callback(lambda c: queues[kind].append(np.asarray(c)), codes, ordered=True)

    def take(kind):
        if not queues[kind]:
            jax.effects_barrier()
        counts[kind] += 1
        return queues[kind].pop(0)

    def j_apply_serve(params, x, spec, *, blocks=None):
        send("act", jnp.clip(jnp.round(x / spec.act_scale), -128, 127).astype(jnp.int8))
        return type(jbe).apply_serve(jbe, params, x, spec, blocks=blocks)

    def j_quantize_kv(x):
        q, scale = jax_kv(x)
        send("kv", q)
        return q, scale

    def t_quantize_activations(x, act_scale):
        u = x / torch.tensor(act_scale, dtype=x.dtype)
        return _hold(take("act"), plain_act(x, act_scale), u, "activation")

    def t_quantize_kv(x):
        q, scale = plain_kv(x)
        return _hold(take("kv"), q, x.float() / scale, "K/V"), scale

    def taken(n_act: int, n_kv: int) -> None:
        jax.effects_barrier()
        got = (len(queues["act"]), len(queues["kv"]), counts["act"], counts["kv"])
        assert got == (0, 0, n_act, n_kv), got
        counts.update(act=0, kv=0)

    jbe.apply_serve = j_apply_serve
    jax_attention._quantize_kv = j_quantize_kv
    port_backend.quantize_activations = t_quantize_activations
    port_attention._quantize_kv = t_quantize_kv
    try:
        yield taken
    finally:
        del jbe.apply_serve  # back to the class's method
        jax_attention._quantize_kv = jax_kv
        port_backend.quantize_activations = plain_act
        port_attention._quantize_kv = plain_kv


@pytest.mark.parametrize("mode,route,quantized", [
    ("dense", "fused", False),
    ("bika", "fused", False),
    ("bika", "gather", False),
    ("bika", "fused", True),
    ("dense", "gather", True),
])
def test_paged_prefill_and_decode_logits(mode, route, quantized):
    jcfg, jparams, tparams = serve_trees(mode, route)
    japi = jax_build_model(jcfg, phase="serve")
    tapi = build_model(port_cfg(jcfg), phase="serve")
    n_act = 7 * jcfg.n_layers if mode == "bika" else 0  # q/k/v/o/gate/up/down
    n_kv = 2 * jcfg.n_layers if quantized else 0
    bs, chunk, n_phys = 8, 8, 9  # 8 blocks + the parking block
    jpool = japi.init_cache(n_phys, bs, quantized=quantized)
    tpool = tapi.init_cache(n_phys, bs, quantized=quantized, device="cpu")
    rng = np.random.RandomState(5)
    prompt = rng.randint(0, jcfg.vocab, 13).astype(np.int32)
    table = np.array([[5, 2, 7, 0]], np.int32)  # shuffled, 4 blocks = max_len 32
    with held_codes() as taken:
        for start in (0, chunk):
            toks = np.zeros((1, chunk), np.int32)
            seg = prompt[start:start + chunk]
            toks[0, :len(seg)] = seg
            last = np.array([len(seg) - 1], np.int32)
            jl, jpool = japi.prefill_chunk(jparams, jnp.asarray(toks), jpool,
                                           jnp.asarray(table), jnp.asarray([start], jnp.int32),
                                           jnp.asarray(last))
            tl, tpool = tapi.prefill_chunk(tparams, torch.from_numpy(toks), tpool,
                                           torch.from_numpy(table),
                                           torch.tensor([start], dtype=torch.int32),
                                           torch.from_numpy(last))
            taken(n_act, n_kv)
            _close(tl, jl, f"prefill chunk at {start}")
        # decode: row 0 continues the prompt across the block boundary at
        # 16, row 1 is parked (whole table on the parking block, position 0)
        tables = np.array([[5, 2, 7, 0], [8, 8, 8, 8]], np.int32)
        tok = np.array([[int(np.asarray(jl).argmax())], [0]], np.int32)  # the reference's
        pos = np.array([13, 0], np.int32)
        for _ in range(4):
            jl, jpool = japi.decode_paged(jparams, jnp.asarray(tok), jpool, jnp.asarray(pos),
                                          jnp.asarray(tables))
            tl, tpool = tapi.decode_paged(tparams, torch.from_numpy(tok), tpool,
                                          torch.from_numpy(pos), torch.from_numpy(tables))
            taken(n_act, n_kv)
            _close(tl[:1], jl[:1], f"decode at {pos[0]}")
            tok = np.array([[int(np.asarray(jl)[0, -1].argmax())], [0]], np.int32)
            pos = pos + np.array([1, 0], np.int32)
    # the live blocks of the pool agree too (row 0's positions < 17)
    for name in jpool:
        g = tpool[name][:, [5, 2, 7]].numpy().reshape(jcfg.n_layers, 24, -1)[:, :17]
        w = np.asarray(jpool[name])[:, [5, 2, 7]].reshape(jcfg.n_layers, 24, -1)[:, :17]
        if g.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=name)  # held at ties: exact codes
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)
