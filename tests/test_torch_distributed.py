"""PyTorch port vs the JAX reference: the sharding rules, spec level (no
devices, no process group).

- the reference's own spec cases (``tests/test_distributed.py``,
  ``tests/test_serving_sharded.py``) through both ``logical_to_spec``;
- every lm-family config's SMOKE tree, in the four modes and both phases,
  leaf by leaf on abstract meshes (1, 2), (2, 4) and (16, 16): the
  reference's ``param_shardings`` over ``jax.eval_shape(api.init)`` against
  the port's ``ModelAPI.param_axes`` through ``param_specs``, and the leaf
  shapes of the two trees;
- ``zero1_shardings`` with ``LOGICAL_RULES`` and ``FSDP_RULES`` over the
  same trees; ``kv_cache_shardings`` and ``batch_sharding``;
- the tensor-parallel placement's rules (``distributed.tp.placement``) at
  nemotron-4-15b and smollm-360m's published shapes.

The port's spec is a tuple, one entry per dim, as ``tuple(PartitionSpec)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding

from repro.configs import get_smoke as jax_get_smoke
from repro.distributed import sharding as jsh
from repro.distributed.meshes import abstract_mesh as jax_abstract_mesh
from repro.models import build_model as jax_build_model
from repro.models.base import KV_CACHE_LOGICAL_AXES as JAX_KV_AXES
from repro.nn.module import P
from repro_torch.configs import REGISTRY, get_config, get_smoke
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.constraints import ACT_RULES, activation_rules
from repro_torch.distributed.meshes import abstract_mesh
from repro_torch.distributed.tp import placement
from repro_torch.launch.mesh import mesh_devices_needed, production_mesh_shape
from repro_torch.models import build_model

LM_CONFIGS = [name for name, mod in REGISTRY.items() if mod.SMOKE.family == "lm"]
MESHES = [(1, 2), (2, 4), (16, 16)]
AXES = ("data", "model")
MODES = ("dense", "bika", "bnn", "qnn8")


def _meshes(shape, axes=AXES):
    return jax_abstract_mesh(shape, axes), abstract_mesh(shape, axes)


def _jspec(spec):
    return tuple(spec)


@pytest.mark.parametrize("case", [
    ("basic", (16, 16), AXES, "LOGICAL", ("embed", "ffn"), (960, 2560)),
    ("basic vocab", (16, 16), AXES, "LOGICAL", ("vocab", "embed"), (49152, 960)),
    ("15 heads fall back", (16, 16), AXES, "LOGICAL", ("heads",), (15,)),
    ("flattened heads split", (16, 16), AXES, "LOGICAL", ("heads",), (960,)),
    ("absent data axis", (4,), ("model",), "FSDP", ("embed", "ffn"), (64, 64)),
    ("kv heads split", (4, 2), AXES, "LOGICAL", JAX_KV_AXES, (2, 4, 64, 4, 32)),
    ("kv scale leaf", (4, 2), AXES, "LOGICAL", JAX_KV_AXES, (2, 4, 64, 4, 1)),
    ("1 kv head replicated", (4, 2), AXES, "LOGICAL", JAX_KV_AXES, (2, 4, 64, 1, 32)),
    ("fsdp embed", (2, 4), AXES, "FSDP", ("embed", "ffn"), (64, 32)),
    ("no shape", (2, 4), AXES, "LOGICAL", ("ffn", "embed"), None),
    ("none axes", (2, 4), AXES, "LOGICAL", None, (3, 4)),
], ids=lambda c: c[0])
def test_logical_to_spec_cases(case):
    _, shape, axes, rules, logical, leaf = case
    jm, tm = _meshes(shape, axes)
    jr = jsh.ShardingRules(jsh.LOGICAL_RULES if rules == "LOGICAL" else jsh.FSDP_RULES)
    tr = tsh.ShardingRules(tsh.LOGICAL_RULES if rules == "LOGICAL" else tsh.FSDP_RULES)
    want = _jspec(jsh.logical_to_spec(logical, jm, jr, leaf))
    assert tsh.logical_to_spec(logical, tm, tr, leaf) == want


def test_rule_tables_and_helpers_match():
    assert tsh.LOGICAL_RULES == jsh.LOGICAL_RULES
    assert tsh.FSDP_RULES == jsh.FSDP_RULES
    assert tsh.KV_CACHE_LOGICAL_AXES == JAX_KV_AXES
    from repro.distributed.constraints import ACT_RULES as JAX_ACT_RULES

    assert ACT_RULES == JAX_ACT_RULES
    jm, tm = _meshes((2, 4))
    assert activation_rules("heads", tm) == ("model",)
    assert activation_rules("batch", tm) == ("data",)
    assert activation_rules("embed", tm) == ()
    rules = [("a", ("model",)), ("b", ("model",))]
    # a mesh axis is used once: the second dim's is dropped
    assert tsh.logical_to_spec(("a", "b"), tm, tsh.ShardingRules(tuple(rules)), (8, 8)) == \
        _jspec(jsh.logical_to_spec(("a", "b"), jm, jsh.ShardingRules(tuple(rules)), (8, 8))) \
        == ("model",)
    over = tsh.ShardingRules().with_overrides(("ffn", ()))
    assert over.lookup("ffn") == () and over.lookup("heads") == ("model",)
    assert tsh.mesh_axis_size(tm, ("data", "model")) == jsh.mesh_axis_size(jm, ("data", "model"))
    for ndim, dim in ((2, 0), (3, 1)):
        want = _jspec(jsh.batch_sharding(jm, ndim, dim).spec)
        assert tsh.batch_sharding(tm, ndim, dim) == want
    for shape in ((1, 2), (16, 16), (2, 16, 16)):
        axes = AXES if len(shape) == 2 else ("pod",) + AXES
        jm, tm = _meshes(shape, axes)
        assert tsh.batch_sharding(tm) == _jspec(jsh.batch_sharding(jm).spec)


def test_kv_cache_shardings_match():
    for mesh_shape in MESHES:
        jm, tm = _meshes(mesh_shape)
        for heads in (1, 2, 4, 5, 16):
            cache = {"k": np.zeros((2, 3, 8, heads, 4), np.int8),
                     "k_scale": np.zeros((2, 3, 8, heads, 1), np.float32)}
            want = jsh.kv_cache_shardings(jm, {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                                               for k, v in cache.items()})
            got = tsh.kv_cache_shardings(tm, cache)
            assert got == {k: _jspec(v.spec) for k, v in want.items()}


def _flat_ref(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (NamedSharding, P)))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in leaves}


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else str(k)))
        return out
    return {path: tree}


def _trees(name, mode, phase):
    kw = dict(compute_mode=mode, remat=False)
    jcfg = jax_get_smoke(name, **kw)
    boxed = jax.eval_shape(jax_build_model(jcfg, phase=phase).init, jax.random.PRNGKey(0))
    api = build_model(get_smoke(name, **kw), phase=phase)
    params = api.init(0, device="cpu")
    return boxed, params, api.param_axes(params)


@pytest.mark.parametrize("phase", ["train", "serve"])
@pytest.mark.parametrize("name", LM_CONFIGS)
def test_param_specs_match_reference_leaf_by_leaf(name, phase):
    """Every leaf's shape and, on each mesh, its spec equal the
    reference's, in every mode."""
    for mode in MODES:
        boxed, params, axes = _trees(name, mode, phase)
        ref_leaves = _flat_ref(boxed)
        port_leaves = _flat(params)
        assert sorted(port_leaves) == sorted(ref_leaves), (mode, phase)
        for path, leaf in port_leaves.items():
            assert tuple(leaf.shape) == tuple(ref_leaves[path].value.shape), (mode, path)
        assert _flat(axes).keys() == port_leaves.keys()
        for mesh_shape in MESHES:
            jm, tm = _meshes(mesh_shape)
            want = {k: _jspec(v.spec)
                    for k, v in _flat_ref(jsh.param_shardings(jm, boxed)).items()}
            got = _flat(tsh.param_specs(tm, params, axes))
            assert got == want, (mode, mesh_shape)


@pytest.mark.parametrize("rules", ["LOGICAL", "FSDP"])
@pytest.mark.parametrize("name", ["smollm-360m", "nemotron-4-15b", "mixtral-8x22b", "qwen1.5-32b"])
def test_zero1_shardings_match_reference(name, rules):
    for mode in ("bika", "qnn8"):
        boxed, params, axes = _trees(name, mode, "train")
        jr = jsh.ShardingRules(jsh.LOGICAL_RULES if rules == "LOGICAL" else jsh.FSDP_RULES)
        tr = tsh.ShardingRules(tsh.LOGICAL_RULES if rules == "LOGICAL" else tsh.FSDP_RULES)
        for mesh_shape in MESHES:
            jm, tm = _meshes(mesh_shape)
            want = {k: _jspec(v.spec)
                    for k, v in _flat_ref(jsh.zero1_shardings(jm, boxed, jr)).items()}
            assert _flat(tsh.zero1_shardings(tm, params, axes, tr)) == want, (mode, mesh_shape)


def test_zero1_adds_data_axis_once():
    """The reference's own case: a (64, 32) ("embed", "ffn") leaf."""
    jm, tm = _meshes((2, 4))
    boxed = {"w": P(jax.ShapeDtypeStruct((64, 32), jnp.float32), ("embed", "ffn"))}
    params = {"w": np.zeros((64, 32), np.float32)}
    axes = {"w": ("embed", "ffn")}
    for jr, tr in ((jsh.LOGICAL_RULES, tsh.LOGICAL_RULES), (jsh.FSDP_RULES, tsh.FSDP_RULES)):
        want = _jspec(jsh.zero1_shardings(jm, boxed, jsh.ShardingRules(jr))["w"].spec)
        assert want == ("data", "model")
        assert tsh.zero1_shardings(tm, params, axes, tsh.ShardingRules(tr))["w"] == want


class _Group:
    """The fields of a TPGroup that the placement reads."""

    def __init__(self, size, rules=None):
        self.mesh = abstract_mesh((1, size), AXES)
        self.rules = rules or tsh.ShardingRules()
        self.size = size


@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16])
def test_placement_at_published_shapes(tp):
    """nemotron-4-15b (48 heads, 8 kv heads, d_ff 24576) splits everywhere
    up to tp = 8 and keeps its attention whole at 16; smollm-360m's 5 kv
    heads keep its attention whole at every tp > 1 (q/k/v replicated, the
    pool's heads replicated, as ``kv_cache_shardings`` falls back)."""
    nem = placement(get_config("nemotron-4-15b"), _Group(tp))
    assert nem.heads == (tp <= 8) and nem.kv_heads == (8 // tp if tp <= 8 else 8)
    assert nem.ffn and nem.wo and nem.down and nem.vocab
    sm = placement(get_config("smollm-360m"), _Group(tp))
    assert sm.heads == (tp == 1) and sm.kv_heads == 5
    assert sm.ffn == (2560 % tp == 0) and sm.wo == sm.down == (960 % tp == 0) and sm.vocab
    # rules that keep the ffn whole keep gate/up and down whole, wo split
    rules = tsh.ShardingRules().with_overrides(("ffn", ()))
    pl = placement(get_config("nemotron-4-15b"), _Group(tp, rules))
    assert not pl.ffn and not pl.down and pl.wo


def test_production_mesh_shape():
    assert production_mesh_shape() == ((16, 8), ("data", "model"))
    assert production_mesh_shape(multi_pod=True) == ((2, 16, 8), ("pod", "data", "model"))
    assert mesh_devices_needed() == 128 and mesh_devices_needed(True) == 256


# nemotron-4-15b's projections, (K, N) unsharded; a tp = 2 rank runs N / 2
TP2_KN = [(6144, 6144), (6144, 1024), (6144, 24576), (24576, 6144)]


@pytest.mark.parametrize("path", ["hw_fwd", "bnn_packed", "qnn8", "paged_attn"])
def test_plans_at_tp_rank_shapes_are_legal(path):
    """The geometry takes the shapes a tp = 2 rank runs: the default plan
    of kernels 1, 7 and 10 at each rank's (M = 4, K, N / 2) passes the
    autotuner's ``plan_error`` and the kernel contracts; so does kernel
    11's plan of the unsharded call (Hq 48, Hkv 8, D 128) at a rank's heads
    (24, 4), which ``ops.paged_attention(heads=)`` launches."""
    from repro_torch.analysis import kernel_contracts as kc
    from repro_torch.kernels import autotune

    if path == "paged_attn":
        for b, c, t in ((4, 1, 8), (1, 32, 8), (4, 4, 8), (4, 1, 64)):
            plan = autotune.get_paged_plan(b, c, 48, 8, 128, 16, t)
            shape = (b, c, 24, 4, 128, 16, t)
            assert autotune.plan_error(path, shape, plan) is None, (shape, plan)
            assert kc.check_plan(path, shape, plan)[0] == [], (shape, plan)
        return
    for k, n in TP2_KN:
        for m in (4, 32):
            shape = (m, k, n // 2)
            plan = autotune.heuristic_plan(path, *shape)
            assert autotune.plan_error(path, shape, plan) is None, (shape, plan)
            assert kc.check_plan(path, shape, plan)[0] == [], (shape, plan)
