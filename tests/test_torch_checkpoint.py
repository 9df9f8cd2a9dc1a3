"""PyTorch port vs the JAX reference: checkpoints, restart and the
constant learning-rate schedule, on the CPU.

Checkpoints are held bit for bit: a round trip, an async save against a
sync one, a restarted run against an uninterrupted one (parameters and
AdamW's m and v), and a checkpoint written by either package restored in
the other (the same ``arrays.npz`` keys and manifest, hash-verified).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jax_restore
from repro.checkpoint import save as jax_save
from repro.configs import get_smoke as jax_get_smoke
from repro.models import build_model as jax_build_model
from repro.nn.module import unbox
from repro.optim import schedule as jschedule
from repro_torch.checkpoint import CheckpointManager, latest_step, restore, save
from repro_torch.configs import get_smoke
from repro_torch.core.convert import from_reference
from repro_torch.launch import train as launch_train
from repro_torch.optim.adamw import OptimizerSpec, make_optimizer, tree_leaves
from repro_torch.optim.schedule import constant
from repro_torch.train.trainer import SimulatedFailure, TrainConfig, Trainer, run_with_restarts

ARCH = get_smoke("smollm-360m", compute_mode="bika", remat=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the tier-1 run
    holds several test processes at once, and torch's default of a thread
    a core in each of them oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(tmp, **kw):
    base = dict(arch=ARCH, seq_len=8, global_batch=2, steps=4,
                ckpt_dir=os.path.join(str(tmp), "ckpt"), ckpt_every=1, keep=2, log_every=1)
    base.update(kw)
    return TrainConfig(**base)


def _trainer(tmp, fail_at_step=None, **kw):
    cfg = _cfg(tmp, **kw)
    return Trainer(cfg, OptimizerSpec(peak_lr=1e-2, warmup=1, total_steps=cfg.steps),
                   device="cpu", fail_at_step=fail_at_step)


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x.numpy(), y.numpy())
        else:
            assert x == y and type(x) is type(y)


def _small_tree(rng):
    return {"a": torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)),
            "b": {"c": torch.arange(5, dtype=torch.int32), "d": torch.tensor(2.5),
                  "e": [torch.ones(2, dtype=torch.int64), torch.zeros((), dtype=torch.bool)]},
            "step": 7}


@pytest.mark.parametrize("how", ["save", "manager", "manager-async"])
def test_roundtrip_is_bit_exact(tmp_path, how):
    tree = _small_tree(np.random.default_rng(0))
    d = str(tmp_path)
    if how == "save":
        save(d, 5, tree, extra={"note": "x"})
    else:
        mgr = CheckpointManager(d, keep=3)
        mgr.save(5, tree, extra={"note": "x"}, blocking=how == "manager")
        mgr.wait()
    template = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5, dtype=torch.int32),
                                              "d": torch.zeros(()),
                                              "e": [torch.zeros(2, dtype=torch.int64),
                                                    torch.ones((), dtype=torch.bool)]},
                "step": 0}
    out, manifest = restore(d, None, template)
    _assert_trees_equal(out, tree)
    assert manifest["step"] == 5 and manifest["extra"] == {"note": "x"}
    assert manifest["arrays"]["step"] == {"shape": [], "dtype": "int32",
                                          "hash": manifest["arrays"]["step"]["hash"]}
    assert set(manifest["arrays"]) == {"a", "b/c", "b/d", "b/e/0", "b/e/1", "step"}
    assert not [f for f in os.listdir(d) if ".tmp-" in f]  # the atomic rename
    assert latest_step(d) == 5 and latest_step(str(tmp_path / "none")) is None


def test_host_copy_is_taken_before_save_returns(tmp_path):
    """The optimizer updates in place: a buffer changed right after an
    async save must not reach the checkpoint."""
    tree = {"w": torch.ones(1000)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree, blocking=False)
    tree["w"].add_(1.0)  # the next step's in-place update
    mgr.wait()
    out, _ = restore(str(tmp_path), 1, {"w": torch.zeros(1000)})
    assert float(out["w"].max()) == 1.0


@pytest.mark.parametrize("corrupt", ["array", "hash"])
def test_corruption_raises(tmp_path, corrupt):
    tree = _small_tree(np.random.default_rng(1))
    d = str(tmp_path)
    save(d, 3, tree)
    path = os.path.join(d, "step_3")
    if corrupt == "array":
        data = dict(np.load(os.path.join(path, "arrays.npz")))
        data["a"] = data["a"] + 1
        np.savez(os.path.join(path, "arrays.npz"), **data)
    else:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        manifest["arrays"]["b/c"]["hash"] = "0" * 16
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    with pytest.raises(IOError, match="hash mismatch"):
        restore(d, 3, tree)
    restore(d, 3, tree, verify=False)  # without the check it loads


def test_template_mismatch_and_bfloat16_raise(tmp_path):
    d = str(tmp_path)
    save(d, 1, {"w": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(d, 1, {"w": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match="dtype mismatch"):
        restore(d, 1, {"w": torch.zeros(2, 3, dtype=torch.float64)})
    with pytest.raises(ValueError, match="bfloat16"):
        save(d, 2, {"w": torch.zeros(2, dtype=torch.bfloat16)})
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "empty"), None, {"w": torch.zeros(2, 3)})


@pytest.mark.parametrize("keep", [1, 2])
def test_keep_last_k(tmp_path, keep):
    mgr = CheckpointManager(str(tmp_path), keep=keep)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.full((2,), float(s))}, blocking=s % 2 == 0)
    mgr.wait()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(str(tmp_path))
                   if n.startswith("step_"))
    assert steps == [3, 4][-keep:]


def test_async_writer_error_surfaces_at_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(str(blocker / "sub"))
    mgr.save(1, {"x": torch.zeros(2)}, blocking=False)  # the thread fails
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # the error is raised once


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """A 4-step run without failure, checkpointing every step."""
    tmp = tmp_path_factory.mktemp("full")
    params, opt, log = _trainer(tmp).run()
    return tmp, params, opt, log


def test_async_checkpoint_equals_sync(tmp_path, uninterrupted):
    tmp, params, opt, _ = uninterrupted
    pa, oa, _ = _trainer(tmp_path, async_ckpt=True).run()
    _assert_trees_equal(pa, params)
    _assert_trees_equal(oa, opt)
    for step in (3, 4):  # keep=2
        want = np.load(os.path.join(str(tmp), "ckpt", f"step_{step}", "arrays.npz"))
        got = np.load(os.path.join(str(tmp_path), "ckpt", f"step_{step}", "arrays.npz"))
        assert sorted(want.files) == sorted(got.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k])
    assert latest_step(os.path.join(str(tmp_path), "ckpt")) == 4


@pytest.mark.parametrize("fail_at", [1, 3])
def test_restart_is_bitwise_reproducible(tmp_path, uninterrupted, fail_at):
    _, params, opt, _ = uninterrupted
    made = {"n": 0}

    def make():
        made["n"] += 1
        return _trainer(tmp_path, fail_at_step=fail_at if made["n"] == 1 else None)

    p, o, log, attempts = run_with_restarts(make)
    assert attempts == 1 and made["n"] == 2
    assert [m["step"] for m in log] == list(range(fail_at, 4))  # resumed at the failure
    _assert_trees_equal(p, params)  # every parameter
    _assert_trees_equal(o, opt)  # m, v and the step
    assert o["step"] == 4


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    made = {"n": 0}

    def make():
        made["n"] += 1
        return _trainer(tmp_path, fail_at_step=0)

    with pytest.raises(SimulatedFailure):
        run_with_restarts(make, max_restarts=2)
    assert made["n"] == 3


def test_init_or_restore_resumes_and_launcher_ckpt(tmp_path, uninterrupted, capsys):
    tmp, params, opt, _ = uninterrupted
    t = _trainer(tmp)  # its directory holds steps 3 and 4
    p, o, start = t.init_or_restore()
    assert start == 4 and o["step"] == 4 and isinstance(o["step"], int)
    _assert_trees_equal(p, params)
    assert _trainer(tmp_path, ckpt_dir=None).init_or_restore()[2] == 0
    ck = str(tmp_path / "ck")
    args = ["--smoke", "--device", "cpu", "--seq-len", "8", "--batch", "2", "--ckpt", ck]
    assert launch_train.main(args + ["--steps", "2"]) == 0
    assert f"checkpoint step 2 -> {ck}" in capsys.readouterr().out
    assert launch_train.main(args + ["--steps", "3"]) == 0  # resumes at step 2
    out = capsys.readouterr().out
    assert "step      2" in out and "step      1" not in out
    assert f"checkpoint step 3 -> {ck}" in out


@pytest.fixture(scope="module")
def reference_state():
    """The reference's smoke bika params and an AdamW state with nonzero
    moments and step 3, as numpy trees."""
    cfg = jax_get_smoke("smollm-360m", compute_mode="bika")
    params = jax.tree_util.tree_map(
        np.asarray, unbox(jax_build_model(cfg, phase="train").init(jax.random.PRNGKey(3))))
    rng = np.random.default_rng(4)

    def noise(tree):
        return jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(a.dtype), tree)

    opt = {"m": noise(params), "v": jax.tree_util.tree_map(np.abs, noise(params)),
           "step": np.asarray(3, np.int32)}
    return {"params": params, "opt": opt}


def _port_template():
    cfg = get_smoke("smollm-360m", compute_mode="bika")
    from repro_torch.models import build_model

    params = build_model(cfg, phase="train").init(0, device="cpu")
    init, _ = make_optimizer(OptimizerSpec())
    return {"params": params, "opt": init(params)}


def test_reference_checkpoint_restores_in_the_port(tmp_path, reference_state):
    d = str(tmp_path)
    jax_save(d, 3, jax.tree_util.tree_map(jnp.asarray, reference_state))
    out, manifest = restore(d, None, _port_template())
    want = from_reference({"params": reference_state["params"],
                           "opt": {"m": reference_state["opt"]["m"],
                                   "v": reference_state["opt"]["v"]}})
    _assert_trees_equal(out["params"], want["params"])
    _assert_trees_equal({"m": out["opt"]["m"], "v": out["opt"]["v"]}, want["opt"])
    assert out["opt"]["step"] == 3 and isinstance(out["opt"]["step"], int)
    assert manifest["step"] == 3
    # the port writes the same keys, shapes, dtypes and hashes
    port_dir = str(tmp_path / "port")
    save(port_dir, 3, out)
    with open(os.path.join(port_dir, "step_3", "manifest.json")) as f:
        assert json.load(f) == manifest


def test_port_checkpoint_restores_in_the_reference(tmp_path, reference_state):
    d = str(tmp_path)
    tree = from_reference(reference_state["params"])
    rng = np.random.default_rng(5)
    init, _ = make_optimizer(OptimizerSpec())
    opt = init(tree)
    for leaf in tree_leaves(opt["m"]) + tree_leaves(opt["v"]):
        leaf.copy_(torch.from_numpy(rng.normal(size=tuple(leaf.shape)).astype(np.float32)))
    opt["step"] = 5
    mgr = CheckpointManager(d, keep=1)
    mgr.save(5, {"params": tree, "opt": opt}, blocking=False)
    template = jax.tree_util.tree_map(jnp.zeros_like, jax.tree_util.tree_map(
        jnp.asarray, reference_state))
    mgr.wait()
    out, manifest = jax_restore(d, None, template)  # hash-verified by the reference
    assert manifest["step"] == 5 and int(out["opt"]["step"]) == 5
    assert out["opt"]["step"].dtype == jnp.int32
    for got, want in zip(jax.tree_util.tree_leaves(out["params"]), tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())
    for key in ("m", "v"):
        for got, want in zip(jax.tree_util.tree_leaves(out["opt"][key]), tree_leaves(opt[key])):
            np.testing.assert_array_equal(np.asarray(got), want.numpy())


@pytest.mark.parametrize("lr", [3e-4, 0.1, 1.0])
def test_constant_schedule_matches_reference(lr):
    fn, jfn = constant(lr), jschedule.constant(lr)
    for step in (0, 1, 7, 10_000):
        assert fn(step) == float(jfn(step))
        assert isinstance(fn(step), float)
