"""PyTorch port vs the JAX reference: training the recurrent families,
zamba2's hybrid (Mamba2 blocks and one shared attention+MLP block) and
xLSTM (mLSTM and sLSTM blocks), at their SMOKE sizes on the CPU (plain
versions of the kernels).

The same numpy inputs go through both packages; the reference reaches its
Pallas kernels in interpret mode, as its own tests run them. Tolerances, as
``tests/test_torch_train_families.py`` states them:

- losses and metrics within 1e-6 relative;
- every gradient leaf within 1e-4 relative plus 1e-5 of the leaf's
  largest entry; in qnn8 the PACT ceilings' gradients, sums whose terms
  cancel, within 1e-4 of their absolute terms (``_amax_terms``);
- the parameters after AdamW's first step within 1e-5 relative plus 1e-2 *
  lr where |g| >= 100 eps, and within the step's reach, 2 * lr, where |g|
  is near AdamW's eps;
- one block alone (``ssm_apply``, ``mlstm_apply``, ``slstm_apply``):
  outputs within 1e-5 absolute, dx and every leaf's gradient as above.

The scans are host loops over positions in the port and ``lax.scan`` in
the reference, so each position's state update is the same arithmetic in
another order of fusion. bika's CAC outputs, integers, are held to the
reference's where they differ at genuine Sign ties only
(``held_cac_train``): the packages' float parts (the gated RMSNorm, the
stabilised gates) move a pre-activation within ~1e-7 of 0 across it. The
port-side tests hold remat, repeats and restarts bit for bit.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _assert_tree_close, _port_cfg, _t
from test_torch_train_families import _amax_terms, _batch, held_cac_train

import repro.nn.ssm as jssm
import repro.nn.xlstm_blocks as jxl
from repro.configs import get_smoke as jax_get_smoke
from repro.core.backend import LinearSpec as JSpec
from repro.models import build_model as jax_build_model
from repro.nn.module import unbox
from repro.optim.adamw import OptimizerSpec as JaxOptimizerSpec
from repro.optim.adamw import make_optimizer as jax_make_optimizer
from repro.train.loss import softmax_xent as jax_softmax_xent
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.core.backend import LinearSpec
from repro_torch.core.convert import from_reference
from repro_torch.data.lm import LMDataConfig, lm_batch
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.nn import ssm, xlstm_blocks as xl
from repro_torch.optim.adamw import OptimizerSpec, make_optimizer, tree_leaves
from repro_torch.train.steps import loss_and_grads, make_train_step
from repro_torch.train.trainer import TrainConfig, Trainer, run_with_restarts

ARCHS = ("zamba2-2.7b", "xlstm-125m")
MODES = ("dense", "bika", "bnn", "qnn8")
OPT = dict(peak_lr=1e-3, warmup=0, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the tier-1 run
    holds several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_at_smoke(arch, mode, monkeypatch):
    """One whole train step at SMOKE (zamba2: 4 Mamba2 layers in 2 groups,
    so the shared block's gradient sums 2 applications; xlstm: 3 layers,
    sLSTM at 0 and 2; remat on): the reference's train-form params from its
    own init, brought over with ``from_reference``, one batch from its
    pipeline, the reference's loss, gradient and AdamW update in one
    compilation (qnn8 op by op under ``jax.disable_jit``, as smollm's test
    explains) against the port's ``make_train_step``: loss, accuracy,
    tokens, the aux loss, the gradient norm, every gradient leaf and every
    parameter after the update. bika's CAC outputs are held at genuine
    ties (``held_cac_train``)."""
    jcfg = jax_get_smoke(arch, compute_mode=mode)
    japi = jax_build_model(jcfg, phase="train")
    np_params = _np(unbox(japi.init(jax.random.PRNGKey(7))))
    batch = _batch(jcfg)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    tbatch = {k: _t(v) for k, v in batch.items()}
    cfg = _port_cfg(jcfg)
    tp = from_reference(np_params)

    def jloss(p):
        logits, aux = japi.apply_aux(p, jbatch)
        loss, met = jax_softmax_xent(logits, jbatch["labels"], jbatch["mask"], z_loss=1e-4)
        return loss + 0.01 * aux, dict(met, aux_loss=aux)

    with contextlib.ExitStack() as stack:
        held = stack.enter_context(held_cac_train(monkeypatch)) if mode == "bika" else None

        def jstep(p):
            grads, met = jax.grad(jloss, has_aux=True)(p)
            jinit, jupd = jax_make_optimizer(JaxOptimizerSpec(**OPT))
            new, opt, stats = jupd(grads, jinit(p), p)
            return grads, dict(met, **stats), new, opt

        with jax.disable_jit() if mode == "qnn8" else contextlib.nullcontext():
            jgrads, jmet, jp, jopt = (jstep if mode == "qnn8" else jax.jit(jstep))(
                jax.tree_util.tree_map(jnp.asarray, np_params))
        jmet = dict(jmet, skipped=0.0)

        api = build_model(cfg, phase="train")
        met, tgrads = loss_and_grads(api, tp, tbatch)
        sum_bounds = _amax_terms(api, tp, tbatch, monkeypatch) if mode == "qnn8" else None
        _assert_tree_close(tgrads, jgrads, "grad", rtol=1e-4, sum_bounds=sum_bounds)
        tinit, tupd = make_optimizer(OptimizerSpec(**OPT))
        before = ops.launch_counts()
        tp, topt, tmet = make_train_step(api, tupd)(tp, tinit(tp), tbatch)
        assert ops.launch_counts() == before  # CPU: plain versions, no launch
    if held is not None:
        assert held["passes"] == 2, held
        assert held["held"] <= 1e-4 * held["outputs"], held
    for key in ("loss", "accuracy", "tokens", "aux_loss", "grad_norm", "skipped"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-6, atol=1e-7,
                                   err_msg=key)
    np.testing.assert_allclose(float(met["loss"]), float(tmet["loss"]), rtol=0)
    assert float(tmet["aux_loss"]) == 0.0
    lr = OPT["peak_lr"]
    for got, want, grad in zip(tree_leaves(tp), tree_leaves(_np(jp)), tree_leaves(_np(jgrads))):
        steady = (np.abs(grad) >= 100 * 1e-8) | (grad == 0)
        g = got.numpy()
        np.testing.assert_allclose(g[steady], want[steady], rtol=1e-5, atol=1e-2 * lr)
        assert np.all(np.abs(g - want) <= 2 * lr)
    assert topt["step"] == int(jopt["step"]) == 1


def _block_case(block, mode):
    """(reference fn, port fn, numpy params, x) for one block in train form
    at a small width: the SSM at d_model 32 (d_inner 64, 4 heads of 16, d_state
    16), the mLSTM and sLSTM at d_model 32 with 2 heads; x (2, 12, 32)."""
    jspec = JSpec(mode=mode, impl="cvjp")
    tspec = LinearSpec(mode=mode, impl="cvjp")
    key = jax.random.PRNGKey(13)
    if block == "ssm":
        jc = jssm.SSMConfig(d_model=32, d_state=16, head_dim=16)
        tc = ssm.SSMConfig(d_model=32, d_state=16, head_dim=16)
        p = _np(unbox(jssm.ssm_init(key, jc, jspec, phase="train")))
        jfn, tfn = jssm.ssm_apply, ssm.ssm_apply
    else:
        jc, tc = jxl.XLSTMConfig(d_model=32, n_heads=2), xl.XLSTMConfig(d_model=32, n_heads=2)
        jinit = jxl.mlstm_init if block == "mlstm" else jxl.slstm_init
        p = _np(unbox(jinit(key, jc, jspec, phase="train")))
        jfn = jxl.mlstm_apply if block == "mlstm" else jxl.slstm_apply
        tfn = xl.mlstm_apply if block == "mlstm" else xl.slstm_apply
        if block == "slstm":  # recurrent weights large enough that the gates move
            p["r"] = p["r"] * 30.0
    x = np.random.default_rng(17).normal(size=(2, 12, 32)).astype(np.float32)
    return ((lambda pp, xx: jfn(pp, xx, jc, jspec, phase="train")),
            (lambda pp, xx: tfn(pp, xx, tc, tspec, phase="train")), p, x)


@pytest.mark.parametrize("mode", ["dense", "bika"])
@pytest.mark.parametrize("block", ["ssm", "mlstm", "slstm"])
def test_block_gradient_matches_reference(block, mode, monkeypatch):
    """One block alone in train form, under autograd through the port's host
    loop over 12 positions, against ``jax.vjp`` through the reference's
    ``lax.scan``: the output, dx, and every leaf's gradient (the
    projections' w and beta, conv_w, A_log, D, dt_bias, ifg, r, the norm
    scales). bika's CAC outputs are held at genuine ties."""
    jfn, tfn, p, x = _block_case(block, mode)
    gy = np.random.default_rng(19).normal(size=x.shape).astype(np.float32)
    with held_cac_train(monkeypatch) if mode == "bika" else contextlib.nullcontext() as held:
        jy, pull = jax.vjp(jfn, jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
        jgp, jgx = pull(jnp.asarray(gy))
        tp = jax.tree_util.tree_map(lambda a: _t(a).requires_grad_(True), p)
        tx = _t(x).requires_grad_(True)
        ty = tfn(tp, tx)
        ty.backward(_t(gy))
    if held is not None:
        assert held["passes"] == 1 and held["held"] <= 1e-4 * held["outputs"], held
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    _assert_tree_close(tx.grad, jgx, "dx", rtol=1e-4)
    grads = jax.tree_util.tree_map(lambda t: t.grad, tp)
    _assert_tree_close(grads, jgp, "grad", rtol=1e-4)
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_and_repeat_bit_equal(arch):
    """The port alone, SMOKE in bika: the gradient with remat (each block,
    and each application of zamba2's shared block, recomputed in the
    backward) equals the one without, and a second run equals the first,
    bit for bit."""
    cfg = get_smoke(arch, compute_mode="bika")
    params = build_model(cfg, phase="train").init(5, device="cpu")
    batch = lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2, seed=1), 2)
    runs = [loss_and_grads(build_model(cfg.replace(remat=remat), phase="train"), params, batch)
            for remat in (True, False, True)]
    for met, grads in runs[1:]:
        assert float(met["loss"]) == float(runs[0][0]["loss"])
        for a, b in zip(tree_leaves(grads), tree_leaves(runs[0][1])):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_round_trips_the_tree(arch, tmp_path):
    """The train tree and AdamW's state after one step (zamba2's stacked
    ``mamba`` leaves, xLSTM's list of heterogeneous layers) saved and
    restored into a fresh init: every leaf bit for bit, the structure and
    the step kept."""
    cfg = get_smoke(arch, compute_mode="bika")
    trainer = Trainer(TrainConfig(arch=cfg, seq_len=8, global_batch=2, steps=1), device="cpu")
    params, opt, _ = trainer.init()
    params, opt, _ = trainer.train_step(params, opt, 0)
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, {"params": params, "opt": opt})
    fresh, fresh_opt, _ = trainer.init()
    state, manifest = mgr.restore_latest({"params": fresh, "opt": fresh_opt}, device="cpu")
    assert int(manifest["step"]) == 1 and state["opt"]["step"] == 1
    assert isinstance(state["params"]["layers" if arch == "xlstm-125m" else "mamba"],
                      list if arch == "xlstm-125m" else dict)
    got, want = tree_leaves(state), tree_leaves({"params": params, "opt": opt})
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, torch.Tensor):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        else:
            assert a == b
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(fresh), tree_leaves(params)))


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_and_launcher_on_cpu(arch, capsys):
    """The Trainer on the CPU at SMOKE, 2 steps, and the launcher's
    ``--arch`` in bnn; without ``--device cpu`` both raise."""
    cfg = get_smoke(arch, compute_mode="bika")
    trainer = Trainer(TrainConfig(arch=cfg, seq_len=8, global_batch=2, steps=2, log_every=1),
                      device="cpu")
    assert trainer.data_cfg.frames_dim == 0 and set(trainer.batch(0)) == {
        "tokens", "labels", "mask"}
    _, opt, log = trainer.run()
    assert [m["step"] for m in log] == [0, 1] and opt["step"] == 2
    assert all(np.isfinite(m["loss"]) and m["aux_loss"] == 0 for m in log)
    assert launch_train.main(["--smoke", "--device", "cpu", "--arch", arch, "--mode", "bnn",
                              "--steps", "2", "--seq-len", "8", "--batch", "2"]) == 0
    assert f"arch={arch} mode=bnn" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--smoke", "--arch", arch, "--steps", "1", "--seq-len", "8",
                           "--batch", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(TrainConfig(arch=cfg, seq_len=8, global_batch=2, steps=1))


@pytest.mark.parametrize("arch", ARCHS)
def test_restart_is_bitwise_reproducible(arch, tmp_path):
    """run_with_restarts at SMOKE in bika, 3 steps with a checkpoint each,
    a failure at step 1: the parameters and AdamW's m, v and step equal the
    uninterrupted run's bit for bit."""
    cfg = get_smoke(arch, compute_mode="bika")

    def trainer(path, fail_at_step=None):
        tc = TrainConfig(arch=cfg, seq_len=8, global_batch=2, steps=3, ckpt_dir=str(path),
                         ckpt_every=1, keep=2, log_every=1)
        return Trainer(tc, OptimizerSpec(peak_lr=1e-2, warmup=1, total_steps=3), device="cpu",
                       fail_at_step=fail_at_step)

    params, opt, _ = trainer(tmp_path / "full").run()
    made = {"n": 0}

    def make():
        made["n"] += 1
        return trainer(tmp_path / "restart", fail_at_step=1 if made["n"] == 1 else None)

    p, o, log, attempts = run_with_restarts(make)
    assert attempts == 1 and [m["step"] for m in log] == [1, 2]
    for a, b in zip(tree_leaves({"params": p, "opt": o}),
                    tree_leaves({"params": params, "opt": opt})):
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        else:
            assert a == b
    assert o["step"] == 3
