"""PyTorch port vs the JAX reference: training the mixture of experts
(mixtral-8x22b) and the encoder-decoder family (seamless-m4t-large-v2) at
their SMOKE sizes on the CPU (plain versions of the kernels).

The same numpy inputs go through both packages; the reference reaches its
Pallas kernels in interpret mode, as its own tests run them. Tolerances, as
``tests/test_torch_train.py`` states them for smollm's step:

- losses and metrics within 1e-6 relative;
- every gradient leaf within 1e-4 relative plus 1e-5 of the leaf's
  largest entry; sums whose terms cancel within 1e-4 of their absolute
  terms instead: in qnn8 the PACT ceilings' gradients (``_amax_terms``),
  in bika the encoder-decoder's cross-attention key bias (``_beta_terms``);
- the parameters after AdamW's first step within 1e-5 relative plus 1e-2 *
  lr where |g| >= 100 eps, and within the step's reach, 2 * lr, where |g|
  is near AdamW's eps;
- ``moe_apply`` alone (one layer, no stack): outputs within 1e-5 absolute,
  the aux loss within 1e-6, gradients as above.

The routing is compared as integers: the tests check that no token's two
chosen gates lie within 1e-6 of the next gate (a near tie an ulp of
softmax could order either way), so the port takes the reference's slots.
bika's CAC outputs, integers, are held to the reference's where they
differ at genuine Sign ties only (``held_cac_train``): the packages' float
parts (LayerNorm, softmax, the cross attention) move a pre-activation
within ~1e-7 of 0 across it. The port-side tests hold restarts, remat and
the batch's frames bit for bit.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _assert_tree_close, _leaves_of, _port_cfg, _t

import repro.nn.moe as jax_moe
from repro.configs import get_smoke as jax_get_smoke
from repro.core.backend import LinearSpec as JSpec
from repro.data.lm import LMDataConfig as JaxLMDataConfig
from repro.data.lm import lm_batch as jax_lm_batch
from repro.core import bika as jbika
from repro.models import build_model as jax_build_model
from repro.nn.module import unbox
from repro.optim.adamw import OptimizerSpec as JaxOptimizerSpec
from repro.optim.adamw import make_optimizer as jax_make_optimizer
from repro.train import steps as jsteps
from repro.train.loss import softmax_xent as jax_softmax_xent
import repro_torch.nn.moe as port_moe
from repro_torch.configs import get_smoke
from repro_torch.core import qnn as tqnn
from repro_torch.core.backend import LinearSpec
from repro_torch.core.convert import from_reference
from repro_torch.data.lm import LMDataConfig, lm_batch
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.optim.adamw import OptimizerSpec, make_optimizer, tree_leaves
from repro_torch.train.loss import softmax_xent
from repro_torch.train.steps import loss_and_grads, make_train_step
from repro_torch.train.trainer import TrainConfig, Trainer, run_with_restarts

ARCHS = ("mixtral-8x22b", "seamless-m4t-large-v2")
MODES = ("dense", "bika", "bnn", "qnn8")
ROUTE_TIE = 1e-6  # gates this close may be ordered either way by an ulp of softmax
SIGN_TIE = 1e-6  # |pre| this close to 0: a Sign the two packages' float parts may split
OPT = dict(peak_lr=1e-3, warmup=0, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the tier-1 run
    holds several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(jcfg, seq_len=16, global_batch=2, seed=3):
    """One reference batch as numpy: tokens, labels, mask, and for the
    encoder-decoder its (B, S, d_model) frames."""
    frames = jcfg.d_model if jcfg.family == "encdec" else 0
    return jax.tree_util.tree_map(np.asarray, jax_lm_batch(JaxLMDataConfig(
        vocab=jcfg.vocab, seq_len=seq_len, global_batch=global_batch, seed=seed,
        frames_dim=frames), 0))


def _tracked(params):
    """(params with fresh leaves that require grad, {id(leaf): path})."""
    paths = {}

    def track(node, path):
        if isinstance(node, dict):
            return {k: track(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, list):  # xLSTM's list of layers
            return [track(v, f"{path}/{i}") for i, v in enumerate(node)]
        leaf = node.detach().requires_grad_(True)
        paths[id(leaf)] = path
        return leaf

    return track(params, "grad"), paths


def _root(t):
    """The leaf a view was taken of (``t`` itself when it is none's view)."""
    return t if t._base is None else t._base


def _backward(api, tracked, paths, batch):
    """The port's weighted loss backward; {path: gradient} of every leaf."""
    logits, aux = api.apply_aux(tracked, batch)
    loss, _ = softmax_xent(logits, batch["labels"], batch.get("mask"), z_loss=1e-4)
    (loss + 0.01 * aux).backward()
    return {paths[id(leaf)]: leaf.grad.numpy() for leaf in _leaves_of(tracked)}


def _beta_terms(api, params, batch, monkeypatch, names):
    """bika: {path: float64 array shaped like the leaf} for the dbeta
    leaves in ``names``: each element's sum of the absolute terms its
    gradient adds up, sum_m |g_mn| 1[|x_mk w_kn + beta_kn| <= 1], g the
    gradient reaching the CAC output (the STE backward's dbeta). The cross
    attention's key bias is such a sum whose terms cancel: softmax's
    scores shift with a key bias alike for every key a query sees, so
    sum_j dL/dk_j = 0 and only the STE mask's few zeros leave a remainder,
    ~1e-8 of the terms at SMOKE, below float32's rounding of them. Such a
    sum is held to rtol of its absolute terms, the bound of any float sum,
    as ``test_torch_train._amax_grad_terms`` holds qnn8's PACT ceilings. The
    terms come from the port's own forward and their sum is checked against
    the port's own gradient first."""
    tracked, paths = _tracked(params)
    recs = []
    real = ops.cac_train_matmul

    def spy(x, w, beta, **kw):
        y = real(x, w, beta, **kw)
        root = _root(beta)
        if y.requires_grad and paths.get(id(root)) in names:
            key = (paths[id(root)], beta.storage_offset())
            xs = x.detach().double().reshape(-1, x.shape[-1])
            ws, bs = w.detach().double(), beta.detach().double()
            y.register_hook(lambda g: recs.append((key, xs, ws, bs, g.detach().double())))
        return y

    monkeypatch.setattr(ops, "cac_train_matmul", spy)
    grads = _backward(api, tracked, paths, batch)
    monkeypatch.setattr(ops, "cac_train_matmul", real)
    sums, abs_sums = {}, {}
    for (path, at), x, w, b, g in recs:
        mask = ((x[:, :, None] * w[None] + b[None]).abs() <= 1.0).double()
        g2 = g.reshape(-1, w.shape[1])[:, None, :]
        span = slice(at, at + w.numel())
        sums.setdefault(path, np.zeros(grads[path].size))[span] += (g2 * mask).sum(0).reshape(-1).numpy()
        abs_sums.setdefault(path, np.zeros(grads[path].size))[span] += (
            g2.abs() * mask).sum(0).reshape(-1).numpy()
    assert set(abs_sums) == set(names)
    for path, total in sums.items():  # the terms are the port's own gradient
        bound = 1e-5 * abs_sums[path] + 1e-30
        assert np.all(np.abs(grads[path].reshape(-1) - total) <= bound), path
    return {path: v.reshape(grads[path].shape) for path, v in abs_sums.items()}


def _amax_terms(api, params, batch, monkeypatch):
    """qnn8: {"grad/.../amax": float64 array shaped like the leaf}: for each
    PACT ceiling (a layer's, or a layer's expert's), the sum of the
    absolute terms its gradient adds up, as
    ``test_torch_train._amax_grad_terms`` takes them, for leaves of any
    stacked shape ((L,), or (L, E) for the experts): the ceiling's place in
    its leaf is the view's storage offset."""
    tracked, paths = _tracked(params)
    recs = []
    real = tqnn.fake_quant_activations

    def spy(x, amax):
        out = real(x, amax)
        root = _root(amax)
        if out.requires_grad and id(root) in paths:
            key = (paths[id(root)], amax.storage_offset())
            xs, a = x.detach().double(), float(amax.detach())
            out.register_hook(lambda g: recs.append((key, xs, a, g.detach().double())))
        return out

    monkeypatch.setattr(tqnn, "fake_quant_activations", spy)
    grads = _backward(api, tracked, paths, batch)
    monkeypatch.setattr(tqnn, "fake_quant_activations", real)
    sums, abs_sums = {}, {}
    for (path, at), x, a, g in recs:
        x1 = x.clamp_min(0.0)
        u = torch.minimum(x1, torch.tensor(a, dtype=torch.float64)) * 255.0 / a
        terms = g * ((torch.round(u) - u) / 255.0 + (x1 > a).double())
        shape = grads[path].shape
        sums.setdefault(path, np.zeros(shape)).reshape(-1)[at] += float(terms.sum())
        abs_sums.setdefault(path, np.zeros(shape)).reshape(-1)[at] += float(terms.abs().sum())
    # a ceiling with no terms (an expert that took no token) must have a zero
    # gradient: the check below holds it to exactly 0
    assert abs_sums and all(v.max() > 0 for v in abs_sums.values())
    for path, total in sums.items():  # the terms are the port's own gradient
        assert np.all(np.abs(grads[path] - total) <= 1e-5 * abs_sums[path]), (path, total)
    return abs_sums


@contextlib.contextmanager
def held_cac_train(monkeypatch):
    """Hold the port's bika training CAC outputs to the reference's at
    genuine ties. The reference sends every ``bika_matmul_cvjp`` output to
    the host (``jax.debug.callback``, ordered: the forward's calls, then
    the remat recompute's, layer by layer backwards, each vmapped expert's
    in expert order); each port call takes the first of them, in that
    order, of its shape that it matches where it does not differ at a
    genuine tie: every difference even and at most twice the number of the
    port's pre-activations in that output's reduction within SIGN_TIE of 0
    (a Sign the packages' float parts may split), and takes that output.
    (The port runs an expert's projections one after another, the
    reference each projection over every expert, so the order within a
    layer's experts differs; outputs of different projections differ
    almost everywhere.) The recorded outputs serve every later pass of the
    port (its gradient, its step). Yields the counts."""
    recorded, stats = [], {"outputs": 0, "held": 0, "near_zero": 0, "passes": 0}
    j_real, t_real = jbika.bika_matmul_cvjp, ops.cac_train_matmul
    pending = []

    def record(*args, **kw):
        y = j_real(*args, **kw)
        jax.debug.callback(lambda v: recorded.append(np.asarray(v)), y, ordered=True)
        return y

    def explained(ref, y, x, w, beta):
        diff = (ref != y).reshape(-1, w.shape[1])
        if not bool(diff.any()):
            return 0, 0
        if int(diff.sum()) > max(8, diff.numel() // 100):
            return None
        x2 = x.reshape(-1, x.shape[-1])
        d = (ref - y).reshape(-1, w.shape[1]).abs()
        near_total = 0
        for r in diff.any(dim=1).nonzero()[:, 0].tolist():
            near = ((x2[r, :, None] * w + beta).abs() <= SIGN_TIE).sum(dim=0)
            if bool((diff[r] & ((d[r] > 2 * near) | (d[r] % 2 != 0))).any()):
                return None
            near_total += int(near[diff[r]].sum())
        return int(diff.sum()), near_total

    def follow(x, w, beta, **kw):
        y = t_real(x, w, beta, **kw)
        if not pending:
            jax.effects_barrier()
            assert recorded, "the reference recorded no CAC output"
            pending.extend(range(len(recorded)))
            stats["passes"] += 1
        yd = y.detach()
        for at, i in enumerate(pending):
            ref = recorded[i]
            if ref.shape != tuple(yd.shape):
                continue
            ref = _t(ref)
            held = explained(ref, yd, x.detach(), w.detach(), beta.detach())
            if held is not None:
                break
        else:
            raise AssertionError(f"no reference CAC output of shape {tuple(yd.shape)} matches "
                                 f"the port's but at genuine ties")
        del pending[at]
        stats["outputs"] += yd.numel()
        stats["held"] += held[0]
        stats["near_zero"] += held[1]
        return y + torch.where(ref != yd, ref - yd, 0)

    monkeypatch.setattr(jbika, "bika_matmul_cvjp", record)
    monkeypatch.setattr(ops, "cac_train_matmul", follow)
    yield stats
    assert not pending, f"the port left {len(pending)} reference outputs of a pass untaken"


def _route_margin(api_cfg, params, batch):
    """The smallest gap between a token's k-th and (k+1)-th gate over every
    routing of the port's forward (inf without experts)."""
    gaps = []
    real = port_moe._top_k

    def spy(gates, k):
        top = torch.sort(gates, dim=-1, descending=True).values
        gaps.append(float((top[:, k - 1] - top[:, k]).min()))
        return real(gates, k)

    port_moe._top_k = spy
    try:
        with torch.no_grad():
            build_model(api_cfg, phase="train").apply(params, batch)
    finally:
        port_moe._top_k = real
    return min(gaps, default=float("inf"))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_at_smoke(arch, mode, monkeypatch):
    """One whole train step at SMOKE (2 layers; seamless 2 + 2; remat on):
    the reference's train-form params from its own init, brought over with
    ``from_reference``, one batch from its pipeline (with frames for the
    encoder-decoder), the reference's loss, gradient and AdamW update in one
    compilation (its plain routes: ``bika_matmul_cvjp``, the SignSTE
    product; smollm's test holds its Pallas routes; qnn8 op by op under
    ``jax.disable_jit``, as smollm's test explains) against the port's
    ``make_train_step``: loss, accuracy, tokens, the aux loss, the gradient
    norm, every gradient leaf and every parameter after the update. bika's
    CAC outputs are held at genuine ties (``held_cac_train``). The MoE's
    capacity is counted from the step's 32 tokens."""
    jcfg = jax_get_smoke(arch, compute_mode=mode)
    japi = jax_build_model(jcfg, phase="train")
    np_params = jax.tree_util.tree_map(np.asarray, unbox(japi.init(jax.random.PRNGKey(7))))
    batch = _batch(jcfg)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    tbatch = {k: _t(v) for k, v in batch.items()}
    cfg = _port_cfg(jcfg)
    tp = from_reference(np_params)
    if cfg.n_experts:
        assert _route_margin(cfg, tp, tbatch) > ROUTE_TIE

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
        sum_bounds = None
        if mode == "qnn8":
            sum_bounds = _amax_terms(api, tp, tbatch, monkeypatch)
        elif mode == "bika" and cfg.family == "encdec":
            sum_bounds = _beta_terms(api, tp, tbatch, monkeypatch,
                                     {"grad/decoder/xattn/wk/beta"})
        _assert_tree_close(tgrads, jgrads, "grad", rtol=1e-4, sum_bounds=sum_bounds)
        tinit, tupd = make_optimizer(OptimizerSpec(**OPT))
        before = ops.launch_counts()
        tp, topt, tmet = make_train_step(api, tupd)(tp, tinit(tp), tbatch)
        assert ops.launch_counts() == before  # CPU: plain versions, no launch
    if held is not None:
        assert held["passes"] == 2 + (sum_bounds is not None), held
        assert held["held"] <= 1e-4 * held["outputs"], held
    for key in ("loss", "accuracy", "tokens", "aux_loss", "grad_norm", "skipped"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-6, atol=1e-7,
                                   err_msg=key)
    np.testing.assert_allclose(float(met["aux_loss"]), float(jmet["aux_loss"]), rtol=1e-6)
    assert (float(tmet["aux_loss"]) > 0) == bool(cfg.n_experts)
    lr = OPT["peak_lr"]
    for got, want, grad in zip(tree_leaves(tp), tree_leaves(jax.tree_util.tree_map(
            np.asarray, jp)), tree_leaves(jax.tree_util.tree_map(np.asarray, jgrads))):
        steady = (np.abs(grad) >= 100 * 1e-8) | (grad == 0)
        g = got.numpy()
        np.testing.assert_allclose(g[steady], want[steady], rtol=1e-5, atol=1e-2 * lr)
        assert np.all(np.abs(g - want) <= 2 * lr)
    assert topt["step"] == int(jopt["step"]) == 1


def _moe_case(mode, capacity_factor):
    spec = JSpec(mode=mode)
    jcfg = jax_moe.MoEConfig(n_experts=4, top_k=2, capacity_factor=capacity_factor)
    p = jax.tree_util.tree_map(np.asarray, unbox(jax_moe.moe_init(
        jax.random.PRNGKey(5), 32, 48, jcfg, spec)))
    tcfg = port_moe.MoEConfig(n_experts=4, top_k=2, capacity_factor=capacity_factor)
    return jcfg, spec, p, tcfg, LinearSpec(mode=mode)


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("mode", ["dense", "bika"])
def test_moe_apply_gradient_matches_reference(mode, dispatch):
    """``moe_apply`` in train form at capacity factor 0.5 (capacity 4 of the
    18 tokens' 36 assignments: a third are dropped, and queue slots stay
    empty at other seeds): output and aux loss, and the gradient of x and
    of every parameter (router, and each expert's gate, up and down)
    against ``jax.vjp`` of the reference's ``moe_apply`` with the same
    dispatch, through the softmax, the top-k, the renormalization, the aux
    loss and both gathers."""
    jcfg, jspec, p, tcfg, tspec = _moe_case(mode, 0.5)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 9, 32)).astype(np.float32)
    gy = rng.normal(size=(2, 9, 32)).astype(np.float32)
    cap = port_moe.capacity_of(18, tcfg)
    logits = torch.from_numpy(x.reshape(18, 32)) @ torch.from_numpy(p["router"]["w"])
    slot, _, _ = port_moe._route_sparse(logits, tcfg, cap)
    assert cap == 4 and int((slot == 4 * cap).sum()) == 36 - int(
        torch.bincount(slot.reshape(-1), minlength=4 * cap + 1)[:-1].sum())
    assert int((slot == 4 * cap).sum()) > 0  # assignments are dropped
    gates = torch.softmax(logits, -1).sort(-1, descending=True).values
    assert float((gates[:, 1] - gates[:, 2]).min()) > ROUTE_TIE

    def jfn(params, xx):
        return jax_moe.moe_apply(params, xx, jcfg, jspec, phase="train", dispatch=dispatch)

    (jy, jaux), pull = jax.vjp(jfn, jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    jgp, jgx = pull((jnp.asarray(gy), jnp.asarray(0.3, jnp.float32)))
    tp = jax.tree_util.tree_map(lambda a: _t(a).requires_grad_(True), p)
    tx = _t(x).requires_grad_(True)
    ty, taux = port_moe.moe_apply(tp, tx, tcfg, tspec, phase="train", dispatch=dispatch)
    torch.autograd.backward([ty, taux], [_t(gy), torch.tensor(0.3)])
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=1e-6)
    _assert_tree_close(tx.grad, jgx, "dx", rtol=1e-4)
    _assert_tree_close(jax.tree_util.tree_map(lambda t: t.grad, tp), jgp, "grad", rtol=1e-4)
    assert float(tp["router"]["w"].grad.abs().max()) > 0


def test_moe_microbatches_match_reference():
    """``make_train_step(microbatches=2)`` on mixtral's SMOKE config (dense)
    against the reference's (compiled): each microbatch routes its own 16
    tokens at its own capacity (int(16 x 2 / 4 x 1.25) = 10), so the step
    is not the whole batch's. Both steps hand their mean gradient to an
    optimizer that returns it: loss, accuracy, tokens, the aux loss and
    every gradient leaf are compared."""
    jcfg = jax_get_smoke("mixtral-8x22b", compute_mode="dense")
    japi = jax_build_model(jcfg, phase="train")
    np_params = jax.tree_util.tree_map(np.asarray, unbox(japi.init(jax.random.PRNGKey(9))))
    batch = _batch(jcfg, global_batch=2)

    def as_output(grads, state, params):  # the step's mean gradient is its output
        return grads, state, {"grad_norm": jnp.zeros(())}

    jstep = jax.jit(jsteps.make_train_step(japi, as_output, microbatches=2))
    jgrads, _, jmet = jstep(jax.tree_util.tree_map(jnp.asarray, np_params),
                            {"step": jnp.zeros((), jnp.int32)},
                            jax.tree_util.tree_map(jnp.asarray, batch))
    cfg = _port_cfg(jcfg)
    api = build_model(cfg, phase="train")
    tp = from_reference(np_params)
    tbatch = {k: _t(v) for k, v in batch.items()}
    for i in (0, 1):
        half = {k: v[i:i + 1] for k, v in tbatch.items()}
        assert _route_margin(cfg, tp, half) > ROUTE_TIE
    whole, _ = loss_and_grads(api, tp, tbatch)
    seen = {}

    def capture(grads, state, params):
        seen["grads"] = grads
        state["step"] += 1
        return params, state, {"grad_norm": torch.zeros(())}

    _, _, tmet = make_train_step(api, capture, microbatches=2)(tp, {"step": 0}, tbatch)
    for key in ("loss", "accuracy", "tokens", "aux_loss"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-6, atol=1e-7,
                                   err_msg=key)
    assert float(whole["aux_loss"]) != float(tmet["aux_loss"])  # per-microbatch routing
    _assert_tree_close(seen["grads"], jgrads, "grad", rtol=1e-4)


def test_moe_remat_and_repeat_bit_equal():
    """The port alone, mixtral SMOKE in bika: the gradient with remat (the
    routing recomputed in the backward) equals the one without, and a
    second run equals the first, bit for bit."""
    cfg = get_smoke("mixtral-8x22b", compute_mode="bika")
    params = build_model(cfg, phase="train").init(5, device="cpu")
    batch = lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=8, global_batch=4, seed=1), 2)
    runs = [loss_and_grads(build_model(cfg.replace(remat=remat), phase="train"), params, batch)
            for remat in (True, False, True)]
    for met, grads in runs[1:]:
        assert float(met["loss"]) == float(runs[0][0]["loss"])
        assert float(met["aux_loss"]) == float(runs[0][0]["aux_loss"])
        for a, b in zip(tree_leaves(grads), tree_leaves(runs[0][1])):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_lm_batch_frames():
    """``frames_dim``: (B, S, frames_dim) float32 frames, 0.1 x a standard
    normal drawn after the tokens, so tokens, labels and mask equal the
    frame-less batch's bit for bit; a function of (seed, step)."""
    cfg = LMDataConfig(vocab=300, seq_len=12, global_batch=6, seed=4)
    with_frames = dataclasses.replace(cfg, frames_dim=64)
    plain, b = lm_batch(cfg, 3), lm_batch(with_frames, 3)
    assert set(plain) == {"tokens", "labels", "mask"}
    assert set(b) == {"tokens", "labels", "mask", "frames"}
    for k in plain:
        assert torch.equal(b[k], plain[k]), k
    f = b["frames"]
    assert f.shape == (6, 12, 64) and f.dtype == torch.float32
    assert 0.09 < float(f.std()) < 0.11 and abs(float(f.mean())) < 0.01
    assert torch.equal(lm_batch(with_frames, 3)["frames"], f)
    assert not torch.equal(lm_batch(with_frames, 4)["frames"], f)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_and_launcher_on_cpu(arch, capsys):
    """The Trainer on the CPU at SMOKE, 2 steps (the encoder-decoder's
    batches carry (B, S, d_model) frames), and the launcher's ``--arch``;
    without ``--device cpu`` both raise."""
    cfg = get_smoke(arch, compute_mode="bika")
    trainer = Trainer(TrainConfig(arch=cfg, seq_len=8, global_batch=2, steps=2, log_every=1),
                      device="cpu")
    assert trainer.data_cfg.frames_dim == (cfg.d_model if cfg.family == "encdec" else 0)
    assert ("frames" in trainer.batch(0)) == (cfg.family == "encdec")
    _, opt, log = trainer.run()
    assert [m["step"] for m in log] == [0, 1] and opt["step"] == 2
    assert all(np.isfinite(m["loss"]) for m in log)
    assert all((m["aux_loss"] > 0) == bool(cfg.n_experts) for m in log)
    assert launch_train.main(["--smoke", "--device", "cpu", "--arch", arch, "--mode", "bnn",
                              "--steps", "2", "--seq-len", "8", "--batch", "2"]) == 0
    assert f"arch={arch} mode=bnn" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--smoke", "--arch", arch, "--steps", "1", "--seq-len", "8",
                           "--batch", "2"])


@pytest.mark.parametrize("arch", ARCHS)
def test_restart_is_bitwise_reproducible(arch, tmp_path):
    """run_with_restarts at SMOKE in bika, 3 steps with a checkpoint each,
    a failure at step 1: the parameters (MoE leaves (L, E, ...); the
    encoder-decoder's two stacks) and AdamW's m, v and step equal the
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
    for a, b in zip(tree_leaves({"params": p, "opt": o}), tree_leaves({"params": params,
                                                                         "opt": opt})):
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        else:
            assert a == b
    assert o["step"] == 3
