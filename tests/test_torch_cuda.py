"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports torch and numpy only (no JAX), so it runs on a GPU
machine without the reference installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a GPU every test here skips. CAC is held bit-exact and repeatable
(the streaming template's ragged edges: M around its 4- and 16-row tiles, N
not a multiple of 16, K = 8 and K not a multiple of 16); paged attention
at 2e-5, the bound the reference holds its fused kernel to against the
gather oracle. The training CAC forward is bit-exact (it compares the
rounded product with the remapped -beta, which decides as the plain
version's rounded sum does); its STE backward within atol/rtol 1e-4 off
the |pre| = 1 window edge, split and fused alike (the kernels sum in
another order), all three bit-repeatable (fixed order, no atomics), the
split pair equal to kernel 5 bit for bit at its plan and to
``cac_train_split_order_model`` at every plan it could take, and each of
kernels 3 and 4 one device operation a call; on the dyadic grid, where
every product and sum is exact, both backwards are equal to their plain
versions bit for bit, window edges and +-0, +-inf and NaN included. The BNN
forwards
(kernels 6 and 7) are bit-exact, 7 equal to 6 on the same signs, kernel 6 on
both of its routes (streaming and tensor cores) at the route threshold and
one row past it; the
SignSTE backward pair (8 and 9) within atol/rtol 1e-4 everywhere (their
masks read the operand itself, so no element sits on an ambiguous edge; the
sums are reordered) and bit-for-bit repeatable. The int8 matmul (kernel 10)
is bit-exact on both of its routes: an exact int32 sum and the same two
float32 roundings as its plain version, also where the sums pass 2^24,
where the stream route's K splits meet in a cluster and where the tile
route's meet through integer atomics. Kernels 7 and 10 on the streaming
layout are one device operation a call (a torch.profiler trace). Paged
attention (kernel 11) is within 2e-5 of the gather oracle at every case,
including tables split over clusters of 1 to 16 ranks whose ranks walk
several blocks and chunks whose first queries see rank 0 alone, repeats
bit for bit (its ranks meet in rank order), takes the plan that
``attn_plan`` computes, and is one device operation a call at decode and
at a prefill chunk, also at the lm family's other GQA groups and head
dims (G = 6, 1 and 8 at D = 128; G = 1 at D = 96), and kernel 1 at
mixtral's expert and attention shapes (K = 6144 and 16384, M down to 1),
and kernels 1, 7 and 10 at zamba2's in_proj (N = 10448: a ragged last
128-column tile), with a SMOKE forward of each recurrent family on the card
equal to its CPU forward at exact launch counts; kernels 1, 7 and 10 at the
encoder-decoder family's three (K, N), with a SMOKE seamless drain on the
card equal to its CPU drain token for token at exact launch counts.
At the paper models' ragged shapes (TFC's N = 10 and
K = 32 head, CNV's first conv at K = 3 x 3 x 3 = 27 and a large im2col M)
every kernel of their paths holds to its plain version the same way, and
the bika serve path takes a contraction that is not a multiple of 8
through kernel 1 (padded to K' = 32) to the plain integers. At
mixtral-8x22b's expert-queue training shapes (M = 160 rows, K = 6144 and
16384) kernels 2 and 6 are bit-exact and kernels 5, 8 and 9 within 1e-4
and repeatable, and a two-expert MoE layer's gradient (router, gates, aux
loss, both gathers, the experts' kernels) repeats bit for bit. The plan
autotuner resolves, with no cache, to every card_* plan function; its
measured search holds every candidate's output and a second resolution
returns the stored winner; and a tuned cluster size reaches kernels 3 and
5 alike, so a tuned split step's gradients equal a tuned fused step's.
Tensor parallelism: kernels 1, 7 and 10 on each tp = 2 rank's column
block of nemotron-4-15b's four projections equal the whole call's
columns; kernel 11 on a rank's heads (Hq = 24, Hkv = 4, D = 128) at the
unsharded call's plan equals the whole call's heads bit for bit; and a
SMOKE nemotron drain under a (1, 2) gloo mesh sharing the card, and under
a one-rank NCCL mesh, equals the single-process drain."""
import os

import numpy as np
import pytest
import torch
from _torch_cases import (BNN_KERNEL_SHAPES, PAGED_CASES, QNN_KERNEL_SHAPES,
                          TRAIN_KERNEL_SHAPES, bnn_case, cac_case, cac_train_case,
                          cac_train_dyadic_case, cac_train_split_order_model, paged_case,
                          paged_ids, qnn_case, window_clear)

from repro_torch.core.backend import pack_signs
from repro_torch.core.ste import sign
from repro_torch.kernels import bnn_matmul as bnn
from repro_torch.kernels import cac_matmul as cac
from repro_torch.kernels import paged_attn as pa
from repro_torch.kernels import qnn_matmul as qnn
from repro_torch.kernels import ref
from repro_torch.kernels.cac_matmul import cac_matmul_kernel_call, cac_matmul_plain
from repro_torch.kernels.paged_attn import paged_attn_kernel_call


@pytest.fixture(autouse=True, scope="module")
def _untuned_plans(tmp_path_factory):
    """Every test here launches the plan rules' own plans: the autotune
    cache is a file that does not exist, whatever the user's cache holds
    (a test that tunes sets its own file, ``tune_cache``)."""
    from repro_torch.kernels import autotune

    old = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(tmp_path_factory.mktemp("plans") / "none.json")
    autotune.clear_cache()
    yield
    if old is None:
        os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE", None)
    else:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = old
    autotune.clear_cache()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 960, 960), (32, 2560, 960), (5, 24, 130)])
def test_cac_kernel_bit_exact_on_card(cuda, m, k, n):
    rng = np.random.default_rng(m + k)
    x, tau, s = cac_case(rng, m, k, n)
    args = (torch.from_numpy(x), torch.from_numpy(tau), pack_signs(torch.from_numpy(s)))
    before = cac_matmul_kernel_call.launches
    got = cac_matmul_kernel_call(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert cac_matmul_kernel_call.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), cac_matmul_plain(*args).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 8, 1), (4, 8, 130), (16, 200, 333), (17, 968, 65),
                                   (32, 960, 2560), (33, 40, 130), (1, 2568, 2560)])
def test_cac_streaming_edges_on_card(cuda, m, k, n):
    """Kernel 1 at the streaming template's edges, x and tau at -128 and
    127: bit-exact against the plain version, and a second launch repeats
    bit for bit (the split partials meet in a fixed order, no atomics)."""
    rng = np.random.default_rng(3 * m + k + n)
    x, tau, s = cac_case(rng, m, k, n)
    x.flat[:2], tau.flat[:2] = (-128, 127), (127, -128)
    args = (torch.from_numpy(x), torch.from_numpy(tau), pack_signs(torch.from_numpy(s)))
    dev = [a.to(cuda) for a in args]
    before = cac_matmul_kernel_call.launches
    got, again = cac_matmul_kernel_call(*dev), cac_matmul_kernel_call(*dev)
    torch.cuda.synchronize()
    assert cac_matmul_kernel_call.launches == before + 2
    assert torch.equal(got, again)
    np.testing.assert_array_equal(got.cpu().numpy(), cac_matmul_plain(*args).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("past", [0, 1], ids=["at", "past"])
@pytest.mark.parametrize("w_dtype", [torch.int8, torch.float32], ids=["int8", "float32"])
@pytest.mark.parametrize("k,n", [(960, 2560), (2560, 960), (100, 130)])
def test_bnn_forward_routes_on_card(cuda, past, w_dtype, k, n):
    """Kernel 6 at its weight dtype's route threshold and one row past it:
    the planned route and both forced routes bit-exact against the plain
    version, each call one counted launch, and a second launch repeats bit
    for bit."""
    m = bnn.FWD_STREAM_MAX_M[w_dtype] + past
    assert bnn.fwd_plan(m, k, n, w_dtype)[0] == ("tc" if past else "stream")
    rng = np.random.default_rng(m + 3 * k + n)
    x, w, _ = (torch.from_numpy(a).to(cuda) for a in bnn_case(rng, m, k, n, nan=True))
    wt = w if w_dtype == torch.float32 else sign(w).to(torch.int8)
    want = bnn.bnn_matmul_plain(x, w)
    before = bnn.bnn_matmul_kernel_call.launches
    for route in (None, "stream", "tc"):
        got = bnn.bnn_matmul_kernel_call(x, wt, route=route)
        assert torch.equal(got, want), route
        assert torch.equal(bnn.bnn_matmul_kernel_call(x, wt, route=route), got)
    torch.cuda.synchronize()
    assert bnn.bnn_matmul_kernel_call.launches == before + 6


def _paged_operands(cuda, b, c, hq, hkv, d, bs, t, quantized, positions):
    rng = np.random.default_rng(b + c + hq)
    case = paged_case(rng, b, c, hq, hkv, d, bs, t, quantized, positions)
    host = [None if a is None else torch.from_numpy(a) for a in case]
    return host, [None if a is None else a.to(cuda) for a in host]


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,hq,hkv,d,bs,t,quantized,positions", PAGED_CASES,
                         ids=paged_ids())
def test_paged_attention_kernel_on_card(cuda, b, c, hq, hkv, d, bs, t, quantized, positions):
    """Within 2e-5 of the gather oracle, and two calls equal bit for bit
    (the ranks' partials meet in a fixed order)."""
    host, dev = _paged_operands(cuda, b, c, hq, hkv, d, bs, t, quantized, positions)
    want = ref.paged_attention_ref(*host)
    got = paged_attn_kernel_call(*dev[:5], k_scale=dev[5], v_scale=dev[6])
    again = paged_attn_kernel_call(*dev[:5], k_scale=dev[5], v_scale=dev[6])
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=2e-5, rtol=2e-5)
    assert torch.equal(got, again)


# the lm family's new (Hq, Hkv, D) on the paged path: nemotron-4-15b (G = 6),
# qwen1.5-32b (G = 1), phi3-mini-3.8b (G = 1, D = 96), chameleon-34b (G = 8)
GROUP_HEADS = [(48, 8, 128), (40, 40, 128), (32, 32, 96), (64, 8, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("b,c,t", [(4, 1, 8), (1, 32, 8), (2, 8, 20)],
                         ids=["decode", "chunk", "chunk-T20"])
@pytest.mark.parametrize("hq,hkv,d", GROUP_HEADS, ids=["G6-D128", "G1-D128", "G1-D96",
                                                        "G8-D128"])
def test_paged_attention_new_groups_on_card(cuda, hq, hkv, d, b, c, t, quantized):
    """Kernel 11 at the new configs' GQA groups and head dims, decode and
    prefill chunks: within 2e-5 of its plain version, repeatable bit for
    bit, on attn_plan's plan (the compiled kernel's own)."""
    host, dev = _paged_operands(cuda, b, c, hq, hkv, d, 16, t, quantized, "tail")
    plan = pa.attn_plan(b, c, hq, hkv, d, 16, t)
    assert pa.card_plan(b, c, hq, hkv, d, 16, t)[:2] == plan
    want = ref.paged_attention_ref(*host)
    got = paged_attn_kernel_call(*dev[:5], k_scale=dev[5], v_scale=dev[6])
    again = paged_attn_kernel_call(*dev[:5], k_scale=dev[5], v_scale=dev[6])
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=2e-5, rtol=2e-5)
    assert torch.equal(got, again)


# mixtral-8x22b's kernel-1 shapes: an expert's gate/up and down at decode
# (capacity 1) and at a short prefill's capacity (13), the attention
# projections at decode (4 rows) and at a prefill of 4 x 11 tokens
MIXTRAL_CAC = [(1, 6144, 16384), (1, 16384, 6144), (13, 6144, 16384), (13, 16384, 6144),
               (4, 6144, 6144), (4, 6144, 1024), (44, 6144, 6144), (44, 6144, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MIXTRAL_CAC)
def test_cac_kernel_at_mixtral_shapes_on_card(cuda, m, k, n):
    """Kernel 1 at mixtral's expert and attention shapes, K up to 16384
    and M down to 1: bit-exact against its plain version and repeatable."""
    rng = np.random.default_rng(m + k + n)
    x, tau, s = (torch.from_numpy(a).to(cuda) for a in cac_case(rng, m, k, n))
    sp = pack_signs(s)
    got, again = cac_matmul_kernel_call(x, tau, sp), cac_matmul_kernel_call(x, tau, sp)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, cac_matmul_plain(x, tau, sp))


# (case for _paged_operands, plan): tiles that cut a chunk unevenly and
# clusters of 1 to 16 (non-portable) ranks at T = 20 with the chunk's
# queries in the last blocks; whole-chunk tiles over a chunk from position
# 0, whose first queries see rank 0 alone
PLAN_CASES = [((2, 9, 6, 2, 64, 8, 20, False, "tail"), plan)
              for plan in [(1, 1), (3, 2), (8, 5), (2, 8), (4, 16)]] + [
              ((1, 8, 6, 2, 16, 2, 8, False, "head"), (8, 4)),
              ((2, 8, 4, 4, 16, 4, 6, True, "head"), (8, 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("case,plan", PLAN_CASES)
def test_paged_attention_kernel_plans_on_card(cuda, case, plan):
    """Any plan within 2e-5 of the oracle."""
    host, dev = _paged_operands(cuda, *case)
    want = ref.paged_attention_ref(*host)
    got = paged_attn_kernel_call(*dev[:5], k_scale=dev[5], v_scale=dev[6], plan=plan)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,t", [(4, 1, 8), (4, 4, 8), (1, 32, 8), (4, 1, 64), (1, 32, 64),
                                   (2, 24, 20), (1, 32, 2)])
def test_paged_attention_plan_matches_the_kernel(cuda, b, c, t):
    """The compiled kernel's plan is attn_plan's, with its shared memory
    and threads, and the card keeps the whole grid resident."""
    hq, hkv, d, bs = 15, 5, 64, 16
    q_tile, splits = pa.attn_plan(b, c, hq, hkv, d, bs, t)
    g = hq // hkv
    assert pa.card_plan(b, c, hq, hkv, d, bs, t) == (
        q_tile, splits, pa.attn_smem_bytes(q_tile, g, d, bs, t, splits),
        32 * min(pa.MAX_WARPS, min(q_tile, c) * g))
    blocks = b * hkv * -(-c // q_tile) * splits
    assert blocks <= pa.card_max_blocks(b, c, hq, hkv, d, bs, t, False, q_tile, splits)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", TRAIN_KERNEL_SHAPES)
def test_cac_train_kernels_on_card(cuda, m, k, n):
    rng = np.random.default_rng(m * 3 + k + n)
    x, w, beta, g = (torch.from_numpy(a).to(cuda) for a in cac_train_case(rng, m, k, n))
    counts = [f.launches for f in (cac.cac_train_fwd_call, cac.cac_train_bwd_fused_call,
                                   cac.cac_train_bwd_dx_call, cac.cac_train_bwd_dw_call)]
    y = cac.cac_train_fwd_call(x, w, beta)
    fused = cac.cac_train_bwd_fused_call(x, w, beta, g)
    split = (cac.cac_train_bwd_dx_call(x, w, beta, g),) + cac.cac_train_bwd_dw_call(x, w, beta, g)
    torch.cuda.synchronize()
    assert [f.launches for f in (cac.cac_train_fwd_call, cac.cac_train_bwd_fused_call,
                                 cac.cac_train_bwd_dx_call, cac.cac_train_bwd_dw_call)] == [
        c + 1 for c in counts]
    assert torch.equal(y, cac.cac_train_fwd_plain(x, w, beta))
    plain = cac.cac_train_bwd_fused_plain(x, w, beta, g)
    dx_keep, dw_keep = window_clear(x, w, beta)
    for name, a, b, c, keep in zip(("dx", "dw", "dbeta"), fused, split, plain,
                                   (dx_keep, dw_keep, dw_keep)):
        for got in (a, b):
            torch.testing.assert_close(torch.where(keep, got, 0), torch.where(keep, c, 0),
                                       atol=1e-4, rtol=1e-4, msg=name)
    for a, b in zip(fused, cac.cac_train_bwd_fused_call(x, w, beta, g)):
        assert bits_equal(a, b)  # kernel 5 repeats bit for bit
    again = (cac.cac_train_bwd_dx_call(x, w, beta, g),) + cac.cac_train_bwd_dw_call(x, w, beta, g)
    for a, b in zip(split, again):
        assert bits_equal(a, b)  # kernels 3 and 4 repeat bit for bit
    # kernels 3 and 4 sum in kernel 5's order (3 at its cluster size)
    for a, b in zip(split, fused):
        assert bits_equal(a, b)


def bits_equal(a, b):
    """Equal bit for bit, any NaN matching any NaN at the same place."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(torch.where(na, 0, a).view(torch.int32),
                                               torch.where(nb, 0, b).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(512, 960, 960), (37, 100, 130), (129, 968, 65)])
def test_cac_train_kernels_exact_on_dyadic_grid(cuda, m, k, n):
    """Kernels 2-5 on the dyadic grid (exact products and sums, many
    pre-activations exactly 0 or +-1) with +-0, +-inf and NaN rows and
    columns: all equal their plain versions bit for bit."""
    rng = np.random.default_rng(m + 2 * k + n)
    x, w, beta, _ = (torch.from_numpy(a).to(cuda) for a in cac_train_dyadic_case(rng, m, k, n))
    assert bits_equal(cac.cac_train_fwd_call(x, w, beta), cac.cac_train_fwd_plain(x, w, beta))
    x, w, beta, g = (torch.from_numpy(a).to(cuda)
                     for a in cac_train_dyadic_case(rng, m, k, n, sparse=True))
    want = cac.cac_train_bwd_fused_plain(x, w, beta, g)
    for got in (cac.cac_train_bwd_fused_call(x, w, beta, g),
                (cac.cac_train_bwd_dx_call(x, w, beta, g),) + cac.cac_train_bwd_dw_call(
                    x, w, beta, g)):
        for name, a, b in zip(("dx", "dw", "dbeta"), got, want):
            assert bits_equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(37, 100, 130), (129, 968, 65), (600, 40, 200)])
def test_cac_train_split_kernels_follow_the_order_model_on_card(cuda, m, k, n):
    """Kernel 3 at every cluster size it takes and kernel 4 at both tile
    widths, one block a tile and one block a K tile: each equal bit for bit
    to ``cac_train_split_order_model`` (the order of kernel 5's sums) at its
    cluster size; so kernel 4's bits do not depend on its plan. M = 600
    walks two 512-row ranges."""
    rng = np.random.default_rng(m + 3 * k + n)
    x, w, beta, g = (torch.from_numpy(a).to(cuda) for a in cac_train_case(rng, m, k, n))
    ops = (x.data_ptr(), w.data_ptr(), beta.data_ptr(), g.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    tiles = -(-n // 64)
    models = {c: cac_train_split_order_model(x.cpu(), w.cpu(), beta.cpu(), g.cpu(), c)
              for c in range(1, min(cac.TRAIN_BWD_MAX_CLUSTER, tiles) + 1)}
    launch = cac._train_lib("cac_train_bwd_dx_launch")
    for c, (want, _, _) in models.items():
        dx = torch.empty_like(x)
        assert launch(*ops, dx.data_ptr(), m, n, k, c, stream) == 0
        assert bits_equal(dx.cpu(), want), c
    launch = cac._train_lib("cac_train_bwd_dw_launch")
    for nt in (8, 4):
        for parts in (-(-n // (8 * nt)), 1):
            dw, db = torch.empty_like(w), torch.empty_like(w)
            assert launch(*ops, dw.data_ptr(), db.data_ptr(), m, n, k, nt, parts, stream) == 0
            assert bits_equal(dw.cpu(), models[1][1]) and bits_equal(db.cpu(), models[1][2]), (
                nt, parts)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", BNN_KERNEL_SHAPES)
def test_bnn_kernels_on_card(cuda, m, k, n):
    rng = np.random.default_rng(m + 5 * k + n)
    x, w, g = (torch.from_numpy(a).to(cuda) for a in bnn_case(rng, m, k, n, nan=True))
    wb = sign(w).to(torch.int8)
    fns = (bnn.bnn_matmul_kernel_call, bnn.bnn_packed_matmul_kernel_call,
           bnn.bnn_bwd_dx_call, bnn.bnn_bwd_dw_call)
    counts = [f.launches for f in fns]
    want = bnn.bnn_matmul_plain(x, w)
    assert torch.equal(bnn.bnn_matmul_kernel_call(x, w), want)
    assert torch.equal(bnn.bnn_matmul_kernel_call(x, wb), want)  # int8 +-1, read as stored
    packed = k % 8 == 0
    if packed:
        wp = pack_signs(wb)
        assert torch.equal(bnn.bnn_packed_matmul_kernel_call(x, wp), want)
        assert torch.equal(bnn.bnn_packed_matmul_plain(x, wp), want)
    x = torch.nan_to_num(x)  # the backward cases hold no NaN
    dx, dw = bnn.bnn_bwd_dx_call(x, w, g), bnn.bnn_bwd_dw_call(x, w, g)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [c + d for c, d in zip(counts, (2, int(packed), 1, 1))]
    torch.testing.assert_close(dx, bnn.bnn_bwd_dx_plain(x, w, g), atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(dw, bnn.bnn_bwd_dw_plain(x, w, g), atol=1e-4, rtol=1e-4)
    assert torch.equal(dx, bnn.bnn_bwd_dx_call(x, w, g))  # no atomics: repeatable
    assert torch.equal(dw, bnn.bnn_bwd_dw_call(x, w, g))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", QNN_KERNEL_SHAPES + [(512, 960, 2560), (1, 4, 1)])
def test_qnn_kernel_bit_exact_on_card(cuda, m, k, n):
    """Kernel 10 on its planned route and on both forced routes (stream,
    tile), with aligned operands and with operands at an odd address (the
    byte loads): bit-exact against the plain version, one counted launch a
    call, and a second launch repeats bit for bit."""
    rng = np.random.default_rng(m + 7 * k + n)
    x, w, ws = qnn_case(rng, m, k, n)
    x[0], w[:, 0] = -128, -127  # one sum at K * 128 * 127
    x, w, ws = (torch.from_numpy(a).to(cuda) for a in (x, w, ws))
    # operands at an address that is not 4-byte aligned take the byte loads
    xo = torch.empty(m * k + 1, dtype=torch.int8, device=cuda)[1:].view(m, k).copy_(x)
    wo = torch.empty(k * n + 1, dtype=torch.int8, device=cuda)[1:].view(k, n).copy_(w)
    want = qnn.qnn_matmul_plain(x, w, ws, 0.05)
    before = qnn.qnn_matmul_kernel_call.launches
    for route in (None, "stream", "tile"):
        got = qnn.qnn_matmul_kernel_call(x, w, ws, 0.05, route=route)
        assert torch.equal(got, want), route
        assert torch.equal(qnn.qnn_matmul_kernel_call(x, w, ws, 0.05, route=route), got), route
        assert torch.equal(qnn.qnn_matmul_kernel_call(xo, wo, ws, 0.05, route=route), want), route
    torch.cuda.synchronize()
    assert qnn.qnn_matmul_kernel_call.launches == before + 9
    assert torch.equal(want.cpu(), qnn.qnn_matmul_plain(x.cpu(), w.cpu(), ws.cpu(), 0.05))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 960, 960), (4, 960, 320), (4, 960, 2560), (4, 2560, 960),
                                   (32, 960, 2560), (32, 2560, 960), (129, 968, 65)])
def test_bnn_packed_equals_kernel6_on_card(cuda, m, k, n):
    """Kernel 7 (the streaming template's packed op) at decode, at a prefill
    chunk and at a ragged shape: equal to kernel 6 on the same signs and to
    its plain version, and a second launch repeats bit for bit."""
    rng = np.random.default_rng(m + 11 * k + n)
    x, w, _ = (torch.from_numpy(a).to(cuda) for a in bnn_case(rng, m, k, n, nan=True))
    wb = sign(w).to(torch.int8)
    wp = pack_signs(wb)
    got = bnn.bnn_packed_matmul_kernel_call(x, wp)
    assert torch.equal(got, bnn.bnn_matmul_kernel_call(x, wb))
    assert torch.equal(got, bnn.bnn_packed_matmul_plain(x, wp))
    assert torch.equal(bnn.bnn_packed_matmul_kernel_call(x, wp), got)


def device_ops(fn, trace_path, tries=3):
    """The device operations (kernels, memsets, copies) of one call of
    ``fn``, by name, from a torch.profiler trace; ``fn`` runs once before,
    so that its kernel is built and its plan made outside the trace. A trace
    that holds no device event at all (the profiler sometimes returns one
    empty in a long process) is taken again, up to ``tries`` times."""
    import json

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace_path))
        with open(trace_path) as fh:
            events = json.load(fh)["traceEvents"]
        ops = [e["name"] for e in events if e.get("ph") == "X"
               and e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")]
        if ops:
            break
    return ops


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 16, 32])
def test_stream_kernels_one_device_op_on_card(cuda, tmp_path, m):
    """A call of kernel 10 (its planned route at the serve path's M) and of
    kernel 7 is one device operation: one kernel, no memset, no copy."""
    rng = np.random.default_rng(m)
    x, w, ws = (torch.from_numpy(a).to(cuda) for a in qnn_case(rng, m, 960, 2560))
    assert qnn.qnn_plan(m, 960, 2560)[0] == "stream"
    ops = device_ops(lambda: qnn.qnn_matmul_kernel_call(x, w, ws, 0.05), tmp_path / "qnn.json")
    assert len(ops) == 1 and "qnn_stream_kernel" in ops[0], ops
    xf, wf, _ = (torch.from_numpy(a).to(cuda) for a in bnn_case(rng, m, 2560, 960))
    wp = pack_signs(sign(wf).to(torch.int8))
    ops = device_ops(lambda: bnn.bnn_packed_matmul_kernel_call(xf, wp), tmp_path / "bnn.json")
    assert len(ops) == 1 and "stream_kernel<3," in ops[0], ops  # op SIGN_PACKED


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(960, 2560), (960, 320)])
def test_cac_train_split_kernels_one_device_op_on_card(cuda, tmp_path, k, n):
    """A call of kernel 3 and of kernel 4 at M = 512 (gate/up: 64-column
    tiles; k/v: 32-column tiles) is one device operation each: one kernel,
    no memset, no copy."""
    rng = np.random.default_rng(k + n)
    x, w, beta, g = (torch.from_numpy(a).to(cuda) for a in cac_train_case(rng, 512, k, n))
    ops = device_ops(lambda: cac.cac_train_bwd_dx_call(x, w, beta, g), tmp_path / "dx.json")
    assert len(ops) == 1 and "cac_train_bwd_dx_kernel" in ops[0], ops
    ops = device_ops(lambda: cac.cac_train_bwd_dw_call(x, w, beta, g), tmp_path / "dw.json")
    assert len(ops) == 1 and "cac_train_bwd_dw_kernel" in ops[0], ops


@pytest.mark.cuda
@pytest.mark.parametrize("b,c", [(4, 1), (1, 32)])
def test_paged_attention_one_device_op_on_card(cuda, tmp_path, b, c):
    """A call of kernel 11 at decode and at a prefill chunk is one device
    operation: one kernel, no memset, no copy."""
    _, dev = _paged_operands(cuda, b, c, 15, 5, 64, 16, 8, False, "tail")
    ops = device_ops(lambda: paged_attn_kernel_call(*dev[:5]), tmp_path / "attn.json")
    assert len(ops) == 1 and "paged_attn_kernel" in ops[0], ops


# the paper models' shapes (M, K, N): TFC's first layer and head, CNV's
# first conv (K = 27) at 8 images' im2col rows, its second at 2 images'
PAPER_SHAPES = [(128, 784, 64), (128, 32, 10), (8192, 27, 64), (2048, 576, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", PAPER_SHAPES)
def test_paper_shape_kernels_on_card(cuda, m, k, n):
    """Kernels 1, 2, 3-5, 6, 8, 9 and 10 at the paper models' shapes
    against their plain versions: forwards bit-exact, the STE backwards
    off the window edge and the SignSTE pair within 1e-4 (dx), and where
    they sum over M > 512 rows (dw, dbeta) within an absolute 1e-4 x
    sqrt(M / 512)."""
    rng = np.random.default_rng(m + 3 * k + n)
    x, w, beta, g = (torch.from_numpy(a).to(cuda) for a in cac_train_case(rng, m, k, n))
    assert torch.equal(cac.cac_train_fwd_call(x, w, beta), cac.cac_train_fwd_plain(x, w, beta))
    plain = cac.cac_train_bwd_fused_plain(x, w, beta, g)
    dx_keep, dw_keep = window_clear(x, w, beta)
    fused = cac.cac_train_bwd_fused_call(x, w, beta, g)
    split = (cac.cac_train_bwd_dx_call(x, w, beta, g),) + cac.cac_train_bwd_dw_call(x, w, beta, g)
    # dw and dbeta sum over M in 512-row ranges: above 512 rows an absolute
    # 1e-4 for each range's sum, growing as the square root of their count,
    # and no relative term (chip_smoke.py:_m_tol)
    m_tol = (1e-4, 1e-4) if m <= 512 else (1e-4 * (-(-m // 512)) ** 0.5, 0.0)
    for a, b, c, keep, (atol, rtol) in zip(fused, split, plain, (dx_keep, dw_keep, dw_keep),
                                           ((1e-4, 1e-4), m_tol, m_tol)):
        for got in (a, b):
            torch.testing.assert_close(torch.where(keep, got, 0), torch.where(keep, c, 0),
                                       atol=atol, rtol=rtol)
    wb = sign(w).to(torch.int8)
    assert torch.equal(bnn.bnn_matmul_kernel_call(x, w), bnn.bnn_matmul_plain(x, w))
    assert torch.equal(bnn.bnn_matmul_kernel_call(x, wb), bnn.bnn_matmul_plain(x, wb))
    torch.testing.assert_close(bnn.bnn_bwd_dx_call(x, w, g), bnn.bnn_bwd_dx_plain(x, w, g),
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(bnn.bnn_bwd_dw_call(x, w, g), bnn.bnn_bwd_dw_plain(x, w, g),
                               atol=m_tol[0], rtol=m_tol[1])
    xq, wq, ws = (torch.from_numpy(a).to(cuda) for a in qnn_case(rng, m, k, n))
    assert torch.equal(qnn.qnn_matmul_kernel_call(xq, wq, ws, 0.05),
                       qnn.qnn_matmul_plain(xq, wq, ws, 0.05))
    if k % 8 == 0:
        xi, tau, s = (torch.from_numpy(a).to(cuda) for a in cac_case(rng, m, k, n))
        sp = pack_signs(s)
        assert torch.equal(cac_matmul_kernel_call(xi, tau, sp), cac_matmul_plain(xi, tau, sp))


@pytest.mark.cuda
@pytest.mark.parametrize("k,m_sets", [(27, 1), (13, 2), (5, 3)])
def test_bika_serve_at_any_contraction_length_on_card(cuda, k, m_sets):
    """BikaBackend.apply_serve on an unpacked serve tree whose K is not a
    multiple of 8 (CNV's first conv: 27), padded as to_serve pads it: one
    kernel-1 launch, and the integers of the plain bika_matmul_hw, bit for
    bit."""
    from repro_torch.core import backend
    from repro_torch.core.bika import bika_matmul_hw, tile_m_axis

    rng = np.random.default_rng(k)
    n = 64
    tau = rng.integers(-128, 128, size=(m_sets, k, n)).astype(np.int8)
    s = np.where(rng.random((m_sets, k, n)) < 0.5, 1, -1).astype(np.int8)
    x = rng.normal(scale=3.0, size=(4096, k)).astype(np.float32)
    tau_p, s_p = backend.pad_contraction(torch.from_numpy(tau), torch.from_numpy(s))
    p = {"tau": tau_p.to(cuda), "s": s_p.to(cuda), "gamma": torch.ones(n, device=cuda)}
    spec = backend.LinearSpec(mode="bika", m=m_sets, out_scale="none")
    before = cac_matmul_kernel_call.launches
    got = backend.get_backend("bika").apply_serve(p, torch.from_numpy(x).to(cuda), spec)
    torch.cuda.synchronize()
    assert cac_matmul_kernel_call.launches == before + 1
    x_int = backend.quantize_activations(torch.from_numpy(x), 0.05)
    want = bika_matmul_hw(tile_m_axis(x_int, m_sets), torch.from_numpy(tau).reshape(-1, n),
                          torch.from_numpy(s).reshape(-1, n), clamp=False)
    assert torch.equal(got.cpu(), want.to(torch.float32))


@pytest.mark.cuda
def test_restart_bit_equal_under_deterministic_algorithms_on_card(cuda, tmp_path, monkeypatch):
    """smollm-360m bika at full width (d_model 960, d_ff 2560, vocab 49152),
    cut to 2 layers, batch 2 x seq 64, remat: a run that fails at step 2 of
    4 and restarts from its checkpoint equals the uninterrupted run bit for
    bit (every parameter, AdamW's m and v, the step), with PyTorch's
    deterministic algorithms on, which raise on an op that has no
    deterministic CUDA route (cuBLAS asks for its workspace setting)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import OptimizerSpec, tree_leaves
    from repro_torch.train.trainer import TrainConfig, Trainer, run_with_restarts

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    arch = get_config("smollm-360m", compute_mode="bika").replace(n_layers=2)
    base = dict(arch=arch, seq_len=64, global_batch=2, steps=4, log_every=1)
    spec = OptimizerSpec(peak_lr=1e-3, warmup=1, total_steps=4)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        ops.reset_launches()
        full_p, full_o, _ = Trainer(TrainConfig(**base), spec, device=cuda).run()
        counts = ops.launch_counts()
        made = []

        def make():
            made.append(1)
            cfg = TrainConfig(**base, ckpt_dir=str(tmp_path / "ck"), ckpt_every=1, keep=1)
            return Trainer(cfg, spec, device=cuda, fail_at_step=2 if len(made) == 1 else None)

        p, o, _, restarts = run_with_restarts(make)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(was)
    assert restarts == 1
    assert counts["cac_train_fwd"] == 4 * 2 * 7 * 2 and counts["cac_train_bwd_fused"] == 4 * 7 * 2
    for a, b in zip(tree_leaves({"p": full_p, "o": full_o}), tree_leaves({"p": p, "o": o})):
        if torch.is_tensor(a):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b == 4


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 64])
def test_in_proj_ragged_tile_on_card(cuda, m):
    """Kernels 1, 7 and 10 at zamba2-2.7b's in_proj, (K, N) = (2560,
    10448): N is not a multiple of the streaming template's 128-column tile,
    and the ragged last tile (columns 10368-10447) is exactly the dt
    columns that feed softplus. Decode (M = 4) and a prefill (M = 64):
    bit-exact against the plain versions, repeatable, one counted launch a
    call."""
    k, n = 2560, 10448
    rng = np.random.default_rng(m + 10448)
    x, tau, s = cac_case(rng, m, k, n)
    args = [torch.from_numpy(a) for a in (x, tau)] + [pack_signs(torch.from_numpy(s))]
    dev = [a.to(cuda) for a in args]
    xf, w, _ = (torch.from_numpy(a).to(cuda) for a in bnn_case(rng, m, k, n, nan=True))
    wp = pack_signs(sign(w).to(torch.int8))
    xq, wq, ws = (torch.from_numpy(a).to(cuda) for a in qnn_case(rng, m, k, n))
    calls = ((cac_matmul_kernel_call, dev, cac_matmul_plain(*args)),
             (bnn.bnn_packed_matmul_kernel_call, (xf, wp), bnn.bnn_packed_matmul_plain(xf, wp)),
             (qnn.qnn_matmul_kernel_call, (xq, wq, ws, 0.05),
              qnn.qnn_matmul_plain(xq, wq, ws, 0.05)))
    for fn, operands, want in calls:
        before = fn.launches
        got, again = fn(*operands), fn(*operands)
        torch.cuda.synchronize()
        assert fn.launches == before + 2, fn
        assert torch.equal(got, again), fn
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["zamba2-2.7b", "xlstm-125m"])
def test_recurrent_smoke_forward_on_card(cuda, monkeypatch, name):
    """One SMOKE-size model of each recurrent family in bika: its prefill
    of 2 x 9 tokens and 2 decode steps on CUDA tensors, then the same calls
    on the CPU (the plain version of kernel 1) fed the card's tokens, with
    activation codes held to the card's at genuine half-way ties
    (``chip_smoke._code_hooks``): logits within 1e-4, greedy tokens equal,
    and every forward on the card exactly one kernel-1 launch a projection
    (hybrid: 2 a Mamba layer + 7 a shared-block application; xLSTM: 2 an
    sLSTM layer + 5 an mLSTM layer) and no other kernel."""
    import os

    from repro_torch.configs import get_smoke
    from repro_torch.core.convert import tree_to_serve
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, views_of

    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs

    cfg = get_smoke(name, compute_mode="bika", pack_signs=True, remat=False)
    per = cs._forward_launches(cfg)
    assert per == (2 * 4 + 7 * 2 if cfg.family == "hybrid" else 2 * 2 + 5)
    train = build_model(cfg, phase="train").init(3, device="cpu")
    serve = tree_to_serve(train, cfg.linear_spec())
    api = build_model(cfg, phase="serve")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (2, 9))
                              .astype(np.int32))
    install, restore, _ = cs._code_hooks(torch)
    logs, fed = {}, []
    for side, where in (("card", cuda), ("cpu", torch.device("cpu"))):
        params = views_of(api, _tree_to(serve, where))
        ops.reset_launches()
        install(side)
        try:
            with torch.inference_mode():
                lg, cache = api.prefill(params, {"tokens": tokens.to(where)}, max_len=16)
                out = [lg.float().cpu()]
                for t in range(9, 11):
                    if side == "card":
                        fed.append(out[-1][:, -1].argmax(-1).to(torch.int32)[:, None])
                    lg, cache = api.decode_step(params, fed[t - 9].to(where), cache, t)
                    out.append(lg.float().cpu())
        finally:
            restore()
        if side == "card":
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert counts["cac_hw"] == 3 * per
            assert sum(counts.values()) == counts["cac_hw"], counts
        logs[side] = out
    for g, c in zip(logs["card"], logs["cpu"]):
        torch.testing.assert_close(g, c, atol=1e-4, rtol=0)
        assert torch.equal(g.argmax(-1), c.argmax(-1))


def _tree_to(tree, where):
    if isinstance(tree, dict):
        return {k: _tree_to(v, where) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, where) for v in tree]
    return tree.to(where)


# seamless-m4t-large-v2's projections: self and cross q/k/v/o, up, down
ENCDEC_KN = [(1024, 1024), (1024, 8192), (8192, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 64])
@pytest.mark.parametrize("k,n", ENCDEC_KN)
def test_encdec_shapes_on_card(cuda, k, n, m):
    """Kernels 1, 7 and 10 at the encoder-decoder family's three (K, N),
    at decode (M = 4) and at the encoder and cross K/V of 4 x 16 frames (M
    = 64): bit-exact against the plain versions, repeatable, one counted
    launch a call."""
    rng = np.random.default_rng(m + k + 2 * n)
    x, tau, s = cac_case(rng, m, k, n)
    args = [torch.from_numpy(a) for a in (x, tau)] + [pack_signs(torch.from_numpy(s))]
    dev = [a.to(cuda) for a in args]
    xf, w, _ = (torch.from_numpy(a).to(cuda) for a in bnn_case(rng, m, k, n, nan=True))
    wp = pack_signs(sign(w).to(torch.int8))
    xq, wq, ws = (torch.from_numpy(a).to(cuda) for a in qnn_case(rng, m, k, n))
    calls = ((cac_matmul_kernel_call, dev, cac_matmul_plain(*args)),
             (bnn.bnn_packed_matmul_kernel_call, (xf, wp), bnn.bnn_packed_matmul_plain(xf, wp)),
             (qnn.qnn_matmul_kernel_call, (xq, wq, ws, 0.05),
              qnn.qnn_matmul_plain(xq, wq, ws, 0.05)))
    for fn, operands, want in calls:
        before = fn.launches
        got, again = fn(*operands), fn(*operands)
        torch.cuda.synchronize()
        assert fn.launches == before + 2, fn
        assert torch.equal(got, again), fn
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_encdec_smoke_drain_on_card(cuda, monkeypatch):
    """A SMOKE seamless-m4t-large-v2 in bika through ServeEngine.from_trained
    (auto -> static), 5 requests at batch 4 with frames (4, 16, 64) given as
    ``run(extra_batch=)``: the drain on the card equals the same drain on
    the CPU token for token, activation codes held to the card's at
    genuine half-way ties (``chip_smoke._code_hooks``), and the card's
    kernel-1 launches are exactly 6 an encoder layer and 10 a decoder layer
    a prefill and 8 a decoder layer a decode step, and no other kernel."""
    import os

    from repro_torch.configs import get_smoke
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs

    cfg = get_smoke("seamless-m4t-large-v2", compute_mode="bika", pack_signs=True, remat=False)
    train = build_model(cfg, phase="train").init(3, device="cpu")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(3, 12))).astype(np.int32)
               for _ in range(5)]
    frames = (0.1 * rng.normal(size=(4, 16, cfg.d_model))).astype(np.float32)
    install, restore, _ = cs._code_hooks(torch)
    outs = {}
    for side, where in (("card", cuda), ("cpu", torch.device("cpu"))):
        eng = ServeEngine.from_trained(_tree_to(train, where), cfg, batch_size=4, max_len=32,
                                       device=where)
        assert eng.engine == "static"
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        ops.reset_launches()
        install(side)
        try:
            done = eng.run(extra_batch={"frames": frames})
        finally:
            restore()
        if side == "card":
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            # two groups: a prefill and 5 decode steps each
            per_prefill = 6 * cfg.n_encoder_layers + 10 * cfg.n_layers
            assert counts["cac_hw"] == 2 * (per_prefill + 5 * 8 * cfg.n_layers), counts
            assert sum(counts.values()) == counts["cac_hw"], counts
        outs[side] = {r.rid: np.asarray(r.output) for r in done}
    assert sorted(outs["card"]) == list(range(5))
    for i in range(5):
        np.testing.assert_array_equal(outs["card"][i], outs["cpu"][i], err_msg=f"request {i}")


# the mixture of experts' expert queues at mixtral-8x22b's training shapes:
# C = int(512 x 2 / 8 x 1.25) = 160 rows (a ragged last 128-row tile), the
# gate/up (K = 6144, N = 16384) and down (K = 16384, N = 6144) projections
EXPERT_TRAIN_SHAPES = [(160, 16384, 6144), (160, 6144, 16384)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", EXPERT_TRAIN_SHAPES)
def test_training_kernels_at_expert_queue_shapes_on_card(cuda, m, k, n):
    """Kernels 2 and 6 bit-exact against their plain versions; kernel 5
    within atol/rtol 1e-4 off the |pre| = 1 window edge, kernels 8 and 9
    within 1e-4 everywhere; 5, 8 and 9 bit-repeatable."""
    _training_kernels_hold(cuda, m, k, n)


# the recurrent families' training shapes at batch 4 x seq 128: zamba2-2.7b's
# in_proj (N = 10448: a 16-column last tile in kernels 2-5, a 16-step last
# stage of kernel 8, an 80-row last tile of kernel 9), out_proj and shared
# block; xlstm-125m's mLSTM up / sLSTM wx, q/k/v, the two downs
RECURRENT_TRAIN_SHAPES = [(512, 2560, 10448), (512, 5120, 2560), (512, 2560, 2560),
                          (512, 2560, 10240), (512, 10240, 2560), (512, 768, 3072),
                          (512, 1536, 1536), (512, 1536, 768), (512, 768, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", RECURRENT_TRAIN_SHAPES)
def test_training_kernels_at_recurrent_shapes_on_card(cuda, m, k, n):
    """Kernels 2-6, 8 and 9 at zamba2-2.7b's and xlstm-125m's training
    shapes, as at the expert queues'."""
    _training_kernels_hold(cuda, m, k, n)


def _training_kernels_hold(cuda, m, k, n):
    rng = np.random.default_rng(m + k + 2 * n)
    x, w, beta, g = (torch.from_numpy(a).to(cuda) for a in cac_train_case(rng, m, k, n))
    assert torch.equal(cac.cac_train_fwd_call(x, w, beta), cac.cac_train_fwd_plain(x, w, beta))
    fused = cac.cac_train_bwd_fused_call(x, w, beta, g)
    dx_keep, dw_keep = window_clear(x, w, beta, rows=2)
    for name, got, want, keep in zip(("dx", "dw", "dbeta"), fused,
                                     cac.cac_train_bwd_fused_plain(x, w, beta, g),
                                     (dx_keep, dw_keep, dw_keep)):
        torch.testing.assert_close(torch.where(keep, got, 0), torch.where(keep, want, 0),
                                   atol=1e-4, rtol=1e-4, msg=name)
    for a, b in zip(fused, cac.cac_train_bwd_fused_call(x, w, beta, g)):
        assert bits_equal(a, b)
    del fused, dx_keep, dw_keep, beta
    x, w, g = (torch.from_numpy(a).to(cuda) for a in bnn_case(rng, m, k, n))
    assert torch.equal(bnn.bnn_matmul_kernel_call(x, w), bnn.bnn_matmul_plain(x, w))
    dx, dw = bnn.bnn_bwd_dx_call(x, w, g), bnn.bnn_bwd_dw_call(x, w, g)
    torch.testing.assert_close(dx, bnn.bnn_bwd_dx_plain(x, w, g), atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(dw, bnn.bnn_bwd_dw_plain(x, w, g), atol=1e-4, rtol=1e-4)
    assert torch.equal(dx, bnn.bnn_bwd_dx_call(x, w, g))
    assert torch.equal(dw, bnn.bnn_bwd_dw_call(x, w, g))


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("mode", ["bika", "bnn"])
def test_moe_layer_gradient_bit_repeatable_on_card(cuda, mode, dispatch):
    """A two-expert MoE layer in train form (d_model 256, d_ff 512, 4 x 64
    tokens, capacity factor 0.75 so that assignments are dropped and queue
    slots stay empty): the gradients of x and of every parameter, through
    the router, the gates, the aux loss, both gathers and the experts'
    kernels, equal bit for bit across two runs; the launches are one
    forward and one backward kernel call (kernels 2 and 5, or 6 and 8 + 9) a
    projection and expert."""
    from repro_torch.core.backend import LinearSpec
    from repro_torch.kernels import ops
    from repro_torch.nn import moe

    cfg = moe.MoEConfig(n_experts=2, top_k=2, capacity_factor=0.75)
    spec = LinearSpec(mode=mode)
    params = moe.moe_init(torch.Generator(device=cuda).manual_seed(1), 256, 512, cfg, spec,
                          phase="train", device=cuda)
    x = torch.randn((4, 64, 256), generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda)
    leaves = [params["router"]["w"]] + [leaf for proj in params["experts"].values()
                                        for leaf in proj.values()]
    runs = []
    for _ in range(2):
        live = [leaf.detach().requires_grad_(True) for leaf in leaves + [x]]
        it = iter(live)
        tree = {"router": {"w": next(it)},
                "experts": {k: {n: next(it) for n in proj} for k, proj in
                            params["experts"].items()}}
        ops.reset_launches()
        y, aux = moe.moe_apply(tree, live[-1], cfg, spec, phase="train", dispatch=dispatch)
        grads = torch.autograd.grad(y.square().mean() + 0.01 * aux, live)
        torch.cuda.synchronize()
        runs.append((grads, ops.launch_counts()))
    slots = moe._route_sparse(x.reshape(-1, 256) @ params["router"]["w"], cfg,
                              moe.capacity_of(256, cfg))[0]
    assert int((slots == 2 * moe.capacity_of(256, cfg)).sum()) > 0  # some assignments drop
    per = 3 * cfg.n_experts
    want = ({"cac_train_fwd": per, "cac_train_bwd_fused": per} if mode == "bika" else
            {"bnn": per, "bnn_bwd_dx": per, "bnn_bwd_dw": per})
    for grads, counts in runs:
        assert {k: v for k, v in counts.items() if v} == want, counts
    assert float(runs[0][0][0].abs().max()) > 0  # the router learns
    for a, b in zip(runs[0][0], runs[1][0]):
        assert bits_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bika", "bnn"])
@pytest.mark.parametrize("name", ["zamba2-2.7b", "xlstm-125m"])
def test_recurrent_smoke_train_step_on_card(cuda, monkeypatch, name, mode):
    """One SMOKE-size train step of each recurrent family (remat on) through
    the Trainer on the card, twice from the same init: exactly one forward
    launch twice (the remat recompute) and one backward launch a projection
    (``chip_smoke._train_projections``: zamba2's 2 a Mamba layer and 7 a
    shared-block application, xLSTM's 2 an sLSTM and 5 an mLSTM layer),
    finite losses, and the updated parameters and AdamW moments equal bit
    for bit (the shared block's gradient sums its applications in a fixed
    order, no atomics)."""
    import os

    from repro_torch.configs import get_smoke
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.trainer import TrainConfig, Trainer

    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs

    cfg = get_smoke(name, compute_mode=mode)
    n = cs._train_projections(cfg)
    assert n == (2 * 4 + 7 * 2 if cfg.family == "hybrid" else 2 * 2 + 5)
    want = ({"cac_train_fwd": 2 * n, "cac_train_bwd_fused": n} if mode == "bika" else
            {"bnn": 2 * n, "bnn_bwd_dx": n, "bnn_bwd_dw": n})
    runs = []
    for _ in range(2):
        trainer = Trainer(TrainConfig(arch=cfg, seq_len=16, global_batch=2, steps=1), device=cuda)
        params, opt, _ = trainer.init()
        ops.reset_launches()
        params, opt, met = trainer.train_step(params, opt, 0)
        torch.cuda.synchronize()
        assert {k: v for k, v in ops.launch_counts().items() if v} == want
        assert np.isfinite(float(met["loss"])) and float(met["skipped"]) == 0.0
        runs.append(tree_leaves({"params": params, "m": opt["m"], "v": opt["v"]}))
    for a, b in zip(*runs):
        assert bits_equal(a, b)


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    """A fresh autotune cache file under tmp_path, for the test's life."""
    from repro_torch.kernels import autotune

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune_torch.json"))
    autotune.clear_cache()
    yield tmp_path / "autotune_torch.json"
    autotune.clear_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 960, 2560), (32, 2560, 960), (512, 960, 2560),
                                   (160, 6144, 16384), (129, 968, 65)])
def test_get_plan_without_cache_is_the_card_plan_on_card(cuda, tune_cache, m, k, n):
    """With no cache entry and no override, every path resolves to today's
    card_* plan function: the wrappers launch the plans they launched
    before the autotuner existed."""
    from repro_torch.kernels import autotune

    i = cuda.index or 0
    want = {
        "hw_fwd": cac.card_stream_plan(i, m, k, n),
        "train_fwd": cac.card_train_fwd_plan(i, m, k, n),
        "train_bwd": cac.card_train_bwd_plan(i, m, k, n),
        "train_bwd_dw": cac.card_train_bwd_dw_plan(i, m, k, n),
        "bnn_packed": cac.card_stream_plan(i, m, k, n, "bnn_matmul", "packed_max_blocks",
                                           bnn.PACKED_MT),
        "qnn8": qnn._card_plan(i, m, k, n),
    }
    for path, plan in want.items():
        assert autotune.get_plan(path, m, k, n, i) == plan, path
    for w_dtype in (torch.int8, torch.float32):
        assert autotune.get_plan("bnn", m, k, n, i, w_dtype=w_dtype) == bnn._card_fwd_plan(
            i, m, k, n, w_dtype)
    for want_dx in (True, False):
        assert autotune.get_plan("bnn_bwd", m, k, n, i, want_dx=want_dx) == bnn._card_plan(
            i, m, k, n, want_dx)
    assert autotune.get_paged_plan(4, 1, 15, 5, 64, 16, 8, i) == pa.card_plan(
        4, 1, 15, 5, 64, 16, 8)[:2]
    assert not tune_cache.exists()


@pytest.mark.cuda
@pytest.mark.parametrize("path,shape", [("hw_fwd", (4, 960, 960)), ("train_bwd_dw", (64, 96, 200)),
                                        ("bnn_bwd", (64, 96, 200))])
def test_measured_plan_holds_its_outputs_on_card(cuda, tune_cache, path, shape):
    """The measured search times every legal candidate, holds each output
    against the default plan's (it raises where one does not hold), stores
    the winner, and a second resolution returns it from the file."""
    from repro_torch.kernels import autotune

    i = cuda.index or 0
    rec = autotune.measured_search(path, *shape, iters=3, warmup=1, index=i)
    assert rec["held"] and rec["candidates"]
    if rec["tolerance"] == 0:  # integer outputs: every candidate bit-equal to the default
        assert all(c["max_abs_err"] == 0 for c in rec["candidates"])
    assert tune_cache.exists()
    autotune.clear_cache()
    timed = autotune.timed_calls
    if path == "bnn_bwd":
        got = {h: autotune.get_plan(path, *shape, i, want_dx=h == "dx") for h in ("dx", "dw")}
    else:
        got = autotune.get_plan(path, *shape, i)
    assert got == rec["winner"] and autotune.timed_calls == timed
    assert autotune.invalid_cache_entries() == []


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(512, 960, 2560), (37, 100, 130)])
def test_tuned_split_step_equals_tuned_fused_step_on_card(cuda, tune_cache, m, k, n):
    """Kernels 3 and 5 resolve through one path (train_bwd): a cached
    cluster size other than the default reaches both, and the split step's
    gradients then equal the fused step's bit for bit."""
    from repro_torch.kernels import autotune, ops

    i = cuda.index or 0
    default = cac.card_train_bwd_plan(i, m, k, n)
    other = [c for c in autotune.candidate_plans("train_bwd", m, k, n, i) if c != default]
    assert other, "a shape with more than one legal cluster size"
    autotune._store_cache(autotune.cache_key("train_bwd", m, k, n, "cuda"),
                          autotune.plan_to_fields("train_bwd", other[0]))
    assert autotune.get_plan("train_bwd", m, k, n, i) == other[0]
    rng = np.random.default_rng(m + k + n)
    x, w, beta, g = (torch.from_numpy(a).to(cuda) for a in cac_train_case(rng, m, k, n))
    grads = {}
    for fused in (True, False):
        xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, beta))
        ops.reset_launches()
        ops.cac_train_matmul(xs, ws, bs, fused_bwd=fused).backward(g)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts["cac_train_bwd_fused" if fused else "cac_train_bwd_dx"] == 1
        grads[fused] = (xs.grad, ws.grad, bs.grad)
    for a, b in zip(grads[True], grads[False]):
        assert bits_equal(a, b)


# nemotron-4-15b's projections on a rank of tp = 2, (K, N/2) of its (K, N):
# q/o, k/v, up, down
TP2_NEMOTRON_KN = [(6144, 6144), (6144, 1024), (6144, 24576), (24576, 6144)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", TP2_NEMOTRON_KN)
def test_column_blocks_equal_the_whole_call_on_card(cuda, k, n):
    """Kernels 1, 7 and 10 on each tp = 2 rank's column block (K, N/2) at
    decode (M = 4): bit-exact against the plain version and equal to the
    same columns of the whole (K, N) call, so a sharded projection gathers
    to the single-process output bit for bit."""
    rng = np.random.default_rng(k + n)
    x, tau, s = cac_case(rng, 4, k, n)
    xf, w, _ = bnn_case(rng, 4, k, n)
    xq, wq, ws = qnn_case(rng, 4, k, n)
    sp = pack_signs(torch.from_numpy(s))
    wp = pack_signs(sign(torch.from_numpy(w)).to(torch.int8))
    calls = (
        (cac_matmul_kernel_call, cac_matmul_plain,
         lambda c: (torch.from_numpy(x), torch.from_numpy(tau)[:, c], sp[:, c])),
        (bnn.bnn_packed_matmul_kernel_call, bnn.bnn_packed_matmul_plain,
         lambda c: (torch.from_numpy(xf), wp[:, c])),
        (qnn.qnn_matmul_kernel_call, qnn.qnn_matmul_plain,
         lambda c: (torch.from_numpy(xq), torch.from_numpy(wq)[:, c], torch.from_numpy(ws)[c],
                    0.05)),
    )
    half = n // 2
    for fn, plain, operands in calls:
        def on_card(c):
            return [a.contiguous().to(cuda) if torch.is_tensor(a) else a for a in operands(c)]

        whole = fn(*on_card(slice(None)))
        for r in range(2):
            cols = slice(r * half, (r + 1) * half)
            got = fn(*on_card(cols))
            torch.cuda.synchronize()
            assert torch.equal(got, whole[:, cols]), (fn, r)
            np.testing.assert_array_equal(got.cpu().numpy(), plain(*operands(cols)).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("b,c,t", [(4, 1, 8), (1, 32, 8), (4, 1, 24)], ids=["decode", "chunk",
                                                                            "long-decode"])
def test_paged_attention_head_blocks_equal_the_whole_call_on_card(cuda, b, c, t, quantized):
    """Kernel 11 on each tp = 2 rank's heads of nemotron-4-15b (Hq = 24 of
    48, Hkv = 4 of 8, D = 128, G = 6), given the unsharded head counts:
    the unsharded call's plan, so each head equals the whole call's bit for
    bit; and that plan is what the whole call takes."""
    from repro_torch.kernels import autotune, ops

    rng = np.random.default_rng(b * c + t)
    q, k, v, tables, q_pos, ks, vs = (None if a is None else torch.from_numpy(a).to(cuda)
                                      for a in paged_case(rng, b, c, 48, 8, 128, 16, t,
                                                          quantized))
    whole = paged_attn_kernel_call(q, k, v, tables, q_pos, k_scale=ks, v_scale=vs)
    plan = autotune.get_paged_plan(b, c, 48, 8, 128, 16, t, cuda.index)
    for r in range(2):
        hq, hk = slice(24 * r, 24 * r + 24), slice(4 * r, 4 * r + 4)
        block = [None if a is None else a[:, :, hk].contiguous() for a in (k, v, ks, vs)]
        before = paged_attn_kernel_call.launches
        got = ops.paged_attention(q[:, :, hq].contiguous(), block[0], block[1], tables, q_pos,
                                  k_scale=block[2], v_scale=block[3], heads=(48, 8))
        torch.cuda.synchronize()
        assert paged_attn_kernel_call.launches == before + 1
        assert torch.equal(got, whole[:, :, hq]), (r, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,world", [("gloo", 2), ("nccl", 1)])
def test_tp_smoke_drain_on_card(cuda, tmp_path, backend, world):
    """The SMOKE nemotron-4-15b (6 heads, 2 kv heads) in bika on the paged
    engine under a (1, world) mesh on the card: two gloo ranks sharing the
    card, or a one-rank NCCL group running the same collectives. Tokens
    and the first logits equal the single-process drain's, and each rank
    launches kernels 1 and 11 as often as one process."""
    import _torch_tp_ranks as ranks_mod
    from repro_torch.configs import get_smoke
    from repro_torch.core.convert import tree_to_serve
    from repro_torch.models import build_model

    arch = get_smoke("nemotron-4-15b", compute_mode="bika", pack_signs=True, remat=False)
    train = build_model(arch, phase="train").init(3, device="cpu")
    serve_np = _np_tree(tree_to_serve(train, arch.linear_spec()))
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, arch.vocab, int(rng.randint(3, 20))).astype(np.int32)
               for _ in range(4)]
    case = {"arch": arch, "engine": "paged", "prompts": prompts, "new_tokens": 6,
            "device": "cuda", "engine_kw": dict(max_len=64, n_slots=2, kv_block_size=16,
                                                prefill_chunk=16)}
    single = ranks_mod.serve_case(case, serve_np)
    got = ranks_mod.spawn(ranks_mod.serve_cases, world, tmp_path, [(case, serve_np)],
                          backend=backend)
    for rank in got:
        res = rank["cases"][0]
        assert res["tokens"] == single["tokens"]
        for kind in ("prefill", "decode"):
            for a, b in zip(res[kind], single[kind]):
                np.testing.assert_array_equal(a, b)
        for name in ("cac_hw", "paged_attn"):
            assert res["launches"][name] == single["launches"][name] > 0, name
        assert res["collectives"]["all_gather"] > 0 and res["collectives"]["all_reduce"] > 0


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.numpy()
