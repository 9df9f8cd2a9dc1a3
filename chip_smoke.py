"""Drive the PyTorch/CUDA port on one GPU and hold it against its plain path.

    python3 chip_smoke.py

Phases (each prints its own lines and, as it ends, ``[time] <phase> <s>``;
any failure exits non-zero):

1. device  — the card's name and power limit (nvidia-smi).
2. build   — compile every kernel in src/repro_torch/csrc/ with nvcc, in
             parallel, and print the build time.
   device-ops — one call each of kernel 10 (stream route), kernel 7 and
             kernel 10's tile route at decode gate/up, of kernel 11 at
             decode and at a prefill chunk, and of kernels 3 and 4 at train
             gate/up, under torch.profiler: all but the tile route must be
             one device operation each (no memset).
3. kernels — each CUDA kernel against its plain PyTorch version on the card,
             at the shapes of the path that runs it: CAC bit-exact and
             repeatable (M = 4 and 32 at the four projections, timed, and
             ragged shapes around the streaming template's edges, one with
             every term a mismatch); paged
             attention within 2e-5 and repeatable, with its plan (fp32 and
             int8 pools: decode, chunk, the speculative verify's B = 4 x C =
             4 window, a drain-like decode at positions 3-35 and a long
             decode at T = 64, positions near 1023), then a sweep of its
             query tile (chunk, verify) and cluster size (long decode);
             the training CAC forward bit-exact and its STE backward (fused,
             and the split dx + dw pair) within atol = rtol = 1e-4 off the
             |pre| = 1 window edge, at M = 512 and two ragged shapes, all
             three backward kernels bit-repeatable, and whether the split
             pair equals the fused kernel bit for bit printed; on a dyadic
             grid with +-0, +-inf and NaN rows and columns (every product
             and sum exact) the forward and the fused and split backwards
             equal their plain versions bit for bit, window edges included;
             the -Xptxas -v lines and the hot loops' instruction mix of
             kernels 2-5, their occupancy and plans, and a sweep of every
             plan kernels 2-5 could take. Times
             the kernel, its plain version and, where one exists, a library
             call that computes the same function (gather + SDPA for
             attention; timed here only, the port never calls it).
4. path    — ServeEngine.from_trained on full-width smollm-360m in bika mode
             with packed signs (random train-form weights from a seed),
             paged engine, fused route: 8 requests x 16 new tokens, run twice
             for determinism, with fp and with int8 KV. The launch counters
             are zeroed just before the first fp run and read just after it.
   profile — one more fp-KV drain under torch.profiler: device busy time,
             idle share, the kernels that take the most time and kernel
             11's device ms and launches (as in every profiled drain).
   obs     — the same drain traced (obs.Tracer), metered
             (obs.MetricsRegistry) and phase-timed (profile_sample=4):
             tokens equal the untraced drain's, 224 kernel-1 and 32
             kernel-11 launches a tick, every request's queued / prefill /
             decode spans equal to its RunMetrics stamps, the Prometheus
             text parsed; traced and untraced wall seconds side by side; a
             drain inside the --profile-dir torch.profiler window, whose
             Chrome trace names kernels 1 and 11; and a replay_arrivals
             drain at Poisson 20 req/s with the closed loop's tokens.
5. parity  — the same weights cut to 2 layers at full width: the card's
             prefill and decode logits against a CPU run of the port (plain
             versions), with the activation codes held equal at half-way
             ties (see phase_parity).
6. train   — Trainer on full-width, full-depth smollm-360m in bika mode
             (remat on), batch 4 x seq 128: 3 steps with the fused backward
             and 1 with the split pair, launch counts exact per step (448
             forward, 224 fused; 224 dx + 224 dw on the split step), finite
             losses; ms per step, peak memory, and one more step of each
             backward under torch.profiler (device busy, idle share, top
             kernels, the device ms of kernels 2 and 5, or 2, 3 and 4).
7. train parity — one train step of the same model cut to 1 layer on the
             card and on the CPU plain path, CAC outputs held equal where
             the two split a Sign at a near-zero pre-activation (see
             phase_train_parity); loss, gradients and updated parameters
             within the stated tolerances.
   ckpt    — checkpoint and restart at full width, 8 of 32 layers (bika,
             remat, batch 4 x seq 128): run_with_restarts with a failure at
             step 2 of 4 (ckpt_every=1, keep=1) equals the uninterrupted
             4-step run bit for bit in every parameter and AdamW m / v leaf,
             each step exactly 112 kernel-2 and 56 kernel-5 launches; the
             checkpoint's bytes and its save (sync, async) and restore
             seconds; a flipped byte in a leaf makes restore raise; then one
             qnn8 step through launch/train.py --mode qnn8 (full depth;
             finite loss, no kernel). Checkpoints go to a temporary
             directory under build/,
             removed at the end of the phase.
8. bnn-kernels — the BNN kernels (6: sign product, 7: its packed serve
             form, 8/9: the SignSTE dx and dw) against their plain versions
             at the decode shapes (M = 4), the unpacked serve's prefill
             shapes (M = 16, 32), the training shapes (M = 512) and three
             ragged shapes: forwards bit-exact on the planned route and on
             both of kernel 6's routes (streaming, tensor cores),
             repeatable, and 7 equal to 6 wherever K % 8 == 0 (its plan
             printed, a second launch equal),
             backward within atol = rtol = 1e-4 on every element and
             repeatable, with each backward launch's plan and the card's
             cluster occupancy; times with plain, library (torch.matmul on
             +-1 operands) and bound, kernel 7 at M = 4, 16 and 32. The
             build prints the -Xptxas -v lines of the product template
             (kernels 6 at large M, 8, 9), its sign pass, the streaming
             template (kernels 1, 6 at small M, 7) and kernel 10's stream
             route.
   route sweep — kernel 6 on both routes at M = 16..128, gate/up and down,
             float32 and int8 weights: the times that set the route
             threshold.
9. bnn-serve — phases 4, profile (with kernel 7's device ms) and 5 again
             in bnn mode at 16 of 32 layers (packed planes: 112 kernel-7
             and 16 attention launches per tick, 0 elsewhere),
             plus one unpacked drain (112 kernel-6 launches per tick) whose
             tokens must equal the packed drain's; the parity holds a Sign
             only where both sides' input lies within 1e-5 of 0.
10. bnn-train — phases 6 and 7 again in bnn mode: 3 steps with exactly 448
             kernel-6, 224 kernel-8 and 224 kernel-9 launches each and 0
             training-CAC launches, and the profiled step's device ms of
             kernels 8 and 9; the parity holds Signs within 1e-5 of 0 and
             STE masks within 1e-5 of |x| = 1.
11. qnn8-kernels — kernel 10 (the int8 matmul) against its plain version,
             bit-exact and repeatable on both routes (stream, tile) and the
             planned one, at the path's (K, N) for M = 4, 16, 32 and 512 and
             three ragged shapes (K = 99, 100, 968), with extreme codes (x
             -128 and 127, w +-127, a zero w column at the 1e-12 scale floor,
             one sum at K * 128 * 127), each shape's plan printed; times of
             both routes with plain, torch._int_mm (cuBLASLt, M = 4 and 16
             zero-padded to 32) and bound; the stream route at every split
             count at M = 4 and 32.
   qnn route sweep — both routes at M = 16..128, gate/up and down: the
             times that set QNN_STREAM_MAX_M.
   tooling — the static checker and the plan autotuner on the card
             (phase_tooling): repro_torch.analysis.kernel_contracts over
             every route x config x M with this build's -Xptxas -v output of
             every entry function (each mapped to its kernel; registers,
             shared memory, spill stores against their budgets), the card's
             SM count and its occupancy for every plan: any finding fails;
             one row per entry function. Then kernels.autotune's measured
             search at one shape a path (TOOLING_SHAPES; kernel 11 at
             smollm's decode case) against a temporary cache file: every
             legal candidate timed (CUDA events, L2 flushed, median of 10),
             its output held against the default plan's (bit-equal for 1,
             2, 6, 7, 10; 1e-4 for 3-5, 8, 9; 2e-5 for 11; kernel 3's dx
             equal to kernel 5's at every cluster size), the default's and
             the winner's ms; a second resolution at each shape must come
             from the file with nothing timed. The file is removed and the
             cache cleared before the next phase. ``python3 chip_smoke.py
             --only tooling`` builds and runs this phase alone (a partial
             run: no result line).
12. qnn8-serve — phases 4, profile (with kernel 10's device ms) and 5
             again in qnn8 mode at 16 of 32 layers: 112 kernel-10
             and 16 attention launches per tick, 0 elsewhere; the parity holds
             activation codes at half-way ties as for bika.
13. spec    — dense smollm-360m target <- qnn8 draft (k = 4) of one seeded
             train-form tree, full width, 8 of 32 layers: paged and continuous
             engines, each target-only and speculative (fp KV). Speculative
             tokens equal target-only, and continuous equal paged, except
             where the target's top-2 logit gap (recomputed on the card from
             the common prefix) is below 1e-4, each such case printed; kernel
             10 exactly 56 x (4 x rounds + admissions), kernel 11 exactly 8
             x (rounds + prefill chunks) on the paged engine and 0 on the
             continuous one, 0 elsewhere; accept rate, tokens per round, TPOT
             and goodput printed for the record, and one more speculative
             drain per engine under torch.profiler.

14. paper  — the paper's models (TFC, SFC, LFC, CNV; models/paper.py) at
             their published widths, batch 128: every kernel of their paths
             (1, 2, 3-5, 6 on float32 and int8 weights, 8, 9, 10) against its
             plain version at each distinct (M, K, N) of their projections
             (PAPER_SHAPES: CNV's im2col M = 131,072 and K = 27, the heads'
             N = 10), timed, beside its bound and, for the sign products,
             torch.matmul; sums over M > 512 rows (dw, dbeta) held within
             an absolute 1e-4 x sqrt(M / 512) (``_m_tol``); then 3 bika
             training steps of each model (CNV a 4th with the split
             backward, kernels 3 and 4) and 3
             of TFC in dense, bnn and qnn8, launches exact a step; one bika
             step of full-width CNV on 4 images card vs CPU (CAC outputs held
             at near-zero Signs); the served forward of each trained model
             (bika for all four, CNV's first conv through the K' = 27 pad;
             bnn and qnn8 on TFC) at batch 128 and, on 8 images, equal to the
             CPU's bit for bit (codes held at half-way ties); and the
             quickstart at 200 steps (check (a) >= 99 % of units, (b)
             bit-equal). ``python3 chip_smoke.py --only paper`` builds and
             runs this phase alone (a partial run: no result line).
15. moe    — the rest of the lm family (phase_moe_kernels, phase_moe): kernel
             1 at mixtral-8x22b's (M, K, N) (an expert's gate/up and down at
             decode capacity 1 and at the short and long prefills' queues,
             q/o and k/v at 4, 44 and 4,200 rows) bit-exact, repeatable,
             timed beside its bound; kernel 11 at the new GQA groups (G = 6,
             1, 1, 8 at D = 128, 128, 96, 128: nemotron, qwen, phi3,
             chameleon), decode and a chunk, fp32 and int8, within 2e-5.
             Then mixtral-8x22b in bika (packed) at full width cut to 2
             layers through ServeEngine.from_trained(engine="auto"), which
             takes the static engine: a short drain (the 8 requests, batch 4,
             max_len 128) and a long drain (prompts of 4,090 and 4,200 tokens,
             one a batch, max_len 4,352: the ring wraps in decode, and folds
             the longer prompt at prefill), each twice with equal tokens,
             every forward exactly 56 kernel-1 launches and no other kernel;
             the ring oracle (the attention layer alone, each decode step
             within 2e-5 of windowed dot_attention over every position so
             far, fp32 and int8 rings); card-vs-CPU parity of the short
             drain's first batch with activation codes and expert choices
             held at genuine ties, each printed (1 of the 2 layers, 2 of
             the 4 requests, prefill + 2 decode steps); one layer in qnn8
             (kernel 10) and bnn (kernel 7) from one train-form tree, a
             drain each twice;
             nemotron-4-15b (LayerNorm,
             squared ReLU, G = 6) at full width, 2 layers, bika on the paged
             engine: a drain twice (12 kernel-1 and 2 kernel-11 launches a
             tick) and its parity at 1 layer. Wall seconds and peak memory of
             every drain. ``python3 chip_smoke.py --only moe`` runs the two
             alone (a partial run: no result line).
16. recurrent — the hybrid and xLSTM families (phase_recurrent_kernels,
             phase_recurrent): kernels 1, 7 and 10 at the ten (K, N) of
             zamba2-2.7b's and xlstm-125m's projections (``RECURRENT_KN``;
             the in_proj's N = 10448 leaves a ragged last 128-column tile),
             M = 4 and 84, bit-exact, repeatable, timed beside their plain
             versions, a library call and the bound. Then zamba2-2.7b in
             bika (packed) at full width, 18 of 54 layers (3 of 9 groups),
             and xlstm-125m whole, each through
             ServeEngine.from_trained(engine="auto"), which takes the
             static engine: the 8 requests x 16 tokens (batch 4, max_len
             128) twice, every forward exactly 57 (51)
             kernel-1 launches and no other kernel, tokens equal run to
             run, build and drain peaks; one drain under torch.profiler
             (device busy, idle share, kernel 1's device ms); the
             prefill's host-loop cost at 64 and 512 tokens; card-vs-CPU
             parity of the drain's first batch (prefill + 4 decode steps;
             zamba2 cut to 6 layers, one shared-block application; xlstm to
             4, an sLSTM and three mLSTM layers) with activation codes held
             at half-way ties; then
             qnn8 (kernel 10) and bnn packed (kernel 7) from one train-form
             tree each (zamba2 at 6 layers: 19 launches a forward; xlstm
             whole: 51), a drain each twice. ``python3 chip_smoke.py --only
             recurrent`` runs the two alone (a partial run: no result line).
17. encdec — the encoder-decoder family (phase_encdec_kernels,
             phase_encdec): kernels 1, 7 and 10 at seamless-m4t-large-v2's
             three (K, N) (``ENCDEC_KN``: q/k/v/o, up, down) at M = 4, 44
             and 64, and kernel 1 at M = 4,096 (the encoder over 1,024
             frames a row), bit-exact, repeatable, timed beside their plain
             versions, a library call and the bound. Then the model in bika
             (packed) at full width and 12 + 12 of 24 + 24 layers through
             ServeEngine.from_trained(engine="auto") -> static, frames (4,
             16, 1024) given as run(extra_batch=): the 8 requests x 16
             tokens twice, every prefill exactly 192 and every decode step
             96 kernel-1 launches and no other kernel (3,264 a drain),
             tokens equal run to run, build and drain peaks; one drain
             under torch.profiler; one prefill over 1,024 frames a row and
             3 decode steps over its 1,024 cross keys, launches exact;
             card-vs-CPU parity at 4 + 4 layers with activation codes held
             at half-way ties; then qnn8 (kernel 10) and bnn packed (kernel
             7) from one train-form tree at 6 + 6 layers (96 launches a
             prefill, 48 a decode step), a drain each twice. ``python3
             chip_smoke.py --only encdec`` runs the two alone (a partial
             run: no result line).
18. train-families — training the mixture of experts and the
             encoder-decoder (phase_train_families_kernels,
             phase_train_families): kernels 2-6, 8 and 9 at the seven (M,
             K, N) of mixtral-8x22b's and seamless-m4t-large-v2's training
             projections at batch 4 x seq 128 (``FAMILY_TRAIN_SHAPES``;
             mixtral's expert queues hold 160 rows, a ragged last 128-row
             tile, and its down projection K = 16384): 2 and 6 bit-exact,
             the backwards within 1e-4, all repeatable, timed beside their
             plain versions, a library call and the bound. Then seamless
             in bika at full width and 12 + 12 of 24 + 24 layers through
             the Trainer (frames from the pipeline): 3 AdamW steps, a
             profiled one and a profiled split-backward one, launches
             exact (384 kernel-2 and 192 kernel-5 a step); in bnn at 6 + 6 layers, 3
             steps; mixtral at full width, 1 layer: the bika gradient twice
             (56 kernel-2 and 28 kernel-5 launches each, equal bit for bit;
             its AdamW state does not fit the card in bika), 3 AdamW steps
             in bnn (56 / 28 / 28 launches) and in qnn8; peaks of each; then
             one train step of each family's SMOKE config card vs CPU in
             bika and bnn, Signs, STE masks and expert choices held at
             genuine ties. ``python3 chip_smoke.py --only train-families``
             runs the two alone (a partial run: no result line).
19. train-recurrent — training the hybrid and xLSTM families
             (phase_train_recurrent_kernels, phase_train_recurrent):
             kernels 2-6, 8 and 9 at the nine (M, K, N) of zamba2-2.7b's
             and xlstm-125m's training projections at batch 4 x seq 128
             (``RECURRENT_TRAIN_SHAPES``; zamba2's in_proj N = 10448 leaves
             a ragged edge in every one of them), as in train-families.
             Then zamba2 in bika at full width and all 54 layers: the
             gradient (``loss_and_grads``) twice, 342 kernel-2 and 171
             kernel-5 launches each, equal bit for bit (its AdamW state at
             54 layers does not fit the card); the Trainer at 18 layers: a
             fused, a split-backward and a profiled step (114 / 57
             launches, 57 each of kernels 3 and 4 split); in bnn (38 / 19
             / 19) and qnn8 at 6 layers, 3 steps each; xlstm-125m whole in
             bika (102 / 51) and bnn, 1 step each; then one train step of
             each family's SMOKE config card vs CPU in bika and bnn,
             Signs and STE masks held at genuine ties. ``python3
             chip_smoke.py --only train-recurrent`` runs the two alone (a
             partial run: no result line).
20. tp      — tensor-parallel serving (phase_tp_kernels, phase_tp): (a)
             kernels 1, 7 and 10 on each tp = 2 rank's column block of
             nemotron-4-15b's four projections (``TP_KN``, M = 4),
             bit-exact and equal to the whole call's columns, timed beside
             plain, a library call and the bound; the tied head's product
             on a rank's vocab rows equal to the whole product's columns;
             kernel 11 on a rank's heads (Hq 24, Hkv 4, D 128), decode and
             a chunk, fp32 and int8, at the unsharded call's plan, each head
             bit-equal to the whole call's. (b) nemotron-4-15b bika
             (packed) at full width, MOE_LAYERS layers, paged engine, tp = 2
             as two gloo ranks sharing the card (``spawn_ranks``: a
             FileStore under build/, a timeout on every collective, a
             deadline on the session): drain tokens, the first prefill and
             decode logits (gathered) and each rank's kernel 1 and 11
             launches equal to the moe phase's single-process drain's; the
             collectives a tick, each rank's resident param and KV bytes
             and the drains' wall seconds beside the single process's. (c)
             The same in qnn8 at TP_QNN_LAYERS layer (kernel 10) against a
             single-process drain here. (d) This process as a one-rank NCCL
             group through the same qnn8 drain. ``python3 chip_smoke.py --only tp`` runs
             it alone (the bika reference drained here; a partial run).

Earlier paths run at cut depths so that the whole script stays well inside
its time limit: the card-vs-CPU parities, whose CPU sides are most of their
phases' time (mixtral at 1 layer, 2 of the batch's 4 requests and 2
decode steps, the bika train step
at 1 layer, zamba2 at 6, xlstm at 4), the checkpoint phase (8 of smollm's
32 layers), the spec phase (8 of 32 layers), the bnn and qnn8 serve
drains (16 of 32 layers), the zamba2 bika drains (18 of 54 layers; the
54-layer forward runs in train-recurrent's gradient), the seamless bika
drains and training (12 + 12 of 24 + 24 layers), xlstm-125m's training
(1 step in each mode). The profiled drains read
the profiler's events directly and write no trace file.

Before the last line come the card's name and power limit as nvidia-smi
prints them, then the kernels JSON; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without CUDA, and when the
port's package is not beside this file.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

try:  # the H100's published peaks: one table with the kernel contracts
    from repro_torch.hwsim import DEVICE_TERMS
    _H100 = DEVICE_TERMS["h100_sxm"]
except ImportError:  # the port is not beside this file: main() says so and fails
    _H100 = {}

SEED = 0
N_SLOTS, MAX_LEN, BLOCK, CHUNK, NEW_TOKENS = 4, 128, 16, 32, 16
# published H100 SXM peaks (NVIDIA data sheet, repro_torch.hwsim): HBM
# bytes/s and the float32 rate outside the tensor cores, which also stands
# in for the CAC's integer compare/add pairs (no tensor-core form exists
# for them)
HBM_BYTES_S = _H100.get("hbm_bw")
CUDA_CORE_OPS_S = _H100.get("fp32_ops")
ATTN_TOL = 2e-5
PARITY_ATOL = 1e-3  # logits, once the activation codes agree; see phase_parity
SPIN_CYCLES = 4_000_000  # ~2 ms at the H100's clock: longer than any call's enqueue
PARITY_TIE = 1e-3  # code units from a half-way point where the codes may differ
# training CAC: the path's (K, N) projections at M = batch 4 x seq 128, and
# two ragged shapes that cut every tile edge
TRAIN_SHAPES = [(512, 960, 960), (512, 960, 320), (512, 960, 2560), (512, 2560, 960)]
TRAIN_RAGGED = [(37, 100, 130), (129, 968, 65)]
# the dyadic grid's bit-exact checks of kernels 2 and 5: q/o and the ragged shapes
TRAIN_DYADIC = [(512, 960, 960)] + TRAIN_RAGGED
TRAIN_TOL = 1e-4  # atol = rtol for dx/dw/dbeta, the reference's own STE-backward bound
WINDOW_EPS = 1e-4  # |pre| within this of 1: the reference leaves the element out
STE_RANGE = 512  # rows of an M range of kernels 3-5 (csrc/cac_train.cu, MAX_ROWS)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 128, 3
TRAIN_SIGN_TIE = 1e-6  # |pre| within this of 0: a Sign the two devices may split
TRAIN_PARITY_LOSS = 1e-5  # relative loss difference, card vs CPU, codes held
TRAIN_PARITY_REL = 1e-4  # per-leaf relative L2 difference of gradients and parameters
TRAIN_PARITY_LAYERS = 1  # the bika train step card vs CPU (the CPU side is the cost)
CKPT_LAYERS = 8  # checkpoint and restart at full width, 8 of 32 layers
_NO_LAUNCHES = {"bnn": 0, "bnn_bwd_dw": 0, "bnn_bwd_dx": 0, "bnn_packed": 0, "cac_hw": 0,
                "cac_train_bwd_dw": 0, "cac_train_bwd_dx": 0, "cac_train_bwd_fused": 0,
                "cac_train_fwd": 0, "paged_attn": 0, "qnn8": 0}
# the BNN kernels: the path's (K, N) projections at decode (M = n_slots) and
# at training (M = batch 4 x seq 128), and three ragged shapes (K not a
# multiple of 32, packed too; K not a multiple of 8, unpacked only; N not a
# multiple of 4 at the down shape, so the backward pair's 4-byte load route
# runs with both tile widths)
PATH_KN = [(960, 960), (960, 320), (960, 2560), (2560, 960)]
BNN_SHAPES = [(N_SLOTS, k, n) for k, n in PATH_KN] + [(512, k, n) for k, n in PATH_KN]
BNN_RAGGED = [(129, 968, 65), (37, 100, 130), (512, 2560, 962)]
# kernel 6 on int8 signs at the unpacked serve's prefill buckets and chunks
BNN_PREFILL = [(m, k, n) for m in (16, 32) for k, n in PATH_KN]
# kernel 6's route sweep: both routes at these M, gate/up and down, both
# weight kinds (the route threshold in kernels/bnn_matmul.py is set from it)
ROUTE_SWEEP_M = (16, 32, 33, 48, 64, 128)
# +-1 products and their integer sums are exact on the tensor cores, so the
# sign products' operations bound, and the SignSTE backward's (each term a
# +-1 times g), is 2 M K N at the dense bf16 rate (data sheet)
TENSOR_CORE_OPS_S = _H100.get("bf16_tensor_ops")
BWD_PLANES = 3  # the backward kernels' bf16 planes of g, recorded beside the bound
BNN_SIGN_TIE = 1e-5  # |x| within this of 0 on both sides: a Sign the devices may split
BNN_WINDOW_TIE = 1e-5  # |x| within this of 1 on both sides: an STE mask they may split
# kernel 10 (int8 matmul): the path's (K, N) at decode (M = n_slots), the
# draft's bucketed prefill of a prompt of <= 16 tokens (M = 16), chunk
# prefill (M = 32) and M = 512, and ragged shapes (K = 99, 100: x rows not
# 4-byte aligned; N = 33, 65, 130: w rows not either)
QNN_SHAPES = [(m, k, n) for m in (N_SLOTS, 16, 32, 512) for k, n in PATH_KN]
QNN_RAGGED = [(37, 100, 130), (129, 968, 65), (5, 99, 33)]
INT8_TENSOR_OPS_S = _H100.get("int8_tensor_ops")  # dense int8 tensor-core peak (data sheet)
ACT_SCALE = 0.05  # LinearSpec.act_scale, the serve path's x_scale
SPEC_K = 4  # the reference's benchmarked speculative window (dense <- qnn8)
SPEC_TIE = 1e-4  # top-2 logit gap below which target-only and spec may part
SPEC_LAYERS = 8  # the speculative pair at full width, 8 of smollm's 32 layers
LOWBIT_SERVE_LAYERS = 16  # the bnn and qnn8 serve drains at full width, 16 of 32 layers
# the profiled drains' device ms of kernel 7 (the streaming template's op 3,
# SIGN_PACKED), of kernel 10 (both routes) and of kernel 11, by kernel name
KERNEL7_GROUP = {"bnn_packed_matmul": ("stream_kernel<3,",)}
KERNEL10_GROUP = {"qnn_matmul": ("qnn_stream_kernel", "qnn_kernel<")}
KERNEL11_GROUP = {"paged_attn": ("paged_attn_kernel",)}


class PhaseClock:
    """Host seconds of each phase: ``clock(name, fn, *args)`` runs the phase,
    prints ``[time] name X s`` as it ends and keeps the figure."""

    def __init__(self):
        self.seconds = {}

    def __call__(self, name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.seconds[name] = time.perf_counter() - t0
        print(f"[time] {name} {self.seconds[name]:.1f} s")
        return out


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def time_ms(torch, fn, *, iters: int = 20, warmup: int = 3, flush=None) -> float:
    """Mean device time of ``fn`` from CUDA events around each call; with
    ``flush`` (a large buffer) L2 is overwritten before every call, as the
    serving path finds each layer's weights cold. A spin kernel ahead of the
    first event keeps the card busy while the host enqueues the call, so the
    events bracket the call's device work and not the host's launch time
    (that cost is the path's, and the profile phase shows it)."""
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_cac(torch, np, dev, flush):
    """Kernel 1 against its plain version, bit-exact: at the serve path's
    eight shapes (M = 4 decode and 32 prefill chunk x the four (K, N)),
    timed, on its plan and at every split count (``_split_sweep``); at
    ragged shapes that cut every edge of the streaming template
    (M in {1, 4, 16, 17, 32, 33}; N not a multiple of 16; K = 8 and K not a
    multiple of 16), with x and tau at -128 and 127; and at K = 2560 with
    every term a mismatch (one byte lane's count past 255 before its
    flush). Every launch is repeated and must repeat bit for bit. Bound:
    bytes = x, tau, s read once and y written once; operations M K N
    compare/add pairs at the CUDA cores' rate; the larger. Also times a
    kernel that does no work (the floor of ``time_ms``). Returns the rows
    and that floor."""
    from repro_torch.core.backend import pack_signs
    from repro_torch.kernels.cac_matmul import (cac_matmul_kernel_call, cac_matmul_plain,
                                                card_stream_plan)

    rng = np.random.default_rng(SEED)
    shapes = [(m, k, n) for m in (4, 32) for (k, n) in PATH_KN]
    ragged = [(5, 24, 130), (33, 40, 7), (1, 8, 1), (17, 968, 333), (4, 8, 130),
              (16, 200, 333), (32, 24, 1000), (1, 2568, 2560), (33, 2560, 960)]
    rows = []
    for m, k, n in shapes + ragged + [(4, 2560, 960)]:
        x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
        tau = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
        s = np.where(rng.random((k, n)) < 0.5, 1, -1).astype(np.int8)
        x.flat[:2], tau.flat[:2] = (-128, 127), (127, -128)
        mismatch = len(rows) == len(shapes) + len(ragged)  # the last case
        if mismatch:  # x < tau everywhere with s = +1: every term is -1
            x[:], tau[:], s[:] = -128, 127, 1
        x, tau = torch.from_numpy(x).to(dev), torch.from_numpy(tau).to(dev)
        sp = pack_signs(torch.from_numpy(s)).to(dev)
        got = cac_matmul_kernel_call(x, tau, sp)
        again = cac_matmul_kernel_call(x, tau, sp)
        torch.cuda.synchronize()
        want = cac_matmul_plain(x, tau, sp)
        err = float((got - want).abs().max())
        if err != 0.0:
            fail(f"cac_matmul M={m} K={k} N={n}: max |kernel - plain| = {err} (must be 0)")
        if not torch.equal(got, again):
            fail(f"cac_matmul M={m} K={k} N={n}: a second launch gave other values")
        if mismatch and not bool((got == -k).all()):
            fail(f"cac_matmul all-mismatch K={k}: not every sum is -K")
        row = {"M": m, "K": k, "N": n, "max_abs_err": err,
               "plan": list(card_stream_plan(x.device.index, m, k, n))}
        if (m, k, n) in shapes and not mismatch:
            row["ms"] = time_ms(torch, lambda: cac_matmul_kernel_call(x, tau, sp), flush=flush)
            row["ms_by_splits"] = _split_sweep(torch, x, tau, sp, flush)
            row["plain_ms"] = time_ms(torch, lambda: cac_matmul_plain(x, tau, sp),
                                      iters=5, flush=flush)
            nbytes = m * k + k * n + k * n // 8 + 4 * m * n
            row["bound_ms"], row["bound_by"] = _bound(nbytes, 2.0 * m * k * n, CUDA_CORE_OPS_S)
            row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        print(f"[kernels] cac_matmul M={m} K={k} N={n} bit-exact, repeatable"
              + (" (every term a mismatch)" if mismatch else "")
              + f"; plan (rows a tile, splits, groups a split) {row['plan']}"
              + (f" ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} "
                 f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}, "
                 f"{100 * row['bound_share']:.1f}%); ms by split count "
                 + ", ".join(f"{sp_} {t:.5f}" for sp_, t in row["ms_by_splits"].items())
                 if "ms" in row else ""))
    tiny = torch.empty(1, device=dev)
    floor = time_ms(torch, lambda: tiny.zero_(), flush=flush)
    print(f"[kernels] timing floor: one 1-element zero_ (a kernel that does no work) "
          f"{floor:.5f} ms")
    return rows, floor


def _split_sweep(torch, x, tau, sp, flush):
    """Kernel 1 at every split count its plan could take (the same row
    tile), device ms each: the data behind stream_plan's rule."""
    from repro_torch.kernels import cac_matmul as cac

    m, k = x.shape
    n = tau.shape[1]
    mt, _, _ = cac.stream_plan(m, k, n)
    groups = -(-k // cac.STREAM_GROUP)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = {}
    for s in range(1, cac.STREAM_MAX_SPLITS + 1):
        per = -(-groups // s)
        if -(-groups // per) != s:
            continue
        args = (x.data_ptr(), tau.data_ptr(), sp.data_ptr(), y.data_ptr(), m, n, k, mt, s, per,
                stream)
        if cac._lib()(*args) != 0:
            fail(f"cac_matmul M={m} K={k} N={n}: the launch refused {s} splits")
        out[s] = time_ms(torch, lambda: cac._lib()(*args), flush=flush)
    return out


def _paged_case(torch, np, rng, dev, b, c, t, quantized, hq=15, hkv=5, d=64, bs=16,
                last_range=None):
    """Shuffled pool; every row's last query sits inside a partial block,
    drawn from [c, t * bs) or from ``last_range``."""
    n_phys = b * t + 3
    q = rng.normal(size=(b, c, hq, d)).astype(np.float32)
    tables = rng.permutation(n_phys)[: b * t].reshape(b, t).astype(np.int32)
    last = rng.integers(*(last_range or (c, t * bs)), size=(b,))
    last = np.where(last % bs == bs - 1, last - 1, last)  # partial last block
    q_pos = (last[:, None] - (c - 1) + np.arange(c)[None]).astype(np.int32)
    if quantized:
        k = rng.integers(-127, 128, size=(n_phys, bs, hkv, d)).astype(np.int8)
        v = rng.integers(-127, 128, size=(n_phys, bs, hkv, d)).astype(np.int8)
        ks = rng.uniform(1e-3, 2e-2, size=(n_phys, bs, hkv, 1)).astype(np.float32)
        vs = rng.uniform(1e-3, 2e-2, size=(n_phys, bs, hkv, 1)).astype(np.float32)
    else:
        k = rng.normal(size=(n_phys, bs, hkv, d)).astype(np.float32)
        v = rng.normal(size=(n_phys, bs, hkv, d)).astype(np.float32)
        ks = vs = None
    to = (lambda a: None if a is None else torch.from_numpy(a).to(dev))
    return [to(a) for a in (q, k, v, tables, q_pos, ks, vs)]


def _sdpa_yardstick(torch, q, k, v, tables, q_pos, ks, vs):
    """Gather the logical windows, then F.scaled_dot_product_attention."""
    import torch.nn.functional as F

    b, c, hq, d = q.shape
    bs = k.shape[1]
    tl = tables.long()

    def gather(leaf):
        w = leaf[tl]
        return w.reshape(b, w.shape[1] * bs, *w.shape[3:])

    kw, vw = gather(k), gather(v)
    if ks is not None:
        kw = kw.float() * gather(ks)
        vw = vw.float() * gather(vs)
    kvp = torch.arange(kw.shape[1], device=q.device)
    mask = (kvp[None, None] <= q_pos[:, :, None])[:, None]  # (B, 1, C, L)
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), kw.transpose(1, 2), vw.transpose(1, 2), attn_mask=mask,
        enable_gqa=True)
    return out.transpose(1, 2)


def _attn_bound(q, k, tables, q_pos, quantized):
    """Kernel 11's least time: bytes are the live K/V window (blocks up to
    each row's last query) plus q, out, tables and positions; operations
    4 D per (query head, attended position), q.k and p.v multiply-adds, on
    the CUDA cores. -> (bound_ms, "bytes" | "operations")."""
    hq, d = q.shape[2], q.shape[3]
    _, bs, hkv, _ = k.shape
    qp = q_pos.cpu().numpy()
    live_blocks = int(sum(int(r.max()) // bs + 1 for r in qp))
    per_pos = hkv * d * k.element_size() + (hkv * 4 if quantized else 0)
    nbytes = (2 * live_blocks * bs * per_pos + 2 * q.numel() * 4 + tables.numel() * 4
              + q_pos.numel() * 4)
    ops = 4.0 * d * hq * float((qp + 1).sum())
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# kernel 11's cases: (name, B, C, T, last positions): decode, a prefill
# chunk and the speculative verify at max_len / block = 8 table entries a
# row, anywhere in it; a drain-like decode (the smoke drain's rows hold 3-35
# positions: 1-3 live blocks); a long decode at T = 64 (max_len 1024), every
# row near its end, where the K/V bytes and not the latency set the bound
ATTN_CASES = [("decode", N_SLOTS, 1, MAX_LEN // BLOCK, None),
              ("chunk", 1, CHUNK, MAX_LEN // BLOCK, None),
              ("verify", N_SLOTS, SPEC_K, MAX_LEN // BLOCK, None),
              ("drain", N_SLOTS, 1, MAX_LEN // BLOCK, (3, 36)),
              ("long", N_SLOTS, 1, 1024 // BLOCK, (1000, 1023))]


def phase_paged(torch, np, dev, flush):
    """Kernel 11 against its plain version at ``ATTN_CASES``, fp32 and int8
    pools, within ATTN_TOL, a second call equal bit for bit; its plan, its
    time, the plain version's, the gather + SDPA yardstick's and the bound."""
    from repro_torch.kernels import paged_attn as pa
    from repro_torch.kernels.paged_attn import paged_attn_kernel_call
    from repro_torch.kernels.ref import paged_attention_ref

    rng = np.random.default_rng(SEED + 1)
    rows = []
    for name, b, c, t, last_range in ATTN_CASES:
        for quantized in (False, True):
            q, k, v, tables, q_pos, ks, vs = _paged_case(torch, np, rng, dev, b, c, t,
                                                         quantized, last_range=last_range)
            got = paged_attn_kernel_call(q, k, v, tables, q_pos, k_scale=ks, v_scale=vs)
            again = paged_attn_kernel_call(q, k, v, tables, q_pos, k_scale=ks, v_scale=vs)
            torch.cuda.synchronize()
            want = paged_attention_ref(q, k, v, tables, q_pos, ks, vs)
            err = float((got - want).abs().max())
            if not err <= ATTN_TOL:
                fail(f"paged_attn {name} int8={quantized}: max |kernel - plain| = {err}")
            if not _bits_equal(torch, got, again):
                fail(f"paged_attn {name} int8={quantized}: two calls differ")
            lib = _sdpa_yardstick(torch, q, k, v, tables, q_pos, ks, vs)
            lib_err = float((lib - want).abs().max())
            hq, d = q.shape[2], q.shape[3]
            bs, hkv = k.shape[1], k.shape[2]
            plan = pa.card_plan(b, c, hq, hkv, d, bs, t)
            if plan is None or plan[:2] != pa.attn_plan(b, c, hq, hkv, d, bs, t):
                fail(f"paged_attn {name}: the kernel's plan {plan} is not attn_plan's")
            row = {"case": name, "B": b, "C": c, "T": t, "int8": quantized,
                   "max_abs_err": err, "library_err": lib_err, "repeatable": True,
                   "plan": {"q_tile": plan[0], "splits": plan[1], "smem_bytes": plan[2],
                            "threads": plan[3]},
                   "last_positions": [int(r.max()) for r in q_pos.cpu().numpy()]}
            row["ms"] = time_ms(torch, lambda: paged_attn_kernel_call(
                q, k, v, tables, q_pos, k_scale=ks, v_scale=vs), flush=flush)
            row["warm_ms"] = time_ms(torch, lambda: paged_attn_kernel_call(
                q, k, v, tables, q_pos, k_scale=ks, v_scale=vs))
            row["plain_ms"] = time_ms(torch, lambda: paged_attention_ref(
                q, k, v, tables, q_pos, ks, vs), flush=flush)
            row["library_ms"] = time_ms(torch, lambda: _sdpa_yardstick(
                torch, q, k, v, tables, q_pos, ks, vs), flush=flush)
            row["bound_ms"], row["bound_by"] = _attn_bound(q, k, tables, q_pos, quantized)
            rows.append(row)
            print(f"[kernels] paged_attn {name} B={b} C={c} T={t} int8={quantized} plan "
                  f"q_tile={plan[0]} splits={plan[1]} ({plan[3]} threads, {plan[2]} B smem) "
                  f"max_abs_err={err:.3e} repeatable ms={row['ms']:.5f} "
                  f"warm_ms={row['warm_ms']:.5f} plain_ms={row['plain_ms']:.5f} "
                  f"library_ms={row['library_ms']:.5f} bound_ms={row['bound_ms']:.6f} "
                  f"({row['bound_by']})")
    return rows


def phase_attn_sweep(torch, np, dev, flush):
    """Kernel 11 at every query tile (1, 2, 4, 8, 16 tokens) for the chunk
    and the verify, and at clusters of 1, 2, 4, 8 and 16 (non-portable)
    ranks for the decodes, fp32, L2 flushed, each call held within
    ATTN_TOL: the times behind attn_plan's QTILE and SPLITS. Returns the
    rows."""
    from repro_torch.kernels import paged_attn as pa
    from repro_torch.kernels.paged_attn import paged_attn_kernel_call
    from repro_torch.kernels.ref import paged_attention_ref

    rng = np.random.default_rng(SEED + 19)
    rows = []
    for name, b, c, t, last_range in ATTN_CASES:
        q, k, v, tables, q_pos, _, _ = _paged_case(torch, np, rng, dev, b, c, t, False,
                                                   last_range=last_range)
        want = paged_attention_ref(q, k, v, tables, q_pos)
        hq, d = q.shape[2], q.shape[3]
        bs, hkv = k.shape[1], k.shape[2]
        chosen = pa.attn_plan(b, c, hq, hkv, d, bs, t)
        plans = ([(qt, chosen[1]) for qt in (1, 2, 4, 8, 16) if qt <= c] if c > 1 else
                 [(1, s) for s in (1, 2, 4, 8, 16) if s <= t])
        line = []
        for plan in plans:
            try:
                got = paged_attn_kernel_call(q, k, v, tables, q_pos, plan=plan)
            except RuntimeError as e:  # a cluster the card cannot place
                line.append(f"{plan}: refused ({e})")
                rows.append({"case": name, "plan": list(plan), "refused": str(e)})
                continue
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not err <= ATTN_TOL:
                fail(f"paged_attn sweep {name} plan {plan}: max |kernel - plain| = {err}")
            ms = time_ms(torch, lambda: paged_attn_kernel_call(q, k, v, tables, q_pos,
                                                               plan=plan), flush=flush)
            rows.append({"case": name, "plan": list(plan), "ms": ms, "max_abs_err": err,
                         "planned": plan == chosen})
            line.append(f"{plan}{'*' if plan == chosen else ''} {ms:.5f}")
        print(f"[attn-sweep] {name} B={b} C={c} T={t} (q_tile, splits) ms, * = plan: "
              + "; ".join(line))
    return rows


def _window_clear(torch, x, w, beta, rows=8):
    """(dx_keep (M, K), dw_keep (K, N)): gradient elements whose reduction
    touches no pre-activation within WINDOW_EPS of |pre| = 1."""
    dx_keep = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    dw_keep = torch.ones(w.shape, dtype=torch.bool, device=x.device)
    for a in range(0, x.shape[0], rows):
        near = ((x[a:a + rows, :, None] * w[None] + beta[None]).abs() - 1.0).abs() <= WINDOW_EPS
        dx_keep[a:a + rows] = ~near.any(dim=2)
        dw_keep &= ~near.any(dim=0)
    return dx_keep, dw_keep


def _close_err(torch, got, want, keep, tol=TRAIN_TOL, rtol=None):
    """max |got - want| over kept elements, and whether every kept element
    is within tol + rtol * |want| (rtol None: tol)."""
    d = torch.where(keep, (got - want).abs(), 0)
    ok = bool((d <= tol + (tol if rtol is None else rtol) * want.abs()).all())
    return float(d.max()), ok


def _m_tol(m):
    """(atol, rtol) of a gradient summed over M rows (dw, dbeta; the
    SignSTE dw): TRAIN_TOL for both up to STE_RANGE rows, the reference's
    bound for a short sum. Above, kernels 3-5 sum M in ranges of STE_RANGE
    rows and add the ranges' sums: each range's sum is held to an absolute
    TRAIN_TOL and the ranges' independent roundings add as the square root
    of their count, so atol = TRAIN_TOL * sqrt(M / STE_RANGE), with no
    relative term (one would grow with |dw|, not with the rounding, and at
    CNV's |dw| ~ 1e3 would let a lost pass of rows through; PERF.md §6,
    ``ste_accuracy.py``)."""
    if m <= STE_RANGE:
        return TRAIN_TOL, TRAIN_TOL
    return TRAIN_TOL * math.sqrt(-(-m // STE_RANGE)), 0.0


def _dyadic_operands(np, rng, m, k, n, sparse=False):
    """Training CAC operands on a dyadic grid (as
    ``tests/_torch_cases.cac_train_dyadic_case``): every product and sum of
    the forward and the STE backward exact in float32, many pre-activations
    exactly 0 or +-1: x and g multiples of 1/4 in [-2, 2], w in {+-0.5, +-1,
    +-2}, beta = -x' w; rows 1.. of x and columns 1.. of w take +0, -0,
    +inf, -inf, NaN (with ``sparse`` at one element each, x[1 + i, i] and
    w[i, 1 + i]: a non-finite x or w makes a whole row of dw or column of dx
    NaN), columns 2.. of beta all five."""
    special = (0.0, -0.0, np.inf, -np.inf, np.nan)
    x = (rng.integers(-8, 9, size=(m, k)) * 0.25).astype(np.float32)
    w = rng.choice(np.array([-2, -1, -0.5, 0.5, 1, 2], np.float32), size=(k, n))
    beta = -(rng.integers(-8, 9, size=(k, n)) * 0.25).astype(np.float32) * w
    g = (rng.integers(-8, 9, size=(m, n)) * 0.25).astype(np.float32)
    for i, v in enumerate(special):
        if 1 + i < m:
            x[1 + i, i % k if sparse else slice(None)] = v
        if 1 + i < n:
            w[i % k if sparse else slice(None), 1 + i] = v
        if 2 + i < n:
            beta[:, 2 + i] = v
    return x, w, beta.astype(np.float32), g


def _bits_equal(torch, a, b):
    """Equal bit for bit, any NaN matching any NaN at the same place."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(torch.where(na, 0, a).view(torch.int32),
                                               torch.where(nb, 0, b).view(torch.int32))


def _train_split_sweep(torch, cac, x, w, beta, g, flush):
    """Every plan kernels 2-5 could take, through the launchers (these
    launches are timing only, not counted): kernel 2 at every K split count
    of 1..8, kernels 5 and 3 at every cluster size of 1..min(16, N tiles),
    kernel 4 with 8 and with 4 columns a thread, one block an N tile (the
    plan's) and, for contrast, a half and a quarter as many blocks walking
    2 and 4 tiles. The times the plans in kernels/cac_matmul.py are checked
    against."""
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    dx, dw, db = torch.empty_like(x), torch.empty_like(w), torch.empty_like(w)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ops = (x.data_ptr(), w.data_ptr(), beta.data_ptr(), g.data_ptr())
    fwd = cac._train_lib("cac_train_fwd_launch")
    launchers = {"bwd": (cac._train_lib("cac_train_bwd_fused_launch"),
                         (dx.data_ptr(), dw.data_ptr(), db.data_ptr())),
                 "dx": (cac._train_lib("cac_train_bwd_dx_launch"), (dx.data_ptr(),))}
    dw_launch = cac._train_lib("cac_train_bwd_dw_launch")
    slices = -(-k // cac.TRAIN_FWD_SLICE)
    out = {"fwd": {}, "bwd": {}, "dx": {}, "dw": {}}
    for s in range(1, cac.TRAIN_MAX_SPLITS + 1):
        if s > slices or -(-slices // -(-slices // s)) != s:
            continue
        launch = lambda: fwd(x.data_ptr(), w.data_ptr(), beta.data_ptr(), y.data_ptr(), m, n, k,
                             s, stream)
        if launch() != 0:
            fail(f"cac_train_fwd launcher refused {s} splits at M={m} K={k} N={n}")
        out["fwd"][s] = time_ms(torch, launch, flush=flush)
    for key, (fn, outs) in launchers.items():
        for c in range(1, min(cac.TRAIN_BWD_MAX_CLUSTER, -(-n // cac.TRAIN_BWD_TILE[1])) + 1):
            launch = lambda: fn(*ops, *outs, m, n, k, c, stream)
            if launch() != 0:
                fail(f"cac_train_bwd {key} launcher refused a cluster of {c} at M={m} K={k} N={n}")
            out[key][c] = time_ms(torch, launch, flush=flush)
    for nt in (8, 4):
        tiles = -(-n // (8 * nt))
        for parts in sorted({tiles, -(-tiles // 2), -(-tiles // 4)}, reverse=True):
            launch = lambda: dw_launch(*ops, dw.data_ptr(), db.data_ptr(), m, n, k, nt, parts,
                                       stream)
            if launch() != 0:
                fail(f"cac_train_bwd_dw launcher refused nt {nt}, {parts} parts at M={m} K={k} "
                     f"N={n}")
            out["dw"][f"{nt}x{parts}"] = time_ms(torch, launch, flush=flush)
    torch.cuda.synchronize()
    print(f"[kernels] cac_train M={m} K={k} N={n} plan sweep ms: fwd by K split "
          + ", ".join(f"{s}: {t:.5f}" for s, t in out["fwd"].items()) + "; fused bwd by cluster "
          + ", ".join(f"{c}: {t:.5f}" for c, t in out["bwd"].items()) + "; dx by cluster "
          + ", ".join(f"{c}: {t:.5f}" for c, t in out["dx"].items()) + "; dw by columns a "
          "thread x blocks a K tile " + ", ".join(f"{c}: {t:.5f}" for c, t in out["dw"].items()))
    return out


def phase_train_kernels(torch, np, dev, flush):
    """Kernels 2-5 against their plain versions: forward bit-exact; dx, dw,
    dbeta of the fused kernel and of the split pair within TRAIN_TOL of the
    plain fused backward and of each other, off the |pre| = 1 window edge,
    and a second launch of each of kernels 3-5 equal bit for bit; whether
    the split pair equals kernel 5 bit for bit, printed (both sum in kernel
    5's order, kernel 3 at kernel 5's cluster size); on the
    dyadic grid (``_dyadic_operands``) at q/o and the ragged shapes, the
    forward and both backwards bit-equal to their plain versions. Inputs as the
    reference's kernel tests draw them (x, g ~ N(0, 1); w, beta ~ N(0,
    0.25)). Timed at the path's shapes, with each launch's plan and a sweep
    of the split counts. Operations per (m, k, n) as the bound counts them
    (the kernels issue fewer instructions; PERF.md):
    4 in the forward (mul, add, compare, count), 6 for dx (mul, add,
    abs-compare, select, multiply-add), 7 for dw+dbeta (the same, a
    multiply-add and an add), 9 fused; the CUDA-core rate stands in for
    them. Library call: none (no single PyTorch call computes Sign(x w +
    beta) summed over K)."""
    from repro_torch.kernels import cac_matmul as cac

    fwd_blocks, bwd_blocks, dx_blocks, dw_blocks = (
        cac._train_lib(f"cac_train_{nm}_max_blocks") for nm in ("fwd", "bwd_fused", "bwd_dx",
                                                                 "bwd_dw"))
    m0 = TRAIN_SHAPES[0][0]
    clusters = range(1, cac.TRAIN_BWD_MAX_CLUSTER + 1)
    print(f"[kernels] cac_train occupancy (blocks resident): fwd by split "
          f"{[fwd_blocks(s) for s in range(1, cac.TRAIN_MAX_SPLITS + 1)]}; at M={m0}: fused bwd "
          f"by cluster {[bwd_blocks(c, m0) for c in clusters]}, dx (kernel 3) by cluster "
          f"{[dx_blocks(c, m0) for c in clusters]}, dw (kernel 4) with 8 and 4 columns a thread "
          f"{[dw_blocks(nt, m0) for nt in (8, 4)]}")
    rng = np.random.default_rng(SEED + 2)
    rows = []
    for m, k, n in TRAIN_SHAPES + TRAIN_RAGGED:
        x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
        w = torch.from_numpy((rng.normal(size=(k, n)) * 0.5).astype(np.float32)).to(dev)
        beta = torch.from_numpy((rng.normal(size=(k, n)) * 0.5).astype(np.float32)).to(dev)
        g = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)).to(dev)
        y = cac.cac_train_fwd_call(x, w, beta)
        fused = cac.cac_train_bwd_fused_call(x, w, beta, g)
        split = (cac.cac_train_bwd_dx_call(x, w, beta, g),) + cac.cac_train_bwd_dw_call(
            x, w, beta, g)
        torch.cuda.synchronize()
        fwd_err = float((y - cac.cac_train_fwd_plain(x, w, beta)).abs().max())
        if fwd_err != 0.0:
            fail(f"cac_train_fwd M={m} K={k} N={n}: max |kernel - plain| = {fwd_err} "
                 f"(must be 0)")
        plain = cac.cac_train_bwd_fused_plain(x, w, beta, g)
        dx_keep, dw_keep = _window_clear(torch, x, w, beta)
        index = dev.index or 0
        row = {"M": m, "K": k, "N": n, "fwd_max_abs_err": fwd_err,
               "left_out": {"dx": int((~dx_keep).sum()), "dw": int((~dw_keep).sum())},
               "fwd_splits": cac.card_train_fwd_plan(index, m, k, n)[0],
               "bwd_cluster": cac.card_train_bwd_plan(index, m, k, n),
               "dw_plan": cac.card_train_bwd_dw_plan(index, m, k, n),
               "split_equals_fused": {name: _bits_equal(torch, a, b) for name, a, b in
                                      zip(("dx", "dw", "dbeta"), split, fused)}}
        again = (cac.cac_train_bwd_fused_call(x, w, beta, g),
                 (cac.cac_train_bwd_dx_call(x, w, beta, g),) + cac.cac_train_bwd_dw_call(
                     x, w, beta, g))
        for which, first, second in zip(("fused", "split"), (fused, split), again):
            for name, a, b in zip(("dx", "dw", "dbeta"), first, second):
                if not _bits_equal(torch, a, b):
                    fail(f"cac_train_bwd {which} M={m} K={k} N={n}: {name} differs between two "
                         f"launches (must repeat bit for bit)")
        if (m, k, n) in TRAIN_DYADIC:
            xd, wd, bd, _ = (torch.from_numpy(a).to(dev) for a in _dyadic_operands(np, rng, m, k, n))
            if not _bits_equal(torch, cac.cac_train_fwd_call(xd, wd, bd),
                               cac.cac_train_fwd_plain(xd, wd, bd)):
                fail(f"cac_train_fwd M={m} K={k} N={n}: differs from plain on the dyadic grid")
            xd, wd, bd, gd = (torch.from_numpy(a).to(dev)
                              for a in _dyadic_operands(np, rng, m, k, n, sparse=True))
            want = cac.cac_train_bwd_fused_plain(xd, wd, bd, gd)
            for which, got in (("fused", cac.cac_train_bwd_fused_call(xd, wd, bd, gd)),
                               ("split", (cac.cac_train_bwd_dx_call(xd, wd, bd, gd),)
                                + cac.cac_train_bwd_dw_call(xd, wd, bd, gd))):
                for name, a, b in zip(("dx", "dw", "dbeta"), got, want):
                    if not _bits_equal(torch, a, b):
                        fail(f"cac_train_bwd {which} M={m} K={k} N={n}: {name} differs from "
                             f"plain on the dyadic grid (every product and sum there is exact)")
            row["dyadic_bit_exact"] = True
        for name, a, b, c, keep in zip(("dx", "dw", "dbeta"), fused, split, plain,
                                       (dx_keep, dw_keep, dw_keep)):
            for which, got, want in (("fused", a, c), ("split", b, c), ("fused-split", a, b)):
                err, ok = _close_err(torch, got, want, keep)
                row[f"{name}_{which}_max_abs_err"] = err
                if not ok:
                    fail(f"cac_train {which} {name} M={m} K={k} N={n}: beyond atol = rtol = "
                         f"{TRAIN_TOL} (max |diff| {err:.3e})")
        if (m, k, n) in TRAIN_SHAPES:
            timed = {
                "fwd": (lambda: cac.cac_train_fwd_call(x, w, beta),
                        lambda: cac.cac_train_fwd_plain(x, w, beta),
                        4, m * k + 2 * k * n + m * n),
                "bwd_fused": (lambda: cac.cac_train_bwd_fused_call(x, w, beta, g),
                              lambda: cac.cac_train_bwd_fused_plain(x, w, beta, g),
                              9, 2 * m * k + 4 * k * n + m * n),
                "bwd_dx": (lambda: cac.cac_train_bwd_dx_call(x, w, beta, g),
                           lambda: cac.cac_train_bwd_dx_plain(x, w, beta, g),
                           6, 2 * m * k + 2 * k * n + m * n),
                "bwd_dw": (lambda: cac.cac_train_bwd_dw_call(x, w, beta, g),
                           lambda: cac.cac_train_bwd_dw_plain(x, w, beta, g),
                           7, m * k + 4 * k * n + m * n),
            }
            for name, (kern, plain_fn, ops_per, n_floats) in timed.items():
                t_bytes = 4.0 * n_floats / HBM_BYTES_S * 1e3
                t_ops = float(ops_per) * m * k * n / CUDA_CORE_OPS_S * 1e3
                row[name] = {
                    "ms": time_ms(torch, kern, flush=flush),
                    "plain_ms": time_ms(torch, plain_fn, iters=3, warmup=1, flush=flush),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                }
            row["split_sweep"] = _train_split_sweep(torch, cac, x, w, beta, g, flush)
        rows.append(row)
        errs = " ".join(f"{nm}={row[nm + '_fused_max_abs_err']:.2e}" for nm in ("dx", "dw", "dbeta"))
        times = "".join(f" {nm} {row[nm]['ms']:.4f} ms (plain {row[nm]['plain_ms']:.3f}, bound "
                        f"{row[nm]['bound_ms']:.6f} {row[nm]['bound_by']})"
                        for nm in ("fwd", "bwd_fused", "bwd_dx", "bwd_dw") if nm in row)
        same = row["split_equals_fused"]
        print(f"[kernels] cac_train M={m} K={k} N={n}: fwd bit-exact (K split {row['fwd_splits']}"
              f"); bwd fused/split within {TRAIN_TOL} ({errs}; left out dx "
              f"{row['left_out']['dx']}, dw {row['left_out']['dw']}), fused and split "
              f"repeatable (cluster {row['bwd_cluster']}, fused and dx; dw (columns a thread, "
              f"blocks a K tile) {row['dw_plan']}); split == fused bit for "
              f"bit: {'yes' if all(same.values()) else same}"
              + ("; dyadic grid bit-exact" if row.get("dyadic_bit_exact") else "") + times)
    return rows


def _bnn_operands(np, rng, m, k, n):
    """x, g ~ N(0, 1), w ~ N(0, 0.25), float32, with about 2% of x and w
    exact +0.0, 2% exact -0.0 (Sign gives +1 for both) and 1% exact +-1 (on
    the inclusive STE window's edge)."""
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.5).astype(np.float32)
    for a in (x, w):
        u = rng.random(a.shape)
        a[u < 0.02] = 0.0
        a[(u >= 0.02) & (u < 0.04)] = -0.0
        edge = (u >= 0.04) & (u < 0.05)
        a[edge] = np.where(rng.random(int(edge.sum())) < 0.5, 1.0, -1.0)
    return x, w, rng.normal(size=(m, n)).astype(np.float32)


def _bound(nbytes, ops, rate):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_bnn_kernels(torch, np, dev, flush):
    """Kernels 6-9 against their plain versions on the card, at the serve
    path's decode shapes (M = n_slots: kernel 6 on int8 +-1 weights, kernel
    7 on packed planes), the training path's shapes (M = 512: kernel 6 on
    float32 weights, kernels 8 and 9) and three ragged shapes (all that
    apply).
    Forwards bit-exact, kernel 7 equal to kernel 6 on the same signs;
    backward within atol = rtol = TRAIN_TOL of the plain versions (summed in
    float64) on every element, and bit-for-bit repeatable. Bounds: bytes =
    each operand read once and the output written once; operations 2 M K N
    at the tensor cores' bf16 rate (every product has a +-1 factor). Beside
    the bound: the float32 CUDA-core figure for 2 M K N, and for the
    backward the 3 x 2 M K N its kernels spend (g in three bf16 planes).
    Library call: one torch.matmul on precomputed float32 +-1
    operands (sx @ sw for 6 and 7, g @ sw.T for 8, sx.T @ g for 9)."""
    from repro_torch.core.backend import pack_signs
    from repro_torch.core.ste import sign
    from repro_torch.kernels import bnn_matmul as bnn
    from repro_torch.kernels.cac_matmul import card_stream_plan

    occupancy = {f"{nm} {bn}": [bnn.card_max_blocks(dev.index or 0, nm == "dx", bn, s)
                                 for s in range(1, bnn.BWD_MAX_SPLITS + 1)]
                 for nm in ("dx", "dw") for bn in bnn.BWD_TILE_COLS}
    print(f"[bnn-kernels] resident blocks of kernels 8 (dx) and 9 (dw) by tile columns, in "
          f"clusters of 1..{bnn.BWD_MAX_SPLITS}: {occupancy}")
    rng = np.random.default_rng(SEED + 7)
    rows = []
    for m, k, n in BNN_SHAPES + BNN_RAGGED + BNN_PREFILL:
        x, w, g = (torch.from_numpy(a).to(dev) for a in _bnn_operands(np, rng, m, k, n))
        wb = sign(w).to(torch.int8)
        wp = pack_signs(wb) if k % 8 == 0 else None
        want = bnn.bnn_matmul_plain(x, w)
        got = {"f32": bnn.bnn_matmul_kernel_call(x, w), "int8": bnn.bnn_matmul_kernel_call(x, wb)}
        for route in ("stream", "tc"):  # both routes of kernel 6, whichever the plan takes
            got[f"f32 {route}"] = bnn.bnn_matmul_kernel_call(x, w, route=route)
            got[f"int8 {route}"] = bnn.bnn_matmul_kernel_call(x, wb, route=route)
        again = bnn.bnn_matmul_kernel_call(x, w)
        if wp is not None:
            got["packed"] = bnn.bnn_packed_matmul_kernel_call(x, wp)
            again_packed = bnn.bnn_packed_matmul_kernel_call(x, wp)
        torch.cuda.synchronize()
        for name, y in got.items():
            if not torch.equal(y, want):
                fail(f"bnn forward ({name} weights) M={m} K={k} N={n}: max |kernel - plain| = "
                     f"{float((y - want).abs().max())} (must be 0)")
        if not torch.equal(again, got["f32"]):
            fail(f"bnn forward M={m} K={k} N={n}: a second launch gave other values")
        if wp is not None and not (torch.equal(got["packed"], got["int8"]) and torch.equal(
                bnn.bnn_packed_matmul_plain(x, wp), want)):
            fail(f"bnn packed forward M={m} K={k} N={n}: kernel 7 != kernel 6")
        if wp is not None and not torch.equal(again_packed, got["packed"]):
            fail(f"bnn packed forward M={m} K={k} N={n}: a second launch gave other values")
        row = {"M": m, "K": k, "N": n, "fwd_max_abs_err": 0.0,
               "fwd_plan": {str(t.dtype)[6:]: list(bnn._card_fwd_plan(x.device.index, m, k, n,
                                                                         t.dtype))
                            for t in (w, wb)}}
        if wp is not None:
            row["fwd_plan"]["packed"] = ["stream"] + list(card_stream_plan(
                x.device.index, m, k, n, "bnn_matmul", "packed_max_blocks", bnn.PACKED_MT))
        train = m > 32
        if train:
            dx, dw = bnn.bnn_bwd_dx_call(x, w, g), bnn.bnn_bwd_dw_call(x, w, g)
            again = (bnn.bnn_bwd_dx_call(x, w, g), bnn.bnn_bwd_dw_call(x, w, g))
            torch.cuda.synchronize()
            if not (torch.equal(dx, again[0]) and torch.equal(dw, again[1])):
                fail(f"bnn backward M={m} K={k} N={n}: a second launch gave other values")
            keep = torch.ones((), dtype=torch.bool, device=dev)  # every element is held
            for name, kern, plain in (("dx", dx, bnn.bnn_bwd_dx_plain(x, w, g)),
                                      ("dw", dw, bnn.bnn_bwd_dw_plain(x, w, g))):
                err, ok = _close_err(torch, kern, plain, keep)
                row[f"{name}_max_abs_err"] = err
                if not ok:
                    fail(f"bnn backward {name} M={m} K={k} N={n}: beyond atol = rtol = "
                         f"{TRAIN_TOL} (max |diff| {err:.3e})")
            row["on_window_edge"] = {"x": int((x.abs() == 1).sum()), "w": int((w.abs() == 1).sum())}
            # (tile columns, splits, steps a split) of each launch
            row["bwd_plan"] = {nm: list(bnn._card_plan(x.device.index, m, k, n, nm == "dx"))
                               for nm in ("dx", "dw")}
        if (m, k, n) in BNN_SHAPES + BNN_PREFILL:
            xs, ws = sign(x), sign(w)
            ops = 2.0 * m * k * n
            t_cuda_core = ops / CUDA_CORE_OPS_S * 1e3
            if train:
                timed = {
                    "fwd_f32": (lambda: bnn.bnn_matmul_kernel_call(x, w),
                                lambda: bnn.bnn_matmul_plain(x, w),
                                lambda: torch.matmul(xs, ws),
                                4 * (m * k + k * n + m * n)),
                    "bwd_dx": (lambda: bnn.bnn_bwd_dx_call(x, w, g),
                               lambda: bnn.bnn_bwd_dx_plain(x, w, g),
                               lambda: torch.matmul(g, ws.T),
                               4 * (2 * m * k + k * n + m * n)),
                    "bwd_dw": (lambda: bnn.bnn_bwd_dw_call(x, w, g),
                               lambda: bnn.bnn_bwd_dw_plain(x, w, g),
                               lambda: torch.matmul(xs.T, g),
                               4 * (m * k + 2 * k * n + m * n)),
                }
            else:
                timed = {
                    "fwd_int8": (lambda: bnn.bnn_matmul_kernel_call(x, wb),
                                 lambda: bnn.bnn_matmul_plain(x, wb),
                                 lambda: torch.matmul(xs, ws),
                                 4 * m * k + k * n + 4 * m * n),
                }
                if wp is not None:
                    timed["fwd_packed"] = (lambda: bnn.bnn_packed_matmul_kernel_call(x, wp),
                                           lambda: bnn.bnn_packed_matmul_plain(x, wp),
                                           lambda: torch.matmul(xs, ws),
                                           4 * m * k + k * n // 8 + 4 * m * n)
            for name, (kern, plain, lib, nbytes) in timed.items():
                bound, by = _bound(nbytes, ops, TENSOR_CORE_OPS_S)
                row[name] = {"ms": time_ms(torch, kern, flush=flush),
                             "plain_ms": time_ms(torch, plain, iters=5, flush=flush),
                             "library_ms": time_ms(torch, lib, flush=flush),
                             "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                             "ops_cuda_core_ms": t_cuda_core}
                row[name]["bound_share"] = bound / row[name]["ms"]
                if name.startswith("bwd"):
                    row[name]["ops_three_planes_ms"] = BWD_PLANES * ops / TENSOR_CORE_OPS_S * 1e3
        rows.append(row)
        errs = ("" if not train else f"; backward dx {row['dx_max_abs_err']:.2e} dw "
                f"{row['dw_max_abs_err']:.2e} (atol = rtol = {TRAIN_TOL}, every element held: "
                f"0 left out; {row['on_window_edge']['x']} x and {row['on_window_edge']['w']} w "
                f"exactly on |v| = 1), repeatable; plans (tile columns, splits, steps) dx "
                f"{row['bwd_plan']['dx']} dw {row['bwd_plan']['dw']}")
        times = "".join(f" {nm} {row[nm]['ms']:.5f} ms (plain {row[nm]['plain_ms']:.4f}, "
                        f"library {row[nm]['library_ms']:.5f}, bound {row[nm]['bound_ms']:.6f} "
                        f"{row[nm]['bound_by']}"
                        + (f"; 3 planes {row[nm]['ops_three_planes_ms']:.6f}"
                           if "ops_three_planes_ms" in row[nm] else "") + ")"
                        for nm in ("fwd_int8", "fwd_packed", "fwd_f32", "bwd_dx", "bwd_dw")
                        if nm in row)
        print(f"[bnn-kernels] M={m} K={k} N={n}: forward bit-exact (float32, int8, both routes"
              f"{', packed = kernel 6' if wp is not None else ''}), repeatable; plans "
              f"{row['fwd_plan']}{errs}{times}")
    return rows


def phase_route_sweep(torch, np, dev, flush):
    """Kernel 6 on both routes (bit-exact) at ROUTE_SWEEP_M rows, gate/up
    and down, float32 and int8 weights: device ms per launch, L2 flushed.
    The route thresholds (kernels/bnn_matmul.py FWD_STREAM_MAX_M, by weight
    dtype) are set from these times: the largest M where the streaming
    route is the faster at both projections."""
    from repro_torch.core.ste import sign
    from repro_torch.kernels import bnn_matmul as bnn

    rng = np.random.default_rng(SEED + 9)
    sweep = []
    for k, n in ((960, 2560), (2560, 960)):
        for m in ROUTE_SWEEP_M:
            x, w, _ = (torch.from_numpy(a).to(dev) for a in _bnn_operands(np, rng, m, k, n))
            want = bnn.bnn_matmul_plain(x, w)
            entry = {"M": m, "K": k, "N": n}
            for kind, wt in (("int8", sign(w).to(torch.int8)), ("f32", w)):
                for route in ("stream", "tc"):
                    if not torch.equal(bnn.bnn_matmul_kernel_call(x, wt, route=route), want):
                        fail(f"bnn forward route sweep M={m} K={k} N={n} {kind} {route}: "
                             f"not bit-exact")
                    entry[f"{kind}_{route}_ms"] = time_ms(
                        torch, lambda: bnn.bnn_matmul_kernel_call(x, wt, route=route),
                        flush=flush)
            sweep.append(entry)
            print(f"[bnn-kernels] route sweep M={m} K={k} N={n} (ms; streams up to M = "
                  f"{bnn.FWD_STREAM_MAX_M[torch.int8]} int8, "
                  f"{bnn.FWD_STREAM_MAX_M[torch.float32]} float32): "
                  + ", ".join(f"{key[:-3]} {val:.5f}" for key, val in entry.items()
                              if key.endswith("_ms")))
    return sweep


def _qnn_operands(np, rng, m, k, n):
    """Kernel 10's operands (as ``tests/_torch_cases.qnn_case``): x int8
    codes over -128..127, w int8 in -127..127 with both extremes, per-column
    float32 scales, column 1 all zero in w at the 1e-12 scale floor; x row
    0 all -128 and w column 0 all -127, so one sum reaches K * 128 * 127
    (past 2^24 at K = 2560)."""
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    w = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    x.flat[:2] = (-128, 127)
    w.flat[:2] = (-127, 127)
    ws = rng.uniform(1e-3, 1e-2, size=(n,)).astype(np.float32)
    w[:, 1] = 0
    ws[1] = 1e-12
    x[0], w[:, 0] = -128, -127
    return x, w, ws


def _int_mm_yardstick(torch, x, w, ws):
    """One cuBLASLt int8 product (``torch._int_mm``, int32 out) and the same
    dequant. ``_int_mm`` wants M > 16: a smaller M is zero-padded to 32 rows
    (the pad is timed too). Timed here only; the port never calls it."""
    m = x.shape[0]
    xs = torch.full((), ACT_SCALE, dtype=torch.float32, device=x.device)

    def run():
        xin = x if m > 16 else torch.cat([x, x.new_zeros((32 - m, x.shape[1]))])
        return torch._int_mm(xin, w)[:m].to(torch.float32) * (ws.reshape(1, -1) * xs)

    return run, ("M=%d" % m if m > 16 else "M=%d zero-padded to 32" % m)


def phase_device_ops(torch, np, dev, tries=3):
    """The device operations (kernels, memsets, copies) of one call each of
    kernel 10 (stream route), kernel 7 and, for contrast, kernel 10's tile
    route, at decode gate/up, of kernel 11 at decode and at a prefill chunk,
    and of kernels 3 and 4 at train gate/up, from one torch.profiler trace
    (kept under build/profile/, gitignored): each call is synchronised, so
    its operations lie between the previous call's and the next one's. All
    but the tile route must be one kernel each, no memset; the tile route
    splits K at decode and so shows its memset. A trace with no device
    event at all is taken again, up to ``tries`` times. Returns {call: [op
    names]}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.backend import pack_signs
    from repro_torch.core.ste import sign
    from repro_torch.kernels import bnn_matmul as bnn
    from repro_torch.kernels import cac_matmul as cac
    from repro_torch.kernels import qnn_matmul as qnn
    from repro_torch.kernels.paged_attn import paged_attn_kernel_call

    rng = np.random.default_rng(SEED + 17)
    x, w, ws = (torch.from_numpy(a).to(dev) for a in _qnn_operands(np, rng, N_SLOTS, 960, 2560))
    xf, wf, _ = (torch.from_numpy(a).to(dev)
                 for a in _bnn_operands(np, rng, N_SLOTS, 960, 2560))
    wp = pack_signs(sign(wf).to(torch.int8))
    attn = {name: _paged_case(torch, np, rng, dev, b, c, MAX_LEN // BLOCK, False)[:5]
            for name, b, c in (("decode", N_SLOTS, 1), ("chunk", 1, CHUNK))}
    m, k, n = TRAIN_SHAPES[2]  # train gate/up
    xt, gt = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
              for s in ((m, k), (m, n)))
    wt, bt = (torch.from_numpy((rng.normal(size=(k, n)) * 0.5).astype(np.float32)).to(dev)
              for _ in range(2))
    calls = {"qnn_matmul stream": lambda: qnn.qnn_matmul_kernel_call(x, w, ws, ACT_SCALE),
             "bnn_packed_matmul": lambda: bnn.bnn_packed_matmul_kernel_call(xf, wp),
             "qnn_matmul tile": lambda: qnn.qnn_matmul_kernel_call(x, w, ws, ACT_SCALE,
                                                                   route="tile"),
             "paged_attn decode": lambda: paged_attn_kernel_call(*attn["decode"]),
             "paged_attn chunk": lambda: paged_attn_kernel_call(*attn["chunk"]),
             "cac_train_bwd_dx": lambda: cac.cac_train_bwd_dx_call(xt, wt, bt, gt),
             "cac_train_bwd_dw": lambda: cac.cac_train_bwd_dw_call(xt, wt, bt, gt)}
    for fn in calls.values():  # built and planned outside the trace
        fn()
    torch.cuda.synchronize()
    out_dir = os.path.join(ROOT, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, "one_call.json")
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for fn in calls.values():
                fn()
                torch.cuda.synchronize()
        prof.export_chrome_trace(trace_path)
        with open(trace_path) as fh:
            events = json.load(fh).get("traceEvents", [])
        ops = sorted((float(e["ts"]), e["name"]) for e in events if e.get("ph") == "X"
                     and e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy"))
        if ops:
            break
        print(f"[device-ops] trace {attempt} holds no device event; taking it again")
    else:
        fail(f"the profiler recorded no device event in {tries} traces")
    # the calls ran in order, each synchronised: split the ordered operations
    # by kernel name (the tile route's memset precedes its kernel)
    result, rest = {}, [name for _, name in ops]
    for key, marker in (("qnn_matmul stream", "qnn_stream_kernel"),
                        ("bnn_packed_matmul", "stream_kernel<3,"),
                        ("qnn_matmul tile", "qnn_kernel<"),
                        ("paged_attn decode", "paged_attn_kernel"),
                        ("paged_attn chunk", "paged_attn_kernel"),
                        ("cac_train_bwd_dx", "cac_train_bwd_dx_kernel"),
                        ("cac_train_bwd_dw", "cac_train_bwd_dw_kernel")):
        end = next((i for i, name in enumerate(rest) if marker in name), None)
        if end is None:
            fail(f"device ops: no {marker} kernel in the trace: {rest}")
        result[key], rest = rest[:end + 1], rest[end + 1:]
    print("[device-ops] one call (decode gate/up; attention at decode and a chunk; kernels 3 "
          "and 4 at train gate/up): "
          + "; ".join(f"{k} {len(v)} ({', '.join(n[:40] for n in v)})"
                      for k, v in result.items()))
    for key in ("qnn_matmul stream", "bnn_packed_matmul", "paged_attn decode",
                "paged_attn chunk", "cac_train_bwd_dx", "cac_train_bwd_dw"):
        if len(result[key]) != 1:
            fail(f"{key}: one call ran {len(result[key])} device operations: {result[key]}")
    return result


def _qnn_split_sweep(torch, x, w, ws, flush):
    """Kernel 10's stream route at every split count its plan could take
    (the same row tile), bit-exact against its planned launch, device ms
    each: the data behind stream_plan's rule for this kernel."""
    from repro_torch.kernels import cac_matmul as cac
    from repro_torch.kernels import qnn_matmul as qnn

    m, k = x.shape
    n = w.shape[1]
    _, mt, _, _ = qnn.qnn_plan(m, k, n)
    groups = -(-k // cac.STREAM_GROUP)
    want = qnn.qnn_matmul_kernel_call(x, w, ws, ACT_SCALE)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    launch = qnn._lib("qnn_stream_launch", qnn._STREAM_ARGS)
    out = {}
    for s in range(1, cac.STREAM_MAX_SPLITS + 1):
        per = -(-groups // s)
        if -(-groups // per) != s:
            continue
        args = (x.data_ptr(), w.data_ptr(), ws.data_ptr(), ACT_SCALE, y.data_ptr(), m, n, k, mt,
                s, per, stream)
        if launch(*args) != 0:
            fail(f"qnn_matmul M={m} K={k} N={n}: the stream launch refused {s} splits")
        torch.cuda.synchronize()
        if not torch.equal(y, want):
            fail(f"qnn_matmul M={m} K={k} N={n}: {s} splits gave other values")
        out[s] = time_ms(torch, lambda: launch(*args), flush=flush)
    return out


def phase_qnn_kernels(torch, np, dev, flush):
    """Kernel 10 against its plain version on the card, on both routes
    (stream, tile) and on the planned one: bit-exact (an exact int32 sum and
    the same two float32 roundings) and repeated bit for bit, at the path's
    (K, N) for M = 4, 16, 32 and 512 and at three ragged shapes, extreme
    codes included; each shape's plan printed. Times both routes, the plain
    version (a float64 product, exact) and ``torch._int_mm`` with the same
    dequant (cuBLASLt; M = 4 and 16 zero-padded to 32). Bound: bytes = x, w,
    w_scale read once and y written once, over 3.35 TB/s; operations 2 M K N
    over the int8 tensor-core peak (1,979 TOPS); the larger. At decode and M
    = 32 the stream route at every split count (``_qnn_split_sweep``).
    Returns the rows."""
    from repro_torch.kernels import qnn_matmul as qnn

    rng = np.random.default_rng(SEED + 11)
    rows = []
    for m, k, n in QNN_SHAPES + QNN_RAGGED:
        x, w, ws = (torch.from_numpy(a).to(dev) for a in _qnn_operands(np, rng, m, k, n))
        got = {route: qnn.qnn_matmul_kernel_call(x, w, ws, ACT_SCALE, route=route)
               for route in (None, "stream", "tile")}
        again = {route: qnn.qnn_matmul_kernel_call(x, w, ws, ACT_SCALE, route=route)
                 for route in got}
        torch.cuda.synchronize()
        want = qnn.qnn_matmul_plain(x, w, ws, ACT_SCALE)
        for route, y in got.items():
            if not torch.equal(y, want):
                fail(f"qnn_matmul M={m} K={k} N={n} route {route or 'planned'}: max |kernel - "
                     f"plain| = {float((y - want).abs().max())} (must be 0)")
            if not torch.equal(again[route], y):
                fail(f"qnn_matmul M={m} K={k} N={n} route {route or 'planned'}: a second "
                     f"launch gave other values")
        plan = qnn._card_plan(x.device.index, m, k, n)
        row = {"M": m, "K": k, "N": n, "max_abs_err": 0.0, "plan": list(plan)}
        if (m, k, n) in QNN_SHAPES:
            lib, lib_shape = _int_mm_yardstick(torch, x, w, ws)
            row["library_err"] = float((lib() - want).abs().max())
            row["library_shape"] = lib_shape
            row["ms"] = time_ms(torch, lambda: qnn.qnn_matmul_kernel_call(x, w, ws, ACT_SCALE),
                                flush=flush)
            for route in ("stream", "tile"):
                row[f"{route}_ms"] = time_ms(
                    torch, lambda: qnn.qnn_matmul_kernel_call(x, w, ws, ACT_SCALE, route=route),
                    flush=flush)
            row["plain_ms"] = time_ms(torch, lambda: qnn.qnn_matmul_plain(x, w, ws, ACT_SCALE),
                                      iters=5, flush=flush)
            row["library_ms"] = time_ms(torch, lib, flush=flush)
            row["bound_ms"], row["bound_by"] = _bound(m * k + k * n + 4 * n + 4 * m * n,
                                                      2.0 * m * k * n, INT8_TENSOR_OPS_S)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            if m in (N_SLOTS, 32):
                row["ms_by_splits"] = _qnn_split_sweep(torch, x, w, ws, flush)
        rows.append(row)
        print(f"[qnn8-kernels] qnn_matmul M={m} K={k} N={n} bit-exact on both routes, "
              f"repeatable; plan {row['plan']}"
              + (f" ms={row['ms']:.5f} (stream {row['stream_ms']:.5f}, tile "
                 f"{row['tile_ms']:.5f}) plain_ms={row['plain_ms']:.5f} library_ms="
                 f"{row['library_ms']:.5f} ({row['library_shape']}, max |lib - plain| "
                 f"{row['library_err']:.1e}) bound_ms={row['bound_ms']:.6f} ({row['bound_by']}, "
                 f"{100 * row['bound_share']:.2f}%)" if "ms" in row else "")
              + ("; stream ms by split count " + ", ".join(
                  f"{sp} {t:.5f}" for sp, t in row["ms_by_splits"].items())
                 if "ms_by_splits" in row else ""))
    return rows


def phase_qnn_route_sweep(torch, np, dev, flush):
    """Kernel 10 on both routes (bit-exact) at ROUTE_SWEEP_M rows, gate/up
    and down: device ms per launch, L2 flushed. QNN_STREAM_MAX_M
    (kernels/qnn_matmul.py) is set from these times: the largest M where
    the stream route is the faster at both projections."""
    from repro_torch.kernels import qnn_matmul as qnn

    rng = np.random.default_rng(SEED + 13)
    sweep = []
    for k, n in ((960, 2560), (2560, 960)):
        for m in ROUTE_SWEEP_M:
            x, w, ws = (torch.from_numpy(a).to(dev) for a in _qnn_operands(np, rng, m, k, n))
            want = qnn.qnn_matmul_plain(x, w, ws, ACT_SCALE)
            entry = {"M": m, "K": k, "N": n}
            for route in ("stream", "tile"):
                if not torch.equal(qnn.qnn_matmul_kernel_call(x, w, ws, ACT_SCALE, route=route),
                                   want):
                    fail(f"qnn_matmul route sweep M={m} K={k} N={n} {route}: not bit-exact")
                entry[f"{route}_ms"] = time_ms(
                    torch, lambda: qnn.qnn_matmul_kernel_call(x, w, ws, ACT_SCALE, route=route),
                    flush=flush)
            sweep.append(entry)
            print(f"[qnn8-kernels] route sweep M={m} K={k} N={n} (ms; streams up to M = "
                  f"{qnn.QNN_STREAM_MAX_M}): stream {entry['stream_ms']:.5f}, tile "
                  f"{entry['tile_ms']:.5f}")
    return sweep


# ---------------------------------------------------------------------------
# phase 4: the serving path
# ---------------------------------------------------------------------------


def _requests(np, vocab):
    """8 requests: six of 3-11 tokens and two sharing a 16-token prefix
    (one full block of 16, so the second admission hits the prefix cache)."""
    from repro_torch.serve import Request

    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, vocab, int(rng.randint(3, 12))).astype(np.int32)
               for _ in range(6)]
    shared = rng.randint(0, vocab, 16).astype(np.int32)
    prompts += [np.concatenate([shared, rng.randint(0, vocab, 3).astype(np.int32)]),
                np.concatenate([shared, rng.randint(0, vocab, 5).astype(np.int32)])]
    return [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]


def _record_logits(eng, log):
    """Keep the first two prefill-chunk and decode logits of a paged
    engine's drain in ``log["prefill"]`` / ``log["decode"]`` (on the host)."""
    sched = eng.scheduler
    log.setdefault("prefill", [])
    log.setdefault("decode", [])

    def wrap(kind, fn):
        def call(*a, **kw):
            logits, cache = fn(*a, **kw)
            if len(log[kind]) < 2:
                log[kind].append(logits.detach().cpu().numpy())
            return logits, cache
        return call

    api = sched.api._replace(prefill_chunk=wrap("prefill", sched.api.prefill_chunk),
                             decode_paged=wrap("decode", sched.api.decode_paged))
    sched.api = sched.prefill.api = api


def _serve(np, train, arch, quantized, dev, count_launches=False, label=None,
           engine="paged", held=None, record=None, **spec):
    """One drain of the 8 requests through ``ServeEngine.from_trained`` (the
    train -> serve conversion runs each time, outside the timed drain);
    ``label`` names the drain in a profile; ``spec`` passes ``spec_draft``
    and ``spec_k`` (or the tracer, registry and profile_sample, or the
    mesh); ``held`` (a dict) gets the engine and the finished requests;
    ``record`` (a dict, paged engine) the first logits (``_record_logits``)."""
    import contextlib

    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine

    eng = ServeEngine.from_trained(train, arch, engine=engine, n_slots=N_SLOTS,
                                   max_len=MAX_LEN, kv_block_size=BLOCK, prefill_chunk=CHUNK,
                                   quantized_kv=quantized, device=dev, **spec)
    if record is not None:
        _record_logits(eng, record)
    for r in _requests(np, arch.vocab):
        eng.submit(r)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    if count_launches:
        ops.reset_launches()
    region = torch.profiler.record_function(label) if label else contextlib.nullcontext()
    t0 = time.perf_counter()
    with region:
        done = eng.run()
        sync()
    wall = time.perf_counter() - t0  # repro: noqa-RPA005 -- sync is torch.cuda.synchronize
    counts = ops.launch_counts() if count_launches else None
    if held is not None:
        held.update(engine=eng, done=done)
    outs = {r.rid: [int(t) for t in r.output] for r in done}
    if sorted(outs) != list(range(8)) or any(len(o) != NEW_TOKENS for o in outs.values()):
        fail(f"serve int8={quantized}: not every request completed with {NEW_TOKENS} tokens")
    return outs, counts, wall, eng.metrics.summary()


def phase_path(torch, np, arch, dev, route, tag="path"):
    """Serve the 8 requests through ``ServeEngine.from_trained`` (random
    train-form weights from SEED), fp and int8 KV, each twice for
    determinism. Every projection of the mode takes kernel route ``route``:
    the launches of the counted fp drain must be exactly 7 of it and one
    paged attention per layer per tick, and 0 of every other kernel."""
    from repro_torch.models import build_model

    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    train = build_model(arch, phase="train").init(gen, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"[{tag}] smollm-360m {arch.compute_mode} packed={arch.pack_signs}, "
          f"{arch.n_layers} layers, d_model {arch.d_model}: train-form init "
          f"{time.perf_counter() - t0:.2f} s")
    result = {}
    for quantized in (False, True):
        outs1, counts, wall, summ = _serve(np, train, arch, quantized, dev,
                                           count_launches=not quantized)
        outs2, _, wall2, _ = _serve(np, train, arch, quantized, dev)
        if outs1 != outs2:
            fail(f"serve int8={quantized}: a second run gave other tokens")
        if summ["prefix_hit_tokens"] != 16:
            fail(f"serve int8={quantized}: expected a 16-token prefix hit, got "
                 f"{summ['prefix_hit_tokens']}")
        print(f"[{tag}] int8_kv={quantized} 8 requests x {NEW_TOKENS} tokens, deterministic; "
              f"wall {wall:.3f} s / {wall2:.3f} s; decode_steps={summ['decode_steps']} "
              f"prefill_chunks={summ['prefill_chunks']} "
              f"prefix_hit_tokens={summ['prefix_hit_tokens']} "
              f"goodput={summ['goodput_tok_s']:.1f} tok/s"
              + (f"; launches {counts}" if counts else ""))
        if counts is not None:
            _check_serve_launches(arch, route, counts, summ)
            result["launches"] = counts
            result["summary"] = summ
            result["tokens"] = outs1
        else:
            result["tokens_int8_kv"] = outs1
        print(f"[{tag}] int8_kv={quantized} tokens req0={outs1[0]}")
    return train, result


def _projections(arch):
    """Projection launches a layer makes a forward: q, k, v, o and the MLP's
    up, down (and gate), or each of the E experts' two or three."""
    mlp = 3 if arch.gated_mlp else 2
    return 4 + mlp * (arch.n_experts or 1)


def _check_serve_launches(arch, route, counts, summ):
    if min(counts[route], counts["paged_attn"]) <= 0:
        fail(f"a kernel of the path was never launched: {counts}")
    ticks = summ["decode_steps"] + summ["prefill_chunks"]
    per = _projections(arch)
    expect = dict(_NO_LAUNCHES, **{route: per * arch.n_layers * ticks,
                                   "paged_attn": arch.n_layers * ticks})
    if counts != expect:
        fail(f"launch counts {counts} != {per} {route} + 1 attention per layer per tick "
             f"({expect[route]}, {expect['paged_attn']}) and 0 elsewhere")


def phase_profile(torch, np, arch, train, dev, tag="profile", label=None, groups=None,
                  **serve_kw):
    """Where the time of a drain goes: one more fp-KV drain under
    torch.profiler (``serve_kw`` picks the engine and the speculative draft;
    default the paged engine). Device busy time is the union of the kernel,
    memcpy and memset intervals inside the drain's window; the idle share is
    the rest; ``groups`` names kernels whose device ms and launches in the
    window are summed (``_device_share``). The profiler's own cost, its stop
    and the reading of its events, is printed beside."""
    from torch.profiler import ProfilerActivity, profile

    label = label or f"{arch.compute_mode}_serve_drain"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, wall, summ = _serve(np, train, arch, False, dev, label=label, **serve_kw)
        t0 = time.perf_counter()
    t_stop = time.perf_counter() - t0
    ticks = summ["decode_steps"] + summ["prefill_chunks"]
    result = {"wall_s": wall, "ticks": ticks, "ms_per_tick": wall / ticks * 1e3}
    t0 = time.perf_counter()
    share = _device_share(prof, label, groups)
    result["profiler_s"] = {"stop": t_stop, "trace": time.perf_counter() - t0}
    print(f"[{tag}] the profiler's own cost: stop {t_stop:.2f} s, reading its events "
          f"{result['profiler_s']['trace']:.2f} s")
    if share is None:
        print(f"[{tag}] device busy share: not measured (the trace holds no drain window "
              "or no device events)")
        return result
    result.update(share)
    print(f"[{tag}] fp-KV drain under torch.profiler: window {result['window_ms']:.1f} ms, "
          f"{ticks} ticks ({result['ms_per_tick']:.2f} ms/tick host clock), device busy "
          f"{result['device_busy_ms']:.2f} ms, idle share {result['idle_share']:.4f}")
    for row in result["top_kernels"]:
        print(f"[{tag}]   {row['ms']:9.3f} ms {row['count']:6d}x {row['name']}")
    for name, g in result["groups"].items():
        print(f"[{tag}] {name}: {g['ms']:.3f} device ms in {g['count']} kernel launches")
    return result


def phase_bnn_serve(torch, np, dev):
    """The bnn serve path: smollm-360m in bnn mode at full width and
    LOWBIT_SERVE_LAYERS layers, packed sign planes (kernel 7 on every projection), through
    ``phase_path``; then one fp-KV drain with unpacked int8 signs (kernel 6
    on every projection), whose tokens must equal the packed drain's (both
    compute the same integers), one profiled drain, and the 2-layer
    card-vs-CPU parity with Signs held at genuine near-zero ties."""
    from repro_torch.configs import get_config
    from repro_torch.core.convert import tree_to_serve

    arch = get_config("smollm-360m", compute_mode="bnn", pack_signs=True, remat=False,
                      paged_attn_route="fused", n_layers=LOWBIT_SERVE_LAYERS)
    train, path = phase_path(torch, np, arch, dev, "bnn_packed", tag="bnn-serve")
    unpacked = arch.replace(pack_signs=False)
    outs, counts, wall, summ = _serve(np, train, unpacked, False, dev, count_launches=True)
    _check_serve_launches(unpacked, "bnn", counts, summ)
    if outs != path["tokens"]:
        fail("bnn serve: the unpacked drain (kernel 6) gave other tokens than the packed "
             "drain (kernel 7)")
    print(f"[bnn-serve] unpacked int8 signs, fp KV: tokens equal to the packed drain's; wall "
          f"{wall:.3f} s; launches {counts}")
    path["unpacked"] = {"launches": counts, "wall_s": wall, "summary": summ}
    path["profile"] = phase_profile(torch, np, arch, train, dev, tag="bnn-profile",
                                    groups={**KERNEL7_GROUP, **KERNEL11_GROUP})
    serve_params = tree_to_serve(train, arch.linear_spec())
    del train
    path["parity"] = phase_parity(torch, np, arch, serve_params, dev,
                                  _bnn_sign_hooks(torch, "bnn_matmul_packed"), tag="bnn-parity")
    return path


def phase_qnn8_serve(torch, np, dev):
    """The qnn8 serve path: smollm-360m in qnn8 mode at full width and
    LOWBIT_SERVE_LAYERS layers through ``phase_path`` (kernel 10 on every
    projection: 7 launches and one attention launch a layer and tick, 0
    elsewhere), one profiled
    drain, and the 2-layer card-vs-CPU parity with activation codes held at
    genuine half-way ties (``_code_hooks``: qnn8 quantizes its input onto the
    same 0.05 grid as bika)."""
    from repro_torch.configs import get_config
    from repro_torch.core.convert import tree_to_serve

    arch = get_config("smollm-360m", compute_mode="qnn8", remat=False, paged_attn_route="fused",
                      n_layers=LOWBIT_SERVE_LAYERS)
    train, path = phase_path(torch, np, arch, dev, "qnn8", tag="qnn8-serve")
    path["profile"] = phase_profile(torch, np, arch, train, dev, tag="qnn8-profile",
                                    groups={**KERNEL10_GROUP, **KERNEL11_GROUP})
    serve_params = tree_to_serve(train, arch.linear_spec())
    del train
    path["parity"] = phase_parity(torch, np, arch, serve_params, dev, _code_hooks(torch),
                                  tag="qnn8-parity")
    return path


def _spec_ties(torch, np, arch, train, dev, want, got, what):
    """Requests whose tokens ``got`` differ from ``want``: each may part only
    where the target's top-2 logit gap at the first differing step, recomputed
    on the card from the common prefix (a full forward of the prompt and the
    common tokens), is below SPEC_TIE. Returns the ties; fails on any other
    divergence."""
    from repro_torch.core.convert import tree_to_serve
    from repro_torch.models import build_model
    from repro_torch.models.lm import split_layers

    ties = []
    diff = [rid for rid in want if want[rid] != got[rid]]
    if not diff:
        return ties
    api = build_model(arch, phase="serve")
    params = split_layers(tree_to_serve(train, arch.linear_spec()))
    prompts = {r.rid: r.prompt for r in _requests(np, arch.vocab)}
    for rid in diff:
        d = next(i for i, (a, b) in enumerate(zip(want[rid], got[rid])) if a != b)
        seq = np.concatenate([prompts[rid], np.asarray(want[rid][:d], np.int32)])
        with torch.inference_mode():
            logits = api.apply(params, {"tokens": torch.from_numpy(seq[None]).to(dev)})
        top2 = torch.topk(logits[0, -1].float(), 2).values
        gap = float(top2[0] - top2[1])
        print(f"[spec] {what}: request {rid} parts at token {d} ({want[rid][d]} vs "
              f"{got[rid][d]}); the target's top-2 logit gap there is {gap:.3e}")
        if gap >= SPEC_TIE:
            fail(f"spec {what}: request {rid} diverges at token {d} where the target's top-2 "
                 f"gap is {gap:.3e} (a tie is below {SPEC_TIE})")
        ties.append({"rid": rid, "token": d, "gap": gap})
    return ties


def phase_spec(torch, np, dev):
    """Speculative decoding at full width, SPEC_LAYERS of 32 layers: dense
    smollm-360m target <- qnn8 draft of the same seeded train-form tree,
    spec_k = SPEC_K,
    through ``ServeEngine.from_trained``. Four fp-KV drains of the 8
    requests: paged target-only, paged speculative, continuous target-only,
    continuous speculative. Speculative tokens equal target-only tokens on
    the same engine, and the continuous target-only tokens the paged ones,
    under the tie rule of ``_spec_ties``. Launch counts exact: kernel 10 =
    7 x layers x (SPEC_K x rounds + admissions) (SPEC_K draft decode steps a
    round, one draft prefill an admission), kernel 11 = layers x (rounds +
    prefill chunks) on the paged engine and 0 on the continuous one (its
    dense attention is plain PyTorch), every other kernel 0."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    arch = get_config("smollm-360m", compute_mode="dense", remat=False, paged_attn_route="fused",
                      n_layers=SPEC_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    train = build_model(arch, phase="train").init(gen, device=dev)
    per_pass = 7 * arch.n_layers
    result, tokens = {}, {}
    for engine in ("paged", "continuous"):
        for spec in (False, True):
            kw = dict(spec_draft="qnn8", spec_k=SPEC_K) if spec else {}
            outs, counts, wall, summ = _serve(np, train, arch, False, dev, count_launches=True,
                                              engine=engine, **kw)
            rounds = summ["decode_steps"]
            attn = arch.n_layers * (rounds + summ["prefill_chunks"]) if engine == "paged" else 0
            qnn = per_pass * (SPEC_K * rounds + summ["prefills"]) if spec else 0
            expect = dict(_NO_LAUNCHES, qnn8=qnn, paged_attn=attn)
            if counts != expect:
                fail(f"spec {engine} spec={spec}: launch counts {counts} != {expect}")
            if spec and min(counts["qnn8"], summ["spec_rounds"]) <= 0:
                fail(f"spec {engine}: the draft never ran")
            name = f"{engine}_{'spec' if spec else 'target'}"
            tokens[name] = outs
            result[name] = {"launches": counts, "wall_s": wall, "summary": summ, "tokens": outs}
            print(f"[spec] {name}: wall {wall:.3f} s, {rounds} "
                  f"{'rounds' if spec else 'ticks'} ({wall / rounds * 1e3:.1f} ms each, "
                  f"admissions included), goodput {summ['goodput_tok_s']:.1f} tok/s, "
                  f"TPOT p50 {summ['tpot_p50_s'] * 1e3:.2f} ms"
                  + (f", accept rate {summ['spec_accept_rate']:.4f}, tokens/round "
                     f"{summ['spec_tokens_per_round']:.4f}" if spec else "")
                  + f"; launches {counts}")
        result[f"{engine}_spec"]["profile"] = phase_profile(
            torch, np, arch, train, dev, tag="spec-profile", label=f"{engine}_spec_drain",
            groups={**KERNEL10_GROUP, **KERNEL11_GROUP}, engine=engine, spec_draft="qnn8",
            spec_k=SPEC_K)
        result[f"{engine}_spec"]["ties"] = _spec_ties(
            torch, np, arch, train, dev, tokens[f"{engine}_target"], tokens[f"{engine}_spec"],
            f"{engine} speculative vs target-only")
    result["continuous_vs_paged_ties"] = _spec_ties(
        torch, np, arch, train, dev, tokens["paged_target"], tokens["continuous_target"],
        "continuous vs paged target-only")
    n_ties = sum(len(result[f"{e}_spec"]["ties"]) for e in ("paged", "continuous"))
    print(f"[spec] dense <- qnn8, k={SPEC_K}: speculative tokens equal target-only on both "
          f"engines and continuous equal paged, with {n_ties} + "
          f"{len(result['continuous_vs_paged_ties'])} divergences at top-2 gaps below "
          f"{SPEC_TIE}; req0={tokens['paged_spec'][0]}")
    return result


def _device_share(prof, label, groups=None):
    """Device busy time, idle share and top kernels inside the profiler
    window named ``label`` (a ``record_function`` range), read from the
    profiler's own event list (the categories a Chrome trace of it would
    show, without writing and parsing one): busy is the union of the
    kernel, memcpy and memset intervals in the window. ``groups`` maps a
    name to the substrings of the kernel names it sums (device ms and
    launches in the window). None when the window or the device events are
    missing."""
    from torch.autograd import DeviceType

    window, gpu = [], []
    for e in prof.profiler.kineto_results.events():
        on_card = e.device_type() == DeviceType.CUDA
        if e.is_user_annotation():  # a record_function range: its host side names the window
            if not on_card and e.name() == label:
                window.append({"ts": e.start_ns() / 1e3, "dur": e.duration_ns() / 1e3})
        elif on_card:  # a kernel, memcpy or memset
            gpu.append({"name": e.name(), "ts": e.start_ns() / 1e3,
                        "dur": e.duration_ns() / 1e3})
    if not window or not gpu:
        return None
    t0 = float(window[0]["ts"])
    t1 = t0 + float(window[0]["dur"])
    spans = sorted((max(float(e["ts"]), t0), min(float(e["ts"]) + float(e["dur"]), t1))
                   for e in gpu)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += 0.0 if cur_e is None else cur_e - cur_s
    by_name = {}
    for e in gpu:
        if t0 <= float(e["ts"]) <= t1:
            key = e["name"][:60]
            n, d = by_name.get(key, (0, 0.0))
            by_name[key] = (n + 1, d + float(e["dur"]))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    summed = {}
    for name, parts in (groups or {}).items():
        hits = [e for e in gpu if t0 <= float(e["ts"]) <= t1
                and any(p in e["name"] for p in parts)]
        summed[name] = {"count": len(hits), "ms": sum(float(e["dur"]) for e in hits) / 1e3}
    return {"window_ms": (t1 - t0) / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / (t1 - t0),
            "top_kernels": [{"name": k, "count": n, "ms": d / 1e3} for k, (n, d) in top],
            "groups": summed}


# ---------------------------------------------------------------------------
# phase 5: card vs CPU plain path, 2 layers at full width
# ---------------------------------------------------------------------------


def _slice_layers(tree, n):
    if isinstance(tree, dict):
        return {k: _slice_layers(v, n) for k, v in tree.items()}
    return tree[:n].contiguous()


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _code_hooks(torch):
    """Activation quantizers for the two sides of the bika parity run. The
    card's records every code it makes; the CPU's makes its own and compares:
    where the two differ, the CPU's input must sit within PARITY_TIE code
    units of the half-way point between them (a tie that float noise may
    break either way), and the CPU then takes the card's code. Any other
    difference fails. Returns (install(side), restore(), report())."""
    from repro_torch.core import backend

    plain = backend.quantize_activations
    queue = []
    stats = {"codes": 0, "ties": 0, "worst_tie": 0.0}

    def record(x, act_scale):
        codes = plain(x, act_scale)
        queue.append(codes.cpu())
        return codes

    def follow(x, act_scale):
        codes = plain(x, act_scale)
        card = queue.pop(0).to(codes.device)
        if card.shape != codes.shape:
            fail(f"parity: the two sides quantized {tuple(card.shape)} vs {tuple(codes.shape)}")
        stats["codes"] += codes.numel()
        diff = codes != card
        if bool(diff.any()):
            u = (x / torch.tensor(act_scale, dtype=x.dtype))[diff].double()
            half = (codes[diff].double() + card[diff].double()) / 2
            dist = float((u - half).abs().max())
            step = int((codes[diff].int() - card[diff].int()).abs().max())
            if step != 1 or dist > PARITY_TIE:
                fail(f"parity: {int(diff.sum())} activation codes differ between card and "
                     f"CPU by up to {step}, {dist:.3e} code units from a half-way point "
                     f"(a tie is within {PARITY_TIE})")
            stats["ties"] += int(diff.sum())
            stats["worst_tie"] = max(stats["worst_tie"], dist)
            for u_, c_, g_ in list(zip(u.tolist(), codes[diff].tolist(),
                                       card[diff].tolist()))[:8]:
                print(f"[parity]   held an activation code tie: x / scale = {u_:.9f}, "
                      f"CPU code {c_}, card code {g_}")
            codes = torch.where(diff, card, codes)
        return codes

    def install(side):
        backend.quantize_activations = record if side == "card" else follow

    def restore():
        backend.quantize_activations = plain

    def report():
        return (f"{stats['ties']} of {stats['codes']} activation codes were half-way ties "
                f"(worst {stats['worst_tie']:.2e} code units, limit {PARITY_TIE})")

    return install, restore, report


def _bnn_sign_hooks(torch, route_name):
    """Hooks on ``ops.<route_name>`` (the route every bnn serve projection
    takes) for the bnn parity run. The card's records each projection input;
    the CPU's compares its own input's Signs with the card's: where they
    differ, both inputs must lie within BNN_SIGN_TIE of 0 (a Sign that float
    noise may flip either way), and the CPU then takes the card's input
    there. Any other difference fails. Returns (install(side), restore(),
    report())."""
    from repro_torch.kernels import ops

    route = getattr(ops, route_name)
    queue = []
    stats = {"signs": 0, "held": 0, "worst": 0.0}

    def record(x, wb):
        queue.append(x.detach().cpu())
        return route(x, wb)

    def follow(x, wb):
        card = queue.pop(0).to(x.device)
        stats["signs"] += x.numel()
        diff = (x >= 0) != (card >= 0)
        if bool(diff.any()):
            worst = float(torch.maximum(x[diff].abs(), card[diff].abs()).max())
            if worst > BNN_SIGN_TIE:
                fail(f"bnn parity: {int(diff.sum())} Signs differ between card and CPU, at "
                     f"|x| up to {worst:.3e} (a tie is within {BNN_SIGN_TIE} of 0)")
            stats["held"] += int(diff.sum())
            stats["worst"] = max(stats["worst"], worst)
            x = torch.where(diff, card, x)
        return route(x, wb)

    def install(side):
        setattr(ops, route_name, record if side == "card" else follow)

    def restore():
        setattr(ops, route_name, route)

    def report():
        if queue:
            fail(f"bnn parity: the CPU side left {len(queue)} card inputs untaken")
        return (f"{stats['held']} of {stats['signs']} projection-input Signs held to the "
                f"card's (worst |x| {stats['worst']:.2e}, limit {BNN_SIGN_TIE})")

    return install, restore, report


def phase_parity(torch, np, arch, serve_params, dev, hooks, tag="parity", layers=2):
    """Prefill a 19-token prompt (one 32-token chunk) and decode 4 steps for
    4 rows (one parked) on the card and on the CPU, the same serve weights
    cut to ``layers`` layers, the CPU through the plain versions.

    The CAC sums are exact integers on both sides, but the float parts
    (RMSNorm, SiLU, the attention kernel against its plain version) differ by
    ~1e-7 relative, and every bika projection rounds its input onto the 0.05
    grid: an input within that noise of a half-way point may take either
    code. One such flip moves ~1% of a projection's outputs by 2/sqrt(K),
    the next layer's codes follow, and after two layers the logits move by
    up to O(0.5) (0.44 in an earlier card run of this script; a CPU run with
    3e-5 relative noise in RMSNorm gives 0.67). So the CPU side takes the
    card's code wherever the two differ at a genuine tie (``_code_hooks``)
    and fails on any other difference; with the codes equal the logits must
    agree within PARITY_ATOL and the greedy tokens must be equal. A bnn
    projection binarizes its float input directly, so there the same noise
    may flip a Sign at an input near 0; ``hooks`` (``_code_hooks`` or
    ``_bnn_sign_hooks``) holds the CPU side to the card at such ties."""
    from repro_torch.models import build_model
    from repro_torch.models.lm import split_layers

    arch2 = arch.replace(n_layers=layers)
    api = build_model(arch2, phase="serve")
    p2 = dict(serve_params)
    p2["layers"] = _slice_layers(serve_params["layers"], layers)
    rng = np.random.RandomState(SEED + 5)
    prompt = rng.randint(0, arch.vocab, 19).astype(np.int32)
    toks = np.zeros((1, CHUNK), np.int32)
    toks[0, :19] = prompt
    n_blocks = 4 * (MAX_LEN // BLOCK)
    table = np.array([[3, 9, 1, 12, 5, 7, 30, 2]], np.int32)
    tables = np.full((4, MAX_LEN // BLOCK), n_blocks, np.int32)  # parked rows
    tables[0] = table[0]
    tables[1] = [4, 6, 8, 10, 11, 13, 14, 15]
    tables[2] = [16, 17, 18, 19, 20, 21, 22, 23]
    install, restore, report = hooks
    sides = (("card", dev), ("cpu", "cpu"))  # the card goes first
    runs, logs = {}, {}

    def step(side, fn):
        install(side)
        try:
            with torch.inference_mode():
                lg, pool = fn()
        finally:
            restore()
        logs.setdefault(side, []).append(lg.float().cpu())
        return pool

    for side, where in sides:
        params = split_layers(_to(p2, where))
        pool = api.init_cache(n_blocks + 1, BLOCK, device=where)
        pool = step(side, lambda: api.prefill_chunk(
            params, torch.from_numpy(toks).to(where), pool, torch.from_numpy(table).to(where),
            torch.tensor([0], dtype=torch.int32, device=where),
            torch.tensor([18], dtype=torch.int32, device=where)))
        runs[side] = (params, pool)
    # decode: feed both sides the CPU's greedy tokens so inputs stay equal
    tok = np.array([[int(logs["cpu"][0][0, -1].argmax())], [7], [11], [0]], np.int32)
    pos = np.array([19, 0, 0, 0], np.int32)
    for _ in range(4):
        for side, where in sides:
            params, pool = runs[side]
            runs[side] = (params, step(side, lambda: api.decode_paged(
                params, torch.from_numpy(tok).to(where), pool, torch.from_numpy(pos).to(where),
                torch.from_numpy(tables).to(where))))
        tok = logs["cpu"][-1][:, -1].argmax(-1).numpy().astype(np.int32)[:, None]
        tok[3] = 0
        pos = pos + np.array([1, 1, 1, 0], np.int32)
    worst, compared, ties = 0.0, 0, 0
    for i, (g, c) in enumerate(zip(logs["card"], logs["cpu"])):
        n_live = 1 if i == 0 else 3  # the parked row 3 is junk by design
        for r in range(n_live):
            gr, cr = g[r, -1], c[r, -1]
            d = float((gr - cr).abs().max())
            worst = max(worst, d)
            if not np.isfinite(d) or d > PARITY_ATOL:
                fail(f"{tag} step {i} row {r}: max |card - cpu| logits = {d} > {PARITY_ATOL}")
            # greedy tokens must agree unless the CPU's top two logits are
            # closer than the two sides' own difference (a tie that the
            # tolerance cannot order)
            top2 = torch.topk(cr, 2).values
            if float(top2[0] - top2[1]) <= 2 * d:
                ties += 1
                continue
            compared += 1
            if int(gr.argmax()) != int(cr.argmax()):
                fail(f"{tag} step {i} row {r}: greedy tokens differ between card and CPU")
    held = report()
    print(f"[{tag}] {arch.compute_mode}, {layers} layers at full width: prefill + 4 decode "
          f"steps, "
          f"card vs CPU plain path: max |dlogit| = {worst:.3e} (tolerance {PARITY_ATOL}); "
          f"greedy tokens equal on {compared} of {compared + ties} rows ({ties} "
          f"within-tolerance ties); {held}")
    return {"max_abs_dlogit": worst, "held": held}


# ---------------------------------------------------------------------------
# phase 6: the training path
# ---------------------------------------------------------------------------


def _train_step(torch, ops, trainer, params, opt, step, expect):
    """One timed Trainer step with the launch counters zeroed just before
    and read just after; ``expect`` is the exact count of each kernel."""
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    params, opt, met = trainer.train_step(params, opt, step)
    loss = float(met["loss"])  # waits for the step
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    if counts != dict(_NO_LAUNCHES, **expect):
        fail(f"train step {step}: launch counts {counts}, expected {expect} and 0 elsewhere")
    if not math.isfinite(loss) or float(met["skipped"]) != 0.0:
        fail(f"train step {step}: loss {loss}, skipped {float(met['skipped'])}")
    return params, opt, {"step": step, "loss": loss, "ms": ms,
                         "grad_norm": float(met["grad_norm"]), "launches": counts}


def _train_projections(arch) -> int:
    """Projections one training forward of ``arch`` runs through its mode's
    kernel: 4 attention ones a layer (q, k, v, o), and the FFN's 3 (gated)
    or 2 per expert (or once without experts); the encoder-decoder's
    decoder layers also run the cross attention's 4; the recurrent
    families as they serve (``_forward_launches``: the hybrid's 2 a Mamba
    layer and 7 a shared-block application, xLSTM's 2 an sLSTM and 5 an
    mLSTM layer)."""
    mlp = 3 if arch.gated_mlp else 2
    if arch.family == "encdec":
        return arch.n_encoder_layers * (4 + mlp) + arch.n_layers * (8 + mlp)
    if arch.family in ("hybrid", "xlstm"):
        return _forward_launches(arch)
    return arch.n_layers * (4 + mlp * max(arch.n_experts, 1))


def phase_train_path(torch, np, dev, mode, tag="train", arch=None, profiled=True,
                     profile_split=True, n_steps=TRAIN_STEPS):
    """Trainer on ``arch`` in ``mode`` (default: full-width, full-depth
    smollm-360m; random train-form weights from seed 42, remat on), batch 4
    x seq 128: ``n_steps`` steps, then (``profiled``) 1 more under
    torch.profiler (and in bika, with ``profile_split``, a split-backward
    one). Per
    step, with remat, each projection (``_train_projections``) launches its
    forward kernel twice (forward, then the recompute in the backward) and
    its backward once: bika the training CAC forward and the fused STE
    backward (with ``profiled``, a last step takes the split dx + dw pair);
    bnn the sign product (kernel 6) and the SignSTE dx and dw kernels (8
    and 9); qnn8 no kernel (fake quantization)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import OptimizerSpec
    from repro_torch.train.trainer import TrainConfig, Trainer

    arch = arch or get_config("smollm-360m", compute_mode=mode)
    n_proj = _train_projections(arch)
    split = None
    if mode == "bika":
        main = {"cac_train_fwd": 2 * n_proj, "cac_train_bwd_fused": n_proj}
        if profiled:
            split = {"cac_train_fwd": 2 * n_proj, "cac_train_bwd_dx": n_proj,
                     "cac_train_bwd_dw": n_proj}
    elif mode == "bnn":
        main = {"bnn": 2 * n_proj, "bnn_bwd_dx": n_proj, "bnn_bwd_dw": n_proj}
    else:
        main = {}
    cfg = TrainConfig(arch=arch, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      steps=n_steps + (2 if split is None else 3))
    profile_split = profile_split and split is not None
    trainer = Trainer(cfg, OptimizerSpec(total_steps=cfg.steps), device=dev)
    layers = (f"{arch.n_encoder_layers} + {arch.n_layers}" if arch.family == "encdec"
              else f"{arch.n_layers}")
    t0 = time.perf_counter()
    params, opt, _ = trainer.init()
    torch.cuda.synchronize()
    print(f"[{tag}] {arch.name} {mode}, {layers} layers, d_model {arch.d_model}, "
          f"remat={arch.remat}: init {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for step in range(n_steps):
        params, opt, row = _train_step(torch, ops, trainer, params, opt, step, main)
        steps.append(row)
    if split is not None:
        ops.FUSED_BWD_DEFAULT = False
        try:
            params, opt, row = _train_step(torch, ops, trainer, params, opt, n_steps, split)
        finally:
            ops.FUSED_BWD_DEFAULT = True
        steps.append(dict(row, split=True))
    peak = torch.cuda.max_memory_allocated()
    for r in steps:
        print(f"[{tag}] step {r['step']}{' (split backward)' if r.get('split') else ''}: "
              f"loss {r['loss']:.5f} grad_norm {r['grad_norm']:.4f} {r['ms']:.1f} ms "
              f"launches {r['launches']}")
    result = {"steps": steps, "max_memory_allocated": peak, "arch": arch.name,
              "layers": layers, "tokens_per_step": TRAIN_BATCH * TRAIN_SEQ,
              "launches_per_step": main}
    if not profiled:
        print(f"[{tag}] peak memory {peak / 2**30:.2f} GiB; steps "
              f"{[round(r['ms'], 1) for r in steps]} ms")
        return result
    label = f"{mode}_train_step"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(label):
            params, opt, row = _train_step(torch, ops, trainer, params, opt, n_steps + 1,
                                           main)
    result["profiled_step"] = row
    # kernels 8, 9 and 6 (its tensor-core route at M = 512) each run a sign
    # pass and then the product template in its mode (1 dx, 0 dw, 2 fwd)
    groups = ({"bnn_bwd_dx": ("bnn_sign_kernel<true", "bnn_bwd_kernel<1,"),
               "bnn_bwd_dw": ("bnn_sign_kernel<false, false, float, false>", "bnn_bwd_kernel<0,"),
               "bnn": ("bnn_sign_kernel<false, false, float, true>", "bnn_bwd_kernel<2,")}
              if mode == "bnn" else
              {"cac_train_fwd": ("cac_train_fwd_kernel",),
               "cac_train_bwd_fused": ("cac_train_bwd_fused_kernel",)})
    share = _device_share(prof, label, groups)
    split_share = None
    if profile_split:  # one split step under the profiler too, after the
        # fused step's trace is read (a second profiler clears its events)
        split_label = f"{mode}_train_step_split"
        ops.FUSED_BWD_DEFAULT = False
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_split:
                with torch.profiler.record_function(split_label):
                    params, opt, _ = _train_step(torch, ops, trainer, params, opt,
                                                 n_steps + 2, split)
        finally:
            ops.FUSED_BWD_DEFAULT = True
        split_share = _device_share(prof_split, split_label, {
            "cac_train_fwd": ("cac_train_fwd_kernel",),
            "cac_train_bwd_dx": ("cac_train_bwd_dx_kernel",),
            "cac_train_bwd_dw": ("cac_train_bwd_dw_kernel",)})
        result["split_profile"] = split_share
    print(f"[{tag}] peak memory {peak / 2**30:.2f} GiB; steps "
          f"{[round(r['ms'], 1) for r in steps[:n_steps]]} ms"
          + (f", split step {steps[-1]['ms']:.1f} ms" if split is not None else ""))
    if share is None:
        print(f"[{tag}] device busy share: not measured (no window or no device events)")
        return result
    result["profile"] = share
    print(f"[{tag}] one step under torch.profiler: window {share['window_ms']:.1f} ms, "
          f"device busy {share['device_busy_ms']:.2f} ms, idle share {share['idle_share']:.4f}")
    for r in share["top_kernels"]:
        print(f"[{tag}]   {r['ms']:9.3f} ms {r['count']:6d}x {r['name']}")
    for name, r in share["groups"].items():
        print(f"[{tag}] profiled step: {name} {r['ms']:.3f} device ms in {r['count']} kernel "
              f"launches" + (" (sign pass + product per call)" if mode == "bnn" else ""))
    if split_share is not None:
        print(f"[{tag}] one split-backward step under torch.profiler: window "
              f"{split_share['window_ms']:.1f} ms, device busy {split_share['device_busy_ms']:.2f} "
              f"ms, idle share {split_share['idle_share']:.4f}; "
              + ", ".join(f"{name} {r['ms']:.3f} device ms in {r['count']} launches"
                          for name, r in split_share["groups"].items()))
    return result


# ---------------------------------------------------------------------------
# ckpt: checkpoint and restart at full width and depth
# ---------------------------------------------------------------------------


def _counted_trainer(torch, ops, cfg, dev, per_step, fail_at_step=None, io_times=None):
    """A Trainer whose steps each zero the launch counters just before and
    read them just after (``per_step`` gets (step, counts)); with
    ``io_times`` (a dict) its checkpoint saves and restores are timed."""
    from repro_torch.optim.adamw import OptimizerSpec
    from repro_torch.train.trainer import Trainer

    trainer = Trainer(cfg, OptimizerSpec(total_steps=cfg.steps), device=dev,
                      fail_at_step=fail_at_step)
    inner = trainer.train_step

    def counted(params, opt, step):
        ops.reset_launches()
        out = inner(params, opt, step)
        per_step.append((step, ops.launch_counts()))
        return out

    trainer.train_step = counted
    for name in ("save", "restore_latest") if io_times is not None and trainer.ckpt else ():
        def timed(*args, _inner=getattr(trainer.ckpt, name), _name=name, **kw):
            t0 = time.perf_counter()
            out = _inner(*args, **kw)
            torch.cuda.synchronize()
            io_times.setdefault(_name, []).append(time.perf_counter() - t0)
            return out

        setattr(trainer.ckpt, name, timed)
    return trainer


def _state_equal(torch, a, b):
    """(leaves compared, the paths whose bits differ) of two {"params",
    "opt"} states."""
    from repro_torch.optim.adamw import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        fail(f"checkpoint state: {len(la)} leaves against {len(lb)}")
    bad = [i for i, (x, y) in enumerate(zip(la, lb))
           if (torch.is_tensor(x) and not (x.dtype == y.dtype and torch.equal(x, y)))
           or (not torch.is_tensor(x) and x != y)]
    return len(la), bad


def _flip_a_byte(path, member):
    """Corrupt one leaf on disk: flip a byte of its array data inside the
    uncompressed ``arrays.npz``."""
    import struct
    import zipfile

    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo(member)
    with open(path, "r+b") as fh:
        fh.seek(info.header_offset + 26)
        name_len, extra_len = struct.unpack("<HH", fh.read(4))
        at = info.header_offset + 30 + name_len + extra_len + info.compress_size - 1
        fh.seek(at)
        byte = fh.read(1)
        fh.seek(at)
        fh.write(bytes([byte[0] ^ 0x40]))


def phase_ckpt(torch, np, dev, tag="ckpt"):
    """Checkpoint and restart of full-width smollm-360m cut to CKPT_LAYERS
    layers in bika mode (remat, batch 4 x seq 128, random weights from seed
    42): an uninterrupted 4-step run against ``run_with_restarts`` with a
    failure injected at step 2 (``ckpt_every=1``, ``keep=1``: the restart
    restores step 2). Every parameter and every AdamW m / v leaf must be
    equal bit for bit, and each step launch exactly 2 x 7 kernel-2 and 7
    kernel-5 kernels a layer and nothing else; the restarted run's four
    (sync) saves and its restore are timed. Then the checkpoint's bytes and
    an async save's seconds (until ``save`` returns, and until ``wait``); a
    byte flipped in one leaf's data must make restore raise on that leaf's
    hash; and one qnn8 step (full width and depth) through
    ``launch/train.py --mode qnn8``: a finite loss and no kernel launched
    (fake quantization). The checkpoints live in a temporary directory
    under build/ that the phase removes."""
    import contextlib
    import io
    import re
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager, latest_step, restore
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.train.trainer import TrainConfig, run_with_restarts

    arch = get_config("smollm-360m", compute_mode="bika", n_layers=CKPT_LAYERS)
    n_proj = 7 * arch.n_layers
    expect = dict(_NO_LAUNCHES, cac_train_fwd=2 * n_proj, cac_train_bwd_fused=n_proj)
    steps, fail_at = 4, 2
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt-", dir=os.path.join(ROOT, "build"))
    result = {"layers": arch.n_layers, "d_model": arch.d_model, "d_ff": arch.d_ff,
              "steps": steps, "fail_at_step": fail_at}
    try:
        cfg = TrainConfig(arch=arch, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, steps=steps,
                          log_every=1)
        full_steps = []
        t0 = time.perf_counter()
        full_p, full_o, full_log = _counted_trainer(torch, ops, cfg, dev, full_steps).run()
        torch.cuda.synchronize()
        result["uninterrupted_s"] = time.perf_counter() - t0
        ck = os.path.join(tmp, "run")
        rcfg = TrainConfig(arch=arch, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, steps=steps,
                           log_every=1, ckpt_dir=ck, ckpt_every=1, keep=1)
        restart_steps, made, io_times = [], [], {}

        def make():
            made.append(1)
            return _counted_trainer(torch, ops, rcfg, dev, restart_steps,
                                    fail_at_step=fail_at if len(made) == 1 else None,
                                    io_times=io_times)

        t0 = time.perf_counter()
        p, o, log, restarts = run_with_restarts(make)
        torch.cuda.synchronize()
        result["restarted_s"] = time.perf_counter() - t0
        if restarts != 1 or [s for s, _ in restart_steps] != list(range(steps)):
            fail(f"[{tag}] restarts {restarts}, steps run {[s for s, _ in restart_steps]}")
        for name, rows in (("uninterrupted", full_steps), ("restarted", restart_steps)):
            for step, counts in rows:
                if counts != expect:
                    fail(f"[{tag}] {name} step {step}: launches {counts}, expected "
                         f"{2 * n_proj} cac_train_fwd + {n_proj} cac_train_bwd_fused")
        n_leaves, bad = _state_equal(torch, {"params": full_p, "opt": full_o},
                                     {"params": p, "opt": o})
        if bad:
            fail(f"[{tag}] the restarted run differs from the uninterrupted one in "
                 f"{len(bad)} of {n_leaves} leaves")
        result["save_sync_s"] = io_times["save"]
        (result["restore_s"],) = io_times["restore_latest"]
        losses = [m["loss"] for m in full_log]
        if [m["loss"] for m in log] != losses[fail_at:] or not all(map(math.isfinite, losses)):
            fail(f"[{tag}] losses {losses} against the restart's {[m['loss'] for m in log]}")
        print(f"[{tag}] smollm-360m bika {arch.n_layers} layers d_model {arch.d_model}: "
              f"restart at step {fail_at} of {steps} (ckpt_every=1, keep=1) equals the "
              f"uninterrupted run bit for bit in all {n_leaves} leaves (params, m, v, step); "
              f"launches {2 * n_proj} cac_train_fwd + {n_proj} cac_train_bwd_fused each of "
              f"{len(full_steps)} + {len(restart_steps)} steps; losses {losses}; "
              f"wall {result['uninterrupted_s']:.2f} s uninterrupted, "
              f"{result['restarted_s']:.2f} s with 4 saves and a restore")
        if latest_step(ck) != steps:
            fail(f"[{tag}] the run's directory ends at step {latest_step(ck)}")
        shutil.rmtree(ck)
        del full_p, full_o
        state = {"params": p, "opt": o}
        mgr = CheckpointManager(os.path.join(tmp, "timed"), keep=1)
        t0 = time.perf_counter()
        mgr.save(steps, state, blocking=False)
        result["save_async_return_s"] = time.perf_counter() - t0
        mgr.wait()
        result["save_async_s"] = time.perf_counter() - t0
        path = os.path.join(tmp, "timed", f"step_{steps}")
        result["checkpoint_bytes"] = sum(os.path.getsize(os.path.join(path, f))
                                         for f in os.listdir(path))
        with open(os.path.join(path, "manifest.json")) as fh:
            first = sorted(json.load(fh)["arrays"])[0]
        _flip_a_byte(os.path.join(path, "arrays.npz"), first + ".npy")
        try:
            restore(os.path.join(tmp, "timed"), None, state, device=dev)
        except OSError as e:  # the manifest's hash must catch it
            if "hash mismatch" not in str(e):
                fail(f"[{tag}] a corrupted leaf ({first}) failed otherwise: {e}")
            result["corrupted_restore_raised"] = f"{type(e).__name__}: {e}"
        else:
            fail(f"[{tag}] a corrupted leaf ({first}) restored without an error")
        print(f"[{tag}] checkpoint {result['checkpoint_bytes']:,} B ({n_leaves} leaves): the "
              f"restarted run's sync saves {[round(t, 2) for t in result['save_sync_s']]} s, "
              f"its restore {result['restore_s']:.2f} s; an async save returns after "
              f"{result['save_async_return_s']:.2f} s (the host copy), written after "
              f"{result['save_async_s']:.2f} s; a flipped byte in {first}: "
              f"{result['corrupted_restore_raised'][:120]}")
        del p, o, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    ops.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(["--mode", "qnn8", "--steps", "1", "--seq-len", str(TRAIN_SEQ),
                                "--batch", str(TRAIN_BATCH)])
    counts = ops.launch_counts()
    text = out.getvalue()
    loss = re.search(r"step\s+0\s+loss (\S+)", text)
    if rc != 0 or loss is None or not math.isfinite(float(loss.group(1))):
        fail(f"[{tag}] launch.train --mode qnn8: rc {rc}, output {text!r}")
    if counts != _NO_LAUNCHES:
        fail(f"[{tag}] qnn8 training launched kernels: {counts}")
    result["qnn8_step"] = {"loss": float(loss.group(1)), "s": time.perf_counter() - t0}
    print(f"[{tag}] launch.train --mode qnn8 (full width and depth, 1 step): loss "
          f"{float(loss.group(1)):.5f}, no kernel launched, {result['qnn8_step']['s']:.2f} s")
    return result


# ---------------------------------------------------------------------------
# obs: the traced, metered and profiled bika drain
# ---------------------------------------------------------------------------


def _reconcile(tag, tracer, done):
    """Exact trace <-> RunMetrics reconciliation: one queued and one prefill
    span per request, each with the request's own stamps, and one decode
    span on the prefill's track. Returns the summed span seconds."""
    spans = {}
    for r in tracer.records:
        if r.kind == "span" and r.track != "profiler" and r.name in ("queued", "prefill",
                                                                     "decode"):
            key = (r.args["rid"], r.name)
            if key in spans:
                fail(f"[{tag}] a second {r.name} span for request {key[0]}")
            spans[key] = r
    sums = {"queued": 0.0, "prefill": 0.0, "queue_wait": 0.0, "prefill_latency": 0.0}
    for req in done:
        rm = req.metrics
        q, p, d = (spans.get((req.rid, n)) for n in ("queued", "prefill", "decode"))
        if q is None or p is None or d is None:
            fail(f"[{tag}] request {req.rid} lacks a lifecycle span")
        if not (q.ts == rm.t_submit and q.dur == rm.queue_wait and p.ts == rm.t_admit
                and p.dur == rm.prefill_latency and d.ts == rm.t_first_token
                and d.dur == rm.t_done - rm.t_first_token and p.track == d.track):
            fail(f"[{tag}] request {req.rid}: spans do not equal its metrics' stamps")
        sums["queued"] += q.dur
        sums["prefill"] += p.dur
        sums["queue_wait"] += rm.queue_wait
        sums["prefill_latency"] += rm.prefill_latency
    if (sums["queued"], sums["prefill"]) != (sums["queue_wait"], sums["prefill_latency"]):
        fail(f"[{tag}] summed spans {sums}")
    if len(spans) != 3 * len(done):
        fail(f"[{tag}] {len(spans)} lifecycle spans for {len(done)} requests")
    return sums


def phase_obs(torch, np, arch, train, dev, untraced, tag="obs"):
    """The paged bika drain of phase path (the same weights and requests,
    fp KV) with a Tracer, a MetricsRegistry and profile_sample=4: its tokens
    must equal the untraced drain's (``untraced``), its launches stay 224
    kernel-1 and 32 kernel-11 a tick, its trace reconciles exactly with
    RunMetrics (``_reconcile``) and its Prometheus text parses. An untraced
    drain just before gives the wall seconds to set beside the traced one.
    Then request 0 alone, 3 tokens, served inside the torch.profiler window
    of ``--profile-dir`` (``obs.profile.profile_trace``; a whole drain's
    trace runs to ~390 MB): its Chrome trace must hold exactly 224 kernel-1
    and 32 kernel-11 launches a tick, by kernel name. Last, an open-loop
    ``replay_arrivals`` drain at a Poisson rate of 20 requests a second,
    whose tokens must equal the closed-loop drain's."""
    import shutil
    import tempfile

    from repro_torch.obs import MetricsRegistry, Tracer, parse_prometheus, profile_trace
    from repro_torch.serve import ServeEngine, replay_arrivals

    _, _, wall_plain, _ = _serve(np, train, arch, False, dev)
    tracer, registry, held = Tracer(), MetricsRegistry(), {}
    outs, counts, wall_traced, summ = _serve(np, train, arch, False, dev, count_launches=True,
                                             held=held, tracer=tracer, registry=registry,
                                             profile_sample=4)
    if outs != untraced:
        fail(f"[{tag}] the traced drain's tokens differ from the untraced drain's")
    _check_serve_launches(arch, "cac_hw", counts, summ)
    sums = _reconcile(tag, tracer, held["done"])
    ticks = summ["decode_steps"] + summ["prefill_chunks"]
    samples = parse_prometheus(registry.to_prometheus())
    labels = (("engine", "paged"), ("mode", "bika"), ("route", "fused"))
    for name in ("serve_requests_total", "serve_run_completed_requests"):
        if samples.get((name, labels)) != 8.0:
            fail(f"[{tag}] {name} = {samples.get((name, labels))}, expected 8")
    names = {}
    for r in tracer.records:
        names[f"{r.track}:{r.name}"] = names.get(f"{r.track}:{r.name}", 0) + 1
    prof = held["engine"].profiler.summary()
    result = {"wall_untraced_s": wall_plain, "wall_traced_s": wall_traced, "ticks": ticks,
              "launches": counts, "records": len(tracer), "dropped": tracer.dropped,
              "record_counts": names, "span_sums_s": sums, "profile": prof,
              "prometheus_samples": len(samples)}
    print(f"[{tag}] traced drain (Tracer, MetricsRegistry, profile_sample=4): tokens equal the "
          f"untraced drain's; launches {counts['cac_hw']} cac_hw + {counts['paged_attn']} "
          f"paged_attn in {ticks} ticks (224 + 32 a tick); wall {wall_traced:.3f} s traced "
          f"against {wall_plain:.3f} s untraced; {len(tracer)} records "
          f"({tracer.dropped} dropped), {len(samples)} Prometheus samples parsed")
    print(f"[{tag}] trace = RunMetrics exactly for all 8 requests: queued spans sum to "
          f"{sums['queued']:.6f} s = queue waits, prefill spans {sums['prefill']:.6f} s = "
          f"prefill latencies; records {names}")
    print(f"[{tag}] step timer: {prof['sampled_ticks']}/{prof['ticks']} ticks sampled; "
          + ", ".join(f"{k} {v['mean_s'] * 1e3:.2f} ms a tick ({v['fraction']:.0%})"
                      for k, v in prof["phases"].items()))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    pdir = tempfile.mkdtemp(prefix="profile-", dir=os.path.join(ROOT, "build"))
    eng = ServeEngine.from_trained(train, arch, engine="paged", n_slots=N_SLOTS, max_len=MAX_LEN,
                                   kv_block_size=BLOCK, prefill_chunk=CHUNK, device=dev)
    first = _requests(np, arch.vocab)[0]
    first.max_new_tokens = 3
    eng.submit(first)
    torch.cuda.synchronize()
    try:
        window = profile_trace(pdir)
        with window:
            (one,) = eng.run()
            torch.cuda.synchronize()
        with open(window.path) as fh:
            events = json.load(fh).get("traceEvents", [])
        result["profile_trace_bytes"] = os.path.getsize(window.path)
    finally:
        shutil.rmtree(pdir, ignore_errors=True)
    ps = eng.metrics.summary()
    pticks = ps["decode_steps"] + ps["prefill_chunks"]
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
    n1 = sum("stream_kernel<0," in e.get("name", "") for e in kernels)
    n11 = sum("paged_attn_kernel" in e.get("name", "") for e in kernels)
    if [int(t) for t in one.output] != untraced[0][:3] or (n1, n11) != (
            7 * arch.n_layers * pticks, arch.n_layers * pticks):
        fail(f"[{tag}] profile window: {n1} kernel-1 and {n11} kernel-11 events in {pticks} "
             f"ticks, tokens {list(one.output)} against {untraced[0][:3]}")
    result["profile_window"] = {"kernel_events": len(kernels), "cac_hw": n1, "paged_attn": n11,
                                "ticks": pticks}
    print(f"[{tag}] --profile-dir window (request 0, 3 tokens, {pticks} ticks): Chrome trace of "
          f"{result['profile_trace_bytes']:,} B, {len(kernels)} kernel events: {n1} "
          f"stream_kernel<0 (kernel 1) and {n11} paged_attn_kernel (kernel 11), 224 and 32 a "
          f"tick; tokens equal the drain's")
    eng = ServeEngine.from_trained(train, arch, engine="paged", n_slots=N_SLOTS, max_len=MAX_LEN,
                                   kv_block_size=BLOCK, prefill_chunk=CHUNK, device=dev)
    reqs = _requests(np, arch.vocab)
    rate = 20.0
    arrivals = np.cumsum(np.random.RandomState(SEED + 1).exponential(1.0 / rate, len(reqs)))
    torch.cuda.synchronize()
    done, makespan = replay_arrivals(eng.scheduler, list(zip(arrivals.tolist(), reqs)))
    outs_r = {r.rid: [int(t) for t in r.output] for r in done}
    if outs_r != untraced:
        fail(f"[{tag}] replay_arrivals at {rate} req/s gave other tokens than the closed loop")
    rs = eng.metrics.summary()
    result["replay"] = {"rate": rate, "last_arrival_s": float(arrivals[-1]),
                        "makespan_s": makespan, "ttft_p50_s": rs.get("ttft_p50_s"),
                        "goodput_tok_s": rs["goodput_tok_s"]}
    print(f"[{tag}] replay_arrivals, Poisson {rate} req/s (last arrival at "
          f"{arrivals[-1]:.3f} s): tokens equal the closed loop's; makespan {makespan:.3f} s, "
          f"goodput {rs['goodput_tok_s']:.1f} tok/s")
    return result


# ---------------------------------------------------------------------------
# phase 7: card vs CPU, one train step of 2 layers at full width
# ---------------------------------------------------------------------------


def _sign_hooks(torch):
    """Hooks on ``ops.cac_train_matmul`` (the route every bika training
    projection takes) for the train parity run. The card's records every
    CAC output it makes (forward and remat recompute, in call order); the
    CPU's computes its own and compares. Where the two differ, each
    difference must be even and at most twice the number of the CPU's
    pre-activations in that output's reduction within TRAIN_SIGN_TIE of 0
    (a Sign that float noise may flip either way); the CPU then takes the
    card's value (the STE backward is unchanged). Any other difference
    fails."""
    from repro_torch.kernels import ops

    route = ops.cac_train_matmul
    queue = []
    stats = {"outputs": 0, "held": 0, "near_zero": 0}

    def record(x, w, beta, **kw):
        y = route(x, w, beta, **kw)
        queue.append(y.detach().cpu())
        return y

    def follow(x, w, beta, **kw):
        y = route(x, w, beta, **kw)
        card, yd = queue.pop(0), y.detach()
        stats["outputs"] += yd.numel()
        diff = card != yd
        if not bool(diff.any()):
            return y
        x2, w, beta = x.detach().reshape(-1, x.shape[-1]), w.detach(), beta.detach()
        d2, c2, y2 = diff.reshape(-1, w.shape[1]), card.reshape(-1, w.shape[1]), yd.reshape(
            -1, w.shape[1])
        for r in d2.any(dim=1).nonzero()[:, 0].tolist():
            near = ((x2[r, :, None] * w + beta).abs() <= TRAIN_SIGN_TIE).sum(dim=0)
            d = (c2[r] - y2[r]).abs()
            bad = d2[r] & ((d > 2 * near) | (torch.remainder(d, 2) != 0))
            if bool(bad.any()):
                fail(f"train parity: {int(bad.sum())} CAC outputs differ between card and CPU "
                     f"by more than their near-zero pre-activations explain")
            stats["near_zero"] += int(near[d2[r]].sum())
        stats["held"] += int(diff.sum())
        return y + torch.where(diff, card - yd, 0)

    def install(side):
        ops.cac_train_matmul = record if side == "card" else follow

    def restore():
        ops.cac_train_matmul = route

    def report():
        if queue:
            fail(f"train parity: the CPU side left {len(queue)} card outputs untaken")
        return (f"{stats['held']} of {stats['outputs']} CAC outputs held to the card's at "
                f"{stats['near_zero']} pre-activations within {TRAIN_SIGN_TIE} of 0")

    return install, restore, report


def _bnn_train_hooks(torch):
    """Hooks on ``ops.bnn_train_matmul`` (the route every bnn training
    projection takes) for the train parity run. The card's records every
    projection input (forward and remat recompute, in call order); the
    CPU's compares its own input's Signs and STE masks with the card's.
    Where a Sign differs, both inputs must lie within BNN_SIGN_TIE of 0;
    where a mask 1[|x| <= 1] differs, both must lie within BNN_WINDOW_TIE of
    |x| = 1. The CPU then takes the card's input value there (the gradient
    still flows to its own x), so both its forward and its backward mask
    follow the card's. Any other difference fails."""
    from repro_torch.kernels import ops

    route = ops.bnn_train_matmul
    queue = []
    stats = {"inputs": 0, "signs": 0, "masks": 0}

    def record(x, w):
        queue.append(x.detach().cpu())
        return route(x, w)

    def follow(x, w):
        card, xd = queue.pop(0), x.detach()
        stats["inputs"] += xd.numel()
        sdiff = (xd >= 0) != (card >= 0)
        mdiff = (xd.abs() <= 1.0) != (card.abs() <= 1.0)
        far_s = torch.maximum(xd.abs(), card.abs())[sdiff]
        far_m = torch.maximum((xd.abs() - 1).abs(), (card.abs() - 1).abs())[mdiff]
        if bool((far_s > BNN_SIGN_TIE).any()) or bool((far_m > BNN_WINDOW_TIE).any()):
            fail(f"train parity: {int(sdiff.sum())} Signs and {int(mdiff.sum())} STE masks of "
                 f"bnn inputs differ between card and CPU, not all at genuine ties")
        stats["signs"] += int(sdiff.sum())
        stats["masks"] += int(mdiff.sum())
        diff = sdiff | mdiff
        if bool(diff.any()):
            x = x + torch.where(diff, card - xd, 0)
        return route(x, w)

    def install(side):
        ops.bnn_train_matmul = record if side == "card" else follow

    def restore():
        ops.bnn_train_matmul = route

    def report():
        if queue:
            fail(f"train parity: the CPU side left {len(queue)} card inputs untaken")
        return (f"of {stats['inputs']} bnn projection inputs, {stats['signs']} Signs (within "
                f"{BNN_SIGN_TIE} of 0) and {stats['masks']} STE masks (within "
                f"{BNN_WINDOW_TIE} of |x| = 1) held to the card's")

    return install, restore, report


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_np(v) for v in tree)
    return tree.detach().cpu().numpy()


def _tree_paths(tree, path=""):
    """Leaf paths of a dict / list tree in ``tree_leaves``'s order (keys
    sorted, lists by index)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _tree_paths(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _tree_paths(v, f"{path}/{i}")]
    return [path]


def _beta_abs_terms(torch, api, params, batch, leaf):
    """For each element of ``leaf`` (a bika dbeta leaf of ``params``, on the
    CPU), the sum of the absolute terms its gradient adds up in one
    ``loss_and_grads``: sum_m |g_mn| 1[|x_mk w_kn + beta_kn| <= 1], g the
    gradient reaching the CAC output (the STE backward's dbeta). A call's
    beta is a view of ``leaf`` where it shares its storage; its offset
    places it."""
    from repro_torch.kernels import ops
    from repro_torch.train.steps import loss_and_grads

    real = ops.cac_train_matmul
    out = torch.zeros(leaf.numel(), dtype=torch.float64)
    ptr = leaf.untyped_storage().data_ptr()

    def spy(x, w, beta, **kw):
        y = real(x, w, beta, **kw)
        if y.requires_grad and beta.untyped_storage().data_ptr() == ptr:
            at, n = beta.storage_offset(), w.numel()
            x2 = x.detach().double().reshape(-1, x.shape[-1])
            mask = ((x2[:, :, None] * w.detach().double() + beta.detach().double()).abs()
                    <= 1.0)

            def hook(g):
                g2 = g.detach().double().reshape(-1, w.shape[1])[:, None, :].abs()
                out[at:at + n] += (g2 * mask).sum(0).reshape(-1)

            y.register_hook(hook)
        return y

    ops.cac_train_matmul = spy
    try:
        loss_and_grads(api, params, batch)
    finally:
        ops.cac_train_matmul = real
    return out.reshape(leaf.shape)


def phase_train_parity(torch, np, dev, mode, hooks, tag="train-parity", layers=2, arch=None,
                       cancelling=()):
    """One train step (loss, gradients, AdamW update) of the same model in
    ``mode`` on the card and on the CPU plain path: smollm-360m at full
    width cut to ``layers`` layers, or ``arch``; the same numpy params (seed
    3) and the same batch (2 x 64 tokens, and the encoder-decoder's frames).

    The CAC outputs are integers, but the float parts (RMSNorm, softmax, the
    head) differ between the two devices by ~1e-7 relative, and a
    pre-activation within that noise of 0 may take either Sign: one flip
    moves an output by 2 gamma / sqrt(K), and later layers follow. So the
    CPU side takes the card's CAC output wherever the two differ at genuine
    near-zero pre-activations (``_sign_hooks``) and fails on any other
    difference. The STE window |pre| <= 1 may differ the same way at an
    element within the noise of 1; that moves one term of a gradient sum and
    does not cascade. The tolerances: loss within TRAIN_PARITY_LOSS
    relative; each gradient leaf and each updated parameter leaf within
    TRAIN_PARITY_REL of its L2 norm (the CPU rehearsal behind these numbers
    is in PERF.md). A bnn model flips the same way where a projection's
    input lies within the noise of 0 (its Sign) or of |x| = 1 (its STE
    mask, which gates a whole element of dx); ``_bnn_train_hooks`` holds
    both at genuine ties. A gradient leaf named in ``cancelling`` (a bika
    dbeta whose terms cancel to below their float32 rounding, as the cross
    attention's key bias: softmax's scores shift alike for every key a
    query sees, so the keys' gradients sum to 0 and only the STE mask's few
    zeros leave a remainder) is held instead to TRAIN_PARITY_REL of the L2
    norm of its absolute terms (``_beta_abs_terms``, on the CPU), the bound
    of any float sum."""
    from repro_torch.configs import get_config
    from repro_torch.core.convert import from_reference
    from repro_torch.data.lm import LMDataConfig, lm_batch
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import OptimizerSpec, make_optimizer, tree_leaves
    from repro_torch.train.steps import loss_and_grads

    arch = arch or get_config("smollm-360m", compute_mode=mode, n_layers=layers)
    api = build_model(arch, phase="train")
    np_params = _tree_np(api.init(3, device="cpu"))
    batch = lm_batch(LMDataConfig(vocab=arch.vocab, seq_len=64, global_batch=2, seed=5,
                                  frames_dim=arch.d_model if arch.family == "encdec" else 0), 0)
    install, restore, report = hooks
    out = {}
    try:
        for side, where in (("card", dev), ("cpu", torch.device("cpu"))):  # the card first
            install(side)
            params = from_reference(np_params, device=where)
            t0 = time.perf_counter()
            met, grads = loss_and_grads(api, params, {k: v.to(where) for k, v in batch.items()})
            init, upd = make_optimizer(OptimizerSpec(peak_lr=1e-3, warmup=0, total_steps=10))
            params, _, _ = upd(grads, init(params), params)
            loss = float(met["loss"])
            out[side] = (loss, [t.cpu() for t in tree_leaves(grads)],
                         [t.cpu() for t in tree_leaves(params)], time.perf_counter() - t0)
    finally:
        restore()
    held = report()
    (lc, gc, pc, tc), (lp, gp, pp, tp) = out["card"], out["cpu"]
    loss_rel = abs(lc - lp) / abs(lp)
    paths = _tree_paths(np_params)
    scale = {}
    for name in cancelling:
        cpu_params = from_reference(np_params, device="cpu")
        leaf = cpu_params
        for key in name.strip("/").split("/"):
            leaf = leaf[key]
        scale[name] = float(_beta_abs_terms(torch, api, cpu_params, batch, leaf).norm())
    rel = lambda a, b, den: float((a - b).norm() / max(den, 1e-30))
    g_rels = [rel(a, b, scale.get(path, float(b.norm()))) for path, a, b in zip(paths, gc, gp)]
    g_rel, worst = max(zip(g_rels, paths))
    p_rel = max(rel(a, b, float(b.norm())) for a, b in zip(pc, pp))
    if not (np.isfinite(lc) and loss_rel <= TRAIN_PARITY_LOSS):
        fail(f"{tag}: loss card {lc} cpu {lp} (relative {loss_rel:.3e} > "
             f"{TRAIN_PARITY_LOSS})")
    if not (g_rel <= TRAIN_PARITY_REL and p_rel <= TRAIN_PARITY_REL):
        fail(f"{tag}: worst leaf relative L2 gradient {g_rel:.3e} ({worst}), parameter "
             f"{p_rel:.3e} (limit {TRAIN_PARITY_REL})")
    print(f"[{tag}] {arch.name} {mode}, {arch.n_layers} layers, d_model {arch.d_model}, one "
          f"train step, card vs CPU plain path: "
          f"loss {lc:.6f} vs {lp:.6f} (relative {loss_rel:.2e}, limit {TRAIN_PARITY_LOSS}); "
          f"worst leaf relative L2 gradient {g_rel:.2e} ({worst}), parameter {p_rel:.2e} "
          f"(limit {TRAIN_PARITY_REL})"
          + "".join(f"; {name} held to its absolute terms' norm {v:.3e}"
                    for name, v in scale.items()) + f"; {held}; card {tc:.1f} s, CPU {tp:.1f} s")
    return {"loss_card": lc, "loss_cpu": lp, "loss_rel": loss_rel, "grad_rel": g_rel,
            "param_rel": p_rel, "held": held}


# ---------------------------------------------------------------------------
# phase 14: the paper's models (TFC, SFC, LFC, CNV) at their published widths
# ---------------------------------------------------------------------------

# Table II's structures at batch 128: each distinct (M, K, N) a projection
# of them gives the training and serving kernels (a CNV conv's M is batch x
# H x W of its im2col; conv1's K = 3 x 3 x 3 = 27 and every head's N = 10
# take the kernels' ragged branches)
PAPER_BATCH, PAPER_STEPS, PAPER_PARITY_BATCH = 128, 3, 8
PAPER_SHAPES = [
    ("tfc fc1", 128, 784, 64), ("tfc fc2", 128, 64, 32), ("tfc fc3", 128, 32, 10),
    ("sfc fc2", 128, 256, 256),
    ("lfc fc1", 128, 784, 1024), ("lfc fc2", 128, 1024, 1024), ("lfc fc4", 128, 1024, 10),
    ("cnv conv1", 131072, 27, 64), ("cnv conv2", 131072, 576, 64),
    ("cnv conv3", 32768, 576, 128), ("cnv conv4", 32768, 1152, 128),
    ("cnv conv5", 8192, 1152, 256), ("cnv conv6", 8192, 2304, 256),
    ("cnv fc1", 128, 4096, 512), ("cnv fc2", 128, 512, 512), ("cnv fc3", 128, 512, 10)]
_PLAIN_ELEMS = 1 << 24  # (rows, K, N) elements a slice of the window masks


def phase_paper_kernels(torch, np, dev, flush):
    """Every kernel on the paper models' paths against its plain version at
    PAPER_SHAPES, on the card: the training CAC forward (kernel 2) and the
    CAC on int8 codes (kernel 1; at K = 27 through the serve tree's pad to
    K' = 32, ``backend.pad_contraction``) bit-exact; the STE backward, fused
    (5) and split (3 + 4), off the |pre| = 1 edge, dx within TRAIN_TOL and
    dw, dbeta within ``_m_tol(M)`` (absolute above 512 rows); the sign
    product (6) on float32 weights (training) and int8 signs (serving)
    bit-exact; its SignSTE dx and dw (8,
    9) on every element, dx within TRAIN_TOL, dw within ``_m_tol(M)``; the
    int8 matmul (10) bit-exact. Each timed, L2 flushed, beside
    its plain version, the bnn kernels also beside torch.matmul on +-1
    operands, and the bound as the main rows count it (bytes and operations
    per (M, K, N): kernels 2-5 4, 9, 6, 7 operations on the CUDA cores;
    1 two; 6, 8, 9 two at the bf16 tensor-core rate; 10 two at the int8
    rate). The plain versions (kernel 1's: ``bika_matmul_hw_tiled``) and
    the window masks run a slice of rows at a time: at CNV's im2col M
    (131,072) nothing else fits."""
    from repro_torch.core.backend import pack_signs, pad_contraction
    from repro_torch.core.bika import bika_matmul_hw_tiled
    from repro_torch.kernels import bnn_matmul as bnn
    from repro_torch.kernels import cac_matmul as cac
    from repro_torch.kernels import qnn_matmul as qnn

    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    sign = lambda v: torch.where(v >= 0, 1.0, -1.0).to(torch.float32)
    rows = []
    for where, m, k, n in PAPER_SHAPES:
        rnd = lambda *shape, s=1.0: torch.randn(shape, generator=gen, device=dev) * s
        x, w, beta, g = rnd(m, k), rnd(k, n, s=0.5), rnd(k, n, s=0.5), rnd(m, n)
        row = {"where": where, "M": m, "K": k, "N": n,
               "fwd_splits": cac.card_train_fwd_plan(dev.index or 0, m, k, n)[0],
               "bwd_cluster": cac.card_train_bwd_plan(dev.index or 0, m, k, n),
               "dw_plan": list(cac.card_train_bwd_dw_plan(dev.index or 0, m, k, n))}
        y = cac.cac_train_fwd_call(x, w, beta)
        if not torch.equal(y, cac.cac_train_fwd_plain(x, w, beta)):
            fail(f"paper cac_train_fwd {where} M={m} K={k} N={n}: differs from plain")
        plain = cac.cac_train_bwd_fused_plain(x, w, beta, g)
        dx_keep, dw_keep = _window_clear(torch, x, w, beta,
                                         rows=max(1, _PLAIN_ELEMS // (k * n)))
        got = {"fused": cac.cac_train_bwd_fused_call(x, w, beta, g),
               "split": (cac.cac_train_bwd_dx_call(x, w, beta, g),)
               + cac.cac_train_bwd_dw_call(x, w, beta, g)}
        for which, grads in got.items():
            for name, a, b, keep in zip(("dx", "dw", "dbeta"), grads, plain,
                                        (dx_keep, dw_keep, dw_keep)):
                tol, rtol = (TRAIN_TOL, TRAIN_TOL) if name == "dx" else _m_tol(m)
                err, ok = _close_err(torch, a, b, keep, tol, rtol)
                row[f"{name}_{which}_max_abs_err"] = err
                if not ok:
                    fail(f"paper cac_train {which} {name} {where} M={m} K={k} N={n}: beyond "
                         f"atol {tol:.2e}, rtol {rtol:.0e} (max |diff| {err:.3e})")
        row["left_out"] = {"dx": int((~dx_keep).sum()), "dw": int((~dw_keep).sum())}
        del plain, got, dx_keep, dw_keep
        x_int = torch.randint(-128, 128, (m, k), generator=gen, device=dev).to(torch.int8)
        tau = torch.randint(-128, 128, (k, n), generator=gen, device=dev).to(torch.int8)
        s = torch.where(torch.rand((k, n), generator=gen, device=dev) < 0.5, 1, -1).to(torch.int8)
        tau_pad, s_pad = pad_contraction(tau, s)
        kp = tau_pad.shape[0]
        x_pad = torch.nn.functional.pad(x_int, (0, kp - k))
        sp = pack_signs(s_pad)
        if not torch.equal(cac.cac_matmul_kernel_call(x_pad, tau_pad, sp) - (kp - k),
                           bika_matmul_hw_tiled(x_int, tau, s)):
            fail(f"paper cac_matmul {where} M={m} K={k} N={n}: differs from bika_matmul_hw")
        wb = sign(w).to(torch.int8)
        for name, a, b in (("f32", bnn.bnn_matmul_kernel_call(x, w), bnn.bnn_matmul_plain(x, w)),
                           ("int8", bnn.bnn_matmul_kernel_call(x, wb),
                            bnn.bnn_matmul_plain(x, wb))):
            if not torch.equal(a, b):
                fail(f"paper bnn_matmul ({name} weights) {where} M={m} K={k} N={n}: differs "
                     f"from plain")
        for name, a, b in (("dx", bnn.bnn_bwd_dx_call(x, w, g), bnn.bnn_bwd_dx_plain(x, w, g)),
                           ("dw", bnn.bnn_bwd_dw_call(x, w, g), bnn.bnn_bwd_dw_plain(x, w, g))):
            tol, rtol = (TRAIN_TOL, TRAIN_TOL) if name == "dx" else _m_tol(m)
            err, ok = _close_err(torch, a, b, torch.ones_like(a, dtype=torch.bool), tol, rtol)
            row[f"bnn_{name}_max_abs_err"] = err
            if not ok:
                fail(f"paper bnn_bwd_{name} {where} M={m} K={k} N={n}: beyond atol {tol:.2e}, "
                     f"rtol {rtol:.0e} (max |diff| {err:.3e})")
        w_int = torch.randint(-127, 128, (k, n), generator=gen, device=dev).to(torch.int8)
        ws = torch.rand((1, n), generator=gen, device=dev) * 1e-2 + 1e-4
        if not torch.equal(qnn.qnn_matmul_kernel_call(x_int, w_int, ws, ACT_SCALE),
                           qnn.qnn_matmul_plain(x_int, w_int, ws, ACT_SCALE)):
            fail(f"paper qnn_matmul {where} M={m} K={k} N={n}: differs from plain")
        xs, ws_pm = sign(x), sign(w)
        mkn = float(m) * k * n
        timed = {
            "cac_train_fwd": (lambda: cac.cac_train_fwd_call(x, w, beta),
                              lambda: cac.cac_train_fwd_plain(x, w, beta), None,
                              4 * (m * k + 2 * k * n + m * n), 4 * mkn, CUDA_CORE_OPS_S),
            "cac_train_bwd_fused": (lambda: cac.cac_train_bwd_fused_call(x, w, beta, g),
                                    lambda: cac.cac_train_bwd_fused_plain(x, w, beta, g), None,
                                    4 * (2 * m * k + 4 * k * n + m * n), 9 * mkn,
                                    CUDA_CORE_OPS_S),
            "cac_train_bwd_dx": (lambda: cac.cac_train_bwd_dx_call(x, w, beta, g),
                                 lambda: cac.cac_train_bwd_dx_plain(x, w, beta, g), None,
                                 4 * (2 * m * k + 2 * k * n + m * n), 6 * mkn, CUDA_CORE_OPS_S),
            "cac_train_bwd_dw": (lambda: cac.cac_train_bwd_dw_call(x, w, beta, g),
                                 lambda: cac.cac_train_bwd_dw_plain(x, w, beta, g), None,
                                 4 * (m * k + 4 * k * n + m * n), 7 * mkn, CUDA_CORE_OPS_S),
            "cac_matmul": (lambda: cac.cac_matmul_kernel_call(x_pad, tau_pad, sp),
                           lambda: bika_matmul_hw_tiled(x_int, tau, s), None,
                           m * k + k * n + k * n // 8 + 4 * m * n, 2 * mkn, CUDA_CORE_OPS_S),
            "bnn_matmul": (lambda: bnn.bnn_matmul_kernel_call(x, w),
                           lambda: bnn.bnn_matmul_plain(x, w), lambda: torch.matmul(xs, ws_pm),
                           4 * (m * k + k * n + m * n), 2 * mkn, TENSOR_CORE_OPS_S),
            "bnn_matmul_int8": (lambda: bnn.bnn_matmul_kernel_call(x, wb),
                                lambda: bnn.bnn_matmul_plain(x, wb),
                                lambda: torch.matmul(xs, ws_pm),
                                4 * m * k + k * n + 4 * m * n, 2 * mkn, TENSOR_CORE_OPS_S),
            "bnn_bwd_dx": (lambda: bnn.bnn_bwd_dx_call(x, w, g),
                           lambda: bnn.bnn_bwd_dx_plain(x, w, g),
                           lambda: torch.matmul(g, ws_pm.T),
                           4 * (2 * m * k + k * n + m * n), 2 * mkn, TENSOR_CORE_OPS_S),
            "bnn_bwd_dw": (lambda: bnn.bnn_bwd_dw_call(x, w, g),
                           lambda: bnn.bnn_bwd_dw_plain(x, w, g),
                           lambda: torch.matmul(xs.T, g),
                           4 * (m * k + 2 * k * n + m * n), 2 * mkn, TENSOR_CORE_OPS_S),
            "qnn_matmul": (lambda: qnn.qnn_matmul_kernel_call(x_int, w_int, ws, ACT_SCALE),
                           lambda: qnn.qnn_matmul_plain(x_int, w_int, ws, ACT_SCALE), None,
                           m * k + k * n + 4 * n + 4 * m * n, 2 * mkn, INT8_TENSOR_OPS_S),
        }
        for name, (kern, plain_fn, lib, nbytes, ops, rate) in timed.items():
            bound, by = _bound(nbytes, ops, rate)
            r = {"ms": time_ms(torch, kern, iters=10, warmup=2, flush=flush),
                 "plain_ms": time_ms(torch, plain_fn, iters=2, warmup=1, flush=flush),
                 "library_ms": (time_ms(torch, lib, iters=10, warmup=2, flush=flush)
                                if lib is not None else None),
                 "bound_ms": bound, "bound_by": by}
            r["bound_share"] = bound / r["ms"]
            row[name] = r
        row["qnn_route"] = qnn._card_plan(dev.index or 0, m, k, n)[0]
        row["bnn_route"] = bnn._card_fwd_plan(dev.index or 0, m, k, n, torch.float32)[0]
        rows.append(row)
        print(f"[paper-kernels] {where} M={m} K={k} N={n}: kernels 1, 2, 6, 10 bit-exact, "
              f"3-5, 8, 9 dx within {TRAIN_TOL}, dw and dbeta within atol {_m_tol(m)[0]:.2e}, "
              f"rtol {_m_tol(m)[1]:.0e} (max "
              f"|diff| kernel 5 dw {row['dw_fused_max_abs_err']:.2e}, dbeta "
              f"{row['dbeta_fused_max_abs_err']:.2e}; left out dx {row['left_out']['dx']}, dw "
              f"{row['left_out']['dw']}); plans fwd splits {row['fwd_splits']}, bwd cluster "
              f"{row['bwd_cluster']}, dw {row['dw_plan']}, bnn {row['bnn_route']}, qnn "
              f"{row['qnn_route']}; ms (plain, bound share): "
              + ", ".join(f"{nm} {row[nm]['ms']:.5f} ({row[nm]['plain_ms']:.3f}, "
                          f"{100 * row[nm]['bound_share']:.1f}%)" for nm in timed))
        del x, w, beta, g, x_int, tau, s, x_pad, tau_pad, s_pad, sp, xs, ws_pm, wb, w_int, timed
    return rows


def _paper_expect(cfg, split=False):
    """Exact kernel launches of one training step of ``cfg``: each
    projection (conv or fc) runs its forward kernel once and its backward
    once (no remat in the paper models; kernel 5 or 3 computes dx even for
    the first layer, whose input needs none)."""
    n = len(cfg.features) + (len([c for c in cfg.conv_plan if c != "P"])
                             if cfg.kind == "cnv" else 0)
    if cfg.mode == "bika":
        bwd = ({"cac_train_bwd_dx": n, "cac_train_bwd_dw": n} if split
               else {"cac_train_bwd_fused": n})
        return dict({"cac_train_fwd": n}, **bwd)
    if cfg.mode == "bnn":
        return {"bnn": n, "bnn_bwd_dx": n, "bnn_bwd_dw": n}
    return {}  # dense and qnn8 train with plain float matmuls


def _paper_train(torch, ops, cfg, dev, steps, split_last=False, tag="paper-train"):
    """``steps`` training steps of ``cfg`` at batch PAPER_BATCH from seed
    SEED (the recipe of train/paper.py), launch counts zeroed just before
    each step and read just after; a last extra step with the split STE
    backward (kernels 3 and 4) if ``split_last``. Returns the trained
    params and the per-step rows."""
    from repro_torch.models.paper import build_paper_model
    from repro_torch.optim.adamw import OptimizerSpec, make_optimizer
    from repro_torch.train.paper import PAPER_LOSS, dataset_batch, image_api
    from repro_torch.train.steps import loss_and_grads

    init, apply = build_paper_model(cfg, device=dev)
    api = image_api(apply)
    params = init(SEED)
    total = steps + int(split_last)
    opt_init, opt_update = make_optimizer(OptimizerSpec(
        peak_lr=3e-3, warmup=max(total // 20, 10), total_steps=total, weight_decay=0.0))
    opt = opt_init(params)
    get_batch = dataset_batch("textures" if cfg.kind == "cnv" else "digits")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for step in range(total):
        split = split_last and step == steps
        x, y = get_batch(SEED, step, PAPER_BATCH, device=dev)
        torch.cuda.synchronize()
        ops.reset_launches()
        ops.FUSED_BWD_DEFAULT = not split
        try:
            t0 = time.perf_counter()
            metrics, grads = loss_and_grads(api, params, {"x": x, "labels": y}, **PAPER_LOSS)
            params, opt, stats = opt_update(grads, opt, params)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            ops.FUSED_BWD_DEFAULT = True
        counts = ops.launch_counts()
        expect = _paper_expect(cfg, split)
        if counts != dict(_NO_LAUNCHES, **expect):
            fail(f"{tag} {cfg.name} {cfg.mode} step {step}: launch counts {counts}, expected "
                 f"{expect} and 0 elsewhere")
        if not math.isfinite(loss):
            fail(f"{tag} {cfg.name} {cfg.mode} step {step}: loss {loss}")
        rows.append({"step": step, "loss": loss, "ms": ms, "split": split,
                     "grad_norm": float(stats["grad_norm"]),
                     "launches": {k: v for k, v in counts.items() if v}})
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] {cfg.name} {cfg.mode} batch {PAPER_BATCH}: losses "
          f"{[round(r['loss'], 5) for r in rows]}, ms/step {[round(r['ms'], 1) for r in rows]}"
          f", launches a step {rows[0]['launches']}"
          + (f" (split step {rows[-1]['launches']})" if split_last else "")
          + f", peak memory {peak / 2**30:.2f} GiB")
    return params, {"steps": rows, "max_memory_allocated": peak}


def phase_paper_parity(torch, np, dev, tag="paper-parity"):
    """One bika training step of CNV at full width (the whole conv plan and
    the 512-512-10 head) on PAPER_PARITY_BATCH // 2 images, on the card and
    on the CPU plain path, from the same numpy params and batch: loss
    within TRAIN_PARITY_LOSS relative, each gradient and each updated
    parameter within TRAIN_PARITY_REL of its L2 norm, CAC outputs held to
    the card's at near-zero pre-activations (``_sign_hooks``, as
    phase_train_parity). Also the largest |dw| of each layer: how much
    gradient reaches each conv down the stack."""
    from repro_torch.core.convert import from_reference
    from repro_torch.data.vision import textures_batch
    from repro_torch.models.paper import CNV, build_paper_model
    from repro_torch.optim.adamw import OptimizerSpec, make_optimizer, tree_leaves
    from repro_torch.train.paper import PAPER_LOSS, image_api
    from repro_torch.train.steps import loss_and_grads

    cfg = CNV.replace(mode="bika")
    np_params = _tree_np(build_paper_model(cfg, device="cpu")[0](SEED + 3))
    x, y = textures_batch(SEED + 5, 0, PAPER_PARITY_BATCH // 2, device="cpu")
    install, restore, report = _sign_hooks(torch)
    out = {}
    try:
        for side, where in (("card", dev), ("cpu", torch.device("cpu"))):  # the card first
            install(side)
            apply = build_paper_model(cfg, device=where)[1]
            params = from_reference(np_params, device=where)
            t0 = time.perf_counter()
            metrics, grads = loss_and_grads(image_api(apply), params,
                                            {"x": x.to(where), "labels": y.to(where)},
                                            **PAPER_LOSS)
            init, upd = make_optimizer(OptimizerSpec(peak_lr=1e-3, warmup=0, total_steps=10))
            params, _, _ = upd(grads, init(params), params)
            out[side] = (float(metrics["loss"]), [t.cpu() for t in tree_leaves(grads)],
                         [t.cpu() for t in tree_leaves(params)], time.perf_counter() - t0,
                         [float(layer["w"].abs().max()) for layer in grads["conv"] + grads["fc"]])
    finally:
        restore()
    held = report()
    (lc, gc, pc, tc, dw_max), (lp, gp, pp, tp, _) = out["card"], out["cpu"]
    loss_rel = abs(lc - lp) / abs(lp)
    rel = lambda a, b: float((a - b).norm() / b.norm().clamp_min(1e-30))
    g_rel = max(rel(a, b) for a, b in zip(gc, gp))
    p_rel = max(rel(a, b) for a, b in zip(pc, pp))
    if not (np.isfinite(lc) and loss_rel <= TRAIN_PARITY_LOSS):
        fail(f"{tag}: loss card {lc} cpu {lp} (relative {loss_rel:.3e} > {TRAIN_PARITY_LOSS})")
    if not (g_rel <= TRAIN_PARITY_REL and p_rel <= TRAIN_PARITY_REL):
        fail(f"{tag}: worst leaf relative L2 gradient {g_rel:.3e}, parameter {p_rel:.3e} "
             f"(limit {TRAIN_PARITY_REL})")
    print(f"[{tag}] CNV bika at full width, {PAPER_PARITY_BATCH // 2} images, one train step, "
          f"card vs CPU plain path: loss {lc:.6f} vs {lp:.6f} (relative {loss_rel:.2e}, limit "
          f"{TRAIN_PARITY_LOSS}); worst leaf relative L2 gradient {g_rel:.2e}, parameter "
          f"{p_rel:.2e} (limit {TRAIN_PARITY_REL}); {held}; card {tc:.1f} s, CPU {tp:.1f} s; "
          f"max |dw| a layer, conv1 .. fc3: {', '.join(f'{v:.3e}' for v in dw_max)}")
    return {"loss_card": lc, "loss_cpu": lp, "loss_rel": loss_rel, "grad_rel": g_rel,
            "param_rel": p_rel, "held": held, "dw_max_per_layer": dw_max}


def _paper_serve(torch, np, ops, cfg, params, dev, tag="paper-serve"):
    """``paper_model_to_serve`` of trained ``params``, then the served
    forward: at PAPER_BATCH on the card (timed; one launch of the mode's
    serve kernel a projection, 0 elsewhere), and on PAPER_PARITY_BATCH
    images on the card and on the CPU, whose logits must be equal bit for
    bit once the activation codes agree (``_code_hooks`` holds them at
    genuine half-way ties)."""
    from repro_torch.core.convert import from_reference
    from repro_torch.models.paper import build_paper_model, paper_model_to_serve

    served = paper_model_to_serve(params, cfg)
    apply = build_paper_model(cfg, phase="serve", device=dev)[1]
    dataset = "textures" if cfg.kind == "cnv" else "digits"
    from repro_torch.train.paper import dataset_batch

    x, _ = dataset_batch(dataset)(SEED + 7, 0, PAPER_BATCH, device=dev)
    n_proj = len(cfg.features) + (len([c for c in cfg.conv_plan if c != "P"])
                                  if cfg.kind == "cnv" else 0)
    route = {"bika": "cac_hw", "bnn": "bnn", "qnn8": "qnn8"}[cfg.mode]
    with torch.no_grad():
        apply(served, x)  # warm: plans and the first launches
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        logits = apply(served, x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        if counts != dict(_NO_LAUNCHES, **{route: n_proj}):
            fail(f"{tag} {cfg.name} {cfg.mode}: launch counts {counts}, expected {n_proj} "
                 f"{route} and 0 elsewhere")
        if tuple(logits.shape) != (PAPER_BATCH, 10) or not bool(torch.isfinite(logits).all()):
            fail(f"{tag} {cfg.name} {cfg.mode}: logits {tuple(logits.shape)}, finite "
                 f"{bool(torch.isfinite(logits).all())}")
        xs = x[:PAPER_PARITY_BATCH]
        np_served = _tree_np(served)
        install, restore, report = _code_hooks(torch)
        out = {}
        try:
            for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
                install(side)
                out[side] = build_paper_model(cfg, phase="serve", device=where)[1](
                    from_reference(np_served, device=where), xs.to(where)).cpu()
        finally:
            restore()
    if not torch.equal(out["card"], out["cpu"]):
        fail(f"{tag} {cfg.name} {cfg.mode}: served logits differ between card and CPU by up "
             f"to {float((out['card'] - out['cpu']).abs().max()):.3e} ({report()})")
    print(f"[{tag}] {cfg.name} {cfg.mode}: served forward at batch {PAPER_BATCH} {ms:.2f} ms, "
          f"{n_proj} {route} launches; {PAPER_PARITY_BATCH} images card == CPU bit for bit "
          f"({report()})")
    return {"ms": ms, "launches": {route: n_proj}, "held": report()}


def phase_paper(torch, np, dev, flush):
    """The paper slice: kernels at the paper's shapes, TFC/SFC/LFC/CNV
    trained in bika at full width (a split-backward step on CNV), TFC in
    dense, bnn and qnn8, CNV's card-vs-CPU step, the served forwards (bika
    for all four, CNV's first conv through the K' = 27 pad; bnn and qnn8
    on TFC) and the quickstart at 200 steps. The launch counts of the
    paper path (every training and serving step above) are summed into
    ``launches``; each on-path kernel must have run in it."""
    from repro_torch.kernels import ops
    from repro_torch.launch import quickstart
    from repro_torch.models.paper import CNV, LFC, SFC, TFC

    t0 = time.perf_counter()
    kernel_rows = phase_paper_kernels(torch, np, dev, flush)
    out = {"kernels": kernel_rows, "train": {}, "serve": {}}
    launches = dict(_NO_LAUNCHES)
    trained = {}
    for base in (TFC, SFC, LFC, CNV):
        cfg = base.replace(mode="bika")
        trained[(base.name, "bika")], out["train"][f"{base.name} bika"] = _paper_train(
            torch, ops, cfg, dev, PAPER_STEPS, split_last=base is CNV)
    for mode in ("dense", "bnn", "qnn8"):
        trained[("tfc", mode)], out["train"][f"tfc {mode}"] = _paper_train(
            torch, ops, TFC.replace(mode=mode), dev, PAPER_STEPS)
    for r in out["train"].values():
        for step in r["steps"]:
            for k, v in step["launches"].items():
                launches[k] += v
    out["parity"] = phase_paper_parity(torch, np, dev)
    for (name, mode), params in trained.items():
        if mode == "dense":
            continue
        cfg = {"tfc": TFC, "sfc": SFC, "lfc": LFC, "cnv": CNV}[name].replace(mode=mode)
        r = _paper_serve(torch, np, ops, cfg, params, dev)
        out["serve"][f"{name} {mode}"] = r
        for k, v in r["launches"].items():
            launches[k] += v
    missing = [k for k in ("cac_hw", "cac_train_fwd", "cac_train_bwd_fused", "cac_train_bwd_dx",
                           "cac_train_bwd_dw", "bnn", "bnn_bwd_dx", "bnn_bwd_dw", "qnn8")
               if not launches[k]]
    if missing:
        fail(f"paper: kernels of the path never launched: {missing}")
    out["launches"] = launches
    q = quickstart.run(steps=200, device=dev, log=lambda s: print(f"[paper-quickstart] {s}"))
    if q["match"] < quickstart.MATCH_MIN or not q["exact"]:
        fail(f"paper quickstart: (a) {q['match']:.4f} of units agree (need "
             f"{quickstart.MATCH_MIN}), (b) bit-equal {q['exact']}")
    out["quickstart"] = q
    out["seconds"] = time.perf_counter() - t0
    print(f"[paper] launches on the paper path {({k: v for k, v in launches.items() if v})}; "
          f"{out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the moe phase: the rest of the lm family (mixtral-8x22b on the static
# engine, nemotron-4-15b on the paged engine) at full width
# ---------------------------------------------------------------------------

MOE_LAYERS = 2  # mixtral-8x22b and nemotron-4-15b cut from 56 / 32 layers
MOE_LONG_LEN = 4352  # past mixtral's 4,096-position window
MOE_LONG_PROMPTS = (4090, 4200)  # wraps the ring during decode; folds at prefill
MOE_PARITY_STEPS = 4
MOE_PARITY_LAYERS = 1  # mixtral's card-vs-CPU parity: 1 of the 2 served layers
MOE_PARITY_LAYER_STEPS = 2  # and 2 decode steps after its prefill
NEMOTRON_PARITY_LAYERS = 1  # nemotron's card-vs-CPU parity: 1 of the 2 served layers
ROUTE_TIE = 1e-6  # gates this close: an expert choice the two devices may order either way
# mixtral-8x22b's kernel-1 shapes, (where, M, K, N): an expert's gate/up and
# down at decode (capacity 1), at the short drain's first prefill (4 rows of
# 11 tokens: capacity 13) and at the long drain's 4,200-token prefill
# (capacity 1,312); the attention's q/o and k/v at the same M
MIXTRAL_CAC = [("decode expert gate/up", 1, 6144, 16384), ("decode expert down", 1, 16384, 6144),
               ("decode q/o", 4, 6144, 6144), ("decode k/v", 4, 6144, 1024),
               ("prefill expert gate/up", 13, 6144, 16384),
               ("prefill expert down", 13, 16384, 6144),
               ("prefill q/o", 44, 6144, 6144), ("prefill k/v", 44, 6144, 1024),
               ("long prefill expert gate/up", 1312, 6144, 16384),
               ("long prefill q/o", 4200, 6144, 6144)]
# kernel 11 at the lm family's new GQA groups (config, Hq, Hkv, D)
NEW_GROUPS = [("nemotron-4-15b", 48, 8, 128), ("qwen1.5-32b", 40, 40, 128),
              ("phi3-mini-3.8b", 32, 32, 96), ("chameleon-34b", 64, 8, 128)]


def phase_moe_kernels(torch, np, dev, flush):
    """Kernel 1 at mixtral's (M, K, N) (``MIXTRAL_CAC``) bit-exact against
    its plain version and repeatable, timed beside its bound; kernel 11 at
    the four new (G, D) (``NEW_GROUPS``), decode (B = 4, T = 8) and a
    prefill chunk (C = 32), fp32 and int8 pools, within ATTN_TOL and
    repeatable on attn_plan's plan, timed beside its bound."""
    from repro_torch.core.backend import pack_signs
    from repro_torch.kernels import paged_attn as pa
    from repro_torch.kernels.cac_matmul import (cac_matmul_kernel_call, cac_matmul_plain,
                                                card_stream_plan)
    from repro_torch.kernels.paged_attn import paged_attn_kernel_call
    from repro_torch.kernels.ref import paged_attention_ref

    rng = np.random.default_rng(SEED + 11)
    cac_rows = []
    for where, m, k, n in MIXTRAL_CAC:
        x = torch.from_numpy(rng.integers(-128, 128, size=(m, k)).astype(np.int8)).to(dev)
        tau = torch.from_numpy(rng.integers(-128, 128, size=(k, n)).astype(np.int8)).to(dev)
        s = np.where(rng.random((k, n)) < 0.5, 1, -1).astype(np.int8)
        sp = pack_signs(torch.from_numpy(s)).to(dev)
        got = cac_matmul_kernel_call(x, tau, sp)
        again = cac_matmul_kernel_call(x, tau, sp)
        want = cac_matmul_plain(x, tau, sp)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if err != 0.0 or not torch.equal(got, again):
            fail(f"moe cac_matmul {where} M={m} K={k} N={n}: max |kernel - plain| = {err}, "
                 f"repeatable {torch.equal(got, again)}")
        big = m > 64  # the plain version takes seconds there: timed once
        row = {"moe": f"mixtral-8x22b {where}", "M": m, "K": k, "N": n, "max_abs_err": err,
               "plan": list(card_stream_plan(x.device.index, m, k, n)),
               "ms": time_ms(torch, lambda: cac_matmul_kernel_call(x, tau, sp),
                             iters=5 if big else 20, flush=flush),
               "plain_ms": time_ms(torch, lambda: cac_matmul_plain(x, tau, sp),
                                   iters=1 if big else 5, warmup=0 if big else 1, flush=flush)}
        nbytes = m * k + k * n + k * n // 8 + 4 * m * n
        row["bound_ms"], row["bound_by"] = _bound(nbytes, 2.0 * m * k * n, CUDA_CORE_OPS_S)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        cac_rows.append(row)
        print(f"[moe-kernels] cac_matmul {where} M={m} K={k} N={n} bit-exact, repeatable; "
              f"plan {row['plan']} ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} "
              f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}, "
              f"{100 * row['bound_share']:.1f}%)")
        del x, tau, sp, got, again, want
    attn_rows = []
    for config, hq, hkv, d in NEW_GROUPS:
        for name, b, c, t in (("decode", N_SLOTS, 1, MAX_LEN // BLOCK),
                              ("chunk", 1, CHUNK, MAX_LEN // BLOCK)):
            for quantized in (False, True):
                q, k, v, tables, q_pos, ks, vs = _paged_case(torch, np, rng, dev, b, c, t,
                                                             quantized, hq=hq, hkv=hkv, d=d)
                got = paged_attn_kernel_call(q, k, v, tables, q_pos, k_scale=ks, v_scale=vs)
                again = paged_attn_kernel_call(q, k, v, tables, q_pos, k_scale=ks, v_scale=vs)
                torch.cuda.synchronize()
                want = paged_attention_ref(q, k, v, tables, q_pos, ks, vs)
                err = float((got - want).abs().max())
                plan = pa.card_plan(b, c, hq, hkv, d, BLOCK, t)
                if not err <= ATTN_TOL or not _bits_equal(torch, got, again):
                    fail(f"moe paged_attn {config} {name} int8={quantized}: max |kernel - "
                         f"plain| = {err}, repeatable {_bits_equal(torch, got, again)}")
                if plan is None or plan[:2] != pa.attn_plan(b, c, hq, hkv, d, BLOCK, t):
                    fail(f"moe paged_attn {config} {name}: the kernel's plan {plan} is not "
                         f"attn_plan's")
                row = {"moe": config, "case": name, "B": b, "C": c, "T": t, "Hq": hq,
                       "Hkv": hkv, "G": hq // hkv, "D": d, "int8": quantized,
                       "max_abs_err": err, "plan": {"q_tile": plan[0], "splits": plan[1]},
                       "ms": time_ms(torch, lambda: paged_attn_kernel_call(
                           q, k, v, tables, q_pos, k_scale=ks, v_scale=vs), flush=flush),
                       "plain_ms": time_ms(torch, lambda: paged_attention_ref(
                           q, k, v, tables, q_pos, ks, vs), iters=5, flush=flush)}
                row["bound_ms"], row["bound_by"] = _attn_bound(q, k, tables, q_pos, quantized)
                attn_rows.append(row)
                print(f"[moe-kernels] paged_attn {config} G={hq // hkv} D={d} {name} B={b} "
                      f"C={c} T={t} int8={quantized} plan q_tile={plan[0]} "
                      f"splits={plan[1]} max_abs_err={err:.3e} repeatable "
                      f"ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} "
                      f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']})")
    return cac_rows, attn_rows


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def _gb(nbytes):
    return nbytes / 1e9


def _counted_forwards(ops, eng, log):
    """Wrap the engine's prefill and decode_step so that each call logs the
    kernel launches it made (host counters: no synchronise)."""
    def wrap(kind, fn):
        def run(*a, **kw):
            before = ops.launch_counts()
            out = fn(*a, **kw)
            after = ops.launch_counts()
            log.append((kind, {name: after[name] - before[name] for name in after}))
            return out
        return run

    api = eng.api
    eng.api = api._replace(prefill=wrap("prefill", api.prefill),
                           decode_step=wrap("decode", api.decode_step))
    return api


def _static_drain(torch, np, ops, eng, reqs, route, tag, extra=None):
    """Drain ``reqs`` through a static engine (``extra`` is its
    ``extra_batch``: the encdec family's frames) with the launch counters
    zeroed just before and read just after; every forward (a batch's
    prefill or a decode step) must launch exactly ``_forward_launches`` of
    ``route`` for its kind and nothing else. -> (tokens by rid, counts,
    forwards, decode steps, wall s, peak GB)."""
    log = []
    api = _counted_forwards(ops, eng, log)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run(extra_batch=extra)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    eng.api = api
    peak = _gb(torch.cuda.max_memory_allocated())
    total = 0
    for i, (kind, delta) in enumerate(log):
        per = _forward_launches(eng.arch, kind)
        total += per
        if delta != dict(_NO_LAUNCHES, **{route: per}):
            fail(f"[{tag}] forward {i} ({kind}): launches {delta} != {per} {route} and 0 "
                 f"elsewhere")
    if counts != dict(_NO_LAUNCHES, **{route: total}) or counts[route] <= 0:
        fail(f"[{tag}] drain launches {counts} != {total} over {len(log)} forwards")
    outs = {r.rid: [int(t) for t in r.output] for r in done}
    if sorted(outs) != sorted(r.rid for r in reqs) or any(
            len(outs[r.rid]) != r.max_new_tokens for r in reqs):
        fail(f"[{tag}] not every request completed with its tokens")
    return outs, counts, len(log), sum(k == "decode" for k, _ in log), wall, peak


def _long_requests(np, vocab):
    from repro_torch.serve import Request

    rng = np.random.RandomState(SEED + 3)
    return [Request(rid=i, prompt=rng.randint(0, vocab, n).astype(np.int32),
                    max_new_tokens=NEW_TOKENS) for i, n in enumerate(MOE_LONG_PROMPTS)]


def _route_hooks(torch):
    """Hooks on ``nn.moe._top_k`` for the MoE parity run: the card's records
    each routing's expert choices; the CPU's compares its own and, where
    they differ, the gates at the two choices must lie within ROUTE_TIE of
    each other (a near tie float noise may order either way); the CPU then
    takes the card's choice. Any other difference fails."""
    from repro_torch.nn import moe

    plain = moe._top_k
    queue = []
    stats = {"routings": 0, "choices": 0, "ties": 0, "worst": 0.0}

    def record(gates, k):
        vals, idx = plain(gates, k)
        queue.append(idx.cpu())
        return vals, idx

    def follow(gates, k):
        vals, idx = plain(gates, k)
        card = queue.pop(0).to(idx.device)
        stats["routings"] += 1
        stats["choices"] += idx.numel()
        diff = idx != card
        if bool(diff.any()):
            gap = (gates.gather(1, idx) - gates.gather(1, card)).abs()[diff]
            worst = float(gap.max())
            if worst > ROUTE_TIE:
                fail(f"moe parity: {int(diff.sum())} expert choices differ between card and "
                     f"CPU at gate gaps up to {worst:.3e} (a tie is within {ROUTE_TIE})")
            stats["ties"] += int(diff.sum())
            stats["worst"] = max(stats["worst"], worst)
            for row in diff.any(1).nonzero()[:, 0].tolist():
                print(f"[moe-parity]   held an expert-choice tie: token {row}, CPU "
                      f"{idx[row].tolist()}, card {card[row].tolist()}, gates "
                      f"{gates[row].tolist()}")
            idx, vals = card, gates.gather(1, card)
        return vals, idx

    def install(side):
        moe._top_k = record if side == "card" else follow

    def restore():
        moe._top_k = plain

    def report():
        if queue:
            fail(f"moe parity: the CPU side left {len(queue)} card routings untaken")
        return (f"{stats['ties']} of {stats['choices']} expert choices in "
                f"{stats['routings']} routings were near ties (worst gap "
                f"{stats['worst']:.2e}, limit {ROUTE_TIE})")

    return install, restore, report


def _both(*hooks):
    def install(side):
        for h in hooks:
            h[0](side)

    def restore():
        for h in hooks:
            h[1]()

    return install, restore, lambda: "; ".join(h[2]() for h in hooks)


def phase_moe_parity(torch, np, arch, params, dev, tag="moe-parity", hooks=None, frames=None,
                     steps=MOE_PARITY_STEPS):
    """The short drain's first batch (requests 0-3, left-padded to the
    longest: 11 tokens at mixtral's vocab) on the card and on the CPU
    (plain versions), the same serve weights, through the model's
    ``prefill`` (with ``frames``, a card tensor, for the encdec family) and
    ``decode_step`` (any static-engine family): the
    prefill's and 4 decode steps' logits, the CPU fed its own greedy tokens
    on both sides, activation codes held at half-way ties (``_code_hooks``)
    and expert choices at near-tie gates (``_route_hooks``), or what
    ``hooks`` holds; then within PARITY_ATOL and greedy tokens equal but
    where the CPU's top two are closer than the two sides' difference."""
    from repro_torch.models import build_model

    api = build_model(arch, phase="serve")
    prompts = [r.prompt for r in _requests(np, arch.vocab)[:N_SLOTS]]
    s = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), s), np.int32)
    for i, p in enumerate(prompts):
        toks[i, s - len(p):] = p
    install, restore, report = hooks or _both(_code_hooks(torch), _route_hooks(torch))
    sides = (("card", dev), ("cpu", torch.device("cpu")))
    logs, runs, secs = {}, {}, {"card": 0.0, "cpu": 0.0}

    def step(side, fn):
        install(side)
        t0 = time.perf_counter()
        try:
            with torch.inference_mode():
                lg, cache = fn()
        finally:
            restore()
        secs[side] += time.perf_counter() - t0
        logs.setdefault(side, []).append(lg[:, -1].float().cpu())
        return cache

    for side, where in sides:
        p = params if side == "card" else _tree_to(params, where)
        batch = {"tokens": torch.from_numpy(toks).to(where)}
        if frames is not None:
            batch["frames"] = frames.to(where)
        runs[side] = (p, step(side, lambda: api.prefill(p, batch, max_len=MAX_LEN)))
    for t in range(1, steps + 1):
        tok = logs["cpu"][-1].argmax(-1).to(torch.int32)[:, None]
        for side, where in sides:
            p, cache = runs[side]
            runs[side] = (p, step(side, lambda: api.decode_step(p, tok.to(where), cache,
                                                                s + t - 1)))
    worst, compared, ties = 0.0, 0, 0
    for i, (g, c) in enumerate(zip(logs["card"], logs["cpu"])):
        for r in range(g.shape[0]):
            d = float((g[r] - c[r]).abs().max())
            worst = max(worst, d)
            if not np.isfinite(d) or d > PARITY_ATOL:
                fail(f"{tag} step {i} row {r}: max |card - cpu| logits = {d} > {PARITY_ATOL}")
            top2 = torch.topk(c[r], 2).values
            if float(top2[0] - top2[1]) <= 2 * d:
                ties += 1
                continue
            compared += 1
            if int(g[r].argmax()) != int(c[r].argmax()):
                fail(f"{tag} step {i} row {r}: greedy tokens differ between card and CPU")
    held = report()
    print(f"[{tag}] {arch.name} {arch.compute_mode}, {arch.n_layers} layers at full width: "
          f"prefill of 4 x {s} tokens + {steps} decode steps, card vs CPU plain "
          f"path: max |dlogit| = {worst:.3e} (tolerance {PARITY_ATOL}); greedy tokens equal "
          f"on {compared} of {compared + ties} rows ({ties} within-tolerance ties); {held}; "
          f"card {secs['card']:.1f} s, CPU {secs['cpu']:.1f} s")
    return {"max_abs_dlogit": worst, "held": held, "cpu_s": secs["cpu"],
            "card_s": secs["card"]}


def phase_moe_ring(torch, np, arch, params, dev, tag="moe-ring"):
    """Mixtral's attention layer alone at full width (layer 0 of the served
    tree) and its published window: ``attn_prefill`` of each long prompt
    (4,090 tokens: the ring wraps during decode; 4,200: folded in at
    prefill), then 16 ``attn_decode_step``s, fp32 and int8 rings. Each
    step's attention output (the wo projection's input) must lie within
    ATTN_TOL of ``dot_attention`` over every K/V so far under the window
    mask (for the int8 ring, over the K/V quantized and dequantized as the
    ring stores them)."""
    from repro_torch.models.lm import _attn_cfg
    from repro_torch.nn import attention as attn
    from repro_torch.nn.rotary import apply_rope

    acfg = _attn_cfg(arch)
    spec = arch.linear_spec()
    p = params["layers"][0]["attn"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    plain_apply = attn.linear_apply
    out = {}
    for s in MOE_LONG_PROMPTS:
        total = s + NEW_TOKENS
        x = torch.randn((1, total, arch.d_model), generator=gen, device=dev)
        with torch.inference_mode():
            q, k, v = attn._project_qkv(p, x, acfg, spec, "serve")
            pos = torch.arange(total, dtype=torch.int32, device=dev)
            q = apply_rope(q, pos, acfg.rope_theta)
            k = apply_rope(k, pos, acfg.rope_theta)
        for quantized in (False, True):
            seen = []

            def record(params_, x_, spec_, *, phase="serve"):
                if params_ is p["wo"]:
                    seen.append(x_)
                return plain_apply(params_, x_, spec_, phase=phase)

            kk, vv = k, v
            if quantized:
                kk = attn._dequantize_kv(*attn._quantize_kv(k), k.dtype)
                vv = attn._dequantize_kv(*attn._quantize_kv(v), v.dtype)
            attn.linear_apply = record
            try:
                with torch.inference_mode():
                    _, cache = attn.attn_prefill(p, x[:, :s], acfg, spec, max_len=MOE_LONG_LEN,
                                                 quantized=quantized)
                    seen.clear()
                    for i in range(NEW_TOKENS):
                        attn.attn_decode_step(p, x[:, s + i:s + i + 1], cache, s + i, acfg,
                                              spec)
            finally:
                attn.linear_apply = plain_apply
            worst = 0.0
            with torch.inference_mode():
                for i, got in enumerate(seen):
                    at = s + i
                    want = attn.dot_attention(q[:, at:at + 1], kk[:, :at + 1], vv[:, :at + 1],
                                              q_positions=pos[at:at + 1],
                                              kv_positions=pos[:at + 1], window=arch.window)
                    worst = max(worst, float((got - want.reshape(got.shape)).abs().max()))
            ring = cache["k"].shape[1]
            if len(seen) != NEW_TOKENS or not worst <= ATTN_TOL:
                fail(f"[{tag}] prompt {s} int8={quantized}: {len(seen)} steps, max |ring - "
                     f"windowed dot_attention| = {worst} > {ATTN_TOL}")
            out[f"{s}{'_int8' if quantized else ''}"] = worst
            print(f"[{tag}] window {arch.window}, ring of {ring} slots, prompt {s} "
                  f"({'folded into the ring at prefill' if s > ring else 'wraps in decode'}), "
                  f"positions {s}..{s + NEW_TOKENS - 1}, int8={quantized}: max |decode - "
                  f"windowed dot_attention| = {worst:.3e} (tolerance {ATTN_TOL})")
    return out


def _bnn_train_from(tree):
    """A qnn8 train-form tree ({w, amax} leaves) -> the bnn train form of the
    same weights ({w, gamma = mean |w| over K}, the draft adaptation of
    serve/spec.py); the dense {w} router passes through."""
    import torch

    if isinstance(tree, dict):
        if set(tree) == {"w", "amax"}:
            return {"w": tree["w"], "gamma": torch.mean(torch.abs(tree["w"]), dim=-2)}
        return {k: _bnn_train_from(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bnn_train_from(v) for v in tree]
    return tree


def phase_moe(torch, np, dev):
    """mixtral-8x22b at full width cut to MOE_LAYERS layers in bika (packed
    signs) through ServeEngine.from_trained(engine="auto") -> static: the
    short drain (8 requests x 16 tokens, batch 4, max_len 128) twice, the
    long drain (the two MOE_LONG_PROMPTS, one a batch, max_len 4,352) twice,
    each forward exactly 2 x (4 + 8 x 3) = 56 kernel-1 launches and 0 of
    kernel 11, tokens equal run to run; the ring oracle; card-vs-CPU parity;
    then one layer in qnn8 (kernel 10) and bnn packed (kernel 7) from one
    train-form tree, a short drain each twice; then nemotron-4-15b at full
    width, MOE_LAYERS layers, bika on the paged engine: the short drain twice
    (2 x 6 kernel-1 and 2 kernel-11 launches a tick) and its parity at
    NEMOTRON_PARITY_LAYERS layer."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.core.convert import tree_to_serve
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    out = {"cut": f"mixtral-8x22b and nemotron-4-15b: {MOE_LAYERS} layers (published 56 and "
                  f"32); bnn / qnn8 mixtral: 1 layer; every width as published"}
    print(f"[moe] {smi_line()}; depth cut: {out['cut']}")
    arch = get_config("mixtral-8x22b", n_layers=MOE_LAYERS, compute_mode="bika",
                      pack_signs=True, remat=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    train = build_model(arch, phase="train").init(gen, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    train_gb = _gb(torch.cuda.memory_allocated())
    t0 = time.perf_counter()
    eng = ServeEngine.from_trained(train, arch, batch_size=N_SLOTS, max_len=MAX_LEN, device=dev)
    torch.cuda.synchronize()
    t_conv = time.perf_counter() - t0
    del train
    gc.collect()
    torch.cuda.empty_cache()
    build_peak = _gb(torch.cuda.max_memory_allocated())
    serve_gb = _gb(torch.cuda.memory_allocated())
    if eng.engine != "static":
        fail(f"[moe] engine='auto' resolved to {eng.engine!r} for MoE + SWA, not 'static'")
    print(f"[moe] mixtral-8x22b bika packed, {arch.n_layers} layers, d_model {arch.d_model}, "
          f"{arch.n_heads}/{arch.n_kv_heads} heads of {arch.hd}, {arch.n_experts} experts "
          f"top-{arch.top_k}, d_ff {arch.d_ff}, window {arch.window}, vocab {arch.vocab}: "
          f"train-form init {t_init:.2f} s ({train_gb:.2f} GB), from_trained {t_conv:.2f} s, "
          f"peak {build_peak:.2f} GB, served tree {serve_gb:.2f} GB; engine={eng.engine}")
    out["mixtral"] = {"init_s": t_init, "convert_s": t_conv, "train_gb": train_gb,
                      "build_peak_gb": build_peak, "serve_gb": serve_gb}
    per_fwd = _projections(arch) * arch.n_layers
    short = []
    for run in range(2):
        outs, counts, fwds, decodes, wall, peak = _static_drain(
            torch, np, ops, eng, _requests(np, arch.vocab), "cac_hw", "moe-short")
        short.append(outs)
        print(f"[moe] short drain {run + 1}: 8 requests x {NEW_TOKENS} tokens, batch "
              f"{N_SLOTS}, max_len {MAX_LEN}: {fwds} forwards ({decodes} decode steps), each "
              f"{per_fwd} kernel-1 and 0 kernel-11 launches; launches {counts}; wall "
              f"{wall:.3f} s, peak {peak:.2f} GB")
        out.setdefault("short", []).append({"wall_s": wall, "peak_gb": peak, "launches": counts,
                                            "forwards": fwds, "decode_steps": decodes})
    if short[0] != short[1]:
        fail("[moe] short drain: a second run gave other tokens")
    out["launches"] = out["short"][0]["launches"]
    print(f"[moe] short drain tokens repeat; req0={short[0][0]}")
    long_eng = ServeEngine(eng.api, eng.params, arch, batch_size=1, max_len=MOE_LONG_LEN,
                           device=dev)
    longs = []
    for run in range(2):
        outs, counts, fwds, decodes, wall, peak = _static_drain(
            torch, np, ops, long_eng, _long_requests(np, arch.vocab), "cac_hw", "moe-long")
        longs.append(outs)
        print(f"[moe] long drain {run + 1}: prompts {MOE_LONG_PROMPTS} x {NEW_TOKENS} tokens, "
              f"one a batch, max_len {MOE_LONG_LEN}: {fwds} forwards, each {per_fwd} kernel-1 "
              f"launches; launches {counts}; wall {wall:.3f} s, peak {peak:.2f} GB")
        out.setdefault("long", []).append({"wall_s": wall, "peak_gb": peak, "launches": counts,
                                           "forwards": fwds})
    if longs[0] != longs[1]:
        fail("[moe] long drain: a second run gave other tokens")
    print(f"[moe] long drain tokens repeat; {longs[0]}")
    del long_eng
    out["ring"] = phase_moe_ring(torch, np, arch, eng.params, dev)
    # the parity at MOE_PARITY_LAYERS of the served layers (its CPU side is
    # most of the phase's time)
    out["parity"] = phase_moe_parity(
        torch, np, arch.replace(n_layers=MOE_PARITY_LAYERS),
        dict(eng.params, layers=eng.params["layers"][:MOE_PARITY_LAYERS]), dev,
        steps=MOE_PARITY_LAYER_STEPS)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # bnn (kernel 7) and qnn8 (kernel 10): one layer, from one train-form tree
    arch1 = get_config("mixtral-8x22b", n_layers=1, compute_mode="qnn8", remat=False)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    train = build_model(arch1, phase="train").init(gen, device=dev)
    for mode, route, a in (("qnn8", "qnn8", arch1),
                           ("bnn", "bnn_packed", arch1.replace(compute_mode="bnn",
                                                               pack_signs=True))):
        tree = train if mode == "qnn8" else _bnn_train_from(train)
        e = ServeEngine.from_trained(tree, a, batch_size=N_SLOTS, max_len=MAX_LEN, device=dev)
        runs = []
        for _ in range(2):
            outs, counts, fwds, decodes, wall, peak = _static_drain(
                torch, np, ops, e, _requests(np, a.vocab), route, f"moe-{mode}")
            runs.append(outs)
        if runs[0] != runs[1]:
            fail(f"[moe-{mode}] a second drain gave other tokens")
        per = _projections(a) * a.n_layers
        print(f"[moe-{mode}] mixtral-8x22b {mode}, 1 layer: short drain twice, tokens repeat; "
              f"{fwds} forwards, each {per} {route} launches; launches {counts}; wall "
              f"{wall:.3f} s, peak {peak:.2f} GB")
        out[mode] = {"launches": counts, "forwards": fwds, "wall_s": wall, "peak_gb": peak}
        del e
    del train
    gc.collect()
    torch.cuda.empty_cache()

    # nemotron-4-15b: LayerNorm, squared ReLU (ungated), G = 6 at D = 128, on the paged engine
    narch = get_config("nemotron-4-15b", n_layers=MOE_LAYERS, compute_mode="bika",
                       pack_signs=True, remat=False, paged_attn_route="fused")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    torch.cuda.reset_peak_memory_stats()
    train = build_model(narch, phase="train").init(gen, device=dev)
    nem = []
    for run in range(2):
        held, log = {}, {}
        outs, counts, wall, summ = _serve(np, train, narch, False, dev, count_launches=True,
                                          held=held, record=log if run == 0 else None)
        _check_serve_launches(narch, "cac_hw", counts, summ)
        if run == 0:  # the tp phase's single-process reference
            out["nemotron_ref"] = _drain_record(outs, counts, wall, summ, held, log)
        held.clear()  # the engine goes before the next drain builds its own
        nem.append(outs)
        ticks = summ["decode_steps"] + summ["prefill_chunks"]
        print(f"[moe-nemotron] nemotron-4-15b bika packed, {narch.n_layers} layers, paged: "
              f"8 requests x {NEW_TOKENS} tokens, {ticks} ticks, each "
              f"{_projections(narch) * narch.n_layers} kernel-1 and {narch.n_layers} "
              f"kernel-11 launches; launches {counts}; wall {wall:.3f} s, peak "
              f"{_gb(torch.cuda.max_memory_allocated()):.2f} GB")
        out.setdefault("nemotron", []).append({"launches": counts, "wall_s": wall,
                                               "ticks": ticks})
    if nem[0] != nem[1]:
        fail("[moe-nemotron] a second drain gave other tokens")
    serve_params = tree_to_serve(train, narch.linear_spec())
    del train
    gc.collect()
    torch.cuda.empty_cache()
    out["nemotron_parity"] = phase_parity(torch, np, narch, serve_params, dev,
                                          _code_hooks(torch), tag="moe-nemotron-parity",
                                          layers=NEMOTRON_PARITY_LAYERS)
    del serve_params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 16: the recurrent families (zamba2-2.7b hybrid, xlstm-125m)
# ---------------------------------------------------------------------------

RECURRENT_PREFILL_M = 84  # the drains' second prefill: 4 prompts left-padded to 21 tokens
# the new (K, N) of kernels 1, 7 and 10 on the recurrent paths; zamba2's
# in_proj N = 10448 leaves a ragged last 128-column tile (columns 10368-10447:
# the dt columns that feed softplus)
RECURRENT_KN = [("zamba2 in_proj", 2560, 10448), ("zamba2 out_proj", 5120, 2560),
                ("zamba2 shared q/k/v/o", 2560, 2560), ("zamba2 shared gate/up", 2560, 10240),
                ("zamba2 shared down", 10240, 2560), ("xlstm mLSTM up", 768, 3072),
                ("xlstm mLSTM q/k/v", 1536, 1536), ("xlstm mLSTM down", 1536, 768),
                ("xlstm sLSTM wx", 768, 3072), ("xlstm sLSTM down", 768, 768)]
ZAMBA_PARITY_LAYERS = 6  # one group (the SMOKE card test holds two KV streams)
# the zamba2 bika drains at 3 of 9 groups (the 54-layer forward runs in train-recurrent)
ZAMBA_SERVE_LAYERS = 18
XLSTM_PARITY_LAYERS = 4  # an sLSTM (layer 0) and three mLSTM layers
ZAMBA_LOWBIT_LAYERS = 6  # bnn and qnn8: one group, 6 x 2 + 7 = 19 launches a forward
LONG_PROMPTS = (64, 512)  # the host-side time loop's prefill cost per token
THREE_KERNELS = ("cac_matmul", "bnn_packed_matmul", "qnn_matmul")  # kernels 1, 7, 10
KERNEL1_GROUP = {"cac_matmul": ("stream_kernel<0,",)}


def _forward_launches(arch, kind="decode"):
    """Projection launches of one forward, a prefill or a decode step
    (``kind``): the lm family's ``_projections`` a layer; the hybrid's 2 a
    Mamba layer (in_proj, out_proj) and 7 a shared-block application;
    xLSTM's 2 an sLSTM layer (wx, down) and 5 an mLSTM layer (up, q, k, v,
    down); the encdec family's prefill 6 an encoder layer (q, k, v, o, up,
    down) and 10 a decoder layer (self q/k/v/o, cross q/k/v/o with the
    cross K/V projected once, up, down), its decode step 8 a decoder layer
    (the cross K/V are cached)."""
    if arch.family == "encdec":
        if kind == "prefill":
            return 6 * arch.n_encoder_layers + 10 * arch.n_layers
        return 8 * arch.n_layers
    if arch.family == "hybrid":
        return 2 * arch.n_layers + _projections(arch) * (arch.n_layers // arch.attn_every)
    if arch.family == "xlstm":
        n_s = sum(1 for i in range(arch.n_layers) if i % arch.slstm_every == 0)
        return 2 * n_s + 5 * (arch.n_layers - n_s)
    return _projections(arch) * arch.n_layers


def _kernel_rows(torch, np, dev, flush, cases, key, tag, seed):
    """Kernels 1, 7 and 10 at each case (where, M, K, N, kernels): bit-exact
    against their plain versions and repeatable, timed (L2 flushed) beside
    the plain version, a library call where one exists (kernel 7:
    torch.matmul on +-1 float32; kernel 10: torch._int_mm) and the bound.
    Above 512 rows the kernel is timed 5 times and the plain version once.
    Each row names its case under ``key``."""
    from repro_torch.core.backend import pack_signs
    from repro_torch.kernels import bnn_matmul as bnn
    from repro_torch.kernels import qnn_matmul as qnn
    from repro_torch.kernels.cac_matmul import cac_matmul_kernel_call, cac_matmul_plain

    rng = np.random.default_rng(seed)
    rows = []
    for where, m, k, n, names in cases:
        x = torch.from_numpy(rng.integers(-128, 128, size=(m, k)).astype(np.int8)).to(dev)
        tau = torch.from_numpy(rng.integers(-128, 128, size=(k, n)).astype(np.int8)).to(dev)
        signs = torch.from_numpy(np.where(rng.random((k, n)) < 0.5, 1, -1).astype(np.int8))
        sp = pack_signs(signs).to(dev)
        ops2 = 2.0 * m * k * n
        cases_here = {"cac_matmul": (
            lambda: cac_matmul_kernel_call(x, tau, sp), lambda: cac_matmul_plain(x, tau, sp),
            None, _bound(m * k + k * n + k * n // 8 + 4 * m * n, ops2, CUDA_CORE_OPS_S))}
        if "bnn_packed_matmul" in names or "qnn_matmul" in names:
            xf = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
            w = torch.from_numpy(rng.integers(-127, 128, size=(k, n)).astype(np.int8)).to(dev)
            ws = torch.from_numpy(rng.uniform(1e-3, 1e-2, size=(n,)).astype(np.float32)).to(dev)
            xs, wsf = torch.where(xf >= 0, 1.0, -1.0), signs.to(dev).float()
            int_mm, int_mm_shape = _int_mm_yardstick(torch, x, w, ws)
            cases_here["bnn_packed_matmul"] = (
                lambda: bnn.bnn_packed_matmul_kernel_call(xf, sp),
                lambda: bnn.bnn_packed_matmul_plain(xf, sp), lambda: torch.matmul(xs, wsf),
                _bound(4 * m * k + k * n // 8 + 4 * m * n, ops2, TENSOR_CORE_OPS_S))
            cases_here["qnn_matmul"] = (
                lambda: qnn.qnn_matmul_kernel_call(x, w, ws, ACT_SCALE),
                lambda: qnn.qnn_matmul_plain(x, w, ws, ACT_SCALE), int_mm,
                _bound(m * k + k * n + 4 * n + 4 * m * n, ops2, INT8_TENSOR_OPS_S))
        big = m > 512
        for name in names:
            kern, plain, lib, (bound, by) = cases_here[name]
            got, again, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if err != 0.0 or not torch.equal(got, again):
                fail(f"{tag} {name} {where} M={m} K={k} N={n}: max |kernel - plain| = "
                     f"{err}, repeatable {torch.equal(got, again)}")
            row = {key: where, "kernel": name, "M": m, "K": k, "N": n, "max_abs_err": err,
                   "ms": time_ms(torch, kern, iters=5 if big else 20, flush=flush),
                   "plain_ms": time_ms(torch, plain, iters=1 if big else 2, warmup=1,
                                       flush=flush),
                   "library_ms": time_ms(torch, lib, flush=flush) if lib else None,
                   "bound_ms": bound, "bound_by": by}
            if name == "qnn_matmul":
                row["library_shape"] = int_mm_shape
            row["bound_share"] = bound / row["ms"]
            rows.append(row)
            lib_ms = "none" if lib is None else f"{row['library_ms']:.5f}"
            print(f"[{tag}] {name} {where} M={m} K={k} N={n} bit-exact, repeatable; "
                  f"ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} library_ms={lib_ms} "
                  f"bound_ms={bound:.6f} ({by}, {100 * row['bound_share']:.1f}%)")
            del got, again, want
        del x, tau, sp, cases_here
    return rows


def phase_recurrent_kernels(torch, np, dev, flush):
    """Kernels 1, 7 and 10 at the ten (K, N) of the recurrent paths
    (``RECURRENT_KN``), M = 4 (decode) and M = 84 (the drains' second
    prefill) (``_kernel_rows``)."""
    return _kernel_rows(torch, np, dev, flush,
                        [(where, m, k, n, THREE_KERNELS) for where, k, n in RECURRENT_KN
                         for m in (N_SLOTS, RECURRENT_PREFILL_M)],
                        "recurrent", "recurrent-kernels", SEED + 25)


def _long_prefill(torch, np, eng, per, tag):
    """The host-side time loop: one prompt of each of LONG_PROMPTS tokens
    (batch 1) through the engine's prefill, launch counts exact, wall ms
    per token; the slope between the two lengths is the loop's cost per
    token."""
    from repro_torch.kernels import ops

    rng = np.random.RandomState(SEED + 7)
    out = {}
    for s in LONG_PROMPTS:
        tokens = torch.from_numpy(rng.randint(0, eng.arch.vocab, (1, s)).astype(np.int32))
        tokens = tokens.to(eng.device)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, _ = eng.api.prefill(eng.params, {"tokens": tokens}, max_len=s + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        if counts != dict(_NO_LAUNCHES, cac_hw=per) or not bool(torch.isfinite(logits).all()):
            fail(f"[{tag}] prefill of {s} tokens: launches {counts} != {per} kernel-1, or "
                 f"non-finite logits")
        out[f"{s}_tokens"] = {"wall_s": wall, "ms_per_token": wall / s * 1e3}
    a, b = LONG_PROMPTS
    ra, rb = out[f"{a}_tokens"], out[f"{b}_tokens"]
    out["slope_ms_per_token"] = (rb["wall_s"] - ra["wall_s"]) / (b - a) * 1e3
    print(f"[{tag}] prefill, batch 1: {a} tokens {ra['wall_s']:.3f} s, {b} tokens "
          f"{rb['wall_s']:.3f} s ({rb['ms_per_token']:.3f} ms a token; "
          f"{out['slope_ms_per_token']:.3f} ms a token between them), {per} kernel-1 "
          f"launches each")
    return out


def _profiled_drain(torch, np, eng, tag, extra=None):
    """One more drain of the 8 requests (``extra``: the engine's
    ``extra_batch``) under torch.profiler: device busy, idle share, the top
    kernels and kernel 1's device ms."""
    from torch.profiler import ProfilerActivity, profile

    label = f"{eng.arch.name}_static_drain"
    for r in _requests(np, eng.arch.vocab):
        eng.submit(r)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(label):
            eng.run(extra_batch=extra)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
    t_stop = time.perf_counter() - t0
    t0 = time.perf_counter()
    share = _device_share(prof, label, KERNEL1_GROUP)
    print(f"[{tag}] the profiler's own cost: stop {t_stop:.2f} s, reading its events "
          f"{time.perf_counter() - t0:.2f} s")
    if share is None:
        print(f"[{tag}] device busy share: not measured (the trace holds no drain window or "
              f"no device events)")
        return None
    print(f"[{tag}] drain under torch.profiler: window {share['window_ms']:.1f} ms, device "
          f"busy {share['device_busy_ms']:.2f} ms, idle share {share['idle_share']:.4f}; "
          f"kernel 1 {share['groups']['cac_matmul']['ms']:.3f} ms in "
          f"{share['groups']['cac_matmul']['count']} launches")
    for row in share["top_kernels"]:
        print(f"[{tag}]   {row['ms']:9.3f} ms {row['count']:6d}x {row['name']}")
    return share


def _bika_engine(torch, arch, dev, seed, tag):
    """A train-form tree of ``arch`` from a seeded generator on the card,
    served through ServeEngine.from_trained (engine="auto", which must
    resolve to static; batch N_SLOTS, max_len MAX_LEN), the train tree then
    freed. -> (engine, a record of the init and conversion seconds, the
    train tree's, build peak's and served tree's GB, the memory baseline)."""
    import gc

    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    train = build_model(arch, phase="train").init(gen, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    train_gb = _gb(torch.cuda.memory_allocated() - base)
    t0 = time.perf_counter()
    eng = ServeEngine.from_trained(train, arch, batch_size=N_SLOTS, max_len=MAX_LEN,
                                   device=dev)
    torch.cuda.synchronize()
    t_conv = time.perf_counter() - t0
    del train
    gc.collect()
    torch.cuda.empty_cache()
    build_peak = _gb(torch.cuda.max_memory_allocated() - base)
    serve_gb = _gb(torch.cuda.memory_allocated() - base)
    if eng.engine != "static":
        fail(f"[{tag}] engine='auto' resolved to {eng.engine!r}, not 'static'")
    per = {kind: _forward_launches(arch, kind) for kind in ("prefill", "decode")}
    print(f"[{tag}] bika packed, {arch.n_layers} layers"
          + (f" + {arch.n_encoder_layers} encoder layers" if arch.n_encoder_layers else "")
          + f", d_model {arch.d_model}, vocab {arch.vocab}: train-form init {t_init:.2f} s "
          f"({train_gb:.2f} GB), built through ServeEngine.from_trained in {t_conv:.2f} s, "
          f"build peak {build_peak:.2f} GB, served tree {serve_gb:.2f} GB; "
          f"engine={eng.engine}; kernel-1 launches {per['prefill']} a prefill, "
          f"{per['decode']} a decode step")
    res = {"layers": arch.n_layers, "init_s": t_init, "convert_s": t_conv,
           "train_gb": train_gb, "build_peak_gb": build_peak, "serve_gb": serve_gb,
           "per_forward": per["decode"], "per_prefill": per["prefill"],
           "built_through": "ServeEngine.from_trained"}
    return eng, res, base


def _drains_twice(torch, np, ops, eng, route, tag, res, base, extra=None):
    """The 8 requests drained twice through a static engine
    (``_static_drain``, ``extra`` its ``extra_batch``): tokens must repeat.
    Each drain's wall seconds, peak above ``base``, launches, forwards and
    decode steps go into ``res["drains"]``, the first's launches into
    ``res["launches"]``."""
    runs = []
    for run in range(2):
        outs, counts, fwds, decodes, wall, peak = _static_drain(
            torch, np, ops, eng, _requests(np, eng.arch.vocab), route, tag, extra=extra)
        runs.append(outs)
        print(f"[{tag}] drain {run + 1}: 8 requests x {NEW_TOKENS} tokens, batch {N_SLOTS}, "
              f"max_len {MAX_LEN}: {fwds} forwards ({decodes} decode steps), "
              f"{_forward_launches(eng.arch, 'prefill')} {route} launches a prefill and "
              f"{_forward_launches(eng.arch)} a decode step; launches {counts}; wall "
              f"{wall:.3f} s, peak {_gb(peak * 1e9 - base):.2f} GB above the build's start")
        res.setdefault("drains", []).append({
            "wall_s": wall, "peak_gb": _gb(peak * 1e9 - base), "launches": counts,
            "forwards": fwds, "decode_steps": decodes})
    if runs[0] != runs[1]:
        fail(f"[{tag}] a second drain gave other tokens")
    res["launches"] = res["drains"][0]["launches"]
    print(f"[{tag}] tokens repeat; req0={runs[0][0]}")


def _lowbit_drains(torch, np, ops, arch, dev, tag, extra=None):
    """qnn8 (kernel 10) and bnn packed (kernel 7) serving of one qnn8
    train-form tree of ``arch`` (the bnn form through ``_bnn_train_from``):
    each drained twice (``_drains_twice``), launches exact.
    -> {mode: record}."""
    import gc

    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    train = build_model(arch, phase="train").init(gen, device=dev)
    out = {}
    for mode, route, am in (("qnn8", "qnn8", arch),
                            ("bnn", "bnn_packed", arch.replace(compute_mode="bnn",
                                                               pack_signs=True))):
        tree = train if mode == "qnn8" else _bnn_train_from(train)
        e = ServeEngine.from_trained(tree, am, batch_size=N_SLOTS, max_len=MAX_LEN, device=dev)
        res = {"layers": am.n_layers, "encoder_layers": am.n_encoder_layers,
               "per_forward": _forward_launches(am),
               "per_prefill": _forward_launches(am, "prefill")}
        _drains_twice(torch, np, ops, e, route, f"{tag}-{mode}", res, 0, extra=extra)
        res["forwards"] = res["drains"][0]["forwards"]
        res["wall_s"] = res["drains"][-1]["wall_s"]
        out[mode] = res
        del e, tree
    del train
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_recurrent(torch, np, dev):
    """zamba2-2.7b (full width, ZAMBA_SERVE_LAYERS layers) and xlstm-125m
    (whole) in bika (packed signs) through
    ServeEngine.from_trained(engine="auto") -> static: the 8 requests x 16
    tokens (batch 4, max_len 128) twice, every forward exactly
    ``_forward_launches`` kernel-1 launches (57 and 51) and no other
    kernel, tokens equal run to run, build and drain peaks; one drain
    profiled; the prefill's cost per token at LONG_PROMPTS; card-vs-CPU
    parity (zamba2 at ZAMBA_PARITY_LAYERS, xlstm at XLSTM_PARITY_LAYERS)
    with activation codes held at half-way ties; then qnn8 (kernel 10) and
    bnn packed (kernel 7)
    from one train-form tree each (zamba2 at 6 layers, xlstm whole), a
    drain each twice."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    out = {"cut": f"zamba2-2.7b: {ZAMBA_SERVE_LAYERS} of 54 layers in bika; the parity at "
                  f"{ZAMBA_PARITY_LAYERS} "
                  f"layers, bnn / qnn8 at {ZAMBA_LOWBIT_LAYERS}; xlstm-125m whole, its parity "
                  f"at {XLSTM_PARITY_LAYERS} layers; every width as published"}
    print(f"[recurrent] {smi_line()}; {out['cut']}")
    for name, seed in (("zamba2-2.7b", SEED + 21), ("xlstm-125m", SEED + 22)):
        tag = f"recurrent-{name}"
        arch = get_config(name, compute_mode="bika", pack_signs=True, remat=False)
        if arch.family == "hybrid":
            arch = arch.replace(n_layers=ZAMBA_SERVE_LAYERS)
        eng, res, base = _bika_engine(torch, arch, dev, seed, tag)
        _drains_twice(torch, np, ops, eng, "cac_hw", tag, res, base)
        res["profile"] = _profiled_drain(torch, np, eng, tag)
        res["long_prefill"] = _long_prefill(torch, np, eng, res["per_forward"], tag)
        # the engine holds the layers as lists of per-layer views
        if arch.family == "hybrid":
            p_arch = arch.replace(n_layers=ZAMBA_PARITY_LAYERS)
            p_params = dict(eng.params, mamba=eng.params["mamba"][:ZAMBA_PARITY_LAYERS])
        else:
            p_arch = arch.replace(n_layers=XLSTM_PARITY_LAYERS)
            p_params = dict(eng.params, layers=eng.params["layers"][:XLSTM_PARITY_LAYERS])
        res["parity"] = phase_moe_parity(torch, np, p_arch, p_params, dev,
                                         tag=f"recurrent-parity {name}",
                                         hooks=_code_hooks(torch))
        del eng, p_params
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = res

    # qnn8 (kernel 10) and bnn packed (kernel 7), from one train-form tree each
    for name, layers in (("zamba2-2.7b", ZAMBA_LOWBIT_LAYERS), ("xlstm-125m", None)):
        a = get_config(name, compute_mode="qnn8", remat=False)
        a = a.replace(n_layers=layers) if layers else a
        out.update({f"{name} {mode}": res for mode, res in _lowbit_drains(
            torch, np, ops, a, dev, f"recurrent-{name}").items()})
    return out


# ---------------------------------------------------------------------------
# phase 17: the encoder-decoder family (seamless-m4t-large-v2)
# ---------------------------------------------------------------------------

ENCDEC = "seamless-m4t-large-v2"
# the family's (K, N): self and cross q/k/v/o, the ungated MLP's up and down
ENCDEC_KN = [("q/k/v/o", 1024, 1024), ("up", 1024, 8192), ("down", 8192, 1024)]
# M: decode; the first group's decoder prefill (4 x 11 tokens); the encoder
# and the cross K/V over 4 x 16 frames
ENCDEC_M = (N_SLOTS, 44, 64)
ENCDEC_FRAMES = 16  # frames a request, as the serve launcher makes them
ENCDEC_PARITY_LAYERS = 4  # card vs CPU at 4 encoder + 4 decoder layers
ENCDEC_SERVE_LAYERS = 12  # the bika drains at 12 + 12 of 24 + 24 layers: 192 / 96 launches
ENCDEC_LOWBIT_LAYERS = 6  # bnn and qnn8 at 6 + 6: 96 launches a prefill, 48 a decode step
ENCDEC_LONG_STEPS = 3  # timed decode steps after the encoder_seq-frame prefill (and 1 untimed)


def phase_encdec_kernels(torch, np, dev, flush):
    """Kernels 1, 7 and 10 at the family's three (K, N) (``ENCDEC_KN``), M in
    ``ENCDEC_M``, and kernel 1 at M = 4 x encoder_seq = 4,096 (the encoder
    over 1,024 frames) at all three (``_kernel_rows``)."""
    cases = [(where, m, k, n, THREE_KERNELS) for where, k, n in ENCDEC_KN for m in ENCDEC_M]
    cases += [(f"encoder {where}", N_SLOTS * 1024, k, n, ("cac_matmul",))
              for where, k, n in ENCDEC_KN]
    return _kernel_rows(torch, np, dev, flush, cases, "encdec", "encdec-kernels", SEED + 26)


def _encdec_frames(torch, arch, dev, n_frames):
    """(N_SLOTS, n_frames, d_model) = 0.1 x a normal sample from a torch
    generator seeded 1 on the card, as the serve launcher makes them."""
    gen = torch.Generator(device=dev).manual_seed(1)
    return 0.1 * torch.randn((N_SLOTS, n_frames, arch.d_model), generator=gen, device=dev)


def _encdec_long(torch, np, ops, eng, tag):
    """One prefill of the first group's prompts over encoder_seq frames a
    row (the encoder's kernel 1 at M = 4 x 1,024), then one untimed and
    ENCDEC_LONG_STEPS timed decode steps whose cross-attention reads 1,024
    keys: launches exact, finite logits, the prefill's seconds and a decode
    step's."""
    arch = eng.arch
    frames = _encdec_frames(torch, arch, eng.device, arch.encoder_seq)
    prompts = [r.prompt for r in _requests(np, arch.vocab)[:N_SLOTS]]
    s = max(len(p) for p in prompts)
    toks = np.zeros((N_SLOTS, s), np.int32)
    for i, p in enumerate(prompts):
        toks[i, s - len(p):] = p
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, cache = eng.api.prefill(
            eng.params, {"tokens": torch.from_numpy(toks).to(eng.device), "frames": frames},
            max_len=MAX_LEN)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        for t in range(ENCDEC_LONG_STEPS + 1):
            if t == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            logits, cache = eng.api.decode_step(eng.params, tok, cache, s + t)
        torch.cuda.synchronize()
    t_decode = (time.perf_counter() - t0) / ENCDEC_LONG_STEPS
    counts = ops.launch_counts()
    want = (_forward_launches(arch, "prefill")
            + (ENCDEC_LONG_STEPS + 1) * _forward_launches(arch))
    if counts != dict(_NO_LAUNCHES, cac_hw=want) or not bool(torch.isfinite(logits).all()):
        fail(f"[{tag}] long-encoder prefill: launches {counts} != {want} kernel-1, or "
             f"non-finite logits")
    if tuple(cache["cross_k"].shape) != (arch.n_layers, N_SLOTS, arch.encoder_seq,
                                         arch.n_kv_heads, arch.hd):
        fail(f"[{tag}] the cross cache is {tuple(cache['cross_k'].shape)}")
    print(f"[{tag}] prefill over {arch.encoder_seq} frames a row (the encoder at M = "
          f"{N_SLOTS * arch.encoder_seq}) and 4 x {s} tokens: {t_prefill:.3f} s; a decode "
          f"step over {arch.encoder_seq} cross keys {t_decode * 1e3:.2f} ms; {want} kernel-1 "
          f"launches")
    return {"frames": arch.encoder_seq, "prefill_s": t_prefill, "decode_step_s": t_decode,
            "launches": counts["cac_hw"]}


def phase_encdec(torch, np, dev):
    """seamless-m4t-large-v2 in bika (packed signs) at full width,
    ENCDEC_SERVE_LAYERS + ENCDEC_SERVE_LAYERS layers, through
    ServeEngine.from_trained(engine="auto") -> static, frames (4, 16, 1024)
    as ``run(extra_batch=)``: the 8 requests x 16 tokens (batch 4, max_len
    128) twice, every prefill exactly 16 and every decode step 8 kernel-1
    launches a decoder layer (and 6 an encoder layer at prefill) and no
    other kernel, tokens
    equal run to run, build and drain peaks; one drain profiled; one
    prefill over encoder_seq = 1,024 frames a row and decode steps after
    it; card-vs-CPU parity at 4 + 4 layers with activation codes held at
    half-way ties; then qnn8 (kernel 10) and bnn packed (kernel 7) from one
    train-form tree at 6 + 6 layers, a drain each twice."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    out = {"cut": f"{ENCDEC}: {ENCDEC_SERVE_LAYERS} + {ENCDEC_SERVE_LAYERS} of 24 + 24 "
                  f"layers in bika; the parity at "
                  f"{ENCDEC_PARITY_LAYERS} + {ENCDEC_PARITY_LAYERS} layers, bnn / qnn8 at "
                  f"{ENCDEC_LOWBIT_LAYERS} + {ENCDEC_LOWBIT_LAYERS}; every width as published"}
    print(f"[encdec] {smi_line()}; {out['cut']}")
    tag = "encdec-bika"
    arch = get_config(ENCDEC, compute_mode="bika", pack_signs=True, remat=False,
                      n_layers=ENCDEC_SERVE_LAYERS, n_encoder_layers=ENCDEC_SERVE_LAYERS)
    eng, res, base = _bika_engine(torch, arch, dev, SEED + 26, tag)
    extra = {"frames": _encdec_frames(torch, arch, dev, ENCDEC_FRAMES)}
    _drains_twice(torch, np, ops, eng, "cac_hw", tag, res, base, extra=extra)
    res["profile"] = _profiled_drain(torch, np, eng, tag, extra=extra)
    res["long_encoder"] = _encdec_long(torch, np, ops, eng, tag)
    n = ENCDEC_PARITY_LAYERS
    res["parity"] = phase_moe_parity(
        torch, np, arch.replace(n_layers=n, n_encoder_layers=n),
        dict(eng.params, encoder=eng.params["encoder"][:n], decoder=eng.params["decoder"][:n]),
        dev, tag="encdec-parity", hooks=_code_hooks(torch), frames=extra["frames"])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    out["bika"] = res
    a = get_config(ENCDEC, compute_mode="qnn8", remat=False, n_layers=ENCDEC_LOWBIT_LAYERS,
                   n_encoder_layers=ENCDEC_LOWBIT_LAYERS)
    out.update(_lowbit_drains(torch, np, ops, a, dev, "encdec", extra=extra))
    return out


# ---------------------------------------------------------------------------
# train-families: training mixtral-8x22b (MoE) and seamless-m4t-large-v2
# (encoder-decoder) at full width
# ---------------------------------------------------------------------------

MIXTRAL = "mixtral-8x22b"
# kernels 2-6, 8 and 9 at every (M, K, N) the two families' training
# projections give them at batch 4 x seq 128 (M = 512): mixtral's
# attention, and its experts' (C, D) queues at C = int(512 x 2 / 8 x 1.25)
# = 160 rows (a ragged last 128-row tile); seamless's attention (self and
# cross: the encoder runs over 4 x 128 frames) and its ungated FFN
FAMILY_TRAIN_SHAPES = [
    (f"{MIXTRAL} q/o", 512, 6144, 6144), (f"{MIXTRAL} k/v", 512, 6144, 1024),
    (f"{MIXTRAL} expert gate/up", 160, 6144, 16384), (f"{MIXTRAL} expert down", 160, 16384, 6144),
    (f"{ENCDEC} q/k/v/o", 512, 1024, 1024), (f"{ENCDEC} up", 512, 1024, 8192),
    (f"{ENCDEC} down", 512, 8192, 1024)]
FAMILY_LOWBIT_LAYERS = 6  # seamless in bnn at 6 + 6 layers
SEAMLESS_TRAIN_LAYERS = 12  # seamless in bika at 12 + 12 of 24 + 24 layers: 384 / 192 launches
MIXTRAL_TRAIN_LAYERS = 1  # mixtral at full width, 1 of 56 layers (its state fills the card)


def _bnn_operands_on(torch, gen, dev, m, k, n):
    """``_bnn_operands`` drawn on the card (the host's normal draws of the
    expert shapes' 100 M-element w took seconds each): x, g ~ N(0, 1), w ~
    N(0, 0.25), about 2% of x and w exact +0.0, 2% exact -0.0 and 1% exact
    +-1."""
    x = torch.randn((m, k), generator=gen, device=dev)
    w = torch.randn((k, n), generator=gen, device=dev) * 0.5
    for a in (x, w):
        u = torch.rand(a.shape, generator=gen, device=dev)
        a[u < 0.02] = 0.0
        a[(u >= 0.02) & (u < 0.04)] = -0.0
        edge = (u >= 0.04) & (u < 0.05)
        a[edge] = torch.where(torch.rand(a.shape, generator=gen, device=dev) < 0.5, 1.0,
                              -1.0)[edge]
    return x, w, torch.randn((m, n), generator=gen, device=dev)


def _family_train_row(torch, dev, flush, gen, where, m, k, n):
    """Kernels 2-5 and 6, 8, 9 at one (M, K, N), operands drawn on the card
    (as the path's kernel tests draw them): the forwards bit-exact against
    their plain versions, the backwards within TRAIN_TOL (kernels 3-5 off
    the |pre| = 1 window edge, as ``phase_train_kernels``; 8 and 9 on every
    element, as ``phase_bnn_kernels``) and bit-for-bit repeatable; each
    timed (L2 flushed) beside its plain version (one call: at these sizes
    the plain versions take ~0.1-1 s) and its bound."""
    from repro_torch.kernels import bnn_matmul as bnn
    from repro_torch.kernels import cac_matmul as cac
    from repro_torch.core.ste import sign

    x = torch.randn((m, k), generator=gen, device=dev)
    w = torch.randn((k, n), generator=gen, device=dev) * 0.5
    beta = torch.randn((k, n), generator=gen, device=dev) * 0.5
    g = torch.randn((m, n), generator=gen, device=dev)
    index = dev.index or 0
    row = {"where": where, "M": m, "K": k, "N": n,
           "fwd_splits": cac.card_train_fwd_plan(index, m, k, n)[0],
           "bwd_cluster": cac.card_train_bwd_plan(index, m, k, n),
           "dw_plan": cac.card_train_bwd_dw_plan(index, m, k, n)}
    y = cac.cac_train_fwd_call(x, w, beta)
    if not _bits_equal(torch, y, cac.cac_train_fwd_plain(x, w, beta)):
        fail(f"cac_train_fwd {where} M={m} K={k} N={n}: differs from plain (must be bit-exact)")
    fused = cac.cac_train_bwd_fused_call(x, w, beta, g)
    split = (cac.cac_train_bwd_dx_call(x, w, beta, g),) + cac.cac_train_bwd_dw_call(x, w, beta, g)
    again = (cac.cac_train_bwd_fused_call(x, w, beta, g),
             (cac.cac_train_bwd_dx_call(x, w, beta, g),) + cac.cac_train_bwd_dw_call(x, w, beta, g))
    for which, first, second in zip(("fused", "split"), (fused, split), again):
        for name, a, b in zip(("dx", "dw", "dbeta"), first, second):
            if not _bits_equal(torch, a, b):
                fail(f"cac_train_bwd {which} {where} M={m} K={k} N={n}: {name} differs between "
                     f"two launches (must repeat bit for bit)")
    del again
    plain = cac.cac_train_bwd_fused_plain(x, w, beta, g)
    dx_keep, dw_keep = _window_clear(torch, x, w, beta, rows=max(1, (1 << 28) // (k * n)))
    row["left_out"] = {"dx": int((~dx_keep).sum()), "dw": int((~dw_keep).sum())}
    for name, a, b, c, keep in zip(("dx", "dw", "dbeta"), fused, split, plain,
                                   (dx_keep, dw_keep, dw_keep)):
        for which, got, want in (("fused", a, c), ("split", b, c)):
            err, ok = _close_err(torch, got, want, keep)
            row[f"{name}_{which}_max_abs_err"] = err
            if not ok:
                fail(f"cac_train {which} {name} {where} M={m} K={k} N={n}: beyond atol = rtol = "
                     f"{TRAIN_TOL} (max |diff| {err:.3e})")
    del fused, split, plain, dx_keep, dw_keep
    xb, wb, gb = _bnn_operands_on(torch, gen, dev, m, k, n)
    if not torch.equal(bnn.bnn_matmul_kernel_call(xb, wb), bnn.bnn_matmul_plain(xb, wb)):
        fail(f"bnn forward {where} M={m} K={k} N={n}: differs from plain (must be bit-exact)")
    dx, dw = bnn.bnn_bwd_dx_call(xb, wb, gb), bnn.bnn_bwd_dw_call(xb, wb, gb)
    if not (torch.equal(dx, bnn.bnn_bwd_dx_call(xb, wb, gb))
            and torch.equal(dw, bnn.bnn_bwd_dw_call(xb, wb, gb))):
        fail(f"bnn backward {where} M={m} K={k} N={n}: a second launch gave other values")
    keep = torch.ones((), dtype=torch.bool, device=dev)
    for name, kern, want in (("dx", dx, bnn.bnn_bwd_dx_plain(xb, wb, gb)),
                             ("dw", dw, bnn.bnn_bwd_dw_plain(xb, wb, gb))):
        err, ok = _close_err(torch, kern, want, keep)
        row[f"bnn_{name}_max_abs_err"] = err
        if not ok:
            fail(f"bnn backward {name} {where} M={m} K={k} N={n}: beyond atol = rtol = "
                 f"{TRAIN_TOL} (max |diff| {err:.3e})")
    del dx, dw
    row["bnn_plan"] = {"fwd": list(bnn._card_fwd_plan(index, m, k, n, wb.dtype)),
                       **{nm: list(bnn._card_plan(index, m, k, n, nm == "dx"))
                          for nm in ("dx", "dw")}}
    sx, sw = sign(xb), sign(wb)
    mkn = float(m) * k * n
    timed = {  # (kernel, plain, library call or None, operations, bytes, rate)
        "fwd": (lambda: cac.cac_train_fwd_call(x, w, beta),
                lambda: cac.cac_train_fwd_plain(x, w, beta), None,
                4 * mkn, 4.0 * (m * k + 2 * k * n + m * n), CUDA_CORE_OPS_S),
        "bwd_fused": (lambda: cac.cac_train_bwd_fused_call(x, w, beta, g),
                      lambda: cac.cac_train_bwd_fused_plain(x, w, beta, g), None,
                      9 * mkn, 4.0 * (2 * m * k + 4 * k * n + m * n), CUDA_CORE_OPS_S),
        "bwd_dx": (lambda: cac.cac_train_bwd_dx_call(x, w, beta, g),
                   lambda: cac.cac_train_bwd_dx_plain(x, w, beta, g), None,
                   6 * mkn, 4.0 * (2 * m * k + 2 * k * n + m * n), CUDA_CORE_OPS_S),
        "bwd_dw": (lambda: cac.cac_train_bwd_dw_call(x, w, beta, g),
                   lambda: cac.cac_train_bwd_dw_plain(x, w, beta, g), None,
                   7 * mkn, 4.0 * (m * k + 4 * k * n + m * n), CUDA_CORE_OPS_S),
        "bnn_fwd_f32": (lambda: bnn.bnn_matmul_kernel_call(xb, wb),
                        lambda: bnn.bnn_matmul_plain(xb, wb), lambda: torch.matmul(sx, sw),
                        2 * mkn, 4.0 * (m * k + k * n + m * n), TENSOR_CORE_OPS_S),
        "bnn_bwd_dx": (lambda: bnn.bnn_bwd_dx_call(xb, wb, gb),
                       lambda: bnn.bnn_bwd_dx_plain(xb, wb, gb), lambda: torch.matmul(gb, sw.T),
                       2 * mkn, 4.0 * (2 * m * k + k * n + m * n), TENSOR_CORE_OPS_S),
        "bnn_bwd_dw": (lambda: bnn.bnn_bwd_dw_call(xb, wb, gb),
                       lambda: bnn.bnn_bwd_dw_plain(xb, wb, gb), lambda: torch.matmul(sx.T, gb),
                       2 * mkn, 4.0 * (m * k + 2 * k * n + m * n), TENSOR_CORE_OPS_S),
    }
    for name, (kern, plain_fn, lib, n_ops, n_bytes, rate) in timed.items():
        bound, by = _bound(n_bytes, n_ops, rate)
        row[name] = {"ms": time_ms(torch, kern, iters=10, flush=flush),
                     "plain_ms": time_ms(torch, plain_fn, iters=1, warmup=0, flush=flush),
                     "library_ms": None if lib is None else time_ms(torch, lib, iters=10,
                                                                    flush=flush),
                     "bound_ms": bound, "bound_by": by}
        row[name]["bound_share"] = bound / row[name]["ms"]
    times = "; ".join(
        f"{nm} {r['ms']:.4f} ms (plain {r['plain_ms']:.1f}, "
        + (f"library {r['library_ms']:.4f}, " if r["library_ms"] is not None else "")
        + f"bound {r['bound_ms']:.5f} {r['bound_by']}, {100 * r['bound_share']:.0f}%)"
        for nm, r in ((nm, row[nm]) for nm in timed))
    print(f"[train-families-kernels] {where} M={m} K={k} N={n}: kernel 2 bit-exact (K split "
          f"{row['fwd_splits']}), 5 and 3 + 4 within {TRAIN_TOL} (dx "
          f"{row['dx_fused_max_abs_err']:.2e} / {row['dx_split_max_abs_err']:.2e}, dw "
          f"{row['dw_fused_max_abs_err']:.2e} / {row['dw_split_max_abs_err']:.2e}, dbeta "
          f"{row['dbeta_fused_max_abs_err']:.2e} / {row['dbeta_split_max_abs_err']:.2e}; left "
          f"out dx {row['left_out']['dx']}, dw {row['left_out']['dw']}; cluster "
          f"{row['bwd_cluster']}, dw plan {row['dw_plan']}), kernel 6 bit-exact, 8 and 9 within "
          f"{TRAIN_TOL} (dx {row['bnn_dx_max_abs_err']:.2e}, dw {row['bnn_dw_max_abs_err']:.2e};"
          f" plans {row['bnn_plan']}), all repeatable; {times}")
    return row


def phase_train_families_kernels(torch, np, dev, flush):
    """Kernels 2-6, 8 and 9 at every shape of ``FAMILY_TRAIN_SHAPES``
    (``_family_train_row``)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    rows = []
    for where, m, k, n in FAMILY_TRAIN_SHAPES:
        rows.append(_family_train_row(torch, dev, flush, gen, where, m, k, n))
        torch.cuda.empty_cache()
    return rows


def _grad_twice(torch, dev, arch, tag, probe):
    """``train.steps.loss_and_grads`` of ``arch`` in bika at full width (the
    step's gradient, where the whole AdamW step's state does not fit the
    card) twice on one batch (4 x 128), each with the launch counters
    zeroed just before and read just after (each projection a kernel-2
    forward twice under remat and a kernel-5 backward once), the two
    gradients equal bit for bit (the first kept on the card), and the
    leaf ``probe(grads)`` picks finite and non-zero."""
    from repro_torch.data.lm import LMDataConfig, lm_batch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.steps import loss_and_grads

    n_proj = _train_projections(arch)
    expect = {"cac_train_fwd": 2 * n_proj, "cac_train_bwd_fused": n_proj}
    api = build_model(arch, phase="train")
    t0 = time.perf_counter()
    params = api.init(42, device=dev)
    batch = lm_batch(LMDataConfig(vocab=arch.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                  seed=SEED), 0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[{tag}] {arch.name} bika, {arch.n_layers} layer(s), d_model {arch.d_model}: "
          f"{n_params / 1e9:.3f} G parameters ({4 * n_params / 1e9:.2f} GB), init "
          f"{time.perf_counter() - t0:.2f} s")
    runs, first = [], None
    for i in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        met, grads = loss_and_grads(api, params, batch)
        loss = float(met["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if counts != dict(_NO_LAUNCHES, **expect):
            fail(f"{arch.name} bika gradient: launch counts {counts}, expected {expect} and 0 "
                 f"elsewhere")
        name, leaf = probe(grads)
        stats = torch.stack([leaf.abs().max(), leaf.isfinite().all()])
        if not (math.isfinite(loss) and float(stats[1]) == 1.0 and float(stats[0]) > 0.0):
            fail(f"{arch.name} bika gradient: loss {loss}, {name} gradient max |g| "
                 f"{float(stats[0])}, finite {bool(stats[1])}")
        leaves = tree_leaves(grads)
        if first is None:
            first = leaves
        else:
            differ = [j for j, (a, b) in enumerate(zip(first, leaves))
                      if not _bits_equal(torch, a, b)]
            if differ:
                fail(f"{arch.name} bika gradient: {len(differ)} of {len(leaves)} leaves differ "
                     f"between two runs on one batch (must repeat bit for bit)")
        runs.append({"loss": loss, "aux_loss": float(met["aux_loss"]), "ms": ms,
                     "max_memory_allocated": peak, "launches": counts})
        print(f"[{tag}] {arch.name} bika gradient {i}: loss {loss:.5f} aux "
              f"{float(met['aux_loss']):.5f} {ms:.1f} ms, peak memory {peak / 2**30:.2f} GiB, "
              f"launches {counts}")
        del grads, leaves, met
    print(f"[{tag}] {arch.name} bika: the two gradients equal bit for bit "
          f"({len(first)} leaves)")
    return {"layers": arch.n_layers, "runs": runs, "bit_equal": True,
            "launches_per_gradient": expect, "parameters": n_params}


def _mixtral_grad_twice(torch, np, dev):
    """mixtral-8x22b in bika at full width, MIXTRAL_TRAIN_LAYERS layer(s),
    the gradient twice (``_grad_twice``; per layer: 4 attention and 8 x 3
    expert projections; the first kept on the card: 20.8 GB beside a
    gradient's ~42 GiB peak), the router's gradient finite and non-zero (it
    flows through the gates and the aux loss)."""
    from repro_torch.configs import get_config

    return _grad_twice(torch, dev, get_config(MIXTRAL, compute_mode="bika",
                                              n_layers=MIXTRAL_TRAIN_LAYERS),
                       "train-families", lambda g: ("router", g["layers"]["moe"]["router"]["w"]))


def phase_train_families(torch, np, dev):
    """seamless-m4t-large-v2 in bika at full width and SEAMLESS_TRAIN_LAYERS
    + SEAMLESS_TRAIN_LAYERS layers through the Trainer (``phase_train_path``:
    3 AdamW steps, a profiled one and a split-backward one, frames from the
    pipeline) and in bnn at 6 + 6;
    mixtral-8x22b at full width, 1 layer: the bika gradient twice, bit for
    bit (``_mixtral_grad_twice``), 3 AdamW steps in bnn and in qnn8; then
    one train step of each family's SMOKE config card vs CPU in bika and
    bnn (``phase_train_parity``, codes, Signs, STE masks and expert choices
    held at genuine ties)."""
    from repro_torch.configs import get_config, get_smoke

    out = {}
    out["seamless_bika"] = phase_train_path(
        torch, np, dev, "bika", tag="train-families",
        arch=get_config(ENCDEC, compute_mode="bika", n_layers=SEAMLESS_TRAIN_LAYERS,
                        n_encoder_layers=SEAMLESS_TRAIN_LAYERS))
    torch.cuda.empty_cache()
    out["seamless_bnn"] = phase_train_path(
        torch, np, dev, "bnn", tag="train-families", profiled=False,
        arch=get_config(ENCDEC, compute_mode="bnn", n_layers=FAMILY_LOWBIT_LAYERS,
                        n_encoder_layers=FAMILY_LOWBIT_LAYERS))
    torch.cuda.empty_cache()
    out["mixtral_bika_grad"] = _mixtral_grad_twice(torch, np, dev)
    torch.cuda.empty_cache()
    for mode in ("bnn", "qnn8"):
        out[f"mixtral_{mode}"] = phase_train_path(
            torch, np, dev, mode, tag="train-families", profiled=False,
            arch=get_config(MIXTRAL, compute_mode=mode, n_layers=MIXTRAL_TRAIN_LAYERS))
        torch.cuda.empty_cache()
    for name in (ENCDEC, MIXTRAL):
        for mode in ("bika", "bnn"):
            hooks = _sign_hooks(torch) if mode == "bika" else _bnn_train_hooks(torch)
            if name == MIXTRAL:
                hooks = _both(hooks, _route_hooks(torch))
            out[f"parity {name} {mode}"] = phase_train_parity(
                torch, np, dev, mode, hooks, tag="train-families-parity",
                arch=get_smoke(name, compute_mode=mode),
                cancelling=("/decoder/xattn/wk/beta",) if (name, mode) == (ENCDEC, "bika")
                else ())
    return out


# ---------------------------------------------------------------------------
# train-recurrent: training zamba2-2.7b (hybrid) and xlstm-125m at full width
# ---------------------------------------------------------------------------

ZAMBA, XLSTM = "zamba2-2.7b", "xlstm-125m"
# kernels 2-6, 8 and 9 at every (M, K, N) the two families' training
# projections give them at batch 4 x seq 128 (M = 512): zamba2's in_proj
# (N = 10448 = 163 x 64 + 16: a 16-column last tile in kernels 2-5, a
# 16-step last stage of kernel 8's contraction, an 80-row last tile of
# kernel 9's output), out_proj and the shared block's; xlstm-125m's (its
# mLSTM up and its sLSTM wx share (768, 3072))
RECURRENT_TRAIN_SHAPES = [
    (f"{ZAMBA} in_proj", 512, 2560, 10448), (f"{ZAMBA} out_proj", 512, 5120, 2560),
    (f"{ZAMBA} shared q/k/v/o", 512, 2560, 2560), (f"{ZAMBA} shared gate/up", 512, 2560, 10240),
    (f"{ZAMBA} shared down", 512, 10240, 2560), (f"{XLSTM} mLSTM up, sLSTM wx", 512, 768, 3072),
    (f"{XLSTM} mLSTM q/k/v", 512, 1536, 1536), (f"{XLSTM} mLSTM down", 512, 1536, 768),
    (f"{XLSTM} sLSTM down", 512, 768, 768)]
ZAMBA_STEP_LAYERS = 6  # the bika AdamW step: 1 of 9 groups (the whole state, ~91 GB, does not fit)
ZAMBA_TRAIN_LOWBIT_LAYERS = 6  # bnn and qnn8: one group, 38 / 19 / 19 launches a bnn step
XLSTM_TRAIN_STEPS = 1  # xlstm-125m's bika and bnn steps (3 until the tooling phase came)


def phase_train_recurrent_kernels(torch, np, dev, flush):
    """Kernels 2-6, 8 and 9 at every shape of ``RECURRENT_TRAIN_SHAPES``
    (``_family_train_row``)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    rows = []
    for where, m, k, n in RECURRENT_TRAIN_SHAPES:
        rows.append(_family_train_row(torch, dev, flush, gen, where, m, k, n))
        torch.cuda.empty_cache()
    return rows


def phase_train_recurrent(torch, np, dev):
    """zamba2-2.7b at full width: the bika gradient at all 54 layers twice,
    bit for bit (``_grad_twice``: 342 kernel-2 and 171 kernel-5 launches
    each; the AdamW step's state at 54 layers does not fit the card), the
    Trainer in bika at ZAMBA_STEP_LAYERS (``phase_train_path``: 3 AdamW
    steps, a fused one, a split-backward one and a profiled one), in bnn
    and qnn8 at ZAMBA_TRAIN_LOWBIT_LAYERS; xlstm-125m whole in bika and bnn,
    XLSTM_TRAIN_STEPS each; then one train step of each family's SMOKE config card
    vs CPU in bika and bnn (``phase_train_parity``, Signs and STE masks
    held at genuine ties). Each part's seconds go to ``out["seconds"]``."""
    from repro_torch.configs import get_config, get_smoke

    out = {"cut": f"{ZAMBA}: the bika gradient at all 54 layers, the bika steps at "
                  f"{ZAMBA_STEP_LAYERS}, bnn / qnn8 at {ZAMBA_TRAIN_LOWBIT_LAYERS}; {XLSTM} "
                  f"whole; every width as published", "seconds": {}}
    print(f"[train-recurrent] {smi_line()}; {out['cut']}")

    def part(key, fn, *args, **kw):
        t0 = time.perf_counter()
        out[key] = fn(*args, **kw)
        torch.cuda.empty_cache()
        out["seconds"][key] = time.perf_counter() - t0

    part("zamba2_bika_grad", _grad_twice, torch, dev, get_config(ZAMBA, compute_mode="bika"),
         "train-recurrent", lambda g: ("mamba A_log", g["mamba"]["ssm"]["A_log"]))
    part("zamba2_bika", phase_train_path, torch, np, dev, "bika", tag="train-recurrent",
         profile_split=False, n_steps=1,
         arch=get_config(ZAMBA, compute_mode="bika", n_layers=ZAMBA_STEP_LAYERS))
    for mode in ("bnn", "qnn8"):
        part(f"zamba2_{mode}", phase_train_path, torch, np, dev, mode, tag="train-recurrent",
             profiled=False,
             arch=get_config(ZAMBA, compute_mode=mode, n_layers=ZAMBA_TRAIN_LOWBIT_LAYERS))
    for mode in ("bika", "bnn"):
        part(f"xlstm_{mode}", phase_train_path, torch, np, dev, mode, tag="train-recurrent",
             profiled=False, n_steps=XLSTM_TRAIN_STEPS, arch=get_config(XLSTM, compute_mode=mode))
    for name in (ZAMBA, XLSTM):
        for mode in ("bika", "bnn"):
            hooks = _sign_hooks(torch) if mode == "bika" else _bnn_train_hooks(torch)
            part(f"parity {name} {mode}", phase_train_parity, torch, np, dev, mode, hooks,
                 tag="train-recurrent-parity", arch=get_smoke(name, compute_mode=mode))
    print("[train-recurrent] seconds: " + ", ".join(f"{k} {v:.1f}"
                                                    for k, v in out["seconds"].items()))
    return out


# ---------------------------------------------------------------------------
# the tooling phase: the kernel contracts on the card's build and occupancy,
# and the measured plan autotuner
# ---------------------------------------------------------------------------

# one shape a path: the serve path's decode projection for the paths that
# serve, the train step's gate/up (batch 4 x seq 128) for those that train;
# kernel 11 at smollm's decode case (B 4, C 1, Hq 15, Hkv 5, D 64, bs 16, T 8)
TOOLING_SHAPES = [("hw_fwd", (N_SLOTS, 960, 2560)), ("train_fwd", (512, 960, 2560)),
                  ("train_bwd", (512, 960, 2560)), ("train_bwd_dw", (512, 960, 2560)),
                  ("bnn", (512, 960, 2560)), ("bnn_packed", (N_SLOTS, 960, 2560)),
                  ("bnn_bwd", (512, 960, 2560)), ("qnn8", (N_SLOTS, 960, 2560))]
TOOLING_PAGED = (N_SLOTS, 1, 15, 5, 64, BLOCK, 8)
TOOLING_ITERS, TOOLING_WARMUP = 10, 2
# the kernels line's names -> the kernel numbers of ROADMAP Queue 2
KERNEL_NUMBERS = {"cac_matmul": 1, "cac_train_fwd": 2, "cac_train_bwd_dx": 3,
                  "cac_train_bwd_dw": 4, "cac_train_bwd_fused": 5, "bnn_matmul": 6,
                  "bnn_packed_matmul": 7, "bnn_bwd_dx": 8, "bnn_bwd_dw": 9, "qnn_matmul": 10,
                  "paged_attn": 11}


def phase_tooling(torch, np, dev, logs):
    """The kernel contracts over the zoo with this build's ``-Xptxas -v``
    output of every entry function, the card's SM count and its occupancy
    for every plan (any finding fails), one row per entry function; then
    the measured autotuner at one shape a path (``TOOLING_SHAPES``, kernel
    11 at ``TOOLING_PAGED``) against a temporary cache file: every
    candidate's median ms, the default plan's and the winner's, every
    candidate's output held against the default plan's; a second
    resolution at each shape, from the file, must return the winner with
    nothing timed. The file is removed and the in-memory cache cleared at
    the end, so no later phase reads a tuned plan."""
    from repro_torch.analysis import kernel_contracts as kc
    from repro_torch.kernels import autotune

    from repro_torch.kernels import build

    tag = "tooling"
    index = dev.index or 0
    missing = [name for name in build.KERNEL_SOURCES if not logs.get(name, "").strip()]
    if missing:
        fail(f"{tag}: no -Xptxas -v output for {missing}: the contracts need every source's")
    log = "\n".join(logs[name] for name in sorted(logs))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ptxas_h100.log"), "w") as fh:
        fh.write(log)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    t0 = time.perf_counter()
    rep = kc.run(ptxas_log=log, sms=sms, max_blocks=lambda path, shape, plan:
                 autotune.card_max_blocks(path, shape, plan, index))
    contracts_s = time.perf_counter() - t0
    data = rep.data[kc.PASS]
    for row in data["ptxas"]:
        print(f"[{tag}] ptxas {row['stem']}<{','.join(map(str, row['targs']))}> kernels "
              f"{row['kernels']}: {row['registers']} registers, {row['smem']} B static smem, "
              f"spill stores {row['spill_stores']} B (budget {row.get('spill_budget', 0)}), "
              f"loads {row['spill_loads']} B")
    if not rep.ok:
        print(rep.render())
        fail(f"{tag}: {len(rep.findings)} kernel-contract finding(s)")
    print(f"[{tag}] contracts: {len(data['ptxas'])} entry functions, {data['coverage']} route x "
          f"config pairs, {len(data['entries'])} (route, arch, case) rows, {sms} SMs, "
          f"0 findings, {contracts_s:.1f} s")

    old_env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    path_file = os.path.join(ROOT, "build", f"autotune-tooling-{os.getpid()}.json")
    os.makedirs(os.path.dirname(path_file), exist_ok=True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = path_file
    autotune.clear_cache()
    rows = []
    t0 = time.perf_counter()
    try:
        for path, shape in TOOLING_SHAPES + [("paged_attn", TOOLING_PAGED)]:
            if path == "paged_attn":
                rec = autotune.measured_paged_search(*shape, iters=TOOLING_ITERS,
                                                     warmup=TOOLING_WARMUP, seed=SEED,
                                                     index=index)
            else:
                rec = autotune.measured_search(path, *shape, iters=TOOLING_ITERS,
                                               warmup=TOOLING_WARMUP, seed=SEED, index=index)
            row = {k: rec[k] for k in ("path", "shape", "key", "default", "default_ms",
                                       "winner", "winner_ms", "tolerance", "held")}
            row["kernels"] = list(autotune.PATH_KERNELS[path])
            row["candidates"] = [{"plan": c["plan"], "ms": c["ms"],
                                  "max_abs_err": c["max_abs_err"], **(
                                      {"half": c["half"]} if "half" in c else {})}
                                 for c in rec["candidates"]]
            row["winner_over_default"] = rec["winner_ms"] / rec["default_ms"]
            row["max_abs_err"] = max(c["max_abs_err"] for c in rec["candidates"])
            rows.append(row)
            print(f"[{tag}] autotune {path} {shape}: {len(row['candidates'])} candidates "
                  + ", ".join(f"{c['plan']}{'/' + c['half'] if 'half' in c else ''} "
                              f"{c['ms']:.5f}" for c in row["candidates"])
                  + f"; default {rec['default']} {rec['default_ms']:.5f} ms, winner "
                  f"{rec['winner']} {rec['winner_ms']:.5f} ms ({row['winner_over_default']:.3f}"
                  f" of the default); outputs within {rec['tolerance']} of the default plan's "
                  f"(max {row['max_abs_err']:.3g})")
        search_s = time.perf_counter() - t0
        # the second resolution: from the file alone, nothing timed
        autotune.clear_cache()
        timed = autotune.timed_calls
        hits = 0
        for row in rows:
            if row["path"] == "paged_attn":
                got = autotune.get_paged_plan(*row["shape"], index=index)
            elif row["path"] == "bnn_bwd":
                got = {h: autotune.get_plan("bnn_bwd", *row["shape"], index, want_dx=h == "dx")
                       for h in ("dx", "dw")}
            else:
                got = autotune.get_plan(row["path"], *row["shape"], index)
            row["second_resolution"] = got
            hits += got == row["winner"]
        retimed = autotune.timed_calls - timed
        invalid = autotune.invalid_cache_entries()
        if hits != len(rows) or retimed or invalid:
            fail(f"{tag}: the second resolution hit the cache at {hits} of {len(rows)} shapes, "
                 f"{retimed} calls re-timed, invalid entries {invalid}")
        with open(path_file) as fh:
            stored = json.load(fh)
        print(f"[{tag}] second resolution: {hits} of {len(rows)} shapes from the cache file "
              f"({len(stored)} entries), {retimed} calls re-timed; search {search_s:.1f} s")
    finally:
        if os.path.exists(path_file):
            os.remove(path_file)
        if old_env is None:
            os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE", None)
        else:
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = old_env
        autotune.clear_cache()
    return {"contracts": {"entry_functions": len(data["ptxas"]),
                          "coverage": data["coverage"], "rows": len(data["entries"]),
                          "findings": len(rep.findings), "sms": sms, "seconds": contracts_s,
                          "ptxas": data["ptxas"]},
            "autotune": rows, "cache_hits": hits, "retimed": retimed,
            "search_seconds": search_s}


# ---------------------------------------------------------------------------
# phase 20: tensor-parallel serving (nemotron-4-15b at tp = 2 on one card)
# ---------------------------------------------------------------------------

TP = 2
# nemotron-4-15b's projections, (K, N) of the unsharded call; a tp = 2 rank
# holds N / 2 of each: q/o (6144, 3072), k/v (6144, 512), up (6144, 12288),
# down (24576, 3072)
TP_KN = [("q/o", 6144, 6144), ("k/v", 6144, 1024), ("up", 6144, 24576), ("down", 24576, 6144)]
TP_HEADS = (48, 8, 128)  # nemotron-4-15b's Hq, Hkv, D: a rank's 24 and 4 at tp = 2
TP_TIMEOUT_S = 300.0  # a collective waiting on a dead peer raises after this
TP_DEADLINE_S = 600.0  # a whole rank session
TP_QNN_LAYERS = 1


def phase_tp_kernels(torch, np, dev, flush):
    """(a) Kernels 1, 7 and 10 on each tp = 2 rank's column block of
    nemotron-4-15b's four projections at decode (M = N_SLOTS): bit-exact
    against the plain version and equal to the whole call's columns, timed
    beside plain, a library call and the bound. Kernel 11 on each rank's
    heads (Hq 24, Hkv 4, D 128, G 6), decode and a chunk, fp32 and int8,
    given the unsharded head counts: at the unsharded call's plan, each head
    bit-equal to the whole call's, timed likewise. No model is built."""
    from repro_torch.core.backend import pack_signs, unpack_signs
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import bnn_matmul as bnn
    from repro_torch.kernels.cac_matmul import cac_matmul_kernel_call, cac_matmul_plain
    from repro_torch.kernels.paged_attn import paged_attn_kernel_call
    from repro_torch.kernels.qnn_matmul import qnn_matmul_kernel_call, qnn_matmul_plain
    from repro_torch.kernels.ref import paged_attention_ref

    rng = np.random.default_rng(SEED + 30)
    m = N_SLOTS
    rows = []
    for where, k, n in TP_KN:
        half = n // TP
        x = torch.from_numpy(rng.integers(-128, 128, size=(m, k)).astype(np.int8)).to(dev)
        tau = torch.from_numpy(rng.integers(-128, 128, size=(k, n)).astype(np.int8)).to(dev)
        sp = pack_signs(torch.from_numpy(np.where(rng.random((k, n)) < 0.5, 1, -1)
                                         .astype(np.int8))).to(dev)
        xf, _w, _g = _bnn_operands(np, rng, m, k, 8)
        xf = torch.from_numpy(xf).to(dev)
        xq, wq, ws = (torch.from_numpy(a).to(dev) for a in _qnn_operands(np, rng, m, k, n))
        cases = (
            ("cac_matmul", cac_matmul_kernel_call, cac_matmul_plain,
             lambda c: (x, tau[:, c].contiguous(), sp[:, c].contiguous()),
             lambda: m * k + k * half + k * half // 8 + 4 * m * half,
             CUDA_CORE_OPS_S, None),
            ("bnn_packed_matmul", bnn.bnn_packed_matmul_kernel_call,
             bnn.bnn_packed_matmul_plain, lambda c: (xf, sp[:, c].contiguous()),
             lambda: 4 * m * k + k * half // 8 + 4 * m * half, TENSOR_CORE_OPS_S,
             lambda a: _sign_matmul(torch, a[0], unpack_signs(a[1], k))),
            ("qnn_matmul", qnn_matmul_kernel_call, qnn_matmul_plain,
             lambda c: (xq, wq[:, c].contiguous(), ws[c].contiguous(), ACT_SCALE),
             lambda: m * k + k * half + 4 * half + 4 * m * half, INT8_TENSOR_OPS_S,
             lambda a: _int_mm_yardstick(torch, *a[:3])[0]),
        )
        for name, fn, plain, operands, nbytes, rate, library in cases:
            whole = fn(*operands(slice(None)))
            for r in range(TP):
                cols = slice(r * half, (r + 1) * half)
                args = operands(cols)
                got = fn(*args)
                want = plain(*args)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if err != 0.0 or not torch.equal(got, whole[:, cols]):
                    fail(f"[tp-kernels] {name} {where} rank {r} (K={k}, N={half}): max "
                         f"|kernel - plain| = {err}, equal to the whole call's columns "
                         f"{torch.equal(got, whole[:, cols])}")
            row = {"kernel": name, "where": f"nemotron-4-15b {where}, a tp={TP} rank", "M": m,
                   "K": k, "N": half, "max_abs_err": err,
                   "ms": time_ms(torch, lambda: fn(*args), flush=flush),
                   "plain_ms": time_ms(torch, lambda: plain(*args), iters=3, flush=flush)}
            row["bound_ms"], row["bound_by"] = _bound(nbytes(), 2.0 * m * k * half, rate)
            row["library_ms"] = (time_ms(torch, library(args), flush=flush)
                                 if library is not None else None)
            rows.append(row)
            print(f"[tp-kernels] {name} {where} (K={k}, N={half}) both ranks bit-exact and "
                  f"equal to the whole call's columns; ms={row['ms']:.5f} "
                  f"plain_ms={row['plain_ms']:.5f} bound_ms={row['bound_ms']:.6f} "
                  f"({row['bound_by']}) library_ms={row['library_ms']}")
        del x, tau, sp, xf, xq, wq, ws
    # the tied head (a float product, not a kernel): a rank's vocab rows give
    # the whole product's columns bit for bit, which the logits' gather needs
    vocab, dm = 256000, TP_KN[0][1]
    table = torch.randn((vocab, dm), device=dev, generator=torch.Generator(device=dev)
                        .manual_seed(SEED + 31)) * 0.02
    for m_head in (1, N_SLOTS, CHUNK):
        xh = torch.randn((m_head, dm), device=dev)
        whole = xh @ table.t()
        half = vocab // TP
        equal = all(torch.equal(xh @ table[r * half:(r + 1) * half].t(),
                                whole[:, r * half:(r + 1) * half]) for r in range(TP))
        if not equal:
            fail(f"[tp-kernels] the tied head at M={m_head}: a rank's vocab rows do not give "
                 f"the whole product's columns bit for bit")
        rows.append({"kernel": "tied_head", "M": m_head, "K": dm, "N": half, "equal": equal})
        print(f"[tp-kernels] tied head x @ table.T at M={m_head}, a rank's {half} of {vocab} "
              f"rows: equal to the whole product's columns bit for bit")
    del table, xh, whole
    hq, hkv, d = TP_HEADS
    for case, b, c in (("decode", N_SLOTS, 1), ("chunk", 1, CHUNK)):
        t = MAX_LEN // BLOCK
        for quantized in (False, True):
            q, k, v, tables, q_pos, ks, vs = _paged_case(torch, np, rng, dev, b, c, t,
                                                         quantized, hq=hq, hkv=hkv, d=d)
            whole = paged_attn_kernel_call(q, k, v, tables, q_pos, k_scale=ks, v_scale=vs)
            plan = autotune.get_paged_plan(b, c, hq, hkv, d, BLOCK, t, dev.index)
            own = autotune.get_paged_plan(b, c, hq // TP, hkv // TP, d, BLOCK, t, dev.index)
            for r in range(TP):
                qh = slice(r * hq // TP, (r + 1) * hq // TP)
                kh = slice(r * hkv // TP, (r + 1) * hkv // TP)
                pool = [None if a is None else a[:, :, kh].contiguous() for a in (k, v, ks, vs)]
                qr = q[:, :, qh].contiguous()
                args = (qr, pool[0], pool[1], tables, q_pos)
                got = ops.paged_attention(*args, k_scale=pool[2], v_scale=pool[3],
                                          heads=(hq, hkv))
                want = paged_attention_ref(*args, pool[2], pool[3])
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not err <= ATTN_TOL or not _bits_equal(torch, got, whole[:, :, qh]):
                    fail(f"[tp-kernels] paged_attn {case} int8={quantized} rank {r}: max "
                         f"|kernel - plain| = {err}, heads equal to the whole call's "
                         f"{_bits_equal(torch, got, whole[:, :, qh])}")
            row = {"kernel": "paged_attn", "where": f"nemotron-4-15b {case}, a tp={TP} rank",
                   "B": b, "C": c, "T": t, "Hq": hq // TP, "Hkv": hkv // TP, "D": d,
                   "int8": quantized, "max_abs_err": err,
                   "plan": {"unsharded": list(plan), "own": list(own)},
                   "ms": time_ms(torch, lambda: ops.paged_attention(
                       *args, k_scale=pool[2], v_scale=pool[3], heads=(hq, hkv)), flush=flush),
                   "plain_ms": time_ms(torch, lambda: paged_attention_ref(
                       *args, pool[2], pool[3]), iters=3, flush=flush),
                   "library_ms": time_ms(torch, lambda: _sdpa_yardstick(
                       torch, *args, pool[2], pool[3]), flush=flush)}
            row["bound_ms"], row["bound_by"] = _attn_bound(qr, pool[0], tables, q_pos,
                                                           quantized)
            rows.append(row)
            print(f"[tp-kernels] paged_attn {case} B={b} C={c} Hq={hq // TP} Hkv={hkv // TP} "
                  f"D={d} int8={quantized}: both ranks' heads bit-equal to the whole call's "
                  f"at its plan {tuple(plan)} (a rank's own would be {tuple(own)}); max_abs_err "
                  f"{err:.3e} ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} "
                  f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}) "
                  f"library_ms={row['library_ms']:.5f}")
    return rows


def _sign_matmul(torch, x, w):
    """The library yardstick of a sign product: torch.matmul on +-1 float32."""
    xs, wf = torch.where(x >= 0, 1.0, -1.0), w.float()
    return lambda: xs @ wf


def _drain_record(outs, counts, wall, summ, held, log):
    """What the tp phase compares of a drain: tokens, first logits, launches,
    ticks, resident param and KV bytes, wall seconds, collectives."""
    from repro_torch.distributed import comm
    from repro_torch.nn.module import param_bytes

    eng = held["engine"]
    return {"tokens": outs, "prefill": log["prefill"], "decode": log["decode"],
            "launches": counts, "wall_s": wall,
            "ticks": summ["decode_steps"] + summ["prefill_chunks"],
            "param_bytes": param_bytes(eng.params), "kv_bytes": eng.scheduler.kv.pool_bytes,
            "collectives": comm.collective_counts()}


def _tp_arch(mode, layers):
    from repro_torch.configs import get_config

    return get_config("nemotron-4-15b", n_layers=layers, compute_mode=mode,
                      pack_signs=mode == "bika", remat=False, paged_attn_route="fused")


def _tp_drain(torch, np, dev, mode, layers, seed, mesh=None):
    """One nemotron-4-15b drain of the 8 requests (paged engine) from a
    train-form tree of ``seed``: single-process, or a rank of ``mesh``
    (each rank builds the whole tree and keeps its shard)."""
    import gc

    from repro_torch.distributed import comm
    from repro_torch.models import build_model

    arch = _tp_arch(mode, layers)
    gen = torch.Generator(device=dev).manual_seed(seed)
    train = build_model(arch, phase="train").init(gen, device=dev)
    held, log = {}, {}
    route = "cac_hw" if mode == "bika" else "qnn8"
    comm.reset_collectives()
    outs, counts, wall, summ = _serve(np, train, arch, False, dev, count_launches=True,
                                      held=held, record=log, mesh=mesh)
    _check_serve_launches(arch, route, counts, summ)
    rec = _drain_record(outs, counts, wall, summ, held, log)
    rec["peak_gb"] = _gb(torch.cuda.max_memory_allocated())
    del train, held
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _tp_rank(rank, world, jobs):
    """A spawned rank of the tp phase: each job (mode, layers, seed) drained
    under a (1, world) mesh of the group ``spawn_ranks`` made. Rank > 0
    drops its logits (rank 0's are compared)."""
    import numpy as np
    import torch

    from repro_torch.distributed.meshes import make_mesh

    mesh = make_mesh((1, world), ("data", "model"))
    dev = torch.device("cuda", torch.cuda.current_device())
    out = []
    for mode, layers, seed in jobs:
        torch.cuda.reset_peak_memory_stats()
        rec = _tp_drain(torch, np, dev, mode, layers, seed, mesh=mesh)
        if rank:
            rec["prefill"] = rec["decode"] = None
        out.append(rec)
    return out


def _tp_compare(tag, ref, ranks, logits=True):
    """Tokens (and first logits, bit for bit) of every rank against the
    single process; kernel launches a rank equal to the single process's."""
    for r, rec in enumerate(ranks):
        if rec["tokens"] != ref["tokens"]:
            fail(f"[{tag}] rank {r}'s tokens differ from the single-process drain's")
        if rec["launches"] != ref["launches"]:
            fail(f"[{tag}] rank {r}'s launches {rec['launches']} != single-process "
                 f"{ref['launches']}")
    if logits:
        for kind in ("prefill", "decode"):
            for i, (a, b) in enumerate(zip(ranks[0][kind], ref[kind])):
                if not _bytes_equal(a, b):
                    fail(f"[{tag}] rank 0's {kind} logits {i} differ from the single-process "
                         f"drain's")


def _bytes_equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def phase_tp(torch, np, dev, ref=None):
    """(b) nemotron-4-15b bika (packed) at full width, MOE_LAYERS layers, paged
    engine, tp = 2 as two gloo ranks on the one card (NCCL takes no two
    ranks on one card): drain tokens, first prefill and decode logits (the
    gathered ones, bit for bit) and each rank's kernel 1 and 11 launches
    equal to the single-process drain's (``ref``: the moe phase's, made
    here when absent); collectives a tick, each rank's resident param and
    KV bytes and the drains' wall seconds printed. (c) The same at
    TP_QNN_LAYERS layer in qnn8 (kernel 10): tokens and logits equal. (d)
    This process as a one-rank NCCL group through the same path (the qnn8
    drain), before the gloo ranks start."""
    import gc
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.distributed.meshes import init_process, make_mesh
    from repro_torch.distributed.spawn import spawn_ranks

    out = {"cut": f"nemotron-4-15b: {MOE_LAYERS} layers in bika, {TP_QNN_LAYERS} in qnn8 "
                  f"(published 32); every width as published"}
    print(f"[tp] {smi_line()}; {out['cut']}")
    if ref is None:
        torch.cuda.reset_peak_memory_stats()
        ref = _tp_drain(torch, np, dev, "bika", MOE_LAYERS, SEED + 2)
    torch.cuda.reset_peak_memory_stats()
    qref = _tp_drain(torch, np, dev, "qnn8", TP_QNN_LAYERS, SEED + 3)
    store = tempfile.mkdtemp(prefix="tp-", dir=os.path.join(ROOT, "build"))
    try:
        # (d) this process as the one rank of an NCCL group
        t0 = time.perf_counter()
        init_process(0, 1, os.path.join(store, "nccl"), "nccl", timeout_s=TP_TIMEOUT_S)
        try:
            torch.cuda.reset_peak_memory_stats()
            nccl = _tp_drain(torch, np, dev, "qnn8", TP_QNN_LAYERS, SEED + 3,
                             mesh=make_mesh((1, 1), ("data", "model")))
        finally:
            dist.destroy_process_group()
        t_nccl = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        # (b), (c): two gloo ranks sharing the card
        t0 = time.perf_counter()
        ranks = spawn_ranks(_tp_rank, TP, store,
                            ([("bika", MOE_LAYERS, SEED + 2), ("qnn8", TP_QNN_LAYERS, SEED + 3)],),
                            backend="gloo", timeout_s=TP_TIMEOUT_S, deadline_s=TP_DEADLINE_S)
        t_gloo = time.perf_counter() - t0
    except (RuntimeError, TimeoutError) as e:
        fail(f"[tp] a rank session failed: {e}")
    finally:
        shutil.rmtree(store, ignore_errors=True)
    bika = [r[0] for r in ranks]
    qnn = [r[1] for r in ranks]
    _tp_compare("tp-bika", ref, bika)
    _tp_compare("tp-qnn8", qref, qnn)
    _tp_compare("tp-nccl", qref, [nccl])
    for tag, single, recs in (("tp-bika", ref, bika), ("tp-qnn8", qref, qnn),
                              ("tp-nccl", qref, [nccl])):
        per_tick = {k: v / recs[0]["ticks"] for k, v in recs[0]["collectives"].items()}
        print(f"[{tag}] {len(recs)} rank(s): tokens and first prefill and decode logits "
              f"equal to the single process's, bit for bit; launches a rank "
              f"{recs[0]['launches']}; {recs[0]['ticks']} ticks, "
              f"collectives a tick {per_tick}; resident params a rank "
              + ", ".join(f"{_gb(r['param_bytes']):.3f}" for r in recs)
              + f" GB (single {_gb(single['param_bytes']):.3f}), KV pool a rank "
              + ", ".join(f"{r['kv_bytes'] / 2**20:.2f}" for r in recs)
              + f" MiB (single {single['kv_bytes'] / 2**20:.2f}); drain wall "
              + ", ".join(f"{r['wall_s']:.3f}" for r in recs)
              + f" s (single {single['wall_s']:.3f}); peak a rank "
              + ", ".join(f"{r['peak_gb']:.2f}" for r in recs) + " GB")
        out[tag] = {"ranks": [{k: v for k, v in r.items() if k not in ("prefill", "decode")}
                              for r in recs],
                    "single": {k: v for k, v in single.items()
                               if k not in ("prefill", "decode", "tokens")},
                    "collectives_per_tick": per_tick}
    out["session_s"] = {"gloo_2_ranks": t_gloo, "nccl_1_rank": t_nccl}
    print(f"[tp] rank sessions: 2 gloo ranks {t_gloo:.1f} s (bika + qnn8, process start-up "
          f"included), this process as 1 NCCL rank {t_nccl:.1f} s (qnn8)")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    only = argv[1] if len(argv) == 2 and argv[0] == "--only" else None
    if argv and only not in ("paper", "moe", "recurrent", "encdec", "train-families",
                             "train-recurrent", "tooling", "tp"):
        fail(f"unknown arguments {argv}; the one option is --only "
             f"paper|moe|recurrent|encdec|train-families|train-recurrent|tooling|tp")
    only_paper = only == "paper"
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs torch and numpy: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a GPU")
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"the port's package is not beside this script ({e}); run from the repo root")

    # every phase but the tooling one launches the plan rules' own plans: the
    # autotune cache is a file of this checkout that does not exist, so no
    # entry that an earlier search left in the user's cache changes a plan
    from repro_torch.kernels import autotune

    untuned = os.path.join(ROOT, "build", f"autotune-untuned-{os.getpid()}.json")
    if os.path.exists(untuned):
        os.remove(untuned)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = untuned
    autotune.clear_cache()

    t_start = time.perf_counter()
    smi = smi_line()
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()  # repro: noqa-RPA005 -- wall seconds of the build and phases
    logs = {}
    paths = build.build_all(logs=logs)
    print(f"[build] {len(paths)} kernels built in {time.perf_counter() - t0:.2f} s: "
          f"{sorted(paths)}")
    # the -Xptxas -v lines (registers, spills) of the redesigned kernels: the
    # product template (kernels 6 at large M, 8, 9) and its sign pass, the
    # streaming template (kernel 1, kernel 6 at small M, kernel 7), kernels
    # 2-5, kernel 10's stream route and kernel 11
    redesigned = ("bnn_bwd", "bnn_sign", "stream_kernel", "cac_train_fwd_kernel",
                  "cac_train_bwd_fused_kernel", "cac_train_bwd_dx_kernel",
                  "cac_train_bwd_dw_kernel", "qnn_stream_kernel", "paged_attn_kernel")
    for source in ("cac_matmul", "bnn_matmul", "cac_train", "qnn_matmul", "paged_attn"):
        show = False
        for line in logs.get(source, "").splitlines():
            if "Compiling entry function" in line:
                show = any(nm in line for nm in redesigned)
            if show and ("Compiling entry function" in line or "Used" in line or "spill" in line):
                print(f"[build] ptxas -v {source}: {line.strip()}")
    # kernels 2-5: the instructions of their hot loop. An iteration of
    # kernel 2's is a K slice, 512 terms a thread; kernel 5's and 3's is a
    # pass, 128 terms a thread, kernel 4's 256 (8 columns) or 128 (4), and
    # their bodies also hold the code a new N tile runs (the window bounds),
    # so their counts are no per-term figure
    for kernel, ops in build.hot_loop_mix(paths["cac_train"], (
            "cac_train_fwd_kernelILb1", "cac_train_bwd_fused_kernelILb1",
            "cac_train_bwd_dx_kernelILb1", "cac_train_bwd_dw_kernelILb1")).items():
        per = (f", {sum(ops.values()) / 512:.2f} a term" if "fwd" in kernel else
               " (with the tile-start code)")
        short = kernel[kernel.rindex("cac_train_"):].split("EEEv")[0]
        print(f"[build] sass {short}: {sum(ops.values())} instructions an iteration{per}: {ops}")

    dev = torch.device("cuda")
    if only_paper:  # a partial run: no kernels line, no last line
        flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
        paper = phase_paper(torch, np, dev, flush)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_paper.json"), "w") as fh:
            json.dump({"device": smi, "paper": paper}, fh, indent=1, sort_keys=True,
                      default=str)
        print(smi)
        print("partial run (--only paper): no result line")
        return 0
    if only == "moe":  # a partial run: no kernels line, no last line
        flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
        moe_cac, moe_attn = phase_moe_kernels(torch, np, dev, flush)
        del flush
        t0 = time.perf_counter()
        moe = phase_moe(torch, np, dev)
        print(f"[moe] phase {time.perf_counter() - t0:.1f} s")
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_moe.json"), "w") as fh:
            json.dump({"device": smi, "moe": moe, "moe_cac": moe_cac, "moe_attn": moe_attn}, fh,
                      indent=1, sort_keys=True, default=str)
        print(f"[total] {time.perf_counter() - t_start:.1f} s, the build included")
        print(smi)
        print("partial run (--only moe): no result line")
        return 0
    if only == "recurrent":  # a partial run: no kernels line, no last line
        flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        rec_kernels = phase_recurrent_kernels(torch, np, dev, flush)
        del flush
        recurrent = phase_recurrent(torch, np, dev)
        print(f"[recurrent] phase {time.perf_counter() - t0:.1f} s")
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_recurrent.json"), "w") as fh:
            json.dump({"device": smi, "recurrent": recurrent, "recurrent_kernels": rec_kernels},
                      fh, indent=1, sort_keys=True, default=str)
        print(f"[total] {time.perf_counter() - t_start:.1f} s, the build included")
        print(smi)
        print("partial run (--only recurrent): no result line")
        return 0
    if only == "encdec":  # a partial run: no kernels line, no last line
        clock = PhaseClock()
        flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
        encdec_kernels = clock("encdec-kernels", phase_encdec_kernels, torch, np, dev, flush)
        del flush
        encdec = clock("encdec", phase_encdec, torch, np, dev)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_encdec.json"), "w") as fh:
            json.dump({"device": smi, "encdec": encdec, "encdec_kernels": encdec_kernels,
                       "phase_seconds": clock.seconds}, fh, indent=1, sort_keys=True,
                      default=str)
        print(f"[total] {time.perf_counter() - t_start:.1f} s, the build included")
        print(smi)
        print("partial run (--only encdec): no result line")
        return 0
    if only == "train-families":  # a partial run: no kernels line, no last line
        clock = PhaseClock()
        flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
        fam_kernels = clock("train-families-kernels", phase_train_families_kernels, torch, np,
                            dev, flush)
        del flush
        families = clock("train-families", phase_train_families, torch, np, dev)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_train_families.json"), "w") as fh:
            json.dump({"device": smi, "train_families": families,
                       "train_families_kernels": fam_kernels, "phase_seconds": clock.seconds},
                      fh, indent=1, sort_keys=True, default=str)
        print(f"[total] {time.perf_counter() - t_start:.1f} s, the build included")
        print(smi)
        print("partial run (--only train-families): no result line")
        return 0
    if only == "train-recurrent":  # a partial run: no kernels line, no last line
        clock = PhaseClock()
        flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
        rec_train_kernels = clock("train-recurrent-kernels", phase_train_recurrent_kernels,
                                  torch, np, dev, flush)
        del flush
        rec_train = clock("train-recurrent", phase_train_recurrent, torch, np, dev)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_train_recurrent.json"),
                  "w") as fh:
            json.dump({"device": smi, "train_recurrent": rec_train,
                       "train_recurrent_kernels": rec_train_kernels,
                       "phase_seconds": clock.seconds}, fh, indent=1, sort_keys=True,
                      default=str)
        print(f"[total] {time.perf_counter() - t_start:.1f} s, the build included")
        print(smi)
        print("partial run (--only train-recurrent): no result line")
        return 0
    if only == "tp":  # a partial run: no kernels line, no last line
        clock = PhaseClock()
        flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
        tp_kernels = clock("tp-kernels", phase_tp_kernels, torch, np, dev, flush)
        del flush
        tp = clock("tp", phase_tp, torch, np, dev)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_tp.json"), "w") as fh:
            json.dump({"device": smi, "tp": tp, "tp_kernels": tp_kernels,
                       "phase_seconds": clock.seconds}, fh, indent=1, sort_keys=True,
                      default=str)
        print(f"[total] {time.perf_counter() - t_start:.1f} s, the build included")
        print(smi)
        print("partial run (--only tp): no result line")
        return 0
    if only == "tooling":  # a partial run: no kernels line, no last line
        clock = PhaseClock()
        tooling = clock("tooling", phase_tooling, torch, np, dev, logs)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_tooling.json"), "w") as fh:
            json.dump({"device": smi, "tooling": tooling, "phase_seconds": clock.seconds}, fh,
                      indent=1, sort_keys=True, default=str)
        print(f"[total] {time.perf_counter() - t_start:.1f} s, the build included")
        print(smi)
        print("partial run (--only tooling): no result line")
        return 0
    clock = PhaseClock()
    device_ops = clock("device-ops", phase_device_ops, torch, np, dev)
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)  # > 50 MB L2
    cac_rows, timing_floor = clock("kernels cac", phase_cac, torch, np, dev, flush)
    attn_rows = clock("kernels paged_attn", phase_paged, torch, np, dev, flush)
    attn_sweep = clock("attn-sweep", phase_attn_sweep, torch, np, dev, flush)
    train_rows = clock("train-kernels", phase_train_kernels, torch, np, dev, flush)
    bnn_rows = clock("bnn-kernels", phase_bnn_kernels, torch, np, dev, flush)
    route_sweep = clock("bnn route sweep", phase_route_sweep, torch, np, dev, flush)
    qnn_rows = clock("qnn8-kernels", phase_qnn_kernels, torch, np, dev, flush)
    qnn_route_sweep = clock("qnn route sweep", phase_qnn_route_sweep, torch, np, dev, flush)
    del flush
    tooling = clock("tooling", phase_tooling, torch, np, dev, logs)
    from repro_torch.configs import get_config
    from repro_torch.core.convert import tree_to_serve

    arch = get_config("smollm-360m", compute_mode="bika", pack_signs=True, remat=False,
                      paged_attn_route="fused")
    train, path = clock("path", phase_path, torch, np, arch, dev, "cac_hw")
    path["profile"] = clock("profile", phase_profile, torch, np, arch, train, dev,
                            groups=KERNEL11_GROUP)
    path["obs"] = clock("obs", phase_obs, torch, np, arch, train, dev, path["tokens"])
    serve_params = tree_to_serve(train, arch.linear_spec())
    del train
    path["parity"] = clock("parity", phase_parity, torch, np, arch, serve_params, dev,
                           _code_hooks(torch))
    del serve_params
    training = clock("train", phase_train_path, torch, np, dev, "bika")
    training["parity"] = clock("train-parity", phase_train_parity, torch, np, dev, "bika",
                               _sign_hooks(torch), layers=TRAIN_PARITY_LAYERS)
    ckpt = clock("ckpt", phase_ckpt, torch, np, dev)
    bnn_path = clock("bnn-serve", phase_bnn_serve, torch, np, dev)
    bnn_training = clock("bnn-train", phase_train_path, torch, np, dev, "bnn", tag="bnn-train")
    bnn_training["parity"] = clock("bnn-train-parity", phase_train_parity, torch, np, dev, "bnn",
                                   _bnn_train_hooks(torch), tag="bnn-train-parity")
    qnn_path = clock("qnn8-serve", phase_qnn8_serve, torch, np, dev)
    spec = clock("spec", phase_spec, torch, np, dev)
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    paper = clock("paper", phase_paper, torch, np, dev, flush)
    moe_cac, moe_attn = clock("moe-kernels", phase_moe_kernels, torch, np, dev, flush)
    rec_kernels = clock("recurrent-kernels", phase_recurrent_kernels, torch, np, dev, flush)
    encdec_kernels = clock("encdec-kernels", phase_encdec_kernels, torch, np, dev, flush)
    fam_kernels = clock("train-families-kernels", phase_train_families_kernels, torch, np, dev,
                        flush)
    rec_train_kernels = clock("train-recurrent-kernels", phase_train_recurrent_kernels, torch,
                              np, dev, flush)
    tp_kernels = clock("tp-kernels", phase_tp_kernels, torch, np, dev, flush)
    del flush
    moe = clock("moe", phase_moe, torch, np, dev)
    tp = clock("tp", phase_tp, torch, np, dev, moe.pop("nemotron_ref"))
    recurrent = clock("recurrent", phase_recurrent, torch, np, dev)
    encdec = clock("encdec", phase_encdec, torch, np, dev)
    families = clock("train-families", phase_train_families, torch, np, dev)
    rec_train = clock("train-recurrent", phase_train_recurrent, torch, np, dev)

    main_cac = next(r for r in cac_rows if (r["M"], r["K"], r["N"]) == (4, 960, 2560))
    main_attn = next(r for r in attn_rows if r["case"] == "decode" and not r["int8"])
    kernels = [
        {"name": "cac_matmul", "route": "cuda", "source": "src/repro_torch/csrc/cac_matmul.cu",
         "replaces": "src/repro/kernels/cac_matmul.py:107",
         "launches": path["launches"]["cac_hw"],
         "max_abs_err": max(r["max_abs_err"] for r in cac_rows),
         "ms": main_cac["ms"], "plain_ms": main_cac["plain_ms"],
         "bound_ms": main_cac["bound_ms"], "bound_by": main_cac["bound_by"],
         "library_ms": None, "shape": "M=4 K=960 N=2560 (decode gate/up)",
         "shapes": [r for r in cac_rows if "ms" in r]},
        {"name": "paged_attn", "route": "cuda", "source": "src/repro_torch/csrc/paged_attn.cu",
         "replaces": "src/repro/kernels/paged_attn.py:164",
         "launches": path["launches"]["paged_attn"],
         "max_abs_err": max(r["max_abs_err"] for r in attn_rows),
         "ms": main_attn["ms"], "plain_ms": main_attn["plain_ms"],
         "bound_ms": main_attn["bound_ms"], "bound_by": main_attn["bound_by"],
         "library_ms": main_attn["library_ms"],
         "shape": "decode B=4 C=1 Hq=15 Hkv=5 D=64 bs=16 T=8 fp32 pool",
         "shapes": attn_rows,
         "spec_launches_per_drain": {k: spec[k]["launches"]["paged_attn"]
                                     for k in ("paged_spec", "continuous_spec")},
         "device_ops_per_call": {k: device_ops[f"paged_attn {k}"] for k in ("decode", "chunk")},
         "drain_device_ms": {name: prof.get("groups", {}).get("paged_attn")
                             for name, prof in (
                                 ("bika", path["profile"]),
                                 ("bnn", bnn_path["profile"]),
                                 ("qnn8", qnn_path["profile"]),
                                 ("paged_spec", spec["paged_spec"]["profile"]))}},
    ]
    main_train = next(r for r in train_rows if (r["M"], r["K"], r["N"]) == (512, 960, 2560))
    per_step = training["steps"][0]["launches"]
    split_step = training["steps"][-1]["launches"]
    for name, key, launches, replaces in (
            ("cac_train_fwd", "fwd", per_step["cac_train_fwd"], 160),
            ("cac_train_bwd_dx", "bwd_dx", split_step["cac_train_bwd_dx"], 222),
            ("cac_train_bwd_dw", "bwd_dw", split_step["cac_train_bwd_dw"], 284),
            ("cac_train_bwd_fused", "bwd_fused", per_step["cac_train_bwd_fused"], 383)):
        grads = {"bwd_dx": ("dx",), "bwd_dw": ("dw", "dbeta")}.get(key, ("dx", "dw", "dbeta"))
        errs = [r[f"{nm}_{which}_max_abs_err"] for r in train_rows for nm in grads
                for which in (("fused", "fused-split") if key == "bwd_fused" else ("split",))]
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/cac_train.cu",
            "replaces": f"src/repro/kernels/cac_matmul.py:{replaces}",
            "launches": launches,
            "max_abs_err": (max(r["fwd_max_abs_err"] for r in train_rows) if key == "fwd"
                            else max(errs)),
            "ms": main_train[key]["ms"], "plain_ms": main_train[key]["plain_ms"],
            "bound_ms": main_train[key]["bound_ms"], "bound_by": main_train[key]["bound_by"],
            "library_ms": None,
            "shape": "M=512 K=960 N=2560 (gate/up, batch 4 x seq 128); launches per "
                     + ("split-backward step" if key in ("bwd_dx", "bwd_dw") else "fused step"),
            "shapes": [{k: v for k, v in r.items() if k in ("M", "K", "N", key)}
                       for r in train_rows if key in r]})
    for entry, key in zip(kernels[-3:-1], ("cac_train_bwd_dx", "cac_train_bwd_dw")):
        entry["device_ops_per_call"] = device_ops[key]
        entry["split_step_device_ms"] = (training.get("split_profile") or {}).get(
            "groups", {}).get(key)
    bnn_train = next(r for r in bnn_rows if (r["M"], r["K"], r["N"]) == (512, 960, 2560))
    bnn_decode = next(r for r in bnn_rows if (r["M"], r["K"], r["N"]) == (N_SLOTS, 960, 2560))
    bnn_step = bnn_training["steps"][0]["launches"]
    for name, key, main_row, launches, replaces, shape, errs in (
            ("bnn_matmul", "fwd_f32", bnn_train, bnn_step["bnn"], 104,
             "M=512 K=960 N=2560 float32 w (train gate/up); launches per train step",
             ("fwd_max_abs_err",)),
            ("bnn_packed_matmul", "fwd_packed", bnn_decode, bnn_path["launches"]["bnn_packed"],
             172, "M=4 K=960 N=2560 packed planes (decode gate/up); launches per drain",
             ("fwd_max_abs_err",)),
            ("bnn_bwd_dx", "bwd_dx", bnn_train, bnn_step["bnn_bwd_dx"], 231,
             "M=512 K=960 N=2560 (train gate/up); launches per train step", ("dx_max_abs_err",)),
            ("bnn_bwd_dw", "bwd_dw", bnn_train, bnn_step["bnn_bwd_dw"], 286,
             "M=512 K=960 N=2560 (train gate/up); launches per train step",
             ("dw_max_abs_err",))):
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/bnn_matmul.cu",
            "replaces": f"src/repro/kernels/bnn_matmul.py:{replaces}",
            "launches": launches,
            "max_abs_err": max(r[e] for r in bnn_rows for e in errs if e in r),
            "ms": main_row[key]["ms"], "plain_ms": main_row[key]["plain_ms"],
            "bound_ms": main_row[key]["bound_ms"], "bound_by": main_row[key]["bound_by"],
            "library_ms": main_row[key]["library_ms"], "shape": shape,
            "shapes": [{k: v for k, v in r.items() if k in ("M", "K", "N", key)}
                       for r in bnn_rows if key in r]})
    kernels[-3]["device_ops_per_call"] = device_ops["bnn_packed_matmul"]
    kernels[-4]["unpacked_serve_launches_per_drain"] = bnn_path["unpacked"]["launches"]["bnn"]
    kernels[-4]["shapes"] += [{k: v for k, v in r.items() if k in ("M", "K", "N", "fwd_int8")}
                              for r in bnn_rows if "fwd_int8" in r]
    main_qnn = next(r for r in qnn_rows if (r["M"], r["K"], r["N"]) == (N_SLOTS, 960, 2560))
    kernels.append({
        "name": "qnn_matmul", "route": "cuda", "source": "src/repro_torch/csrc/qnn_matmul.cu",
        "replaces": "src/repro/kernels/qnn_matmul.py:73",
        "launches": qnn_path["launches"]["qnn8"],
        "max_abs_err": max(r["max_abs_err"] for r in qnn_rows),
        "ms": main_qnn["ms"], "plain_ms": main_qnn["plain_ms"],
        "bound_ms": main_qnn["bound_ms"], "bound_by": main_qnn["bound_by"],
        "library_ms": main_qnn["library_ms"],
        "shape": "M=4 K=960 N=2560 (decode gate/up); launches per qnn8 drain; library: "
                 "torch._int_mm " + main_qnn["library_shape"],
        "spec_launches_per_drain": {k: spec[k]["launches"]["qnn8"]
                                    for k in ("paged_spec", "continuous_spec")},
        "device_ops_per_call": device_ops["qnn_matmul stream"],
        "tile_route_device_ops_per_call": device_ops["qnn_matmul tile"],
        "shapes": [r for r in qnn_rows if "ms" in r]})
    # the paper slice: each on-path kernel's launches on the paper path and
    # its rows at the paper's shapes (kernel 6 on float32 and on int8 weights)
    paper_keys = {"cac_matmul": ("cac_hw", ("cac_matmul",)),
                  "cac_train_fwd": ("cac_train_fwd", ("cac_train_fwd",)),
                  "cac_train_bwd_dx": ("cac_train_bwd_dx", ("cac_train_bwd_dx",)),
                  "cac_train_bwd_dw": ("cac_train_bwd_dw", ("cac_train_bwd_dw",)),
                  "cac_train_bwd_fused": ("cac_train_bwd_fused", ("cac_train_bwd_fused",)),
                  "bnn_matmul": ("bnn", ("bnn_matmul", "bnn_matmul_int8")),
                  "bnn_bwd_dx": ("bnn_bwd_dx", ("bnn_bwd_dx",)),
                  "bnn_bwd_dw": ("bnn_bwd_dw", ("bnn_bwd_dw",)),
                  "qnn_matmul": ("qnn8", ("qnn_matmul",))}
    for entry in kernels:
        if entry["name"] not in paper_keys:
            continue
        count, row_keys = paper_keys[entry["name"]]
        entry["paper_launches"] = paper["launches"][count]
        entry["shapes"] = entry["shapes"] + [
            dict({"paper": r["where"], "M": r["M"], "K": r["K"], "N": r["N"]},
                 **{key: r[key] for key in row_keys}) for r in paper["kernels"]]
    # the seventh slice: kernel 1's launches on mixtral's static path and
    # kernels 1 and 11 on nemotron's paged path, and their rows at the lm
    # family's new shapes
    kernels[0]["moe_launches"] = {"mixtral_short_drain": moe["launches"]["cac_hw"],
                                  "nemotron_drain": moe["nemotron"][0]["launches"]["cac_hw"]}
    kernels[0]["shapes"] = kernels[0]["shapes"] + moe_cac
    kernels[1]["moe_launches"] = {"mixtral_short_drain": moe["launches"]["paged_attn"],
                                  "nemotron_drain": moe["nemotron"][0]["launches"]["paged_attn"]}
    kernels[1]["shapes"] = kernels[1]["shapes"] + moe_attn
    for entry in kernels:
        if entry["name"] == "qnn_matmul":
            entry["moe_launches"] = {"mixtral_1_layer_drain": moe["qnn8"]["launches"]["qnn8"]}
        if entry["name"] == "bnn_packed_matmul":
            entry["moe_launches"] = {"mixtral_1_layer_drain":
                                     moe["bnn"]["launches"]["bnn_packed"]}
    # the eighth slice: kernels 1, 7 and 10 on the recurrent paths (zamba2 and
    # xlstm in bika; in qnn8 and bnn packed) and their rows at the new shapes
    rec_keys = {"cac_matmul": ("cac_hw", ("zamba2-2.7b", "xlstm-125m")),
                "bnn_packed_matmul": ("bnn_packed", ("zamba2-2.7b bnn", "xlstm-125m bnn")),
                "qnn_matmul": ("qnn8", ("zamba2-2.7b qnn8", "xlstm-125m qnn8"))}
    for entry in kernels:
        if entry["name"] in rec_keys:
            count, names = rec_keys[entry["name"]]
            entry["recurrent_launches"] = {
                f"{nm} drain ({recurrent[nm]['layers']} layers, "
                f"{recurrent[nm]['per_forward']} a forward)": recurrent[nm]["launches"][count]
                for nm in names}
            entry["shapes"] = entry["shapes"] + [r for r in rec_kernels
                                                 if r["kernel"] == entry["name"]]
    # the ninth slice: kernels 1, 7 and 10 on seamless-m4t-large-v2's static
    # path (bika at 24 + 24 layers; qnn8 and bnn packed at 6 + 6) and their
    # rows at the family's (K, N)
    for entry in kernels:
        if entry["name"] in rec_keys:
            count = rec_keys[entry["name"]][0]
            res = {"cac_matmul": encdec["bika"], "bnn_packed_matmul": encdec["bnn"],
                   "qnn_matmul": encdec["qnn8"]}[entry["name"]]
            entry["encdec_launches"] = {
                f"{ENCDEC} drain ({res['layers']} + {res['layers']} layers, "
                f"{res['per_prefill']} a prefill, {res['per_forward']} a decode step)":
                    res["launches"][count]}
            entry["shapes"] = entry["shapes"] + [r for r in encdec_kernels
                                                 if r["kernel"] == entry["name"]]
    # the tenth slice: kernels 2-6, 8 and 9 on the training paths of
    # mixtral-8x22b (1 layer at full width) and seamless-m4t-large-v2 (bika at
    # 12 + 12 layers, bnn at 6 + 6): launches a step and rows at their shapes
    fam_keys = {"cac_train_fwd": ("fwd", "cac_train_fwd"),
                "cac_train_bwd_dx": ("bwd_dx", "cac_train_bwd_dx"),
                "cac_train_bwd_dw": ("bwd_dw", "cac_train_bwd_dw"),
                "cac_train_bwd_fused": ("bwd_fused", "cac_train_bwd_fused"),
                "bnn_matmul": ("bnn_fwd_f32", "bnn"), "bnn_bwd_dx": ("bnn_bwd_dx", "bnn_bwd_dx"),
                "bnn_bwd_dw": ("bnn_bwd_dw", "bnn_bwd_dw")}
    seamless_split = families["seamless_bika"]["steps"][-1]["launches"]
    for entry in kernels:
        if entry["name"] not in fam_keys:
            continue
        key, count = fam_keys[entry["name"]]
        if count.startswith("cac"):
            seamless = seamless_split if count in ("cac_train_bwd_dx", "cac_train_bwd_dw") \
                else families["seamless_bika"]["steps"][0]["launches"]
            entry["families_launches"] = {
                f"{ENCDEC} bika step ({SEAMLESS_TRAIN_LAYERS} + {SEAMLESS_TRAIN_LAYERS} layers)":
                    seamless[count],
                f"{MIXTRAL} bika gradient (1 layer)":
                    families["mixtral_bika_grad"]["runs"][0]["launches"][count]}
        else:
            entry["families_launches"] = {
                f"{ENCDEC} bnn step (6 + 6 layers)":
                    families["seamless_bnn"]["steps"][0]["launches"][count],
                f"{MIXTRAL} bnn step (1 layer)":
                    families["mixtral_bnn"]["steps"][0]["launches"][count]}
        entry["shapes"] = entry["shapes"] + [
            {"train_families": r["where"], "M": r["M"], "K": r["K"], "N": r["N"], key: r[key]}
            for r in fam_kernels]
    # the eleventh slice: kernels 2-6, 8 and 9 on the recurrent families'
    # training paths (zamba2 in bika: the 54-layer gradient and the 18-layer
    # steps; in bnn at 6 layers; xlstm-125m whole) and their rows at the
    # families' nine training shapes
    zamba_steps = rec_train["zamba2_bika"]["steps"]
    for entry in kernels:
        if entry["name"] not in fam_keys:
            continue
        key, count = fam_keys[entry["name"]]
        if count.startswith("cac"):
            zamba = zamba_steps[-1 if count in ("cac_train_bwd_dx", "cac_train_bwd_dw") else 0]
            entry["recurrent_train_launches"] = {
                f"{ZAMBA} bika step ({ZAMBA_STEP_LAYERS} layers)": zamba["launches"][count],
                f"{ZAMBA} bika gradient (54 layers)":
                    rec_train["zamba2_bika_grad"]["runs"][0]["launches"][count],
                f"{XLSTM} bika step (12 layers)":
                    rec_train["xlstm_bika"]["steps"][0]["launches"][count]}
        else:
            entry["recurrent_train_launches"] = {
                f"{ZAMBA} bnn step ({ZAMBA_TRAIN_LOWBIT_LAYERS} layers)":
                    rec_train["zamba2_bnn"]["steps"][0]["launches"][count],
                f"{XLSTM} bnn step (12 layers)":
                    rec_train["xlstm_bnn"]["steps"][0]["launches"][count]}
        entry["shapes"] = entry["shapes"] + [
            {"train_recurrent": r["where"], "M": r["M"], "K": r["K"], "N": r["N"], key: r[key]}
            for r in rec_train_kernels]
    # the thirteenth slice: kernels 1, 11 (bika) and 10 (qnn8) on the tensor-
    # parallel path a rank, and their rows at a rank's shapes
    tp_route = {"cac_matmul": ("tp-bika", "cac_hw"), "paged_attn": ("tp-bika", "paged_attn"),
                "qnn_matmul": ("tp-qnn8", "qnn8")}
    for entry in kernels:
        if entry["name"] in tp_route:
            tag, count = tp_route[entry["name"]]
            entry["tp_launches"] = {
                f"nemotron-4-15b {tag[3:]} drain, tp={TP}, rank {r}": rec["launches"][count]
                for r, rec in enumerate(tp[tag]["ranks"])}
        if entry["name"] in ("cac_matmul", "bnn_packed_matmul", "qnn_matmul", "paged_attn"):
            entry["shapes"] = entry["shapes"] + [r for r in tp_kernels
                                                 if r["kernel"] == entry["name"]]
    # the twelfth slice: each kernel's entry functions under the contracts
    # (registers, spill stores, findings) and the autotune row of its path
    for entry in kernels:
        number = KERNEL_NUMBERS[entry["name"]]
        fns = [r for r in tooling["contracts"]["ptxas"] if number in r["kernels"]]
        if not fns:
            fail(f"kernel {number} ({entry['name']}) has no entry function in the ptxas log")
        entry["contracts"] = {"entry_functions": len(fns),
                              "registers": max(r["registers"] for r in fns),
                              "spill_stores": max(r["spill_stores"] for r in fns),
                              "findings": tooling["contracts"]["findings"]}
        entry["autotune"] = next(
            {k: r[k] for k in ("path", "shape", "default", "default_ms", "winner", "winner_ms",
                               "winner_over_default", "max_abs_err", "tolerance")}
            for r in tooling["autotune"] if number in r["kernels"])
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump({"device": smi, "kernels": kernels, "timing_floor_ms": timing_floor,
                   "path": path, "training": training,
                   "train_kernels": train_rows, "bnn_kernels": bnn_rows,
                   "bnn_route_sweep": route_sweep, "bnn_path": bnn_path,
                   "bnn_training": bnn_training, "qnn_kernels": qnn_rows,
                   "qnn_route_sweep": qnn_route_sweep, "qnn_path": qnn_path,
                   "attn_sweep": attn_sweep,
                   "spec": spec, "paper": paper, "ckpt": ckpt, "moe": moe,
                   "recurrent": recurrent, "recurrent_kernels": rec_kernels,
                   "encdec": encdec, "encdec_kernels": encdec_kernels,
                   "train_families": families, "train_families_kernels": fam_kernels,
                   "train_recurrent": rec_train, "train_recurrent_kernels": rec_train_kernels,
                   "tp": tp, "tp_kernels": tp_kernels,
                   "tooling": tooling, "phase_seconds": clock.seconds},
                  fh, indent=1, sort_keys=True,
                  default=str)
    print(f"[total] {time.perf_counter() - t_start:.1f} s, the build included")
    print(smi)
    print(json.dumps({"kernels": kernels}, sort_keys=True))
    # repro: noqa-RPA004 -- the result line, "ok" first as its contract shows it
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
