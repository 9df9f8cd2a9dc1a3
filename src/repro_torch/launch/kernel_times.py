"""Time the serve path's kernels on the card: kernel 7 (the packed sign
product) and kernel 10 (the int8 matmul) at smollm-360m's four projections
for M = 4 (decode), 16 (the draft's bucketed prefill) and 32 (prefill
chunks), and kernel 11 (paged attention, smollm-360m's 15 / 5 heads of 64,
blocks of 16) at decode, a drain-like decode (rows of 3-35 positions), the
speculative verify (C = 4) and a prefill chunk (C = 32) at T = 8 table
entries a row, and a long decode at T = 64, each with fp32 and int8 pools;
and the training kernels 2-5 (the training CAC forward, the STE backward's
dx and dw halves, and the fused backward) at the four projections for a
batch of 4 x 128 tokens (M = 512). Device ms per launch with a spin kernel
ahead of the first event, as
``chip_smoke.py`` times kernels: ``ms`` with L2 flushed before every call
(weights and K/V read from device memory, as a drain finds a model larger
than L2), ``warm_ms`` without (left in L2 by the previous call, as a drain
finds a model that fits: 32 layers of packed bnn planes are 39 MB of the
H100's 50 MB). Each result is first held against the plain version: kernels
2, 7 and 10 bit-exact, kernel 11 within 2e-5, kernels 3, 4 and 5 within
atol = rtol = 1e-4 off the |x w + beta| = 1 window edge.

    PYTHONPATH=src python -m repro_torch.launch.kernel_times [--out FILE]

It calls only the kernels' public wrappers and plain versions, so it also
times another checkout's kernels: run this file by its path with that
checkout's ``src/`` on PYTHONPATH, e.g. to time a parent commit beside this
one in the same call. Prints the card's name and power limit, then one JSON
line a kernel and shape; ``--out`` also writes them all as one JSON file.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from repro_torch.core.backend import pack_signs
from repro_torch.kernels import cac_matmul as cac
from repro_torch.kernels.bnn_matmul import (bnn_packed_matmul_kernel_call,
                                             bnn_packed_matmul_plain)
from repro_torch.kernels.paged_attn import paged_attn_kernel_call
from repro_torch.kernels.qnn_matmul import qnn_matmul_kernel_call, qnn_matmul_plain
from repro_torch.kernels.ref import paged_attention_ref

PATH_KN = [(960, 960), (960, 320), (960, 2560), (2560, 960)]
ROWS = (4, 16, 32)
SPIN_CYCLES = 4_000_000  # ~2 ms at the H100's clock: longer than any call's enqueue
X_SCALE = 0.05
ATTN_TOL = 2e-5
# kernel 11: (case, B, C, T, last positions drawn from [lo, hi)); heads,
# head dim and block as smollm-360m serves them
ATTN_CASES = [("decode", 4, 1, 8, (1, 128)), ("drain", 4, 1, 8, (3, 36)),
              ("verify", 4, 4, 8, (4, 128)), ("chunk", 1, 32, 8, (32, 128)),
              ("long", 4, 1, 64, (1000, 1023))]
HQ, HKV, HEAD_DIM, BLOCK = 15, 5, 64, 16
TRAIN_M, TRAIN_TOL, WINDOW_EPS = 512, 1e-4, 1e-4


def time_ms(fn, flush=None, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` from CUDA events around each call; with
    ``flush`` (a buffer larger than L2) L2 is overwritten before each."""
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


def attn_operands(rng, dev, b, c, t, last_range, quantized):
    """A shuffled pool of b * t + 3 blocks, each row's table naming t of
    them, the row's C queries ending at a position drawn from
    ``last_range``; int8 pools with per-(block, position, head) scales."""
    n_phys = b * t + 3
    q = rng.normal(size=(b, c, HQ, HEAD_DIM)).astype(np.float32)
    tables = rng.permutation(n_phys)[: b * t].reshape(b, t).astype(np.int32)
    last = rng.integers(*last_range, size=(b,))
    q_pos = (last[:, None] - (c - 1) + np.arange(c)[None]).astype(np.int32)
    shape = (n_phys, BLOCK, HKV, HEAD_DIM)
    if quantized:
        k = rng.integers(-127, 128, size=shape).astype(np.int8)
        v = rng.integers(-127, 128, size=shape).astype(np.int8)
        ks = rng.uniform(1e-3, 2e-2, size=shape[:3] + (1,)).astype(np.float32)
        vs = rng.uniform(1e-3, 2e-2, size=shape[:3] + (1,)).astype(np.float32)
    else:
        k = rng.normal(size=shape).astype(np.float32)
        v = rng.normal(size=shape).astype(np.float32)
        ks = vs = None
    return [None if a is None else torch.from_numpy(a).to(dev)
            for a in (q, k, v, tables, q_pos, ks, vs)]


def attn_rows(rng, dev, flush):
    """Kernel 11's rows, or None when a case is out of tolerance."""
    rows = []
    for case, b, c, t, last_range in ATTN_CASES:
        for quantized in (False, True):
            q, k, v, tables, q_pos, ks, vs = attn_operands(rng, dev, b, c, t, last_range,
                                                           quantized)

            def kern():
                return paged_attn_kernel_call(q, k, v, tables, q_pos, k_scale=ks, v_scale=vs)

            err = float((kern() - paged_attention_ref(q, k, v, tables, q_pos, ks, vs)).abs().max())
            if not err <= ATTN_TOL:
                print(f"kernel_times: paged_attn {case} int8={quantized}: max |kernel - "
                      f"plain| = {err}", file=sys.stderr)
                return None
            rows.append({"kernel": "paged_attn", "case": case, "B": b, "C": c, "T": t,
                         "int8": quantized, "max_abs_err": err, "ms": time_ms(kern, flush),
                         "warm_ms": time_ms(kern)})
    return rows


def _window_clear(x, w, beta, rows=8):
    """(dx_keep, dw_keep): gradient elements whose reduction touches no
    pre-activation within WINDOW_EPS of |x w + beta| = 1."""
    dx_keep = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    dw_keep = torch.ones(w.shape, dtype=torch.bool, device=x.device)
    for a in range(0, x.shape[0], rows):
        near = ((x[a:a + rows, :, None] * w[None] + beta[None]).abs() - 1.0).abs() <= WINDOW_EPS
        dx_keep[a:a + rows] = ~near.any(dim=2)
        dw_keep &= ~near.any(dim=0)
    return dx_keep, dw_keep


def train_rows(rng, dev, flush):
    """Kernels 2-5's rows at M = 512 and the four projections (x, g ~ N(0,
    1), w, beta ~ N(0, 0.25)), or None when one is out of tolerance."""
    rows = []
    for k, n in PATH_KN:
        x = torch.from_numpy(rng.normal(size=(TRAIN_M, k)).astype(np.float32)).to(dev)
        w, beta = (torch.from_numpy((rng.normal(size=(k, n)) * 0.5).astype(np.float32)).to(dev)
                   for _ in range(2))
        g = torch.from_numpy(rng.normal(size=(TRAIN_M, n)).astype(np.float32)).to(dev)
        if not torch.equal(cac.cac_train_fwd_call(x, w, beta), cac.cac_train_fwd_plain(x, w, beta)):
            print(f"kernel_times: cac_train_fwd K={k} N={n} is not bit-exact", file=sys.stderr)
            return None
        dx_keep, dw_keep = _window_clear(x, w, beta)
        plain = cac.cac_train_bwd_fused_plain(x, w, beta, g)
        cases = (("cac_train_bwd_dx", lambda: (cac.cac_train_bwd_dx_call(x, w, beta, g),),
                  (0,)),
                 ("cac_train_bwd_dw", lambda: cac.cac_train_bwd_dw_call(x, w, beta, g), (1, 2)),
                 ("cac_train_bwd_fused", lambda: cac.cac_train_bwd_fused_call(x, w, beta, g),
                  (0, 1, 2)))
        errs = {}
        for name, kern, which in cases:
            for got, i in zip(kern(), which):
                keep = dx_keep if i == 0 else dw_keep
                d = torch.where(keep, (got - plain[i]).abs(), 0)
                if not bool((d <= TRAIN_TOL + TRAIN_TOL * plain[i].abs()).all()):
                    print(f"kernel_times: {name} K={k} N={n} beyond atol = rtol = {TRAIN_TOL} off "
                          f"the window edge", file=sys.stderr)
                    return None
                errs[name] = max(errs.get(name, 0.0), float(d.max()))
        for name, kern in (("cac_train_fwd", lambda: cac.cac_train_fwd_call(x, w, beta)),) + tuple(
                (name, kern) for name, kern, _ in cases):
            rows.append({"kernel": name, "M": TRAIN_M, "K": k, "N": n,
                         "max_abs_err": errs.get(name, 0.0), "ms": time_ms(kern, flush),
                         "warm_ms": time_ms(kern)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the rows here as JSON")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device; the kernels run only on the card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)  # > 50 MB L2
    rng = np.random.default_rng(args.seed)
    tiny = torch.empty(1, device=dev)
    rows = [{"kernel": "floor", "ms": time_ms(lambda: tiny.zero_(), flush),
             "warm_ms": time_ms(lambda: tiny.zero_())}]
    attn = attn_rows(np.random.default_rng(args.seed + 11), dev, flush)
    if attn is None:
        return 1
    rows += attn
    train = train_rows(np.random.default_rng(args.seed + 23), dev, flush)
    if train is None:
        return 1
    rows += train
    for m in ROWS:
        for k, n in PATH_KN:
            x = torch.from_numpy(rng.integers(-128, 128, size=(m, k)).astype(np.int8)).to(dev)
            w = torch.from_numpy(rng.integers(-127, 128, size=(k, n)).astype(np.int8)).to(dev)
            ws = torch.from_numpy(rng.uniform(1e-3, 1e-2, size=(n,)).astype(np.float32)).to(dev)
            xf = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
            wp = pack_signs(torch.where(torch.from_numpy(rng.random((k, n))) < 0.5, 1,
                                        -1).to(torch.int8)).to(dev)
            cases = (("qnn_matmul", lambda: qnn_matmul_kernel_call(x, w, ws, X_SCALE),
                      lambda: qnn_matmul_plain(x, w, ws, X_SCALE)),
                     ("bnn_packed_matmul", lambda: bnn_packed_matmul_kernel_call(xf, wp),
                      lambda: bnn_packed_matmul_plain(xf, wp)))
            for name, kern, plain in cases:
                if not torch.equal(kern(), plain()):
                    print(f"kernel_times: {name} M={m} K={k} N={n} is not bit-exact",
                          file=sys.stderr)
                    return 1
                rows.append({"kernel": name, "M": m, "K": k, "N": n, "ms": time_ms(kern, flush),
                             "warm_ms": time_ms(kern)})
    for row in rows:
        print(json.dumps(row, sort_keys=True))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"device": smi, "rows": rows}, fh, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
