"""Hold the training CAC's STE backward sums over M against float64 sums on
one GPU: kernel 5 (fused) and kernel 4 (dw, dbeta of the split pair), and
the plain version, at the LM's training shape and at the paper models'
im2col shapes.

    python3 ste_accuracy.py [SRC]

SRC is the ``src`` directory of the tree whose kernels and plain version to
hold (default: this tree's; a parent unpacked with ``git archive`` builds its
own kernels under its own ``build/``). Operands are drawn as
``chip_smoke.py``'s paper phase draws them (x, g ~ N(0, 1); w, beta ~ N(0,
0.25)); the float64 sums take the plain version's window, decided on
float32 ``|fl(fl(x w) + beta)| <= 1``. For each shape and each of dw and
dbeta the script prints the largest |difference| from the float64 sum, the
number of elements beyond 1e-4 + 1e-4 |float64 sum| (the reference's
bound for a short sum), and the largest difference over the bound
``chip_smoke.py`` holds a sum over M rows to (``_m_tol``: above 512 rows an
absolute 1e-4 x sqrt(M / 512), no relative term); and, last, one JSON
line of all of it. The shapes are the LM's gate/up projection and the six
convs of CNV at batch 128.
"""
from __future__ import annotations

import json
import math
import os
import sys

SHAPES = [(512, 960, 2560), (131072, 27, 64), (131072, 576, 64), (32768, 576, 128),
          (32768, 1152, 128), (8192, 1152, 256), (8192, 2304, 256)]


def main(argv) -> int:
    src = os.path.abspath(argv[0]) if argv else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src")
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import cac_matmul as cac

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    rows = []
    for m, k, n in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(21)
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((k, n), generator=gen, device=dev) * 0.5
        beta = torch.randn((k, n), generator=gen, device=dev) * 0.5
        g = torch.randn((m, n), generator=gen, device=dev)
        got = {"kernel 5": cac.cac_train_bwd_fused_call(x, w, beta, g)[1:],
               "kernel 4": cac.cac_train_bwd_dw_call(x, w, beta, g),
               "plain": cac.cac_train_bwd_fused_plain(x, w, beta, g)[1:]}
        want = [torch.zeros((k, n), dtype=torch.float64, device=dev) for _ in range(2)]
        step = max(1, (1 << 24) // (k * n))
        for a in range(0, m, step):
            inside = (x[a:a + step, :, None] * w[None] + beta[None]).abs() <= 1.0
            gm = torch.where(inside, g[a:a + step, None, :].double(), 0.0)
            want[0] += (gm * x[a:a + step, :, None].double()).sum(0)
            want[1] += gm.sum(0)
        atol, rtol = (1e-4, 1e-4) if m <= 512 else (1e-4 * math.sqrt(-(-m // 512)), 0.0)
        row = {"M": m, "K": k, "N": n, "m_tol": [atol, rtol]}
        for who, pair in got.items():
            for name, a, b in zip(("dw", "dbeta"), pair, want):
                d = (a.double() - b).abs()
                row[f"{who} {name}"] = {
                    "max_abs_err": float(d.max()),
                    "beyond_1e-4": int((d > 1e-4 + 1e-4 * b.abs()).sum()),
                    "max_over_m_tol": float((d / (atol + rtol * b.abs())).max())}
        rows.append(row)
        print(f"M={m} K={k} N={n} (atol {atol:.2e}, rtol {rtol:.0e}): " + "; ".join(
            f"{key} max {v['max_abs_err']:.3e}, {v['beyond_1e-4']} beyond 1e-4, "
            f"{v['max_over_m_tol']:.3f} of m_tol" for key, v in row.items()
            if isinstance(v, dict)))
        del x, w, beta, g, got, want
    print(json.dumps({"device": torch.cuda.get_device_name(0), "src": src, "rows": rows},
                     sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
