"""Quickstart (the port's counterpart of ``examples/quickstart.py``): train
the paper's TFC classifier in BiKA mode, export its first layer to the
hardware form (int8 thresholds + 1-bit signs), and check that the
deployed comparator datapath reproduces the trained layer.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--steps 200] [--device cpu]

The reference checks the trained layer against its CAC kernel on float
thresholds in one step. The port's CAC kernel (kernel 1) takes int8 codes
only, so the check is split in two:

(a) the trained layer's training form (kernel 2 on CUDA, its plain version
    on the CPU) against the float (tau, s) datapath ``bika_matmul_hw``: at
    least 99 % of the units agree (the export moves a unit only where an
    input lies on a threshold);
(b) the int8 export (``quantize_thresholds``, then packed sign planes)
    through kernel 1 equals ``bika_matmul_hw`` on the same codes, bit for
    bit.

It also prints the served model's validation accuracy (every layer in the
hardware form, through kernel 1) beside the trained model's. Runs on CUDA
unless ``--device cpu``; raises without a GPU.
"""
from __future__ import annotations

import argparse
from typing import Dict

import torch

from repro_torch.core.backend import pack_signs, quantize_activations
from repro_torch.core.bika import bika_matmul_hw, quantize_thresholds, to_hardware
from repro_torch.data.vision import digits_batch
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.paper import TFC, build_paper_model, paper_model_to_serve
from repro_torch.nn.module import param_bytes
from repro_torch.train.paper import train_paper_model, val_accuracy

X_SCALE = 1.0 / 127.0  # the export's input grid: [-1, 1] images onto int8 codes
MATCH_MIN = 0.99


def run(steps: int = 200, batch: int = 128, device=None, log=print) -> Dict:
    """Train, export and check; returns the numbers of every step."""
    device = resolve_device(device)
    log("== 1. train TFC (784-64-32-10) in BiKA mode on procedural digits ==")
    cfg = TFC.replace(mode="bika")
    r = train_paper_model(cfg, "digits", steps=steps, batch=batch, device=device)
    log(f"train acc {r['train_acc']:.3f}  val acc {r['val_acc']:.3f}")
    params = r["params"]

    log("== 2. export layer 0 to the CAC hardware form ==")
    w, beta = params[0]["w"][0], params[0]["beta"][0]
    tau, s = to_hardware(w, beta)
    tau_int, _ = quantize_thresholds(tau, X_SCALE)
    fp_bytes = param_bytes({"w": w, "beta": beta})
    hw_bytes = tau_int.numel() + s.numel() // 8  # int8 tau + 1-bit sign
    log(f"weights: {fp_bytes} B float -> {hw_bytes} B hardware form "
        f"({fp_bytes / hw_bytes:.1f}x smaller)")

    log("== 3. deployed CAC == trained layer ==")
    x, _ = digits_batch(0, 999, 32, device=device)
    xf = x.reshape(32, -1)
    with torch.no_grad():
        y_train = ops.cac_train_matmul(xf, w, beta)  # kernel 2 on CUDA
    y_float = bika_matmul_hw(xf, tau, s, clamp=False, acc_dtype=torch.float32)
    match = float(torch.isclose(y_train, y_float, atol=1e-4).to(torch.float32).mean())
    log(f"(a) layer-0 training form and float (tau, s) datapath agree on "
        f"{100 * match:.2f}% of units")
    x_int = quantize_activations(xf, X_SCALE)
    y_k1 = ops.cac_matmul(x_int, tau_int, pack_signs(s.to(torch.int8)))  # kernel 1 on CUDA
    y_int = bika_matmul_hw(x_int, tau_int, s, clamp=False)
    exact = bool(torch.equal(y_k1, y_int.to(torch.float32)))
    log(f"(b) int8 export through the CAC kernel {'equals' if exact else 'DIFFERS FROM'} "
        f"bika_matmul_hw on the same codes ({y_k1.numel()} sums)")

    served = paper_model_to_serve(params, cfg)
    _, serve_apply = build_paper_model(cfg, phase="serve", device=device)
    val_served = val_accuracy(serve_apply, served, "digits", device=device)
    log(f"val acc: trained {r['val_acc']:.3f}, served (hardware form, every layer) "
        f"{val_served:.3f}")
    return {"train_acc": r["train_acc"], "val_acc": r["val_acc"], "val_acc_served": val_served,
            "fp_bytes": fp_bytes, "hw_bytes": hw_bytes, "match": match, "exact": exact,
            "ok": match >= MATCH_MIN and exact}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a GPU) or cpu (plain versions)")
    args = ap.parse_args(argv)
    out = run(args.steps, args.batch, args.device)
    if not out["ok"]:
        print(f"quickstart FAILED: (a) {out['match']:.4f} < {MATCH_MIN} or (b) not bit-equal")
        return 1
    print("quickstart OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
