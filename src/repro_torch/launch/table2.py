"""Table II (the port's counterpart of ``benchmarks/table2_accuracy.py``):
validation accuracy of dense (ANN), qnn8, bnn, bika and a B-spline KAN on
the paper's structures, trained on the procedural tasks of
``data/vision.py``. Absolute accuracies are not MNIST's; the claims are
relative:

  (1) QNN >= BNN >= BiKA - 0.02 at TFC;
  (2) the BNN-BiKA gap shrinks from TFC to SFC (within 0.02);
  (3) BiKA >= KAN - 0.02 at SFC (KAN is trained at TFC and SFC only, as
      the paper's memory-bound KAN training is).

    PYTHONPATH=src python -m repro_torch.launch.table2 [--full] [--out FILE] [--device cpu]

Quick: TFC and SFC at 300 steps. ``--full`` adds LFC and CNV and trains
2400 steps. ``--out`` writes the JSON there. Runs on CUDA unless
``--device cpu``; raises without a GPU.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

import torch

from repro_torch.core import kan
from repro_torch.device import resolve_device
from repro_torch.models.paper import CNV, LFC, SFC, TFC, PaperConfig
from repro_torch.train.paper import fit, train_paper_model, val_accuracy

MODES = ("dense", "qnn8", "bnn", "bika")


def _train_kan(structure: PaperConfig, dataset: str, steps: int, batch: int, device) -> float:
    """A B-spline KAN of the structure's widths on the same task (the pykan
    functional form, tanh between layers to stay inside the grid)."""
    dims = (structure.in_dim,) + structure.features
    gen = torch.Generator(device=device).manual_seed(0)
    params = [kan.kan_linear_init(gen, dims[i], dims[i + 1], grid=5, order=3, device=device)
              for i in range(len(dims) - 1)]

    def apply(p, x):
        x = torch.tanh(x.reshape(x.shape[0], -1))
        for i, lp in enumerate(p):
            x = kan.kan_linear_apply(lp, x)
            if i < len(p) - 1:
                x = torch.tanh(x)
        return x.to(torch.float32)

    params, _ = fit(apply, params, dataset, steps=steps, batch=batch, lr=3e-3, warmup=20,
                    device=device)
    return val_accuracy(apply, params, dataset, seed=0, batch=batch, device=device)


def run(quick: bool = True, steps: Optional[int] = None, batch: int = 128, device=None,
        log=print) -> Dict:
    """Train every structure in every mode (and KAN at TFC and SFC); returns
    {"accuracy": {net: {mode: val_acc}}, "claims", "steps", "seconds"}."""
    device = resolve_device(device)
    steps = steps or (300 if quick else 2400)
    nets = {"tfc": TFC, "sfc": SFC}
    if not quick:
        nets.update(lfc=LFC, cnv=CNV)
    results: Dict[str, Dict[str, float]] = {}
    seconds: Dict[str, Dict[str, float]] = {}
    for net_name, base in nets.items():
        dataset = "textures" if base.kind == "cnv" else "digits"
        results[net_name], seconds[net_name] = {}, {}
        for mode in MODES + (("kan",) if net_name in ("tfc", "sfc") else ()):
            t0 = time.perf_counter()
            if mode == "kan":
                acc = _train_kan(base, dataset, steps, batch, device)
            else:
                acc = train_paper_model(base.replace(mode=mode), dataset, steps=steps,
                                        batch=batch, lr=3e-3, device=device)["val_acc"]
            results[net_name][mode] = acc
            seconds[net_name][mode] = time.perf_counter() - t0
            log(f"table2/{net_name}/{mode}: val acc {acc:.4f} "
                f"({seconds[net_name][mode]:.1f} s, {steps} steps)")
    claims = {}
    t = results["tfc"]
    claims["tfc_order_qnn>bnn>bika"] = t["qnn8"] >= t["bnn"] >= t["bika"] - 0.02
    gap_tfc = results["tfc"]["bnn"] - results["tfc"]["bika"]
    gap_sfc = results["sfc"]["bnn"] - results["sfc"]["bika"]
    claims["bnn_bika_gap_shrinks"] = gap_sfc <= gap_tfc + 0.02
    claims["gap_tfc"], claims["gap_sfc"] = gap_tfc, gap_sfc
    claims["bika_overtakes_kan_at_sfc"] = results["sfc"]["bika"] >= results["sfc"]["kan"] - 0.02
    return {"accuracy": results, "claims": claims, "steps": steps, "batch": batch,
            "seconds": seconds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="add LFC and CNV, 2400 steps")
    ap.add_argument("--steps", type=int, default=None, help="override the step count")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--out", default=None, help="write the JSON result to this path")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a GPU) or cpu (plain versions)")
    args = ap.parse_args(argv)
    out = run(not args.full, args.steps, args.batch, args.device)
    for net_name, accs in out["accuracy"].items():
        print(f"table2/{net_name}: " + " ".join(f"{m}={v:.3f}" for m, v in accs.items()))
    print("table2/claims: " + " ".join(f"{k}={v}" for k, v in out["claims"].items()))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
