"""The paper's core conversion end to end (Eq. 1-7, Fig. 3-6; the port's
counterpart of ``examples/kan_to_bika.py``):

  1. fit a 1 -> 1 KAN edge (B-spline) to y = 0.8 sin(3x);
  2. sample the learned edge to a piecewise-constant function;
  3. convert it exactly to weighted thresholds (the Eq. 7 closed form);
  4. quantize the weights to an integer budget m and expand them into unit
     thresholds (m = 1 is BiKA);
  5. print the approximation error against m (the Fig. 5-6 trade-off).

    PYTHONPATH=src python -m repro_torch.launch.kan_to_bika [--device cpu]

Plain PyTorch. The fit runs on CUDA unless ``--device cpu`` (raising
without a GPU); the conversion runs on the CPU, as the reference's numpy
steps do.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import kan
from repro_torch.core import thresholds as thr
from repro_torch.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a GPU) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    # 1. fit y = 0.8 sin(3x) with a 1 -> 1 KAN edge, plain gradient descent
    gen = torch.Generator(device=device).manual_seed(0)
    params = kan.kan_linear_init(gen, 1, 1, grid=5, order=3, device=device)
    xs = torch.linspace(-0.95, 0.95, 256, device=device)[:, None]
    ys = 0.8 * torch.sin(3.0 * xs)
    leaves = [p.requires_grad_(True) for p in params.values()]
    for _ in range(400):
        loss = ((kan.kan_linear_apply(params, xs) - ys) ** 2).mean()
        with torch.no_grad():
            for p, g in zip(leaves, torch.autograd.grad(loss, leaves)):
                p -= 0.05 * g
    params = {k: v.detach().cpu() for k, v in params.items()}
    mse = float(((kan.kan_linear_apply(params, xs.cpu()) - ys.cpu()) ** 2).mean())
    print(f"KAN fit mse: {mse:.5f}")

    # 2-3. sample the edge and convert it exactly (Eq. 7)
    edge = kan.kan_edge_fn(params, 0, 0)
    t_slots = 32
    bounds, outs = thr.sample_to_pwc(edge, -1.0, 1.0, t_slots)
    alphas = thr.pwc_to_alphas(outs)
    xs1 = torch.linspace(-0.99, 0.99, 401)
    gap = (thr.threshold_sum(xs1, bounds, alphas) - thr.eval_pwc(xs1, bounds, outs)).abs().max()
    print(f"Eq.7 exactness |threshold_sum - pwc|_max = {float(gap):.2e}  (should be ~1e-6)")

    # 4-5. the integer budget m
    ref = edge(xs1)
    rms_ref = float(ref.square().mean().sqrt())
    print(f"{'m':>4} {'rmse/rms':>10}   (m=1 is BiKA)")
    for m in (1, 2, 4, 8, 16, 32, 64):
        taus, signs, scale = thr.approximate_function(edge, -1.0, 1.0, t_slots, m)
        approx = scale * thr.threshold_sum(xs1, taus, signs)
        rmse = float((approx - ref).square().mean().sqrt()) / rms_ref
        print(f"{m:>4} {rmse:>10.4f}   {'#' * int(50 * min(rmse, 1.0))}")
    print("conversion demo OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
