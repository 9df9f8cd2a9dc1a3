"""Table III (the port's counterpart of ``benchmarks/table3_resources.py``):
accelerator resources and latency from the calibrated analytic model of
``repro_torch.hwsim``, model against paper for each number, and the
paper's headline claims (LUT reductions of 27.73 % against BNN and 51.54 %
against QNN; BiKA 2.17-3.30x faster than QNN; BNN-SIMD fastest; BiKA's
lowest area-delay and power-delay products).

    PYTHONPATH=src python -m repro_torch.launch.table3 [--out FILE]

The numbers are the paper's Ultra96-V2 FPGA figures and the model fitted to
them; nothing here touches a tensor or a device. ``--out`` writes the JSON.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict

from repro_torch.hwsim import (
    PAPER_TABLE3,
    adp,
    array_resources,
    calibrate_latency,
    latency_us,
    pdp,
)

MODES = ("bika", "bnn", "qnn")
NETS = ("tfc", "sfc", "lfc")


def table3() -> Dict[str, dict]:
    """``{"table": {mode: model and paper numbers}, "claims": {...}}``."""
    models = calibrate_latency()
    table = {}
    for mode in MODES:
        r = array_resources(mode)
        p = PAPER_TABLE3[mode]
        table[mode] = {
            "LUT_model": r["LUT"], "LUT_paper": p["LUT"],
            "FF_model": r["FF"], "FF_paper": p["FF"],
            "ADP_model": adp(mode, r), "PDP": pdp(mode),
            "latency_us_model": {n: latency_us(mode, n, models) for n in NETS},
            "latency_us_paper": p["latency_us"],
        }
    b, n, q = (table[m]["LUT_model"] for m in MODES)
    claims = {
        "lut_reduction_vs_bnn_pct": 100 * (1 - b / n),
        "lut_reduction_vs_bnn_paper": 27.73,
        "lut_reduction_vs_qnn_pct": 100 * (1 - b / q),
        "lut_reduction_vs_qnn_paper": 51.54,
        "bika_vs_qnn_speedup": [
            latency_us("qnn", net, models) / latency_us("bika", net, models) for net in NETS
        ],
        "bika_vs_qnn_speedup_paper": [2.17, 3.30],
        "bnn_fastest": all(
            latency_us("bnn", net, models)
            < min(latency_us("bika", net, models), latency_us("qnn", net, models))
            for net in NETS
        ),
        "bika_lowest_adp": adp("bika") < min(adp("bnn"), adp("qnn")),
        "bika_lowest_pdp": pdp("bika") < min(pdp("bnn"), pdp("qnn")),
    }
    return {"table": table, "claims": claims}


def render(result: Dict[str, dict]) -> str:
    lines = [f"{'mode':<5} {'LUT model':>10} {'paper':>7} {'FF model':>9} {'paper':>7} "
             f"{'ADP':>9} {'PDP':>6}  latency us model / paper (tfc, sfc, lfc)"]
    for mode, t in result["table"].items():
        lat = ", ".join(f"{t['latency_us_model'][n]:.3f} / {t['latency_us_paper'][n]:.3f}"
                        for n in NETS)
        lines.append(f"{mode:<5} {t['LUT_model']:>10.0f} {t['LUT_paper']:>7} "
                     f"{t['FF_model']:>9.0f} {t['FF_paper']:>7} {t['ADP_model']:>9.1f} "
                     f"{t['PDP']:>6.3f}  {lat}")
    c = result["claims"]
    lines.append(
        f"claims: LUTs -{c['lut_reduction_vs_bnn_pct']:.2f}% vs BNN (paper -27.73%), "
        f"-{c['lut_reduction_vs_qnn_pct']:.2f}% vs QNN (paper -51.54%); BiKA "
        f"{min(c['bika_vs_qnn_speedup']):.2f}-{max(c['bika_vs_qnn_speedup']):.2f}x faster "
        f"than QNN (paper 2.17-3.30x); BNN fastest {c['bnn_fastest']}; BiKA lowest ADP "
        f"{c['bika_lowest_adp']}, PDP {c['bika_lowest_pdp']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the table and claims as JSON here")
    args = ap.parse_args(argv)
    result = table3()
    print(render(result))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1, sort_keys=True)
            fh.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
