"""Analytic stand-in for the paper's Ultra96-V2 place-and-route numbers
(Table III), and the H100's device terms that the port's bounds and its
kernel-contract checker read.

The FPGA model is the reference's (``repro/hwsim/resource.py``), copied
with its names and values: there is no FPGA toolchain here, so it models

* LUT/FF per processing element from standard UltraScale+ primitive costs
  (n-bit carry-chain compare ≈ n/2+1 LUTs, n-bit add ≈ n LUTs, LUT-only
  8x8 multiply ≈ 57 LUTs, XNOR bank ≈ 1 LUT per 2 bits + popcount tree);
* array-level overhead (FSM, AXI shell, FIFOs) shared across accelerators,
  plus the extra threshold-load pipeline the paper adds to BNN/QNN;
* a linear cycle model over systolic tiles with one fitted
  cycles-per-tile constant per accelerator (calibrated on the paper's nine
  TFC/SFC/LFC latencies, then validated on cross-network ratios).

Validation targets are the paper's *ratios* (−27.73 % LUTs vs BNN, −51.54 %
vs QNN; BiKA 2.17–3.30x faster than QNN; BNN-SIMD fastest).

``DEVICE_TERMS`` holds one card, the H100 SXM, from NVIDIA's data sheet and
the CUDA programming guide (compute capability 9.0): the peaks behind every
bound ``chip_smoke.py`` prints, and the on-chip limits that
``repro_torch.analysis.kernel_contracts`` holds the kernels to.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

__all__ = [
    "PAPER_TABLE3",
    "NET_DIMS",
    "DEVICE_TERMS",
    "DEFAULT_DEVICE",
    "KERNEL_SMEM_BUDGET",
    "AcceleratorModel",
    "pe_luts",
    "array_resources",
    "latency_us",
    "calibrate_latency",
    "adp",
    "pdp",
    "smem_budget_bytes",
]

# ---------------------------------------------------------------------------
# Device terms (one NVIDIA H100 SXM)
# ---------------------------------------------------------------------------
DEVICE_TERMS = {
    "h100_sxm": {
        "hbm_bw": 3.35e12,  # HBM3 bytes/s (data sheet)
        "fp32_ops": 67e12,  # float32 operations/s outside the tensor cores (data sheet)
        "bf16_tensor_ops": 989e12,  # dense bf16 tensor-core operations/s (data sheet)
        "int8_tensor_ops": 1979e12,  # dense int8 tensor-core operations/s (data sheet)
        "sms": 132,  # streaming multiprocessors (data sheet, SXM5)
        "smem_per_block": 232448,  # bytes a block may opt in to, 227 KB (programming guide)
        "smem_per_sm": 233472,  # bytes of shared memory an SM has, 228 KB (programming guide)
        "regs_per_sm": 65536,  # 32-bit registers an SM has (programming guide)
        "regs_per_thread": 255,  # registers a thread may take (programming guide)
        "cluster_portable": 8,  # blocks a cluster may hold portably (programming guide)
        "cluster_nonportable": 16,  # with cudaFuncAttributeNonPortableClusterSizeAllowed
        "l2_bytes": 50 << 20,  # L2 cache, 50 MB (data sheet)
        "hbm_bytes": 80 * 10**9,  # HBM3 capacity, 80 GB (data sheet)
    },
}

DEFAULT_DEVICE = "h100_sxm"

# Shared memory one kernel's block may take: static plus dynamic, against
# the block's opt-in limit (the 1 KB an SM reserves per block lies outside it).
KERNEL_SMEM_BUDGET = DEVICE_TERMS[DEFAULT_DEVICE]["smem_per_block"]


def smem_budget_bytes(device: str = DEFAULT_DEVICE, fraction: float = 1.0) -> int:
    """Per-block shared-memory budget (static + dynamic bytes) for ``device``."""
    return int(fraction * DEVICE_TERMS[device]["smem_per_block"])


# Paper Table III (Ultra96-V2, 8x8 PEs).
PAPER_TABLE3 = {
    "bika": {
        "LUT": 8900, "FF": 9232, "BRAM": 19.5, "MHz": 300.0, "delay_ns": 2.744,
        "power_w": 1.778, "latency_us": {"tfc": 11.201, "sfc": 71.421, "lfc": 611.890},
    },
    "bnn": {
        "LUT": 12315, "FF": 9962, "BRAM": 24.5, "MHz": 300.0, "delay_ns": 3.013,
        "power_w": 1.860, "latency_us": {"tfc": 1.646, "sfc": 10.663, "lfc": 84.753},
    },
    "qnn": {
        "LUT": 18366, "FF": 13179, "BRAM": 23.5, "MHz": 250.0, "delay_ns": 3.610,
        "power_w": 1.803, "latency_us": {"tfc": 34.915, "sfc": 236.028, "lfc": 1327.980},
    },
}

# Table II network structures (input dim first).
NET_DIMS = {
    "tfc": (784, 64, 32, 10),
    "sfc": (784, 256, 256, 256, 10),
    "lfc": (784, 1024, 1024, 1024, 10),
}

ARRAY = 8  # 8x8 PEs


# ---------------------------------------------------------------------------
# Primitive LUT costs (UltraScale+ 6-LUT + CARRY8 mapping)
# ---------------------------------------------------------------------------


def _cmp(bits: int) -> int:
    """n-bit magnitude compare on the carry chain: ~n/2 LUTs + 1."""
    return bits // 2 + 1


def _add(bits: int) -> int:
    """Ripple/carry add: 1 LUT per bit."""
    return bits


def _sat(bits: int) -> int:
    """Saturation clamp (overflow detect + mux): ~bits/2 + 2."""
    return bits // 2 + 2


def _mul_lut(bits: int) -> int:
    """LUT-only signed bits x bits multiply (no DSP): partial products +
    compressor tree, ~1.3 LUT per product bit for 8x8."""
    return int(1.33 * bits * bits)


def _xnor_bank(width: int) -> int:
    """width 1-bit XNORs pack 2/LUT."""
    return -(-width // 2)


def _popcount(width: int) -> int:
    """Adder-tree popcount of `width` bits: ~1.25 LUT per input bit."""
    return int(1.25 * width) + 2


def pe_luts(mode: str) -> Dict[str, int]:
    """Per-PE LUT breakdown for the three PE types of Fig. 8."""
    if mode == "bika":
        # one comparator + one saturating accumulator; no activation unit.
        # threshold storage: 9 bits/edge (int8 tau + sign) -> small load mux.
        return {"cmp8": _cmp(8), "acc8_sat": _add(8) + _sat(8), "thresh_store": 3}
    if mode == "bnn":
        # 8-bit SIMD XNOR + popcount + 1-threshold activation + accumulator;
        # the SIMD datapath needs 8-bit weight regs + lane routing.
        return {
            "xnor_simd8": _xnor_bank(8),
            "popcount8": _popcount(8) - 3,
            "acc12": _add(12),
            "thresh_act": _cmp(12) + 4,  # threshold compare + load mux
            "simd_regs_routing": 17,
            "store": 3,
        }
    if mode == "qnn":
        # 8x8 MAC + serial 2^8-threshold requant (one comparator, FSM-shared)
        return {
            "mul8x8_lut": _mul_lut(8),
            "acc20": _add(20),
            "thresh_serial": _cmp(20) + 8,  # comparator + serial index ctrl
            "weight_regs": 8,
            "store": 3,
        }
    raise ValueError(mode)


# Array-level shell (AXI, FSM, FIFOs) + the extra threshold-loading pipeline
# the paper adds to BNN/QNN systolic arrays (Fig. 9) — absent in BiKA.
_SHELL_LUT = {"bika": 7500, "bnn": 7500 + 1100, "qnn": 7500 + 2000}
_SHELL_FF = {"bika": 7800, "bnn": 7800, "qnn": 7800}
_FF_PER_PE = {"bika": 22, "bnn": 34, "qnn": 84}


def array_resources(mode: str, n_pe: int = ARRAY * ARRAY) -> Dict[str, float]:
    pe = sum(pe_luts(mode).values())
    return {
        "LUT": _SHELL_LUT[mode] + n_pe * pe,
        "FF": _SHELL_FF[mode] + n_pe * _FF_PER_PE[mode],
        "LUT_per_PE": pe,
    }


# ---------------------------------------------------------------------------
# Cycle/latency model
# ---------------------------------------------------------------------------


def _net_tiles(dims: Sequence[int]) -> float:
    """Systolic tiles summed over layers: ceil(K/8) * ceil(N/8)."""
    return float(
        sum(-(-k // ARRAY) * (-(-n // ARRAY)) for k, n in zip(dims[:-1], dims[1:]))
    )


def _net_outputs(dims: Sequence[int]) -> float:
    return float(sum(dims[1:]))


@dataclasses.dataclass(frozen=True)
class AcceleratorModel:
    """cycles = cpt * tiles + cpo * outputs; latency = cycles / fMHz.

    cpt — systolic streaming cycles per 8x8 tile (BiKA ≈ 4: one input/cycle
          through the CAC pipeline; BNN-SIMD ≈ 0.5: 8 bits/cycle);
    cpo — per-output post-processing cycles (QNN's serial 2^8-threshold
          requant dominates here ≈ 54; ~0 for BiKA, which has no activation
          pass — the paper's architectural point).
    """

    mode: str
    cycles_per_tile: float
    cycles_per_output: float
    mhz: float

    def latency_us(self, net: str) -> float:
        dims = NET_DIMS[net]
        cycles = (
            self.cycles_per_tile * _net_tiles(dims)
            + self.cycles_per_output * _net_outputs(dims)
        )
        return cycles / self.mhz


def calibrate_latency() -> Dict[str, AcceleratorModel]:
    """Fit (cycles_per_tile, cycles_per_output) per accelerator to the
    paper's nine latencies (non-negative least squares, 2 params x 3 nets)."""
    out = {}
    for mode, row in PAPER_TABLE3.items():
        mhz = row["MHz"]
        a, b = [], []
        for net, lat in row["latency_us"].items():
            a.append([_net_tiles(NET_DIMS[net]), _net_outputs(NET_DIMS[net])])
            b.append(lat * mhz)
        (cpt, cpo), *_ = np.linalg.lstsq(np.asarray(a), np.asarray(b), rcond=None)
        cpo = max(cpo, 0.0)
        out[mode] = AcceleratorModel(mode, float(cpt), float(cpo), mhz)
    return out


def latency_us(mode: str, net: str, models: Dict[str, AcceleratorModel] = None) -> float:
    models = models or calibrate_latency()
    return models[mode].latency_us(net)


def adp(mode: str, resources: Dict[str, float] = None) -> float:
    """Area-delay product (LUT x total delay ns), as in Table III."""
    r = resources or array_resources(mode)
    return r["LUT"] * PAPER_TABLE3[mode]["delay_ns"]


def pdp(mode: str) -> float:
    return PAPER_TABLE3[mode]["power_w"] * PAPER_TABLE3[mode]["delay_ns"]
