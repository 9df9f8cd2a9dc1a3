"""repro_torch.hwsim — the calibrated analytic FPGA resource/latency model of
the paper's Table III, and the H100's device terms (peak rates, on-chip
limits, the per-block shared-memory budget) that the bounds and the kernel
contracts read."""
from .resource import (
    DEFAULT_DEVICE,
    DEVICE_TERMS,
    KERNEL_SMEM_BUDGET,
    NET_DIMS,
    PAPER_TABLE3,
    AcceleratorModel,
    adp,
    array_resources,
    calibrate_latency,
    latency_us,
    pdp,
    pe_luts,
    smem_budget_bytes,
)

__all__ = [
    "DEFAULT_DEVICE",
    "DEVICE_TERMS",
    "KERNEL_SMEM_BUDGET",
    "NET_DIMS",
    "PAPER_TABLE3",
    "AcceleratorModel",
    "pe_luts",
    "array_resources",
    "latency_us",
    "calibrate_latency",
    "adp",
    "pdp",
    "smem_budget_bytes",
]
