"""The port's hwsim against the reference's: the FPGA resource and latency
model of Table III number for number, the H100's device terms (no TPU
entry), the Table III launcher, and chip_smoke.py's bound constants read
from the port's table with the values they had."""
import json
import os
import re
import sys

import pytest

import repro.hwsim as ref
import repro_torch.hwsim as hw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("bika", "bnn", "qnn")
NETS = ("tfc", "sfc", "lfc")


def test_tables_equal_the_reference():
    assert hw.PAPER_TABLE3 == ref.PAPER_TABLE3
    assert hw.NET_DIMS == ref.resource.NET_DIMS


@pytest.mark.parametrize("mode", MODES)
def test_resources_equal_the_reference(mode):
    assert hw.pe_luts(mode) == ref.pe_luts(mode)
    assert hw.array_resources(mode) == ref.array_resources(mode)
    assert hw.array_resources(mode, n_pe=16) == ref.array_resources(mode, n_pe=16)
    assert hw.adp(mode) == ref.adp(mode)
    assert hw.pdp(mode) == ref.pdp(mode)


@pytest.mark.parametrize("mode", MODES)
def test_latency_model_equals_the_reference(mode):
    mine, theirs = hw.calibrate_latency()[mode], ref.calibrate_latency()[mode]
    assert (mine.cycles_per_tile, mine.cycles_per_output, mine.mhz) == (
        theirs.cycles_per_tile, theirs.cycles_per_output, theirs.mhz)
    for net in NETS:
        assert hw.latency_us(mode, net) == ref.latency_us(mode, net)


def test_headline_ratios_equal_the_reference_and_the_paper():
    from repro_torch.launch import table3

    claims = table3.table3()["claims"]
    lut = {m: ref.array_resources(m)["LUT"] for m in MODES}
    assert claims["lut_reduction_vs_bnn_pct"] == 100 * (1 - lut["bika"] / lut["bnn"])
    assert claims["lut_reduction_vs_qnn_pct"] == 100 * (1 - lut["bika"] / lut["qnn"])
    assert claims["bika_vs_qnn_speedup"] == [
        ref.latency_us("qnn", n) / ref.latency_us("bika", n) for n in NETS]
    # the paper's claims, as the reference's own tests hold its model to them
    assert abs(claims["lut_reduction_vs_bnn_pct"] - 27.73) < 2.0
    assert abs(claims["lut_reduction_vs_qnn_pct"] - 51.54) < 2.0
    assert 2.0 < min(claims["bika_vs_qnn_speedup"]) and max(claims["bika_vs_qnn_speedup"]) < 3.5
    assert claims["bnn_fastest"] and claims["bika_lowest_adp"] and claims["bika_lowest_pdp"]


def test_table3_launcher(tmp_path, capsys):
    from repro_torch.launch import table3

    out = tmp_path / "table3.json"
    assert table3.main(["--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert set(got["table"]) == set(MODES)
    assert got["table"]["bika"]["LUT_paper"] == 8900
    assert got["table"]["qnn"]["latency_us_model"]["lfc"] == pytest.approx(
        ref.latency_us("qnn", "lfc"), rel=0, abs=0)
    printed = capsys.readouterr().out
    assert "paper -27.73%" in printed and "2.17-3.30x" in printed


def test_device_terms_are_the_h100s_and_no_tpu_figure():
    assert set(hw.DEVICE_TERMS) == {"h100_sxm"}
    assert not any("tpu" in k.lower() for k in hw.DEVICE_TERMS)
    h = hw.DEVICE_TERMS["h100_sxm"]
    assert (h["hbm_bw"], h["fp32_ops"], h["bf16_tensor_ops"], h["int8_tensor_ops"]) == (
        3.35e12, 67e12, 989e12, 1979e12)
    assert (h["sms"], h["smem_per_block"], h["smem_per_sm"], h["regs_per_sm"],
            h["regs_per_thread"], h["cluster_portable"], h["cluster_nonportable"]) == (
        132, 232448, 233472, 65536, 255, 8, 16)
    assert hw.KERNEL_SMEM_BUDGET == hw.smem_budget_bytes() == 232448
    assert not hasattr(hw, "KERNEL_VMEM_BUDGET") and not hasattr(hw, "vmem_budget_bytes")
    with open(os.path.join(ROOT, "src", "repro_torch", "hwsim", "resource.py")) as fh:
        text = fh.read().lower()
    assert not re.search(r"\btpu|vmem", text)


def test_chip_smoke_bounds_read_the_port_table():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    h = hw.DEVICE_TERMS["h100_sxm"]
    assert (chip_smoke.HBM_BYTES_S, chip_smoke.CUDA_CORE_OPS_S, chip_smoke.TENSOR_CORE_OPS_S,
            chip_smoke.INT8_TENSOR_OPS_S) == (h["hbm_bw"], h["fp32_ops"], h["bf16_tensor_ops"],
                                              h["int8_tensor_ops"])
    # the values every bound in PERF.md was computed with
    assert (chip_smoke.HBM_BYTES_S, chip_smoke.CUDA_CORE_OPS_S, chip_smoke.TENSOR_CORE_OPS_S,
            chip_smoke.INT8_TENSOR_OPS_S) == (3.35e12, 67e12, 989e12, 1979e12)
