"""Hold the serve drains of two builds of the paged-attention kernel against
each other on one GPU.

    python3 attn_ties.py OTHER_PAGED_ATTN_CU

OTHER_PAGED_ATTN_CU is another commit's ``src/repro_torch/csrc/paged_attn.cu``
(a parent's, unpacked with ``git archive``); its C entry point
``paged_attn_launch`` takes the same arguments as this tree's. The script
builds it beside this tree's kernel and serves ``chip_smoke.py``'s drains
(smollm-360m at full width and depth, random weights from its seed, 8
requests x 16 tokens, paged engine) with each: bika, packed bnn and qnn8,
each with fp and int8 KV, and the paged speculative drain (dense target,
qnn8 draft, k = 4, fp KV).

The two kernels sum in other orders, so their outputs differ by float
rounding (~1e-7 relative). Where a drain's tokens differ, the script serves
this tree's drain again while holding every activation code (bika, qnn8) or
projection-input Sign (bnn) to the other build's where the two differ at a
genuine tie, as ``chip_smoke.py``'s parity phase defines one (within
PARITY_TIE code units of a half-way point; |x| within BNN_SIGN_TIE of 0), and
fails on any other difference; the tokens must then be equal (with the
codes held, K/V come from the same integer sums, so an int8 pool rounds them
alike). Speculative tokens that differ must do so at a top-2 logit gap below
SPEC_TIE (``chip_smoke._spec_ties``). Prints one line a drain and exits
non-zero on a difference that is not a tie.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import chip_smoke as cs


def other_kernel(torch, src):
    """Build ``src`` and return a call with ``paged_attn_kernel_call``'s
    arguments that launches it."""
    from repro_torch.kernels import build

    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:12]
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(build.BUILD_DIR, f"libpaged_attn_other-{digest}.so")
    if not os.path.exists(lib_path):
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", os.path.dirname(src), "-o",
                        lib_path, src], check=True)
    fn = ctypes.CDLL(lib_path).paged_attn_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(q, k, v, tables, q_pos, *, k_scale=None, v_scale=None):
        quantized = k_scale is not None
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        tables = tables.to(torch.int32).contiguous()
        q_pos = q_pos.to(torch.int32).contiguous()
        ks = k_scale.contiguous() if quantized else None
        vs = v_scale.contiguous() if quantized else None
        out = torch.empty_like(q)
        b, c, hq, d = q.shape
        _, bs, hkv, _ = k.shape
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 ks.data_ptr() if quantized else None, vs.data_ptr() if quantized else None,
                 tables.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
                 b, c, hq, hkv, d, bs, tables.shape[1], int(quantized),
                 torch.cuda.current_stream(q.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"the other paged attention kernel failed: CUDA error {err}")
        return out

    return call


def drain(np, train, arch, dev, attn, ops, quantized=False, **spec):
    """The drain's tokens, paged attention through ``attn``."""
    kernel = ops.paged_attn_kernel_call
    ops.paged_attn_kernel_call = attn
    try:
        return cs._serve(np, train, arch, quantized, dev, **spec)[0]
    finally:
        ops.paged_attn_kernel_call = kernel


def main() -> int:
    import numpy as np
    import torch

    if len(sys.argv) != 2 or not os.path.isfile(sys.argv[1]):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("attn_ties: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.models import build_model

    print(cs.smi_line())
    build.build_all()  # every source at once, in parallel
    dev = torch.device("cuda")
    other, this = other_kernel(torch, sys.argv[1]), ops.paged_attn_kernel_call
    for mode, hooks in (("bika", cs._code_hooks),
                        ("bnn", lambda t: cs._bnn_sign_hooks(t, "bnn_matmul_packed")),
                        ("qnn8", cs._code_hooks)):
        arch = get_config("smollm-360m", compute_mode=mode, pack_signs=mode != "qnn8",
                          remat=False, paged_attn_route="fused")
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        train = build_model(arch, phase="train").init(gen, device=dev)
        for quantized in (False, True):
            install, restore, report = hooks(torch)
            install("card")  # record the other build's codes (Signs)
            try:
                want = drain(np, train, arch, dev, other, ops, quantized)
            finally:
                restore()
            got = drain(np, train, arch, dev, this, ops, quantized)
            differ = sorted(r for r in want if want[r] != got[r])
            line = (f"[ties] {mode} {'int8' if quantized else 'fp'} KV: tokens equal on "
                    f"{8 - len(differ)} of 8 requests")
            if differ:
                install("cpu")  # this build, held to the other's codes (Signs) at ties
                try:
                    held = drain(np, train, arch, dev, this, ops, quantized)
                finally:
                    restore()
                if held != want:
                    cs.fail(f"{mode}: with the ties held the tokens still differ")
                firsts = {r: next(i for i, (a, b) in enumerate(zip(want[r], got[r]))
                                  if a != b) for r in differ}
                line += (f" (requests {differ} part at tokens {firsts}); held at ties, equal "
                         f"on 8 of 8: {report()}")
            print(line, flush=True)
        del train
    arch = get_config("smollm-360m", compute_mode="dense", remat=False, paged_attn_route="fused")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    train = build_model(arch, phase="train").init(gen, device=dev)
    spec = dict(spec_draft="qnn8", spec_k=cs.SPEC_K)
    want = drain(np, train, arch, dev, other, ops, **spec)
    got = drain(np, train, arch, dev, this, ops, **spec)
    ties = cs._spec_ties(torch, np, arch, train, dev, want, got,
                         "paged speculative, this kernel vs the other")
    print(f"[ties] paged speculative: tokens equal on "
          f"{sum(want[r] == got[r] for r in want)} of 8 requests; {len(ties)} parted at a "
          f"top-2 gap below {cs.SPEC_TIE}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
