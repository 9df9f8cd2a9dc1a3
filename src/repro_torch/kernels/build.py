"""Build the hand-written CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

into ``build/kernels/lib<name>-<hash>.so`` at the repository root (the
hash is of the source and the shared ``*.cuh`` headers, so an edited kernel
rebuilds), with ``-Xptxas=-v``, whose output is kept beside the library as
``lib<name>-<hash>.ptxas.log`` (a library without it is built again).
No ``--use_fast_math``: the paged-attention tolerance relies on accurate
``expf``, and the training CAC on IEEE-rounded ``__fmul_rn``/``__fadd_rn``.
Nothing is built at import time; ``load(name)`` builds on first use and ``build_all``
compiles every source in parallel (one ``nvcc`` each, all started together).
Each process compiles to temporary names of its own (its pid) and renames
them into place atomically, so ranks that reach a first build together
each finish a whole library and never clobber one another's; the
launchers build before they spawn ranks.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from typing import Dict, List, Optional

__all__ = ["CSRC", "BUILD_DIR", "KERNEL_SOURCES", "build_all", "hot_loop_mix", "load"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_PKG)), "build", "kernels")
KERNEL_SOURCES = ("bnn_matmul", "cac_matmul", "cac_train", "paged_attn", "qnn_matmul")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of its source and of every
    shared header in ``csrc/`` (``*.cuh``), so an edit to either rebuilds."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _command(name: str, out: str) -> List[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", out, os.path.join(CSRC, f"{name}.cu")]


def _log_path(lib: str) -> str:
    """The ``-Xptxas=-v`` output kept beside a library: ``lib<name>-<hash>.ptxas.log``."""
    return lib[:-len(".so")] + ".ptxas.log"


def build_all(names=KERNEL_SOURCES, *, logs: Optional[Dict[str, str]] = None
              ) -> Dict[str, str]:
    """Compile every named source that is not built yet, all in parallel.
    Returns ``{name: library path}``; raises with nvcc's output on failure.
    Every source compiles with ``-Xptxas=-v``, whose output (registers,
    shared memory and spills per kernel) is kept beside its library; with
    ``logs``, each named source's output is stored there, whether it was
    compiled now or before."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    paths = {}
    tmp = f".{os.getpid()}.tmp"  # per process: ranks that build at once never share one
    for name in names:
        out = _lib_path(name)
        paths[name] = out
        if not (os.path.exists(out) and os.path.exists(_log_path(out))):
            cmd = _command(name, out + tmp)
            cmd.insert(1, "-Xptxas=-v")
            procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        with open(_log_path(out) + tmp, "w") as fh:
            fh.write(log)
        os.replace(_log_path(out) + tmp, _log_path(out))
        os.replace(out + tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    if logs is not None:
        for name, out in paths.items():
            with open(_log_path(out)) as fh:
                logs[name] = fh.read()
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    cached = _LIBS.get(name)
    if cached is not None:
        return cached
    cdll = ctypes.CDLL(build_all((name,))[name])
    _LIBS[name] = cdll
    return cdll


def hot_loop_mix(lib: str, kernels) -> Dict[str, Dict[str, int]]:
    """The opcode counts of the hot loop of each kernel in the built library
    ``lib`` whose name contains one of ``kernels``, from ``cuobjdump -sass``:
    ``{kernel name: {opcode: count}}``. A loop is a backward branch; its own
    body leaves out the loops nested in it, and the hot loop is the one whose
    own body holds the most FP32 arithmetic (FADD, FMUL, FFMA, FSET,
    FSETP). Opcodes lose their modifiers (compares keep theirs); a
    predicated instruction counts as issued."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0].strip()
        if not any(k in name for k in kernels):
            continue
        ins = [(int(a, 16), t.strip()) for a, t in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        loops = []
        for addr, text in ins:
            target = re.search(r"BRA[^0-9]*0x([0-9a-f]+)", text)
            if target and int(target.group(1), 16) < addr:
                loops.append((int(target.group(1), 16), addr))
        best = None
        for lo, hi in loops:
            nested = [(c, d) for c, d in loops if (c, d) != (lo, hi) and lo <= c and d <= hi]
            ops = collections.Counter()
            for addr, text in ins:
                if lo <= addr <= hi and not any(c <= addr <= d for c, d in nested):
                    op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]
                    ops[op if op.startswith(("FSET", "FSETP", "ISETP")) else op.split(".")[0]] += 1
            fp32 = sum(n for op, n in ops.items() if op.split(".")[0] in
                       ("FADD", "FMUL", "FFMA", "FSET", "FSETP"))
            if best is None or fp32 > best[0]:
                best = (fp32, ops)
        if best is not None:
            out[name] = dict(best[1].most_common())
    return out
