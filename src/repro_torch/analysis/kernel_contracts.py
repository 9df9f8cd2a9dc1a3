"""Pass 2 — the Hopper kernel contract checker (the port's counterpart of
``repro/analysis/kernel_contracts.py``).

For every route in ``kernels.ops.KERNEL_ROUTES``, every registered config
(``configs.ARCH_NAMES``) and M = 4 (decode), 512 (training) and 2048
(prefill) this pass takes the plan each kernel of the route would launch
(``kernels.autotune.get_plan`` off the card: today's plan rules at the
H100's 132 SMs, or a cache entry), rebuilds the launcher's grid, cluster
and shared memory from it (``kernels.geometry``, the one copy of the
launchers' geometry and limits, which ``autotune.plan_error`` also reads;
the card's own launches confirm it where ``chip_smoke.py`` and the
measured search run them), and checks:

  KCV001  coverage: every KERNEL_ROUTES entry has contract metadata and
          vice versa, every counted kernel (``ops._COUNTED``) an autotune
          path, and every entry function of a ``-Xptxas -v`` log a kernel
          (by symbol stem); an entry that maps to nothing is a finding
  KCV002  plan legality: tiles and splits cover the problem exactly once
          with no empty split; a cluster is at most 8 blocks, or 16 where
          the launcher sets cudaFuncAttributeNonPortableClusterSizeAllowed
          (kernels 3, 5 and 11); grid y and z at most 65,535; packed K a
          whole number of bytes; on the TMA routes (kernels 6 at large M,
          8, 9) every global stride a multiple of 16 bytes, every box
          dimension at most 256 and the swizzled inner box at most 128 bytes
  KCV003  bounds: the last tile starts inside its operand on every axis
  KCV004  on-chip budget: static plus the plan's dynamic shared memory
          within ``hwsim.KERNEL_SMEM_BUDGET``; from a ptxas log also
          registers x threads x the blocks ``__launch_bounds__`` asks for
          within the SM's 65,536, at most 255 registers a thread, and spill
          stores within the kernel's stated budget (``SPILL_BUDGET``)
  KCV005  wrapper contract: each route's output shape and dtype (and the
          training routes' gradients) on ``meta`` tensors, through the
          route itself
  KCV006  keys: autotune keys round-trip through ``parse_cache_key``, and
          each backend's ``autotune_key`` agrees with its ``kernel_route``
          and ``autotune_path``
  KCV007  cache hygiene: every on-disk autotune entry the loader rejected

It runs on the CPU in seconds. ``run(ptxas_log=..., sms=..., max_blocks=...)``
takes the build's ``-Xptxas -v`` output and the card's SM count and
occupancy query on the card (``chip_smoke.py``'s tooling phase); off the
card a recorded log serves (``python -m repro_torch.analysis --contracts
--ptxas-log FILE``). The JSON payload has one entry per (route, arch, M).
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.hwsim import DEVICE_TERMS, KERNEL_SMEM_BUDGET
from repro_torch.kernels import autotune, geometry

from .report import Finding, Report

__all__ = [
    "ENTRY_KERNELS",
    "M_CASES",
    "ROUTE_INFO",
    "SPILL_BUDGET",
    "check_plan",
    "check_ptxas",
    "check_tma",
    "config_gemms",
    "entry_kernels",
    "parse_ptxas",
    "run",
    "symbol_stem",
]

PASS = "kernel_contracts"
H100 = DEVICE_TERMS["h100_sxm"]
M_CASES = (("decode", 4), ("train", 512), ("prefill", 2048))

# route -> the autotune paths of its kernels, and kernel 6's weight dtype
ROUTE_INFO: Dict[str, Dict] = {
    "cac_hw": dict(paths=("hw_fwd",)),
    "cac_train": dict(paths=("train_fwd", "train_bwd", "train_bwd_dw")),
    "bnn": dict(paths=("bnn",), w_dtype="int8"),
    "bnn_packed": dict(paths=("bnn_packed",)),
    "bnn_train": dict(paths=("bnn", "bnn_bwd"), w_dtype="float32"),
    "qnn8": dict(paths=("qnn8",)),
    "paged_attn": dict(paths=("paged_attn",)),
}
# counted kernel (ops._COUNTED) -> its autotune path
COUNTED_PATHS = {
    "cac_hw": "hw_fwd", "cac_train_fwd": "train_fwd", "cac_train_bwd_fused": "train_bwd",
    "cac_train_bwd_dx": "train_bwd", "cac_train_bwd_dw": "train_bwd_dw", "bnn": "bnn",
    "bnn_packed": "bnn_packed", "bnn_bwd_dx": "bnn_bwd", "bnn_bwd_dw": "bnn_bwd",
    "qnn8": "qnn8", "paged_attn": "paged_attn",
}

# Entry functions by symbol stem: the kernels (numbered as in ROADMAP Queue
# 2) they serve, their __launch_bounds__ threads, and the blocks an SM that
# __launch_bounds__ asks for (a function of the template arguments where
# they set it). Kernel 6's streaming route and kernel 7 share kernel 1's
# template (csrc/stream_matmul.cuh): its first template argument is the op.
_STREAM_OP_KERNELS = {0: (1,), 1: (6,), 2: (6,), 3: (7,)}
_PRODUCT_MODE_KERNELS = {0: (9,), 1: (8,), 2: (6,)}
ENTRY_KERNELS: Dict[str, Dict] = {
    "stream_kernel": dict(threads=256, blocks=2,
                          kernels=lambda t: _STREAM_OP_KERNELS.get(t[0], ())),
    "cac_train_fwd_kernel": dict(threads=256, blocks=2, kernels=(2,)),
    "cac_train_bwd_fused_kernel": dict(threads=256, blocks=2, kernels=(5,)),
    "cac_train_bwd_dx_kernel": dict(threads=256, blocks=2, kernels=(3,)),
    "cac_train_bwd_dw_kernel": dict(threads=256, blocks=lambda t: 4 if t[1] == 4 else 2,
                                    kernels=(4,)),
    "bnn_bwd_kernel": dict(threads=256, blocks=1,
                           kernels=lambda t: _PRODUCT_MODE_KERNELS.get(t[0], ())),
    "bnn_sign_kernel": dict(threads=256, blocks=1, kernels=(6, 8, 9)),
    "qnn_kernel": dict(threads=256, blocks=1, kernels=(10,)),
    "qnn_stream_kernel": dict(threads=256, blocks=2, kernels=(10,)),
    "paged_attn_kernel": dict(threads=256, blocks=2, kernels=(11,)),
}

# Spill stores (bytes) an entry function may make, by (stem, template
# arguments); every other entry function's budget is 0. Each figure is
# what ptxas reported for the sources as they stand, on an H100 build
# (PERF.md lists them): the streaming template at the 128-register cap of
# two blocks an SM, kernel 4 at 4 columns (64 registers: four blocks an
# SM), four instantiations of kernel 11 and kernel 10's 32-row tile.
SPILL_BUDGET: Dict[Tuple[str, Tuple[int, ...]], int] = {
    ("stream_kernel", (0, 0, 8)): 124,
    ("stream_kernel", (0, 1, 8)): 96,
    ("stream_kernel", (0, 0, 4)): 16,
    ("stream_kernel", (0, 1, 4)): 44,
    ("cac_train_bwd_dw_kernel", (0, 4)): 12,
    ("cac_train_bwd_dw_kernel", (1, 4)): 36,
    ("paged_attn_kernel", (0, 1, 0)): 8,
    ("paged_attn_kernel", (1, 2, 0)): 8,
    ("paged_attn_kernel", (1, 4, 1)): 4,
    ("paged_attn_kernel", (1, 8, 0)): 8,
    ("qnn_kernel", (32,)): 8,
}


def _f(code: str, where: str, message: str, hint: str = "", **extra) -> Finding:
    return Finding(pass_name=PASS, code=code, where=where, message=message, hint=hint,
                   extra=extra)


# ---------------------------------------------------------------------------
# The zoo's GEMMs
# ---------------------------------------------------------------------------


def config_gemms(cfg) -> Dict[str, Tuple[int, int]]:
    """The (K, N) of a config's projections: attention (q, k/v, o), the MLP
    (gate/up, down), the MoE router, the SSM's in/out projections, the
    xLSTM blocks' projections and the LM head; 0-sized ones dropped."""
    d, hd = cfg.d_model, cfg.hd
    gemms = {
        "q": (d, cfg.n_heads * hd),
        "kv": (d, cfg.n_kv_heads * hd),
        "o": (cfg.n_heads * hd, d),
        "gate_up": (d, cfg.d_ff),
        "down": (cfg.d_ff, d),
        "lm_head": (d, cfg.padded_vocab),
    }
    if cfg.n_experts:
        gemms["router"] = (d, cfg.n_experts)
    if cfg.family == "hybrid":
        di = cfg.ssm_expand * d
        gemms["ssm_in"] = (d, 2 * di + 2 * cfg.ssm_state + di // cfg.ssm_head_dim)
        gemms["ssm_out"] = (di, d)
    if cfg.family == "xlstm":
        di = 2 * d  # the mLSTM's up-projection factor
        gemms.update(mlstm_up=(d, 2 * di), mlstm_qkv=(di, di), mlstm_down=(di, d),
                     slstm_wx=(d, 4 * d), slstm_down=(d, d))
    return {name: kn for name, kn in gemms.items() if kn[0] and kn[1]}


# ---------------------------------------------------------------------------
# Checks of one plan (also the seeded-violation entry points); the launch
# geometry and its limits are ``kernels.geometry``'s, which autotune's
# plan_error reads too
# ---------------------------------------------------------------------------

def check_tma(where: str, tmap: dict) -> List[Finding]:
    """One TMA map's KCV002 findings (``geometry.tma_errors``)."""
    return [_f(code, where, msg, hint, **extra)
            for code, msg, hint, extra in geometry.tma_errors(tmap)]


def _entries_for(launch: dict, ptxas: Optional[List[dict]]) -> List[dict]:
    if not ptxas:
        return []
    return [e for e in ptxas if e["stem"] == launch["entry"]
            and all(i < len(e["targs"]) and e["targs"][i] == v
                    for i, v in launch["targs"].items())]


def check_launch(where: str, launch: dict, *, ptxas: Optional[List[dict]] = None,
                 smem_budget: int = KERNEL_SMEM_BUDGET) -> Tuple[List[Finding], dict]:
    """KCV002-004 of one launch; returns (findings, its JSON row)."""
    out: List[Finding] = []
    entries = _entries_for(launch, ptxas)
    static = max((e["smem"] for e in entries), default=0)
    row = dict(entry=launch["entry"], smem_dynamic=launch.get("smem", 0), smem_static=static)
    if entries:
        row["registers"] = max(e["registers"] for e in entries)
        row["spill_stores"] = max(e["spill_stores"] for e in entries)
    if launch.get("grid") is not None:
        row.update(grid=list(launch["grid"]), cluster=launch["cluster"],
                   threads=launch["threads"])
    out += [_f(code, where, msg, hint, **extra) for code, msg, hint, extra in
            geometry.launch_errors(launch, static_smem=static, smem_budget=smem_budget)]
    row["smem_bytes"] = static + launch.get("smem", 0)
    return out, row


def check_plan(path: str, shape: tuple, plan=None, *, where: Optional[str] = None,
               w_dtype: str = "float32", ptxas: Optional[List[dict]] = None,
               smem_budget: int = KERNEL_SMEM_BUDGET) -> Tuple[List[Finding], dict]:
    """Every check of one plan of ``path`` at ``shape`` (None: the plan
    ``autotune`` resolves off the card). Returns (findings, the JSON row)."""
    import torch

    where = where or f"{path}[{'x'.join(map(str, shape))}]"
    if plan is None:
        if path == autotune.PAGED_ATTN_PATH:
            plan = autotune.get_paged_plan(*shape)
        else:
            plan = autotune.get_plan(path, *shape, w_dtype=getattr(torch, w_dtype))
    findings: List[Finding] = []
    rows = []
    for launch in geometry.launches(path, shape, plan, w_dtype=w_dtype):
        fs, row = check_launch(where, launch, ptxas=ptxas, smem_budget=smem_budget)
        findings += fs
        rows.append(row)
    entry = dict(path=path, shape=list(shape), plan=plan, launches=rows,
                 smem_bytes=max(r["smem_bytes"] for r in rows), ok=not findings)
    regs = [r["registers"] for r in rows if "registers" in r]
    if regs:
        entry["registers"] = max(regs)
    return findings, entry


# ---------------------------------------------------------------------------
# ptxas logs
# ---------------------------------------------------------------------------

_ENTRY_RE = re.compile(r"Compiling entry function '([^']+)'")
_PROPS_RE = re.compile(r"Function properties for (\S+)")
_SPILL_RE = re.compile(
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED_RE = re.compile(r"Used (\d+) registers")
_SMEM_RE = re.compile(r"(\d+) bytes smem")


def symbol_stem(symbol: str) -> Tuple[str, Tuple[int, ...]]:
    """A mangled entry function's name and integral template arguments:
    ``_ZN6stream13stream_kernelILi0ELb1ELi8EE...`` -> ("stream_kernel", (0,
    1, 8)). The name is the last component of the nested name (anonymous
    namespaces and others dropped)."""
    i = 3 if symbol.startswith("_ZN") else 2 if symbol.startswith("_Z") else 0
    names = []
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        size = int(symbol[i:j])
        names.append(symbol[j:j + size])
        i = j + size
        if not symbol.startswith("_ZN"):
            break
    name = names[-1] if names else symbol
    targs: Tuple[int, ...] = ()
    if i < len(symbol) and symbol[i] == "I":  # literals of the template argument list
        targs = tuple(int(v.replace("n", "-"))
                      for v in re.findall(r"L[a-z](n?\d+)E", symbol[i:].split("EEv")[0]))
    return name, targs


def parse_ptxas(log: str) -> List[dict]:
    """The entry functions of ``-Xptxas -v`` output (raw, or as
    ``chip_smoke.py`` prints it, each line prefixed): symbol, stem,
    template arguments, registers, static shared memory, spill stores and
    loads, stack frame."""
    entries: Dict[str, dict] = {}
    current: Optional[dict] = None
    props: Optional[str] = None
    for line in log.splitlines():
        got = _ENTRY_RE.search(line)
        if got:
            symbol = got.group(1)
            stem, targs = symbol_stem(symbol)
            current = entries.setdefault(symbol, dict(
                symbol=symbol, stem=stem, targs=targs, registers=0, smem=0, spill_stores=0,
                spill_loads=0, stack=0))
            props = symbol
            continue
        got = _PROPS_RE.search(line)
        if got:
            props = got.group(1)
            continue
        got = _SPILL_RE.search(line)
        if got and current is not None and props in (None, current["symbol"]):
            current.update(stack=int(got.group(1)), spill_stores=int(got.group(2)),
                           spill_loads=int(got.group(3)))
            continue
        got = _USED_RE.search(line)
        if got and current is not None:
            current["registers"] = int(got.group(1))
            smem = _SMEM_RE.search(line)
            current["smem"] = int(smem.group(1)) if smem else 0
    return list(entries.values())


def entry_kernels(entry: dict) -> Tuple[int, ...]:
    """The kernels (1-11) an entry function serves; () when it maps to none."""
    info = ENTRY_KERNELS.get(entry["stem"])
    if info is None:
        return ()
    kernels = info["kernels"]
    return tuple(kernels(entry["targs"]) if callable(kernels) else kernels)


def check_ptxas(entries: List[dict], *,
                spill_budget: Optional[Dict[Tuple[str, Tuple[int, ...]], int]] = None,
                smem_budget: int = KERNEL_SMEM_BUDGET) -> Tuple[List[Finding], List[dict]]:
    """KCV001 (each entry maps to a kernel) and KCV004 (registers, their
    product with threads and blocks an SM, spill stores, static shared
    memory) of every entry function; returns (findings, one row each)."""
    budget = SPILL_BUDGET if spill_budget is None else spill_budget
    out: List[Finding] = []
    rows = []
    for e in entries:
        where = f"ptxas:{e['stem']}<{','.join(map(str, e['targs']))}>"
        kernels = entry_kernels(e)
        row = dict(e, kernels=list(kernels), targs=list(e["targs"]))
        rows.append(row)
        if not kernels:
            out.append(_f("KCV001", where, f"entry function {e['symbol']} maps to no kernel",
                          "add its stem to ENTRY_KERNELS", symbol=e["symbol"]))
            continue
        info = ENTRY_KERNELS[e["stem"]]
        blocks = info["blocks"](e["targs"]) if callable(info["blocks"]) else info["blocks"]
        row.update(threads=info["threads"], blocks_per_sm=blocks)
        if e["registers"] > H100["regs_per_thread"]:
            out.append(_f("KCV004", where, f"{e['registers']} registers a thread past "
                          f"{H100['regs_per_thread']}", "cut the live state"))
        if e["registers"] * info["threads"] * blocks > H100["regs_per_sm"]:
            out.append(_f("KCV004", where, f"{e['registers']} registers x {info['threads']} "
                          f"threads x {blocks} blocks past the SM's {H100['regs_per_sm']}",
                          "the __launch_bounds__ and the register use disagree"))
        allowed = budget.get((e["stem"], tuple(e["targs"])), 0)
        row["spill_budget"] = allowed
        if e["spill_stores"] > allowed:
            out.append(_f("KCV004", where, f"{e['spill_stores']} B of spill stores past the "
                          f"budget {allowed} B", "cut the live state, or record the spill's "
                          "budget with its cost (PERF.md)", spill_stores=e["spill_stores"],
                          budget=allowed))
        if e["smem"] > smem_budget:
            out.append(_f("KCV004", where, f"{e['smem']} B of static shared memory past "
                          f"{smem_budget} B", "move the buffer to dynamic shared memory"))
    return out, rows


# ---------------------------------------------------------------------------
# KCV005: the routes on meta tensors
# ---------------------------------------------------------------------------


def _meta_eval(route: str, m: int, k: int, n: int, cfg) -> Optional[str]:
    """Run ``route`` on ``meta`` tensors (the training routes' backward too)
    and compare the output shapes and dtypes with the contract; None when
    they hold, else what differs."""
    import torch

    from repro_torch.kernels import ops

    dev = "meta"
    fn = ops.KERNEL_ROUTES[route]

    def t(shape, dtype=torch.float32, grad=False):
        return torch.empty(shape, dtype=dtype, device=dev, requires_grad=grad)

    f32 = torch.float32
    want = (m, n)
    grads = ()
    if route == "cac_hw":
        out = fn(t((m, k), torch.int8), t((k, n), torch.int8), t((k // 8, n), torch.uint8))
    elif route == "cac_train":
        args = (t((m, k), grad=True), t((k, n), grad=True), t((k, n), grad=True))
        out = fn(*args)
        grads = torch.autograd.grad(out, args, torch.empty_like(out))
    elif route == "bnn":
        out = fn(t((m, k)), t((k, n), torch.int8))
    elif route == "bnn_packed":
        out = fn(t((m, k)), t((k // 8, n), torch.uint8))
    elif route == "bnn_train":
        args = (t((m, k), grad=True), t((k, n), grad=True))
        out = fn(*args)
        grads = torch.autograd.grad(out, args, torch.empty_like(out))
    elif route == "qnn8":
        out = fn(t((m, k), torch.int8), t((k, n), torch.int8), t((1, n)), 0.05)
    elif route == "paged_attn":
        bs, t_len = 16, 16
        want = (m, 1, cfg.n_heads, cfg.hd)
        out = fn(t(want), t((m * t_len + 1, bs, cfg.n_kv_heads, cfg.hd)),
                 t((m * t_len + 1, bs, cfg.n_kv_heads, cfg.hd)), t((m, t_len), torch.int32),
                 t((m, 1), torch.int32))
    else:
        return f"no meta signature for route {route!r}"
    if tuple(out.shape) != want or out.dtype != f32:
        return f"output {tuple(out.shape)} {out.dtype}, want {want} float32"
    for g, a in zip(grads, ((m, k), (k, n), (k, n))):
        if tuple(g.shape) != a or g.dtype != f32:
            return f"gradient {tuple(g.shape)} {g.dtype}, want {a} float32"
    return None


# ---------------------------------------------------------------------------
# KCV006 / KCV007
# ---------------------------------------------------------------------------


def _key_findings(path: str, shape: tuple, where: str) -> List[Finding]:
    if path == autotune.PAGED_ATTN_PATH:
        key = autotune.paged_attn_cache_key(*shape, backend="cuda")
    else:
        key = autotune.cache_key(path, *shape, backend="cuda")
    parsed = autotune.parse_cache_key(key)
    if parsed is None or parsed["path"] != path or tuple(parsed["shape"]) != tuple(shape):
        return [_f("KCV006", where, f"cache key {key!r} does not round-trip to ({path!r}, "
                   f"{tuple(shape)})", "autotune.cache_key and parse_cache_key must stay "
                   "inverse", key=key)]
    return []


def _registry_findings() -> List[Finding]:
    from repro_torch.core.backend import LinearSpec, registered_backends
    from repro_torch.kernels import ops

    out: List[Finding] = []
    for name, backend in sorted(registered_backends().items()):
        for pack in (False, True):
            spec = LinearSpec(mode=name, pack_signs=pack)
            for phase in ("train", "serve"):
                route = backend.kernel_route(spec, phase)
                path = backend.autotune_path(spec, phase)
                where = f"backend:{name}/{phase}" + ("/packed" if pack else "")
                if (route is None) != (path is None):
                    out.append(_f("KCV006", where, f"kernel_route={route!r} but "
                                  f"autotune_path={path!r}", "define both or neither"))
                    continue
                if route is None:
                    continue
                if route not in ops.KERNEL_ROUTES:
                    out.append(_f("KCV006", where, f"kernel_route {route!r} not in "
                                  "KERNEL_ROUTES", "register the route in kernels/ops.py"))
                elif path not in ROUTE_INFO.get(route, {}).get("paths", ()):
                    out.append(_f("KCV006", where, f"autotune_path {path!r} is not a path "
                                  f"of route {route!r}", "fix the backend's autotune_path"))
                key = backend.autotune_key(spec, phase, 64, 128, 256, "cuda")
                if key != autotune.cache_key(path, 64, 128, 256, "cuda"):
                    out.append(_f("KCV006", where, f"autotune_key {key!r} disagrees with "
                                  f"cache_key({path!r})", "delegate to autotune.cache_key"))
    return out


def _cache_findings() -> List[Finding]:
    return [_f("KCV007", f"autotune-cache:{key}", f"invalid autotune cache entry: {reason}",
               "delete the entry (or the file at autotune.cache_path()); it was ignored at "
               "load, but something wrote it", key=key, reason=reason)
            for key, reason in autotune.invalid_cache_entries()]


# ---------------------------------------------------------------------------
# The pass
# ---------------------------------------------------------------------------


def _paged_cases(cfg):
    """Kernel 11 at the config's heads: decode (4 rows), the speculative
    verify (4 rows x 5 tokens) and a prefill chunk (1 row x 32 tokens)."""
    hq, hkv, d, bs = cfg.n_heads, cfg.n_kv_heads, cfg.hd, 16
    return {"decode": (4, 1, hq, hkv, d, bs, 16), "verify": (4, 5, hq, hkv, d, bs, 16),
            "chunk": (1, 32, hq, hkv, d, bs, 128)}


def run(archs=None, *, ptxas_log: Optional[str] = None, meta: bool = True,
        smem_budget: int = KERNEL_SMEM_BUDGET, sms: Optional[int] = None,
        max_blocks: Optional[Callable] = None) -> Report:
    """The pass over ``archs`` (every registered config by default).
    ``ptxas_log``: ``-Xptxas -v`` output of every source (KCV001's entry
    coverage and KCV004's register, spill and static shared memory checks).
    ``sms``: the card's SM count, which must be the 132 the plans assume;
    ``max_blocks(path, shape, plan)``: the card's occupancy for a plan (> 0
    where it fits), checked for every plan of the zoo."""
    from repro_torch.kernels import ops

    rep = Report(passes_run=[PASS])
    archs = list(archs) if archs is not None else list(ARCH_NAMES)

    for r in sorted(set(ops.KERNEL_ROUTES) - set(ROUTE_INFO)):
        rep.add(_f("KCV001", f"route:{r}", "KERNEL_ROUTES entry has no contract metadata",
                   "add a ROUTE_INFO entry"))
    for r in sorted(set(ROUTE_INFO) - set(ops.KERNEL_ROUTES)):
        rep.add(_f("KCV001", f"route:{r}", "contract metadata names a route that no longer "
                   "exists", "drop the stale ROUTE_INFO entry"))
    for c in sorted(ops._COUNTED):
        if COUNTED_PATHS.get(c) not in autotune.PATH_KERNELS:
            rep.add(_f("KCV001", f"kernel:{c}", "counted kernel has no autotune path",
                       "add it to COUNTED_PATHS and autotune.PATH_KERNELS"))
    if sms is not None and sms != H100["sms"]:
        rep.add(_f("KCV001", "device", f"the card has {sms} SMs; the plans and bounds assume "
                   f"{H100['sms']}", "a card of another size needs its own DEVICE_TERMS"))

    ptxas = parse_ptxas(ptxas_log) if ptxas_log else None
    ptxas_rows: List[dict] = []
    if ptxas is not None:
        fs, ptxas_rows = check_ptxas(ptxas, smem_budget=smem_budget)
        rep.findings.extend(fs)
        served = {kn for e in ptxas for kn in entry_kernels(e)}
        for kn in range(1, 12):
            if kn not in served:
                rep.add(_f("KCV001", f"kernel:{kn}", f"kernel {kn} has no entry function in "
                           "the ptxas log", "build every source with -Xptxas -v"))

    entries: List[Dict] = []
    for arch in archs:
        cfg = get_config(arch)
        gemms = config_gemms(cfg)
        for route, info in ROUTE_INFO.items():
            if route not in ops.KERNEL_ROUTES:
                continue
            w_dtype = info.get("w_dtype", "float32")
            if route == "paged_attn":
                cases = [(label, [("attn", shape)]) for label, shape in _paged_cases(cfg).items()]
            else:
                cases = [(label, [(gname, (m, k, n)) for gname, (k, n) in gemms.items()])
                         for label, m in M_CASES]
            for label, shapes in cases:
                worst, seen = None, []
                for gname, shape in shapes:
                    for path in info["paths"]:
                        where = f"{route}/{arch}/{label}/{gname}[{'x'.join(map(str, shape))}]"
                        if path == "bnn_packed" and shape[1] % 8:
                            continue  # served only at K % 8 == 0 (the backend pads K)
                        try:
                            fs, entry = check_plan(path, shape, where=where, w_dtype=w_dtype,
                                                   ptxas=ptxas, smem_budget=smem_budget)
                        except ValueError as e:  # a shape no plan takes
                            rep.add(_f("KCV002", where, f"no plan: {e}",
                                       "the route cannot launch this config's shape"))
                            continue
                        rep.findings.extend(fs)
                        rep.findings.extend(_key_findings(path, shape, where))
                        if max_blocks is not None and max_blocks(path, shape,
                                                                 entry["plan"]) <= 0:
                            rep.add(_f("KCV002", where, f"the card holds no block of plan "
                                       f"{entry['plan']!r}", "the plan rule and the card's "
                                       "occupancy disagree"))
                        seen.append(gname)
                        if worst is None or entry["smem_bytes"] > worst["smem_bytes"]:
                            worst = dict(entry, gemm=gname)
                if worst is None:
                    continue
                worst.update(route=route, arch=arch, case=label, gemms=sorted(set(seen)))
                entries.append(worst)
            if meta:
                k, n = max(gemms.values(), key=lambda kn: kn[0] * kn[1]) \
                    if route != "paged_attn" else (0, 0)
                if route in ("cac_hw", "bnn_packed") and k % 8:
                    k += 8 - k % 8
                err = _meta_eval(route, 4, k, n, cfg)
                if err:
                    rep.add(_f("KCV005", f"{route}/{arch}", f"meta evaluation: {err}",
                               "the route's shape/dtype contract broke: run its parity tests"))
    rep.findings.extend(_registry_findings())
    rep.findings.extend(_cache_findings())

    covered = {(e["route"], e["arch"]) for e in entries}
    expected = {(r, a) for r in ops.KERNEL_ROUTES for a in archs}
    for route, arch in sorted(expected - covered):
        rep.add(_f("KCV001", f"{route}/{arch}", "route x config pair produced no contract "
                   "entry", "the checker must cover every KERNEL_ROUTES x config pair"))
    rep.data[PASS] = {
        "n_routes": len(ops.KERNEL_ROUTES),
        "n_archs": len(archs),
        "coverage": f"{len(covered & expected)}/{len(expected)}",
        "smem_budget": int(smem_budget),
        "entries": entries,
        "ptxas": ptxas_rows,
        "invalid_cache_entries": [{"key": k, "reason": r}
                                  for k, r in autotune.invalid_cache_entries()],
    }
    return rep
