"""Launch-plan resolution for the port's kernel wrappers, with a measured
search and an on-disk cache (port of ``repro/kernels/autotune.py``).

Every wrapper in ``cac_matmul.py``, ``bnn_matmul.py``, ``qnn_matmul.py`` and
``paged_attn.py`` takes its plan from ``get_plan`` (``get_paged_plan`` for
kernel 11), one resolution point, in this order:

  1. an explicit override (the wrapper's ``plan=``; sweeps and tests);
  2. a valid entry of the measured cache, keyed ``backend:path:MxKxN``;
  3. the plan rule of today: the ``card_*_plan`` functions under the
     card's SM count and occupancy (``heuristic_plan`` off the card).

With no cache entry and no override the wrapper launches exactly the plan
it launched before the cache existed.

Paths (the reference's names where they mean the same):

  hw_fwd        kernel 1, the served CAC: (mt, splits, groups_per_split)
  train_fwd     kernel 2: (splits, slices_per_split)
  train_bwd     kernels 5 and 3, one plan: the cluster size, so a split
                step's dx equals a fused step's bit for bit
  train_bwd_dw  kernel 4: (nt, parts)
  bnn           kernel 6: ("stream", mt, splits, groups) or ("tc", bn,
                splits, k_per_split); one entry serves both weight dtypes
  bnn_packed    kernel 7: (mt, splits, groups_per_split)
  bnn_bwd       kernels 8 (dx) and 9 (dw): (bn, splits, t_per_split) each
  qnn8          kernel 10: ("stream", mt, splits, groups) or ("tile",)
  paged_attn    kernel 11: (q_tile, splits), keyed on the serving shape

``plan_error`` (``geometry``) says which plans a launcher accepts.
``measured_plan`` times every plan the launcher accepts at a shape and the
card's occupancy holds (CUDA events, L2 flushed, the median), holds each
candidate's output against the default plan's, and stores the fastest. A
legal candidate that fails to launch raises; nothing is skipped.

The cache is ``REPRO_TORCH_AUTOTUNE_CACHE`` or
``~/.cache/repro/autotune_torch.json``: never the reference's file, whose
loader would reject the port's plan fields.
"""
from __future__ import annotations

import functools
import json
import os
import re
import statistics
import threading
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.hwsim import DEVICE_TERMS

from . import geometry
from .geometry import PAGED_ATTN_PATH, plan_error

__all__ = [
    "PATH_KERNELS",
    "cache_key",
    "cache_path",
    "candidate_plans",
    "card_max_blocks",
    "card_plan",
    "clear_cache",
    "default_backend",
    "fields_to_plan",
    "get_paged_plan",
    "get_plan",
    "heuristic_plan",
    "invalid_cache_entries",
    "measured_paged_search",
    "measured_plan",
    "measured_search",
    "paged_attn_cache_key",
    "parse_cache_key",
    "plan_error",
    "plan_to_fields",
    "validate_cache_entry",
]

# path -> the kernels (numbered as in ROADMAP Queue 2) whose plan it resolves
PATH_KERNELS: Dict[str, Tuple[int, ...]] = {
    "hw_fwd": (1,),
    "train_fwd": (2,),
    "train_bwd": (3, 5),
    "train_bwd_dw": (4,),
    "bnn": (6,),
    "bnn_packed": (7,),
    "bnn_bwd": (8, 9),
    "qnn8": (10,),
    "paged_attn": (11,),
}
# the most splits or cluster ranks any launcher takes: the search's
# enumeration stops there, and plan_error keeps what each launcher accepts
_MAX_SPLITS = DEVICE_TERMS["h100_sxm"]["cluster_nonportable"]


def default_backend() -> str:
    """``cuda`` where a card is present, else ``cpu``: the backend field of
    a key that names none."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def cache_path() -> str:
    return os.environ.get(
        "REPRO_TORCH_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro", "autotune_torch.json"),
    )


def cache_key(path: str, m: int, k: int, n: int, backend: Optional[str] = None) -> str:
    """``backend:path:MxKxN``, the reference's key form."""
    return f"{backend or default_backend()}:{path}:{m}x{k}x{n}"


def paged_attn_cache_key(b: int, c: int, hq: int, hkv: int, d: int, bs: int, t: int,
                         backend: Optional[str] = None) -> str:
    """The reference's paged form ``backend:paged_attn:SxLxBxDxH`` (slots,
    max_len = t * bs, block size, head dim, kv heads), followed by the two
    further fields the port's plan depends on: ``xCxQ`` (query tokens a row
    and query heads)."""
    return (f"{backend or default_backend()}:{PAGED_ATTN_PATH}:"
            f"{b}x{t * bs}x{bs}x{d}x{hkv}x{c}x{hq}")


_MATMUL_KEY_RE = re.compile(r"^([A-Za-z0-9_]+):([A-Za-z0-9_]+):(\d+)x(\d+)x(\d+)$")
_PAGED_KEY_RE = re.compile(
    r"^([A-Za-z0-9_]+):paged_attn:(\d+)x(\d+)x(\d+)x(\d+)x(\d+)x(\d+)x(\d+)$")


def parse_cache_key(key: str) -> Optional[Dict[str, object]]:
    """``{"backend", "path", "shape"}``: shape (m, k, n) for a matmul key,
    (b, c, hq, hkv, d, bs, t) for a paged key; None for anything else."""
    got = _PAGED_KEY_RE.match(key)
    if got:
        s, length, bs, d, hkv, c, hq = (int(v) for v in got.groups()[1:])
        if bs < 1 or length % bs:
            return None
        return {"backend": got.group(1), "path": PAGED_ATTN_PATH,
                "shape": (s, c, hq, hkv, d, bs, length // bs)}
    got = _MATMUL_KEY_RE.match(key)
    if got and got.group(2) in PATH_KERNELS and got.group(2) != PAGED_ATTN_PATH:
        return {"backend": got.group(1), "path": got.group(2),
                "shape": tuple(int(v) for v in got.groups()[2:])}
    return None


# ---------------------------------------------------------------------------
# Plans as cache entries
# ---------------------------------------------------------------------------

_STREAM_FIELDS = ("mt", "splits", "per")
_FIELDS = {
    "hw_fwd": _STREAM_FIELDS,
    "train_fwd": ("splits", "per"),
    "train_bwd": ("cluster",),
    "train_bwd_dw": ("nt", "parts"),
    "bnn_packed": _STREAM_FIELDS,
    "bnn_bwd": ("dx_bn", "dx_splits", "dx_per", "dw_bn", "dw_splits", "dw_per"),
    "paged_attn": ("q_tile", "splits"),
}
_ROUTE_FIELDS = {  # the paths with a route: its name, then its fields
    "bnn": {"stream": _STREAM_FIELDS, "tc": ("bn", "splits", "per")},
    "qnn8": {"stream": _STREAM_FIELDS, "tile": ()},
}


def _fields(path: str, fields: dict) -> Tuple[str, ...]:
    if path in _ROUTE_FIELDS:
        routes = _ROUTE_FIELDS[path]
        if fields.get("route") not in routes:
            raise ValueError(f"{path} plan needs a route in {sorted(routes)}")
        return ("route",) + routes[fields["route"]]
    return _FIELDS[path]


def plan_to_fields(path: str, plan) -> Dict[str, object]:
    """A plan as the wrapper takes it -> the cache entry's fields. For
    ``bnn_bwd`` the plan is ``{"dx": (bn, splits, per), "dw": (...)}``."""
    if path == "bnn_bwd":
        return {f"{half}_{f}": int(v) for half in ("dx", "dw")
                for f, v in zip(("bn", "splits", "per"), plan[half])}
    if path == "train_bwd":
        return {"cluster": int(plan)}
    if path in _ROUTE_FIELDS:
        names = _ROUTE_FIELDS[path][plan[0]]
        return dict({"route": plan[0]}, **{f: int(v) for f, v in zip(names, plan[1:])})
    return {f: int(v) for f, v in zip(_FIELDS[path], plan)}


def fields_to_plan(path: str, fields: dict, want_dx: Optional[bool] = None):
    """A cache entry's fields -> the plan the wrapper takes (for
    ``bnn_bwd`` the half of ``want_dx``, or both as a dict when None)."""
    if path == "bnn_bwd":
        halves = {h: tuple(fields[f"{h}_{f}"] for f in ("bn", "splits", "per"))
                  for h in ("dx", "dw")}
        return halves if want_dx is None else halves["dx" if want_dx else "dw"]
    if path == "train_bwd":
        return fields["cluster"]
    names = _fields(path, fields)
    return tuple(fields[f] for f in names)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def validate_cache_entry(key: str, fields) -> Optional[str]:
    """None when (key, fields) is a well-formed cache entry whose plan the
    launcher accepts at the shape the key itself encodes; else why not."""
    parsed = parse_cache_key(key)
    if parsed is None:
        return "unparseable key (expected backend:path:MxKxN or the paged form)"
    path = parsed["path"]
    if not isinstance(fields, dict) or not fields:
        return "entry is not a non-empty dict of plan fields"
    try:
        names = _fields(path, fields)
    except ValueError as e:
        return str(e)
    if set(fields) != set(names):
        return (f"plan fields {sorted(fields)} are not those of path {path!r}: "
                f"{sorted(names)}")
    for f, v in fields.items():
        if f != "route" and (isinstance(v, bool) or not isinstance(v, int) or v < 1):
            return f"{f}={v!r} is not a positive int"
    reason = plan_error(path, parsed["shape"], fields_to_plan(path, fields))
    return None if reason is None else f"plan illegal at {parsed['shape']}: {reason}"


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------

_cache_lock = threading.Lock()
_cache: Optional[Dict[str, dict]] = None
_invalid: List[Tuple[str, str]] = []  # (key, reason) of the last load's rejects


def _load_cache() -> Dict[str, dict]:
    global _cache
    with _cache_lock:
        if _cache is None:
            _invalid.clear()
            try:
                with open(cache_path()) as fh:
                    raw = json.load(fh)
            except (OSError, ValueError):
                raw = {}
            if not isinstance(raw, dict):
                raw = {}
            _cache = {}
            for key, fields in raw.items():
                reason = validate_cache_entry(key, fields)
                if reason is None:
                    _cache[key] = dict(fields)
                else:
                    _invalid.append((key, reason))
        return _cache


def _store_cache(key: str, fields: dict) -> None:
    global _cache
    _load_cache()  # merge into what is on disk
    with _cache_lock:
        cur = dict(_cache or {})
        cur[key] = dict(fields)
        _cache = cur
        f = cache_path()
        os.makedirs(os.path.dirname(os.path.abspath(f)), exist_ok=True)
        tmp = f + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(cur, fh, indent=1, sort_keys=True)
        os.replace(tmp, f)


def invalid_cache_entries() -> List[Tuple[str, str]]:
    """(key, reason) for every on-disk entry the last load rejected."""
    _load_cache()
    with _cache_lock:
        return list(_invalid)


def clear_cache() -> None:
    """Drop the in-memory cache (the next lookup reads the file again; the
    file is not touched)."""
    global _cache
    with _cache_lock:
        _cache = None


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------


def _plan_rules() -> Dict[str, object]:
    """``{path: rule(index, m, k, n, w_dtype, want_dx, route)}``, today's
    plan rule of each matmul path (``index`` None: off the card), and
    kernel 11's ``paged_attn.attn_plan`` (the compiled kernel's own rule,
    which needs no card); built on the first resolution (the kernel modules
    import this one)."""
    global _bnn_int8_max_m
    if _rules:
        return _rules
    from . import bnn_matmul as bnn
    from . import cac_matmul as cac
    from . import paged_attn as pa
    from . import qnn_matmul as qnn

    def bnn_fwd(i, m, k, n, w_dtype, want_dx, route):
        w_dtype = _w_dtype(m, w_dtype)
        return (bnn.fwd_plan(m, k, n, w_dtype, route=route) if i is None else
                bnn._card_fwd_plan(i, m, k, n, w_dtype, route))

    def bnn_bwd(i, m, k, n, w_dtype, want_dx, route):
        def half(dx):
            return bnn.bwd_plan(m, k, n, dx) if i is None else bnn._card_plan(i, m, k, n, dx)

        return {"dx": half(True), "dw": half(False)} if want_dx is None else half(want_dx)

    def rule(card, off):
        return lambda i, m, k, n, *_: off(m, k, n) if i is None else card(i, m, k, n)

    _rules.update({
        "hw_fwd": rule(cac.card_stream_plan, cac.stream_plan),
        "train_fwd": rule(cac.card_train_fwd_plan, cac.train_fwd_plan),
        "train_bwd": rule(cac.card_train_bwd_plan, cac.train_bwd_plan),
        "train_bwd_dw": rule(cac.card_train_bwd_dw_plan, cac.train_bwd_dw_plan),
        "bnn": bnn_fwd,
        "bnn_packed": rule(
            lambda i, m, k, n: cac.card_stream_plan(i, m, k, n, "bnn_matmul",
                                                    "packed_max_blocks", bnn.PACKED_MT),
            lambda m, k, n: cac.stream_plan(m, k, n, mt=bnn.PACKED_MT)),
        "bnn_bwd": bnn_bwd,
        "qnn8": lambda i, m, k, n, w_dtype, want_dx, route: (
            qnn.qnn_plan(m, k, n, route=route) if i is None else
            qnn._card_plan(i, m, k, n, route)),
        PAGED_ATTN_PATH: pa.attn_plan,
    })
    _bnn_int8_max_m = bnn.FWD_STREAM_MAX_M[torch.int8]
    return _rules


_rules: Dict[str, object] = {}
_bnn_int8_max_m = 0


def _w_dtype(m: int, w_dtype):
    """Kernel 6's weight dtype where the caller names none: int8 signs up
    to the serve path's M, float32 (the training forward) above."""
    if w_dtype is not None:
        return w_dtype
    _plan_rules()
    return torch.int8 if m <= _bnn_int8_max_m else torch.float32


def card_plan(path: str, m: int, k: int, n: int, index: Optional[int], *, w_dtype=None,
              want_dx: Optional[bool] = None, route: Optional[str] = None):
    """Today's plan rule: on card ``index`` the ``card_*`` plan functions
    (its SM count and occupancy); with ``index`` None the plan functions'
    defaults (two blocks an SM of 132), ``heuristic_plan``. ``bnn`` takes
    ``w_dtype`` and ``route``, ``qnn8`` ``route``, ``bnn_bwd`` ``want_dx``
    (both halves as a dict when None)."""
    if path not in PATH_KERNELS or path == PAGED_ATTN_PATH:
        raise ValueError(f"unknown matmul path {path!r}; known: "
                         f"{sorted(p for p in PATH_KERNELS if p != PAGED_ATTN_PATH)}")
    return _plan_rules()[path](index, m, k, n, w_dtype, want_dx, route)


def heuristic_plan(path: str, m: int, k: int, n: int, **kw):
    """Today's plan rule off the card (the reference's name for it):
    ``card_plan`` with no card."""
    return card_plan(path, m, k, n, None, **kw)


def _override(path: str, shape: tuple, overrides, want_dx=None):
    plan = fields_to_plan(path, overrides, want_dx) if isinstance(overrides, dict) \
        else overrides
    if path == "bnn_bwd" and want_dx is not None and not isinstance(plan, dict):
        other = heuristic_plan(path, *shape, want_dx=not want_dx)
        check = {"dx": plan, "dw": other} if want_dx else {"dx": other, "dw": plan}
    else:
        check = plan
    reason = plan_error(path, shape, check)
    if reason is not None:
        raise ValueError(f"{path} plan {plan!r} at {shape}: {reason}")
    return plan


def get_plan(path: str, m: int, k: int, n: int, index: Optional[int] = None,
             overrides=None, *, w_dtype=None, want_dx: Optional[bool] = None,
             route: Optional[str] = None):
    """The plan a wrapper launches for ``path`` at (m, k, n) on card
    ``index``: ``overrides`` (a plan, or its cache fields) if given, else a
    valid cache entry, else ``card_plan`` (``heuristic_plan`` and the
    ``cpu`` key where ``index`` is None). A forced ``route`` (kernels 6 and
    10) passes over a cached plan of the other route."""
    if overrides is not None:
        return _override(path, (m, k, n), overrides, want_dx)
    cache = _cache if _cache is not None else _load_cache()
    if cache:
        hit = cache.get(cache_key(path, m, k, n, "cpu" if index is None else "cuda"))
        if hit is not None and (route is None or hit.get("route") == route):
            return fields_to_plan(path, hit, want_dx)
    return card_plan(path, m, k, n, index, w_dtype=w_dtype, want_dx=want_dx, route=route)


def get_paged_plan(b: int, c: int, hq: int, hkv: int, d: int, bs: int, t: int,
                   index: Optional[int] = None, overrides=None) -> Tuple[int, int]:
    """(q_tile, splits) for one paged-attention call: ``overrides``, else a
    valid cache entry, else ``paged_attn.attn_plan`` (the compiled kernel's
    own rule, which needs no card). An override goes to
    the launcher as given, which refuses one it does not take (the sweeps
    rely on that)."""
    shape = (b, c, hq, hkv, d, bs, t)
    if overrides is not None:
        return fields_to_plan(PAGED_ATTN_PATH, overrides) if isinstance(overrides, dict) \
            else tuple(int(v) for v in overrides)
    cache = _cache if _cache is not None else _load_cache()
    if cache:
        hit = cache.get(paged_attn_cache_key(*shape, backend="cpu" if index is None else "cuda"))
        if hit is not None:
            return fields_to_plan(PAGED_ATTN_PATH, hit)
    return _plan_rules()[PAGED_ATTN_PATH](*shape)


# ---------------------------------------------------------------------------
# Measured search (on the card)
# ---------------------------------------------------------------------------

# how far a candidate's output may sit from the default plan's: 0 (bit-equal)
# where the outputs are integers, the STE backward's 1e-4 (atol = rtol) and
# the online softmax's 2e-5
TOLERANCE = {"hw_fwd": 0.0, "train_fwd": 0.0, "bnn": 0.0, "bnn_packed": 0.0, "qnn8": 0.0,
             "train_bwd": 1e-4, "train_bwd_dw": 1e-4, "bnn_bwd": 1e-4, "paged_attn": 2e-5}
SPIN_CYCLES = 1_000_000  # ~0.5 ms: keeps the card busy while the host enqueues a call
timed_calls = 0  # calls timed by the searches of this process (a resolution times none)


@functools.lru_cache(maxsize=None)
def _occupancy(index: int, query: str, *args) -> int:
    """One occupancy query of card ``index``, once per argument set."""
    from . import bnn_matmul as bnn
    from . import cac_matmul as cac
    from . import paged_attn as pa

    if query == "stream":  # (mt, splits, source, symbol)
        return cac.card_stream_max_blocks(index, *args)
    if query == "product":  # (mode, bn, splits)
        return bnn.card_max_blocks(index, *args)
    with torch.cuda.device(index):
        if query == "paged":
            return pa.card_max_blocks(*args)
        return cac._train_lib(query)(*args)


def card_max_blocks(path: str, shape: tuple, plan, index: int = 0, *,
                    quantized: bool = False) -> int:
    """Blocks of ``plan`` at ``shape`` that card ``index`` keeps resident at
    once (its occupancy queries: clusters x their size); 0 or less where
    not one cluster fits. For ``bnn_bwd`` the least of the plan's halves."""
    from . import bnn_matmul as bnn

    if path == PAGED_ATTN_PATH:
        return _occupancy(index, "paged", *shape, bool(quantized), *plan)
    m = shape[0]
    sources = {"hw_fwd": ("cac_matmul", "stream_max_blocks"),
               "bnn_packed": ("bnn_matmul", "packed_max_blocks"),
               "bnn": ("bnn_matmul", "stream_max_blocks"),
               "qnn8": ("qnn_matmul", "stream_max_blocks")}
    if path in ("hw_fwd", "bnn_packed"):
        return _occupancy(index, "stream", plan[0], plan[1], *sources[path])
    if path in ("bnn", "qnn8"):
        if plan[0] == "tile":  # kernel 10's tile route: no cluster
            return 1
        if plan[0] == "tc":
            return _occupancy(index, "product", bnn.FWD_MODE, plan[1], plan[2])
        return _occupancy(index, "stream", plan[1], plan[2], *sources[path])
    if path == "bnn_bwd":
        return min(_occupancy(index, "product", int(h == "dx"), p[0], p[1])
                   for h, p in plan.items())
    if path == "train_fwd":
        return _occupancy(index, "cac_train_fwd_max_blocks", plan[0])
    if path == "train_bwd":  # kernels 5 and 3 take the same cluster
        return min(_occupancy(index, f"cac_train_bwd_{x}_max_blocks", plan, m)
                   for x in ("fused", "dx"))
    if path == "train_bwd_dw":
        return _occupancy(index, "cac_train_bwd_dw_max_blocks", plan[0], m)
    raise ValueError(f"unknown path {path!r}")


def _cuts(units: int, most: int):
    """(splits, per): every distinct cut of ``units`` into at most ``most``
    ranges of ``per``, none empty."""
    return [(s, _cdiv(units, s)) for s in range(1, min(most, units) + 1)
            if _cdiv(units, _cdiv(units, s)) == s]


def candidate_plans(path: str, m: int, k: int, n: int, index: int = 0, *, w_dtype=None):
    """Every plan of ``path`` at (m, k, n) that the launcher accepts and
    card ``index``'s occupancy query holds (for ``bnn_bwd``: ``{"dx": [...],
    "dw": [...]}``): stream splits at both row tiles, kernel 2's split
    counts, kernel 5's cluster sizes, kernel 4's column widths, the product
    template's tile widths and splits, kernel 10's tile route. Filtered by
    that legality before anything is timed."""
    from . import bnn_matmul as bnn
    from . import cac_matmul as cac

    shape = (m, k, n)
    stream = [(mt, s, per) for mt in cac.STREAM_MT
              for s, per in _cuts(_cdiv(k, cac.STREAM_GROUP), _MAX_SPLITS)]

    def product(t):
        return [(bn, s, per * bnn.BWD_STAGE) for bn in bnn.BWD_TILE_COLS
                for s, per in _cuts(_cdiv(t, bnn.BWD_STAGE), _MAX_SPLITS)]

    def legal(plans, half=None):
        return [p for p in plans
                if plan_error(path, shape, {half: p} if half else p) is None
                and card_max_blocks(path, shape, {half: p} if half else p, index) > 0]

    if path == "bnn_bwd":
        return {"dx": legal(product(n), "dx"), "dw": legal(product(m), "dw")}
    out = {
        "hw_fwd": stream,
        "bnn_packed": stream,
        "train_fwd": _cuts(_cdiv(k, cac.TRAIN_FWD_SLICE), _MAX_SPLITS),
        "train_bwd": list(range(1, _MAX_SPLITS + 1)),
        "train_bwd_dw": [(nt, _cdiv(n, 8 * nt)) for nt in sorted(geometry.DW_COLUMNS,
                                                                reverse=True)],
        "bnn": [("stream",) + p for p in stream] + [("tc",) + p for p in product(k)],
        "qnn8": [("stream",) + p for p in stream] + [("tile",)],
    }.get(path)
    if out is None:
        raise ValueError(f"unknown matmul path {path!r}")
    return legal(out)


def _time_ms(fn, flush, iters: int, warmup: int) -> float:
    """Median device ms of ``fn`` from CUDA events, L2 overwritten before
    every call and a spin kernel ahead of the first event."""
    global timed_calls
    timed_calls += 1
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _max_err(got, want) -> float:
    if isinstance(got, (tuple, list)):
        return max(_max_err(g, w) for g, w in zip(got, want))
    return float((got - want).abs().max()) if got.numel() else 0.0


def _held(got, want, tol: float) -> bool:
    if isinstance(got, (tuple, list)):
        return all(_held(g, w, tol) for g, w in zip(got, want))
    if tol == 0.0:
        return torch.equal(got, want)
    return bool(torch.allclose(got, want, rtol=tol, atol=tol))


def _operands(path, m, k, n, device, seed, w_dtype):
    """The search's inputs, from ``seed``: the wrapper's dtypes at (m, k, n)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=device).to(torch.int8)

    if path == "hw_fwd":
        return (codes(m, k), codes(k, n),
                torch.randint(0, 256, (k // 8, n), generator=gen, device=device).to(torch.uint8))
    if path == "bnn_packed":
        return (normal(m, k),
                torch.randint(0, 256, (k // 8, n), generator=gen, device=device).to(torch.uint8))
    if path == "bnn":
        w = normal(k, n)
        return normal(m, k), (torch.where(w >= 0, 1, -1).to(torch.int8)
                              if _w_dtype(m, w_dtype) == torch.int8 else w)
    if path == "qnn8":
        return codes(m, k), codes(k, n), normal(n).abs() / 127 + 1e-3, 0.05
    if path == "bnn_bwd":
        return normal(m, k), normal(k, n), normal(m, n)
    # the training CAC: x w + beta near the STE window, g of either sign
    return normal(m, k), normal(k, n, scale=0.5), normal(k, n, scale=0.5), normal(m, n)


def _runners(path, ops):
    """``{kernel label: fn(plan) -> output}`` of the kernels ``path`` plans."""
    from . import bnn_matmul as bnn
    from . import cac_matmul as cac
    from . import qnn_matmul as qnn

    if path == "hw_fwd":
        return {"cac_matmul": lambda p: cac.cac_matmul_kernel_call(*ops, plan=p)}
    if path == "train_fwd":
        return {"cac_train_fwd": lambda p: cac.cac_train_fwd_call(*ops[:3], plan=p)}
    if path == "train_bwd":
        return {"cac_train_bwd_fused": lambda p: cac.cac_train_bwd_fused_call(*ops, plan=p),
                "cac_train_bwd_dx": lambda p: cac.cac_train_bwd_dx_call(*ops, plan=p)}
    if path == "train_bwd_dw":
        return {"cac_train_bwd_dw": lambda p: cac.cac_train_bwd_dw_call(*ops, plan=p)}
    if path == "bnn":
        return {"bnn_matmul": lambda p: bnn.bnn_matmul_kernel_call(*ops, plan=p)}
    if path == "bnn_packed":
        return {"bnn_packed_matmul": lambda p: bnn.bnn_packed_matmul_kernel_call(*ops, plan=p)}
    if path == "bnn_bwd":
        return {"bnn_bwd_dx": lambda p: bnn.bnn_bwd_dx_call(*ops, plan=p),
                "bnn_bwd_dw": lambda p: bnn.bnn_bwd_dw_call(*ops, plan=p)}
    if path == "qnn8":
        return {"qnn_matmul": lambda p: qnn.qnn_matmul_kernel_call(*ops, plan=p)}
    raise ValueError(f"unknown matmul path {path!r}")


def _search(label, candidates, default, runners, tol, flush, iters, warmup,
            same_dx=False):
    """Time every candidate of one plan (all of ``runners`` launch with it),
    hold its outputs against the default plan's. Returns the rows and the
    winner; raises where an output does not hold."""
    want = {name: run(default) for name, run in runners.items()}
    rows = []
    for cand in candidates:
        outs = {name: run(cand) for name, run in runners.items()}
        for name, out in outs.items():
            if not _held(out, want[name], tol):
                raise RuntimeError(f"{label}: plan {cand!r} of {name} is "
                                   f"{_max_err(out, want[name]):.3g} from the default plan "
                                   f"{default!r}, past {tol}")
        if same_dx:  # kernels 3 and 5 at one cluster size: dx bit for bit
            if not torch.equal(outs["cac_train_bwd_dx"], outs["cac_train_bwd_fused"][0]):
                raise RuntimeError(f"{label}: kernel 3's dx differs from kernel 5's at "
                                   f"cluster {cand}")
        ms = sum(_time_ms(lambda: run(cand), flush, iters, warmup) for run in runners.values())
        rows.append({"plan": cand, "ms": ms,
                     "max_abs_err": max(_max_err(outs[nm], want[nm]) for nm in outs)})
    if not rows:
        raise RuntimeError(f"{label}: no legal candidate plan")
    default_rows = [r for r in rows if r["plan"] == default]
    default_ms = (default_rows[0]["ms"] if default_rows else
                  sum(_time_ms(lambda: run(default), flush, iters, warmup)
                      for run in runners.values()))
    best = min(rows, key=lambda r: r["ms"])
    return {"candidates": rows, "default": default, "default_ms": default_ms,
            "winner": best["plan"], "winner_ms": best["ms"], "tolerance": tol,
            "held": True}


def measured_search(path: str, m: int, k: int, n: int, *, candidates=None,
                    iters: int = 10, warmup: int = 2, seed: int = 0, index: int = 0,
                    w_dtype=None) -> dict:
    """``measured_plan``'s search with its record: every candidate's median
    ms and its largest distance from the default plan's output, the default
    plan and its ms, the winner and its ms. Stores the winner in the cache
    and reports it on the tracer's ``autotune`` track."""
    device = torch.device("cuda", index)
    ops = _operands(path, m, k, n, device, seed, w_dtype)
    flush = torch.empty(2 * (50 << 20) // 4, dtype=torch.float32, device=device)
    runners = _runners(path, ops)
    tol = TOLERANCE[path]
    label = f"{path}:{m}x{k}x{n}"
    default = card_plan(path, m, k, n, index, w_dtype=w_dtype)
    cands = candidate_plans(path, m, k, n, index, w_dtype=w_dtype) if candidates is None \
        else candidates
    if path == "bnn_bwd":
        halves = {h: _search(f"{label} {h}", cands[h], default[h],
                             {f"bnn_bwd_{h}": runners[f"bnn_bwd_{h}"]}, tol, flush, iters,
                             warmup) for h in ("dx", "dw")}
        record = {"halves": halves, "default": default,
                  "default_ms": sum(h["default_ms"] for h in halves.values()),
                  "winner": {h: halves[h]["winner"] for h in halves},
                  "winner_ms": sum(h["winner_ms"] for h in halves.values()),
                  "candidates": [dict(r, half=h) for h in halves
                                 for r in halves[h]["candidates"]],
                  "tolerance": tol, "held": True}
    else:
        record = _search(label, [tuple(c) if isinstance(c, list) else c for c in cands],
                         default, runners, tol, flush, iters, warmup,
                         same_dx=path == "train_bwd")
    del flush
    record.update(path=path, shape=[m, k, n], key=cache_key(path, m, k, n, "cuda"))
    _store_cache(record["key"], plan_to_fields(path, record["winner"]))
    _trace_search(label, record)
    return record


def measured_plan(path: str, m: int, k: int, n: int, *, candidates=None, iters: int = 10,
                  warmup: int = 2, seed: int = 0, index: int = 0, w_dtype=None):
    """Time every legal plan of ``path`` at (m, k, n) on card ``index``,
    hold each output against the default plan's, store the fastest in the
    cache and return it (for ``bnn_bwd`` ``{"dx": ..., "dw": ...}``): the
    reference's entry point, ``measured_search`` without its record."""
    return measured_search(path, m, k, n, candidates=candidates, iters=iters, warmup=warmup,
                           seed=seed, index=index, w_dtype=w_dtype)["winner"]


def measured_paged_search(b: int, c: int, hq: int, hkv: int, d: int, bs: int, t: int, *,
                          quantized: bool = False, candidates=None, iters: int = 10,
                          warmup: int = 2, seed: int = 0, index: int = 0) -> dict:
    """``measured_search`` for kernel 11 at one serving shape: every (q_tile,
    splits) the launcher accepts and the card holds, on a seeded pool whose
    rows sit at the end of their tables, held within 2e-5 of the default."""
    from . import paged_attn as pa

    device = torch.device("cuda", index)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_phys = b * t + 1
    q = torch.randn((b, c, hq, d), generator=gen, device=device)
    pool = [torch.randn((n_phys, bs, hkv, d), generator=gen, device=device) for _ in range(2)]
    scales = {}
    if quantized:
        scales = {"k_scale": pool[0].abs().amax(-1, keepdim=True) / 127,
                  "v_scale": pool[1].abs().amax(-1, keepdim=True) / 127}
        pool = [torch.round(p / s).clamp(-127, 127).to(torch.int8)
                for p, s in zip(pool, scales.values())]
    tables = torch.randperm(b * t, generator=gen, device=device).to(torch.int32).reshape(b, t)
    q_pos = (t * bs - c + torch.arange(c, device=device, dtype=torch.int32)).expand(b, c)
    q_pos = q_pos.contiguous()
    shape = (b, c, hq, hkv, d, bs, t)
    if candidates is None:
        candidates = [(qt, s) for qt in range(1, min(pa.MAX_QTILE, c) + 1)
                      for s in range(1, min(_MAX_SPLITS, t) + 1)
                      if plan_error(PAGED_ATTN_PATH, shape, (qt, s)) is None
                      and card_max_blocks(PAGED_ATTN_PATH, shape, (qt, s), index,
                                          quantized=quantized) > 0]
    runners = {"paged_attn": lambda p: pa.paged_attn_kernel_call(
        q, pool[0], pool[1], tables, q_pos, plan=p, **scales)}
    flush = torch.empty(2 * (50 << 20) // 4, dtype=torch.float32, device=device)
    label = f"{PAGED_ATTN_PATH}:{b}x{c}x{hq}x{hkv}x{d}x{bs}x{t}"
    record = _search(label, candidates, pa.attn_plan(*shape), runners,
                     TOLERANCE[PAGED_ATTN_PATH], flush, iters, warmup)
    del flush
    record.update(path=PAGED_ATTN_PATH, shape=list(shape),
                  key=paged_attn_cache_key(*shape, backend="cuda"))
    _store_cache(record["key"], plan_to_fields(PAGED_ATTN_PATH, record["winner"]))
    _trace_search(label, record)
    return record


def _trace_search(shape_key: str, record: dict) -> None:
    """One ``autotune`` event on the process tracer's ``autotune`` track
    (``obs.trace.set_tracer``), with every candidate's ms."""
    from repro_torch.obs.trace import get_tracer

    tracer = get_tracer()
    if not tracer.enabled:
        return
    tracer.event("autotune", track="autotune", shape=shape_key,
                 winner=plan_to_fields(record["path"], record["winner"]),
                 best_ms=record["winner_ms"], default_ms=record["default_ms"],
                 n_candidates=len(record["candidates"]),
                 candidates=[{"plan": repr(r["plan"]), "ms": r["ms"]}
                             for r in record["candidates"]])
