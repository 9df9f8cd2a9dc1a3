"""Pass 1 — AST lints for PyTorch/CUDA serving and training pitfalls (the
port's twin of ``repro/analysis/lints.py``; stdlib only).

Rules (each fires a :class:`~repro_torch.analysis.report.Finding` with a
code, a message and a fix hint). The codes are the reference's, so one
``# repro: noqa-RPA001`` comment serves both packages' linters:

  RPA001  a host sync in per-tick code or in a ``torch.autograd.Function``'s
          ``forward``/``backward``: ``.item()``, ``.tolist()``, ``.cpu()``,
          ``.numpy()``, ``.to("cpu")``, ``np.asarray``/``np.array`` of a
          (possible) tensor, ``float``/``int``/``bool`` of a call or of a
          tensor expression, and ``torch.cuda.synchronize()``. Each one waits for the card and
          stalls the stream of launches behind it.
  RPA002  ``torch.compile``, ``torch.cuda.CUDAGraph()`` /
          ``torch.cuda.graph(...)``, ``build.load`` or ``ctypes.CDLL`` made
          inside a ``for``/``while`` loop: every iteration compiles, captures
          or loads afresh.
  RPA003  a Python branch (``if``/``while``/ternary) on a tensor expression
          in per-tick code: a tensor's truth value is a hidden sync.
  RPA004  dict-ordering-dependent key construction: ``tuple(d.items())`` /
          ``list(d.items())`` without ``sorted``, or ``json.dump(s)``
          without ``sort_keys=True``.
  RPA005  a timed region (two or more ``time.perf_counter``/``time.time``/
          ``time.monotonic`` calls in one function) that launches torch work
          but never waits for it: no ``torch.cuda.synchronize()``, no CUDA
          event's ``synchronize``/``elapsed_time``, no call that syncs
          (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``). It times the
          launches, not the device.

Suppression: append ``# repro: noqa-RPA001`` (or ``# noqa: RPA001``, or a
blanket ``# repro: noqa``) to the flagged line, or put it in the comment
block directly above; say why the construct is intended.

*Per-tick code* is ``HOT_TICK_FUNCTIONS``: the methods that run once per
decode tick, static-engine step or train step, where an unintended sync
stalls the whole batch. The default sweep is ``src/repro_torch/``,
``chip_smoke.py``, ``attn_ties.py`` and ``ste_accuracy.py``.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .report import Finding, Report

__all__ = ["DEFAULT_PATHS", "HOT_TICK_FUNCTIONS", "RULES", "lint_file", "lint_paths", "run"]

PASS = "lints"

RULES: Dict[str, Tuple[str, str]] = {
    "RPA001": (
        "host sync in per-tick code or in an autograd.Function's forward/backward",
        "keep the value on the device (torch ops, device buffers) or hoist the sync "
        "out of the hot function; if the sync is the function's contract, suppress "
        "with '# repro: noqa-RPA001 -- <why>'",
    ),
    "RPA002": (
        "compile, graph capture or library load inside a loop",
        "build the compiled function, the graph or the library once outside the "
        "loop and reuse it",
    ),
    "RPA003": (
        "Python branch on a tensor expression in per-tick code (a hidden sync)",
        "keep the decision on the device (torch.where, masks) or branch on a host "
        "value the tick already has",
    ),
    "RPA004": (
        "dict-ordering-dependent key/artifact construction",
        "wrap .items() in sorted(...) / pass sort_keys=True so equal dicts "
        "serialize identically regardless of insertion order",
    ),
    "RPA005": (
        "timing region launches torch work without waiting for the device",
        "call torch.cuda.synchronize() (or an event's synchronize/elapsed_time) "
        "inside the timed region; otherwise the timer measures the launches",
    ),
}

# Functions that run once per decode tick, static-engine step or train step.
# Module key is a path suffix.
HOT_TICK_FUNCTIONS: Dict[str, Set[str]] = {
    "serve/scheduler.py": {"tick", "_tick", "_run_tick", "_admit_one", "_admit",
                           "_run_spec_tick"},
    "serve/engine.py": {"step_batch", "_step_batch"},
    "train/steps.py": {"train_step"},
}

DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py", "attn_ties.py", "ste_accuracy.py")

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_NP_CONVERT = {"asarray", "array"}
_SCALAR_CASTS = {"float", "int", "bool"}
# builtins whose result is a host value: a cast of one is no sync
_HOST_BUILTINS = {"len", "round", "range", "str", "min", "max", "abs", "sum", "getattr",
                  "ord", "divmod", "int", "float", "bool", "sorted", "next", "id", "hash"}
_TIMER_ATTRS = {"perf_counter", "time", "monotonic", "perf_counter_ns"}
# torch calls that run on the host and launch nothing
_HOST_TORCH = {
    "torch.cuda.is_available", "torch.cuda.device_count", "torch.cuda.get_device_name",
    "torch.cuda.get_device_properties", "torch.cuda.Event", "torch.cuda.synchronize",
    "torch.cuda.current_stream", "torch.cuda.device", "torch.cuda.max_memory_allocated",
    "torch.cuda.memory_allocated", "torch.cuda.reset_peak_memory_stats", "torch.device",
    "torch.is_tensor", "torch.is_grad_enabled", "torch.no_grad", "torch.inference_mode",
    "torch.get_default_dtype", "torch.manual_seed", "torch.Generator",
    "torch.is_floating_point", "torch.cuda.empty_cache",
}
_LOOP_BUILDERS = {"torch.compile", "torch.cuda.CUDAGraph", "torch.cuda.graph", "build.load",
                  "ctypes.CDLL"}

_NOQA_RE = re.compile(
    r"#\s*(?:repro:\s*)?noqa(?P<codes>\s*[:\-]\s*[A-Za-z0-9,\- ]+)?")


def _attr_chain(node: ast.AST) -> str:
    """Dotted name of a Name/Attribute chain ('' when not a plain chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _call_name(call: ast.Call) -> str:
    return _attr_chain(call.func)


def _tail(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _noqa_codes(source_lines: List[str], lineno: int) -> Optional[Set[str]]:
    """Suppressed codes for a physical line: set of codes, empty set for a
    blanket noqa, None when no suppression applies. A suppression lives on
    the flagged line itself or in the contiguous pure-comment block directly
    above it (the convention for justifications too long for one line)."""
    if not 1 <= lineno <= len(source_lines):
        return None

    def _parse(line: str) -> Optional[Set[str]]:
        m = _NOQA_RE.search(line)
        if not m:
            return None
        codes = m.group("codes")
        if not codes:
            return set()  # blanket
        toks = re.split(r"[,\s]+", codes.lstrip(" :-").strip())
        rpa = {t.upper().replace("-", "") for t in toks
               if t and t.upper().startswith("RPA")}
        # a code list without any RPA code is some other tool's noqa
        # (e.g. "# noqa: E501") — not a suppression for this linter
        return rpa or None

    got = _parse(source_lines[lineno - 1])
    if got is not None:
        return got
    i = lineno - 2  # walk the comment block immediately above
    while i >= 0 and source_lines[i].lstrip().startswith("#"):
        got = _parse(source_lines[i])
        if got is not None:
            return got
        i -= 1
    return None


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    """A class deriving from ``torch.autograd.Function`` (or ``Function``
    imported from it)."""
    for base in cls.bases:
        chain = _attr_chain(base)
        if chain.endswith("autograd.Function") or chain == "Function":
            return True
    return False


def _is_to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")``, ``x.to(device="cpu")`` or ``x.to(torch.device("cpu"))``."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    args = list(call.args) + [kw.value for kw in call.keywords if kw.arg == "device"]
    for a in args:
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
        if isinstance(a, ast.Call) and _call_name(a) == "torch.device" and a.args \
                and isinstance(a.args[0], ast.Constant) and a.args[0].value == "cpu":
            return True
    return False


def _tensor_call(node: ast.AST) -> Optional[ast.Call]:
    """The first call in ``node`` that yields a tensor: a ``torch.*``
    function that is not a host query. (A method such as ``.any()`` may be
    numpy's on a host array, so it is left out: few false positives.)"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            chain = _call_name(sub)
            if chain.startswith("torch.") and chain not in _HOST_TORCH:
                return sub
    return None


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, rel: str, source: str) -> None:
        self.path = path
        self.rel = rel
        self.lines = source.splitlines()
        self.findings: List[Finding] = []
        self.tree = ast.parse(source, filename=path)
        self.hot_names = self._hot_names(rel)
        self._fn_depth = 0  # autograd.Function forward/backward (and what they nest)
        self._hot_depth = 0
        self._loop_depth = 0
        self._class_stack: List[bool] = []
        self._fn_stack: List[dict] = []

    @staticmethod
    def _hot_names(rel: str) -> Set[str]:
        for suffix, names in HOT_TICK_FUNCTIONS.items():
            if rel.replace(os.sep, "/").endswith(suffix):
                return names
        return set()

    # -- reporting ----------------------------------------------------------

    def _flag(self, code: str, node: ast.AST, detail: str = "") -> None:
        noqa = _noqa_codes(self.lines, node.lineno)
        if noqa is not None and (not noqa or code in noqa):
            return
        msg, hint = RULES[code]
        if detail:
            msg = f"{msg}: {detail}"
        self.findings.append(Finding(
            pass_name=PASS, code=code,
            where=f"{self.rel}:{node.lineno}:{node.col_offset + 1}",
            message=msg, hint=hint, line=node.lineno,
        ))

    # -- class / function context -------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(_is_autograd_function(node))
        self.generic_visit(node)
        self._class_stack.pop()

    def _visit_function(self, node) -> None:
        in_fn = self._fn_depth > 0 or (
            bool(self._class_stack) and self._class_stack[-1]
            and node.name in ("forward", "backward"))
        hot = self._hot_depth > 0 or node.name in self.hot_names
        self._fn_depth += in_fn
        self._hot_depth += hot
        # RPA005 bookkeeping is per function (not inherited by nested defs)
        self._fn_stack.append({"timers": [], "torch_calls": 0, "synced": False})
        outer_loop, self._loop_depth = self._loop_depth, 0
        self._class_stack.append(False)  # a nested def's methods are no Function's
        self.generic_visit(node)
        self._class_stack.pop()
        self._loop_depth = outer_loop
        st = self._fn_stack.pop()
        if len(st["timers"]) >= 2 and st["torch_calls"] and not st["synced"]:
            self._flag("RPA005", st["timers"][1], f"in function {node.name!r}")
        self._fn_depth -= in_fn
        self._hot_depth -= hot

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    # -- loops (RPA002) and branches (RPA003) -------------------------------

    def _visit_loop(self, node) -> None:
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_For = _visit_loop
    visit_AsyncFor = _visit_loop

    def _check_branch(self, node, test: ast.expr) -> None:
        if self._hot_depth > 0:
            call = _tensor_call(test)
            if call is not None:
                self._flag("RPA003", node, f"test calls {_call_name(call)}(...)")

    def visit_If(self, node: ast.If) -> None:
        self._check_branch(node, node.test)
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._check_branch(node, node.test)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_branch(node, node.test)
        self._visit_loop(node)

    # -- calls (RPA001 / RPA002 / RPA004 / RPA005) --------------------------

    def _sync_detail(self, node: ast.Call, chain: str, name: str) -> Optional[str]:
        """What host sync ``node`` is, or None."""
        if isinstance(node.func, ast.Attribute) and name in _SYNC_METHODS \
                and not chain.startswith(("np.", "numpy.")):
            return f".{name}()"
        if _is_to_cpu(node):
            return '.to("cpu")'
        if chain == "torch.cuda.synchronize":
            return "torch.cuda.synchronize()"
        root = chain.split(".", 1)[0]
        if root in ("np", "numpy") and name in _NP_CONVERT and node.args and not isinstance(
                node.args[0], (ast.List, ast.Tuple, ast.ListComp, ast.GeneratorExp,
                               ast.Constant)):
            return f"{chain}(...)"  # a literal or comprehension touches no device buffer
        if isinstance(node.func, ast.Name) and node.func.id in _SCALAR_CASTS and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Call) and not (isinstance(arg.func, ast.Name)
                                                  and arg.func.id in _HOST_BUILTINS):
                return f"{node.func.id}(<call>)"
            if _tensor_call(arg) is not None:
                return f"{node.func.id}(<tensor expression>)"
        return None

    def visit_Call(self, node: ast.Call) -> None:
        chain = _call_name(node)
        name = node.func.attr if isinstance(node.func, ast.Attribute) else _tail(chain)
        root = chain.split(".", 1)[0]

        if self._fn_stack:
            st = self._fn_stack[-1]
            if root == "time" and name in _TIMER_ATTRS:
                st["timers"].append(node)
            if chain == "torch.cuda.synchronize" or name in ("synchronize", "elapsed_time") \
                    or (isinstance(node.func, ast.Attribute) and name in _SYNC_METHODS):
                st["synced"] = True
            elif (root == "torch" and chain not in _HOST_TORCH) or root == "ops":
                st["torch_calls"] += 1

        if self._loop_depth > 0 and chain in _LOOP_BUILDERS:
            self._flag("RPA002", node, f"{chain}(...) in a loop body")

        if self._fn_depth > 0 or self._hot_depth > 0:
            detail = self._sync_detail(node, chain, name)
            if detail:
                ctx = "per-tick" if self._hot_depth > 0 else "autograd.Function"
                self._flag("RPA001", node, f"{detail} in {ctx} code")

        if name in ("dumps", "dump") and root == "json":
            kwargs = {kw.arg for kw in node.keywords}
            if "sort_keys" not in kwargs:
                self._flag("RPA004", node, f"json.{name} without sort_keys=True")
        if isinstance(node.func, ast.Name) and node.func.id in ("tuple", "list") \
                and len(node.args) == 1:
            arg = node.args[0]
            if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute) \
                    and arg.func.attr == "items":
                self._flag("RPA004", node,
                           f"{node.func.id}(<dict>.items()) without sorted(...)")

        self.generic_visit(node)


def lint_file(path: str, root: str = ".") -> List[Finding]:
    rel = os.path.relpath(path, root)
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    try:
        linter = _Linter(path, rel, source)
    except SyntaxError as e:
        return [Finding(pass_name=PASS, code="RPA000", where=f"{rel}:{e.lineno}",
                        message=f"syntax error: {e.msg}", line=e.lineno)]
    linter.visit(linter.tree)
    return sorted(linter.findings, key=lambda f: (f.line or 0, f.code))


def iter_py_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
        elif os.path.isdir(p):
            for base, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs if not d.startswith((".", "__pycache__"))]
                out.extend(os.path.join(base, f) for f in files if f.endswith(".py"))
    return sorted(out)


def lint_paths(paths: Iterable[str], root: str = ".") -> Report:
    rep = Report(passes_run=[PASS])
    files = iter_py_files(paths)
    for f in files:
        rep.findings.extend(lint_file(f, root=root))
    rep.data[PASS] = {
        "n_files": len(files),
        "rules": {code: RULES[code][0] for code in RULES},
    }
    return rep


def run(root: str = ".", paths: Optional[List[str]] = None) -> Report:
    """Lint ``paths``, or the default sweep (``DEFAULT_PATHS`` under root)."""
    if paths is None:
        paths = [os.path.join(root, p) for p in DEFAULT_PATHS]
    return lint_paths(paths, root=root)
