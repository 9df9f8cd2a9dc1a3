"""Findings model shared by the analysis passes (a copy of the reference's
``repro/analysis/report.py``, whose JSON shape it keeps).

A *finding* is one violated contract: a rule code (``RPA001``… for the AST
lints, ``KCV001``… for the kernel contracts), where it was found (file:line
for lints, a route/arch/shape key or a ptxas entry for the contracts), a
one-line message, and a fix hint. A *report* aggregates the findings of a
run plus each pass's structured data (the contracts' per-route table, the
ptxas rows) and renders both the human listing and the JSON artifact.

Exit-code contract: ``Report.ok`` is True iff there are zero findings;
``python -m repro_torch.analysis`` exits 1 otherwise.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

__all__ = ["Finding", "Report"]


@dataclasses.dataclass
class Finding:
    """One violated contract."""

    pass_name: str  # lints | kernel_contracts
    code: str  # RPA001… / KCV001…
    where: str  # "path:line:col" or "route/arch" or program key
    message: str
    hint: str = ""
    line: Optional[int] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        d = {
            "pass": self.pass_name,
            "code": self.code,
            "where": self.where,
            "message": self.message,
            "hint": self.hint,
        }
        if self.line is not None:
            d["line"] = self.line
        if self.extra:
            d["extra"] = self.extra
        return d

    def render(self) -> str:
        s = f"{self.where}: {self.code} {self.message}"
        if self.hint:
            s += f"\n    hint: {self.hint}"
        return s


@dataclasses.dataclass
class Report:
    """Aggregate of one analyzer run: findings + per-pass structured data."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    # pass name -> arbitrary JSON-serializable payload (contract table, ptxas rows…)
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)
    passes_run: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def extend(self, other: "Report") -> None:
        self.findings.extend(other.findings)
        self.data.update(other.data)
        self.passes_run.extend(p for p in other.passes_run
                               if p not in self.passes_run)

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def to_json(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "passes": list(self.passes_run),
            "n_findings": len(self.findings),
            "findings": [f.to_json() for f in self.findings],
            "data": self.data,
        }

    def write_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=1, sort_keys=True)
            fh.write("\n")

    def render(self) -> str:
        lines = []
        by_pass: Dict[str, List[Finding]] = {}
        for f in self.findings:
            by_pass.setdefault(f.pass_name, []).append(f)
        for pname in self.passes_run:
            fs = by_pass.get(pname, [])
            status = "ok" if not fs else f"{len(fs)} finding(s)"
            lines.append(f"[{pname}] {status}")
            for f in fs:
                lines.append("  " + f.render().replace("\n", "\n  "))
        if not self.passes_run:
            lines.append("no passes run")
        lines.append(
            f"{len(self.findings)} finding(s) across "
            f"{len(self.passes_run)} pass(es)"
        )
        return "\n".join(lines)
