"""repro_torch.analysis — the port's static checker (two passes):

  lints             AST lint rules (RPA0xx) over ``src/repro_torch/``,
                    ``chip_smoke.py``, ``attn_ties.py`` and
                    ``ste_accuracy.py`` for PyTorch/CUDA pitfalls: host syncs
                    in per-tick code or an autograd.Function, compiles or
                    loads in loops, branches on tensors, dict-order-dependent
                    keys, timing without a synchronise. Suppress a deliberate
                    hit with ``# repro: noqa-RPA001 -- <why>``.
  kernel_contracts  every KERNEL_ROUTES entry against the whole config zoo
                    (KCV0xx): plan legality and bounds, the on-chip budget
                    from ``-Xptxas -v`` logs against ``repro_torch.hwsim``'s
                    H100 terms, the routes on meta tensors, autotune keys and
                    cache hygiene.

Run it: ``python -m repro_torch.analysis --all`` (exit 0 iff no findings).
``repro_torch.analysis.lints`` alone is stdlib only.
"""
from . import lints
from .report import Finding, Report

__all__ = ["Finding", "Report", "lints", "run_all"]


def run_all(root: str = ".", *, ptxas_log=None) -> Report:
    """Both passes, merged."""
    from . import kernel_contracts

    rep = Report()
    rep.extend(lints.run(root))
    rep.extend(kernel_contracts.run(ptxas_log=ptxas_log))
    return rep
