"""Seeded RPA003 violations: Python branches on tensor expressions in a
decode tick. The tests lint this file as ``serve/scheduler.py``, whose
``_run_tick`` is per-tick code."""
import torch


class Scheduler:
    def _run_tick(self, logits, x):
        if torch.any(torch.isnan(logits)):  # RPA003: a tensor's truth value
            raise RuntimeError("nan logits")
        while torch.count_nonzero(x) > 0:  # RPA003
            x = x - 1
        return x if torch.all(x >= 0) else -x  # RPA003
