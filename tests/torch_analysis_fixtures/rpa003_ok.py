"""RPA003-clean twin: the tick branches on host values and keeps its tensor
decisions on the device. Linted as ``serve/scheduler.py``."""
import torch


class Scheduler:
    def _run_tick(self, logits, x):
        if self.n_active == 0:
            return x
        x = torch.where(torch.isnan(logits), torch.zeros_like(x), x)
        return x if self.greedy else -x
