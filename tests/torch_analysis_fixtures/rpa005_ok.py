"""RPA005-clean twins: the timed region waits for the card, by a
synchronise or by CUDA events."""
import time

import torch


def time_execution(x):
    t0 = time.perf_counter()
    y = torch.matmul(x, x)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    return y, t1 - t0


def time_events(x):
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    y = torch.matmul(x, x)
    e1.record()
    ms = e0.elapsed_time(e1)
    t1 = time.perf_counter()
    return y, ms, t1 - t0
