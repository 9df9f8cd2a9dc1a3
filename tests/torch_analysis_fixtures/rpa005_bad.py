"""Seeded RPA005 violation: a timed region launching torch work with no
synchronise: the timer measures the launch, not the card."""
import time

import torch


def time_launch(x):
    t0 = time.perf_counter()
    y = torch.matmul(x, x)
    t1 = time.perf_counter()  # RPA005 fires on the second timer call
    return y, t1 - t0
