"""Seeded RPA002 violations: a compile, a graph and two library loads made
afresh in every iteration of a loop."""
import ctypes

import torch

from repro_torch.kernels import build


def rebuild_per_iter(fns, xs, names):
    outs = []
    for f, x in zip(fns, xs):
        outs.append(torch.compile(f)(x))  # RPA002: a new compile every pass
    for _ in xs:
        outs.append(torch.cuda.CUDAGraph())  # RPA002: a new graph every pass
    for name in names:
        outs.append(build.load(name))  # RPA002: a load every pass
    while names:
        outs.append(ctypes.CDLL(names.pop()))  # RPA002
    return outs
