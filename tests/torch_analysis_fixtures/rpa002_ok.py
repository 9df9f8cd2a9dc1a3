"""RPA002-clean twin: the compiled function, the graph and the library are
made once, outside the loops."""
import torch

from repro_torch.kernels import build


def build_once(f, xs, name):
    compiled = torch.compile(f)
    graph = torch.cuda.CUDAGraph()
    lib = build.load(name)
    return [compiled(x) for x in xs], graph, lib
