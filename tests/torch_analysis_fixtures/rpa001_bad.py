"""Seeded RPA001 violations: host syncs inside an autograd.Function's
forward and backward. Every marked line must give exactly one RPA001
finding (the last line two)."""
import numpy as np
import torch


class SyncingFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = float(x.abs().max())  # RPA001: a scalar cast of a device value
        ctx.n = x.sum().item()  # RPA001: .item()
        host = x.cpu()  # RPA001: .cpu()
        arr = np.asarray(x)  # RPA001: numpy of a tensor
        return x * scale + host.to(x.device) + torch.from_numpy(arr)

    @staticmethod
    def backward(ctx, g):
        torch.cuda.synchronize()  # RPA001: waits for the whole card
        rows = g.tolist()  # RPA001: .tolist()
        return g.to("cpu").numpy(), rows  # RPA001 twice: .to("cpu") and .numpy()
