"""FINN-style binarized layers, the paper's primary hardware baseline (port
of ``repro/core/bnn.py``).

Training form: latent real weights binarized with SignSTE; activations
binarized with SignSTE; hidden nonlinearity = learnable threshold on the
integer popcount sum.

Hardware form: bits x_hat = (x+1)/2 in {0,1}; the +/-1 dot product equals

    dot(x, w) = K - 2 * popcount(XOR(x_hat, w_hat))
              = 2 * popcount(XNOR(x_hat, w_hat)) - K

which is what the BNN PE computes (XNOR + PopCount) and what the CUDA
kernels (``csrc/bnn_matmul.cu``) count over 32-row words; here the
reference semantics are kept.
"""
from __future__ import annotations

import torch

from .ste import sign_ste

__all__ = [
    "binarize",
    "bnn_matmul",
    "bnn_linear_init",
    "bnn_linear_apply",
    "xnor_popcount_dot",
]


def binarize(x: torch.Tensor) -> torch.Tensor:
    """SignSTE binarization to {-1, +1}."""
    return sign_ste(x)


def bnn_matmul(xb: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """Integer-valued +/-1 contraction (the XNOR-popcount sum)."""
    return xb @ wb


def xnor_popcount_dot(x_bits: torch.Tensor, w_bits: torch.Tensor) -> torch.Tensor:
    """Hardware formulation on {0,1} bits: 2*popcount(XNOR) - K.

    x_bits: (..., K) integer; w_bits: (K, N) integer -> (..., N)."""
    k = x_bits.shape[-1]
    xnor = 1 - torch.bitwise_xor(x_bits[..., :, None], w_bits)  # (..., K, N)
    return 2 * xnor.sum(dim=-2) - k


def bnn_linear_init(gen: torch.Generator, k: int, n: int, dtype=torch.float32, *,
                    device=None):
    """{"w": U(-1/sqrt(k), 1/sqrt(k)) (k, n), "thresh": zeros (n,)} from ``gen``."""
    bound = 1.0 / (k**0.5)
    u = torch.rand((k, n), generator=gen, dtype=torch.float32, device=device)
    return {"w": ((u * 2.0 - 1.0) * bound).to(dtype),
            "thresh": torch.zeros((n,), dtype=dtype, device=device)}


def bnn_linear_apply(params, x: torch.Tensor, *, binarize_input: bool = True,
                     activation: bool = True) -> torch.Tensor:
    """One BNN layer. With activation=True returns +/-1 activations
    (Sign(popcount_sum - thresh)); otherwise the raw integer sum (logit layer)."""
    xb = binarize(x) if binarize_input else x
    wb = binarize(params["w"])
    pre = bnn_matmul(xb, wb)
    if not activation:
        return pre
    return sign_ste(pre - params["thresh"])
