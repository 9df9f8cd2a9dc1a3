"""Mamba2-style selective state-space block for zamba2 (port of
``repro/nn/ssm.py``).

Simplified SSD recurrence, faithful to the Mamba2 state update:

    h_t = exp(-dt_t * A) * h_{t-1} + dt_t * (x_t  B_t^T)      (outer product)
    y_t = h_t C_t + D * x_t

with per-head scalar A, input-dependent (B_t, C_t, dt_t), a causal depthwise
conv on the input stream, and a gated output. The recurrence is state
arithmetic and stays in float32; the in/out projections run through the
switchable linear backend (kernels 1, 7 and 10 on the card in bika, bnn and
qnn8). The time scan is a plain Python loop over the sequence, one
``_ssd_step`` a position; decode is one step with the state carried in the
cache. The prefill's conv sums ``pad[:, j:j+S] * w[j]`` term by term in j
order and decode's sums the window in one reduction, as the reference's two
paths do.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .linear import LinearSpec, linear_apply, linear_init

__all__ = ["SSMConfig", "ssm_init", "ssm_apply", "ssm_decode_step", "init_ssm_state"]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.head_dim == 0
        return self.d_inner // self.head_dim


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssm_init(gen: torch.Generator, cfg: SSMConfig, spec: LinearSpec, *, phase: str = "serve",
             device=None):
    di, n = cfg.d_inner, cfg.d_state
    # in_proj emits [z (di), x (di), B (n), C (n), dt (heads)]
    d_in_proj = 2 * di + 2 * n + cfg.n_heads
    return {
        "in_proj": linear_init(gen, cfg.d_model, d_in_proj, spec, phase=phase, device=device),
        "out_proj": linear_init(gen, di, cfg.d_model, spec, phase=phase, device=device),
        "conv_w": torch.randn((cfg.conv_width, di + 2 * n), generator=gen, device=device) * 0.1,
        "A_log": torch.log(torch.linspace(1.0, 16.0, cfg.n_heads, device=device)),
        "D": torch.ones((cfg.n_heads,), device=device),
        "dt_bias": torch.zeros((cfg.n_heads,), device=device),
        "norm_scale": torch.ones((di,), device=device),
    }


def _split_in_proj(zxbcdt: torch.Tensor, cfg: SSMConfig):
    di, n = cfg.d_inner, cfg.d_state
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n], zxbcdt[..., 2 * di + 2 * n:]


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. xbc: (B, S, C); w: (W, C)."""
    width, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    # sum_j w[j, c] * x[t - (W-1) + j, c], term by term in j order
    return sum(pad[:, j:j + s, :] * w[j] for j in range(width))


def _heads(x: torch.Tensor, cfg: SSMConfig) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (cfg.n_heads, cfg.head_dim))


def _ssd_step(h, xt, bt, ct, dtt, A):
    """One SSD recurrence step (the scan's and decode's). h (B, H, P, N),
    xt (B, H, P), bt / ct (B, N), dtt (B, H) -> (h_new, y (B, H, P))."""
    decay = torch.exp(-dtt * A)[..., None, None]
    inject = (dtt[..., None] * xt)[..., None] * bt[:, None, None, :]
    h_new = decay * h + inject
    return h_new, torch.einsum("bhpn,bn->bhp", h_new, ct)


def _d_skip(d: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """D * x skip connection, flattened back to (B, S, di)."""
    y = d[:, None] * xs.to(torch.float32)
    return y.reshape(xs.shape[0], xs.shape[1], -1)


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    y = y * F.silu(z)
    var = torch.mean(y * y, dim=-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * scale


def ssm_apply(params, x: torch.Tensor, cfg: SSMConfig, spec: LinearSpec, *,
              phase: str = "serve", return_state: bool = False):
    """x (B, S, D) -> (B, S, D); with ``return_state`` also the decode state
    {"h": (B, H, P, N), "conv": the last W-1 pre-conv inputs (B, W-1, C)}."""
    b, s, _ = x.shape
    f32 = torch.float32
    zxbcdt = linear_apply(params["in_proj"], x, spec, phase=phase)
    z, xbc_raw, dt = _split_in_proj(zxbcdt, cfg)
    xbc = F.silu(_causal_conv(xbc_raw.to(f32), params["conv_w"]))
    di, n = cfg.d_inner, cfg.d_state
    xs = _heads(xbc[..., :di], cfg)  # (B, S, H, P)
    bs = xbc[..., di:di + n]
    cs = xbc[..., di + n:]
    dts = softplus(dt.to(f32) + params["dt_bias"])  # (B, S, H)
    A = torch.exp(params["A_log"])
    h = torch.zeros((b, cfg.n_heads, cfg.head_dim, n), dtype=f32, device=x.device)
    ys = []
    for t in range(s):
        h, y_t = _ssd_step(h, xs[:, t], bs[:, t], cs[:, t], dts[:, t], A)
        ys.append(y_t)
    y = torch.stack(ys, dim=1).reshape(b, s, di)
    y = y + _d_skip(params["D"], xs)
    y = _gated_rmsnorm(y, z.to(f32), params["norm_scale"])
    out = linear_apply(params["out_proj"], y.to(x.dtype), spec, phase=phase)
    if not return_state:
        return out
    # the conv's rolling window holds the last (W-1) *pre-conv* inputs
    w1 = cfg.conv_width - 1
    conv = xbc_raw[:, -w1:].to(f32)
    if s < w1:
        conv = F.pad(conv, (0, 0, w1 - s, 0))
    return out, {"h": h, "conv": conv}


def init_ssm_state(batch: int, cfg: SSMConfig, dtype=torch.float32, device=None):
    return {
        "h": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state), dtype=dtype,
                         device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.d_state),
                            dtype=dtype, device=device),
    }


def ssm_decode_step(params, x: torch.Tensor, state, cfg: SSMConfig, spec: LinearSpec, *,
                    phase: str = "serve"):
    """One-token step. x (B, 1, D); state {"h", "conv"} -> (y (B, 1, D),
    new state)."""
    b = x.shape[0]
    f32 = torch.float32
    zxbcdt = linear_apply(params["in_proj"], x, spec, phase=phase)
    z, xbc, dt = _split_in_proj(zxbcdt[:, 0], cfg)
    # the causal conv over the rolling window [conv_state, x_t], one reduction
    win = torch.cat([state["conv"], xbc[:, None, :].to(state["conv"].dtype)], dim=1)
    conv_out = torch.sum(win * params["conv_w"][None], dim=1)  # (B, C)
    xbc_t = F.silu(conv_out.to(f32))
    di, n = cfg.d_inner, cfg.d_state
    xt = _heads(xbc_t[..., :di], cfg)
    bt = xbc_t[..., di:di + n]
    ct = xbc_t[..., di + n:]
    dtt = softplus(dt.to(f32) + params["dt_bias"])
    A = torch.exp(params["A_log"])
    h_new, y = _ssd_step(state["h"].to(f32), xt, bt, ct, dtt, A)
    y = y.reshape(b, -1) + (params["D"][:, None] * xt).reshape(b, -1)
    y = _gated_rmsnorm(y, z.to(f32), params["norm_scale"])
    out = linear_apply(params["out_proj"], y[:, None, :].to(x.dtype), spec, phase=phase)
    return out, {"h": h_new.to(state["h"].dtype), "conv": win[:, 1:]}
