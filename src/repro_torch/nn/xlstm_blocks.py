"""xLSTM blocks (sLSTM + mLSTM) for xlstm-125m (port of
``repro/nn/xlstm_blocks.py``).

mLSTM: a matrix memory C (head_dim x head_dim per head) with stabilised
exponential gating. sLSTM: a scalar memory with block-diagonal recurrent
weights. Both scans are plain Python loops over the sequence, one step
function shared with decode. The gating and recurrence arithmetic stays in
float32 (the gate product ``ifg`` and the recurrent ``r`` are float
products, as in the reference); every projection routes through the
switchable linear backend.

The sLSTM's recurrent product is reshaped head-major, (B, H, 4 hd) ->
(B, 4 D), and only then split into the i, f, z and o pre-activations, so
each gate's recurrent term is one head's 4 hd outputs rather than that
gate's slice of every head: the reference's behaviour, kept as it is.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .linear import LinearSpec, linear_apply, linear_init
from .ssm import softplus

__all__ = [
    "XLSTMConfig",
    "mlstm_init",
    "mlstm_apply",
    "mlstm_decode_step",
    "init_mlstm_state",
    "slstm_init",
    "slstm_apply",
    "slstm_decode_step",
    "init_slstm_state",
]


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int = 4
    proj_factor: float = 2.0  # mLSTM up-projection
    conv_width: int = 4

    @property
    def d_inner(self) -> int:
        return int(self.proj_factor * self.d_model)

    @property
    def head_dim(self) -> int:
        assert self.d_inner % self.n_heads == 0
        return self.d_inner // self.n_heads


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


def _rms(y: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = torch.mean(y * y, dim=-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * scale


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(gen: torch.Generator, cfg: XLSTMConfig, spec: LinearSpec, *, phase="serve",
               device=None):
    d, di = cfg.d_model, cfg.d_inner
    return {
        "up": linear_init(gen, d, 2 * di, spec, phase=phase, device=device),
        "q": linear_init(gen, di, di, spec, phase=phase, device=device),
        "k": linear_init(gen, di, di, spec, phase=phase, device=device),
        "v": linear_init(gen, di, di, spec, phase=phase, device=device),
        "ifg": torch.randn((di, 2 * cfg.n_heads), generator=gen, device=device) * 0.01,
        "down": linear_init(gen, di, d, spec, phase=phase, device=device),
        "norm_scale": torch.ones((di,), device=device),
    }


def _mlstm_step(state, q, k, v, ip, fp):
    """Stabilised exponential gating (xLSTM eqs. 19-27). state (C (B,H,P,P),
    n (B,H,P), m (B,H)); q/k/v (B,H,P); ip/fp (B,H) -> (state, h (B,H,P))."""
    C, n, m = state
    m_new = torch.maximum(fp + m, ip)
    i = torch.exp(ip - m_new)[..., None]
    f = torch.exp(fp + m - m_new)[..., None]
    n_new = f * n + i * k
    C_new = f[..., None] * C + (i * v)[..., :, None] * k[..., None, :]
    denom = torch.clamp_min(torch.abs(torch.sum(n_new * q, dim=-1)), 1.0)[..., None]
    h = torch.einsum("bhpq,bhq->bhp", C_new, q) / denom
    return (C_new, n_new, m_new), h


def _qkv_heads(x: torch.Tensor, cfg: XLSTMConfig) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (cfg.n_heads, cfg.head_dim))


def _mlstm_inputs(params, xin: torch.Tensor, cfg: XLSTMConfig, spec, phase):
    """q, k / sqrt(head_dim), v by heads and the (ip, log_sigmoid(fp))
    gate pre-activations of the up-projection's first half."""
    f32 = torch.float32
    q = _qkv_heads(linear_apply(params["q"], xin, spec, phase=phase).to(f32), cfg)
    k = _qkv_heads(linear_apply(params["k"], xin, spec, phase=phase).to(f32), cfg)
    k = k / torch.full((), cfg.head_dim, dtype=f32, device=k.device).sqrt()
    v = _qkv_heads(linear_apply(params["v"], xin, spec, phase=phase).to(f32), cfg)
    ifg = xin.to(f32) @ params["ifg"]  # (..., 2H), a plain float product
    ip, fp = torch.chunk(ifg, 2, dim=-1)
    return q, k, v, ip, _log_sigmoid(fp)


def mlstm_apply(params, x: torch.Tensor, cfg: XLSTMConfig, spec: LinearSpec, *,
                phase="serve", return_state: bool = False):
    b, s, _ = x.shape
    f32 = torch.float32
    up = linear_apply(params["up"], x, spec, phase=phase)
    xin, z = torch.chunk(up, 2, dim=-1)
    q, k, v, ip, fp = _mlstm_inputs(params, xin, cfg, spec, phase)
    hd = cfg.head_dim
    state = (torch.zeros((b, cfg.n_heads, hd, hd), dtype=f32, device=x.device),
             torch.zeros((b, cfg.n_heads, hd), dtype=f32, device=x.device),
             torch.zeros((b, cfg.n_heads), dtype=f32, device=x.device))
    hs = []
    for t in range(s):
        state, h_t = _mlstm_step(state, q[:, t], k[:, t], v[:, t], ip[:, t], fp[:, t])
        hs.append(h_t)
    h = torch.stack(hs, dim=1).reshape(b, s, cfg.d_inner)
    h = _rms(h, params["norm_scale"]) * F.silu(z.to(f32))
    out = linear_apply(params["down"], h.to(x.dtype), spec, phase=phase)
    if not return_state:
        return out
    C, n, m = state
    return out, {"C": C, "n": n, "m": m}


def init_mlstm_state(batch: int, cfg: XLSTMConfig, dtype=torch.float32, device=None):
    hd = cfg.head_dim
    return {
        "C": torch.zeros((batch, cfg.n_heads, hd, hd), dtype=dtype, device=device),
        "n": torch.zeros((batch, cfg.n_heads, hd), dtype=dtype, device=device),
        "m": torch.zeros((batch, cfg.n_heads), dtype=dtype, device=device),
    }


def mlstm_decode_step(params, x: torch.Tensor, state, cfg: XLSTMConfig, spec: LinearSpec, *,
                      phase="serve"):
    b = x.shape[0]
    f32 = torch.float32
    up = linear_apply(params["up"], x[:, 0], spec, phase=phase)
    xin, z = torch.chunk(up, 2, dim=-1)
    q, k, v, ip, fp = _mlstm_inputs(params, xin, cfg, spec, phase)
    st = (state["C"].to(f32), state["n"].to(f32), state["m"].to(f32))
    (C, n, m), h = _mlstm_step(st, q, k, v, ip, fp)
    h = _rms(h.reshape(b, cfg.d_inner), params["norm_scale"]) * F.silu(z.to(f32))
    y = linear_apply(params["down"], h[:, None].to(x.dtype), spec, phase=phase)
    # m is returned uncast, as the reference returns it
    return y, {"C": C.to(state["C"].dtype), "n": n.to(state["n"].dtype), "m": m}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(gen: torch.Generator, cfg: XLSTMConfig, spec: LinearSpec, *, phase="serve",
               device=None):
    d = cfg.d_model
    hd = d // cfg.n_heads
    return {
        # input projections for the i, f, z, o gates
        "wx": linear_init(gen, d, 4 * d, spec, phase=phase, device=device),
        # block-diagonal recurrent weights: (H, hd, 4 hd)
        "r": torch.randn((cfg.n_heads, hd, 4 * hd), generator=gen, device=device) * 0.01,
        "down": linear_init(gen, d, d, spec, phase=phase, device=device),
        "norm_scale": torch.ones((d,), device=device),
    }


def _slstm_step(state, wx_t: torch.Tensor, r: torch.Tensor, n_heads: int):
    """state (h, c, n, m), each (B, D); wx_t (B, 4D) -> (state, h_new)."""
    h, c, n, m = state
    b, d = h.shape
    hh = h.reshape(b, n_heads, d // n_heads)
    # head-major: one head's 4 hd outputs stay together before the gate split
    rec = torch.einsum("bhp,hpq->bhq", hh, r).reshape(b, 4 * d)
    ip, fp, zp, op = torch.chunk(wx_t + rec, 4, dim=-1)
    m_new = torch.maximum(_log_sigmoid(fp) + m, ip)
    i = torch.exp(ip - m_new)
    f = torch.exp(_log_sigmoid(fp) + m - m_new)
    z = torch.tanh(zp)
    o = torch.sigmoid(op)
    c_new = f * c + i * z
    n_new = f * n + i
    h_new = o * c_new / torch.clamp_min(n_new, 1.0)
    return (h_new, c_new, n_new, m_new), h_new


def slstm_apply(params, x: torch.Tensor, cfg: XLSTMConfig, spec: LinearSpec, *,
                phase="serve", return_state: bool = False):
    b, s, d = x.shape
    wx = linear_apply(params["wx"], x, spec, phase=phase).to(torch.float32)  # (B, S, 4D)
    zero = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    state = (zero, zero, zero, zero)
    hs = []
    for t in range(s):
        state, h_t = _slstm_step(state, wx[:, t], params["r"], cfg.n_heads)
        hs.append(h_t)
    h = _rms(torch.stack(hs, dim=1), params["norm_scale"])
    out = linear_apply(params["down"], h.to(x.dtype), spec, phase=phase)
    if not return_state:
        return out
    hf, cf, nf, mf = state
    return out, {"h": hf, "c": cf, "n": nf, "m": mf}


def init_slstm_state(batch: int, cfg: XLSTMConfig, dtype=torch.float32, device=None):
    return {k: torch.zeros((batch, cfg.d_model), dtype=dtype, device=device)
            for k in ("h", "c", "n", "m")}


def slstm_decode_step(params, x: torch.Tensor, state, cfg: XLSTMConfig, spec: LinearSpec, *,
                      phase="serve"):
    wx = linear_apply(params["wx"], x[:, 0], spec, phase=phase).to(torch.float32)
    st = tuple(state[k].to(torch.float32) for k in ("h", "c", "n", "m"))
    (h, c, n, m), _ = _slstm_step(st, wx, params["r"], cfg.n_heads)
    y = _rms(h, params["norm_scale"])
    out = linear_apply(params["down"], y[:, None].to(x.dtype), spec, phase=phase)
    return out, {"h": h, "c": c, "n": n, "m": m}
