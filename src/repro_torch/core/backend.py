"""Quantized-backend registry (port of ``repro/core/backend.py``).

Every projection mode implements one contract — ``init_train`` /
``init_serve`` / ``to_serve`` / ``train_param_keys`` / ``apply_train`` /
``apply_serve`` / ``kernel_route`` / ``autotune_path`` / ``autotune_key``
— and ``nn/linear.py`` dispatches on ``LinearSpec.mode`` through the registry.
Registered: ``dense``, ``bika``, ``bnn`` and ``qnn8``.

Parameters are plain dicts of tensors with the reference's ``(K, N)`` /
``(m, K, N)`` layouts (never torch's ``(N, K)``), so one tree converts
between the packages leaf for leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from . import bika as bika_core
from . import qnn as qnn_core
from .ste import sign

__all__ = [
    "LinearSpec",
    "QuantBackend",
    "register",
    "registered_backends",
    "get_backend",
    "pack_signs",
    "pad_contraction",
    "quantize_activations",
    "unpack_signs",
    "DenseBackend",
    "BikaBackend",
    "BnnBackend",
    "Qnn8Backend",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    """Per-callsite projection options (same fields as the reference)."""

    mode: str = "dense"
    m: int = 1  # thresholds per edge (bika)
    fold_m: bool = True  # fold the m axis into K: one contraction, not m
    impl: str = "fused"  # the reference's XLA/Pallas choice; see BikaBackend.apply_serve
    chunk: Optional[int] = None
    out_scale: str = "rsqrt_k"  # 'none' | 'rsqrt_k'
    bias: bool = False
    pack_signs: bool = False  # serve-form bika: 1-bit packed sign planes
    act_scale: float = 0.05  # serve-form activation quantization LSB
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


# ---------------------------------------------------------------------------
# Sign bit-packing: bit j of byte r is row 8r+j; 1 -> +1, 0 -> -1
# ---------------------------------------------------------------------------


def unpack_signs(packed: torch.Tensor, k: int) -> torch.Tensor:
    """(..., K/8, N) uint8 bitplanes -> (..., K, N) +/-1 int8."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None, :] >> shifts[:, None]) & 1  # (..., K/8, 8, N)
    bits = bits.reshape(packed.shape[:-2] + (k, packed.shape[-1]))
    return (2 * bits.to(torch.int8) - 1).to(torch.int8)


def pack_signs(s: torch.Tensor) -> torch.Tensor:
    """(..., K, N) +/-1 -> (..., K/8, N) uint8 bitplanes."""
    k = s.shape[-2]
    if k % 8:
        raise ValueError(f"pack_signs requires K % 8 == 0, got K={k}")
    bits = (s > 0).to(torch.uint8).reshape(s.shape[:-2] + (k // 8, 8, s.shape[-1]))
    shifts = torch.arange(8, dtype=torch.uint8, device=s.device)
    return (bits << shifts[:, None]).sum(dim=-2).to(torch.uint8)


def pad_contraction(tau: torch.Tensor, s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K, N) int8 thresholds and +-1 int8 signs with K rounded up to a
    multiple of 8 (the CAC kernel's packed planes hold 8 rows a byte), the
    new rows tau = -128 and s = +1. Every int8 code satisfies x >= -128, so
    each new row adds exactly +1 to every sum, whatever x is padded with."""
    pad = -tau.shape[-2] % 8
    if not pad:
        return tau, s
    shape = tau.shape[:-2] + (pad, tau.shape[-1])
    return (torch.cat([tau, tau.new_full(shape, -128)], dim=-2),
            torch.cat([s, s.new_ones(shape)], dim=-2))


def _uniform(gen: torch.Generator, shape, dtype, bound: float, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return ((u * 2.0 - 1.0) * bound).to(dtype)


def quantize_activations(x: torch.Tensor, act_scale: float) -> torch.Tensor:
    """Activations onto the int8 threshold grid: ``clip(round(x / act_scale),
    -128, 127)`` with round half to even, as ``int8``. The divisor is a 0-dim
    tensor on x's device, filled there (no host copy, which would stall the
    stream): a true IEEE divide on every device, where a Python-scalar divisor
    may become a reciprocal multiply."""
    scale = torch.full((), act_scale, dtype=x.dtype, device=x.device)
    return torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)


def _out_scale(y: torch.Tensor, mk: int, spec) -> torch.Tensor:
    if spec.out_scale == "rsqrt_k":
        return y / torch.full((), float(mk), dtype=y.dtype, device=y.device).sqrt()
    return y


# ---------------------------------------------------------------------------
# The backend contract and registry
# ---------------------------------------------------------------------------


class QuantBackend:
    """Base class for one projection family (serve-slice subset)."""

    name: str = "?"
    # does this mode carry an additive bias like an ordinary ANN layer?
    default_bias: bool = False

    def inter_act(self, x: torch.Tensor) -> torch.Tensor:
        """Between-layer activation: the identity where the nonlinearity is
        inside the contraction (bika's Sign, bnn's binarization)."""
        return x

    def init_train(self, gen, k: int, n: int, spec, *, device):
        raise NotImplementedError

    def init_serve(self, gen, k: int, n: int, spec, *, device):
        raise NotImplementedError

    def to_serve(self, params, spec):
        raise NotImplementedError

    def train_param_keys(self, spec) -> Tuple[frozenset, frozenset]:
        raise NotImplementedError

    def apply_train(self, params, x: torch.Tensor, spec) -> torch.Tensor:
        raise NotImplementedError

    def apply_serve(self, params, x: torch.Tensor, spec) -> torch.Tensor:
        raise NotImplementedError

    def kernel_route(self, spec, phase: str = "train") -> Optional[str]:
        """Name of the route in ``kernels.ops.KERNEL_ROUTES`` this backend
        takes in ``phase`` (None: plain PyTorch)."""
        return None

    def autotune_path(self, spec, phase: str = "train") -> Optional[str]:
        """The ``kernels.autotune`` path the route's forward resolves its
        plan under (None where there is no route)."""
        return None

    def autotune_key(self, spec, phase: str, m: int, k: int, n: int,
                     backend: Optional[str] = None) -> Optional[str]:
        """The cache key the route's plan resolves under at (m, k, n)."""
        path = self.autotune_path(spec, phase)
        if path is None:
            return None
        from repro_torch.kernels import autotune

        return autotune.cache_key(path, m, k, n, backend)


_REGISTRY: Dict[str, QuantBackend] = {}


def register(backend: QuantBackend, *, name: Optional[str] = None) -> QuantBackend:
    _REGISTRY[name or backend.name] = backend
    return backend


def registered_backends() -> Dict[str, QuantBackend]:
    """A copy of the registry: ``{mode name: backend}``."""
    return dict(_REGISTRY)


def get_backend(name: str) -> QuantBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown linear mode {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


class DenseBackend(QuantBackend):
    name = "dense"
    default_bias = True

    def inter_act(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x)

    def init_train(self, gen, k, n, spec, *, device):
        p = {"w": _uniform(gen, (k, n), spec.pdtype, 1.0 / (k**0.5), device)}
        if spec.bias:
            p["b"] = torch.zeros((n,), dtype=spec.pdtype, device=device)
        return p

    init_serve = init_train  # dense serves its training parameters

    def to_serve(self, params, spec):
        return dict(params)

    def train_param_keys(self, spec):
        return frozenset({"w"}), frozenset({"b"})

    def apply_train(self, params, x, spec):
        y = x @ params["w"].to(x.dtype)
        if "b" in params:
            y = y + params["b"].to(x.dtype)
        return y

    apply_serve = apply_train


class BikaBackend(QuantBackend):
    name = "bika"

    def init_train(self, gen, k, n, spec, *, device):
        bound = 1.0 / (k**0.5)
        return {
            "w": _uniform(gen, (spec.m, k, n), spec.pdtype, bound, device),
            "beta": _uniform(gen, (spec.m, k, n), spec.pdtype, bound, device),
            "gamma": torch.ones((n,), dtype=spec.pdtype, device=device),
        }

    def init_serve(self, gen, k, n, spec, *, device):
        """Placeholder serve tree (tau 0; s -1 in packed planes, +1
        unpacked, as the reference's), K padded as ``to_serve`` pads it."""
        tau = torch.zeros((spec.m, k, n), dtype=torch.int8, device=device)
        s = torch.full((spec.m, k, n), -1 if spec.pack_signs else 1, dtype=torch.int8,
                       device=device)
        tau, s = pad_contraction(tau, s)
        return {"tau": tau, "s": pack_signs(s) if spec.pack_signs else s,
                "gamma": torch.ones((n,), dtype=torch.float32, device=device)}

    def to_serve(self, params, spec):
        """(w, beta) -> int8 (tau, s), K padded to a multiple of 8 once here
        (``pad_contraction``: CNV's first conv has K = 27), so that a served
        forward pads only its activations. A stacked leaf (layers, experts:
        more than the (m, K, N) dims) converts one leading slice at a time,
        which bounds the float temporaries to one slice's (the conversion is
        elementwise over leading dims, so the result is the same)."""
        if params["w"].dim() > 3:
            parts = [self.to_serve({k: v[i] for k, v in params.items()}, spec)
                     for i in range(params["w"].shape[0])]
            return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
        tau, s = bika_core.to_hardware(params["w"], params["beta"])
        tau_int, _ = bika_core.quantize_thresholds(tau, spec.act_scale)
        tau_int, s = pad_contraction(tau_int, s.to(torch.int8))
        if spec.pack_signs:
            s = pack_signs(s)
        return {"tau": tau_int, "s": s, "gamma": params["gamma"].to(torch.float32)}

    def train_param_keys(self, spec):
        return frozenset({"w", "beta", "gamma"}), frozenset()

    def apply_train(self, params, x, spec):
        """Training-form projection y = gamma * sum_k SignSTE(x w + beta) /
        sqrt(m K). Every call goes through ``kernels.ops.cac_train_matmul``
        whatever ``spec.impl`` says: on CUDA the hand-written training CAC
        kernels (forward and STE backward), on the CPU their plain versions.
        That is the function the reference computes on each of its
        ``fused``/``cvjp``/``pallas`` routes (its default ``cvjp`` is XLA).
        With m > 1 the fold feeds it K' = m*K."""
        from repro_torch.kernels.ops import cac_train_matmul

        cd = x.dtype
        w, beta = params["w"].to(cd), params["beta"].to(cd)
        m, k = w.shape[0], w.shape[1]
        if spec.fold_m and m > 1:
            wf, bf = bika_core.fold_m_axis(w, beta)
            y = cac_train_matmul(bika_core.tile_m_axis(x, m), wf, bf)
        else:
            y = sum(cac_train_matmul(x, w[j], beta[j]) for j in range(m))
        y = _out_scale(y.to(cd), m * k, spec)
        return y * params["gamma"].to(cd)

    def kernel_route(self, spec, phase="train"):
        return "cac_train" if phase == "train" else "cac_hw"

    def autotune_path(self, spec, phase="train"):
        return "train_fwd" if phase == "train" else "hw_fwd"

    def apply_serve(self, params, x, spec):
        """Hardware-form CAC projection. Every call goes through
        ``kernels.ops.cac_matmul`` whatever ``spec.impl`` says: on CUDA that
        is the hand-written CAC kernel, on the CPU its plain version — both
        compute exactly the integers of the reference's ``bika_matmul_hw``
        (its ``impl="pallas"`` route is the counterpart). The kernel reads
        the packed sign planes directly; unpacked serve trees are packed
        per call. Where the tree's K is padded (``pad_contraction``), the
        activation codes are padded to it and the pad rows' +1 each is
        subtracted. With m > 1 the fold feeds it K' = m*K."""
        from repro_torch.kernels.ops import cac_matmul

        cd = x.dtype
        tau, s = params["tau"], params["s"]
        m, k = tau.shape[0], x.shape[-1]
        pad = tau.shape[1] - k
        x_int = quantize_activations(x, spec.act_scale)
        if pad:
            x_int = torch.nn.functional.pad(x_int, (0, pad))

        def mm(xi, t, sg):
            return cac_matmul(xi, t, sg if spec.pack_signs else pack_signs(sg))

        if spec.fold_m and m > 1:
            # one comparator contraction over K' = m*K; exact (integer sums commute)
            y = mm(bika_core.tile_m_axis(x_int, m), tau.reshape(-1, tau.shape[-1]),
                   s.reshape(-1, s.shape[-1]))
        else:
            y = sum(mm(x_int, tau[j], s[j]) for j in range(m))
        y = (y - m * pad if pad else y).to(cd)
        y = _out_scale(y, m * k, spec)
        return y * params["gamma"].to(cd)


class BnnBackend(QuantBackend):
    """FINN-style XNOR-popcount baseline: train form ``{w, gamma}`` (latent
    float weights), serve form ``{wb, gamma}`` with ``wb`` int8 +-1 (K, N)
    or, with ``pack_signs``, uint8 bitplanes (K/8, N)."""

    name = "bnn"

    def init_train(self, gen, k, n, spec, *, device):
        return {
            "w": _uniform(gen, (k, n), spec.pdtype, 1.0 / (k**0.5), device),
            "gamma": torch.ones((n,), dtype=spec.pdtype, device=device),
        }

    def init_serve(self, gen, k, n, spec, *, device):
        if spec.pack_signs:
            if k % 8:
                raise ValueError(f"pack_signs requires K%8==0, got K={k}")
            p = {"wb": torch.zeros((k // 8, n), dtype=torch.uint8, device=device)}
        else:
            p = {"wb": torch.ones((k, n), dtype=torch.int8, device=device)}
        p["gamma"] = torch.ones((n,), dtype=torch.float32, device=device)
        return p

    def to_serve(self, params, spec):
        wb = sign(params["w"]).to(torch.int8)
        if spec.pack_signs:
            wb = pack_signs(wb)
        return {"wb": wb, "gamma": params["gamma"].to(torch.float32)}

    def train_param_keys(self, spec):
        return frozenset({"w", "gamma"}), frozenset()

    def apply_train(self, params, x, spec):
        """y = gamma * sign(x) @ sign(w) / sqrt(K) with the SignSTE
        backward. Every call goes through ``kernels.ops.bnn_train_matmul``
        whatever ``spec.impl`` says: on CUDA the hand-written sign-product
        kernel forward and the dx/dw kernels backward, on the CPU their
        plain versions. The reference's default route computes the same
        function in XLA (``sign_ste(x) @ sign_ste(w)``)."""
        from repro_torch.kernels.ops import bnn_train_matmul

        cd = x.dtype
        k = params["w"].shape[0]
        y = bnn_train_matmul(x, params["w"].to(cd)).to(cd)
        y = _out_scale(y, k, spec)
        return y * params["gamma"].to(cd)

    def apply_serve(self, params, x, spec):
        """y = gamma * sign(x) @ wb / sqrt(K): the float activations are
        binarized directly (no activation quantization). Every call goes
        through ``kernels.ops.bnn_matmul_packed`` (packed planes) or
        ``bnn_matmul`` (int8 +-1, read as stored) whatever ``spec.impl``
        says; the reference's default route computes the same integers in
        XLA (``sign(x) @ wb``)."""
        from repro_torch.kernels.ops import bnn_matmul, bnn_matmul_packed

        cd = x.dtype
        wb = params["wb"]
        if spec.pack_signs:
            k = 8 * wb.shape[0]
            y = bnn_matmul_packed(x, wb).to(cd)
        else:
            k = wb.shape[0]
            y = bnn_matmul(x, wb).to(cd)
        y = _out_scale(y, k, spec)
        return y * params["gamma"].to(cd)

    def kernel_route(self, spec, phase="train"):
        if phase == "train":
            return "bnn_train"
        return "bnn_packed" if spec.pack_signs else "bnn"

    def autotune_path(self, spec, phase="train"):
        return "bnn_packed" if phase != "train" and spec.pack_signs else "bnn"


class Qnn8Backend(QuantBackend):
    """The 8-bit integer baseline: train form ``{w, amax[, b]}`` (fake-quant
    weights and PACT activations), serve form ``{w_int int8 (K, N), w_scale
    float32 (1, N)[, b]}``."""

    name = "qnn8"
    default_bias = True  # an ordinary ANN layer's additive bias

    def inter_act(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x)

    def init_train(self, gen, k, n, spec, *, device):
        p = {
            "w": _uniform(gen, (k, n), spec.pdtype, 1.0 / (k**0.5), device),
            "amax": torch.full((), 6.0, dtype=spec.pdtype, device=device),
        }
        if spec.bias:
            p["b"] = torch.zeros((n,), dtype=spec.pdtype, device=device)
        return p

    def init_serve(self, gen, k, n, spec, *, device):
        p = {
            "w_int": torch.zeros((k, n), dtype=torch.int8, device=device),
            "w_scale": torch.ones((1, n), dtype=torch.float32, device=device),
        }
        if spec.bias:
            p["b"] = torch.zeros((n,), dtype=torch.float32, device=device)
        return p

    def to_serve(self, params, spec):
        w_int, w_scale = qnn_core.quantize_weights(params["w"])
        out = {"w_int": w_int, "w_scale": w_scale.to(torch.float32)}
        if "b" in params:
            out["b"] = params["b"].to(torch.float32)
        return out

    def train_param_keys(self, spec):
        return frozenset({"w", "amax"}), frozenset({"b"})

    def apply_train(self, params, x, spec):
        """Fake-quant training: a plain float matmul, as in the reference
        (no kernel of its own)."""
        xq = qnn_core.fake_quant_activations(x, params["amax"].to(x.dtype))
        wq = qnn_core.fake_quant_weights(params["w"].to(x.dtype))
        y = xq @ wq
        if "b" in params:
            y = y + params["b"].to(x.dtype)
        return y

    def apply_serve(self, params, x, spec):
        """y = float32(q(x) @ w_int) * (w_scale * act_scale) [+ b], with
        q(x) the int8 activation codes of ``quantize_activations``. Every call
        goes through ``kernels.ops.qnn_matmul`` whatever ``spec.impl`` says:
        on CUDA the hand-written int8 kernel, on the CPU its plain version.
        The reference's default route computes the same integers in XLA."""
        from repro_torch.kernels.ops import qnn_matmul

        cd = x.dtype
        x_int = quantize_activations(x, spec.act_scale)
        y = qnn_matmul(x_int, params["w_int"], params["w_scale"], spec.act_scale).to(cd)
        if "b" in params:
            y = y + params["b"].to(cd)
        return y

    def kernel_route(self, spec, phase="train"):
        return None if phase == "train" else "qnn8"

    def autotune_path(self, spec, phase="train"):
        return None if phase == "train" else "qnn8"


register(DenseBackend())
register(BikaBackend())
register(BnnBackend())
register(Qnn8Backend())
