"""Procedural 10-class image tasks standing in for MNIST and CIFAR-10
(port of ``repro/data/vision.py``), deterministic in (seed, step).

"digits" (MNIST-like): 5x7 font glyphs rendered onto 28x28 with a random
sub-pixel shift and scale, a stroke-softening factor and noise, centred to
[-1, 1]. "textures" (CIFAR-like): 32x32x3 gratings, checkers, radials and
blobs by class, with colour jitter, heavy noise and a colour bias.

Each maker is split into its random draws (``digits_draws`` /
``textures_draws``, from a CPU ``torch.Generator``, so a batch is the same
on every device) and a render function that takes those draws and runs on
the target device. The draws are not the reference's: ``jax.random`` and
torch's generators differ, so parity tests feed the reference's draws to
the render functions. ``digits_batch`` / ``textures_batch`` render on CUDA
unless ``device="cpu"``; without a GPU they raise.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.device import resolve_device

__all__ = ["digits_batch", "digits_draws", "make_digits", "make_textures",
           "render_digits", "render_textures", "textures_batch", "textures_draws"]

# 5x7 bitmap font for digits 0-9 (rows top -> bottom)
_FONT = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00110", "01000", "10000", "11111"],
    3: ["01110", "10001", "00001", "00110", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}
_GLYPHS = torch.tensor([[[float(ch == "1") for ch in row] for row in _FONT[d]]
                        for d in range(10)])  # (10, 7, 5)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + torch.rand(shape, generator=gen) * (hi - lo)


def _gen(seed: int, step: int) -> torch.Generator:
    return torch.Generator().manual_seed((seed * 1_000_003 + step) & 0x7FFF_FFFF_FFFF_FFFF)


def digits_draws(gen: torch.Generator, n: int) -> Dict[str, torch.Tensor]:
    """The random inputs of n digits, on the CPU: labels, glyph pixel size
    ``scale``, offsets ``ox``/``oy``, stroke factor ``blur`` (n, 1, 1) and
    ``noise`` (n, 28, 28) uniform in [0, 1)."""
    return {
        "labels": torch.randint(0, 10, (n,), generator=gen),
        "scale": _uniform(gen, (n,), 2.2, 3.2),
        "ox": _uniform(gen, (n,), 2.0, 26.0 - 5 * 2.2),
        "oy": _uniform(gen, (n,), 2.0, 26.0 - 7 * 2.2),
        "blur": _uniform(gen, (n, 1, 1), 0.75, 1.0),
        "noise": torch.rand((n, 28, 28), generator=gen),
    }


def render_digits(labels, scale, ox, oy, blur, noise) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draws -> (images (n, 28, 28, 1) in [-1, 1], labels (n,)) on the
    draws' device."""
    dev = noise.device
    yy, xx = torch.meshgrid(torch.arange(28.0, device=dev), torch.arange(28.0, device=dev),
                            indexing="ij")
    sc = scale[:, None, None]
    gy = (yy - oy[:, None, None]) / sc  # glyph-space coordinates
    gx = (xx - ox[:, None, None]) / sc
    iy = torch.floor(gy).to(torch.int64).clamp(0, 6)
    ix = torch.floor(gx).to(torch.int64).clamp(0, 4)
    inside = (gy >= 0) & (gy < 7) & (gx >= 0) & (gx < 5)
    glyphs = _GLYPHS.to(dev)
    imgs = glyphs[labels.long()[:, None, None], iy, ix] * inside
    imgs = torch.clamp(imgs * blur + 0.15 * noise, 0.0, 1.0)
    # centred to [-1, 1]: the binarizing modes threshold near 0
    return (imgs[..., None] - 0.5) * 2.0, labels


def textures_draws(gen: torch.Generator, n: int) -> Dict[str, torch.Tensor]:
    """The random inputs of n textures, on the CPU: labels, frequency
    ``freq``, ``phase``, ``color`` (n, 3), ``noise`` (n, 32, 32, 3) and
    ``bias`` (n, 1, 1, 3), the last two uniform in [0, 1)."""
    return {
        "labels": torch.randint(0, 10, (n,), generator=gen),
        "freq": _uniform(gen, (n,), 2.0, 5.0),
        "phase": _uniform(gen, (n,), 0.0, 2 * math.pi),
        "color": _uniform(gen, (n, 3), 0.3, 1.0),
        "noise": torch.rand((n, 32, 32, 3), generator=gen),
        "bias": torch.rand((n, 1, 1, 3), generator=gen),
    }


def render_textures(labels, freq, phase, color, noise, bias
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draws -> (images (n, 32, 32, 3) in [-1, 1], labels (n,)) on the
    draws' device. The class picks the pattern (label % 4: grating,
    checker, radial, blob) and its orientation (label * pi / 10)."""
    dev = noise.device
    lin = torch.linspace(-1, 1, 32, device=dev)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    ang = (labels * (math.pi / 10.0))[:, None, None]
    f, ph = freq[:, None, None], phase[:, None, None]
    u = xx * torch.cos(ang) + yy * torch.sin(ang)
    v = -xx * torch.sin(ang) + yy * torch.cos(ang)
    grating = torch.sin(2 * math.pi * f * u + ph)
    checker = torch.sign(torch.sin(2 * math.pi * f * u + ph) * torch.sin(2 * math.pi * f * v))
    radial = torch.sin(2 * math.pi * f * torch.sqrt(u * u + v * v) + ph)
    blob = torch.exp(-((u * f / 2) ** 2 + (v * f / 2) ** 2))
    kinds = torch.stack([grating, checker, radial, blob], dim=1)  # (n, 4, 32, 32)
    base = kinds[torch.arange(labels.shape[0], device=dev), labels.long() % 4]
    imgs = (0.5 * (base + 1.0))[..., None] * color[:, None, None, :]
    out = torch.clamp(imgs + 0.25 * noise + 0.1 * bias, 0.0, 1.0)
    return (out - 0.5) * 2.0, labels


def _to(draws: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in draws.items()}


def make_digits(gen: torch.Generator, n: int, *, device=None):
    """n MNIST-like samples from ``gen``: (images (n, 28, 28, 1), labels)."""
    return render_digits(**_to(digits_draws(gen, n), resolve_device(device)))


def make_textures(gen: torch.Generator, n: int, *, device=None):
    """n CIFAR-like samples from ``gen``: (images (n, 32, 32, 3), labels)."""
    return render_textures(**_to(textures_draws(gen, n), resolve_device(device)))


def digits_batch(seed: int, step: int, batch: int, *, device=None):
    return make_digits(_gen(seed, step), batch, device=device)


def textures_batch(seed: int, step: int, batch: int, *, device=None):
    return make_textures(_gen(seed, step), batch, device=device)
