"""Output-stage image denoise (port of libyafaray_tpu/film/denoise.py: the
reference v3's optional non-local-means, with its denoiseHLum /
denoiseHCol / denoiseMix knobs).

A patch-based non-local means over the final image on any torch device:
luminance and chroma (YCbCr) filtered with their own strengths on the
reference's 0-255 scale, over a 7x7 search window of 3x3 patches with
edge-clamped shifts, blended with the original by `mix`.  As in the
reference, no render path calls it: `RenderConfig.denoise*` are parsed and
not applied.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.math import div

# search window radius (offsets) and patch radius of the SSD metric
_SEARCH = 3
_PATCH = 1


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """img[y-dy, x-dx], the indices clamped to the image (edge pixels
    repeat)."""
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    iy = torch.clamp(torch.arange(h, device=dev) - dy, 0, h - 1)
    ix = torch.clamp(torch.arange(w, device=dev) - dx, 0, w - 1)
    return img[iy][:, ix]


def _box(x: torch.Tensor, r: int) -> torch.Tensor:
    """Separable (2r+1)² mean filter with edge-clamped shifts."""
    acc = x
    for d in range(1, r + 1):
        acc = acc + _shift2d(x, d, 0) + _shift2d(x, -d, 0)
    acc = div(acc, 2 * r + 1)
    out = acc
    for d in range(1, r + 1):
        out = out + _shift2d(acc, 0, d) + _shift2d(acc, 0, -d)
    return div(out, 2 * r + 1)


def _rgb_to_ycc(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = (b - y) * 0.564
    cr = (r - y) * 0.713
    return torch.stack([y, cb, cr], dim=-1)


def _ycc_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    y, cb, cr = ycc[..., 0], ycc[..., 1], ycc[..., 2]
    r = y + 1.403 * cr
    b = y + 1.773 * cb
    g = div(y - 0.299 * r - 0.114 * b, 0.587)
    return torch.stack([r, g, b], dim=-1)


def nlm_denoise(img, h_lum: float = 5.0, h_col: float = 5.0,
                mix: float = 0.8) -> torch.Tensor:
    """Non-local-means denoise of an (H, W, 3) linear image (a tensor on
    any device, or an array, taken to the CPU).

    h_lum / h_col: strengths on the 0-255 scale (luminance / chroma); a
    strength <= 0 leaves its band as it is.  mix: result = mix·denoised +
    (1 - mix)·original."""
    img = torch.as_tensor(np.asarray(img, np.float32)
                          if not isinstance(img, torch.Tensor) else img,
                          dtype=torch.float32)
    dev = img.device
    ycc = _rgb_to_ycc(img)
    h = torch.tensor([max(h_lum, 0.0), max(h_col, 0.0), max(h_col, 0.0)],
                     dtype=torch.float32, device=dev) / 255.0
    h2 = torch.clamp(h * h, min=1e-12)
    num = torch.zeros_like(ycc)
    den = torch.zeros_like(ycc)
    for dy in range(-_SEARCH, _SEARCH + 1):
        for dx in range(-_SEARCH, _SEARCH + 1):
            sh = _shift2d(ycc, dy, dx)
            d2 = _box((ycc - sh) ** 2, _PATCH)
            w = torch.exp(-d2 / h2)
            num = num + w * sh
            den = den + w
    out = num / torch.clamp(den, min=1e-12)
    out = torch.where(h[None, None, :] > 0.0, out, ycc)
    rgb = _ycc_to_rgb(out)
    m = torch.tensor(float(np.clip(mix, 0.0, 1.0)), dtype=torch.float32,
                     device=dev)
    return m * rgb + (1.0 - m) * img


def denoise_image(img, h_lum: float = 5.0, h_col: float = 5.0,
                  mix: float = 0.8, device="cuda") -> np.ndarray:
    """Host entry: nlm_denoise of the (H, W, 3) image on `device` (default
    the card; it raises without one, device="cpu" runs on the CPU), as a
    numpy array."""
    from ..integrators.engine import resolve_device

    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(img, np.float32), device=dev)
    return nlm_denoise(x, float(h_lum), float(h_col),
                       float(mix)).cpu().numpy()
