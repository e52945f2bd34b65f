"""Background (IBL) light: importance sampling of the environment map
(port of libyafaray_tpu/lights/bglight.py).

A flat Walker alias table over the map's texels, weighted by luminance ×
sin(theta), is built once at scene compile (numpy) and sampled with two
gathers a lane (lights/alias.py).  `pdf_bg_dir` is the MIS counterpart at
background escapes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..backgrounds.base import dir_to_uv, uv_to_dir
from ..core.math import div
from .alias import build_alias_table, sample_alias

_TWO_PI2 = 2.0 * math.pi * math.pi


def build_bg_cdf(image: np.ndarray) -> dict:
    """image (H, W, 3) linear lat-long map (v = 0 at the +z pole) -> the
    alias table over sin(theta)-weighted texel luminance (bg_alias_prob,
    bg_alias) and bg_pdf_grid (H, W), the density over the unit uv
    square."""
    img = np.maximum(np.asarray(image, np.float64), 0.0)
    h, w = img.shape[:2]
    lum = img.mean(axis=-1)
    theta = (np.arange(h) + 0.5) / h * np.pi
    weight = lum * np.sin(theta)[:, None]
    total = weight.sum()
    if total <= 0:
        weight = np.ones_like(weight)
        total = weight.sum()
    prob, alias = build_alias_table(weight.ravel())
    return dict(bg_alias_prob=prob, bg_alias=alias,
                bg_pdf_grid=(weight * (h * w) / total).astype(np.float32))


def _pdf_solid_angle(p_uv, v):
    """Density over (u, v) -> density over solid angle at polar v·pi."""
    sin_t = torch.clamp(torch.sin(v * math.pi), min=1e-5)
    return p_uv / (_TWO_PI2 * sin_t)


def sample_bg_light(arrays: dict, spec, p, u1, u2) -> dict:
    """An incident direction from the environment table: u1 picks the texel
    (its rescaled coin the in-cell u), u2 the in-cell v.  Returns dict(wi,
    dist (1e8), li, pdf (solid angle), valid); p only sets the lane
    count."""
    pdf_grid = arrays["bg_pdf_grid"]
    img = arrays.get("bg_image_ibl", arrays["bg_image"])
    h, w = pdf_grid.shape
    cell, du = sample_alias(arrays["bg_alias_prob"], arrays["bg_alias"], u1)
    y = torch.div(cell, w, rounding_mode="floor")
    x = cell - y * w
    u = div(x.to(torch.float32) + du, w)
    v = div(y.to(torch.float32) + torch.clamp(u2, 0.0, 1.0 - 1e-6), h)
    yl, xl = y.long(), x.long()
    pdf = _pdf_solid_angle(pdf_grid[yl, xl], v)
    return dict(wi=uv_to_dir(spec, u, v),
                dist=torch.full(u1.shape, 1e8, dtype=torch.float32,
                                device=u1.device),
                li=img[yl, xl] * spec.power, pdf=pdf, valid=pdf > 1e-10)


def pdf_bg_dir(arrays: dict, spec, d) -> torch.Tensor:
    """Solid-angle pdf with which sample_bg_light draws direction d."""
    pdf_grid = arrays["bg_pdf_grid"]
    h, w = pdf_grid.shape
    u, v = dir_to_uv(spec, d)
    x = torch.clamp((u * w).to(torch.int32), 0, w - 1)
    y = torch.clamp((v * h).to(torch.int32), 0, h - 1)
    return _pdf_solid_angle(pdf_grid[y.long(), x.long()], v)
