"""Image film — weighted accumulation and scatter-free splatting (port of
libyafaray_tpu/film/imagefilm.py: film_init, film_splat, film_image and
SPPM's density layer; the AOV, alpha and variance planes wait for ROADMAP
Queue 1 items 16-17).

The lanes are pixel-ordered, one sample per pixel per step, so splatting a
filter of radius R is (2R+1)² dense shifted plane-adds, never a scatter.
"""
from __future__ import annotations

import torch

from .filters import eval_filter_2d, filter_radius


def film_init(h: int, w: int, device, with_density: bool = False) -> dict:
    film = dict(
        wsum=torch.zeros((h, w, 3), dtype=torch.float32, device=device),
        w=torch.zeros((h, w), dtype=torch.float32, device=device),
        nsamples=torch.zeros((h, w), dtype=torch.int32, device=device),
    )
    if with_density:
        film["density"] = torch.zeros((h, w, 3), dtype=torch.float32,
                                      device=device)
    return film


def _shift2d(a: torch.Tensor, oy: int, ox: int) -> torch.Tensor:
    """Shift a (H,W,...) plane by static offsets (out[y, x] = a[y-oy, x-ox]),
    zero-filling."""
    if oy == 0 and ox == 0:
        return a
    h, w = a.shape[0], a.shape[1]
    out = torch.zeros_like(a)
    out[max(oy, 0):h + min(oy, 0), max(ox, 0):w + min(ox, 0)] = \
        a[max(-oy, 0):h - max(oy, 0), max(-ox, 0):w - max(ox, 0)]
    return out


def film_splat(film: dict, color, sx, sy, active, filter_type: str,
               pixel_width: float, clamp_samples: float = 0.0) -> dict:
    """Accumulate one sample-per-pixel plane into the film.

    color: (H,W,3) radiance of this step's sample for each pixel.
    sx, sy: (H,W) subpixel position in [0,1) of the sample in its pixel.
    active: (H,W) float 0/1 resample flag."""
    if clamp_samples > 0.0:
        # reference AA_clamp_samples: clamp sample color magnitude
        m = color.amax(dim=-1, keepdim=True)
        scale = torch.where(m > clamp_samples,
                            torch.full_like(m, clamp_samples)
                            / torch.clamp(m, min=1e-9), 1.0)
        color = color * scale
    r = filter_radius(filter_type, pixel_width)
    wsum = film["wsum"]
    wacc = film["w"]
    for oy in range(-r, r + 1):
        for ox in range(-r, r + 1):
            # distance from neighbor pixel center (o + 0.5) to the sample
            dx = ox + 0.5 - sx
            dy = oy + 0.5 - sy
            wgt = eval_filter_2d(filter_type, dx, dy, pixel_width) * active
            wsum = wsum + _shift2d(wgt[..., None] * color, oy, ox)
            wacc = wacc + _shift2d(wgt, oy, ox)
    out = dict(film)
    out["wsum"] = wsum
    out["w"] = wacc
    out["nsamples"] = film["nsamples"] + active.to(torch.int32)
    return out


def film_image(film: dict) -> torch.Tensor:
    """Current weighted-mean image (H,W,3), linear RGB, plus the density
    layer where the film has one."""
    img = film["wsum"] / torch.clamp(film["w"], min=1e-8)[..., None]
    if "density" in film:
        img = img + film["density"]
    return img


def add_density(film: dict, contrib: torch.Tensor) -> dict:
    """SPPM's density layer accumulation (reference addDensitySample)."""
    base = film.get("density")
    return dict(film, density=contrib if base is None else base + contrib)
