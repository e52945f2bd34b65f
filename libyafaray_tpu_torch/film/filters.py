"""Reconstruction filters (port of libyafaray_tpu/film/filters.py): box,
Mitchell-Netravali B=C=1/3, Gaussian and Lanczos(2), evaluated analytically
per static neighbour offset on whole pixel planes (film/imagefilm.py)."""
from __future__ import annotations

import math

import torch


def filter_radius(filter_type: str, pixel_width: float) -> int:
    """Static neighbor-offset radius needed to cover the filter support."""
    pixel_width = effective_width(filter_type, pixel_width)
    if filter_type == "box":
        return 0 if pixel_width <= 1.0 else int(math.ceil(
            (pixel_width - 1.0) / 2.0))
    return max(1, int(math.ceil((pixel_width - 1.0) / 2.0)))


def effective_width(filter_type: str, pixel_width: float) -> float:
    """Negative-lobe kernels (mitchell, lanczos) need support >= 2px or the
    discrete tap set can sum negative at some subpixel positions; clamp."""
    if filter_type in ("mitchell", "lanczos"):
        return max(pixel_width, 2.0)
    return pixel_width


def eval_filter_1d(filter_type: str, x: torch.Tensor,
                   pixel_width: float) -> torch.Tensor:
    """Filter weight at distance x (pixels) from the sample; support
    |x| <= pixel_width/2 (unnormalized; the film divides by the weight
    sum)."""
    pixel_width = effective_width(filter_type, pixel_width)
    half = pixel_width * 0.5
    ax = x.abs()
    inside = ax <= half

    if filter_type == "box":
        return torch.where(inside, 1.0, 0.0)

    # remap so the canonical kernels (support 2 for mitchell / lanczos,
    # exp falloff for gauss) stretch over pixel_width
    if filter_type == "mitchell":
        t = ax * (4.0 / pixel_width)  # canonical support [-2, 2]
        b = c = 1.0 / 3.0
        t2 = t * t
        t3 = t2 * t
        w1 = ((12.0 - 9.0 * b - 6.0 * c) * t3
              + (-18.0 + 12.0 * b + 6.0 * c) * t2
              + (6.0 - 2.0 * b)) / 6.0
        w2 = ((-b - 6.0 * c) * t3 + (6.0 * b + 30.0 * c) * t2
              + (-12.0 * b - 48.0 * c) * t + (8.0 * b + 24.0 * c)) / 6.0
        w = torch.where(t < 1.0, w1, torch.where(t < 2.0, w2, 0.0))
        return torch.where(inside, w, 0.0)

    if filter_type == "gauss":
        alpha = 6.0  # falloff; exp(-alpha*(x/half)^2) minus edge value
        r = ax / max(half, 1e-6)
        w = torch.exp(-alpha * r * r) - math.exp(-alpha)
        return torch.where(inside, torch.clamp(w, min=0.0), 0.0)

    if filter_type == "lanczos":
        t = ax * (4.0 / pixel_width)  # canonical support [-2, 2]
        pit = math.pi * torch.clamp(t, min=1e-6)
        w = (2.0 * torch.sin(pit) * torch.sin(pit * 0.5)) / (pit * pit)
        w = torch.where(t < 1e-6, 1.0, w)
        return torch.where(inside & (t < 2.0), w, 0.0)

    raise ValueError(f"unknown filter {filter_type!r}")


def eval_filter_2d(filter_type: str, dx: torch.Tensor, dy: torch.Tensor,
                   pixel_width: float) -> torch.Tensor:
    return eval_filter_1d(filter_type, dx, pixel_width) * eval_filter_1d(
        filter_type, dy, pixel_width)
