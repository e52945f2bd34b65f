"""Sampling warps and MIS heuristics (port of libyafaray_tpu/core/sampling.py,
restricted to what slice 1 calls)."""
from __future__ import annotations

import math

import torch

from . import math as vmath

PI = math.pi
INV_PI = 1.0 / math.pi


def sample_cos_hemisphere(n: torch.Tensor, u1: torch.Tensor,
                          u2: torch.Tensor):
    """Cosine-weighted hemisphere around normal n. Returns (dir, pdf)."""
    u, v = vmath.build_onb(n)
    r = torch.sqrt(torch.clamp(u1, min=0.0))
    phi = 2.0 * PI * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    d = x[..., None] * u + y[..., None] * v + z[..., None] * n
    pdf = torch.clamp(z, min=1e-8) * INV_PI
    return d, pdf


def power_heuristic(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """MIS power heuristic, beta = 2."""
    a2 = pdf_a * pdf_a
    return a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-20)
