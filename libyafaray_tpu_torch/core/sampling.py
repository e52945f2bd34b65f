"""Sampling warps and MIS heuristics (port of libyafaray_tpu/core/sampling.py:
the cosine, sphere, cone, triangle and concentric-disk warps and the power
heuristic)."""
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
    r = vmath.sqrt_rn(torch.clamp(u1, min=0.0))
    phi = 2.0 * PI * u2
    x = r * vmath.cos_rn(phi)
    y = r * vmath.sin_rn(phi)
    z = vmath.sqrt_rn(torch.clamp(1.0 - u1, min=0.0))
    d = x[..., None] * u + y[..., None] * v + z[..., None] * n
    pdf = torch.clamp(z, min=1e-8) * INV_PI
    return d, pdf


def sample_sphere(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere (pdf 1/(4π))."""
    z = 1.0 - 2.0 * u1
    r = vmath.sqrt_rn(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * u2
    return torch.stack([r * vmath.cos_rn(phi), r * vmath.sin_rn(phi), z], dim=-1)


def sample_cone(axis: torch.Tensor, cos_max: torch.Tensor, u1: torch.Tensor,
                u2: torch.Tensor):
    """Uniform direction in the cone of half-angle acos(cos_max) around
    the unit `axis`.  Returns (dir, pdf), pdf = 1/(2π(1-cos_max))."""
    u, v = vmath.build_onb(axis)
    cos_t = 1.0 - u1 * (1.0 - cos_max)
    sin_t = vmath.sqrt_rn(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * PI * u2
    d = ((sin_t * vmath.cos_rn(phi))[..., None] * u
         + (sin_t * vmath.sin_rn(phi))[..., None] * v
         + cos_t[..., None] * axis)
    den = torch.clamp(2.0 * PI * (1.0 - cos_max), min=1e-9)
    return d, torch.ones_like(den) / den


def sample_triangle(u1: torch.Tensor, u2: torch.Tensor):
    """Uniform barycentrics (b0, b1) on a triangle (square-root warp)."""
    su1 = vmath.sqrt_rn(torch.clamp(u1, min=0.0))
    return 1.0 - su1, u2 * su1


def sample_disk_concentric(u1: torch.Tensor, u2: torch.Tensor):
    """Shirley-Chiu concentric warp of the unit square to the unit disk:
    (x, y)."""
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    zero = (ox.abs() < 1e-9) & (oy.abs() < 1e-9)
    use_x = ox.abs() > oy.abs()
    r = torch.where(use_x, ox, oy)
    safe_ox = torch.where(ox.abs() < 1e-12, 1.0, ox)
    safe_oy = torch.where(oy.abs() < 1e-12, 1.0, oy)
    theta = torch.where(use_x, (PI / 4.0) * (oy / safe_ox),
                        (PI / 2.0) - (PI / 4.0) * (ox / safe_oy))
    return (torch.where(zero, 0.0, r * vmath.cos_rn(theta)),
            torch.where(zero, 0.0, r * vmath.sin_rn(theta)))


def power_heuristic(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """MIS power heuristic, beta = 2."""
    a2 = pdf_a * pdf_a
    return a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-20)
