"""Light table + per-type NEE samplers (port of libyafaray_tpu/lights/
base.py: the LT_* codes, the table layout, `light_row`, one sampler per
light type and `pdf_hit_area`).

Radiometric conventions (the reference's):
  point/spot/ies:  intensity I = color·power;            Li = I/d² (delta)
  area/mesh:       radiance  L = color·power/(π·A_total); Li = L, MIS-able
  sphere:          radiance  L = color·power/(4π²·r²);    cone-sampled
  sun:             radiance  L = color·power, angular-radius cone
  directional:     irradiance E = color·power (delta)

Every sampler takes the light's row (0-dim / (3,) tensors), the shading
points p (N,3) and two uniforms a lane, and returns dict(wi (N,3), dist
(N,), li (N,3), pdf (N,) solid angle, 1 for delta lights, valid (N,)).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import math as vmath
from ..core.sampling import sample_cone, sample_disk_concentric, \
    sample_triangle

LT_POINT = 0
LT_AREA = 1
LT_SPHERE = 2
LT_SPOT = 3
LT_SUN = 4
LT_DIRECTIONAL = 5
LT_MESH = 6
LT_BACKGROUND = 7
LT_IES = 8
LT_PORTAL = 9

_F3 = ["p0", "e1", "e2", "direction", "radiance", "intensity"]
_F1 = ["power", "radius", "cos_start", "cos_end", "area", "cos_angle",
       "spot_blend"]
_I1 = ["ltype", "samples", "tri_start", "tri_count"]
_B1 = ["enabled", "cast_shadows", "is_delta", "intersectable", "photon_only",
       "double_sided"]


def default_light_row() -> dict:
    row = {k: (0.0, 0.0, 0.0) for k in _F3}
    row.update({k: 0.0 for k in _F1})
    row.update({k: 0 for k in _I1})
    row.update({k: False for k in _B1})
    row["enabled"] = True
    row["cast_shadows"] = True
    row["samples"] = 1
    row["tri_start"] = -1
    return row


def build_light_table(rows: list[dict]) -> dict:
    n = len(rows)
    out = {}
    for k in _F3:
        out[k] = np.asarray([r[k] for r in rows], np.float32).reshape(n, 3)
    for k in _F1:
        out[k] = np.asarray([r[k] for r in rows], np.float32).reshape(n)
    for k in _I1:
        out[k] = np.asarray([r[k] for r in rows], np.int32).reshape(n)
    for k in _B1:
        out[k] = np.asarray([r[k] for r in rows], np.bool_).reshape(n)
    return out


def light_row(lights: dict, li: int) -> dict:
    """Row of the (static) light index li: 0-dim / (3,) tensors."""
    return {k: v[li] for k, v in lights.items()}


def _unit_z(p: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """Per lane (0,0,1) where |axis.z| < 0.9, else (1,0,0): the helper
    vector of the spot's disk frame."""
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=p.dtype, device=p.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=p.dtype, device=p.device)
    return torch.where(axis[..., 2:3].abs() < 0.9, ez, ex)


def sample_point(row: dict, p: torch.Tensor, u1: torch.Tensor,
                 u2: torch.Tensor) -> dict:
    """A point light: the one direction to it, Li = I/d²."""
    d = row["p0"] - p
    dist2 = torch.clamp(vmath.dot(d, d), min=1e-12)
    dist = vmath.sqrt_rn(dist2)
    return dict(wi=d / dist[..., None], dist=dist,
                li=row["intensity"] / dist2[..., None],
                pdf=torch.ones_like(dist),
                valid=torch.ones(dist.shape, dtype=torch.bool,
                                 device=p.device))


def spot_falloff(row: dict, cos_a: torch.Tensor) -> torch.Tensor:
    """A spot's smoothstep falloff at cos_a to its axis: 0 outside
    cos_end, 1 inside cos_start (the reference's `blend` band)."""
    ce = row["cos_end"]
    t = torch.clamp((cos_a - ce) / torch.clamp(row["cos_start"] - ce,
                                               min=1e-6), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def sample_spot(row: dict, p: torch.Tensor, u1: torch.Tensor,
                u2: torch.Tensor) -> dict:
    """A spot light: a point light whose position is jittered on a disk of
    radius `radius` (soft_shadows' shadowFuzzyness; 0 keeps the delta
    light) perpendicular to its axis, with a smoothstep falloff between
    cos_end and cos_start."""
    out = sample_point(row, p, u1, u2)
    r_j = row["radius"]
    ax = row["direction"] + torch.zeros_like(p)
    t1 = vmath.normalize(vmath.cross(ax, _unit_z(p, ax)))
    t2 = vmath.cross(ax, t1)
    dx, dy = sample_disk_concentric(u1, u2)
    p0 = (row["p0"] + (dx * r_j)[..., None] * t1
          + (dy * r_j)[..., None] * t2)
    dvec = p0 - p
    d2 = torch.clamp(vmath.dot(dvec, dvec), min=1e-12)
    dist = vmath.sqrt_rn(d2)
    wi = dvec / dist[..., None]
    cos_a = vmath.dot(-wi, row["direction"])
    out.update(wi=wi, dist=dist, li=row["intensity"] / d2[..., None]
               * spot_falloff(row, cos_a)[..., None],
               valid=cos_a > row["cos_end"])
    return out


def sample_directional(row: dict, p: torch.Tensor, u1: torch.Tensor,
                       u2: torch.Tensor) -> dict:
    """A directional light: the one direction -direction, segments of
    1e8, Li = E."""
    shape = p.shape[:-1]
    return dict(wi=vmath.normalize(-row["direction"] + torch.zeros_like(p)),
                dist=torch.full(shape, 1e8, dtype=p.dtype, device=p.device),
                li=row["intensity"] + torch.zeros_like(p),
                pdf=torch.ones(shape, dtype=p.dtype, device=p.device),
                valid=torch.ones(shape, dtype=torch.bool, device=p.device))


def sample_sun(row: dict, p: torch.Tensor, u1: torch.Tensor,
               u2: torch.Tensor) -> dict:
    """The sun: a uniform direction in its angular-radius cone around
    -direction, segments of 1e8, Li = L."""
    shape = p.shape[:-1]
    axis = vmath.normalize(-row["direction"] + torch.zeros_like(p))
    wi, pdf = sample_cone(axis, row["cos_angle"], u1, u2)
    return dict(wi=wi,
                dist=torch.full(shape, 1e8, dtype=p.dtype, device=p.device),
                li=row["radiance"] + torch.zeros_like(p),
                pdf=pdf + torch.zeros(shape, dtype=p.dtype, device=p.device),
                valid=torch.ones(shape, dtype=torch.bool, device=p.device))


def sample_sphere_light(row: dict, p: torch.Tensor, u1: torch.Tensor,
                        u2: torch.Tensor) -> dict:
    """A sphere light: a uniform direction in the cone of the sphere's
    visible cap, the segment to the sphere's near surface."""
    c = row["p0"] - p
    dist_c2 = torch.clamp(vmath.dot(c, c), min=1e-12)
    dist_c = vmath.sqrt_rn(dist_c2)
    axis = c / dist_c[..., None]
    r = row["radius"]
    sin_max2 = torch.clamp(r * r / dist_c2, 0.0, 1.0)
    cos_max = vmath.sqrt_rn(torch.clamp(1.0 - sin_max2, min=0.0))
    wi, pdf = sample_cone(axis, cos_max, u1, u2)
    b = vmath.dot(wi, c)
    det = torch.clamp(b * b - dist_c2 + r * r, min=0.0)
    dist = b - vmath.sqrt_rn(det)
    return dict(wi=wi, dist=torch.clamp(dist, min=1e-4),
                li=row["radiance"] + torch.zeros_like(p), pdf=pdf,
                valid=dist_c > r)


def mesh_point(tri_cdf: torch.Tensor, tri_pos: torch.Tensor,
               u1: torch.Tensor, u2: torch.Tensor):
    """A uniform point by area on a mesh's triangles: u1 picks a triangle
    by the (T+1,) area CDF tri_cdf and is rescaled into it, (u1, u2) warp
    to the triangle; tri_pos (T,3,3) holds the corners.  Returns the point
    and its triangle's unit normal, each (N,3)."""
    nt = tri_pos.shape[0]
    idx = torch.clamp(torch.searchsorted(tri_cdf, u1, right=True) - 1, 0,
                      nt - 1)
    lo = tri_cdf[idx]
    hi = tri_cdf[idx + 1]
    u1r = torch.clamp((u1 - lo) / torch.clamp(hi - lo, min=1e-12), 0.0,
                      1.0 - 1e-7)
    b0, b1 = sample_triangle(u1r, u2)
    tp = tri_pos[idx]  # (N,3,3)
    q = (b0[..., None] * tp[:, 0] + b1[..., None] * tp[:, 1]
         + (1.0 - b0 - b1)[..., None] * tp[:, 2])
    return q, vmath.normalize(vmath.cross(tp[:, 1] - tp[:, 0],
                                          tp[:, 2] - tp[:, 0]))


def sample_mesh_light(row: dict, p: torch.Tensor, u1: torch.Tensor,
                      u2: torch.Tensor, tri_cdf: torch.Tensor,
                      tri_pos: torch.Tensor) -> dict:
    """Uniform area sampling over a meshlight's (or portal's) triangles
    (`mesh_point`).  Emission is double-sided (|cos| at the light)."""
    q, ln = mesh_point(tri_cdf, tri_pos, u1, u2)
    d = q - p
    dist2 = torch.clamp(vmath.dot(d, d), min=1e-12)
    dist = vmath.sqrt_rn(dist2)
    wi = d / dist[..., None]
    cos_l = vmath.dot(ln, -wi).abs()
    pdf = dist2 / torch.clamp(row["area"] * torch.clamp(cos_l, min=1e-6),
                              min=1e-9)
    return dict(wi=wi, dist=dist, li=row["radiance"] + torch.zeros_like(p),
                pdf=pdf, valid=cos_l > 1e-6)


def pdf_hit_area(row: dict, p_from: torch.Tensor, hit_p: torch.Tensor,
                 hit_ng: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """The solid-angle pdf with which area sampling of an area / mesh light
    would have drawn a BSDF-sampled hit on it (the MIS counterpart)."""
    d = hit_p - p_from
    dist2 = torch.clamp(vmath.dot(d, d), min=1e-12)
    cos_l = vmath.dot(hit_ng, -wi).abs()
    return dist2 / torch.clamp(row["area"] * torch.clamp(cos_l, min=1e-6),
                               min=1e-9)


def sample_area(row: dict, p: torch.Tensor, u1: torch.Tensor,
                u2: torch.Tensor) -> dict:
    """Uniform area sample of the parallelogram light p0 + u1·e1 + u2·e2.
    Returns dict(wi (N,3), dist (N,), li (N,3), pdf (N,) solid angle,
    valid (N,))."""
    q = row["p0"] + u1[..., None] * row["e1"] + u2[..., None] * row["e2"]
    ln = vmath.normalize(vmath.cross(row["e1"], row["e2"])
                         + torch.zeros_like(p))
    d = q - p
    dist2 = torch.clamp(vmath.dot(d, d), min=1e-12)
    dist = vmath.sqrt_rn(dist2)
    wi = d / dist[..., None]
    cos_l = vmath.dot(ln, -wi)
    cos_l_eff = torch.where(row["double_sided"], cos_l.abs(), cos_l)
    pdf = dist2 / torch.clamp(
        row["area"] * torch.clamp(cos_l_eff, min=1e-6), min=1e-9)
    li = row["radiance"] + torch.zeros_like(p)
    return dict(wi=wi, dist=dist, li=li, pdf=pdf, valid=cos_l_eff > 1e-6)
