"""Light table + area-light sampling (port of libyafaray_tpu/lights/base.py:
the LT_* codes, the table layout, `light_row` and `sample_area`).

Radiometric convention of the area light: radiance L = color·power/(π·A),
sampled uniformly by area and MIS-weighted against BSDF sampling.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import math as vmath

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
    dist = torch.sqrt(dist2)
    wi = d / dist[..., None]
    cos_l = vmath.dot(ln, -wi)
    cos_l_eff = torch.where(row["double_sided"], cos_l.abs(), cos_l)
    pdf = dist2 / torch.clamp(
        row["area"] * torch.clamp(cos_l_eff, min=1e-6), min=1e-9)
    li = row["radiance"] + torch.zeros_like(p)
    return dict(wi=wi, dist=dist, li=li, pdf=pdf, valid=cos_l_eff > 1e-6)
