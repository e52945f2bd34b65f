"""Backgrounds (port of libyafaray_tpu/backgrounds/base.py: the spec record,
`eval_background` (none, constant, gradient, texture), and the lat-long and
angular-probe direction <-> uv maps the IBL light shares).  The sunsky and
darksky backgrounds are baked on the host to a lat-long map
(backgrounds/sky.py) and evaluate as texture backgrounds."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core.math import div, sqrt_rn

BG_NONE = -1
BG_CONSTANT = 0
BG_GRADIENT = 1
BG_TEXTURE = 2
BG_SUNSKY = 3
BG_DARKSKY = 4


@dataclass(frozen=True)
class BackgroundSpec:
    bg_type: int = BG_NONE
    power: float = 1.0
    color: tuple = (0.0, 0.0, 0.0)
    horizon_color: tuple = (0.0, 0.0, 0.0)
    zenith_color: tuple = (0.0, 0.0, 0.0)
    horizon_ground_color: tuple = (0.0, 0.0, 0.0)
    zenith_ground_color: tuple = (0.0, 0.0, 0.0)
    mapping: str = "sphere"  # sphere (lat-long) | probe (angular)
    rotation: float = 0.0
    ibl: bool = False
    ibl_samples: int = 16
    # the IBL light's lookups (NEE, its sampling table) read a gaussian-
    # blurred copy of the map; the visible background stays sharp
    ibl_blur: float = 0.0
    with_caustic: bool = True
    with_diffuse: bool = True


def eval_background(spec: BackgroundSpec, bg_image, d: torch.Tensor):
    """Radiance of escaping rays with direction d (N, 3).  bg_image: the
    (Hb, Wb, 3) map of a texture background (None otherwise), read at the
    nearest texel."""
    if spec.bg_type == BG_NONE:
        return torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32,
                           device=d.device)
    if spec.bg_type == BG_CONSTANT:
        c = torch.tensor(spec.color, dtype=torch.float32, device=d.device) \
            * spec.power
        return c.expand(d.shape[:-1] + (3,))
    if spec.bg_type == BG_GRADIENT:
        # sky colors above the horizon, ground colors below, each blended
        # from horizon to zenith by |z|
        def col(c):
            return torch.tensor(c, dtype=torch.float32, device=d.device)

        z = d[..., 2]
        t = torch.clamp(z.abs(), 0.0, 1.0)[..., None]
        sky = (1.0 - t) * col(spec.horizon_color) + t * col(spec.zenith_color)
        ground = ((1.0 - t) * col(spec.horizon_ground_color)
                  + t * col(spec.zenith_ground_color))
        return torch.where((z >= 0.0)[..., None], sky, ground) * spec.power
    if spec.bg_type != BG_TEXTURE:
        raise ValueError(f"background type {spec.bg_type} not compiled here")
    u, v = dir_to_uv(spec, d)
    hb, wb = bg_image.shape[0], bg_image.shape[1]
    x = torch.clamp((u * wb).to(torch.int32), 0, wb - 1)
    y = torch.clamp((v * hb).to(torch.int32), 0, hb - 1)
    return bg_image[y.long(), x.long()] * spec.power


def dir_to_uv(spec: BackgroundSpec, d: torch.Tensor):
    """Direction -> texture uv: lat-long with z up (sphere) or the angular
    probe map, rotated `rotation` degrees about z."""
    if spec.mapping == "probe":
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        r = div(torch.acos(torch.clamp(-dy, -1.0, 1.0)), math.pi)
        denom = torch.clamp(sqrt_rn(dx * dx + dz * dz), min=1e-9)
        return 0.5 + 0.5 * r * dx / denom, 0.5 + 0.5 * r * dz / denom
    phi = torch.atan2(d[..., 1], d[..., 0]) + spec.rotation * math.pi / 180.0
    u = div(phi, 2.0 * math.pi) % 1.0
    v = div(torch.acos(torch.clamp(d[..., 2], -1.0, 1.0)), math.pi)
    return u, v


def uv_to_dir(spec: BackgroundSpec, u: torch.Tensor, v: torch.Tensor):
    """The inverse of dir_to_uv for lat-long maps (IBL sampling)."""
    phi = u * 2.0 * math.pi - spec.rotation * math.pi / 180.0
    theta = v * math.pi
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                        torch.cos(theta)], dim=-1)
