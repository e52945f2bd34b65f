"""Analytic sky backgrounds baked to a lat-long radiance grid (port of
libyafaray_tpu/backgrounds/sky.py; host numpy, so the grid equals the
reference's bit for bit).

Reference: src/backgrounds/sunsky.cc (Preetham) and darksky.cc
(Hosek-Wilkie).  The analytic model is evaluated once on the host over a
128 x 256 lat-long grid at scene build, and the background is a texture
background from then on: its eval and the IBL light's importance sampling
run the textureback path, a texture lookup a ray.

The Preetham model is the published formulation (turbidity-parameterized
Perez functions in xyY).  darksky takes the Hosek-Wilkie grid
(backgrounds/hosek.py) when the scene names a coefficient dataset, else the
Preetham grid, and applies the reference's exposure / bright / night
controls.
"""
from __future__ import annotations

import logging
import math

import numpy as np

from ..scene.params import ParamMap
from .base import BG_TEXTURE, BackgroundSpec

log = logging.getLogger("libyafaray_tpu_torch")


def _perez(theta, gamma, c):
    return (1.0 + c[0] * np.exp(c[1] / np.maximum(np.cos(theta), 0.01))) * (
        1.0 + c[2] * np.exp(c[3] * gamma) + c[4] * np.cos(gamma) ** 2
    )


def _preetham_grid(sun_dir, turbidity, res_v=128, res_u=256):
    t = turbidity
    # Perez coefficients for Y, x, y (Preetham et al. 1999)
    cy = [0.1787 * t - 1.4630, -0.3554 * t + 0.4275, -0.0227 * t + 5.3251,
          0.1206 * t - 2.5771, -0.0670 * t + 0.3703]
    cx = [-0.0193 * t - 0.2592, -0.0665 * t + 0.0008, -0.0004 * t + 0.2125,
          -0.0641 * t - 0.8989, -0.0033 * t + 0.0452]
    cyy = [-0.0167 * t - 0.2608, -0.0950 * t + 0.0092, -0.0079 * t + 0.2102,
           -0.0441 * t - 1.6537, -0.0109 * t + 0.0529]

    sd = np.asarray(sun_dir, np.float64)
    sd = sd / max(np.linalg.norm(sd), 1e-12)
    theta_s = math.acos(np.clip(sd[2], -1.0, 1.0))
    theta_s = min(theta_s, math.pi / 2 - 1e-3)

    # zenith values
    chi = (4.0 / 9.0 - t / 120.0) * (math.pi - 2.0 * theta_s)
    yz = (4.0453 * t - 4.9710) * math.tan(chi) - 0.2155 * t + 2.4192  # kcd/m2
    yz = max(yz, 1e-3)
    ts = theta_s
    tv = np.array([ts**3, ts**2, ts, 1.0])
    xz = np.array([
        [0.00166, -0.00375, 0.00209, 0.0],
        [-0.02903, 0.06377, -0.03202, 0.00394],
        [0.11693, -0.21196, 0.06052, 0.25886],
    ])
    xz = np.array([t * t, t, 1.0]) @ xz @ tv
    yyz = np.array([
        [0.00275, -0.00610, 0.00317, 0.0],
        [-0.04214, 0.08970, -0.04153, 0.00516],
        [0.15346, -0.26756, 0.06670, 0.26688],
    ])
    yyz = np.array([t * t, t, 1.0]) @ yyz @ tv

    v = (np.arange(res_v) + 0.5) / res_v
    u = (np.arange(res_u) + 0.5) / res_u
    theta = v * math.pi  # polar from +z
    phi = u * 2.0 * math.pi
    st, ct = np.sin(theta), np.cos(theta)
    dirs = np.stack(
        [
            np.outer(st, np.cos(phi)),
            np.outer(st, np.sin(phi)),
            np.outer(ct, np.ones_like(phi)),
        ],
        axis=-1,
    )  # (V,U,3)
    cos_g = np.clip(dirs @ sd, -1.0, 1.0)
    gamma = np.arccos(cos_g)
    th = np.minimum(theta[:, None] * np.ones_like(cos_g), math.pi / 2 - 1e-3)

    def ratio(c, th_, gm_):
        return _perez(th_, gm_, c) / max(_perez(0.0, theta_s, c), 1e-9)

    yy = yz * ratio(cy, th, gamma)
    xx = xz * ratio(cx, th, gamma)
    yyy = yyz * ratio(cyy, th, gamma)
    # xyY -> XYZ -> linear sRGB
    yyy = np.maximum(yyy, 1e-6)
    big_x = xx / yyy * yy
    big_z = (1.0 - xx - yyy) / yyy * yy
    xyz = np.stack([big_x, yy, big_z], axis=-1)
    m = np.array([
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ])
    rgb = xyz @ m.T
    rgb = np.maximum(rgb, 0.0) * 0.02  # kcd/m² -> scene-scale radiance
    # below horizon: fade to ground albedo-ish constant
    below = ct < 0.0
    horizon = rgb[res_v // 2 - 1 if res_v >= 2 else 0]
    rgb[below[:, 0] if below.ndim > 1 else below] = horizon * 0.2
    return rgb.astype(np.float32)


def bake_sky(btype: str, params: ParamMap):
    sun_from = np.asarray(params.get_point("from", (0.5, 0.5, 0.7)),
                          np.float64)
    turb = params.get_float("turbidity", 3.0)
    power = params.get_float("power", 1.0)
    grid = None
    if btype == "darksky":
        # Hosek-Wilkie evaluation path (backgrounds/hosek.py): genuine
        # HW radiance when a fitted-coefficient dataset is available
        # (scene param hw_dataset / env LIBYAF_HW_DATA), Preetham
        # stand-in otherwise.  Reference darksky.cc [H].
        from . import hosek

        path = hosek.find_dataset(params)
        if path:
            ds = hosek.load_hw_dataset(path)
            grid = hosek.hw_grid(
                ds, sun_from, max(1.0, min(turb, 10.0)),
                params.get_float("albedo", 0.2))
            log.info("darksky: Hosek-Wilkie grid from %s", path)
    if grid is None:
        grid = _preetham_grid(sun_from, max(1.8, min(turb, 10.0)))
        if btype == "darksky":
            log.info("darksky: using Preetham-baked grid (no Hosek-"
                     "Wilkie dataset file); exposure/night controls "
                     "applied")
    if btype == "darksky":
        exposure = params.get_float("exposure", 1.0)
        if exposure > 0:
            grid = 1.0 - np.exp(-grid * exposure)
        bright = params.get_float("bright", 1.0)
        grid = grid * bright
        if params.get_bool("night", False):
            grid = grid * np.asarray([0.05, 0.05, 0.2], np.float32)
    spec = BackgroundSpec(
        bg_type=BG_TEXTURE, power=power, mapping="sphere", rotation=0.0,
        ibl=params.get_bool("ibl", params.get_bool("background_light", False)),
        ibl_samples=params.get_int("ibl_samples",
                                   params.get_int("light_samples", 16)),
    )
    return spec, grid
