"""Hosek-Wilkie sky radiance model with loadable fitted-coefficient tables
(port of libyafaray_tpu/backgrounds/hosek.py; host numpy).

Reference role: src/backgrounds/darksky.cc and the ArHosekSkyModel data
headers.  The fitted datasets (Hosek & Wilkie 2012, "An Analytic Model for
Full Spectral Sky-Dome Radiance") are not shipped in the repository.  This
module implements the evaluation (quintic-Bezier solar-elevation
interpolation, turbidity / albedo lerp, the 9-coefficient radiance
distribution) over tables read from an ``.npz`` file named by the scene
parameter ``hw_dataset`` or the environment variable ``LIBYAF_HW_DATA``
(``scripts/convert_hosek_data.py`` converts the upstream C header).
Without one, darksky takes the Preetham grid (backgrounds/sky.py).

``.npz`` format (checked by :func:`load_hw_dataset`):

- ``config``:   float64 ``(C, 10, 2, 6, 9)`` — per channel (usually
  C=3 for RGB), 10 turbidities (1..10), 2 albedos (0, 1), 6 solar-
  elevation control points, 9 distribution coefficients A..I.
- ``radiance``: float64 ``(C, 10, 2, 6)`` — expected-value scale in
  the same indexing.

Model (paper eq. 3): for view zenith angle theta and sun angle gamma,

    F(theta, gamma) = (1 + A e^{B/(cos theta + 0.01)})
                      * (C + D e^{E gamma} + F cos^2 gamma
                         + G chi(H, gamma) + I sqrt(max(cos theta, 0)))
    chi(g, a) = (1 + cos^2 a) / (1 + g^2 - 2 g cos a)^{3/2}

    radiance  = F * R            (R from the ``radiance`` table)
"""
from __future__ import annotations

import logging
import math
import os

import numpy as np

log = logging.getLogger("libyafaray_tpu_torch")


def load_hw_dataset(path: str) -> dict:
    """Load and shape-check a Hosek-Wilkie ``.npz`` coefficient file."""
    with np.load(path) as z:
        config = np.asarray(z["config"], np.float64)
        radiance = np.asarray(z["radiance"], np.float64)
    if config.ndim != 5 or config.shape[1:] != (10, 2, 6, 9):
        raise ValueError(
            f"hw dataset 'config' must be (C, 10, 2, 6, 9), got "
            f"{config.shape}")
    if radiance.shape != config.shape[:4]:
        raise ValueError(
            f"hw dataset 'radiance' must be (C, 10, 2, 6), got "
            f"{radiance.shape}")
    return {"config": config, "radiance": radiance}


def _bezier5(ctrl: np.ndarray, x: float) -> np.ndarray:
    """Quintic Bernstein interpolation over the 6 control points on the
    LAST-but-one axis of ``ctrl`` (..., 6, K) -> (..., K).  This is the
    solar-elevation curve the HW fit uses (x = (2 elev / pi)^(1/3))."""
    x = float(np.clip(x, 0.0, 1.0))
    ix = 1.0 - x
    w = np.array([ix**5,
                  5.0 * x * ix**4,
                  10.0 * x**2 * ix**3,
                  10.0 * x**3 * ix**2,
                  5.0 * x**4 * ix,
                  x**5], np.float64)
    return np.tensordot(w, ctrl, axes=(0, ctrl.ndim - 2))


def _interp_tables(dataset: dict, turbidity: float, albedo: float,
                   elevation: float):
    """(coeffs (C, 9), rad (C,)) at the given turbidity in [1, 10],
    ground albedo in [0, 1] and solar elevation in [0, pi/2]."""
    config = dataset["config"]      # (C, 10, 2, 6, 9)
    radiance = dataset["radiance"]  # (C, 10, 2, 6)
    t = float(np.clip(turbidity, 1.0, 10.0))
    a = float(np.clip(albedo, 0.0, 1.0))
    ti = int(np.clip(math.floor(t) - 1, 0, 8))
    tf = t - (ti + 1)
    x = (2.0 * max(elevation, 0.0) / math.pi) ** (1.0 / 3.0)

    def at(tidx):
        lo = _bezier5(config[:, tidx, 0], x), radiance[:, tidx, 0] @ _bw(x)
        hi = _bezier5(config[:, tidx, 1], x), radiance[:, tidx, 1] @ _bw(x)
        return (lo[0] * (1 - a) + hi[0] * a,
                lo[1] * (1 - a) + hi[1] * a)

    c0, r0 = at(ti)
    c1, r1 = at(min(ti + 1, 9))
    return c0 * (1 - tf) + c1 * tf, r0 * (1 - tf) + r1 * tf


def _bw(x: float) -> np.ndarray:
    x = float(np.clip(x, 0.0, 1.0))
    ix = 1.0 - x
    return np.array([ix**5, 5 * x * ix**4, 10 * x**2 * ix**3,
                     10 * x**3 * ix**2, 5 * x**4 * ix, x**5], np.float64)


def hw_radiance(coeffs: np.ndarray, rad: np.ndarray, cos_theta,
                cos_gamma):
    """Vectorized HW distribution: coeffs (C, 9), rad (C,), cos_theta /
    cos_gamma broadcastable arrays -> radiance (..., C)."""
    ct = np.maximum(np.asarray(cos_theta, np.float64), 0.0)
    cg = np.clip(np.asarray(cos_gamma, np.float64), -1.0, 1.0)
    gamma = np.arccos(cg)
    out = []
    for c in range(coeffs.shape[0]):
        A, B, C_, D, E, F_, G, H, I = coeffs[c]
        chi = (1.0 + cg * cg) / np.power(
            np.maximum(1.0 + H * H - 2.0 * H * cg, 1e-12), 1.5)
        f = (1.0 + A * np.exp(B / (ct + 0.01))) * (
            C_ + D * np.exp(E * gamma) + F_ * cg * cg + G * chi
            + I * np.sqrt(ct))
        out.append(f * rad[c])
    return np.stack(out, axis=-1)


def hw_grid(dataset: dict, sun_dir, turbidity: float, albedo: float,
            res_v: int = 128, res_u: int = 256) -> np.ndarray:
    """Bake the HW model to the same (V, U, 3) lat-long radiance grid
    sky.py uses (theta = v*pi from +z).  Channels beyond 3 are reduced
    to RGB by truncation; 1-channel datasets broadcast."""
    sd = np.asarray(sun_dir, np.float64)
    sd = sd / max(np.linalg.norm(sd), 1e-12)
    elevation = math.asin(np.clip(sd[2], -1.0, 1.0))
    coeffs, rad = _interp_tables(dataset, turbidity, albedo,
                                 max(elevation, 0.0))
    v = (np.arange(res_v) + 0.5) / res_v
    u = (np.arange(res_u) + 0.5) / res_u
    theta = v * math.pi
    phi = u * 2.0 * math.pi
    st, ct = np.sin(theta), np.cos(theta)
    dirs = np.stack([np.outer(st, np.cos(phi)),
                     np.outer(st, np.sin(phi)),
                     np.outer(ct, np.ones_like(phi))], axis=-1)
    cos_g = dirs @ sd
    rgb = hw_radiance(coeffs, rad, ct[:, None], cos_g)
    if rgb.shape[-1] == 1:
        rgb = np.repeat(rgb, 3, axis=-1)
    rgb = np.maximum(rgb[..., :3], 0.0)
    # below horizon: same ground fade convention as the Preetham bake
    below = ct < 0.0
    horizon = rgb[max(res_v // 2 - 1, 0)]
    rgb[below] = horizon * 0.2
    return rgb.astype(np.float32)


def find_dataset(params=None) -> str | None:
    """Dataset path resolution: scene param ``hw_dataset`` wins, then
    env ``LIBYAF_HW_DATA``; None when neither names an existing file."""
    cand = []
    if params is not None:
        p = params.get_str("hw_dataset", "")
        if p:
            cand.append(p)
    env = os.environ.get("LIBYAF_HW_DATA", "")
    if env:
        cand.append(env)
    for p in cand:
        if os.path.isfile(p):
            return p
        log.warning("darksky: hw dataset %r not found", p)
    return None
