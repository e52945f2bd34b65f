"""Background factory: ParamMap -> (BackgroundSpec, image or None) (port of
libyafaray_tpu/backgrounds/factory.py: constant, gradient, textureback, and
sunsky / darksky baked to a lat-long map (backgrounds/sky.py); an unknown
type warns and renders black), and `blur_env_map`, the IBL light's
prefilter."""
from __future__ import annotations

import logging

import numpy as np

from ..scene.params import ParamMap
from .base import BG_CONSTANT, BG_GRADIENT, BG_TEXTURE, BackgroundSpec

log = logging.getLogger("libyafaray_tpu_torch")


def background_from_params(params: ParamMap, textures: dict | None = None):
    """textures: name -> host texture with .image (H, W, 3|4).  A missing
    texture gives a black 2x2 map with a warning, as in the reference."""
    btype = params.get_str("type", "constant")
    power = params.get_float("power", 1.0)
    ibl = params.get_bool("ibl", False)
    ibl_samples = params.get_int("ibl_samples", 16)
    if btype == "constant":
        return BackgroundSpec(
            bg_type=BG_CONSTANT, power=power,
            color=params.get_rgb("color", (0.0, 0.0, 0.0)),
            ibl=ibl, ibl_samples=ibl_samples), None
    if btype == "gradient":
        return BackgroundSpec(
            bg_type=BG_GRADIENT, power=power,
            horizon_color=params.get_rgb("horizon_color", (0.8, 0.9, 1.0)),
            zenith_color=params.get_rgb("zenith_color", (0.1, 0.3, 0.8)),
            horizon_ground_color=params.get_rgb("horizon_ground_color",
                                                (0.6, 0.6, 0.6)),
            zenith_ground_color=params.get_rgb("zenith_ground_color",
                                               (0.3, 0.3, 0.3)),
            ibl=ibl, ibl_samples=ibl_samples), None
    if btype in ("textureback", "texture"):
        tex_name = params.get_str("texture", "")
        if textures and tex_name in textures:
            img = np.asarray(textures[tex_name].image, np.float32)
        else:
            log.warning("textureback: texture %r not found; black bg",
                        tex_name)
            img = np.zeros((2, 2, 3), np.float32)
        return BackgroundSpec(
            bg_type=BG_TEXTURE, power=power,
            mapping=("probe" if params.get_str("mapping", "sphere")
                     in ("probe", "angular") else "sphere"),
            rotation=params.get_float("rotation", 0.0),
            ibl=ibl, ibl_samples=ibl_samples,
            ibl_blur=params.get_float("ibl_blur", 0.0)), img
    if btype in ("sunsky", "darksky"):
        from .sky import bake_sky
        return bake_sky(btype, params)
    log.warning("unknown background type %r; black", btype)
    return BackgroundSpec(), None


def blur_env_map(img: np.ndarray, ibl_blur: float) -> np.ndarray:
    """Gaussian prefilter of a lat-long map for ibl_blur: wraps in
    longitude, clamps in latitude; sigma_uv = ibl_blur² / 2."""
    from scipy.ndimage import gaussian_filter1d

    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    sig_u = 0.5 * ibl_blur * ibl_blur * w
    sig_v = 0.5 * ibl_blur * ibl_blur * h
    out = gaussian_filter1d(img, max(sig_u, 1e-3), axis=1, mode="wrap")
    out = gaussian_filter1d(out, max(sig_v, 1e-3), axis=0, mode="nearest")
    return out.astype(np.float32)
