"""Texture factory (port of libyafaray_tpu/textures/factory.py).

Image textures load through io/image.py into linear float32; procedural
textures (clouds, marble, wood, voronoi, musgrave, distorted_noise, blend,
rgb_cube) are host records whose evaluation lives in
textures/procedural.py.  A texture's `spec` is the static tuple the
shading code dispatches on; mipmapped image textures add a vertical mip
atlas (`build_mip_atlas`) beside the image.  All numpy.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from ..scene.params import ParamMap

log = logging.getLogger("libyafaray_tpu_torch")


def _parse_ramp(params: ParamMap):
    """Color ramp: up to N stops (position, r, g, b), linear or constant
    interpolation of the texture intensity; None without one."""
    if not params.get_bool("use_color_ramp", False):
        return None
    n = params.get_int("ramp_num_items", 0)
    if n <= 0:
        return None
    items = []
    for i in range(n):
        c = params.get_color(f"ramp_item_{i}_color", (0.0, 0.0, 0.0, 1.0))
        pos = params.get_float(f"ramp_item_{i}_position",
                               i / max(n - 1, 1))
        items.append((float(pos), float(c[0]), float(c[1]), float(c[2])))
    items.sort()
    mode = params.get_str("ramp_interpolation", "linear").lower()
    return (mode, tuple(items))


def _parse_image_window(params: ParamMap):
    """Image-texture uv window: (xrepeat, yrepeat, crop or None, clipping
    mode, rot90, even_tiles, odd_tiles)."""
    crop = (params.get_float("cropmin_x", 0.0),
            params.get_float("cropmin_y", 0.0),
            params.get_float("cropmax_x", 1.0),
            params.get_float("cropmax_y", 1.0))
    if crop == (0.0, 0.0, 1.0, 1.0):
        crop = None
    return (params.get_int("xrepeat", 1),
            params.get_int("yrepeat", 1),
            crop,
            params.get_str("clipping", "repeat").lower(),
            params.get_bool("rot90", False),
            params.get_bool("even_tiles", True),
            params.get_bool("odd_tiles", False))


def mip_level_meta(h: int, w: int) -> tuple:
    """Per-level (y0, h, w) of the vertical mip atlas: level 0 at rows
    [0, h), level k below it at half the previous size, down to a side
    of 1."""
    levels = []
    y0 = 0
    lh, lw = h, w
    while True:
        levels.append((y0, lh, lw))
        if lh <= 1 or lw <= 1:
            break
        y0 += lh
        lh = max(1, lh // 2)
        lw = max(1, lw // 2)
    return tuple(levels)


def build_mip_atlas(img: np.ndarray) -> np.ndarray:
    """(H, W, C) -> vertical atlas (sum of level heights, W, C): level 0 on
    top, each further level a 2x2 box-filter downsample (odd sides padded
    by their last row or column)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    levels = mip_level_meta(h, w)
    total_h = levels[-1][0] + levels[-1][1]
    atlas = np.zeros((total_h, w, img.shape[2]), np.float32)
    cur = img
    for (y0, lh, lw) in levels:
        if cur.shape[0] != lh or cur.shape[1] != lw:
            src = cur
            if src.shape[0] % 2:
                src = np.concatenate([src, src[-1:]], axis=0)
            if src.shape[1] % 2:
                src = np.concatenate([src, src[:, -1:]], axis=1)
            cur = 0.25 * (src[0::2, 0::2] + src[1::2, 0::2]
                          + src[0::2, 1::2] + src[1::2, 1::2])
            cur = cur[:lh, :lw]
        atlas[y0:y0 + lh, :lw] = cur
    return atlas


@dataclass
class HostTexture:
    tex_type: str
    params: ParamMap
    image: np.ndarray | None = None  # (H, W, 3|4) linear float32
    use_alpha: bool = False
    interpolate: str = "bilinear"

    @property
    def spec(self) -> tuple:
        """The static spec the shading code dispatches on:
        ("image", window, ramp, interpolate, mips) with `mips` the atlas
        level table in a mipmap mode (else None), or (type, sorted scalar
        params, ramp) for a procedural."""
        ramp = _parse_ramp(self.params)
        if self.tex_type == "image":
            mips = None
            if (self.interpolate.startswith("mipmap")
                    and self.image is not None):
                mips = mip_level_meta(self.image.shape[0],
                                      self.image.shape[1])
            return ("image", _parse_image_window(self.params), ramp,
                    self.interpolate, mips)
        frozen = tuple(sorted(
            (k, v) for k, v in self.params.items()
            if isinstance(v, (int, float, str, bool))))
        return (self.tex_type, frozen, ramp)


def texture_from_params(params: ParamMap) -> HostTexture:
    """A texture from its <texture> parameters.  An image that does not
    load becomes a 16x16 checker with a warning, as in the reference;
    `filename` is relative to the working directory."""
    ttype = params.get_str("type", "image")
    tex = HostTexture(tex_type=ttype, params=ParamMap(params))
    if ttype == "image":
        from ..io.image import load_image

        fname = params.get_str("filename", "")
        tex.interpolate = params.get_str("interpolate", "bilinear")
        tex.use_alpha = params.get_bool("use_alpha", False)
        try:
            tex.image = load_image(fname,
                                   color_space=params.get_str("color_space",
                                                              ""),
                                   gamma=params.get_float("gamma", 1.0))
        except Exception as e:  # noqa: BLE001 - parity: warn, don't fail
            log.warning("texture: cannot load %r (%s); using checker",
                        fname, e)
            c = np.indices((16, 16)).sum(axis=0) % 2
            tex.image = np.stack([c, c, c], axis=-1).astype(np.float32)
    return tex
