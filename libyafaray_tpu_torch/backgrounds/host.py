"""Host-side (numpy) baking of a constant or gradient background to a
lat-long map, so that `ibl` on such a background samples it like a texture
(port of libyafaray_tpu/backgrounds/host.py)."""
from __future__ import annotations

import numpy as np

from .base import BG_CONSTANT, BG_GRADIENT, BackgroundSpec


def bake_background_np(spec: BackgroundSpec, h: int, w: int) -> np.ndarray:
    """(h, w, 3) lat-long grid of the background (power not folded: the
    lookups multiply spec.power).  Rows are theta / pi from the +z pole;
    other types bake black."""
    v = (np.arange(h) + 0.5) / h
    z = np.cos(v * np.pi)
    img = np.zeros((h, w, 3), np.float32)
    if spec.bg_type == BG_CONSTANT:
        img[:] = np.asarray(spec.color, np.float32)
        return img
    if spec.bg_type == BG_GRADIENT:
        t = np.clip(np.abs(z), 0.0, 1.0)[:, None]
        sky = (1 - t) * np.asarray(spec.horizon_color) + t * np.asarray(
            spec.zenith_color)
        ground = (1 - t) * np.asarray(spec.horizon_ground_color) + t * \
            np.asarray(spec.zenith_ground_color)
        row = np.where((z >= 0)[:, None], sky, ground).astype(np.float32)
        img[:] = row[:, None, :]
    return img
