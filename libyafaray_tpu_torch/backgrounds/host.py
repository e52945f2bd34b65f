"""Host-side (numpy) baking of a constant background to a lat-long map, so
that `ibl` on a constant background samples it like a texture (port of the
constant branch of libyafaray_tpu/backgrounds/host.py)."""
from __future__ import annotations

import numpy as np

from .base import BG_CONSTANT, BackgroundSpec


def bake_background_np(spec: BackgroundSpec, h: int, w: int) -> np.ndarray:
    """(h, w, 3) lat-long grid of the background (power not folded: the
    lookups multiply spec.power)."""
    if spec.bg_type != BG_CONSTANT:
        raise NotImplementedError(
            f"baking background type {spec.bg_type} is not ported yet: "
            "ROADMAP Queue 1 item 17 (gradient, sunsky, darksky)")
    img = np.zeros((h, w, 3), np.float32)
    img[:] = np.asarray(spec.color, np.float32)
    return img
