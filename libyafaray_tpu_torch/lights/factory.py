"""Light factory: ParamMap -> light table row + emissive geometry (port of the
`arealight` and `bglight` branches of libyafaray_tpu/lights/factory.py;
the other light types raise until ROADMAP Queue 1 item 17 ports them).
A scene makes its bglight itself from an `ibl` background
(scene/scene.py); the factory's branch is the same row."""
from __future__ import annotations

import math

import numpy as np

from ..scene.params import ParamMap
from .base import LT_AREA, LT_BACKGROUND, default_light_row


def bg_light_row(samples: int) -> dict:
    """The IBL light's row: `samples` NEE samples a first vertex,
    intersectable (its MIS counterpart is the background escape)."""
    row = default_light_row()
    row["ltype"] = LT_BACKGROUND
    row["samples"] = max(1, samples)
    row["intersectable"] = True
    return row


def light_from_params(params: ParamMap):
    """Returns (row, geometry): geometry is a dict with the panel's two
    triangles `pos` (2,3,3) and its emitted `radiance`, which the scene
    attaches with a light_mat row so BSDF-sampled hits see the light."""
    lt = params.get_str("type", "pointlight")
    if lt == "bglight":
        row = bg_light_row(params.get_int("ibl_samples",
                                          params.get_int("samples", 16)))
        row["enabled"] = params.get_bool("light_enabled", True)
        row["cast_shadows"] = params.get_bool("cast_shadows", True)
        row["photon_only"] = params.get_bool("photon_only", False)
        return row, None
    if lt != "arealight":
        raise NotImplementedError(
            f"light type {lt!r} is not ported yet: ROADMAP Queue 1 item 17")
    row = default_light_row()
    row["enabled"] = params.get_bool("light_enabled", True)
    row["cast_shadows"] = params.get_bool("cast_shadows", True)
    row["photon_only"] = params.get_bool("photon_only", False)
    row["samples"] = max(1, params.get_int("samples", 1))
    color = np.asarray(params.get_rgb("color", (1.0, 1.0, 1.0)), np.float64)
    power = params.get_float("power", 1.0)

    row["ltype"] = LT_AREA
    corner = np.asarray(params.get_point("corner"), np.float64)
    p1 = np.asarray(params.get_point("point1"), np.float64)
    p2 = np.asarray(params.get_point("point2"), np.float64)
    e1 = p1 - corner
    e2 = p2 - corner
    area = float(np.linalg.norm(np.cross(e1, e2)))
    row["p0"] = tuple(corner)
    row["e1"] = tuple(e1)
    row["e2"] = tuple(e2)
    row["area"] = max(area, 1e-12)
    # radiance from total flux: L = Φ/(π·A)
    rad = color * power / (math.pi * max(area, 1e-12))
    row["radiance"] = tuple(rad)
    row["intersectable"] = True
    c = corner
    q = [c, c + e1, c + e1 + e2, c + e2]
    tris = np.asarray([[q[0], q[1], q[2]], [q[0], q[2], q[3]]], np.float32)
    return row, dict(pos=tris, radiance=tuple(rad))
