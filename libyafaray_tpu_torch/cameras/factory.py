"""Camera factory: ParamMap -> Camera (port of
libyafaray_tpu/cameras/factory.py)."""
from __future__ import annotations

import logging

from ..scene.params import ParamMap
from .base import (
    CAM_ANGULAR, CAM_ARCHITECT, CAM_EQUIRECT, CAM_ORTHO, CAM_PERSPECTIVE,
    Camera,
)

log = logging.getLogger("libyafaray_tpu_torch")

_TYPES = {
    "perspective": CAM_PERSPECTIVE,
    "architect": CAM_ARCHITECT,
    "angular": CAM_ANGULAR,
    "orthographic": CAM_ORTHO,
    "equirectangular": CAM_EQUIRECT,
}


def camera_from_params(params: ParamMap) -> Camera:
    tname = params.get_str("type", "perspective")
    if tname not in _TYPES:
        log.warning("unknown camera type %r; using perspective", tname)
        tname = "perspective"
    return Camera.from_lookat(
        _TYPES[tname],
        params.get_int("resx", 512),
        params.get_int("resy", 512),
        params.get_point("from", (0.0, -1.0, 0.0)),
        params.get_point("to", (0.0, 0.0, 0.0)),
        params.get_point("up", (0.0, -1.0, 1.0)),
        focal=params.get_float("focal", 1.0),
        aperture=params.get_float("aperture", 0.0),
        dof_distance=params.get_float("dof_distance",
                                      params.get_float("focal_distance", 1.0)),
        bokeh_type=params.get_str("bokeh_type", "disk1"),
        bokeh_rotation=params.get_float("bokeh_rotation", 0.0),
        bokeh_bias=params.get_str("bokeh_bias", "uniform"),
        aspect_ratio=params.get_float("aspect_ratio", 1.0),
        angle_deg=params.get_float("angle", 90.0),
        circular=params.get_bool("circular", True),
        mirrored=params.get_bool("mirrored", False),
        max_angle_deg=params.get_float("max_angle", 0.0),
        scale=params.get_float("scale", 1.0),
        near_clip=params.get_float("nearClip", 0.0),
        far_clip=params.get_float("farClip", -1.0),
    )
