"""Background factory: ParamMap -> BackgroundSpec (port of the constant branch
of libyafaray_tpu/backgrounds/factory.py)."""
from __future__ import annotations

from ..scene.params import ParamMap
from .base import BG_CONSTANT, BackgroundSpec, check_supported


def background_from_params(params: ParamMap) -> BackgroundSpec:
    btype = params.get_str("type", "constant")
    if btype != "constant":
        raise NotImplementedError(
            f"background type {btype!r} is not ported yet: ROADMAP Queue 1 "
            "items 15 and 17")
    spec = BackgroundSpec(
        bg_type=BG_CONSTANT, power=params.get_float("power", 1.0),
        color=params.get_rgb("color", (0.0, 0.0, 0.0)),
        ibl=params.get_bool("ibl", False),
        ibl_samples=params.get_int("ibl_samples", 16),
    )
    check_supported(spec)
    return spec
