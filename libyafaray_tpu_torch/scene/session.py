"""Render session helpers (port of `build_config` from
libyafaray_tpu/scene/session.py)."""
from __future__ import annotations

from ..integrators.config import RenderConfig, config_from_params
from .params import ParamMap
from .scene import Scene

SURFACE_INTEGRATORS = ("directlighting", "pathtracing", "photonmapping",
                       "SPPM", "bidirectional", "DebugIntegrator")


def build_config(scene: Scene) -> RenderConfig:
    surf = ParamMap()
    vol = ParamMap()
    want = scene.render_params.get_str("integrator_name", "")
    want_vol = scene.render_params.get_str("volintegrator_name", "")
    for name, p in scene.integrator_params.items():
        t = p.get_str("type", "")
        if name == want or (not want and t in SURFACE_INTEGRATORS and
                            not surf):
            if t in SURFACE_INTEGRATORS:
                surf = p
        if name == want_vol or (not want_vol and
                                t in ("EmissionIntegrator",
                                      "SingleScatterIntegrator",
                                      "SkyIntegrator", "none")):
            vol = p
    if not surf:
        for p in scene.integrator_params.values():
            if p.get_str("type", "") in SURFACE_INTEGRATORS:
                surf = p
                break
    return config_from_params(scene.render_params, surf, vol)
