"""Light factory: ParamMap -> light table row + emissive geometry (port of
libyafaray_tpu/lights/factory.py, every light type of the reference).
A scene makes its bglight itself from an `ibl` background
(scene/scene.py); the factory's branch is the same row.  Meshlight and
portal rows carry `_object`, `_color` and `_power`, resolved against the
scene's meshes at compile; an IES row carries `_ies_profile`."""
from __future__ import annotations

import logging
import math

import numpy as np

from ..scene.mesh import make_sphere_mesh
from ..scene.params import ParamMap
from .base import (LT_AREA, LT_BACKGROUND, LT_DIRECTIONAL, LT_IES, LT_MESH,
                   LT_POINT, LT_PORTAL, LT_SPHERE, LT_SPOT, LT_SUN,
                   default_light_row)
from .ies import PROFILE_RES, parse_ies

log = logging.getLogger("libyafaray_tpu_torch")


def bg_light_row(samples: int) -> dict:
    """The IBL light's row: `samples` NEE samples a first vertex,
    intersectable (its MIS counterpart is the background escape)."""
    row = default_light_row()
    row["ltype"] = LT_BACKGROUND
    row["samples"] = max(1, samples)
    row["intersectable"] = True
    return row


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v / max(np.linalg.norm(v), 1e-12)


def _scene_dir(params: ParamMap) -> tuple:
    """Sun and directional lights: `direction` (or `from`) points toward
    the light; the row stores the light -> scene direction."""
    return tuple(-_unit(params.get_point(
        "direction", params.get_point("from", (0, 0, 1)))))


def light_from_params(params: ParamMap):
    """Returns (row, geometry): geometry is None or a dict with the light's
    triangles `pos` (T,3,3) and its emitted `radiance`, which the scene
    attaches with a light_mat row so BSDF-sampled hits see the light (the
    area light's panel, the sphere light's 320-face icosphere).  An
    unknown type becomes a point light, with a warning."""
    lt = params.get_str("type", "pointlight")
    if lt == "bglight":
        row = bg_light_row(params.get_int("ibl_samples",
                                          params.get_int("samples", 16)))
        row["enabled"] = params.get_bool("light_enabled", True)
        row["cast_shadows"] = params.get_bool("cast_shadows", True)
        row["photon_only"] = params.get_bool("photon_only", False)
        return row, None
    row = default_light_row()
    row["enabled"] = params.get_bool("light_enabled", True)
    row["cast_shadows"] = params.get_bool("cast_shadows", True)
    row["photon_only"] = params.get_bool("photon_only", False)
    row["samples"] = max(1, params.get_int("samples", 1))
    color = np.asarray(params.get_rgb("color", (1.0, 1.0, 1.0)), np.float64)
    power = params.get_float("power", 1.0)
    geometry = None

    if lt == "spotlight":
        row["ltype"] = LT_SPOT
        row["p0"] = params.get_point("from")
        to = np.asarray(params.get_point("to"), np.float64)
        row["direction"] = tuple(_unit(to - np.asarray(row["p0"],
                                                       np.float64)))
        cone = params.get_float("cone_angle", 45.0)
        blend = params.get_float("blend", 0.15)
        row["cos_start"] = math.cos(math.radians(cone * (1.0 - blend)))
        row["cos_end"] = math.cos(math.radians(cone))
        row["spot_blend"] = blend
        row["intensity"] = tuple(color * power)
        row["is_delta"] = True
        # soft shadows: the emitter's jitter disk radius (0 = hard delta)
        if params.get_bool("soft_shadows", False):
            row["radius"] = params.get_float("shadowFuzzyness", 1.0)
            row["samples"] = max(row["samples"],
                                 params.get_int("samples", 8))

    elif lt in ("sunlight", "sun"):
        row["ltype"] = LT_SUN
        row["direction"] = _scene_dir(params)
        angle = params.get_float("angle", 0.27)  # angular radius, degrees
        row["cos_angle"] = math.cos(math.radians(max(angle, 1e-4)))
        row["radiance"] = tuple(color * power)

    elif lt == "directional":
        row["ltype"] = LT_DIRECTIONAL
        row["direction"] = _scene_dir(params)
        row["intensity"] = tuple(color * power)
        row["is_delta"] = True

    elif lt == "spherelight":
        row["ltype"] = LT_SPHERE
        row["p0"] = params.get_point("from")
        r = params.get_float("radius", 1.0)
        row["radius"] = r
        # radiance from total flux: L = Φ/(π·4πr²)
        rad = color * power / (4.0 * math.pi * math.pi * r * r)
        row["radiance"] = tuple(rad)
        row["area"] = 4.0 * math.pi * r * r
        # intersectable: an emissive icosphere, whose BSDF-sampled hits
        # the engine MIS-weights with the cone pdf of the NEE sampler
        row["intersectable"] = True
        geometry = dict(pos=make_sphere_mesh(row["p0"], r, 0,
                                             subdiv=2)["pos"],
                        radiance=tuple(rad))

    elif lt == "arealight":
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
        geometry = dict(pos=np.asarray([[q[0], q[1], q[2]],
                                        [q[0], q[2], q[3]]], np.float32),
                        radiance=tuple(rad))

    elif lt == "meshlight":
        # the object's triangles, area and radiance are resolved by the
        # scene at compile (the object keeps its own material)
        row["ltype"] = LT_MESH
        row["intersectable"] = True
        row["double_sided"] = params.get_bool("double_sided", False)
        row["_object"] = params.get_str("object_name",
                                        str(params.get_int("object", 0)))
        row["_color"] = tuple(color)
        row["_power"] = power

    elif lt == "bgPortalLight":
        # area-samples the portal object, radiance from the background
        # along the sampled direction times `power`; with a portal (and
        # no IBL light) the background reaches non-specular vertices
        # through this light only (the engine zeroes their escapes)
        row["ltype"] = LT_PORTAL
        row["_object"] = params.get_str("object_name",
                                        str(params.get_int("object", 0)))
        row["_color"] = (1.0, 1.0, 1.0)
        row["_power"] = params.get_float("power", 1.0)
        row["power"] = row["_power"]
        row["samples"] = max(1, params.get_int("samples", 16))
        row["intersectable"] = False

    elif lt == "ieslight":
        row["ltype"] = LT_IES
        row["p0"] = params.get_point("from")
        d = (np.asarray(params.get_point("to", (0, 0, -1)), np.float64)
             - np.asarray(row["p0"], np.float64))
        n = np.linalg.norm(d)
        row["direction"] = tuple(d / n) if n > 1e-12 else (0.0, 0.0, -1.0)
        row["intensity"] = tuple(color * power)
        row["is_delta"] = True
        ies_file = params.get_str("file", params.get_str("filename", ""))
        try:
            row["_ies_profile"] = parse_ies(ies_file)
        except Exception as e:  # noqa: BLE001 -- warn, isotropic profile
            log.warning("ieslight: cannot parse %r (%s); isotropic",
                        ies_file, e)
            row["_ies_profile"] = np.ones(PROFILE_RES, np.float32)

    else:
        if lt != "pointlight":
            log.warning("unknown light type %r; using pointlight", lt)
        row["ltype"] = LT_POINT
        row["p0"] = params.get_point("from")
        row["intensity"] = tuple(color * power)
        row["is_delta"] = True

    return row, geometry
