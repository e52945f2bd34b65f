"""Material factory: ParamMap -> material table row (port of
libyafaray_tpu/materials/factory.py without the shader-node resolution,
which raises until textures are ported)."""
from __future__ import annotations

import math

from ..scene.params import ParamMap
from .base import MATERIAL_TYPE_NAMES, MT_BLEND, MT_GLASS, MT_LIGHT, \
    MT_MASK, MT_ROUGH_GLASS, default_row

_SHADER_KEYS = (
    "diffuse_shader", "glossy_shader", "bump_shader", "mirror_color_shader",
    "transparency_shader", "translucency_shader", "blend_shader",
    "mask_shader", "sigma_oren_shader", "IOR_shader")


def material_row_from_params(params: ParamMap, mat_name_to_id: dict) -> dict:
    mtype_name = params.get_str("type", "shinydiffusemat")
    if mtype_name not in MATERIAL_TYPE_NAMES:
        raise NotImplementedError(
            f"material type {mtype_name!r} is unknown to the port")
    if "__list__" in params or any(params.get_str(k, "")
                                   for k in _SHADER_KEYS):
        raise NotImplementedError(
            "textured materials and shader nodes are not ported yet: "
            "ROADMAP Queue 1 item 15")
    row = default_row()
    row["mtype"] = MATERIAL_TYPE_NAMES[mtype_name]

    # common / shinydiffuse
    row["diffuse_color"] = params.get_rgb("color", params.get_rgb(
        "diffuse_color", (0.8, 0.8, 0.8)))
    row["mirror_color"] = params.get_rgb("mirror_color", (1.0, 1.0, 1.0))
    row["diffuse_reflect"] = params.get_float("diffuse_reflect", 1.0)
    row["specular_reflect"] = params.get_float("specular_reflect", 0.0)
    row["transparency"] = params.get_float("transparency", 0.0)
    row["translucency"] = params.get_float("translucency", 0.0)
    row["emit_strength"] = params.get_float("emit", 0.0)
    row["fresnel_effect"] = params.get_bool("fresnel_effect", False)
    row["ior"] = params.get_float("IOR", 1.0)
    row["sigma"] = params.get_float("sigma", 0.0)
    row["receive_shadows"] = params.get_bool("receive_shadows", True)
    row["sampling_factor"] = params.get_float(
        "samplingfactor", params.get_float("sampling_factor", 1.0))
    row["additional_depth"] = float(params.get_int(
        "additionaldepth", params.get_int("additional_depth", 0)))

    # glossy family
    row["glossy_color"] = params.get_rgb("glossy_color", (1.0, 1.0, 1.0))
    row["glossy_reflect"] = params.get_float("glossy_reflect", 1.0)
    row["exponent"] = params.get_float("exponent", 50.0)
    row["anisotropic"] = params.get_bool("anisotropic", False)
    row["exp_u"] = params.get_float("exp_u", 50.0)
    row["exp_v"] = params.get_float("exp_v", 50.0)
    row["as_diffuse"] = params.get_bool("as_diffuse", False)

    # glass family (rough glass: table columns only, the family raises)
    if row["mtype"] in (MT_GLASS, MT_ROUGH_GLASS):
        row["ior"] = params.get_float("IOR", 1.5)
        row["filter_color"] = params.get_rgb("filter_color", (1.0, 1.0, 1.0))
        absorp = params.get_rgb("absorption", (1.0, 1.0, 1.0))
        dist = params.get_float("absorption_dist", 1.0)
        row["absorption_sigma"] = tuple(
            -math.log(max(min(c, 1.0), 1e-6)) / max(dist, 1e-6)
            if c < 1.0 - 1e-9 else 0.0
            for c in absorp
        )
        row["dispersion_power"] = params.get_float("dispersion_power", 0.0)
        row["fake_shadows"] = params.get_bool("fake_shadows", False)
        if row["mtype"] == MT_ROUGH_GLASS:
            alpha = params.get_float("alpha", params.get_float("exponent", 0.2))
            if alpha <= 0.0:
                alpha = 1e-3
            if "alpha" in params:
                row["exponent"] = max(2.0 / (alpha * alpha) - 2.0, 1.0)
    else:
        row["filter_color"] = params.get_rgb("filter_color", (1.0, 1.0, 1.0))

    # light material
    if row["mtype"] == MT_LIGHT:
        power = params.get_float("power", 1.0)
        col = params.get_rgb("color", (1.0, 1.0, 1.0))
        row["emit_color"] = tuple(c * power for c in col)
        row["double_sided"] = params.get_bool("double_sided", False)
        row["diffuse_reflect"] = 0.0

    # blend / mask (table columns only; the composite itself raises)
    if row["mtype"] in (MT_BLEND, MT_MASK):
        row["sub_mat1"] = mat_name_to_id.get(params.get_str("material1", ""),
                                             0)
        row["sub_mat2"] = mat_name_to_id.get(params.get_str("material2", ""),
                                             0)
        row["blend_value"] = params.get_float("blend_value", 0.5)
        row["mask_threshold"] = params.get_float("threshold", 0.5)
    return row
