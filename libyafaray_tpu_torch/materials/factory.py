"""Material factory: ParamMap -> material table row (port of
libyafaray_tpu/materials/factory.py).  Parameter names and defaults follow
the reference's factories so XML scenes map 1:1.  Shader slots resolve to
texture ids (the tex_* columns) and, where the scene keeps a program
registry, to a compiled node program (the node_prog column)."""
from __future__ import annotations

import logging
import math

from ..scene.params import ParamMap
from ..textures.nodes import parse_node_graph
from .base import MATERIAL_TYPE_NAMES, MT_BLEND, MT_GLASS, MT_LIGHT, \
    MT_MASK, MT_ROUGH_GLASS, default_row

log = logging.getLogger("libyafaray_tpu_torch")

# the layer blend modes of the tex_* slot resolution (the structurally
# distinct ones; the hue / saturation family maps to mix there, node
# programs carry them all)
_BLEND_MODES = {
    "mix": 0, "add": 1, "sub": 2, "subtract": 2, "mul": 3, "multiply": 3,
    "screen": 4, "difference": 5, "darken": 6, "lighten": 7, "div": 8,
    "divide": 8, "overlay": 9,
    "hue": 0, "saturation": 0, "value": 0, "color": 0, "stencil": 0,
}
# tex_* column <- shader slot parameter
_SLOT_COLUMNS = (
    ("tex_diffuse", "diffuse_shader"), ("tex_glossy", "glossy_shader"),
    ("tex_bump", "bump_shader"), ("tex_mirror", "mirror_color_shader"),
    ("tex_transparency", "transparency_shader"),
    ("tex_translucency", "translucency_shader"),
    ("tex_blend", "blend_shader"), ("tex_mask", "mask_shader"),
    ("tex_sigma_oren", "sigma_oren_shader"), ("tex_ior", "IOR_shader"))
# the slots a node program binds (not bump)
_NODE_SLOT_KEYS = (
    "diffuse_shader", "glossy_shader", "mirror_color_shader",
    "transparency_shader", "translucency_shader", "blend_shader",
    "mask_shader", "sigma_oren_shader", "IOR_shader")


def material_row_from_params(params: ParamMap, mat_name_to_id: dict,
                             tex_name_to_id: dict | None = None,
                             texture_mappers: dict | None = None,
                             node_programs: list | None = None) -> dict:
    """A material row.  tex_name_to_id: texture name -> index;
    texture_mappers: texture index -> (texco, mapping, scale, offset),
    filled from the material's mapper nodes; node_programs: the scene's
    program registry, appended to."""
    tex_name_to_id = tex_name_to_id or {}
    texture_mappers = texture_mappers if texture_mappers is not None else {}
    mtype_name = params.get_str("type", "shinydiffusemat")
    if mtype_name not in MATERIAL_TYPE_NAMES:
        raise NotImplementedError(
            f"material type {mtype_name!r} is unknown to the port")
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

    # glass family (glass, rough glass)
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

    # blend / mask: the children's rows and the blend / mask factors
    if row["mtype"] in (MT_BLEND, MT_MASK):
        row["sub_mat1"] = mat_name_to_id.get(params.get_str("material1", ""),
                                             0)
        row["sub_mat2"] = mat_name_to_id.get(params.get_str("material2", ""),
                                             0)
        row["blend_value"] = params.get_float("blend_value", 0.5)
        row["mask_threshold"] = params.get_float("threshold", 0.5)

    _resolve_shader_slots(row, params, tex_name_to_id, texture_mappers)
    # the full node DAG (textures/nodes.py): arbitrary node-on-node chains
    # with every blend mode; the slots above stay for bump mapping
    slot_refs = {k: params.get_str(k, "") for k in _NODE_SLOT_KEYS}
    if node_programs is not None and any(slot_refs.values()):
        prog = parse_node_graph(params.get_list("__list__", []),
                                tex_name_to_id, slot_refs)
        if prog is not None:
            row["node_prog"] = len(node_programs)
            node_programs.append(prog)
    return row


def _resolve_shader_slots(row: dict, params: ParamMap, tex_name_to_id: dict,
                          texture_mappers: dict) -> None:
    """Resolve each shader slot of the material down to its source texture
    id (tex_* columns): texture_mapper nodes bind a texture and register
    its coordinate transform (the first use wins), layer nodes chain to
    their input (up to 3 levels) and set the row's blend mode and colour
    factor, a bare texture name binds directly."""
    node_to_tex: dict[str, int] = {}
    nodes = params.get_list("__list__", [])
    for _ in range(3):
        for nd in nodes:
            if not isinstance(nd, ParamMap):
                nd = ParamMap(nd)
            name = nd.get_str("name", "")
            ntype = nd.get_str("type", "")
            if not name or name in node_to_tex:
                continue
            if ntype in ("texture_mapper", "texture"):
                t = nd.get_str("texture", "")
                if t not in tex_name_to_id:
                    continue
                ti = tex_name_to_id[t]
                node_to_tex[name] = ti
                bs = nd.get_float("bump_strength", -1.0)
                if bs >= 0.0 and params.get_str("bump_shader", "") == name:
                    row["bump_strength"] = bs
                if ti not in texture_mappers:
                    texture_mappers[ti] = (
                        nd.get_str("texco", "uv"),
                        nd.get_str("mapping", "plain"),
                        tuple(nd.get_point("scale", (1.0, 1.0, 1.0))),
                        tuple(nd.get_point("offset", (0.0, 0.0, 0.0))))
            elif ntype in ("layer", "mix"):
                for src_key in ("input", "upper_layer", "layer_input"):
                    src = nd.get_str(src_key, "")
                    if src in node_to_tex:
                        node_to_tex[name] = node_to_tex[src]
                        row["tex_blend_mode"] = _BLEND_MODES.get(
                            nd.get_str("blend_mode",
                                       nd.get_str("mode", "mix")), 0)
                        row["tex_colorfac"] = nd.get_float(
                            "colfac", nd.get_float("colorfac", 1.0))
                        break
    for slot, key in _SLOT_COLUMNS:
        sh = params.get_str(key, "")
        if not sh:
            continue
        if sh in node_to_tex:
            row[slot] = node_to_tex[sh]
        elif sh in tex_name_to_id:
            row[slot] = tex_name_to_id[sh]
        else:
            log.warning("material: shader %r for %s not resolvable to a "
                        "texture; ignored", sh, key)
