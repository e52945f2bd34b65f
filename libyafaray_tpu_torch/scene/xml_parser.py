"""XML scene parser (port of libyafaray_tpu/scene/xml_parser.py).

stdlib ElementTree; typed leaf params (ival/fval/bval/sval attributes,
colors as r/g/b/a, points as x/y/z), <texture>s, meshes streamed via
<p>/<n>/<uv>/<set_material>/<f> (has_uv, has_orco, and the object
`visibility`: normal | invisible | shadow_only | no_shadows), analytic
<sphere>s, <volumeregion>s, <smooth ID angle> (default angle 181: smooth
every corner), <instance base_object_id> with its <transform> child, and
the closing <render> block.
"""
from __future__ import annotations

import logging
import xml.etree.ElementTree as ET

from .params import ParamMap
from .scene import Scene

log = logging.getLogger("libyafaray_tpu_torch")


def _parse_value(el: ET.Element):
    """Typed value from a leaf element's attributes."""
    a = el.attrib
    if "ival" in a:
        return int(a["ival"])
    if "fval" in a:
        return float(a["fval"])
    if "bval" in a:
        return a["bval"].lower() in ("true", "1", "yes", "on")
    if "sval" in a:
        return a["sval"]
    if "r" in a and "g" in a and "b" in a:
        c = (float(a["r"]), float(a["g"]), float(a["b"]))
        return c + ((float(a["a"]),) if "a" in a else ())
    if "x" in a and "y" in a and "z" in a:
        return (float(a["x"]), float(a["y"]), float(a["z"]))
    if "m00" in a:
        return tuple(
            float(a[f"m{i}{j}"]) for i in range(4) for j in range(4))
    if "u" in a and "v" in a:
        return (float(a["u"]), float(a["v"]))
    return None


def _parse_params(el: ET.Element) -> ParamMap:
    """Collect child leaf elements into a ParamMap; <list_element> children
    become a list under key '__list__' (shader nodes)."""
    params = ParamMap()
    items = []
    for child in el:
        if child.tag == "list_element":
            items.append(_parse_params(child))
            continue
        v = _parse_value(child)
        if v is None and len(child) == 0 and not child.attrib:
            continue
        if v is None:
            log.warning("xml: unrecognized param element <%s>; ignored",
                        child.tag)
            continue
        params[child.tag] = v
    if items:
        params["__list__"] = items
    return params


def _parse_mesh(el: ET.Element, scene: Scene):
    mesh_id = int(el.attrib.get("id", scene._next_mesh_id))
    has_uv = el.attrib.get("has_uv", "false").lower() in ("true", "1")
    has_orco = el.attrib.get("has_orco", "false").lower() in ("true", "1")
    scene.start_tri_mesh(mesh_id, has_uv=has_uv, has_orco=has_orco,
                         visibility=el.attrib.get("visibility", "normal"))
    cur_mat = 0
    for child in el:
        tag = child.tag
        a = child.attrib
        if tag == "p":
            scene.add_vertex(float(a["x"]), float(a["y"]), float(a["z"]))
        elif tag == "n":
            scene.add_normal(float(a["x"]), float(a["y"]), float(a["z"]))
        elif tag == "uv":
            scene.add_uv(float(a["u"]), float(a["v"]))
        elif tag == "set_material":
            name = a.get("sval", "")
            cur_mat = scene.material_names.get(name, 0)
            if name and name not in scene.material_names:
                log.warning("xml: set_material %r unknown; default", name)
        elif tag == "f":
            if has_uv and "uv_a" in a:
                scene.add_triangle(
                    int(a["a"]), int(a["b"]), int(a["c"]), cur_mat,
                    int(a["uv_a"]), int(a["uv_b"]), int(a["uv_c"]))
            else:
                scene.add_triangle(int(a["a"]), int(a["b"]), int(a["c"]),
                                   cur_mat)
        else:
            log.warning("xml: unknown mesh child <%s>", tag)
    scene.end_tri_mesh()
    return mesh_id


def parse_xml_string(text: str) -> Scene:
    """Parse a scene XML into a Scene."""
    scene = Scene()
    root = ET.fromstring(text)
    if root.tag != "scene":
        raise ValueError("root element must be <scene>")
    for el in root:
        tag = el.tag
        name = el.attrib.get("name", "")
        if tag == "texture":
            scene.create_texture(name, _parse_params(el))
        elif tag == "material":
            scene.create_material(name, _parse_params(el))
        elif tag == "light":
            scene.create_light(name, _parse_params(el))
        elif tag == "camera":
            scene.create_camera(name, _parse_params(el))
        elif tag == "background":
            scene.create_background(name, _parse_params(el))
        elif tag == "integrator":
            scene.create_integrator(name or "default", _parse_params(el))
        elif tag == "volumeregion":
            scene.create_volume_region(name, _parse_params(el))
        elif tag == "mesh":
            _parse_mesh(el, scene)
        elif tag == "smooth":
            scene.smooth_mesh(int(el.attrib.get("ID",
                                                el.attrib.get("id", 0))),
                              float(el.attrib.get("angle", 181.0)))
        elif tag == "instance":
            m = None
            for child in el:
                if child.tag == "transform":
                    m = _parse_value(child)
            if m is not None:
                scene.add_instance(int(el.attrib.get("base_object_id", 0)),
                                   m)
        elif tag == "sphere":
            p = _parse_params(el)
            scene.add_sphere(p.get_point("center", (0, 0, 0)),
                             p.get_float("radius", 1.0),
                             p.get_str("material", "__default__"))
        elif tag == "render":
            scene.set_render_params(_parse_params(el))
        else:
            log.warning("xml: unknown element <%s>; ignored", tag)
    return scene


def parse_xml_file(path: str) -> Scene:
    with open(path, "r", encoding="utf-8") as f:
        return parse_xml_string(f.read())
