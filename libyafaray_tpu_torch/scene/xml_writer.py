"""The XML writer: a Scene back to scene XML (port of
libyafaray_tpu/scene/xml_writer.py, the reference's xmlinterface.cc role).
It writes the ParamMaps the create* calls kept, the meshes with their
material switches, smoothing angles and visibility, the integrators,
volume regions and render block, so parse(write(scene)) builds the same
scene.
"""
from __future__ import annotations

from xml.sax.saxutils import quoteattr

from .params import ParamMap
from .scene import Scene


def _value_attrs(v) -> str:
    if isinstance(v, bool):
        return f'bval="{str(v).lower()}"'
    if isinstance(v, int):
        return f'ival="{v}"'
    if isinstance(v, float):
        return f'fval="{v!r}"'
    if isinstance(v, str):
        return f"sval={quoteattr(v)}"
    if isinstance(v, (tuple, list)):
        v = tuple(v)
        if len(v) == 2:
            return f'u="{v[0]!r}" v="{v[1]!r}"'
        if len(v) == 3:
            # ambiguous point vs rgb: parser accepts either keying; emit xyz
            return f'x="{v[0]!r}" y="{v[1]!r}" z="{v[2]!r}"'
        if len(v) == 4:
            return (f'r="{v[0]!r}" g="{v[1]!r}" b="{v[2]!r}" '
                    f'a="{v[3]!r}"')
        if len(v) == 16:
            return " ".join(
                f'm{i}{j}="{v[i * 4 + j]!r}"'
                for i in range(4) for j in range(4)
            )
    raise ValueError(f"cannot serialize param value {v!r}")


_POINT_KEYS = {"from", "to", "up", "corner", "point1", "point2",
               "direction", "scale", "offset"}


def _params_xml(params: ParamMap, indent: str) -> list[str]:
    out = []
    for k, v in params.items():
        if k == "__list__":
            for item in v:
                out.append(f"{indent}<list_element>")
                out.extend(_params_xml(item, indent + "  "))
                out.append(f"{indent}</list_element>")
            continue
        if isinstance(v, (tuple, list)) and len(v) == 3 \
                and k not in _POINT_KEYS:
            out.append(f'{indent}<{k} r="{v[0]!r}" g="{v[1]!r}" '
                       f'b="{v[2]!r}"/>')
        else:
            out.append(f"{indent}<{k} {_value_attrs(v)}/>")
    return out


def write_xml(scene: Scene) -> str:
    """Serialize the buildable state of a Scene to scene XML."""
    lines = ['<?xml version="1.0"?>', '<scene type="triangle">']

    for name, tex in scene.textures.items():
        lines.append(f"  <texture name={quoteattr(name)}>")
        lines.extend(_params_xml(tex.params, "    "))
        lines.append("  </texture>")

    id_to_name = {v: k for k, v in scene.material_names.items()}
    for name, params in getattr(scene, "material_params", {}).items():
        lines.append(f"  <material name={quoteattr(name)}>")
        lines.extend(_params_xml(params, "    "))
        lines.append("  </material>")

    for name, params in zip(scene.light_names,
                            getattr(scene, "light_params", [])):
        lines.append(f"  <light name={quoteattr(name)}>")
        lines.extend(_params_xml(params, "    "))
        lines.append("  </light>")

    for name, params in getattr(scene, "camera_params", {}).items():
        lines.append(f"  <camera name={quoteattr(name)}>")
        lines.extend(_params_xml(params, "    "))
        lines.append("  </camera>")

    if getattr(scene, "background_params", None) is not None:
        lines.append('  <background name="bg">')
        lines.extend(_params_xml(scene.background_params, "    "))
        lines.append("  </background>")

    for mesh in scene.meshes.values():
        has_uv = "true" if mesh.has_uv else "false"
        vis = ("" if mesh.visibility == "normal"
               else f' visibility="{mesh.visibility}"')
        lines.append(
            f'  <mesh id="{mesh.mesh_id}" vertices="{len(mesh.vertices)}" '
            f'faces="{len(mesh.faces)}" has_uv="{has_uv}"{vis} type="0">'
        )
        for x, y, z in mesh.vertices:
            lines.append(f'    <p x="{x!r}" y="{y!r}" z="{z!r}"/>')
        for x, y, z in mesh.normals:
            lines.append(f'    <n x="{x!r}" y="{y!r}" z="{z!r}"/>')
        for u, v in mesh.uvs:
            lines.append(f'    <uv u="{u!r}" v="{v!r}"/>')
        cur_mat = None
        for (a, b, c, mid), (ua, ub, uc) in zip(mesh.faces, mesh.face_uvs):
            if mid != cur_mat:
                mname = id_to_name.get(mid, "__default__")
                lines.append(f"    <set_material sval={quoteattr(mname)}/>")
                cur_mat = mid
            if mesh.has_uv and ua >= 0:
                lines.append(
                    f'    <f a="{a}" b="{b}" c="{c}" uv_a="{ua}" '
                    f'uv_b="{ub}" uv_c="{uc}"/>'
                )
            else:
                lines.append(f'    <f a="{a}" b="{b}" c="{c}"/>')
        lines.append("  </mesh>")
        if mesh.smooth_angle is not None:
            lines.append(
                f'  <smooth ID="{mesh.mesh_id}" angle="{mesh.smooth_angle!r}"/>'
            )

    for name, params in scene.integrator_params.items():
        lines.append(f"  <integrator name={quoteattr(name)}>")
        lines.extend(_params_xml(params, "    "))
        lines.append("  </integrator>")

    for vol_params in getattr(scene, "volume_params", []):
        lines.append('  <volumeregion name="vol">')
        lines.extend(_params_xml(vol_params, "    "))
        lines.append("  </volumeregion>")

    if scene.render_params:
        lines.append("  <render>")
        lines.extend(_params_xml(scene.render_params, "    "))
        lines.append("  </render>")

    lines.append("</scene>")
    return "\n".join(lines) + "\n"
