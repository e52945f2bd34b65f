"""Shader-node programs (port of libyafaray_tpu/textures/nodes.py).

A material's node DAG (texture mappers, layers with the Blender blend
modes, value / colour constants) is static, so scene compile freezes it
into a hashable `NodeProgram`: the topologically ordered nodes and the
material slots bound to them.  `eval_node_program` interprets it for every
lane with a static loop; each node yields an (N, 3) colour and an (N,)
factor that stencil layers scale.
"""
from __future__ import annotations

import logging
from typing import NamedTuple

import torch

from ..core.color import luminance

log = logging.getLogger("libyafaray_tpu_torch")

# layer blend modes (Blender names)
BLEND_MODES = {
    "mix": 0, "add": 1, "sub": 2, "subtract": 2, "mul": 3, "multiply": 3,
    "screen": 4, "difference": 5, "diff": 5, "darken": 6, "dark": 6,
    "lighten": 7, "light": 7, "divide": 8, "div": 8, "overlay": 9,
    "hue": 10, "saturation": 11, "sat": 11, "value": 12, "val": 12,
    "color": 13, "burn": 14, "dodge": 15,
}


class NodeSpec(NamedTuple):
    name: str
    ntype: str          # "texture_mapper" | "layer" | "color"
    tex_id: int         # texture index (mapper) else -1
    mapping: tuple      # (texco, mapping, scale, offset) for mappers
    inp: int            # node index of the lower / input layer (-1 none)
    upper: int          # node index of the upper layer / mapper (-1 none)
    mode: int           # blend mode (layer)
    colorfac: float
    negative: bool
    no_rgb: bool        # use the upper's intensity, not its colour
    stencil: bool       # the upper's intensity masks lower layers' factor
    use_alpha: bool
    const: tuple        # rgb of colour / value nodes and a layer's default
    default_val: float


class NodeProgram(NamedTuple):
    nodes: tuple        # topologically ordered tuple[NodeSpec]
    slots: tuple        # tuple[(slot_name, node_index)]


def _rgb_to_hsv(c):
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    safe = torch.clamp(d, min=1e-12)
    h = torch.where(
        mx == r, (g - b) / safe % 6.0,
        torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0),
    ) / 6.0
    h = torch.where(d < 1e-12, 0.0, h % 1.0)
    s = torch.where(mx > 1e-12, d / torch.clamp(mx, min=1e-12), 0.0)
    return h, s, mx


def _hsv_to_rgb(h, s, v):
    h6 = (h % 1.0) * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6

    def pick(*vals):
        out = vals[-1]
        for k in range(len(vals) - 2, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def blend_layer(base, tex, mode: int, fac):
    """One blend mode (a static int) of tex over base, both (N, 3), by
    factor fac (N,)."""
    f = fac[..., None]
    if mode == 0:       # mix
        out = base * (1.0 - f) + tex * f
    elif mode == 1:     # add
        out = base + tex * f
    elif mode == 2:     # sub
        out = base - tex * f
    elif mode == 3:     # mul
        out = base * ((1.0 - f) + tex * f)
    elif mode == 4:     # screen
        out = 1.0 - (1.0 - base) * (1.0 - tex * f)
    elif mode == 5:     # difference
        out = base * (1.0 - f) + (base - tex).abs() * f
    elif mode == 6:     # darken
        out = torch.minimum(base, tex * f + base * (1.0 - f))
    elif mode == 7:     # lighten
        out = torch.maximum(base, tex * f)
    elif mode == 8:     # divide
        out = base * (1.0 - f) + f * base / torch.clamp(tex, min=1e-4)
    elif mode == 9:     # overlay
        mixed = tex * f + base * (1.0 - f)
        out = torch.where(base < 0.5, 2.0 * base * mixed,
                          1.0 - 2.0 * (1.0 - base) * (1.0 - mixed))
    elif mode == 10:    # hue (tex hue where it has saturation)
        th, ts, _ = _rgb_to_hsv(tex)
        _, bs, bv = _rgb_to_hsv(base)
        res = torch.where((ts > 1e-6)[..., None], _hsv_to_rgb(th, bs, bv),
                          base)
        out = base * (1.0 - f) + res * f
    elif mode == 11:    # saturation
        _, ts, _ = _rgb_to_hsv(tex)
        bh, bs, bv = _rgb_to_hsv(base)
        res = torch.where((bs > 1e-6)[..., None], _hsv_to_rgb(bh, ts, bv),
                          base)
        out = base * (1.0 - f) + res * f
    elif mode == 12:    # value
        _, _, tv = _rgb_to_hsv(tex)
        bh, bs, _ = _rgb_to_hsv(base)
        out = base * (1.0 - f) + _hsv_to_rgb(bh, bs, tv) * f
    elif mode == 13:    # color (hue and saturation from tex)
        th, ts, _ = _rgb_to_hsv(tex)
        _, _, bv = _rgb_to_hsv(base)
        res = torch.where((ts > 1e-6)[..., None], _hsv_to_rgb(th, ts, bv),
                          base)
        out = base * (1.0 - f) + res * f
    elif mode == 14:    # burn
        out = 1.0 - (1.0 - base) / torch.clamp(tex * f + (1.0 - f),
                                               min=1e-4)
    elif mode == 15:    # dodge
        out = base / torch.clamp(1.0 - tex * f, min=1e-4)
    else:
        out = base * (1.0 - f) + tex * f
    return torch.clamp(out, min=0.0)


def _mapper(name, tex_id, mapping) -> NodeSpec:
    return NodeSpec(name=name, ntype="texture_mapper", tex_id=tex_id,
                    mapping=mapping, inp=-1, upper=-1, mode=0, colorfac=1.0,
                    negative=False, no_rgb=False, stencil=False,
                    use_alpha=False, const=(0.0, 0.0, 0.0), default_val=0.0)


def _constant(name, rgb, val) -> NodeSpec:
    return NodeSpec(name=name, ntype="color", tex_id=-1, mapping=(), inp=-1,
                    upper=-1, mode=0, colorfac=1.0, negative=False,
                    no_rgb=False, stencil=False, use_alpha=False,
                    const=rgb, default_val=val)


def parse_node_graph(nodes_params, tex_name_to_id, slots: dict):
    """<list_element> node list + the material's slot references ->
    NodeProgram, or None when no slot resolves.  slots: slot name ->
    shader node or texture name (a bare texture gets an implicit uv
    mapper)."""
    from ..scene.params import ParamMap

    raw = {}
    for nd in nodes_params:
        nd = nd if isinstance(nd, ParamMap) else ParamMap(nd)
        name = nd.get_str("name", "")
        if name:
            raw[name] = nd

    specs: list[NodeSpec] = []
    index: dict[str, int] = {}

    def build(name: str, depth=0):
        if name in index:
            return index[name]
        if depth > 32 or name not in raw:
            return -1
        nd = raw[name]
        ntype = nd.get_str("type", "")
        if ntype in ("texture_mapper", "texture"):
            t = nd.get_str("texture", "")
            ti = tex_name_to_id.get(t, -1)
            if ti < 0:
                log.warning("node %r: unknown texture %r", name, t)
                return -1
            spec = _mapper(name, ti, (
                nd.get_str("texco", "uv"), nd.get_str("mapping", "plain"),
                tuple(nd.get_point("scale", (1.0, 1.0, 1.0))),
                tuple(nd.get_point("offset", (0.0, 0.0, 0.0)))))
        elif ntype in ("layer", "mix"):
            # `input` is the mapper / texture feeding this layer,
            # `upper_layer` the previous layer below it
            upper = build(nd.get_str("input", ""), depth + 1)
            inp_name = nd.get_str("upper_layer", "")
            inp = build(inp_name, depth + 1) if inp_name else -1
            def_col = nd.get_color("def_col", (1.0, 1.0, 1.0, 1.0))
            spec = NodeSpec(
                name=name, ntype="layer", tex_id=-1, mapping=(),
                inp=inp, upper=upper,
                mode=BLEND_MODES.get(
                    nd.get_str("blend_mode", nd.get_str("mode", "mix")), 0),
                colorfac=nd.get_float("colfac",
                                      nd.get_float("colorfac", 1.0)),
                negative=nd.get_bool("negative", False),
                no_rgb=nd.get_bool("noRGB", nd.get_bool("no_rgb", False)),
                stencil=nd.get_bool("stencil", False),
                use_alpha=nd.get_bool("use_alpha", False),
                const=tuple(def_col[:3]),
                default_val=nd.get_float("def_val", 1.0))
            if upper < 0:
                return inp
        elif ntype in ("value", "float"):
            v = nd.get_float("value", nd.get_float("val", 0.0))
            spec = _constant(name, (v, v, v), v)
        elif ntype in ("color", "rgb"):
            c = nd.get_color("color", (0.0, 0.0, 0.0, 1.0))
            spec = _constant(name, tuple(c[:3]), float(c[0]))
        else:
            log.warning("node %r: unknown type %r; skipped", name, ntype)
            return -1
        specs.append(spec)
        index[name] = len(specs) - 1
        return index[name]

    bound = []
    for slot, ref in slots.items():
        if not ref:
            continue
        if ref in raw:
            idx = build(ref)
        elif ref in tex_name_to_id:
            nm = f"__tex_{ref}"
            if nm not in index:
                specs.append(_mapper(nm, tex_name_to_id[ref],
                                     ("uv", "plain", (1.0, 1.0, 1.0),
                                      (0.0, 0.0, 0.0))))
                index[nm] = len(specs) - 1
            idx = index[nm]
        else:
            log.warning("material: shader %r for %s not resolvable; "
                        "ignored", ref, slot)
            continue
        if idx >= 0:
            bound.append((slot, idx))
    if not bound:
        return None
    return NodeProgram(nodes=tuple(specs), slots=tuple(bound))


def eval_node_program(arrays, static, prog: NodeProgram, sp) -> dict:
    """The program over all lanes -> {slot: (N, 3)}: every node's colour
    once; layers fold their upper over their input with their blend mode;
    stencil layers scale the factor seen downstream."""
    from .eval import const, sample_texture

    colors: list = []
    facs: list = []
    n = sp["p"].shape[0]
    dev = sp["p"].device
    for spec in prog.nodes:
        if spec.ntype == "texture_mapper":
            col = sample_texture(arrays, static, spec.tex_id, sp,
                                 mapping_over=spec.mapping)
            colors.append(col)
            facs.append(torch.ones(col.shape[:-1], dtype=torch.float32,
                                   device=dev))
        elif spec.ntype == "color":
            colors.append(const(tuple(spec.const), dev).expand(n, 3))
            facs.append(torch.full((n,), float(spec.default_val),
                                   dtype=torch.float32, device=dev))
        else:  # layer
            upper = colors[spec.upper]
            upper_fac = facs[spec.upper]
            if spec.inp >= 0:
                base = colors[spec.inp]
                base_fac = facs[spec.inp]
            else:
                base = const(tuple(spec.const), dev).expand(upper.shape[0],
                                                            3)
                base_fac = torch.ones((upper.shape[0],), dtype=torch.float32,
                                      device=dev)
            if spec.no_rgb:
                upper = luminance(upper)[..., None].expand(upper.shape)
            if spec.negative:
                upper = 1.0 - upper
            out = blend_layer(base, upper, spec.mode,
                              spec.colorfac * upper_fac)
            out_fac = base_fac
            if spec.stencil:
                out_fac = base_fac * torch.clamp(luminance(upper), 0.0, 1.0)
            colors.append(out)
            facs.append(out_fac)
    return {slot: colors[idx] for slot, idx in prog.slots}
