"""Texture evaluation at surface points, the `initBSDF` analog (port of
libyafaray_tpu/textures/eval.py).

After the engine gathers a lane's material row, `apply_textures`
overrides its textured parameters (diffuse / glossy / mirror colours,
transparency, translucency, blend and mask factors, Oren-Nayar sigma,
IOR) from the scene's textures and node programs, and `bump_normal`
perturbs the shading normal from the bump slot's gradient.  The loop over
the scene's textures is static with lane masks.

Image sampling: nearest ("none"), bilinear (the default), bicubic
(Catmull-Rom), trilinear over the mip atlas with the LOD from the ray-cone
footprint ("mipmap_trilinear"), and EWA as trilinear probes along the
footprint's major axis ("mipmap_ewa").  Each lookup is one advanced-index
gather per tap on the device tensor; nothing is read back to the host.
Procedural textures evaluate in textures/procedural.py through the same
`sample_texture`.
"""
from __future__ import annotations

import functools
import math

import torch

from ..core import math as vmath
from ..core.color import luminance

F32 = torch.float32


@functools.lru_cache(maxsize=256)
def const(values: tuple, device: torch.device,
          dtype: torch.dtype = F32) -> torch.Tensor:
    """A constant tensor of static values, made once per device (a tensor
    built from host values each call is a copy the host waits for)."""
    return torch.tensor(values, dtype=dtype, device=device)


def _blend(base, tex, mode, fac):
    """Layer blend of a texture over the material's base parameter; mode
    (N,) int (mix, add, sub, mul, screen, difference, darken, lighten,
    divide, overlay), fac (N,)."""
    f = fac[..., None]
    outs = [
        base * (1.0 - f) + tex * f,
        base + tex * f,
        base - tex * f,
        base * ((1.0 - f) + tex * f),
        1.0 - (1.0 - base) * (1.0 - tex * f),
        base * (1.0 - f) + (base - tex).abs() * f,
        torch.minimum(base, tex * f + base * (1.0 - f)),
        torch.maximum(base, tex * f),
        base * (1.0 - f) + f * base / torch.clamp(tex, min=1e-4),
        torch.where(base < 0.5,
                    2.0 * base * (tex * f + base * (1.0 - f)),
                    1.0 - 2.0 * (1.0 - base) * (1.0 - (tex * f
                                                       + base * (1.0 - f)))),
    ]
    out = outs[0]
    for i in range(1, len(outs)):
        out = torch.where((mode == i)[..., None], outs[i], out)
    return torch.clamp(out, min=0.0)


def _taps(img, y, x):
    """img[y, x] for int index tensors (one gather)."""
    return img[y.long(), x.long()]


def sample_image_bilinear(img, u, v):
    """img (H, W, C); u, v (N,) wrapped to [0, 1). -> (N, C)."""
    h, w = img.shape[0], img.shape[1]
    x = (u % 1.0) * w - 0.5
    y = (v % 1.0) * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.to(torch.int32)
    y0 = y0.to(torch.int32)
    x1 = (x0 + 1) % w
    y1 = (y0 + 1) % h
    x0 = x0 % w
    y0 = y0 % h
    c00, c10 = _taps(img, y0, x0), _taps(img, y0, x1)
    c01, c11 = _taps(img, y1, x0), _taps(img, y1, x1)
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def _catmull_rom_w(f):
    """Catmull-Rom weights of the taps at -1, 0, +1, +2 for offset f."""
    f2 = f * f
    f3 = f2 * f
    return (-0.5 * f3 + f2 - 0.5 * f,
            1.5 * f3 - 2.5 * f2 + 1.0,
            -1.5 * f3 + 2.0 * f2 + 0.5 * f,
            0.5 * f3 - 0.5 * f2)


def sample_image_bicubic(img, u, v):
    """Catmull-Rom bicubic with repeat wrap."""
    h, w = img.shape[0], img.shape[1]
    x = (u % 1.0) * w - 0.5
    y = (v % 1.0) * h - 0.5
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    wx = _catmull_rom_w(x - x0)
    wy = _catmull_rom_w(y - y0)
    out = 0.0
    for j in range(4):
        yj = (y0 + (j - 1)) % h
        rowv = 0.0
        for i in range(4):
            rowv = rowv + wx[i][..., None] * _taps(img, yj,
                                                    (x0 + (i - 1)) % w)
        out = out + wy[j][..., None] * rowv
    return out


def sample_image_nearest(img, u, v):
    """Nearest texel (interpolate "none")."""
    h, w = img.shape[0], img.shape[1]
    x = torch.floor((u % 1.0) * w).to(torch.int32) % w
    y = torch.floor((v % 1.0) * h).to(torch.int32) % h
    return _taps(img, y, x)


def _bilinear_in_level(atlas, y0, lh, lw, u, v):
    """Bilinear with repeat wrap inside one atlas level; the level
    geometry (y0, lh, lw) is per lane (N,) int32."""
    x = (u % 1.0) * lw - 0.5
    y = (v % 1.0) * lh - 0.5
    x0 = torch.floor(x)
    yy0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - yy0)[..., None]
    x0 = x0.to(torch.int32)
    yy0 = yy0.to(torch.int32)
    x1 = (x0 + 1) % lw
    y1 = (yy0 + 1) % lh
    x0 = x0 % lw
    yy0 = yy0 % lh
    c00, c10 = _taps(atlas, y0 + yy0, x0), _taps(atlas, y0 + yy0, x1)
    c01, c11 = _taps(atlas, y0 + y1, x0), _taps(atlas, y0 + y1, x1)
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def sample_image_trilinear(atlas, levels: tuple, u, v, lod):
    """Mipmap-trilinear from the vertical atlas; `levels` is the static
    (y0, h, w) table (factory.mip_level_meta), lod (N,) the fractional
    level (0 = full resolution)."""
    n_lv = len(levels)
    y0s, hs, ws = (const(tuple(lv[i] for lv in levels), atlas.device,
                         torch.int32) for i in range(3))
    lod = torch.clamp(lod, 0.0, float(n_lv - 1))
    k0 = torch.floor(lod).to(torch.int32)
    k1 = torch.clamp(k0 + 1, max=n_lv - 1)
    fr = (lod - k0.to(F32))[..., None]
    k0l, k1l = k0.long(), k1.long()
    c0 = _bilinear_in_level(atlas, y0s[k0l], hs[k0l], ws[k0l], u, v)
    c1 = _bilinear_in_level(atlas, y0s[k1l], hs[k1l], ws[k1l], u, v)
    return c0 * (1.0 - fr) + c1 * fr


EWA_TAPS = 4        # trilinear probes along the major footprint axis
EWA_MAX_ANISO = 8.0  # cap on the major/minor stretch


def _norm(a):
    return torch.linalg.vector_norm(a, dim=-1)


def _ewa_uv_axes(sp):
    """The ray cone's anisotropic uv footprint at the hit: minor radius fp
    across the projected view direction, major fp/cos(theta) along it,
    mapped to uv through the dual basis of (dPdU, dPdV).  Returns
    (duv_major (N,2), duv_minor (N,2))."""
    ng = sp["ng"]
    d = sp["view"]
    fp = sp["fp"]
    cosi = vmath.dot(d, ng).abs()
    d_t = d - vmath.dot(d, ng)[..., None] * ng
    lt = _norm(d_t)[..., None]
    fallback = sp["dpdu"] - vmath.dot(sp["dpdu"], ng)[..., None] * ng
    fallback = fallback / torch.clamp(_norm(fallback)[..., None], min=1e-9)
    dir_t = torch.where(lt > 1e-6, d_t / torch.clamp(lt, min=1e-9),
                        fallback)
    stretch = torch.clamp(1.0 / torch.clamp(cosi, min=1e-3),
                          max=EWA_MAX_ANISO)
    a_maj = dir_t * (fp * stretch)[..., None]
    a_min = vmath.cross(ng, dir_t) * fp[..., None]
    du_, dv_ = sp["dpdu"], sp["dpdv"]
    g11 = vmath.dot(du_, du_)
    g12 = vmath.dot(du_, dv_)
    g22 = vmath.dot(dv_, dv_)
    det = torch.clamp(g11 * g22 - g12 * g12, min=1e-20)

    def to_uv(a):
        b1 = vmath.dot(a, du_)
        b2 = vmath.dot(a, dv_)
        return torch.stack([(g22 * b1 - g12 * b2) / det,
                            (g11 * b2 - g12 * b1) / det], dim=-1)

    duv1 = to_uv(a_maj)
    duv2 = to_uv(a_min)
    swap = ((duv2 * duv2).sum(-1) > (duv1 * duv1).sum(-1))[..., None]
    return (torch.where(swap, duv2, duv1), torch.where(swap, duv1, duv2))


def sample_image_ewa(atlas, levels: tuple, u, v, duv_major, duv_minor,
                     taps: int = EWA_TAPS):
    """Anisotropic filtering: `taps` trilinear probes spread along the
    major footprint axis, the LOD from the minor axis."""
    w0 = levels[0][2]
    min_len = _norm(duv_minor)
    maj_len = _norm(duv_major)
    lod = torch.log2(torch.clamp(min_len * w0 * 2.0, min=1.0))
    span = torch.clamp(maj_len - min_len, min=0.0) / torch.clamp(
        maj_len, min=1e-12)
    out = 0.0
    for k in range(taps):
        f = ((k + 0.5) / taps - 0.5) * 2.0
        off = duv_major * (f * span)[..., None]
        out = out + sample_image_trilinear(
            atlas, levels, u + off[..., 0], v + off[..., 1], lod)
    return out / taps


# (texco, mapping, scale, offset) of a texture no mapper node registers
DEFAULT_MAPPING = ("uv", "plain", (1.0, 1.0, 1.0), (0.0, 0.0, 0.0))


def _mapped_coords(static, ti: int, sp, mapping_over=None):
    """The texture mapper's transform: texco (uv, window, orco, object,
    global) with scale / offset, and for 3-D coordinates the projection
    (plain, sphere, tube, cube) to 2-D uv.  Returns (u, v, p3).
    mapping_over: a node's own (texco, mapping, scale, offset)."""
    if mapping_over is not None:
        texco, mapping, scale, offset = mapping_over
    else:
        mappings = getattr(static, "texture_mappings", ())
        texco, mapping, scale, offset = (
            mappings[ti] if ti < len(mappings) else DEFAULT_MAPPING)
    if texco == "uv" or (texco == "window" and sp.get("win") is not None):
        src = sp["uv"] if texco == "uv" else sp["win"]
        u = src[..., 0] * scale[0] + offset[0]
        v = src[..., 1] * scale[1] + offset[1]
        return u, v, torch.stack([u, v, torch.zeros_like(u)], dim=-1)
    # 3-D spaces: orco (bbox-normalised object coordinates), object
    # (local), else world P (also where the scene carries no orco pack)
    if texco == "orco" and sp.get("orco") is not None:
        base = sp["orco"]
    elif texco == "object" and sp.get("local") is not None:
        base = sp["local"]
    else:
        base = sp["p"]
    dev = base.device
    p3 = (base * const(tuple(scale), dev)
          + const(tuple(offset), dev))
    if mapping == "sphere":
        d = p3 / torch.clamp(_norm(p3)[..., None], min=1e-9)
        u = 0.5 + vmath.div(torch.atan2(d[..., 1], d[..., 0]), 2.0 * math.pi)
        v = 0.5 - vmath.div(torch.asin(torch.clamp(d[..., 2], -1, 1)),
                            math.pi)
    elif mapping == "tube":
        u = 0.5 + vmath.div(torch.atan2(p3[..., 1], p3[..., 0]),
                            2.0 * math.pi)
        v = p3[..., 2] * 0.5 + 0.5
    elif mapping == "cube":  # dominant-axis projection
        ax = torch.argmax(p3.abs(), dim=-1)
        u = torch.where(ax == 0, p3[..., 1], p3[..., 0])
        v = torch.where(ax == 2, p3[..., 1], p3[..., 2])
        u = u * 0.5 + 0.5
        v = v * 0.5 + 0.5
    else:  # plain
        u = p3[..., 0] * 0.5 + 0.5
        v = 0.5 - p3[..., 1] * 0.5
    return u, v, p3


def apply_color_ramp(val, ramp):
    """Map texture intensity through a colour band: static stops
    (position, r, g, b), linear or constant interpolation, clamped at the
    ends."""
    mode, items = ramp
    dev = val.device
    if len(items) == 1:
        return const(tuple(items[0][1:4]), dev).expand(val.shape)
    inten = luminance(val)
    pos = const(tuple(it[0] for it in items), dev)
    cols = const(tuple(tuple(it[1:4]) for it in items), dev)
    idx = torch.clamp(torch.searchsorted(pos, inten.contiguous(),
                                         right=True) - 1,
                      0, len(items) - 2)
    p0 = pos[idx]
    p1 = pos[idx + 1]
    t = torch.clamp((inten - p0) / torch.clamp(p1 - p0, min=1e-9), 0.0, 1.0)
    if mode.startswith("constant"):
        t = torch.zeros_like(t)
    out = cols[idx] * (1.0 - t[..., None]) + cols[idx + 1] * t[..., None]
    out = torch.where((inten <= pos[0])[..., None], cols[0], out)
    return torch.where((inten >= pos[-1])[..., None], cols[-1], out)


def _sample_image_windowed(img, u, v, win, sampler=None):
    """Image sampling through the image texture's uv window: rot90,
    x/y repeat, clipping mode (repeat, extend, clip, clipcube, checker) and
    crop.  Lanes outside a clip window or on a skipped checker tile get
    black.  sampler(u, v) replaces the bilinear lookup."""
    if sampler is None:
        def sampler(uu, vv):
            return sample_image_bilinear(img, uu, vv)
    if win is None:
        return sampler(u, v)
    xrep, yrep, crop, clip, rot90, even_tiles, odd_tiles = win
    if rot90:
        u, v = v, u
    u = u * xrep
    v = v * yrep
    inside = None
    if clip in ("clip", "clipcube"):
        inside = (u >= 0.0) & (u < 1.0) & (v >= 0.0) & (v < 1.0)
        u = torch.clamp(u, 0.0, 1.0)
        v = torch.clamp(v, 0.0, 1.0)
    elif clip == "extend":
        u = torch.clamp(u, 0.0, 1.0 - 1e-6)
        v = torch.clamp(v, 0.0, 1.0 - 1e-6)
    elif clip == "checker":
        tile_odd = ((torch.floor(u) + torch.floor(v)).to(torch.int32)
                    & 1) == 1
        inside = torch.where(tile_odd, bool(odd_tiles), bool(even_tiles))
    u = u % 1.0
    v = v % 1.0
    if crop is not None:
        cx0, cy0, cx1, cy1 = crop
        u = cx0 + u * (cx1 - cx0)
        v = cy0 + v * (cy1 - cy0)
    out = sampler(u, v)
    if inside is not None:
        out = out * inside[..., None].to(F32)
    return out


def sample_texture(arrays, static, ti: int, sp, mapping_over=None):
    """Texture `ti` at the surface points. -> (N, 3).  Mipmap modes need
    the ray-cone footprint sp["fp"] (world units): trilinear takes its
    LOD from fp × the triangle's uv density × the mapper and window
    scale; EWA builds the anisotropic uv ellipse from dPdU / dPdV and the
    view slope.  Without a footprint they sample bilinear."""
    spec = static.textures[ti]
    u, v, p3 = _mapped_coords(static, ti, sp, mapping_over)
    ramp = spec[2] if len(spec) > 2 else None
    if spec[0] == "image":
        img = arrays[f"tex_{ti}"]
        win = spec[1] if len(spec) > 1 else None
        interp = spec[3] if len(spec) > 3 else "bilinear"
        mips = spec[4] if len(spec) > 4 else None
        sampler = None
        if interp == "none":
            def sampler(uu, vv):
                return sample_image_nearest(img, uu, vv)
        elif interp == "bicubic":
            def sampler(uu, vv):
                return sample_image_bicubic(img, uu, vv)
        elif (interp.startswith("mipmap") and mips is not None
                and sp.get("fp") is not None and f"mip_{ti}" in arrays):
            mappings = getattr(static, "texture_mappings", ())
            mscale = (mappings[ti][2] if ti < len(mappings)
                      else (1.0, 1.0, 1.0))
            if mapping_over is not None:
                mscale = mapping_over[2]
            s_win = 1.0
            if win is not None:
                s_win = float(max(abs(win[0]), abs(win[1]), 1))
            atlas = arrays[f"mip_{ti}"]
            if (interp == "mipmap_ewa" and sp.get("dpdu") is not None
                    and sp.get("view") is not None):
                duv_maj, duv_min = _ewa_uv_axes(sp)
                sc = const((mscale[0] * s_win, mscale[1] * s_win),
                           atlas.device)
                duv_maj = duv_maj * sc
                duv_min = duv_min * sc

                def sampler(uu, vv):
                    return sample_image_ewa(atlas, mips, uu, vv, duv_maj,
                                            duv_min)
            else:
                s_map = max(abs(mscale[0]), abs(mscale[1]), 1e-6)
                uv_fp = sp["fp"] * sp["uv_density"] * (s_map * s_win)
                lod = torch.log2(torch.clamp(uv_fp * mips[0][2], min=1.0))

                def sampler(uu, vv):
                    return sample_image_trilinear(atlas, mips, uu, vv, lod)
        out = _sample_image_windowed(img, u, v, win, sampler)
    else:
        from .procedural import eval_procedural

        out = eval_procedural(spec, p3, torch.stack([u, v], dim=-1))
    if ramp is not None:
        out = apply_color_ramp(out, ramp)
    return out


_SLOTS_COLOR = (("tex_diffuse", "diffuse_color"),
                ("tex_glossy", "glossy_color"),
                ("tex_mirror", "mirror_color"))
# scalar slots take the texture's luminance; the mask texture's value is
# the mask material's per-lane blend_value, the IOR shader's the fresnel IOR
_SLOTS_SCALAR = (("tex_transparency", "transparency"),
                 ("tex_translucency", "translucency"),
                 ("tex_blend", "blend_value"),
                 ("tex_mask", "blend_value"),
                 ("tex_sigma_oren", "sigma"),
                 ("tex_ior", "ior"))
# node-program slot -> (row key, takes the luminance)
_NODE_SLOT_TARGETS = {
    "diffuse_shader": ("diffuse_color", False),
    "glossy_shader": ("glossy_color", False),
    "mirror_color_shader": ("mirror_color", False),
    "transparency_shader": ("transparency", True),
    "translucency_shader": ("translucency", True),
    "blend_shader": ("blend_value", True),
    "mask_shader": ("blend_value", True),
    "sigma_oren_shader": ("sigma", True),
    "IOR_shader": ("ior", True),
}


def apply_textures(arrays, static, row, sp):
    """Override textured material parameters per lane: first the tex_*
    slots (a colour slot blends by the row's layer mode and colour factor),
    then the node programs of the materials that have one."""
    if not getattr(static, "textures", ()):
        return row
    row = dict(row)
    for ti in range(len(static.textures)):
        val = sample_texture(arrays, static, ti, sp)
        for slot, target in _SLOTS_COLOR:
            mask = row[slot] == ti
            blended = _blend(row[target], val, row["tex_blend_mode"],
                             row["tex_colorfac"])
            row[target] = torch.where(mask[..., None], blended, row[target])
        for slot, target in _SLOTS_SCALAR:
            row[target] = torch.where(row[slot] == ti, luminance(val),
                                      row[target])
    progs = getattr(static, "node_programs", ())
    if progs:
        from .nodes import eval_node_program

        for pi, prog in enumerate(progs):
            mask = row["node_prog"] == pi
            for slot, col in eval_node_program(arrays, static, prog,
                                               sp).items():
                tgt = _NODE_SLOT_TARGETS.get(slot)
                if tgt is None:
                    continue
                key, scalar = tgt
                if scalar:
                    row[key] = torch.where(mask, luminance(col), row[key])
                else:
                    row[key] = torch.where(mask[..., None], col, row[key])
    return row


def bump_normal(arrays, static, row, sp, strength: float = 0.02):
    """Shading normals perturbed by the bump slot's image texture: central
    differences one texel apart in u and v, along the true uv tangents
    where the surface carries dPdU (the ONB otherwise), scaled by
    strength × the row's bump_strength."""
    if not getattr(static, "textures", ()):
        return sp["n"]
    n = sp["n"]
    for ti in range(len(static.textures)):
        if static.textures[ti][0] != "image":
            continue
        mask = row["tex_bump"] == ti
        img = arrays[f"tex_{ti}"]
        h, w = img.shape[0], img.shape[1]
        u, v = sp["uv"][..., 0], sp["uv"][..., 1]
        du = 1.0 / w
        dv = 1.0 / h
        f0 = luminance(sample_image_bilinear(img, u, v))
        fu = luminance(sample_image_bilinear(img, u + du, v))
        fv = luminance(sample_image_bilinear(img, u, v + dv))
        if sp.get("dpdu") is not None:
            du_p = sp["dpdu"] - n * vmath.dot(n, sp["dpdu"])[..., None]
            dl = _norm(du_p)[..., None]
            onb_u, onb_v = vmath.build_onb(n)
            tu = torch.where(dl > 1e-9, du_p / torch.clamp(dl, min=1e-9),
                             onb_u)
            tv_c = vmath.cross(n, tu)
            # keep the uv handedness of dPdV
            hand = torch.sign(vmath.dot(tv_c, sp["dpdv"]))[..., None]
            tv = torch.where(dl > 1e-9,
                             tv_c * torch.where(hand == 0.0, 1.0, hand),
                             onb_v)
        else:
            tu, tv = vmath.build_onb(n)
        grad_u = (fu - f0) / du
        grad_v = (fv - f0) / dv
        str_l = (strength * row["bump_strength"])[..., None]
        n_b = vmath.normalize(
            n - str_l * (grad_u[..., None] * tu + grad_v[..., None] * tv))
        n = torch.where(mask[..., None], n_b, n)
    return n
