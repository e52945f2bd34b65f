"""Full (s,t)-MIS bidirectional path tracing (port of
libyafaray_tpu/integrators/veach.py, Veach BDPT).

One eye subpath and one light subpath a pixel sample, and every (s,t)
connection strategy with s + t <= raydepth + 2, combined by the power
heuristic over the area-measure pdf-ratio recursion (`_mis_weight`):

    eye walk     T_MAX = min(raydepth, 6) surface vertices from the camera
    light walk   y0 on an emitter (picked by flux), then S_MAX - 1 = the
                 same cap less one surface vertices, importance transport
                 (Veach's shading-normal correction)
    s = 0        eye vertices that hit an emitter
    escape       the background, weight 1 (no light subpath starts there)
    s = 1        a fresh point on a light, resampled at each eye vertex
    eye-only     weight-1 NEE for lights outside the strategy set (zero
                 flux; IBL rides the escape term)
    s, t >= 2    inner connections of light and eye vertices
    t = 1        light vertices connected to the camera and splatted
                 through the reconstruction filter into a plane that the
                 render divides by the light paths a pixel and writes to
                 the film's density layer

The walks and the strategy blocks are Python loops over static bounds, as
in the reference; every block is ordinary tensor code over the N =
H·W·spp_batch lanes, and every closest hit and shadow segment goes through
the engine's `closest_hit` / `shadow_transmission`, so through the
triangle kernels (the tiny kernels on scenes/cornell_bidir.xml).  The rays
counted are the reference's: the live camera lanes times T_MAX + S_MAX a
step, connection rays not counted.  The film's pass planes take the eye
path's first hit (z, normal, geo_normal, uv, mat_index, obj_index,
diffuse_color) as plain per-sample sums; the film keeps no alpha plane,
as the reference's.  A saved film carries the t=1 plane summed so far
(`bd_splat`) and resumes at the step after it.

Lights: area, mesh, sphere, point and spot lights take part in light
subpaths and s = 1 (`_BD_LIGHT_TYPES`); sun, directional and IES lights
have no photon flux, so no pick probability, and reach the image through
the weight-1 eye-side NEE; the IBL light and portals through the escape.
Cameras: every type.  As in the reference, only perspective and architect
cameras give the camera vertex its direction pdf and make t = 1 splats
(projected through the pinhole even with an aperture); the others take
pdf_cam0 = 1 and no t = 1 strategy.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..backgrounds.base import eval_background
from ..cameras.base import (CAM_ARCHITECT, CAM_PERSPECTIVE,
                            pixel_plane_area, project_to_camera)
from ..convert import to_tensors
from ..core import math as vmath
from ..core import qmc
from ..core.sampling import (PI, sample_cone, sample_cos_hemisphere,
                             sample_sphere)
from ..film.filters import eval_filter_2d, filter_radius
from ..film.imagefilm import film_save, film_splat
from ..film.passes import film_add_passes
from ..lights import base as lightmod
from ..materials import blend as blendmod
from ..materials.base import MT_GLASS, MT_ROUGH_GLASS, gather_rows
from ..textures.eval import apply_textures, bump_normal
from .config import RenderConfig
from .engine import (F32, _channels, _surface_point, _tile, camera_rays,
                     check_arrays, check_supported, closest_hit, ray_bounds,
                     resolve_device, sample_light, shading_frame,
                     shadow_transmission, stack_planes, unstack_planes,
                     uses_textures)
from .photonmap import _light_cdf
from .render import (RenderResult, _fresh_film, _sync, film_params,
                     load_film, saves_passes)

# light subpaths and s=1 resampling take these emitter types; other lights
# contribute through the eye strategies only (a weight-1 partition)
_BD_LIGHT_TYPES = (lightmod.LT_AREA, lightmod.LT_MESH, lightmod.LT_SPHERE,
                   lightmod.LT_POINT, lightmod.LT_SPOT)


INV_4PI = 1.0 / (4.0 * PI)


def _rdiv(s: float, x: torch.Tensor) -> torch.Tensor:
    """s / x as a true float32 division (torch computes scalar / tensor as
    a reciprocal times the scalar)."""
    return torch.full_like(x, s) / x


def _remap0(x):
    """The ratio convention: a pdf of 0 (delta, unreachable) counts as 1,
    so the product skips it (the delta flags gate the sum)."""
    return torch.where(x > 0.0, x, 1.0)


def _to_area(pdf_sa, p_from, p_to, n_to, on_surface_to=True):
    """Solid-angle pdf at p_from -> area pdf at p_to.  on_surface_to: True
    (|cos| at n_to), False (a point: no cosine) or a per-lane bool
    tensor."""
    d = p_to - p_from
    d2 = torch.clamp(vmath.dot(d, d), min=1e-12)
    if on_surface_to is False:
        return pdf_sa / d2
    cos_t = vmath.dot(n_to, d / vmath.sqrt_rn(d2)[..., None]).abs()
    if on_surface_to is not True:
        cos_t = torch.where(on_surface_to, cos_t, 1.0)
    return pdf_sa * cos_t / d2


def _shading_corr(ns, ng, wo, wi):
    """Veach's shading-normal correction for importance (light -> eye)
    transport: |wo·ns||wi·ng| / (|wo·ng||wi·ns|), clipped to [0, 8]."""
    num = vmath.dot(wo, ns).abs() * vmath.dot(wi, ng).abs()
    den = torch.clamp(vmath.dot(wo, ng).abs() * vmath.dot(wi, ns).abs(),
                      min=1e-6)
    return torch.clamp(num / den, 0.0, 8.0)


def _light_tables(static) -> list:
    """Per-light flags of the MIS bookkeeping: whether the light takes part
    in light subpaths, is a delta position, or emits from a surface."""
    return [dict(supported=ls.enabled and ls.ltype in _BD_LIGHT_TYPES,
                 delta_pos=ls.ltype in (lightmod.LT_POINT, lightmod.LT_SPOT),
                 surface=ls.ltype in (lightmod.LT_AREA, lightmod.LT_MESH,
                                      lightmod.LT_SPHERE))
            for ls in static.lights]


def _emit_vertex(ls, lrow, n, u1, u2, u3, u4) -> dict:
    """The light subpath's origin y0 and first direction, with separable
    pdfs (BDPT's MIS needs the position and direction pdfs apart, unlike
    photon_shoot's folded flux): dict(org, nl, dirn, le (N,3) radiance or
    radiant intensity, pdf_pos (area; 1 for a point), pdf_dir (solid
    angle), cos0 |cos| at y0, 1 for a point).  A double-sided area light
    picks its side by u4's high half and reuses the rest of u4.  A
    meshlight goes through `_emit_mesh_vertex`; any other light gives a
    dead vertex (pdf_dir 0)."""
    dev = u1.device
    one = torch.ones((n,), dtype=F32, device=dev)
    zeros3 = torch.zeros((n, 3), dtype=F32, device=dev)
    if ls.ltype == lightmod.LT_AREA:
        q = (lrow["p0"] + u1[..., None] * lrow["e1"]
             + u2[..., None] * lrow["e2"])
        ln = vmath.normalize(vmath.cross(lrow["e1"], lrow["e2"]) + zeros3)
        dbl = lrow["double_sided"]
        flip = dbl & (u4 > 0.5)
        u4s = torch.where(dbl, torch.where(flip, (u4 - 0.5) * 2.0, u4 * 2.0),
                          u4)
        ln_s = torch.where(flip[..., None], -ln, ln)
        d, pdf_d = sample_cos_hemisphere(ln_s, u3, u4s)
        pdf_d = pdf_d * torch.where(dbl, 0.5, 1.0)
        return dict(org=q, nl=ln_s, dirn=d, le=lrow["radiance"] + zeros3,
                    pdf_pos=one / torch.clamp(lrow["area"], min=1e-9),
                    pdf_dir=pdf_d, cos0=vmath.dot(ln_s, d).abs())
    if ls.ltype == lightmod.LT_SPHERE:
        r = lrow["radius"]
        dn = sample_sphere(u1, u2)
        d, pdf_d = sample_cos_hemisphere(dn, u3, u4)
        area = 4.0 * PI * (r * r)
        return dict(org=lrow["p0"] + dn * r, nl=dn, dirn=d,
                    le=lrow["radiance"] + zeros3,
                    pdf_pos=one / torch.clamp(area, min=1e-9), pdf_dir=pdf_d,
                    cos0=vmath.dot(dn, d).abs())
    if ls.ltype == lightmod.LT_POINT:
        d = sample_sphere(u3, u4)
        return dict(org=lrow["p0"].expand(n, 3), nl=d, dirn=d,
                    le=lrow["intensity"] + zeros3, pdf_pos=one,
                    pdf_dir=one * INV_4PI, cos0=one)
    if ls.ltype == lightmod.LT_SPOT:
        axis = lrow["direction"].expand(n, 3)
        d, pdf_d = sample_cone(axis, lrow["cos_end"], u3, u4)
        fall = lightmod.spot_falloff(lrow, vmath.dot(d, axis))
        return dict(org=lrow["p0"].expand(n, 3), nl=d, dirn=d,
                    le=lrow["intensity"][None, :] * fall[..., None],
                    pdf_pos=one, pdf_dir=pdf_d + 0.0 * one, cos0=one)
    dirn = zeros3.clone()
    dirn[:, 2] = 1.0
    return dict(org=zeros3, nl=zeros3, dirn=dirn, le=zeros3, pdf_pos=one,
                pdf_dir=0.0 * one, cos0=one)


def _emit_mesh_vertex(arrays, ls, li, lrow, n, u1, u2, u3, u4) -> dict:
    """`_emit_vertex` of a meshlight: a uniform point by area
    (`lights.base.mesh_point`), a cosine direction about the side u4's
    high half picks (meshlights emit double-sided)."""
    q, ln = lightmod.mesh_point(
        arrays[f"mlight_cdf_{li}"],
        arrays["tri_pos"][ls.tri_start:ls.tri_start + ls.tri_count], u1, u2)
    flip = u4 > 0.5
    u4s = torch.where(flip, (u4 - 0.5) * 2.0, u4 * 2.0)
    ln_s = torch.where(flip[..., None], -ln, ln)
    d, pdf_d = sample_cos_hemisphere(ln_s, u3, u4s)
    one = torch.ones((n,), dtype=F32, device=u1.device)
    return dict(org=q, nl=ln_s, dirn=d,
                le=lrow["radiance"] + torch.zeros_like(q),
                pdf_pos=one / torch.clamp(lrow["area"], min=1e-9),
                pdf_dir=pdf_d * 0.5, cos0=vmath.dot(ln_s, d).abs())


def _sample_light_point(arrays, ls, li, lrow, n, u1, u2) -> dict:
    """s=1 resampling: a point on the light by area (not solid angle):
    dict(q, nl, le, pdf_pos (area; 1 for a point), dbl, surface)."""
    dev = u1.device
    one = torch.ones((n,), dtype=F32, device=dev)
    zeros3 = torch.zeros((n, 3), dtype=F32, device=dev)
    no = torch.zeros((n,), dtype=torch.bool, device=dev)
    if ls.ltype == lightmod.LT_AREA:
        q = (lrow["p0"] + u1[..., None] * lrow["e1"]
             + u2[..., None] * lrow["e2"])
        ln = vmath.normalize(vmath.cross(lrow["e1"], lrow["e2"]) + zeros3)
        return dict(q=q, nl=ln, le=lrow["radiance"] + zeros3,
                    pdf_pos=one / torch.clamp(lrow["area"], min=1e-9),
                    dbl=lrow["double_sided"], surface=True)
    if ls.ltype == lightmod.LT_MESH:
        smp = _emit_mesh_vertex(arrays, ls, li, lrow, n, u1, u2,
                                0.0 * one, 0.0 * one)
        return dict(q=smp["org"], nl=smp["nl"], le=smp["le"],
                    pdf_pos=smp["pdf_pos"], dbl=~no, surface=True)
    if ls.ltype == lightmod.LT_SPHERE:
        r = lrow["radius"]
        dn = sample_sphere(u1, u2)
        area = 4.0 * PI * (r * r)
        return dict(q=lrow["p0"] + dn * r, nl=dn,
                    le=lrow["radiance"] + zeros3,
                    pdf_pos=one / torch.clamp(area, min=1e-9), dbl=no,
                    surface=True)
    if ls.ltype in (lightmod.LT_POINT, lightmod.LT_SPOT):
        if ls.ltype == lightmod.LT_SPOT:
            nl = lrow["direction"].expand(n, 3)
        else:
            nl = zeros3.clone()
            nl[:, 2] = 1.0
        return dict(q=lrow["p0"].expand(n, 3), nl=nl,
                    le=lrow["intensity"] + zeros3, pdf_pos=one, dbl=no,
                    surface=False)
    return dict(q=zeros3, nl=zeros3, le=zeros3, pdf_pos=one, dbl=no,
                surface=False)


def _spot_fall(lrow, wi_from_light):
    """A spot's falloff toward wi_from_light (unit, light -> point)."""
    return lightmod.spot_falloff(lrow, vmath.dot(wi_from_light,
                                                 lrow["direction"]))


def _emit_dir_pdf_le(static, arrays, pick_pmf, li_id, p_l, n_l, w_out):
    """At light-surface points p_l (normals n_l) of the lights li_id, the
    emission pdf toward w_out (solid angle), the position pdf (area; 1 for
    a point) and the light's pick probability, gathered per lane over the
    static light list (0 for lanes on no supported light)."""
    n = li_id.shape[0]
    zero = torch.zeros((n,), dtype=F32, device=li_id.device)
    pdf_dir, pdf_pos, pick = zero, zero, zero
    for li, ls in enumerate(static.lights):
        if not (ls.enabled and ls.ltype in _BD_LIGHT_TYPES):
            continue
        lrow = lightmod.light_row(arrays["lights"], li)
        sel = li_id == li
        cos_o = vmath.dot(n_l, w_out)
        one = torch.ones_like(lrow["area"])
        if ls.ltype == lightmod.LT_AREA:
            pd = torch.where(lrow["double_sided"],
                             vmath.div(cos_o.abs(), 2.0 * PI),
                             vmath.div(torch.clamp(cos_o, min=0.0), PI))
            pp = one / torch.clamp(lrow["area"], min=1e-9)
        elif ls.ltype == lightmod.LT_MESH:
            pd = vmath.div(cos_o.abs(), 2.0 * PI)
            pp = one / torch.clamp(lrow["area"], min=1e-9)
        elif ls.ltype == lightmod.LT_SPHERE:
            pd = vmath.div(torch.clamp(cos_o, min=0.0), PI)
            r = lrow["radius"]
            pp = one / torch.clamp(4.0 * PI * (r * r), min=1e-9)
        elif ls.ltype == lightmod.LT_POINT:
            pd = zero + INV_4PI
            pp = one
        else:  # spot
            den = torch.clamp(2.0 * PI * (1.0 - lrow["cos_end"]), min=1e-9)
            pd = (zero + 1.0) / den
            pd = pd * (vmath.dot(w_out, lrow["direction"])
                       > lrow["cos_end"])
            pp = one
        pdf_dir = torch.where(sel, pd, pdf_dir)
        pdf_pos = torch.where(sel, pp + zero, pdf_pos)
        pick = torch.where(sel, pick_pmf[li], pick)
    return pdf_dir, pdf_pos, pick


def d2v(dist):
    return torch.clamp(dist * dist, min=1e-9)


def make_bdpt_step(cscene, cfg: RenderConfig, device):
    """The BDPT sample step on `device`:
        step(arrays, film, flags) -> (film', splat_plane)
    with `arrays` the scene tensors on `device` and flags (H, W) bool.  The
    eye-side strategies splat into the film; the t=1 strategies return an
    unnormalized (H, W, 3) plane (the caller divides its sum by the light
    paths a pixel)."""
    static, camera = cscene.static, cscene.camera
    check_supported(static, cfg)
    dev = resolve_device(device)
    h, w = cfg.height, cfg.width
    spb = max(1, cfg.spp_batch)
    n = h * w * spb

    # subpath lengths: T_MAX eye surface vertices, S_MAX light vertices (y0
    # on the emitter included); raydepth bounds s + t
    T_MAX = max(1, min(cfg.raydepth, 6))
    S_MAX = max(1, min(cfg.raydepth, 6))
    max_verts = cfg.raydepth + 2  # t counts the camera vertex

    cdf, _ = _light_cdf(static, cscene.arrays["lights"])
    pick_pmf = np.diff(cdf).astype(np.float32)
    pick_pmf_t = torch.from_numpy(pick_pmf).to(dev)
    cdf_t = torch.from_numpy(cdf).to(dev)
    tables = _light_tables(static)
    bd_lights = [li for li, tb in enumerate(tables) if tb["supported"]]
    has_any_bd_light = any(pick_pmf[li] > 0 for li in bd_lights)
    # lights outside the strategy set (zero flux, or a type light subpaths
    # do not take): weight-1 NEE; background and portal ride the escape
    eye_only = [li for li, ls in enumerate(static.lights)
                if ls.enabled and ls.ltype not in (lightmod.LT_BACKGROUND,
                                                   lightmod.LT_PORTAL)
                and (li not in bd_lights or pick_pmf[li] <= 0.0)]

    cam_persp = camera.cam_type in (CAM_PERSPECTIVE, CAM_ARCHITECT)
    a_film = pixel_plane_area(camera) * h * w
    focal2 = float(camera.focal) ** 2 if cam_persp else 1.0
    cam_org = torch.tensor(camera.origin, dtype=F32, device=dev)
    cam_fwd = torch.tensor(camera.fwd, dtype=F32, device=dev)

    lane = torch.arange(n, dtype=torch.int32, device=dev)
    lane_pix = lane % (h * w)
    lane_k = torch.div(lane, h * w, rounding_mode="floor")
    py = torch.div(lane_pix, w, rounding_mode="floor")
    px = lane_pix - py * w
    # the reference's BDPT keys its pixels without qmc_seed
    pixel_hash = qmc.hash_u32(px ^ (py << 16))
    zeros_i = torch.zeros((n,), dtype=torch.int32, device=dev)
    zeros_f = torch.zeros((n,), dtype=F32, device=dev)
    zeros3 = torch.zeros((n, 3), dtype=F32, device=dev)

    tex = uses_textures(static)
    # Beer media on glass and rough glass; no wavelength lane: a dispersive
    # glass renders at its base IOR, as in the reference
    media = bool({MT_GLASS, MT_ROUGH_GLASS} & set(static.mat_families))
    families, depth = static.mat_families, static.has_blend
    bias = static.shadow_bias

    def word(x: int) -> torch.Tensor:
        return qmc.word_like(zeros_i, x)

    def cam_pdf(cos_c):
        """Camera direction pdf (solid angle, whole-film measure) at
        cos_c to the view axis: focal² / (A_film · cos³)."""
        c = torch.clamp(cos_c, min=1e-4)
        return _rdiv(focal2, torch.clamp(a_film * (c * c * c), min=1e-12))

    def shadow(arrays, org, dirn, dist):
        return shadow_transmission(arrays, static, cfg.transp_shad, org,
                                   dirn, dist)

    def eval_f(arrays, v, wo, wi):
        return blendmod.eval_bsdf(arrays["materials"], v["row"], v["n"],
                                  v["ng"], wo, wi, depth, families)

    def pdf_f(arrays, v, wo, wi):
        return blendmod.pdf_bsdf(arrays["materials"], v["row"], v["n"],
                                 v["ng"], wo, wi, depth, families)

    def walk(arrays, org, dirn, beta, pdf_dir, alive, skey, importance,
             p_prev, n_prev, on_prev, n_steps, first_aux=False) -> list:
        """A subpath from (org, dirn) with start throughput beta and
        direction pdf pdf_dir (solid angle at the previous vertex), n_steps
        surface vertices.  Vertex i sets the reverse pdf of vertex i-1 (the
        first keeps its own as prev_rev for the caller's origin).
        first_aux: the first vertex also keeps its hit's t, uv, triangle
        and material (the film's pass planes read them)."""
        mats = arrays["materials"]
        verts = []
        medium = zeros3
        for i in range(n_steps):
            hit = closest_hit(arrays, static, org, dirn,
                              *ray_bounds(static, alive))
            if media:
                seg = torch.where(hit.hit, hit.t, 0.0)
                beta = beta * torch.exp(-medium * seg[..., None])
            escape = alive & ~hit.hit
            alive = alive & hit.hit
            # textures sample at footprint 0 (mip level 0) on BDPT vertices
            keep = first_aux and i == 0
            sp = _surface_point(arrays, hit, org, dirn, fp=zeros_f,
                                tex=tex or keep)
            wo = -dirn
            row = gather_rows(mats, sp["mat"].long())
            if tex:
                if static.need_window:
                    pxw, pyw, _, _, _ = project_to_camera(camera, sp["p"])
                    sp["win"] = torch.stack([vmath.div(pxw, w),
                                             vmath.div(pyw, h)], dim=-1)
                row = apply_textures(arrays, static, row, sp)
                sp["n"] = bump_normal(arrays, static, row, sp)
            n_sh, ng_sh = shading_frame(sp, wo)
            v = dict(p=sp["p"], n=n_sh, ng=ng_sh, ng_hit=sp["ng"],
                     light_id=sp["light_id"], row=row, wo=wo, beta=beta,
                     valid=alive, escape=escape,
                     # area-measure forward pdf of this vertex
                     pdf_fwd=_to_area(pdf_dir, p_prev, sp["p"], ng_sh),
                     pdf_rev=zeros_f)
            if keep:
                v.update(t=hit.t, uv=sp["uv"], tri=sp["tri"], mat=sp["mat"])

            u1, u2, ul = (qmc.sample_dim(zeros_i, d, qmc.hash_combine(
                skey, word(11 + d + 7 * i))) for d in range(3))
            smp = blendmod.sample_bsdf(mats, row, n_sh, ng_sh, wo, u1, u2,
                                       ul, depth, families)
            v["delta"] = smp["specular"]
            # reverse pdf of the previous vertex: sampling wo given the
            # incoming smp.wi here, to area at the previous vertex
            pdf_rev_sa = torch.where(smp["specular"], 0.0, blendmod.pdf_bsdf(
                mats, row, n_sh, ng_sh, smp["wi"], wo, depth, families))
            prev_rev = _to_area(pdf_rev_sa, sp["p"], p_prev, n_prev,
                                on_surface_to=on_prev)
            if i == 0:
                v["prev_rev"] = prev_rev
            else:
                verts[i - 1]["pdf_rev"] = torch.where(
                    alive, prev_rev, verts[i - 1]["pdf_rev"])
            tp = smp["tp"]
            if importance:
                tp = tp * _shading_corr(n_sh, ng_sh, wo, smp["wi"])[..., None]
            beta = beta * tp
            alive = alive & smp["valid"] & (tp.amax(dim=-1) > 0.0)
            if media:
                leave = smp["transmit"] & ~smp["entering"]
                medium = torch.where(
                    smp["entering"][..., None], row["absorption_sigma"],
                    torch.where(leave[..., None], 0.0, medium))
            off = torch.where(smp["transmit"], -1.0, 1.0)[..., None]
            org = sp["p"] + ng_sh * off * bias
            dirn = smp["wi"]
            pdf_dir = torch.where(smp["specular"], 0.0, smp["pdf"])
            p_prev, n_prev, on_prev = sp["p"], ng_sh, True
            verts.append(v)
        return verts

    def mis_weight(s, t, Lv, Ev, ov):
        """1 / (1 + Σ r_i²) over the ratio recursion of both subpaths
        (power heuristic, β = 2).  ov: reverse-pdf overrides at the junction
        vertices, {("E", i) or ("L", i): pdf}, and "sampled", the s=1
        light vertex.  A delta flag known to be false is None."""
        if s + t == 2:
            return torch.ones((n,), dtype=F32, device=dev)
        sum_ri = zeros_f

        def add(ri, d_i, d_prev):
            flags = [d for d in (d_i, d_prev) if d is not None]
            if not flags:
                return sum_ri + ri
            off = flags[0] if len(flags) == 1 else flags[0] | flags[1]
            return sum_ri + torch.where(off, 0.0, ri)

        # camera side, i = t-1 .. 1 over the eye surface vertices (Ev[i-1]
        # is z_i; the camera z_0 is never summed)
        ri = None
        for i in range(t - 1, 0, -1):
            v = Ev[i - 1]
            r = _remap0(ov.get(("E", i), v["pdf_rev"])) / _remap0(v["pdf_fwd"])
            ri = r * r if ri is None else ri * (r * r)
            d_i = None if i == t - 1 else v["delta"]
            d_prev = (None if i - 1 == 0 or i - 1 == t - 1
                      else Ev[i - 2]["delta"])
            sum_ri = add(ri, d_i, d_prev)
        # light side, i = s-1 .. 0 over the light vertices
        ri = None
        for i in range(s - 1, -1, -1):
            v = ov["sampled"] if (s == 1 and i == 0) else Lv[i]
            r = _remap0(ov.get(("L", i), v["pdf_rev"])) / _remap0(v["pdf_fwd"])
            ri = r * r if ri is None else ri * (r * r)
            d_i = None if i == s - 1 else v["delta"]
            if i > 0:
                d_prev = Lv[i - 1]["delta"] if i - 1 != s - 1 else None
                if s == 1 and i - 1 == 0:
                    d_prev = ov["sampled"]["delta"]
            else:
                d_prev = (ov["sampled"] if s == 1 else Lv[0])["delta_light"]
            sum_ri = add(ri, d_i, d_prev)
        return _rdiv(1.0, 1.0 + sum_ri)

    def pick_light(u):
        """The last light li with u >= cdf[li] (the reference's pick, not
        a searchsorted)."""
        lp = zeros_i
        for li in range(len(static.lights)):
            lp = torch.where(u >= cdf_t[li], li, lp)
        return lp

    def light_subpath(arrays, skey_step, active) -> list:
        """y0 on a light picked by flux, then the importance walk."""
        skey_l = qmc.hash_combine(skey_step, word(0x11A))
        u_pick, u1, u2, u3, u4 = (qmc.sample_dim(zeros_i, d, skey_l)
                                  for d in range(5))
        li_pick = pick_light(u_pick)
        org0, nl0, le0 = zeros3, zeros3, zeros3
        dir0 = torch.zeros_like(zeros3)
        dir0[:, 2] = 1.0
        ppos0 = torch.ones_like(zeros_f)
        pdir0 = zeros_f
        cos00 = ppos0
        pick0 = ppos0
        no = torch.zeros((n,), dtype=torch.bool, device=dev)
        dl0, surf0 = no, no
        for li in bd_lights:
            ls = static.lights[li]
            lrow = lightmod.light_row(arrays["lights"], li)
            if ls.ltype == lightmod.LT_MESH:
                e = _emit_mesh_vertex(arrays, ls, li, lrow, n, u1, u2, u3, u4)
            else:
                e = _emit_vertex(ls, lrow, n, u1, u2, u3, u4)
            sel = li_pick == li
            sel3 = sel[..., None]
            org0 = torch.where(sel3, e["org"], org0)
            nl0 = torch.where(sel3, e["nl"], nl0)
            dir0 = torch.where(sel3, e["dirn"], dir0)
            le0 = torch.where(sel3, e["le"], le0)
            ppos0 = torch.where(sel, e["pdf_pos"], ppos0)
            pdir0 = torch.where(sel, e["pdf_dir"], pdir0)
            cos00 = torch.where(sel, e["cos0"], cos00)
            pick0 = torch.where(sel, torch.clamp(pick_pmf_t[li], min=1e-12),
                                pick0)
            dl0 = torch.where(sel, tables[li]["delta_pos"], dl0)
            surf0 = torch.where(sel, tables[li]["surface"], surf0)
        alive_l = active & (pdir0 > 0.0) & (le0.amax(dim=-1) > 0.0)
        beta_l1 = (le0 * cos00[..., None]
                   / torch.clamp(pick0 * ppos0 * pdir0, min=1e-12)[..., None])
        y0 = dict(p=org0, n=nl0,
                  beta=le0 / torch.clamp(pick0 * ppos0, min=1e-12)[..., None],
                  pdf_fwd=pick0 * ppos0, pdf_rev=zeros_f, delta=no,
                  delta_light=dl0, surface=surf0, valid=alive_l)
        lift = torch.where(surf0, bias, 0.0)[..., None]
        lw = walk(arrays, org0 + nl0 * lift, dir0, beta_l1, pdir0, alive_l,
                  qmc.hash_combine(skey_step, word(0x11B)), True, org0, nl0,
                  surf0, S_MAX - 1)
        if lw:
            y0["pdf_rev"] = torch.where(lw[0]["valid"], lw[0].pop("prev_rev"),
                                        y0["pdf_rev"])
        for v in lw:
            v["delta_light"] = dl0
        return [y0] + lw

    def first_hit_planes(film: dict, planes: list, z1: dict, active) -> dict:
        """The film's pass planes plus the eye path's first hit, each a
        plain per-sample sum (the spb samples a pixel summed first), all in
        one add; a plane of no first-hit source keeps its zeros."""
        hm = z1["valid"]
        h3, hf = hm[..., None], hm.to(F32)
        src = dict(z=lambda: torch.where(hm, z1["t"], 0.0),
                   normal=lambda: torch.where(h3, z1["n"], 0.0),
                   geo_normal=lambda: torch.where(h3, z1["ng"], 0.0),
                   uv=lambda: torch.where(h3, z1["uv"], 0.0),
                   mat_index=lambda: z1["mat"].to(F32) * hf,
                   obj_index=lambda: z1["tri"].to(F32) * hf,
                   diffuse_color=lambda: torch.where(
                       h3, z1["row"]["diffuse_color"], 0.0))
        keys = [k for k in planes if k[4:] in src]
        if not keys:
            return {}
        val = torch.cat([_channels(src[k[4:]]()) for k in keys], dim=-1)
        val = val * active.to(F32)[:, None]
        base = stack_planes(film, keys)
        return unstack_planes(keys, film, base + val.reshape(
            spb, h, w, base.shape[-1]).sum(dim=0))

    def step(arrays: dict, film: dict, flags: torch.Tensor):
        check_arrays(arrays, dev)
        mats = arrays["materials"]
        s_idx = _tile(film["nsamples"].reshape(-1), spb) + lane_k
        active = _tile(flags.reshape(-1), spb)
        skey_step = qmc.hash_combine(pixel_hash, s_idx)

        # ---- eye subpath ----
        dx, dy, org_e, dir_e, wt = camera_rays(camera, px, py, pixel_hash,
                                               s_idx)
        alive_e = active & (wt > 0.0)
        pdf_cam0 = (cam_pdf(vmath.dot(dir_e, cam_fwd)) if cam_persp
                    else torch.ones_like(zeros_f))
        planes = [k for k in film if k.startswith("aov_")]
        Ev = walk(arrays, org_e, dir_e, torch.ones_like(zeros3), pdf_cam0,
                  alive_e, qmc.hash_combine(skey_step, word(0xE7E)), False,
                  org_e, cam_fwd + zeros3, False, T_MAX, bool(planes))

        # ---- light subpath ----
        Lv = light_subpath(arrays, skey_step, active) if has_any_bd_light \
            else []

        L = zeros3
        splat = torch.zeros((h * w, 3), dtype=F32, device=dev)

        # ---- s = 0: the eye path hits an emitter ----
        for t in range(2, min(T_MAX + 1, max_verts) + 1):
            zv = Ev[t - 2]
            emit = blendmod.emission(mats, zv["row"], zv["ng"], zv["wo"],
                                     depth)
            li_id = zv["light_id"]
            if static.lights:
                lpk = arrays["lights"]["hit_pack"][
                    torch.clamp(li_id, min=0).long()]
                front = (vmath.dot(zv["ng_hit"], zv["wo"]) > 0.0) | (
                    lpk[:, 1] > 0.5)
                emit = emit + torch.where(((li_id >= 0) & front)[..., None],
                                          lpk[:, 2:5], 0.0)
            has_e = emit.amax(dim=-1) > 0.0
            if t == 2:
                wmis = None
            else:
                # z_t's reverse pdf: the light's pick · position pdf;
                # z_{t-1}'s: its emission pdf toward z_{t-1}, to area
                zprev = Ev[t - 3]
                w_out = vmath.normalize(zprev["p"] - zv["p"])
                pdf_d, pdf_p, pick = _emit_dir_pdf_le(
                    static, arrays, pick_pmf_t, li_id, zv["p"], zv["ng"],
                    w_out)
                ov = {("E", t - 1): pick * pdf_p,
                      ("E", t - 2): _to_area(pdf_d, zv["p"], zprev["p"],
                                             zprev["ng"])}
                # emitting surfaces that are no registered light are
                # reached by no other strategy: weight 1
                wmis = torch.where(pick > 0.0, mis_weight(0, t, Lv, Ev, ov),
                                   1.0)
            contrib = zv["beta"] * emit
            if wmis is not None:
                contrib = contrib * wmis[..., None]
            L = L + torch.where((zv["valid"] & has_e)[..., None], contrib,
                                0.0)

        # ---- background escape, weight 1: no light subpath starts on the
        # background; a vertex's beta is its throughput on arrival ----
        for zv in Ev:
            bgv = eval_background(static.bg, arrays.get("bg_image"),
                                  -zv["wo"])
            L = L + torch.where(zv["escape"][..., None], zv["beta"] * bgv,
                                0.0)

        # ---- s = 1: a light point resampled at each eye vertex ----
        for t in range(2, min(T_MAX + 1, max_verts - 1) + 1):
            if not has_any_bd_light:
                break
            zv = Ev[t - 2]
            sk = qmc.hash_combine(skey_step, word(0x51D0 + 13 * t))
            u_p, u1, u2 = (qmc.sample_dim(zeros_i, d, sk) for d in range(3))
            lp = pick_light(u_p)
            q, nl, le = zeros3, zeros3, zeros3
            ppos = torch.ones_like(zeros_f)
            pick = ppos
            no = torch.zeros((n,), dtype=torch.bool, device=dev)
            dls, surf, dbl = no, no, no
            for li in bd_lights:
                lrow = lightmod.light_row(arrays["lights"], li)
                smp = _sample_light_point(arrays, static.lights[li], li,
                                          lrow, n, u1, u2)
                sel = lp == li
                sel3 = sel[..., None]
                q = torch.where(sel3, smp["q"], q)
                nl = torch.where(sel3, smp["nl"], nl)
                lev = smp["le"]
                if static.lights[li].ltype == lightmod.LT_SPOT:
                    wi_l = vmath.normalize(zv["p"] - smp["q"])
                    lev = lev * _spot_fall(lrow, wi_l)[..., None]
                le = torch.where(sel3, lev, le)
                ppos = torch.where(sel, smp["pdf_pos"], ppos)
                pick = torch.where(sel, torch.clamp(pick_pmf_t[li],
                                                    min=1e-12), pick)
                dls = torch.where(sel, not smp["surface"], dls)
                surf = torch.where(sel, smp["surface"], surf)
                dbl = torch.where(sel, smp["dbl"], dbl)
            dvec = q - zv["p"]
            d2 = torch.clamp(vmath.dot(dvec, dvec), min=1e-12)
            dist = vmath.sqrt_rn(d2)
            wi = dvec / dist[..., None]
            cos_l = vmath.dot(nl, -wi)
            cos_l_eff = torch.where(dbl | dls, cos_l.abs(),
                                    torch.clamp(cos_l, min=0.0))
            cos_z = vmath.dot(zv["n"], wi)
            f_z = eval_f(arrays, zv, zv["wo"], wi)
            geo = torch.where(surf, cos_l_eff, 1.0) / d2
            contrib = zv["beta"] * f_z * le * (
                cos_z.abs() * geo / torch.clamp(pick * ppos, min=1e-12)
            )[..., None]
            pot = zv["valid"] & (contrib.amax(dim=-1) > 0.0)
            org_s = zv["p"] + zv["ng"] * torch.sign(cos_z)[..., None] * bias
            tr = shadow(arrays, org_s, wi,
                        torch.where(pot, dist - 2.0 * bias, -1.0))
            # the sampled vertex's reverse pdf: z_{t-1} scattering toward
            # the light; z_{t-1}'s: the light's emission toward it, to area
            sampled = dict(
                p=q, n=nl, pdf_fwd=pick * ppos, delta=None, delta_light=dls,
                pdf_rev=_to_area(pdf_f(arrays, zv, zv["wo"], wi), zv["p"], q,
                                 nl, on_surface_to=surf))
            pdf_d_l = _emit_dir_pdf_le(static, arrays, pick_pmf_t, lp, q, nl,
                                       -wi)[0]
            ov = {("E", t - 1): _to_area(pdf_d_l, q, zv["p"], zv["ng"]),
                  "sampled": sampled}
            if t >= 3:
                zprev = Ev[t - 3]
                ov[("E", t - 2)] = _to_area(pdf_f(arrays, zv, wi, zv["wo"]),
                                            zv["p"], zprev["p"], zprev["ng"])
            wmis = mis_weight(1, t, Lv, Ev, ov)
            L = L + torch.where(pot[..., None], contrib * tr * wmis[..., None],
                                0.0)

        # ---- eye-only lights, weight-1 NEE: zero-flux emitters, outside
        # the strategy set (light subpaths never start from them) ----
        for li in eye_only:
            ls = static.lights[li]
            for t in range(2, min(T_MAX + 1, max_verts - 1) + 1):
                zv = Ev[t - 2]
                sk = qmc.hash_combine(skey_step, word(0xE0E0 + 31 * li + t))
                u1, u2 = (qmc.sample_dim(zeros_i, d, sk) for d in range(2))
                smp = sample_light(arrays, static, li, zv["p"], u1, u2)
                cos_z = vmath.dot(zv["n"], smp["wi"])
                f_z = eval_f(arrays, zv, zv["wo"], smp["wi"])
                term = zv["beta"] * f_z * smp["li"] * (
                    cos_z.abs() / torch.clamp(smp["pdf"], min=1e-9))[..., None]
                pot = (zv["valid"] & smp["valid"] & (smp["pdf"] > 1e-9)
                       & (term.amax(dim=-1) > 0.0))
                if ls.cast_shadows:
                    org_s = (zv["p"] + zv["ng"] * torch.sign(cos_z)[..., None]
                             * bias)
                    term = term * shadow(arrays, org_s, smp["wi"],
                                         torch.where(pot, smp["dist"], -1.0))
                L = L + torch.where(pot[..., None], term, 0.0)

        # ---- s >= 2, t >= 2: inner connections ----
        for s in range(2, min(S_MAX, len(Lv)) + 1):
            for t in range(2, min(T_MAX + 1, max_verts - s) + 1):
                yv, zv = Lv[s - 1], Ev[t - 2]
                dvec = yv["p"] - zv["p"]
                d2 = torch.clamp(vmath.dot(dvec, dvec), min=1e-12)
                dist = vmath.sqrt_rn(d2)
                wi = dvec / dist[..., None]  # z -> y
                f_z = eval_f(arrays, zv, zv["wo"], wi)
                f_y = eval_f(arrays, yv, yv["wo"], -wi) * _shading_corr(
                    yv["n"], yv["ng"], yv["wo"], -wi)[..., None]
                g = (vmath.dot(zv["n"], wi).abs()
                     * vmath.dot(yv["n"], wi).abs() / d2)
                contrib = zv["beta"] * f_z * f_y * yv["beta"] * g[..., None]
                pot = (zv["valid"] & yv["valid"]
                       & (contrib.amax(dim=-1) > 0.0))
                org_s = zv["p"] + zv["ng"] * torch.sign(vmath.dot(
                    zv["ng"], wi))[..., None] * bias
                tr = shadow(arrays, org_s, wi,
                            torch.where(pot, dist - 2.0 * bias, -1.0))
                # reverse pdfs at the four junction vertices, all to area
                # at the target's geometric normal (the walks' convention)
                yprev = Lv[s - 2]
                ov = {("L", s - 1): _to_area(pdf_f(arrays, zv, zv["wo"], wi),
                                             zv["p"], yv["p"], yv["ng"]),
                      ("E", t - 1): _to_area(pdf_f(arrays, yv, yv["wo"], -wi),
                                             yv["p"], zv["p"], zv["ng"]),
                      ("L", s - 2): _to_area(
                          pdf_f(arrays, yv, -wi, yv["wo"]), yv["p"],
                          yprev["p"], yprev.get("ng", yprev["n"]),
                          on_surface_to=(yprev["surface"] if s == 2
                                         else True))}
                if t >= 3:
                    zprev = Ev[t - 3]
                    ov[("E", t - 2)] = _to_area(
                        pdf_f(arrays, zv, wi, zv["wo"]), zv["p"], zprev["p"],
                        zprev["ng"])
                wmis = mis_weight(s, t, Lv, Ev, ov)
                L = L + torch.where(pot[..., None],
                                    contrib * tr * wmis[..., None], 0.0)

        # ---- t = 1: light vertices to the camera, splatted ----
        if has_any_bd_light and cam_persp:
            r = filter_radius(cfg.filter_type, cfg.aa_pixelwidth)
            for s in range(2, min(S_MAX, max_verts - 1, len(Lv)) + 1):
                yv = Lv[s - 1]
                pxc, pyc, cos_c, dist, ok = project_to_camera(camera,
                                                              yv["p"])
                we = cam_pdf(cos_c)
                pdf_cd = torch.where(ok, we, 0.0)
                to_cam = vmath.normalize(cam_org - yv["p"])
                cos_y = vmath.dot(yv["n"], to_cam)
                f_y = eval_f(arrays, yv, yv["wo"], to_cam) * _shading_corr(
                    yv["n"], yv["ng"], yv["wo"], to_cam)[..., None]
                contrib = yv["beta"] * f_y * (
                    cos_y.abs() / d2v(dist) * we)[..., None]
                pot = yv["valid"] & ok & (contrib.amax(dim=-1) > 0.0)
                org_s = (yv["p"] + yv["ng"] * torch.sign(cos_y)[..., None]
                         * bias)
                tr = shadow(arrays, org_s, to_cam,
                            torch.where(pot, dist - 2.0 * bias, -1.0))
                # the camera side is empty; overrides on the light chain
                yprev = Lv[s - 2]
                ov = {("L", s - 1): _to_area(pdf_cd, cam_org + zeros3,
                                             yv["p"], yv["ng"]),
                      ("L", s - 2): _to_area(
                          pdf_f(arrays, yv, to_cam, yv["wo"]), yv["p"],
                          yprev["p"], yprev.get("ng", yprev["n"]),
                          on_surface_to=(yprev["surface"] if s == 2
                                         else True))}
                wmis = mis_weight(s, 1, Lv, Ev, ov)
                c = torch.where(pot[..., None],
                                contrib * tr * wmis[..., None], 0.0)
                # a filter-weighted scatter of unit mass per connection; a
                # lane off the film adds 0 (its position is zeroed first:
                # the cast of NaN to int is not defined)
                pxs = torch.where(ok, pxc, 0.0)
                pys = torch.where(ok, pyc, 0.0)
                xi0 = torch.floor(pxs).to(torch.int32)
                yi0 = torch.floor(pys).to(torch.int32)
                sx, sy = pxs - xi0, pys - yi0
                offs = [(oy, ox) for oy in range(-r, r + 1)
                        for ox in range(-r, r + 1)]
                wgt = [torch.clamp(eval_filter_2d(
                    cfg.filter_type, ox + 0.5 - sx, oy + 0.5 - sy,
                    cfg.aa_pixelwidth), min=0.0) for oy, ox in offs]
                wtot = torch.clamp(sum(wgt), min=1e-9)
                for (oy, ox), w_ in zip(offs, wgt):
                    xi = torch.clamp(xi0 + ox, 0, w - 1)
                    yi = torch.clamp(yi0 + oy, 0, h - 1)
                    splat.index_add_(0, (yi * w + xi).long(),
                                     c * (w_ / wtot)[..., None])

        # ---- film ----
        L = torch.nan_to_num(L * wt[..., None], nan=0.0, posinf=0.0)
        film = film_splat(film, L.reshape(spb, h, w, 3),
                          dx.reshape(spb, h, w), dy.reshape(spb, h, w),
                          active.to(F32).reshape(spb, h, w), cfg.filter_type,
                          cfg.aa_pixelwidth,
                          clamp_samples=cfg.aa_clamp_samples)
        if planes:
            film.update(first_hit_planes(film, planes, Ev[0], active))
        rays = alive_e.to(F32).sum() * float(T_MAX + S_MAX)
        film = dict(film, rays=film["rays"] + rays)
        return film, torch.nan_to_num(splat.reshape(h, w, 3), nan=0.0,
                                      posinf=0.0)

    return step


def _check_unported(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "multi-device BDPT (a device mesh) is not ported yet: ROADMAP "
            "Queue 1 item 19")


def _run(cscene, cfg: RenderConfig, device, warm_up: bool, film_path=None,
         progress_cb=None) -> RenderResult:
    """aa_samples · aa_passes uniform steps (the reference runs no adaptive
    flags under BDPT), each of spp_batch samples a pixel; the t=1 planes
    summed and divided by the light paths a pixel into film["density"].
    film_path: the film and the t=1 sum saved after every step (film
    save / load "save" / "load-save" or autosave by pass) and resumed under
    "load" / "load-save"; progress_cb(step done, steps) after each step."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    check_supported(cscene.static, cfg)
    arrays = to_tensors(cscene.arrays, dev)
    step = make_bdpt_step(cscene, cfg, dev)
    h, w = cfg.height, cfg.width
    flags = torch.ones((h, w), dtype=torch.bool, device=dev)
    if warm_up:  # one step on a throw-away film, outside the clock
        step(arrays, _fresh_film(cfg, dev), flags)
        _sync(dev)
    film = _fresh_film(cfg, dev)
    if cfg.passes:
        film = film_add_passes(film, h, w, cfg.passes, dev)
    splat = torch.zeros((h, w, 3), dtype=F32, device=dev)
    n_steps = max(1, cfg.aa_samples * cfg.aa_passes)
    spb = max(1, cfg.spp_batch)
    start = 0
    loaded = load_film(cfg, film_path, dev)
    if loaded is not None:
        lf, start = loaded
        splat = lf.pop("bd_splat")
        film = {k: lf.get(k, v) for k, v in film.items()}
    t1 = time.perf_counter()
    for p in range(start, n_steps):
        film, plane = step(arrays, film, flags)
        splat = splat + plane
        if progress_cb is not None:
            progress_cb(p + 1, n_steps)
        if saves_passes(cfg, film_path):
            film_save(film_path, dict(film, bd_splat=splat),
                      film_params(cfg), p + 1)
    film["density"] = vmath.div(splat, max(n_steps * spb, 1))
    _sync(dev)
    t2 = time.perf_counter()
    return RenderResult(film, dict(render_s=t2 - t1, total_s=t2 - t0,
                                   rays=float(film["rays"]),
                                   bdpt_steps=n_steps), cfg)


def render_bdpt(cscene, cfg: RenderConfig, *, device="cuda", film_path=None,
                progress_cb=None, mesh=None) -> RenderResult:
    """Full-MIS BDPT render: one eye and one light subpath a pixel sample
    a step; stats render_s, total_s, rays, bdpt_steps.  film_path and
    progress_cb as `_run`; a device mesh raises, naming its ROADMAP
    item."""
    _check_unported(mesh)
    return _run(cscene, cfg, device, warm_up=False, film_path=film_path,
                progress_cb=progress_cb)


def render_bdpt_timed(cscene, cfg: RenderConfig, *,
                      device="cuda") -> RenderResult:
    """render_bdpt after one warm-up step on a throw-away film outside the
    clock (the Mrays/s metric; the rays are the reference's count, so
    BDPT's Mrays/s does not compare with the path tracer's)."""
    return _run(cscene, cfg, device, warm_up=True)
