"""The wavefront render engine (port of libyafaray_tpu/integrators/
engine.py `make_sample_step`), in its two modes: "path" (pathtracing) and
"direct" (directlighting).

`make_sample_step` builds a function that advances the film by one step
of spp_batch samples per pixel:

    sample_step : (scene tensors, film, flags) -> film'
      generate rays   (camera.shoot_rays over n = H·W·spb lanes, QMC dims
                      0,1; lane k·H·W + i is sample nsamples[i] + k of
                      pixel i)
      bounce 0        static QMC dims; every light's full sample count
                      for NEE, batched block-major over ns·n lanes; in
                      direct mode ambient occlusion, and with a caustic
                      photon map its density at the hit
      bounces 1..B    hash-keyed dynamic QMC dims; 1 NEE sample per light
                      (AA_clamp_indirect clamps that term)
      splat           spb plane splats into a fresh film fragment, added
                      once to the film (and the m2 plane where the film has
                      one); the alpha and pass planes as below

The film's planes decide what else a step computes, so a film without
them costs nothing more.  An `alpha` plane (bg_transp) keeps each lane's
camera-visibility chain (`track`: through null and straight-through
transparency, and refracted specular chains under bg_transp_refract) and
whether it reached the background (`transp`); `aov_<source>` planes
(film/passes.py) ask the first vertex for their sources (`first_hit_aux`:
AO and the shadow value only then) and, for reflect / refract, keep per
lane the light that arrived through a bounce-0 specular reflection /
transmission (`tag`).  The filter-weighted planes (alpha, direct, emit,
reflect, refract) go into the film in one splat of their channels
stacked, the others as plain per-sample sums in one add.

B is `bounces` in path mode and `raydepth` in direct mode, plus the scene's
largest per-material additionalDepth: a lane's depth budget rises where it
meets such a material, and a lane past its budget dies.  In direct mode a
path continues only through specular vertices, takes no Russian roulette
and weighs its NEE samples 1.  A lane inside a glass with absorption
carries the glass's Beer coefficient (`medium_sigma`) and loses
exp(-sigma·t) of its throughput over each segment.  In a scene with a
dispersive glass each lane carries a wavelength (`wavelength`, -1 while
chromatic), which the glass draws when it first transmits the lane
(materials/bsdf.py sample_bsdf) and which then fixes its IOR at every
later dispersive vertex.  In a scene with volume
regions and a volume integrator the first vertex runs it over the camera
segment (volumes/integrate.py): its in-scattered light is added and the
throughput takes the segment's transmittance.

In a scene with textures every vertex applies them to its material row
and bumps its normal (textures/eval.py), the mip LOD read from a ray cone
(`cone_w`, `cone_spread`, started at the camera's pixel cone and widened
at every non-specular scatter).  Blend and mask materials resolve through
materials/blend.py.  Escaped rays see the background (a texture
background's map); with an `ibl` background its light joins NEE
(lights/bglight.py) and the escape is MIS-weighted against it; with a
portal light (and no IBL light) the background reaches non-specular
vertices through the portal's NEE only.  Every light type of the
reference is sampled (`sample_light`); BSDF hits on area and mesh lights
are MIS-weighted with the area pdf, on sphere lights with the cone pdf of
their sampler.

Everything is SoA over the lanes; dead lanes are masked, exactly as in
the reference, so the same QMC stream gives the same image.  The compact
variant (`compact_n`, the adaptive passes of integrators/render.py) takes
its lanes' pixels as a step input, one lane per flagged pixel and sample,
and runs the same wavefront (`run_wavefront`).  The reference's `lax.scan`
over bounces is a Python loop that keeps its split between static and
dynamic dims.  Features outside the ported slices raise
NotImplementedError naming their ROADMAP item.

The intersection, surface-point and NEE functions here are shared with the
photon-mapping and SPPM integrators (`integrators/photonmap.py`,
`integrators/sppm.py`): `closest_hit` and `shadow_transmission` merge
the reference's exact quadric pass (plain torch) into the triangle kernels'
answers, and `_surface_point` decodes sphere hits (tri = -2 - sphere).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..backgrounds.base import eval_background
from ..cameras.base import pixel_cone, project_to_camera, shoot_rays
from ..core import math as vmath
from ..core import qmc
from ..core.color import luminance
from ..core.sampling import INV_PI, power_heuristic, sample_cos_hemisphere
from ..film.imagefilm import (clamp_sample, film_splat, film_splat_compact,
                              splat_plane, splat_plane_compact)
from ..film.passes import FILTER_WEIGHTED_AOVS
from ..lights import base as lightmod
from ..lights.bglight import pdf_bg_dir, sample_bg_light
from ..lights.ies import apply_ies_profile
from ..materials import blend as blendmod
from ..materials import bsdf
from ..materials.base import (MT_COATED_GLOSSY, MT_GLASS, MT_GLOSSY,
                              MT_ROUGH_GLASS, MT_SHINYDIFFUSE, gather_rows)
from ..ops import intersect as isect
from ..ops.photon_flash import density_auto
from ..textures.eval import apply_textures, bump_normal
from ..volumes.integrate import integrate_volume
from .config import RenderConfig

F32 = torch.float32


PORTED_INTEGRATORS = ("directlighting", "pathtracing", "photonmapping",
                      "SPPM", "bidirectional", "DebugIntegrator")


def check_supported(static, cfg: RenderConfig) -> None:
    """Raise for any part of (scene, config) that the port does not render
    with cfg.integrator.  All six of the reference's surface integrators,
    all its light, camera, background and volume types, its render passes
    and its alpha plane are ported."""
    if cfg.integrator not in PORTED_INTEGRATORS:
        raise ValueError(f"unknown integrator {cfg.integrator!r}")


def check_arrays(arrays: dict, device: torch.device, prefix: str = "") -> None:
    """Every scene tensor lies on `device`, and floats are float32."""
    for k, v in arrays.items():
        if isinstance(v, dict):
            check_arrays(v, device, f"{prefix}{k}.")
            continue
        if v.device != device:
            raise ValueError(f"scene array {prefix}{k} is on {v.device}, "
                             f"expected {device}")
        if v.is_floating_point() and v.dtype != F32:
            raise TypeError(f"scene array {prefix}{k} is {v.dtype}, "
                            "expected float32")


def resolve_device(device) -> torch.device:
    """torch.device with the index made explicit ("cuda" -> "cuda:<current>"),
    so tensors' devices compare equal to it.  Raises for "cuda" without a
    card: the entry points default to it and never fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r}: no CUDA device is available "
            "(torch.cuda.is_available() is False); pass device='cpu' to "
            "render on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _tile(x: torch.Tensor, ns: int) -> torch.Tensor:
    """(N, ...) -> (ns·N, ...) block-major: lane s·N + i holds x[i]."""
    if ns == 1:
        return x
    return x[None].expand((ns,) + x.shape).reshape((ns * x.shape[0],)
                                                   + x.shape[1:])


def pixel_of(lane: torch.Tensor, w: int, qmc_seed: int):
    """(px, py) int32 of flat pixel ids and each one's QMC pixel hash."""
    py = torch.div(lane, w, rounding_mode="floor")
    px = lane - py * w
    return px, py, qmc.hash_u32(px ^ (py << 16) ^ qmc.i32(qmc_seed))


def pixel_lanes(h: int, w: int, qmc_seed: int, device):
    """The N = H·W pixel lanes, row-major: (px, py) int32 and each lane's
    QMC pixel hash."""
    return pixel_of(torch.arange(h * w, dtype=torch.int32, device=device), w,
                    qmc_seed)


def camera_rays(camera, px, py, pixel_hash, s_idx):
    """Primary rays of sample s_idx: (dx, dy, org, dirn, weight), (dx, dy)
    the in-pixel offsets from QMC dims 0-1 and the lens pair from dims 2-3.
    (The reference's path, BDPT, photon-mapping and SPPM steps draw the
    lens pair as one sample_dim_pair or as two sample_dim calls, which give
    the same values.  Only depth of field reads the pair: a camera without
    an aperture skips the draw.)"""
    dx, dy = qmc.sample_dim_pair(s_idx, qmc.DIM_PIXEL_X, pixel_hash)
    if camera.aperture > 0.0:
        lu, lv = qmc.sample_dim_pair(s_idx, qmc.DIM_LENS_U, pixel_hash)
    else:
        lu = lv = torch.zeros_like(dx)
    org, dirn, wt = shoot_rays(camera, px.to(F32) + dx, py.to(F32) + dy,
                               lu, lv)
    return dx, dy, org, dirn, wt


def ray_bounds(static, alive: torch.Tensor):
    """(tmin, tmax) of a path vertex's rays; dead lanes get an empty
    interval."""
    tmin = torch.full(alive.shape, static.ray_min_dist, dtype=F32,
                      device=alive.device)
    return tmin, torch.where(alive, float("inf"), -1.0)


def bounce_key(pixel_hash: torch.Tensor, bounce_idx: int) -> torch.Tensor:
    """The QMC scramble key of one path vertex."""
    return qmc.hash_combine(pixel_hash, qmc.word_like(pixel_hash, bounce_idx))


def shading_frame(sp: dict, wo: torch.Tensor):
    """(n, ng) of a surface point, flipped to face wo."""
    backface = (vmath.dot(sp["ng"], wo) < 0.0)[..., None]
    return (torch.where(backface, -sp["n"], sp["n"]),
            torch.where(backface, -sp["ng"], sp["ng"]))


def nee_count(ls, cfg: RenderConfig, full: bool) -> int:
    """NEE samples per lane of one light: its full `samples` count, or one
    (the path engines' vertices past the first)."""
    if full:
        return max(1, int(round(ls.samples * cfg.light_ns_mult)))
    return max(1, int(round(cfg.indirect_ns_mult)))


def uses_textures(static) -> bool:
    """Whether the scene's vertices apply textures or node programs."""
    return bool(static.textures or static.node_programs)


def has_bg_light(static) -> bool:
    return any(ls.ltype == lightmod.LT_BACKGROUND and ls.enabled
               for ls in static.lights)


def has_portal(static) -> bool:
    return any(ls.ltype == lightmod.LT_PORTAL and ls.enabled
               for ls in static.lights)


_LIGHT_SAMPLERS = {
    lightmod.LT_POINT: lightmod.sample_point,
    lightmod.LT_SPOT: lightmod.sample_spot,
    lightmod.LT_DIRECTIONAL: lightmod.sample_directional,
    lightmod.LT_SUN: lightmod.sample_sun,
    lightmod.LT_AREA: lightmod.sample_area,
    lightmod.LT_SPHERE: lightmod.sample_sphere_light,
}


def sample_light(arrays, static, li: int, p, u1, u2) -> dict:
    """One NEE sample of light li per lane (reference _sample_one_light):
    a portal's point, radiance from the background along it times the
    portal's power; a meshlight's point; the IBL light's direction from the
    environment table; an IES light's point-light sample scaled by its
    profile; else the type's sampler of lights/base.py."""
    ls = static.lights[li]
    if ls.ltype == lightmod.LT_BACKGROUND:
        return sample_bg_light(arrays, static.bg, p, u1, u2)
    lrow = lightmod.light_row(arrays["lights"], li)
    if ls.ltype in (lightmod.LT_PORTAL, lightmod.LT_MESH):
        tri_pos = arrays["tri_pos"][ls.tri_start:ls.tri_start + ls.tri_count]
        smp = lightmod.sample_mesh_light(lrow, p, u1, u2,
                                         arrays[f"mlight_cdf_{li}"], tri_pos)
        if ls.ltype == lightmod.LT_PORTAL:
            bg = eval_background(static.bg, arrays.get(
                "bg_image_ibl", arrays.get("bg_image")), smp["wi"])
            smp["li"] = bg * lrow["power"]
        return smp
    if ls.ltype == lightmod.LT_IES:
        smp = lightmod.sample_point(lrow, p, u1, u2)
        fac = apply_ies_profile(arrays[f"ies_{li}"], lrow["direction"],
                                smp["wi"])
        smp["li"] = smp["li"] * fac[..., None]
        return smp
    return _LIGHT_SAMPLERS[ls.ltype](lrow, p, u1, u2)


def shadow_rays(arrays, static, li: int, ns: int, p, n, ng, alive, s_idx,
                skey, bounce_dim, static_dims: bool):
    """Light li's NEE samples and their shadow rays, ns per lane, batched
    block-major over ns·N lanes (lane s·N + i is sample s of lane i).
    bounce_dim is a static int or an (N,) int32 tensor of per-lane dim
    bases; static_dims draws the pair of the reference's static QMC dims
    (a static int bounce_dim only), else its dynamic hash dims.
    Returns (smp, cos_i, org, dist): the light's sample record, the
    cosine at the shading normal, and the segments; dead lanes get a
    negative dist, an empty segment."""
    skey_l = qmc.hash_combine(skey, qmc.word_like(skey, 0xABCD01 + 131 * li))
    if ns > 1:
        s = torch.arange(ns, dtype=torch.int32, device=p.device)
        sub_idx = (s_idx[None, :] * ns + s[:, None]).reshape(-1)
    else:
        sub_idx = s_idx
    skey_v, p_, n_, ng_, alive_ = (_tile(x, ns)
                                   for x in (skey_l, p, n, ng, alive))
    per_lane = isinstance(bounce_dim, torch.Tensor)
    if static_dims:
        if per_lane:
            raise ValueError("shadow_rays: static dims need an int bounce_dim")
        u1, u2 = qmc.sample_dim_pair(sub_idx, bounce_dim + qmc.SLOT_LIGHT_U,
                                     skey_v)
    else:
        dims = _tile(bounce_dim, ns) if per_lane else bounce_dim
        u1 = qmc.dynamic_sample_dim(sub_idx, dims + qmc.SLOT_LIGHT_U, skey_v)
        u2 = qmc.dynamic_sample_dim(sub_idx, dims + qmc.SLOT_LIGHT_V, skey_v)
    smp = sample_light(arrays, static, li, p_, u1, u2)
    cos_i = vmath.dot(n_, smp["wi"])
    org = p_ + ng_ * torch.sign(cos_i)[..., None] * static.shadow_bias
    dist = torch.where(alive_, smp["dist"], -1.0)
    return smp, cos_i, org, dist


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c in float32, rounded once (the product is exact in
    float64)."""
    return (a.double() * b.double() + c.double()).float()


def _sphere_roots(spheres, org, dirn):
    """The rays against the (S, 5) analytic sphere pack [cx cy cz r mat]:
    (disc, t0, t1), each (N, S), the quadric's discriminant and its two
    roots (no hit where disc < 0).  b = oc·d and b² - c are multiply-adds
    rounded once, as the reference's compiled step computes them: near a
    sphere's silhouette b² - c cancels, and one more rounding there moves
    t by up to ~4e-4 of itself."""
    oc = org[:, None, :] - spheres[None, :, 0:3]
    d = dirn[:, None, :]
    r = spheres[:, 3]
    b = _fma(oc[..., 2], d[..., 2],
             _fma(oc[..., 1], d[..., 1], oc[..., 0] * d[..., 0]))
    disc = _fma(b, b, -(vmath.dot(oc, oc) - r[None] * r[None]))
    sq = vmath.sqrt_rn(torch.clamp(disc, min=0.0))
    return disc, -b - sq, -b + sq


def _sphere_hits(spheres, org, dirn, tmin, tmax):
    """Exact quadric intersection against the analytic spheres.  Returns
    (t (N,), sphere index (N,) int32, hit)."""
    disc, t0, t1 = _sphere_roots(spheres, org, dirn)
    t = torch.where(t0 > tmin[:, None], t0, t1)
    ok = (disc >= 0.0) & (t > tmin[:, None]) & (t < tmax[:, None])
    t = torch.where(ok, t, float("inf"))
    idx = torch.argmin(t, dim=1)  # the first sphere on ties
    tb = t.gather(1, idx[:, None])[:, 0]
    return tb, idx.to(torch.int32), torch.isfinite(tb)


def closest_hit(arrays: dict, static, org, dirn, tmin, tmax) -> isect.Hit:
    """Nearest hit over the triangle kernels, merged with the analytic
    spheres' (a sphere hit is encoded as tri = -2 - sphere index)."""
    hit = isect.closest_hit(arrays, static, org, dirn, tmin, tmax)
    if not static.n_spheres:
        return hit
    st, sidx, shit = _sphere_hits(arrays["spheres"], org, dirn, tmin, tmax)
    better = shit & (st < hit.t)
    return isect.Hit(t=torch.where(better, st, hit.t),
                     tri=torch.where(better, -2 - sidx, hit.tri),
                     u=torch.where(better, 0.0, hit.u),
                     v=torch.where(better, 0.0, hit.v),
                     hit=hit.hit | better)


def shadow_transmission(arrays: dict, static, transp_shad: bool, org, dirn,
                        dist) -> torch.Tensor:
    """(N,3) transmission over the triangle kernels times the spheres':
    a shadow ray through a sphere crosses two interfaces, so each quadric
    root inside (SHADOW_EPS, dist·(1-1e-4) - SHADOW_EPS) applies the
    sphere's filter once."""
    tr = isect.shadow_transmission(arrays, static, transp_shad, org, dirn,
                                   dist)
    if not static.n_spheres:
        return tr
    sp = arrays["spheres"]
    sfil = arrays["sphere_filt" if transp_shad else "sphere_filt_binary"]
    disc, t0, t1 = _sphere_roots(sp, org, dirn)
    tmax = (dist * (1.0 - 1e-4) - isect.SHADOW_EPS)[:, None]
    opacity = 1.0 - sfil[None]  # (1,S,3)
    factor = torch.ones_like(opacity)
    for root in (t0, t1):
        hit = ((disc >= 0.0) & (root > isect.SHADOW_EPS)
               & (root < tmax)).to(F32)
        factor = factor * (1.0 - hit[..., None] * opacity)
    tr_sph = factor[:, 0]
    for s in range(1, sp.shape[0]):
        tr_sph = tr_sph * factor[:, s]
    return tr * tr_sph


def _surface_point(arrays: dict, hit: isect.Hit, org=None, dirn=None,
                   fp=None, tex: bool = False) -> dict:
    """Hit -> shading record from one packed gather of tri_shade_pack
    (pos 0:9, normal 9:18, uv 18:24, geo_n 24:27, mat 27, light_id 28,
    uv_density 29, dPdU 30:33, dPdV 33:36).  In a scene with spheres,
    sphere hits (tri < -1) take the exact point org + t·dirn and its radial
    normal.  tex=True adds what textures read: uv, uv_density, dpdu, dpdv
    (a sphere's lat-long uv and its analytic derivatives), view, t, tri,
    fp (the ray-cone footprint, or None), and orco / local where the scene
    carries tri_orco_pack."""
    pack = arrays["tri_shade_pack"]
    tri = torch.clamp(hit.tri, 0, pack.shape[0] - 1)
    b1, b2 = hit.u, hit.v
    b0 = 1.0 - b1 - b2

    def lerp(c0, c1, c2):
        return (b0[..., None] * c0 + b1[..., None] * c1
                + b2[..., None] * c2)

    pk = pack[tri.long()]  # (N, 36)
    p = lerp(pk[:, 0:3], pk[:, 3:6], pk[:, 6:9])
    n = vmath.normalize(lerp(pk[:, 9:12], pk[:, 12:15], pk[:, 15:18]))
    ng = pk[:, 24:27]
    mat = pk[:, 27].to(torch.int32)
    light_id = pk[:, 28].to(torch.int32)
    out = {}
    if tex:
        out = dict(uv=lerp(pk[:, 18:20], pk[:, 20:22], pk[:, 22:24]),
                   uv_density=pk[:, 29], dpdu=pk[:, 30:33],
                   dpdv=pk[:, 33:36], view=dirn, t=hit.t, tri=tri, fp=fp)
        if "tri_orco_pack" in arrays:
            ok = arrays["tri_orco_pack"][tri.long()]  # (N, 18)
            out["orco"] = lerp(ok[:, 0:3], ok[:, 3:6], ok[:, 6:9])
            out["local"] = lerp(ok[:, 9:12], ok[:, 12:15], ok[:, 15:18])
    if "spheres" in arrays:
        is_sph = hit.tri < -1
        sph = arrays["spheres"]
        srow = sph[torch.clamp(-2 - hit.tri, 0, sph.shape[0] - 1).long()]
        p_s = org + hit.t[..., None] * dirn
        n_s = vmath.normalize(p_s - srow[:, 0:3])
        m3 = is_sph[..., None]
        p = torch.where(m3, p_s, p)
        n = torch.where(m3, n_s, n)
        ng = torch.where(m3, n_s, ng)
        mat = torch.where(is_sph, srow[:, 4].to(torch.int32), mat)
        light_id = torch.where(is_sph, -1, light_id)
        if tex:
            nx, ny, nz = n_s[..., 0:1], n_s[..., 1:2], n_s[..., 2:3]
            # lat-long uv: u = 0.5 + atan2(ny, nx)/2pi, v = 0.5 - asin(nz)/pi
            uv_s = torch.stack([
                0.5 + vmath.div(torch.atan2(n_s[..., 1], n_s[..., 0]),
                                2.0 * np.pi),
                0.5 - vmath.div(torch.asin(torch.clamp(n_s[..., 2], -1.0,
                                                       1.0)), np.pi)], dim=-1)
            r_s = srow[:, 3:4]
            cos_lat = vmath.sqrt_rn(torch.clamp(1.0 - nz * nz, min=1e-12))
            dpdu_s = 2.0 * np.pi * r_s * torch.cat(
                [-ny, nx, torch.zeros_like(nx)], dim=-1)
            dpdv_s = np.pi * r_s * torch.cat(
                [nx * nz / cos_lat, ny * nz / cos_lat, -cos_lat], dim=-1)
            out["uv"] = torch.where(m3, uv_s, out["uv"])
            out["uv_density"] = torch.where(
                is_sph, 1.0 / torch.clamp(np.pi * srow[:, 3], min=1e-6),
                out["uv_density"])
            out["dpdu"] = torch.where(m3, dpdu_s, out["dpdu"])
            out["dpdv"] = torch.where(m3, dpdv_s, out["dpdv"])
            if "orco" in out:
                out["orco"] = torch.where(m3, n_s, out["orco"])
                out["local"] = torch.where(m3, p_s - srow[:, 0:3],
                                           out["local"])
    return dict(out, p=p, n=n, ng=ng, mat=mat, light_id=light_id)


def _make_mat_resolve(arrays, static, sp: dict):
    """The callback with which materials/blend.py re-applies textures to a
    composite's gathered child rows, or None when no composite child is
    textured.  Child rows over ns·N NEE lanes see sp tiled block-major."""
    if not (static.has_blend and static.blend_child_textured
            and uses_textures(static)):
        return None
    base = sp["p"].shape[0]

    def resolve(r):
        k = r["mtype"].shape[0] // base
        spr = sp if k == 1 else {
            kk: (_tile(v, k) if isinstance(v, torch.Tensor)
                 and v.shape[:1] == (base,) else v)
            for kk, v in sp.items()}
        return apply_textures(arrays, static, r, spr)

    return resolve


def _direct_lighting(arrays, static, cfg, p, n, ng, row, wo, s_idx, skey,
                     bounce_dim, full_count: bool, static_dims: bool, alive,
                     mis_with_bsdf=True, resolve=None, shadow_pass=False):
    """NEE with two-strategy MIS over the enabled lights (reference
    estimateAllDirectLight).  full_count gives every light its full
    `samples` count (else one sample), all ns samples batched block-major
    over ns·N lanes (`shadow_rays`); bounce_dim and static_dims as there.
    The reference ties neither choice to the other: its path step takes
    both at the first vertex, its SPPM eye pass the full count and static
    dims at every vertex, its photon step the full count over per-lane
    dynamic dims.  mis_with_bsdf=False weighs the light samples 1 (for
    callers that never take the BSDF-sampled counterpart).  Blend and
    mask rows evaluate through materials/blend.py, `resolve` as there.
    Returns (L (N,3), shadow rays per live lane), and with shadow_pass
    the "shadow" pass's value: each light's mean luminance of its samples'
    transmission, averaged over the lights sampled."""
    L = torch.zeros_like(p)
    nrays = 0
    sh_sum, sh_cnt = 0.0, 0
    families = static.mat_families
    for li, ls in enumerate(static.lights):
        if not ls.enabled or ls.photon_only:
            continue
        ns = nee_count(ls, cfg, full_count)
        n0 = p.shape[0]
        smp, cos_i, org_s, d_ = shadow_rays(
            arrays, static, li, ns, p, n, ng, alive, s_idx, skey, bounce_dim,
            static_dims)
        n_, ng_, wo_ = (_tile(x, ns) for x in (n, ng, wo))
        row_ = {k: _tile(row[k], ns) for k in bsdf.eval_keys(families)}
        f = blendmod.eval_bsdf(arrays["materials"], row_, n_, ng_, wo_,
                               smp["wi"], static.has_blend, families,
                               resolve)
        contrib_w = cos_i.abs() / torch.clamp(smp["pdf"], min=1e-9)
        ok = smp["valid"] & (smp["pdf"] > 1e-9)
        if ls.cast_shadows:
            tr = shadow_transmission(arrays, static, cfg.transp_shad, org_s,
                                     smp["wi"], d_)
        else:
            tr = torch.ones_like(f)
        term = f * smp["li"] * tr * contrib_w[..., None]
        if mis_with_bsdf and (not ls.is_delta) and ls.intersectable:
            bpdf = blendmod.pdf_bsdf(arrays["materials"], row_, n_, ng_,
                                     wo_, smp["wi"], static.has_blend,
                                     families, resolve)
            term = term * power_heuristic(smp["pdf"], bpdf)[..., None]
        term = torch.where(ok[..., None], term, 0.0)
        accum = term[:n0]
        for k in range(1, ns):
            accum = accum + term[k * n0:(k + 1) * n0]
        if ls.cast_shadows:
            nrays += ns
        L = L + vmath.div(accum, ns)
        if shadow_pass:
            lum = luminance(tr)
            acc = lum[:n0]
            for k in range(1, ns):
                acc = acc + lum[k * n0:(k + 1) * n0]
            sh_sum = sh_sum + vmath.div(acc, ns)
            sh_cnt += 1
    if shadow_pass:
        if not sh_cnt:  # no light sampled
            sh_sum = torch.zeros_like(p[:, 0])
        return L, nrays, vmath.div(sh_sum, max(sh_cnt, 1))
    return L, nrays


def _ambient_occlusion(arrays, static, cfg, p, n_f, diffuse_color, s_idx,
                       skey, alive):
    """Ambient occlusion at a vertex (reference _ambient_occlusion,
    sampleAmbientOcclusion): ao_samples cosine rays about n_f up to
    ao_distance in one batched shadow pass over ao_samples·N lanes (sample
    k keyed by skey ⊕ 0xA0A0 + k at the first bounce dims), their mean
    transmission times the diffuse color and ao_color.  Dead lanes trace
    an empty segment."""
    ns = cfg.ao_samples
    n0 = p.shape[0]
    k = torch.arange(ns, dtype=torch.int32, device=p.device)
    salt = (k + 0xA0A0).repeat_interleave(n0)
    skey_a = qmc.hash_combine(_tile(skey, ns), salt)
    u1, u2 = qmc.sample_dim_pair(_tile(s_idx, ns), qmc.BOUNCE_DIMS_START,
                                 skey_a)
    nf_t = _tile(n_f, ns)
    d, _ = sample_cos_hemisphere(nf_t, u1, u2)
    org = _tile(p, ns) + nf_t * static.shadow_bias
    dist = torch.where(_tile(alive, ns), float(cfg.ao_distance), -1.0)
    tr = shadow_transmission(arrays, static, cfg.transp_shad, org, d, dist)
    ao = tr[:n0]
    for j in range(1, ns):
        ao = ao + tr[j * n0:(j + 1) * n0]
    ao_col = torch.tensor(cfg.ao_color, dtype=F32, device=p.device)
    return vmath.div(ao * diffuse_color * ao_col, ns)


# the aux sources that read the surface point's texture fields (uv, the
# clamped triangle id, dPdU, dPdV)
SP_AUX = frozenset({"uv", "obj_index", "nu", "nv", "dpdu", "dpdv"})


def first_hit_aux(want: frozenset, hit, sp: dict, row: dict, n_sh, ng_sh,
                  alive, emit, Ld, shadow, ao) -> dict:
    """The first vertex's values of the aux sources in `want` (the
    reference's primary-hit attributes), each (N,) or (N, C): on hit lanes
    z (the hit distance), normal and geo_normal (the shading frame's),
    uv, mat_index, obj_index (the hit triangle, 0 on a sphere),
    diffuse_color, samp_factor (the material's samplingFactor, 1 on a
    miss), nu and nv (the frame orthonormalized from dPdU, build_onb's u
    where dPdU lies along the normal), dpdu and dpdv (normalized); on the
    lanes that go on past the vertex (the reference's mask) emit, direct,
    ao and shadow (1 elsewhere).  shadow: (the NEE's shadow value,) or
    ()."""
    hm = hit.hit
    h3 = hm[..., None]
    out = {}
    if "z" in want:
        out["z"] = torch.where(hm, hit.t, 0.0)
    if "normal" in want:
        out["normal"] = torch.where(h3, n_sh, 0.0)
    if "geo_normal" in want:
        out["geo_normal"] = torch.where(h3, ng_sh, 0.0)
    if "uv" in want:
        out["uv"] = torch.where(h3, sp["uv"], 0.0)
    hf = hm.to(F32)
    if "mat_index" in want:
        out["mat_index"] = sp["mat"].to(F32) * hf
    if "obj_index" in want:
        out["obj_index"] = sp["tri"].to(F32) * hf
    if "diffuse_color" in want:
        out["diffuse_color"] = torch.where(h3, row["diffuse_color"], 0.0)
    if "samp_factor" in want:
        out["samp_factor"] = torch.where(hm, row["sampling_factor"], 1.0)
    a3 = alive[..., None]
    if "emit" in want:
        out["emit"] = torch.where(a3, emit, 0.0)
    if "direct" in want:
        out["direct"] = torch.where(a3, Ld, 0.0)
    if "shadow" in want:
        out["shadow"] = torch.where(alive, shadow[0], 1.0)
    if "ao" in want:
        out["ao"] = torch.where(a3, ao, 0.0)
    if "nu" in want or "nv" in want:
        du = sp["dpdu"] - n_sh * vmath.dot(n_sh, sp["dpdu"])[..., None]
        du_len = vmath.length(du)[..., None]
        onb_u, _ = vmath.build_onb(n_sh)
        tu = torch.where(du_len > 1e-9, du / torch.clamp(du_len, min=1e-9),
                         onb_u)
        out["nu"] = torch.where(h3, tu, 0.0)
        out["nv"] = torch.where(h3, vmath.cross(n_sh, tu), 0.0)
    for key in ("dpdu", "dpdv"):
        if key in want:
            out[key] = torch.where(h3, vmath.normalize(sp[key]), 0.0)
    return out


def _channels(x: torch.Tensor) -> torch.Tensor:
    """(N,) -> (N, 1); (N, C) as it is."""
    return x[:, None] if x.dim() == 1 else x


def stack_planes(film: dict, keys: list) -> torch.Tensor:
    """The film planes of keys, (H, W, C_k) each, stacked on the channel
    axis (one plane as it is)."""
    if len(keys) == 1:
        return film[keys[0]]
    return torch.cat([film[k] for k in keys], dim=-1)


def unstack_planes(keys: list, film: dict, stacked: torch.Tensor) -> dict:
    """stack_planes' inverse: key -> its channels of stacked (views)."""
    if len(keys) == 1:
        return {keys[0]: stacked}
    out, c = {}, 0
    for k in keys:
        ck = film[k].shape[-1]
        out[k] = stacked[..., c:c + ck]
        c += ck
    return out


def is_diffuse_family(mtype: torch.Tensor) -> torch.Tensor:
    """Materials with a diffuse lobe (shinydiffuse, glossy, coated
    glossy): where photons are stored and gathered."""
    return ((mtype == MT_SHINYDIFFUSE) | (mtype == MT_GLOSSY)
            | (mtype == MT_COATED_GLOSSY))


def make_sample_step(static, camera, cfg: RenderConfig, device,
                     caustic=None, compact_n: int = 0):
    """Builds the step of spp_batch samples per pixel on `device`:
    sample_step(arrays, film, flags) -> film, with `arrays` the scene
    tensors on `device` (convert.to_tensors) and flags (H, W) bool.
    pathtracing takes path mode, directlighting direct mode.  caustic:
    (radius, photons emitted) of a caustic photon map whose pack rides in
    arrays["pm_caustic"] (photonmap.build_caustic_map): the first vertex
    then adds its density on the diffuse families (reference caustic_type
    photon / both).

    compact_n > 0 builds the compact variant of an adaptive pass instead:
    sample_step(arrays, film, pix) with pix a (compact_n,) int32 tensor of
    flat pixel ids, -1 for a dead lane.  Each lane's pixel hash and sample
    index come from its pixel id and the film's nsamples, so a compact pass
    draws the samples the dense masked pass would, over compact_n·spb lanes
    instead of H·W·spb.  The step's `lanes` is its lane count."""
    check_supported(static, cfg)
    if cfg.integrator not in ("pathtracing", "directlighting"):
        raise ValueError(f"make_sample_step renders pathtracing and "
                         f"directlighting, not {cfg.integrator!r} "
                         "(scene.session.render_scene dispatches on the "
                         "integrator)")
    path_mode = cfg.integrator == "pathtracing"
    base_bounces = cfg.bounces if path_mode else cfg.raydepth
    # per-material additionalDepth: the loop runs the table's largest extra
    # vertices more, each lane gated on its own budget (no depth lanes in a
    # scene without it)
    extra_depth = int(static.max_additional_depth)
    n_bounces = base_bounces + extra_depth
    # absorption lives on glass rows only: without glass no lane ever
    # enters a medium
    media = bool({MT_GLASS, MT_ROUGH_GLASS} & set(static.mat_families))
    # a dispersive glass: each lane carries a wavelength (-1 chromatic),
    # drawn where the glass first transmits it
    dispersion = static.dispersion
    volumes = bool(static.volumes) and cfg.vol_integrator not in ("none", "")
    dev = resolve_device(device)
    h, w = cfg.height, cfg.width
    spb = max(1, cfg.spp_batch)
    n_pix = compact_n or h * w
    n = n_pix * spb  # lane k·n_pix + i: sample k of lane i's pixel
    lane_k = (torch.div(torch.arange(n, dtype=torch.int32, device=dev), n_pix,
                        rounding_mode="floor") if spb > 1 else None)
    if not compact_n:
        px, py, pixel_hash = (_tile(x, spb) for x in pixel_lanes(
            h, w, cfg.qmc_seed, dev))
    nee_on_table = torch.tensor(
        [1.0 if (ls.enabled and not ls.photon_only) else 0.0
         for ls in static.lights] or [0.0], dtype=F32, device=dev)
    tex = uses_textures(static)
    if tex:
        cone0_s, cone0_w = pixel_cone(camera)
    bg_light = has_bg_light(static)
    portal = has_portal(static)
    sphere_lights = any(ls.ltype == lightmod.LT_SPHERE
                        for ls in static.lights)
    families, depth = static.mat_families, static.has_blend

    def shade_vertex(arrays, st, bounce_idx: int, s_idx, ph, first: bool,
                     want: frozenset):
        """One path vertex: intersect, attenuate by the medium, add
        background (MIS against the IBL light) and emission (MIS), apply
        textures, NEE, AO and caustics at the first vertex, sample the
        continuation.  ph: the lanes' QMC pixel hashes; want: the aux
        sources the film's planes ask of the first vertex (`first_hit_aux`;
        "ao" and "shadow" also ask their extra work).  Where the state
        carries them, the vertex also keeps the alpha chain (track, transp)
        and the reflect / refract planes (L_refl, L_refr by the bounce-0
        tag)."""
        bounce_dim = qmc.bounce_dim(bounce_idx, 0)
        throughput, alive = st["throughput"], st["alive"]
        spec_mask, prev_pdf = st["spec_mask"], st["prev_pdf"]
        L, nrays = st["L"], st["nrays"]
        org, dirn = st["org"], st["dirn"]
        mats = arrays["materials"]
        out = {}
        # past the first vertex a contribution also lands in the plane of
        # its lane's bounce-0 tag (1 reflect, 2 refract); at the first every
        # tag is 0
        tagged = [] if first else [
            (key, (st["tag"] == t)[..., None])
            for key, t in (("L_refl", 1), ("L_refr", 2)) if key in st]

        def add(L, x, mask):
            x = torch.where(mask[..., None], x, 0.0)
            for key, on in tagged:
                out[key] = out.get(key, st[key]) + torch.where(on, x, 0.0)
            return L + x

        hit = closest_hit(arrays, static, org, dirn,
                          *ray_bounds(static, alive))
        if media:
            # Beer's law over the segment (a miss travels 0), before the
            # background and emission terms
            seg = torch.where(hit.hit, hit.t, 0.0)
            throughput = throughput * torch.exp(-st["medium_sigma"]
                                                * seg[..., None])
        if first and volumes:
            # the volume integrator on the camera segment (escapes march to
            # 1e8): L += T·L_vol over it, and the surface behind sees T
            l_vol, t_vol = integrate_volume(
                static.volumes, cfg.vol_integrator, arrays, static, cfg,
                partial(shadow_transmission, arrays, static,
                        cfg.transp_shad),
                org, dirn, torch.where(hit.hit, hit.t, 1e8), s_idx, ph)
            L = L + torch.where(alive[..., None], throughput * l_vol, 0.0)
            throughput = throughput * t_vol[..., None]

        # escaped rays: the background, MIS-weighted against the IBL
        # light's NEE where it has one; with a portal instead, only
        # specular chains see it (the portal's NEE is the background's
        # sole strategy at non-specular vertices)
        escape = alive & ~hit.hit
        bg = eval_background(static.bg, arrays.get("bg_image"), dirn)
        if bg_light:
            w_bg = torch.where(spec_mask, 1.0, power_heuristic(
                prev_pdf, pdf_bg_dir(arrays, static.bg, dirn)))
            bg = bg * w_bg[..., None]
        elif portal:
            bg = bg * torch.where(spec_mask, 1.0, 0.0)[..., None]
        L = add(L, throughput * bg, escape)
        if "transp" in st:
            # alpha: a lane whose camera-visibility chain reaches the
            # background ends transparent
            out["transp"] = st["transp"] | (escape & st["track"])
        alive = alive & hit.hit

        fp = None
        if tex:  # the ray cone's footprint at the hit (mip LOD)
            fp = st["cone_w"] + st["cone_spread"] * torch.where(
                hit.hit, hit.t, 0.0)
        sp = _surface_point(arrays, hit, org, dirn, fp=fp,
                            tex=tex or (first and bool(want & SP_AUX)))
        wo = -dirn
        row = gather_rows(mats, sp["mat"].long())
        if extra_depth:
            # a material with additionalDepth raises the lane's budget to
            # base + its extra vertices
            out["depth_limit"] = torch.where(alive, torch.maximum(
                st["depth_limit"], base_bounces + row["additional_depth"]),
                st["depth_limit"])
        if tex:
            if static.need_window:  # texco "window": the hit's raster uv
                pxw, pyw, _, _, _ = project_to_camera(camera, sp["p"])
                sp["win"] = torch.stack([vmath.div(pxw, w),
                                         vmath.div(pyw, h)], dim=-1)
            row = apply_textures(arrays, static, row, sp)
            sp["n"] = bump_normal(arrays, static, row, sp)
        resolve = _make_mat_resolve(arrays, static, sp)

        # ---- emission with MIS against NEE ----
        emit = blendmod.emission(mats, row, sp["ng"], wo, depth, resolve)
        li_id = sp["light_id"]
        is_light_tri = li_id >= 0
        if static.lights:
            lpk = arrays["lights"]["hit_pack"][torch.clamp(li_id, min=0)
                                               .long()]
            area_l = lpk[:, 0]
            dbl = lpk[:, 1] > 0.5
            front = (vmath.dot(sp["ng"], wo) > 0.0) | dbl
            emit = emit + torch.where((is_light_tri & front)[..., None],
                                      lpk[:, 2:5], 0.0)
        else:
            area_l = torch.ones((n,), dtype=F32, device=dev)
        cos_l = vmath.dot(sp["ng"], wo).abs()
        pdf_light_hit = (hit.t * hit.t) / torch.clamp(
            area_l * torch.clamp(cos_l, min=1e-6), min=1e-9)
        if sphere_lights:
            # a sphere light's NEE samples the cone of its visible cap:
            # the MIS counterpart of a BSDF hit is that cone's pdf from
            # the ray origin, not the area form
            is_sphere_l = is_light_tri & (lpk[:, 5].to(torch.int32)
                                          == lightmod.LT_SPHERE)
            dvec = lpk[:, 6:9] - org
            d_c2 = torch.clamp(vmath.dot(dvec, dvec), min=1e-12)
            sl_r = lpk[:, 9]
            sin2 = torch.clamp(sl_r * sl_r / d_c2, 0.0, 1.0)
            cos_max = vmath.sqrt_rn(torch.clamp(1.0 - sin2, min=0.0))
            den = torch.clamp(2.0 * np.pi * (1.0 - cos_max), min=1e-9)
            pdf_light_hit = torch.where(is_sphere_l,
                                        torch.ones_like(den) / den,
                                        pdf_light_hit)
        # MIS only against lights that the NEE step actually samples
        nee_on = nee_on_table[torch.clamp(li_id, min=0).long()] > 0.5
        mis_w = torch.where(is_light_tri & ~spec_mask & nee_on,
                            power_heuristic(prev_pdf, pdf_light_hit), 1.0)
        L = add(L, throughput * emit * mis_w[..., None], alive)

        # ---- shading frame ----
        n_sh, ng_sh = shading_frame(sp, wo)
        skey_b = bounce_key(ph, bounce_idx)

        # ---- NEE (single-strategy in direct mode) ----
        nee = _direct_lighting(
            arrays, static, cfg, sp["p"], n_sh, ng_sh, row, wo, s_idx,
            skey_b, bounce_dim, first, first, alive, mis_with_bsdf=path_mode,
            resolve=resolve, shadow_pass=first and "shadow" in want)
        Ld, sh_rays = nee[:2]
        if not first:  # AA_clamp_indirect, on the NEE term past the first
            Ld = clamp_sample(Ld, cfg.aa_clamp_indirect)
        L = add(L, throughput * Ld, alive)
        nrays = nrays + sh_rays * alive.to(F32).sum()

        ao = None
        if first and ((cfg.do_ao and not path_mode) or "ao" in want):
            # direct mode's AO term, and the AO pass under either mode
            ao = _ambient_occlusion(arrays, static, cfg, sp["p"], ng_sh,
                                    row["diffuse_color"], s_idx, skey_b,
                                    alive)
        if first and cfg.do_ao and not path_mode:
            L = L + torch.where(alive[..., None], throughput * ao, 0.0)

        if first and caustic is not None:
            c_radius, c_nem = caustic
            cflux, _ = density_auto(arrays["pm_caustic"], sp["p"], n_sh,
                                    c_radius)
            lc = vmath.div(vmath.div(cflux, np.pi * c_radius * c_radius),
                           c_nem)
            f_c = (row["diffuse_reflect"][..., None] * row["diffuse_color"]
                   * INV_PI)
            L = add(L, throughput * f_c * lc,
                    alive & is_diffuse_family(row["mtype"]))

        # ---- continuation ----
        if first:
            u1, u2 = qmc.sample_dim_pair(s_idx, bounce_dim + qmc.SLOT_BSDF_U,
                                         skey_b)
            ul, u_rr = qmc.sample_dim_pair(
                s_idx, bounce_dim + qmc.SLOT_LIGHT_PICK, skey_b)
        else:
            u1, u2, ul, u_rr = (
                qmc.dynamic_sample_dim(s_idx, bounce_dim + slot, skey_b)
                for slot in (qmc.SLOT_BSDF_U, qmc.SLOT_BSDF_V,
                             qmc.SLOT_LIGHT_PICK, qmc.SLOT_RR))
        smp = blendmod.sample_bsdf(mats, row, n_sh, ng_sh, wo, u1, u2, ul,
                                   depth, families, resolve,
                                   st.get("wavelength"))
        if dispersion:
            out["wavelength"] = smp["new_wavelength"]
        alive = alive & smp["valid"]
        if not path_mode:  # direct mode follows specular vertices only
            alive = alive & smp["specular"]
        throughput = throughput * smp["tp"]

        # Russian roulette, path mode (reference: survival = max component)
        if path_mode and bounce_idx >= cfg.rr_min_bounces:
            q = torch.clamp(throughput.amax(dim=-1), 0.05, 1.0)
            alive = alive & ~(u_rr > q)
            throughput = throughput / q[..., None]
        if first and "tag" in st:
            # the reflect / refract planes route a path by the kind of its
            # bounce-0 specular continuation
            spec = alive & smp["specular"]
            out["tag"] = torch.where(spec & ~smp["transmit"], 1, torch.where(
                spec & smp["transmit"], 2, 0))

        if media:
            # entering a glass takes its coefficient, leaving one clears it
            leave = smp["transmit"] & ~smp["entering"]
            out["medium_sigma"] = torch.where(
                smp["entering"][..., None], row["absorption_sigma"],
                torch.where(leave[..., None], 0.0, st["medium_sigma"]))
        off = torch.where(smp["transmit"], -1.0, 1.0)[..., None]
        org = sp["p"] + ng_sh * off * static.shadow_bias
        # null pass-through keeps the MIS state of the last real vertex
        pt = smp["passthrough"]
        if "track" in st:
            # the alpha chain survives null pass-through and straight-
            # through transparency (wi == -wo); refracted specular chains
            # only under bg_transp_refract
            through = smp["specular"] & smp["transmit"]
            straight = pt | (through & (vmath.dot(smp["wi"], -wo)
                                        > 0.999999))
            if cfg.bg_transp_refract:
                straight = straight | through
            out["track"] = st["track"] & straight
        spec_mask = torch.where(pt, spec_mask, smp["specular"])
        prev_pdf = torch.where(pt, prev_pdf, smp["pdf"])
        if tex:
            # the cone widens at non-specular scatters by the lobe's spread
            # (~2/sqrt(e+2) for a Blinn-e lobe, at most 0.6)
            out["cone_w"] = fp
            spread = torch.clamp(2.0 * torch.rsqrt(row["exponent"] + 2.0),
                                 max=0.6)
            out["cone_spread"] = st["cone_spread"] + torch.where(
                smp["specular"] | pt, 0.0, spread)
        if extra_depth:  # the next vertex must fit the lane's budget
            alive = alive & (bounce_idx + 1.0 <= out["depth_limit"])
        nrays = nrays + alive.to(F32).sum()
        if first and want:
            out["aux"] = first_hit_aux(want, hit, sp, row, n_sh, ng_sh,
                                       alive, emit, Ld, nee[2:], ao)
        return dict(st, **out, org=org, dirn=smp["wi"],
                    throughput=throughput, alive=alive, spec_mask=spec_mask,
                    prev_pdf=prev_pdf, L=L, nrays=nrays)

    def run_wavefront(arrays, s_idx, ph, org, dirn, wt, active,
                      want: frozenset, alpha: bool) -> dict:
        """The first vertex and the bounce loop, shared by the dense and
        compact steps: the final lane state (L, nrays; with want, the
        first vertex's aux; the planes want and alpha ask: L_refl, L_refr,
        transp)."""
        alive = active & (wt > 0.0)
        st = dict(
            org=org, dirn=dirn,
            throughput=torch.ones((n, 3), dtype=F32, device=dev),
            alive=alive,
            # the primary ray counts emission fully
            spec_mask=torch.ones((n,), dtype=torch.bool, device=dev),
            prev_pdf=torch.zeros((n,), dtype=F32, device=dev),
            L=torch.zeros((n, 3), dtype=F32, device=dev),
            nrays=alive.to(F32).sum(),
        )
        if media:
            st["medium_sigma"] = torch.zeros((n, 3), dtype=F32, device=dev)
        if dispersion:
            st["wavelength"] = torch.full((n,), -1.0, dtype=F32, device=dev)
        if tex:
            st["cone_w"] = torch.full((n,), cone0_w, dtype=F32, device=dev)
            st["cone_spread"] = torch.full((n,), cone0_s, dtype=F32,
                                           device=dev)
        if extra_depth:
            st["depth_limit"] = torch.full((n,), float(base_bounces),
                                           dtype=F32, device=dev)
        for key, src in (("L_refl", "reflect"), ("L_refr", "refract")):
            if src in want:
                st[key] = torch.zeros((n, 3), dtype=F32, device=dev)
                st["tag"] = torch.zeros((n,), dtype=torch.int64, device=dev)
        if alpha:
            st["track"] = torch.ones((n,), dtype=torch.bool, device=dev)
            st["transp"] = torch.zeros((n,), dtype=torch.bool, device=dev)
        st = shade_vertex(arrays, st, 0, s_idx, ph, True, want)
        for b in range(1, n_bounces + 1):
            st = shade_vertex(arrays, st, b, s_idx, ph, False, want)
        return st

    def splat(acc, val, dx, dy, act, pix):
        """The step's spb samples a pixel splatted in order into acc: the
        film planes (wsum, w, nsamples) when acc is a dict, else one plane.
        pix: the compact lanes' pixel ids, None on the dense step."""
        film_planes = isinstance(acc, dict)
        kw = dict(clamp_samples=cfg.aa_clamp_samples) if film_planes else {}
        if pix is None:
            shape = (spb, h, w)
            fn = film_splat if film_planes else splat_plane
            return fn(acc, val.reshape(shape + (-1,)), dx.reshape(shape),
                      dy.reshape(shape), act.reshape(shape), cfg.filter_type,
                      cfg.aa_pixelwidth, **kw)
        shape = (spb, n_pix)
        fn = film_splat_compact if film_planes else splat_plane_compact
        return fn(acc, val.reshape(shape + (-1,)), pix[:n_pix],
                  dx.reshape(shape), dy.reshape(shape), act.reshape(shape),
                  cfg.filter_type, cfg.aa_pixelwidth, **kw)

    def add_planes(film, st, wt, dx, dy, act, pix) -> dict:
        """The alpha and AOV planes with the step's samples added: the
        filter-weighted ones (alpha, direct, emit, reflect, refract) in one
        splat of their channels stacked, the others as plain per-sample
        sums (the spb samples a pixel summed first) in one add."""
        vals = dict(st.get("aux", {}))
        for key, src in (("L_refl", "reflect"), ("L_refr", "refract")):
            if key in st:
                vals[src] = st[key] * wt[..., None]
        if "transp" in st:  # a lane off the camera counts transparent
            vals["alpha"] = torch.where(st["transp"] | (wt <= 0.0), 0.0,
                                        1.0)
        weighted = [k for k in film if k == "alpha" or (
            k.startswith("aov_") and k[4:] in FILTER_WEIGHTED_AOVS)]
        plain = [k for k in film if k.startswith("aov_")
                 and k not in weighted]
        out = {}
        if weighted:
            base = stack_planes(film, weighted)
            val = torch.cat([_channels(vals[k.removeprefix("aov_")])
                             for k in weighted], dim=-1)
            out.update(unstack_planes(weighted, film, base + splat(
                torch.zeros_like(base), val, dx, dy, act, pix)))
        if plain:
            base = stack_planes(film, plain)
            val = [_channels(vals[k[4:]]) for k in plain]
            val = (val[0] if len(val) == 1 else torch.cat(val, dim=-1)) \
                * act[:, None]
            c = base.shape[-1]
            out.update(unstack_planes(plain, film, (
                base + val.reshape(spb, h, w, c).sum(dim=0) if pix is None
                else base.reshape(-1, c).index_add(
                    0, torch.clamp(pix, min=0).long(), val).reshape(
                        base.shape))))
        return out

    def advance(arrays, film, lpx, lpy, ph, base_idx, active, pix) -> dict:
        """Trace the lanes (pixels (lpx, lpy), hashes ph, first sample
        index base_idx, resample flags active) and accumulate them."""
        check_arrays(arrays, dev)
        s_idx = base_idx if lane_k is None else base_idx + lane_k
        dx, dy, org, dirn, wt = camera_rays(camera, lpx, lpy, ph, s_idx)
        # the film's planes ask for the work they read, nothing more
        want = frozenset(k[4:] for k in film if k.startswith("aov_"))
        st = run_wavefront(arrays, s_idx, ph, org, dirn, wt, active, want,
                           "alpha" in film)
        L = st["L"] * wt[..., None]
        act = active.to(F32)
        # two-level accumulation: splat into a fresh fragment, then add it
        # once (splatting straight into the long-run sums stagnates in f32)
        frag = splat(dict(wsum=torch.zeros_like(film["wsum"]),
                          w=torch.zeros_like(film["w"]),
                          nsamples=torch.zeros_like(film["nsamples"])),
                     L, dx, dy, act, pix)
        out = dict(film,
                   wsum=film["wsum"] + frag["wsum"],
                   w=film["w"] + frag["w"],
                   nsamples=film["nsamples"] + frag["nsamples"],
                   rays=film["rays"] + st["nrays"])
        if "m2" in film:  # the variance estimator's second moments
            L2 = clamp_sample(L, cfg.aa_clamp_samples)
            out["m2"] = film["m2"] + splat(torch.zeros_like(film["m2"]),
                                           L2 * L2, dx, dy, act, pix)
        if want or "alpha" in film:
            out.update(add_planes(film, st, wt, dx, dy, act, pix))
        return out

    if compact_n:
        def sample_step_compact(arrays: dict, film: dict,
                                pix: torch.Tensor) -> dict:
            lane_pix = _tile(pix, spb)
            lanep = torch.clamp(lane_pix, min=0)
            lpx, lpy, ph = pixel_of(lanep, w, cfg.qmc_seed)
            base_idx = film["nsamples"].reshape(-1)[lanep.long()]
            return advance(arrays, film, lpx, lpy, ph, base_idx,
                           lane_pix >= 0, lane_pix)

        sample_step_compact.lanes = n
        return sample_step_compact

    def sample_step(arrays: dict, film: dict, flags: torch.Tensor) -> dict:
        # film sample counters are the QMC sample index (int32 = uint32
        # bits for the non-negative counts)
        return advance(arrays, film, px, py, pixel_hash,
                       _tile(film["nsamples"].reshape(-1), spb),
                       _tile(flags.reshape(-1), spb), None)

    sample_step.lanes = n
    return sample_step
