"""Wavefront photon shooting (port of libyafaray_tpu/integrators/
photon_shoot.py for area lights).

All photons advance in lockstep through a static-depth bounce loop.  Each
lane picks a light by the power CDF, emits from it, then intersects and
scatters with Russian roulette by albedo; every qualifying hit records a
photon into a (bounce slot, lane) row: no append, no atomics; invalid rows
carry valid=False.  Emitted flux of an area light: color·power (radiance
L = Φ/(πA)); the IBL light emits no photons (zero flux, as the
reference's light_flux gives it).  Other light types raise (ROADMAP Queue
1 item 17).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import math as vmath
from ..core import qmc
from ..core.math import div
from ..core.sampling import PI, sample_cos_hemisphere
from ..lights import base as lightmod
from ..materials import bsdf
from ..materials.base import gather_rows
from .engine import (F32, _surface_point, closest_hit,
                     is_diffuse_family, shading_frame)

PHOTON_MODES = ("diffuse", "caustic", "indirect")


def _check_area_lights(static) -> None:
    for ls in static.lights:
        if ls.ltype not in (lightmod.LT_AREA, lightmod.LT_BACKGROUND):
            raise NotImplementedError(
                f"photons from light type {ls.ltype} are not ported yet: "
                "ROADMAP Queue 1 item 17")


def light_flux(static, lights: dict) -> np.ndarray:
    """Per-light total emitted flux (scalar luminance) for the power CDF,
    from the compiled scene's numpy light table."""
    _check_area_lights(static)
    flux = []
    for li, ls in enumerate(static.lights):
        if not ls.enabled or ls.ltype == lightmod.LT_BACKGROUND:
            flux.append(0.0)
            continue
        # the reference's scalar types: a float32 area keeps the product
        # float32
        f = (float(np.mean(lights["radiance"][li])) * PI
             * max(lights["area"][li], 1e-12))
        flux.append(max(float(f), 0.0))
    return np.asarray(flux, np.float64)


def _emit_area(lrow: dict, n: int, u1, u2, u3, u4):
    """Photon origin, direction and flux color of an area light over all
    lanes: a uniform point of the parallelogram, a cosine direction."""
    q = lrow["p0"] + u1[..., None] * lrow["e1"] + u2[..., None] * lrow["e2"]
    ln = vmath.normalize(vmath.cross(lrow["e1"], lrow["e2"])).expand(n, 3)
    d, _ = sample_cos_hemisphere(ln, u3, u4)
    flux = lrow["radiance"] * PI * lrow["area"]
    return q, d, flux.expand(n, 3)


def make_photon_pass(static, cfg, n_lanes: int, max_bounces: int,
                     mode: str):
    """Returns shoot(arrays, light_cdf, seed) -> photon record dict of
    (max_bounces + 1)·n_lanes rows, slot-major: pos, dir (incoming, toward
    the surface the photon came from), power, mat, normal, valid.
    light_cdf is the (L+1,) numpy CDF of `light_flux`.
    mode: 'diffuse' stores every diffuse hit; 'caustic' stores diffuse hits
    reached through a specular-only chain of at least one bounce;
    'indirect' stores diffuse hits from the first bounce on (none straight
    from the light: SPPM's eye pass adds direct light by NEE)."""
    if mode not in PHOTON_MODES:
        raise ValueError(f"photon mode {mode!r} is not one of {PHOTON_MODES}")
    _check_area_lights(static)
    n = n_lanes
    families = static.mat_families

    def shoot(arrays: dict, light_cdf: np.ndarray, seed: int) -> dict:
        dev = arrays["tri_pack10"].device
        lane_ids = torch.arange(n, dtype=torch.int32, device=dev)
        skey = qmc.hash_combine(lane_ids, qmc.word_like(lane_ids, seed))
        s_idx = torch.zeros((n,), dtype=torch.int32, device=dev)
        mats = arrays["materials"]

        u_pick = qmc.sample_dim(s_idx, 0, skey)
        cdf = np.asarray(light_cdf, np.float32)
        li_pick = torch.zeros((n,), dtype=torch.int32, device=dev)
        for li in range(len(static.lights)):
            li_pick = torch.where(u_pick >= float(cdf[li]), li, li_pick)
        u1, u2 = qmc.sample_dim_pair(s_idx, 2, skey)
        u3, u4 = qmc.sample_dim_pair(s_idx, 4, skey)
        org = torch.zeros((n, 3), dtype=F32, device=dev)
        dirn = torch.zeros((n, 3), dtype=F32, device=dev)
        pcol = torch.zeros((n, 3), dtype=F32, device=dev)
        for li, ls in enumerate(static.lights):
            if ls.ltype == lightmod.LT_AREA:
                o_l, d_l, f_l = _emit_area(
                    lightmod.light_row(arrays["lights"], li), n, u1, u2, u3,
                    u4)
            else:  # the IBL light: a zero photon from the origin along +z
                o_l = f_l = torch.zeros((n, 3), dtype=F32, device=dev)
                d_l = o_l + torch.tensor([0.0, 0.0, 1.0], device=dev)
            sel = (li_pick == li)[..., None]
            prob = max(cdf[li + 1] - cdf[li], np.float32(1e-9))
            org = torch.where(sel, o_l, org)
            dirn = torch.where(sel, d_l, dirn)
            pcol = torch.where(sel, div(f_l, prob), pcol)

        alive = pcol.amax(dim=-1) > 0.0
        spec_only = torch.ones((n,), dtype=torch.bool, device=dev)
        had_spec = torch.zeros((n,), dtype=torch.bool, device=dev)
        tmin = torch.full((n,), static.ray_min_dist, dtype=F32, device=dev)
        rec = {k: [] for k in ("pos", "dir", "power", "mat", "normal",
                               "valid")}
        for bounce in range(max_bounces + 1):
            hit = closest_hit(arrays, static, org, dirn, tmin,
                              torch.where(alive, float("inf"), -1.0))
            alive = alive & hit.hit
            sp = _surface_point(arrays, hit, org, dirn)
            wo = -dirn
            row = gather_rows(mats, sp["mat"].long())
            n_sh, ng_sh = shading_frame(sp, wo)
            # surfaces with a diffuse lobe store photons (BSDF_DIFFUSE)
            store = (alive & is_diffuse_family(row["mtype"])
                     & (row["diffuse_reflect"] > 1e-5))
            if mode == "caustic":
                store = store & had_spec & spec_only
            elif mode == "indirect" and bounce == 0:
                store = torch.zeros_like(store)
            for k, v in (("pos", sp["p"]), ("dir", wo), ("power", pcol),
                         ("mat", sp["mat"]), ("normal", n_sh),
                         ("valid", store)):
                rec[k].append(v)
            if bounce == max_bounces:
                break

            bd = 8 + bounce * 4
            b1, b2 = qmc.sample_dim_pair(s_idx, bd, skey)
            ul, u_rr = qmc.sample_dim_pair(s_idx, bd + 2, skey)
            smp = bsdf.sample_bsdf(row, n_sh, ng_sh, wo, b1, b2, ul,
                                   families)
            scatter_col = pcol * smp["tp"]
            # Russian roulette by albedo: survive with p = max component
            p_surv = torch.clamp(smp["tp"].amax(dim=-1), 0.0, 1.0)
            alive = alive & smp["valid"] & (u_rr < p_surv)
            pcol = scatter_col / torch.clamp(p_surv, min=1e-6)[..., None]
            spec_only = spec_only & smp["specular"]
            had_spec = had_spec | smp["specular"]
            off = torch.where(smp["transmit"], -1.0, 1.0)[..., None]
            org = sp["p"] + ng_sh * off * static.shadow_bias
            dirn = smp["wi"]
        return {k: torch.cat(v) for k, v in rec.items()}

    return shoot
