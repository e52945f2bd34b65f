"""Wavefront photon shooting (port of libyafaray_tpu/integrators/
photon_shoot.py).

All photons advance in lockstep through a static-depth bounce loop.  Each
lane picks a light by the power CDF, emits from it, then intersects and
scatters with Russian roulette by albedo; every qualifying hit records a
photon into a (bounce slot, lane) row: no append, no atomics; invalid rows
carry valid=False.

Emitted flux, as the reference's:
  area/mesh : color·power (radiance L = Φ/(πA))
  point     : 4π·intensity
  spot      : intensity·2π(1-(cos_start+cos_end)/2) (the cone's solid
              angle with the smoothstep falloff folded into the emission)
  sphere    : color·power
  sun, directional, IES, portal and the IBL light: 0
A meshlight's flux enters the power CDF, but its photons leave with zero
flux from the origin along +z, as the reference emits them (its emitter
has no meshlight branch): the lanes that pick it store nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import math as vmath
from ..core import qmc
from ..core.math import div
from ..core.sampling import PI, sample_cone, sample_cos_hemisphere, \
    sample_sphere
from ..lights import base as lightmod
from ..materials import bsdf
from ..materials.base import gather_rows
from ..parallel import distributed as pd
from ..parallel.mesh import sharded
from .engine import (F32, _surface_point, closest_hit,
                     is_diffuse_family, shading_frame)

PHOTON_MODES = ("diffuse", "caustic", "indirect")


def light_flux(static, lights: dict) -> np.ndarray:
    """Per-light total emitted flux (scalar luminance) for the power CDF,
    from the compiled scene's numpy light table (reference
    light->totalEnergy).  Each branch keeps the reference's scalar types:
    a Python float times a float32 table entry stays float32."""
    flux = []
    for li, ls in enumerate(static.lights):
        if not ls.enabled:
            flux.append(0.0)
            continue
        if ls.ltype in (lightmod.LT_AREA, lightmod.LT_MESH):
            f = (float(np.mean(lights["radiance"][li])) * PI
                 * max(lights["area"][li], 1e-12))
        elif ls.ltype == lightmod.LT_SPHERE:
            f = (float(np.mean(lights["radiance"][li])) * 4 * PI * PI
                 * lights["radius"][li] ** 2)
        elif ls.ltype == lightmod.LT_POINT:
            f = float(np.mean(lights["intensity"][li])) * 4.0 * PI
        elif ls.ltype == lightmod.LT_SPOT:
            cs, ce = lights["cos_start"][li], lights["cos_end"][li]
            f = (float(np.mean(lights["intensity"][li])) * 2.0 * PI
                 * (1.0 - 0.5 * (cs + ce)))
        else:  # sun, directional, IES, portal, IBL: no photons
            f = 0.0
        flux.append(max(f, 0.0))
    return np.asarray(flux, np.float64)


def _emit_one_light(ls, lrow: dict, n: int, u1, u2, u3, u4):
    """Photon origin, direction and flux color of one light over all lanes
    (reference _emit_one_light): an area light's uniform point and cosine
    direction; a point light's uniform direction; a spot's uniform
    direction in its cone, weighted by the cone's solid angle and the
    falloff; a sphere light's uniform surface point and cosine direction
    about its normal.  Any other light: a zero photon from the origin
    along +z."""
    if ls.ltype == lightmod.LT_AREA:
        q = (lrow["p0"] + u1[..., None] * lrow["e1"]
             + u2[..., None] * lrow["e2"])
        ln = vmath.normalize(vmath.cross(lrow["e1"], lrow["e2"])).expand(
            n, 3)
        d, _ = sample_cos_hemisphere(ln, u3, u4)
        return q, d, (lrow["radiance"] * PI * lrow["area"]).expand(n, 3)
    if ls.ltype == lightmod.LT_POINT:
        d = sample_sphere(u3, u4)
        return (lrow["p0"].expand(n, 3), d,
                (lrow["intensity"] * (4.0 * PI)).expand(n, 3))
    if ls.ltype == lightmod.LT_SPOT:
        axis = lrow["direction"].expand(n, 3)
        d, _ = sample_cone(axis, lrow["cos_end"], u3, u4)
        fall = lightmod.spot_falloff(lrow, vmath.dot(d, axis))
        # E[I·Ω·fall] under the cone pdf 1/Ω is the CDF's flux (the
        # smoothstep integrates to 1/2 over the blend band)
        omega = 2.0 * PI * (1.0 - lrow["cos_end"])
        return (lrow["p0"].expand(n, 3), d,
                lrow["intensity"][None, :] * omega * fall[..., None])
    if ls.ltype == lightmod.LT_SPHERE:
        r = lrow["radius"]
        dn = sample_sphere(u1, u2)
        d, _ = sample_cos_hemisphere(dn, u3, u4)
        return (lrow["p0"] + dn * r, d,
                (lrow["radiance"] * (PI * 4.0 * PI * (r * r))).expand(n, 3))
    zero = torch.zeros((n, 3), dtype=F32, device=u1.device)
    return zero, zero + torch.tensor([0.0, 0.0, 1.0], device=u1.device), zero


def gather_stored(rec: dict, slots: int) -> dict:
    """The stored rows of every rank's photon record (each rank's a share
    of the lanes, slot-major), gathered into the stored rows of the whole
    record in its order: slot by slot, rank by rank, lane by lane, which is
    the one-device record's order with its unstored rows taken out.  The
    stored counts differ by rank: they are gathered first, and each rank's
    rows padded to the largest.  Every returned row is valid."""
    valid = rec["valid"]
    dev = valid.device
    counts = torch.stack(pd.all_gather(
        valid.reshape(slots, -1).sum(dim=1))).cpu().numpy()  # (world, slots)
    rows = torch.cat([rec["pos"], rec["dir"], rec["power"],
                      rec["mat"].view(F32)[:, None], rec["normal"]],
                     dim=1)[valid]
    per_rank = counts.sum(axis=1)
    m = max(int(per_rank.max()), 1)
    buf = torch.zeros((m, rows.shape[1]), dtype=F32, device=dev)
    buf[:rows.shape[0]] = rows
    starts = np.cumsum(counts, axis=1) - counts
    idx = np.concatenate([np.zeros(0, np.int64)] + [
        r * m + starts[r, s] + np.arange(counts[r, s])
        for s in range(slots) for r in range(counts.shape[0])])
    full = torch.cat(pd.all_gather(buf))[torch.from_numpy(idx).to(dev)]
    out = dict(pos=full[:, 0:3], dir=full[:, 3:6], power=full[:, 6:9],
               mat=full[:, 9].view(torch.int32), normal=full[:, 10:13])
    out = {k: v.contiguous() for k, v in out.items()}
    out["valid"] = torch.ones((full.shape[0],), dtype=torch.bool, device=dev)
    return out


def make_photon_pass(static, cfg, n_lanes: int, max_bounces: int,
                     mode: str, mesh=None):
    """Returns shoot(arrays, light_cdf, seed) -> photon record dict of
    (max_bounces + 1)·n_lanes rows, slot-major: pos, dir (incoming, toward
    the surface the photon came from), power, mat, normal, valid.
    light_cdf is the (L+1,) numpy CDF of `light_flux`.
    mode: 'diffuse' stores every diffuse hit; 'caustic' stores diffuse hits
    reached through a specular-only chain of at least one bounce;
    'indirect' stores diffuse hits from the first bounce on (none straight
    from the light: SPPM's eye pass adds direct light by NEE).
    mesh: a film mesh of more than one rank splits the lanes (each keyed
    by its id, as on one device) and every rank returns the stored rows of
    the whole record (`gather_stored`): its compaction is the one-device
    record's."""
    if mode not in PHOTON_MODES:
        raise ValueError(f"photon mode {mode!r} is not one of {PHOTON_MODES}")
    multi = sharded(mesh)
    lane0, lane1 = mesh.lanes(n_lanes) if multi else (0, n_lanes)
    n = lane1 - lane0
    families = static.mat_families

    def shoot(arrays: dict, light_cdf: np.ndarray, seed: int) -> dict:
        dev = arrays["tri_geom_pack"].device
        lane_ids = torch.arange(lane0, lane1, dtype=torch.int32, device=dev)
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
            o_l, d_l, f_l = _emit_one_light(
                ls, lightmod.light_row(arrays["lights"], li), n, u1, u2, u3,
                u4)
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
        rec = {k: torch.cat(v) for k, v in rec.items()}
        return gather_stored(rec, max_bounces + 1) if multi else rec

    return shoot
