"""Volume integrators (port of libyafaray_tpu/volumes/integrate.py:
reference EmissionIntegrator / SingleScatterIntegrator).

Applied to the camera segment (origin -> first hit / escape), where the
reference's volume integrator wraps the surface integrator's result:
    L = T(segment)·L_surface + L_volume
Density models: uniform (closed-form transmittance), exp-height, sky and
noise (fixed-step ray marching, MARCH_STEPS steps), and a DF3 grid.  Single
scattering marches the segment and at each step takes one NEE sample of
every non-mesh, non-background light through the medium, its shadow ray
through the scene's shadow kernels (`shadow_fn`).

The order of accumulation is the reference's: tau step by step, and at
every camera-side step a nested march of the transmittance back to the
camera.  Each step is a handful of eager tensor ops, so the march costs
thousands of small launches a sample step; its shadow rays are one kernel
launch per step and light.
"""
from __future__ import annotations

import math
from functools import lru_cache

import torch

from ..core import math as vmath
from ..core import qmc
from ..lights import base as lightmod
from .factory import (VOL_EXP, VOL_GRID, VOL_NOISE, VOL_SKY, VOL_UNIFORM,
                      VolumeRegion)

F32 = torch.float32
MARCH_STEPS = 16
ATT_GRID = 24  # attenuation-grid resolution per axis (`optimize`)


@lru_cache(maxsize=64)
def _vec(a: tuple, dev: torch.device) -> torch.Tensor:
    """A region's corner as a tensor on `dev`, made once: the march reads
    it ~1,000 times a step, and each fresh one is a host-to-device copy."""
    return torch.tensor(a, dtype=F32, device=dev)


def _recip(x: torch.Tensor) -> torch.Tensor:
    """1 / x as a true float32 division."""
    return torch.ones_like(x) / x


def _ray_aabb(org, dirn, bmin, bmax, tmax):
    """(enter, exit) of the rays' segments [0, tmax] in the box; exit >=
    enter (an empty segment where the ray misses it)."""
    tiny = torch.where(dirn < 0, -1e-12, 1e-12)
    inv = _recip(torch.where(dirn.abs() < 1e-12, tiny, dirn))
    t0 = (_vec(bmin, org.device) - org) * inv
    t1 = (_vec(bmax, org.device) - org) * inv
    tlo = torch.minimum(t0, t1).amax(dim=-1)
    thi = torch.maximum(t0, t1).amin(dim=-1)
    enter = torch.clamp(tlo, min=0.0)
    exit_ = torch.minimum(thi, tmax)
    return enter, torch.maximum(exit_, enter)


def _f2u32(x: torch.Tensor) -> torch.Tensor:
    """float -> uint32 word as XLA converts it: truncated, negative values
    saturating to 0 and large ones to 2^32 - 1."""
    w = torch.clamp(x, min=0.0).to(torch.int64)
    return qmc.u32(torch.clamp(w, max=0xFFFFFFFF))


def _grids(volumes, arrays) -> tuple:
    """The scene's density grid of each region (None but for a GridVolume
    that loaded): the arrays' vol_grid_{vi}."""
    return tuple(arrays.get(f"vol_grid_{vi}") for vi in range(len(volumes)))


def _density(vol: VolumeRegion, p: torch.Tensor, grid=None) -> torch.Tensor:
    """Relative density at points p (N,3); a GridVolume's reads `grid`, its
    (nz, ny, nx) densities (the scene array vol_grid_{vi})."""
    dev = p.device
    if vol.vtype == VOL_UNIFORM:
        return torch.ones(p.shape[:-1], dtype=F32, device=dev)
    if vol.vtype in (VOL_EXP, VOL_SKY):
        # exponential height falloff above the box's floor (SkyVolume's
        # Rayleigh / Mie split acts in the phase function)
        z0 = vol.bmin[2]
        return vol.a * torch.exp(-vol.b * torch.clamp(p[..., 2] - z0,
                                                      min=0.0))
    if vol.vtype == VOL_NOISE:
        # hash value noise on a lattice of spacing 1/2, trilinearly blended
        q = p * 2.0
        qi = torch.floor(q)
        qf = q - qi

        def h(ix, iy, iz):
            v = qmc.hash_combine(qmc.hash_combine(_f2u32(ix), _f2u32(iy)),
                                 _f2u32(iz))
            return qmc.u32_to_float(v) * (1.0 / 4294967296.0)

        ix, iy, iz = qi[..., 0], qi[..., 1], qi[..., 2]
        fx, fy, fz = qf[..., 0], qf[..., 1], qf[..., 2]

        def lerp(a, b, t):
            return a + (b - a) * t

        c00 = lerp(h(ix, iy, iz), h(ix + 1, iy, iz), fx)
        c10 = lerp(h(ix, iy + 1, iz), h(ix + 1, iy + 1, iz), fx)
        c01 = lerp(h(ix, iy, iz + 1), h(ix + 1, iy, iz + 1), fx)
        c11 = lerp(h(ix, iy + 1, iz + 1), h(ix + 1, iy + 1, iz + 1), fx)
        n = lerp(lerp(c00, c10, fy), lerp(c01, c11, fy), fz)
        d = (n - (1.0 - vol.cover)) * vol.sharpness
        return torch.clamp(d, 0.0, 1.0) * vol.density
    if vol.vtype == VOL_GRID and vol.grid_shape:
        if grid is None:
            raise ValueError("a GridVolume's density needs its vol_grid array")
        nz, ny, nx = vol.grid_shape
        bmin = _vec(vol.bmin, dev)
        rel = (p - bmin) / torch.clamp(_vec(vol.bmax, dev) - bmin, min=1e-9)
        ix = torch.clamp((rel[..., 0] * nx).to(torch.int32), 0, nx - 1)
        iy = torch.clamp((rel[..., 1] * ny).to(torch.int32), 0, ny - 1)
        iz = torch.clamp((rel[..., 2] * nz).to(torch.int32), 0, nz - 1)
        inside = ((rel >= 0.0) & (rel <= 1.0)).all(dim=-1)
        return torch.where(inside, grid[iz.long(), iy.long(), ix.long()], 0.0)
    return torch.ones(p.shape[:-1], dtype=F32, device=dev)


def _phase(vol: VolumeRegion, cos_t: torch.Tensor) -> torch.Tensor:
    """Phase function value for the scatter angle's cosine (N,):
    Henyey-Greenstein with the region's g (isotropic at g = 0); SkyVolume
    mixes Rayleigh 3/(16π)(1+cos²θ) and HG-Mie by its s_ray / s_mie
    split."""
    inv4pi = 1.0 / (4.0 * math.pi)
    g = vol.g
    if abs(g) < 1e-6:
        hg = torch.full_like(cos_t, inv4pi)
    else:
        denom = torch.clamp(1.0 + g * g - 2.0 * g * cos_t, min=1e-6)
        hg = (torch.full_like(cos_t, inv4pi * (1.0 - g * g))
              / (denom * vmath.sqrt_rn(denom)))
    if vol.vtype == VOL_SKY:
        ray = 3.0 / (16.0 * math.pi) * (1.0 + cos_t * cos_t)
        wr = vol.s_ray / max(vol.s_ray + vol.s_mie, 1e-12)
        return wr * ray + (1.0 - wr) * hg
    return hg


def _trilinear_grid(grid: torch.Tensor, bmin, bmax, p: torch.Tensor):
    """Sample a (G, G, G) scalar grid trilinearly at world points p (N,3),
    clamped at the borders."""
    gz, gy, gx = grid.shape
    bmin = _vec(bmin, p.device)
    rel = (p - bmin) / torch.clamp(_vec(bmax, p.device) - bmin, min=1e-9)
    fx = torch.clamp(rel[..., 0] * gx - 0.5, 0.0, gx - 1.0)
    fy = torch.clamp(rel[..., 1] * gy - 0.5, 0.0, gy - 1.0)
    fz = torch.clamp(rel[..., 2] * gz - 0.5, 0.0, gz - 1.0)
    x0, y0, z0 = (torch.floor(f).to(torch.int32) for f in (fx, fy, fz))
    x1 = torch.clamp(x0 + 1, max=gx - 1)
    y1 = torch.clamp(y0 + 1, max=gy - 1)
    z1 = torch.clamp(z0 + 1, max=gz - 1)
    tx, ty, tz = fx - x0, fy - y0, fz - z0

    def at(z, y, x):
        return grid[z.long(), y.long(), x.long()]

    c00 = at(z0, y0, x0) * (1 - tx) + at(z0, y0, x1) * tx
    c01 = at(z1, y0, x0) * (1 - tx) + at(z1, y0, x1) * tx
    c10 = at(z0, y1, x0) * (1 - tx) + at(z0, y1, x1) * tx
    c11 = at(z1, y1, x0) * (1 - tx) + at(z1, y1, x1) * tx
    return ((c00 * (1 - ty) + c10 * ty) * (1 - tz)
            + (c01 * (1 - ty) + c11 * ty) * tz)


def _marched_lights(static):
    """(li, ls) of the lights a march samples: enabled, neither meshlights
    nor the background light."""
    return [(li, ls) for li, ls in enumerate(static.lights)
            if ls.enabled and ls.ltype not in (lightmod.LT_MESH,
                                               lightmod.LT_BACKGROUND)]


def build_attenuation_grids(volumes, static, arrays, cfg, shadow_fn) -> dict:
    """SingleScatter `optimize` precompute (reference
    SingleScatterIntegrator.cc attenuationGridMap): per (volume, light) a
    G³ grid of shadow x medium transmittance toward the light, sampled once
    at render start instead of at every march step: a delta light at one
    emitter sample, an area-class light averaged over a 2 x 2 stratified
    grid of emitter samples.  Returns {"vol_att_{vi}_{li}": (G, G, G)}."""
    from ..integrators.engine import _LIGHT_SAMPLERS

    dev = arrays["tri_geom_pack"].device
    out = {}
    g = ATT_GRID
    grids = _grids(volumes, arrays)
    c = vmath.div(torch.arange(g, dtype=F32, device=dev) + 0.5, g)
    for vi, vol in enumerate(volumes):
        bmin, bmax = _vec(vol.bmin, dev), _vec(vol.bmax, dev)
        zs, ys, xs = torch.meshgrid(c, c, c, indexing="ij")
        p = bmin + torch.stack([xs, ys, zs], dim=-1).reshape(-1, 3) \
            * (bmax - bmin)
        n = p.shape[0]
        for li, ls in _marched_lights(static):
            lrow = lightmod.light_row(arrays["lights"], li)
            u_set = (((0.5, 0.5),) if ls.is_delta else
                     tuple((ux / 2.0 + 0.25, uy / 2.0 + 0.25)
                           for ux in range(2) for uy in range(2)))
            att = torch.zeros((n,), dtype=F32, device=dev)
            for ux, uy in u_set:
                u1 = torch.full((n,), ux, dtype=F32, device=dev)
                u2 = torch.full((n,), uy, dtype=F32, device=dev)
                smp = _LIGHT_SAMPLERS[ls.ltype](lrow, p, u1, u2)
                occ = shadow_fn(p, smp["wi"], smp["dist"])
                t_med = transmittance(volumes, p, smp["wi"], smp["dist"],
                                      grids=grids)
                occ_mean = vmath.div(occ[:, 0] + occ[:, 1] + occ[:, 2], 3)
                att = att + occ_mean * t_med
            out[f"vol_att_{vi}_{li}"] = vmath.div(att, len(u_set)).reshape(
                g, g, g)
    return out


def _step_density(vol, org, dirn, tm, dt, adaptive=False, grid=None):
    """Density of one march step.  adaptive=True (reference SingleScatter
    `adaptive`): nonuniform volumes average 4 stratified substeps."""
    if not adaptive or vol.vtype == VOL_UNIFORM:
        return _density(vol, org + dirn * tm[..., None], grid)
    acc = 0.0
    for k in range(4):
        tk = tm + dt * ((k + 0.5) / 4.0 - 0.5)
        acc = acc + _density(vol, org + dirn * tk[..., None], grid)
    return acc * 0.25


def transmittance(volumes, org, dirn, dist, adaptive=False, grids=None):
    """Beer transmittance along the segments (N,) over every region
    crossed; `grids` holds each region's density grid (`_grids`)."""
    tr = torch.ones(dist.shape, dtype=F32, device=dist.device)
    for vol, grid in zip(volumes, grids or (None,) * len(volumes)):
        sig_t = vol.sigma_a + vol.sigma_s
        if sig_t <= 0.0:
            continue
        t0, t1 = _ray_aabb(org, dirn, vol.bmin, vol.bmax, dist)
        seg = torch.clamp(t1 - t0, min=0.0)
        if vol.vtype == VOL_UNIFORM:
            tau = sig_t * seg
        else:
            dt = vmath.div(seg, MARCH_STEPS)
            tau = torch.zeros_like(seg)
            for i in range(MARCH_STEPS):
                tm = t0 + (i + 0.5) * dt
                tau = tau + _step_density(vol, org, dirn, tm, dt, adaptive,
                                          grid) * sig_t * dt
        tr = tr * torch.exp(-tau)
    return tr


def integrate_volume(volumes, mode: str, arrays, static, cfg, shadow_fn,
                     org, dirn, dist, s_idx, skey):
    """(L_vol (N,3), T (N,)) of the camera segments org -> org + dirn·dist.

    mode: 'EmissionIntegrator' | 'SingleScatterIntegrator' | 'none'.
    shadow_fn(org, dirn, dist) -> (N,3) transmission, for in-scatter NEE;
    step i of the march draws its light sample from QMC dims 40 + 2i and
    41 + 2i keyed by hash_combine(skey, light index)."""
    from ..integrators.engine import _LIGHT_SAMPLERS

    n, dev = org.shape[0], org.device
    if not volumes or mode in ("none", ""):
        return (torch.zeros((n, 3), dtype=F32, device=dev),
                torch.ones((n,), dtype=F32, device=dev))
    l_vol = torch.zeros((n, 3), dtype=F32, device=dev)
    grids = _grids(volumes, arrays)
    t_total = transmittance(volumes, org, dirn, dist, grids=grids)
    adaptive = bool(getattr(cfg, "vol_adaptive", False))
    lights = _marched_lights(static)
    for vi, vol in enumerate(volumes):
        t0, t1 = _ray_aabb(org, dirn, vol.bmin, vol.bmax, dist)
        seg = torch.clamp(t1 - t0, min=0.0)
        dt = vmath.div(seg, MARCH_STEPS)
        for i in range(MARCH_STEPS):
            tm = t0 + (i + 0.5) * dt
            p = org + dirn * tm[..., None]
            dens = _step_density(vol, org, dirn, tm, dt, adaptive, grids[vi])
            # transmittance from the camera to the sample point
            t_cam = transmittance(volumes, org, dirn, tm, adaptive, grids)
            if mode == "EmissionIntegrator":
                l_vol = l_vol + (vol.l_e * dens * t_cam * dt)[..., None] \
                    * torch.ones((1, 3), dtype=F32, device=dev)
                continue
            if vol.sigma_s <= 0.0:
                continue
            ls_sum = torch.zeros((n, 3), dtype=F32, device=dev)
            for li, lstat in lights:
                lrow = lightmod.light_row(arrays["lights"], li)
                key = qmc.hash_combine(skey, qmc.word_like(skey, li))
                u1 = qmc.sample_dim(s_idx, 40 + 2 * i, key)
                u2 = qmc.sample_dim(s_idx, 41 + 2 * i, key)
                smp = _LIGHT_SAMPLERS[lstat.ltype](lrow, p, u1, u2)
                att_key = f"vol_att_{vi}_{li}"
                if att_key in arrays:
                    # `optimize`: the precomputed attenuation grid stands
                    # in for the shadow ray and the medium march
                    occ_med = _trilinear_grid(arrays[att_key], vol.bmin,
                                              vol.bmax, p)[..., None]
                else:
                    occ = shadow_fn(p, smp["wi"], smp["dist"])
                    t_med = transmittance(volumes, p, smp["wi"], smp["dist"],
                                          grids=grids)
                    occ_med = occ * t_med[..., None]
                phase = _phase(vol, vmath.dot(-dirn, smp["wi"]))
                ok = smp["valid"] & (smp["pdf"] > 1e-9)
                term = smp["li"] * occ_med * (
                    phase / torch.clamp(smp["pdf"], min=1e-9))[..., None]
                ls_sum = ls_sum + torch.where(ok[..., None], term, 0.0)
            l_vol = (l_vol + (vol.sigma_s * dens * t_cam * dt)[..., None]
                     * ls_sum + (vol.l_e * dens * t_cam * dt)[..., None])
    return l_vol, t_total
