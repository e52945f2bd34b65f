"""Photon-mapping integrator (port of libyafaray_tpu/integrators/
photonmap.py, over one device or a film mesh, with its film save / load by
pass), and the path tracer's caustic photon map (`build_caustic_map`).

    preprocess  wavefront photon passes (photon_shoot), device-side
                compaction, photon packs (ops/photon_flash) and the
                radiance map: Lambertian exitance at a strided subset of
                the stored diffuse photons, from a density gather
    sample step the engine's camera rays and specular transport up to
                raydepth, storing each lane's first diffuse hit; then,
                once per lane: NEE (full light sample counts, per-lane
                dynamic QMC dims, no MIS), the caustic map's density, and
                fg_samples cosine final-gather rays whose hits look up the
                nearest radiance photon (or, without final gather, the
                diffuse map's density); one splat straight into the film

The pixel hash carries no qmc_seed, and the step splats straight into the
film, both as the reference's photon step does.

On a film mesh (`parallel/mesh.py`) every photon pass splits its lanes over
the ranks and gathers the stored photons in lane order, so each rank
builds the one-device maps; each rank's step traces the pixels of its band
of rows into its partial film, and the adaptive flags and the result read
the summed film.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..backgrounds.base import eval_background
from ..convert import to_tensors
from ..core import qmc
from ..core.math import div
from ..core.sampling import INV_PI, sample_cos_hemisphere
from ..film.imagefilm import compute_aa_flags, film_save, film_splat_lanes
from ..materials import bsdf
from ..materials.base import gather_rows
from ..ops.photon_flash import (density_auto, make_photon_pack_auto,
                                make_photon_pack_lookup, nearest_flash,
                                pack_layout)
from .config import RenderConfig
from .engine import (F32, _direct_lighting, _surface_point,
                     bounce_key, camera_rays, check_arrays, check_supported,
                     closest_hit, is_diffuse_family, resolve_device,
                     shading_frame, uses_textures)
from .photon_shoot import light_flux, make_photon_pass
from ..parallel.mesh import band_of, finish, lane_pixels, sum_film, writes
from .render import (RenderResult, _fresh_film, _sync, film_params,
                     load_film, saves_passes)

MAX_PHOTON_LANES = 1 << 18
RADIANCE_QUERIES = 1 << 16  # radiance-map size target and query chunk


def _light_cdf(static, lights: dict):
    """(CDF over the lights by emitted flux, total flux), from numpy."""
    flux = light_flux(static, lights)
    total = flux.sum()
    if total <= 0:
        return np.zeros(len(flux) + 1, np.float32), 0.0
    cdf = np.concatenate([[0.0], np.cumsum(flux / total)]).astype(np.float32)
    cdf[-1] = 1.0
    return cdf, float(total)


def compact_photons_device(rec: dict, cap: int) -> dict:
    """Scatter the valid rows of a photon record into a cap-row buffer, in
    order; rows past cap are dropped (through a last row that is cut)."""
    valid = rec["valid"]
    pos_idx = torch.cumsum(valid.to(torch.int64), 0) - 1
    dest = torch.where(valid & (pos_idx < cap), pos_idx, cap)
    total = torch.clamp(pos_idx[-1] + 1, max=cap)
    out = {}
    for k, v in rec.items():
        if k == "valid":
            continue
        buf = torch.zeros((cap + 1,) + v.shape[1:], dtype=v.dtype,
                          device=v.device)
        buf[dest] = v
        out[k] = buf[:cap]
    out["valid"] = torch.arange(cap, device=valid.device) < total
    return out


def photon_radii(cscene, cfg: RenderConfig):
    """(diffuse, caustic) radii: the config's, else shares of the scene
    diagonal."""
    diag = float(np.linalg.norm(np.asarray(cscene.bound_max)
                                - np.asarray(cscene.bound_min)))
    return (cfg.diffuse_radius if cfg.diffuse_radius > 0 else diag * 0.01,
            cfg.caustic_radius if cfg.caustic_radius > 0 else diag * 0.005)


def _layout_info(pack: dict) -> dict:
    """A pack's width and layout (`pack_layout`: "flash", "sorted" or
    "culled"), for reports."""
    return dict(pack=pack["tbl" if "tbl" in pack else "pos_t"].shape[1],
                layout=pack_layout(pack))


def build_caustic_map(cscene, cfg: RenderConfig, arrays: dict, mesh=None):
    """The path tracer's caustic map (reference build_caustic_map, the
    createCausticMap that directlight and the path tracer share): one
    caustic photon pass of caustic_photons lanes (rounded to 4096, at most
    MAX_PHOTON_LANES) seeded 777, compacted and packed; on a mesh its lanes
    split over the ranks (`make_photon_pass`).  Returns (pack, radius,
    photons emitted, photons stored), or None when no light emits or no
    photon is stored.  Reads the stored count once."""
    static = cscene.static
    cdf, total_flux = _light_cdf(static, cscene.arrays["lights"])
    if total_flux <= 0:
        return None
    _, c_radius = photon_radii(cscene, cfg)
    lanes = min(MAX_PHOTON_LANES,
                max(4096, -(-cfg.caustic_photons // 4096) * 4096))
    shoot = make_photon_pass(static, cfg, lanes, cfg.photon_bounces,
                             "caustic", mesh=mesh)
    rec = shoot(arrays, cdf, 777)
    n_stored = int(rec["valid"].sum())
    if n_stored == 0:
        return None
    rec = compact_photons_device(rec, max(4096, -(-n_stored // 4096) * 4096))
    pack = make_photon_pack_auto(rec["pos"], rec["valid"], rec["dir"],
                                 rec["power"])
    return pack, c_radius, lanes, n_stored


def build_photon_maps(cscene, cfg: RenderConfig, arrays: dict,
                      mesh=None) -> dict:
    """Shoot the diffuse and caustic maps and precompute the radiance map.
    Returns dict(diffuse, caustic, radiance: packs or None, n_em_d, n_em_c:
    photons emitted per map, info: counts for reports).  On a mesh the
    photon passes split their lanes and every rank builds the same maps."""
    static = cscene.static
    cdf, total_flux = _light_cdf(static, cscene.arrays["lights"])
    out = dict(diffuse=None, caustic=None, radiance=None, n_em_d=1,
               n_em_c=1, info={})
    if total_flux <= 0:
        return out
    d_radius, _ = photon_radii(cscene, cfg)

    def shoot_map(n_req: int, mode: str, seed0: int):
        # lanes rounded to 4096, passes seeded seed0 + p
        lanes = min(MAX_PHOTON_LANES, max(4096, -(-n_req // 4096) * 4096))
        n_passes = max(1, int(np.ceil(n_req / lanes)))
        shoot = make_photon_pass(static, cfg, lanes, cfg.photon_bounces,
                                 mode, mesh=mesh)
        recs = [shoot(arrays, cdf, seed0 + p) for p in range(n_passes)]
        rec = {k: torch.cat([r[k] for r in recs]) for k in recs[0]}
        n_stored = int(rec["valid"].sum())
        cap = max(4096, -(-max(n_stored, 1) // 4096) * 4096)
        out["info"][mode] = dict(lanes=lanes, passes=n_passes,
                                 emitted=lanes * n_passes, stored=n_stored)
        return compact_photons_device(rec, cap), lanes * n_passes

    rec_d, out["n_em_d"] = shoot_map(cfg.photons, "diffuse", 1000)
    rec_c, out["n_em_c"] = shoot_map(cfg.caustic_photons, "caustic", 9000)
    for key, rec in (("diffuse", rec_d), ("caustic", rec_c)):
        out[key] = make_photon_pack_auto(rec["pos"], rec["valid"],
                                         rec["dir"], rec["power"])
        out["info"][key].update(_layout_info(out[key]))

    if cfg.final_gather:
        # outgoing radiance at a strided subset of the stored diffuse
        # photons (invalid rows included), Lambertian: E·ρ/π
        stride = max(1, -(-rec_d["pos"].shape[0] // RADIANCE_QUERIES))
        qp = rec_d["pos"][::stride].contiguous()
        qn = rec_d["normal"][::stride].contiguous()
        r_q = d_radius * 2.0
        flux = torch.cat([
            density_auto(out["diffuse"], qp[c0:c0 + RADIANCE_QUERIES],
                         qn[c0:c0 + RADIANCE_QUERIES], r_q)[0]
            for c0 in range(0, qp.shape[0], RADIANCE_QUERIES)])
        e_irr = div(div(flux, np.pi * r_q ** 2), out["n_em_d"])
        rows = gather_rows(arrays["materials"],
                           rec_d["mat"][::stride].long())
        lo = (e_irr * rows["diffuse_color"]
              * rows["diffuse_reflect"][..., None] * INV_PI)
        out["radiance"] = make_photon_pack_lookup(
            qp, rec_d["valid"][::stride], qn, lo)
        out["info"]["radiance"] = dict(queries=qp.shape[0], stride=stride,
                                       **_layout_info(out["radiance"]))
    return out


def make_photon_sample_step(cscene, cfg: RenderConfig, maps: dict, device,
                            pix: torch.Tensor | None = None):
    """One-sample-per-pixel photon-mapping step on `device`:
    sample_step(arrays, film, flags) -> film, `arrays` the scene tensors
    with the packs under pm_diffuse / pm_caustic / pm_radiance.  pix: the
    flat pixel ids of the lanes (a rank's band), None for every pixel; the
    step then splats its lanes by id (`film_splat_compact`, the same adds
    in the same order as the dense splat)."""
    static = cscene.static
    check_supported(static, cfg)
    if cfg.integrator != "photonmapping":
        raise ValueError(f"make_photon_sample_step renders photonmapping, "
                         f"not {cfg.integrator!r}")
    if (static.has_blend and static.blend_child_textured
            and uses_textures(static)):
        # the reference shades stored hit points from (p, n, ng) alone, so
        # its NEE cannot texture a composite's child (ROADMAP Queue 3)
        raise NotImplementedError(
            "photon mapping with textured blend / mask children: the "
            "reference's hit-point shading has no texture coordinates")
    dev = resolve_device(device)
    h, w = cfg.height, cfg.width
    lane = (torch.arange(h * w, dtype=torch.int32, device=dev)
            if pix is None else pix)
    n = lane.shape[0]
    py = torch.div(lane, w, rounding_mode="floor")
    px = lane - py * w
    pixel_hash = qmc.hash_u32(px ^ (py << 16))  # no qmc_seed, as the ref
    d_radius, c_radius = photon_radii(cscene, cfg)
    has_diffuse = maps["diffuse"] is not None
    has_caustic = maps["caustic"] is not None
    has_radiance = maps["radiance"] is not None
    # without final gather the diffuse map's density is the whole
    # transport (it stores direct photons too): no NEE, no caustic map
    show_map = has_diffuse and not has_radiance
    tmin = torch.full((n,), static.ray_min_dist, dtype=F32, device=dev)
    no_tmax = torch.full((n,), float("inf"), dtype=F32, device=dev)

    def shade_lanes(arrays, s_idx, active):
        dx, dy, org, dirn, wt = camera_rays(cscene.camera, px, py,
                                            pixel_hash, s_idx)
        mats = arrays["materials"]
        L = torch.zeros((n, 3), dtype=F32, device=dev)
        throughput = torch.ones((n, 3), dtype=F32, device=dev)
        alive = active & (wt > 0.0)
        done = torch.zeros((n,), dtype=torch.bool, device=dev)
        nrays = alive.to(F32).sum()

        # phase 1: follow specular chains up to raydepth and store each
        # lane's first diffuse hit
        hp = dict(p=torch.zeros((n, 3), dtype=F32, device=dev))
        hp["n"], hp["ng"], hp["wo"] = (torch.zeros_like(hp["p"])
                                       for _ in range(3))
        hp["tp"] = torch.ones_like(hp["p"])
        hp["mat"], hp["bdim"], hp["skey"] = (
            torch.zeros((n,), dtype=torch.int32, device=dev)
            for _ in range(3))
        for bounce in range(cfg.raydepth + 1):
            hit = closest_hit(arrays, static, org, dirn, tmin, no_tmax)
            escape = alive & ~hit.hit
            L = L + torch.where(escape[..., None],
                                throughput * eval_background(
                                    static.bg, arrays.get("bg_image"), dirn),
                                0.0)
            alive = alive & hit.hit
            sp = _surface_point(arrays, hit, org, dirn)
            wo = -dirn
            row = gather_rows(mats, sp["mat"].long())
            L = L + torch.where(alive[..., None],
                                throughput * bsdf.emission(row, sp["ng"], wo),
                                0.0)
            n_sh, ng_sh = shading_frame(sp, wo)
            here = alive & is_diffuse_family(row["mtype"]) & ~done
            bdim = qmc.bounce_dim(bounce, 0)
            skey_b = bounce_key(pixel_hash, bounce)
            m3 = here[..., None]
            for k, v in (("p", sp["p"]), ("n", n_sh), ("ng", ng_sh),
                         ("wo", wo), ("tp", throughput)):
                hp[k] = torch.where(m3, v, hp[k])
            hp["mat"] = torch.where(here, sp["mat"], hp["mat"])
            hp["bdim"] = torch.where(here, bdim, hp["bdim"])
            hp["skey"] = torch.where(here, skey_b, hp["skey"])
            done = done | here
            if bounce == cfg.raydepth:
                break
            # continue only through chains: specular vertices and rough
            # glass (non-delta, but never a stored hit); no wavelength
            # lane, so a dispersive glass is glass at its base IOR
            u1, u2 = qmc.sample_dim_pair(s_idx, bdim + qmc.SLOT_BSDF_U,
                                         skey_b)
            ul = qmc.sample_dim(s_idx, bdim + qmc.SLOT_LIGHT_PICK, skey_b)
            smp = bsdf.sample_bsdf(row, n_sh, ng_sh, wo, u1, u2, ul,
                                   static.mat_families)
            alive = alive & smp["chain"] & smp["valid"] & ~done
            throughput = throughput * smp["tp"]
            off = torch.where(smp["transmit"], -1.0, 1.0)[..., None]
            org = sp["p"] + ng_sh * off * static.shadow_bias
            dirn = smp["wi"]
            nrays = nrays + alive.to(F32).sum()

        # phase 2: shade the stored hit points once
        stored = done
        row = gather_rows(mats, hp["mat"].long())
        m3 = stored[..., None]
        n_stored = stored.to(F32).sum()
        f_diff = (row["diffuse_reflect"][..., None] * row["diffuse_color"]
                  * INV_PI)
        if not show_map:
            Ld, sh_rays = _direct_lighting(
                arrays, static, cfg, hp["p"], hp["n"], hp["ng"], row,
                hp["wo"], s_idx, hp["skey"], hp["bdim"], True, False,
                stored, mis_with_bsdf=False)
            L = L + torch.where(m3, hp["tp"] * Ld, 0.0)
            nrays = nrays + sh_rays * n_stored
        if has_caustic and not show_map:
            cflux, _ = density_auto(arrays["pm_caustic"], hp["p"], hp["n"],
                                    c_radius)
            lc = div(div(cflux, np.pi * c_radius * c_radius),
                      maps["n_em_c"])
            L = L + torch.where(m3, hp["tp"] * f_diff * lc, 0.0)
        if has_radiance:
            gorg = hp["p"] + hp["ng"] * static.shadow_bias
            ind = torch.zeros((n, 3), dtype=F32, device=dev)
            for s in range(cfg.fg_samples):
                skey_f = qmc.hash_combine(hp["skey"],
                                          qmc.word_like(px, 0xF6 + s))
                u1 = qmc.dynamic_sample_dim(
                    s_idx, hp["bdim"] + qmc.SLOT_BSDF_U, skey_f)
                u2 = qmc.dynamic_sample_dim(
                    s_idx, hp["bdim"] + qmc.SLOT_BSDF_V, skey_f)
                gd, _ = sample_cos_hemisphere(hp["n"], u1, u2)
                ghit = closest_hit(arrays, static, gorg, gd, tmin, no_tmax)
                gsp = _surface_point(arrays, ghit, gorg, gd)
                rad, found = nearest_flash(arrays["pm_radiance"],
                                           gsp["p"].contiguous(),
                                           d_radius * 4.0)
                li = torch.where(ghit.hit[..., None],
                                 torch.where(found[..., None], rad, 0.0),
                                 eval_background(static.bg,
                                                 arrays.get("bg_image"), gd))
                ind = ind + li
            # cosine sampling of a Lambertian: f·cos/pdf = ρ
            ind = (div(ind, cfg.fg_samples) * row["diffuse_color"]
                   * row["diffuse_reflect"][..., None])
            L = L + torch.where(m3, hp["tp"] * ind, 0.0)
            nrays = nrays + cfg.fg_samples * n_stored
        elif has_diffuse:
            dflux, _ = density_auto(arrays["pm_diffuse"], hp["p"], hp["n"],
                                    d_radius)
            ld = div(div(dflux, np.pi * d_radius * d_radius),
                      maps["n_em_d"])
            L = L + torch.where(m3, hp["tp"] * f_diff * ld, 0.0)
        return L * wt[..., None], dx, dy, nrays

    def sample_step(arrays: dict, film: dict, flags: torch.Tensor) -> dict:
        check_arrays(arrays, dev)
        s_idx = film["nsamples"].reshape(-1)
        active = flags.reshape(-1)
        if pix is not None:
            s_idx, active = s_idx[pix.long()], active[pix.long()]
        L, dx, dy, nrays = shade_lanes(arrays, s_idx, active)
        # one splat straight into the film, as the reference's photon step
        film = film_splat_lanes(film, L, pix, dx, dy, active.to(F32),
                                cfg.filter_type, cfg.aa_pixelwidth,
                                clamp_samples=cfg.aa_clamp_samples)
        return dict(film, rays=film["rays"] + nrays)

    sample_step.lanes = n
    return sample_step


def install_photon_maps(cscene, cfg: RenderConfig, arrays: dict,
                        mesh=None) -> dict:
    """build_photon_maps, with its packs added to the scene tensors as
    pm_diffuse / pm_caustic / pm_radiance (the sample step reads them
    there).  Returns the maps."""
    maps = build_photon_maps(cscene, cfg, arrays, mesh=mesh)
    for key in ("diffuse", "caustic", "radiance"):
        if maps[key] is not None:
            arrays[f"pm_{key}"] = maps[key]
    return maps


def _render(cscene, cfg: RenderConfig, device, warmup: bool, film_path=None,
            progress_cb=None, mesh=None) -> RenderResult:
    dev = mesh.device if mesh is not None else resolve_device(device)
    check_supported(cscene.static, cfg)
    arrays = to_tensors(cscene.arrays, dev)
    _sync(dev)
    t0 = time.perf_counter()
    maps = install_photon_maps(cscene, cfg, arrays, mesh=mesh)
    _sync(dev)
    preprocess_s = time.perf_counter() - t0
    step = make_photon_sample_step(cscene, cfg, maps, dev,
                                   pix=lane_pixels(mesh, cfg.width))
    flags = torch.ones((cfg.height, cfg.width), dtype=torch.bool, device=dev)
    if warmup:
        step(arrays, _fresh_film(cfg, dev), flags)
        _sync(dev)
    film = _fresh_film(cfg, dev)
    start_pass = 0
    stats = dict(lanes_traced=0)
    loaded = load_film(cfg, film_path, dev)
    if loaded is not None:
        # the photon maps are rebuilt at preprocess from the same seeds:
        # only the film's own planes resume
        lf, start_pass = loaded
        film = band_of({k: lf.get(k, v) for k, v in film.items()}, mesh)
    t1 = time.perf_counter()
    for p in range(start_pass, cfg.aa_passes):
        # adaptive passes as the reference runs them: the contrast
        # estimator, dense steps masked by its flags
        fl = flags if p == 0 else compute_aa_flags(
            sum_film(film, mesh, stats), cfg.aa_threshold,
            cfg.aa_dark_detection, cfg.aa_dark_factor,
            cfg.aa_detect_color_noise)
        for _ in range(cfg.aa_samples if p == 0 else cfg.aa_inc_samples):
            film = step(arrays, film, fl)
            stats["lanes_traced"] += step.lanes
        if progress_cb is not None:
            progress_cb(p + 1, cfg.aa_passes)
        if saves_passes(cfg, film_path):
            full = sum_film(film, mesh, stats)
            if writes(mesh):
                film_save(film_path, full, film_params(cfg), p + 1)
    _sync(dev)
    render_s = time.perf_counter() - t1
    film = finish(film, mesh, stats)
    return RenderResult(film, dict(
        stats, render_s=render_s, preprocess_s=preprocess_s,
        rays=float(film["rays"]), photon_maps=maps["info"]), cfg)


def render_photonmap(cscene, cfg: RenderConfig, *, device="cuda",
                     film_path=None, progress_cb=None,
                     mesh=None) -> RenderResult:
    """Full photon-mapping render: preprocess, then AA_minsamples steps
    and, where aa_passes > 1, adaptive passes of AA_inc_samples steps.
    stats: render_s (the steps), preprocess_s (photon shooting, packs and
    the radiance map), rays, photon_maps (counts per map), lanes_traced
    (the lanes of every step, summed).  Its film keeps
    no alpha or pass planes (as the reference's).  film_path: film
    save / load by pass as `render.render` (no autosave by time, as in the
    reference); progress_cb(pass done, aa_passes) after each pass.  mesh:
    a film mesh splits the photon lanes and the film rows (module
    docstring); stats then add rank_rays, reduce_s and mesh."""
    return _render(cscene, cfg, device, warmup=False, film_path=film_path,
                   progress_cb=progress_cb, mesh=mesh)


def render_photonmap_timed(cscene, cfg: RenderConfig, *, device="cuda",
                           mesh=None) -> RenderResult:
    """Benchmark variant: one warm-up step on a throw-away film after the
    preprocess, then the timed steps (the Mrays/s metric)."""
    return _render(cscene, cfg, device, warmup=True, mesh=mesh)
