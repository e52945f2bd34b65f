"""SPPM, stochastic progressive photon mapping (port of
libyafaray_tpu/integrators/sppm.py, over one device or a film mesh, with
its film save / load).

Per pass:
  eye pass    the camera rays follow specular chains (and rough glass, the
              reference's other chain family) up to raydepth
              and store one hit point per pixel at the first diffuse hit
              (position, normal, throughput, ρ/π); NEE at every vertex
              (full light sample counts, static QMC dims, no MIS) and the
              background and emission go to the film as ordinary samples
  photon pass one `indirect` photon pass (photon_shoot: no store straight
              from the light, the eye pass has that by NEE), compacted on
              the device and packed; each hit point gathers the photons
              within its current radius (`density_auto`)
  update      per pixel R²' = R²·(N+αM)/(N+M), τ' = (τ+Φ)·same,
              N' = N+αM (`flux_update`, α = sppm_alpha)

After the last pass the film's density layer holds τ/(πR²·photons emitted).
A saved film carries the progressive state beside the film (sppm_r2,
sppm_n, sppm_tau, sppm_nem: photons emitted so far), so a resumed render
goes on with pass p's photon stream.
The eye pass's QMC stream is its own: the pixel hash carries no qmc_seed,
each dim is drawn by `qmc.sample_dim`'s values and a vertex's key is
hash_combine(pixel hash, bounce); photon pass p is seeded 31337 + p.

On a film mesh (`parallel/mesh.py`) a rank's eye pass traces the pixels of
its band of rows and keeps their hit points and R², N, τ; each photon pass
splits its lanes and gathers the stored photons in lane order, so every
rank gathers from the one-device pack; the photons emitted count all
lanes.  The density layer and the film are the ranks' partials summed.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..backgrounds.base import eval_background
from ..convert import to_tensors
from ..core import qmc
from ..core.sampling import INV_PI
from ..film.imagefilm import (add_density, film_init, film_save,
                              film_splat_lanes)
from ..materials import bsdf
from ..materials.base import gather_rows
from ..ops.photon_flash import density_auto, make_photon_pack_auto
from .config import RenderConfig
from .engine import (F32, _direct_lighting, _make_mat_resolve,
                     _surface_point, bounce_key, camera_rays, check_arrays,
                     check_supported, closest_hit, is_diffuse_family,
                     pixel_lanes, pixel_of, ray_bounds, resolve_device,
                     shading_frame, uses_textures)
from .photon_shoot import make_photon_pass
from .photonmap import MAX_PHOTON_LANES, _light_cdf, compact_photons_device
from ..parallel import distributed as pd
from ..parallel.mesh import (at_pixels, band_of, finish, lane_pixels,
                             sum_film, writes)
from .render import (RenderResult, _sync, film_params, load_film,
                     saves_passes)


def make_eye_pass(cscene, cfg: RenderConfig, device,
                  pix: torch.Tensor | None = None):
    """eye_pass(arrays, film) -> (film, hitpoints): one sample per pixel
    splatted into the film (and its rays counted), and the pixels' hit
    points: pos, normal, tp, fd (N,3) and valid (N,) bool.  A pixel that
    stores nothing keeps pos = normal = tp = fd = 0.  pix: the flat pixel
    ids of the lanes (a rank's band), None for every pixel."""
    static = cscene.static
    dev = resolve_device(device)
    h, w = cfg.height, cfg.width
    px, py, pixel_hash = (pixel_lanes(h, w, 0, dev) if pix is None
                          else pixel_of(pix, w, 0))  # no qmc_seed
    n = px.shape[0]
    ones = torch.ones((n,), dtype=F32, device=dev)
    # textures apply only to the children of composites, inside NEE (as
    # in the reference's eye pass)
    child_tex = bool(static.has_blend and static.blend_child_textured
                     and uses_textures(static))

    def eye_pass(arrays: dict, film: dict):
        check_arrays(arrays, dev)
        s_idx = film["nsamples"].reshape(-1)
        if pix is not None:
            s_idx = s_idx[pix.long()]
        dx, dy, org, dirn, wt = camera_rays(cscene.camera, px, py,
                                            pixel_hash, s_idx)
        mats = arrays["materials"]
        L = torch.zeros((n, 3), dtype=F32, device=dev)
        throughput = torch.ones((n, 3), dtype=F32, device=dev)
        alive = wt > 0.0
        stored = torch.zeros((n,), dtype=torch.bool, device=dev)
        hp = {k: torch.zeros((n, 3), dtype=F32, device=dev)
              for k in ("pos", "normal", "tp", "fd")}
        nrays = alive.to(F32).sum()
        for bounce in range(cfg.raydepth + 1):
            hit = closest_hit(arrays, static, org, dirn,
                              *ray_bounds(static, alive))
            escape = alive & ~hit.hit
            L = L + torch.where(escape[..., None],
                                throughput * eval_background(
                                    static.bg, arrays.get("bg_image"), dirn),
                                0.0)
            alive = alive & hit.hit
            sp = _surface_point(arrays, hit, org, dirn, tex=child_tex)
            wo = -dirn
            row = gather_rows(mats, sp["mat"].long())
            L = L + torch.where(alive[..., None],
                                throughput * bsdf.emission(row, sp["ng"], wo),
                                0.0)
            n_sh, ng_sh = shading_frame(sp, wo)
            here = alive & is_diffuse_family(row["mtype"]) & ~stored

            bdim = qmc.bounce_dim(bounce, 0)
            skey_b = bounce_key(pixel_hash, bounce)
            Ld, sh_rays = _direct_lighting(
                arrays, static, cfg, sp["p"], n_sh, ng_sh, row, wo, s_idx,
                skey_b, bdim, True, True, here, mis_with_bsdf=False,
                resolve=_make_mat_resolve(arrays, static,
                                          dict(sp, n=n_sh, ng=ng_sh)))
            L = L + torch.where(here[..., None], throughput * Ld, 0.0)
            nrays = nrays + sh_rays * here.to(F32).sum()

            f_d = (row["diffuse_reflect"][..., None] * row["diffuse_color"]
                   * INV_PI)
            m3 = here[..., None]
            for k, v in (("pos", sp["p"]), ("normal", n_sh),
                         ("tp", throughput), ("fd", f_d)):
                hp[k] = torch.where(m3, v, hp[k])
            stored = stored | here
            if bounce == cfg.raydepth:
                break
            u1, u2 = qmc.sample_dim_pair(s_idx, bdim + qmc.SLOT_BSDF_U,
                                         skey_b)
            ul = qmc.sample_dim(s_idx, bdim + qmc.SLOT_LIGHT_PICK, skey_b)
            smp = bsdf.sample_bsdf(row, n_sh, ng_sh, wo, u1, u2, ul,
                                   static.mat_families)
            alive = alive & smp["chain"] & smp["valid"] & ~stored
            throughput = throughput * smp["tp"]
            off = torch.where(smp["transmit"], -1.0, 1.0)[..., None]
            org = sp["p"] + ng_sh * off * static.shadow_bias
            dirn = smp["wi"]
            nrays = nrays + alive.to(F32).sum()

        L = L * wt[..., None]
        film = film_splat_lanes(film, L, pix, dx, dy, ones, cfg.filter_type,
                                cfg.aa_pixelwidth)
        return dict(film, rays=film["rays"] + nrays), dict(hp, valid=stored)

    eye_pass.lanes = n
    return eye_pass


def flux_update(hitpoints: dict, pack: dict, r2, n_acc, tau, alpha: float):
    """Gather one pass's photons into the hit points and apply the
    progressive update.  Each hit point gathers within sqrt(r2) (the
    kernels square it again, as the reference's do); its photon count M
    counts only at a stored hit point.  Returns (r2, n_acc, tau)."""
    flux, m = density_auto(pack, hitpoints["pos"], hitpoints["normal"],
                           torch.sqrt(r2))
    m = torch.where(hitpoints["valid"], m, 0.0)
    # the hit point's BSDF is Lambertian: f = fd (ρ/π)
    tau_add = flux * hitpoints["fd"] * hitpoints["tp"]
    ratio = torch.where(n_acc + m > 0,
                        (n_acc + alpha * m)
                        / torch.clamp(n_acc + m, min=1e-6), 1.0)
    return (r2 * ratio, n_acc + alpha * m,
            (tau + tau_add) * ratio[..., None])


def make_sppm_pass(cscene, cfg: RenderConfig, device, mesh=None):
    """(fresh, sppm_pass): fresh() -> the state before the first pass, a
    dict of film, r2 (the initial radius squared), n_acc and tau (zero);
    sppm_pass(arrays, state, p) -> (state after pass p, the photons pass p
    stored, a device scalar).  The first pass reads its stored count once,
    for the compaction's capacity (1.3 times it, in 4096s), and every
    later pass keeps it.  On a mesh of more than one rank r2, n_acc and
    tau are its band's pixels' (sppm_pass.pix, their flat ids) and the
    photon lanes split (`make_photon_pass`)."""
    static = cscene.static
    dev = mesh.device if mesh is not None else resolve_device(device)
    check_supported(static, cfg)
    h, w = cfg.height, cfg.width
    pix = lane_pixels(mesh, w)
    n = h * w if pix is None else pix.shape[0]
    cdf, _ = _light_cdf(static, cscene.arrays["lights"])
    if cfg.sppm_initial_radius > 0:
        r0 = cfg.sppm_initial_radius
    else:  # the pixel footprint: twice the scene diagonal over the film
        diag = float(np.linalg.norm(np.asarray(cscene.bound_max)
                                    - np.asarray(cscene.bound_min)))
        r0 = diag / max(h, w) * 2.0
    eye = make_eye_pass(cscene, cfg, dev, pix)
    lanes = min(MAX_PHOTON_LANES,
                max(4096, -(-cfg.sppm_photons // 4096) * 4096))
    shoot = make_photon_pass(static, cfg, lanes, cfg.photon_bounces,
                             "indirect", mesh=mesh)
    cap = []

    def fresh() -> dict:
        film = film_init(h, w, dev)
        film["rays"] = torch.zeros((), dtype=F32, device=dev)
        return dict(film=film,
                    r2=torch.full((n,), r0 * r0, dtype=F32, device=dev),
                    n_acc=torch.zeros((n,), dtype=F32, device=dev),
                    tau=torch.zeros((n, 3), dtype=F32, device=dev))

    def sppm_pass(arrays: dict, state: dict, p: int):
        film, hitpoints = eye(arrays, state["film"])
        rec = shoot(arrays, cdf, 31337 + p)
        if not cap:
            n_stored = int(rec["valid"].sum())
            cap.append(max(4096, -(-int(n_stored * 1.3) // 4096) * 4096))
        c = compact_photons_device(rec, cap[0])
        pack = make_photon_pack_auto(c["pos"], c["valid"], c["dir"],
                                     c["power"])
        r2, n_acc, tau = flux_update(hitpoints, pack, state["r2"],
                                     state["n_acc"], state["tau"],
                                     cfg.sppm_alpha)
        return (dict(film=film, r2=r2, n_acc=n_acc, tau=tau),
                rec["valid"].sum())

    sppm_pass.lanes = lanes
    sppm_pass.cap = cap
    sppm_pass.pix = pix
    sppm_pass.eye_lanes = eye.lanes
    return fresh, sppm_pass


def _save(film_path, cfg: RenderConfig, state: dict, emitted: int,
          p: int) -> None:
    """The film and the progressive state, as the reference saves them."""
    film_save(film_path, dict(state["film"], sppm_r2=state["r2"],
                              sppm_n=state["n_acc"], sppm_tau=state["tau"],
                              sppm_nem=np.asarray(emitted)),
              film_params(cfg), p)


def _full_state(state: dict, pix, mesh, stats: dict) -> dict:
    """The film summed over the mesh and the progressive state of every
    pixel (each rank's band scattered into zeros, then summed), as saved."""
    if pix is None:
        return state
    out = dict(film=sum_film(state["film"], mesh, stats))
    n_px = state["film"]["w"].numel()
    for k in ("r2", "n_acc", "tau"):
        out[k] = pd.all_reduce_sum(at_pixels(state[k], pix, n_px))
    return out


def _resume(cfg: RenderConfig, film_path, dev, state: dict, pix, mesh):
    """(state, photons emitted, first pass) of a saved SPPM film, or None;
    on a mesh, this rank's band of it."""
    loaded = load_film(cfg, film_path, dev)
    if loaded is None:
        return None
    lf, start = loaded
    st = dict(r2=lf.pop("sppm_r2"), n_acc=lf.pop("sppm_n"),
              tau=lf.pop("sppm_tau"))
    emitted = int(lf.pop("sppm_nem"))
    film = {k: lf.get(k, v) for k, v in state["film"].items()}
    if pix is not None:
        st = {k: v[pix.long()] for k, v in st.items()}
        film = band_of(film, mesh)
    st["film"] = film
    return st, emitted, start


def _render(cscene, cfg: RenderConfig, device, warmup: bool, film_path=None,
            progress_cb=None, mesh=None) -> RenderResult:
    dev = mesh.device if mesh is not None else resolve_device(device)
    fresh, sppm_pass = make_sppm_pass(cscene, cfg, dev, mesh=mesh)
    pix = sppm_pass.pix
    arrays = to_tensors(cscene.arrays, dev)
    if warmup:
        sppm_pass(arrays, fresh(), 0)
        _sync(dev)
    state, stored, emitted, start = fresh(), [], 0, 0
    resumed = _resume(cfg, film_path, dev, state, pix, mesh)
    if resumed is not None:
        state, emitted, start = resumed
    stats = dict(lanes_traced=0)
    t1 = time.perf_counter()
    for p in range(start, cfg.sppm_passes):
        state, n_stored = sppm_pass(arrays, state, p)
        stored.append(n_stored)
        stats["lanes_traced"] += sppm_pass.eye_lanes
        emitted += sppm_pass.lanes
        if progress_cb is not None:
            progress_cb(p + 1, cfg.sppm_passes)
        if saves_passes(cfg, film_path):
            full = _full_state(state, pix, mesh, stats)
            if writes(mesh):
                _save(film_path, cfg, full, emitted, p + 1)
    _sync(dev)
    render_s = time.perf_counter() - t1
    # density layer: τ/(πR²·photons emitted); the direct part is the film
    dens = state["tau"] / (torch.clamp(state["r2"], min=1e-12)[..., None]
                           * np.pi * float(max(emitted, 1)))
    # on a mesh, this rank's band of the layer (zero elsewhere), then sums
    film = finish(add_density(state["film"], at_pixels(
        dens, pix, cfg.height * cfg.width).reshape(cfg.height, cfg.width,
                                                   3)), mesh, stats)
    return RenderResult(film, dict(
        stats, render_s=render_s, rays=float(film["rays"]),
        passes=cfg.sppm_passes,
        photons=dict(lanes=sppm_pass.lanes, emitted=emitted,
                     cap=sppm_pass.cap[0] if sppm_pass.cap else 0,
                     stored=[int(x) for x in stored])), cfg)


def render_sppm(cscene, cfg: RenderConfig, *, device="cuda", film_path=None,
                progress_cb=None, mesh=None) -> RenderResult:
    """Full SPPM render: sppm_passes passes.  stats: render_s (the
    passes), rays (the eye passes' film["rays"]; photons are not rays),
    passes, photons (lanes a pass, emitted in all, the compaction cap,
    stored a pass run), lanes_traced (the eye passes' lanes, summed).  Its
    film keeps no alpha or pass planes (as the
    reference's).  film_path: the film and the progressive state saved
    after every pass under film_save_load "save" / "load-save" or autosave
    by pass, and resumed under "load" / "load-save";
    progress_cb(pass done, sppm_passes) after each pass.  mesh: a film mesh
    splits the film rows and the photon lanes (module docstring); stats
    then add rank_rays, reduce_s and mesh."""
    return _render(cscene, cfg, device, warmup=False, film_path=film_path,
                   progress_cb=progress_cb, mesh=mesh)


def render_sppm_timed(cscene, cfg: RenderConfig, *, device="cuda",
                      mesh=None) -> RenderResult:
    """Benchmark variant: one warm-up pass (pass 0 on throw-away state)
    before the timed passes."""
    return _render(cscene, cfg, device, warmup=True, mesh=mesh)
