"""Render orchestration (port of libyafaray_tpu/integrators/render.py:
`render`, the adaptive pass loop with its compact passes, the film's alpha
and pass planes, film save / load and autosave, without a device mesh, and
`render_timed`), for pathtracing, with its caustic photon map when
caustic_type is photon or both, and directlighting.

`device` (default "cuda", which raises without a card) threads from here
down: the scene tensors, the film and every lane live on it.  Timing
synchronizes the device before the clock is read.
"""
from __future__ import annotations

import time
from dataclasses import replace
from functools import partial

import numpy as np
import torch

from ..convert import to_tensors
from ..film.imagefilm import (compute_aa_flags, compute_stderr_flags,
                              film_alpha, film_image, film_init, film_load,
                              film_save)
from ..film.passes import extract_passes, film_add_passes
from ..scene.scene import CompiledScene
from .config import RenderConfig
from .engine import check_supported, make_sample_step, resolve_device


class RenderResult:
    def __init__(self, film: dict, stats: dict, cfg: RenderConfig):
        self.film = film
        # render_s (timed seconds of the sample steps or SPPM passes), rays
        # (film["rays"]); the photon renders add preprocess_s and
        # photon_maps (SPPM: photons)
        self.stats = stats
        # the render's config (the CLI reads color_space, gamma, sizes)
        self.cfg = cfg

    @property
    def image(self) -> np.ndarray:
        return film_image(self.film).cpu().numpy()

    @property
    def alpha(self):
        """(H, W) alpha plane, or None when the film carries none
        (bg_transp off, or an integrator that keeps none)."""
        a = film_alpha(self.film)
        return None if a is None else a.cpu().numpy()

    @property
    def passes(self) -> dict:
        """name -> (H, W, C) numpy planes of cfg.passes (film/passes.py)."""
        return extract_passes(self.film, self.cfg.passes)

    @property
    def mrays_per_sec(self) -> float:
        """Rays counted as film["rays"] (camera rays, shadow rays and live
        continuation rays) over the timed render seconds."""
        return self.stats["rays"] / max(self.stats["render_s"], 1e-9) / 1e6


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fresh_film(cfg: RenderConfig, device, with_variance: bool = False,
                with_alpha: bool = False) -> dict:
    f = film_init(cfg.height, cfg.width, device, with_alpha=with_alpha,
                  with_variance=with_variance)
    f["rays"] = torch.zeros((), dtype=torch.float32, device=device)
    return f


def film_params(cfg: RenderConfig) -> dict:
    """What a saved film's hash covers: the whole config, as the
    reference's."""
    return {"cfg": repr(cfg)}


def load_film(cfg: RenderConfig, film_path, device):
    """(film, pass to start from) of film_path under film_save_load "load"
    or "load-save", or None (no path, not asked, missing, or saved under
    another config)."""
    if cfg.film_save_load in ("load", "load-save") and film_path:
        return film_load(film_path, film_params(cfg), device)
    return None


def saves_passes(cfg: RenderConfig, film_path) -> bool:
    """Whether the film is saved after every pass: autosave by pass, or
    film_save_load "save" / "load-save"."""
    return bool(film_path) and (
        cfg.autosave_interval_type == "pass"
        or cfg.film_save_load in ("save", "load-save"))


def _setup(cscene: CompiledScene, cfg: RenderConfig, device):
    """(device, scene tensors, make_step, stats): SingleScatter's
    `optimize` attenuation grids (tensors vol_att_*) and the path tracer's
    caustic map, when its caustic_type asks for one (pm_caustic; stats:
    preprocess_s and photon_maps), are built here;
    make_step(cfg, compact_n=0) builds a sample step of the scene that
    adds the map's term."""
    dev = resolve_device(device)
    check_supported(cscene.static, cfg)
    arrays = to_tensors(cscene.arrays, dev)
    caustic, stats = None, {}
    if (cfg.vol_optimize and cscene.static.volumes
            and cfg.vol_integrator == "SingleScatterIntegrator"):
        # SingleScatter `optimize`: the per-(volume, light) attenuation
        # grids, baked once (reference attenuationGridMap)
        from ..volumes.integrate import build_attenuation_grids
        from .engine import shadow_transmission

        arrays.update(build_attenuation_grids(
            cscene.static.volumes, cscene.static, arrays, cfg,
            partial(shadow_transmission, arrays, cscene.static,
                    cfg.transp_shad)))
    if (cfg.integrator == "pathtracing"
            and cfg.caustic_type in ("photon", "both")):
        from .photonmap import build_caustic_map

        _sync(dev)
        t0 = time.perf_counter()
        cmap = build_caustic_map(cscene, cfg, arrays)
        _sync(dev)
        stats["preprocess_s"] = time.perf_counter() - t0
        if cmap is not None:
            arrays["pm_caustic"], c_radius, c_nem, stored = cmap
            caustic = (c_radius, c_nem)
            stats["photon_maps"] = dict(caustic=dict(
                emitted=c_nem, stored=stored, radius=c_radius))
    return dev, arrays, partial(make_sample_step, cscene.static,
                                cscene.camera, device=dev,
                                caustic=caustic), stats


def _pass_steps(cfg: RenderConfig, p: int) -> int:
    """Steps of pass p: ceil(AA_minsamples / spb) in pass 0, then
    ceil(AA_inc_samples / spb) scaled by AA_sample_multiplier_factor^p."""
    spb = max(1, cfg.spp_batch)
    if p == 0:
        return -(-cfg.aa_samples // spb)
    return max(1, round(-(-cfg.aa_inc_samples // spb)
                        * cfg.aa_sample_multiplier_factor ** p))


def pass_config(cfg: RenderConfig, p: int) -> RenderConfig:
    """Pass p's config: the NEE sample counts of adaptive pass p scaled by
    the light and indirect multiplier factors^p (reference
    setSampleMultiplier)."""
    f_light = cfg.aa_light_sample_multiplier_factor
    f_ind = cfg.aa_indirect_sample_multiplier_factor
    if p == 0 or (f_light == 1.0 and f_ind == 1.0):
        return cfg
    return replace(cfg, light_ns_mult=f_light ** p,
                   indirect_ns_mult=f_ind ** p)


def adaptive_flags(film: dict, cfg: RenderConfig) -> torch.Tensor:
    """(H, W) bool pixels the next adaptive pass resamples: the variance
    or the contrast estimator, its threshold scaled by 1 / the mean primary
    samplingFactor where the film records it."""
    scale = None
    if "aov_samp_factor" in film:
        sfac = film["aov_samp_factor"][..., 0] / torch.clamp(
            film["nsamples"], min=1).to(torch.float32)
        scale = 1.0 / torch.clamp(sfac, min=1e-3)
    if cfg.aa_estimator == "variance":
        return compute_stderr_flags(film, cfg.aa_threshold,
                                    threshold_scale=scale)
    return compute_aa_flags(film, cfg.aa_threshold, cfg.aa_dark_detection,
                            cfg.aa_dark_factor, cfg.aa_detect_color_noise,
                            threshold_scale=scale)


def compact_bucket(nf: int) -> int:
    """Lanes of the compact pass over nf flagged pixels: 512·2^k >= nf."""
    nc = 512
    while nc < nf:
        nc *= 2
    return nc


def compact_lanes(flags: torch.Tensor, nf: int) -> torch.Tensor:
    """The compact pass's lane list: the nf flagged pixels' flat ids, padded
    with -1 (dead lanes) to its bucket."""
    pix = torch.full((compact_bucket(nf),), -1, dtype=torch.int32,
                     device=flags.device)
    pix[:nf] = torch.nonzero(flags.reshape(-1))[:, 0].to(torch.int32)
    return pix


def render(cscene: CompiledScene, cfg: RenderConfig, *, device="cuda",
           compact: bool = True, film_path=None,
           progress_cb=None) -> RenderResult:
    """Full render: aa_passes passes (reference imagefilm adaptive AA).
    Pass 0 runs ceil(AA_minsamples / spp_batch) steps over every pixel;
    each later pass flags pixels by the estimator (`adaptive_flags`),
    stops the render when none is flagged, and runs its steps over the
    flagged pixels: with compact=True, while the bucket of nc >= flagged
    lanes is at most half the pixels, through the compact step (one built
    per bucket, and per pass where the multipliers change the NEE counts),
    else the dense step masked by the flags.  stats: render_s, rays,
    passes, and pass_log, a (flagged, lanes, "compact" or "dense", steps,
    wall_s) entry per pass run.

    The film carries an alpha plane with bg_transp and the planes of
    cfg.passes.  film_path: with film_save_load "load" / "load-save" a film
    saved there under the same config resumes (its passes are not run
    again); "save" / "load-save" or autosave by pass save it after every
    pass, autosave by time between steps (with the pass it is in).
    progress_cb(pass done, aa_passes) after each pass."""
    dev, arrays, make_step, stats = _setup(cscene, cfg, device)
    step = make_step(cfg)
    film = _fresh_film(cfg, dev, with_alpha=cfg.transp_background,
                       with_variance=(cfg.aa_passes > 1
                                      and cfg.aa_estimator == "variance"))
    if cfg.passes:
        film = film_add_passes(film, cfg.height, cfg.width, cfg.passes, dev)
    if cfg.aa_passes > 1 and cscene.static.has_sampling_factor:
        # the primary hit's samplingFactor, summed per sample, scales the
        # adaptive threshold
        film.setdefault("aov_samp_factor", torch.zeros(
            (cfg.height, cfg.width, 1), dtype=torch.float32, device=dev))
    start_pass = 0
    loaded = load_film(cfg, film_path, dev)
    if loaded is not None:
        film, start_pass = loaded
    params = film_params(cfg)
    n_px = cfg.height * cfg.width
    compact_steps: dict = {}
    log = []
    t0 = time.perf_counter()
    for p in range(start_pass, cfg.aa_passes):
        cfg_p = pass_config(cfg, p)
        if p > 0 and cfg_p is not cfg:
            step = make_step(cfg_p)
        flags = (torch.ones((cfg.height, cfg.width), dtype=torch.bool,
                            device=dev) if p == 0
                 else adaptive_flags(film, cfg))
        run, arg, nf, lanes = step, flags, n_px, n_px
        if p > 0:
            nf = int(flags.sum())
            if nf == 0:
                break  # nothing left to resample
            nc = compact_bucket(nf)
            if compact and nc <= n_px // 2:
                key = (nc, p if cfg_p is not cfg else 0)
                if key not in compact_steps:
                    compact_steps[key] = make_step(cfg_p, compact_n=nc)
                run, arg, lanes = (compact_steps[key],
                                   compact_lanes(flags, nf), nc)
        t_p = last_save = time.perf_counter()
        n_steps = _pass_steps(cfg, p)
        for _ in range(n_steps):
            film = run(arrays, film, arg)
            if (cfg.autosave_interval_type == "time" and film_path
                    and time.perf_counter() - last_save
                    > cfg.autosave_interval):
                film_save(film_path, film, params, p)
                last_save = time.perf_counter()
        _sync(dev)
        log.append(dict(flagged=nf, lanes=lanes,
                        mode="compact" if run is not step else "dense",
                        steps=n_steps, wall_s=time.perf_counter() - t_p))
        if progress_cb is not None:
            progress_cb(p + 1, cfg.aa_passes)
        if saves_passes(cfg, film_path):
            film_save(film_path, film, params, p + 1)
    return RenderResult(film, dict(
        stats, render_s=time.perf_counter() - t0, rays=float(film["rays"]),
        passes=cfg.aa_passes, pass_log=log), cfg)


def render_timed(cscene: CompiledScene, cfg: RenderConfig, *,
                 device="cuda") -> RenderResult:
    """Benchmark render: one warm-up step on a throw-away film, then
    ceil(AA_minsamples·AA_passes / spp_batch) timed steps over every pixel
    (the Mrays/s metric; adaptive passes run uniform, as the reference's
    benchmark render runs them).  Its film is the reference's plain one:
    no alpha or pass planes, so no work for them."""
    dev, arrays, make_step, stats = _setup(cscene, cfg, device)
    step = make_step(cfg)
    flags = torch.ones((cfg.height, cfg.width), dtype=torch.bool, device=dev)
    step(arrays, _fresh_film(cfg, dev), flags)
    _sync(dev)
    film = _fresh_film(cfg, dev)
    t0 = time.perf_counter()
    for _ in range(-(-cfg.aa_samples * cfg.aa_passes
                     // max(1, cfg.spp_batch))):
        film = step(arrays, film, flags)
    _sync(dev)
    return RenderResult(film, dict(stats, render_s=time.perf_counter() - t0,
                                   rays=float(film["rays"]), passes=1), cfg)
