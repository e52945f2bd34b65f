"""Render orchestration (port of libyafaray_tpu/integrators/render.py:
`render` for one pass without mesh or film save, and `render_timed`), for
pathtracing, with its caustic photon map when caustic_type is photon or
both, and directlighting.

`device` (default "cuda", which raises without a card) threads from here
down: the scene tensors, the film and every lane live on it.  Timing
synchronizes the device before the clock is read.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..convert import to_tensors
from ..film.imagefilm import film_image, film_init
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
    def mrays_per_sec(self) -> float:
        """Rays counted as film["rays"] (camera rays, shadow rays and live
        continuation rays) over the timed render seconds."""
        return self.stats["rays"] / max(self.stats["render_s"], 1e-9) / 1e6


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fresh_film(cfg: RenderConfig, device) -> dict:
    f = film_init(cfg.height, cfg.width, device)
    f["rays"] = torch.zeros((), dtype=torch.float32, device=device)
    return f


def _setup(cscene: CompiledScene, cfg: RenderConfig, device):
    """(device, scene tensors, sample step, stats): the path tracer's
    caustic map, when its caustic_type asks for one, is built here and
    rides in the tensors as pm_caustic (stats: preprocess_s and
    photon_maps)."""
    dev = resolve_device(device)
    check_supported(cscene.static, cfg)
    arrays = to_tensors(cscene.arrays, dev)
    caustic, stats = None, {}
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
    step = make_sample_step(cscene.static, cscene.camera, cfg, dev,
                            caustic=caustic)
    return dev, arrays, step, stats


def _render(cscene, cfg: RenderConfig, device, warmup: bool) -> RenderResult:
    dev, arrays, step, stats = _setup(cscene, cfg, device)
    flags = torch.ones((cfg.height, cfg.width), dtype=torch.bool, device=dev)
    if warmup:
        step(arrays, _fresh_film(cfg, dev), flags)
        _sync(dev)
    film = _fresh_film(cfg, dev)
    t0 = time.perf_counter()
    for _ in range(cfg.aa_samples):
        film = step(arrays, film, flags)
    _sync(dev)
    return RenderResult(film, dict(stats, render_s=time.perf_counter() - t0,
                                   rays=float(film["rays"])), cfg)


def render(cscene: CompiledScene, cfg: RenderConfig, *,
           device="cuda") -> RenderResult:
    """Full render: aa_samples one-sample steps over every pixel."""
    return _render(cscene, cfg, device, warmup=False)


def render_timed(cscene: CompiledScene, cfg: RenderConfig, *,
                 device="cuda") -> RenderResult:
    """Benchmark render: one warm-up step on a throw-away film, then the
    timed steps (the Mrays/s metric)."""
    return _render(cscene, cfg, device, warmup=True)
