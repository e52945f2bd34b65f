"""Render session helpers (port of `build_config`, `_auto_mesh` and
`render_scene` from libyafaray_tpu/scene/session.py).

Several devices render one film as ranks of a torch.distributed group, one
process a device (`parallel/`): inside an initialised group render_scene
splits the film over it; without one, n_devices > 1 starts that many local
ranks and returns rank 0's result.
"""
from __future__ import annotations

import os
import tempfile

import torch

from ..integrators.config import RenderConfig, config_from_params
from ..integrators.render import RenderResult
from .params import ParamMap
from .scene import Scene

SURFACE_INTEGRATORS = ("directlighting", "pathtracing", "photonmapping",
                       "SPPM", "bidirectional", "DebugIntegrator")


def build_config(scene: Scene) -> RenderConfig:
    surf = ParamMap()
    vol = ParamMap()
    want = scene.render_params.get_str("integrator_name", "")
    want_vol = scene.render_params.get_str("volintegrator_name", "")
    for name, p in scene.integrator_params.items():
        t = p.get_str("type", "")
        if name == want or (not want and t in SURFACE_INTEGRATORS and
                            not surf):
            if t in SURFACE_INTEGRATORS:
                surf = p
        if name == want_vol or (not want_vol and
                                t in ("EmissionIntegrator",
                                      "SingleScatterIntegrator",
                                      "SkyIntegrator", "none")):
            vol = p
    if not surf:
        for p in scene.integrator_params.values():
            if p.get_str("type", "") in SURFACE_INTEGRATORS:
                surf = p
                break
    return config_from_params(scene.render_params, surf, vol)


def available_devices(device) -> int:
    """Devices a render on `device` can take: the visible cards, or on the
    CPU one rank a core."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def n_devices_for(n_devices: int | None, device, height: int) -> int:
    """The reference's rule (`_auto_mesh`): None takes every visible card
    (on the CPU the process alone), 1 forces one device, N is clamped to
    the devices available, then lowered to the largest divisor of the
    height."""
    from ..parallel.mesh import auto_devices

    if n_devices is None and torch.device(device).type != "cuda":
        return 1
    return auto_devices(n_devices, height, available_devices(device))


def render_scene(scene: Scene, *, device="cuda", timed: bool = False,
                 pairs: bool = False, compact: bool = True, progress_cb=None,
                 film_path=None, n_devices: int | None = None
                 ) -> RenderResult:
    """The entry point: build the config, compile for `device` (default
    the card; it raises without one, device="cpu" renders on the CPU) and
    render with the scene's integrator (pathtracing and directlighting ->
    integrators.render, photonmapping -> integrators.photonmap, SPPM ->
    integrators.sppm, bidirectional -> integrators.veach, DebugIntegrator
    -> integrators.debug with its default "N" image).  timed=True takes
    the benchmark variants, which run one warm-up step (SPPM: pass)
    outside the timed ones (the DebugIntegrator has one variant).
    pairs=True asks for the pair-granular intersection route (packs of 64
    or more clusters take it).  compact=False runs the adaptive passes of
    pathtracing and directlighting dense and masked instead of over
    compact lane lists (the reference's photon mapping has no compact
    passes).  progress_cb(done, total) after each pass (BDPT: step) and
    film_path (film save / load and autosave as the scene's render
    parameters ask) go to every integrator that takes them, as the
    reference's: not the DebugIntegrator, and not the timed variants.

    Several devices (not the DebugIntegrator, as in the reference): inside
    an initialised process group of more than one rank the film rows split
    over the group (n_devices 1 renders the whole film on each rank), every
    rank on its device (`parallel.distributed.rank_device`) and every rank
    returning the full film.  Without a group, `n_devices_for` decides how
    many devices; above one, that many local ranks start (`spawn_ranks`,
    the kernels built first) and rank 0's result comes back, its film on
    `device`, progress_cb called here after the render for each pass that
    rank 0 reported."""
    from ..integrators import debug, photonmap, render, sppm, veach
    from ..integrators.engine import resolve_device
    from ..parallel import distributed as pd
    from ..parallel.mesh import make_device_mesh

    resolve_device(device)  # no card, no render: raise before compiling

    cfg = build_config(scene)
    runners = {
        "pathtracing": (render.render, render.render_timed),
        "directlighting": (render.render, render.render_timed),
        "photonmapping": (photonmap.render_photonmap,
                          photonmap.render_photonmap_timed),
        "SPPM": (sppm.render_sppm, sppm.render_sppm_timed),
        "bidirectional": (veach.render_bdpt, veach.render_bdpt_timed),
        "DebugIntegrator": (debug.render_debug, debug.render_debug),
    }
    if cfg.integrator not in runners:
        raise ValueError(f"unknown integrator {cfg.integrator!r}")
    run = runners[cfg.integrator][timed]
    kw = {}
    if not timed and run is not debug.render_debug:
        kw = {k: v for k, v in (("progress_cb", progress_cb),
                                ("film_path", film_path)) if v is not None}
    # only the adaptive pass loop takes the keyword, and only to turn
    # compaction off
    if not compact and run is render.render:
        kw["compact"] = False
    if run is not debug.render_debug:
        if pd.is_live():
            if n_devices != 1:
                mesh = make_device_mesh(height=cfg.height, device=device)
                kw["mesh"] = mesh
                device = mesh.device
        else:
            n = n_devices_for(n_devices, device, cfg.height)
            if n > 1:
                return _render_on_ranks(scene, n, device, timed, pairs,
                                        compact, progress_cb, film_path)
    return run(scene.compile(device=device, pairs=pairs), cfg, device=device,
               **kw)


def _rank_render(rank: int, scene: Scene, device, timed: bool, pairs: bool,
                 compact: bool, film_path, out: str) -> None:
    """One local rank of `_render_on_ranks`: render_scene inside the group;
    rank 0 saves the result (film on the host, stats, config, the passes
    it reported) to `out`."""
    done = []
    res = render_scene(scene, device=device, timed=timed, pairs=pairs,
                       compact=compact, film_path=film_path,
                       progress_cb=None if timed else
                       (lambda p, total: done.append((p, total))))
    if rank == 0:
        torch.save(dict(film={k: v.cpu() for k, v in res.film.items()},
                        stats=res.stats, cfg=res.cfg, progress=done), out)


def _render_on_ranks(scene: Scene, n: int, device, timed: bool, pairs: bool,
                     compact: bool, progress_cb, film_path) -> RenderResult:
    """render_scene over n local ranks (see render_scene)."""
    from ..parallel import distributed as pd

    if torch.device(device).type == "cuda":
        pd.prebuild_kernels()
    with tempfile.TemporaryDirectory(prefix="libyaf_render_") as d:
        out = os.path.join(d, "rank0.pt")
        pd.spawn_ranks(_rank_render, n, (scene, device, timed, pairs,
                                         compact, film_path, out),
                       device=device)
        # written by rank 0 of this call, just now
        got = torch.load(out, weights_only=False)
    if progress_cb is not None:
        for p, total in got["progress"]:
            progress_cb(p, total)
    return RenderResult({k: v.to(device) for k, v in got["film"].items()},
                        got["stats"], got["cfg"])
