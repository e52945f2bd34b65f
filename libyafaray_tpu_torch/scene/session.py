"""Render session helpers (port of `build_config` and `render_scene` from
libyafaray_tpu/scene/session.py, one device)."""
from __future__ import annotations

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


def render_scene(scene: Scene, *, device="cuda", timed: bool = False,
                 pairs: bool = False, compact: bool = True, progress_cb=None,
                 film_path=None) -> RenderResult:
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
    reference's: not the DebugIntegrator, and not the timed variants."""
    from ..integrators import debug, photonmap, render, sppm, veach
    from ..integrators.engine import resolve_device

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
    return run(scene.compile(device=device, pairs=pairs), cfg, device=device,
               **kw)
