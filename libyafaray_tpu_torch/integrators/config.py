"""Render/integrator configuration (a frozen, hashable value passed down the
render).

Collects the reference's <render> block + surface/volume integrator params
(SURVEY §2.10/§2.11, App. A) into one frozen dataclass.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..scene.params import ParamMap


@dataclass(frozen=True)
class RenderConfig:
    width: int = 512
    height: int = 512
    # adaptive AA (imagefilm)
    aa_passes: int = 1
    aa_samples: int = 1  # minsamples, pass 0
    aa_inc_samples: int = 1
    aa_threshold: float = 0.05
    aa_pixelwidth: float = 1.5
    filter_type: str = "box"
    # noise estimator for adaptive passes: "contrast" = the reference's
    # neighbor-delta detection; "variance" = per-pixel stderr from the
    # film's second-moment plane (TPU-first extension — can target a
    # global RMSE level, where contrast re-flags true edges forever)
    aa_estimator: str = "contrast"
    aa_dark_detection: str = "none"
    aa_dark_factor: float = 1.0
    aa_detect_color_noise: bool = False
    aa_clamp_samples: float = 0.0
    aa_clamp_indirect: float = 0.0
    # per-pass sample-multiplier factors (reference imagefilm
    # setSampleMultiplier: each adaptive pass multiplies its sampling
    # effort by these).  aa factor scales the pass's added sample steps;
    # light/indirect factors scale the NEE sample counts, materialized
    # into light_ns_mult/indirect_ns_mult per pass by render()
    aa_sample_multiplier_factor: float = 1.0
    aa_light_sample_multiplier_factor: float = 1.0
    aa_indirect_sample_multiplier_factor: float = 1.0
    light_ns_mult: float = 1.0     # internal: current pass multiplier
    indirect_ns_mult: float = 1.0  # internal: current pass multiplier
    # global sampler decorrelation seed (XORed into the per-pixel Owen
    # scramble key) — independent renders of the same scene; used by
    # scripts/bench_time_to_rmse.py for an uncorrelated golden
    qmc_seed: int = 0
    # integrator selection + shared
    integrator: str = "directlighting"
    raydepth: int = 5
    shadow_depth: int = 5
    transp_shad: bool = False
    transp_background: bool = False
    # transparent background through refracted specular chains + output
    # alpha premultiply (reference render params bg_transp_refract /
    # premult, imageOutput alpha handling)
    bg_transp_refract: bool = False
    premult_alpha: bool = False
    # pathtracing
    path_samples: int = 1
    bounces: int = 4
    rr_min_bounces: int = 3
    caustic_type: str = "path"
    no_recursive: bool = False
    # AO
    do_ao: bool = False
    ao_samples: int = 8
    ao_distance: float = 1.0
    ao_color: tuple = (0.9, 0.9, 0.9)
    # photon mapping
    photons: int = 500000
    caustic_photons: int = 500000
    diffuse_radius: float = 0.1
    caustic_radius: float = 0.1
    photon_search: int = 50
    caustic_mix: int = 50
    final_gather: bool = True
    fg_samples: int = 32
    fg_bounces: int = 2
    photon_bounces: int = 5
    # SPPM
    sppm_passes: int = 8
    sppm_photons: int = 300000
    sppm_initial_radius: float = 0.0  # 0 = estimate from pixel footprint
    sppm_alpha: float = 0.7
    sppm_search: int = 100
    # volume integrator
    vol_integrator: str = "none"
    vol_step_size: float = 0.1
    vol_adaptive: bool = False
    vol_optimize: bool = False
    # output
    color_space: str = "sRGB"
    gamma: float = 1.0
    # output-stage denoise (reference v3 imageHandler CImg NLM knobs,
    # SURVEY §2.12 [L]; film/denoise.py jitted non-local means)
    denoise: bool = False
    denoise_h_lum: float = 5.0
    denoise_h_col: float = 5.0
    denoise_mix: float = 0.8
    z_channel: bool = False
    passes: tuple = ()  # render pass names (film/passes.py)
    # film persistence
    film_save_load: str = "none"  # none|save|load-save
    autosave_interval_type: str = "none"  # none|pass|time
    autosave_interval: float = 300.0
    background_name: str = ""
    tiles_order: str = "linear"
    threads: int = -1
    # wavefront tuning: samples per pixel advanced per jitted step
    # (amortizes kernel-launch overhead; lanes = H*W*spp_batch)
    spp_batch: int = 1


def _collect_passes(render: ParamMap) -> tuple:
    """Pass selection: `render_passes` space-separated names, plus the
    reference's z_channel flag; unknown names warn+ignore downstream."""
    names = tuple(render.get_str("render_passes", "").split())
    if render.get_bool("z_channel", False) and "z-depth-norm" not in names:
        names = names + ("z-depth-norm",)
    return names


def config_from_params(render: ParamMap, integ: ParamMap,
                       vol_integ: ParamMap | None = None) -> RenderConfig:
    itype = integ.get_str("type", "directlighting")
    vol = vol_integ or ParamMap()
    # AA controls live in the render block (reference imageFilm params);
    # accept them on the integrator too, render block winning — upstream
    # scenes/tests set them in either place.
    aa_p = render.get_int("AA_passes", integ.get_int("AA_passes", 1))
    aa_s = render.get_int("AA_minsamples",
                          integ.get_int("AA_minsamples", 1))
    aa_i = render.get_int("AA_inc_samples",
                          integ.get_int("AA_inc_samples", 1))
    aa_t = render.get_float("AA_threshold",
                            integ.get_float("AA_threshold", 0.05))
    return RenderConfig(
        width=render.get_int("width", 512),
        height=render.get_int("height", 512),
        aa_passes=max(1, aa_p),
        aa_samples=max(1, aa_s),
        aa_inc_samples=max(1, aa_i),
        aa_threshold=aa_t,
        aa_pixelwidth=render.get_float("AA_pixelwidth", 1.5),
        filter_type=render.get_str("filter_type", "box").lower(),
        aa_estimator=render.get_str(
            "AA_estimator",
            integ.get_str("AA_estimator", "contrast")).lower(),
        aa_dark_detection=render.get_str("AA_dark_detection_type", "none"),
        aa_dark_factor=render.get_float("AA_dark_threshold_factor", 1.0),
        aa_detect_color_noise=render.get_bool("AA_detect_color_noise", False),
        aa_clamp_samples=render.get_float("AA_clamp_samples", 0.0),
        aa_clamp_indirect=render.get_float("AA_clamp_indirect", 0.0),
        aa_sample_multiplier_factor=render.get_float(
            "AA_sample_multiplier_factor", 1.0),
        aa_light_sample_multiplier_factor=render.get_float(
            "AA_light_sample_multiplier_factor", 1.0),
        aa_indirect_sample_multiplier_factor=render.get_float(
            "AA_indirect_sample_multiplier_factor", 1.0),
        qmc_seed=render.get_int("qmc_seed", 0),
        integrator=itype,
        raydepth=integ.get_int("raydepth", 5),
        shadow_depth=integ.get_int("shadowDepth", 5),
        transp_shad=integ.get_bool("transpShad", False),
        transp_background=render.get_bool("bg_transp", False),
        bg_transp_refract=render.get_bool("bg_transp_refract", False),
        premult_alpha=render.get_bool(
            "premult", render.get_bool("alpha_premultiply", False)),
        path_samples=max(1, integ.get_int("path_samples", 32)),
        bounces=integ.get_int("bounces", 4),
        rr_min_bounces=integ.get_int("russian_roulette_min_bounces", 3),
        caustic_type=integ.get_str("caustic_type", "path"),
        no_recursive=integ.get_bool("no_recursive", False),
        do_ao=integ.get_bool("do_AO", False),
        ao_samples=max(1, integ.get_int("AO_samples", 8)),
        ao_distance=integ.get_float("AO_distance", 1.0),
        ao_color=tuple(integ.get_rgb("AO_color", (0.9, 0.9, 0.9))),
        photons=integ.get_int("photons", 500000),
        caustic_photons=integ.get_int("cPhotons",
                                      integ.get_int("photons", 500000)),
        diffuse_radius=integ.get_float("diffuseRadius", 0.1),
        caustic_radius=integ.get_float("causticRadius", 0.1),
        photon_search=integ.get_int("search", 50),
        caustic_mix=integ.get_int("caustic_mix", 50),
        final_gather=integ.get_bool("finalGather", True),
        fg_samples=integ.get_int("fg_samples", 32),
        fg_bounces=integ.get_int("fg_bounces", 2),
        photon_bounces=integ.get_int("bounces", 5),
        sppm_passes=integ.get_int("passNums", 8),
        sppm_photons=integ.get_int("photons", 300000),
        sppm_initial_radius=integ.get_float("initialRadius", 0.0),
        sppm_search=integ.get_int("searchNum", 100),
        vol_integrator=vol.get_str("type", "none"),
        vol_step_size=vol.get_float("stepSize", 0.1),
        vol_adaptive=vol.get_bool("adaptive", False),
        vol_optimize=vol.get_bool("optimize", False),
        color_space=render.get_str("color_space", "sRGB"),
        gamma=render.get_float("gamma", 1.0),
        denoise=render.get_bool("denoiseEnabled",
                                render.get_bool("denoise", False)),
        denoise_h_lum=render.get_float("denoiseHLum", 5.0),
        denoise_h_col=render.get_float("denoiseHCol", 5.0),
        denoise_mix=render.get_float("denoiseMix", 0.8),
        z_channel=render.get_bool("z_channel", False),
        passes=_collect_passes(render),
        film_save_load=render.get_str("film_save_load", "none"),
        autosave_interval_type=render.get_str(
            "images_autosave_interval_type", "none"),
        autosave_interval=render.get_float(
            "images_autosave_interval_seconds", 300.0),
        background_name=render.get_str("background_name", ""),
        tiles_order=render.get_str("tiles_order", "linear"),
        threads=render.get_int("threads", -1),
    )
