"""Adaptive AA (slice 16): the port's film estimators, compact passes and
pass loop against the JAX reference on the CPU (the plain versions of the
port's kernels), from the same inputs and the same QMC stream:
- the film functions of film/imagefilm.py on seeded numpy films: the
  variance plane, splat_plane, the compact splats (also against the port's
  own dense masked splat, bit for bit), compute_aa_flags over its dark
  detection, colour-noise and threshold-scale options, film_stderr and
  compute_stderr_flags;
- the compact sample step on a flag pattern with a sample history
  (tests/test_compact.py's scene, built through the port's Scene API)
  against the port's dense masked step, bit for bit, and against the
  reference's compact step;
- scenes/cornell.xml as pathtracing (bounces 4, rr_min_bounces 2) at 32²,
  3 passes, the contrast estimator at a threshold whose passes run compact
  (compact=True and compact=False), and the variance estimator.

Bounds, as tests/test_torch_render.py states them: film planes RMSE <=
1e-5 (the variance plane m2, a sum of squared samples, 1e-6 of its RMS),
image RMSE <= 1e-4, rays within 0.01%, nsamples equal.  Flags are
equal: the estimators read films that differ only in float32 rounding
order (XLA contracts multiply-adds on the CPU, PyTorch does not), and no
pixel of these films sits that close to its threshold.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu.film import imagefilm as rfilm
from libyafaray_tpu.integrators.config import RenderConfig as RefConfig
from libyafaray_tpu.integrators.engine import \
    make_sample_step as ref_make_step
from libyafaray_tpu.integrators.render import device_put_scene
from libyafaray_tpu.integrators.render import render as ref_render
from libyafaray_tpu.scene.params import ParamMap as RefParamMap
from libyafaray_tpu.scene.scene import Scene as RefScene
from libyafaray_tpu.scene.session import build_config as ref_build
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch.convert import to_tensors
from libyafaray_tpu_torch.film import imagefilm as pfilm
from libyafaray_tpu_torch.integrators import render as prender
from libyafaray_tpu_torch.integrators.config import RenderConfig
from libyafaray_tpu_torch.integrators.engine import make_sample_step
from libyafaray_tpu_torch.scene.params import ParamMap
from libyafaray_tpu_torch.scene.scene import Scene
from libyafaray_tpu_torch.scene.session import build_config
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "cornell.xml")
# the slice's path at test size: 32², 4 spp in pass 0, 2 more a pass; at
# AA_threshold 0.3 passes 1-2 flag ~60 of the 1,024 pixels (one 512-lane
# bucket: compact), the variance estimator's 0.03 ~300
ADAPTIVE = dict(integrator="pathtracing", bounces=4, rr_min_bounces=2,
                aa_passes=3, aa_samples=4, aa_inc_samples=2)
CONTRAST_THRESHOLD = 0.3
VARIANCE = dict(aa_estimator="variance", aa_threshold=0.03,
                aa_inc_samples=4)
FILTERS = ("box", "gauss", "mitchell")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU path is many small tensor ops: one thread runs them
    fastest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rmse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- the film functions on seeded numpy films ------------------------------


def _film(rng, h=12, w=10, with_m2=True, empty=0.0):
    """A film after a few samples: wsum, w, m2 as their splats leave them,
    nsamples 0 on a share `empty` of the pixels."""
    n = 6
    samples = rng.gamma(2.0, 0.25, (n, h, w, 3)).astype(np.float32)
    # an edge: a bright block on a dark field
    samples[:, 3:8, 4:9] *= 6.0
    wts = rng.uniform(0.5, 1.0, (n, h, w)).astype(np.float32)
    film = dict(wsum=(wts[..., None] * samples).sum(0).astype(np.float32),
                w=wts.sum(0).astype(np.float32),
                nsamples=np.full((h, w), n, np.int32))
    if with_m2:
        film["m2"] = (wts[..., None] * samples ** 2).sum(0).astype(
            np.float32)
    none = rng.random((h, w)) < empty
    film["nsamples"][none] = 0
    for k in film:
        if k != "nsamples":
            film[k][none] = 0.0
    return film


def _both(film: dict):
    return ({k: jnp.asarray(v) for k, v in film.items()},
            {k: _t(v) for k, v in film.items()})


@pytest.mark.parametrize("with_variance", [False, True])
def test_film_init_planes_match_reference(with_variance):
    ref = rfilm.film_init(5, 7, with_variance=with_variance)
    port = pfilm.film_init(5, 7, "cpu", with_variance=with_variance)
    # the reference's film also carries its flags plane, which the port's
    # steps take as an argument
    assert set(port) == set(ref) - {"flags"}
    for k, v in port.items():
        assert tuple(v.shape) == ref[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(ref[k].dtype), k
        assert not v.any(), k


def _lanes(rng, h, w):
    """Subpixel positions, resample flags and (H,W,3) values of one
    sample plane."""
    sx = rng.random((h, w)).astype(np.float32)
    sy = rng.random((h, w)).astype(np.float32)
    act = (rng.random((h, w)) < 0.4).astype(np.float32)
    val = rng.gamma(2.0, 0.5, (h, w, 3)).astype(np.float32)
    return sx, sy, act, val


@pytest.mark.parametrize("filter_type", FILTERS)
def test_splat_plane_matches_reference(filter_type):
    rng = np.random.default_rng(11)
    h, w = 9, 13
    sx, sy, act, val = _lanes(rng, h, w)
    acc = rng.random((h, w, 3)).astype(np.float32)
    ref = rfilm.splat_plane(jnp.asarray(acc), jnp.asarray(val),
                            jnp.asarray(sx), jnp.asarray(sy),
                            jnp.asarray(act), filter_type, 2.0)
    port = pfilm.splat_plane(_t(acc), _t(val), _t(sx), _t(sy), _t(act),
                             filter_type, 2.0)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("filter_type", FILTERS)
def test_compact_splats_match_reference_and_dense(filter_type):
    """The compact splats of a flagged lane set (in scan order, padded with
    dead lanes) equal the port's dense splat masked by the same flags bit
    for bit, and the reference's compact splats within rtol 1e-6."""
    rng = np.random.default_rng(12)
    h, w = 9, 13
    sx, sy, act, val = _lanes(rng, h, w)
    clamp = 1.5
    base = _film(rng, h, w)
    base["nsamples"] = rng.integers(0, 5, (h, w)).astype(np.int32)
    idx = np.flatnonzero(act).astype(np.int32)
    pix = np.concatenate([idx, np.full(64 - idx.size, -1, np.int32)])
    lane = np.maximum(pix, 0)
    c_sx, c_sy, c_val = (x.reshape((h * w,) + x.shape[2:])[lane]
                         for x in (sx, sy, val))
    c_act = (pix >= 0).astype(np.float32)
    rbase, pbase = _both(base)
    dense = pfilm.film_splat(pbase, _t(val), _t(sx), _t(sy), _t(act),
                             filter_type, 2.0, clamp_samples=clamp)
    port = pfilm.film_splat_compact(pbase, _t(c_val), _t(pix), _t(c_sx),
                                    _t(c_sy), _t(c_act), filter_type, 2.0,
                                    clamp_samples=clamp)
    ref = rfilm.film_splat_compact(
        rbase, jnp.asarray(c_val), jnp.asarray(pix), jnp.asarray(c_sx),
        jnp.asarray(c_sy), jnp.asarray(c_act), filter_type, 2.0,
        clamp_samples=clamp)
    for k in ("wsum", "w", "nsamples"):
        assert torch.equal(port[k], dense[k]), k
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    plane = pfilm.splat_plane_compact(pbase["m2"], _t(c_val), _t(pix),
                                      _t(c_sx), _t(c_sy), _t(c_act),
                                      filter_type, 2.0)
    assert torch.equal(plane, pfilm.splat_plane(
        pbase["m2"], _t(val), _t(sx), _t(sy), _t(act), filter_type, 2.0))
    np.testing.assert_allclose(plane.numpy(), np.asarray(
        rfilm.splat_plane_compact(rbase["m2"], jnp.asarray(c_val),
                                  jnp.asarray(pix), jnp.asarray(c_sx),
                                  jnp.asarray(c_sy), jnp.asarray(c_act),
                                  filter_type, 2.0)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dark, color_noise, scaled", [
    ("none", False, False), ("linear", False, False), ("curve", False, False),
    ("none", True, False), ("linear", True, True), ("curve", False, True)])
def test_aa_flags_match_reference(dark, color_noise, scaled):
    rng = np.random.default_rng(13)
    film = _film(rng)
    scale = (rng.uniform(0.3, 3.0, film["w"].shape).astype(np.float32)
             if scaled else None)
    rf, pf = _both(film)
    for thr in (0.05, 0.2, 0.5):
        ref = rfilm.compute_aa_flags(
            rf, thr, dark, 1.5, color_noise,
            threshold_scale=None if scale is None else jnp.asarray(scale))
        port = pfilm.compute_aa_flags(
            pf, thr, dark, 1.5, color_noise,
            threshold_scale=None if scale is None else _t(scale))
        assert port.dtype == torch.bool
        assert np.array_equal(port.numpy(), np.asarray(ref)), thr
    assert 0 < int(port.sum()) < port.numel()


@pytest.mark.parametrize("scaled", [False, True])
def test_stderr_matches_reference(scaled):
    """film_stderr within rtol 1e-6; the variance estimator's flags equal,
    pixels with no sample flagged."""
    rng = np.random.default_rng(14)
    film = _film(rng, empty=0.1)
    scale = (rng.uniform(0.3, 3.0, film["w"].shape).astype(np.float32)
             if scaled else None)
    rf, pf = _both(film)
    err_r = np.asarray(rfilm.film_stderr(rf))
    err_p = pfilm.film_stderr(pf).numpy()
    np.testing.assert_allclose(err_p, err_r, rtol=1e-6, atol=1e-9)
    for thr in np.quantile(err_r[film["nsamples"] > 0], [0.2, 0.5, 0.8]):
        ref = rfilm.compute_stderr_flags(
            rf, float(thr),
            threshold_scale=None if scale is None else jnp.asarray(scale))
        port = pfilm.compute_stderr_flags(
            pf, float(thr),
            threshold_scale=None if scale is None else _t(scale))
        assert np.array_equal(port.numpy(), np.asarray(ref)), thr
        assert port[torch.from_numpy(film["nsamples"] == 0)].all()


# ---- the compact step --------------------------------------------------------


def _floor_and_lamp(scene_cls, pmap, res):
    """tests/test_compact.py's scene (a floor, an emissive quad, an area
    light facing down), through the flat Scene API both packages share."""
    s = scene_cls()
    white = s.create_material("white", pmap({
        "type": "shinydiffusemat", "color": (0.7, 0.7, 0.7)}))
    lamp = s.create_material("lamp", pmap({
        "type": "light_mat", "color": (1.0, 0.9, 0.8), "power": 6.0}))
    s.start_tri_mesh(1, has_uv=False, visibility="normal")
    for v in ((-4.0, -4.0, 0.0), (4.0, -4.0, 0.0), (4.0, 4.0, 0.0),
              (-4.0, 4.0, 0.0), (-1.0, -1.0, 3.0), (1.0, -1.0, 3.0),
              (1.0, 1.0, 3.0)):
        s.add_vertex(*v)
    s.add_triangle(0, 1, 2, white)
    s.add_triangle(0, 2, 3, white)
    s.add_triangle(4, 5, 6, lamp)
    s.end_tri_mesh()
    s.create_light("l", pmap({
        "type": "arealight", "corner": (-1.0, -1.0, 2.9),
        "point1": (-1.0, 1.0, 2.9), "point2": (1.0, -1.0, 2.9),
        "color": (1.0, 1.0, 1.0), "power": 20.0, "samples": 1}))
    s.create_camera("cam", pmap({
        "type": "perspective", "resx": res, "resy": res,
        "from": (0.0, -6.0, 3.0), "to": (0.0, 0.0, 0.5),
        "up": (0.0, -6.0, 4.0), "focal": 1.4}))
    s.create_integrator("default", pmap({
        "type": "pathtracing", "bounces": 2, "raydepth": 3}))
    s.set_render_params(pmap({
        "width": res, "height": res, "AA_minsamples": 1,
        "integrator_name": "default", "camera_name": "cam"}))
    return s


def _pattern(h, w, nc):
    """test_compact.py's flag pattern and sample history: 37 flagged pixels
    of rng(5), nsamples 0-4, and the padded lane list."""
    rng = np.random.default_rng(5)
    flags = np.zeros((h, w), bool)
    sel = rng.choice(h * w, 37, replace=False)
    flags[np.unravel_index(sel, (h, w))] = True
    nsamples = rng.integers(0, 5, (h, w)).astype(np.int32)
    idx = np.flatnonzero(flags).astype(np.int32)
    pix = np.concatenate([idx, np.full(nc - idx.size, -1, np.int32)])
    return flags, nsamples, pix


@pytest.fixture(scope="module")
def floor_scene():
    s = _floor_and_lamp(Scene, ParamMap, 32)
    cs = s.compile(device="cpu")
    return cs, build_config(s), to_tensors(cs.arrays, "cpu")


def _port_film(cfg, nsamples):
    f = prender._fresh_film(cfg, "cpu")
    f["nsamples"] = _t(nsamples)
    return f


@pytest.mark.parametrize("spb", [1, 2])
def test_compact_step_equals_dense_masked_step(floor_scene, spb):
    """Bit for bit: the same lanes, the same per-lane arithmetic and the
    same adds per pixel, with 1 and 2 samples a step."""
    cs, cfg, arrays = floor_scene
    cfg = RenderConfig(**{**cfg.__dict__, "spp_batch": spb})
    flags, nsamples, pix = _pattern(cfg.height, cfg.width, 64)
    dense = make_sample_step(cs.static, cs.camera, cfg, "cpu")(
        arrays, _port_film(cfg, nsamples), _t(flags))
    compact = make_sample_step(cs.static, cs.camera, cfg, "cpu",
                               compact_n=64)(
        arrays, _port_film(cfg, nsamples), _t(pix))
    for k in ("wsum", "w", "nsamples", "rays"):
        assert torch.equal(compact[k], dense[k]), k
    added = compact["nsamples"].numpy() - nsamples
    assert np.array_equal(added, spb * flags)
    assert float(compact["wsum"].sum()) > 0.0


def test_compact_step_matches_reference(floor_scene):
    """The port's compact step against the reference's on the same lanes
    (tests/test_compact.py's comparison): nsamples and rays equal, film
    planes within RMSE 1e-5."""
    cs, cfg, arrays = floor_scene
    rs = _floor_and_lamp(RefScene, RefParamMap, 32)
    rcs = rs.compile()
    rcfg = ref_build(rs)
    flags, nsamples, pix = _pattern(cfg.height, cfg.width, 64)
    rfilm_ = rfilm.film_init(rcfg.height, rcfg.width)
    rfilm_["rays"] = jnp.zeros((), jnp.float32)
    rfilm_["nsamples"] = jnp.asarray(nsamples)
    ref = jax.jit(ref_make_step(rcs.static, rcs.camera, rcfg, compact_n=64))(
        device_put_scene(rcs), rfilm_, jnp.asarray(pix))
    port = make_sample_step(cs.static, cs.camera, cfg, "cpu", compact_n=64)(
        arrays, _port_film(cfg, nsamples), _t(pix))
    assert np.array_equal(port["nsamples"].numpy(),
                          np.asarray(ref["nsamples"]))
    for k in ("wsum", "w"):
        assert _rmse(ref[k], port[k].numpy()) <= 1e-5, k
    assert float(port["rays"]) == float(ref["rays"]) > 0


# ---- the adaptive Cornell render ---------------------------------------------


def _cornell(parse, build, config_cls, size=32, **over):
    s = parse(CORNELL)
    s.render_params["width"] = size
    s.render_params["height"] = size
    cfg = build(s)
    return s, config_cls(**{**cfg.__dict__, **ADAPTIVE, **over,
                            "width": size, "height": size})


@pytest.fixture(scope="module")
def ref_renders():
    """The reference's adaptive renders (its default compact passes), once:
    the contrast estimator and the variance estimator."""
    out = {}
    for name, over in (("contrast", dict(aa_threshold=CONTRAST_THRESHOLD)),
                       ("variance", VARIANCE)):
        s, cfg = _cornell(ref_parse, ref_build, RefConfig, **over)
        out[name] = ref_render(s.compile(), cfg)
    return out


@pytest.fixture(scope="module")
def port_renders():
    out = {}
    for name, over, compact in (
            ("compact", dict(aa_threshold=CONTRAST_THRESHOLD), True),
            ("dense", dict(aa_threshold=CONTRAST_THRESHOLD), False),
            ("variance", VARIANCE, True)):
        s, cfg = _cornell(parse_xml_file, build_config, RenderConfig, **over)
        out[name] = prender.render(s.compile(device="cpu"), cfg,
                                   device="cpu", compact=compact)
    return out


@pytest.mark.parametrize("name, ref_name", [
    ("compact", "contrast"), ("dense", "contrast"), ("variance", "variance")])
def test_adaptive_cornell_matches_reference(ref_renders, port_renders, name,
                                            ref_name):
    ref, port = ref_renders[ref_name], port_renders[name]
    assert np.array_equal(port.film["nsamples"].numpy(),
                          np.asarray(ref.film["nsamples"]))
    for k in ("wsum", "w"):
        assert _rmse(ref.film[k], port.film[k].numpy()) <= 1e-5, k
    if name == "variance":
        # m2 sums squared samples (the light's pixels reach ~1e4): held to
        # its own scale, RMSE <= 1e-6 of its RMS (measured 9.5e-8; wsum's
        # RMSE is 1.3e-7 of its RMS)
        m2 = np.asarray(ref.film["m2"], np.float64)
        assert _rmse(m2, port.film["m2"].numpy()) <= 1e-6 * np.sqrt(
            np.mean(m2 ** 2))
    assert _rmse(ref.image, port.image) <= 1e-4
    r_ref, r_port = ref.stats["rays"], port.stats["rays"]
    assert abs(r_port - r_ref) <= 1e-4 * r_ref, (r_ref, r_port)
    assert port.stats["passes"] == ref.stats["passes"] == 3
    ns = port.film["nsamples"].numpy()
    # the later passes resampled some pixels, not all
    assert ns.min() == 4 and ns.max() > 4


def test_compact_passes_equal_dense_passes(port_renders):
    """compact=True ran passes 1-2 over one 512-lane bucket; its film equals
    the dense masked passes' bit for bit, rays equal."""
    c, d = port_renders["compact"], port_renders["dense"]
    for k in ("wsum", "w", "nsamples"):
        assert torch.equal(c.film[k], d.film[k]), k
    assert c.stats["rays"] == d.stats["rays"]
    log_c, log_d = c.stats["pass_log"], d.stats["pass_log"]
    assert [e["mode"] for e in log_c] == ["dense", "compact", "compact"]
    assert [e["mode"] for e in log_d] == ["dense"] * 3
    assert [e["lanes"] for e in log_c] == [1024, 512, 512]
    assert [e["steps"] for e in log_c] == [4, 2, 2]
    for a, b in zip(log_c, log_d):
        assert a["flagged"] == b["flagged"]
    assert 0 < log_c[1]["flagged"] <= 512


def test_render_timed_runs_the_passes_uniform():
    """render_timed runs ceil(AA_minsamples·AA_passes / spp_batch) steps
    over every pixel: the film of a one-pass render of as many samples."""
    s, cfg = _cornell(parse_xml_file, build_config, RenderConfig, size=8,
                      aa_samples=2, spp_batch=2)
    cs = s.compile(device="cpu")
    timed = prender.render_timed(cs, cfg, device="cpu")
    one = prender.render(cs, RenderConfig(**{
        **cfg.__dict__, "aa_passes": 1, "aa_samples": 6}), device="cpu")
    assert (timed.film["nsamples"] == 6).all()
    for k in ("wsum", "w", "nsamples", "rays"):
        assert torch.equal(timed.film[k], one.film[k]), k
    assert timed.stats["passes"] == 1


def test_pass_steps_and_multiplied_configs():
    cfg = RenderConfig(aa_samples=64, aa_inc_samples=16, spp_batch=3,
                       aa_sample_multiplier_factor=1.5,
                       aa_light_sample_multiplier_factor=2.0)
    assert [prender._pass_steps(cfg, p) for p in range(4)] == [22, 9, 14, 20]
    assert prender.pass_config(cfg, 0) is cfg
    c2 = prender.pass_config(cfg, 2)
    assert (c2.light_ns_mult, c2.indirect_ns_mult) == (4.0, 1.0)
    plain = RenderConfig()
    assert prender.pass_config(plain, 3) is plain
    flags = torch.zeros((40, 40), dtype=torch.bool)
    flags.view(-1)[[3, 700, 1599]] = True
    pix = prender.compact_lanes(flags, 3)
    assert pix.shape == (512,) and pix[:3].tolist() == [3, 700, 1599]
    assert (pix[3:] == -1).all()
    flags[:30] = True
    assert prender.compact_lanes(flags, int(flags.sum())).shape == (2048,)
