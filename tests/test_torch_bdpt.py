"""Full (s,t)-MIS BDPT (integrators/veach.py) in the port against the JAX
reference on the CPU:
- the module helpers (`_remap0`, `_to_area` in its three modes,
  `_shading_corr`, and the area-light branches of `_emit_vertex`,
  `_sample_light_point` and `_emit_dir_pdf_le`, single- and double-sided)
  on numpy-seeded inputs: rtol 1e-6, with atol 1e-7 for components near 0
  (a float32 cos or sqrt may differ in its last bit between XLA and
  torch);
- scenes/cornell_bidir.xml (bidirectional, raydepth 3: Beer glass and
  glossy chrome spheres, one area light) at 16², 2 spp through
  `render_scene`: image RMSE <= 1e-4 (tests/test_torch_render.py's
  bound), the t=1 density plane RMSE <= 1e-5, rays equal.  The reference's
  step takes ~2 minutes of XLA compile on the CPU, so it renders once, in a
  module fixture;
and the port alone: `render_bdpt_timed` against `render_bdpt`, BDPT
against the port's own path tracer on tests/test_veach.py's diffuse box
(mean within 6%, floor and back wall within 10%), and the entry points'
refusal of a device mesh (item 19)."""
import os

import numpy as np
import pytest
import torch

from libyafaray_tpu.integrators import veach as ref_veach
from libyafaray_tpu.lights import base as ref_lightmod
from libyafaray_tpu.scene.session import render_scene as ref_render_scene
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch import convert
from libyafaray_tpu_torch.integrators import veach
from libyafaray_tpu_torch.integrators.photonmap import _light_cdf
from libyafaray_tpu_torch.lights import base as lightmod
from libyafaray_tpu_torch.scene.params import ParamMap
from libyafaray_tpu_torch.scene.scene import Scene
from libyafaray_tpu_torch.scene.session import build_config, render_scene
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIDIR = os.path.join(REPO, "scenes", "cornell_bidir.xml")
TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU path is many small tensor ops: one thread runs them
    fastest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sized(parse, size=16, spp=2):
    s = parse(BIDIR)
    s.render_params["width"] = size
    s.render_params["height"] = size
    s.render_params["AA_minsamples"] = spp
    return s


def _rmse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               **(tol or TOL))


# ---- the module helpers ----------------------------------------------------


def _lanes(n=4096, seed=7):
    rng = np.random.default_rng(seed)

    def unit():
        v = rng.normal(size=(n, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    return dict(
        u=[rng.random(n).astype(np.float32) for _ in range(4)],
        p0=rng.uniform(-3, 3, (n, 3)).astype(np.float32),
        p1=rng.uniform(-3, 3, (n, 3)).astype(np.float32),
        n0=unit(), n1=unit(), w0=unit(), w1=unit(),
        pdf=rng.uniform(0.0, 4.0, n).astype(np.float32),
        on=rng.random(n) < 0.5)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_remap0_and_shading_corr():
    d = _lanes()
    pdf = d["pdf"].copy()
    pdf[::7] = 0.0
    _close(veach._remap0(_t(pdf)), ref_veach._remap0(pdf))
    args = (d["n0"], d["n1"], d["w0"], d["w1"])
    _close(veach._shading_corr(*map(_t, args)),
           ref_veach._shading_corr(*args))


@pytest.mark.parametrize("mode", ["surface", "point", "per_lane"])
def test_to_area(mode):
    d = _lanes()
    on = {"surface": True, "point": False, "per_lane": d["on"]}[mode]
    args = (d["pdf"], d["p0"], d["p1"], d["n1"])
    port_on = on if isinstance(on, bool) else _t(on)
    _close(veach._to_area(*map(_t, args), on_surface_to=port_on),
           ref_veach._to_area(*args, on_surface_to=on))


@pytest.fixture(scope="module")
def compiled():
    """cornell_bidir.xml compiled by both packages: (reference static and
    arrays, port static and tensors)."""
    rcs = _sized(ref_parse).compile()
    pcs = _sized(parse_xml_file).compile(device="cpu")
    return rcs, pcs


def _light_rows(compiled, double_sided: bool):
    """The area light's row in both packages, with double_sided set."""
    rcs, pcs = compiled
    ref_lights = dict(rcs.arrays["lights"])
    ref_lights["double_sided"] = np.full_like(ref_lights["double_sided"],
                                              double_sided)
    port = convert.to_tensors(pcs.arrays, "cpu")
    port["lights"]["double_sided"] = torch.full_like(
        port["lights"]["double_sided"], double_sided)
    li = [ls.ltype for ls in pcs.static.lights].index(lightmod.LT_AREA)
    return (li, dict(rcs.arrays, lights=ref_lights), port,
            ref_lightmod.light_row(ref_lights, li),
            lightmod.light_row(port["lights"], li))


@pytest.mark.parametrize("double_sided", [False, True])
def test_emit_vertex_and_light_point(compiled, double_sided):
    rcs, pcs = compiled
    li, ref_arrays, arrays, ref_row, row = _light_rows(compiled,
                                                       double_sided)
    d = _lanes()
    n = d["u"][0].shape[0]
    ls, ref_ls = pcs.static.lights[li], rcs.static.lights[li]
    got = veach._emit_vertex(ls, row, n, *map(_t, d["u"]))
    want = ref_veach._emit_vertex(ref_ls, ref_row, n, *d["u"])
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    got = veach._sample_light_point(arrays, ls, li, row, n,
                                    *map(_t, d["u"][:2]))
    want = ref_veach._sample_light_point(ref_arrays, ref_ls, li, ref_row, n,
                                         *d["u"][:2])
    for k in ("q", "nl", "le", "pdf_pos"):
        _close(got[k], want[k])
    assert bool(got["dbl"]) == bool(want["dbl"]) == double_sided
    assert got["surface"] is want["surface"] is True


@pytest.mark.parametrize("double_sided", [False, True])
def test_emit_dir_pdf(compiled, double_sided):
    rcs, pcs = compiled
    li, ref_arrays, arrays, _, _ = _light_rows(compiled, double_sided)
    d = _lanes()
    li_id = np.where(d["on"], li, -1).astype(np.int32)
    cdf, _ = _light_cdf(pcs.static, pcs.arrays["lights"])
    pmf = np.diff(cdf).astype(np.float32)
    got = veach._emit_dir_pdf_le(pcs.static, arrays, _t(pmf), _t(li_id),
                                 _t(d["p0"]), _t(d["n0"]), _t(d["w0"]))
    want = ref_veach._emit_dir_pdf_le(rcs.static, ref_arrays, pmf, li_id,
                                      d["p0"], d["n0"], d["w0"])
    for g, r in zip(got, want):
        _close(g, r)
    assert float(got[0][d["on"]].max()) > 0.0
    assert float(got[0][~d["on"]].abs().max()) == 0.0


def test_unported_emitters_raise():
    """No emitter branch raises now that every light type is ported:
    the lights outside BDPT's strategy set (sun, directional, IES: zero
    flux, never picked) take the reference's fallback branches, a dead
    light vertex (pdf_dir 0, no radiance) and a zero s=1 point, as in
    libyafaray_tpu/integrators/veach.py."""
    u = torch.full((4,), 0.3)
    for ltype in (lightmod.LT_SUN, lightmod.LT_DIRECTIONAL, lightmod.LT_IES):
        class Light:
            enabled = True

        Light.ltype = ltype
        e = veach._emit_vertex(Light, {}, 4, u, u, u, u)
        want = ref_veach._emit_vertex(Light, {}, 4, *(u.numpy(),) * 4)
        for k in want:
            _close(e[k], np.broadcast_to(np.asarray(want[k]), e[k].shape))
        assert float(e["pdf_dir"].abs().max()) == 0.0
        assert float(e["le"].abs().max()) == 0.0
        p = veach._sample_light_point({}, Light, 0, {}, 4, u, u)
        assert float(p["le"].abs().max()) == 0.0 and p["surface"] is False


# ---- cornell_bidir.xml against the reference -------------------------------


@pytest.fixture(scope="module")
def bidir_renders():
    """One reference render (its step's ~2 min XLA compile) and the port's,
    both through render_scene at 16², 2 spp."""
    ref = ref_render_scene(_sized(ref_parse))
    port = render_scene(_sized(parse_xml_file), device="cpu")
    return ref, port


def test_cornell_bidir_config():
    cfg = build_config(parse_xml_file(BIDIR))
    assert (cfg.integrator, cfg.raydepth, cfg.width, cfg.aa_samples,
            cfg.filter_type, cfg.aa_pixelwidth) == (
        "bidirectional", 3, 512, 64, "box", 1.5)


def test_cornell_bidir_image_matches_reference(bidir_renders):
    ref, port = bidir_renders
    img = port.image
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.min() >= 0.0 and img.mean() > 0.05
    assert _rmse(ref.image, img) <= 1e-4
    for k in ("wsum", "w", "nsamples"):
        assert _rmse(ref.film[k], port.film[k].numpy()) <= 1e-5, k


def test_cornell_bidir_density_matches_reference(bidir_renders):
    """The t=1 splats' plane, normalized by the light paths a pixel: the
    light tracing strategies reach the image."""
    ref, port = bidir_renders
    dens = port.film["density"].numpy()
    assert dens.shape == (16, 16, 3) and float(dens.mean()) > 0.0
    assert _rmse(ref.film["density"], dens) <= 1e-5


def test_cornell_bidir_rays_match_reference(bidir_renders):
    """The reference's count: live camera lanes x (T_MAX + S_MAX) a step,
    16² x 2 steps x 6 = 3,072 on this box (every camera ray is live)."""
    ref, port = bidir_renders
    assert port.stats["rays"] == ref.stats["rays"] == 16 * 16 * 2 * 6
    assert port.stats["bdpt_steps"] == ref.stats["bdpt_steps"] == 2


def test_render_bdpt_timed_counts_the_same_rays():
    """The timed variant's warm-up step is not counted: its film holds the
    rays and image of a plain render of the same config."""
    s = _sized(parse_xml_file, size=8, spp=2)
    cfg = build_config(s)
    cs = s.compile(device="cpu")
    timed = veach.render_bdpt_timed(cs, cfg, device="cpu")
    plain = veach.render_bdpt(cs, cfg, device="cpu")
    assert timed.stats["rays"] == plain.stats["rays"] > 0
    assert np.array_equal(timed.image, plain.image)
    assert torch.equal(timed.film["density"], plain.film["density"])
    assert timed.mrays_per_sec > 0


@pytest.mark.parametrize("kw, item", [
    (dict(mesh=object()), "item 19"),
])
def test_film_persistence_and_mesh_raise(kw, item):
    s = _sized(parse_xml_file, size=8, spp=1)
    with pytest.raises(NotImplementedError, match=item):
        veach.render_bdpt(s.compile(device="cpu"), build_config(s),
                          device="cpu", **kw)


def test_entry_point_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_scene(_sized(parse_xml_file))


# ---- BDPT against the port's path tracer ------------------------------------


def _box(integrator, res=32, spp=16):
    """tests/test_veach.py's diffuse box (floor, back wall, one 0.8 x 0.8
    area light) through the port's Scene API (mesh and material ids)."""
    s = Scene()
    white = s.create_material("white", ParamMap({
        "type": "shinydiffusemat", "color": (0.7, 0.7, 0.7)}))
    s.create_light("L", ParamMap({
        "type": "arealight", "corner": (-0.4, -0.4, 1.98),
        "point1": (-0.4, 0.4, 1.98), "point2": (0.4, -0.4, 1.98),
        "power": 8.0, "color": (1.0, 1.0, 1.0), "samples": 4}))
    s.start_tri_mesh(1, has_uv=False, visibility="normal")
    for (x, y, z) in ((-2, -2, 0), (2, -2, 0), (2, 2, 0), (-2, 2, 0),
                      (-2, 2, 0), (2, 2, 0), (2, 2, 3), (-2, 2, 3)):
        s.add_vertex(float(x), float(y), float(z))
    for tri in ((0, 1, 2), (0, 2, 3), (4, 5, 6), (4, 6, 7)):
        s.add_triangle(*tri, white)
    s.end_tri_mesh()
    s.create_camera("cam", ParamMap({
        "type": "perspective", "resx": res, "resy": res,
        "from": (0.0, -5.0, 1.2), "to": (0.0, 0.0, 0.9),
        "up": (0.0, -5.0, 2.2), "focal": 1.4}))
    s.create_integrator("default", ParamMap({
        "type": integrator, "bounces": 3, "raydepth": 4}))
    s.render_params = ParamMap({
        "width": res, "height": res, "AA_minsamples": spp,
        "integrator_name": "default", "camera_name": "cam"})
    return s


def test_bdpt_matches_path_tracer_on_diffuse_box():
    """All strategies and their MIS weights on a diffuse box reproduce the
    path tracer: the image means within 6%, the floor and the back wall
    within 10% (tests/test_veach.py's bounds)."""
    img_bd = render_scene(_box("bidirectional"), device="cpu").image
    img_pt = render_scene(_box("pathtracing"), device="cpu").image
    assert np.isfinite(img_bd).all()
    m_bd, m_pt = float(img_bd.mean()), float(img_pt.mean())
    assert abs(m_bd - m_pt) / max(m_pt, 1e-6) < 0.06, (m_bd, m_pt)
    for region in ((slice(18, 30), slice(4, 28)),
                   (slice(8, 16), slice(6, 26))):
        r_bd = float(img_bd[region].mean())
        r_pt = float(img_pt[region].mean())
        assert abs(r_bd - r_pt) / max(r_pt, 1e-6) < 0.10, (region, r_bd,
                                                          r_pt)


@pytest.mark.parametrize("raydepth, closest, shadow", [(3, 5, 8),
                                                        (4, 7, 13)])
def test_step_intersection_batches(monkeypatch, raydepth, closest, shadow):
    """One step's closest-hit and shadow batches, which chip_smoke.py
    asserts as kernel launches: T = S = raydepth walk vertices (S - 1 past
    the emitter), and a shadow batch per s=1, inner and t=1 strategy with
    s + t <= raydepth + 2; the eye-only NEE adds none (the area light has
    flux)."""
    from libyafaray_tpu_torch.integrators.render import _fresh_film
    from libyafaray_tpu_torch.ops import intersect as isect

    s = _sized(parse_xml_file, size=4, spp=1)
    s.integrator_params["default"]["raydepth"] = raydepth
    cfg = build_config(s)
    cs = s.compile(device="cpu")
    step = veach.make_bdpt_step(cs, cfg, "cpu")
    calls = dict(closest_hit=0, shadow_transmission=0)
    for name in calls:
        fn = getattr(isect, name)

        def counting(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(isect, name, counting)
    step(convert.to_tensors(cs.arrays, "cpu"), _fresh_film(cfg, "cpu"),
         torch.ones((4, 4), dtype=torch.bool))
    assert calls == dict(closest_hit=closest, shadow_transmission=shadow)
