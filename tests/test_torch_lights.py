"""Every light type of the reference, function by function: the port's
samplers (lights/base.py), IES profiles (lights/ies.py), factory rows,
photon emitters (integrators/photon_shoot.py) and BDPT emitter branches
(integrators/veach.py) against the JAX package's on the same rows and the
same uniforms, made from a seed with numpy.  The JAX functions run op by
op (not jitted), as the port's do.  Bounds: rtol 1e-5, atol 1e-6 on
floats, validity flags equal; parse_ies, the factory rows, the compiled
light arrays and the power CDF's fluxes exactly equal.  The scene
scenes/cornell_lights.xml compiles to 352 triangles and takes the dense
kernels.

The scene end to end under the photon integrators and BDPT, at 16² (the
scene names its IES file relative to the repository root: these tests
run from there):
- photon mapping (16,384 diffuse and 8,192 caustic photons, final gather
  4, 2 spp): the power CDF over every light type (the meshlight's flux
  enters it, its photons leave with zero flux, as the reference's do;
  sun, directional and IES emit none), the point, spot and sphere
  emitters.  Image RMSE <= 1e-3, the diffuse and caustic maps' stored
  photons within 0.1% of the reference's (its log line), rays within 0.1%;
- SPPM (2 passes of 16,384 photons): image and density layer RMSE <=
  1e-3, rays equal; one `indirect` photon pass of 16,384 lanes from every
  light type (make_photon_pass of both packages, the same seed): the
  stored photons within 0.1%, and the emitted power of each stored
  photon's light type present;
- bidirectional (raydepth 4, 2 spp): the light subpaths start on the
  meshlight, point, spot and sphere lights (picked by flux), the s = 1
  resampling takes the spot's falloff, the sun, directional and IES
  lights arrive through the weight-1 eye-side NEE.  Image RMSE <= 1e-4,
  rays equal, the t=1 density plane RMSE <= 1e-5.
"""
import logging
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu.integrators import photon_shoot as ref_shoot
from libyafaray_tpu.integrators import veach as ref_veach
from libyafaray_tpu.lights import base as ref_base
from libyafaray_tpu.lights import ies as ref_ies
from libyafaray_tpu.lights.factory import light_from_params as ref_factory
from libyafaray_tpu.integrators.photonmap import _light_cdf as ref_cdf
from libyafaray_tpu.scene.params import ParamMap as RefParamMap
from libyafaray_tpu.scene.session import build_config as ref_build
from libyafaray_tpu.scene.session import render_scene as ref_render_scene
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch import convert
from libyafaray_tpu_torch.core import sampling
from libyafaray_tpu_torch.integrators import engine
from libyafaray_tpu_torch.integrators import photon_shoot
from libyafaray_tpu_torch.integrators.photonmap import _light_cdf
from libyafaray_tpu_torch.integrators import veach
from libyafaray_tpu_torch.lights import base
from libyafaray_tpu_torch.lights import ies
from libyafaray_tpu_torch.lights.factory import light_from_params
from libyafaray_tpu_torch.ops.intersect import route
from libyafaray_tpu_torch.scene.params import ParamMap
from libyafaray_tpu_torch.scene.session import build_config, render_scene
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU path is many small tensor ops: one thread runs them
    fastest (and keeps parallel test workers off each other's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIGHTS_XML = os.path.join(REPO, "scenes", "cornell_lights.xml")
IES_ASSET = os.path.join(REPO, "scenes", "assets", "cornell_lights.ies")
N = 4096
RTOL, ATOL = 1e-5, 1e-6

# one parameter set per light type (the meshlight and portal resolve
# against a scene at compile: tested through the compiled arrays)
LIGHT_PARAMS = {
    "point": dict(type="pointlight", **{"from": (0.3, -0.2, 2.5)},
                  color=(1.0, 0.9, 0.8), power=3.0),
    "spot": dict(type="spotlight", **{"from": (0.2, 0.1, 3.0)},
                 to=(0.5, 0.3, 0.0), cone_angle=35.0, blend=0.2,
                 color=(0.9, 1.0, 0.8), power=5.0),
    "spot_soft": dict(type="spotlight", **{"from": (0.2, 0.1, 3.0)},
                      to=(0.5, 0.3, 0.0), cone_angle=35.0, blend=0.2,
                      soft_shadows=True, shadowFuzzyness=0.3, samples=8,
                      color=(0.9, 1.0, 0.8), power=5.0),
    "sun": dict(type="sunlight", direction=(0.3, -1.0, 0.8), angle=0.5,
                color=(1.0, 0.95, 0.85), power=0.6, samples=2),
    "directional": dict(type="directional", direction=(-0.4, -1.0, 0.5),
                        color=(0.6, 0.7, 1.0), power=0.3),
    "sphere": dict(type="spherelight", **{"from": (0.4, 0.2, 1.5)},
                   radius=0.4, color=(1.0, 0.7, 0.4), power=20.0, samples=8),
    "area": dict(type="arealight", corner=(-0.5, -0.5, 2.0),
                 point1=(-0.5, 0.5, 2.0), point2=(0.5, -0.5, 2.0),
                 color=(1.0, 1.0, 1.0), power=10.0, samples=4),
    "ies": dict(type="ieslight", **{"from": (0.1, 0.2, 3.0)},
                to=(0.1, 0.2, 0.0), file=IES_ASSET, power=2.5),
    "meshlight": dict(type="meshlight", object=4, power=40.0,
                      color=(1.0, 0.88, 0.68), samples=16),
    "portal": dict(type="bgPortalLight", object_name="7", samples=8),
    "unknown": dict(type="torchlight", **{"from": (0.0, 0.0, 1.0)},
                    power=2.0),
}


def _rng_inputs(seed=7, n=N):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    u = rng.random((4, n), dtype=np.float32)
    return p, u


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _close(got, want, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == np.bool_:
        assert np.array_equal(got, want), name
        return
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)


def _rows(name):
    """(port row, reference row) of LIGHT_PARAMS[name] through both
    factories, and their geometry."""
    row, geom = light_from_params(ParamMap(LIGHT_PARAMS[name]))
    rrow, rgeom = ref_factory(RefParamMap(LIGHT_PARAMS[name]))
    return row, geom, rrow, rgeom


def _tables(name):
    row, _, rrow, _ = _rows(name)
    table = base.build_light_table(
        [{k: v for k, v in row.items() if not k.startswith("_")}])
    rtable = ref_base.build_light_table(
        [{k: v for k, v in rrow.items() if not k.startswith("_")}])
    return (base.light_row(convert.to_tensors(table, "cpu"), 0),
            ref_base.light_row({k: jnp.asarray(v) for k, v in rtable.items()},
                               0), row, rrow)


@pytest.mark.parametrize("name", sorted(LIGHT_PARAMS))
def test_factory_rows_equal_reference(name):
    """Every factory branch (with the unknown type's point-light fallback,
    the sphere light's 320-face icosphere and the IES profile) gives the
    reference's row and geometry."""
    row, geom, rrow, rgeom = _rows(name)
    assert sorted(row) == sorted(rrow)
    for k in rrow:
        if k == "_ies_profile":
            assert np.array_equal(row[k], rrow[k])
        else:
            assert row[k] == rrow[k], k
    assert (geom is None) == (rgeom is None)
    if geom is not None:
        assert np.array_equal(geom["pos"], rgeom["pos"])
        assert geom["radiance"] == rgeom["radiance"]
    if name == "sphere":
        assert geom["pos"].shape == (320, 3, 3)


_SAMPLERS = [
    ("point", "sample_point"), ("spot", "sample_spot"),
    ("spot_soft", "sample_spot"), ("directional", "sample_directional"),
    ("sun", "sample_sun"), ("sphere", "sample_sphere_light"),
    ("area", "sample_area"),
]


@pytest.mark.parametrize("name, fn", _SAMPLERS)
def test_light_samplers_match_reference(name, fn):
    lrow, rrow_j, _, _ = _tables(name)
    p, u = _rng_inputs()
    got = getattr(base, fn)(lrow, _t(p), _t(u[0]), _t(u[1]))
    want = getattr(ref_base, fn)(rrow_j, jnp.asarray(p), jnp.asarray(u[0]),
                                 jnp.asarray(u[1]))
    for k in ("wi", "dist", "li", "pdf", "valid"):
        assert got[k].shape[0] == N, k
        _close(got[k], np.broadcast_to(np.asarray(want[k]), got[k].shape),
               f"{name} {k}")
    assert got["valid"].any()


def _mesh_inputs(seed=3, nt=6):
    rng = np.random.default_rng(seed)
    tri_pos = rng.uniform(-1.0, 1.0, (nt, 3, 3)).astype(np.float32)
    areas = 0.5 * np.linalg.norm(np.cross(tri_pos[:, 1] - tri_pos[:, 0],
                                          tri_pos[:, 2] - tri_pos[:, 0]),
                                 axis=1)
    cdf = np.concatenate([[0.0], np.cumsum(areas / areas.sum())])
    cdf[-1] = 1.0
    return tri_pos, cdf.astype(np.float32), float(areas.sum())


def test_mesh_light_sampler_and_hit_pdf_match_reference():
    """sample_mesh_light (area CDF over the triangles, the 1 - 1e-7 clip)
    and pdf_hit_area, on 6 random triangles; p moved off their plane."""
    tri_pos, cdf, area = _mesh_inputs()
    p, u = _rng_inputs()
    p = p + np.float32(3.0)
    row = dict(area=np.float32(area), radiance=np.asarray([1.0, 0.5, 0.2],
                                                          np.float32))
    got = base.sample_mesh_light({k: _t(v) for k, v in row.items()}, _t(p),
                                 _t(u[0]), _t(u[1]), _t(cdf), _t(tri_pos))
    want = ref_base.sample_mesh_light(
        {k: jnp.asarray(v) for k, v in row.items()}, jnp.asarray(p),
        jnp.asarray(u[0]), jnp.asarray(u[1]), jnp.asarray(cdf),
        jnp.asarray(tri_pos))
    for k in ("wi", "dist", "li", "valid"):
        _close(got[k], want[k], k)
    # the pdf d²/(A·|cos|) is compared as its reciprocal, which stays well
    # conditioned at grazing angles: there a one-ulp difference in the
    # triangle normal (XLA fuses jnp.cross's multiply-subtracts) moves the
    # pdf itself by up to ~2e-4 of its value
    _close(1.0 / got["pdf"], 1.0 / np.asarray(want["pdf"]), "1/pdf")
    ng = got["wi"].flip(-1)  # any normals
    hp = _t(p) + got["wi"] * got["dist"][..., None]
    _close(base.pdf_hit_area({"area": _t(np.float32(area))}, _t(p), hp, ng,
                             got["wi"]),
           ref_base.pdf_hit_area({"area": jnp.float32(area)},
                                 jnp.asarray(p), jnp.asarray(hp.numpy()),
                                 jnp.asarray(ng.numpy()),
                                 jnp.asarray(got["wi"].numpy())), "pdf_hit")


@pytest.mark.parametrize("fn", ["sample_sphere", "sample_triangle",
                                "sample_disk_concentric", "sample_cone"])
def test_sampling_warps_match_reference(fn):
    from libyafaray_tpu.core import sampling as ref_sampling

    _, u = _rng_inputs(11)
    u[0, :4] = 0.5  # the disk warp's centre
    u[1, :4] = 0.5
    args, rargs = (_t(u[0]), _t(u[1])), (jnp.asarray(u[0]),
                                          jnp.asarray(u[1]))
    if fn == "sample_cone":
        axis = np.tile(np.asarray([[0.36, -0.48, 0.8]], np.float32), (N, 1))
        cos_max = np.linspace(0.2, 0.99, N).astype(np.float32)
        args = (_t(axis), _t(cos_max)) + args
        rargs = (jnp.asarray(axis), jnp.asarray(cos_max)) + rargs
    got = getattr(sampling, fn)(*args)
    want = getattr(ref_sampling, fn)(*rargs)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        _close(g, w, fn)


def _tilt_include_file(tmp_path):
    text = open(IES_ASSET).read().replace(
        "TILT=NONE", "TILT=INCLUDE\n1\n3\n0 45 90\n1.0 0.9\n0.8")
    path = tmp_path / "tilt.ies"
    path.write_text(text)
    return str(path)


def test_parse_ies_equals_reference(tmp_path):
    """The asset (TILT=NONE, 7 vertical angles, quadrant symmetry, so the
    full-grid expansion runs) and a TILT=INCLUDE copy: the same grid, bit
    for bit; the tilt block is skipped, so both grids are equal too."""
    grid = ies.parse_ies(IES_ASSET)
    assert grid.shape == (ies.PROFILE_RES, ies.PROFILE_HRES)
    assert np.array_equal(grid, ref_ies.parse_ies(IES_ASSET))
    tilt = _tilt_include_file(tmp_path)
    assert np.array_equal(ies.parse_ies(tilt), ref_ies.parse_ies(tilt))
    assert np.array_equal(ies.parse_ies(tilt), grid)
    # quadrant symmetry: phi and 180 - phi read the same column
    assert np.array_equal(grid[:, 12], grid[:, 24])
    assert grid.max() == 1.0 and grid[-1].max() == 0.0


def test_unreadable_ies_falls_back_to_isotropic(tmp_path, caplog):
    params = dict(LIGHT_PARAMS["ies"], file=str(tmp_path / "missing.ies"))
    row, _ = light_from_params(ParamMap(params))
    assert np.array_equal(row["_ies_profile"],
                          np.ones(ies.PROFILE_RES, np.float32))
    assert "isotropic" in caplog.text


@pytest.mark.parametrize("full", [True, False])
def test_apply_ies_profile_matches_reference(full):
    grid = ies.parse_ies(IES_ASSET)
    prof = grid if full else grid.mean(axis=1).astype(np.float32)
    _, u = _rng_inputs(5)
    # emission directions -wi around the downward axis
    wi = np.stack([u[0] - 0.5, u[1] - 0.5, u[2]], -1).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    ld = np.asarray([0.1, -0.2, -0.97], np.float32)
    ld /= np.linalg.norm(ld)
    got = ies.apply_ies_profile(_t(prof), _t(ld), _t(wi))
    want = ref_ies.apply_ies_profile(jnp.asarray(prof), jnp.asarray(ld),
                                     jnp.asarray(wi))
    _close(got, want, "ies")
    assert float(got.max()) > 0.5


@pytest.fixture(scope="module")
def compiled():
    """scenes/cornell_lights.xml compiled by both packages (from the
    repository root: the IES file name is relative)."""
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        return (parse_xml_file(LIGHTS_XML).compile(device="cpu"),
                ref_parse(LIGHTS_XML).compile())
    finally:
        os.chdir(cwd)


def test_scene_light_arrays_equal_reference(compiled):
    """The meshlight's CDF, area, radiance and triangle range, the IES
    grid, tri_pos in concatenation order, the light table (hit_pack) and
    the triangles' light ids: the reference's values; 352 triangles, the
    dense route; the port's static equals the reference's converted."""
    cs, rcs = compiled
    for k in ("mlight_cdf_0", "ies_4", "tri_pos"):
        assert np.array_equal(cs.arrays[k], rcs.arrays[k]), k
    for k, v in rcs.arrays["lights"].items():
        assert np.array_equal(cs.arrays["lights"][k], v), k
    assert np.array_equal(cs.arrays["tri_shade_pack"],
                          rcs.arrays["tri_shade_pack"])
    assert cs.static.lights == convert.static_from_reference(
        rcs.static).lights
    assert cs.static.n_tris_real == 352
    assert (cs.static.lights[0].tri_start, cs.static.lights[0].tri_count) \
        == (30, 2)
    assert np.array_equal(cs.arrays["ies_4"],
                          ies.parse_ies(IES_ASSET))
    lid = cs.arrays["tri_shade_pack"][:, 28]
    assert (lid[30:32] == 0).all() and (lid[32:] == 3).all()
    t = convert.to_tensors(cs.arrays, "cpu")
    assert route(t["tri_pack10"], t["tri_cluster8"], 352) == "dense"
    # arrays_from_reference carries the light arrays
    arr = convert.arrays_from_reference(rcs.arrays, "cpu")
    for k in ("mlight_cdf_0", "ies_4", "tri_pos"):
        assert torch.equal(arr[k], t[k]), k


def test_missing_meshlight_object_disables_the_light(caplog):
    from libyafaray_tpu_torch.scene.xml_parser import parse_xml_string

    xml = open(LIGHTS_XML).read().replace('<object ival="4"/>',
                                          '<object ival="9"/>')
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        cs = parse_xml_string(xml).compile(device="cpu")
    finally:
        os.chdir(cwd)
    assert not cs.static.lights[0].enabled
    assert "mlight_cdf_0" not in cs.arrays and "not found" in caplog.text
    assert (cs.arrays["lights"]["hit_pack"][0, 2:5] == 0).all()


def test_light_flux_equals_reference(compiled):
    """The power CDF's fluxes of every light type, bit for bit (each
    branch keeps the reference's float32 / float64 scalar types): the
    meshlight's enters, sun, directional and IES give 0."""
    cs, rcs = compiled
    got = photon_shoot.light_flux(cs.static, cs.arrays["lights"])
    want = ref_shoot.light_flux(rcs.static, rcs.arrays)
    assert np.array_equal(got, want)
    assert got[0] > 0 and (got[4:] == 0).all()


def _scene_rows(compiled, li):
    cs, rcs = compiled
    lrow = base.light_row(convert.to_tensors(cs.arrays["lights"], "cpu"),
                          li)
    rrow = ref_base.light_row(
        {k: jnp.asarray(v) for k, v in rcs.arrays["lights"].items()}, li)
    return cs.static.lights[li], rcs.static.lights[li], lrow, rrow


def _same_cone_dirs(monkeypatch, module, dirs):
    """Patch `module`'s sample_cone to return the port's directions `dirs`
    (the reference's own pdf): a spot's smoothstep falloff amplifies a
    one-ulp difference in a sampled direction (XLA's and torch's sin / cos
    differ in the last bit) up to ~1e-4, so its flux is held at equal
    directions, the directions themselves at rtol 1e-5."""
    orig = module.sample_cone

    def fixed(*args):
        return jnp.asarray(dirs.numpy()), orig(*args)[1]

    monkeypatch.setattr(module, "sample_cone", fixed)


@pytest.mark.parametrize("li", range(7))
def test_photon_emitters_match_reference(compiled, li, monkeypatch):
    """_emit_one_light of every light of the scene: origin, direction and
    flux color (the meshlight's and the zero-flux types' zero photon from
    the origin along +z)."""
    ls, rls, lrow, rrow = _scene_rows(compiled, li)
    _, u = _rng_inputs(li)
    ru = {f"u{i + 1}": jnp.asarray(u[i]) for i in range(4)}
    got = photon_shoot._emit_one_light(ls, lrow, N, *(_t(x) for x in u))
    want = ref_shoot._emit_one_light(rls, rrow, N, ru)
    _close(got[1], np.broadcast_to(np.asarray(want[1]), got[1].shape), "dir")
    if ls.ltype == base.LT_SPOT:
        _same_cone_dirs(monkeypatch, ref_shoot, got[1])
        want = ref_shoot._emit_one_light(rls, rrow, N, ru)
    for g, w, k in zip(got, want, ("org", "dir", "flux")):
        _close(g, np.broadcast_to(np.asarray(w), g.shape), k)


@pytest.mark.parametrize("li", range(7))
def test_bdpt_emitters_match_reference(compiled, li, monkeypatch):
    """veach._emit_vertex / _emit_mesh_vertex, _sample_light_point and
    _emit_dir_pdf_le of every light of the scene (point, spot and sphere
    emitters, the meshlight's triangle pick; sun, directional and IES
    give the dead branch), and the spot's falloff."""
    cs, rcs = compiled
    ls, rls, lrow, rrow = _scene_rows(compiled, li)
    _, u = _rng_inputs(20 + li)
    tu, ju = [_t(x) for x in u], [jnp.asarray(x) for x in u]
    arrays = convert.to_tensors(cs.arrays, "cpu")
    rarrays = {k: jnp.asarray(v) for k, v in rcs.arrays.items()
               if not isinstance(v, dict)}
    if ls.ltype == base.LT_MESH:
        got = veach._emit_mesh_vertex(arrays, ls, li, lrow, N, *tu)
        want = ref_veach._emit_mesh_vertex(rarrays, rls, li, rrow, N, *ju)
    else:
        got = veach._emit_vertex(ls, lrow, N, *tu)
        want = ref_veach._emit_vertex(rls, rrow, N, *ju)
        _close(got["dirn"], np.broadcast_to(np.asarray(want["dirn"]),
                                            (N, 3)), "dirn")
        if ls.ltype == base.LT_SPOT:
            _same_cone_dirs(monkeypatch, ref_veach, got["dirn"])
            want = ref_veach._emit_vertex(rls, rrow, N, *ju)
    for k in ("org", "nl", "dirn", "le", "pdf_pos", "pdf_dir", "cos0"):
        _close(got[k], np.broadcast_to(np.asarray(want[k]), got[k].shape),
               k)
    got = veach._sample_light_point(arrays, ls, li, lrow, N, tu[0], tu[1])
    want = ref_veach._sample_light_point(rarrays, rls, li, rrow, N, ju[0],
                                         ju[1])
    for k in ("q", "nl", "le", "pdf_pos", "dbl"):
        _close(got[k] | torch.zeros(N, dtype=torch.bool) if k == "dbl"
               else got[k], np.broadcast_to(np.asarray(want[k]),
                                            (N,) if k in ("pdf_pos", "dbl")
                                            else (N, 3)), k)
    assert got["surface"] == want["surface"]
    # the emission pdfs at random points / normals toward random directions
    p, _ = _rng_inputs(40 + li)
    w_out = np.stack([u[2] - 0.5, u[3] - 0.5, u[0] - 0.3], -1)
    w_out = (w_out / np.linalg.norm(w_out, axis=1,
                                    keepdims=True)).astype(np.float32)
    ids = (np.arange(N) % 8 - 1).astype(np.int32)  # -1 and every light
    pmf = np.diff(_light_cdf(cs.static, cs.arrays["lights"])[0])
    got = veach._emit_dir_pdf_le(cs.static, arrays, _t(pmf), _t(ids),
                                 _t(p), _t(w_out[::-1].copy()), _t(w_out))
    want = ref_veach._emit_dir_pdf_le(
        rcs.static, rarrays | {"lights": {
            k: jnp.asarray(v) for k, v in rcs.arrays["lights"].items()}},
        jnp.asarray(pmf), jnp.asarray(ids), jnp.asarray(p),
        jnp.asarray(w_out[::-1].copy()), jnp.asarray(w_out))
    for g, w in zip(got, want):
        _close(g, w, "emit_dir_pdf")
    if ls.ltype == base.LT_SPOT:
        _close(veach._spot_fall(lrow, _t(w_out)),
               ref_veach._spot_fall(rrow, jnp.asarray(w_out)), "spot_fall")


def test_engine_samples_every_scene_light(compiled):
    """engine.sample_light (the port's _sample_one_light) on every light of
    the scene, the meshlight through its CDF and tri_pos slice and the IES
    light through its profile, against the reference's dispatch."""
    from libyafaray_tpu.integrators.engine import _sample_one_light

    cs, rcs = compiled
    arrays = convert.to_tensors(cs.arrays, "cpu")
    rarrays = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                   if isinstance(v, dict) else jnp.asarray(v))
               for k, v in rcs.arrays.items()}
    p, u = _rng_inputs(9)
    p = (p * np.float32(2.0) + np.asarray([2.78, 2.8, 2.7],
                                          np.float32)).astype(np.float32)
    for li, ls in enumerate(rcs.static.lights):
        rrow = ref_base.light_row(rarrays["lights"], li)
        want = _sample_one_light(rarrays, rcs.static, li, ls, rrow,
                                 jnp.asarray(p), jnp.asarray(u[0]),
                                 jnp.asarray(u[1]))
        got = engine.sample_light(arrays, cs.static, li, _t(p), _t(u[0]),
                                  _t(u[1]))
        for k in ("wi", "dist", "li", "pdf", "valid"):
            _close(got[k], np.broadcast_to(np.asarray(want[k]),
                                           got[k].shape), f"{li} {k}")


# ---- cornell_lights.xml end to end: photon mapping, SPPM, BDPT -------------


def _lights_scene(parse, integrator: str, spp: int, **params):
    s = parse(LIGHTS_XML)
    s.render_params.update(width=16, height=16, AA_minsamples=spp)
    s.integrator_params["default"]["type"] = integrator
    s.integrator_params["default"].update(params)
    return s


PHOTON_PARAMS = dict(photons=16384, cPhotons=8192, fg_samples=4)
SPPM_PARAMS = dict(photons=16384, passNums=2)


def _rmse(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64)
                                  - np.asarray(b, np.float64)) ** 2)))


@pytest.fixture
def at_repo_root(monkeypatch):
    """The scene names its IES file relative to the repository root."""
    monkeypatch.chdir(REPO)


@pytest.fixture(scope="module")
def photon_renders():
    """Both photon-mapping renders, and the reference's stored and
    emitted photon counts from its log line."""
    cwd = os.getcwd()
    os.chdir(REPO)
    logger = logging.getLogger("libyafaray_tpu")
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    h, level = Keep(), logger.level
    logger.addHandler(h)
    logger.setLevel(logging.INFO)
    try:
        port = render_scene(_lights_scene(parse_xml_file, "photonmapping", 2,
                                          **PHOTON_PARAMS), device="cpu")
        ref = ref_render_scene(_lights_scene(ref_parse, "photonmapping", 2,
                                             **PHOTON_PARAMS))
    finally:
        logger.removeHandler(h)
        logger.setLevel(level)
        os.chdir(cwd)
    m = next(re.search(r"(\d+) diffuse stores / (\d+) emitted, (\d+) "
                       r"caustic stores / (\d+) emitted", ln)
             for ln in lines if "diffuse stores" in ln)
    return port, ref, [int(x) for x in m.groups()]


def test_photonmap_image_matches_reference(photon_renders):
    port, ref, _ = photon_renders
    img = port.image
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05
    rmse = float(np.sqrt(np.mean((img.astype(np.float64)
                                  - np.asarray(ref.image)) ** 2)))
    assert rmse <= 1e-3, rmse
    r_ref, r_port = ref.stats["rays"], port.stats["rays"]
    assert abs(r_port - r_ref) <= 1e-3 * r_ref, (r_ref, r_port)


def test_photonmap_stored_photons_match_reference(photon_renders):
    port, _, (d_ref, d_em, c_ref, c_em) = photon_renders
    info = port.stats["photon_maps"]
    assert info["diffuse"]["emitted"] == d_em == 16384
    assert info["caustic"]["emitted"] == c_em == 8192
    assert d_ref > 1000
    # no specular surface: the caustic map stores nothing in either
    for got, want in ((info["diffuse"]["stored"], d_ref),
                      (info["caustic"]["stored"], c_ref)):
        assert abs(got - want) <= 1e-3 * max(want, 1), (got, want)


def test_sppm_matches_reference(at_repo_root):
    port = render_scene(_lights_scene(parse_xml_file, "SPPM", 1,
                                      **SPPM_PARAMS), device="cpu")
    ref = ref_render_scene(_lights_scene(ref_parse, "SPPM", 1,
                                         **SPPM_PARAMS))
    assert port.stats["passes"] == ref.stats["passes"] == 2
    img = port.image
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05
    assert _rmse(ref.image, img) <= 1e-3
    assert _rmse(ref.film["density"], port.film["density"].numpy()) <= 1e-3
    assert port.stats["rays"] == ref.stats["rays"] > 0


def test_indirect_photon_pass_matches_reference(at_repo_root):
    s = _lights_scene(parse_xml_file, "SPPM", 1, **SPPM_PARAMS)
    rs = _lights_scene(ref_parse, "SPPM", 1, **SPPM_PARAMS)
    cs, rcs = s.compile(device="cpu"), rs.compile()
    cfg, rcfg = build_config(s), ref_build(rs)
    cdf, _ = _light_cdf(cs.static, cs.arrays["lights"])
    rcdf, rflux = ref_cdf(rcs.static, rcs.arrays)
    assert np.array_equal(cdf, rcdf)
    rec = photon_shoot.make_photon_pass(cs.static, cfg, 16384,
                                        cfg.photon_bounces, "indirect")(
        convert.to_tensors(cs.arrays, "cpu"), cdf, 31337)
    rrec = jax.jit(ref_shoot.make_photon_pass(rcs.static, rcfg, 16384,
                                              rcfg.photon_bounces,
                                              "indirect"))(
        rcs.arrays, jnp.asarray(rcdf), rflux, jnp.uint32(31337))
    got, want = int(rec["valid"].sum()), int(jnp.sum(rrec["valid"]))
    assert want > 1000 and abs(got - want) <= 1e-3 * want, (got, want)
    p_got = rec["power"][rec["valid"]].sum(0).numpy()
    p_want = np.asarray(rrec["power"])[np.asarray(rrec["valid"])].sum(0)
    np.testing.assert_allclose(p_got, p_want, rtol=1e-3)


@pytest.fixture(scope="module")
def bdpt_renders():
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        yield (render_scene(_lights_scene(parse_xml_file, "bidirectional",
                                          2), device="cpu"),
               ref_render_scene(_lights_scene(ref_parse, "bidirectional",
                                              2)))
    finally:
        os.chdir(cwd)


def test_bdpt_image_and_rays_match_reference(bdpt_renders):
    port, ref = bdpt_renders
    img = port.image
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05
    assert _rmse(ref.image, img) <= 1e-4
    assert port.stats["rays"] == ref.stats["rays"] > 0
    assert port.stats["bdpt_steps"] == ref.stats["bdpt_steps"] == 2


def test_bdpt_density_plane_matches_reference(bdpt_renders):
    """The t=1 splats (light vertices connected to the camera): the point,
    spot, sphere and meshlight subpaths all reach the film."""
    port, ref = bdpt_renders
    dens = port.film["density"].numpy()
    assert float(dens.max()) > 0.0
    assert _rmse(ref.film["density"], dens) <= 1e-5
