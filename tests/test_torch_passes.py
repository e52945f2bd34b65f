"""The port's render passes (libyafaray_tpu_torch/film/passes.py, the
engine's first-hit aux planes and tagged reflect / refract planes, the BDPT
step's first-hit planes) against the JAX reference's, on the same inputs:

- scenes/cornell.xml as pathtracing, 24², 4 spp, bounces 2, ao_samples 4,
  with the 28 passes of tests/test_passes.py (the reference's own set-up);
- scenes/ibl_passes.xml (ibl_spheres.xml's scene with every pass, alpha
  and bg_transp_refract) at 16², 2 spp, bounces 5;
- the Cornell passes at spp_batch 2;
- ibl_passes.xml as bidirectional (raydepth 3), its first-hit planes.

Each plane is held to max abs <= 1e-4 · max(1, |plane|max), the index
planes (mat-index-*, obj-index-*) equal, the rays equal.  The shadow pass
may also differ in one pixel of 500 by whole samples: a shadow ray that
grazes the Cornell ceiling toward the ceiling's light flips between hit
and miss on the ulp by which the reference's compiled step (XLA contracts
multiply-adds) places its ends; on the same rays both packages give the
same transmission.  The reference's dense step cannot render plain-sum
passes at spp_batch > 1 (its mask is not tiled over the batch: a
broadcast error), so the port's spp_batch 2 planes are held to the
reference's spp_batch 1 render of the same samples.

The port alone: a stacked splat of several planes bit-equal to one splat
a plane (dense and compact); the image with passes on bit-equal to the
image without; compact adaptive passes bit-equal to dense ones with
passes (tests/test_compact.py's scene and passes); and the semantics of
tests/test_passes.py on the port's planes.
"""
import os

import numpy as np
import pytest
import torch

from libyafaray_tpu.integrators.config import RenderConfig as RefConfig
from libyafaray_tpu.integrators.render import render as ref_render
from libyafaray_tpu.integrators.veach import render_bdpt as ref_render_bdpt
from libyafaray_tpu.scene.session import build_config as ref_build
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch.film.imagefilm import (splat_plane,
                                                 splat_plane_compact)
from libyafaray_tpu_torch.integrators.config import RenderConfig
from libyafaray_tpu_torch.integrators.render import render
from libyafaray_tpu_torch.integrators.veach import render_bdpt
from libyafaray_tpu_torch.scene.session import build_config
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "cornell.xml")
IBL_PASSES = os.path.join(REPO, "scenes", "ibl_passes.xml")

ALL_PASSES = (
    "z-depth-abs", "z-depth-norm", "mist", "normal-smooth", "normal-geom",
    "uv", "mat-index-abs", "mat-index-norm", "mat-index-auto",
    "mat-index-mask", "obj-index-abs", "obj-index-auto", "diffuse-color",
    "emit", "direct", "ao", "ao-clay", "shadow", "reflect", "refract",
    "debug-nu", "debug-nv", "debug-dpdu", "debug-dpdv",
    "edge", "toon", "indirect", "diffuse-indirect",
)
CORNELL_CFG = dict(integrator="pathtracing", bounces=2, width=24, height=24,
                   aa_samples=4, aa_passes=1, passes=ALL_PASSES,
                   ao_samples=4)
IBL_CFG = dict(width=16, height=16, aa_samples=2, aa_passes=1)
BDPT_PASSES = ("z-depth-norm", "normal-smooth", "normal-geom", "uv",
               "mat-index-abs", "obj-index-abs", "diffuse-color")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU path is many small tensor ops: one thread runs them
    fastest.  The IBL scene names its assets relative to the repository
    root."""
    n = torch.get_num_threads()
    cwd = os.getcwd()
    torch.set_num_threads(1)
    os.chdir(REPO)
    yield
    os.chdir(cwd)
    torch.set_num_threads(n)


def _pair(path, **over):
    """(reference result, port result) of one scene and config, through
    the path tracer's render (BDPT's render_bdpt for bidirectional)."""
    size = dict(width=over.get("width", 16), height=over.get("height", 16))
    bdpt = over.get("integrator") == "bidirectional"
    s = ref_parse(path)
    s.render_params.update(size)
    ref = (ref_render_bdpt if bdpt else ref_render)(
        s.compile(), RefConfig(**{**ref_build(s).__dict__, **over}))
    s = parse_xml_file(path)
    s.render_params.update(size)
    port = (render_bdpt if bdpt else render)(
        s.compile(device="cpu"),
        RenderConfig(**{**build_config(s).__dict__, **over}), device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def cornell():
    return _pair(CORNELL, **CORNELL_CFG)


@pytest.fixture(scope="module")
def ibl():
    return _pair(IBL_PASSES, **IBL_CFG)


def _planes_match(name, ref, port, shadow_flips=0):
    assert ref.shape == port.shape, name
    assert np.isfinite(port).all(), name
    if "-index-" in name:
        np.testing.assert_array_equal(port, ref, err_msg=name)
        return
    d = np.abs(port - ref)
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    bad = d.max(axis=-1) > tol
    if name == "shadow" and shadow_flips:
        # whole samples of one light's transmission: at most one pixel in
        # 500
        assert bad.sum() <= max(1, bad.size // 500), (name, bad.sum())
        return
    assert not bad.any(), (name, float(d.max()), tol)


@pytest.mark.parametrize("name", ALL_PASSES)
def test_cornell_pass_planes_match_reference(cornell, name):
    ref, port = cornell
    _planes_match(name, ref.passes[name], port.passes[name],
                  shadow_flips=1)


def test_cornell_rays_image_and_semantics(cornell):
    """Rays equal, the image within 1e-4, and tests/test_passes.py's
    assertions on the port's planes."""
    ref, port = cornell
    assert port.stats["rays"] == ref.stats["rays"] > 0
    assert np.abs(port.image - ref.image).max() < 1e-4
    planes = port.passes
    assert len(planes) == len(ALL_PASSES)
    sh = planes["shadow"]
    assert sh.min() >= -1e-6 and sh.max() <= 1.0 + 1e-6
    assert (sh < 0.95).any()
    clay = planes["ao-clay"]
    assert np.allclose(clay[..., 0], clay[..., 1])
    assert planes["reflect"].max() < 1e-4 and planes["refract"].max() < 1e-4
    ind = planes["indirect"]
    assert ind.min() >= 0.0 and ind.mean() > 1e-3
    cols = {tuple(np.round(c, 3))
            for c in planes["mat-index-auto"].reshape(-1, 3)}
    assert len(cols) >= 2
    assert set(np.unique(planes["mat-index-mask"])).issubset({0.0, 1.0})
    hit = planes["z-depth-abs"][..., 0] > 0
    for key in ("debug-nu", "debug-dpdu"):
        ln = np.linalg.norm(planes[key], axis=-1)
        assert (ln[hit] <= 1.0 + 1e-3).all() and np.median(ln[hit]) > 0.99
    dot = np.abs((planes["debug-dpdu"] * planes["debug-dpdv"]).sum(-1))
    assert np.median(dot[hit]) < 0.1


def test_passes_leave_the_image_unchanged(cornell):
    """The image and rays with all 28 passes on equal those with none, bit
    for bit (the passes only read the path's values)."""
    _, port = cornell
    s = parse_xml_file(CORNELL)
    s.render_params["width"] = s.render_params["height"] = 24
    cfg = RenderConfig(**{**build_config(s).__dict__, **CORNELL_CFG,
                          "passes": ()})
    plain = render(s.compile(device="cpu"), cfg, device="cpu")
    assert np.array_equal(plain.image, port.image)
    assert plain.stats["rays"] == port.stats["rays"]
    assert not any(k.startswith("aov_") for k in plain.film)


@pytest.mark.parametrize("name", ALL_PASSES)
def test_ibl_pass_planes_match_reference(ibl, name):
    """ibl_passes.xml: spheres (their lat-long uv, dPdU / dPdV and
    triangle id 0), glass (refract), a glossy sphere (reflect), the
    checker's uv and colour, the IBL light's NEE and AO."""
    ref, port = ibl
    _planes_match(name, ref.passes[name], port.passes[name])


def test_ibl_alpha_and_rays_match_reference(ibl):
    ref, port = ibl
    assert port.stats["rays"] == ref.stats["rays"] > 0
    assert port.alpha.shape == (16, 16)
    np.testing.assert_allclose(port.alpha, ref.alpha, atol=1e-6)
    assert np.abs(port.image - ref.image).max() < 1e-3
    assert port.passes["refract"].max() > 0.0
    assert port.passes["reflect"].max() > 0.0


def test_spp_batch_2_planes(cornell):
    """The Cornell passes at spp_batch 2 (two steps of two samples a
    pixel): the same samples as the reference's four steps of one, held to
    its planes; the film's sample counts equal."""
    ref, _ = cornell
    s = parse_xml_file(CORNELL)
    s.render_params["width"] = s.render_params["height"] = 24
    cfg = RenderConfig(**{**build_config(s).__dict__, **CORNELL_CFG,
                          "spp_batch": 2})
    port = render(s.compile(device="cpu"), cfg, device="cpu")
    assert port.stats["rays"] == ref.stats["rays"]
    assert np.array_equal(port.film["nsamples"].numpy(),
                          np.asarray(ref.film["nsamples"]))
    for name in ALL_PASSES:
        _planes_match(name, ref.passes[name], port.passes[name],
                      shadow_flips=1)


def test_bdpt_first_hit_planes_match_reference():
    """ibl_passes.xml as bidirectional (raydepth 3, 16², 2 spp): the eye
    path's first-hit planes; the film keeps no alpha plane (as the
    reference's BDPT)."""
    ref, port = _pair(IBL_PASSES, integrator="bidirectional", raydepth=3,
                      passes=BDPT_PASSES, **IBL_CFG)
    assert port.stats["rays"] == ref.stats["rays"] > 0
    assert port.alpha is None and ref.alpha is None
    for name in BDPT_PASSES:
        _planes_match(name, ref.passes[name], port.passes[name])


def _compact_scene(res=48, aa_passes=3, threshold=0.08):
    """tests/test_compact.py's scene (a floor, an emissive quad, an area
    light) with its adaptive settings and passes, and the alpha plane."""
    from libyafaray_tpu_torch.scene.params import ParamMap
    from libyafaray_tpu_torch.scene.scene import Scene
    from test_torch_adaptive import _floor_and_lamp

    s = _floor_and_lamp(Scene, ParamMap, res)
    s.render_params.update({
        "AA_passes": aa_passes, "AA_inc_samples": 1,
        "AA_threshold": threshold,
        "render_passes": "z-depth-norm normal-smooth reflect",
        "bg_transp": True})
    return s


def test_compact_passes_equal_dense_with_planes():
    """Adaptive passes over compact lane lists splat the pass and alpha
    planes as the dense masked passes do: every film plane bit-equal."""
    s = _compact_scene()
    cfg = build_config(s)
    cs = s.compile(device="cpu")
    comp = render(cs, cfg, device="cpu")
    dense = render(cs, cfg, device="cpu", compact=False)
    assert "compact" in [e["mode"] for e in comp.stats["pass_log"]]
    assert set(comp.film) == set(dense.film)
    assert {"aov_z", "aov_normal", "aov_reflect", "alpha"} <= set(comp.film)
    for k in comp.film:
        assert torch.equal(comp.film[k], dense.film[k]), k
    assert comp.alpha.min() >= 0.0 and comp.alpha.max() > 0.99


@pytest.mark.parametrize("compact", [False, True])
def test_stacked_splat_equals_splat_per_plane(compact):
    """One splat of planes stacked on the channel axis gives each plane's
    own splat bit for bit (the taps' weights are per lane, the products
    per channel)."""
    rng = np.random.default_rng(5)
    h = w = 6
    spb = 2
    planes = [rng.normal(size=(spb, h * w, c)).astype(np.float32)
              for c in (1, 3, 3)]
    sx, sy = (torch.from_numpy(rng.random((spb, h * w)).astype(np.float32))
              for _ in range(2))
    act = torch.from_numpy((rng.random((spb, h * w)) > 0.2).astype(
        np.float32))
    vals = [torch.from_numpy(p) for p in planes]
    pix = torch.from_numpy(rng.permutation(h * w).astype(np.int32))
    pix[:3] = -1

    def run(val, acc):
        if compact:
            return splat_plane_compact(acc, val, pix, sx, sy, act, "gauss",
                                       1.5)
        shape = (spb, h, w)
        return splat_plane(acc, val.reshape(shape + (-1,)),
                           sx.reshape(shape), sy.reshape(shape),
                           act.reshape(shape), "gauss", 1.5)

    stacked = run(torch.cat(vals, dim=-1), torch.zeros((h, w, 7)))
    c = 0
    for v in vals:
        one = run(v, torch.zeros((h, w, v.shape[-1])))
        assert torch.equal(stacked[..., c:c + v.shape[-1]], one)
        c += v.shape[-1]


def test_plain_film_pays_nothing_for_the_config_passes():
    """A step over the plain film (render_timed's) dispatches the same ops
    and gives the same film whether or not the config asks for passes and
    alpha: the film's planes, not the config, decide the work."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from libyafaray_tpu_torch.convert import to_tensors
    from libyafaray_tpu_torch.integrators.engine import make_sample_step
    from libyafaray_tpu_torch.integrators.render import _fresh_film

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            return func(*args, **(kwargs or {}))

    s = parse_xml_file(IBL_PASSES)
    s.render_params["width"] = s.render_params["height"] = 8
    cfg = build_config(s)
    cs = s.compile(device="cpu")
    arrays = to_tensors(cs.arrays, "cpu")
    flags = torch.ones((8, 8), dtype=torch.bool)
    out = []
    for c in (cfg, RenderConfig(**{**cfg.__dict__, "passes": (),
                                   "transp_background": False})):
        step = make_sample_step(cs.static, cs.camera, c, "cpu")
        step(arrays, _fresh_film(c, "cpu"), flags)  # fills tables once
        with Count() as n:
            film = step(arrays, _fresh_film(c, "cpu"), flags)
        out.append((n.ops, film))
    assert cfg.passes and out[0][0] == out[1][0]
    assert set(out[0][1]) == set(out[1][1])
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k
