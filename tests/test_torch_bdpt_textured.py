"""BDPT on a textured scene, the port against the JAX reference on the CPU:
scenes/ibl_spheres.xml (a textureback env.hdr with its IBL light, a
mipmapped checker.png floor, glass and glossy spheres) with its integrator
set to bidirectional at raydepth 3, 16², 2 spp, through `render_scene`.

This holds what scenes/cornell_bidir.xml does not reach: the texture step
at footprint 0 (BDPT's vertices sample mip level 0), the escape term with
weight 1 and the texture background.  The scene's only light is its IBL
light, which BDPT leaves to the escape term: no light subpath is built and
no shadow ray is traced, so the strategies themselves are held by
tests/test_torch_bdpt.py.  Bounds as tests/test_torch_render.py's: image
RMSE <= 1e-4, rays equal.  The reference renders once (~20 s, most of it
its XLA compile), in a module fixture."""
import os

import numpy as np
import pytest
import torch

from libyafaray_tpu.scene.session import render_scene as ref_render_scene
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch.io.rgbe import read_hdr
from libyafaray_tpu_torch.io.image import load_image
from libyafaray_tpu_torch.ops import intersect as isect
from libyafaray_tpu_torch.scene.session import build_config, render_scene
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IBL = os.path.join(REPO, "scenes", "ibl_spheres.xml")
ASSETS = {"tex_0": ("env.hdr", (64, 128, 3)),
          "tex_1": ("checker.png", (128, 128, 3))}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def repo_cwd():
    """The scene names its assets relative to the repository root."""
    old = os.getcwd()
    os.chdir(REPO)
    yield
    os.chdir(old)


def _scene(parse):
    s = parse(IBL)
    s.render_params.update(width=16, height=16, AA_minsamples=2)
    s.integrator_params["default"].update(type="bidirectional", raydepth=3)
    return s


def _assets_loaded(arrays):
    """The two textures are their files, not the 16 x 16 stand-in of a
    failed load, and the background's map is env.hdr."""
    for key, (name, shape) in ASSETS.items():
        got = np.asarray(arrays[key])
        want = load_image(os.path.join(REPO, "scenes", "assets", name))
        assert got.shape == shape, key
        np.testing.assert_array_equal(got, want[..., :3])
    np.testing.assert_array_equal(
        np.asarray(arrays["bg_image"]),
        read_hdr(os.path.join(REPO, "scenes", "assets", "env.hdr")))


@pytest.fixture(scope="module")
def renders(repo_cwd):
    ref_s = _scene(ref_parse)
    _assets_loaded(ref_s.compile().arrays)
    port_s = _scene(parse_xml_file)
    _assets_loaded(port_s.compile(device="cpu").arrays)
    calls = dict(closest_hit=0, shadow_transmission=0)
    saved = {k: getattr(isect, k) for k in calls}

    def counting(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    for k, fn in saved.items():
        setattr(isect, k, counting(k, fn))
    try:
        port = render_scene(port_s, device="cpu")
    finally:
        for k, fn in saved.items():
            setattr(isect, k, fn)
    return ref_render_scene(ref_s), port, calls


def test_textured_bdpt_config(repo_cwd):
    s = _scene(parse_xml_file)
    cfg = build_config(s)
    cs = s.compile(device="cpu")
    assert (cfg.integrator, cfg.raydepth) == ("bidirectional", 3)
    assert [ls.ltype for ls in cs.static.lights] == [7]  # the IBL light
    assert cs.static.textures and cs.static.n_spheres == 2


def test_textured_bdpt_matches_reference(renders):
    ref, port, _ = renders
    img = port.image
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.min() >= 0.0 and img.mean() > 0.05
    rmse = float(np.sqrt(np.mean((np.asarray(ref.image, np.float64)
                                  - img) ** 2)))
    assert rmse <= 1e-4, rmse
    assert port.stats["rays"] == ref.stats["rays"] == 16 * 16 * 2 * 6


def test_textured_bdpt_builds_no_light_subpath(renders):
    """No light subpath: the density plane stays 0, the triangle
    intersector sees the eye walk's 3 closest-hit batches a step and no
    shadow batch."""
    _, port, calls = renders
    assert float(port.film["density"].abs().max()) == 0.0
    assert calls == dict(closest_hit=3 * 2, shadow_transmission=0)
