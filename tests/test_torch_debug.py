"""The DebugIntegrator (integrators/debug.py) in the port against the JAX
reference on the CPU: every debug image (N, Ng, dPdU, dPdV, NU, NV, UV, t)
of scenes/cornell.xml (triangles only) and scenes/cornell_bidir.xml (with
its two analytic spheres) at 16², atol 1e-6, except the hit distance t
(~9 scene units, where a float32 ulp is ~1e-6): rtol 1e-6, since the
reference's compiled intersection contracts multiply-adds and the port's
rounds each; and `render_scene`, which renders the "N" image as the
reference's session does."""
import os

import numpy as np
import pytest

from libyafaray_tpu.integrators.debug import render_debug as ref_debug
from libyafaray_tpu.scene.session import build_config as ref_build
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch.integrators.debug import DEBUG_TYPES, render_debug
from libyafaray_tpu_torch.scene.session import build_config, render_scene
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = {name: os.path.join(REPO, "scenes", f"{name}.xml")
          for name in ("cornell", "cornell_bidir")}


def _scene(parse, name, size=16):
    s = parse(SCENES[name])
    s.render_params.update(width=size, height=size)
    s.integrator_params["default"]["type"] = "DebugIntegrator"
    return s


@pytest.fixture(scope="module")
def compiled():
    out = {}
    for name in SCENES:
        rs, ps = _scene(ref_parse, name), _scene(parse_xml_file, name)
        out[name] = (rs.compile(), ref_build(rs),
                     ps.compile(device="cpu"), build_config(ps))
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("debug_type", DEBUG_TYPES)
def test_debug_image_matches_reference(compiled, name, debug_type):
    rcs, rcfg, pcs, pcfg = compiled[name]
    want = ref_debug(rcs, rcfg, debug_type).image
    got = render_debug(pcs, pcfg, debug_type, device="cpu")
    img = got.image
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    # cornell.xml's meshes carry no uv: its UV image is black
    assert float(np.abs(img).max()) > 0.0 or (name, debug_type) == (
        "cornell", "UV")
    tol = dict(rtol=1e-6, atol=0) if debug_type == "t" else dict(
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(img, np.asarray(want), **tol)
    assert got.stats["rays"] == 16 * 16


def test_render_scene_renders_the_normals():
    s = _scene(parse_xml_file, "cornell", size=8)
    assert build_config(s).integrator == "DebugIntegrator"
    res = render_scene(s, device="cpu")
    want = render_debug(s.compile(device="cpu"), build_config(s), "N",
                        device="cpu")
    assert np.array_equal(res.image, want.image)
    hit = res.image.max(axis=-1) > 0.0
    assert hit.any() and (res.image[hit] <= 1.0).all()
