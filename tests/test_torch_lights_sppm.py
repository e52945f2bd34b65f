"""scenes/cornell_lights.xml as SPPM (2 passes of 16,384 photons, 16²),
the port against the JAX package on the CPU: image and density layer RMSE
<= 1e-3, rays equal; one `indirect` photon pass of 16,384 lanes from
every light type (make_photon_pass of both packages, the same seed): the
stored photons within 0.1%, and the emitted power of each stored
photon's light type present.  The scene names its IES file relative to
the repository root: the module runs from there.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu.integrators.photon_shoot import \
    make_photon_pass as ref_photon_pass
from libyafaray_tpu.integrators.photonmap import _light_cdf as ref_cdf
from libyafaray_tpu.scene.session import build_config as ref_build
from libyafaray_tpu.scene.session import render_scene as ref_render_scene
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch.convert import to_tensors
from libyafaray_tpu_torch.integrators.photon_shoot import make_photon_pass
from libyafaray_tpu_torch.integrators.photonmap import _light_cdf
from libyafaray_tpu_torch.scene.session import build_config, render_scene
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIGHTS_XML = os.path.join(REPO, "scenes", "cornell_lights.xml")


def _scene(parse):
    s = parse(LIGHTS_XML)
    s.render_params.update(width=16, height=16, AA_minsamples=1)
    s.integrator_params["default"]["type"] = "SPPM"
    s.integrator_params["default"].update(photons=16384, passNums=2)
    return s


@pytest.fixture(scope="module", autouse=True)
def one_thread_at_repo_root():
    n = torch.get_num_threads()
    cwd = os.getcwd()
    torch.set_num_threads(1)
    os.chdir(REPO)
    yield
    os.chdir(cwd)
    torch.set_num_threads(n)


def _rmse(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64)
                                  - np.asarray(b, np.float64)) ** 2)))


def test_sppm_matches_reference():
    port = render_scene(_scene(parse_xml_file), device="cpu")
    ref = ref_render_scene(_scene(ref_parse))
    assert port.stats["passes"] == ref.stats["passes"] == 2
    img = port.image
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05
    assert _rmse(ref.image, img) <= 1e-3
    assert _rmse(ref.film["density"], port.film["density"].numpy()) <= 1e-3
    assert port.stats["rays"] == ref.stats["rays"] > 0


def test_indirect_photon_pass_matches_reference():
    s, rs = _scene(parse_xml_file), _scene(ref_parse)
    cs, rcs = s.compile(device="cpu"), rs.compile()
    cfg, rcfg = build_config(s), ref_build(rs)
    cdf, _ = _light_cdf(cs.static, cs.arrays["lights"])
    rcdf, rflux = ref_cdf(rcs.static, rcs.arrays)
    assert np.array_equal(cdf, rcdf)
    rec = make_photon_pass(cs.static, cfg, 16384, cfg.photon_bounces,
                           "indirect")(to_tensors(cs.arrays, "cpu"), cdf,
                                       31337)
    rrec = jax.jit(ref_photon_pass(rcs.static, rcfg, 16384,
                                   rcfg.photon_bounces, "indirect"))(
        rcs.arrays, jnp.asarray(rcdf), rflux, jnp.uint32(31337))
    got, want = int(rec["valid"].sum()), int(jnp.sum(rrec["valid"]))
    assert want > 1000 and abs(got - want) <= 1e-3 * want, (got, want)
    p_got = rec["power"][rec["valid"]].sum(0).numpy()
    p_want = np.asarray(rrec["power"])[np.asarray(rrec["valid"])].sum(0)
    np.testing.assert_allclose(p_got, p_want, rtol=1e-3)
