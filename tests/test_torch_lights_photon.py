"""scenes/cornell_lights.xml as photonmapping (16,384 diffuse and 8,192
caustic photons, final gather 4, 16², 2 spp), the port against the JAX
package on the CPU: the power CDF over every light type (the meshlight's
flux enters it, its photons leave with zero flux, as the reference's do;
sun, directional and IES emit none), the point, spot and sphere emitters.
Image RMSE <= 1e-3, the diffuse and caustic maps' stored photons within
0.1% of the reference's (its log line), rays within 0.1%.  The scene
names its IES file relative to the repository root: the module runs from
there.
"""
import logging
import os
import re

import numpy as np
import pytest
import torch

from libyafaray_tpu.scene.session import render_scene as ref_render_scene
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch.scene.session import render_scene
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIGHTS_XML = os.path.join(REPO, "scenes", "cornell_lights.xml")


def _scene(parse):
    s = parse(LIGHTS_XML)
    s.render_params.update(width=16, height=16, AA_minsamples=2)
    s.integrator_params["default"]["type"] = "photonmapping"
    s.integrator_params["default"].update(photons=16384, cPhotons=8192,
                                          fg_samples=4)
    return s


@pytest.fixture(scope="module")
def renders():
    n = torch.get_num_threads()
    cwd = os.getcwd()
    torch.set_num_threads(1)
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
        port = render_scene(_scene(parse_xml_file), device="cpu")
        ref = ref_render_scene(_scene(ref_parse))
    finally:
        logger.removeHandler(h)
        logger.setLevel(level)
        os.chdir(cwd)
        torch.set_num_threads(n)
    m = next(re.search(r"(\d+) diffuse stores / (\d+) emitted, (\d+) "
                       r"caustic stores / (\d+) emitted", ln)
             for ln in lines if "diffuse stores" in ln)
    return port, ref, [int(x) for x in m.groups()]


def test_photonmap_image_matches_reference(renders):
    port, ref, _ = renders
    img = port.image
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05
    rmse = float(np.sqrt(np.mean((img.astype(np.float64)
                                  - np.asarray(ref.image)) ** 2)))
    assert rmse <= 1e-3, rmse
    r_ref, r_port = ref.stats["rays"], port.stats["rays"]
    assert abs(r_port - r_ref) <= 1e-3 * r_ref, (r_ref, r_port)


def test_photonmap_stored_photons_match_reference(renders):
    port, _, (d_ref, d_em, c_ref, c_em) = renders
    info = port.stats["photon_maps"]
    assert info["diffuse"]["emitted"] == d_em == 16384
    assert info["caustic"]["emitted"] == c_em == 8192
    assert d_ref > 1000
    # no specular surface: the caustic map stores nothing in either
    for got, want in ((info["diffuse"]["stored"], d_ref),
                      (info["caustic"]["stored"], c_ref)):
        assert abs(got - want) <= 1e-3 * max(want, 1), (got, want)
