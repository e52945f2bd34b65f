"""scenes/cornell_lights.xml as bidirectional (raydepth 4, 16², 2 spp),
the port against the JAX package on the CPU: the light subpaths start on
the meshlight, point, spot and sphere lights (picked by flux), the s = 1
resampling takes the spot's falloff, the sun, directional and IES lights
arrive through the weight-1 eye-side NEE.  Image RMSE <= 1e-4, rays
equal, the t=1 density plane RMSE <= 1e-5.  The scene names its IES file
relative to the repository root: the module runs from there.
"""
import os

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
    s.integrator_params["default"]["type"] = "bidirectional"
    return s


def _rmse(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64)
                                  - np.asarray(b, np.float64)) ** 2)))


@pytest.fixture(scope="module")
def renders():
    n = torch.get_num_threads()
    cwd = os.getcwd()
    torch.set_num_threads(1)
    os.chdir(REPO)
    try:
        yield (render_scene(_scene(parse_xml_file), device="cpu"),
               ref_render_scene(_scene(ref_parse)))
    finally:
        os.chdir(cwd)
        torch.set_num_threads(n)


def test_bdpt_image_and_rays_match_reference(renders):
    port, ref = renders
    img = port.image
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05
    assert _rmse(ref.image, img) <= 1e-4
    assert port.stats["rays"] == ref.stats["rays"] > 0
    assert port.stats["bdpt_steps"] == ref.stats["bdpt_steps"] == 2


def test_bdpt_density_plane_matches_reference(renders):
    """The t=1 splats (light vertices connected to the camera): the point,
    spot, sphere and meshlight subpaths all reach the film."""
    port, ref = renders
    dens = port.film["density"].numpy()
    assert float(dens.max()) > 0.0
    assert _rmse(ref.film["density"], dens) <= 1e-5
