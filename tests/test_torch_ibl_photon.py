"""The IBL light in photon mapping, the port against the JAX reference on
the CPU: scenes/ibl_spheres.xml with an area light added above the
spheres (`ibl_scene`), so the photon maps hold the area light's photons
while the IBL light (zero photon flux, as the reference's light_flux
gives it) lights the hit points through NEE and the background shows at
escapes and in the final gather.  16², 2 spp, 4,096 + 2,048 photons,
final gather 2, raydepth 3: image RMSE <= 1e-4, rays within 0.01%
(tests/test_torch_photon.py's bounds).  tests/test_torch_ibl_sppm.py
does the same for SPPM."""
import os

import numpy as np
import pytest
import torch

from libyafaray_tpu.scene.session import render_scene as ref_render_scene
from libyafaray_tpu.scene.xml_parser import parse_xml_string as ref_parse
from libyafaray_tpu_torch.scene.session import render_scene
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_string

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIGHT = """
  <light name="panel">
    <type sval="arealight"/>
    <corner x="-0.5" y="-0.5" z="4.0"/>
    <point1 x="0.5" y="-0.5" z="4.0"/>
    <point2 x="-0.5" y="0.5" z="4.0"/>
    <color r="1" g="1" b="1"/>
    <power fval="20.0"/>
    <samples ival="2"/>
  </light>
"""
INTEGRATORS = {
    "SPPM": dict(type="SPPM", photons=4096, passNums=2, raydepth=3),
    "photonmapping": dict(type="photonmapping", photons=4096, cPhotons=2048,
                          fg_samples=2, raydepth=3),
}


def ibl_scene(parse, integrator: str):
    """ibl_spheres.xml with the area light, at 16², 2 spp, with the
    integrator's small settings."""
    with open(os.path.join(REPO, "scenes", "ibl_spheres.xml")) as f:
        xml = f.read().replace("</scene>", LIGHT + "</scene>")
    s = parse(xml)
    s.render_params.update(width=16, height=16, AA_minsamples=2)
    s.integrator_params["default"].update(INTEGRATORS[integrator])
    return s


def match_reference(integrator: str) -> None:
    ref = ref_render_scene(ibl_scene(ref_parse, integrator))
    port = render_scene(ibl_scene(parse_xml_string, integrator),
                        device="cpu")
    assert port.cfg.integrator == integrator
    img = port.image
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05
    rmse = float(np.sqrt(np.mean((img.astype(np.float64)
                                  - np.asarray(ref.image)) ** 2)))
    assert rmse <= 1e-4, rmse
    r_ref, r_port = ref.stats["rays"], port.stats["rays"]
    assert abs(r_port - r_ref) <= 1e-4 * r_ref, (r_ref, r_port)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def repo_cwd(monkeypatch):
    """The scene names its assets relative to the repository root."""
    monkeypatch.chdir(REPO)


def test_ibl_photonmapping_matches_reference():
    match_reference("photonmapping")
