"""The port's alpha plane (film_init(with_alpha=), the engine's camera-
visibility chain `track` / `transp`, bg_transp and bg_transp_refract)
against the JAX reference's, on the four scenes of tests/test_alpha.py: an
opaque quad, a semi-transparent one (transparency 0.6), and a glass quad
without and with bg_transp_refract, each in front of a constant background
under directlighting at 32² (4, 64, 32 and 32 spp).  The alpha planes are
held to atol 1e-6 and the images to 1e-4, and the reference test's
assertions hold on the port's planes; without bg_transp the port's film
keeps no alpha plane, and `premult` parses as the reference parses it."""
import numpy as np
import pytest
import torch

from libyafaray_tpu.scene.session import render_scene as ref_render_scene
from libyafaray_tpu.scene.xml_parser import parse_xml_string as ref_parse
from libyafaray_tpu_torch.scene.session import build_config, render_scene
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_string
from test_alpha import GLASS, OPAQUE, SEMI, _center_border, _scene_xml


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {
    "opaque": (OPAQUE, "", 4),
    "semi": (SEMI, "", 64),
    "glass": (GLASS, "", 32),
    "glass_refract": (GLASS, '<bg_transp_refract bval="true"/>', 32),
}


@pytest.mark.parametrize("case", list(CASES))
def test_alpha_matches_reference(case):
    mat, extra, spp = CASES[case]
    xml = _scene_xml(mat, extra, spp=spp)
    ref = ref_render_scene(ref_parse(xml))
    port = render_scene(parse_xml_string(xml), device="cpu")
    assert port.alpha.shape == ref.alpha.shape == (32, 32)
    np.testing.assert_allclose(port.alpha, ref.alpha, atol=1e-6)
    assert np.abs(port.image - ref.image).max() < 1e-4
    assert port.stats["rays"] == ref.stats["rays"]
    center, border = _center_border(port.alpha)
    if case == "opaque":
        assert center.mean() > 0.99 and border.mean() < 0.01
        assert port.image[:2, :2].mean() > 0.05
    elif case == "semi":
        assert abs(center.mean() - 0.4) < 0.08 and border.mean() < 0.01
    elif case == "glass":
        assert center.mean() > 0.95
    else:
        assert center.mean() < 0.25


def test_no_alpha_without_bg_transp():
    xml = _scene_xml(OPAQUE, spp=2).replace('<bg_transp bval="true"/>', "")
    res = render_scene(parse_xml_string(xml), device="cpu")
    assert res.alpha is None and "alpha" not in res.film


def test_premult_parses():
    cfg = build_config(parse_xml_string(_scene_xml(
        OPAQUE, '<premult bval="true"/>', spp=2)))
    assert cfg.premult_alpha and cfg.transp_background
