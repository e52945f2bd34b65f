"""scenes/cornell_lights.xml (a meshlight, point, soft-shadowed spot,
sphere, IES, sun and directional lights) and the portal room of the
reference's tests, rendered by the port and the JAX package on the CPU
from the same scene and the same QMC stream, 16², 2 spp: as pathtracing
(the scene's own integrator) and as directlighting, image RMSE <= 1e-4
and rays equal; the portal room (a bgPortalLight over an open box top,
directlighting) RMSE <= 1e-4.  The port rendering from the reference's
compiled scene (convert.arrays_from_reference / static_from_reference)
gives the same bits as from its own compile.  The scene names its IES
file relative to the repository root: the module runs from there.
"""
import os

import numpy as np
import pytest
import torch

from libyafaray_tpu.scene.params import ParamMap as RefParamMap
from libyafaray_tpu.scene.scene import Scene as RefScene
from libyafaray_tpu.scene.session import render_scene as ref_render_scene
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch import convert
from libyafaray_tpu_torch.integrators.render import render
from libyafaray_tpu_torch.scene.params import ParamMap
from libyafaray_tpu_torch.scene.scene import CompiledScene, Scene
from libyafaray_tpu_torch.scene.session import build_config, render_scene
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIGHTS_XML = os.path.join(REPO, "scenes", "cornell_lights.xml")


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
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def lights_scene(parse, integrator=None, size=16, spp=2, **params):
    s = parse(LIGHTS_XML)
    s.render_params.update(width=size, height=size, AA_minsamples=spp)
    if integrator:
        s.integrator_params["default"]["type"] = integrator
    s.integrator_params["default"].update(params)
    return s


@pytest.mark.parametrize("integrator", ["pathtracing", "directlighting"])
def test_cornell_lights_matches_reference(integrator):
    port = render_scene(lights_scene(parse_xml_file, integrator),
                        device="cpu")
    ref = ref_render_scene(lights_scene(ref_parse, integrator))
    img = port.image
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05
    assert _rmse(ref.image, img) <= 1e-4
    assert port.stats["rays"] == ref.stats["rays"] > 0


def test_render_from_reference_compile_is_bit_equal():
    """The reference's compiled scene converted (the renderer's weights
    carried across) renders the same bits as the port's own compile."""
    s = lights_scene(parse_xml_file)
    cfg = build_config(s)
    own = render(s.compile(device="cpu"), cfg, device="cpu")
    rcs = lights_scene(ref_parse).compile()
    arrays = convert.arrays_from_reference(rcs.arrays, "cpu")
    assert sorted(arrays) == sorted(convert.to_tensors(
        s.compile(device="cpu").arrays, "cpu"))
    conv = CompiledScene(
        arrays=arrays, static=convert.static_from_reference(rcs.static),
        camera=convert.camera_from_reference(rcs.camera),
        bound_min=tuple(rcs.bound_min), bound_max=tuple(rcs.bound_max))
    got = render(conv, cfg, device="cpu")
    assert np.array_equal(got.image, own.image)
    assert got.stats["rays"] == own.stats["rays"]


def portal_room(scene_cls, pm_cls, use_portal: bool, size=16, spp=8):
    """The reference's test_bg_portal_light room: an open-top box lit by a
    constant background through a portal quad over its top (or, without
    the portal, by the IBL light), directlighting, raydepth 1."""
    s = scene_cls()
    white = s.create_material("white", pm_cls({
        "type": "shinydiffusemat", "color": (0.7, 0.7, 0.7)}))
    hole = s.create_material("hole", pm_cls({"type": "null"}))
    s.create_background("bg", pm_cls({
        "type": "constant", "color": (2.0, 2.0, 2.0),
        "ibl": not use_portal, "ibl_samples": 8}))
    s.start_tri_mesh(1, has_uv=False, visibility="normal")
    for p in ((-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0),
              (-1, -1, 2), (1, -1, 2), (1, 1, 2), (-1, 1, 2)):
        s.add_vertex(*p)
    for a, b, c, d in ((0, 1, 2, 3), (0, 1, 5, 4), (1, 2, 6, 5),
                       (2, 3, 7, 6), (3, 0, 4, 7)):
        s.add_triangle(a, b, c, white)
        s.add_triangle(a, c, d, white)
    s.end_tri_mesh()
    s.start_tri_mesh(2, has_uv=False, visibility="normal")
    for p in ((-1, -1, 2.0), (1, -1, 2.0), (1, 1, 2.0), (-1, 1, 2.0)):
        s.add_vertex(*p)
    s.add_triangle(0, 2, 1, hole)
    s.add_triangle(0, 3, 2, hole)
    s.end_tri_mesh()
    if use_portal:
        s.create_light("P", pm_cls({"type": "bgPortalLight",
                                    "object_name": "2", "samples": 8}))
    s.create_camera("cam", pm_cls({
        "type": "perspective", "resx": size, "resy": size,
        "from": (0.0, -0.8, 1.0), "to": (0.0, 0.5, 0.6),
        "up": (0.0, -0.8, 2.0), "focal": 0.8}))
    s.create_integrator("default", pm_cls({"type": "directlighting",
                                           "raydepth": 1}))
    s.render_params = pm_cls({"width": size, "height": size,
                              "AA_minsamples": spp, "camera_name": "cam",
                              "integrator_name": "default"})
    return s


def test_portal_room_matches_reference():
    """The portal's NEE (area samples of the portal quad, the background's
    radiance along them) and the zeroed non-specular escapes."""
    port = render_scene(portal_room(Scene, ParamMap, True), device="cpu")
    ref = ref_render_scene(portal_room(RefScene, RefParamMap, True))
    assert np.isfinite(port.image).all() and port.image.mean() > 0.05
    assert _rmse(ref.image, port.image) <= 1e-4
    assert port.stats["rays"] == ref.stats["rays"]


def test_debug_integrator_renders_cornell_lights():
    """The sixth integrator on the scene: the DebugIntegrator's N image
    (the sphere light's icosphere and the meshlight's quad are surfaces
    like any other) against the reference's, atol 1e-6."""
    port = render_scene(lights_scene(parse_xml_file, "DebugIntegrator"),
                        device="cpu")
    ref = ref_render_scene(lights_scene(ref_parse, "DebugIntegrator"))
    assert port.image.shape == (16, 16, 3)
    assert np.abs(port.image).max() > 0.0
    np.testing.assert_allclose(port.image, np.asarray(ref.image), rtol=0,
                               atol=1e-6)
