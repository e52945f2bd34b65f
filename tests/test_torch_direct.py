"""Directlighting and Beer glass in pathtracing, the port against the JAX
reference on the CPU (the plain versions of the port's kernels), both from
the same XML and the same QMC stream:
- scenes/cornell.xml at its own settings (directlighting, raydepth 3), as
  is and with ambient occlusion on;
- scenes/cornell_path.xml at its own settings (pathtracing, bounces 5,
  rr_min_bounces 3; a glass sphere with absorption, so Beer's law, and a
  glossy sphere);
each at 16², 2 spp.  Bounds as tests/test_torch_render.py states them:
image RMSE <= 1e-4, rays within 0.01%.  The two scenes also go through
`render_scene` and the port's CLI on the CPU at 16² and their own sample
counts: the .exr reads back as the entry point's image.
"""
import json
import os

import numpy as np
import pytest
import torch

from libyafaray_tpu.integrators.config import RenderConfig as RefConfig
from libyafaray_tpu.integrators.render import render as ref_render
from libyafaray_tpu.scene.session import build_config as ref_build
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch.cli.yafaray_xml import main as cli_main
from libyafaray_tpu_torch.integrators.config import RenderConfig
from libyafaray_tpu_torch.integrators.render import render
from libyafaray_tpu_torch.io.exr import read_exr
from libyafaray_tpu_torch.scene.params import ParamMap
from libyafaray_tpu_torch.scene.session import build_config, render_scene
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "cornell.xml")
CORNELL_PATH = os.path.join(REPO, "scenes", "cornell_path.xml")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU path is many small tensor ops: one thread runs them
    fastest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(parse, build, config_cls, path, size, spp, **over):
    s = parse(path)
    s.render_params["width"] = size
    s.render_params["height"] = size
    cfg = build(s)
    return s, config_cls(**{**cfg.__dict__, **over, "width": size,
                            "height": size, "aa_samples": spp})


def _rmse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def _against_reference(path, **over):
    rs, rc = _setup(ref_parse, ref_build, RefConfig, path, 16, 2, **over)
    ref = ref_render(rs.compile(), rc)
    ps, pc = _setup(parse_xml_file, build_config, RenderConfig, path, 16, 2,
                    **over)
    port = render(ps.compile(device="cpu"), pc, device="cpu")
    img = port.image
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05
    assert _rmse(ref.image, img) <= 1e-4
    r_ref, r_port = ref.stats["rays"], port.stats["rays"]
    assert abs(r_port - r_ref) <= 1e-4 * r_ref, (r_ref, r_port)
    return pc, port


@pytest.mark.parametrize("do_ao", [False, True])
def test_directlighting_matches_reference(do_ao):
    """cornell.xml's own integrator: raydepth 3, continuation only through
    specular vertices, single-strategy NEE; with do_AO the first vertex
    adds ambient occlusion."""
    cfg, port = _against_reference(CORNELL, do_ao=do_ao)
    assert (cfg.integrator, cfg.raydepth, cfg.do_ao) == (
        "directlighting", 3, do_ao)


def test_cornell_path_beer_glass_matches_reference():
    """bench.py config 2 at 16², 2 spp: the glass sphere's Beer medium,
    the glossy sphere, bounces 5, Russian roulette from bounce 3."""
    cfg, _ = _against_reference(CORNELL_PATH)
    assert (cfg.integrator, cfg.bounces, cfg.rr_min_bounces,
            cfg.caustic_type) == ("pathtracing", 5, 3, "path")


def test_beer_absorption_only_darkens():
    """The same render without the glass's absorption, Russian roulette
    off (it would read the throughput): every path is the same, so a pixel
    is darker with absorption where its paths crossed the glass and equal
    bit for bit where none did (a lane that never enters the glass carries
    no medium)."""
    imgs = []
    for absorb in (True, False):
        s, cfg = _setup(parse_xml_file, build_config, RenderConfig,
                        CORNELL_PATH, 16, 1, rr_min_bounces=10)
        if not absorb:
            s.create_material("glass", ParamMap(
                type="glass", IOR=1.55, filter_color=(0.97, 0.99, 0.98)))
        imgs.append(render(s.compile(device="cpu"), cfg,
                           device="cpu").image)
    darker = (imgs[0] <= imgs[1]).all(axis=-1) & (imgs[0] < imgs[1]).any(
        axis=-1)
    same = (imgs[0] == imgs[1]).all(axis=-1)
    assert darker.sum() >= 4 and same.sum() >= 4
    assert (darker | same).all()


@pytest.mark.parametrize("scene, integrator", [
    (CORNELL, "directlighting"), (CORNELL_PATH, "pathtracing")])
def test_render_scene_and_cli_render_the_scene(tmp_path, capsys, scene,
                                               integrator):
    """The scene at its own settings through render_scene and through the
    CLI on the CPU at 16²: the .exr reads back as render_scene's image and
    the --json-stats rays are its rays."""
    s = parse_xml_file(scene)
    s.render_params["width"] = s.render_params["height"] = 16
    res = render_scene(s, device="cpu")
    assert res.cfg.integrator == integrator
    assert res.cfg.aa_samples == 64
    out = str(tmp_path / "out.exr")
    assert cli_main([scene, out, "--width", "16", "--height", "16",
                     "--device", "cpu", "--json-stats", "-vl",
                     "warning"]) == 0
    stats = json.loads([line for line in capsys.readouterr().out.splitlines()
                        if line.startswith("{")][-1])
    assert stats["rays"] == res.stats["rays"] > 0
    img = read_exr(out)
    assert img.shape == (16, 16, 3) and img.mean() > 0.05
    np.testing.assert_array_equal(img, res.image)
