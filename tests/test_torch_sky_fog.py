"""scenes/sky_fog.xml end to end against the reference: a sunsky
background with its IBL light, a sunlight, an exponential ground fog under
the single-scatter volume integrator, a thin-lens camera with hexagonal
bokeh, and object visibility (26 camera-visible triangles: the tiny
kernels; 334 shadow casters: the dense kernels).  Both packages'
render_scene at 16², 2 spp (the reference's once, in a module fixture):
image RMSE <= 1e-4, rays within 0.01%.  The fog marches 4 steps here in
both packages (the scene's 16 make the reference's compile of its nested
march cost most of a minute; the 16-step march is held card against CPU
by chip_smoke.py).  The scene through the port's CLI renders
render_scene's image.
"""
import json
import os

import numpy as np
import pytest
import torch

from libyafaray_tpu.scene.session import render_scene as ref_render_scene
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu.volumes import integrate as rvol
from libyafaray_tpu_torch.cli.yafaray_xml import main as cli_main
from libyafaray_tpu_torch.io.exr import read_exr
from libyafaray_tpu_torch.ops.intersect import route
from libyafaray_tpu_torch.scene.session import render_scene
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file
from libyafaray_tpu_torch.volumes import integrate as pvol

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKY_FOG = os.path.join(REPO, "scenes", "sky_fog.xml")
SIZE, SPP, MARCH = 16, 2, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread_short_march():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rvol, "MARCH_STEPS", MARCH)
        mp.setattr(pvol, "MARCH_STEPS", MARCH)
        yield
    torch.set_num_threads(n)


def _small(scene):
    scene.render_params.update(width=SIZE, height=SIZE, AA_minsamples=SPP)
    return scene


@pytest.fixture(scope="module")
def ref_result():
    res = ref_render_scene(_small(ref_parse(SKY_FOG)))
    return np.asarray(res.image), float(res.stats["rays"])


@pytest.fixture(scope="module")
def port_result():
    return render_scene(_small(parse_xml_file(SKY_FOG)), device="cpu")


def test_scene_sets_and_routes():
    cs = parse_xml_file(SKY_FOG).compile(device="cpu")
    st = cs.static
    assert (st.n_tris_real, st.n_stris_real) == (26, 334)
    a = {k: torch.from_numpy(cs.arrays[k]) for k in (
        "tri_pack10", "tri_cluster8", "stri_pack10", "stri_cluster8")}
    assert route(a["tri_pack10"], a["tri_cluster8"], 26) == "tiny"
    assert route(a["stri_pack10"], a["stri_cluster8"], 334) == "dense"
    assert len(st.volumes) == 1 and st.volumes[0].sigma_s > 0
    assert st.bg.ibl and st.bg.ibl_samples == 8
    assert cs.arrays["bg_image"].shape == (128, 256, 3)
    assert cs.camera.aperture > 0 and cs.camera.bokeh_type == "hexagon"


def test_sky_fog_matches_reference(ref_result, port_result):
    ref_img, ref_rays = ref_result
    img = port_result.image
    assert img.shape == (SIZE, SIZE, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05
    rmse = float(np.sqrt(np.mean((img - ref_img) ** 2)))
    assert rmse <= 1e-4, rmse
    rays = port_result.stats["rays"]
    assert abs(rays - ref_rays) <= 1e-4 * ref_rays, (rays, ref_rays)


def test_sky_fog_cli(tmp_path, capsys, port_result):
    """The scene through the CLI (a copy at 2 spp; --width / --height set
    the size) renders render_scene's image and counts its rays."""
    with open(SKY_FOG) as f:
        text = f.read()
    assert '<AA_minsamples ival="16"/>' in text
    xml = tmp_path / "sky_fog.xml"
    xml.write_text(text.replace('<AA_minsamples ival="16"/>',
                                f'<AA_minsamples ival="{SPP}"/>'))
    out = str(tmp_path / "sky.exr")
    assert cli_main([str(xml), out, "--width", str(SIZE), "--height",
                     str(SIZE), "--device", "cpu", "--json-stats", "-vl",
                     "warning"]) == 0
    stats = json.loads([line for line in capsys.readouterr().out.splitlines()
                        if line.startswith("{")][-1])
    assert stats["rays"] == port_result.stats["rays"] > 0
    np.testing.assert_array_equal(read_exr(out), port_result.image)
