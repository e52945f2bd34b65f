"""The port's yafaray-xml CLI (libyafaray_tpu_torch/cli/yafaray_xml.py), its
scene generator (scene/generate.py) and image output (io/image.py, the EXR
writer in io/exr.py, io/rgbe.py) against the JAX reference's: the
generator's XML equals scripts/make_large_scene.py's text; the port's CLI
renders the generated 172-triangle (dense kernels) and 652-triangle
(streaming kernels) scenes at 16², 2 spp to the reference CLI's image
within RMSE 1e-4 with its ray count within 0.01%; and the entry points
default to the card, raising without one."""
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from libyafaray_tpu.cli.yafaray_xml import main as ref_main
from libyafaray_tpu.io.exr import read_exr as ref_read_exr
from libyafaray_tpu.io.exr import write_exr as ref_write_exr
from libyafaray_tpu.io.rgbe import read_hdr as ref_read_hdr
from libyafaray_tpu_torch.cli.yafaray_xml import main
from libyafaray_tpu_torch.io.exr import read_exr, write_exr
from libyafaray_tpu_torch.io.rgbe import read_hdr
from libyafaray_tpu_torch.scene.generate import (grid_spheres_xml,
                                                 write_grid_spheres)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU path is many small tensor ops: one thread runs them
    fastest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("grid, subdiv", [(1, 1), (2, 1), (2, 2)])
def test_generator_writes_the_scripts_xml(tmp_path, grid, subdiv):
    path = str(tmp_path / "ref.xml")
    subprocess.run([sys.executable,
                    os.path.join(REPO, "scripts", "make_large_scene.py"),
                    "--grid", str(grid), "--subdiv", str(subdiv),
                    "--out", path], check=True, capture_output=True)
    with open(path) as f:
        want = f.read()
    assert grid_spheres_xml(grid, subdiv) == want
    mine = write_grid_spheres(str(tmp_path / "port.xml"), grid, subdiv)
    with open(mine) as f:
        assert f.read() == want


def _stats(out: str) -> dict:
    return json.loads(next(line for line in out.splitlines()
                           if line.startswith("{")))


@pytest.mark.parametrize("grid, tris", [(1, 172), (2, 652)])
def test_cli_matches_reference_cli(tmp_path, capsys, grid, tris):
    """Both CLIs on the same generated scene at 16², 2 spp, writing .exr."""
    xml = write_grid_spheres(str(tmp_path / "scene.xml"), grid, 1, 2, 16)
    ref_out, port_out = str(tmp_path / "ref.exr"), str(tmp_path / "port.exr")
    size = ["--width", "16", "--height", "16", "--json-stats", "-vl",
            "warning"]
    assert ref_main([xml, ref_out, *size, "--compile-cache", ""]) == 0
    ref = _stats(capsys.readouterr().out)
    assert main([xml, port_out, *size, "--device", "cpu"]) == 0
    port = _stats(capsys.readouterr().out)
    assert set(port) == set(ref) == {"output", "wall_s", "render_s", "rays",
                                     "mrays_per_sec"}
    assert port["output"] == port_out
    assert abs(port["rays"] - ref["rays"]) <= 1e-4 * ref["rays"]
    img, want = read_exr(port_out), ref_read_exr(ref_out)
    assert img.shape == want.shape == (16, 16, 3)
    assert img.mean() > 0.0 and np.isfinite(img).all()
    rmse = float(np.sqrt(np.mean((img - want) ** 2)))
    assert rmse <= 1e-4, (tris, rmse)


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    """The 172-triangle scene at 8², 1 spp."""
    d = tmp_path_factory.mktemp("cli")
    return write_grid_spheres(str(d / "scene.xml"), 1, 1, 1, 8)


@pytest.mark.parametrize("fmt", ["png", "hdr", "exr"])
def test_cli_writes_each_format(tmp_path, capsys, small_scene, fmt):
    """-f picks the format; --logs writes the TXT and HTML logs; --badge
    adds the parameter band under an 8-bit image."""
    out = str(tmp_path / "img.out")
    extra = ["--logs", "--badge"] if fmt == "png" else []
    assert main([small_scene, out, "-f", fmt, "--json-stats", "--device",
                 "cpu", "-t", "4", "-vl", "warning", *extra]) == 0
    path = str(tmp_path / f"img.{fmt}")
    assert _stats(capsys.readouterr().out)["output"] == path
    if fmt == "png":
        from PIL import Image

        with Image.open(path) as im:
            assert im.size[0] == 8 and im.size[1] > 8  # the badge band
        for ext in (".log.txt", ".log.html"):
            assert os.path.getsize(str(tmp_path / f"img{ext}")) > 0
    else:
        img = read_hdr(path) if fmt == "hdr" else read_exr(path)
        assert img.shape == (8, 8, 3) and img.mean() > 0.0


def test_cli_profile_writes_a_trace(tmp_path, small_scene):
    trace_dir = str(tmp_path / "trace")
    assert main([small_scene, str(tmp_path / "img.exr"), "--profile",
                 trace_dir, "--device", "cpu", "-vl", "warning"]) == 0
    with open(os.path.join(trace_dir, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


@pytest.mark.parametrize("flag", [["--devices", "2"]])
def test_cli_raises_on_unported_options(tmp_path, small_scene, flag):
    """The option that raised until multi-device rendering was ported,
    --devices 2, now renders over two local gloo ranks: the image is the
    one-device CLI's within 1e-5 (the rows a filter reaches across the
    band edge sum two ranks' partials)."""
    one, two = str(tmp_path / "one.exr"), str(tmp_path / "two.exr")
    assert main([small_scene, one, "--device", "cpu", "-vl", "warning"]) == 0
    assert main([small_scene, two, *flag, "--device", "cpu", "-vl",
                 "warning"]) == 0
    a, b = read_exr(one), read_exr(two)
    assert a.shape == b.shape and a.mean() > 0.0
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def test_cli_refuses_a_missing_scene(tmp_path, capsys):
    assert main([str(tmp_path / "none.xml"), "--device", "cpu"]) == 2
    assert "not found" in capsys.readouterr().err


def test_entry_points_default_to_the_card(tmp_path, small_scene):
    """render_scene, render, render_timed, render_photonmap(_timed), the
    CLI and Scene.compile default to "cuda"; without a card every render
    entry point raises (no CPU fallback), before it renders."""
    from libyafaray_tpu_torch.integrators import photonmap, render
    from libyafaray_tpu_torch.integrators.engine import resolve_device
    from libyafaray_tpu_torch.scene import session
    from libyafaray_tpu_torch.scene.scene import Scene
    from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

    entries = (session.render_scene, render.render, render.render_timed,
               photonmap.render_photonmap, photonmap.render_photonmap_timed,
               Scene.compile)
    for fn in entries:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    scene = parse_xml_file(small_scene)
    cs = scene.compile()  # picks the intersector only: no card needed
    cfg = session.build_config(scene)
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    for call in (lambda: session.render_scene(scene),
                 lambda: render.render(cs, cfg),
                 lambda: render.render_timed(cs, cfg),
                 lambda: photonmap.render_photonmap(cs, cfg),
                 lambda: photonmap.render_photonmap_timed(cs, cfg),
                 lambda: main([small_scene, str(tmp_path / "img.exr")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_exr_writer_and_hdr_codec_match_reference(tmp_path):
    """The port's EXR writer gives the reference writer's bytes (ZIPS,
    float32 scanlines) and both readers read it back exactly; the .hdr
    codec round-trips like the reference's."""
    rng = np.random.default_rng(3)
    img = (rng.random((9, 7, 3)) * 4.0).astype(np.float32)
    img[0, 0] = 0.0
    mine, ref = str(tmp_path / "port.exr"), str(tmp_path / "ref.exr")
    write_exr(mine, img)
    ref_write_exr(ref, img)
    with open(mine, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert np.array_equal(read_exr(mine), img)
    assert np.array_equal(ref_read_exr(mine), img)
    from libyafaray_tpu_torch.io.image import save_image

    hdr = str(tmp_path / "img.hdr")
    save_image(hdr, img)
    assert np.array_equal(read_hdr(hdr), ref_read_hdr(hdr))
    # 8-bit mantissas under a shared exponent: off by at most 1/64 of the
    # pixel's largest channel
    err = np.abs(read_hdr(hdr) - img)
    assert (err <= img.max(axis=-1, keepdims=True) / 64.0).all()
