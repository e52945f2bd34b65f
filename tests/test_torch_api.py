"""The port's public surface beside the XML CLI: the flat `Interface`
(scene/interface.py), the XML writer and `XmlExportInterface`
(scene/xml_writer.py), the compare tool (cli/compare.py) and
`python -m libyafaray_tpu_torch`, against the JAX reference's
(libyafaray_tpu/scene/interface.py, scene/xml_writer.py, cli/compare.py).

Exact throughout: the compiled arrays of the same Interface calls equal
key by key after the converter; the same XML text; the same compare JSON
and exit codes."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from libyafaray_tpu.cli import compare as ref_compare
from libyafaray_tpu.scene.interface import Interface as RefInterface
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu.scene.xml_writer import write_xml as ref_write_xml
from libyafaray_tpu_torch import convert
from libyafaray_tpu_torch.cli import compare
from libyafaray_tpu_torch.io.exr import write_exr
from libyafaray_tpu_torch.scene.interface import (Interface,
                                                  XmlExportInterface)
from libyafaray_tpu_torch.scene.scene import SLICE_ARRAY_KEYS
from libyafaray_tpu_torch.scene.xml_parser import (parse_xml_file,
                                                   parse_xml_string)
from libyafaray_tpu_torch.scene.xml_writer import write_xml


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU path is many small tensor ops: one thread runs them
    fastest (and keeps parallel test workers off each other's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "cornell.xml")


def _build(yi):
    """The calls of the reference's tests/test_api.py::
    test_interface_builds_scene, with a uv'd, smoothed second mesh and an
    instance of it."""
    yi.params_clear_all()
    yi.params_set_string("type", "shinydiffusemat")
    yi.params_set_color("color", 0.7, 0.2, 0.1)
    yi.create_material("red")

    yi.start_geometry()
    yi.start_tri_mesh(0, 3, 1, False, False, 0)
    yi.add_vertex(0, 0, 0)
    yi.add_vertex(1, 0, 0)
    yi.add_vertex(0, 1, 0)
    yi.add_triangle(0, 1, 2, 1)
    yi.end_tri_mesh()
    yi.start_tri_mesh(1, 4, 2, False, True, 0)
    for x, y in ((0, 0), (1, 0), (1, 1), (0, 1)):
        yi.add_vertex(x - 0.5, y - 0.5, -0.5)
        yi.add_uv(x, y)
    yi.add_triangle_uv(0, 1, 2, 0, 1, 2, 1)
    yi.add_triangle_uv(0, 2, 3, 0, 2, 3, 1)
    yi.end_tri_mesh()
    yi.smooth_mesh(1, 30.0)
    yi.add_instance(1, (1, 0, 0, 0.2, 0, 1, 0, 0, 0, 0, 1, -0.2,
                        0, 0, 0, 1))
    yi.end_geometry()

    yi.params_set_string("type", "pointlight")
    yi.params_set_point("from", 0.3, 0.3, 2.0)
    yi.params_set_color("color", 1, 1, 1)
    yi.params_set_float("power", 10.0)
    yi.create_light("lamp")

    yi.params_set_string("type", "perspective")
    yi.params_set_int("resx", 8)
    yi.params_set_int("resy", 8)
    yi.params_set_point("from", 0.3, 0.3, 3.0)
    yi.params_set_point("to", 0.3, 0.3, 0.0)
    yi.params_set_point("up", 0.3, 1.3, 3.0)
    yi.create_camera("cam")

    yi.params_set_string("type", "constant")
    yi.params_set_color("color", 0, 0, 0)
    yi.create_background("bg")

    yi.params_set_string("type", "directlighting")
    yi.create_integrator("default")
    return yi


def _flat(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_interface_compiles_to_reference_arrays():
    ref = _build(RefInterface()).scene.compile()
    port_i = _build(Interface())
    port = port_i.scene.compile(device="cpu")
    assert port.static.n_tris_real == ref.static.n_tris_real == 5
    assert len(port.static.lights) == len(ref.static.lights) == 1
    assert port.camera == convert.camera_from_reference(ref.camera)
    want = dict(_flat({k: v for k, v in convert.arrays_from_reference(
        ref.arrays, "cpu").items() if k in SLICE_ARRAY_KEYS}))
    got = dict(_flat(convert.to_tensors(
        {k: port.arrays[k] for k in SLICE_ARRAY_KEYS}, "cpu")))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert port_i.get_version()
    port_i.abort()
    assert port_i.scene.aborted


def test_xml_export_writes_the_reference_text(tmp_path):
    ref_i = _build(RefInterface())
    ref_i.scene.set_render_params(ref_i._params)
    path = str(tmp_path / "export.xml")
    xi = _build(XmlExportInterface(path))
    xi.params_set_int("width", 8)
    xi.params_set_int("height", 8)
    ref_i.scene.render_params["width"] = 8
    ref_i.scene.render_params["height"] = 8
    want = ref_write_xml(ref_i.scene)
    got = xi.render()
    assert got == want
    with open(path) as f:
        assert f.read() == want
    # both packages parse it back to the same triangles (the writer, as
    # the reference's, keeps no <instance>: the meshes alone come back)
    from libyafaray_tpu.scene.xml_parser import parse_xml_string as rps

    a = parse_xml_string(got).compile(device="cpu").arrays["tri_shade_pack"]
    assert a.shape[0] == 3
    assert np.array_equal(a, rps(want).compile().arrays["tri_shade_pack"])


@pytest.mark.parametrize("scene", ["cornell.xml", "ibl_spheres.xml",
                                   "cornell_surfaces.xml"])
def test_write_xml_of_parsed_scenes_equals_reference(scene, monkeypatch):
    monkeypatch.chdir(REPO)  # the scenes' asset paths
    path = os.path.join("scenes", scene)
    want = ref_write_xml(ref_parse(path))
    port = parse_xml_file(path)
    got = write_xml(port)
    assert got == want
    again = write_xml(parse_xml_string(got))
    assert again == got


def test_compare_prints_the_reference_json(tmp_path, capsys):
    rng = np.random.default_rng(9)
    a = rng.random((12, 10, 3), np.float32)
    paths = {}
    for name, img in (("a", a), ("near", a + 1e-4),
                      ("far", a + 0.05 * rng.random(a.shape, np.float32)),
                      ("small", a[:6])):
        paths[name] = str(tmp_path / f"{name}.exr")
        write_exr(paths[name], img)
    for other, codes in (("a", (0, 0)), ("near", (0, 0)),
                         ("far", (1, 0)), ("small", (2, 2))):
        for argv, code in (([paths["a"], paths[other]], codes[0]),
                           ([paths["a"], paths[other], "--threshold",
                             "0.1"], codes[1])):
            assert ref_compare.main(argv) == code, (other, argv)
            want = capsys.readouterr().out
            assert compare.main(argv) == code, (other, argv)
            got = capsys.readouterr().out
            assert got == want, (other, argv)
            if other != "small":
                line = json.loads(got)
                assert set(line) == {"rmse", "threshold", "pass", "max_abs"}


def test_python_dash_m_runs_the_cli(tmp_path):
    r = subprocess.run([sys.executable, "-m", "libyafaray_tpu_torch",
                        "--help"], capture_output=True, text=True,
                       timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert "yafaray-xml-torch" in r.stdout
