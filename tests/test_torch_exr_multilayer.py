"""The port's multilayer EXR (io/exr.py write_exr_multilayer /
read_exr_multilayer, io/image.py save_multilayer_exr) and the CLI's
output with passes (cli/yafaray_xml.py) against the JAX reference's:

- a file the port writes (NONE and ZIPS) is byte-equal to the reference
  writer's, and each reader reads the other's file bit for bit;
- a tiled file and a PIZ file the reference writes read bit for bit as
  the reference reads them (every codec and layout is held in
  tests/test_torch_exr_codecs.py);
- both CLIs on tests/test_alpha.py's opaque quad with passes and
  bg_transp at 16²: the .exr's layers (combined, alpha, a layer a pass)
  have the same names and agree; a PNG output with -z writes the same
  files (an RGBA image and a `<base>.<pass>.png` a pass, z-depth-norm
  among them); and --film resumes: a second load-save run over a finished
  film renders nothing more and writes the same image and rays.
"""
import json
import os

import numpy as np
import pytest
import torch

from libyafaray_tpu.cli.yafaray_xml import main as ref_main
from libyafaray_tpu.io import exr as ref_exr
from libyafaray_tpu_torch.cli.yafaray_xml import main
from libyafaray_tpu_torch.io import exr
from libyafaray_tpu_torch.io.image import read_png
from test_alpha import OPAQUE, _scene_xml

PASSES = "z-depth-abs mat-index-abs uv normal-smooth ao"
SIZE = ["--width", "16", "--height", "16", "-vl", "warning"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layers(seed=3):
    rng = np.random.default_rng(seed)
    return {"": rng.random((6, 5, 3), np.float32) * 4.0,
            "alpha": rng.random((6, 5, 1), np.float32),
            "uv": rng.random((6, 5, 2), np.float32),
            "z-depth-abs": rng.random((6, 5, 1), np.float32) * 9.0,
            "normal": np.zeros((6, 5, 3), np.float32)}


@pytest.mark.parametrize("compression", ["none", "zips"])
def test_port_file_is_the_reference_file(tmp_path, compression):
    layers = _layers()
    mine, ref = str(tmp_path / "port.exr"), str(tmp_path / "ref.exr")
    exr.write_exr_multilayer(mine, layers, compression)
    ref_exr.write_exr_multilayer(ref, layers, compression)
    with open(mine, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    got = ref_exr.read_exr_multilayer(mine)
    assert set(got) == set(layers)
    for k, v in layers.items():
        assert np.array_equal(got[k], v), k


@pytest.mark.parametrize("compression", ["none", "zips"])
def test_port_reads_reference_files(tmp_path, compression):
    layers = _layers(4)
    path = str(tmp_path / "ref.exr")
    ref_exr.write_exr_multilayer(path, layers, compression)
    got = exr.read_exr_multilayer(path)
    want = ref_exr.read_exr_multilayer(path)
    assert set(got) == set(want) == set(layers)
    for k in layers:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k])
    assert np.array_equal(exr.read_exr(path), layers[""])


@pytest.mark.parametrize("kw, what", [(dict(tiles=(4, 4)), "tiled"),
                                      (dict(compression="piz"), "type 4")])
def test_unported_exr_variants_raise(tmp_path, kw, what):
    """Once unported (they raised), a tiled file and a PIZ (type 4) file
    now read as the reference reads them, bit for bit."""
    path = str(tmp_path / "x.exr")
    layers = _layers()
    ref_exr.write_exr_multilayer(path, layers, **kw)
    got = exr.read_exr_multilayer(path)
    want = ref_exr.read_exr_multilayer(path)
    assert set(got) == set(want) == set(layers), what
    for k in layers:
        assert got[k].dtype == np.float32, (what, k)
        assert np.array_equal(got[k], want[k]), (what, k)
        assert np.array_equal(got[k], layers[k]), (what, k)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    path = str(d / "quad.xml")
    with open(path, "w") as f:
        f.write(_scene_xml(OPAQUE, f'<render_passes sval="{PASSES}"/>'
                           '<film_save_load sval="load-save"/>', spp=2))
    return path


def test_cli_multilayer_exr_matches_reference_cli(tmp_path, scene):
    ref_out, port_out = str(tmp_path / "ref.exr"), str(tmp_path / "port.exr")
    assert ref_main([scene, ref_out, *SIZE, "--compile-cache", ""]) == 0
    assert main([scene, port_out, *SIZE, "--device", "cpu"]) == 0
    ref, port = ref_exr.read_exr_multilayer(ref_out), \
        exr.read_exr_multilayer(port_out)
    assert set(port) == set(ref) == {"", "alpha", *PASSES.split()}
    for k in ref:
        assert port[k].shape == ref[k].shape, k
        tol = 1e-4 * max(1.0, float(np.abs(ref[k]).max()))
        assert np.abs(port[k] - ref[k]).max() <= tol, k
    mine = ref_exr.read_exr_multilayer(port_out)
    for k in port:
        assert np.array_equal(mine[k], port[k])
    assert port["alpha"].min() >= 0.0 and port["alpha"].max() > 0.99


def test_cli_png_files_match_reference_cli(tmp_path, scene):
    """A PNG output with -z: the RGBA image (alpha from bg_transp) and one
    file a pass, z-depth-norm added by -z, named as the reference names
    them; the 8-bit values agree to one step."""
    out = {}
    for who, run, extra in (("ref", ref_main, ["--compile-cache", ""]),
                            ("port", main, ["--device", "cpu"])):
        d = tmp_path / who
        d.mkdir()
        assert run([scene, str(d / "img.png"), "-z", *SIZE, *extra]) == 0
        out[who] = d
    names = sorted(p.name for p in out["ref"].iterdir())
    assert sorted(p.name for p in out["port"].iterdir()) == names
    assert "img.z-depth-norm.png" in names and "img.uv.png" in names
    for name in names:
        a, b = (read_png(str(out[w] / name)).astype(int)
                for w in ("ref", "port"))
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1, name
    assert read_png(str(out["port"] / "img.png")).shape == (16, 16, 4)


def test_cli_film_resumes(tmp_path, scene, capsys):
    """--film with load-save: the second run loads the finished film, runs
    no pass (so saves nothing), and writes the first run's image and
    rays."""
    film = str(tmp_path / "quad.film.npz")
    stats, imgs, stamps = [], [], []
    for k in range(2):
        if k:
            stamps.append(os.stat(film).st_mtime_ns)
        out = str(tmp_path / f"run{k}.exr")
        assert main([scene, out, *SIZE, "--device", "cpu", "--film", film,
                     "--json-stats"]) == 0
        stats.append(json.loads([line for line in
                                 capsys.readouterr().out.splitlines()
                                 if line.startswith("{")][-1]))
        imgs.append(exr.read_exr_multilayer(out))
    assert stats[0]["rays"] == stats[1]["rays"] > 0
    for k in imgs[0]:
        assert np.array_equal(imgs[0][k], imgs[1][k]), k
    assert int(np.load(film)["__pass__"]) == 1
    assert os.stat(film).st_mtime_ns == stamps[0]
