"""The ported slices end to end, rendered by the JAX reference on the CPU
and by the port on the CPU (the plain versions of its kernels), both from
the same XML and the same QMC stream:
- slice 1, the Cornell pathtracing main path (bounces=4, rr_min_bounces=2,
  aa_passes=1; brute-force intersection in the reference);
- slice 2, the generated grid-spheres scene (scripts/make_large_scene.py)
  with its own settings (pathtracing, bounces=3, gauss filter): 2.6K
  triangles (--grid 2 --subdiv 2, the fine path), and the 164K-triangle
  bench.py config 3 (--grid 4 --subdiv 4), where the reference's CPU path
  intersects through its BVH; the port renders it once on its clustered
  kernels and once forced onto its own BVH route.

Bounds: film planes within RMSE 1e-5, image within RMSE 1e-4, ray count
within 0.01%.  The reference's own device-vs-CPU RMSE at equal spp is
7.2e-7 (PARITY.md); the two engines differ only in float32 rounding
order (XLA contracts multiply-adds on the CPU, PyTorch does not)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from libyafaray_tpu.integrators.config import RenderConfig as RefConfig
from libyafaray_tpu.integrators.render import render as ref_render
from libyafaray_tpu.scene.session import build_config as ref_build
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch.integrators.config import RenderConfig
from libyafaray_tpu_torch.integrators.render import render, render_timed
from libyafaray_tpu_torch.scene.session import build_config
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file


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
SLICE = dict(integrator="pathtracing", bounces=4, rr_min_bounces=2,
             aa_passes=1)


def _setup(parse, build, config_cls, size, spp, path=CORNELL, **over):
    s = parse(path)
    s.render_params["width"] = size
    s.render_params["height"] = size
    cfg = build(s)
    over = {**SLICE, **over} if path == CORNELL else {"aa_passes": 1,
                                                     **over}
    cfg = config_cls(**{**cfg.__dict__, **over, "width": size,
                        "height": size, "aa_samples": spp})
    return s, cfg


def _rmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


@pytest.fixture(scope="module")
def renders():
    rs, rc = _setup(ref_parse, ref_build, RefConfig, 16, 4)
    ref = ref_render(rs.compile(), rc)
    ps, pc = _setup(parse_xml_file, build_config, RenderConfig, 16, 4)
    port = render(ps.compile(device="cpu"), pc, device="cpu")
    return ref, port


def test_cornell_film_matches_reference(renders):
    ref, port = renders
    for k in ("wsum", "w", "nsamples"):
        assert port.film[k].shape == tuple(np.asarray(ref.film[k]).shape)
        assert _rmse(ref.film[k], port.film[k].numpy()) <= 1e-5, k
    assert _rmse(ref.image, port.image) <= 1e-4
    assert np.isfinite(port.image).all() and port.image.mean() > 0.05


def test_cornell_ray_count_matches_reference(renders):
    ref, port = renders
    r_ref, r_port = ref.stats["rays"], port.stats["rays"]
    assert abs(r_port - r_ref) <= 1e-4 * r_ref, (r_ref, r_port)


def test_render_timed_counts_the_same_rays():
    """render_timed's warm-up step is not counted: its timed film holds
    exactly the rays of a plain render of the same config."""
    s, cfg = _setup(parse_xml_file, build_config, RenderConfig, 8, 2)
    cs = s.compile(device="cpu")
    timed = render_timed(cs, cfg, device="cpu")
    plain = render(cs, cfg, device="cpu")
    assert timed.stats["rays"] == plain.stats["rays"] > 0
    assert np.array_equal(timed.image, plain.image)
    assert timed.mrays_per_sec > 0


def _grid_renders(path, size, spp):
    rs, rc = _setup(ref_parse, ref_build, RefConfig, size, spp, path)
    ref = ref_render(rs.compile(), rc)
    ps, pc = _setup(parse_xml_file, build_config, RenderConfig, size, spp,
                    path)
    assert (pc.integrator, pc.bounces, pc.filter_type) == (
        "pathtracing", 3, "gauss")
    return ref, render(ps.compile(device="cpu"), pc, device="cpu")


def _make_grid(tmp_path, grid, subdiv):
    path = str(tmp_path / f"grid{grid}_{subdiv}.xml")
    subprocess.run([sys.executable,
                    os.path.join(REPO, "scripts", "make_large_scene.py"),
                    "--grid", str(grid), "--subdiv", str(subdiv),
                    "--out", path], check=True, capture_output=True)
    return path


def test_grid_spheres_matches_reference(tmp_path):
    """Slice 2 at small size: 2,572 triangles, glossy and mirror spheres,
    16², 4 spp."""
    ref, port = _grid_renders(_make_grid(tmp_path, 2, 2), 16, 4)
    for k in ("wsum", "w", "nsamples"):
        assert _rmse(ref.film[k], port.film[k].numpy()) <= 1e-5, k
    assert _rmse(ref.image, port.image) <= 1e-4
    r_ref, r_port = ref.stats["rays"], port.stats["rays"]
    assert abs(r_port - r_ref) <= 1e-4 * r_ref, (r_ref, r_port)
    assert np.isfinite(port.image).all() and port.image.mean() > 0.05


@pytest.fixture(scope="module")
def grid164k(tmp_path_factory):
    """bench.py config 3 (163,852 triangles) at 8², 1 spp: the scene's
    path and the reference's render, through its BVH walk (its CPU
    intersector above 131,072 triangles), made once for both tests."""
    path = _make_grid(tmp_path_factory.mktemp("grid164k"), 4, 4)
    rs, rc = _setup(ref_parse, ref_build, RefConfig, 8, 1, path)
    return path, ref_render(rs.compile(), rc)


def _port_grid_render(path):
    ps, pc = _setup(parse_xml_file, build_config, RenderConfig, 8, 1, path)
    assert (pc.integrator, pc.bounces, pc.filter_type) == (
        "pathtracing", 3, "gauss")
    cs = ps.compile(device="cpu")
    return cs, render(cs, pc, device="cpu")


def test_grid_spheres_164k_matches_reference_bvh(grid164k):
    """The parity gate at scale the reference never had: the port's plain
    fine versions against the reference's BVH walk."""
    path, ref = grid164k
    cs, port = _port_grid_render(path)
    assert cs.static.intersector == "brute"
    assert _rmse(ref.image, port.image) <= 1e-4
    assert ref.stats["rays"] == port.stats["rays"] > 0
    assert np.isfinite(port.image).all() and port.image.mean() > 0.05


def test_grid_spheres_164k_bvh_route_matches_reference(grid164k,
                                                       monkeypatch):
    """The same render with the port forced onto its own BVH route (its
    budget cut to the reference's CPU one, 131,072 triangles): both
    engines walk the same threaded BVH, the port through its plain
    lockstep walk."""
    from libyafaray_tpu_torch.ops import intersect

    monkeypatch.setattr(intersect, "MAX_TRIS", 131072)
    path, ref = grid164k
    cs, port = _port_grid_render(path)
    assert cs.static.intersector == "bvh"
    assert _rmse(ref.image, port.image) <= 1e-4
    assert ref.stats["rays"] == port.stats["rays"] > 0
    assert np.isfinite(port.image).all() and port.image.mean() > 0.05
