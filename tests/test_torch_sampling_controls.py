"""The sampling controls of slice 16 against the JAX reference on the CPU
(the plain versions of the port's kernels), from the same inputs and the
same QMC stream:
- spp_batch: scenes/cornell.xml (pathtracing, bounces 4, rr_min_bounces 2)
  at 32² with 4 samples a step, 2 adaptive passes over a compact lane
  bucket, against the reference at spp_batch 4 (the two-level splat rounds
  as the reference's does, not as four one-sample steps);
- the pass multipliers (tests/test_aa_multipliers.py's scene and settings);
- AA_clamp_indirect on Cornell at 16²;
- per-material additionalDepth (tests/test_sampling_controls.py's corridor
  of three transparent panes) and samplingFactor's threshold scale, both
  scenes built through the port's Scene API;
- photon mapping on cornell_photon.xml with 2 adaptive passes at 16²;
- SPPM, which never reads AA_passes;
- cornell.xml with AA_passes 3 through the port's CLI against
  `render_scene`.
Bounds, as tests/test_torch_render.py states them: film planes RMSE <=
1e-5, image RMSE <= 1e-4, rays within 0.01%, nsamples equal; the photon
render RMSE <= 1e-4 as tests/test_torch_photon.py holds its slice.
"""
import json
import os

import numpy as np
import pytest
import torch

from libyafaray_tpu.film.imagefilm import compute_aa_flags as ref_flags
from libyafaray_tpu.integrators import photonmap as rpm
from libyafaray_tpu.integrators.config import RenderConfig as RefConfig
from libyafaray_tpu.integrators.render import render as ref_render
from libyafaray_tpu.scene.params import ParamMap as RefParamMap
from libyafaray_tpu.scene.scene import Scene as RefScene
from libyafaray_tpu.scene.session import build_config as ref_build
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch.cli.yafaray_xml import main as cli_main
from libyafaray_tpu_torch.film.imagefilm import compute_aa_flags
from libyafaray_tpu_torch.integrators import photonmap as ppm
from libyafaray_tpu_torch.integrators import sppm as psppm
from libyafaray_tpu_torch.integrators.config import RenderConfig
from libyafaray_tpu_torch.integrators.render import render
from libyafaray_tpu_torch.io.exr import read_exr
from libyafaray_tpu_torch.scene.params import ParamMap
from libyafaray_tpu_torch.scene.scene import Scene
from libyafaray_tpu_torch.scene.session import build_config, render_scene
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "cornell.xml")
PHOTON = os.path.join(REPO, "scenes", "cornell_photon.xml")
SPPM = os.path.join(REPO, "scenes", "cornell_sppm.xml")
PATH = dict(integrator="pathtracing", bounces=4, rr_min_bounces=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU path is many small tensor ops: one thread runs them
    fastest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rmse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def _scene_file(parse, build, config_cls, path, size, **over):
    s = parse(path)
    s.render_params["width"] = size
    s.render_params["height"] = size
    cfg = build(s)
    return s, config_cls(**{**cfg.__dict__, **over, "width": size,
                            "height": size})


def _match(ref, port, planes=("wsum", "w")) -> None:
    """The slice's bounds: nsamples equal, film planes RMSE <= 1e-5, image
    RMSE <= 1e-4, rays within 0.01%."""
    assert np.array_equal(port.film["nsamples"].numpy(),
                          np.asarray(ref.film["nsamples"]))
    for k in planes:
        assert _rmse(ref.film[k], port.film[k].numpy()) <= 1e-5, k
    assert _rmse(ref.image, port.image) <= 1e-4
    r_ref, r_port = ref.stats["rays"], port.stats["rays"]
    assert abs(r_port - r_ref) <= 1e-4 * r_ref, (r_ref, r_port)


def _both(path, size, **over):
    """The reference's render and the port's on the CPU of one scene file
    with `over` set on its config."""
    rs, rc = _scene_file(ref_parse, ref_build, RefConfig, path, size, **over)
    ps, pc = _scene_file(parse_xml_file, build_config, RenderConfig, path,
                         size, **over)
    return (ref_render(rs.compile(), rc),
            render(ps.compile(device="cpu"), pc, device="cpu"))


def test_spp_batch_matches_reference_spp_batch():
    """4 samples a step (lanes block-major: lane k·H·W + i is sample
    nsamples[i] + k of pixel i), the spb plane splats into one fragment;
    the adaptive passes run compact (spb·512 lanes)."""
    ref, port = _both(CORNELL, 32, **PATH, spp_batch=4, aa_passes=3,
                      aa_samples=4, aa_inc_samples=4, aa_threshold=0.3)
    _match(ref, port)
    log = port.stats["pass_log"]
    assert [e["mode"] for e in log] == ["dense", "compact", "compact"]
    assert [e["steps"] for e in log] == [1, 1, 1]
    assert port.film["nsamples"].dtype == torch.int32
    ns = port.film["nsamples"].numpy()
    assert ns.min() == 4 and ns.max() == 12


def test_clamp_indirect_matches_reference():
    """AA_clamp_indirect clamps the NEE term of every vertex past the
    first: against the reference, and darker than the unclamped render."""
    ref, port = _both(CORNELL, 16, **PATH, aa_samples=2,
                      aa_clamp_indirect=0.02)
    _match(ref, port)
    s, c = _scene_file(parse_xml_file, build_config, RenderConfig, CORNELL,
                       16, **PATH, aa_samples=2)
    free = render(s.compile(device="cpu"), c, device="cpu")
    assert port.image.mean() < free.image.mean() - 1e-3
    assert np.array_equal(port.film["w"].numpy(), free.film["w"].numpy())


# ---- scenes through the flat Scene API ----------------------------------------


def _plane_scene(scene_cls, pmap):
    """tests/test_aa_multipliers.py's scene: a diffuse quad under a
    2-sample area light, 24²."""
    sc = scene_cls()
    m = sc.create_material("w", pmap({"type": "shinydiffusemat",
                                      "diffuse_color": (0.7, 0.7, 0.7)}))
    sc.start_tri_mesh(1, has_uv=False, visibility="normal")
    for (x, y) in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
        sc.add_vertex(x, y, 0.0)
    sc.add_triangle(0, 1, 2, m)
    sc.add_triangle(0, 2, 3, m)
    sc.end_tri_mesh()
    sc.create_light("L", pmap({
        "type": "arealight", "corner": (-0.3, -0.3, 2.0),
        "point1": (0.3, -0.3, 2.0), "point2": (-0.3, 0.3, 2.0),
        "color": (1, 1, 1), "power": 8.0, "samples": 2}))
    sc.create_camera("cam", pmap({
        "type": "perspective", "from": (0, 0, 3), "to": (0, 0, 0),
        "up": (0, 1, 3), "resx": 24, "resy": 24, "focal": 1.0}))
    return sc


# the multiplier test's config (tests/test_aa_multipliers.py)
MULT = dict(width=24, height=24, integrator="pathtracing", bounces=1,
            aa_passes=2, aa_samples=2, aa_inc_samples=2, aa_threshold=1e-6,
            aa_sample_multiplier_factor=2.0,
            aa_light_sample_multiplier_factor=2.0,
            aa_indirect_sample_multiplier_factor=2.0)


def test_multipliers_match_reference():
    """Pass 1 flags every pixel with any contrast (threshold ~0) and runs
    2·2 steps with the light's 2 NEE samples doubled to 4 (the step rebuilt
    for the pass)."""
    ref = ref_render(_plane_scene(RefScene, RefParamMap).compile(),
                     RefConfig(**MULT))
    port = render(_plane_scene(Scene, ParamMap).compile(device="cpu"),
                  RenderConfig(**MULT), device="cpu")
    _match(ref, port)
    assert port.film["nsamples"].max() == 6
    log = port.stats["pass_log"]
    assert [e["steps"] for e in log] == [2, 4]
    assert 0 < log[1]["flagged"] < 576  # the quad's pixels, not the black
    plain = render(_plane_scene(Scene, ParamMap).compile(device="cpu"),
                   RenderConfig(**{
                       **MULT, "aa_light_sample_multiplier_factor": 1.0,
                       "aa_indirect_sample_multiplier_factor": 1.0}),
                   device="cpu")
    # the same passes; pass 1's doubled NEE samples trace more shadow rays
    assert torch.equal(port.film["nsamples"], plain.film["nsamples"])
    assert port.stats["rays"] > plain.stats["rays"]


def _corridor(scene_cls, pmap, additional_depth=0, sampling_factor=None,
              res=8):
    """tests/test_sampling_controls.py's corridor: the camera behind three
    fully transparent panes and a bright constant background, so the
    background takes 3 vertices, one more than bounces=2 allows unless the
    panes' additionaldepth raises the budget.  sampling_factor: the panes
    become opaque diffuse with that samplingfactor, 2 adaptive passes."""
    s = scene_cls()
    if sampling_factor is None:
        pane = {"type": "shinydiffusemat", "transparency": 1.0,
                "diffuse_reflect": 0.0, "additionaldepth": additional_depth}
    else:
        pane = {"type": "shinydiffusemat", "color": (0.5, 0.5, 0.5),
                "samplingfactor": sampling_factor}
    m = s.create_material("pane", pmap(pane))
    s.start_tri_mesh(1, has_uv=False, visibility="normal")
    for i in range(3):
        y = 1.0 + 0.5 * i
        for v in ((-5.0, y, -5.0), (5.0, y, -5.0), (5.0, y, 5.0),
                  (-5.0, y, 5.0)):
            s.add_vertex(*v)
        s.add_triangle(4 * i, 4 * i + 1, 4 * i + 2, m)
        s.add_triangle(4 * i, 4 * i + 2, 4 * i + 3, m)
    s.end_tri_mesh()
    s.create_background("bg", pmap({"type": "constant",
                                    "color": (1.0, 1.0, 1.0)}))
    s.create_camera("cam", pmap({
        "type": "perspective", "resx": res, "resy": res,
        "from": (0.0, -2.0, 0.0), "to": (0.0, 0.0, 0.0),
        "up": (0.0, -2.0, 1.0), "focal": 1.8}))
    integ = {"type": "pathtracing", "bounces": 2, "raydepth": 2}
    if sampling_factor is not None:
        integ.update(AA_passes=2, AA_inc_samples=2, AA_threshold=0.05)
    s.create_integrator("default", pmap(integ))
    s.set_render_params(pmap({
        "width": res, "height": res, "AA_minsamples": 4,
        "integrator_name": "default", "camera_name": "cam"}))
    return s


def _render_both(make):
    rs, ps = make(RefScene, RefParamMap), make(Scene, ParamMap)
    rcs, pcs = rs.compile(), ps.compile(device="cpu")
    return (rcs, ref_render(rcs, ref_build(rs)), pcs,
            render(pcs, build_config(ps), device="cpu"))


@pytest.mark.parametrize("extra", [0, 1])
def test_additional_depth_matches_reference(extra):
    """additionaldepth 1 raises the panes' lanes' budget to 3 vertices: the
    background shows; without it the corridor stays black.  With no extra
    depth the step is the one without the depth lanes."""
    rcs, ref, pcs, port = _render_both(
        lambda sc, pm: _corridor(sc, pm, additional_depth=extra))
    assert pcs.static.max_additional_depth == \
        rcs.static.max_additional_depth == extra
    _match(ref, port)
    mean = port.image.mean()
    assert (mean > 0.9) if extra else (mean < 1e-3), mean


def test_sampling_factor_matches_reference():
    """samplingfactor 8 on the panes: the primary hits' factor plane (a
    plain per-sample sum) and the adaptive pass it scales the threshold
    of, against the reference; then the threshold scale's effect on the
    flags."""
    rcs, ref, pcs, port = _render_both(
        lambda sc, pm: _corridor(sc, pm, sampling_factor=8.0))
    assert pcs.static.has_sampling_factor and rcs.static.has_sampling_factor
    _match(ref, port, planes=("wsum", "w", "aov_samp_factor"))
    sfac = (port.film["aov_samp_factor"][..., 0]
            / torch.clamp(port.film["nsamples"], min=1)).numpy()
    assert abs(sfac.mean() - 8.0) < 1e-3, sfac.mean()
    film = {k: v for k, v in port.film.items() if k != "rays"}
    jfilm = {k: np.asarray(v) for k, v in ref.film.items()}
    for thr in (0.02, 0.1, 1e9):
        lo = compute_aa_flags(film, thr, threshold_scale=torch.full(
            (8, 8), 1.0 / 8.0))
        assert np.array_equal(lo.numpy(), np.asarray(ref_flags(
            jfilm, thr, threshold_scale=np.full((8, 8), 1.0 / 8.0,
                                                np.float32))))
        assert int(lo.sum()) >= int(compute_aa_flags(film, thr).sum())


def test_sampling_factor_plane_under_spp_batch():
    """The factor plane with 2 samples a step: the flags tiled over the
    batch slices (the reference's step raises here, multiplying its
    H·W·spb factor lanes by H·W flags), the same sample counts and the
    same factor means as one sample a step."""
    out = []
    for spb in (1, 2):
        s = _corridor(Scene, ParamMap, sampling_factor=8.0)
        cfg = RenderConfig(**{**build_config(s).__dict__, "spp_batch": spb})
        out.append(render(s.compile(device="cpu"), cfg, device="cpu"))
    a, b = (r.film for r in out)
    assert torch.equal(a["nsamples"], b["nsamples"])
    assert torch.equal(a["aov_samp_factor"], b["aov_samp_factor"])
    assert float((b["aov_samp_factor"][..., 0] / b["nsamples"]).min()) == 8.0


# ---- the other integrators ----------------------------------------------------


# tests/test_torch_photon.py's slice size, with 2 adaptive passes
PHOTON_PASSES = dict(width=16, height=16, aa_samples=1, raydepth=2,
                     photon_bounces=2, fg_samples=2, photons=4096,
                     caustic_photons=4096, aa_passes=2, aa_inc_samples=1,
                     aa_threshold=0.2)


def test_photonmap_adaptive_passes_match_reference():
    """The reference's photon pass loop: dense steps masked by the
    contrast estimator's flags, no compaction."""
    rs, rc = _scene_file(ref_parse, ref_build, RefConfig, PHOTON, 16,
                         **PHOTON_PASSES)
    ps, pc = _scene_file(parse_xml_file, build_config, RenderConfig, PHOTON,
                         16, **PHOTON_PASSES)
    ref = rpm.render_photonmap(rs.compile(), rc)
    port = ppm.render_photonmap(ps.compile(device="cpu"), pc, device="cpu")
    ns = port.film["nsamples"].numpy()
    assert np.array_equal(ns, np.asarray(ref.film["nsamples"]))
    # pass 1 resampled some pixels, not all
    assert ns.min() == 1 and ns.max() == 2
    assert _rmse(ref.image, port.image) <= 1e-4
    r_ref, r_port = ref.stats["rays"], port.stats["rays"]
    assert abs(r_port - r_ref) <= 1e-4 * r_ref, (r_ref, r_port)


def test_sppm_ignores_aa_passes():
    """SPPM runs its own passes (passNums) and never reads AA_passes, as
    the reference's render_sppm does not: the film is the same bit for
    bit."""
    out = []
    for passes in (1, 3):
        s, c = _scene_file(parse_xml_file, build_config, RenderConfig, SPPM,
                           16, sppm_passes=2, sppm_photons=4096, raydepth=2,
                           aa_passes=passes)
        out.append(psppm.render_sppm(s.compile(device="cpu"), c,
                                     device="cpu"))
    for k in ("wsum", "w", "nsamples", "density"):
        assert torch.equal(out[0].film[k], out[1].film[k]), k
    assert out[0].stats["rays"] == out[1].stats["rays"]


def test_cli_renders_adaptive_passes(tmp_path, capsys):
    """A copy of cornell.xml with AA_passes 3 (and 8 + 4 samples) through
    the CLI on the CPU at 16²: the .exr holds render_scene's image, rays
    equal."""
    with open(CORNELL) as f:
        xml = f.read()
    for key, old, new in (("AA_passes", "1", "3"),
                          ("AA_minsamples", "64", "8"),
                          ("AA_inc_samples", "16", "4")):
        tag = f'<{key} ival="{old}"/>'
        assert tag in xml, tag
        xml = xml.replace(tag, f'<{key} ival="{new}"/>')
    scene_path = tmp_path / "cornell_aa3.xml"
    scene_path.write_text(xml)
    out = str(tmp_path / "aa3.exr")
    assert cli_main([str(scene_path), out, "--width", "16", "--height", "16",
                     "--device", "cpu", "--json-stats"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    scene = parse_xml_file(str(scene_path))
    scene.render_params.update(width=16, height=16)
    assert build_config(scene).aa_passes == 3
    res = render_scene(scene, device="cpu")
    assert len(res.stats["pass_log"]) >= 2
    assert stats["rays"] == res.stats["rays"]
    assert _rmse(read_exr(out), res.image) <= 1e-6
