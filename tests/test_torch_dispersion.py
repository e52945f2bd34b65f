"""Spectral dispersion (a glass's dispersion_power > 0) in the port against
the JAX package on the CPU:
- core/color.py's wl_to_rgb, cauchy_coefficients and cauchy_ior: rtol
  1e-6;
- sample_bsdf with a wavelength lane, lane by lane (chromatic and
  wavelength lanes on dispersive glass of two powers, plain glass, null
  and shinydiffuse rows): new_wavelength and the flags equal, floats
  within rtol 1e-5 / atol 1e-6 (the JAX side op by op); the wavelength
  draw hashes u1 (the reference's bits), it is no QMC dimension;
- the reference's tests/test_dispersion_cameras.py:26 on the port: a
  chromatic lane that a dispersive glass transmits draws a wavelength in
  [0, 1], the refracted direction spreads with it, wl_to_rgb averages to
  white within 0.15, a non-dispersive glass keeps lanes chromatic;
- scenes/cornell_path.xml with its glass made dispersive (power 1.5) as
  pathtracing and directlighting, 16², 2 spp, and as pathtracing at
  spp_batch 2: image RMSE <= 1e-4 (tests/test_torch_render.py's bound),
  rays equal; its reflect and refract planes with the chrome sphere made
  rough glass (8², 2 spp) within tests/test_torch_passes.py's bound; its
  adaptive passes (32², 3 passes, threshold 0.3) compact and dense give
  bit-equal films;
- BDPT and photon mapping, which carry no wavelength lane in the
  reference: the port renders the dispersive scene with the bits of the
  same scene at dispersion_power 0 (8², 2 spp).  (The reference holds the
  dispersive prism of scenes/cornell_surfaces.xml under BDPT:
  tests/test_torch_rough_glass.py.)"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu.core import color as rcolor
from libyafaray_tpu.integrators.config import RenderConfig as RefConfig
from libyafaray_tpu.integrators.render import render as ref_render
from libyafaray_tpu.materials import base as rmat
from libyafaray_tpu.materials import bsdf as rbsdf
from libyafaray_tpu.scene.session import build_config as ref_build
from libyafaray_tpu.scene.xml_parser import parse_xml_string as ref_parse_str
from libyafaray_tpu_torch import convert
from libyafaray_tpu_torch.core import color as pcolor
from libyafaray_tpu_torch.integrators.config import RenderConfig
from libyafaray_tpu_torch.integrators.render import render
from libyafaray_tpu_torch.materials import base as pmat
from libyafaray_tpu_torch.materials import bsdf as pbsdf
from libyafaray_tpu_torch.materials.factory import material_row_from_params
from libyafaray_tpu_torch.scene.params import ParamMap
from libyafaray_tpu_torch.scene.session import build_config, render_scene
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_string

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL_PATH = os.path.join(REPO, "scenes", "cornell_path.xml")
N = 4096
RTOL, ATOL = 1e-5, 1e-6
FAMILIES = (rmat.MT_NULL, rmat.MT_SHINYDIFFUSE, rmat.MT_GLASS)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _close(ref, port, name="", rtol=RTOL):
    r = np.asarray(ref)
    p = port.numpy()
    if r.dtype == np.bool_:
        assert np.array_equal(r, p), name
    else:
        np.testing.assert_allclose(p, r, rtol=rtol, atol=ATOL, err_msg=name)


def test_spectral_helpers_match_reference():
    w = np.linspace(0.0, 1.0, 2049, dtype=np.float32)
    _close(rcolor.wl_to_rgb(jnp.asarray(w)),
           pcolor.wl_to_rgb(torch.from_numpy(w)), "wl_to_rgb", rtol=1e-6)
    ior = np.asarray([1.33, 1.5, 1.55, 2.4], np.float32)
    power = np.asarray([0.5, 1.0, 1.5, 3.0], np.float32)
    ra, rb = rcolor.cauchy_coefficients(jnp.asarray(ior), jnp.asarray(power))
    pa, pb = pcolor.cauchy_coefficients(torch.from_numpy(ior),
                                        torch.from_numpy(power))
    _close(ra, pa, "A", rtol=1e-6)
    _close(rb, pb, "B", rtol=1e-6)
    ww = np.linspace(0.0, 1.0, 4, dtype=np.float32)
    _close(rcolor.cauchy_ior(ra, rb, jnp.asarray(ww)),
           pcolor.cauchy_ior(pa, pb, torch.from_numpy(ww)), "n", rtol=1e-6)


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(23)
    rows = []
    for ior, power in ((1.55, 1.5), (1.5, 3.0), (1.5, 0.0)):
        r = rmat.default_row()
        r.update(mtype=rmat.MT_GLASS, ior=ior, dispersion_power=power,
                 mirror_color=(1.0, 0.95, 0.9),
                 filter_color=(0.97, 0.99, 0.98))
        rows.append(r)
    s = rmat.default_row()
    s.update(mtype=rmat.MT_SHINYDIFFUSE, diffuse_color=(0.5, 0.6, 0.7))
    rows += [s, rmat.default_row()]
    table = rmat.build_material_table(rows)
    mid = rng.integers(0, len(rows), N).astype(np.int32)
    n = _unit(rng, N)
    ng = n + 0.1 * _unit(rng, N)
    ng = (ng / np.linalg.norm(ng, axis=1, keepdims=True)).astype(np.float32)
    wo = _unit(rng, N)
    u = rng.random((3, N)).astype(np.float32)
    # half the lanes chromatic, half carrying a wavelength already
    wl = np.where(rng.random(N) < 0.5, -1.0, rng.random(N)).astype(np.float32)
    row_r = rmat.gather_rows({k: jnp.asarray(v) for k, v in table.items()},
                             jnp.asarray(mid))
    row_p = pmat.gather_rows(convert.to_tensors(table, "cpu"),
                             torch.from_numpy(mid).long())
    return row_r, row_p, (n, ng, wo), u, wl, mid


def test_sample_with_wavelength_matches_reference(lanes):
    row_r, row_p, geo, u, wl, mid = lanes
    r = rbsdf.sample_bsdf(row_r, *(jnp.asarray(x) for x in geo),
                          *(jnp.asarray(x) for x in u),
                          wavelength=jnp.asarray(wl), families=FAMILIES)
    p = pbsdf.sample_bsdf(row_p, *(torch.from_numpy(x) for x in geo),
                          *(torch.from_numpy(x) for x in u), FAMILIES,
                          torch.from_numpy(wl))
    assert set(r) == set(p)
    for k in r:
        _close(r[k], p[k], k)
    new = p["new_wavelength"].numpy()
    disp = mid < 2
    drawn = disp & (wl < 0.0) & p["transmit"].numpy()
    assert drawn.sum() > 100
    assert ((new[drawn] >= 0.0) & (new[drawn] <= 1.0)).all()
    # a lane keeps a wavelength once drawn; others stay chromatic
    assert np.array_equal(new[wl >= 0.0], wl[wl >= 0.0])
    assert (new[~drawn & (wl < 0.0)] < 0.0).all()
    # without a wavelength lane the dispersive glass is glass at its IOR
    plain = pbsdf.sample_bsdf(row_p, *(torch.from_numpy(x) for x in geo),
                              *(torch.from_numpy(x) for x in u), FAMILIES)
    assert "new_wavelength" not in plain
    r0 = rbsdf.sample_bsdf(row_r, *(jnp.asarray(x) for x in geo),
                           *(jnp.asarray(x) for x in u), families=FAMILIES)
    for k in r0:
        _close(r0[k], plain[k], k)


def _glass_row(n, dispersion=0.01):
    row = material_row_from_params(ParamMap({
        "type": "glass", "IOR": 1.55, "dispersion_power": dispersion,
        "filter_color": (1.0, 1.0, 1.0)}), {}, {}, {})
    table = pmat.build_material_table([row])
    return pmat.gather_rows(convert.to_tensors(table, "cpu"),
                            torch.zeros(n, dtype=torch.long))


def test_glass_dispersion_samples_wavelengths_and_spreads():
    """tests/test_dispersion_cameras.py:26 on the port."""
    n = 4096
    rng = np.random.default_rng(5)
    row = _glass_row(n)
    nrm = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3).contiguous()
    wo = torch.tensor([[np.sqrt(0.5), 0.0, np.sqrt(0.5)]],
                      dtype=torch.float32).expand(n, 3).contiguous()
    u1, u2, ul = (torch.from_numpy(rng.random(n).astype(np.float32))
                  for _ in range(3))
    wl = torch.full((n,), -1.0)
    fam = (pmat.MT_GLASS,)
    smp = pbsdf.sample_bsdf(row, nrm, nrm, wo, u1, u2, ul, fam, wl)
    tr = (smp["transmit"] & smp["valid"]).numpy()
    assert tr.sum() > n // 4
    new_wl = smp["new_wavelength"].numpy()
    assert (new_wl[tr] >= 0.0).all() and (new_wl[tr] <= 1.0).all()
    wi = smp["wi"].numpy()
    lo = tr & (new_wl < 0.2)
    hi = tr & (new_wl > 0.8)
    assert lo.sum() > 50 and hi.sum() > 50
    assert abs(wi[lo, 0].mean() - wi[hi, 0].mean()) > 1e-4
    mean_rgb = pcolor.wl_to_rgb(torch.linspace(0.0, 1.0, 2048)).mean(0)
    assert (torch.abs(mean_rgb - 1.0) < 0.15).all(), mean_rgb
    smp0 = pbsdf.sample_bsdf(_glass_row(n, 0.0), nrm, nrm, wo, u1, u2, ul,
                             fam, wl)
    assert (smp0["new_wavelength"] < 0.0).all()


def _dispersive_text(power: float = 1.5) -> str:
    with open(CORNELL_PATH) as f:
        text = f.read()
    return text.replace('<IOR fval="1.55"/>',
                        f'<IOR fval="1.55"/>\n    <dispersion_power '
                        f'fval="{power}"/>', 1)


def _pair(integrator, size=16, spp=2, **over):
    out = []
    for parse, build, cfg_cls, run in (
            (ref_parse_str, ref_build, RefConfig, ref_render),
            (parse_xml_string, build_config, RenderConfig, render)):
        s = parse(_dispersive_text())
        s.render_params.update(width=size, height=size, AA_minsamples=spp)
        s.integrator_params["default"]["type"] = integrator
        cfg = cfg_cls(**{**build(s).__dict__, **over})
        out.append(run(s.compile(), cfg) if run is ref_render
                   else run(s.compile(device="cpu"), cfg, device="cpu"))
    return out


@pytest.mark.parametrize("integrator, over", [
    ("pathtracing", {}), ("directlighting", {}),
    ("pathtracing", {"spp_batch": 2})],
    ids=["pathtracing", "directlighting", "pathtracing_spp_batch_2"])
def test_dispersive_render_matches_reference(integrator, over):
    ref, port = _pair(integrator, **over)
    img = port.image
    assert np.isfinite(img).all() and img.mean() > 0.05
    rmse = float(np.sqrt(np.mean((img.astype(np.float64) - ref.image) ** 2)))
    assert rmse <= 1e-4, rmse
    assert port.stats["rays"] == ref.stats["rays"] > 0


def test_dispersive_and_rough_transmission_planes_match_reference():
    """The reflect and refract planes (the engine's bounce-0 tags) with the
    glass dispersive and the chrome sphere made rough glass, path tracer,
    8², 2 spp: a dispersive transmission is specular and lands in the
    refract plane, a rough one is not and lands in neither, as in the
    reference; each plane within 1e-4 · max(1, max|plane|)
    (tests/test_torch_passes.py's bound)."""
    text = _dispersive_text().replace(
        '<type sval="glossy"/>', '<type sval="rough_glass"/>\n'
        '    <alpha fval="0.2"/>', 1)
    passes = ("reflect", "refract")
    out = []
    for parse, build, cfg_cls, run in (
            (ref_parse_str, ref_build, RefConfig, ref_render),
            (parse_xml_string, build_config, RenderConfig, render)):
        s = parse(text)
        s.render_params.update(width=8, height=8, AA_minsamples=2)
        cfg = cfg_cls(**{**build(s).__dict__, "passes": passes})
        out.append(run(s.compile(), cfg) if run is ref_render
                   else run(s.compile(device="cpu"), cfg, device="cpu"))
    ref, port = out
    for name in passes:
        r, p = np.asarray(ref.passes[name]), port.passes[name]
        assert np.isfinite(p).all() and r.shape == p.shape, name
        tol = 1e-4 * max(1.0, float(np.abs(r).max()))
        assert np.abs(p - r).max() <= tol, name
    assert float(np.asarray(port.passes["refract"]).max()) > 0.0


def test_dispersion_changes_the_path_traced_image():
    """The wavelength lane is live: the dispersive glass renders other
    bits than the same glass at power 0."""
    imgs = []
    for power in (1.5, 0.0):
        s = parse_xml_string(_dispersive_text(power))
        s.render_params.update(width=8, height=8, AA_minsamples=2)
        assert s.compile(device="cpu").static.dispersion == (power > 0)
        imgs.append(render_scene(s, device="cpu").image)
    assert not np.array_equal(*imgs)


def test_compact_passes_equal_dense_with_dispersion():
    """Adaptive passes over the wavelength lane: compact and dense films
    bit-equal, some pass compact."""
    s = parse_xml_string(_dispersive_text())
    s.render_params.update(width=32, height=32, AA_minsamples=4,
                           AA_passes=3, AA_inc_samples=2, AA_threshold=0.3)
    cs = s.compile(device="cpu")
    cfg = build_config(s)
    comp = render(cs, cfg, device="cpu", compact=True)
    dense = render(cs, cfg, device="cpu", compact=False)
    assert "compact" in [e["mode"] for e in comp.stats["pass_log"]]
    assert np.array_equal(comp.image, dense.image)
    assert comp.stats["rays"] == dense.stats["rays"]


@pytest.mark.parametrize("integrator, extra", [
    ("bidirectional", dict(raydepth=3)),
    ("photonmapping", dict(raydepth=3, photons=4096, cPhotons=4096,
                           fg_samples=2)),
])
def test_wavelength_free_integrators_ignore_dispersion(integrator, extra):
    """BDPT and photon mapping carry no wavelength lane (as the reference's
    veach.py and photon passes): a dispersive glass renders as glass at
    its base IOR."""
    imgs = []
    for power in (1.5, 0.0):
        s = parse_xml_string(_dispersive_text(power))
        s.render_params.update(width=8, height=8, AA_minsamples=2)
        s.integrator_params["default"]["type"] = integrator
        s.integrator_params["default"].update(extra)
        imgs.append(render_scene(s, device="cpu").image)
    assert np.isfinite(imgs[0]).all() and imgs[0].mean() > 0.05
    assert np.array_equal(*imgs)
