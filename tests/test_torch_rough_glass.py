"""Rough glass (materials/bsdf.py `_rough_glass_terms` and its eval, pdf
and sample branches) in the port against the JAX package on the CPU:
- eval_bsdf, pdf_bsdf and sample_bsdf lane by lane on numpy-seeded rows,
  frames, directions and uniforms (rough glass of three IORs and
  roughnesses beside smooth glass, null and shinydiffuse rows): floats
  within rtol 1e-5 / atol 1e-6, flags equal (the JAX side op by op); the
  sampled pdf within rtol 1e-4, at most one lane in 1,000 outside 1e-5
  (pow(cos θh, 300) of a sampled half-vector, see the test);
- the reference's own consistency checks on the port's sampler
  (tests/test_materials.py: the sampled pdf equals pdf_bsdf, tp equals
  f·|cos|/pdf, the smooth limit is the delta glass's Fresnel split);
- the white furnace of tests/test_integrators.py (a lossless rough-glass
  sphere in a uniform environment with its IBL light) on the port, under
  that test's bound (mean |pixel - 0.5| < 0.05), at 16², 16 spp;
- scenes/cornell_surfaces.xml (its rough-glass sphere beside the
  dispersive prism) as BDPT (raydepth 3) and as photon mapping with the
  prism's glass made diffuse, 16², 2 spp, against the reference: image
  RMSE <= 1e-4, rays equal (BDPT) and within 0.01% (photon mapping)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu.materials import base as rmat
from libyafaray_tpu.materials import bsdf as rbsdf
from libyafaray_tpu.scene.session import render_scene as ref_render_scene
from libyafaray_tpu.scene.xml_parser import parse_xml_string as ref_parse_str
from libyafaray_tpu_torch import convert
from libyafaray_tpu_torch.core import math as vmath
from libyafaray_tpu_torch.materials import base as pmat
from libyafaray_tpu_torch.materials import bsdf as pbsdf
from libyafaray_tpu_torch.scene.params import ParamMap
from libyafaray_tpu_torch.scene.scene import Scene
from libyafaray_tpu_torch.scene.session import render_scene
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_string

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SURFACES = os.path.join(REPO, "scenes", "cornell_surfaces.xml")
N = 4096
RTOL, ATOL = 1e-5, 1e-6
FAMILIES = (rmat.MT_NULL, rmat.MT_SHINYDIFFUSE, rmat.MT_GLASS,
            rmat.MT_ROUGH_GLASS)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _close(ref, port, name=""):
    r = np.asarray(ref)
    p = port.numpy()
    if r.dtype == np.bool_:
        assert np.array_equal(r, p), name
    else:
        np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.fixture(scope="module")
def lanes():
    """Rows, frames, directions and uniforms, each lane's row drawn from a
    table of rough glass (IOR 1.5 / 1.33 / 2.0, exponents 60 / 8 / 300:
    alpha ~0.18 / ~0.47 / ~0.08), smooth glass, shinydiffuse and null."""
    rng = np.random.default_rng(11)
    rows = []
    for ior, e in ((1.5, 60.0), (1.33, 8.0), (2.0, 300.0)):
        r = rmat.default_row()
        r.update(mtype=rmat.MT_ROUGH_GLASS, ior=ior, exponent=e,
                 mirror_color=(1.0, 0.9, 0.8), filter_color=(0.9, 0.95, 1.0))
        rows.append(r)
    g = rmat.default_row()
    g.update(mtype=rmat.MT_GLASS, ior=1.55, filter_color=(0.97, 0.99, 0.98))
    s = rmat.default_row()
    s.update(mtype=rmat.MT_SHINYDIFFUSE, diffuse_color=(0.5, 0.6, 0.7))
    rows += [g, s, rmat.default_row()]
    table = rmat.build_material_table(rows)
    mid = rng.integers(0, len(rows), N).astype(np.int32)
    n = _unit(rng, N)
    ng = n + 0.1 * _unit(rng, N)
    ng = (ng / np.linalg.norm(ng, axis=1, keepdims=True)).astype(np.float32)
    wo, wi = _unit(rng, N), _unit(rng, N)
    u = rng.random((3, N)).astype(np.float32)
    row_r = rmat.gather_rows({k: jnp.asarray(v) for k, v in table.items()},
                             jnp.asarray(mid))
    row_p = pmat.gather_rows(convert.to_tensors(table, "cpu"),
                             torch.from_numpy(mid).long())
    return row_r, row_p, (n, ng, wo, wi), u, mid


def test_rough_glass_eval_and_pdf_match_reference(lanes):
    row_r, row_p, (n, ng, wo, wi), _, mid = lanes
    J = jnp.asarray
    T = torch.from_numpy
    rough = mid < 3
    f = pbsdf.eval_bsdf(row_p, T(n), T(ng), T(wo), T(wi), FAMILIES)
    p = pbsdf.pdf_bsdf(row_p, T(n), T(ng), T(wo), T(wi), FAMILIES)
    _close(rbsdf.eval_bsdf(row_r, J(n), J(ng), J(wo), J(wi),
                           families=FAMILIES), f, "eval")
    _close(rbsdf.pdf_bsdf(row_r, J(n), J(ng), J(wo), J(wi),
                          families=FAMILIES), p, "pdf")
    # both lobes are reached: reflection and transmission pairs
    cos_i = (n * wi).sum(1) * np.sign((n * wo).sum(1))
    assert (p.numpy()[rough & (cos_i > 0)] > 0).sum() > 100
    assert (p.numpy()[rough & (cos_i < 0)] > 0).sum() > 100


def test_rough_glass_sample_matches_reference(lanes):
    row_r, row_p, (n, ng, wo, _), u, mid = lanes
    r = rbsdf.sample_bsdf(row_r, *(jnp.asarray(x) for x in (n, ng, wo)),
                          *(jnp.asarray(x) for x in u), families=FAMILIES)
    p = pbsdf.sample_bsdf(row_p, *(torch.from_numpy(x) for x in (n, ng, wo)),
                          *(torch.from_numpy(x) for x in u), FAMILIES)
    assert set(r) == set(p)
    for k in r:
        if k != "pdf":
            _close(r[k], p[k], k)
    # the sampled pdf carries pow(cos θh, e) of a half-vector that is
    # itself a pow of the uniform: at e = 300 a few-ulp difference between
    # XLA's and torch's float32 pow grows ~300-fold, so a lane in a
    # thousand may leave rtol 1e-5; all stay within 1e-4
    pr, pp = np.asarray(r["pdf"]), p["pdf"].numpy()
    np.testing.assert_allclose(pp, pr, rtol=1e-4, atol=ATOL)
    assert (~np.isclose(pp, pr, rtol=RTOL, atol=ATOL)).sum() <= N // 1000
    rough = mid < 3
    v = p["valid"].numpy() & rough
    tr = p["transmit"].numpy()
    assert (v & tr).sum() > 100 and (v & ~tr).sum() > 100
    # non-delta, but a chain lobe for the photon passes
    assert not p["specular"].numpy()[v].any() and p["chain"].numpy()[v].all()


def _table_rows(**over):
    r = pmat.default_row()
    r.update(**over)
    table = pmat.build_material_table([r])
    return pmat.gather_rows(convert.to_tensors(table, "cpu"),
                            torch.zeros(N, dtype=torch.long))


def _sample(row):
    rng = np.random.default_rng(0)
    nrm = torch.tensor([[0.0, 0.0, 1.0]]).expand(N, 3).contiguous()
    wo = vmath.normalize(torch.tensor([[0.3, 0.1, 0.8]]).expand(N, 3)
                         .contiguous())
    u = [torch.from_numpy(rng.random(N).astype(np.float32))
         for _ in range(3)]
    return nrm, wo, pbsdf.sample_bsdf(row, nrm, nrm, wo, *u,
                                      (pmat.MT_ROUGH_GLASS,))


def test_rough_glass_sample_eval_pdf_consistent():
    """The reference's tests/test_materials.py:262 on the port: the
    sampler's pdf is pdf_bsdf's, its tp is f·|cos|/pdf, its mean weight is
    bounded."""
    row = _table_rows(mtype=pmat.MT_ROUGH_GLASS, ior=1.5, exponent=60.0,
                      filter_color=(1.0, 1.0, 1.0),
                      mirror_color=(1.0, 1.0, 1.0))
    nrm, wo, s = _sample(row)
    fam = (pmat.MT_ROUGH_GLASS,)
    v = s["valid"].numpy()
    pdf_s = s["pdf"].numpy()
    assert (pdf_s[v] > 0).all()
    pdf2 = pbsdf.pdf_bsdf(row, nrm, nrm, wo, s["wi"], fam).numpy()
    r = pdf_s[v] / np.maximum(pdf2[v], 1e-12)
    assert np.quantile(np.abs(r - 1.0), 0.9) < 5e-3
    f = pbsdf.eval_bsdf(row, nrm, nrm, wo, s["wi"], fam).numpy()
    ci = np.abs(s["wi"].numpy()[:, 2])
    tp_ref = f * (ci / np.maximum(pdf_s, 1e-12))[:, None]
    tp = s["tp"].numpy()
    ok = v & (pdf_s > 1e-6) & (ci > 1e-3)
    rel = np.abs(tp[ok] - tp_ref[ok]) / np.maximum(tp_ref[ok], 1e-3)
    assert np.quantile(rel, 0.9) < 2e-2
    assert np.all(tp[v].mean(axis=0) < 1.1)


def test_rough_glass_smooth_limit_matches_delta_glass():
    """tests/test_materials.py:299 on the port: at exponent 20,000 the
    reflected share is the delta glass's Fresnel kr and the weights are
    ~1."""
    row = _table_rows(mtype=pmat.MT_ROUGH_GLASS, ior=1.5, exponent=20000.0,
                      filter_color=(1.0, 1.0, 1.0),
                      mirror_color=(1.0, 1.0, 1.0))
    nrm, wo, s = _sample(row)
    v = s["valid"].numpy()
    trans = s["transmit"].numpy() & v
    kr = float(vmath.fresnel_dielectric(
        vmath.dot(nrm, wo)[:1], torch.tensor([1.5]))[0])
    assert abs((1.0 - trans[v].mean()) - kr) < 0.03
    tp = s["tp"].numpy()[v]
    assert np.quantile(np.abs(tp - 1.0), 0.8) < 0.05


def _furnace(res, spp):
    """tests/test_integrators.py's `_sphere_scene` with its rough-glass
    furnace parameters, built through the port's flat API."""
    s = Scene()
    s.create_material("m", ParamMap({
        "type": "rough_glass", "IOR": 1.5, "alpha": 0.35,
        "filter_color": (1.0, 1.0, 1.0), "mirror_color": (1.0, 1.0, 1.0)}))
    s.create_background("bg", ParamMap({
        "type": "constant", "color": (0.5, 0.5, 0.5), "ibl": True,
        "ibl_samples": 4}))
    s.add_sphere((0.0, 0.0, 0.0), 1.0, "m")
    s.create_camera("cam", ParamMap({
        "type": "perspective", "resx": res, "resy": res,
        "from": (0.0, -4.0, 0.0), "to": (0.0, 0.0, 0.0),
        "up": (0.0, -4.0, 1.0), "focal": 1.8}))
    s.create_integrator("default", ParamMap({
        "type": "pathtracing", "bounces": 6, "raydepth": 6,
        "path_samples": 1}))
    s.render_params = ParamMap({
        "width": res, "height": res, "AA_minsamples": spp,
        "integrator_name": "default", "camera_name": "cam"})
    return s


def test_white_furnace_rough_glass():
    """Energy conservation of rough transmission through the whole path
    tracer (NEE and MIS see the non-delta lobe): every pixel ~0.5."""
    img = render_scene(_furnace(16, 16), device="cpu").image
    assert np.isfinite(img).all()
    err = np.abs(img - 0.5)
    assert err.mean() < 0.05, (img.mean(), err.mean())


def _surfaces_text(diffuse_prism: bool) -> str:
    with open(SURFACES) as f:
        text = f.read()
    if diffuse_prism:
        # photon mapping: the prism's triangle glass, whose caustic photons
        # the two packages route differently near its edges, turns diffuse
        text = text.replace(
            '<type sval="glass"/>\n    <IOR fval="1.55"/>\n'
            '    <dispersion_power fval="2.0"/>',
            '<type sval="shinydiffusemat"/>')
    return text


@pytest.mark.parametrize("integrator, extra", [
    ("bidirectional", dict(raydepth=3)),
    ("photonmapping", dict(raydepth=3, photons=4096, cPhotons=4096,
                           fg_samples=4)),
])
def test_cornell_surfaces_matches_reference(integrator, extra):
    photon = integrator == "photonmapping"
    out = []
    for parse, run in ((ref_parse_str, ref_render_scene),
                       (parse_xml_string, render_scene)):
        s = parse(_surfaces_text(photon))
        s.render_params.update(width=16, height=16, AA_minsamples=2)
        s.integrator_params["default"]["type"] = integrator
        s.integrator_params["default"].update(extra)
        out.append(run(s) if run is ref_render_scene
                   else run(s, device="cpu"))
    ref, port = out
    img = port.image
    assert np.isfinite(img).all() and img.mean() > 0.05
    rmse = float(np.sqrt(np.mean((img.astype(np.float64) - ref.image) ** 2)))
    assert rmse <= 1e-4, rmse
    r_ref, r_port = ref.stats["rays"], port.stats["rays"]
    if photon:
        assert abs(r_port - r_ref) <= 1e-4 * r_ref, (r_ref, r_port)
    else:
        assert r_port == r_ref > 0
