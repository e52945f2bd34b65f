"""Shading-layer parity of the port against the JAX reference: perspective
camera rays, area-light sampling, the shinydiffuse / glossy /
coated-glossy / glass / light / null BSDFs, the constant background, the
four reconstruction filters, the film, and the analytic spheres' closest
hit, shading record and shadow transmission.

Inputs are made with numpy from a fixed seed and fed to both packages.
Tolerance: allclose atol 1e-6 / rtol 1e-5.  Both sides compute in float32
with the same formulas; the order in which XLA and PyTorch round a few
fused or library operations (sin/cos, reductions) is the only source of
difference.  Boolean lanes must agree exactly."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libyafaray_tpu.backgrounds import base as rbg
from libyafaray_tpu.cameras import base as rcam
from libyafaray_tpu.film import imagefilm as rfilm
from libyafaray_tpu.lights import base as rlights
from libyafaray_tpu.materials import base as rmat
from libyafaray_tpu.materials import bsdf as rbsdf
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch import convert
from libyafaray_tpu_torch.backgrounds import base as pbg
from libyafaray_tpu_torch.cameras import base as pcam
from libyafaray_tpu_torch.film import imagefilm as pfilm
from libyafaray_tpu_torch.lights import base as plights
from libyafaray_tpu_torch.materials import base as pmat
from libyafaray_tpu_torch.materials import bsdf as pbsdf


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU path is many small tensor ops: one thread runs them
    fastest (and keeps parallel test workers off each other's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

N = 4096
ATOL, RTOL = 1e-6, 1e-5
FAMILIES = (rmat.MT_NULL, rmat.MT_SHINYDIFFUSE, rmat.MT_LIGHT)


@pytest.fixture(scope="module")
def cornell():
    s = ref_parse("scenes/cornell.xml")
    s.render_params["width"] = 16
    s.render_params["height"] = 16
    return s.compile()


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def jax_tree(d):
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in d.items()}


def _close(ref, port, name="", rtol=RTOL):
    r = np.asarray(ref)
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    if r.dtype == np.bool_:
        assert np.array_equal(r, p), name
    else:
        np.testing.assert_allclose(p, r, atol=ATOL, rtol=rtol, err_msg=name)


def test_shoot_rays_perspective(cornell, rng):
    cam_r = cornell.camera
    cam_p = convert.camera_from_reference(cam_r)
    px = (rng.random(N) * cam_r.resx).astype(np.float32)
    py = (rng.random(N) * cam_r.resy).astype(np.float32)
    lu = rng.random(N).astype(np.float32)
    ro, rd, rw = rcam.shoot_rays(cam_r, jnp.asarray(px), jnp.asarray(py),
                                 jnp.asarray(lu), jnp.asarray(lu))
    po, pd, pw = pcam.shoot_rays(cam_p, torch.from_numpy(px),
                                 torch.from_numpy(py), torch.from_numpy(lu),
                                 torch.from_numpy(lu))
    for name, r, p in (("org", ro, po), ("dir", rd, pd), ("wt", rw, pw)):
        assert p.dtype == torch.float32
        _close(r, p, name)
    assert pcam.pixel_cone(cam_p) == rcam.pixel_cone(cam_r)


def test_sample_area(cornell, rng):
    lr = rlights.light_row(jax_tree(cornell.arrays["lights"]), 0)
    lp = plights.light_row(convert.to_tensors(cornell.arrays["lights"],
                                              "cpu"), 0)
    p = (rng.random((N, 3)) * 5.5).astype(np.float32)
    u1, u2 = (rng.random(N).astype(np.float32) for _ in range(2))
    r = rlights.sample_area(lr, jnp.asarray(p), jnp.asarray(u1),
                            jnp.asarray(u2))
    s = plights.sample_area(lp, torch.from_numpy(p), torch.from_numpy(u1),
                            torch.from_numpy(u2))
    for k in ("wi", "dist", "li", "pdf", "valid"):
        _close(r[k], s[k], k)


@pytest.fixture(scope="module")
def shading_lanes(cornell, rng):
    """Material rows of the Cornell table plus shinydiffuse variants that
    exercise mirror, transparency, translucency, Fresnel and Oren-Nayar,
    with random frames, directions and uniforms."""
    rows = [dict(r) for r in _cornell_rows()]
    for spec, transp, transl, fres, sigma in ((0.3, 0.2, 0.1, True, 0.0),
                                              (0.0, 0.0, 0.4, False, 0.5),
                                              (0.6, 0.0, 0.0, False, 0.2)):
        r = rmat.default_row()
        r.update(mtype=rmat.MT_SHINYDIFFUSE, diffuse_color=(0.5, 0.6, 0.7),
                 mirror_color=(0.9, 0.8, 0.7), filter_color=(0.3, 0.9, 0.5),
                 specular_reflect=spec, transparency=transp,
                 translucency=transl, fresnel_effect=fres, ior=1.5,
                 sigma=sigma, emit_strength=0.25)
        rows.append(r)
    table = rmat.build_material_table(rows)
    mid = rng.integers(0, len(rows), N).astype(np.int32)
    n = _unit(rng, N)
    ng = n + 0.1 * _unit(rng, N)
    ng = (ng / np.linalg.norm(ng, axis=1, keepdims=True)).astype(np.float32)
    wo, wi = _unit(rng, N), _unit(rng, N)
    u = rng.random((3, N)).astype(np.float32)
    row_r = rmat.gather_rows(jax_tree(table), jnp.asarray(mid))
    row_p = pmat.gather_rows(convert.to_tensors(table, "cpu"),
                             torch.from_numpy(mid).long())
    return row_r, row_p, (n, ng, wo, wi), u


def _cornell_rows():
    s = ref_parse("scenes/cornell.xml")
    s.compile()  # appends the area light's light_mat row
    return s.materials


def test_gather_rows_match(shading_lanes):
    row_r, row_p, _, _ = shading_lanes
    assert set(row_r) == set(row_p)
    for k in row_r:
        assert np.array_equal(np.asarray(row_r[k]), row_p[k].numpy()), k


def test_shinydiffuse_eval_and_pdf(shading_lanes):
    row_r, row_p, vecs, _ = shading_lanes
    jr = [jnp.asarray(v) for v in vecs]
    tp = [torch.from_numpy(v) for v in vecs]
    _close(rbsdf.eval_bsdf(row_r, *jr, families=FAMILIES),
           pbsdf.eval_bsdf(row_p, *tp, FAMILIES), "eval")
    _close(rbsdf.pdf_bsdf(row_r, *jr, families=FAMILIES),
           pbsdf.pdf_bsdf(row_p, *tp, FAMILIES), "pdf")


def test_sample_bsdf_families(shading_lanes):
    row_r, row_p, (n, ng, wo, _), u = shading_lanes
    r = rbsdf.sample_bsdf(row_r, jnp.asarray(n), jnp.asarray(ng),
                          jnp.asarray(wo), *(jnp.asarray(x) for x in u),
                          wavelength=jnp.full((N,), -1.0, jnp.float32),
                          families=FAMILIES)
    p = pbsdf.sample_bsdf(row_p, torch.from_numpy(n), torch.from_numpy(ng),
                          torch.from_numpy(wo),
                          *(torch.from_numpy(x) for x in u), FAMILIES)
    for k in ("wi", "tp", "pdf", "specular", "transmit", "entering",
              "valid", "passthrough"):
        _close(r[k], p[k], k)
    assert np.array_equal(np.asarray(r["new_wavelength"]), np.full(N, -1.0))


# cos(theta_h)^e with exponents up to 200 multiplies the last-bit rounding
# of cos(theta_h) by e: rtol 1e-4 (~e * 8 ulp) on the glossy values
GLOSSY_RTOL = 1e-4
GLOSSY_FAMILIES = (rmat.MT_NULL, rmat.MT_SHINYDIFFUSE, rmat.MT_GLOSSY,
                   rmat.MT_COATED_GLOSSY, rmat.MT_LIGHT)


@pytest.fixture(scope="module")
def glossy_lanes(rng):
    """Glossy and coated-glossy rows (isotropic and anisotropic, the
    grid-spheres scene's own glossy material among them) mixed with a
    shinydiffuse and a null row, with random frames, directions and
    uniforms."""
    rows = []
    for mt, aniso, exp, eu, ev, g_refl, ior in (
            (rmat.MT_GLOSSY, False, 120.0, 50.0, 50.0, 0.7, 1.0),
            (rmat.MT_GLOSSY, False, 8.0, 50.0, 50.0, 0.3, 1.0),
            (rmat.MT_GLOSSY, True, 50.0, 200.0, 20.0, 0.5, 1.0),
            (rmat.MT_COATED_GLOSSY, False, 40.0, 50.0, 50.0, 0.6, 1.5),
            (rmat.MT_COATED_GLOSSY, True, 50.0, 10.0, 90.0, 0.8, 1.8)):
        r = rmat.default_row()
        r.update(mtype=mt, diffuse_color=(0.2, 0.25, 0.7),
                 glossy_color=(0.9, 0.8, 0.6), mirror_color=(0.7, 0.9, 0.8),
                 anisotropic=aniso, exponent=exp, exp_u=eu, exp_v=ev,
                 glossy_reflect=g_refl, ior=ior, diffuse_reflect=0.8)
        rows.append(r)
    shiny = rmat.default_row()
    shiny.update(mtype=rmat.MT_SHINYDIFFUSE, diffuse_color=(0.5, 0.6, 0.7))
    rows += [shiny, rmat.default_row()]
    table = rmat.build_material_table(rows)
    mid = rng.integers(0, len(rows), N).astype(np.int32)
    n = _unit(rng, N)
    ng = n + 0.1 * _unit(rng, N)
    ng = (ng / np.linalg.norm(ng, axis=1, keepdims=True)).astype(np.float32)
    wo = _unit(rng, N)
    # half the wi near the mirror direction, where the glossy lobe peaks
    refl = 2.0 * np.sum(n * wo, axis=1, keepdims=True) * n - wo
    wi = np.where(np.arange(N)[:, None] % 2 == 0, _unit(rng, N),
                  refl + 0.05 * _unit(rng, N))
    wi = (wi / np.linalg.norm(wi, axis=1, keepdims=True)).astype(np.float32)
    u = rng.random((3, N)).astype(np.float32)
    row_r = rmat.gather_rows(jax_tree(table), jnp.asarray(mid))
    row_p = pmat.gather_rows(convert.to_tensors(table, "cpu"),
                             torch.from_numpy(mid).long())
    return row_r, row_p, (n, ng, wo, wi), u


def test_glossy_eval_and_pdf(glossy_lanes):
    row_r, row_p, vecs, _ = glossy_lanes
    jr = [jnp.asarray(v) for v in vecs]
    tp = [torch.from_numpy(v) for v in vecs]
    f = pbsdf.eval_bsdf(row_p, *tp, GLOSSY_FAMILIES)
    assert (f.amax(dim=-1) > 1.0).any()  # the lobe's peak is sampled
    _close(rbsdf.eval_bsdf(row_r, *jr, families=GLOSSY_FAMILIES), f, "eval",
           GLOSSY_RTOL)
    _close(rbsdf.pdf_bsdf(row_r, *jr, families=GLOSSY_FAMILIES),
           pbsdf.pdf_bsdf(row_p, *tp, GLOSSY_FAMILIES), "pdf", GLOSSY_RTOL)


def test_glossy_sample(glossy_lanes):
    row_r, row_p, (n, ng, wo, _), u = glossy_lanes
    r = rbsdf.sample_bsdf(row_r, jnp.asarray(n), jnp.asarray(ng),
                          jnp.asarray(wo), *(jnp.asarray(x) for x in u),
                          families=GLOSSY_FAMILIES)
    p = pbsdf.sample_bsdf(row_p, torch.from_numpy(n), torch.from_numpy(ng),
                          torch.from_numpy(wo),
                          *(torch.from_numpy(x) for x in u), GLOSSY_FAMILIES)
    glossy = np.isin(np.asarray(row_r["mtype"]),
                     (rmat.MT_GLOSSY, rmat.MT_COATED_GLOSSY))
    assert (glossy & np.asarray(r["specular"])).any()  # coat reflections
    assert (glossy & np.asarray(r["valid"]) & ~np.asarray(r["specular"])).any()
    for k in ("wi", "tp", "pdf", "specular", "transmit", "entering",
              "valid", "passthrough"):
        _close(r[k], p[k], k, GLOSSY_RTOL)


@pytest.mark.parametrize("filter_type", ["box", "mitchell", "gauss",
                                         "lanczos"])
def test_filters_match_reference(filter_type):
    from libyafaray_tpu.film import filters as rfilters
    from libyafaray_tpu_torch.film import filters as pfilters

    x = np.linspace(-2.5, 2.5, 2001).astype(np.float32)
    for width in (1.0, 1.5, 2.0, 3.0):
        assert (pfilters.filter_radius(filter_type, width)
                == rfilters.filter_radius(filter_type, width))
        _close(rfilters.eval_filter_1d(filter_type, jnp.asarray(x), width),
               pfilters.eval_filter_1d(filter_type, torch.from_numpy(x),
                                       width), f"{filter_type} {width}")
    with pytest.raises(ValueError, match="unknown filter"):
        pfilters.eval_filter_1d("sinc", torch.from_numpy(x), 1.5)


def test_emission(shading_lanes):
    row_r, row_p, (_, ng, wo, _), _ = shading_lanes
    _close(rbsdf.emission(row_r, jnp.asarray(ng), jnp.asarray(wo)),
           pbsdf.emission(row_p, torch.from_numpy(ng), torch.from_numpy(wo)),
           "emission")


def test_unported_family_raises():
    """Every family of the reference renders now (rough glass was the last,
    ROADMAP Queue 1 item 10); a code outside the table still raises."""
    pbsdf.check_families(tuple(rmat.MATERIAL_TYPE_NAMES.values()))
    with pytest.raises(NotImplementedError, match="Queue 1"):
        pbsdf.check_families((rmat.MT_SHINYDIFFUSE, 42))


def test_eval_background_constant(cornell, rng):
    spec_r = rbg.BackgroundSpec(bg_type=rbg.BG_CONSTANT, power=2.5,
                                color=(0.1, 0.2, 0.3))
    d = _unit(rng, N)
    _close(rbg.eval_background(spec_r, None, jnp.asarray(d)),
           pbg.eval_background(pbg.BackgroundSpec(**spec_r.__dict__),
                               None, torch.from_numpy(d)), "constant")
    # the Cornell scene's own (black) background
    spec_c = convert.static_from_reference(cornell.static).bg
    _close(rbg.eval_background(cornell.static.bg, None, jnp.asarray(d)),
           pbg.eval_background(spec_c, None, torch.from_numpy(d)),
           "cornell")


def test_film_splat_box_and_image(rng):
    _check_splat(rng, "box")


def test_film_splat_gauss_and_image(rng):
    """The grid-spheres scene's gauss filter (width 1.5, radius 1)."""
    _check_splat(rng, "gauss")


def _check_splat(rng, filter_type):
    h, w = 12, 10
    color = rng.random((h, w, 3)).astype(np.float32) * 3.0
    sx, sy = (rng.random((h, w)).astype(np.float32) for _ in range(2))
    active = (rng.random((h, w)) > 0.2).astype(np.float32)
    fr = rfilm.film_init(h, w)
    fp = pfilm.film_init(h, w, "cpu")
    for _ in range(2):  # accumulate twice, as consecutive steps do
        fr = rfilm.film_splat(fr, jnp.asarray(color), jnp.asarray(sx),
                              jnp.asarray(sy), jnp.asarray(active),
                              filter_type, 1.5)
        fp = pfilm.film_splat(fp, torch.from_numpy(color),
                              torch.from_numpy(sx), torch.from_numpy(sy),
                              torch.from_numpy(active), filter_type, 1.5)
    for k in ("wsum", "w", "nsamples"):
        _close(fr[k], fp[k], k)
    _close(rfilm.film_image(fr), pfilm.film_image(fp), "image")


GLASS_FAMILIES = (rmat.MT_NULL, rmat.MT_SHINYDIFFUSE, rmat.MT_GLASS,
                  rmat.MT_LIGHT)


def test_glass_sample(rng):
    """Smooth glass (cornell_photon.xml's IOR 1.55 and a denser 2.4, where
    total internal reflection is common) mixed with null and shinydiffuse
    rows: both Fresnel lobes are sampled, from both sides."""
    rows = []
    for ior, mirror, filt in ((1.55, (1.0, 1.0, 1.0), (0.97, 0.99, 0.98)),
                              (2.4, (0.8, 0.9, 1.0), (0.6, 0.7, 0.8))):
        r = rmat.default_row()
        r.update(mtype=rmat.MT_GLASS, ior=ior, mirror_color=mirror,
                 filter_color=filt)
        rows.append(r)
    shiny = rmat.default_row()
    shiny.update(mtype=rmat.MT_SHINYDIFFUSE, diffuse_color=(0.5, 0.6, 0.7))
    rows += [shiny, rmat.default_row()]
    table = rmat.build_material_table(rows)
    mid = rng.integers(0, len(rows), N).astype(np.int32)
    n = _unit(rng, N)
    ng = n + 0.1 * _unit(rng, N)
    ng = (ng / np.linalg.norm(ng, axis=1, keepdims=True)).astype(np.float32)
    wo = _unit(rng, N)
    u = rng.random((3, N)).astype(np.float32)
    row_r = rmat.gather_rows(jax_tree(table), jnp.asarray(mid))
    row_p = pmat.gather_rows(convert.to_tensors(table, "cpu"),
                             torch.from_numpy(mid).long())
    r = rbsdf.sample_bsdf(row_r, jnp.asarray(n), jnp.asarray(ng),
                          jnp.asarray(wo), *(jnp.asarray(x) for x in u),
                          families=GLASS_FAMILIES)
    p = pbsdf.sample_bsdf(row_p, torch.from_numpy(n), torch.from_numpy(ng),
                          torch.from_numpy(wo),
                          *(torch.from_numpy(x) for x in u), GLASS_FAMILIES)
    glass = np.asarray(row_r["mtype"]) == rmat.MT_GLASS
    tr = np.asarray(r["transmit"])
    assert (glass & tr).sum() > 100 and (glass & ~tr).sum() > 100
    for k in ("wi", "tp", "pdf", "specular", "transmit", "entering",
              "valid", "passthrough"):
        _close(r[k], p[k], k)
    # delta lobes: nothing to evaluate
    wi = _unit(rng, N)
    f = pbsdf.eval_bsdf(row_p, torch.from_numpy(n), torch.from_numpy(ng),
                        torch.from_numpy(wo), torch.from_numpy(wi),
                        GLASS_FAMILIES)
    assert (f[torch.from_numpy(glass)] == 0).all()


@pytest.fixture(scope="module")
def photon_scene():
    s = ref_parse("scenes/cornell_photon.xml")
    s.render_params["width"] = 16
    s.render_params["height"] = 16
    return s.compile()


def _sphere_rays(rng, n=N):
    """Rays from inside the box, half of them aimed at the two spheres."""
    org = rng.uniform((0.3, 0.3, 0.3), (5.2, 5.3, 5.2), (n, 3))
    aim = np.where(np.arange(n)[:, None] % 4 == 0, (1.86, 1.69, 2.35),
                   (4.3, 1.1, 0.65)) + rng.normal(0, 0.5, (n, 3))
    d = np.where(np.arange(n)[:, None] % 2 == 0, aim - org,
                 rng.normal(size=(n, 3)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org.astype(np.float32), d.astype(np.float32)


def test_sphere_hit_and_surface_point(photon_scene, rng):
    """The merged triangle + analytic sphere closest hit and its shading
    record (sphere hits: tri = -2 - sphere) against the reference's, both
    compiled as its render step compiles them: XLA contracts the quadric's
    multiply-adds there, and the port's `_sphere_roots` rounds them once
    too (near a silhouette the op-by-op reference's t moves by ~1e-5)."""
    from libyafaray_tpu.integrators import engine as reng
    from libyafaray_tpu_torch.integrators import engine as peng

    org, d = _sphere_rays(rng)
    tmin = np.full(N, 5e-5, np.float32)
    tmax = np.where(np.arange(N) % 7 == 0, 2.0, np.inf).astype(np.float32)
    ra = jax_tree(photon_scene.arrays)
    pa = convert.arrays_from_reference(photon_scene.arrays, "cpu")
    ps = convert.static_from_reference(photon_scene.static)
    rh = jax.jit(lambda *a: reng._closest_hit(ra, photon_scene.static, *a))(
        jnp.asarray(org), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax))
    ph = peng.closest_hit(pa, ps, *(torch.from_numpy(x)
                                    for x in (org, d, tmin, tmax)))
    hit = np.array(rh.hit)
    assert (np.asarray(rh.tri)[hit] < -1).sum() > N // 8  # sphere hits
    _close(rh.hit, ph.hit, "hit")
    assert np.array_equal(np.asarray(rh.tri)[hit], ph.tri.numpy()[hit])
    _close(np.asarray(rh.t)[hit], ph.t[torch.from_numpy(hit)], "t", 1e-4)
    rs = jax.jit(lambda h, o, d_: reng._surface_point(ra, h, o, d_))(
        rh, jnp.asarray(org), jnp.asarray(d))
    pt = peng._surface_point(pa, ph, torch.from_numpy(org),
                             torch.from_numpy(d))
    for k in ("p", "n", "ng"):
        np.testing.assert_allclose(pt[k].numpy()[hit], np.asarray(rs[k])[hit],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("mat", "light_id"):
        assert np.array_equal(pt[k].numpy()[hit], np.asarray(rs[k])[hit]), k


@pytest.mark.parametrize("transp_shad", [False, True])
def test_sphere_shadow_transmission(photon_scene, rng, transp_shad):
    """Shadow segments through the glass (two roots, filter applied per
    crossing with transpShad, opaque without) and chrome spheres."""
    from libyafaray_tpu.integrators import engine as reng
    from libyafaray_tpu.integrators.config import RenderConfig as RC
    from libyafaray_tpu_torch.integrators import engine as peng

    org, d = _sphere_rays(rng)
    dist = np.where(np.arange(N) % 5 == 0, -1.0,
                    rng.uniform(0.1, 6.0, N)).astype(np.float32)
    ra = jax_tree(photon_scene.arrays)
    pa = convert.arrays_from_reference(photon_scene.arrays, "cpu")
    ps = convert.static_from_reference(photon_scene.static)
    rt = reng._shadow_transmission(ra, photon_scene.static,
                                   RC(transp_shad=transp_shad),
                                   jnp.asarray(org), jnp.asarray(d),
                                   jnp.asarray(dist))
    pt = peng.shadow_transmission(pa, ps, transp_shad, torch.from_numpy(org),
                                  torch.from_numpy(d),
                                  torch.from_numpy(dist))
    rt = np.asarray(rt)
    assert 0.1 < (rt.max(axis=1) < 1e-3).mean() < 0.9
    # the tiny kernels floor an opaque hit at exp(-80), the reference's
    # brute force gives 0: the intersection tolerance, atol 2e-3
    np.testing.assert_allclose(pt.numpy(), rt, atol=2e-3, rtol=0)
