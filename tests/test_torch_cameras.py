"""Every camera of the reference, function by function: the port's
`shoot_rays`, `_bokeh_warp`, `pixel_cone`, `project_to_camera` and
`pixel_plane_area` (cameras/base.py) against the JAX package's on the same
pixel and lens uniforms, made from a seed with numpy, for the perspective
camera (pinhole and thin lens with every bokeh shape and bias), the
architect, angular (circular, mirrored, max_angle), orthographic and
equirectangular cameras; the factory's fallback; and the lens pair the
engines draw (qmc dims 2-3).  The JAX functions run op by op.

Bounds: origins and directions rtol 1e-5, atol 1e-6 (sin / cos / atan2
differ from XLA's by an ulp); weights equal except lanes within 1e-6 of
the angular mask's edge (counted, at most a handful); the pixel cones
exactly equal; projections rtol 1e-5 with the valid flags equal away from
the frame's border.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu.cameras import base as rcam
from libyafaray_tpu.cameras.factory import camera_from_params as ref_factory
from libyafaray_tpu.core import qmc as rqmc
from libyafaray_tpu.scene.params import ParamMap as RefParamMap
from libyafaray_tpu_torch import convert
from libyafaray_tpu_torch.cameras import base as pcam
from libyafaray_tpu_torch.cameras.factory import camera_from_params
from libyafaray_tpu_torch.core import qmc
from libyafaray_tpu_torch.scene.params import ParamMap


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU path is many small tensor ops: one thread runs them
    fastest (and keeps parallel test workers off each other's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

N = 4096
RTOL, ATOL = 1e-5, 1e-6
RES = (96, 64)  # resx, resy: a non-square frame exercises the aspect

BASE = {"from": (1.2, -7.5, 1.6), "to": (0.0, 0.0, 0.6),
        "up": (1.2, -7.5, 2.6), "resx": RES[0], "resy": RES[1],
        "focal": 1.3}
CAMERAS = {
    "perspective": dict(type="perspective"),
    "architect": dict(type="architect", to=(0.3, 0.0, 2.5)),
    "angular": dict(type="angular", angle=150.0),
    "angular_mirrored": dict(type="angular", angle=120.0, mirrored=True),
    "angular_max_angle": dict(type="angular", angle=170.0, max_angle=70.0),
    "angular_full": dict(type="angular", angle=120.0, circular=False),
    "orthographic": dict(type="orthographic", scale=6.0),
    "equirectangular": dict(type="equirectangular"),
}
BOKEH = [(shape, bias) for shape in ("disk1", "disk2", "triangle", "square",
                                      "pentagon", "hexagon", "ring")
         for bias in ("uniform", "center", "edge")]


def _cams(params: dict):
    p = {**BASE, **params}
    return (ref_factory(RefParamMap(p)), camera_from_params(ParamMap(p)))


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(19)
    px = (rng.random(N) * RES[0]).astype(np.float32)
    py = (rng.random(N) * RES[1]).astype(np.float32)
    lu = rng.random(N).astype(np.float32)
    lv = rng.random(N).astype(np.float32)
    return px, py, lu, lv


def _shoot(cam_r, cam_p, lanes):
    px, py, lu, lv = lanes
    ref = rcam.shoot_rays(cam_r, *(jnp.asarray(a) for a in lanes))
    port = pcam.shoot_rays(cam_p, *(torch.from_numpy(a) for a in lanes))
    return [np.asarray(a) for a in ref], [a.numpy() for a in port]


def _check_rays(ref, port, edge=None):
    for name, r, p in zip(("org", "dir"), ref[:2], port[:2]):
        np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL, err_msg=name)
    differ = ref[2] != port[2]
    if edge is None:
        assert not differ.any()
    else:  # lanes whose angle sits on the mask's edge may round across it
        assert not (differ & ~edge).any()
        assert differ.sum() <= 4


@pytest.mark.parametrize("kind", sorted(CAMERAS))
def test_shoot_rays(kind, lanes):
    cam_r, cam_p = _cams(CAMERAS[kind])
    assert convert.camera_from_reference(cam_r) == cam_p
    ref, port = _shoot(cam_r, cam_p, lanes)
    edge = None
    if cam_r.cam_type == rcam.CAM_ANGULAR and cam_r.circular:
        # the lanes' angle theta against the mask's half-angle
        px, py, _, _ = (a.astype(np.float64) for a in lanes)
        u = px / cam_r.resx - 0.5
        v = (0.5 - py / cam_r.resy) * cam_r.resy / cam_r.resx
        half = 0.5 * cam_r.angle_deg * np.pi / 180.0
        theta = 2.0 * np.hypot(u, v) * half
        mx = (0.5 * cam_r.max_angle_deg * np.pi / 180.0
              if cam_r.max_angle_deg > 0 else half)
        edge = np.abs(theta - mx) < 1e-6
        assert (ref[2] == 0).any() and (ref[2] == 1).any()
    _check_rays(ref, port, edge)


@pytest.mark.parametrize("shape, bias", BOKEH)
def test_bokeh_warp(shape, bias, lanes):
    cam_r, cam_p = _cams(dict(type="perspective", aperture=0.2,
                              dof_distance=7.0, bokeh_type=shape,
                              bokeh_bias=bias, bokeh_rotation=15.0))
    _, _, lu, lv = lanes
    rx, ry = rcam._bokeh_warp(cam_r, jnp.asarray(lu), jnp.asarray(lv))
    qx, qy = pcam._bokeh_warp(cam_p, torch.from_numpy(lu),
                              torch.from_numpy(lv))
    np.testing.assert_allclose(qx.numpy(), np.asarray(rx), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(qy.numpy(), np.asarray(ry), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("kind", ["perspective", "architect"])
@pytest.mark.parametrize("shape, bias", [("disk1", "uniform"),
                                         ("hexagon", "uniform"),
                                         ("ring", "center"),
                                         ("triangle", "edge")])
def test_shoot_rays_depth_of_field(kind, shape, bias, lanes):
    """Thin lens: lens offset on the bokeh shape, focus plane at
    dof_distance along fwd."""
    cam_r, cam_p = _cams({**CAMERAS[kind], "aperture": 0.15,
                          "dof_distance": 6.5, "bokeh_type": shape,
                          "bokeh_bias": bias, "bokeh_rotation": 10.0})
    ref, port = _shoot(cam_r, cam_p, lanes)
    # the lens moves the origins off the pinhole
    assert np.abs(ref[0] - np.asarray(cam_r.origin, np.float32)).max() > 1e-3
    _check_rays(ref, port)


@pytest.mark.parametrize("kind", sorted(CAMERAS))
def test_pixel_cone_and_plane_area(kind):
    cam_r, cam_p = _cams(CAMERAS[kind])
    assert pcam.pixel_cone(cam_p) == rcam.pixel_cone(cam_r)
    assert pcam.pixel_plane_area(cam_p) == rcam.pixel_plane_area(cam_r)


@pytest.mark.parametrize("kind", ["perspective", "architect",
                                  "orthographic", "angular"])
def test_project_to_camera(kind):
    """Projection of world points (the ones shoot_rays reaches at a random
    depth, so most land in the frame): px, py, cos, dist and valid."""
    cam_r, cam_p = _cams(CAMERAS[kind])
    rng = np.random.default_rng(7)
    px = (rng.random(N) * RES[0]).astype(np.float32)
    py = (rng.random(N) * RES[1]).astype(np.float32)
    zero = np.zeros(N, np.float32)
    o, d, _ = rcam.shoot_rays(cam_r, jnp.asarray(px), jnp.asarray(py),
                              jnp.asarray(zero), jnp.asarray(zero))
    t = rng.uniform(0.5, 12.0, (N, 1)).astype(np.float32)
    p = (np.asarray(o) + t * np.asarray(d)).astype(np.float32)
    p[::7] += rng.normal(0, 8.0, p[::7].shape).astype(np.float32)
    ref = [np.asarray(a) for a in rcam.project_to_camera(cam_r,
                                                          jnp.asarray(p))]
    port = [a.numpy() for a in pcam.project_to_camera(cam_p,
                                                      torch.from_numpy(p))]
    inner = ((ref[0] > 1e-3) & (ref[0] < RES[0] - 1e-3) & (ref[1] > 1e-3)
             & (ref[1] < RES[1] - 1e-3))
    assert np.array_equal(ref[4] & inner, port[4] & inner)
    # (the angular camera projects as a perspective one, as in the
    # reference: its rays' points mostly fall outside that frame)
    assert ref[4].sum() > (N // 2 if kind != "angular" else 0)
    for name, r, q in zip(("px", "py", "cos", "dist"), ref[:4], port[:4]):
        ok = ref[4]
        np.testing.assert_allclose(q[ok], r[ok], rtol=RTOL, atol=1e-4,
                                   err_msg=name)


def test_factory_fallback(caplog):
    """An unknown camera type warns and renders with a perspective camera,
    as in the reference."""
    cam_r, cam_p = _cams(dict(type="fisheye_lens"))
    assert cam_p.cam_type == pcam.CAM_PERSPECTIVE == cam_r.cam_type
    assert cam_p == convert.camera_from_reference(cam_r)
    assert any("unknown camera type" in r.message for r in caplog.records)


def test_lens_pair_draws_agree():
    """The engines draw the lens pair with sample_dim_pair (path tracer,
    BDPT) or two sample_dim calls (photon mapping, SPPM): both give the
    reference's values."""
    rng = np.random.default_rng(3)
    s_idx = rng.integers(0, 1 << 20, N).astype(np.uint32)
    key = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    ru = np.asarray(rqmc.sample_dim(jnp.asarray(s_idx), rqmc.DIM_LENS_U,
                                    jnp.asarray(key)))
    rv = np.asarray(rqmc.sample_dim(jnp.asarray(s_idx), rqmc.DIM_LENS_V,
                                    jnp.asarray(key)))
    ts, tk = (torch.from_numpy(a.view(np.int32)) for a in (s_idx, key))
    pu, pv = qmc.sample_dim_pair(ts, qmc.DIM_LENS_U, tk)
    np.testing.assert_array_equal(pu.numpy(), ru)
    np.testing.assert_array_equal(pv.numpy(), rv)
    np.testing.assert_array_equal(
        qmc.sample_dim(ts, qmc.DIM_LENS_V, tk).numpy(), rv)
