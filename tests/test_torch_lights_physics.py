"""The reference's light physics, held on the port (CPU, plain versions of
its kernels) at the reference tests' own sizes and bounds
(tests/test_integrators.py, tests/test_veach.py):
- a meshlight quad and an arealight of the same flux light a floor alike:
  mean abs difference < 0.15 × the mean;
- a sphere light under pathtracing (NEE + cone-pdf MIS at BSDF hits) and
  directlighting (NEE only): means within 10%, and the sphere is seen;
- BDPT against the path tracer with a point light: means within 6%;
- sun and directional lights under BDPT (the weight-1 eye-side NEE): not
  black, within 8% of the path tracer;
- a spot's soft_shadows (shadowFuzzyness) widen its shadow's penumbra.
Scenes are built through the port's flat API.
"""
import numpy as np
import pytest
import torch

from libyafaray_tpu_torch.scene.params import ParamMap
from libyafaray_tpu_torch.scene.scene import Scene
from libyafaray_tpu_torch.scene.session import render_scene


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quad_mesh(s, mesh_id, corners, mat, tris=((0, 1, 2), (0, 2, 3))):
    s.start_tri_mesh(mesh_id, has_uv=False, visibility="normal")
    for p in corners:
        s.add_vertex(*(float(x) for x in p))
    for a, b, c in tris:
        s.add_triangle(a, b, c, mat)
    s.end_tri_mesh()


def _camera_and_render(s, integrator, res, spp, cam, **integ):
    s.create_camera("cam", ParamMap(dict(type="perspective", resx=res,
                                         resy=res, **cam)))
    s.create_integrator("default", ParamMap(dict(type=integrator, **integ)))
    s.render_params = ParamMap({"width": res, "height": res,
                                "AA_minsamples": spp,
                                "integrator_name": "default",
                                "camera_name": "cam"})
    return render_scene(s, device="cpu").image


def _box_light(kind: str, res=32):
    """A floor under an arealight or an equal meshlight quad (double-
    sided), directlighting raydepth 2, 16 spp."""
    s = Scene()
    white = s.create_material("white", ParamMap(
        type="shinydiffusemat", color=(0.7, 0.7, 0.7)))
    s.create_background("bg", ParamMap(type="constant", color=(0, 0, 0)))
    _quad_mesh(s, 1, ((-2, -2, 0), (2, -2, 0), (2, 2, 0), (-2, 2, 0)),
               white)
    corner = np.array([-0.5, -0.5, 2.0])
    e1, e2 = np.array([1.0, 0.0, 0.0]), np.array([0.0, 1.0, 0.0])
    if kind == "area":
        s.create_light("L", ParamMap(
            type="arealight", corner=tuple(corner),
            point1=tuple(corner + e2), point2=tuple(corner + e1),
            color=(1.0, 1.0, 1.0), power=10.0, samples=8))
    else:
        _quad_mesh(s, 2, (corner, corner + e2, corner + e1 + e2,
                          corner + e1), white)
        s.create_light("L", ParamMap(
            type="meshlight", object_name="2", color=(1.0, 1.0, 1.0),
            power=10.0, samples=8, double_sided=True))
    return _camera_and_render(
        s, "directlighting", res, 16,
        {"from": (0.0, -5.0, 1.0), "to": (0.0, 0.0, 0.5),
         "up": (0.0, -5.0, 2.0), "focal": 1.2}, raydepth=2)


def test_meshlight_matches_arealight():
    fa = _box_light("area")[20:]
    fm = _box_light("mesh")[20:]
    assert fa.mean() > 0.01
    assert np.abs(fa - fm).mean() < 0.15 * fa.mean(), (fa.mean(), fm.mean())


def _sphere_light(integrator):
    s = Scene()
    floor = s.create_material("floor", ParamMap(
        type="shinydiffusemat", color=(0.8, 0.8, 0.8), diffuse_reflect=0.9))
    s.create_light("L", ParamMap(type="spherelight", radius=0.7, power=30.0,
                                 color=(1.0, 1.0, 1.0), samples=8,
                                 **{"from": (0.0, 0.0, 2.0)}))
    _quad_mesh(s, 1, ((-4, -4, 0), (4, -4, 0), (4, 4, 0), (-4, 4, 0)),
               floor)
    return _camera_and_render(
        s, integrator, 32, 24,
        {"from": (0.0, -6.0, 3.0), "to": (0.0, 0.0, 0.5),
         "up": (0.0, -6.0, 4.0), "focal": 1.2}, raydepth=2, bounces=2)


def test_spherelight_two_strategy_mis():
    img_path = _sphere_light("pathtracing")
    img_direct = _sphere_light("directlighting")
    mp, md = float(img_path.mean()), float(img_direct.mean())
    assert np.isfinite(img_path).all() and np.isfinite(img_direct).all()
    assert abs(mp - md) / max(md, 1e-6) < 0.1, (mp, md)
    assert img_path[2:12, 10:22].max() > img_path[20:, :].max()


def _veach_scene(integrator, lights, res, spp):
    """tests/test_veach.py's box: a floor and a back wall, bounces 3,
    raydepth 4."""
    s = Scene()
    white = s.create_material("white", ParamMap(
        type="shinydiffusemat", color=(0.7, 0.7, 0.7)))
    for name, params in lights:
        s.create_light(name, ParamMap(params))
    _quad_mesh(s, 1, ((-2, -2, 0), (2, -2, 0), (2, 2, 0), (-2, 2, 0),
                      (-2, 2, 0), (2, 2, 0), (2, 2, 3), (-2, 2, 3)),
               white, tris=((0, 1, 2), (0, 2, 3), (4, 5, 6), (4, 6, 7)))
    return _camera_and_render(
        s, integrator, res, spp,
        {"from": (0.0, -5.0, 1.2), "to": (0.0, 0.0, 0.9),
         "up": (0.0, -5.0, 2.2), "focal": 1.4},
        bounces=3, raydepth=4, photons=8192, photon_bounces=4)


def test_bdpt_point_light_matches_path_tracer():
    light = [("P", {"type": "pointlight", "from": (0.0, 0.0, 1.9),
                    "power": 6.0, "color": (1.0, 1.0, 1.0)})]
    img_bd = _veach_scene("bidirectional", light, 32, 16)
    img_pt = _veach_scene("pathtracing", light, 32, 16)
    assert np.isfinite(img_bd).all()
    m_bd, m_pt = float(img_bd.mean()), float(img_pt.mean())
    assert abs(m_bd - m_pt) / max(m_pt, 1e-6) < 0.06, (m_bd, m_pt)


def test_bdpt_sun_and_directional_lights():
    lights = [("S", {"type": "sunlight", "direction": (0.3, 0.3, 1.0),
                     "power": 2.0, "color": (1.0, 1.0, 1.0), "angle": 0.5}),
              ("D", {"type": "directional", "direction": (-0.2, 0.1, 1.0),
                     "power": 1.0, "color": (1.0, 0.9, 0.8)})]
    img_bd = _veach_scene("bidirectional", lights, 16, 4)
    img_pt = _veach_scene("pathtracing", lights, 16, 4)
    m_bd, m_pt = float(img_bd.mean()), float(img_pt.mean())
    assert m_bd > 1e-3, "sun/directional render black under BDPT"
    assert abs(m_bd - m_pt) / max(m_pt, 1e-6) < 0.08, (m_bd, m_pt)


def _spot(soft: bool):
    s = Scene()
    floor = s.create_material("floor", ParamMap(
        type="shinydiffusemat", color=(1.0, 1.0, 1.0)))
    blk = s.create_material("blk", ParamMap(
        type="shinydiffusemat", color=(0.0, 0.0, 0.0)))
    p = {"type": "spotlight", "from": (0.0, 0.0, 4.0), "to": (0.0, 0.0, 0.0),
         "cone_angle": 60.0, "power": 40.0, "color": (1.0, 1.0, 1.0)}
    if soft:
        p.update(soft_shadows=True, shadowFuzzyness=0.4, samples=16)
    s.create_light("L", ParamMap(p))
    s.start_tri_mesh(1, has_uv=False, visibility="normal")
    for v in ((-3, -3, 0), (3, -3, 0), (3, 3, 0), (-3, 3, 0), (0, -3, 2.0),
              (0, 3, 2.0), (1.5, -3, 2.0), (1.5, 3, 2.0)):
        s.add_vertex(*(float(x) for x in v))
    s.add_triangle(0, 1, 2, floor)
    s.add_triangle(0, 2, 3, floor)
    s.add_triangle(4, 6, 7, blk)
    s.add_triangle(4, 7, 5, blk)
    s.end_tri_mesh()
    return _camera_and_render(
        s, "directlighting", 48, 4,
        {"from": (0.0, 0.0, 6.0), "to": (0.0, 0.001, 0.0),
         "up": (0.0, 1.0, 6.0), "focal": 1.0}, raydepth=1)


def test_spotlight_soft_shadows_penumbra():
    hard, soft = _spot(False), _spot(True)
    assert np.isfinite(soft).all()

    def edge_frac(img):
        # the share of floor pixels strictly between lit and shadowed
        v = img[..., 0]
        lit = np.percentile(v[v > 1e-4], 90)
        return ((v > 0.15 * lit) & (v < 0.7 * lit)).mean()

    assert edge_frac(soft) > edge_frac(hard) + 0.01, (edge_frac(hard),
                                                      edge_frac(soft))
