"""The gradient, sunsky and darksky backgrounds against the JAX package's:
the gradient's eval on directions made from a seed with numpy (rtol 1e-5,
atol 1e-6); the host bakes (the gradient's IBL grid, the Preetham sunsky
grid, darksky's Preetham stand-in with its exposure / bright / night
controls, and the Hosek-Wilkie grid on a synthetic coefficient dataset
written to tmp_path, as tests/test_hosek.py writes one) exactly equal;
the Hosek-Wilkie pieces (_bezier5, _interp_tables, hw_radiance,
find_dataset) exactly equal; the factory's specs equal and its fallback
for an unknown type (a warning, black); and the scene compile's IBL
arrays of a gradient background equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu.backgrounds import base as rbase
from libyafaray_tpu.backgrounds import hosek as rhosek
from libyafaray_tpu.backgrounds.factory import \
    background_from_params as ref_factory
from libyafaray_tpu.backgrounds.host import bake_background_np as ref_bake
from libyafaray_tpu.scene.params import ParamMap as RefParamMap
from libyafaray_tpu.scene.scene import Scene as RefScene
from libyafaray_tpu_torch.backgrounds import base, hosek
from libyafaray_tpu_torch.backgrounds.factory import background_from_params
from libyafaray_tpu_torch.backgrounds.host import bake_background_np
from libyafaray_tpu_torch.scene.params import ParamMap
from libyafaray_tpu_torch.scene.scene import Scene

GRADIENT = dict(type="gradient", horizon_color=(0.9, 0.8, 0.7),
                zenith_color=(0.2, 0.4, 0.9),
                horizon_ground_color=(0.5, 0.45, 0.4),
                zenith_ground_color=(0.2, 0.18, 0.15), power=1.7)
SKIES = {
    "sunsky": dict(type="sunsky", turbidity=3.0,
                   **{"from": (-0.45, 0.55, 0.7)}),
    "sunsky_low_sun": dict(type="sunsky", turbidity=7.5,
                           **{"from": (0.8, 0.2, 0.05)}),
    "darksky": dict(type="darksky", turbidity=2.2, exposure=1.5, bright=1.2,
                    **{"from": (0.3, -0.6, 0.5)}),
    "darksky_night": dict(type="darksky", turbidity=4.0, night=True,
                          **{"from": (0.3, -0.6, 0.5)}),
}


def _both(params: dict):
    return (ref_factory(RefParamMap(params)),
            background_from_params(ParamMap(params)))


def _synth_dataset(path):
    """A dataset with every coefficient in play (seeded), in the .npz
    layout load_hw_dataset checks."""
    rng = np.random.default_rng(11)
    config = rng.uniform(-0.5, 0.5, (3, 10, 2, 6, 9))
    config[..., 2] += 1.0  # C
    config[..., 4] = -np.abs(config[..., 4])  # E < 0: the glow decays
    config[..., 7] = rng.uniform(0.1, 0.9, (3, 10, 2, 6))  # H in (0, 1)
    radiance = rng.uniform(0.5, 3.0, (3, 10, 2, 6))
    np.savez(path, config=config, radiance=radiance)
    return str(path)


def test_gradient_eval():
    (spec_r, img_r), (spec_p, img_p) = _both(GRADIENT)
    assert img_r is None and img_p is None
    assert spec_p == base.BackgroundSpec(**spec_r.__dict__)
    rng = np.random.default_rng(5)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:64, 2] = 0.0  # on the horizon: the sky side
    ref = np.asarray(rbase.eval_background(spec_r, None, jnp.asarray(d)))
    port = base.eval_background(spec_p, None, torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("params", [GRADIENT, dict(type="constant",
                                                    color=(0.3, 0.2, 0.1))])
def test_ibl_bake(params):
    (spec_r, _), (spec_p, _) = _both(params)
    np.testing.assert_array_equal(bake_background_np(spec_p, 32, 64),
                                  ref_bake(spec_r, 32, 64))


@pytest.mark.parametrize("kind", sorted(SKIES))
def test_sky_bake(kind):
    """The sky grids are host numpy in both packages: equal bit for bit,
    and both become texture backgrounds with the same spec."""
    (spec_r, grid_r), (spec_p, grid_p) = _both(SKIES[kind])
    assert grid_p.shape == (128, 256, 3) and grid_p.dtype == np.float32
    np.testing.assert_array_equal(grid_p, grid_r)
    assert spec_p == base.BackgroundSpec(**spec_r.__dict__)
    assert spec_p.bg_type == base.BG_TEXTURE
    assert np.isfinite(grid_p).all() and grid_p.max() > 0


def test_hosek_pieces_and_darksky(tmp_path, monkeypatch):
    path = _synth_dataset(tmp_path / "hw.npz")
    ds_r, ds_p = rhosek.load_hw_dataset(path), hosek.load_hw_dataset(path)
    for k in ("config", "radiance"):
        np.testing.assert_array_equal(ds_p[k], ds_r[k])
    for x in (0.0, 0.37, 1.0):
        np.testing.assert_array_equal(hosek._bezier5(ds_p["config"][0, 3],
                                                     x),
                                      rhosek._bezier5(ds_r["config"][0, 3],
                                                      x))
    for t, a, e in ((1.0, 0.0, 0.0), (4.3, 0.5, 0.7), (10.0, 1.0, 1.5)):
        cp, rp = hosek._interp_tables(ds_p, t, a, e)
        cr, rr = rhosek._interp_tables(ds_r, t, a, e)
        np.testing.assert_array_equal(cp, cr)
        np.testing.assert_array_equal(rp, rr)
        rng = np.random.default_rng(2)
        ct, cg = rng.uniform(-1, 1, 500), rng.uniform(-1, 1, 500)
        np.testing.assert_array_equal(hosek.hw_radiance(cp, rp, ct, cg),
                                      rhosek.hw_radiance(cr, rr, ct, cg))
    np.testing.assert_array_equal(
        hosek.hw_grid(ds_p, (0.3, -0.6, 0.5), 3.0, 0.3),
        rhosek.hw_grid(ds_r, (0.3, -0.6, 0.5), 3.0, 0.3))
    # the scene parameter, then the environment, name the dataset
    params = dict(SKIES["darksky"], hw_dataset=path, albedo=0.3)
    assert hosek.find_dataset(ParamMap(params)) == path
    monkeypatch.setenv("LIBYAF_HW_DATA", path)
    assert hosek.find_dataset(ParamMap(SKIES["darksky"])) == path
    assert rhosek.find_dataset(RefParamMap(SKIES["darksky"])) == path
    (spec_r, grid_r), (spec_p, grid_p) = _both(params)
    np.testing.assert_array_equal(grid_p, grid_r)
    # the Hosek-Wilkie grid, not the Preetham stand-in
    monkeypatch.delenv("LIBYAF_HW_DATA")
    _, stand_in = background_from_params(ParamMap(SKIES["darksky"]))
    assert np.abs(grid_p - stand_in).max() > 1e-3


def test_factory_fallback(caplog):
    """An unknown background type warns and renders black, as in the
    reference."""
    (spec_r, img_r), (spec_p, img_p) = _both(dict(type="aurora"))
    assert img_r is None and img_p is None
    assert spec_p == base.BackgroundSpec() and spec_p.bg_type == base.BG_NONE
    assert spec_r.bg_type == rbase.BG_NONE
    assert any("unknown background type" in r.message
               for r in caplog.records)


def test_gradient_ibl_compile():
    """A gradient background with `ibl`: the baked 32 x 64 map and the IBL
    light's alias tables of the scene compile equal the reference's."""
    scenes = []
    for cls, pm in ((RefScene, RefParamMap), (Scene, ParamMap)):
        s = cls()
        s.create_material("m", pm({"type": "shinydiffusemat"}))
        s.create_background("bg", pm(dict(GRADIENT, ibl=True,
                                          ibl_samples=4)))
        s.start_tri_mesh(1, has_uv=False, visibility="normal")
        for v in ((0, 0, 0), (1, 0, 0), (0, 1, 0)):
            s.add_vertex(*v)
        s.add_triangle(0, 1, 2, 1)
        s.end_tri_mesh()
        scenes.append(s.compile(device="cpu") if cls is Scene
                      else s.compile())
    ref, port = scenes
    for k in ("bg_image", "bg_alias_prob", "bg_alias", "bg_pdf_grid"):
        np.testing.assert_array_equal(port.arrays[k], ref.arrays[k],
                                      err_msg=k)
    assert port.static.lights[-1].samples == 4


_EMISSION_XML = """<scene type="triangle">
  <material name="m"><type sval="shinydiffusemat"/>
    <color r="0.7" g="0.6" b="0.5"/></material>
  <light name="p"><type sval="pointlight"/>
    <from x="1.0" y="-1.0" z="3.0"/><power fval="6.0"/>
    <color r="1.0" g="1.0" b="1.0"/></light>
  <background name="bg"><type sval="gradient"/>
    <horizon_color r="0.9" g="0.8" b="0.7"/>
    <zenith_color r="0.2" g="0.4" b="0.9"/>
    <horizon_ground_color r="0.5" g="0.45" b="0.4"/>
    <zenith_ground_color r="0.2" g="0.18" b="0.15"/>
    <power fval="1.5"/><ibl bval="true"/><ibl_samples ival="4"/>
  </background>
  <camera name="cam"><type sval="perspective"/>
    <from x="0.5" y="-6.0" z="2.0"/><to x="0.0" y="0.0" z="0.5"/>
    <up x="0.5" y="-6.0" z="3.0"/><resx ival="16"/><resy ival="16"/>
    <focal fval="0.9"/></camera>
  <volumeregion name="v"><type sval="UniformVolume"/>
    <sigma_a fval="0.05"/><sigma_s fval="0.1"/><l_e fval="0.4"/>
    <minX fval="-3.0"/><minY fval="-3.0"/><minZ fval="0.0"/>
    <maxX fval="3.0"/><maxY fval="3.0"/><maxZ fval="2.5"/></volumeregion>
  <mesh id="1" vertices="4" faces="2" has_uv="false" type="0">
    <p x="-3" y="-3" z="0"/><p x="3" y="-3" z="0"/><p x="3" y="3" z="0"/>
    <p x="-3" y="3" z="0"/><set_material sval="m"/>
    <f a="0" b="1" c="2"/><f a="0" b="2" c="3"/>
  </mesh>
  <integrator name="default"><type sval="directlighting"/>
    <raydepth ival="2"/></integrator>
  <integrator name="volintegr"><type sval="EmissionIntegrator"/></integrator>
  <render><camera_name sval="cam"/><integrator_name sval="default"/>
    <volintegrator_name sval="volintegr"/>
    <width ival="16"/><height ival="16"/><AA_minsamples ival="2"/>
    <filter_type sval="box"/></render>
</scene>"""


def test_gradient_ibl_emission_render():
    """Directlighting with the IBL light of a gradient background and an
    EmissionIntegrator fog, both packages' render_scene at 16², 2 spp:
    image RMSE <= 1e-4, rays equal.  (A uniform fog: its closed-form
    transmittance keeps the reference's compile short; the marched
    densities are held function by function in test_torch_volumes.py and
    end to end in test_torch_sky_fog.py.)"""
    from libyafaray_tpu.scene.session import render_scene as ref_render
    from libyafaray_tpu.scene.xml_parser import parse_xml_string as ref_xml
    from libyafaray_tpu_torch.scene.session import render_scene
    from libyafaray_tpu_torch.scene.xml_parser import parse_xml_string

    ref = ref_render(ref_xml(_EMISSION_XML))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    port = render_scene(parse_xml_string(_EMISSION_XML), device="cpu")
    torch.set_num_threads(n)
    img = port.image
    assert img.shape == (16, 16, 3) and img.mean() > 0.05
    rmse = float(np.sqrt(np.mean((img - np.asarray(ref.image)) ** 2)))
    assert rmse <= 1e-4, rmse
    assert port.stats["rays"] == float(ref.stats["rays"])
