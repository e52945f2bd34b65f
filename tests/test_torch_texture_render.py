"""Textures through the whole path engine, the port against the JAX
reference on the CPU: a scene that takes every texture wiring of the
engine at once (pathtracing, 16², 2 spp, bounces 3) — an EWA-mipmapped
checker with bump mapping on a uv floor (the ray-cone footprint, dPdU /
dPdV), a window-mapped texture (the raster projection), an orco /
sphere-mapped procedural with a colour ramp and a node layer over a
global / cube-mapped image on an analytic sphere (the sphere's lat-long
uv and derivatives, the orco pack), a blend material whose factor is a
texture, and a rotated, blurred textureback with its IBL light.  Image
RMSE <= 1e-4 and rays within 0.01% (tests/test_torch_render.py's
bounds), and the statics the shading reads equal after `convert`."""
import os

import numpy as np
import pytest
import torch

from libyafaray_tpu.scene.session import render_scene as ref_render_scene
from libyafaray_tpu.scene.xml_parser import parse_xml_string as ref_parse
from libyafaray_tpu_torch import convert
from libyafaray_tpu_torch.scene.session import render_scene
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_string

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = """<scene type="triangle">
  <texture name="env"><type sval="image"/>
    <filename sval="scenes/assets/env.hdr"/></texture>
  <texture name="checker"><type sval="image"/>
    <filename sval="scenes/assets/checker.png"/>
    <interpolate sval="mipmap_ewa"/></texture>
  <texture name="ck_win"><type sval="image"/>
    <filename sval="scenes/assets/checker.png"/>
    <xrepeat ival="3"/><yrepeat ival="2"/></texture>
  <texture name="clouds"><type sval="clouds"/><depth ival="2"/>
    <size fval="2.0"/><noise_type sval="newperlin"/>
    <use_color_ramp bval="true"/><ramp_num_items ival="2"/>
    <ramp_item_0_color r="0.9" g="0.2" b="0.1" a="1"/>
    <ramp_item_0_position fval="0.3"/>
    <ramp_item_1_color r="0.1" g="0.3" b="0.9" a="1"/>
    <ramp_item_1_position fval="0.7"/></texture>
  <material name="floor"><type sval="shinydiffusemat"/>
    <color r="0.7" g="0.7" b="0.7"/>
    <diffuse_shader sval="m_ck"/><bump_shader sval="m_ck"/>
    <list_element><name sval="m_ck"/><type sval="texture_mapper"/>
      <texture sval="checker"/><texco sval="uv"/>
      <bump_strength fval="2.0"/></list_element>
  </material>
  <material name="windowed"><type sval="shinydiffusemat"/>
    <diffuse_shader sval="m_win"/>
    <list_element><name sval="m_win"/><type sval="texture_mapper"/>
      <texture sval="ck_win"/><texco sval="window"/></list_element>
  </material>
  <material name="cloudy"><type sval="glossy"/>
    <color r="0.3" g="0.3" b="0.3"/><glossy_reflect fval="0.5"/>
    <exponent fval="40.0"/>
    <diffuse_shader sval="m_cl"/><glossy_shader sval="lay"/>
    <list_element><name sval="m_cl"/><type sval="texture_mapper"/>
      <texture sval="clouds"/><texco sval="orco"/><mapping sval="sphere"/>
      </list_element>
    <list_element><name sval="m_ck2"/><type sval="texture_mapper"/>
      <texture sval="ck_win"/><texco sval="global"/><mapping sval="cube"/>
      </list_element>
    <list_element><name sval="lay"/><type sval="layer"/>
      <input sval="m_ck2"/><upper_layer sval="m_cl"/>
      <blend_mode sval="overlay"/><colfac fval="0.7"/></list_element>
  </material>
  <material name="red"><type sval="shinydiffusemat"/>
    <color r="0.8" g="0.1" b="0.1"/></material>
  <material name="shiny"><type sval="glossy"/>
    <color r="0.1" g="0.1" b="0.1"/><glossy_color r="0.9" g="0.9" b="0.6"/>
    <exponent fval="80.0"/></material>
  <material name="blended"><type sval="blend_mat"/>
    <material1 sval="red"/><material2 sval="shiny"/>
    <blend_shader sval="clouds"/></material>
  <background name="bg"><type sval="textureback"/>
    <texture sval="env"/><ibl bval="true"/><ibl_samples ival="3"/>
    <ibl_blur fval="0.2"/><rotation fval="40.0"/><power fval="1.3"/>
  </background>
  <mesh id="1" vertices="4" faces="2" has_uv="true" has_orco="true" type="0">
    <p x="-6.0" y="-6.0" z="0.0"/><p x="6.0" y="-6.0" z="0.0"/>
    <p x="6.0" y="6.0" z="0.0"/><p x="-6.0" y="6.0" z="0.0"/>
    <uv u="0.0" v="0.0"/><uv u="4.0" v="0.0"/>
    <uv u="4.0" v="4.0"/><uv u="0.0" v="4.0"/>
    <set_material sval="floor"/>
    <f a="0" b="1" c="2" uv_a="0" uv_b="1" uv_c="2"/>
    <set_material sval="blended"/>
    <f a="0" b="2" c="3" uv_a="0" uv_b="2" uv_c="3"/>
  </mesh>
  <sphere name="s1"><center x="-1.2" y="0.3" z="1.0"/><radius fval="1.0"/>
    <material sval="cloudy"/></sphere>
  <sphere name="s2"><center x="1.4" y="-0.4" z="1.0"/><radius fval="1.0"/>
    <material sval="windowed"/></sphere>
  <camera name="cam"><type sval="perspective"/>
    <from x="0.2" y="-7.0" z="2.4"/><to x="0.0" y="0.0" z="0.9"/>
    <up x="0.2" y="-7.0" z="3.4"/><resx ival="16"/><resy ival="16"/>
    <focal fval="1.4"/></camera>
  <integrator name="default"><type sval="pathtracing"/>
    <raydepth ival="4"/><bounces ival="3"/>
    <russian_roulette_min_bounces ival="2"/></integrator>
  <render><camera_name sval="cam"/><integrator_name sval="default"/>
    <background_name sval="bg"/><width ival="16"/><height ival="16"/>
    <AA_passes ival="1"/><AA_minsamples ival="2"/>
    <AA_pixelwidth fval="1.5"/><filter_type sval="box"/></render>
</scene>
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def repo_cwd(monkeypatch):
    """The scene names its assets relative to the repository root."""
    monkeypatch.chdir(REPO)


def test_textured_scene_renders_as_reference():
    rs = ref_parse(SCENE)
    ps = parse_xml_string(SCENE)
    ref_static = convert.static_from_reference(rs.compile().static)
    port_static = ps.compile(device="cpu").static
    for f in ("textures", "texture_mappings", "node_programs", "has_blend",
              "blend_child_textured", "need_orco", "need_window", "bg",
              "lights"):
        assert getattr(port_static, f) == getattr(ref_static, f), f
    assert port_static.need_orco and port_static.need_window
    assert port_static.has_blend == 1 and port_static.bg.ibl_blur > 0
    ref = ref_render_scene(rs)
    port = render_scene(ps, device="cpu")
    img = port.image
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05
    rmse = float(np.sqrt(np.mean((img.astype(np.float64)
                                  - np.asarray(ref.image)) ** 2)))
    assert rmse <= 1e-4, rmse
    r_ref, r_port = ref.stats["rays"], port.stats["rays"]
    assert abs(r_port - r_ref) <= 1e-4 * r_ref, (r_ref, r_port)
