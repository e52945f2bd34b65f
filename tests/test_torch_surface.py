"""The rest of the surface in the port against the JAX package on the CPU:
`<smooth>` (angle-thresholded per-corner normals), `<instance>` (a baked
copy of a mesh under a 4x4 transform, normals through the inverse
transpose, both flipped under a mirroring transform), an unknown instance
base (a warning), explicit per-vertex normals winning over `<smooth>`, the
orco of an instance (the base mesh's local space), the obj-index plane on
instanced triangles, and scenes/cornell_surfaces.xml end to end.

Compiled arrays are compared exactly, key by key, after the converter.
Renders: 16², 1 spp (the obj-index scene 8²), image RMSE <= 1e-4
(tests/test_torch_render.py's bound), rays equal.  The scene's glass prism makes the path tracer's ray
count depend on the rounding of single operations: the reference's
compiled step contracts multiply-adds in its reflect / refract / normalize
(XLA on the CPU; ROADMAP Queue 3), which moves about one lane's path in
4,000.  The pathtracing case therefore runs the reference op by op, as
tests/test_torch_lights.py runs its samplers; the directlighting case
runs it compiled.  The index planes are compared exactly."""
import logging
import os

import jax
import numpy as np
import pytest
import torch

from libyafaray_tpu.integrators.config import RenderConfig as RefConfig
from libyafaray_tpu.integrators.render import render as ref_render
from libyafaray_tpu.scene.session import build_config as ref_build
from libyafaray_tpu.scene.session import render_scene as ref_render_scene
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu.scene.xml_parser import parse_xml_string as ref_parse_str
from libyafaray_tpu_torch import convert
from libyafaray_tpu_torch.cli.yafaray_xml import main as cli_main
from libyafaray_tpu_torch.integrators.config import RenderConfig
from libyafaray_tpu_torch.integrators.render import render
from libyafaray_tpu_torch.io.exr import read_exr
from libyafaray_tpu_torch.scene.mesh import finalize_mesh
from libyafaray_tpu_torch.scene.scene import (ORCO_ARRAY_KEY,
                                              SLICE_ARRAY_KEYS,
                                              CompiledScene)
from libyafaray_tpu_torch.scene.session import build_config, render_scene
from libyafaray_tpu_torch.scene.xml_parser import (parse_xml_file,
                                                   parse_xml_string)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SURFACES = os.path.join(REPO, "scenes", "cornell_surfaces.xml")


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


def _flat(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _arrays_equal(ref_cs, port_cs) -> None:
    """Every array the port reads, exactly, after the converter."""
    want = dict(_flat(convert.arrays_from_reference(
        ref_cs.arrays, "cpu", n_stris_real=ref_cs.static.n_stris_real)))
    got = dict(_flat(convert.to_tensors(port_cs.arrays, "cpu")))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert port_cs.static.n_tris_real == ref_cs.static.n_tris_real
    assert port_cs.static.n_stris_real == ref_cs.static.n_stris_real


# a 6-sided prism with flat caps whose rim vertices the sides and caps
# share (so an angle of 60 degrees rounds the sides and keeps
# the rims sharp), a floor, and a point light
_MESH = """
  <mesh id="1" vertices="{nv}" faces="{nf}" has_uv="false" type="0">
{verts}
    <set_material sval="m"/>
{faces}
  </mesh>"""


def _prism_mesh(normals: bool = False) -> str:
    seg, r, h = 6, 0.5, 1.0
    verts, faces = [], []
    for z in (0.0, h):
        for k in range(seg):
            a = 2.0 * np.pi * k / seg
            verts.append((r * np.cos(a), r * np.sin(a), z))
    verts += [(0.0, 0.0, 0.0), (0.0, 0.0, h)]
    for k in range(seg):
        k1 = (k + 1) % seg
        faces += [(k, k1, seg + k1), (k, seg + k1, seg + k),
                  (2 * seg, k1, k), (2 * seg + 1, seg + k, seg + k1)]
    lines = [f'    <p x="{x:.6f}" y="{y:.6f}" z="{z:.6f}"/>'
             for x, y, z in verts]
    if normals:  # radial "explicit" normals, unlike any smoothing
        lines += [f'    <n x="{x:.6f}" y="{y:.6f}" z="0.3"/>'
                  for x, y, z in verts]
    return _MESH.format(nv=len(verts), nf=len(faces), verts="\n".join(lines),
                        faces="\n".join(f'    <f a="{a}" b="{b}" c="{c}"/>'
                                        for a, b, c in faces))


def _transform(m) -> str:
    return "<transform " + " ".join(
        f'm{i}{j}="{m[i][j]:.6f}"' for i in range(4) for j in range(4)) + "/>"


_ROT_SCALE = [[0.9, -0.6, 0.0, 2.0], [0.35, 0.45, 0.0, 0.5],
              [0.0, 0.0, 0.8, 0.0], [0.0, 0.0, 0.0, 1.0]]
_MIRROR = [[-1.0, 0.0, 0.0, -1.5], [0.0, 1.0, 0.0, 0.2],
           [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]]
_SCENE = """<scene type="triangle">
  <material name="m"><type sval="glossy"/><exponent fval="40.0"/>
    <color r="0.6" g="0.5" b="0.3"/></material>
  <material name="floor"><type sval="shinydiffusemat"/>
    <color r="0.7" g="0.7" b="0.7"/></material>
  <light name="p"><type sval="pointlight"/><from x="0.5" y="-1.5" z="3.0"/>
    <power fval="20.0"/><color r="1.0" g="1.0" b="1.0"/></light>
  <camera name="cam"><type sval="perspective"/>
    <from x="0.3" y="-5.0" z="2.5"/><to x="0.3" y="0.0" z="0.4"/>
    <up x="0.3" y="-5.0" z="3.5"/><resx ival="8"/><resy ival="8"/>
    <focal fval="0.8"/></camera>
  <background name="bg"><type sval="constant"/>
    <color r="0.05" g="0.05" b="0.08"/></background>
  <mesh id="0" vertices="4" faces="2" has_uv="false" type="0">
    <p x="-4" y="-4" z="0"/><p x="4" y="-4" z="0"/><p x="4" y="4" z="0"/>
    <p x="-4" y="4" z="0"/><set_material sval="floor"/>
    <f a="0" b="1" c="2"/><f a="0" b="2" c="3"/>
  </mesh>{body}
  <integrator name="default"><type sval="pathtracing"/>
    <bounces ival="2"/><raydepth ival="2"/></integrator>
  <render><camera_name sval="cam"/><integrator_name sval="default"/>
    <width ival="8"/><height ival="8"/><AA_minsamples ival="1"/>
    <filter_type sval="box"/></render>
</scene>"""

SURFACE_CASES = {
    "smooth": _prism_mesh() + '\n  <smooth ID="1" angle="60"/>',
    "smooth_default_angle": _prism_mesh() + '\n  <smooth ID="1"/>',
    # an unknown id falls back to the mesh being built: none, between
    # meshes, so nothing is smoothed
    "smooth_unknown_id": _prism_mesh() + '\n  <smooth ID="9" angle="60"/>',
    "normals_win_over_smooth": _prism_mesh(normals=True)
    + '\n  <smooth ID="1" angle="60"/>',
    "instance": _prism_mesh() + '\n  <smooth ID="1" angle="60"/>'
    + f'\n  <instance base_object_id="1">{_transform(_ROT_SCALE)}'
      "</instance>",
    "mirroring_instance": _prism_mesh()
    + f'\n  <instance base_object_id="1">{_transform(_MIRROR)}</instance>',
    "unknown_base": _prism_mesh()
    + f'\n  <instance base_object_id="7">{_transform(_MIRROR)}</instance>',
}


def _both(body: str):
    text = _SCENE.format(body=body)
    return ref_parse_str(text), parse_xml_string(text)


@pytest.mark.parametrize("case", sorted(SURFACE_CASES))
def test_surface_compile_equals_reference(case, caplog):
    """Parse and compile of each case: the arrays equal the reference's."""
    with caplog.at_level(logging.WARNING):
        rs, ps = _both(SURFACE_CASES[case])
    _arrays_equal(rs.compile(), ps.compile(device="cpu"))
    n_prism = 24
    want = {"instance": 2, "mirroring_instance": 2}.get(case, 1)
    assert ps.compile(device="cpu").static.n_tris_real == 2 + want * n_prism
    if case == "unknown_base":
        assert "unknown base mesh 7" in caplog.text


def test_smoothing_rounds_sides_and_keeps_rims():
    """angle 60 on the hexagonal prism: side corners take the smoothed
    normal (off their face normal), cap corners keep the face normal;
    explicit normals replace both."""
    _, ps = _both(SURFACE_CASES["smooth"])
    arr = finalize_mesh(ps.meshes[1])
    n, gn = arr["normal"], arr["geo_n"]
    dev = np.abs(np.einsum("tkc,tc->tk", n, gn) - 1.0) > 1e-6  # (T, 3)
    side = np.abs(gn[:, 2]) < 0.5
    assert dev[side].all() and not dev[~side].any()
    _, pe = _both(SURFACE_CASES["normals_win_over_smooth"])
    mesh = pe.meshes[1]
    vn = np.asarray(mesh.normals)
    vn /= np.linalg.norm(vn, axis=1, keepdims=True)
    faces = np.asarray([f[:3] for f in mesh.faces])
    assert np.allclose(finalize_mesh(mesh)["normal"], vn[faces], atol=1e-6)


def test_mirroring_instance_flips_both_normals():
    """Under det < 0 the baked normals are the base's mirrored and
    negated, so the geometric normal stays the one of the instance's own
    (mirrored, so reversed) winding."""
    _, ps = _both(SURFACE_CASES["mirroring_instance"])
    base = finalize_mesh(ps.meshes[1])
    inst = ps.extra_tri_blocks[0]
    mirror = np.diag([-1.0, 1.0, 1.0])
    assert np.allclose(inst["geo_n"], -(base["geo_n"] @ mirror.T), atol=1e-6)
    assert np.allclose(inst["normal"], -(base["normal"] @ mirror.T),
                       atol=1e-6)
    p = inst["pos"].astype(np.float64)
    wind = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    wind /= np.linalg.norm(wind, axis=1, keepdims=True)
    assert np.allclose(inst["geo_n"], wind, atol=1e-5)


def test_instance_orco_stays_in_base_space():
    """An orco-mapped texture: the orco pack equals the reference's, and
    an instance's orco and local corners are its base mesh's (reference
    tests/test_surface_derivs.py)."""
    tex = """
  <texture name="t"><type sval="clouds"/><size fval="0.5"/></texture>
  <material name="m"><type sval="shinydiffusemat"/>
    <diffuse_shader sval="map"/>
    <list_element><name sval="map"/><type sval="texture_mapper"/>
      <texture sval="t"/><texco sval="orco"/></list_element>
  </material>"""
    body = (_prism_mesh()
            + f'\n  <instance base_object_id="1">{_transform(_ROT_SCALE)}'
              "</instance>")
    text = _SCENE.format(body=body).replace(
        '<scene type="triangle">', '<scene type="triangle">' + tex, 1)
    text = text.replace(
        '<material name="m"><type sval="glossy"/><exponent fval="40.0"/>\n'
        '    <color r="0.6" g="0.5" b="0.3"/></material>', "", 1)
    rcs = ref_parse_str(text).compile()
    pcs = parse_xml_string(text).compile(device="cpu")
    assert pcs.static.need_orco
    _arrays_equal(rcs, pcs)
    orco = pcs.arrays[ORCO_ARRAY_KEY]
    n = 24
    assert np.array_equal(orco[2:2 + n], orco[2 + n:2 + 2 * n])
    assert not np.array_equal(pcs.arrays["tri_shade_pack"][2:2 + n, :9],
                              pcs.arrays["tri_shade_pack"][2 + n:, :9])


def test_obj_index_plane_on_instances():
    """The obj-index and normal planes of the instanced scene (path
    tracer, 8², 1 spp) equal the reference's: the index planes exactly,
    the normals within 1e-4; some pixel sees an instance triangle."""
    passes = ("obj-index-abs", "normal-smooth", "normal-geom")
    out = []
    for parse, build, cfg_cls, run in (
            (ref_parse_str, ref_build, RefConfig, ref_render),
            (parse_xml_string, build_config, RenderConfig, render)):
        s = parse(_SCENE.format(body=SURFACE_CASES["instance"]))
        cfg = cfg_cls(**{**build(s).__dict__, "passes": passes})
        cs = s.compile() if run is ref_render else s.compile(device="cpu")
        out.append(run(cs, cfg) if run is ref_render
                   else run(cs, cfg, device="cpu"))
    ref, port = out
    np.testing.assert_array_equal(port.passes["obj-index-abs"],
                                  ref.passes["obj-index-abs"])
    assert port.passes["obj-index-abs"].max() >= 2 + 24
    for name in passes[1:]:
        assert np.abs(port.passes[name] - ref.passes[name]).max() <= 1e-4
    assert _rmse(ref.image, port.image) <= 1e-4


# ---- scenes/cornell_surfaces.xml end to end -------------------------------


def _surfaces(parse, integrator, size=16, spp=2):
    s = parse(SURFACES)
    s.render_params.update(width=size, height=size, AA_minsamples=spp)
    s.integrator_params["default"]["type"] = integrator
    return s


def test_cornell_surfaces_compile_equals_reference():
    """162 mesh triangles (walls, the smoothed cylinder and its two
    instances, the prism) and the two lamps' 4: 2 clusters, the dense
    kernels."""
    rcs = ref_parse(SURFACES).compile()
    pcs = parse_xml_file(SURFACES).compile(device="cpu")
    _arrays_equal(rcs, pcs)
    assert pcs.static.n_tris_real == 166
    assert pcs.arrays["tri_cluster8"].shape[1] == 2
    assert pcs.static.dispersion and pcs.static.n_spheres == 1
    assert set(SLICE_ARRAY_KEYS) <= set(pcs.arrays)


def test_render_from_reference_compile_is_bit_equal():
    """The reference's compile of the scene carried across (its instance
    blocks, smoothed normals and, from its material table, the dispersion
    flag) renders the bits of the port's own compile (8², 1 spp)."""
    s = _surfaces(parse_xml_file, "pathtracing", size=8, spp=1)
    cfg = build_config(s)
    own = render(s.compile(device="cpu"), cfg, device="cpu")
    rcs = _surfaces(ref_parse, "pathtracing", size=8, spp=1).compile()
    static = convert.static_from_reference(rcs.static,
                                           rcs.arrays["materials"])
    assert static.dispersion
    assert not convert.static_from_reference(rcs.static).dispersion
    conv = CompiledScene(
        arrays=convert.arrays_from_reference(
            rcs.arrays, "cpu", n_stris_real=rcs.static.n_stris_real),
        static=static, camera=convert.camera_from_reference(rcs.camera),
        bound_min=tuple(rcs.bound_min), bound_max=tuple(rcs.bound_max))
    got = render(conv, cfg, device="cpu")
    assert np.array_equal(got.image, own.image)
    assert got.stats["rays"] == own.stats["rays"] > 0


@pytest.mark.parametrize("integrator", ["pathtracing", "directlighting"])
def test_cornell_surfaces_matches_reference(integrator):
    """16², 1 spp (the op-by-op reference's time is its dispatches, ~1
    minute a sample here)."""
    port = render_scene(_surfaces(parse_xml_file, integrator, spp=1),
                        device="cpu")
    if integrator == "pathtracing":
        with jax.disable_jit():
            ref = ref_render_scene(_surfaces(ref_parse, integrator, spp=1))
    else:
        ref = ref_render_scene(_surfaces(ref_parse, integrator, spp=1))
    img = port.image
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05
    assert _rmse(ref.image, img) <= 1e-4
    assert port.stats["rays"] == ref.stats["rays"] > 0


def test_cornell_surfaces_through_the_cli(tmp_path):
    """The port's CLI at 16² (--device cpu) writes the image render_scene
    gives, and its --json-stats rays are that render's."""
    out = str(tmp_path / "surfaces.exr")
    assert cli_main([SURFACES, out, "--width", "16", "--height", "16",
                     "--device", "cpu"]) == 0
    s = parse_xml_file(SURFACES)
    s.render_params.update(width=16, height=16)
    res = render_scene(s, device="cpu")
    assert np.array_equal(read_exr(out)[..., :3], res.image)
    assert res.image.mean() > 0.05
