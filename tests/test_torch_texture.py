"""Textures in the port against the JAX reference on the CPU: the PNG reader
and `load_image`, the mip atlas, every image sampler, the texture mapper,
every procedural texture, node programs with every layer blend mode, and
`apply_textures` / `bump_normal` on compiled material rows
(tests/test_torch_blend.py renders blend and mask materials).  Inputs are
made from seeds with numpy; values agree within rtol 1e-5, atol 1e-6
(marble and wood: atol 1e-5, see test_procedural_texture), texel picks
and arrays built on the host exactly."""
import os
import struct
import types
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from libyafaray_tpu.io.image import load_image as ref_load_image
from libyafaray_tpu.scene.params import ParamMap as RefParamMap
from libyafaray_tpu.scene.xml_parser import parse_xml_string as ref_parse_str
from libyafaray_tpu.textures import eval as ref_eval
from libyafaray_tpu.textures import nodes as ref_nodes
from libyafaray_tpu.textures import procedural as ref_proc
from libyafaray_tpu.textures.factory import build_mip_atlas as ref_atlas
from libyafaray_tpu.textures.factory import mip_level_meta
from libyafaray_tpu_torch import convert
from libyafaray_tpu_torch.io.image import load_image, read_png
from libyafaray_tpu_torch.materials.base import gather_rows
from libyafaray_tpu_torch.scene.params import ParamMap
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_string
from libyafaray_tpu_torch.textures import eval as tex_eval
from libyafaray_tpu_torch.textures import nodes, procedural
from libyafaray_tpu_torch.textures.factory import build_mip_atlas

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKER = os.path.join(REPO, "scenes", "assets", "checker.png")
ENV = os.path.join(REPO, "scenes", "assets", "env.hdr")
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               **(tol or TOL))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---- PNG and load_image ----------------------------------------------------


_MODES = {0: "L", 2: "RGB", 4: "LA", 6: "RGBA"}


@pytest.mark.parametrize("ctype", sorted(_MODES))
def test_png_reader_equals_pillow(tmp_path, ctype):
    """A seeded image of each colour type, written by Pillow, decodes bit
    for bit as Pillow's convert("RGB" / "RGBA") decodes it."""
    rng = np.random.default_rng(ctype)
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    px = rng.integers(0, 256, (23, 37, ch), dtype=np.uint8)
    # smooth ramps too, so the encoder picks more than one row filter
    px[::2] = np.cumsum(px[::2], axis=1, dtype=np.uint8)
    path = str(tmp_path / f"t{ctype}.png")
    Image.fromarray(px[..., 0] if ch == 1 else px, _MODES[ctype]).save(path)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGBA" if "A" in im.getbands()
                                     else "RGB"))
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode_filtered(px: np.ndarray) -> bytes:
    """An RGB PNG whose row y uses filter type y % 5 (none, sub, up,
    average, paeth), encoded here byte by byte."""
    h, w, bpp = px.shape
    raw = px.reshape(h, w * bpp).astype(np.int64)
    out = bytearray()
    for y in range(h):
        f = y % 5
        out.append(f)
        for i in range(w * bpp):
            a = raw[y, i - bpp] if i >= bpp else 0
            b = raw[y - 1, i] if y else 0
            c = raw[y - 1, i - bpp] if y and i >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[f]
            out.append(int(raw[y, i] - pred) & 255)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


def test_png_reader_all_five_filters(tmp_path):
    """Every row filter, each on several rows, against Pillow and the
    pixels encoded."""
    px = np.random.default_rng(5).integers(0, 256, (15, 9, 3),
                                           dtype=np.uint8)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_encode_filtered(px))
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), px)
    np.testing.assert_array_equal(read_png(path), px)


@pytest.mark.parametrize("path, shape", [(CHECKER, (128, 128, 3)),
                                         (ENV, (64, 128, 3))])
def test_load_image_equals_reference(path, shape):
    """Both assets of ibl_spheres.xml load from their files as the
    reference loads them (sRGB -> linear for the 8-bit checker)."""
    got = load_image(path)
    want = np.asarray(ref_load_image(path))
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.max() > got.min()  # a real image, not a flat stand-in


def test_load_image_color_spaces(tmp_path):
    px = np.random.default_rng(7).integers(0, 256, (6, 5, 4), dtype=np.uint8)
    path = str(tmp_path / "a.png")
    Image.fromarray(px, "RGBA").save(path)
    for cs, g in (("sRGB", 1.0), ("raw_manual_gamma", 2.2), ("linear", 1.0)):
        np.testing.assert_array_equal(
            load_image(path, color_space=cs, gamma=g),
            np.asarray(ref_load_image(path, color_space=cs, gamma=g)))


# ---- mip atlas and samplers -------------------------------------------------


@pytest.mark.parametrize("shape", [(128, 128, 3), (37, 20, 3)])
def test_mip_atlas_bit_equal(shape):
    img = np.random.default_rng(11).random(shape, np.float32)
    np.testing.assert_array_equal(build_mip_atlas(img),
                                  np.asarray(ref_atlas(img)))


def _uv(n=4096, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2, 3, n).astype(np.float32),
            rng.uniform(-2, 3, n).astype(np.float32))


@pytest.mark.parametrize("name", ["nearest", "bilinear", "bicubic"])
def test_image_samplers(name):
    img = np.random.default_rng(1).random((21, 34, 3), np.float32)
    u, v = _uv()
    fn = f"sample_image_{name}"
    _close(getattr(tex_eval, fn)(_t(img), _t(u), _t(v)),
           getattr(ref_eval, fn)(jnp.asarray(img), jnp.asarray(u),
                                 jnp.asarray(v)))


def test_trilinear_sampler():
    img = np.random.default_rng(2).random((64, 48, 3), np.float32)
    atlas = build_mip_atlas(img)
    levels = mip_level_meta(64, 48)
    u, v = _uv()
    lod = np.random.default_rng(4).uniform(-1, len(levels) + 1,
                                           u.shape).astype(np.float32)
    _close(tex_eval.sample_image_trilinear(_t(atlas), levels, _t(u), _t(v),
                                           _t(lod)),
           ref_eval.sample_image_trilinear(jnp.asarray(atlas), levels,
                                           jnp.asarray(u), jnp.asarray(v),
                                           jnp.asarray(lod)))


def _surface(n=2048, seed=8):
    """Seeded surface points: p, n, ng, uv, orco, local, win, view, fp,
    dpdu, dpdv, uv_density."""
    rng = np.random.default_rng(seed)

    def unit(k):
        x = rng.normal(size=(n, k)).astype(np.float32)
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(
            np.float32)

    ng = unit(3)
    t = unit(3)
    dpdu = np.cross(ng, t).astype(np.float32) * rng.uniform(
        0.5, 3, (n, 1)).astype(np.float32)
    dpdv = np.cross(ng, dpdu).astype(np.float32) * rng.uniform(
        0.5, 2, (n, 1)).astype(np.float32)
    return dict(
        p=rng.uniform(-3, 3, (n, 3)).astype(np.float32), n=ng, ng=ng,
        uv=rng.uniform(-1, 2, (n, 2)).astype(np.float32),
        orco=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        local=rng.uniform(-2, 2, (n, 3)).astype(np.float32),
        win=rng.uniform(0, 1, (n, 2)).astype(np.float32),
        view=-unit(3), fp=rng.uniform(1e-4, 0.2, n).astype(np.float32),
        dpdu=dpdu, dpdv=dpdv,
        uv_density=rng.uniform(0.1, 2, n).astype(np.float32))


def _both(sp):
    return ({k: _t(v) for k, v in sp.items()},
            {k: jnp.asarray(v) for k, v in sp.items()})


def test_ewa_sampler():
    img = np.random.default_rng(9).random((32, 64, 3), np.float32)
    atlas = build_mip_atlas(img)
    levels = mip_level_meta(32, 64)
    sp_t, sp_j = _both(_surface())
    maj_t, min_t = tex_eval._ewa_uv_axes(sp_t)
    maj_j, min_j = ref_eval._ewa_uv_axes(sp_j)
    _close(maj_t, maj_j)
    _close(min_t, min_j)
    u, v = sp_t["uv"][:, 0], sp_t["uv"][:, 1]
    _close(tex_eval.sample_image_ewa(_t(atlas), levels, u, v, maj_t, min_t),
           ref_eval.sample_image_ewa(jnp.asarray(atlas), levels,
                                     sp_j["uv"][:, 0], sp_j["uv"][:, 1],
                                     maj_j, min_j))


_MAPPINGS = [(texco, mapping, (1.5, -0.75, 2.0), (0.25, 0.5, -0.125))
             for texco in ("uv", "window", "orco", "object", "global")
             for mapping in ("plain", "sphere", "tube", "cube")]


@pytest.mark.parametrize("mapping", _MAPPINGS,
                         ids=[f"{m[0]}-{m[1]}" for m in _MAPPINGS])
def test_mapped_coords(mapping):
    static = types.SimpleNamespace(texture_mappings=(mapping,))
    sp_t, sp_j = _both(_surface())
    for got, want in zip(tex_eval._mapped_coords(static, 0, sp_t),
                         ref_eval._mapped_coords(static, 0, sp_j)):
        _close(got, want)


# ---- procedural textures ----------------------------------------------------

_PROCEDURAL = [
    ("clouds", (("depth", 2), ("size", 1.5))),
    ("clouds", (("hard", True), ("noise_type", "newperlin"))),
    ("clouds", (("noise_type", "cellnoise"),)),
    ("marble", (("sharpness", 2.0), ("turbulence", 3.0))),
    ("wood", ()),
    ("wood", (("wood_type", "bands"), ("noise_type", "voronoi_f2"))),
    ("voronoi", (("distance_metric", "dist"),)),
    ("voronoi", (("distance_metric", "manhattan"), ("color_type", "col1"),
                 ("weight_2", 0.5))),
    ("voronoi", (("distance_metric", "chebychev"), ("weight_3", 0.3))),
    ("voronoi", (("distance_metric", "dist_squared"), ("weight_4", 0.2))),
    ("musgrave", (("musgrave_type", "fBm"),)),
    ("musgrave", (("musgrave_type", "ridged_multifractal"),
                  ("noise_type", "newperlin"))),
    ("musgrave", (("musgrave_type", "hybrid_multifractal"),
                  ("noise_type", "voronoi_crackle"))),
    ("distorted_noise", (("distort", 2.0), ("noise_type1", "voronoi_f3"),
                         ("noise_type2", "voronoi_f4"))),
    ("blend", (("stype", "lin"),)),
    ("blend", (("stype", "quad"),)),
    ("blend", (("stype", "ease"),)),
    ("blend", (("stype", "diag"),)),
    ("blend", (("stype", "sphere"),)),
    ("rgb_cube", ()),
    ("unknown_type", ()),
]


@pytest.mark.parametrize("spec", _PROCEDURAL,
                         ids=[f"{s[0]}{i}" for i, s in enumerate(_PROCEDURAL)])
def test_procedural_texture(spec):
    """rtol 1e-5, atol 1e-6; marble and wood take sin of arguments up to
    ~60 rad, where float32 sin implementations (XLA's, torch's) differ by
    an ulp of the argument, ~4e-6: atol 1e-5 there."""
    rng = np.random.default_rng(21)
    p = rng.uniform(-4, 4, (2048, 3)).astype(np.float32)
    uv = rng.uniform(-0.5, 1.5, (2048, 2)).astype(np.float32)
    atol = 1e-5 if spec[0] in ("marble", "wood") else 1e-6
    spec = spec + (None,)
    _close(procedural.eval_procedural(spec, _t(p), _t(uv)),
           ref_proc.eval_procedural(spec, jnp.asarray(p), jnp.asarray(uv)),
           rtol=1e-5, atol=atol)


# ---- node programs ----------------------------------------------------------


def _program(pmap_cls, mode: str):
    """A node graph: an image mapper and a clouds mapper (sphere-mapped,
    global) under a layer of `mode`, stacked on a stencil layer over a
    colour node, feeding the diffuse and glossy slots; a value node feeds
    the transparency slot."""
    nds = [
        dict(name="img", type="texture_mapper", texture="checker",
             texco="uv", scale=(2.0, 2.0, 1.0)),
        dict(name="cl", type="texture_mapper", texture="clouds",
             texco="global", mapping="sphere", offset=(0.1, 0.0, 0.0)),
        dict(name="base", type="color", color=(0.2, 0.5, 0.9, 1.0)),
        dict(name="l0", type="layer", input="cl", upper_layer="base",
             blend_mode="mix", stencil=True, colfac=0.8),
        dict(name="l1", type="layer", input="img", upper_layer="l0",
             blend_mode=mode, colfac=0.7, negative=(mode == "screen"),
             noRGB=(mode == "add")),
        dict(name="val", type="value", value=0.35),
    ]
    slots = dict(diffuse_shader="l1", glossy_shader="cl",
                 transparency_shader="val", mirror_color_shader="checker")
    return [pmap_cls(d) for d in nds], dict(checker=0, clouds=1), slots


@pytest.mark.parametrize("mode", sorted(set(nodes.BLEND_MODES)))
def test_node_program_blend_modes(mode):
    img = np.random.default_rng(31).random((16, 16, 3), np.float32)
    specs = (("image", None, None, "bilinear", None),
             ("clouds", (("depth", 1),), None))
    static = types.SimpleNamespace(textures=specs, texture_mappings=())
    got_p = nodes.parse_node_graph(*_program(ParamMap, mode))
    want_p = ref_nodes.parse_node_graph(*_program(RefParamMap, mode))
    assert tuple(got_p.nodes) == tuple(tuple(n) for n in want_p.nodes)
    assert got_p.slots == want_p.slots
    sp_t, sp_j = _both(_surface(1024))
    got = nodes.eval_node_program({"tex_0": _t(img)}, static, got_p, sp_t)
    want = ref_nodes.eval_node_program({"tex_0": jnp.asarray(img)}, static,
                                       want_p, sp_j)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])


# ---- apply_textures / bump_normal on compiled rows --------------------------

_TEXTURED = f"""<scene type="triangle">
  <texture name="checker"><type sval="image"/>
    <filename sval="{CHECKER}"/><interpolate sval="mipmap_trilinear"/>
  </texture>
  <texture name="env"><type sval="image"/><filename sval="{ENV}"/>
    <interpolate sval="mipmap_ewa"/><xrepeat ival="2"/>
    <clipping sval="checker"/><odd_tiles bval="true"/>
  </texture>
  <texture name="nearest"><type sval="image"/><filename sval="{CHECKER}"/>
    <interpolate sval="none"/><clipping sval="clip"/>
    <cropmax_x fval="0.5"/><rot90 bval="true"/>
  </texture>
  <texture name="cubic"><type sval="image"/><filename sval="{ENV}"/>
    <interpolate sval="bicubic"/><clipping sval="extend"/>
  </texture>
  <texture name="clouds"><type sval="clouds"/><depth ival="2"/>
    <use_color_ramp bval="true"/><ramp_num_items ival="3"/>
    <ramp_item_0_color r="1" g="0" b="0" a="1"/>
    <ramp_item_0_position fval="0.2"/>
    <ramp_item_1_color r="0" g="1" b="0" a="1"/>
    <ramp_item_1_position fval="0.5"/>
    <ramp_item_2_color r="0" g="0" b="1" a="1"/>
    <ramp_item_2_position fval="0.8"/>
  </texture>
  <texture name="wood"><type sval="wood"/>
    <use_color_ramp bval="true"/><ramp_num_items ival="2"/>
    <ramp_interpolation sval="constant"/>
    <ramp_item_0_color r="0.1" g="0.1" b="0.1" a="1"/>
    <ramp_item_1_color r="0.9" g="0.8" b="0.2" a="1"/>
  </texture>
  <material name="a"><type sval="shinydiffusemat"/>
    <diffuse_shader sval="m_ck"/><bump_shader sval="m_ck"/>
    <transparency_shader sval="m_wood"/>
    <list_element><name sval="m_ck"/><type sval="texture_mapper"/>
      <texture sval="checker"/><texco sval="uv"/>
      <bump_strength fval="3.0"/></list_element>
    <list_element><name sval="m_wood"/><type sval="texture_mapper"/>
      <texture sval="wood"/><texco sval="orco"/><mapping sval="tube"/>
    </list_element>
  </material>
  <material name="b"><type sval="glossy"/>
    <glossy_shader sval="lay"/><diffuse_shader sval="env"/>
    <list_element><name sval="m_env"/><type sval="texture_mapper"/>
      <texture sval="env"/><texco sval="uv"/></list_element>
    <list_element><name sval="lay"/><type sval="layer"/>
      <input sval="m_env"/><blend_mode sval="multiply"/>
      <colfac fval="0.6"/></list_element>
  </material>
  <material name="c"><type sval="shinydiffusemat"/>
    <mirror_color_shader sval="nearest"/><IOR_shader sval="cubic"/>
    <sigma_oren_shader sval="clouds"/><translucency_shader sval="m_cl"/>
    <list_element><name sval="m_cl"/><type sval="texture_mapper"/>
      <texture sval="clouds"/><texco sval="object"/><mapping sval="cube"/>
      </list_element>
  </material>
  <material name="d"><type sval="mask_mat"/><material1 sval="a"/>
    <material2 sval="b"/><mask_shader sval="clouds"/></material>
  <mesh id="1" vertices="4" faces="2" has_uv="true" has_orco="true"
        type="0">
    <p x="-1" y="-1" z="0"/><p x="2" y="-1" z="0.5"/>
    <p x="2" y="1.5" z="0"/><p x="-1" y="1" z="-0.25"/>
    <uv u="0" v="0"/><uv u="3" v="0"/><uv u="3" v="2"/><uv u="0" v="2"/>
    <set_material sval="a"/>
    <f a="0" b="1" c="2" uv_a="0" uv_b="1" uv_c="2"/>
    <set_material sval="d"/>
    <f a="0" b="2" c="3" uv_a="0" uv_b="2" uv_c="3"/>
  </mesh>
</scene>"""


@pytest.fixture(scope="module")
def textured():
    return (ref_parse_str(_TEXTURED).compile(),
            parse_xml_string(_TEXTURED).compile(device="cpu"))


def test_textured_scene_compiles_as_reference(textured):
    """The textures' arrays (images, atlases), the orco pack, the material
    table and the statics the shading reads, exactly."""
    ref, port = textured
    conv = convert.static_from_reference(ref.static)
    for f in ("textures", "texture_mappings", "node_programs", "has_blend",
              "blend_child_textured", "need_orco", "need_window",
              "mat_families"):
        assert getattr(port.static, f) == getattr(conv, f), f
    keys = [k for k in ref.arrays if k.startswith(("tex_", "mip_"))]
    assert sorted(keys) == sorted(k for k in port.arrays
                                  if k.startswith(("tex_", "mip_")))
    assert len(keys) == 6 and port.static.need_orco
    for k in keys + ["tri_orco_pack"]:
        np.testing.assert_array_equal(port.arrays[k],
                                      np.asarray(ref.arrays[k]), err_msg=k)
    np.testing.assert_array_equal(port.arrays["materials"]["__pack__"],
                                  np.asarray(ref.arrays["materials"]
                                             ["__pack__"]))


def test_apply_textures_and_bump(textured):
    """Seeded surface points on every material of the scene: each textured
    row entry and the bumped normal as the reference gives them."""
    ref, port = textured
    n = 2048
    rng = np.random.default_rng(41)
    mid = rng.integers(0, len(port.arrays["materials"]["mtype"]), n)
    sp = _surface(n, seed=42)
    arrays_t = convert.to_tensors(port.arrays, "cpu")
    arrays_j = {k: (jnp.asarray(v) if not isinstance(v, dict)
                    else {kk: jnp.asarray(vv) for kk, vv in v.items()})
                for k, v in ref.arrays.items()
                if k.startswith(("tex_", "mip_")) or k == "materials"}
    from libyafaray_tpu.materials.base import gather_rows as ref_gather

    row_t = gather_rows(arrays_t["materials"], _t(mid))
    row_j = ref_gather(arrays_j["materials"], jnp.asarray(mid, jnp.int32))
    sp_t, sp_j = _both(sp)
    got = tex_eval.apply_textures(arrays_t, port.static, row_t, sp_t)
    want = ref_eval.apply_textures(arrays_j, ref.static, row_j, sp_j)
    for k in want:
        _close(got[k], want[k])
    _close(tex_eval.bump_normal(arrays_t, port.static, got, sp_t),
           ref_eval.bump_normal(arrays_j, ref.static, want, sp_j))
