"""The IBL slice in the port against the JAX reference on the CPU: the alias
table, the environment's sampling table and blur, the alias draw, the
background light's samples and pdf, the texture background, and
scenes/ibl_spheres.xml (BASELINE config 5: a textureback env.hdr with
ibl, a mipmapped checker.png floor, glass and glossy spheres) end to end:
at 16², 2 spp against the reference's render (image RMSE <= 1e-4, rays
within 0.01%, the bounds of tests/test_torch_render.py), from the
reference's compile through `convert`, and at its own 64 spp through
`render_scene` and the port's CLI.  Host-built tables are bit-equal; a
draw's cells are equal and its values within rtol 1e-5."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu.backgrounds import base as ref_bg
from libyafaray_tpu.backgrounds.factory import blur_env_map as ref_blur
from libyafaray_tpu.integrators.config import RenderConfig as RefConfig
from libyafaray_tpu.integrators.render import render as ref_render
from libyafaray_tpu.lights import alias as ref_alias
from libyafaray_tpu.lights import bglight as ref_bgl
from libyafaray_tpu.scene.session import build_config as ref_build
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch import convert
from libyafaray_tpu_torch.backgrounds import base as bg
from libyafaray_tpu_torch.backgrounds.factory import blur_env_map
from libyafaray_tpu_torch.cli.yafaray_xml import main as cli_main
from libyafaray_tpu_torch.integrators.config import RenderConfig
from libyafaray_tpu_torch.integrators.render import render
from libyafaray_tpu_torch.io.exr import read_exr
from libyafaray_tpu_torch.io.rgbe import read_hdr
from libyafaray_tpu_torch.lights import alias, bglight
from libyafaray_tpu_torch.scene.scene import CompiledScene
from libyafaray_tpu_torch.scene.session import build_config, render_scene
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IBL = os.path.join(REPO, "scenes", "ibl_spheres.xml")
ENV = os.path.join(REPO, "scenes", "assets", "env.hdr")
TOL = dict(rtol=1e-5, atol=1e-6)


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


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               **(tol or TOL))


def _env():
    return read_hdr(ENV)


# ---- host tables ------------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "sparse", "zero"])
def test_alias_table_bit_equal(case):
    rng = np.random.default_rng(3)
    w = rng.random(1000)
    if case == "sparse":
        w[rng.random(1000) < 0.7] = 0.0
    elif case == "zero":
        w[:] = 0.0
    got, want = alias.build_alias_table(w), ref_alias.build_alias_table(w)
    for g, r in zip(got, want):
        assert g.dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(g, np.asarray(r))


@pytest.mark.parametrize("image", ["env", "random"])
def test_bg_cdf_bit_equal(image):
    img = (_env() if image == "env"
           else np.random.default_rng(5).random((16, 32, 3), np.float32))
    got, want = bglight.build_bg_cdf(img), ref_bgl.build_bg_cdf(img)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("blur", [0.05, 0.3])
def test_blur_env_map_bit_equal(blur):
    img = _env()
    np.testing.assert_array_equal(blur_env_map(img, blur),
                                  ref_blur(img, blur))


# ---- draws, pdfs and the texture background ---------------------------------


def _tables():
    tab = bglight.build_bg_cdf(_env())
    arrays = dict(tab, bg_image=_env())
    return ({k: torch.from_numpy(v) for k, v in arrays.items()},
            {k: jnp.asarray(v) for k, v in arrays.items()})


def test_sample_alias():
    tab = bglight.build_bg_cdf(_env())
    u = np.random.default_rng(9).random(65536).astype(np.float32)
    cell, rest = alias.sample_alias(torch.from_numpy(tab["bg_alias_prob"]),
                                    torch.from_numpy(tab["bg_alias"]),
                                    torch.from_numpy(u))
    rcell, rrest = ref_alias.sample_alias(jnp.asarray(tab["bg_alias_prob"]),
                                          jnp.asarray(tab["bg_alias"]),
                                          jnp.asarray(u))
    np.testing.assert_array_equal(cell.numpy(), np.asarray(rcell))
    _close(rest, rrest)


_SPECS = [dict(mapping="sphere", rotation=0.0, power=1.0),
          dict(mapping="sphere", rotation=37.0, power=2.5),
          dict(mapping="probe", rotation=0.0, power=0.5)]


@pytest.mark.parametrize("spec", _SPECS, ids=["sphere", "rotated", "probe"])
def test_background_light_and_texture_background(spec):
    """sample_bg_light (texels equal, direction / radiance / pdf within
    rtol 1e-5), pdf_bg_dir and the texture branch of eval_background on
    seeded directions."""
    a_t, a_j = _tables()
    s_t = bg.BackgroundSpec(bg_type=bg.BG_TEXTURE, ibl=True, **spec)
    s_j = ref_bg.BackgroundSpec(bg_type=ref_bg.BG_TEXTURE, ibl=True, **spec)
    rng = np.random.default_rng(13)
    n = 32768
    u1, u2 = (rng.random(n).astype(np.float32) for _ in range(2))
    p = rng.normal(size=(n, 3)).astype(np.float32)
    if spec["mapping"] == "sphere":
        got = bglight.sample_bg_light(a_t, s_t, torch.from_numpy(p),
                                      torch.from_numpy(u1),
                                      torch.from_numpy(u2))
        want = ref_bgl.sample_bg_light(a_j, s_j, jnp.asarray(p),
                                       jnp.asarray(u1), jnp.asarray(u2))
        for k in ("wi", "dist", "li", "pdf"):
            _close(got[k], want[k])
        np.testing.assert_array_equal(got["valid"].numpy(),
                                      np.asarray(want["valid"]))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    _close(bglight.pdf_bg_dir(a_t, s_t, torch.from_numpy(d)),
           ref_bgl.pdf_bg_dir(a_j, s_j, jnp.asarray(d)))
    _close(bg.eval_background(s_t, a_t["bg_image"], torch.from_numpy(d)),
           ref_bg.eval_background(s_j, a_j["bg_image"], jnp.asarray(d)))
    for got_uv, want_uv in zip(bg.dir_to_uv(s_t, torch.from_numpy(d)),
                               ref_bg.dir_to_uv(s_j, jnp.asarray(d))):
        _close(got_uv, want_uv)


# ---- ibl_spheres.xml end to end ---------------------------------------------


def _setup(parse, build, config_cls, size, spp):
    s = parse(IBL)
    s.render_params["width"] = size
    s.render_params["height"] = size
    cfg = build(s)
    return s, config_cls(**{**cfg.__dict__, "width": size, "height": size,
                            "aa_samples": spp})


def _assets_loaded(arrays):
    """tex_0 is env.hdr (64 x 128) and tex_1 the 128 x 128 checker, not
    the 16 x 16 stand-in a failed load leaves."""
    env = np.asarray(arrays["tex_0"])
    checker = np.asarray(arrays["tex_1"])
    assert env.shape == (64, 128, 3) and checker.shape == (128, 128, 3)
    np.testing.assert_array_equal(env, _env())
    np.testing.assert_array_equal(np.asarray(arrays["bg_image"]), env)


@pytest.fixture(scope="module")
def reference():
    rs, rc = _setup(ref_parse, ref_build, RefConfig, 16, 2)
    ref = rs.compile()
    return ref, ref_render(ref, rc)


def _rmse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def test_ibl_spheres_matches_reference(reference):
    ref_cs, ref = reference
    ps, pc = _setup(parse_xml_file, build_config, RenderConfig, 16, 2)
    cs = ps.compile(device="cpu")
    _assets_loaded(ref_cs.arrays)
    _assets_loaded(cs.arrays)
    assert (pc.integrator, pc.bounces, pc.rr_min_bounces) == (
        "pathtracing", 5, 3)
    assert [ls.ltype for ls in cs.static.lights] == [7]
    assert cs.static.lights[0].samples == 8
    port = render(cs, pc, device="cpu")
    img = port.image
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05
    assert _rmse(ref.image, img) <= 1e-4
    r_ref, r_port = ref.stats["rays"], port.stats["rays"]
    assert abs(r_port - r_ref) <= 1e-4 * r_ref, (r_ref, r_port)


def test_ibl_spheres_from_reference_compile(reference):
    """The reference's compiled scene fed to the port through convert (the
    textures, mip atlas, background map and alias tables included)."""
    ref_cs, ref = reference
    arrays = convert.arrays_from_reference(ref_cs.arrays, "cpu")
    for k in ("tex_0", "tex_1", "mip_1", "bg_image", "bg_alias_prob",
              "bg_alias", "bg_pdf_grid"):
        assert k in arrays, k
    cs = CompiledScene(arrays=arrays,
                       static=convert.static_from_reference(ref_cs.static),
                       camera=convert.camera_from_reference(ref_cs.camera),
                       bound_min=tuple(ref_cs.bound_min),
                       bound_max=tuple(ref_cs.bound_max))
    _, rc = _setup(ref_parse, ref_build, RefConfig, 16, 2)
    port = render(cs, convert.config_from_reference(rc), device="cpu")
    assert _rmse(ref.image, port.image) <= 1e-4
    assert abs(port.stats["rays"] - ref.stats["rays"]) <= (
        1e-4 * ref.stats["rays"])


def test_render_scene_and_cli_render_ibl_spheres(tmp_path, capsys):
    """Its own settings (pathtracing, bounces 5, 64 spp) at 16² through
    render_scene and through the CLI on the CPU: the .exr reads back as
    render_scene's image and the --json-stats rays are its rays."""
    s = parse_xml_file(IBL)
    s.render_params["width"] = s.render_params["height"] = 16
    res = render_scene(s, device="cpu")
    assert (res.cfg.integrator, res.cfg.aa_samples, res.cfg.bounces) == (
        "pathtracing", 64, 5)
    out = str(tmp_path / "ibl.exr")
    assert cli_main([IBL, out, "--width", "16", "--height", "16",
                     "--device", "cpu", "--json-stats", "-vl",
                     "warning"]) == 0
    stats = json.loads([line for line in capsys.readouterr().out.splitlines()
                        if line.startswith("{")][-1])
    assert stats["rays"] == res.stats["rays"] > 0
    img = read_exr(out)
    assert img.shape == (16, 16, 3) and img.mean() > 0.05
    np.testing.assert_array_equal(img, res.image)


def test_ibl_spheres_raises_without_a_card(monkeypatch):
    """The default device is the card: without one the entry point raises
    and does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_scene(parse_xml_file(IBL))
