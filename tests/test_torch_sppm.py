"""SPPM (libyafaray_tpu_torch/integrators/sppm.py) against the JAX
reference on the CPU, from the same numpy inputs or the same XML:
- photon shooting's `indirect` mode (no store at the first hit, straight
  from the light) on scenes/cornell_sppm.xml, 4,096 lanes, 2 bounces: the
  photon records' rule of tests/test_torch_photon.py (>= 99.5% of the
  slots agree, pos/dir/power/normal within rtol 1e-4);
- `flux_update` on one pack of numpy photons with per-hit-point radii
  (hit points that store nothing at pos = normal = 0, as the eye pass
  leaves them), on each layout a density gather takes: photon counts
  equal, R², N and τ within rtol 1e-5;
- `render_sppm` on cornell_sppm.xml at 16², 2 passes, 4,096 photons,
  raydepth 2 (the reference's own smoke size, tests/test_photon.py):
  image RMSE <= 1e-4, rays within 0.01%, the last pass's R², N and τ
  within rtol 1e-5;
- the scene at its own settings, photons cut to 4,096, through
  `render_scene` and the port's CLI on the CPU at 16².
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu.integrators import photon_shoot as rshoot
from libyafaray_tpu.integrators import photonmap as rpm
from libyafaray_tpu.integrators import sppm as rsppm
from libyafaray_tpu.integrators.config import RenderConfig as RefConfig
from libyafaray_tpu.ops import photon_flash as rpf
from libyafaray_tpu.scene.session import build_config as ref_build
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch.cli.yafaray_xml import main as cli_main
from libyafaray_tpu_torch.convert import to_tensors
from libyafaray_tpu_torch.integrators import photon_shoot as pshoot
from libyafaray_tpu_torch.integrators import photonmap as ppm
from libyafaray_tpu_torch.integrators import sppm as psppm
from libyafaray_tpu_torch.integrators.config import RenderConfig
from libyafaray_tpu_torch.io.exr import read_exr
from libyafaray_tpu_torch.ops import photon_flash as ppf
from libyafaray_tpu_torch.scene.session import build_config, render_scene
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "scenes", "cornell_sppm.xml")
RTOL = 1e-5
SMOKE = dict(width=16, height=16, sppm_passes=2, sppm_photons=4096,
             raydepth=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scene(parse):
    s = parse(SCENE)
    s.render_params["width"] = s.render_params["height"] = 16
    return s


def test_photon_pass_indirect_matches_reference():
    rs = _scene(ref_parse)
    rcs, rcfg = rs.compile(), ref_build(rs)
    ps = _scene(parse_xml_file)
    pcs, pcfg = ps.compile(device="cpu"), build_config(ps)
    rarrays = jax.device_put(rcs.arrays)
    cdf, total = rpm._light_cdf(rcs.static, rarrays)
    pcdf, _ = ppm._light_cdf(pcs.static, pcs.arrays["lights"])
    assert np.array_equal(cdf, pcdf)
    ref = jax.jit(rshoot.make_photon_pass(rcs.static, rcfg, 4096, 2,
                                          "indirect"))(
        rarrays, jnp.asarray(cdf), total, jnp.uint32(31337))
    port = pshoot.make_photon_pass(pcs.static, pcfg, 4096, 2, "indirect")(
        to_tensors(pcs.arrays, "cpu"), pcdf, 31337)
    rv, pv = np.asarray(ref["valid"]), port["valid"].numpy()
    assert not rv[:4096].any() and not pv[:4096].any()  # bounce 0
    both = rv & pv
    assert both.sum() > 1000
    agree = (rv == pv) & ~both
    same = both & np.equal(port["mat"].numpy(), np.asarray(ref["mat"]))
    for k in ("pos", "dir", "power", "normal"):
        same &= np.isclose(port[k].numpy(), np.asarray(ref[k]), rtol=1e-4,
                           atol=1e-5).all(axis=1)
    agree |= same
    assert agree.mean() >= 0.995, ((rv != pv).sum(), (both & ~same).sum())


@pytest.fixture(scope="module")
def update_inputs():
    """3,000 photons (10% invalid) and 400 hit points, a fifth of them
    storing nothing (pos = normal = tp = fd = 0), with per-point R² and
    a progressive state part-way through (N = 0 on a third)."""
    rng = np.random.default_rng(23)
    p, q = 3000, 400
    unit = rng.normal(size=(p + q, 3))
    unit = (unit / np.linalg.norm(unit, axis=1, keepdims=True)).astype(
        np.float32)
    photons = dict(pos=rng.uniform(0, 2, (p, 3)).astype(np.float32),
                   valid=rng.random(p) > 0.1, dir=unit[:p],
                   power=rng.random((p, 3)).astype(np.float32))
    valid = rng.random(q) > 0.2
    hp = dict(pos=rng.uniform(0, 2, (q, 3)).astype(np.float32),
              normal=unit[p:], tp=rng.random((q, 3)).astype(np.float32),
              fd=(rng.random((q, 3)) / np.pi).astype(np.float32),
              valid=valid)
    for k in ("pos", "normal", "tp", "fd"):
        hp[k][~valid] = 0.0
    state = (rng.uniform(0.01, 0.09, q).astype(np.float32),
             np.where(np.arange(q) % 3 == 0, 0.0,
                      rng.uniform(1, 60, q)).astype(np.float32),
             rng.random((q, 3)).astype(np.float32))
    return photons, hp, state


@pytest.mark.parametrize("layout", ["flash", "sorted", "culled"])
def test_flux_update_matches_reference(update_inputs, monkeypatch, layout):
    """The same update on each layout `density_auto` takes (on the CPU the
    sorted and culled packs run `density_culled_plain`, with the (N,)
    radii sqrt(R²) squared again)."""
    photons, hp, (r2, n_acc, tau) = update_inputs
    args = [photons[k] for k in ("pos", "valid", "dir", "power")]
    rpack = rpf.make_photon_pack(*(jnp.asarray(a) for a in args))
    want = jax.jit(rsppm.flux_update, static_argnames=("alpha",))(
        {k: jnp.asarray(v) for k, v in hp.items()}, rpack, jnp.asarray(r2),
        jnp.asarray(n_acc), jnp.asarray(tau), alpha=0.7)
    _, rcount = rpf.density_auto(rpack, jnp.asarray(hp["pos"]),
                                 jnp.asarray(hp["normal"]),
                                 jnp.sqrt(jnp.asarray(r2)))
    make = ppf.make_photon_pack if layout == "flash" else \
        ppf.make_photon_pack_sorted
    ppack = make(*(_t(a) for a in args))
    if layout == "culled":  # the culled layout from this pack's width on
        monkeypatch.setattr(ppf, "CULL_MIN_PHOTONS", 512)
    assert ppf.pack_layout(ppack) == layout
    php = {k: _t(v) for k, v in hp.items()}
    got = psppm.flux_update(php, ppack, _t(r2), _t(n_acc), _t(tau), 0.7)
    _, pcount = ppf.density_auto(ppack, php["pos"], php["normal"],
                                 torch.sqrt(_t(r2)))
    assert np.array_equal(np.asarray(rcount), pcount.numpy())
    # a zero normal passes no photon's side test
    assert (pcount.numpy()[hp["valid"]] > 0).sum() > 100
    assert not pcount.numpy()[~hp["valid"]].any()
    for name, r, p in zip(("r2", "n", "tau"), want, got):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=1e-7, err_msg=name)
    # a point that stores nothing keeps its state
    stay = ~hp["valid"]
    assert np.array_equal(got[0].numpy()[stay], r2[stay])
    assert np.array_equal(got[1].numpy()[stay], n_acc[stay])


def _last_state(monkeypatch, module, compiled: bool):
    """Patch module.flux_update to keep the state each pass returns."""
    kept, fn = [], module.flux_update

    def keep(*a, **k):
        out = fn(*a, **k)
        if compiled:
            jax.debug.callback(
                lambda *v: kept.append([np.asarray(x) for x in v]), *out)
        else:
            kept.append([x.numpy() for x in out])
        return out
    monkeypatch.setattr(module, "flux_update", keep)
    return kept


@pytest.fixture(scope="module")
def smoke():
    """The reference's and the port's render_sppm at SMOKE, with the
    progressive state of every pass."""
    with pytest.MonkeyPatch.context() as mp:
        s = _scene(ref_parse)
        rcfg = RefConfig(**{**ref_build(s).__dict__, **SMOKE})
        rstate = _last_state(mp, rsppm, compiled=True)
        ref = rsppm.render_sppm(s.compile(), rcfg)
        s = _scene(parse_xml_file)
        cfg = RenderConfig(**{**build_config(s).__dict__, **SMOKE})
        pstate = _last_state(mp, psppm, compiled=False)
        port = psppm.render_sppm(s.compile(device="cpu"), cfg, device="cpu")
    return ref, rstate, port, pstate, s, cfg


def test_render_sppm_matches_reference(smoke):
    ref, rstate, port, pstate, _, cfg = smoke
    assert cfg.integrator == "SPPM" and len(rstate) == len(pstate) == 2
    img = port.image
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05
    rmse = float(np.sqrt(np.mean((img.astype(np.float64)
                                  - np.asarray(ref.image)) ** 2)))
    assert rmse <= 1e-4, rmse
    r_ref, r_port = ref.stats["rays"], port.stats["rays"]
    assert abs(r_port - r_ref) <= 1e-4 * r_ref, (r_ref, r_port)
    for name, r, p in zip(("r2", "n", "tau"), rstate[-1], pstate[-1]):
        np.testing.assert_allclose(p, r, rtol=RTOL, atol=1e-7, err_msg=name)
    # the density layer: τ/(πR²·photons emitted), on top of the film
    np.testing.assert_allclose(port.film["density"].numpy(),
                               np.asarray(ref.film["density"]), rtol=RTOL,
                               atol=1e-7)
    ph = port.stats["photons"]
    assert ph["emitted"] == 2 * ph["lanes"] == 8192
    assert len(ph["stored"]) == 2 and min(ph["stored"]) > 1000


def test_render_sppm_timed_counts_the_same_rays(smoke):
    """The warm-up pass (pass 0 on throw-away state) changes nothing."""
    _, _, port, _, s, cfg = smoke
    timed = psppm.render_sppm_timed(s.compile(device="cpu"), cfg,
                                    device="cpu")
    assert timed.stats["rays"] == port.stats["rays"] > 0
    assert np.array_equal(timed.image, port.image)
    assert timed.stats["photons"] == port.stats["photons"]


def test_eye_pass_keeps_empty_hit_points_at_zero(smoke):
    """A pixel that stores no hit point (its path ends on the light, or
    leaves the chain) keeps pos = normal = tp = fd = 0 and still goes to
    the gather: the hit points are the film's H·W lanes."""
    *_, s, cfg = smoke
    cs = s.compile(device="cpu")
    eye = psppm.make_eye_pass(cs, cfg, "cpu")
    fresh, _ = psppm.make_sppm_pass(cs, cfg, "cpu")
    film, hp = eye(to_tensors(cs.arrays, "cpu"), fresh()["film"])
    valid = hp["valid"]
    assert valid.shape == (256,) and 0 < int((~valid).sum()) < 128
    for k in ("pos", "normal", "tp", "fd"):
        assert hp[k].shape == (256, 3)
        assert (hp[k][~valid] == 0).all(), k
    assert int(film["nsamples"].sum()) == 256 and float(film["rays"]) > 256


def test_render_scene_and_cli_render_sppm(tmp_path, capsys):
    """cornell_sppm.xml at its own settings (16 passes, raydepth 5), its
    photons cut to 4,096 a pass, through render_scene and through the CLI
    on the CPU at 16²: the .exr reads back as render_scene's image."""
    with open(SCENE) as f:
        xml = f.read().replace('<photons ival="200000"/>',
                               '<photons ival="4096"/>')
    path = str(tmp_path / "sppm.xml")
    with open(path, "w") as f:
        f.write(xml)
    s = parse_xml_file(path)
    s.render_params["width"] = s.render_params["height"] = 16
    res = render_scene(s, device="cpu")
    assert (res.cfg.integrator, res.cfg.sppm_passes, res.cfg.raydepth,
            res.cfg.sppm_photons) == ("SPPM", 16, 5, 4096)
    assert res.stats["passes"] == 16
    out = str(tmp_path / "sppm.exr")
    assert cli_main([path, out, "--width", "16", "--height", "16",
                     "--device", "cpu", "--json-stats", "-vl",
                     "warning"]) == 0
    stats = json.loads([line for line in capsys.readouterr().out.splitlines()
                        if line.startswith("{")][-1])
    assert stats["rays"] == res.stats["rays"] > 0
    img = read_exr(out)
    assert img.shape == (16, 16, 3) and img.mean() > 0.05
    np.testing.assert_array_equal(img, res.image)
