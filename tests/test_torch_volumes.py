"""Volume regions and the volume integrators against the JAX package's:
every density model (uniform, exponential, noise, grid, sky), the phase
functions, the marched transmittance with and without `adaptive`, the
trilinear grid lookup, `integrate_volume` (Emission and SingleScatter,
each with and without `adaptive`, and SingleScatter over `optimize`'s
attenuation grids) on camera segments of scenes/sky_fog.xml, and
`build_attenuation_grids`, on inputs made from a seed with numpy; the
marches here take 2 steps and the grids 8³ cells in both packages (the
render's 16 steps and 24³ cells cost the reference's op-by-op nested
march minutes; the scene end to end, tests/test_torch_sky_fog.py, marches
4; its 16-step march is held card against CPU by chip_smoke.py).  The
in-scatter shadow rays go through each package's scene shadow function on
the same compiled scene (the port's through its dense shadow kernel's
plain version); the reference runs op by op.  A GridVolume reads a .df3
written to tmp_path (and must load: a failed load falls back to uniform);
the port reads its densities from the scene array vol_grid_{vi}.

Bounds: densities, phases and transmittances rtol 1e-5, atol 1e-6;
integrate_volume's radiance and transmittance, and the attenuation grids,
rtol 1e-4, atol 1e-6 (a sum over 16 steps of exp() and of nested
marches, each within an ulp of XLA's).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu.integrators.config import RenderConfig as RefConfig
from libyafaray_tpu.integrators.engine import _shadow_transmission
from libyafaray_tpu.scene.params import ParamMap as RefParamMap
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu.volumes import factory as rfac
from libyafaray_tpu.volumes import integrate as rvol
from libyafaray_tpu_torch import convert
from libyafaray_tpu_torch.integrators import engine
from libyafaray_tpu_torch.scene.params import ParamMap
from libyafaray_tpu_torch.volumes import factory as pfac
from libyafaray_tpu_torch.volumes import integrate as pvol

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKY_FOG = os.path.join(REPO, "scenes", "sky_fog.xml")
N = 512  # every call takes this many lanes (= the 8³ attenuation grid):
# one shape a primitive, so the reference compiles each op once
RTOL, ATOL = 1e-5, 1e-6
BOX = dict(minX=-3.0, minY=-2.0, minZ=0.0, maxX=3.0, maxY=4.0, maxZ=3.0)
VOLUMES = {
    "uniform": dict(type="UniformVolume", sigma_a=0.05, sigma_s=0.2, l_e=0.3),
    "exp": dict(type="ExpDensityVolume", sigma_a=0.02, sigma_s=0.3,
                a=1.5, b=0.8, l_e=0.2, g=0.4),
    "noise": dict(type="NoiseVolume", sigma_a=0.05, sigma_s=0.4,
                  sharpness=3.0, cover=0.6, density=1.2, l_e=0.4, g=-0.3),
    "sky": dict(type="SkyVolume", sigma_a=0.02, sigma_s=0.3, a=1.0, b=0.4,
                sigma_r=0.02, sigma_m=0.005, l_e=0.1, g=0.7),
    "grid": dict(type="GridVolume", sigma_a=0.05, sigma_s=0.3, l_e=0.25),
}


def _write_df3(path, shape=(5, 6, 7)):
    """A 16-bit POV-Ray density file (big-endian dims nx ny nz, voxels
    z-major), seeded."""
    nz, ny, nx = shape
    rng = np.random.default_rng(4)
    vox = rng.integers(0, 65536, nz * ny * nx).astype(">u2")
    with open(path, "wb") as f:
        f.write(np.asarray([nx, ny, nz], ">u2").tobytes() + vox.tobytes())
    return str(path)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    df3 = _write_df3(tmp_path_factory.mktemp("df3") / "d.df3")
    out = {}
    for k, v in VOLUMES.items():
        p = dict(v, **BOX, density_file=df3)
        out[k] = (rfac.volume_from_params(RefParamMap(p)),
                  pfac.volume_from_params(ParamMap(p)))
        assert out[k][0].__dict__ == out[k][1].__dict__
    assert out["grid"][1].grid_shape == (5, 6, 7)  # the grid loaded
    return out


@pytest.fixture(scope="module")
def fog_scene():
    """scenes/sky_fog.xml compiled by the reference and carried to the
    port, with the reference's arrays on the JAX side."""
    cs = ref_parse(SKY_FOG).compile()
    static = convert.static_from_reference(cs.static)
    arrays = convert.arrays_from_reference(
        cs.arrays, "cpu", n_stris_real=cs.static.n_stris_real)
    return cs, static, arrays


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(19)
    lo, hi = np.array([-3.5, -2.5, -0.5]), np.array([3.5, 4.5, 3.5])
    return (lo + rng.random((N, 3)) * (hi - lo)).astype(np.float32)


def _close(port, ref, rtol=RTOL, atol=ATOL, name=""):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=name)


def _grids(vols):
    """The port's density grids of the regions (`vol_grid_{vi}`, the
    scene arrays a compile makes of each GridVolume)."""
    return {k: torch.from_numpy(v) for k, v in
            pfac.grid_arrays([v[1] for v in vols]).items()}


@pytest.mark.parametrize("kind", sorted(VOLUMES))
def test_density_and_phase(kind, volumes, points):
    vr, vp = volumes[kind]
    _close(pvol._density(vp, torch.from_numpy(points),
                         _grids([volumes[kind]]).get("vol_grid_0")),
           rvol._density(vr, jnp.asarray(points)))
    cos_t = np.linspace(-1.0, 1.0, N, dtype=np.float32)
    _close(pvol._phase(vp, torch.from_numpy(cos_t)),
           rvol._phase(vr, jnp.asarray(cos_t)))


def test_unknown_type_falls_back(caplog):
    p = dict(type="CloudVolume", **BOX)
    vr = rfac.volume_from_params(RefParamMap(p))
    vp = pfac.volume_from_params(ParamMap(p))
    assert vp.__dict__ == vr.__dict__ and vp.vtype == pfac.VOL_UNIFORM
    assert any("unknown volume type" in r.message for r in caplog.records)
    missing = pfac.volume_from_params(ParamMap(dict(
        type="GridVolume", density_file="/nonexistent.df3", **BOX)))
    assert missing.grid_shape == ()  # uniform density, with a warning
    assert any("GridVolume" in r.message for r in caplog.records)


def _segments(n, seed):
    rng = np.random.default_rng(seed)
    org = np.zeros((n, 3), np.float32) + np.array([0.5, -6.0, 1.2],
                                                  np.float32)
    d = rng.normal(size=(n, 3)) * np.array([0.4, 0.2, 0.3]) + np.array(
        [0.0, 1.0, 0.0])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    dist = rng.uniform(2.0, 14.0, n).astype(np.float32)
    dist[::5] = 1e8  # escaped rays
    return org, d, dist


@pytest.fixture
def short_march(monkeypatch):
    """Both packages march 2 steps instead of 16: the same code, with a
    64th of the reference's op-by-op nested march."""
    monkeypatch.setattr(rvol, "MARCH_STEPS", 2)
    monkeypatch.setattr(pvol, "MARCH_STEPS", 2)


@pytest.mark.parametrize("adaptive", [False, True])
def test_transmittance(adaptive, volumes, short_march):
    org, d, dist = _segments(N, 1)
    vols = [v for v in volumes.values()]
    vr, vp = [v[0] for v in vols], [v[1] for v in vols]
    grids = pvol._grids(vp, _grids(vols))
    for i, (a, b) in enumerate(zip(vr, vp)):  # one region at a time
        _close(pvol.transmittance([b], torch.from_numpy(org),
                                  torch.from_numpy(d),
                                  torch.from_numpy(dist), adaptive,
                                  grids[i:i + 1]),
               rvol.transmittance([a], jnp.asarray(org), jnp.asarray(d),
                                  jnp.asarray(dist), adaptive),
               name=list(volumes)[i])
    # every region crossed multiplies in
    t = pvol.transmittance(vp, torch.from_numpy(org), torch.from_numpy(d),
                           torch.from_numpy(dist), adaptive, grids)
    _close(t, rvol.transmittance(vr, jnp.asarray(org), jnp.asarray(d),
                                 jnp.asarray(dist), adaptive))
    assert float(t.min()) < 0.9


def test_grid_is_a_scene_array(volumes, tmp_path):
    """A GridVolume's densities reach the device as the scene array
    vol_grid_{vi}, uploaded with the rest; the march reads them there."""
    from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

    scene = parse_xml_file(SKY_FOG)
    p = dict(VOLUMES["grid"], **BOX, density_file=_write_df3(
        tmp_path / "d.df3"))
    scene.create_volume_region("grid", ParamMap(p))
    cs = scene.compile(device="cpu")
    g = cs.arrays["vol_grid_1"]
    assert g.shape == (5, 6, 7) and g.dtype == np.float32
    np.testing.assert_array_equal(
        g.reshape(-1), np.asarray(volumes["grid"][1].grid_data, np.float32))
    assert "vol_grid_0" not in cs.arrays  # the fog is no grid
    with pytest.raises(ValueError, match="vol_grid"):
        pvol._density(cs.static.volumes[1], torch.zeros((1, 3)))


def test_trilinear_grid(points):
    g = np.random.default_rng(8).random((4, 5, 6)).astype(np.float32)
    lo, hi = (-3.0, -2.0, 0.0), (3.0, 4.0, 3.0)
    _close(pvol._trilinear_grid(torch.from_numpy(g), lo, hi,
                                torch.from_numpy(points)),
           rvol._trilinear_grid(jnp.asarray(g), lo, hi, jnp.asarray(points)))


def _integrate(fog_scene, vols, mode, adaptive=False, att=None, n=N):
    cs, static, arrays = fog_scene
    vr, vp = [v[0] for v in vols], [v[1] for v in vols]
    org, d, dist = _segments(n, 2)
    rng = np.random.default_rng(6)
    s_idx = rng.integers(0, 1 << 16, n).astype(np.uint32)
    skey = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    rcfg = RefConfig(vol_integrator=mode, vol_adaptive=adaptive)
    pcfg = convert.config_from_reference(rcfg)
    rarr = {k: (jnp.asarray(v) if not isinstance(v, dict) else
                {kk: jnp.asarray(vv) for kk, vv in v.items()})
            for k, v in cs.arrays.items()}
    parr = dict(arrays, **_grids(vols))
    if att is not None:
        rarr.update({k: jnp.asarray(v) for k, v in att.items()})
        parr.update({k: torch.from_numpy(np.asarray(v))
                     for k, v in att.items()})

    def rshadow(o, dd, ds):
        return _shadow_transmission(rarr, cs.static, rcfg, o, dd, ds)

    ref = rvol.integrate_volume(vr, mode, rarr, cs.static, rcfg, rshadow,
                                jnp.asarray(org), jnp.asarray(d),
                                jnp.asarray(dist), jnp.asarray(s_idx),
                                jnp.asarray(skey))
    port = pvol.integrate_volume(
        vp, mode, parr, static, pcfg,
        lambda o, dd, ds: engine.shadow_transmission(
            parr, static, pcfg.transp_shad, o, dd, ds),
        torch.from_numpy(org), torch.from_numpy(d), torch.from_numpy(dist),
        torch.from_numpy(s_idx.view(np.int32)),
        torch.from_numpy(skey.view(np.int32)))
    return ref, port


@pytest.mark.parametrize("kind", sorted(VOLUMES))
def test_integrate_emission(kind, volumes, fog_scene, short_march):
    ref, port = _integrate(fog_scene, [volumes[kind]], "EmissionIntegrator",
                           adaptive=kind in ("noise", "sky"))
    _close(port[0], ref[0], rtol=1e-4)
    _close(port[1], ref[1], rtol=1e-4)
    assert float(port[0].max()) > 0


@pytest.mark.parametrize("kind, adaptive", [("uniform", False),
                                            ("exp", True), ("sky", False),
                                            ("grid", False),
                                            ("noise", True), ("fog", False)])
def test_integrate_single_scatter(kind, adaptive, volumes, fog_scene,
                                  short_march):
    """In-scatter of the scene's sun (its IBL light is not marched), the
    shadow rays through the scene's 334-triangle shadow set; "fog" is the
    scene's own region."""
    cs, static, _ = fog_scene
    vols = ([(cs.static.volumes[0], static.volumes[0])] if kind == "fog"
            else [volumes[kind]])
    ref, port = _integrate(fog_scene, vols, "SingleScatterIntegrator",
                           adaptive=adaptive)
    _close(port[0], ref[0], rtol=1e-4)
    _close(port[1], ref[1], rtol=1e-4)
    assert float(port[0].max()) > 0


def test_attenuation_grids_and_optimize(fog_scene, short_march,
                                        monkeypatch):
    """`optimize`: the per-(volume, light) grids of the scene's own fog (8³
    cells here in both packages, 24³ in a render), then SingleScatter
    reading them instead of shadow rays."""
    monkeypatch.setattr(rvol, "ATT_GRID", 8)
    monkeypatch.setattr(pvol, "ATT_GRID", 8)
    cs, static, arrays = fog_scene
    rcfg = RefConfig(vol_integrator="SingleScatterIntegrator",
                     vol_optimize=True)
    rarr = {k: (jnp.asarray(v) if not isinstance(v, dict) else
                {kk: jnp.asarray(vv) for kk, vv in v.items()})
            for k, v in cs.arrays.items()}
    ref = rvol.build_attenuation_grids(
        cs.static.volumes, cs.static, rarr, rcfg,
        lambda o, d, ds: _shadow_transmission(rarr, cs.static, rcfg, o, d,
                                              ds))
    port = pvol.build_attenuation_grids(
        static.volumes, static, arrays, rcfg,
        lambda o, d, ds: engine.shadow_transmission(arrays, static, False, o,
                                                    d, ds))
    assert sorted(port) == sorted(ref) == ["vol_att_0_0"]
    for k in ref:
        assert port[k].shape == (pvol.ATT_GRID,) * 3
        _close(port[k], ref[k], rtol=1e-4)
    g = port["vol_att_0_0"]
    assert float(g.min()) < 0.5 < float(g.max())  # canopy shadow and sun
    fog = [(cs.static.volumes[0], static.volumes[0])]
    ref_i, port_i = _integrate(fog_scene, fog, "SingleScatterIntegrator",
                               att={k: np.array(v) for k, v in ref.items()})
    _close(port_i[0], ref_i[0], rtol=1e-4)
