"""The path tracer's caustic photon map (caustic_type photon / both), the
port against the JAX reference on the CPU: scenes/cornell_path.xml at its
own settings (glass sphere with absorption, glossy sphere, bounces 5) at
16², 2 spp, with 8,192 caustic photons.

- the map (`photonmap.build_caustic_map`, as each package's render builds
  it: seed 777, one pass): photons emitted equal, stored count equal, and
  the stored photons' pos, dir and power within rtol 1e-4, the photon
  records' tolerance (tests/test_torch_photon.py: >= 99.5% of them agree,
  XLA contracts multiply-adds on the CPU);
- the render: image RMSE <= 1e-4, rays within 0.01%.
The density gather at the first vertex runs on the CPU's flash pack
(`density_flash_plain`), as the reference's does through its XLA path.
"""
import os

import numpy as np
import pytest
import torch

from libyafaray_tpu.integrators import photonmap as rpm
from libyafaray_tpu.integrators.config import RenderConfig as RefConfig
from libyafaray_tpu.integrators.render import render as ref_render
from libyafaray_tpu.scene.session import build_config as ref_build
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch.integrators import photonmap as ppm
from libyafaray_tpu_torch.integrators.config import RenderConfig
from libyafaray_tpu_torch.integrators.render import render, render_timed
from libyafaray_tpu_torch.scene.session import build_config
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "scenes", "cornell_path.xml")
SLICE = dict(width=16, height=16, aa_samples=2, caustic_photons=8192)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(parse, build, config_cls, caustic_type):
    s = parse(SCENE)
    s.render_params["width"] = s.render_params["height"] = 16
    return s, config_cls(**{**build(s).__dict__, **SLICE,
                            "caustic_type": caustic_type})


def _kept(monkeypatch, module, name):
    """Patch module.name to keep what each call returns."""
    kept, fn = [], getattr(module, name)

    def keep(*a, **k):
        kept.append(fn(*a, **k))
        return kept[-1]
    monkeypatch.setattr(module, name, keep)
    return kept


@pytest.fixture(scope="module", params=["photon", "both"])
def caustic(request):
    """(reference map, reference render, port map, port render) of one
    caustic_type."""
    with pytest.MonkeyPatch.context() as mp:
        rs, rc = _setup(ref_parse, ref_build, RefConfig, request.param)
        rmap = _kept(mp, rpm, "build_caustic_map")
        ref = ref_render(rs.compile(), rc)
        ps, pc = _setup(parse_xml_file, build_config, RenderConfig,
                        request.param)
        pmap = _kept(mp, ppm, "build_caustic_map")
        port = render(ps.compile(device="cpu"), pc, device="cpu")
    return rmap[0], ref, pmap[0], port, (ps, pc)


def test_caustic_map_matches_reference(caustic):
    (rpack, rrad, rnem), _, (ppack, prad, pnem, stored), port, _ = caustic
    assert (pnem, prad) == (rnem, rrad) == (8192, 0.1)
    assert rpack["pos_t"].shape == tuple(ppack["pos_t"].shape)
    rvalid = np.asarray(rpack["pos_t"])[0] < 1e8
    pvalid = ppack["pos_t"].numpy()[0] < 1e8
    assert int(rvalid.sum()) == int(pvalid.sum()) == stored > 100
    assert port.stats["photon_maps"]["caustic"]["stored"] == stored
    agree = np.isclose(ppack["val"].numpy(), np.asarray(rpack["val"]),
                       rtol=1e-4, atol=1e-6).all(axis=1)
    for key in ("pos_t", "aux_t"):
        agree &= np.isclose(ppack[key].numpy(), np.asarray(rpack[key]),
                            rtol=1e-4, atol=1e-5).all(axis=0)
    assert agree[rvalid].mean() >= 0.995, (~agree[rvalid]).sum()


def test_render_with_caustic_map_matches_reference(caustic):
    _, ref, _, port, _ = caustic
    img = port.image
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05
    rmse = float(np.sqrt(np.mean((img.astype(np.float64)
                                  - np.asarray(ref.image)) ** 2)))
    assert rmse <= 1e-4, rmse
    r_ref, r_port = ref.stats["rays"], port.stats["rays"]
    assert abs(r_port - r_ref) <= 1e-4 * r_ref, (r_ref, r_port)


def test_caustic_term_adds_light(caustic):
    """The map's term is there: the same render with caustic_type=path
    (no map) is darker, and render_timed builds the same map, counts the
    same rays and gives the same image."""
    _, _, _, port, (ps, pc) = caustic
    cs = ps.compile(device="cpu")
    plain = render(cs, RenderConfig(**{**pc.__dict__,
                                       "caustic_type": "path"}),
                   device="cpu")
    assert "photon_maps" not in plain.stats
    assert port.image.sum() > plain.image.sum()
    assert plain.stats["rays"] == port.stats["rays"]
    timed = render_timed(cs, pc, device="cpu")
    assert timed.stats["rays"] == port.stats["rays"]
    assert np.array_equal(timed.image, port.image)
    assert timed.stats["preprocess_s"] > 0
