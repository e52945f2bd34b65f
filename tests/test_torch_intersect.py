"""The port's tiny-scene intersection (plain PyTorch versions of the CUDA
kernels, libyafaray_tpu_torch/ops/cuda_intersect.py) against the JAX
reference: the Pallas tiny kernels in interpret mode and the jnp brute
force, on the Cornell pack (camera and random rays) and a 48-triangle
random soup.

Tolerances are the reference's own (tests/test_accel.py): hit and tri
equal, t within rtol 1e-4 (u, v also atol 1e-6), transmission within
atol 2e-3.  XLA on the CPU contracts multiply-adds, so the reference's
values differ from the plain versions' in the last bits.  On an
opaque hit the tiny kernels give exp(-80) ~ 1.8e-35 where brute force gives
exactly 0 (ops/intersect.py _shadow_small): expected, not a port fault.
The kernels themselves run only on the card; chip_smoke.py holds them to
these plain versions there."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libyafaray_tpu.ops import pallas_intersect as pli
from libyafaray_tpu.ops.intersect import (closest_hit_brute, pad_triangles,
                                          shadow_transmission_brute)
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch.ops import cuda_intersect as ci


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU path is many small tensor ops: one thread runs them
    fastest (and keeps parallel test workers off each other's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cornell():
    s = ref_parse("scenes/cornell.xml")
    s.render_params["width"] = 16
    s.render_params["height"] = 16
    return s.compile()


def _soup(rng, n_tris=48):
    v0 = (rng.random((n_tris, 3)) * 4.0 - 2.0).astype(np.float32)
    e1 = (rng.normal(size=(n_tris, 3)) * 0.8).astype(np.float32)
    e2 = (rng.normal(size=(n_tris, 3)) * 0.8).astype(np.float32)
    return v0, e1, e2


def _random_rays(rng, n, center, spread):
    org = (center + (rng.random((n, 3)) - 0.5) * spread).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return org, d


def _camera_rays(cornell, n):
    cam = cornell.camera
    rng = np.random.default_rng(3)
    from libyafaray_tpu.cameras.base import shoot_rays

    px = (rng.random(n) * cam.resx).astype(np.float32)
    py = (rng.random(n) * cam.resy).astype(np.float32)
    o, d, _ = shoot_rays(cam, jnp.asarray(px), jnp.asarray(py),
                         jnp.zeros(n), jnp.zeros(n))
    return np.array(o), np.array(d)  # writable copies for torch


def _cases(cornell):
    """(name, pack10, n_tris, tris (T,3)x3, filt (T,3), org, dir)."""
    rng = np.random.default_rng(11)
    a = cornell.arrays
    n_real = cornell.static.n_tris_real
    tris = tuple(a["tri_geom_pack"][:, k:k + 3] for k in (0, 3, 6))
    filt = a["shadow_filt"][:n_real]
    cases = []
    for name, (o, d) in (
            ("cornell-camera", _camera_rays(cornell, 256)),
            ("cornell-random", _random_rays(rng, 256, 2.75, 5.0))):
        cases.append((name, a["tri_pack10"], n_real, tris, filt, o, d))
    v0, e1, e2 = _soup(rng)
    pack, _, _ = ci.build_tri_pack(v0, e1, e2)
    filt_s = (rng.random((48, 3)) * (rng.random((48, 1)) > 0.5)).astype(
        np.float32)
    o, d = _random_rays(rng, 256, 0.0, 6.0)
    cases.append(("soup48", pack, 48, (v0, e1, e2), filt_s, o, d))
    return cases


CASES = ("cornell-camera", "cornell-random", "soup48")


@pytest.fixture(scope="module")
def cases(cornell):
    return {c[0]: c[1:] for c in _cases(cornell)}


def _closest_plain(pack, n_tris, o, d, tmin, tmax):
    return ci.closest_hit_tiny(torch.from_numpy(pack), torch.from_numpy(o),
                               torch.from_numpy(d), torch.from_numpy(tmin),
                               torch.from_numpy(tmax), n_tris)


@pytest.mark.parametrize("case", CASES)
def test_closest_plain_matches_pallas_tiny_and_brute(cases, case):
    pack, n_tris, (v0, e1, e2), _, o, d = cases[case]
    n = o.shape[0]
    tmin = np.full(n, 5e-5, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    tmax[::7] = 1.5  # some finite segments
    t, tri, u, v, hit = (x.numpy() for x in _closest_plain(
        pack, n_tris, o, d, tmin, tmax))
    pli.INTERPRET = True
    try:
        rt, rtri, ru, rv, rhit = (np.asarray(x) for x in pli._closest_hit_tiny(
            jnp.asarray(pack), jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(tmin), jnp.asarray(tmax), n_tris=n_tris))
    finally:
        pli.INTERPRET = False
    assert hit.any() and not hit.all()
    assert np.array_equal(hit, rhit)
    m = rhit
    assert np.array_equal(tri[m], rtri[m])
    assert np.allclose(t[m], rt[m], rtol=1e-4)
    # u, v come out of cancelling sums of O(1) terms, so near 0 their
    # rounding error is absolute: rtol 1e-4 plus atol 1e-6 (~8 ulp of 1)
    for a, b in ((u, ru), (v, rv)):
        assert np.allclose(a[m], b[m], rtol=1e-4, atol=1e-6)
    v0p, e1p, e2p, _ = pad_triangles(v0, e1, e2, 8)
    hb = closest_hit_brute(dict(v0=jnp.asarray(v0p), e1=jnp.asarray(e1p),
                                e2=jnp.asarray(e2p)), jnp.asarray(o),
                           jnp.asarray(d), jnp.asarray(tmin),
                           jnp.asarray(tmax), chunk=8)
    assert np.array_equal(hit, np.asarray(hb.hit))
    assert np.array_equal(tri[m], np.asarray(hb.tri)[m])
    assert np.allclose(t[m], np.asarray(hb.t)[m], rtol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_shadow_plain_matches_pallas_tiny_and_brute(cases, case):
    pack, n_tris, (v0, e1, e2), filt, o, d = cases[case]
    n = o.shape[0]
    dist = np.random.default_rng(5).uniform(0.5, 14.0, n).astype(np.float32)
    dist[::9] = -1.0  # dead lanes: empty segment
    filt4 = np.zeros((4, pack.shape[1]), np.float32)
    filt4[:3, :n_tris] = filt.T
    tr = ci.shadow_transmission_tiny(
        torch.from_numpy(pack), torch.from_numpy(filt4), torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(dist), n_tris).numpy()
    pli.INTERPRET = True
    try:
        rtr = np.asarray(pli._shadow_transmission_tiny(
            jnp.asarray(pack), jnp.asarray(filt4), jnp.asarray(o),
            jnp.asarray(d), jnp.asarray(dist), n_tris=n_tris))
    finally:
        pli.INTERPRET = False
    assert np.allclose(tr, rtr, atol=2e-3)
    v0p, e1p, e2p, _ = pad_triangles(v0, e1, e2, 8)
    fpad = np.zeros((v0p.shape[0], 3), np.float32)
    fpad[:n_tris] = filt
    rb = np.asarray(shadow_transmission_brute(
        dict(v0=jnp.asarray(v0p), e1=jnp.asarray(e1p), e2=jnp.asarray(e2p)),
        jnp.asarray(fpad), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(dist), chunk=8))
    assert np.allclose(tr, rb, atol=2e-3)
    assert (tr < 1.0).any() and (tr == 1.0).any()


def test_wrapper_routes_cpu_to_plain_and_counts_nothing(cases):
    """On CPU tensors closest_hit_tiny, and the private entry of the
    one-thread body its walk replaced, run the plain version and launch
    nothing."""
    pack, n_tris, _, _, o, d = cases["cornell-camera"]
    n = o.shape[0]
    args = (torch.from_numpy(pack), torch.from_numpy(o), torch.from_numpy(d),
            torch.full((n,), 5e-5), torch.full((n,), float("inf")))
    before = ci.closest_hit_tiny.launches
    want = ci.closest_hit_tiny_plain(*args, n_tris)
    for fn in (ci.closest_hit_tiny, ci._closest_hit_tiny_before):
        got = fn(*args, n_tris)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert want[4].any()
    assert ci.closest_hit_tiny.launches == before  # no kernel launched


def test_shadow_wrapper_routes_cpu_to_plain_and_counts_nothing(cases):
    """On CPU tensors shadow_logsum_tiny, and the private entry of the
    one-thread body its walk replaced, run the plain version and launch
    nothing."""
    pack, n_tris, _, filt, o, d = cases["cornell-random"]
    n = o.shape[0]
    filt4 = np.zeros((4, pack.shape[1]), np.float32)
    filt4[:3, :n_tris] = filt.T
    args = (torch.from_numpy(pack), ci.log_filter(torch.from_numpy(filt4)),
            torch.from_numpy(o), torch.from_numpy(d), torch.full((n,), 3.0))
    before = ci.shadow_logsum_tiny.launches
    want = ci.shadow_logsum_tiny_plain(*args, n_tris)
    for fn in (ci.shadow_logsum_tiny, ci._shadow_logsum_tiny_before):
        got = fn(*args, n_tris)
        assert got.shape == (n, 3) and torch.equal(got, want)
    assert (want < 0).any()
    assert ci.shadow_logsum_tiny.launches == before  # no kernel launched


def test_wrapper_rejects_bad_inputs(cases):
    pack, n_tris, _, _, o, d = cases["soup48"]
    n = o.shape[0]
    pk = torch.from_numpy(pack)
    org, dirn = torch.from_numpy(o), torch.from_numpy(d)
    lim = torch.zeros(n)
    with pytest.raises(TypeError):
        ci.closest_hit_tiny(pk, org.double(), dirn, lim, lim, n_tris)
    with pytest.raises(ValueError):
        ci.closest_hit_tiny(pk, org.t().contiguous().t(), dirn, lim, lim,
                            n_tris)
    with pytest.raises(ValueError):
        ci.closest_hit_tiny(pk, org, dirn, lim[:-1], lim, n_tris)
    with pytest.raises(ValueError):
        ci.closest_hit_tiny(pk, org, dirn, lim, lim, ci.TINY_TRIS + 1)
    with pytest.raises(ValueError):
        ci._closest_hit_tiny_before(pk, org, dirn, lim, lim,
                                    ci.TINY_TRIS + 1)
    with pytest.raises(TypeError):
        ci._closest_hit_tiny_before(pk, org, dirn, lim.double(), lim,
                                    n_tris)
    with pytest.raises(ValueError):
        ci.shadow_logsum_tiny(pk, torch.zeros(2, pack.shape[1]), org, dirn,
                              lim, n_tris)


def test_dispatch_above_tiny_raises(cornell):
    """Above TINY_TRIS the dispatch no longer raises (the dense range is
    ported): 65 triangles in one cluster take the dense kernels, and over
    Cornell's pack (its 33 columns past the real 32 are degenerate) they
    find the tiny kernels' hits."""
    from libyafaray_tpu_torch import convert
    from libyafaray_tpu_torch.ops import intersect as isect

    st = convert.static_from_reference(cornell.static)
    big = type(st)(**{**st.__dict__, "n_tris_real": 65})
    arrays = convert.arrays_from_reference(cornell.arrays, "cpu")
    assert isect.route(arrays["tri_pack10"], arrays["tri_cluster8"],
                       65) == "dense"
    rng = np.random.default_rng(2)
    o = torch.from_numpy(rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32))
    lim = (torch.full((64,), 5e-5), torch.full((64,), float("inf")))
    got = isect.closest_hit(arrays, big, o, d, *lim)
    want = isect.closest_hit(arrays, st, o, d, *lim)
    m = want.hit
    assert m.any() and torch.equal(got.hit, m) and torch.equal(got.t, want.t)
    for a, b in ((got.tri, want.tri), (got.u, want.u), (got.v, want.v)):
        assert torch.equal(a[m], b[m])  # misses: the epilogue's column 0
