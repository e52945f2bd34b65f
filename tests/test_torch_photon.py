"""The photon-mapping slice of the port against the JAX reference on the
CPU: the photon packs and the plain versions of the three photon-gather
kernels (libyafaray_tpu_torch/ops/photon_flash.py), photon shooting,
compaction and the radiance map, and `render_photonmap` on
scenes/cornell_photon.xml (glass and glossy analytic spheres).

Inputs are made with numpy from fixed seeds and fed to both packages.  The
reference's gathers run as its own CPU tests run them: density_flash and
nearest_flash through their XLA reference path, density_culled in Pallas
interpret mode.  Tolerances:
- counts and found flags equal (the radius and side tests are computed in
  the same operation order);
- flux and values rtol 1e-5 (float32 sums taken in another order);
- photon records and maps: >= 99.5% of slots agree, a slot agreeing if
  both leave it empty or both store a photon with pos/dir/power/normal
  (and, in the maps, the value) within rtol 1e-4.  XLA contracts
  multiply-adds on the CPU, so Russian roulette and the Fresnel pick can
  flip on the last bit and a few photons go another way, and a refraction
  near the critical angle turns a last-bit difference into ~1e-3;
- the render: image RMSE <= 1e-4, rays within 0.01%.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu.integrators import photon_shoot as rshoot
from libyafaray_tpu.integrators import photonmap as rpm
from libyafaray_tpu.integrators.config import RenderConfig as RefConfig
from libyafaray_tpu.ops import photon_flash as rpf
from libyafaray_tpu.scene.session import build_config as ref_build
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch.convert import to_tensors
from libyafaray_tpu_torch.integrators import photon_shoot as pshoot
from libyafaray_tpu_torch.integrators import photonmap as ppm
from libyafaray_tpu_torch.integrators.config import RenderConfig
from libyafaray_tpu_torch.ops import photon_flash as ppf
from libyafaray_tpu_torch.scene import session
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "scenes", "cornell_photon.xml")
RTOL = 1e-5
# the slice's test size: 16², 1 spp, raydepth 2, photon_bounces 2, fg 2,
# 4,096 photons per map
SLICE = dict(width=16, height=16, aa_samples=1, raydepth=2, photon_bounces=2,
             fg_samples=2, photons=4096, caustic_photons=4096)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def photons():
    """3,000 photons (10% invalid) with exact duplicates inside one
    512-block (10, 11) and across two (20 in block 0, 600 in block 1), and
    300 queries, the first two exactly on the duplicates."""
    rng = np.random.default_rng(17)
    p, nq = 3000, 300
    pos = rng.uniform(0, 4, (p, 3)).astype(np.float32)
    pos[11], pos[600] = pos[10], pos[20]
    power = rng.random((p, 3)).astype(np.float32)
    dirs = _unit(rng, p)
    valid = rng.random(p) > 0.1
    valid[[10, 11, 20, 600]] = True
    qp = rng.uniform(0, 4, (nq, 3)).astype(np.float32)
    qp[0], qp[1] = pos[10], pos[20]
    qn = _unit(rng, nq)
    radius = rng.uniform(0.1, 0.4, nq).astype(np.float32)
    return pos, valid, dirs, power, qp, qn, radius


def _packs(photons):
    pos, valid, dirs, power = photons[:4]
    ref = rpf.make_photon_pack(jnp.asarray(pos), jnp.asarray(valid),
                               jnp.asarray(dirs), jnp.asarray(power))
    port = ppf.make_photon_pack(_t(pos), _t(valid), _t(dirs), _t(power))
    return ref, port


def test_flash_pack_equals_reference(photons):
    ref, port = _packs(photons)
    assert set(ref) == set(port)
    for k in ref:
        assert np.array_equal(np.asarray(ref[k]), port[k].numpy()), k
    assert port["pos_t"].shape == (3, 3072) and port["pos_t"].is_contiguous()


def _close(ref, port, name, scale=1.0):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=1e-6 * scale, err_msg=name)


@pytest.mark.parametrize("per_query", [True, False])
def test_density_flash_plain_matches_reference(photons, per_query):
    qp, qn, radius = photons[4:]
    rad = radius if per_query else 0.3
    ref_pack, port_pack = _packs(photons)
    rf, rc = rpf.density_flash(ref_pack, jnp.asarray(qp), jnp.asarray(qn),
                               jnp.asarray(rad))
    pf, pc = ppf.density_flash(port_pack, _t(qp), _t(qn),
                               _t(rad) if per_query else rad)
    assert np.array_equal(np.asarray(rc), pc.numpy())
    assert pc.sum() > 200
    _close(rf, pf, "flux", float(np.abs(np.asarray(rf)).max()))


@pytest.mark.parametrize("per_query", [True, False])
def test_nearest_flash_plain_matches_reference(photons, per_query):
    power = photons[3]
    qp, _, radius = photons[4:]
    rad = radius if per_query else 0.3
    ref_pack, port_pack = _packs(photons)
    rv, rfound = rpf.nearest_flash(ref_pack, jnp.asarray(qp),
                                   jnp.asarray(rad))
    pv, pfound = ppf.nearest_flash(port_pack, _t(qp),
                                   _t(rad) if per_query else rad)
    assert np.array_equal(np.asarray(rfound), pfound.numpy())
    _close(rv, pv, "value")
    # the tie rule: a tie inside a block is averaged, across blocks the
    # earlier block wins
    np.testing.assert_allclose(pv[0].numpy(), (power[10] + power[11]) / 2,
                               rtol=RTOL)
    assert np.array_equal(pv[1].numpy(), power[20])


def _nearest_case(photons, case):
    """(pos, valid, dirs, power, qp, radius) of a nearest-lookup case."""
    pos, valid, dirs, power, qp, _, radius = photons
    if case == "scalar_radius":
        radius = 0.3
    elif case == "all_invalid":
        valid = np.zeros_like(valid)
    elif case == "radius_excludes_all":
        radius = 1e-6
        qp = qp + np.float32(0.01)  # off the duplicates it sat on
    elif case == "duplicates_in_sorted_neighbours":
        # 40 copies of one photon spread over blocks 0, 2 and 5 of the
        # original order: the sort puts them side by side, block 0 must win
        pos, power = pos.copy(), power.copy()
        idx = np.r_[30:40, 1100:1115, 2600:2615]
        pos[idx] = pos[30]
        valid = valid.copy()
        valid[idx] = True
        qp = qp.copy()
        qp[2] = pos[30]
    return pos, valid, dirs, power, qp, radius


NEAREST_CASES = ("per_query_radius", "scalar_radius", "all_invalid",
                 "radius_excludes_all", "duplicates_in_sorted_neighbours")


@pytest.mark.parametrize("case", NEAREST_CASES)
def test_nearest_culled_plain_matches_flash_and_reference(photons, case):
    """The lexicographic rule over the sorted pack (what the culled search
    on the card computes) against the block rule over the unsorted pack
    and the reference's nearest_flash: found equal, best d2 equal, value
    rtol 1e-5."""
    pos, valid, dirs, power, qp, radius = _nearest_case(photons, case)
    rad_t = _t(radius) if isinstance(radius, np.ndarray) else radius
    flash = ppf.make_photon_pack(_t(pos), _t(valid), _t(dirs), _t(power))
    near = ppf.make_photon_pack_nearest(_t(pos), _t(valid), _t(dirs),
                                        _t(power))
    fv, fbest = ppf.nearest_flash_best(flash, _t(qp), rad_t)
    cv, cbest = ppf.nearest_flash_best(near, _t(qp), rad_t)
    assert torch.equal(fbest, cbest)
    _close(fv.numpy(), cv, "value vs flash")
    pv, pfound = ppf.nearest_flash(near, _t(qp), rad_t)
    assert torch.equal(pv, cv) and torch.equal(pfound, torch.isfinite(cbest))
    plain_v, plain_found = ppf.nearest_culled_plain(near, _t(qp), rad_t)
    assert torch.equal(plain_v, cv) and torch.equal(plain_found, pfound)
    ref = rpf.make_photon_pack(jnp.asarray(pos), jnp.asarray(valid),
                               jnp.asarray(dirs), jnp.asarray(power))
    rv, rfound = rpf.nearest_flash(ref, jnp.asarray(qp), jnp.asarray(radius))
    assert np.array_equal(np.asarray(rfound), pfound.numpy())
    _close(rv, cv, "value vs reference")
    if case in ("all_invalid", "radius_excludes_all"):
        assert not pfound.any() and not cv.any()
    else:
        assert 20 < int(pfound.sum()) < len(qp)
        # ties inside a block are averaged, across blocks the earlier wins
        np.testing.assert_allclose(cv[0].numpy(), (power[10] + power[11]) / 2,
                                   rtol=RTOL)
        assert np.array_equal(cv[1].numpy(), power[20])
    if case == "duplicates_in_sorted_neighbours":
        np.testing.assert_allclose(cv[2].numpy(),
                                   power[30:40].mean(axis=0), rtol=RTOL)


def test_nearest_pack_carries_original_blocks(photons):
    """make_photon_pack_nearest: the sorted pack with row 9 = original
    index // 512; every other row and the boxes are the sorted pack's."""
    pos, valid, dirs, power = (_t(a) for a in photons[:4])
    near = ppf.make_photon_pack_nearest(pos, valid, dirs, power)
    srt = ppf.make_photon_pack_sorted(pos, valid, dirs, power)
    for k in ("cl_lo", "cl_hi", "n_valid"):
        assert torch.equal(near[k], srt[k]), k
    rows = [r for r in range(16) if r != 9]
    assert torch.equal(near["tbl"][rows], srt["tbl"][rows])
    assert not srt["tbl"][9].any()
    # each valid photon is found again at its sorted place with its block
    tbl = near["tbl"].numpy()
    p = photons[0].shape[0]
    by_pos = {tuple(x): i // 512 for i, x in enumerate(photons[0])
              if photons[1][i]}
    seen = 0
    for j in range(tbl.shape[1]):
        key = tuple(tbl[0:3, j])
        if key in by_pos and key not in (tuple(photons[0][10]),
                                         tuple(photons[0][20])):
            assert tbl[9, j] == by_pos[key], j
            seen += 1
    assert seen >= photons[1].sum() - 4
    assert np.array_equal(tbl[9, p:], np.arange(p, tbl.shape[1]) // 512)
    assert sorted(np.unique(tbl[9])) == list(range(tbl.shape[1] // 512))
    # the dispatch: sorted only for CUDA packs
    assert "pos_t" in ppf.make_photon_pack_lookup(pos, valid, dirs, power)


def test_nearest_pair_tests_counts_near_clusters(sorted_photons_near):
    """The bound's count: clusters within min(r2, best d2) of a query, by
    their valid photons; never more than the radius alone admits, and at
    least the winner's cluster."""
    near, qp, radius = sorted_photons_near
    _, best = ppf.nearest_flash_best(near, _t(qp), _t(radius))
    pairs, boxes = ppf.nearest_pair_tests(near, _t(qp), _t(radius), best)
    wide, boxes_w = ppf.culled_pair_tests(near, _t(qp), _t(radius))
    n_cl = near["cl_lo"].shape[0]
    assert boxes == boxes_w == len(qp) * n_cl
    found = int(torch.isfinite(best).sum())
    assert 0 < found and found <= pairs < wide
    # queries outside every box's reach need no pair test
    none, _ = ppf.nearest_pair_tests(near, _t(qp + np.float32(100.0)),
                                     _t(radius), best)
    assert none == 0


@pytest.fixture(scope="module")
def sorted_photons_near():
    """6,000 photons in [-5, 5]³ (10% invalid) as a nearest pack, 700
    queries with radii 0.2-0.8."""
    rng = np.random.default_rng(13)
    p, nq = 6000, 700
    pos = rng.uniform(-5, 5, (p, 3)).astype(np.float32)
    power = rng.random((p, 3)).astype(np.float32)
    valid = rng.random(p) > 0.1
    near = ppf.make_photon_pack_nearest(_t(pos), _t(valid), _t(_unit(rng, p)),
                                        _t(power))
    qp = rng.uniform(-5, 5, (nq, 3)).astype(np.float32)
    return near, qp, rng.uniform(0.2, 0.8, nq).astype(np.float32)


@pytest.fixture(scope="module")
def sorted_photons():
    """6,000 photons in [-5, 5]³, 10% invalid, with runs of photons that
    share a Morton cell (repeated keys), 700 queries."""
    rng = np.random.default_rng(13)
    p, nq = 6000, 700
    pos = rng.uniform(-5, 5, (p, 3)).astype(np.float32)
    pos[100:140] = pos[100] + rng.uniform(0, 1e-4, (40, 3)).astype(np.float32)
    power = rng.random((p, 3)).astype(np.float32)
    dirs = _unit(rng, p)
    valid = rng.random(p) > 0.1
    qp = rng.uniform(-5, 5, (nq, 3)).astype(np.float32)
    qn = _unit(rng, nq)
    radius = rng.uniform(0.2, 0.8, nq).astype(np.float32)
    ref = rpf.make_photon_pack_sorted(jnp.asarray(pos), jnp.asarray(valid),
                                      jnp.asarray(dirs), jnp.asarray(power))
    port = ppf.make_photon_pack_sorted(_t(pos), _t(valid), _t(dirs),
                                       _t(power))
    return ref, port, (qp, qn, radius)


def test_sorted_pack_equals_reference(sorted_photons):
    ref, port, _ = sorted_photons
    for k in ("tbl", "cl_lo", "cl_hi", "n_valid"):
        assert np.array_equal(np.asarray(ref[k]), port[k].numpy()), k
    assert port["tbl"].shape == (16, 6144)
    assert int(port["n_valid"]) < 6000


def test_density_culled_plain_matches_reference(sorted_photons):
    ref, port, (qp, qn, radius) = sorted_photons
    rpf.INTERPRET = True
    try:
        rf, rc = rpf.density_culled(ref, jnp.asarray(qp), jnp.asarray(qn),
                                    jnp.asarray(radius))
    finally:
        rpf.INTERPRET = False
    pf, pc = ppf.density_culled(port, _t(qp), _t(qn), _t(radius))
    assert np.array_equal(np.asarray(rc), pc.numpy())
    assert pc.sum() > 1000
    _close(rf, pf, "flux", float(np.abs(np.asarray(rf)).max()))
    # the same photons through the flash sweep: equal counts
    ff, fc = ppf.density_flash_plain(ppf.flash_view(port), _t(qp), _t(qn),
                                     _t(radius))
    assert torch.equal(fc, pc)
    _close(ff.numpy(), pf, "flux vs flash", float(ff.abs().max()))
    assert ppf.density_auto(port, _t(qp), _t(qn), _t(radius))[1].equal(pc)


@pytest.mark.parametrize("per_query", [True, False])
def test_density_flash_on_sorted_pack_matches_reference(photons, per_query):
    """density_flash over a Morton-sorted pack (on the card the warp-per-
    query search; on the CPU `density_culled_plain`) against the
    reference's density_flash over its flash pack and the port's flash
    sweep: counts equal, flux rtol 1e-5."""
    pos, valid, dirs, power, qp, qn, radius = photons
    rad = radius if per_query else 0.3
    ref_pack, flash = _packs(photons)
    srt = ppf.make_photon_pack_sorted(_t(pos), _t(valid), _t(dirs),
                                      _t(power))
    rad_t = _t(rad) if per_query else rad
    sf, sc = ppf.density_flash(srt, _t(qp), _t(qn), rad_t)
    rf, rc = rpf.density_flash(ref_pack, jnp.asarray(qp), jnp.asarray(qn),
                               jnp.asarray(rad))
    ff, fc = ppf.density_flash_plain(flash, _t(qp), _t(qn), rad_t)
    assert np.array_equal(np.asarray(rc), sc.numpy()) and torch.equal(fc, sc)
    assert sc.sum() > 200
    _close(rf, sf, "flux vs reference", float(np.abs(np.asarray(rf)).max()))
    _close(ff.numpy(), sf, "flux vs flash", float(ff.abs().max()))
    assert ppf.pack_layout(srt) == "sorted"
    assert torch.equal(ppf.density_auto(srt, _t(qp), _t(qn), rad_t)[1], sc)


def _warp_density(pack, qp, qn, r2):
    """The card's density over a sorted pack in plain PyTorch, one warp a
    query: the clusters whose box lies within the query's radius, in
    rising index; lane l of 32 sums photons l, l + 32, ... of each (d2 <=
    r2, front side), then the lanes are added by the xor tree (offsets 16,
    8, 4, 2, 1).  Returns (flux, count, pair tests: the valid photons of
    the visited clusters)."""
    tbl, lo, hi = pack["tbl"], pack["cl_lo"], pack["cl_hi"]
    valid = tbl[0] < 0.5 * ppf.SENTINEL
    lanes_f = torch.zeros((qp.shape[0], 32, 3))
    lanes_c = torch.zeros((qp.shape[0], 32))
    pairs = 0
    for c in range(lo.shape[0]):
        near = ppf._box_d2(qp, lo[c], hi[c]) <= r2
        pairs += int(near.sum()) * int(valid[c * 512:(c + 1) * 512].sum())
        for it in range(512 // 32):
            j = c * 512 + 32 * it + torch.arange(32)
            dx, dy, dz = (qp[:, a:a + 1] - tbl[a, j][None] for a in range(3))
            d2 = dx * dx + dy * dy + dz * dz
            side = (qn[:, 0:1] * tbl[3, j][None] + qn[:, 1:2] * tbl[4, j][None]
                    + qn[:, 2:3] * tbl[5, j][None])
            w = near[:, None] & (d2 <= r2[:, None]) & (side > 0.0)
            lanes_f = lanes_f + torch.where(w[..., None], tbl[6:9, j].T[None],
                                            0.0)
            lanes_c = lanes_c + w.to(torch.float32)
    idx = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        lanes_f = lanes_f + lanes_f[:, idx ^ off]
        lanes_c = lanes_c + lanes_c[:, idx ^ off]
    return lanes_f[:, 0], lanes_c[:, 0], pairs


def test_warp_density_walk_gives_the_plain_density(sorted_photons):
    """The card kernel's visit rule and sum order over the sorted pack
    against `density_culled_plain` and the flash sweep over the same
    photons: counts equal bit for bit (the radius and side tests keep
    their operation order), flux rtol 1e-5; its pair tests are
    `culled_pair_tests`' count, a fraction of the brute force's."""
    _, port, (qp, qn, radius) = sorted_photons
    q, n = _t(qp), _t(qn)
    r2 = _t(radius) * _t(radius)
    wf, wc, pairs = _warp_density(port, q, n, r2)
    cf, cc = ppf.density_culled_plain(port, q, n, _t(radius))
    ff, fc = ppf.density_flash_plain(ppf.flash_view(port), q, n, _t(radius))
    assert torch.equal(wc, cc) and torch.equal(wc, fc) and wc.sum() > 1000
    _close(cf.numpy(), wf, "flux vs culled", float(cf.abs().max()))
    _close(ff.numpy(), wf, "flux vs flash", float(ff.abs().max()))
    assert pairs == ppf.culled_pair_tests(port, q, _t(radius))[0]
    assert pairs < 0.5 * len(qp) * int(port["n_valid"])


def test_culled_constants_are_the_kernels():
    """CULL_QUERIES, CULL_TPQ and CULL_WINDOW, which the tile lists and the
    tests use, are the values csrc/photon_flash.cu is built with."""
    import re

    with open(os.path.join(REPO, "libyafaray_tpu_torch", "csrc",
                           "photon_flash.cu")) as f:
        src = f.read()
    d = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)\b", src)}
    assert ppf.CULL_TPQ == d["CULL_TPQ"]
    assert ppf.CULL_QUERIES == d["THREADS"] // d["CULL_TPQ"] * d["CULL_QPT"]
    assert ppf.CULL_WINDOW == 32 * d["CULL_MASK_WORDS"]
    assert ppf.BP == d["BP"]


@pytest.fixture(scope="module")
def clumps():
    """30,000 photons (10% invalid) in two clumps 10 apart on every axis,
    as a sorted pack (59 clusters), and 600 queries with radii 0.1-0.5:
    most on photons of either clump, a tenth anywhere in the box that
    holds both, so Morton runs of queries jump and tile boxes grow."""
    rng = np.random.default_rng(23)
    p, nq = 30_000, 600
    centre = np.where(rng.random(p)[:, None] < 0.5, 0.0, 10.0)
    pos = (centre + rng.normal(0.0, 1.0, (p, 3))).astype(np.float32)
    valid = rng.random(p) > 0.1
    pack = ppf.make_photon_pack_sorted(_t(pos), _t(valid), _t(_unit(rng, p)),
                                       _t(rng.random((p, 3)).astype(
                                           np.float32)))
    qp = (pos[rng.integers(0, p, nq)]
          + rng.normal(0.0, 0.05, (nq, 3))).astype(np.float32)
    qp[::10] = rng.uniform(-3.0, 13.0, (nq // 10, 3))
    radius = rng.uniform(0.1, 0.5, nq).astype(np.float32)
    return pack, _t(qp), _t(_unit(rng, nq)), _t(radius)


def _tile_walk(pack, qp, qn, radius, window=ppf.CULL_WINDOW, reverse=False):
    """`density_culled_kernel` in plain PyTorch.  The queries in
    `cull_order`, CULL_QUERIES to a tile.  Per tile and window of `window`
    clusters, the words of 32 clusters whose union box lies within the
    tile's largest radius of its query box, in rising or (reverse) falling
    order (warps take them in turn): the clusters of such a word whose own
    box passes the same test are candidates, and a candidate is listed if
    some query's point-box d2 <= its r2.  Then thread j of a query sums
    photons k = j mod CULL_TPQ of each listed cluster one by one into a
    partial, added to its total cluster by cluster in rising index, and
    the CULL_TPQ totals are added by the xor tree.  Returns (flux, count,
    each tile's listed clusters in visit order)."""
    tbl, lo, hi = pack["tbl"], pack["cl_lo"], pack["cl_hi"]
    n, n_cl = qp.shape[0], lo.shape[0]
    tile, tpq = ppf.CULL_QUERIES, ppf.CULL_TPQ
    perm = ppf.cull_order(pack, qp)
    pad = (-n) % tile
    q = torch.cat([qp[perm], torch.zeros((pad, 3))])
    qn_s = torch.cat([qn[perm], torch.zeros((pad, 3))])
    r2 = torch.cat([(radius * radius)[perm], torch.full((pad,), -1.0)])
    wbox = ppf._word_boxes(lo, hi)
    visits = []
    for t in range(q.shape[0] // tile):
        tq, tr = q[t * tile:(t + 1) * tile], r2[t * tile:(t + 1) * tile]
        live = (tr >= 0.0)[:, None]
        blo = torch.where(live, tq, float("inf")).amin(0)
        bhi = torch.where(live, tq, -float("inf")).amax(0)
        rmax = tr.amax()
        seen = []
        for c0 in range(0, n_cl, window):
            keep = torch.zeros(n_cl, dtype=torch.bool)
            words = [w0 for w0 in range(c0, min(c0 + window, n_cl), 32)
                     if ppf._gap2(wbox[w0 // 32, :3], wbox[w0 // 32, 3:],
                                  blo, bhi) <= rmax]
            for w0 in reversed(words) if reverse else words:
                for c in range(w0, min(w0 + 32, n_cl)):
                    if ppf._gap2(lo[c], hi[c], blo, bhi) <= rmax:
                        keep[c] = bool(
                            (ppf._box_d2(tq, lo[c], hi[c]) <= tr).any())
            seen += [int(c) for c in torch.nonzero(keep)[:, 0]]
        visits.append(seen)
    lanes_f = torch.zeros((q.shape[0], tpq, 3))
    lanes_c = torch.zeros((q.shape[0], tpq))
    tile_of = torch.arange(q.shape[0]) // tile
    for c in range(n_cl):
        on = torch.tensor([c in v for v in visits])[tile_of][:, None]
        if not on.any():
            continue
        # a cluster's partial sums, added to the totals after it
        part_f, part_c = torch.zeros_like(lanes_f), torch.zeros_like(lanes_c)
        for it in range(ppf.BP // tpq):
            k = c * ppf.BP + tpq * it + torch.arange(tpq)
            dx, dy, dz = (q[:, a:a + 1] - tbl[a, k][None] for a in range(3))
            d2 = dx * dx + dy * dy + dz * dz
            side = (qn_s[:, 0:1] * tbl[3, k][None]
                    + qn_s[:, 1:2] * tbl[4, k][None]
                    + qn_s[:, 2:3] * tbl[5, k][None])
            w = on & (d2 <= r2[:, None]) & (side > 0.0)
            part_f = part_f + torch.where(w[..., None], tbl[6:9, k].T[None],
                                          0.0)
            part_c = part_c + w.to(torch.float32)
        lanes_f, lanes_c = lanes_f + part_f, lanes_c + part_c
    idx = torch.arange(tpq)
    off = tpq // 2
    while off:
        lanes_f = lanes_f + lanes_f[:, idx ^ off]
        lanes_c = lanes_c + lanes_c[:, idx ^ off]
        off //= 2
    flux, cnt = torch.empty((n, 3)), torch.empty(n)
    flux[perm], cnt[perm] = lanes_f[:n, 0], lanes_c[:n, 0]
    return flux, cnt, visits


@pytest.fixture(scope="module")
def clumps_walk(clumps):
    return _tile_walk(*clumps)


def test_culled_tile_walk_gives_the_plain_density(clumps, clumps_walk):
    """The card kernel's tile lists and sum order against
    `density_culled_plain`: counts equal bit for bit, flux rtol 1e-5.  Each
    tile lists, in rising index, exactly the clusters some query of it
    needs (`culled_tile_lists`, by brute force over the tile's queries),
    a subset of its tile-box candidates, and less than half of them where
    a tile spans both clumps."""
    pack, qp, qn, radius = clumps
    wf, wc, visits = clumps_walk
    cf, cc = ppf.density_culled_plain(pack, qp, qn, radius)
    assert torch.equal(wc, cc) and wc.sum() > 5000
    _close(cf.numpy(), wf, "flux vs culled plain", float(cf.abs().max()))
    words, cand, listed = ppf.culled_tile_lists(pack, qp, radius)
    perm = ppf.cull_order(pack, qp)
    lo, hi = pack["cl_lo"], pack["cl_hi"]
    n_cl = lo.shape[0]
    r2 = (radius * radius)[perm]
    tile = ppf.CULL_QUERIES
    for t, seen in enumerate(visits):
        q, rr = qp[perm][t * tile:(t + 1) * tile], r2[t * tile:(t + 1) * tile]
        need = [c for c in range(n_cl)
                if bool((ppf._box_d2(q, lo[c], hi[c]) <= rr).any())]
        assert seen == need == sorted(set(seen)), t
        assert seen == torch.nonzero(listed[t])[:, 0].tolist(), t
    near = torch.repeat_interleave(words, 32, dim=1)[:, :n_cl]
    assert bool((listed <= cand).all()) and bool((cand <= near).all())
    assert int(words.sum()) < words.numel()
    assert bool((cand.sum(1) > 2 * listed.sum(1)).any())
    assert n_cl > 32  # more than one window of 32 clusters


@pytest.mark.parametrize("window,reverse", [(ppf.CULL_WINDOW, True),
                                            (32, False), (32, True)])
def test_culled_tile_walk_bits_are_order_and_window_free(clumps, clumps_walk,
                                                         window, reverse):
    """The words of a window taken in falling order (warps finish their
    words in any order), and lists capped at a window of 32 clusters (the
    overflow path: two windows here, one after the other), give the same
    lists and the same bits."""
    wf, wc, visits = clumps_walk
    f, c, v = _tile_walk(*clumps, window=window, reverse=reverse)
    assert v == visits and torch.equal(c, wc) and torch.equal(f, wf)


def test_culled_wrappers_route_cpu_to_plain(clumps):
    """On CPU tensors `density_culled` and the private old body run
    `density_culled_plain` and count no launch."""
    pack, qp, qn, radius = clumps
    want = ppf.density_culled_plain(pack, qp, qn, radius)
    before = ppf.density_culled.launches
    for fn in (ppf.density_culled, ppf._density_culled_before):
        got = fn(pack, qp, qn, radius)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ppf.density_culled.launches == before
    with pytest.raises(ValueError, match="shape"):
        ppf._density_culled_before(pack, qp, qn[:5], radius)


def test_pack_layout_predicates(monkeypatch, photons):
    """sorted_layout: CUDA packs take the sorted layouts, CPU packs the
    flash one; make_photon_pack_auto and make_photon_pack_lookup follow it;
    pack_layout names the gather density_auto takes (the culled kernel
    from CULL_MIN_PHOTONS columns of a sorted pack)."""
    assert ppf.sorted_layout("cuda") and ppf.sorted_layout("cuda:1")
    assert ppf.sorted_layout(torch.device("cuda", 0))
    assert not ppf.sorted_layout("cpu")
    assert not ppf.sorted_layout(torch.device("cpu"))
    args = [_t(a) for a in photons[:4]]
    flash = ppf.make_photon_pack_auto(*args)
    assert ppf.pack_layout(flash) == "flash"
    assert "pos_t" in ppf.make_photon_pack_lookup(*args)
    monkeypatch.setattr(ppf, "sorted_layout", lambda device: True)
    srt = ppf.make_photon_pack_auto(*args)
    assert srt["tbl"].shape == (16, 3072) and ppf.pack_layout(srt) == "sorted"
    assert "tbl" in ppf.make_photon_pack_lookup(*args)
    seen = []
    for name in ("density_flash", "density_culled"):
        monkeypatch.setattr(ppf, name, lambda *a, name=name: seen.append(name))
    ppf.density_auto(flash, None, None, 0.3)
    ppf.density_auto(srt, None, None, 0.3)
    monkeypatch.setattr(ppf, "CULL_MIN_PHOTONS", 3072)
    assert ppf.pack_layout(srt) == "culled"
    ppf.density_auto(srt, None, None, 0.3)
    assert seen == ["density_flash", "density_flash", "density_culled"]


def test_auto_pack_takes_flash_layout_on_cpu(monkeypatch, photons):
    """The culled layout is for CUDA packs only, as the reference builds it
    only where its Pallas kernels run."""
    pos, valid, dirs, power = (_t(a) for a in photons[:4])
    monkeypatch.setattr(ppf, "CULL_MIN_PHOTONS", 1024)
    assert "pos_t" in ppf.make_photon_pack_auto(pos, valid, dirs, power)


def test_wrappers_check_their_inputs(photons):
    _, port_pack = _packs(photons)
    qp = _t(photons[4])
    bad = dict(port_pack, pos_t=port_pack["pos_t"][:, :1000].contiguous())
    with pytest.raises(ValueError, match="multiple of 512"):
        ppf.nearest_flash(bad, qp, 0.3)
    with pytest.raises(TypeError, match="float32"):
        ppf.nearest_flash(port_pack, qp.double(), 0.3)
    with pytest.raises(ValueError, match="shape"):
        ppf.density_flash(port_pack, qp, qp[:5], 0.3)


# ---- photon shooting, maps and the slice render ----------------------------


def _scene(parse):
    s = parse(SCENE)
    s.render_params["width"] = 16
    s.render_params["height"] = 16
    return s


@pytest.fixture(scope="module")
def ref_slice():
    """The reference's compiled scene, slice config, photon maps and
    render, each computed once (the maps are the ones its render builds)."""
    s = _scene(ref_parse)
    cfg = RefConfig(**{**ref_build(s).__dict__, **SLICE})
    cs = s.compile()
    arrays = jax.device_put(cs.arrays)
    built = []

    def build_and_keep(*args, **kwargs):
        built.append(build_maps(*args, **kwargs))
        return built[-1]

    build_maps = rpm.build_photon_maps
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rpm, "build_photon_maps", build_and_keep)
        res = rpm.render_photonmap(cs, cfg)
    return cs, cfg, arrays, built[0], res


@pytest.fixture(scope="module")
def port_slice():
    s = _scene(parse_xml_file)
    cfg = RenderConfig(**{**session.build_config(s).__dict__, **SLICE})
    cs = s.compile(device="cpu")
    return cs, cfg, to_tensors(cs.arrays, "cpu")


@pytest.mark.parametrize("mode", ["diffuse", "caustic"])
def test_photon_pass_matches_reference(ref_slice, port_slice, mode):
    """make_photon_pass on cornell_photon.xml, 4,096 lanes, 2 bounces."""
    rcs, rcfg, rarrays = ref_slice[:3]
    pcs, pcfg, parrays = port_slice
    cdf, total = rpm._light_cdf(rcs.static, rarrays)
    pcdf, ptotal = ppm._light_cdf(pcs.static, pcs.arrays["lights"])
    assert np.array_equal(cdf, pcdf) and total == ptotal
    ref = jax.jit(rshoot.make_photon_pass(rcs.static, rcfg, 4096, 2, mode))(
        rarrays, jnp.asarray(cdf), total, jnp.uint32(5))
    port = pshoot.make_photon_pass(pcs.static, pcfg, 4096, 2, mode)(
        parrays, pcdf, 5)
    rv, pv = np.asarray(ref["valid"]), port["valid"].numpy()
    both = rv & pv
    assert both.sum() > (300 if mode == "diffuse" else 10)
    # a slot agrees if both leave it empty, or both store a photon with
    # the same material and pos/dir/power/normal within rtol 1e-4
    agree = (rv == pv) & ~both
    same = both & np.equal(port["mat"].numpy(), np.asarray(ref["mat"]))
    for k in ("pos", "dir", "power", "normal"):
        same &= np.isclose(port[k].numpy(), np.asarray(ref[k]), rtol=1e-4,
                           atol=1e-5).all(axis=1)
    agree |= same
    assert agree.mean() >= 0.995, ((rv != pv).sum(), (both & ~same).sum())


def test_compaction_and_radiance_map_match_reference(ref_slice, port_slice):
    rmaps = ref_slice[3]
    pcs, pcfg, parrays = port_slice
    pmaps = ppm.build_photon_maps(pcs, pcfg, parrays)
    assert pmaps["n_em_d"] == rmaps[3] and pmaps["n_em_c"] == rmaps[4]
    for name, i in (("diffuse", 0), ("caustic", 1), ("radiance", 2)):
        r, p = rmaps[i], pmaps[name]
        assert set(r) == set(p), name
        rvalid = np.asarray(r["pos_t"])[0] < 1e8
        pvalid = p["pos_t"].numpy()[0] < 1e8
        assert r["pos_t"].shape == tuple(p["pos_t"].shape), name
        assert abs(int(rvalid.sum()) - int(pvalid.sum())) <= \
            0.005 * rvalid.sum(), name
        # compaction keeps record order, so a photon stored on one side only
        # shifts the columns after it: compare the columns before the first
        # such photon, of which >= 99.5% agree within rtol 1e-4, as the
        # slots of the photon records do
        k = int(np.argmax(rvalid != pvalid)) if (rvalid != pvalid).any() \
            else len(rvalid)
        assert k > 0.3 * rvalid.sum(), (name, k)
        agree = np.isclose(p["val"].numpy()[:k], np.asarray(r["val"])[:k],
                           rtol=1e-4, atol=1e-6).all(axis=1)
        for key in ("pos_t", "aux_t"):
            agree &= np.isclose(p[key].numpy()[:, :k],
                                np.asarray(r[key])[:, :k], rtol=1e-4,
                                atol=1e-5).all(axis=0)
        assert agree.mean() >= 0.995, (name, (~agree).sum(), k)
    assert pmaps["info"]["radiance"]["pack"] == rmaps[2]["val"].shape[0]


def test_compact_photons_device():
    rng = np.random.default_rng(3)
    valid = rng.random(50) > 0.5
    rec = dict(pos=rng.random((50, 3)).astype(np.float32),
               mat=np.arange(50, dtype=np.int32), valid=valid)
    ref = rpm.compact_photons_device({k: jnp.asarray(v)
                                      for k, v in rec.items()}, 16)
    port = ppm.compact_photons_device({k: _t(v) for k, v in rec.items()}, 16)
    for k in ref:
        assert np.array_equal(np.asarray(ref[k]), port[k].numpy()), k


@pytest.fixture(scope="module")
def port_render(port_slice):
    pcs, pcfg, _ = port_slice
    return ppm.render_photonmap(pcs, pcfg, device="cpu")


def test_render_photonmap_matches_reference(ref_slice, port_render):
    """The slice as a whole: 16², 1 spp, raydepth 2, photon_bounces 2,
    fg 2, 4,096 photons per map."""
    ref = ref_slice[4]
    img = port_render.image
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.02
    rmse = float(np.sqrt(np.mean((img.astype(np.float64)
                                  - np.asarray(ref.image)) ** 2)))
    assert rmse <= 1e-4, rmse
    r_ref, r_port = ref.stats["rays"], port_render.stats["rays"]
    assert abs(r_port - r_ref) <= 1e-4 * r_ref, (r_ref, r_port)


def test_render_photonmap_without_final_gather_matches_reference(
        ref_slice, port_slice):
    """The slice with finalGather off: every stored hit point takes the
    diffuse map's density (the path of `density_culled` on the card from
    2^20 stored photons), no NEE, no caustic map.  Image RMSE <= 1e-4,
    rays within 0.01%."""
    rcs, rcfg = ref_slice[:2]
    pcs, pcfg, _ = port_slice
    ref = rpm.render_photonmap(rcs, RefConfig(**{**rcfg.__dict__,
                                                 "final_gather": False}))
    port = ppm.render_photonmap(pcs, RenderConfig(**{
        **pcfg.__dict__, "final_gather": False}), device="cpu")
    img = port.image
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.02
    assert port.stats["photon_maps"].get("radiance") is None
    rmse = float(np.sqrt(np.mean((img.astype(np.float64)
                                  - np.asarray(ref.image)) ** 2)))
    assert rmse <= 1e-4, rmse
    r_ref, r_port = ref.stats["rays"], port.stats["rays"]
    assert abs(r_port - r_ref) <= 1e-4 * r_ref, (r_ref, r_port)


def test_render_photonmap_timed_counts_the_same_rays(port_slice,
                                                     port_render):
    pcs, pcfg, _ = port_slice
    timed = ppm.render_photonmap_timed(pcs, pcfg, device="cpu")
    assert timed.stats["rays"] == port_render.stats["rays"] > 0
    assert np.array_equal(timed.image, port_render.image)
    st = timed.stats
    assert st["preprocess_s"] > 0 and st["render_s"] > 0
    assert st["photon_maps"]["diffuse"]["layout"] == "flash"


def test_radiance_pack_keeps_the_flash_layout_on_cpu(port_render):
    """The sorted lookup pack is built for CUDA only: on the CPU the
    radiance map stays the reference's flash pack and nearest_flash its
    plain block sweep."""
    info = port_render.stats["photon_maps"]["radiance"]
    assert info["layout"] == "flash" and info["pack"] % 512 == 0


def test_render_scene_dispatches_on_the_integrator(monkeypatch):
    """render_scene: pathtracing and directlighting -> render,
    photonmapping -> render_photonmap, SPPM -> render_sppm, bidirectional
    -> render_bdpt (render_bdpt_timed when timed), DebugIntegrator ->
    render_debug."""
    from libyafaray_tpu_torch.integrators import (debug, photonmap, render,
                                                  sppm, veach)

    calls = []
    monkeypatch.setattr(render, "render",
                        lambda cs, cfg, device: calls.append(cfg.integrator))
    monkeypatch.setattr(photonmap, "render_photonmap_timed",
                        lambda cs, cfg, device: calls.append(cfg.integrator))
    monkeypatch.setattr(sppm, "render_sppm",
                        lambda cs, cfg, device: calls.append(cfg.integrator))
    monkeypatch.setattr(veach, "render_bdpt",
                        lambda cs, cfg, device: calls.append(cfg.integrator))
    monkeypatch.setattr(veach, "render_bdpt_timed", lambda cs, cfg, device:
                        calls.append(cfg.integrator + " timed"))
    monkeypatch.setattr(debug, "render_debug",
                        lambda cs, cfg, device: calls.append(cfg.integrator))
    for name, timed in (("pathtracing", False), ("photonmapping", True),
                        ("SPPM", False), ("directlighting", False),
                        ("bidirectional", False), ("bidirectional", True),
                        ("DebugIntegrator", False)):
        s = _scene(parse_xml_file)
        s.integrator_params["default"]["type"] = name
        session.render_scene(s, device="cpu", timed=timed)
    assert calls == ["pathtracing", "photonmapping", "SPPM", "directlighting",
                     "bidirectional", "bidirectional timed",
                     "DebugIntegrator"]


def test_pathtracing_raises_on_spheres_and_glass():
    """Spheres and every glass render in pathtracing now: the rough and the
    dispersive glass that this case once asserted raise (ROADMAP item 10)
    replace cornell_photon.xml's glass, and the port's 8², 2 spp path
    tracer matches the reference's: image RMSE <= 1e-4, rays within
    0.01% (tests/test_torch_direct.py's bounds)."""
    from libyafaray_tpu.scene.params import ParamMap as RefParamMap
    from libyafaray_tpu.scene.session import render_scene as ref_scene
    from libyafaray_tpu_torch.scene.params import ParamMap

    for glass in (dict(type="rough_glass", IOR=1.5),
                  dict(type="glass", IOR=1.5, dispersion_power=0.5)):
        out = []
        for parse, pm, run in ((ref_parse, RefParamMap, ref_scene),
                               (parse_xml_file, ParamMap,
                                session.render_scene)):
            s = _scene(parse)
            s.render_params.update(width=8, height=8, AA_minsamples=2)
            s.integrator_params["default"]["type"] = "pathtracing"
            s.create_material("glass", pm(glass))
            out.append(run(s) if run is ref_scene else run(s, device="cpu"))
        ref, port = out
        assert np.isfinite(port.image).all() and port.image.mean() > 0.02
        rmse = float(np.sqrt(np.mean((port.image.astype(np.float64)
                                      - ref.image) ** 2)))
        assert rmse <= 1e-4, (glass, rmse)
        r_ref, r_port = ref.stats["rays"], port.stats["rays"]
        assert abs(r_port - r_ref) <= 1e-4 * r_ref, (glass, r_ref, r_port)