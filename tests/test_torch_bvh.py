"""The port's threaded-BVH route (libyafaray_tpu_torch/accel/bvh.py, the
C++ builder of accel/native.py, the plain walks of ops/bvh_traverse.py and
the compile's "bvh" intersector) against the JAX reference's
(libyafaray_tpu/accel/bvh.py, accel/native.py, ops/bvh_traverse.py), on
the 700-triangle soup and 512 rays of tests/test_accel.py (seeds 42 / 43)
and on the 2,572-triangle grid-spheres scene (--grid 2 --subdiv 2).

Bounds: the builders' arrays equal (native against native, numpy against
numpy).  The walks on the same BVH: hit and tri equal, t within rtol 1e-5
(the reference's step contracts multiply-adds on the CPU), u / v within
atol 1e-5, transmission within atol 1e-6.  Against brute force, the
intersection contract of tests/test_accel.py: hit equal, tri equal but on
exact ties, t within rtol 1e-4, transmission within atol 2e-3.  The CUDA
kernels run only on the card, where chip_smoke.py holds them to these
plain versions bit for bit."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libyafaray_tpu.accel import bvh as ref_bvh
from libyafaray_tpu.ops import bvh_traverse as ref_bt
from libyafaray_tpu.ops import pallas_intersect as pli
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch import convert
from libyafaray_tpu_torch.accel import bvh as port_bvh
from libyafaray_tpu_torch.ops import bvh_traverse as bt
from libyafaray_tpu_torch.ops import fine_intersect as fi
from libyafaray_tpu_torch.ops import intersect as isect
from libyafaray_tpu_torch.scene.generate import write_grid_spheres
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _soup():
    rng = np.random.default_rng(42)
    t = 700
    center = rng.uniform(-1, 1, (t, 3))
    v0 = center + rng.normal(0, 0.08, (t, 3))
    e1 = rng.normal(0, 0.15, (t, 3))
    e2 = rng.normal(0, 0.15, (t, 3))
    return v0.astype(np.float32), e1.astype(np.float32), e2.astype(np.float32)


def _soup_rays():
    rng = np.random.default_rng(43)
    org = rng.uniform(-2, 2, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """name -> (v0, e1, e2, org, dirn): the soup, and the grid scene's
    triangles (the port's compile) with 512 rays from inside its box."""
    path = str(tmp_path_factory.mktemp("grid") / "grid2.xml")
    write_grid_spheres(path, grid=2, subdiv=2, size=16)
    cs = parse_xml_file(path).compile(device="cpu")
    g = cs.arrays["tri_geom_pack"]
    assert g.shape == (2572, 9)
    rng = np.random.default_rng(7)
    lo, hi = np.asarray(cs.bound_min), np.asarray(cs.bound_max)
    org = (lo + rng.random((512, 3)) * (hi - lo)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return {"soup700": (*_soup(), *_soup_rays()),
            "grid2572": (g[:, 0:3], g[:, 3:6], g[:, 6:9], org, d)}


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", ["soup700", "grid2572"])
def test_builders_match_reference(scenes, name, native):
    v0, e1, e2 = scenes[name][:3]
    want = ref_bvh.build_bvh(v0, e1, e2, prefer_native=native)
    got = port_bvh.build_bvh(v0, e1, e2, prefer_native=native)
    assert port_bvh.last_builder == ("native" if native else "numpy")
    assert set(got) == set(want) == set(bt.BVH_KEYS)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    # well formed, as tests/test_accel.py asks
    n = got["bb_min"].shape[0]
    assert np.all(got["hit_next"] < n) and np.all(got["miss_next"] < n)
    leaves = got["first_tri"] >= 0
    assert got["tri_count"][leaves].max() <= port_bvh.LEAF_SIZE
    assert got["tri_count"][leaves].sum() == v0.shape[0]
    assert sorted(got["tri_order"].tolist()) == list(range(v0.shape[0]))


def _walk_inputs(v0, e1, e2):
    bvh = port_bvh.build_bvh(v0, e1, e2)
    tb = {k: torch.from_numpy(v) for k, v in bvh.items()}
    tri9 = torch.from_numpy(np.concatenate([v0, e1, e2], axis=1))
    ref = ({k: jnp.asarray(v) for k, v in bvh.items()},
           dict(v0=jnp.asarray(v0), e1=jnp.asarray(e1), e2=jnp.asarray(e2)))
    return tb, tri9, ref


@pytest.mark.parametrize("name", ["soup700", "grid2572"])
def test_closest_walk_matches_reference_and_brute(scenes, name):
    v0, e1, e2, org, d = scenes[name]
    n = org.shape[0]
    tb, tri9, (rb, rt) = _walk_inputs(v0, e1, e2)
    tmin = torch.full((n,), isect.RAY_EPS)
    tmax = torch.full((n,), float("inf"))
    t, tri, u, v, hit = bt.closest_hit_bvh(tb, tri9, torch.from_numpy(org),
                                           torch.from_numpy(d), tmin, tmax)
    ref = ref_bt.closest_hit_bvh(rb, rt, jnp.asarray(org), jnp.asarray(d))
    assert np.array_equal(hit.numpy(), np.asarray(ref.hit))
    assert hit.any() and not hit.all()
    m = hit.numpy()
    assert np.array_equal(tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_allclose(t.numpy()[m], np.asarray(ref.t)[m], rtol=1e-5)
    np.testing.assert_allclose(u.numpy(), np.asarray(ref.u), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(ref.v), atol=1e-5)
    assert np.all(np.isinf(t.numpy()[~m])) and np.all(tri.numpy()[~m] == 0)
    # brute force over every triangle (the fine kernels' plain version)
    pack = torch.from_numpy(np.concatenate(
        [tri9.numpy().T, np.arange(v0.shape[0], dtype=np.float32)[None]]))
    bt_t, bt_col = fi.closest_fine_plain(pack, torch.from_numpy(org),
                                         torch.from_numpy(d), tmin, tmax,
                                         v0.shape[0])
    assert np.array_equal(torch.isfinite(bt_t).numpy(), m)
    np.testing.assert_allclose(t.numpy()[m], bt_t.numpy()[m], rtol=1e-4)
    tie = t.numpy() == bt_t.numpy()
    assert np.all((tri.numpy() == bt_col.numpy())[m] | tie[m])


@pytest.mark.parametrize("name", ["soup700", "grid2572"])
def test_shadow_walk_matches_reference_and_brute(scenes, name):
    v0, e1, e2, org, d = scenes[name]
    n, nt = org.shape[0], v0.shape[0]
    rng = np.random.default_rng(44)
    filt = (rng.random((nt, 3)) * (rng.random((nt, 1)) > 0.5)).astype(
        np.float32)
    dist = np.full((n,), 2.5, np.float32)
    tb, tri9, (rb, rt) = _walk_inputs(v0, e1, e2)
    lf4 = torch.from_numpy(bt.leaf_lf4(tb, bt.log_filter4(
        torch.from_numpy(filt))))
    tr = bt.shadow_transmission_bvh(tb, tri9, lf4, torch.from_numpy(org),
                                    torch.from_numpy(d),
                                    torch.from_numpy(dist))
    ref = np.asarray(ref_bt.shadow_transmission_bvh(
        rb, rt, jnp.asarray(filt), jnp.asarray(org), jnp.asarray(d),
        jnp.asarray(dist)))
    np.testing.assert_allclose(tr.numpy(), ref, atol=1e-6)
    assert (ref == 0).any(axis=1).any() and (ref == 1).all(axis=1).any()
    assert np.array_equal(tr.numpy() == 0, ref == 0)
    # brute force: the fine shadow sum with the reference's opaque rule
    logf = torch.log(torch.clamp(torch.from_numpy(filt), min=1e-35)).T
    lg = fi.shadow_sum_plain(torch.from_numpy(tri9.numpy().T.copy()),
                             logf.contiguous(), torch.from_numpy(org),
                             torch.from_numpy(d), torch.from_numpy(dist), nt)
    brute = torch.exp(torch.clamp(lg, min=-80.0))
    np.testing.assert_allclose(tr.numpy(), brute.numpy(), atol=2e-3)


def test_walk_counts_and_lanes(scenes):
    """counts=True gives per ray the nodes visited and the triangle tests
    made, and leaves the answers as they are; a lane whose interval is
    empty visits the root alone."""
    v0, e1, e2, org, d = scenes["grid2572"]
    tb, tri9, _ = _walk_inputs(v0, e1, e2)
    o, dd = torch.from_numpy(org), torch.from_numpy(d)
    tmin = torch.full((512,), isect.RAY_EPS)
    tmax = torch.full((512,), float("inf"))
    tmax[:8] = 0.0  # dead lanes: tmin > tmax
    plain = bt.closest_bvh_plain(tb, tri9, o, dd, tmin, tmax)
    counted = bt.closest_bvh_plain(tb, tri9, o, dd, tmin, tmax, counts=True)
    for a, b in zip(plain, counted[:4]):
        assert torch.equal(a, b)
    c = counted[4]
    assert c.shape == (512, 2) and c.dtype == torch.int64
    assert torch.all(c[:8, 0] == 1) and torch.all(c[:8, 1] == 0)
    assert torch.all(torch.isinf(plain[0][:8]))
    assert c[8:, 0].float().mean() > 4 and c[8:, 1].sum() > 0
    lf4 = bt.log_filter4(torch.ones((v0.shape[0], 1)))
    assert torch.equal(lf4, torch.zeros_like(lf4))
    hi = bt.shadow_tmax(torch.full((512,), 3.0))
    lg, blk, sc = bt.shadow_bvh_plain(tb, tri9, lf4, o, dd, hi, counts=True)
    assert not blk.any() and torch.equal(lg, torch.zeros_like(lg))
    assert torch.all(sc[:, 0] >= 1)


def test_wrappers_check_their_inputs(scenes):
    v0, e1, e2, org, d = scenes["soup700"]
    tb, tri9, _ = _walk_inputs(v0, e1, e2)
    o, dd = torch.from_numpy(org), torch.from_numpy(d)
    lo, hi = torch.zeros(512), torch.ones(512)
    with pytest.raises(TypeError, match="hit_next"):
        bt.closest_hit_bvh({**tb, "hit_next": tb["hit_next"].long()}, tri9,
                           o, dd, lo, hi)
    with pytest.raises(ValueError, match="tri9"):
        bt.closest_hit_bvh(tb, tri9[:, :6].contiguous(), o, dd, lo, hi)
    with pytest.raises(ValueError, match="lf4"):
        bt.shadow_logsum_bvh(tb, tri9, torch.zeros((3, 4)), o, dd, hi)
    meta = {k: v.to("meta") for k, v in tb.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        bt.closest_hit_bvh(meta, tri9.to("meta"), o.to("meta"),
                           dd.to("meta"), lo.to("meta"), hi.to("meta"))


def test_compile_builds_the_reference_bvh(monkeypatch):
    """With both packages' budgets cut to one triangle, the port's compile
    of cornell.xml takes the BVH route with the reference's bvh / sbvh, and
    of a scene whose shadow set differs (tests/test_visibility.py's) a
    separate sbvh; neither builds the sub-cluster or 32-column tables."""
    from test_visibility import _scene_xml

    from libyafaray_tpu.scene.xml_parser import parse_xml_string as rps
    from libyafaray_tpu_torch.scene.xml_parser import parse_xml_string

    monkeypatch.setattr(isect, "MAX_TRIS", 1)
    monkeypatch.setattr(pli, "CPU_DENSE_MAX", 1)
    for ref_s, port_s, same in (
            (ref_parse(os.path.join(REPO, "scenes", "cornell.xml")),
             parse_xml_file(os.path.join(REPO, "scenes", "cornell.xml")),
             True),
            (rps(_scene_xml("shadow_only")),
             parse_xml_string(_scene_xml("shadow_only")), False)):
        ref = ref_s.compile()
        port = port_s.compile(device="cpu")
        assert ref.static.intersector == port.static.intersector == "bvh"
        for key in ("bvh", "sbvh"):
            for k in bt.BVH_KEYS:
                assert np.array_equal(port.arrays[key][k],
                                      ref.arrays[key][k]), (key, k)
        assert (port.arrays["sbvh"] is port.arrays["bvh"]) == same
        assert not {"tri_sub8", "tri_box32"} & set(port.arrays)
        st = ref.arrays["stris"]
        ns = port.static.n_stris_real
        np.testing.assert_array_equal(
            port.arrays["stri_geom_pack"],
            np.concatenate([st["v0"], st["e1"], st["e2"]], axis=1)[:ns])
        conv = convert.arrays_from_reference(ref.arrays, "cpu",
                                             n_stris_real=ns)
        for k in ("stri_geom_pack", "sbvh_lf4", "sbvh_lf4_binary"):
            assert torch.equal(conv[k], torch.from_numpy(port.arrays[k])), k


def test_photonmap_on_the_bvh_route_matches_reference(monkeypatch):
    """cornell_photon.xml through photon mapping with both packages on
    their BVH (budgets cut to one triangle): photon shooting, the map
    gathers and the final gather all intersect through the walks.  8², 1
    spp, raydepth 1, photon_bounces 1 (the reference's compile of deeper
    walks costs ~15 s more here), fg 2, 2,048 photons per map; image RMSE
    <= 1e-4, rays within 0.01%."""
    from libyafaray_tpu.integrators import photonmap as rpm
    from libyafaray_tpu.integrators.config import RenderConfig as RefConfig
    from libyafaray_tpu.scene.session import build_config as ref_build
    from libyafaray_tpu_torch.integrators import photonmap as ppm
    from libyafaray_tpu_torch.integrators.config import RenderConfig
    from libyafaray_tpu_torch.scene.session import build_config

    monkeypatch.setattr(isect, "MAX_TRIS", 1)
    monkeypatch.setattr(pli, "CPU_DENSE_MAX", 1)
    over = dict(width=8, height=8, aa_samples=1, raydepth=1,
                photon_bounces=1, fg_samples=2, photons=2048,
                caustic_photons=2048)
    scene = os.path.join(REPO, "scenes", "cornell_photon.xml")
    rs, ps = ref_parse(scene), parse_xml_file(scene)
    for s in (rs, ps):
        s.render_params.update(width=8, height=8)
    rcs = rs.compile()
    pcs = ps.compile(device="cpu")
    assert rcs.static.intersector == pcs.static.intersector == "bvh"
    ref = rpm.render_photonmap(rcs, RefConfig(**{**ref_build(rs).__dict__,
                                                 **over}))
    port = ppm.render_photonmap(pcs, RenderConfig(**{
        **build_config(ps).__dict__, **over}), device="cpu")
    img = port.image
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert img.mean() > 0.02
    rmse = float(np.sqrt(np.mean((img.astype(np.float64)
                                  - np.asarray(ref.image)) ** 2)))
    assert rmse <= 1e-4, rmse
    r_ref, r_port = ref.stats["rays"], port.stats["rays"]
    assert abs(r_port - r_ref) <= 1e-4 * r_ref, (r_ref, r_port)


# ---- the card's layout (pack_bvh, leaf_lf4) ---------------------------------


def _layout_case(name, scenes):
    """(v0, e1, e2) of a layout case: the file's scenes, a random soup, one
    triangle, fewer than LEAF_SIZE, and 40 triangles on one centroid (the
    builders' median split)."""
    if name in scenes:
        return scenes[name][:3]
    rng = np.random.default_rng(11)
    if name == "soup2000":
        v0 = rng.uniform(-3, 3, (2000, 3))
        e1, e2 = rng.normal(0, 0.2, (2, 2000, 3))
    elif name == "one":
        v0, e1, e2 = (np.array([[0.0, 0.0, 1.0]]), np.array([[1.0, 0, 0]]),
                      np.array([[0.0, 1.0, 0]]))
    elif name == "three":
        v0 = rng.uniform(-1, 1, (port_bvh.LEAF_SIZE - 1, 3))
        e1, e2 = rng.normal(0, 0.3, (2, port_bvh.LEAF_SIZE - 1, 3))
    else:  # "centroid40": scaled copies of one triangle about its centroid
        s = rng.uniform(0.5, 2.0, (40, 1))
        a, b, c = (np.array([1.0, 0, 0]), np.array([0, 1.0, 0]),
                   np.array([-1.0, -1.0, 0]))
        v0, e1, e2 = a * s, (b - a) * s, (c - a) * s
    return tuple(np.asarray(x, np.float32) for x in (v0, e1, e2))


LAYOUT_CASES = ["soup700", "grid2572", "soup2000", "one", "three",
                "centroid40"]


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", LAYOUT_CASES)
def test_packed_layout_decodes_to_the_builder_arrays(scenes, name, native):
    """The builders thread their nodes in depth-first pre-order (hit_next
    is node + 1 at an inner node, miss_next at a leaf), and pack_bvh's
    node records, leaf-ordered triangle rows and leaf_lf4's filter rows
    decode bit for bit to BVH_KEYS, tri9 and lf4."""
    v0, e1, e2 = _layout_case(name, scenes)
    bvh = port_bvh.build_bvh(v0, e1, e2, prefer_native=native)
    assert port_bvh.last_builder == ("native" if native else "numpy")
    n, t = bvh["bb_min"].shape[0], v0.shape[0]
    leaf = bvh["first_tri"] >= 0
    node = np.arange(n)
    assert np.array_equal(bvh["hit_next"][~leaf], node[~leaf] + 1)
    assert np.array_equal(bvh["hit_next"][leaf], bvh["miss_next"][leaf])
    if name == "centroid40":
        assert leaf.sum() > 1  # split, by the median branch
    tri9 = np.concatenate([v0, e1, e2], axis=1)
    packed = bt.pack_bvh(bvh, tri9)
    assert set(packed) == set(bt.BVH_KEYS) | set(bt.PACKED_KEYS)
    nodes, tris = packed["nodes"], packed["tris"]
    assert nodes.shape == (n, 8) and nodes.dtype == np.float32
    assert tris.shape == (t, 12) and tris.dtype == np.float32
    bits = nodes.view(np.int32)
    assert np.array_equal(bits[:, 0:3], bvh["bb_min"].view(np.int32))
    assert np.array_equal(bits[:, 4:7], bvh["bb_max"].view(np.int32))
    assert np.array_equal(bits[:, 3], bvh["miss_next"])
    word = bits[:, 7]
    assert np.all(word[~leaf] == -1) and np.all(word[leaf] >= 0)
    assert np.array_equal(word[leaf] >> bt.LEAF_BITS, bvh["first_tri"][leaf])
    assert np.array_equal(word[leaf] & ((1 << bt.LEAF_BITS) - 1),
                          bvh["tri_count"][leaf])
    hit = np.where(word < 0, node + 1, bits[:, 3])
    assert np.array_equal(hit, bvh["hit_next"])
    order = bvh["tri_order"]
    rows = tris.view(np.int32)
    assert np.array_equal(rows[:, 3], order)
    assert np.all(rows[:, [7, 11]] == 0)
    g = tris[:, [0, 1, 2, 4, 5, 6, 8, 9, 10]]
    assert np.array_equal(g.view(np.int32), tri9[order].view(np.int32))
    rng = np.random.default_rng(5)
    lf4 = bt.log_filter4(torch.from_numpy(rng.random((t, 3)).astype(
        np.float32) * (rng.random((t, 1)) > 0.3))).numpy()
    lf_leaf = bt.leaf_lf4(bvh, lf4)
    assert np.array_equal(lf_leaf.view(np.int32), lf4[order].view(np.int32))
    back = np.empty_like(lf_leaf)
    back[order] = lf_leaf
    assert np.array_equal(back.view(np.int32), lf4.view(np.int32))


def test_pack_bvh_raises_where_the_walk_would_go_wrong(scenes):
    """A node order the kernels' implicit hit_next cannot follow, or a
    leaf range outside the triangles, raises: no layout falls back."""
    v0, e1, e2 = scenes["soup700"][:3]
    bvh = port_bvh.build_bvh(v0, e1, e2)
    tri9 = np.concatenate([v0, e1, e2], axis=1)
    inner = int(np.flatnonzero(bvh["first_tri"] < 0)[0])
    moved = dict(bvh, hit_next=bvh["hit_next"].copy())
    moved["hit_next"][inner] = moved["miss_next"][inner]
    with pytest.raises(ValueError, match="pre-order"):
        bt.pack_bvh(moved, tri9)
    leaf = int(np.flatnonzero(bvh["first_tri"] >= 0)[-1])
    wide = dict(bvh, tri_count=bvh["tri_count"].copy())
    wide["tri_count"][leaf] = 8
    with pytest.raises(ValueError, match="leaf"):
        bt.pack_bvh(wide, tri9)
    with pytest.raises(ValueError, match="tri9"):
        bt.pack_bvh(bvh, tri9[:, :6])


def test_wrappers_check_the_packed_rows(scenes):
    """With the packed rows present the CPU wrappers still take the plain
    walks, and check the rows they would hand the card's kernels."""
    v0, e1, e2, org, d = scenes["soup700"]
    tri9_np = np.concatenate([v0, e1, e2], axis=1)
    packed = bt.pack_bvh(port_bvh.build_bvh(v0, e1, e2), tri9_np)
    tb = {k: torch.from_numpy(v) for k, v in packed.items()}
    tri9 = torch.from_numpy(tri9_np)
    o, dd = torch.from_numpy(org), torch.from_numpy(d)
    lo, hi = torch.full((512,), isect.RAY_EPS), torch.full((512,), 3.0)
    plain = bt.closest_bvh_plain(tb, tri9, o, dd, lo, hi)
    got = bt.closest_hit_bvh(tb, tri9, o, dd, lo, hi)
    for a, b in zip(plain, got):
        assert torch.equal(a, b)
    lf4 = torch.from_numpy(bt.leaf_lf4(packed, bt.log_filter4(
        torch.full((v0.shape[0], 1), 0.5))))
    lg, blk = bt.shadow_logsum_bvh(tb, tri9, lf4, o, dd, hi)
    lg0, blk0 = bt.shadow_bvh_plain(tb, tri9, lf4, o, dd, hi)
    assert torch.equal(lg, lg0) and torch.equal(blk, blk0) and (lg < 0).any()
    with pytest.raises(ValueError, match="nodes"):
        bt.closest_hit_bvh({**tb, "nodes": tb["nodes"][:, :4].contiguous()},
                           tri9, o, dd, lo, hi)
    with pytest.raises(ValueError, match="tris"):
        bt.closest_hit_bvh({**tb, "tris": tb["tris"][1:]}, tri9, o, dd, lo,
                           hi)
    with pytest.raises(ValueError, match="lacks"):
        bt.closest_hit_bvh({k: v for k, v in tb.items() if k != "tris"},
                           tri9, o, dd, lo, hi)
