"""The port's large-scene intersection (libyafaray_tpu_torch/ops/
fine_intersect.py: the Morton pack, the sub-cluster boxes, the plain
PyTorch versions of the two CUDA kernels and the closest-hit epilogue)
against the JAX reference's gathered-fine path: `closest_hit_pallas` and
`shadow_transmission_pallas` with their Pallas kernels in interpret mode,
on the 2,304-triangle soup of tests/test_accel.py and on a small generated
grid-spheres scene (scripts/make_large_scene.py --grid 2 --subdiv 2).

Tolerances are the reference's own (tests/test_accel.py): hit and tri equal,
t within rtol 1e-4 (u, v also atol 1e-6), transmission within atol 2e-3.
On the sphere meshes adjacent triangles can give exactly equal t on a shared
edge: the port takes the lowest pack column, the reference's fine kernel the
first-visited group's winner, so there a tri may differ on a lane whose two
triangles' t are exactly equal in the port's arithmetic, and nowhere else.
The kernels themselves run only on the card; chip_smoke.py holds them to
these plain versions there."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libyafaray_tpu.ops import pallas_intersect as pli
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch import convert
from libyafaray_tpu_torch.ops import cuda_intersect as ci
from libyafaray_tpu_torch.ops import fine_intersect as fi
from libyafaray_tpu_torch.ops import intersect as isect

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _soup(n_tris=2304):
    rng = np.random.default_rng(11)
    v0 = rng.uniform(-4, 4, (n_tris, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.3, (n_tris, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.3, (n_tris, 3)).astype(np.float32)
    return v0, e1, e2


def _random_rays(rng, n, center, spread):
    org = (center + (rng.random((n, 3)) - 0.5) * spread).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return org, d


@pytest.fixture(scope="module")
def grid_scene(tmp_path_factory):
    """The reference's compile of a generated 2.6K-triangle grid-spheres
    scene (n_sc = 21 sub-clusters: the fine path)."""
    path = str(tmp_path_factory.mktemp("grid") / "grid2.xml")
    subprocess.run([sys.executable,
                    os.path.join(REPO, "scripts", "make_large_scene.py"),
                    "--grid", "2", "--subdiv", "2", "--size", "32",
                    "--out", path], check=True, capture_output=True)
    return ref_parse(path).compile()


def _grid_rays(cs, rng):
    from libyafaray_tpu.cameras.base import shoot_rays

    cam = cs.camera
    n = 512
    px = (rng.random(n) * cam.resx).astype(np.float32)
    py = (rng.random(n) * cam.resy).astype(np.float32)
    o, d, _ = shoot_rays(cam, jnp.asarray(px), jnp.asarray(py),
                         jnp.zeros(n), jnp.zeros(n))
    o2, d2 = _random_rays(rng, 256, 2.75, 5.0)  # inside the 5.5 room
    return (np.concatenate([np.array(o), o2]),
            np.concatenate([np.array(d), d2]))


@pytest.fixture(scope="module")
def cases(grid_scene):
    """name -> (pack10, cluster8, n_tris, org, dir)."""
    rng = np.random.default_rng(3)
    v0, e1, e2 = _soup()
    pack, cl, _ = ci.build_tri_pack(v0, e1, e2, ci.morton_order(v0, e1, e2))
    o, d = _random_rays(rng, 256, 0.0, 10.0)
    a = grid_scene.arrays
    return {"soup2304": (pack, cl, 2304, o, d),
            "grid2": (a["tri_pack10"], a["tri_cluster8"],
                      grid_scene.static.n_tris_real, *_grid_rays(grid_scene,
                                                                 rng))}


CASES = ("soup2304", "grid2")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_morton_pack_and_boxes_equal_reference():
    v0, e1, e2 = _soup()
    order = ci.morton_order(v0, e1, e2)
    assert np.array_equal(order, pli.morton_order(v0, e1, e2))
    got = ci.build_tri_pack(v0, e1, e2, order)
    want = pli.build_tri_pack(v0, e1, e2, order)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    pack = got[0]
    assert pack.shape == (10, 2304) and got[1].shape == (8, 18)
    sub8 = fi.sub_aabbs(pack, 2304)
    assert np.array_equal(sub8, np.asarray(pli._sub_aabbs(jnp.asarray(pack),
                                                           2304)))
    # padded columns: the last sub-cluster of 2,000 triangles is partly real,
    # the all-pad tail inverted
    sub_p = fi.sub_aabbs(pack, 2000)
    assert np.array_equal(sub_p, np.asarray(pli._sub_aabbs(
        jnp.asarray(pack), 2000)))
    assert np.isinf(sub_p[0:3, 16:]).all() and (sub_p[0:3, 16:] > 0).all()


def test_compile_packs_grid_scene_like_reference(tmp_path):
    """The port's compile of a generated grid scene gives the reference's
    Morton pack, cluster boxes and shadow filters, and sub-cluster boxes
    equal to the reference's `_sub_aabbs` of that pack."""
    from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

    path = str(tmp_path / "grid2.xml")
    subprocess.run([sys.executable,
                    os.path.join(REPO, "scripts", "make_large_scene.py"),
                    "--grid", "2", "--subdiv", "2", "--out", path],
                   check=True, capture_output=True)
    ref = ref_parse(path).compile()
    port = parse_xml_file(path).compile(device="cpu")
    n = ref.static.n_tris_real
    assert port.static.n_tris_real == n == 2572
    for k in ("tri_pack10", "tri_cluster8", "stri_pack10", "stri_cluster8",
              "sfilt4", "sfilt4_binary"):
        assert np.array_equal(port.arrays[k], ref.arrays[k]), k
    want = np.asarray(pli._sub_aabbs(jnp.asarray(ref.arrays["tri_pack10"]),
                                     n))
    assert port.arrays["tri_sub8"].shape == (8, 21)
    assert np.array_equal(port.arrays["tri_sub8"], want)
    conv = convert.arrays_from_reference(ref.arrays, "cpu")
    for k in ("tri_sub8", "stri_sub8"):
        assert torch.equal(conv[k], torch.tensor(want)), k


def _reference_closest(pack, cl, n_tris, o, d, tmin, tmax):
    pli.INTERPRET = True
    try:
        return [np.asarray(x) for x in pli.closest_hit_pallas(
            jnp.asarray(pack), jnp.asarray(cl), jnp.asarray(o),
            jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax),
            n_tris=n_tris)]
    finally:
        pli.INTERPRET = False


@pytest.mark.parametrize("case", CASES)
def test_closest_plain_matches_reference_fine(cases, case):
    pack, cl, n_tris, o, d = cases[case]
    assert fi.takes_fine_path(pack.shape[1], cl.shape[1])
    n = o.shape[0]
    tmin = np.full(n, 5e-5, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    tmax[::7] = 1.5  # some finite segments
    tmax[::11] = -1.0  # dead lanes: empty interval
    sub8 = fi.sub_aabbs(pack, n_tris)
    tc, col = fi.closest_hit_fine(_t(pack), _t(cl), _t(sub8), _t(o), _t(d),
                                  _t(tmin), _t(tmax), n_tris)
    t, tri, u, v, hit = (x.numpy() for x in fi.closest_epilogue(
        _t(pack), _t(o), _t(d), tc, col, n_tris))
    assert np.array_equal(t, tc.numpy())  # the epilogue keeps the t
    rt, rtri, ru, rv, rhit = _reference_closest(pack, cl, n_tris, o, d, tmin,
                                                tmax)
    assert hit.any() and not hit.all() and not hit[::11].any()
    assert np.array_equal(hit, rhit)
    m = rhit
    assert np.allclose(t[m], rt[m], rtol=1e-4)
    flip = m & (tri != rtri)
    if case == "soup2304":
        assert not flip.any()
    else:
        # a flip is a tie: the reference's triangle gives the port's t
        # exactly, and its column lies above the port's
        inv = np.empty(n_tris, np.int64)
        inv[pack[9, :n_tris].astype(np.int64)] = np.arange(n_tris)
        rcol = inv[rtri[flip]]
        c10 = _t(pack[:, rcol])
        t_ref, _, _, ok = ci._mt_test(c10, slice(None),
                                      *_t(o[flip]).unbind(-1),
                                      *_t(d[flip]).unbind(-1))
        assert ok.all() and np.array_equal(t_ref.numpy(), t[flip])
        assert (rcol > col.numpy()[flip]).all()
        assert flip.sum() <= 0.02 * m.sum(), (flip.sum(), m.sum())
    keep = m & ~flip
    for a, b in ((u, ru), (v, rv)):
        assert np.allclose(a[keep], b[keep], rtol=1e-4, atol=1e-6)


def _walk_closest(pk, cl8, sub8, n_tris, o, d, lo, hi):
    """One ray through the card kernel's walk, in plain PyTorch: clusters
    by entry distance, a box skipped only when its entry lies beyond
    min(tmax, best t) (entry == best is visited), the same for the picked
    cluster's sub-boxes; 32 lanes take a sub-cluster's columns k, k + 32,
    ..., each keeping its own lexicographic minimum (t, column), reduced
    over the lanes at the end.  Returns (t, col, sub-clusters visited)."""
    spc = sub8.shape[1] // cl8.shape[1]
    sc_real = -(-n_tris // fi.SUB_BT)
    cl_real = -(-sc_real // spc)
    inf = float("inf")
    lane_t = torch.full((32,), inf)
    lane_c = torch.full((32,), 2 ** 31 - 1, dtype=torch.int64)
    lim, visited = float(hi), 0
    ent = fi.box_entry(cl8[:, :cl_real], o, d, lo, hi)[0]
    for c in torch.argsort(ent, stable=True).tolist():
        if not ent[c] <= lim or torch.isinf(ent[c]):
            break
        j0 = c * spc
        j1 = min(j0 + spc, sc_real)
        sub = fi.box_entry(sub8[:, j0:j1], o, d, lo, torch.tensor([lim]))[0]
        for b in torch.argsort(sub, stable=True).tolist():
            if not sub[b] <= lim or torch.isinf(sub[b]):
                break
            visited += 1
            k0 = (j0 + b) * fi.SUB_BT
            k = torch.arange(k0, k0 + fi.SUB_BT)
            t, _, _, ok = ci._mt_test(pk, slice(k0, k0 + fi.SUB_BT), *o[0],
                                      *d[0])
            t = torch.where(ok & (t > lo) & (t < hi) & (k < n_tris), t, inf)
            for row_t, row_k in zip(t.reshape(-1, 32), k.reshape(-1, 32)):
                # sub-clusters are not met in column order: on equal t
                # the lower column wins
                better = (row_t < lane_t) | ((row_t == lane_t)
                                             & (row_k < lane_c)
                                             & (row_t < inf))
                lane_t = torch.where(better, row_t, lane_t)
                lane_c = torch.where(better, row_k, lane_c)
            lim = min(float(hi), float(lane_t.amin()))
    best = float(lane_t.amin())
    if best == inf:
        return best, 0, visited
    return best, int(lane_c[lane_t == best].amin()), visited


def _edge_rays(pack, n_tris, n, rng):
    """Rays from inside the room through a point of an edge (v0, v0 + e1)
    of n random triangles, the vertex v0 for every other one: where
    triangles of a sphere mesh share it, each gives a hit there."""
    k = rng.choice(n_tris, n, replace=False)
    mid = (pack[0:3, k] + 0.5 * (np.arange(n) % 2) * pack[3:6, k]).T
    org = np.tile(np.float32([2.75, 2.75, 2.75]), (n, 1))
    org += rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    d = mid - org
    return org, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


@pytest.mark.parametrize("case", CASES)
def test_walk_rule_gives_the_plain_answer(cases, case):
    """The near-first walk with its skip rule and the lexicographic
    (t, column) minimum gives closest_fine_plain's (t, col) exactly, ties
    on shared edges included, and visits fewer sub-clusters than the pack
    holds."""
    pack, cl, n_tris, o, d = cases[case]
    rng = np.random.default_rng(23)
    keep = rng.choice(o.shape[0], 96, replace=False)
    o, d = o[keep], d[keep]
    if case == "grid2":
        eo, ed = _edge_rays(pack, n_tris, 400, rng)
        o, d = np.concatenate([o, eo]), np.concatenate([d, ed])
    n = o.shape[0]
    tmin = np.full(n, 5e-5, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    tmax[::7] = 1.5
    tmax[::11] = -1.0
    pk, c8 = _t(pack), _t(cl)
    sub8 = _t(fi.sub_aabbs(pack, n_tris))
    args = [_t(x) for x in (o, d, tmin, tmax)]
    pt, pcol = fi.closest_fine_plain(pk, *args, n_tris)
    visited = 0
    for i in range(n):
        t, col, v = _walk_closest(pk, c8, sub8, n_tris,
                                  *(x[i:i + 1] for x in args))
        assert (t, col) == (float(pt[i]), int(pcol[i])), i
        visited += v
    hit = torch.isfinite(pt)
    assert hit.any() and not hit.all()
    assert visited < 0.5 * n * sub8.shape[1]
    if case == "grid2":
        # some of the edge rays are exact ties between two columns
        ox, oy, oz = (x[:, None] for x in args[0].unbind(-1))
        dx, dy, dz = (x[:, None] for x in args[1].unbind(-1))
        t_all, _, _, ok = ci._mt_test(pk, slice(0, n_tris), ox, oy, oz, dx,
                                      dy, dz)
        tied = (ok & (t_all == pt[:, None])).sum(dim=1) > 1
        assert int((tied & hit).sum()) >= 3, int((tied & hit).sum())


@pytest.mark.parametrize("case", CASES)
def test_shadow_plain_matches_reference_fine(cases, case):
    pack, cl, n_tris, o, d = cases[case]
    n = o.shape[0]
    rng = np.random.default_rng(5)
    dist = rng.uniform(0.5, 12.0, n).astype(np.float32)
    dist[::9] = -1.0  # dead lanes: empty segment
    tp = pack.shape[1]
    filt4 = np.zeros((4, tp), np.float32)
    filt4[:3, :n_tris] = (rng.random((3, n_tris))
                          * (rng.random((1, n_tris)) > 0.5))
    tr = fi.shadow_transmission_fine(
        _t(pack), _t(cl), _t(fi.sub_aabbs(pack, n_tris)), _t(filt4), _t(o),
        _t(d), _t(dist), n_tris).numpy()
    pli.INTERPRET = True
    try:
        rtr = np.asarray(pli.shadow_transmission_pallas(
            jnp.asarray(pack), jnp.asarray(cl), jnp.asarray(filt4),
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(dist),
            n_tris=n_tris))
    finally:
        pli.INTERPRET = False
    assert np.allclose(tr, rtr, atol=2e-3)
    assert (tr[::9] == 1.0).all()
    assert (tr < 1e-30).any() and ((tr > 0.01) & (tr < 0.99)).any()


def _lane_tree_sum(terms):
    """(M, 128, 3) per-column terms of one tile -> (M, 3), added as the card
    kernels add them: lane l of 32 sums its columns l, l + 32, l + 64,
    l + 96 in rising order from 0, then the lanes are added by the xor tree
    (offsets 16, 8, 4, 2, 1) and lane 0 holds the tile's sum."""
    lanes = torch.zeros((terms.shape[0], 32, 3))
    for q in range(fi.SUB_BT // 32):
        lanes = lanes + terms[:, 32 * q:32 * q + 32]
    idx = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ off]
    return lanes[:, 0]


def _tile_terms(pk, logf, j, n_tris, o, d, hi):
    """(M, 128, 3) log-filter terms of tile j's columns for M segments: the
    column's log filter where the segment crosses its triangle, else 0;
    columns past n_tris are never tested (0)."""
    k0, k1 = j * fi.SUB_BT, min((j + 1) * fi.SUB_BT, n_tris)
    t, _, _, ok = ci._mt_test(pk, slice(k0, k1),
                              *(o[:, a:a + 1] for a in range(3)),
                              *(d[:, a:a + 1] for a in range(3)))
    crossed = ok & (t > ci.SHADOW_TMIN) & (t < hi[:, None])
    terms = torch.zeros((o.shape[0], fi.SUB_BT, 3))
    terms[:, :k1 - k0] = torch.where(crossed[..., None],
                                     logf[:3, k0:k1].T[None], 0.0)
    return terms, k1 - k0


def _walk_shadow(pk, cl8, sub8, logf, o, d, dist, n_tris, floor=True):
    """The card kernel's shadow walk in plain PyTorch: tiles (128-column
    sub-clusters) in pack order; a ray takes a tile when its segment enters
    the tile's cluster box and the tile's own box, both widened by 1e-5;
    pad tiles are never visited; a ray whose three sums are <= -80 takes no
    further tile (with `floor`); a tile's sum is `_lane_tree_sum`'s and is
    added to the ray's running sum.  Returns (sums, floored at -80 with
    `floor`; pair tests made; (ray, tile) items the opaque exit skipped)."""
    spc = sub8.shape[1] // cl8.shape[1]
    sc_real = -(-n_tris // fi.SUB_BT)
    cl_real = -(-sc_real // spc)
    lo, hi = ci.SHADOW_TMIN * torch.ones_like(dist), (
        dist * (1.0 - 1e-4) - ci.SHADOW_TMIN)
    c_in = torch.isfinite(fi.box_entry(cl8[:, :cl_real], o, d, lo, hi))
    s_in = torch.isfinite(fi.box_entry(sub8[:, :sc_real], o, d, lo, hi))
    acc = torch.zeros((o.shape[0], 3))
    pairs = skipped = 0
    for j in range(sc_real):
        takers = c_in[:, j // spc] & s_in[:, j]
        if floor:
            done = (acc <= fi.LOG_FLOOR).all(dim=1)
            skipped += int((takers & done).sum())
            takers = takers & ~done
        idx = torch.nonzero(takers).squeeze(1)
        if idx.numel():
            terms, ncols = _tile_terms(pk, logf, j, n_tris, o[idx], d[idx],
                                       hi[idx])
            acc[idx] = acc[idx] + _lane_tree_sum(terms)
            pairs += idx.numel() * ncols
    return (acc.clamp(min=fi.LOG_FLOOR) if floor else acc), pairs, skipped


def _regroup(pack, n_tris, spc):
    """Cluster boxes over spc tiles each (the pack's own clusters are one
    tile wide below 32,769 triangles): the two-level walk a large pack
    gets, on a small one."""
    return ci._column_boxes(pack, n_tris, spc * fi.SUB_BT)


def _filters(kind, n_tris, tp, rng):
    """(4, T') filter rows in pack order: 0 or 1 (`binary`, log filters 0
    or -80: every sum exact), all 0 (`opaque`), or a random colour on half
    of the triangles and 0 on the rest (`partial`)."""
    filt4 = np.zeros((4, tp), np.float32)
    if kind == "binary":
        filt4[:3, :n_tris] = rng.random((1, n_tris)) > 0.5
    elif kind == "partial":
        filt4[:3, :n_tris] = (rng.random((3, n_tris))
                              * (rng.random((1, n_tris)) > 0.5))
    return filt4


# (case, triangles counted as real or None for all, tiles per cluster)
WALKS = [("soup2304", None, 1), ("soup2304", None, 6), ("soup2304", None, 18),
         ("soup2304", 2000, 6), ("grid2", None, 1), ("grid2", None, 3)]


@pytest.mark.parametrize("kind", ["binary", "opaque", "partial"])
@pytest.mark.parametrize("case, real, spc", WALKS)
def test_shadow_tile_walk_gives_the_plain_sum(cases, case, real, spc, kind):
    """The kernel's tile walk (cluster and sub-box skips, pad tiles never
    visited, the -80 exit, dead lanes, lane-then-tree sums) against the
    brute force: equal bit for bit where every log filter is 0 or -80,
    transmission within atol 2e-3 (log sums within 1e-4) otherwise."""
    pack, _, n_tris, o, d = cases[case]
    n_tris = real or n_tris
    rng = np.random.default_rng(5)
    dist = rng.uniform(0.5, 12.0, o.shape[0]).astype(np.float32)
    dist[::9] = -1.0  # dead lanes: empty segment
    pk = _t(pack)
    logf = ci.log_filter(_t(_filters(kind, n_tris, pack.shape[1], rng)))
    sub8 = _t(fi.sub_aabbs(pack, n_tris))
    cl8 = _t(_regroup(pack, n_tris, spc))
    rays = (_t(o), _t(d), _t(dist))
    want = fi.shadow_logsum_fine_plain(pk, logf, *rays, n_tris)
    got, pairs, skipped = _walk_shadow(pk, cl8, sub8, logf, *rays, n_tris)
    assert (got[::9] == 0.0).all()
    assert 0 < pairs < 0.5 * o.shape[0] * n_tris
    if kind == "partial":
        assert torch.allclose(got, want, atol=1e-4, rtol=1e-6)
        assert torch.allclose(torch.exp(got), torch.exp(want), atol=2e-3)
        assert ((got < 0) & (got > -80)).any()
    else:
        assert torch.equal(got, want)
        assert (got == -80.0).any() and skipped > 0
    # without the exit the walk tests what the bound's count says it needs
    lo, hi = ci.SHADOW_TMIN * torch.ones_like(rays[2]), (
        rays[2] * (1.0 - 1e-4) - ci.SHADOW_TMIN)
    raw, all_pairs, none = _walk_shadow(pk, cl8, sub8, logf, *rays, n_tris,
                                        floor=False)
    assert all_pairs == fi.fine_pair_tests(cl8, sub8, rays[0], rays[1], lo,
                                           hi, n_tris)[0]
    assert none == 0 and pairs <= all_pairs
    assert torch.equal(raw.clamp(min=-80.0), got) or kind == "partial"


@pytest.mark.parametrize("batch", ["empty", "dead"])
def test_shadow_tile_walk_takes_empty_and_dead_batches(cases, batch):
    """No rays, or only dead lanes (dist < 0): nothing is entered, no pair
    is tested, every sum is 0, in the walk and in the plain version."""
    pack, cl, n_tris, o, d = cases["soup2304"]
    n = 0 if batch == "empty" else 40
    pk, sub8 = _t(pack), _t(fi.sub_aabbs(pack, n_tris))
    logf = ci.log_filter(torch.zeros((4, pack.shape[1])))
    rays = (_t(o[:n]), _t(d[:n]), torch.full((n,), -1.0))
    got, pairs, _ = _walk_shadow(pk, _t(cl), sub8, logf, *rays, n_tris)
    want = fi.shadow_logsum_fine(pk, _t(cl), sub8, logf, *rays, n_tris)
    assert got.shape == want.shape == (n, 3) and pairs == 0
    assert torch.equal(got, want) and not got.any()


def test_shadow_plain_floors_at_opaque():
    """Every log filter is <= 0, so one floor at -80 after the sum is the
    reference's per-group floor: three opaque triangles on one segment
    give exactly -80, not -240."""
    v0 = np.array([[0, 0, z] for z in (1.0, 2.0, 3.0)], np.float32) - 0.5
    e1 = np.tile(np.float32([[2, 0, 0]]), (3, 1))
    e2 = np.tile(np.float32([[0, 2, 0]]), (3, 1))
    pack, _, _ = ci.build_tri_pack(v0, e1, e2)
    logf = ci.log_filter(torch.zeros((4, pack.shape[1])))
    lg = fi.shadow_logsum_fine_plain(
        _t(pack), logf, torch.tensor([[0.0, 0.0, 0.0]]),
        torch.tensor([[0.0, 0.0, 1.0]]), torch.tensor([5.0]), 3)
    assert torch.equal(lg, torch.full((1, 3), -80.0))


@pytest.mark.parametrize("n_tris, route", [
    (64, "tiny"), (65, "dense"), (384, "dense"), (385, "stream"),
    (896, "stream"), (897, "fine"), (2304, "fine")])
def test_dispatch_boundaries(monkeypatch, n_tris, route):
    """The reference's routing by pack shape: <= 64 triangles the tiny
    kernels; fewer than 4 clusters the dense kernels and 4 or more with
    fewer than 8 sub-clusters the streaming kernels (ops/
    cluster_intersect.py); from 897 triangles (8 sub-clusters) the fine
    kernels."""
    from libyafaray_tpu_torch.ops import cluster_intersect as cx
    from libyafaray_tpu_torch.scene.scene import SceneStatic

    v0, e1, e2 = (x[:n_tris] for x in _soup())
    pack, cl, _ = ci.build_tri_pack(v0, e1, e2)
    sub8 = fi.sub_aabbs(pack, n_tris)
    box32 = cx.quarter_boxes(pack, n_tris)
    arrays = {"tri_pack10": _t(pack), "stri_pack10": _t(pack),
              "tri_cluster8": _t(cl), "stri_cluster8": _t(cl),
              "tri_sub8": _t(sub8), "stri_sub8": _t(sub8),
              "tri_box32": _t(box32), "stri_box32": _t(box32),
              "sfilt4": torch.zeros((4, pack.shape[1])),
              "sfilt4_binary": torch.zeros((4, pack.shape[1]))}
    static = SceneStatic(n_tris_real=n_tris, n_stris_real=n_tris, lights=(),
                         bg=None, mat_families=(), has_blend=0,
                         ray_min_dist=5e-5, shadow_bias=5e-4,
                         intersector="brute", chunk=8)
    called = []
    for mod, name in ((ci, "closest_hit_tiny_plain"),
                      (ci, "shadow_logsum_tiny_plain"),
                      (fi, "closest_fine_plain"),
                      (fi, "shadow_logsum_fine_plain"),
                      (cx, "closest_dense_plain"),
                      (cx, "shadow_logsum_dense_plain"),
                      (cx, "closest_stream_plain"),
                      (cx, "shadow_logsum_stream_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, fn=fn, name=name: (
            called.append(name), fn(*a))[1])
    o, d = _random_rays(np.random.default_rng(1), 16, 0.0, 6.0)
    args = (_t(o), _t(d))
    lim = (torch.full((16,), 5e-5), torch.full((16,), float("inf")))
    assert isect.route(_t(pack), _t(cl), n_tris) == route
    hit = isect.closest_hit(arrays, static, *args, *lim)
    tr = isect.shadow_transmission(arrays, static, False, *args,
                                   torch.full((16,), 3.0))
    assert hit.t.shape == (16,) and tr.shape == (16, 3)
    assert all(route in name for name in called) and len(called) == 2


def test_fine_wrapper_routes_cpu_to_plain_and_counts_nothing(cases):
    pack, cl, n_tris, o, d = cases["soup2304"]
    n = o.shape[0]
    sub8 = _t(fi.sub_aabbs(pack, n_tris))
    lim = (torch.full((n,), 5e-5), torch.full((n,), float("inf")))
    before = (fi.closest_hit_fine.launches, fi.shadow_logsum_fine.launches)
    got = fi.closest_hit_fine(_t(pack), _t(cl), sub8, _t(o), _t(d), *lim,
                              n_tris)
    want = fi.closest_fine_plain(_t(pack), _t(o), _t(d), *lim, n_tris)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    logf = torch.zeros((3, pack.shape[1]))
    fi.shadow_logsum_fine(_t(pack), _t(cl), sub8, logf, _t(o), _t(d),
                          torch.ones(n), n_tris)
    assert (fi.closest_hit_fine.launches,
            fi.shadow_logsum_fine.launches) == before


def test_fine_wrapper_rejects_bad_inputs(cases):
    pack, cl, n_tris, o, d = cases["soup2304"]
    n = o.shape[0]
    pk, c8 = _t(pack), _t(cl)
    sub8 = _t(fi.sub_aabbs(pack, n_tris))
    org, dirn = _t(o), _t(d)
    lim = torch.zeros(n)
    with pytest.raises(ValueError, match="shape"):  # sub table of other width
        fi.closest_hit_fine(pk, c8, sub8[:, :-1].contiguous(), org, dirn,
                            lim, lim, n_tris)
    with pytest.raises(ValueError, match="clusters"):  # 18 sub-clusters in 5
        fi.closest_hit_fine(pk, torch.zeros((8, 5)), sub8, org, dirn, lim,
                            lim, n_tris)
    with pytest.raises(ValueError, match="n_tris"):
        fi.closest_hit_fine(pk, c8, sub8, org, dirn, lim, lim,
                            pack.shape[1] + 1)
    with pytest.raises(TypeError):
        fi.closest_hit_fine(pk, c8, sub8, org.double(), dirn, lim, lim,
                            n_tris)
    with pytest.raises(ValueError, match="rgb rows"):
        fi.shadow_logsum_fine(pk, c8, sub8, torch.zeros(2, pack.shape[1]),
                              org, dirn, lim, n_tris)
