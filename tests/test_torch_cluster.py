"""The port's mid-size-scene intersection (libyafaray_tpu_torch/ops/
cluster_intersect.py: the plain PyTorch versions of the dense and
streaming CUDA kernels, their wrappers on the CPU, and the routing in
ops/intersect.py) against the JAX reference's `closest_hit_pallas` and
`shadow_transmission_pallas` with their Pallas kernels in interpret mode
(`_closest_kernel` / `_shadow_kernel` below 4 clusters,
`_closest_kernel_stream` / `_shadow_kernel_stream` from 4 clusters with
fewer than 8 sub-clusters).

Packs: the generated 172-triangle scene (--grid 1 --subdiv 1, 2 clusters:
dense), the 652-triangle one (--grid 2 --subdiv 1, 6 clusters: stream), a
300-triangle soup (3 clusters: dense) and a 400-triangle soup (4 clusters:
stream), 1,024 rays each from numpy with a fixed seed.  Tolerances are the
reference's own (tests/test_accel.py): hit and tri equal, t within rtol
1e-4, transmission within atol 2e-3.  On the stream packs a lane whose two
triangles give exactly equal t may differ in tri (the reference keeps the
first visited cluster's column, the port the lowest column), and nowhere
else.  The kernels themselves run only on the card; chip_smoke.py holds
them to these plain versions there.  Here the walks of the kernels that
skip by boxes of column groups are emulated in plain PyTorch and held to
the plain versions bit for bit: `closest_hit_stream` (a warp a ray over
the 32-column quarter boxes), the column walk of the three shadow sums
(csrc/column_walk.cuh: several rays a thread; `shadow_logsum_dense` and
`shadow_logsum_stream` over the quarter boxes, the latter with its opaque
stop, and `shadow_logsum_tiny` over 2-column boxes on the Cornell box's
pack and a 64-triangle soup) and the closest walk of the same header
(`closest_hit_tiny` over the 2-column boxes, `closest_hit_dense` over
16-column boxes: a ray's nearest group by its thread, its other groups as
items the block's threads share)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libyafaray_tpu.ops import pallas_intersect as pli
from libyafaray_tpu.scene.xml_parser import parse_xml_string as ref_parse
from libyafaray_tpu_torch.ops import cluster_intersect as cl
from libyafaray_tpu_torch.ops import cuda_intersect as ci
from libyafaray_tpu_torch.ops import fine_intersect as fi
from libyafaray_tpu_torch.ops import intersect as isect
from libyafaray_tpu_torch.scene.generate import grid_spheres_xml
from libyafaray_tpu_torch.scene.xml_parser import (parse_xml_file,
                                                   parse_xml_string)

N_RAYS = 1024
ROOM = 5.5
CAMERA = (2.75, -7.5, 3.025)  # the generated scenes' camera position
KIND = {"grid1": "dense", "grid2": "stream", "soup300": "dense",
        "soup400": "stream"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions are many small tensor ops: one CPU thread runs
    them fastest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _scene_rays(rng, n=N_RAYS):
    """Half from the camera towards points in the room, half from points
    in the room in random directions."""
    h = n // 2
    target = rng.uniform(0.0, ROOM, (h, 3))
    d_cam = target - np.asarray(CAMERA)
    d_cam /= np.linalg.norm(d_cam, axis=1, keepdims=True)
    o_in = rng.uniform(0.2, ROOM - 0.2, (n - h, 3))
    org = np.concatenate([np.tile(np.float32(CAMERA), (h, 1)), o_in])
    return (org.astype(np.float32),
            np.concatenate([d_cam.astype(np.float32), _unit(rng, n - h)]))


def _soup(n_tris, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-4, 4, (n_tris, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.4, (n_tris, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.4, (n_tris, 3)).astype(np.float32)
    return ci.build_tri_pack(v0, e1, e2, ci.morton_order(v0, e1, e2))[:2]


@pytest.fixture(scope="module")
def scenes():
    """The reference's compile of the two generated scenes."""
    return {f"grid{g}": ref_parse(grid_spheres_xml(g, 1, 2, 16)).compile()
            for g in (1, 2)}


@pytest.fixture(scope="module")
def cases(scenes):
    """name -> (pack10, cluster8, n_tris, org, dir)."""
    rng = np.random.default_rng(7)
    out = {}
    for name, cs in scenes.items():
        out[name] = (cs.arrays["tri_pack10"], cs.arrays["tri_cluster8"],
                     cs.static.n_tris_real, *_scene_rays(rng))
    for n_tris, seed in ((300, 13), (400, 17)):
        pack, c8 = _soup(n_tris, seed)
        o = (rng.random((N_RAYS, 3)) - 0.5) * 10.0
        out[f"soup{n_tris}"] = (pack, c8, n_tris, o.astype(np.float32),
                                _unit(rng, N_RAYS))
    return out


def _box32(pack, n_tris):
    return _t(cl.quarter_boxes(pack, n_tris))


def _closest_scene(kind, pack, c8, n_tris):
    """The scene arguments closest_hit_<kind> takes before the rays."""
    if kind == "stream":
        return _t(pack), _t(c8), _box32(pack, n_tris)
    return _t(pack), _t(c8)


def _shadow_scene(pack, c8, n_tris):
    """The scene arguments shadow_logsum_<kind> (and shadow_transmission_
    <kind>) take before the filters."""
    return _t(pack), _t(c8), _box32(pack, n_tris)


@pytest.mark.parametrize("grid, pack_w, n_cl", [(1, 256, 2), (2, 768, 6)])
def test_compile_packs_generated_scene_like_reference(scenes, grid, pack_w,
                                                      n_cl):
    """The port's compile of a generated mid-size scene gives the
    reference's pack, cluster boxes and shadow filters, and the quarter
    boxes of its pack."""
    ref = scenes[f"grid{grid}"]
    port = parse_xml_string(grid_spheres_xml(grid, 1, 2, 16)).compile(
        device="cpu")
    assert port.static.n_tris_real == ref.static.n_tris_real
    assert port.arrays["tri_pack10"].shape == (10, pack_w)
    assert port.arrays["tri_cluster8"].shape == (8, n_cl)
    for k in ("tri_pack10", "tri_cluster8", "stri_pack10", "stri_cluster8",
              "sfilt4", "sfilt4_binary"):
        assert np.array_equal(port.arrays[k], ref.arrays[k]), k
    box32 = port.arrays["tri_box32"]
    assert box32.shape == (8, pack_w // 32)
    assert np.array_equal(box32, cl.quarter_boxes(ref.arrays["tri_pack10"],
                                                  ref.static.n_tris_real))
    assert port.arrays["stri_box32"] is box32


def _limits(n):
    tmin = np.full(n, 5e-5, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    tmax[::7] = 1.5  # some finite segments
    tmax[::11] = -1.0  # dead lanes: empty interval
    return tmin, tmax


@pytest.mark.parametrize("case", tuple(KIND))
def test_closest_plain_matches_reference(cases, case):
    pack, c8, n_tris, o, d = cases[case]
    kind = KIND[case]
    assert isect.route(pack, c8, n_tris) == kind
    tmin, tmax = _limits(o.shape[0])
    wrapper = getattr(cl, f"closest_hit_{kind}")
    tc, col = wrapper(*_closest_scene(kind, pack, c8, n_tris), _t(o), _t(d),
                      _t(tmin), _t(tmax), n_tris)
    t, tri, u, v, hit = (x.numpy() for x in fi.closest_epilogue(
        _t(pack), _t(o), _t(d), tc, col, n_tris))
    assert np.array_equal(t, tc.numpy())  # the epilogue keeps the t
    pli.INTERPRET = True
    try:
        ref = pli.closest_hit_pallas(
            jnp.asarray(pack), jnp.asarray(c8), jnp.asarray(o),
            jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax),
            n_tris=n_tris)
        rt, rtri, ru, rv, rhit = (np.asarray(x) for x in ref)
    finally:
        pli.INTERPRET = False
    assert hit.any() and not hit.all() and not hit[::11].any()
    assert np.array_equal(hit, rhit)
    m = rhit
    assert np.allclose(t[m], rt[m], rtol=1e-4)
    flip = m & (tri != rtri)
    if kind == "dense":
        assert not flip.any()  # the dense kernel keeps the lowest column too
    else:
        # a flip is a tie: the reference's triangle gives the port's t
        # exactly, and its column lies above the port's
        inv = np.empty(n_tris, np.int64)
        inv[pack[9, :n_tris].astype(np.int64)] = np.arange(n_tris)
        rcol = inv[rtri[flip]]
        t_ref, _, _, ok = ci._mt_test(_t(pack[:, rcol]), slice(None),
                                      *_t(o[flip]).unbind(-1),
                                      *_t(d[flip]).unbind(-1))
        assert ok.all() and np.array_equal(t_ref.numpy(), t[flip])
        assert (rcol > col.numpy()[flip]).all()
        assert flip.sum() <= 0.02 * m.sum(), (flip.sum(), m.sum())
    keep = m & ~flip
    for a, b in ((u, ru), (v, rv)):
        assert np.allclose(a[keep], b[keep], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("case", tuple(KIND))
def test_shadow_plain_matches_reference(cases, case):
    pack, c8, n_tris, o, d = cases[case]
    kind = KIND[case]
    n = o.shape[0]
    rng = np.random.default_rng(5)
    dist = rng.uniform(0.5, 12.0, n).astype(np.float32)
    dist[::9] = -1.0  # dead lanes: empty segment
    filt4 = np.zeros((4, pack.shape[1]), np.float32)
    filt4[:3, :n_tris] = (rng.random((3, n_tris))
                          * (rng.random((1, n_tris)) > 0.5))
    wrapper = getattr(cl, f"shadow_transmission_{kind}")
    tr = wrapper(*_shadow_scene(pack, c8, n_tris), _t(filt4), _t(o),
                 _t(d), _t(dist), n_tris).numpy()
    pli.INTERPRET = True
    try:
        rtr = np.asarray(pli.shadow_transmission_pallas(
            jnp.asarray(pack), jnp.asarray(c8), jnp.asarray(filt4),
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(dist),
            n_tris=n_tris))
    finally:
        pli.INTERPRET = False
    assert np.allclose(tr, rtr, atol=2e-3)
    assert (tr[::9] == 1.0).all()
    assert (tr < 1e-30).any() and ((tr > 0.01) & (tr < 0.99)).any()


def test_dense_sum_has_no_floor_and_stream_sum_floors_at_opaque():
    """Three opaque triangles on one segment: the dense sum is -240 (the
    reference's `_shadow_kernel` sums without a floor on the total), the
    stream sum -80 (`_shadow_kernel_stream` floors after each cluster)."""
    v0 = np.array([[0, 0, z] for z in (1.0, 2.0, 3.0)], np.float32) - 0.5
    e1 = np.tile(np.float32([[2, 0, 0]]), (3, 1))
    e2 = np.tile(np.float32([[0, 2, 0]]), (3, 1))
    pack, c8, _ = ci.build_tri_pack(v0, e1, e2)
    logf = ci.log_filter(torch.zeros((4, pack.shape[1])))
    args = (_t(pack), logf, torch.tensor([[0.0, 0.0, 0.0]]),
            torch.tensor([[0.0, 0.0, 1.0]]), torch.tensor([5.0]), 3)
    assert torch.equal(cl.shadow_logsum_dense_plain(*args),
                       torch.full((1, 3), -240.0))
    assert torch.equal(cl.shadow_logsum_stream_plain(*args),
                       torch.full((1, 3), -80.0))
    lg = cl.shadow_logsum_dense(args[0], _t(c8), _box32(pack, 3),
                                *args[1:])
    assert torch.equal(lg, torch.full((1, 3), -240.0))


@pytest.mark.parametrize("table", ["clusters", "quarters"])
def test_box_entry_never_skips_a_hit(cases, table):
    """The widened boxes the kernels skip by (the 128-column cluster boxes
    and the 32-column quarter boxes): every hit's box is entered no further
    than the hit, so a ray never skips the box of its hit; the pair counts
    of chip_smoke.py's bounds lie between the hits' boxes and the brute
    force, and the quarter boxes need fewer pairs than the clusters."""
    pack, c8, n_tris, o, d = cases["grid2"]
    n = o.shape[0]
    org, dirn = _t(o), _t(d)
    boxes8 = _t(c8) if table == "clusters" else _box32(pack, n_tris)
    lo, hi = torch.full((n,), 5e-5), torch.full((n,), float("inf"))
    t, col = cl.closest_stream_plain(_t(pack), org, dirn, lo, hi, n_tris)
    hit = torch.isfinite(t)
    bt = pack.shape[1] // boxes8.shape[1]
    ent = fi.box_entry(boxes8, org, dirn, lo, hi)
    own = ent[hit, col[hit].long() // bt]
    assert (own <= t[hit]).all()
    before_hit = torch.minimum(hi, t)
    pairs, boxes = cl.cluster_pair_tests(_t(pack), boxes8, org, dirn, lo,
                                         before_hit, n_tris)
    assert int(hit.sum()) <= pairs < n * n_tris
    assert boxes == n * -(-n_tris // bt)
    if table == "quarters":
        cluster_pairs, _ = cl.cluster_pair_tests(_t(pack), _t(c8), org, dirn,
                                                 lo, before_hit, n_tris)
        assert pairs < 0.6 * cluster_pairs, (pairs, cluster_pairs)
        return
    # 128-column clusters: each is its own single sub-cluster, so the fine
    # count finds the same pairs and adds one box test per entered cluster
    entered = int(torch.isfinite(fi.box_entry(_t(c8), org, dirn, lo,
                                              before_hit)).sum())
    f_pairs, f_boxes = fi.fine_pair_tests(
        _t(c8), _t(fi.sub_aabbs(pack, n_tris)), org, dirn, lo, before_hit,
        n_tris)
    assert (f_pairs, f_boxes) == (pairs, boxes + entered)


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


def _walk_quarters(pk, box32, n_tris, o, d, lo, hi):
    """One ray (1-row tensors) through closest_hit_stream's warp walk, in
    plain PyTorch: lane q holds quarter q's entry into [tmin, tmax]; the
    warp picks the nearest quarter not yet visited (the lowest lane on equal
    entries) and stops once it lies strictly beyond min(tmax, best t); on a
    visit lane l tests column 32 q + l (none past n_tris) and keeps its own
    lexicographic minimum (t, column); the lanes' best t is reduced after
    every visit and the (t, column) minimum at the end.  Returns (t, col,
    quarters visited, pair tests made)."""
    q_real = -(-n_tris // cl.QUARTER)
    inf = float("inf")
    ent = [float(e) for e in fi.box_entry(box32[:, :q_real], o, d, lo,
                                          hi)[0]]
    lane_t = torch.full((32,), inf)
    lane_c = torch.full((32,), 2 ** 31 - 1, dtype=torch.int64)
    lim, visits, pairs = float(hi), 0, 0
    while ent:
        e = min(ent)
        q = ent.index(e)
        if not e <= lim or e == inf:
            break
        ent[q] = inf
        visits += 1
        k0 = cl.QUARTER * q
        pairs += min(k0 + cl.QUARTER, n_tris) - k0
        k = torch.arange(k0, k0 + cl.QUARTER)
        t, _, _, ok = ci._mt_test(pk, slice(k0, k0 + cl.QUARTER), *o[0],
                                  *d[0])
        t = torch.where(ok & (t > lo) & (t < hi) & (k < n_tris), t, inf)
        better = (t < lane_t) | ((t == lane_t) & (k < lane_c) & (t < inf))
        lane_t = torch.where(better, t, lane_t)
        lane_c = torch.where(better, k, lane_c)
        lim = min(float(hi), float(lane_t.amin()))
    best = float(lane_t.amin())
    if best == inf:
        return best, 0, visits, pairs
    return best, int(lane_c[lane_t == best].amin()), visits, pairs


@pytest.mark.parametrize("case", ["grid2", "soup400"])
def test_quarter_walk_gives_the_plain_answer(cases, case):
    """closest_hit_stream's walk over the quarter boxes, nearest entry
    first with its stopping rule and the lexicographic (t, column) minimum,
    gives closest_stream_plain's (t, col) exactly, exact ties on shared
    edges included; it visits fewer than half of the real quarters, and it
    tests the pairs cluster_pair_tests counts on the quarter boxes below
    min(tmax, t)."""
    pack, c8, n_tris, o, d = cases[case]
    rng = np.random.default_rng(29)
    keep = rng.choice(o.shape[0], 160, replace=False)
    o, d = o[keep], d[keep]
    if case == "grid2":
        eo, ed = _edge_rays(pack, n_tris, 240, rng)
        o, d = np.concatenate([o, eo]), np.concatenate([d, ed])
    n = o.shape[0]
    tmin, tmax = _limits(n)
    pk, box32 = _t(pack), _box32(pack, n_tris)
    args = [_t(x) for x in (o, d, tmin, tmax)]
    pt, pcol = cl.closest_stream_plain(pk, *args, n_tris)
    visits = pairs = 0
    for i in range(n):
        t, col, v, p = _walk_quarters(pk, box32, n_tris,
                                      *(x[i:i + 1] for x in args))
        assert (t, col) == (float(pt[i]), int(pcol[i])), i
        visits += v
        pairs += p
    hit = torch.isfinite(pt)
    assert hit.any() and not hit.all()
    assert visits < 0.5 * n * -(-n_tris // cl.QUARTER)
    assert pairs == cl.cluster_pair_tests(
        pk, box32, args[0], args[1], args[2], torch.minimum(args[3], pt),
        n_tris)[0]
    if case == "grid2":
        # some of the edge rays are exact ties between two columns
        ox, oy, oz = (x[:, None] for x in args[0].unbind(-1))
        dx, dy, dz = (x[:, None] for x in args[1].unbind(-1))
        t_all, _, _, ok = ci._mt_test(pk, slice(0, n_tris), ox, oy, oz, dx,
                                      dy, dz)
        tied = (ok & (t_all == pt[:, None])).sum(dim=1) > 1
        assert int((tied & hit).sum()) >= 3, int((tied & hit).sum())


def _walk_shadow(pk, boxes, width, logf, o, d, dist, n_tris, r, stop):
    """The column walk of the shadow kernels (csrc/column_walk.cuh) in plain
    PyTorch, over the boxes (8, T'/width) of the pack's width-column
    groups: a thread holds r consecutive rays (the last one those left) and
    tests each live segment against the real boxes; it walks, in rising
    order, the groups one of its segments enters, columns in rising order,
    and a ray adds a column's log filters where its own test passes, from 0.
    Without `stop` every ray of the thread tests each walked group, and
    there is no floor.  With `stop` (the stream sum) a ray tests only the
    groups it enters; after each group a ray whose three channels are all
    <= -80 is dropped, so a thread walks a group only if one of its rays
    still in the walk entered it; the sum is floored at -80 at the end.
    Returns (sums, pair tests made)."""
    n = o.shape[0]
    g_real = -(-n_tris // width)
    lo, hi = cl.shadow_limits(dist)
    ent = torch.isfinite(fi.box_entry(boxes[:, :g_real], o, d, lo, hi))
    thread = torch.arange(n) // r
    acc = torch.zeros((n, 3))
    walking = torch.ones(n, dtype=torch.bool)  # not dropped by the stop
    pairs = 0
    for g in range(g_real):
        own = ent[:, g] & walking
        walks = torch.zeros(n // r + 1, dtype=torch.int64).index_add_(
            0, thread, own.to(torch.int64))[thread] > 0
        idx = torch.nonzero(own if stop else walks).squeeze(1)
        k0, k1 = width * g, min(width * (g + 1), n_tris)
        if idx.numel():
            t, _, _, ok = ci._mt_test(pk, slice(k0, k1),
                                      *(o[idx, a:a + 1] for a in range(3)),
                                      *(d[idx, a:a + 1] for a in range(3)))
            crossed = ok & (t > ci.SHADOW_TMIN) & (t < hi[idx, None])
            part = acc[idx]
            for c in range(k1 - k0):
                part = part + torch.where(crossed[:, c:c + 1],
                                          logf[:3, k0 + c][None], 0.0)
            acc[idx] = part
            pairs += idx.numel() * (k1 - k0)
        if stop:
            walking &= ~(acc <= ci.LOG_FLOOR).all(dim=1)
    if stop:
        acc = torch.clamp(acc, min=ci.LOG_FLOOR)
    return acc, pairs


def _column_sum(pk, logf, o, d, dist, n_tris):
    """Each segment's log-filter sum over every real column in rising
    order from 0, nothing skipped: the order the kernel adds in."""
    _, hi = cl.shadow_limits(dist)
    t, _, _, ok = ci._mt_test(pk, slice(0, n_tris),
                              *(o[:, a:a + 1] for a in range(3)),
                              *(d[:, a:a + 1] for a in range(3)))
    crossed = ok & (t > ci.SHADOW_TMIN) & (t < hi[:, None])
    acc = torch.zeros((o.shape[0], 3))
    for c in range(n_tris):
        acc = acc + torch.where(crossed[:, c:c + 1], logf[:3, c][None], 0.0)
    return acc


def _filters(kind, n_tris, tp, rng):
    """(4, T') filter rows in pack order: 0 or 1 (`binary`, log filters 0
    or -80: every sum exact), all 0 (`opaque`), a random colour on half of
    the triangles and 0 on the rest (`partial`), or red 0 and a random
    green and blue on every triangle (`channel`: a segment is opaque in red
    at its first crossing and not in the other two, so a stop on one
    channel would drop its later crossings)."""
    filt4 = np.zeros((4, tp), np.float32)
    if kind == "binary":
        filt4[:3, :n_tris] = rng.random((1, n_tris)) > 0.5
    elif kind == "partial":
        filt4[:3, :n_tris] = (rng.random((3, n_tris))
                              * (rng.random((1, n_tris)) > 0.5))
    elif kind == "channel":
        filt4[1:3, :n_tris] = rng.uniform(0.3, 1.0, (2, n_tris))
    return filt4


FILTERS = ("binary", "opaque", "partial", "channel")


def _shadow_walk_case(pack, n_tris, o, d, kind, seed=5):
    """Segments of the case's rays (the last 3 dropped, so a last thread
    holds fewer than r of them; every 9th dead: an empty segment) and log
    filters of `kind`."""
    n = o.shape[0] - 3
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0.5, 12.0, n).astype(np.float32)
    dist[::9] = -1.0
    logf = ci.log_filter(_t(_filters(kind, n_tris, pack.shape[1], rng)))
    return logf, (_t(o[:n]), _t(d[:n]), _t(dist))


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("kind", FILTERS)
@pytest.mark.parametrize("case", ["grid1", "soup300"])
def test_dense_shadow_walk_gives_the_plain_sum(cases, case, kind, r):
    """shadow_logsum_dense's walk (r rays a thread, the quarter skip, each
    ray's terms in rising column order, dead rays) against the brute force:
    bit for bit equal to the column-order sum with nothing skipped for
    every filter, to the plain version where every log filter is 0 or -80,
    transmission within atol 2e-3 of it otherwise; dead rays sum to 0; the
    pair tests it makes are group_walk_pair_tests' count, fewer than
    the brute force's."""
    pack, _, n_tris, o, d = cases[case]
    pk, box32 = _t(pack), _box32(pack, n_tris)
    logf, rays = _shadow_walk_case(pack, n_tris, o, d, kind)
    n = rays[0].shape[0]
    got, pairs = _walk_shadow(pk, box32, cl.QUARTER, logf, *rays, n_tris, r,
                              stop=False)
    want = cl.shadow_logsum_dense_plain(pk, logf, *rays, n_tris)
    assert torch.equal(got, _column_sum(pk, logf, *rays, n_tris))
    assert (got[::9] == 0.0).all()
    if kind in ("partial", "channel"):
        assert torch.allclose(torch.exp(got), torch.exp(want), atol=2e-3)
        assert ((got < 0) & (got > -80)).any()
    else:
        assert torch.equal(got, want)
        assert (got <= -80.0).any()
    assert pairs == cl.group_walk_pair_tests(box32, *rays, n_tris,
                                             rays_per_thread=r)[0]
    assert 0 < pairs < 0.9 * n * n_tris


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("kind", FILTERS)
@pytest.mark.parametrize("case", ["grid2", "soup400"])
def test_stream_shadow_walk_gives_the_floored_plain_sum(cases, case, kind,
                                                        r):
    """shadow_logsum_stream's walk (r rays a thread, each ray over the
    quarters it enters until all three of its channels are <= -80, the
    floor once at the end) against the brute force: bit for bit equal to
    the floored column-order sum for every filter, to the plain version
    where every log filter is 0 or -80, transmission within atol 2e-3 of it
    otherwise; dead rays give 0; a ray opaque in one channel walks on.  Its
    pair tests are stop_walk_pair_tests' count: no more than the quarters a
    ray enters hold, fewer once rays turn opaque."""
    pack, _, n_tris, o, d = cases[case]
    pk, box32 = _t(pack), _box32(pack, n_tris)
    logf, rays = _shadow_walk_case(pack, n_tris, o, d, kind)
    got, pairs = _walk_shadow(pk, box32, cl.QUARTER, logf, *rays, n_tris, r,
                              stop=True)
    want = cl.shadow_logsum_stream_plain(pk, logf, *rays, n_tris)
    full = _column_sum(pk, logf, *rays, n_tris)
    assert torch.equal(got, torch.clamp(full, min=ci.LOG_FLOOR))
    assert (got[::9] == 0.0).all()
    if kind in ("partial", "channel"):
        assert torch.allclose(torch.exp(got), torch.exp(want), atol=2e-3)
        assert ((got < 0) & (got > -80)).any()
    else:
        assert torch.equal(got, want)
    assert (got <= -80.0).all(dim=1).any() == (kind != "channel")
    made, boxes = cl.stop_walk_pair_tests(pk, box32, logf, *rays, n_tris)
    assert pairs == made
    entered = cl.cluster_pair_tests(pk, box32, rays[0], rays[1],
                                    *cl.shadow_limits(rays[2]), n_tris)[0]
    assert 0 < pairs <= entered
    if kind in ("binary", "opaque"):
        assert pairs < entered
    live = int((rays[2] > 0).sum())
    assert boxes == live * -(-n_tris // cl.QUARTER)


@pytest.fixture(scope="module")
def tiny_cases():
    """name -> (pack10, n_tris, org, dir): the Cornell box's shadow pack
    (32 triangles, the port's compile) with rays through the room, and a
    64-triangle soup (TINY_TRIS: 32 boxes, a full 32-bit mask)."""
    rng = np.random.default_rng(23)
    cs = parse_xml_file("scenes/cornell.xml").compile(device="cpu")
    out = {"cornell": (cs.arrays["stri_pack10"], cs.static.n_stris_real,
                       *_scene_rays(rng))}
    v0 = rng.uniform(-2.0, 2.0, (ci.TINY_TRIS, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.5, (ci.TINY_TRIS, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.5, (ci.TINY_TRIS, 3)).astype(np.float32)
    o = (rng.random((N_RAYS, 3)) - 0.5) * 6.0
    out["soup64"] = (ci.build_tri_pack(v0, e1, e2)[0], ci.TINY_TRIS,
                     o.astype(np.float32), _unit(rng, N_RAYS))
    return out


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("kind", FILTERS)
@pytest.mark.parametrize("case", ["cornell", "soup64"])
def test_tiny_shadow_walk_gives_the_plain_sum(tiny_cases, case, kind, r):
    """shadow_logsum_tiny's walk (r rays a thread over the 2-column boxes
    its kernel builds, tiny_boxes; no floor, no stop) against the brute
    force: bit for bit equal to the plain version, which adds its terms in
    rising column order too, for every filter; dead rays sum to 0; its
    pair tests are group_walk_pair_tests' count, a fraction of the brute
    force's."""
    pack, n_tris, o, d = tiny_cases[case]
    pk, boxes = _t(pack), _t(ci.tiny_boxes(pack, n_tris))
    assert boxes.shape == (8, pack.shape[1] // ci.TINY_GROUP)
    logf, rays = _shadow_walk_case(pack, n_tris, o, d, kind)
    n = rays[0].shape[0]
    got, pairs = _walk_shadow(pk, boxes, ci.TINY_GROUP, logf, *rays, n_tris,
                              r, stop=False)
    want = ci.shadow_logsum_tiny_plain(pk, logf, *rays, n_tris)
    assert torch.equal(got, want)
    assert torch.equal(got, _column_sum(pk, logf, *rays, n_tris))
    assert (got[::9] == 0.0).all() and (got < 0).any()
    assert pairs == cl.group_walk_pair_tests(
        boxes, *rays, n_tris, width=ci.TINY_GROUP, rays_per_thread=r)[0]
    assert 0 < pairs < (0.25 if case == "cornell" else 0.5) * n * n_tris


def _walk_closest(pk, boxes, o, d, tmin, tmax, n_tris):
    """The closest walk of csrc/column_walk.cuh (closest_items) in plain
    PyTorch over the boxes (8, T'/width) of the pack's width-column groups.
    A live ray (tmin <= tmax) tests every real box against its whole
    interval and walks the group it enters nearest (the lower one on equal
    entries); each other group it entered takes one more box test, against
    its interval cut at the best t found so far, and is listed where the
    cut interval enters it.  The listed (ray, group) items are then taken
    one group after another, each skipped where its entry lies beyond the
    ray's best t by then (the kernel's threads take them in an order of
    their own).  A pair replaces the best on a smaller t or an equal t at a
    lower column.  Returns ((t, column (int64), u, v), pair tests made,
    pair tests listed, box tests); a ray that hits nothing keeps t = inf,
    column 0, u = v = 0."""
    n = o.shape[0]
    width = pk.shape[1] // boxes.shape[1]
    g_real = -(-n_tris // width)
    inf = float("inf")
    live = tmin <= tmax
    best = [torch.full((n,), inf), torch.zeros(n, dtype=torch.int64),
            torch.zeros(n), torch.zeros(n)]
    cols = torch.clamp(n_tris - torch.arange(g_real) * width, 0, width)
    made = [0]

    def visit(group, on):
        idx = torch.nonzero(on).squeeze(1)
        k = group[idx, None] * width + torch.arange(width)
        real = k < n_tris
        made[0] += int(real.sum())
        t, u, v, ok = ci._mt_test(pk[:, k.clamp(max=n_tris - 1)], slice(None),
                                  *(o[idx, a:a + 1] for a in range(3)),
                                  *(d[idx, a:a + 1] for a in range(3)))
        ok = ok & real & (t > tmin[idx, None]) & (t < tmax[idx, None])
        bt, bk, bu, bv = (b[idx] for b in best)
        for c in range(width):
            tc, kc = t[:, c], k[:, c]
            win = ok[:, c] & ((tc < bt) | ((tc == bt) & (kc < bk)))
            bt, bk = torch.where(win, tc, bt), torch.where(win, kc, bk)
            bu = torch.where(win, u[:, c], bu)
            bv = torch.where(win, v[:, c], bv)
        for b, x in zip(best, (bt, bk, bu, bv)):
            b[idx] = x

    ent = fi.box_entry(boxes[:, :g_real], o, d, tmin, tmax)
    entered = torch.isfinite(ent) & live[:, None]
    first, has = torch.argmin(ent, dim=1), entered.any(dim=1)
    visit(first, has)
    again = entered & ~((torch.arange(g_real)[None] == first[:, None])
                        & has[:, None])
    cut = torch.minimum(tmax, best[0])
    item = fi.box_entry(boxes[:, :g_real], o, d, tmin, cut)
    listed = again & torch.isfinite(item)
    for g in range(g_real):
        visit(torch.full((n,), g, dtype=torch.int64),
              listed[:, g] & (item[:, g] <= torch.minimum(tmax, best[0])))
    pairs_listed = int((cols[first] * has).sum()) + int(
        (listed.to(torch.int64) * cols).sum())
    box_tests = int(live.sum()) * g_real + int(again.sum())
    return best, made[0], pairs_listed, box_tests


def _closest_walk_case(pack, n_tris, o, d, rays, seed):
    """200 of the case's rays (`rays`: "first" from its first half, the
    camera's rays in the generated scenes and the Cornell box, "second"
    from its second half, rays from points inside the room in random
    directions, as bounce rays are) and 200 edge rays (exact ties where
    triangles share the aimed-at edge or vertex), with the limits of
    `_limits` (every 11th ray dead)."""
    rng = np.random.default_rng(seed)
    h = o.shape[0] // 2
    keep = rng.choice(h, 200, replace=False) + (h if rays == "second" else 0)
    edges = [_edge_rays(pack, n_tris, min(200, n_tris), rng)
             for _ in range(-(-200 // n_tris))]
    o = np.concatenate([o[keep]] + [eo for eo, _ in edges])
    d = np.concatenate([d[keep]] + [ed for _, ed in edges])
    return [_t(x) for x in (o, d, *_limits(o.shape[0]))]


def _ties(pk, org, dirn, t, n_tris):
    """Rays whose nearest t two or more columns give exactly."""
    ox, oy, oz = (x[:, None] for x in org.unbind(-1))
    dx, dy, dz = (x[:, None] for x in dirn.unbind(-1))
    t_all, _, _, ok = ci._mt_test(pk, slice(0, n_tris), ox, oy, oz, dx, dy,
                                  dz)
    return int(((ok & (t_all == t[:, None])).sum(dim=1) > 1)[
        torch.isfinite(t)].sum())


def _check_closest_walk(pk, boxes, rays, n_tris, want, brute_share):
    """The walk on `rays` against the plain answer `want` (t, column[, u,
    v]) bit for bit, dead rays (every 11th) missing at column 0; its
    listed pairs and box tests are closest_walk_pair_tests' count, the
    pairs it makes lie between what the groups entered below min(tmax, t)
    hold and what it listed, no more than the groups its whole interval
    enters hold, and under brute_share of the brute force's pairs."""
    org, dirn, tmin, tmax = rays
    got, made, listed, box_tests = _walk_closest(pk, boxes, *rays, n_tris)
    for a, b in zip(got, want):
        assert torch.equal(a, b.to(a.dtype))
    hit = torch.isfinite(want[0])
    assert hit.any() and not hit[::11].any() and (got[1][::11] == 0).all()
    assert (listed, box_tests) == cl.closest_walk_pair_tests(pk, boxes,
                                                             *rays, n_tris)
    need = cl.cluster_pair_tests(pk, boxes, org, dirn, tmin,
                                 torch.minimum(tmax, want[0]), n_tris)[0]
    entered = cl.cluster_pair_tests(pk, boxes, *rays, n_tris)[0]
    assert 0 < need <= made <= listed <= entered
    assert listed < brute_share * org.shape[0] * n_tris
    return listed


@pytest.mark.parametrize("rays", ["first", "second"])
@pytest.mark.parametrize("case", ["cornell", "soup64"])
def test_tiny_closest_walk_gives_the_plain_answer(tiny_cases, case, rays):
    """closest_hit_tiny's walk (the 2-column boxes its kernel builds,
    tiny_boxes; each ray's nearest group by its own thread, its other
    entered groups as items listed for the block) gives
    closest_hit_tiny_plain's (t, tri, u, v) bit for bit, exact ties on
    shared edges and dead rays (t = inf, column 0) included; it lists
    under a quarter of the brute force's pairs on the Cornell box."""
    pack, n_tris, o, d = tiny_cases[case]
    pk = _t(pack)
    rays_ = _closest_walk_case(pack, n_tris, o, d, rays, 31)
    want = ci.closest_hit_tiny_plain(pk, *rays_, n_tris)[:4]
    if case == "cornell":
        assert _ties(pk, *rays_[:2], want[0], n_tris) >= 3
    _check_closest_walk(pk, _t(ci.tiny_boxes(pack, n_tris)), rays_, n_tris,
                        want, 0.25 if case == "cornell" else 0.5)


@pytest.mark.parametrize("rays", ["first", "second"])
@pytest.mark.parametrize("case", ["grid1", "soup300"])
def test_dense_closest_walk_gives_the_plain_answer(cases, case, rays):
    """closest_hit_dense's walk (the 16-column boxes its kernel builds,
    dense_boxes, walked as the tiny one is, the lexicographic (t, column)
    minimum) gives closest_dense_plain's (t, col) exactly, exact ties on
    shared edges and dead rays included; it lists fewer pairs than the
    quarter boxes need and than the brute force's half."""
    pack, _, n_tris, o, d = cases[case]
    pk, boxes = _t(pack), _t(cl.dense_boxes(pack, n_tris))
    assert boxes.shape == (8, pack.shape[1] // cl.DENSE_GROUP)
    rays_ = _closest_walk_case(pack, n_tris, o, d, rays, 37)
    org, dirn, tmin, tmax = rays_
    want = cl.closest_dense_plain(pk, *rays_, n_tris)
    if case == "grid1":
        assert _ties(pk, org, dirn, want[0], n_tris) >= 3
    listed = _check_closest_walk(pk, boxes, rays_, n_tris, want, 0.9)
    quarters = cl.cluster_pair_tests(pk, _box32(pack, n_tris), org, dirn,
                                     tmin, torch.minimum(tmax, want[0]),
                                     n_tris)[0]
    assert listed < quarters


def test_cluster_wrappers_route_cpu_to_plain_and_count_nothing(cases):
    """On CPU tensors every wrapper (and the private entries of the
    one-thread bodies that the four walks replaced) runs its plain version
    and launches nothing."""
    pack, c8, n_tris, o, d = cases["grid2"]
    n = o.shape[0]
    lim = (torch.full((n,), 5e-5), torch.full((n,), float("inf")))
    wrappers = (cl.closest_hit_dense, cl.closest_hit_stream,
                cl.shadow_logsum_dense, cl.shadow_logsum_stream)
    before = [w.launches for w in wrappers]
    box32 = _box32(pack, n_tris)
    logf = torch.full((3, pack.shape[1]), -1.0)
    dist = torch.full((n,), 3.0)
    for kind in ("dense", "stream"):
        want = getattr(cl, f"closest_{kind}_plain")(
            _t(pack), _t(o), _t(d), *lim, n_tris)
        calls = [(getattr(cl, f"closest_hit_{kind}"),
                  _closest_scene(kind, pack, c8, n_tris)),
                 (getattr(cl, f"_closest_hit_{kind}_before"),
                  (_t(pack), _t(c8)))]
        for fn, scene in calls:
            got = fn(*scene, _t(o), _t(d), *lim, n_tris)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
        want = getattr(cl, f"shadow_logsum_{kind}_plain")(
            _t(pack), logf, _t(o), _t(d), dist, n_tris)
        calls = [(getattr(cl, f"shadow_logsum_{kind}"),
                  _shadow_scene(pack, c8, n_tris)),
                 (getattr(cl, f"_shadow_logsum_{kind}_before"),
                  (_t(pack), _t(c8)))]
        for fn, scene in calls:
            got = fn(*scene, logf, _t(o), _t(d), dist, n_tris)
            assert got.shape == (n, 3) and torch.equal(got, want)
    assert box32.shape == (8, pack.shape[1] // 32)
    assert [w.launches for w in wrappers] == before


def test_cluster_wrappers_reject_bad_inputs(cases):
    pack, c8, n_tris, o, d = cases["grid2"]
    n = o.shape[0]
    pk, c, org, dirn = _t(pack), _t(c8), _t(o), _t(d)
    box32 = _box32(pack, n_tris)
    lim = torch.zeros(n)
    with pytest.raises(ValueError, match="equal clusters"):
        cl.closest_hit_dense(pk, torch.zeros((8, 5)), org, dirn, lim, lim,
                             n_tris)
    with pytest.raises(ValueError, match="at most"):  # 12 clusters of 64
        cl.closest_hit_stream(pk, torch.zeros((8, 12)), box32, org, dirn,
                              lim, lim, n_tris)
    with pytest.raises(ValueError, match="n_tris"):
        cl.closest_hit_stream(pk, c, box32, org, dirn, lim, lim,
                              pack.shape[1] + 1)
    with pytest.raises(TypeError):
        cl.closest_hit_dense(pk, c, org.double(), dirn, lim, lim, n_tris)
    # the dense walk holds at most 64 boxes of 16 columns (1,024 triangles);
    # the one-thread body it replaced takes no boxes
    with pytest.raises(ValueError, match="at most 64 boxes"):
        cl.closest_hit_dense(torch.zeros((10, 1152)), torch.zeros((8, 9)),
                             org, dirn, lim, lim, 1025)
    with pytest.raises(ValueError, match="n_tris"):
        cl._closest_hit_dense_before(pk, c, org, dirn, lim, lim,
                                     pack.shape[1] + 1)
    with pytest.raises(ValueError, match="rgb rows"):
        cl.shadow_logsum_stream(pk, c, box32, torch.zeros(2, pack.shape[1]),
                                org, dirn, lim, n_tris)
    with pytest.raises(ValueError, match="shared"):  # 6 x 1,024 columns
        cl.shadow_logsum_dense(torch.zeros((10, 6144)), c,
                               torch.zeros((8, 192)), torch.zeros(
                                   (3, 6144)), org, dirn, lim, n_tris)
    # the quarter boxes: required, (8, T'/32), float32, and at most 32 for
    # the warp
    for bad in (None, box32[:, :-1].contiguous(), box32[:6].contiguous()):
        with pytest.raises(ValueError, match="box32"):
            cl.closest_hit_stream(pk, c, bad, org, dirn, lim, lim, n_tris)
        for shadow in (cl.shadow_logsum_dense, cl.shadow_logsum_stream):
            with pytest.raises(ValueError, match="box32"):
                shadow(pk, c, bad, torch.zeros((3, 768)), org, dirn, lim,
                       n_tris)
    with pytest.raises(TypeError):
        cl.closest_hit_stream(pk, c, box32.double(), org, dirn, lim, lim,
                              n_tris)
    with pytest.raises(ValueError, match="at most 32"):  # 64 quarters
        cl.closest_hit_stream(torch.zeros((10, 2048)), torch.zeros((8, 8)),
                              torch.zeros((8, 64)), org, dirn, lim, lim,
                              n_tris)
