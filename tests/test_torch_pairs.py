"""The port's pair-granular intersection route (libyafaray_tpu_torch/ops/
pairs_intersect.py: the plain PyTorch versions of the two pair kernels,
the closest-hit and shadow passes built on them, their wrappers on the CPU
and the routing in ops/intersect.py) against the JAX reference's pair route
in libyafaray_tpu/ops/pallas_intersect.py, its Pallas kernels in interpret
mode as tests/test_accel.py runs them.

The per-slot kernels and the two passes are held on the 2,999-triangle
random soup of tests/test_accel.py (24 clusters of 128) with 256 rays, both
packages' caps lowered alike (K1 2, K2 3, SHADOW_KS 5, PAIRS_MIN_CLUSTERS
4; the reference's PAIR_KB 4 sizes only its TPU blocks), so that round 2
and the straggler pass do real work.  The slice is the generated
10,252-triangle grid (--grid 2 --subdiv 3: 81 clusters, over the real
PAIRS_MIN_CLUSTERS = 64) rendered with the real caps.

Tolerances are the reference's own (tests/test_accel.py): hit equal, t
within rtol 1e-4, tri equal except on exact ties, transmission within atol
2e-3; per-slot log sums within atol 1e-5; renders within image RMSE 1e-4
and rays within 0.01%.  The kernels themselves run only on the card;
chip_smoke.py holds them to these plain versions there."""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libyafaray_tpu.integrators.config import RenderConfig as RefConfig
from libyafaray_tpu.integrators.render import render as ref_render
from libyafaray_tpu.ops import pallas_intersect as pli
from libyafaray_tpu.scene.session import build_config as ref_build
from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse
from libyafaray_tpu_torch.integrators.config import RenderConfig
from libyafaray_tpu_torch.integrators.render import render
from libyafaray_tpu_torch.ops import cuda_intersect as ci
from libyafaray_tpu_torch.ops import fine_intersect as fi
from libyafaray_tpu_torch.ops import intersect as isect
from libyafaray_tpu_torch.ops import pairs_intersect as pi
from libyafaray_tpu_torch.scene import generate
from libyafaray_tpu_torch.scene.scene import SceneStatic
from libyafaray_tpu_torch.scene.session import build_config, render_scene
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TRIS = 2999
N_RAYS = 256
CAPS = dict(PAIRS_MIN_CLUSTERS=4, PAIR_K1=2, PAIR_K2=3, SHADOW_KS=5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions are many small tensor ops: one CPU thread runs
    them fastest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_caps(monkeypatch):
    """The same small caps in both packages, the reference's kernels in
    interpret mode."""
    for k, v in CAPS.items():
        monkeypatch.setattr(pli, k, v)
        monkeypatch.setattr(pi, k, v)
    monkeypatch.setattr(pli, "PAIR_KB", 4)
    monkeypatch.setattr(pli, "INTERPRET", True)


@pytest.fixture(scope="module")
def soup():
    """The 2,999-triangle soup of tests/test_accel.py in Morton order, its
    sub-boxes, 256 rays inside it, random filters in pack order."""
    rng = np.random.default_rng(17)
    v0 = rng.uniform(-4, 4, (N_TRIS, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.45, (N_TRIS, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.45, (N_TRIS, 3)).astype(np.float32)
    pack, cl, s_ord = ci.build_tri_pack(v0, e1, e2,
                                        ci.morton_order(v0, e1, e2))
    org = rng.uniform(-4, 4, (N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    filt = (rng.random((N_TRIS, 3))
            * (rng.random((N_TRIS, 1)) > 0.5)).astype(np.float32)
    filt_pk = np.where((np.arange(pack.shape[1]) < N_TRIS)[:, None],
                       filt[s_ord], 1.0).astype(np.float32)
    filt4 = np.concatenate([filt_pk.T, np.zeros((1, pack.shape[1]),
                                                np.float32)])
    dist = rng.uniform(0.5, 6.0, N_RAYS).astype(np.float32)
    dist[::9] = -1.0  # dead lanes: empty segment
    tmax = np.full(N_RAYS, np.inf, np.float32)
    tmax[::7] = 2.0  # some finite segments
    return dict(pack=pack, cl=cl, sub=fi.sub_aabbs(pack, N_TRIS), org=org,
                dir=d, tmin=np.full(N_RAYS, 5e-5, np.float32), tmax=tmax,
                filt4=filt4, dist=dist)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port(s, *keys):
    return [_t(s[k]) for k in keys]


def _jnp(s, *keys):
    return [jnp.asarray(s[k]) for k in keys]


def _pack16s(pack, filt4):
    logf4 = jnp.maximum(jnp.log(jnp.maximum(jnp.asarray(filt4), 1e-35)),
                        -80.0)
    return jnp.concatenate([jnp.asarray(pack), logf4,
                            jnp.zeros((2, pack.shape[1]), jnp.float32)])


def _reference_slots(s, k: int):
    """The reference's cluster-sorted slots of each ray's k nearest
    clusters (its own entries), padded as it pads them: (sray, scl,
    slotcl, valid slot count)."""
    org, d, tmin, tmax = _jnp(s, "org", "dir", "tmin", "tmax")
    ent = pli._ray_cluster_entries(org, d, tmin, tmax, jnp.asarray(s["cl"]))
    sidx = jnp.argsort(ent, axis=1).astype(jnp.int32)[:, :k]
    valid = jnp.isfinite(jnp.take_along_axis(ent, sidx, axis=1))
    sray, scl, slotcl = pli._expand_pairs(sidx, valid, s["cl"].shape[1])
    return sray, scl, slotcl, int(valid.sum())


def _tie(s, col, rcol, t, rows):
    """Slots or rays where the two columns differ are exact ties: the
    reference's column gives the port's t in the port's arithmetic, and it
    lies above the port's."""
    org, d = _t(s["org"][rows]), _t(s["dir"][rows])
    c10 = _t(s["pack"][:, rcol])
    t_ref, _, _, ok = ci._mt_test(c10, slice(None), *org.unbind(-1),
                                  *d.unbind(-1))
    return bool(ok.all()) and np.array_equal(t_ref.numpy(), t) and (
        rcol > col).all()


# ---- (a) the per-slot kernels ---------------------------------------------


def test_pairs_closest_plain_matches_reference_kernel(soup, small_caps):
    s = soup
    n_cl = s["cl"].shape[1]
    sray, scl, slotcl, p = _reference_slots(s, 8)
    org, d, tmin, tmax = _jnp(s, "org", "dir", "tmin", "tmax")
    ray8 = jnp.concatenate([org, d, tmin[:, None], tmax[:, None]],
                           axis=1)[sray]
    pack16 = jnp.pad(jnp.asarray(s["pack"]), ((0, 6), (0, 0)))
    rt, rcol = (np.asarray(x)[:p, 0] for x in pli._pairs_sweep(
        pli._pairs_closest_kernel, pack16, ray8, slotcl,
        pli._pair_tables(scl, n_cl, pli.PAIR_KB), 128,
        [(1, jnp.float32), (1, jnp.int32)]))
    sr = _t(np.asarray(sray)[:p].astype(np.int32))
    sc = _t(np.asarray(scl)[:p].astype(np.int32))
    t, col = pi.pairs_closest_plain(_t(s["pack"]), n_cl, sr, sc,
                                    *_port(s, "org", "dir", "tmin", "tmax"),
                                    N_TRIS)
    t, col = t.numpy(), col.numpy()
    hit = np.isfinite(rt)
    assert p > 1000 and 100 < hit.sum() < p
    assert np.array_equal(np.isfinite(t), hit)
    assert np.allclose(t[hit], rt[hit], rtol=1e-4)
    assert (col[~hit] == 0).all()
    flip = hit & (col != rcol)
    rows = np.asarray(sray)[:p][flip]
    assert _tie(s, col[flip], rcol[flip], t[flip], rows)


def test_pairs_shadow_plain_matches_reference_kernel(soup, small_caps):
    s = soup
    n_cl = s["cl"].shape[1]
    sray, scl, slotcl, p = _reference_slots(s, 8)
    org, d, dist = _jnp(s, "org", "dir", "dist")
    tmin = jnp.full_like(dist, 5e-4)
    tmax = dist * (1.0 - 1e-4) - 5e-4
    ray8 = jnp.concatenate([org, d, tmin[:, None], tmax[:, None]],
                           axis=1)[sray]
    (rlg,) = pli._pairs_sweep(
        pli._pairs_shadow_kernel, _pack16s(s["pack"], s["filt4"]), ray8,
        slotcl, pli._pair_tables(scl, n_cl, pli.PAIR_KB), 128,
        [(3, jnp.float32)])
    rlg = np.asarray(rlg)[:p]
    logf = ci.log_filter(_t(s["filt4"]))
    lg = pi.pairs_shadow_plain(
        _t(s["pack"]), n_cl, logf, _t(np.asarray(sray)[:p].astype(np.int32)),
        _t(np.asarray(scl)[:p].astype(np.int32)),
        *_port(s, "org", "dir", "dist"), N_TRIS).numpy()
    assert np.allclose(lg, rlg, atol=1e-5)
    assert (lg <= -80).any() and ((lg < 0) & (lg > -80)).any()
    assert lg.min() < -80  # not floored: two opaque crossings sum


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


def _walk_slots(pk, n_cl, sub8, logf, sray, scl, org, dirn, dist, n_tris):
    """The card kernel's slot sums in plain PyTorch: a slot whose ray or
    cluster id is out of range tests nothing; the others take their
    cluster's tiles (128-column sub-clusters) in rising order, a tile only
    when the segment enters its box (widened by 1e-5) and never a pad tile;
    a tile's sum is `_lane_tree_sum`'s, added to the slot's running sum,
    which is not floored.  Returns (sums (P, 3), pair tests made)."""
    spc = sub8.shape[1] // n_cl
    sc_real = -(-n_tris // fi.SUB_BT)
    ok_id = ((sray >= 0) & (sray < org.shape[0]) & (scl >= 0) & (scl < n_cl))
    acc = torch.zeros((sray.shape[0], 3))
    keep = torch.nonzero(ok_id).squeeze(1)
    r, c = sray[keep].long(), scl[keep].long()
    o, d = org[r], dirn[r]
    lo = torch.full_like(dist[r], ci.SHADOW_TMIN)
    hi = dist[r] * (1.0 - 1e-4) - ci.SHADOW_TMIN
    pairs = 0
    for b in range(spc):
        j = c * spc + b
        real = j < sc_real
        ent = fi.box_entry(sub8[:, j.clamp(max=sc_real - 1)][:, :, None], o,
                           d, lo, hi)[0, :, 0]
        take = torch.nonzero(real & torch.isfinite(ent)).squeeze(1)
        if not take.numel():
            continue
        cols = j[take, None] * fi.SUB_BT + torch.arange(fi.SUB_BT)
        g = pk[:, cols.clamp(max=pk.shape[1] - 1)]
        t, _, _, ok = ci._mt_test(
            g, slice(None), *(o[take, a:a + 1] for a in range(3)),
            *(d[take, a:a + 1] for a in range(3)))
        crossed = (ok & (cols < n_tris) & (t > ci.SHADOW_TMIN)
                   & (t < hi[take, None]))
        lf = logf[:3, cols.clamp(max=logf.shape[1] - 1)].permute(1, 2, 0)
        terms = torch.where(crossed[..., None], lf, 0.0)
        acc[keep[take]] = acc[keep[take]] + _lane_tree_sum(terms)
        pairs += int((cols < n_tris).sum())
    return acc, pairs


@pytest.mark.parametrize("kind", ["binary", "partial"])
@pytest.mark.parametrize("spc", [1, 2, 8])
def test_slot_tile_walk_gives_the_plain_sum(soup, spc, kind):
    """The kernel's slot walk with the sub-box table (clusters of `spc`
    tiles) against `pairs_shadow_plain`, which tests every column of a
    slot's cluster: equal bit for bit where every log filter is 0 or -80,
    within atol 1e-4 otherwise; not floored; slots with an out-of-range ray
    or cluster id give 0."""
    s = soup
    pk, sub8, org, d, dist = _port(s, "pack", "sub", "org", "dir", "dist")
    n_cl = s["pack"].shape[1] // (spc * fi.SUB_BT)
    filt4 = _t(s["filt4"])
    if kind == "binary":
        filt4 = (filt4 > 0.5).to(torch.float32)
    logf = ci.log_filter(filt4)
    rng = np.random.default_rng(8)
    p = 3000
    sray = rng.integers(0, N_RAYS, p).astype(np.int32)
    scl = np.sort(rng.integers(0, n_cl, p)).astype(np.int32)
    bad = np.arange(p) % 50 == 7  # out-of-range ids, four kinds in turn
    which = np.arange(p) % 4
    sray[bad & (which == 0)] = -1
    sray[bad & (which == 1)] = N_RAYS
    scl[bad & (which == 2)] = -1
    scl[bad & (which == 3)] = n_cl
    got, pairs = _walk_slots(pk, n_cl, sub8, logf, _t(sray), _t(scl), org, d,
                             dist, N_TRIS)
    good = np.nonzero(~bad)[0]
    want = torch.zeros((p, 3))
    want[good] = pi.pairs_shadow_plain(pk, n_cl, logf, _t(sray[good]),
                                       _t(scl[good]), org, d, dist, N_TRIS)
    assert not got[np.nonzero(bad)[0]].any() and bad.sum() >= 40
    if kind == "binary":
        assert torch.equal(got, want)
    else:
        assert torch.allclose(got, want, atol=1e-4, rtol=1e-6)
        assert ((got < 0) & (got > -80)).any()
    assert got.min() < -80  # not floored: two opaque crossings sum
    # the sub-boxes spare most of a wide cluster's columns; the count is the
    # bound's (`slot_pair_tests`)
    lo = torch.full((good.size,), ci.SHADOW_TMIN)
    hi = dist[sray[good]] * (1.0 - 1e-4) - ci.SHADOW_TMIN
    assert pairs == pi.slot_pair_tests(sub8, n_cl, _t(sray[good]),
                                       _t(scl[good]), org, d, lo, hi,
                                       N_TRIS)[0]
    if spc == 8:
        assert pairs < 0.6 * good.size * spc * fi.SUB_BT


def _lane_tree_min(t, k):
    """(M, 128) per-column t (inf where no hit) and tile columns of one tile
    -> (M,) (t, column) as the card kernel takes them: lane l of 32 keeps
    the nearest of its columns l, l + 32, l + 64, l + 96 (strict <, in
    rising order), then the lanes reduce the lexicographic minimum of (t,
    column) by the xor tree (offsets 16, 8, 4, 2, 1); every lane ends with
    it, and lane 0's is returned."""
    lt = torch.full((t.shape[0], 32), float("inf"))
    lk = torch.full((t.shape[0], 32), fi.SUB_BT)
    for q in range(fi.SUB_BT // 32):
        ct, ck = t[:, 32 * q:32 * q + 32], k[:, 32 * q:32 * q + 32]
        nearer = ct < lt
        lt, lk = torch.where(nearer, ct, lt), torch.where(nearer, ck, lk)
    idx = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        ot, ok = lt[:, idx ^ off], lk[:, idx ^ off]
        take = (ot < lt) | ((ot == lt) & (ok < lk))
        lt, lk = torch.where(take, ot, lt), torch.where(take, ok, lk)
    return lt[:, 0], lk[:, 0]


def _walk_closest(pk, n_cl, sub8, sray, scl, org, dirn, tmin, tmax, n_tris):
    """The card kernel's closest hit per slot in plain PyTorch: a slot whose
    ray or cluster id is out of range, or whose interval is empty, tests
    nothing (inf, 0); the others take their cluster's tiles in rising
    order, a tile only when the ray's interval enters its box (widened by
    1e-5), never a pad tile, and not when it enters it strictly beyond the
    slot's best t so far; a tile's answer is `_lane_tree_min`'s, kept if
    strictly nearer.  Returns (t, column, pair tests made)."""
    spc = sub8.shape[1] // n_cl
    sc_real = -(-n_tris // fi.SUB_BT)
    ok_id = ((sray >= 0) & (sray < org.shape[0]) & (scl >= 0) & (scl < n_cl))
    best_t = torch.full((sray.shape[0],), float("inf"))
    best_c = torch.zeros(sray.shape[0], dtype=torch.int64)
    keep = torch.nonzero(ok_id).squeeze(1)
    r, c = sray[keep].long(), scl[keep].long()
    o, d, lo, hi = org[r], dirn[r], tmin[r], tmax[r]
    local = torch.arange(fi.SUB_BT)
    pairs = 0
    for b in range(spc):
        j = c * spc + b
        ent = fi.box_entry(sub8[:, j.clamp(max=sc_real - 1)][:, :, None], o,
                           d, lo, hi)[0, :, 0]
        take = torch.nonzero((lo < hi) & (j < sc_real) & torch.isfinite(ent)
                             & ~(ent > best_t[keep])).squeeze(1)
        if not take.numel():
            continue
        cols = j[take, None] * fi.SUB_BT + local
        g = pk[:, cols.clamp(max=pk.shape[1] - 1)]
        t, _, _, ok = ci._mt_test(
            g, slice(None), *(o[take, a:a + 1] for a in range(3)),
            *(d[take, a:a + 1] for a in range(3)))
        hit = (ok & (cols < n_tris) & (t > lo[take, None])
               & (t < hi[take, None]))
        tt, kk = _lane_tree_min(torch.where(hit, t, float("inf")),
                                local.expand(take.numel(), -1))
        slot = keep[take]
        nearer = tt < best_t[slot]
        best_t[slot] = torch.where(nearer, tt, best_t[slot])
        best_c[slot] = torch.where(nearer, j[take] * fi.SUB_BT + kk,
                                   best_c[slot])
        pairs += int((cols < n_tris).sum())
    return best_t, best_c.to(torch.int32), pairs


# columns of every tile that repeat an earlier column of it (the same lane a
# round later, a later lane in the same round, an earlier lane a round
# later): never a winner where the copies tie
_REPEATS = {32 + m: m for m in range(16)}
_REPEATS.update({80 + m: 64 + m for m in range(16)})
_REPEATS.update({96 + m: 16 + m for m in range(16)})


def _duplicated_pack(pack):
    """The soup's pack with exact copies: in every tile the columns of
    `_REPEATS`, and each odd tile a copy of the tile before it."""
    dup = pack.copy()
    for j in range(0, dup.shape[1], fi.SUB_BT):
        for k, src in _REPEATS.items():
            dup[:, j + k] = dup[:, j + src]
    for j in range(fi.SUB_BT, dup.shape[1], 2 * fi.SUB_BT):
        dup[:, j:j + fi.SUB_BT] = dup[:, j - fi.SUB_BT:j]
    return dup


@pytest.mark.parametrize("kind", ["soup", "duplicated"])
@pytest.mark.parametrize("spc", [1, 2, 8])
def test_slot_closest_walk_gives_the_plain_hit(soup, spc, kind):
    """The closest kernel's slot walk with the sub-box table (clusters of
    `spc` tiles), its skip and its (t, column) merge, against
    `pairs_closest_plain`, which tests every column of a slot's cluster: t
    and column equal bit for bit, the lowest column on exact ties (the
    `duplicated` pack's copies inside a tile and across tiles); slots with
    an out-of-range id or an empty interval give (inf, 0).  It tests no
    fewer pairs than the bound counts and, with more than one tile a
    cluster, fewer than a walk without the skip (on the soup)."""
    s = soup
    pack = _duplicated_pack(s["pack"]) if kind == "duplicated" else s["pack"]
    pk = _t(pack)
    sub8 = _t(fi.sub_aabbs(pack, N_TRIS))
    org, d, tmin, tmax = _port(s, "org", "dir", "tmin", "tmax")
    tmin = tmin.clone()
    tmin[::13] = 3.0  # some intervals start far out, some (tmax 2) are empty
    n_cl = pack.shape[1] // (spc * fi.SUB_BT)
    rng = np.random.default_rng(8)
    p = 3000
    sray = rng.integers(0, N_RAYS, p).astype(np.int32)
    scl = np.sort(rng.integers(0, n_cl, p)).astype(np.int32)
    bad = np.arange(p) % 50 == 7  # out-of-range ids, four kinds in turn
    which = np.arange(p) % 4
    sray[bad & (which == 0)] = -1
    sray[bad & (which == 1)] = N_RAYS
    scl[bad & (which == 2)] = -1
    scl[bad & (which == 3)] = n_cl
    t, col, pairs = _walk_closest(pk, n_cl, sub8, _t(sray), _t(scl), org, d,
                                  tmin, tmax, N_TRIS)
    good = np.nonzero(~bad)[0]
    want_t = torch.full((p,), float("inf"))
    want_c = torch.zeros(p, dtype=torch.int32)
    want_t[good], want_c[good] = pi.pairs_closest_plain(
        pk, n_cl, _t(sray[good]), _t(scl[good]), org, d, tmin, tmax, N_TRIS)
    assert torch.equal(t, want_t) and torch.equal(col, want_c)
    hit = torch.isfinite(t)
    assert 50 < int(hit.sum()) < good.size and not (col[~hit]).any()
    empty = (tmin >= tmax)[_t(sray[good]).long()]
    assert empty.any() and not hit[good][empty].any()
    if kind == "duplicated":
        local = (col[hit] % fi.SUB_BT).numpy()
        assert not np.isin(local, list(_REPEATS)).any()
        if spc > 1:  # a tie across tiles keeps the earlier tile's column
            assert (col[hit] // fi.SUB_BT % 2 == 0).all()
    r = _t(sray[good]).long()
    bound, _ = pi.slot_pair_tests(sub8, n_cl, _t(sray[good]), _t(scl[good]),
                                  org, d, tmin[r],
                                  torch.minimum(tmax[r], t[good]), N_TRIS)
    no_skip, _ = pi.slot_pair_tests(sub8, n_cl, _t(sray[good]),
                                    _t(scl[good]), org, d, tmin[r], tmax[r],
                                    N_TRIS)
    assert bound <= pairs <= no_skip
    if spc > 1 and kind == "soup":  # an odd copy shares its tile's box
        assert pairs < no_skip


def test_slot_pair_tests_count_the_entered_sub_clusters(soup):
    """The pair kernels' work count: with every (ray, cluster) slot, the
    real columns of the sub-clusters each ray enters, counted ray by ray
    over the whole sub-box table, and one box test per real sub-cluster."""
    s = soup
    pk, cl, sub, org, d, tmin, tmax = _port(s, "pack", "cl", "sub", "org",
                                            "dir", "tmin", "tmax")
    n_cl = cl.shape[1]
    sray = torch.arange(N_RAYS, dtype=torch.int32).repeat_interleave(n_cl)
    scl = torch.arange(n_cl, dtype=torch.int32).repeat(N_RAYS)
    hi = torch.minimum(tmax, torch.full_like(tmax, 3.0))
    sc_real = -(-N_TRIS // fi.SUB_BT)
    ent = fi.box_entry(sub[:, :sc_real], org, d, tmin, hi)
    cols = fi.real_columns(fi.SUB_BT, sc_real, N_TRIS, "cpu")
    want = int((torch.isfinite(ent).to(torch.int64) * cols).sum())
    got = pi.slot_pair_tests(sub, n_cl, sray, scl, org, d, tmin[sray.long()],
                             hi[sray.long()], N_TRIS, chunk=1000)
    assert got == (want, N_RAYS * sc_real)
    assert 0 < want < N_RAYS * N_TRIS


# ---- (b) the two passes ---------------------------------------------------


# the argument whose length a spied call logs: slots or rays
_COUNTED = {"pairs_closest": 2, "pairs_shadow": 4, "closest_hit_fine": 3,
            "shadow_logsum_fine": 4}


def _spy(monkeypatch, module, name, log):
    """Log (name, slots or rays) of every call of module.name."""
    fn = getattr(module, name)

    def call(*args, **kwargs):
        log.append((name, args[_COUNTED[name]].shape[0]))
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, call)


def test_closest_hit_pairs_matches_reference_route(soup, small_caps,
                                                   monkeypatch):
    s = soup
    log = []
    _spy(monkeypatch, pi, "pairs_closest", log)
    _spy(monkeypatch, fi, "closest_hit_fine", log)
    pk, cl, sub = _port(s, "pack", "cl", "sub")
    rays = _port(s, "org", "dir", "tmin", "tmax")
    t, col = (x.numpy() for x in pi.closest_hit_pairs(pk, cl, sub, *rays,
                                                      N_TRIS))
    pack = jnp.asarray(s["pack"])
    rt, rcol = (np.asarray(x) for x in pli._closest_hit_pairs(
        pack, jnp.pad(pack, ((0, 6), (0, 0))), jnp.asarray(s["cl"]),
        *_jnp(s, "org", "dir", "tmin", "tmax"), N_TRIS))
    # two rounds with slots, then stragglers through the fine kernel
    assert [k for k, _ in log] == ["pairs_closest", "pairs_closest",
                                   "closest_hit_fine"]
    assert all(n > 0 for _, n in log)
    hit = np.isfinite(rt)
    assert 30 < hit.sum() < N_RAYS
    assert np.array_equal(np.isfinite(t), hit)
    assert np.allclose(t[hit], rt[hit], rtol=1e-4)
    tri, rtri = s["pack"][9, col], s["pack"][9, rcol]
    flip = hit & (tri != rtri)
    assert _tie(s, col[flip], rcol[flip], t[flip], np.nonzero(flip)[0])
    # the exact nearest hit: the brute force's t, bit for bit
    bt, bcol = (x.numpy() for x in fi.closest_fine_plain(pk, *rays, N_TRIS))
    assert np.array_equal(t, bt) and np.array_equal(col[hit], bcol[hit])


def test_shadow_transmission_pairs_matches_reference_route(soup, small_caps,
                                                           monkeypatch):
    s = soup
    log = []
    _spy(monkeypatch, pi, "pairs_shadow", log)
    _spy(monkeypatch, fi, "shadow_logsum_fine", log)
    tr = pi.shadow_transmission_pairs(
        *_port(s, "pack", "cl", "sub", "filt4", "org", "dir", "dist"),
        N_TRIS).numpy()
    rtr = np.asarray(pli._shadow_transmission_pairs(
        jnp.asarray(s["pack"]), _pack16s(s["pack"], s["filt4"]),
        jnp.asarray(s["cl"]), *_jnp(s, "org", "dir", "dist"), N_TRIS))
    assert [k for k, _ in log] == ["pairs_shadow", "shadow_logsum_fine"]
    assert all(n > 0 for _, n in log)
    assert np.allclose(tr, rtr, atol=2e-3)
    assert (tr[::9] == 1.0).all()
    assert (tr < 1e-30).any() and ((tr > 0.01) & (tr < 0.99)).any()
    want = torch.exp(fi.shadow_logsum_fine_plain(
        _t(s["pack"]), ci.log_filter(_t(s["filt4"])),
        *_port(s, "org", "dir", "dist"), N_TRIS)).numpy()
    assert np.allclose(tr, want, atol=2e-3)


def test_passes_take_empty_ray_batches(soup):
    """No rays: no slots, no stragglers, no launch; empty results."""
    s = soup
    pk, cl, sub, filt4 = _port(s, "pack", "cl", "sub", "filt4")
    z3, z = torch.zeros((0, 3)), torch.zeros(0)
    t, col = pi.closest_hit_pairs(pk, cl, sub, z3, z3, z, z, N_TRIS)
    tr = pi.shadow_transmission_pairs(pk, cl, sub, filt4, z3, z3, z, N_TRIS)
    assert t.shape == col.shape == (0,) and tr.shape == (0, 3)


# ---- (c) the slice --------------------------------------------------------


@pytest.fixture(scope="module")
def grid10k(tmp_path_factory):
    return generate.write_grid_spheres(
        str(tmp_path_factory.mktemp("pairs") / "grid2_3.xml"), 2, 3)


def _setup(parse, build, config_cls, path, size):
    s = parse(path)
    s.render_params["width"] = size
    s.render_params["height"] = size
    cfg = build(s)
    return s, config_cls(**{**cfg.__dict__, "aa_passes": 1, "width": size,
                            "height": size, "aa_samples": 1})


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64)
                                  - np.asarray(b, np.float64)) ** 2)))


def test_grid10k_pairs_render_matches_reference_and_fine(grid10k,
                                                         monkeypatch):
    """The slice: the 10,252-triangle grid rendered by the port on the CPU
    with pairs=True, against the reference's CPU render and the port's own
    fine-route render (12², 1 spp, the scene's own settings)."""
    log = []
    _spy(monkeypatch, pi, "pairs_closest", log)
    _spy(monkeypatch, pi, "pairs_shadow", log)
    ps, pc = _setup(parse_xml_file, build_config, RenderConfig, grid10k, 12)
    cs = ps.compile(device="cpu", pairs=True)
    a, n = cs.arrays, cs.static.n_tris_real
    assert n == 10252 and a["tri_cluster8"].shape[1] == 81
    assert isect.route(a["tri_pack10"], a["tri_cluster8"], n,
                       cs.static.pairs) == "pairs"
    port = render(cs, pc, device="cpu")
    assert {k for k, _ in log} == {"pairs_closest", "pairs_shadow"}
    fine = render(ps.compile(device="cpu"), pc, device="cpu")
    rs, rc = _setup(ref_parse, ref_build, RefConfig, grid10k, 12)
    ref = ref_render(rs.compile(), rc)
    for other in (ref, fine):
        assert _rmse(other.image, port.image) <= 1e-4
        r_o, r_p = other.stats["rays"], port.stats["rays"]
        assert abs(r_p - r_o) <= 1e-4 * r_o, (r_o, r_p)
    assert np.isfinite(port.image).all() and port.image.mean() > 0.05


def test_render_scene_passes_pairs_to_compile(grid10k, monkeypatch):
    """render_scene(pairs=True) renders through the pair route; the default
    does not."""
    seen = []
    for name in ("closest_hit_pairs", "shadow_transmission_pairs"):
        fn = getattr(pi, name)
        monkeypatch.setattr(pi, name, lambda *a, fn=fn, name=name, **k: (
            seen.append(name), fn(*a, **k))[1])
    scene = parse_xml_file(grid10k)
    scene.render_params.update(width=4, height=4, AA_minsamples=1)
    render_scene(scene, device="cpu")
    assert not seen
    res = render_scene(scene, device="cpu", pairs=True)
    assert set(seen) == {"closest_hit_pairs", "shadow_transmission_pairs"}
    assert res.stats["rays"] > 0


# ---- (d) the routing ------------------------------------------------------


@pytest.mark.parametrize("n_tris, min_clusters, pairs, want", [
    (64, 4, True, "tiny"),
    (384, 4, True, "dense"),  # 3 clusters: below any pair minimum
    (896, 8, True, "stream"),  # 7 clusters
    (2999, 4, False, "fine"),  # not asked
    (2999, 64, True, "fine"),  # 24 clusters, below the real minimum
    (2999, 24, True, "pairs"),
    (2999, 4, True, "pairs"),
])
def test_route_takes_pairs_only_when_asked(soup, monkeypatch, n_tris,
                                           min_clusters, pairs, want):
    monkeypatch.setattr(pi, "PAIRS_MIN_CLUSTERS", min_clusters)
    pack = s_cl = None
    if n_tris == N_TRIS:
        pack, s_cl = soup["pack"], soup["cl"]
    else:
        pack, s_cl, _ = ci.build_tri_pack(soup["pack"][0:3, :n_tris].T,
                                          soup["pack"][3:6, :n_tris].T,
                                          soup["pack"][6:9, :n_tris].T)
    assert isect.route(_t(pack), _t(s_cl), n_tris, pairs) == want
    assert isect.route(_t(pack), _t(s_cl), n_tris) != "pairs"


def test_route_refuses_pairs_without_the_fine_stragglers(soup, monkeypatch):
    """5 clusters of 128 columns are 5 sub-clusters, too few for the fine
    kernels the pair route's stragglers need."""
    monkeypatch.setattr(pi, "PAIRS_MIN_CLUSTERS", 4)
    p = soup["pack"]
    pack, cl, _ = ci.build_tri_pack(p[0:3, :600].T, p[3:6, :600].T,
                                    p[6:9, :600].T)
    assert cl.shape[1] == 5
    with pytest.raises(ValueError, match="fine kernels"):
        isect.route(_t(pack), _t(cl), 600, True)


@pytest.mark.parametrize("pairs", [False, True])
def test_dispatch_by_static(soup, small_caps, monkeypatch, pairs):
    """ops/intersect.py reads the request from SceneStatic.pairs, and the
    pair passes answer as the fine route does."""
    s = soup
    pk, cl, sub, filt4 = _port(s, "pack", "cl", "sub", "filt4")
    arrays = {"tri_pack10": pk, "stri_pack10": pk, "tri_cluster8": cl,
              "stri_cluster8": cl, "tri_sub8": sub, "stri_sub8": sub,
              "sfilt4": filt4, "sfilt4_binary": filt4}
    static = SceneStatic(n_tris_real=N_TRIS, n_stris_real=N_TRIS, lights=(),
                         bg=None, mat_families=(), has_blend=0,
                         ray_min_dist=5e-5, shadow_bias=5e-4,
                         intersector="brute", chunk=8, pairs=pairs)
    log = []
    _spy(monkeypatch, pi, "pairs_closest", log)
    _spy(monkeypatch, pi, "pairs_shadow", log)
    org, d, tmin, tmax, dist = _port(s, "org", "dir", "tmin", "tmax", "dist")
    hit = isect.closest_hit(arrays, static, org, d, tmin, tmax)
    tr = isect.shadow_transmission(arrays, static, True, org, d, dist)
    assert bool(log) == pairs
    want_t, want_col = fi.closest_fine_plain(pk, org, d, tmin, tmax, N_TRIS)
    assert torch.equal(hit.t, want_t)
    assert torch.equal(hit.tri[hit.hit], pk[9, want_col.long()][hit.hit]
                       .to(torch.int32))
    want_tr = fi.shadow_transmission_fine(pk, cl, sub, filt4, org, d, dist,
                                          N_TRIS)
    assert torch.allclose(tr, want_tr, atol=2e-3)


# ---- (e) the wrappers -----------------------------------------------------


def test_wrappers_run_plain_on_cpu_and_count_nothing(soup):
    s = soup
    pk = _t(s["pack"])
    n_cl = s["cl"].shape[1]
    rng = np.random.default_rng(4)
    sray = _t(np.sort(rng.integers(0, N_RAYS, 300)).astype(np.int32))
    scl = _t(np.sort(rng.integers(0, n_cl, 300)).astype(np.int32))
    rays = _port(s, "org", "dir", "tmin", "tmax")
    logf = ci.log_filter(_t(s["filt4"]))
    sub = _t(s["sub"])
    before = (pi.pairs_closest.launches, pi.pairs_shadow.launches)
    want = pi.pairs_closest_plain(pk, n_cl, sray, scl, *rays, N_TRIS)
    for table in (sub, None):  # the tile walk's table, or the thread body
        got = pi.pairs_closest(pk, n_cl, table, sray, scl, *rays, N_TRIS)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    sh = (logf, sray, scl, *_port(s, "org", "dir", "dist"), N_TRIS)
    assert torch.equal(pi.pairs_shadow(pk, n_cl, sub, *sh),
                       pi.pairs_shadow_plain(pk, n_cl, *sh))
    empty = torch.zeros(0, dtype=torch.int32)
    t, col = pi.pairs_closest(pk, n_cl, sub, empty, empty, *rays, N_TRIS)
    lg = pi.pairs_shadow(pk, n_cl, sub, logf, empty, empty,
                         *_port(s, "org", "dir", "dist"), N_TRIS)
    assert t.shape == col.shape == (0,) and lg.shape == (0, 3)
    assert (pi.pairs_closest.launches, pi.pairs_shadow.launches) == before


@pytest.mark.parametrize("bad, err, match", [
    (dict(sray="int64"), TypeError, "int32"),
    (dict(scl="short"), ValueError, "shape"),
    (dict(n_cl=25), ValueError, "equal clusters"),
    (dict(n_tris=3073), ValueError, "n_tris"),
    (dict(org="double"), TypeError, "float32"),
    (dict(tmax="short"), ValueError, "shape"),
    (dict(logf="two rows"), ValueError, "rgb rows"),
    (dict(logf="two rows", sub8="short"), ValueError, "shape"),
    (dict(logf="two rows", n_cl=48), ValueError, "whole"),
    (dict(sub8="short"), ValueError, "shape"),
    (dict(n_cl=48), ValueError, "whole"),
])
def test_wrappers_reject_bad_inputs(soup, bad, err, match):
    s = soup
    kw = dict(pack10=_t(s["pack"]), n_cl=s["cl"].shape[1],
              sray=torch.zeros(8, dtype=torch.int32),
              scl=torch.zeros(8, dtype=torch.int32),
              org=_t(s["org"]), dirn=_t(s["dir"]), tmin=_t(s["tmin"]),
              tmax=_t(s["tmax"]), n_tris=N_TRIS)
    change = {"int64": lambda x: x.long(), "short": lambda x: x[:-1],
              "double": lambda x: x.double(), 25: lambda x: 25,
              48: lambda x: 48, 3073: lambda x: 3073}
    kw["sub8"] = _t(s["sub"])
    if "sub8" in bad:  # a sub-box table of another pack width
        kw["sub8"] = kw["sub8"][:, :-1].contiguous()
    for k, how in bad.items():
        if k not in ("logf", "sub8"):
            kw[k] = change[how](kw[k])
    with pytest.raises(err, match=match):
        if "logf" in bad:
            kw.pop("tmin")
            kw.pop("tmax")
            pi.pairs_shadow(logf=torch.zeros(2, s["pack"].shape[1]),
                            dist=_t(s["dist"]), **kw)
        else:
            pi.pairs_closest(**kw)


def test_soup_and_rays_equal_the_benchmark_scripts():
    """The port's copy of scripts/bench_intersect.py's make_soup /
    make_rays gives the same arrays."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        from bench_intersect import make_rays, make_soup
    finally:
        sys.path.pop(0)
    for a, b in zip(make_soup(5000, seed=2), generate.make_soup(5000, seed=2)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for kind in ("coherent", "incoherent"):
        for a, b in zip(make_rays(4096, kind), generate.make_rays(4096, kind)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
