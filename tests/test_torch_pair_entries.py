"""The pair route's ray-cluster entries and nearest-k pick
(libyafaray_tpu_torch/ops/pairs_intersect.py `nearest_clusters` and its
plain version; the kernel is csrc/pair_entries.cu) against the JAX
reference's `_ray_cluster_entries` with the stable `jnp.argsort` its
closest-hit pass takes (libyafaray_tpu/ops/pallas_intersect.py).

Three box tables, from the benchmarks' random soup (`scene/generate.py`
make_soup, Morton clusters that overlap everywhere) in the port's pack:
- "sub_boxes": 70,000 triangles, 69 clusters of 1,024 columns, each entry
  the minimum over a cluster's 8 sub-boxes (`pick_nsub` 8);
- "sub_box_pairs": 40,000 triangles, 157 clusters of 256 (`pick_nsub` 2);
- "cluster_boxes": 2,999 triangles, 24 clusters of 128 (`pick_nsub` 1);
- "sweeps": 300,000 triangles, 293 clusters of 1,024 whose 2,344 sub-boxes
  are more than MAX_NSUB_TABLE, so the cluster boxes, and more clusters
  than one sweep of the kernel (256).
Rays start inside the soup, so many origins lie in several boxes and enter
them all at `lo`: exact ties, which the reference breaks by the lower
cluster id.  Some intervals start at 0, some are short segments as shadow
rays have, some are empty.  Entries, ids and counts are compared bit for
bit; the kernel runs only on the card (chip_smoke.py holds it to the plain
version there), its selection is emulated here."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libyafaray_tpu.ops import pallas_intersect as pli
from libyafaray_tpu_torch.ops import cuda_intersect as ci
from libyafaray_tpu_torch.ops import fine_intersect as fi
from libyafaray_tpu_torch.ops import pairs_intersect as pi
from libyafaray_tpu_torch.scene.generate import make_rays, make_soup

N_RAYS = 512
TABLES = {"sub_boxes": 70_000, "sub_box_pairs": 40_000,
          "cluster_boxes": 2_999, "sweeps": 300_000}
_BIG = torch.iinfo(torch.int32).max


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions are many small tensor ops: one CPU thread runs
    them fastest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables():
    """{name: (cluster8, sub8, n_tris)} of the three soups' packs."""
    out = {}
    for name, n in TABLES.items():
        v0, e1, e2 = make_soup(n, seed=3)
        pack, cl8, _ = ci.build_tri_pack(v0, e1, e2,
                                         ci.morton_order(v0, e1, e2))
        out[name] = (torch.from_numpy(cl8),
                     torch.from_numpy(fi.sub_aabbs(pack, n)), n)
    return out


@pytest.fixture(scope="module")
def rays():
    """N_RAYS incoherent rays from inside the soup: intervals from 1e-3 to
    1e9, every 5th from 0, every 7th a segment as a shadow ray's
    (SHADOW_TMIN to a length in [0.5, 8)), every 11th empty."""
    org, d = (torch.from_numpy(x) for x in make_rays(N_RAYS, "incoherent",
                                                     seed=5))
    rng = np.random.default_rng(6)
    lo = torch.full((N_RAYS,), 1e-3)
    hi = torch.full((N_RAYS,), 1e9)
    lo[::5] = 0.0
    seg = torch.from_numpy(rng.uniform(0.5, 8.0, N_RAYS).astype(np.float32))
    lo[::7] = ci.SHADOW_TMIN
    hi[::7] = seg[::7]
    lo[::11], hi[::11] = 2.0, 1.0
    return org, d, lo, hi


def _bits(x):
    return x.contiguous().view(torch.int32)


def _stable_picks(ent, k: int):
    """numpy's stable argsort of each row of entries: (entries (N, k), ids
    (N, k) int32, n_cl past the finite ones, count of finite entries)."""
    e = ent.numpy()
    order = np.argsort(e, axis=1, kind="stable")[:, :k]
    v = np.take_along_axis(e, order, axis=1)
    ids = np.where(np.isfinite(v), order, e.shape[1]).astype(np.int32)
    return (torch.from_numpy(v), torch.from_numpy(ids),
            torch.from_numpy(np.isfinite(e).sum(axis=1).astype(np.int32)))


@pytest.mark.parametrize("table", list(TABLES))
def test_plain_breaks_ties_by_the_lower_cluster_id(tables, rays, table):
    """nearest_clusters_plain's ids are a stable sort of the port's own
    entries (`cluster_entries`, -0 read as +0): on rays whose origins lie in
    several boxes (ties at lo) the lower cluster id comes first."""
    cl8, sub8, n_tris = tables[table]
    org, d, lo, hi = rays
    k = 24
    ent = pi.cluster_entries(cl8, sub8, org, d, lo, hi, n_tris)
    ent = torch.where(ent == 0, 0.0, ent)
    want = _stable_picks(ent, k)
    got = pi.nearest_clusters_plain(cl8, sub8, org, d, lo, hi, n_tris, k)
    assert got[1].dtype == got[2].dtype == torch.int32
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    # the ties the rule decides: rays entering 2 or more clusters at lo
    at_lo = (got[0] == lo[:, None]).sum(dim=1)
    assert int((at_lo >= 2).sum()) >= 40
    assert (got[2] > 0).sum() > N_RAYS // 2 and (got[2] == 0).any()
    assert not got[2][::11].any()  # empty intervals enter nothing


@pytest.mark.parametrize("table", ["sub_boxes", "sub_box_pairs",
                                   "cluster_boxes"])
def test_picks_at_lo_match_the_reference_argsort(tables, rays, table):
    """The picks whose entry is lo (the boxes holding the ray's origin)
    equal the reference's `_ray_cluster_entries` + stable `jnp.argsort`
    picks at lo, in set and in order (the port's widened boxes and the
    reference's unwidened ones agree on origins well inside them).  The
    reference's slab enters an all-pad (inverted) sub-box at lo for every
    ray, the port never: the entry of the cluster that holds them is the
    reference's over its real sub-boxes alone."""
    cl8, sub8, n_tris = tables[table]
    org, d, lo, hi = rays
    k = 21
    n_cl, n_sc = cl8.shape[1], sub8.shape[1]
    n_sub = pi.pick_nsub(n_sc * fi.SUB_BT, n_sc * fi.SUB_BT // n_cl)
    assert n_sub == {"sub_boxes": 8, "sub_box_pairs": 2,
                     "cluster_boxes": 1}[table]
    rays_j = [jnp.asarray(x.numpy()) for x in (org, d, lo, hi)]
    ref = np.array(pli._ray_cluster_entries(
        *rays_j, jnp.asarray(cl8.numpy()), sub8=jnp.asarray(sub8.numpy()),
        n_sub=n_sub))
    sc_real = -(-n_tris // fi.SUB_BT)
    if n_sub > 1 and sc_real % n_sub:
        c, j0 = sc_real // n_sub, sc_real // n_sub * n_sub
        real = jnp.asarray(sub8[:, j0:sc_real].numpy())
        ref[:, c] = np.asarray(pli._ray_cluster_entries(
            *rays_j, real, sub8=real, n_sub=sc_real - j0))[:, 0]
    r_idx = np.argsort(ref, axis=1, kind="stable")[:, :k]
    assert np.array_equal(r_idx, np.asarray(jnp.argsort(ref, axis=1))[:, :k])
    r_ent = np.take_along_axis(ref, r_idx, axis=1)
    ent, ids, _ = pi.nearest_clusters(cl8, sub8, org, d, lo, hi, n_tris, k)
    lo_np = lo.numpy()[:, None]
    mine = ent.numpy() == lo_np
    theirs = r_ent == lo_np
    rows = 0
    for r in range(N_RAYS):
        assert list(ids.numpy()[r][mine[r]]) == list(r_idx[r][theirs[r]]), r
        rows += int(mine[r].sum() >= 2)
    assert rows >= 40


def _kernel_picks(cl8, sub8, org, dirn, lo, hi, n_tris: int, k: int):
    """The card kernel's answer in plain PyTorch: a test of every real
    cluster box and, where the entries take the sub-boxes, of the real
    sub-boxes of each entered cluster, their minimum the cluster's entry
    (-0 as +0); clusters met in sweeps of 256, each sweep's entries merged
    with the picks held so far by up to k rounds of the least (entry, id),
    ending at the first inf.  Returns (entries, ids, count, box tests)."""
    n, n_cl, n_sc = org.shape[0], cl8.shape[1], sub8.shape[1]
    bt = n_sc * fi.SUB_BT // n_cl
    n_sub = pi.pick_nsub(n_sc * fi.SUB_BT, bt)
    cl_real, sc_real = -(-n_tris // bt), -(-n_tris // fi.SUB_BT)
    ent = fi.box_entry(cl8[:, :cl_real], org, dirn, lo, hi)
    tests = n * cl_real
    if n_sub > 1:
        entered = torch.isfinite(ent)
        ent = torch.full_like(ent, float("inf"))
        for b in range(n_sub):
            j = torch.arange(cl_real) * n_sub + b
            real = j < sc_real
            e = fi.box_entry(sub8[:, j.clamp(max=sc_real - 1)], org, dirn, lo,
                             hi)
            tests += int((entered & real).sum())
            take = entered & real & torch.isfinite(e)
            ent = torch.where(take, torch.minimum(ent, e), ent)
    ent = torch.where(ent == 0, 0.0, ent)
    count = torch.isfinite(ent).sum(dim=1, dtype=torch.int32)
    pe = torch.full((n, k), float("inf"))
    pid = torch.full((n, k), n_cl, dtype=torch.int32)
    for c0 in range(0, cl_real, 256):
        c1 = min(c0 + 256, cl_real)
        cand_e = torch.cat([pe, ent[:, c0:c1]], dim=1)
        cand_i = torch.cat([pid, torch.arange(c0, c1, dtype=torch.int32)
                            .expand(n, -1)], dim=1)
        for q in range(k):
            m = cand_e.amin(dim=1)
            w = torch.where(cand_e == m[:, None], cand_i, _BIG).amin(dim=1)
            live = torch.isfinite(m)
            pe[:, q] = torch.where(live, m, float("inf"))
            pid[:, q] = torch.where(live, w, n_cl)
            cand_e = torch.where((cand_i == w[:, None]) & live[:, None],
                                 float("inf"), cand_e)
    return pe, pid, count, tests


@pytest.mark.parametrize("k", [21, 24])
@pytest.mark.parametrize("table", list(TABLES))
def test_kernel_selection_gives_the_plain_picks(tables, rays, table, k):
    """The kernel's walk (cluster boxes first, sub-boxes only of entered
    clusters) and its sweep-by-sweep merge give the plain version's
    entries, ids and counts bit for bit, with k = 21 (closest hits) and 24
    (shadows), on both tables and over more than one sweep; its box tests
    are the bound's (`entry_box_tests`), fewer than the plain slab's where
    it takes the sub-boxes."""
    cl8, sub8, n_tris = tables[table]
    org, d, lo, hi = rays
    e, ids, cnt, tests = _kernel_picks(cl8, sub8, org, d, lo, hi, n_tris, k)
    pe, pids, pcnt = pi.nearest_clusters_plain(cl8, sub8, org, d, lo, hi,
                                               n_tris, k)
    assert torch.equal(_bits(e), _bits(pe))
    assert torch.equal(ids, pids) and torch.equal(cnt, pcnt)
    assert (cnt < k).any()
    bound, whole = pi.entry_box_tests(cl8, sub8, org, d, lo, hi, n_tris)
    assert tests == bound
    if table.startswith("sub_box"):  # 8 or 2 sub-boxes a cluster
        assert bound < (0.5 if table == "sub_boxes" else 0.7) * whole
    else:
        assert bound == whole
    if table == "sweeps":  # rows cut at k, picks from both sweeps
        assert cl8.shape[1] > 256 and (cnt > k).any()
        assert (pids[:, 0] >= 256).any() and (pids < 256).any()


def test_wrapper_runs_plain_on_cpu_and_counts_nothing(tables, rays):
    cl8, sub8, n_tris = tables["sub_boxes"]
    org, d, lo, hi = rays
    before = pi.nearest_clusters.launches
    for k in (1, 21, 24, 32):
        got = pi.nearest_clusters(cl8, sub8, org, d, lo, hi, n_tris, k)
        want = pi.nearest_clusters_plain(cl8, sub8, org, d, lo, hi, n_tris,
                                         k)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert got[0].shape == got[1].shape == (N_RAYS, k)
    z3, z = torch.zeros((0, 3)), torch.zeros(0)
    e, ids, cnt = pi.nearest_clusters(cl8, sub8, z3, z3, z, z, n_tris, 21)
    assert e.shape == ids.shape == (0, 21) and cnt.shape == (0,)
    assert ids.dtype == cnt.dtype == torch.int32
    assert pi.nearest_clusters.launches == before


@pytest.mark.parametrize("bad, err, match", [
    (dict(org="double"), TypeError, "float32"),
    (dict(lo="short"), ValueError, "shape"),
    (dict(hi="meta"), ValueError, "expected cpu"),
    (dict(k=33), ValueError, "k=33"),
    (dict(k=0), ValueError, "k=0"),
    (dict(table="cluster_boxes", k=25), ValueError, "k=25"),
    (dict(sub8="short"), ValueError, "equal clusters"),
    (dict(n_tris=70_657), ValueError, "n_tris"),
    (dict(all="meta"), ValueError, "unsupported device"),
])
def test_wrapper_rejects_bad_inputs(tables, rays, bad, err, match):
    table = bad.get("table", "sub_boxes")
    cl8, sub8, n_tris = tables[table]
    org, d, lo, hi = rays
    kw = dict(cluster8=cl8, sub8=sub8, org=org, dirn=d, lo=lo, hi=hi,
              n_tris=n_tris, k=bad.get("k", 21))
    change = {"double": lambda x: x.double(), "short": lambda x: x[:-1],
              "meta": lambda x: x.to("meta")}
    for key, how in bad.items():
        if key == "all":
            for name in ("cluster8", "sub8", "org", "dirn", "lo", "hi"):
                kw[name] = change[how](kw[name])
        elif key == "sub8":  # a table of one sub-box fewer
            kw["sub8"] = sub8[:, :-1].contiguous()
        elif key not in ("k", "table"):
            kw[key] = change[how](kw[key]) if isinstance(how, str) else how
    with pytest.raises(err, match=match):
        pi.nearest_clusters(**kw)
