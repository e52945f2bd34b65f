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
them to these plain versions there."""
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
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_string

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


@pytest.mark.parametrize("grid, pack_w, n_cl", [(1, 256, 2), (2, 768, 6)])
def test_compile_packs_generated_scene_like_reference(scenes, grid, pack_w,
                                                      n_cl):
    """The port's compile of a generated mid-size scene gives the
    reference's pack, cluster boxes and shadow filters."""
    ref = scenes[f"grid{grid}"]
    port = parse_xml_string(grid_spheres_xml(grid, 1, 2, 16)).compile(
        device="cpu")
    assert port.static.n_tris_real == ref.static.n_tris_real
    assert port.arrays["tri_pack10"].shape == (10, pack_w)
    assert port.arrays["tri_cluster8"].shape == (8, n_cl)
    for k in ("tri_pack10", "tri_cluster8", "stri_pack10", "stri_cluster8",
              "sfilt4", "sfilt4_binary"):
        assert np.array_equal(port.arrays[k], ref.arrays[k]), k


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
    tc, col = wrapper(_t(pack), _t(c8), _t(o), _t(d), _t(tmin), _t(tmax),
                      n_tris)
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
    tr = wrapper(_t(pack), _t(c8), _t(filt4), _t(o), _t(d), _t(dist),
                 n_tris).numpy()
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
    lg = cl.shadow_logsum_dense(args[0], _t(c8), *args[1:])
    assert torch.equal(lg, torch.full((1, 3), -240.0))


def test_box_entry_never_skips_a_hit(cases):
    """The widened boxes the kernels skip by: every hit's cluster is
    entered no further than the hit, so a ray never skips the box of its
    hit; the pair counts of chip_smoke.py's bounds lie between the hits'
    clusters and the brute force."""
    pack, c8, n_tris, o, d = cases["grid2"]
    n = o.shape[0]
    org, dirn = _t(o), _t(d)
    lo, hi = torch.full((n,), 5e-5), torch.full((n,), float("inf"))
    t, col = cl.closest_stream_plain(_t(pack), org, dirn, lo, hi, n_tris)
    hit = torch.isfinite(t)
    bt = pack.shape[1] // c8.shape[1]
    ent = fi.box_entry(_t(c8), org, dirn, lo, hi)
    own = ent[hit, col[hit].long() // bt]
    assert (own <= t[hit]).all()
    before_hit = torch.minimum(hi, t)
    pairs, boxes = cl.cluster_pair_tests(_t(pack), _t(c8), org, dirn, lo,
                                         before_hit, n_tris)
    assert int(hit.sum()) <= pairs < n * n_tris
    assert boxes == n * c8.shape[1]
    # 128-column clusters: each is its own single sub-cluster, so the fine
    # count finds the same pairs and adds one box test per entered cluster
    entered = int(torch.isfinite(fi.box_entry(_t(c8), org, dirn, lo,
                                              before_hit)).sum())
    f_pairs, f_boxes = fi.fine_pair_tests(
        _t(c8), _t(fi.sub_aabbs(pack, n_tris)), org, dirn, lo, before_hit,
        n_tris)
    assert (f_pairs, f_boxes) == (pairs, boxes + entered)


def test_cluster_wrappers_route_cpu_to_plain_and_count_nothing(cases):
    pack, c8, n_tris, o, d = cases["grid2"]
    n = o.shape[0]
    lim = (torch.full((n,), 5e-5), torch.full((n,), float("inf")))
    wrappers = (cl.closest_hit_dense, cl.closest_hit_stream,
                cl.shadow_logsum_dense, cl.shadow_logsum_stream)
    before = [w.launches for w in wrappers]
    for kind in ("dense", "stream"):
        got = getattr(cl, f"closest_hit_{kind}")(
            _t(pack), _t(c8), _t(o), _t(d), *lim, n_tris)
        want = getattr(cl, f"closest_{kind}_plain")(
            _t(pack), _t(o), _t(d), *lim, n_tris)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        logf = torch.full((3, pack.shape[1]), -1.0)
        got = getattr(cl, f"shadow_logsum_{kind}")(
            _t(pack), _t(c8), logf, _t(o), _t(d), torch.full((n,), 3.0),
            n_tris)
        assert got.shape == (n, 3)
    assert [w.launches for w in wrappers] == before


def test_cluster_wrappers_reject_bad_inputs(cases):
    pack, c8, n_tris, o, d = cases["grid2"]
    n = o.shape[0]
    pk, c, org, dirn = _t(pack), _t(c8), _t(o), _t(d)
    lim = torch.zeros(n)
    with pytest.raises(ValueError, match="equal clusters"):
        cl.closest_hit_dense(pk, torch.zeros((8, 5)), org, dirn, lim, lim,
                             n_tris)
    with pytest.raises(ValueError, match="at most"):  # 12 clusters of 64
        cl.closest_hit_stream(pk, torch.zeros((8, 12)), org, dirn, lim, lim,
                              n_tris)
    with pytest.raises(ValueError, match="n_tris"):
        cl.closest_hit_stream(pk, c, org, dirn, lim, lim, pack.shape[1] + 1)
    with pytest.raises(TypeError):
        cl.closest_hit_dense(pk, c, org.double(), dirn, lim, lim, n_tris)
    with pytest.raises(ValueError, match="rgb rows"):
        cl.shadow_logsum_stream(pk, c, torch.zeros(2, pack.shape[1]), org,
                                dirn, lim, n_tris)
    with pytest.raises(ValueError, match="shared"):  # 6 x 1,024 columns
        cl.shadow_logsum_dense(torch.zeros((10, 6144)), c, torch.zeros(
            (3, 6144)), org, dirn, lim, n_tris)
