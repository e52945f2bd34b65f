"""The threaded-BVH walks: the intersector of scenes above MAX_TRIS = 2^20
triangles.  CUDA wrappers and their plain PyTorch versions.

Port of libyafaray_tpu/ops/bvh_traverse.py (`closest_hit_bvh`,
`shadow_transmission_bvh`), which the reference writes as a
`lax.while_loop`, not as a Pallas kernel.  On the card each walk is a
hand-written kernel of csrc/bvh_walk.cu walking the threaded node array of
accel/bvh.py without a stack, over the card's layout of it (`pack_bvh`);
the plain versions are the reference's lockstep walk: every
live lane takes one node a step, tests its box and, in an entered leaf,
its <= LEAF_SIZE triangles.  Both repeat the reference's arithmetic in its
order, every dot and cross product component by component, and every ray
visits the same nodes in the same order in both, so the kernels are
bit-equal to the plain versions on the card (t, tri, u, v; the log sums
and the blocked flags).

The scene side of a walk: `bvh`, accel/bvh.py's arrays as tensors
(BVH_KEYS: bb_min, bb_max, hit_next, miss_next, first_tri, tri_count,
tri_order) and, for the card, their packed rows (PACKED_KEYS, made once a
scene by `pack_bvh`); and tri9, the (T, 9) v0 | e1 | e2 rows of the
triangles it was built over.  `tri` is a triangle's row in tri9.  The
shadow walk reads lf4 (T, 4) in the BVH's leaf order (row j for triangle
tri_order[j], `leaf_lf4`): each triangle's log filter rgb,
log(max(filter, 1e-12)), and 1 where it is opaque (its largest filter <
1e-6), made once per scene by `log_filter4`.

Each wrapper takes the plain version only for CPU tensors; for CUDA
tensors it launches its kernel on the current stream or raises, and
counts the launch in its `launches` attribute.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..accel.bvh import LEAF_SIZE
from . import _build
from .cuda_intersect import NEG_EPS, SHADOW_TMIN, _check, _mt_test, _raise_on

BVH_KEYS = ("bb_min", "bb_max", "hit_next", "miss_next", "first_tri",
            "tri_count", "tri_order")


def log_filter4(filt: torch.Tensor) -> torch.Tensor:
    """(T, 4) float32 lf4 rows from per-triangle shadow filters (T, 3) or
    (T, 1) (the binary filters): log(max(filt, 1e-12)) on three channels,
    and 1.0 where max(filt) < 1e-6 (opaque), as the reference's walk
    derives them."""
    logf = torch.log(torch.clamp(filt, min=1e-12)).expand(filt.shape[0], 3)
    opaque = (filt.amax(dim=-1) < 1e-6).to(torch.float32)
    return torch.cat([logf, opaque[:, None]], dim=1).contiguous()


def inv_dir(dirn: torch.Tensor) -> torch.Tensor:
    """1 / dirn with |d| < 1e-12 set to +-1e-12 first (the reference's
    guard)."""
    d = torch.where(dirn.abs() < NEG_EPS,
                    torch.where(dirn < 0, -NEG_EPS, NEG_EPS), dirn)
    return torch.ones_like(d) / d


# ---- the card's layout ----------------------------------------------------

# a BVH dict's packed rows, beside BVH_KEYS: nodes (N, 8) float32, two
# float4 a node, (min xyz, miss_next) and (max xyz, leaf word), the int32s
# stored as their bits; tris (T, 12) float32, the triangles in leaf order
# (row j is triangle tri_order[j]), (v0, index) (e1, 0) (e2, 0), the index
# stored as its bits
PACKED_KEYS = ("nodes", "tris")
# a leaf word: first << LEAF_BITS | count; -1 for an inner node
LEAF_BITS = 3


def pack_bvh(bvh: dict, tri9) -> dict:
    """`bvh` (numpy BVH_KEYS arrays) with PACKED_KEYS added, for the
    triangles tri9 (T, 9) it was built over.  hit_next is left implicit:
    the builders thread the nodes in depth-first pre-order, so an inner
    node's hit_next is node + 1 and a leaf's its miss_next; raises
    ValueError where that does not hold, or where a leaf holds more than
    LEAF_SIZE triangles or a range outside the triangles."""
    hit = np.asarray(bvh["hit_next"], np.int32)
    miss = np.asarray(bvh["miss_next"], np.int32)
    first = np.asarray(bvh["first_tri"], np.int32)
    count = np.asarray(bvh["tri_count"], np.int32)
    order = np.asarray(bvh["tri_order"], np.int32)
    tri9 = np.asarray(tri9, np.float32)
    n, t = hit.shape[0], order.shape[0]
    if n == 0 or t == 0 or tri9.shape != (t, 9):
        raise ValueError(f"pack_bvh: {n} nodes over {t} triangles, tri9 "
                         f"{tri9.shape}")
    leaf = first >= 0
    node = np.arange(n, dtype=np.int64)
    if not (np.array_equal(hit[~leaf], node[~leaf] + 1)
            and np.array_equal(hit[leaf], miss[leaf])):
        raise ValueError("pack_bvh: the nodes are not threaded in "
                         "depth-first pre-order (hit_next is not node + 1 "
                         "at an inner node and miss_next at a leaf)")
    if t >= 1 << (31 - LEAF_BITS) or np.any(
            (count[leaf] < 1) | (count[leaf] > LEAF_SIZE)
            | (first[leaf].astype(np.int64) + count[leaf] > t)):
        raise ValueError("pack_bvh: a leaf's range does not fit its word "
                         "or the triangles")
    nodes = np.zeros((n, 8), np.float32)
    nodes[:, 0:3] = np.asarray(bvh["bb_min"], np.float32)
    nodes[:, 4:7] = np.asarray(bvh["bb_max"], np.float32)
    words = nodes.view(np.int32)
    words[:, 3] = miss
    words[:, 7] = np.where(leaf, (first << LEAF_BITS) | count, -1)
    tris = np.zeros((t, 12), np.float32)
    g = tri9[order]
    for k in range(3):
        tris[:, 4 * k:4 * k + 3] = g[:, 3 * k:3 * k + 3]
    tris.view(np.int32)[:, 3] = order
    return {**bvh, "nodes": nodes, "tris": tris}


def leaf_lf4(bvh: dict, lf4) -> np.ndarray:
    """lf4's rows (numpy) in the BVH's leaf order, as the shadow walks read
    them: row j is triangle tri_order[j]'s."""
    return np.ascontiguousarray(np.asarray(lf4)[np.asarray(bvh["tri_order"])])


def _entered(bvh, node, org, iv, lo, hi):
    """The reference's `_aabb_hit` of each lane's node box."""
    b0, b1 = bvh["bb_min"][node], bvh["bb_max"][node]
    t0 = (b0 - org) * iv
    t1 = (b1 - org) * iv
    tlo, thi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    enter = torch.maximum(torch.maximum(torch.maximum(tlo[:, 0], tlo[:, 1]),
                                        tlo[:, 2]), lo)
    exit_ = torch.minimum(torch.minimum(torch.minimum(thi[:, 0], thi[:, 1]),
                                        thi[:, 2]), hi)
    return enter <= exit_


def _leaf_tests(bvh, tri9, node, org, dirn):
    """(j, tri, t, u, v, ok, in_leaf) of slot k = 0..LEAF_SIZE-1 of each
    lane's node, as a generator: j the slot's place in leaf order, ok the
    det / barycentric test alone."""
    order = bvh["tri_order"]
    first, cnt = bvh["first_tri"][node], bvh["tri_count"][node]
    ox, oy, oz = org.unbind(-1)
    dx, dy, dz = dirn.unbind(-1)
    for k in range(LEAF_SIZE):
        j = torch.clamp(first + k, 0, order.shape[0] - 1)
        ti = order[j]
        t, u, v, ok = _mt_test(tri9[ti].T, slice(None), ox, oy, oz, dx, dy,
                               dz)
        yield j, ti, t, u, v, ok, k < cnt


class _Lanes:
    """The lanes of a lockstep walk: per-lane state tensors, narrowed to
    the lanes still walking once a quarter of them has finished (a
    finished lane is masked until then); `compact` first writes every
    lane's results into the full-size outputs."""

    def __init__(self, n, device, **state):
        self.idx = torch.arange(n, device=device)
        self.state = state

    def live(self, active, out: dict) -> bool:
        """False once no lane is active (the outputs then hold every
        result); narrows the lanes when a quarter of them is done."""
        m = active.shape[0]
        n_alive = int(active.sum())
        if n_alive <= (3 * m) // 4:
            for k, o in out.items():
                o[self.idx] = self.state[k]
            self.idx = self.idx[active]
            self.state = {k: v[active] for k, v in self.state.items()}
        return n_alive > 0


def closest_bvh_plain(bvh: dict, tri9, org, dirn, tmin, tmax,
                      counts: bool = False):
    """Nearest hit of each ray in (tmin, tmax) by the reference's lockstep
    walk.  Returns (t (inf on a miss), tri (int32, 0 on a miss), u, v);
    with counts=True also (N, 2) int64 per ray: nodes visited, triangle
    tests made."""
    n, dev = org.shape[0], org.device
    out = dict(t=torch.full((n,), float("inf"), device=dev),
               tri=torch.zeros((n,), dtype=torch.int32, device=dev),
               u=torch.zeros((n,), device=dev),
               v=torch.zeros((n,), device=dev),
               nodes=torch.zeros((n,), dtype=torch.int64, device=dev),
               tests=torch.zeros((n,), dtype=torch.int64, device=dev))
    w = _Lanes(n, dev, node=torch.zeros((n,), dtype=torch.int32, device=dev),
               org=org, dirn=dirn, iv=inv_dir(dirn), lo=tmin, hi=tmax,
               **{k: v.clone() for k, v in out.items()})
    while w.live(w.state["node"] >= 0, out):
        s = w.state
        active = s["node"] >= 0
        node = torch.clamp(s["node"], min=0)
        entered = active & _entered(bvh, node, s["org"], s["iv"], s["lo"],
                                    torch.minimum(s["hi"], s["t"]))
        is_leaf = bvh["first_tri"][node] >= 0
        do_leaf = entered & is_leaf
        bt, btri, bu, bv = s["t"], s["tri"], s["u"], s["v"]
        if counts:
            s["nodes"] += active
        for _, ti, t, u, v, ok, in_leaf in _leaf_tests(bvh, tri9, node,
                                                        s["org"],
                                                        s["dirn"]):
            in_leaf = do_leaf & in_leaf
            ok = (ok & (t > s["lo"]) & (t < torch.minimum(s["hi"], bt))
                  & in_leaf)
            better = ok & (t < bt)
            bt = torch.where(better, t, bt)
            btri = torch.where(better, ti, btri)
            bu = torch.where(better, u, bu)
            bv = torch.where(better, v, bv)
            if counts:
                s["tests"] += in_leaf
        nxt = torch.where(entered & ~is_leaf, bvh["hit_next"][node],
                          bvh["miss_next"][node])
        s.update(t=bt, tri=btri, u=bu, v=bv,
                 node=torch.where(active, nxt, s["node"]))
    res = (out["t"], out["tri"], out["u"], out["v"])
    if counts:
        return res + (torch.stack([out["nodes"], out["tests"]], dim=1),)
    return res


def shadow_bvh_plain(bvh: dict, tri9, lf4, org, dirn, tmax,
                     counts: bool = False):
    """(N, 3) sum of the log filters (lf4 in leaf order) of the triangles
    each ray crosses at t in (5e-4, tmax), and (N,) bool: it crossed an
    opaque one, by the
    reference's lockstep walk (a lane stops after the leaf of its first
    opaque crossing).  With counts=True also (N, 2) int64 per ray: nodes
    visited, triangle tests made."""
    n, dev = org.shape[0], org.device
    out = dict(lg=torch.zeros((n, 3), device=dev),
               blocked=torch.zeros((n,), dtype=torch.bool, device=dev),
               nodes=torch.zeros((n,), dtype=torch.int64, device=dev),
               tests=torch.zeros((n,), dtype=torch.int64, device=dev))
    lo = torch.full((n,), SHADOW_TMIN, device=dev)
    w = _Lanes(n, dev, node=torch.zeros((n,), dtype=torch.int32, device=dev),
               org=org, dirn=dirn, iv=inv_dir(dirn), lo=lo, hi=tmax,
               **{k: v.clone() for k, v in out.items()})
    while w.live((w.state["node"] >= 0) & ~w.state["blocked"], out):
        s = w.state
        active = (s["node"] >= 0) & ~s["blocked"]
        node = torch.clamp(s["node"], min=0)
        entered = active & _entered(bvh, node, s["org"], s["iv"], s["lo"],
                                    s["hi"])
        is_leaf = bvh["first_tri"][node] >= 0
        do_leaf = entered & is_leaf
        lg, blocked = s["lg"], s["blocked"]
        if counts:
            s["nodes"] += active
        for j, _, t, _, _, ok, in_leaf in _leaf_tests(bvh, tri9, node,
                                                      s["org"], s["dirn"]):
            in_leaf = do_leaf & in_leaf
            ok = ok & (t > s["lo"]) & (t < s["hi"]) & in_leaf
            f = lf4[j]
            blocked = blocked | (ok & (f[:, 3] != 0))
            lg = lg + torch.where(ok[:, None], f[:, :3], 0.0)
            if counts:
                s["tests"] += in_leaf
        nxt = torch.where(entered & ~is_leaf, bvh["hit_next"][node],
                          bvh["miss_next"][node])
        s.update(lg=lg, blocked=blocked,
                 node=torch.where(active, nxt, s["node"]))
    res = (out["lg"], out["blocked"])
    if counts:
        return res + (torch.stack([out["nodes"], out["tests"]], dim=1),)
    return res


# ---- CUDA wrappers --------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "bvh_closest_launch": [_P] * 6 + [_I] + [_P] * 9,
    "bvh_shadow_launch": [_P] * 6 + [_I] + [_P] * 7,
    "bvh_closest_before_launch": [_P] * 7 + [_I] + [_P] * 5 + [_I]
    + [_P] * 5,
    "bvh_shadow_before_launch": [_P] * 7 + [_I] + [_P] * 5 + [_I]
    + [_P] * 3,
}


def _lib() -> ctypes.CDLL:
    lib = _build.load("bvh_walk")
    if lib.bvh_closest_launch.argtypes is None:
        for name, argtypes in _SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = _I
    return lib


def _check_rows(name: str, x, rows: int, cols: int, device) -> None:
    """A packed table: float32 (rows, cols), contiguous, on `device`, on a
    16-byte boundary (the kernels read it as float4s)."""
    _check(name, x, (rows, cols), device)
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: must start on a 16-byte boundary")


def _check_bvh(bvh: dict, tri9, device) -> None:
    """BVH_KEYS, tri9 and, where present (the card's walks need them),
    PACKED_KEYS."""
    n_nodes = bvh["bb_min"].shape[0]
    for k in BVH_KEYS:
        x = bvh[k]
        if x.device != device or not x.is_contiguous():
            raise ValueError(f"bvh[{k!r}]: must be contiguous on {device}")
        want = torch.float32 if k.startswith("bb_") else torch.int32
        if x.dtype != want:
            raise TypeError(f"bvh[{k!r}]: expected {want}, got {x.dtype}")
        if k.startswith("bb_"):
            shape = (n_nodes, 3)
        elif k == "tri_order":
            shape = (x.shape[0],)
        else:
            shape = (n_nodes,)
        if tuple(x.shape) != shape:
            raise ValueError(f"bvh[{k!r}]: shape {tuple(x.shape)}, "
                             f"expected {shape}")
    if n_nodes == 0 or bvh["tri_order"].shape[0] == 0:
        raise ValueError("empty BVH")
    _check("tri9", tri9, (None, 9), device)
    if "nodes" in bvh or device.type == "cuda":
        missing = [k for k in PACKED_KEYS if k not in bvh]
        if missing:
            raise ValueError(f"bvh lacks {missing}: the card's walks read "
                             "the packed rows (pack_bvh)")
        _check_rows("bvh['nodes']", bvh["nodes"], n_nodes, 8, device)
        _check_rows("bvh['tris']", bvh["tris"], tri9.shape[0], 12, device)


def _check_rays(org, dirn, device, **per_ray) -> int:
    n = org.shape[0]
    _check("org", org, (n, 3), device)
    _check("dirn", dirn, (n, 3), device)
    for name, x in per_ray.items():
        _check(name, x, (n,), device)
    return n


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _count_buffers(bvh, tri9, n, counts: bool) -> tuple:
    """The counting launch's zeroed outputs (per-ray visits and tests,
    nodes and triangles touched), or three null pointers."""
    if not counts:
        return (), (0, 0, 0)
    dev = tri9.device
    bufs = (torch.zeros((n, 2), dtype=torch.int32, device=dev),
            torch.zeros(bvh["bb_min"].shape[0], dtype=torch.uint8,
                        device=dev),
            torch.zeros(tri9.shape[0], dtype=torch.uint8, device=dev))
    return bufs, tuple(b.data_ptr() for b in bufs)


def _closest_out(n, dev) -> tuple:
    return (torch.empty((n,), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev),
            torch.empty((n,), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=torch.float32, device=dev))


def _shadow_out(n, dev) -> tuple:
    return (torch.empty((n, 3), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=torch.bool, device=dev))


def _ptrs(*xs) -> tuple:
    return tuple(x.data_ptr() for x in xs)


def _closest_launch(bvh, tri9, org, dirn, tmin, tmax, counts=False):
    dev, n = org.device, org.shape[0]
    out = _closest_out(n, dev)
    bufs, ptrs = _count_buffers(bvh, tri9, n, counts)
    counter = torch.empty((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = _lib().bvh_closest_launch(
            *_ptrs(bvh["nodes"], bvh["tris"], org, dirn, tmin, tmax), n,
            *_ptrs(*out, counter), *ptrs, _stream(dev))
    _raise_on(code, "closest_hit_bvh")
    return (*out, torch.isfinite(out[0])), bufs


def _shadow_launch(bvh, tri9, lf4, org, dirn, tmax, counts=False):
    dev, n = org.device, org.shape[0]
    out = _shadow_out(n, dev)
    bufs, ptrs = _count_buffers(bvh, tri9, n, counts)
    counter = torch.empty((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = _lib().bvh_shadow_launch(
            *_ptrs(bvh["nodes"], bvh["tris"], lf4, org, dirn, tmax), n,
            *_ptrs(*out, counter), *ptrs, _stream(dev))
    _raise_on(code, "shadow_logsum_bvh")
    return out, bufs


def closest_hit_bvh(bvh: dict, tri9, org, dirn, tmin, tmax):
    """(t, tri (int32), u, v, hit) of each ray's nearest hit in (tmin,
    tmax) over the BVH's triangles; t = inf and tri 0 on a miss; the first
    winner in walk order keeps a tie.

    bvh: BVH_KEYS tensors (float32 boxes, int32 indices), with PACKED_KEYS
    for CUDA tensors; tri9 (T, 9), org/dirn (N, 3), tmin/tmax (N,):
    float32, contiguous, one device."""
    dev = org.device
    _check_bvh(bvh, tri9, dev)
    _check_rays(org, dirn, dev, tmin=tmin, tmax=tmax)
    if dev.type == "cpu":
        t, tri, u, v = closest_bvh_plain(bvh, tri9, org, dirn, tmin, tmax)
        return t, tri, u, v, torch.isfinite(t)
    if dev.type != "cuda":
        raise ValueError(f"closest_hit_bvh: unsupported device {dev}")
    out, _ = _closest_launch(bvh, tri9, org, dirn, tmin, tmax)
    _WRAPPERS["closest_hit_bvh"].launches += 1
    return out


closest_hit_bvh.launches = 0


def _check_shadow(bvh, tri9, lf4, org, dirn, tmax) -> None:
    dev = org.device
    _check_bvh(bvh, tri9, dev)
    _check_rows("lf4", lf4, tri9.shape[0], 4, dev)
    _check_rays(org, dirn, dev, tmax=tmax)


def shadow_logsum_bvh(bvh: dict, tri9, lf4, org, dirn, tmax):
    """((N, 3) log sum, (N,) bool blocked) of each ray over t in (5e-4,
    tmax): the sum of the log filters (lf4 columns 0-2) of the triangles it
    crosses, and whether one of them is opaque (lf4 column 3), by the BVH
    walk.  lf4 (T, 4) float32 in the BVH's leaf order (`leaf_lf4`), on a
    16-byte boundary; the rest as `closest_hit_bvh`."""
    dev = org.device
    _check_shadow(bvh, tri9, lf4, org, dirn, tmax)
    if dev.type == "cpu":
        return shadow_bvh_plain(bvh, tri9, lf4, org, dirn, tmax)
    if dev.type != "cuda":
        raise ValueError(f"shadow_logsum_bvh: unsupported device {dev}")
    out, _ = _shadow_launch(bvh, tri9, lf4, org, dirn, tmax)
    _WRAPPERS["shadow_logsum_bvh"].launches += 1
    return out


shadow_logsum_bvh.launches = 0
# the wrappers whose launches they count, bound here so a caller that wraps
# a module attribute (to record calls) keeps the counts
_WRAPPERS = {f.__name__: f for f in (closest_hit_bvh, shadow_logsum_bvh)}


def walk_counts(kind: str, *args) -> tuple:
    """The card's walk of `closest_hit_bvh(*args)` (kind "closest") or
    `shadow_logsum_bvh(*args)` ("shadow") by its counting kernel, for a
    kernel's bound: (the wrapper's outputs, (N, 2) int32 per ray: nodes
    visited, triangle tests made; distinct nodes touched; distinct
    triangles touched).  Not a path: its launches are not counted."""
    launch = {"closest": _closest_launch, "shadow": _shadow_launch}[kind]
    out, (per_ray, nodes, tris) = launch(*args, counts=True)
    return out, per_ray, int(nodes.sum()), int(tris.sum())


def _before_args(bvh, tri9) -> tuple:
    return (*_ptrs(*(bvh[k] for k in BVH_KEYS)), bvh["tri_order"].shape[0],
            tri9.data_ptr())


def _closest_hit_bvh_before(bvh: dict, tri9, org, dirn, tmin, tmax):
    """`closest_hit_bvh`'s function by the body its walk replaced: one
    thread a ray in the caller's order over the builder's arrays.  For
    timing beside the walk; no path calls it and its launches are not
    counted."""
    dev, n = org.device, org.shape[0]
    _check_bvh(bvh, tri9, dev)
    _check_rays(org, dirn, dev, tmin=tmin, tmax=tmax)
    out = _closest_out(n, dev)
    with torch.cuda.device(dev):
        code = _lib().bvh_closest_before_launch(
            *_before_args(bvh, tri9), *_ptrs(org, dirn, tmin, tmax), n,
            *_ptrs(*out), _stream(dev))
    _raise_on(code, "_closest_hit_bvh_before")
    return (*out, torch.isfinite(out[0]))


def _shadow_logsum_bvh_before(bvh: dict, tri9, lf4, org, dirn, tmax):
    """`shadow_logsum_bvh`'s function by the body its walk replaced, which
    reads lf4 in the triangles' order (row i for triangle i).  For timing
    beside the walk; no path calls it and its launches are not counted."""
    dev, n = org.device, org.shape[0]
    _check_shadow(bvh, tri9, lf4, org, dirn, tmax)
    out = _shadow_out(n, dev)
    with torch.cuda.device(dev):
        code = _lib().bvh_shadow_before_launch(
            *_before_args(bvh, tri9), *_ptrs(lf4, org, dirn, tmax), n,
            *_ptrs(*out), _stream(dev))
    _raise_on(code, "_shadow_logsum_bvh_before")
    return out


def shadow_tmax(dist: torch.Tensor) -> torch.Tensor:
    """A shadow segment's tested interval ends at dist·(1-1e-4) - 5e-4."""
    return dist * (1.0 - 1e-4) - SHADOW_TMIN


def shadow_transmission_bvh(bvh: dict, tri9, lf4, org, dirn, dist):
    """(N, 3) transmission along org -> org + dirn·dist: exp of the log sum,
    0 where the segment crosses an opaque triangle (lf4 in leaf order)."""
    lg, blocked = shadow_logsum_bvh(bvh, tri9, lf4, org, dirn,
                                    shadow_tmax(dist).contiguous())
    return torch.where(blocked[:, None], 0.0, torch.exp(lg))
