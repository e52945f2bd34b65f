"""The threaded BVH's host builder (port of libyafaray_tpu/accel/bvh.py).

A binned-SAH BVH (LEAF_SIZE triangles a leaf at most, N_BINS bins over
the largest centroid extent) flattened into a *threaded* node array: every
node stores the node to visit next when a ray enters its box and when it
misses, so the walks of ops/bvh_traverse.py need no stack.  The C++
builder of accel/cpp (accel/native.py) gives the same arrays and is the
one used when g++ is there; this numpy version is its fallback and its
reference.

Layout (node array, N nodes):
  bb_min (N,3) f32, bb_max (N,3) f32
  hit_next  (N,) i32 — node to visit when the ray enters this box
                        (left child for inner nodes; for leaves: miss_next)
  miss_next (N,) i32 — node to visit when the ray misses / after a leaf
  first_tri (N,) i32 — leaf: first index into tri_order; -1 for inner
  tri_count (N,) i32 — leaf triangle count (<= LEAF_SIZE)
  tri_order (T,) i32 — triangle permutation (leaves reference ranges)
  -1 as next pointer = the walk is done.
"""
from __future__ import annotations

import numpy as np

LEAF_SIZE = 4
N_BINS = 16
# the builder of the last build_bvh call: "native" or "numpy"
last_builder: str | None = None


def _build_recursive(cmin, cmax, centroid, idx, nodes, order):
    """Append nodes for triangle set `idx`; returns node index."""
    node_id = len(nodes)
    bb_min = cmin[idx].min(axis=0)
    bb_max = cmax[idx].max(axis=0)
    nodes.append([bb_min, bb_max, -1, -1, -1, 0])  # placeholder

    if len(idx) <= LEAF_SIZE:
        first = len(order)
        order.extend(idx.tolist())
        nodes[node_id][4] = first
        nodes[node_id][5] = len(idx)
        return node_id

    # binned SAH over the largest centroid extent axis (fall back: median)
    c = centroid[idx]
    cb_min, cb_max = c.min(axis=0), c.max(axis=0)
    extent = cb_max - cb_min
    axis = int(np.argmax(extent))
    if extent[axis] < 1e-12:
        mid = len(idx) // 2
        part = np.argsort(c[:, axis], kind="stable")
        left_idx, right_idx = idx[part[:mid]], idx[part[mid:]]
    else:
        rel = (c[:, axis] - cb_min[axis]) / extent[axis]
        bins = np.minimum((rel * N_BINS).astype(np.int32), N_BINS - 1)
        # per-bin counts and bounds
        counts = np.bincount(bins, minlength=N_BINS)
        bmin = np.full((N_BINS, 3), np.inf)
        bmax = np.full((N_BINS, 3), -np.inf)
        for b in range(N_BINS):
            sel = bins == b
            if counts[b]:
                bmin[b] = cmin[idx[sel]].min(axis=0)
                bmax[b] = cmax[idx[sel]].max(axis=0)

        def area(mn, mx):
            d = np.maximum(mx - mn, 0.0)
            return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                          + d[..., 0] * d[..., 2])

        # prefix/suffix sweeps
        lmin = np.minimum.accumulate(bmin, axis=0)
        lmax = np.maximum.accumulate(bmax, axis=0)
        rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
        lcount = np.cumsum(counts)
        rcount = np.cumsum(counts[::-1])[::-1]
        cost = np.full(N_BINS - 1, np.inf)
        for s in range(N_BINS - 1):
            if lcount[s] == 0 or rcount[s + 1] == 0:
                continue
            cost[s] = area(lmin[s], lmax[s]) * lcount[s] + area(
                rmin[s + 1], rmax[s + 1]
            ) * rcount[s + 1]
        if not np.isfinite(cost).any():
            mid = len(idx) // 2
            part = np.argsort(c[:, axis], kind="stable")
            left_idx, right_idx = idx[part[:mid]], idx[part[mid:]]
        else:
            s = int(np.argmin(cost))
            go_left = bins <= s
            left_idx, right_idx = idx[go_left], idx[~go_left]

    left = _build_recursive(cmin, cmax, centroid, left_idx, nodes, order)
    right = _build_recursive(cmin, cmax, centroid, right_idx, nodes, order)
    nodes[node_id][2] = left  # hit -> left child
    nodes[node_id][3] = right  # placeholder: miss filled by threading pass
    nodes[node_id][4] = -1
    # stash children for threading
    nodes[node_id].append((left, right))
    return node_id


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
              prefer_native: bool = True) -> dict:
    """Build the threaded BVH over triangles (v0, v0+e1, v0+e2).

    Uses the C++ builder (accel/cpp, ctypes) when it builds, with a
    warning when it does not; the numpy path below is its fallback and
    its reference."""
    global last_builder
    if prefer_native:
        from .native import build_bvh_native

        out = build_bvh_native(np.asarray(v0, np.float32),
                               np.asarray(e1, np.float32),
                               np.asarray(e2, np.float32))
        if out is not None:
            last_builder = "native"
            return out
    last_builder = "numpy"
    t = v0.shape[0]
    p1 = v0 + e1
    p2 = v0 + e2
    cmin = np.minimum(np.minimum(v0, p1), p2).astype(np.float64)
    cmax = np.maximum(np.maximum(v0, p1), p2).astype(np.float64)
    centroid = (cmin + cmax) * 0.5

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 64 * int(np.log2(t + 2))))
    nodes: list = []
    order: list = []
    _build_recursive(cmin, cmax, centroid, np.arange(t), nodes, order)
    sys.setrecursionlimit(old_limit)

    n = len(nodes)
    bb_min = np.asarray([nd[0] for nd in nodes], np.float32)
    bb_max = np.asarray([nd[1] for nd in nodes], np.float32)
    hit_next = np.full(n, -1, np.int32)
    miss_next = np.full(n, -1, np.int32)
    first_tri = np.asarray([nd[4] for nd in nodes], np.int32)
    tri_count = np.asarray([nd[5] for nd in nodes], np.int32)

    # threading pass: depth-first with an explicit "next on miss" chain
    def thread(node_id, miss_to):
        nd = nodes[node_id]
        miss_next[node_id] = miss_to
        if nd[4] >= 0:  # leaf: after processing tris, go to miss_to
            hit_next[node_id] = miss_to
        else:
            left, right = nd[6]
            hit_next[node_id] = left
            thread(left, right)
            thread(right, miss_to)

    sys.setrecursionlimit(max(old_limit, 10000 + 64 * int(np.log2(t + 2))))
    thread(0, -1)
    sys.setrecursionlimit(old_limit)

    return dict(
        bb_min=bb_min, bb_max=bb_max,
        hit_next=hit_next, miss_next=miss_next,
        first_tri=first_tri, tri_count=tri_count,
        tri_order=np.asarray(order, np.int32),
    )
