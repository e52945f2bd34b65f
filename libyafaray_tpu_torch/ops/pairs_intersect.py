"""The pair-granular intersection route: CUDA wrappers and plain PyTorch
versions of the two pair kernels, and the closest-hit and shadow passes
built on them.

Port of the pair section of libyafaray_tpu/ops/pallas_intersect.py:
`_pairs_closest_kernel` and `_pairs_shadow_kernel` (launched by
`_pairs_sweep`), `_ray_cluster_entries`, `_pick_nsub`, `_expand_pairs`,
`_pair_round`, `_closest_hit_pairs` and `_shadow_transmission_pairs`.  The
kernels live in csrc/pairs_intersect.cu and are built by ops/_build.py at
first use.

The route is opt-in (`Scene.compile(pairs=True)`) for packs of at least
PAIRS_MIN_CLUSTERS clusters.  Each ray's clusters are ordered by the entry
of its interval into their boxes (the minimum over a cluster's 128-column
sub-boxes where `pick_nsub` > 1); picked clusters become (ray, cluster)
slots sorted by cluster, so that neighbouring threads of a kernel test the
same triangles, and the per-slot results are reduced back to rays.  Both
kernels take the sub-box table too: a block of slots stages its cluster's
128-column sub-clusters in shared memory and a slot tests only those its
segment enters, for a closest hit only those it enters before its best hit
so far (the plain versions test every column of the cluster: the same
answers, the shadow sums up to the order of the additions).
- Closest hit: round 1 tests each ray's PAIR_K1 nearest clusters, round 2
  the next PAIR_K2 whose entry is nearer than round 1's hit; a ray with a
  cluster past those still nearer than its best hit is a straggler.
- Shadows: a ray that enters at most SHADOW_KS clusters has them all tested
  in one pair pass, its slot sums added without a floor; the others are
  stragglers.
Stragglers are compacted and re-walked by the fine kernels
(`ops/fine_intersect.py`), closest hits below min(tmax, best t), shadows
with the floor at -80: the exact answer whatever the caps.  (The reference
re-walks them with its stream kernels, whose port holds at most 8 clusters
in shared memory.)  Every pack of 64 or more clusters within MAX_TRIS is
fine-eligible; the dispatch checks it.

Slot lists hold valid picks only, so a round with none launches nothing;
counting them, and compacting the stragglers, reads one number from the
device per pass.  The reference's visit tables (`_pair_tables`), its padding
of the slots to PAIR_KB·128 and the PAIR_KB cap schedule the TPU's DMA and
are not ported.  Box entries are `fine_intersect.box_entry`'s widened ones:
they may list a cluster the reference's unwidened slab skips, never the
reverse.

Each wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches its kernel on the current stream or raises, and counts the
launch in its `launches` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, fine_intersect
from .cluster_intersect import shadow_limits
from .cuda_intersect import (SHADOW_TMIN, _check, _mt_test, _raise_on,
                             log_filter)
from .fine_intersect import SUB_BT, box_entry

PAIR_K1 = 4  # round 1: each ray's nearest clusters
PAIR_K2 = 16  # round 2 cap (the rest go to the straggler pass)
PAIRS_MIN_CLUSTERS = 64  # fewer clusters never take the pair route
SHADOW_KS = 24  # shadow rays entering more clusters are stragglers
MAX_NSUB_TABLE = 2048  # sub-boxes above which entries use the cluster boxes
# rays x boxes per chunk of the entry slab (bounds its temporaries)
_ENTRY_ELEMS = 1 << 26
_BIG = torch.iinfo(torch.int32).max


def pick_nsub(pack_w: int, bt: int) -> int:
    """Sub-boxes per cluster whose minimum entry stands for the cluster's
    (`_pick_nsub`): bt / 128 while the pack has at most MAX_NSUB_TABLE
    sub-clusters, else 1 (the cluster boxes)."""
    return (bt // SUB_BT if bt > SUB_BT and pack_w // SUB_BT <= MAX_NSUB_TABLE
            else 1)


# ---- per-ray cluster entries ---------------------------------------------


def cluster_entries(cluster8, sub8, org, dirn, lo, hi, n_tris: int):
    """(N, C) entry of each ray's interval [lo, hi] into each cluster, inf
    where it enters none of the cluster's (sub-)boxes; all-pad clusters and
    sub-clusters are never entered."""
    n_cl = cluster8.shape[1]
    bt = sub8.shape[1] * SUB_BT // n_cl
    n_sub = pick_nsub(sub8.shape[1] * SUB_BT, bt)
    table, width = (sub8, SUB_BT) if n_sub > 1 else (cluster8, bt)
    real = -(-n_tris // width)
    ent = torch.full((org.shape[0], n_cl * n_sub), float("inf"),
                     device=org.device)
    ent[:, :real] = box_entry(table[:, :real], org, dirn, lo, hi)
    return ent.view(-1, n_cl, n_sub).amin(dim=2)


def nearest_clusters(cluster8, sub8, org, dirn, lo, hi, n_tris: int,
                     k: int):
    """Each ray's k nearest clusters by entry, nearest first: (entries
    (N, k), cluster ids (N, k) int64, count of clusters entered (N,)).
    Chunked over rays so the (rays, boxes) temporaries stay bounded."""
    n, boxes = org.shape[0], sub8.shape[1]
    step = max(1, _ENTRY_ELEMS // max(boxes, 1))
    vals, idx, cnt = [], [], []
    for r0 in range(0, n, step):
        sl = slice(r0, r0 + step)
        e = cluster_entries(cluster8, sub8, org[sl], dirn[sl], lo[sl],
                            hi[sl], n_tris)
        v, i = torch.topk(e, k, dim=1, largest=False, sorted=True)
        vals.append(v)
        idx.append(i)
        cnt.append(torch.isfinite(e).sum(dim=1))
    if not vals:
        z = torch.zeros((0, k), device=org.device)
        return z, z.long(), z[:, 0].long()
    return torch.cat(vals), torch.cat(idx), torch.cat(cnt)


def expand_pairs(idx, valid, n_cl: int):
    """(N, K) cluster picks -> the valid picks as slots sorted by cluster
    (stable: rays ascending within a cluster).  Returns (slot ray ids
    int32, slot cluster ids int32, each slot's index into the flattened
    (N·K) picks)."""
    n, k = idx.shape
    keys = torch.where(valid, idx, n_cl).reshape(-1).to(torch.int32)
    n_slots = int(valid.sum())
    scl, flat = torch.sort(keys, stable=True)
    flat = flat[:n_slots]
    sray = torch.div(flat, k, rounding_mode="floor").to(torch.int32)
    return sray, scl[:n_slots].contiguous(), flat


def slot_pair_tests(sub8, n_cl: int, sray, scl, org, dirn, lo, hi,
                    n_tris: int, chunk: int = 1 << 18) -> tuple:
    """(pair tests, box tests) a slot list's data needs: per slot, the real
    columns of every sub-cluster of its cluster whose box its ray's
    interval [lo, hi] (per slot) enters, and a box test for every real
    sub-cluster of its cluster.  For closest hits pass hi = min(tmax, the
    slot's t).  Counts what the inputs need, for a kernel's bound; not a
    kernel path."""
    spc = sub8.shape[1] // n_cl
    sc_real = -(-n_tris // SUB_BT)
    cols = fine_intersect.real_columns(SUB_BT, sub8.shape[1], n_tris,
                                       sub8.device)
    pairs = boxes = 0
    for s0 in range(0, sray.shape[0], chunk):
        sl = slice(s0, s0 + chunk)
        r = sray[sl].long()
        sc = scl[sl].long()[:, None] * spc + torch.arange(spc,
                                                          device=sub8.device)
        real = sc < sc_real
        ent = box_entry(sub8[:, sc.clamp(max=sc_real - 1)], org[r], dirn[r],
                        lo[sl], hi[sl])[0]
        pairs += int(((torch.isfinite(ent) & real).to(torch.int64)
                      * cols[sc]).sum())
        boxes += int(real.sum())
    return pairs, boxes


# ---- plain PyTorch versions ---------------------------------------------


def _slot_chunks(n_slots: int, bt: int):
    step = max(1, fine_intersect._PLAIN_ELEMS // bt)
    return ((s0, min(s0 + step, n_slots)) for s0 in range(0, n_slots, step))


def _slot_columns(pack10, bt, sray, scl, org, dirn, s0, s1, n_tris):
    """One chunk of slots: (ray ids (P,), pack columns (P, bt), t, ok) of
    the Möller-Trumbore test of each slot's ray against its cluster's
    columns, with columns past n_tris masked out of `ok`."""
    r = sray[s0:s1].long()
    cols = scl[s0:s1].long()[:, None] * bt + torch.arange(
        bt, device=scl.device)
    real = cols < n_tris
    g = pack10[:, cols.clamp(max=pack10.shape[1] - 1)]
    o, d = org[r], dirn[r]
    t, _, _, ok = _mt_test(g, slice(None), *(o[:, a:a + 1] for a in range(3)),
                           *(d[:, a:a + 1] for a in range(3)))
    return r, cols, t, ok & real


def pairs_closest_plain(pack10, n_cl: int, sray, scl, org, dirn, tmin, tmax,
                        n_tris: int):
    """Per slot, the nearest t in (tmin, tmax) of its ray over its cluster's
    real columns: (t (inf on a miss), pack column (int32, 0 on a miss)),
    the lowest column on ties."""
    bt = pack10.shape[1] // n_cl
    p = sray.shape[0]
    t_out = torch.full((p,), float("inf"), device=org.device)
    c_out = torch.zeros((p,), dtype=torch.int32, device=org.device)
    for s0, s1 in _slot_chunks(p, bt):
        r, cols, t, ok = _slot_columns(pack10, bt, sray, scl, org, dirn, s0,
                                       s1, n_tris)
        t_ok = torch.where(ok & (t > tmin[r, None]) & (t < tmax[r, None]), t,
                           float("inf"))
        cmin = t_ok.amin(dim=1)
        kmin = torch.where(t_ok <= cmin[:, None], cols, _BIG).amin(dim=1)
        t_out[s0:s1] = cmin
        c_out[s0:s1] = torch.where(torch.isfinite(cmin), kmin, 0).to(
            torch.int32)
    return t_out, c_out


def pairs_shadow_plain(pack10, n_cl: int, logf, sray, scl, org, dirn, dist,
                       n_tris: int):
    """(P, 3) per slot: the sum of the log filters of its cluster's real
    columns its ray's segment crosses, t in (5e-4, dist·(1-1e-4) - 5e-4),
    not floored."""
    bt = pack10.shape[1] // n_cl
    p = sray.shape[0]
    lg = torch.zeros((p, 3), device=org.device)
    _, hi = shadow_limits(dist)
    for s0, s1 in _slot_chunks(p, bt):
        r, cols, t, ok = _slot_columns(pack10, bt, sray, scl, org, dirn, s0,
                                       s1, n_tris)
        okf = (ok & (t > SHADOW_TMIN) & (t < hi[r, None])).to(torch.float32)
        lf = logf[:3, cols.clamp(max=logf.shape[1] - 1)]  # (3, P, bt)
        lg[s0:s1] = (okf[None] * lf).sum(dim=2).T
    return lg


# ---- CUDA wrappers --------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("pairs_intersect")
    if lib.pairs_closest_launch.argtypes is None:
        lib.pairs_closest_launch.argtypes = [
            _P, _I, _I, _I, _P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P,
            _P]
        lib.pairs_closest_launch.restype = _I
        lib.pairs_shadow_launch.argtypes = [
            _P, _I, _I, _I, _P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _I, _P,
            _P]
        lib.pairs_shadow_launch.restype = _I
    return lib


def _check_slots(pack10, n_cl: int, sray, scl, n_tris: int, device) -> int:
    _check("pack10", pack10, (10, None), device)
    tp = pack10.shape[1]
    if n_cl <= 0 or tp % n_cl:
        raise ValueError(f"pack width {tp} is not {n_cl} equal clusters")
    if not 0 <= n_tris <= tp:
        raise ValueError(f"n_tris={n_tris} outside [0, {tp}]")
    p = sray.shape[0] if sray.dim() == 1 else -1
    for name, x in (("sray", sray), ("scl", scl)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32, got {x.dtype}")
        if x.device != device or not x.is_contiguous():
            raise ValueError(f"{name}: must be contiguous on {device}")
        if tuple(x.shape) != (p,):
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                             f"({p},)")
    if p >= 1 << 31:
        raise ValueError(f"{p} slots: a launch takes fewer than 2^31")
    return p


def _check_sub8(sub8, tp: int, n_cl: int, device) -> None:
    if (tp // n_cl) % SUB_BT:
        raise ValueError(f"clusters of {tp // n_cl} columns are not whole "
                         f"{SUB_BT}-column sub-clusters")
    _check("sub8", sub8, (8, tp // SUB_BT), device)


def pairs_closest(pack10, n_cl: int, sub8, sray, scl, org, dirn, tmin,
                  tmax, n_tris: int):
    """Per slot (ray id sray[i], cluster id scl[i], int32, sorted by
    cluster for speed), the nearest hit of the ray in (tmin, tmax) over the
    cluster's real columns: (t (P,) inf on a miss, pack column (P,) int32,
    0 on a miss), the lowest column on ties.

    pack10 (10, T') of n_cl equal clusters, org/dirn (N, 3), tmin/tmax (N,):
    float32, contiguous, one device.  sub8 (8, T'/128) holds the boxes of
    the pack's 128-column sub-clusters (clusters are whole sub-clusters): on
    the card a slot tests only the sub-clusters its ray enters before its
    best hit so far, and pack10 must start on a 16-byte boundary there.
    sub8=None launches the body before that walk, one thread a slot over
    every column (`chip_smoke.py` times it beside the walk)."""
    dev = org.device
    n = org.shape[0]
    p = _check_slots(pack10, n_cl, sray, scl, n_tris, dev)
    tp = pack10.shape[1]
    if sub8 is not None:
        _check_sub8(sub8, tp, n_cl, dev)
    _check("org", org, (n, 3), dev)
    _check("dirn", dirn, (n, 3), dev)
    _check("tmin", tmin, (n,), dev)
    _check("tmax", tmax, (n,), dev)
    if dev.type == "cpu":
        return pairs_closest_plain(pack10, n_cl, sray, scl, org, dirn, tmin,
                                   tmax, n_tris)
    if dev.type != "cuda":
        raise ValueError(f"pairs_closest: unsupported device {dev}")
    if sub8 is not None:
        fine_intersect._check_aligned(pack10=pack10)
    t = torch.empty((p,), dtype=torch.float32, device=dev)
    col = torch.empty((p,), dtype=torch.int32, device=dev)
    if p == 0:
        return t, col
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.pairs_closest_launch(
            pack10.data_ptr(), tp, n_cl, n_tris,
            None if sub8 is None else sub8.data_ptr(),
            0 if sub8 is None else sub8.shape[1], sray.data_ptr(),
            scl.data_ptr(), p, org.data_ptr(), dirn.data_ptr(),
            tmin.data_ptr(), tmax.data_ptr(), n, t.data_ptr(), col.data_ptr(),
            stream)
    _WRAPPERS["pairs_closest"].launches += 1
    _raise_on(code, "pairs_closest")
    return t, col


pairs_closest.launches = 0


def pairs_shadow(pack10, n_cl: int, sub8, logf, sray, scl, org, dirn, dist,
                 n_tris: int):
    """(P, 3) per slot: the sum of the log filters (logf (>=3, T') rows) of
    the slot cluster's real columns its ray's segment org -> org + dirn·dist
    crosses, not floored.  sub8 (8, T'/128) holds the boxes of the pack's
    128-column sub-clusters (clusters are whole sub-clusters): on the card a
    slot tests only the sub-clusters its segment enters, and the sums are
    added sub-cluster by sub-cluster, the same bits in every call; pack10
    and logf must start on a 16-byte boundary there.  Float32, contiguous,
    one device."""
    dev = org.device
    n = org.shape[0]
    p = _check_slots(pack10, n_cl, sray, scl, n_tris, dev)
    tp = pack10.shape[1]
    _check_sub8(sub8, tp, n_cl, dev)
    _check("logf", logf, (None, tp), dev)
    if logf.shape[0] < 3:
        raise ValueError(f"logf: needs 3 rgb rows, has {logf.shape[0]}")
    _check("org", org, (n, 3), dev)
    _check("dirn", dirn, (n, 3), dev)
    _check("dist", dist, (n,), dev)
    if dev.type == "cpu":
        return pairs_shadow_plain(pack10, n_cl, logf, sray, scl, org, dirn,
                                  dist, n_tris)
    if dev.type != "cuda":
        raise ValueError(f"pairs_shadow: unsupported device {dev}")
    fine_intersect._check_aligned(pack10=pack10, logf=logf)
    lg = torch.empty((p, 3), dtype=torch.float32, device=dev)
    if p == 0:
        return lg
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.pairs_shadow_launch(
            pack10.data_ptr(), tp, n_cl, n_tris, sub8.data_ptr(),
            sub8.shape[1], logf.data_ptr(), logf.shape[1], sray.data_ptr(),
            scl.data_ptr(), p, org.data_ptr(), dirn.data_ptr(),
            dist.data_ptr(), n, lg.data_ptr(), stream)
    _WRAPPERS["pairs_shadow"].launches += 1
    _raise_on(code, "pairs_shadow")
    return lg


pairs_shadow.launches = 0
# the wrappers whose launches they count, bound here so a caller that wraps
# a module attribute (to record calls) keeps the counts
_WRAPPERS = {f.__name__: f for f in (pairs_closest, pairs_shadow)}


# ---- the route ------------------------------------------------------------


def _per_pick(values, flat, shape, fill):
    """Slot results back at their (ray, pick) place: (N, K) (+ trailing)."""
    out = torch.full((shape[0] * shape[1], *values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    out[flat] = values
    return out.view(*shape, *values.shape[1:])


def _pair_round(pack10, n_cl, sub8, idx, valid, org, dirn, tmin, tmax,
                n_tris: int):
    """One closest-hit round over each ray's valid picks: per ray (t, col)
    (inf / 0 when none hit), the nearest t, then the lowest column among
    the picks that reach it."""
    sray, scl, flat = expand_pairs(idx, valid, n_cl)
    t_s, col_s = pairs_closest(pack10, n_cl, sub8, sray, scl, org, dirn,
                               tmin, tmax, n_tris)
    t_k = _per_pick(t_s, flat, idx.shape, float("inf"))
    t_ray = t_k.amin(dim=1)
    win = (t_k == t_ray[:, None]) & torch.isfinite(t_k)
    c_k = _per_pick(col_s, flat, idx.shape, _BIG)
    col = torch.where(win, c_k, _BIG).amin(dim=1)
    return t_ray, torch.where(torch.isfinite(t_ray), col, 0).to(torch.int32)


def closest_hit_pairs(pack10, cluster8, sub8, org, dirn, tmin, tmax,
                      n_tris: int):
    """(best t, best pack column (int32)) of each ray over the first n_tris
    pack columns by the pair route: two rounds, then the stragglers through
    `fine_intersect.closest_hit_fine`.  `fine_intersect.closest_epilogue`
    turns them into a hit record."""
    n_cl = cluster8.shape[1]
    k1 = min(PAIR_K1, n_cl)
    k2 = min(PAIR_K1 + PAIR_K2, n_cl)
    sent, sidx, _ = nearest_clusters(cluster8, sub8, org, dirn, tmin, tmax,
                                     n_tris, min(k2 + 1, n_cl))
    t12, c12 = _pair_round(pack10, n_cl, sub8, sidx[:, :k1],
                           torch.isfinite(sent[:, :k1]), org, dirn, tmin,
                           tmax, n_tris)
    if k2 > k1:
        e2 = sent[:, k1:k2]
        t2, c2 = _pair_round(pack10, n_cl, sub8, sidx[:, k1:k2],
                             torch.isfinite(e2) & (e2 < t12[:, None]), org,
                             dirn, tmin, tmax, n_tris)
        use2 = t2 < t12
        t12, c12 = torch.where(use2, t2, t12), torch.where(use2, c2, c12)
    if n_cl > k2:
        # stragglers: a cluster past the caps entered nearer than the hit
        strag = torch.nonzero(sent[:, k2] < t12).squeeze(1)
        if strag.numel():
            t_fb, c_fb = fine_intersect.closest_hit_fine(
                pack10, cluster8, sub8, org[strag], dirn[strag], tmin[strag],
                torch.minimum(tmax[strag], t12[strag]), n_tris)
            use = t_fb < t12[strag]
            t12[strag] = torch.where(use, t_fb, t12[strag])
            c12[strag] = torch.where(use, c_fb, c12[strag])
    return t12, c12


def shadow_logsum_pairs(pack10, cluster8, sub8, logf, org, dirn, dist,
                        n_tris: int):
    """(N, 3) log transmission of each segment by the pair route: rays that
    enter at most SHADOW_KS clusters summed over their slots without a
    floor, the others through `fine_intersect.shadow_logsum_fine` (floored
    at -80)."""
    n_cl = cluster8.shape[1]
    ks = min(SHADOW_KS, n_cl)
    lo, hi = shadow_limits(dist)
    sent, sidx, count = nearest_clusters(cluster8, sub8, org, dirn, lo, hi,
                                         n_tris, ks)
    capable = count <= ks
    sray, scl, flat = expand_pairs(
        sidx, torch.isfinite(sent) & capable[:, None], n_cl)
    lg_s = pairs_shadow(pack10, n_cl, sub8, logf, sray, scl, org, dirn, dist,
                        n_tris)
    # summed per ray in pick order: the same sum in every run
    lg = _per_pick(lg_s, flat, sidx.shape, 0.0).sum(dim=1)
    strag = torch.nonzero(~capable).squeeze(1)
    if strag.numel():
        lg[strag] = fine_intersect.shadow_logsum_fine(
            pack10, cluster8, sub8, logf, org[strag], dirn[strag],
            dist[strag], n_tris)
    return lg


def shadow_transmission_pairs(pack10, cluster8, sub8, filt4, org, dirn, dist,
                              n_tris: int):
    """(N, 3) transmission = exp(log sum), filt4 (4, T') rgb filter rows in
    pack order (0 = opaque)."""
    return torch.exp(shadow_logsum_pairs(pack10, cluster8, sub8,
                                         log_filter(filt4), org, dirn, dist,
                                         n_tris))
