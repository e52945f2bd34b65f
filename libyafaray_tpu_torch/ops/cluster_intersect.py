"""The mid-size-scene intersection kernels: CUDA wrappers and plain PyTorch
versions of the dense and streaming pairs.

Port of the dense and streaming sections of
libyafaray_tpu/ops/pallas_intersect.py: `_closest_kernel` and
`_shadow_kernel` (packs of fewer than FB_MIN_CLUSTERS = 4 clusters, 65 to
384 triangles), `_closest_kernel_stream` and `_shadow_kernel_stream` with
their wrappers `_closest_fb_tcol` / `_shadow_fb_lg` (4 or more clusters
with fewer than FINE_GROUP = 8 sub-clusters, 385 to 896 triangles).  The
kernels live in csrc/cluster_intersect.cu and are built by ops/_build.py
at first use.

The closest-hit kernels return (best t, best pack column), which
`fine_intersect.closest_epilogue` turns into a hit record; both compute the
brute-force nearest hit with the lowest column on ties, so their plain
versions share `fine_intersect.closest_fine_plain`.  The shadow kernels
sum the per-column log filters of the columns each segment crosses: the
dense sum has no floor on its total (as the reference's `_shadow_kernel`),
the stream sum is floored at -80.  The reference's block lists, ray sort
and DMA pipeline schedule the TPU and are not ported.

`closest_hit_stream` and the two shadow sums skip by the pack's 32-column
quarter boxes (`quarter_boxes`, built once per scene at compile): the
stream closest hit gives a warp to a ray and visits its entered quarters
nearest first; the shadow sums give a thread SHADOW_DENSE_RAYS (dense) or
SHADOW_STREAM_RAYS (stream) neighbouring rays and walk, in rising order,
the quarters one of them enters (the column walk of csrc/column_walk.cuh).
The stream sum's rays test only the quarters they enter and stop once
opaque in all three channels.  `closest_hit_dense` skips by the boxes of
the pack's DENSE_GROUP-column groups (`dense_boxes`), which its kernel
builds in each block (the closest walk of csrc/column_walk.cuh): a ray's
thread box-tests every group and walks the group it enters nearest; the
other groups it enters go to a list the block's threads share.  The
one-thread bodies those walks replaced are launched only by
`_closest_hit_dense_before`, `_closest_hit_stream_before`,
`_shadow_logsum_dense_before` and `_shadow_logsum_stream_before`, which no
path calls: `chip_smoke.py` times them beside the walks.

Each wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches its kernel on the current stream or raises, and counts the
launch in its `launches` attribute.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .cuda_intersect import (LOG_FLOOR, SHADOW_TMIN, _check, _column_boxes,
                             _mt_test, _raise_on, log_filter)
from .fine_intersect import (box_entry, closest_fine_plain, real_columns,
                             shadow_sum_plain)

MAX_STREAM_CLUSTERS = 8  # clusters a stream kernel sorts in registers
QUARTER = 32  # columns of a quarter box
MAX_QUARTERS = 32  # quarter boxes closest_hit_stream's warp holds, one a lane
# rays a thread of the shadow walks owns (DENSE_RAYS, STREAM_RAYS in
# csrc/cluster_intersect.cu), for counting their pair tests
SHADOW_DENSE_RAYS = 2
SHADOW_STREAM_RAYS = 1
# columns of a box of closest_hit_dense's walk, the boxes it holds and the
# items its block lists (DENSE_GROUP, DENSE_MAX_GROUPS, DENSE_ITEMS in
# csrc/cluster_intersect.cu), and a block's threads
DENSE_GROUP = 16
DENSE_MAX_GROUPS = 64
DENSE_ITEMS = 2048
_THREADS = 256
_MAX_SMEM = 232448  # shared memory a block may use on Hopper


def quarter_boxes(pack10: np.ndarray, n_tris: int) -> np.ndarray:
    """(8, T'/32) boxes of the pack's 32-column quarters over its real
    columns (rows lo xyz | hi xyz | 0 0); all-pad quarters get the inverted
    box (+inf, -inf).  Built once per scene at compile."""
    return _column_boxes(pack10, n_tris, QUARTER)


def dense_boxes(pack10: np.ndarray, n_tris: int) -> np.ndarray:
    """(8, T'/DENSE_GROUP) boxes of the pack's DENSE_GROUP-column groups
    over its real columns, as `closest_hit_dense`'s kernel builds them in
    each block (the same float32 sums, minima and maxima): for counting
    its tests."""
    return _column_boxes(pack10, n_tris, DENSE_GROUP)


# ---- plain PyTorch versions ---------------------------------------------


def closest_dense_plain(pack10, org, dirn, tmin, tmax, n_tris: int):
    """Nearest hit in (tmin, tmax) over the first n_tris pack columns:
    (t (inf on a miss), pack column (int32, 0 on a miss)), lowest column on
    ties."""
    return closest_fine_plain(pack10, org, dirn, tmin, tmax, n_tris)


def closest_stream_plain(pack10, org, dirn, tmin, tmax, n_tris: int):
    """The stream kernel's function: the same nearest hit as
    `closest_dense_plain` (the front-to-back walk only orders the work)."""
    return closest_fine_plain(pack10, org, dirn, tmin, tmax, n_tris)


def shadow_logsum_dense_plain(pack10, logf, org, dirn, dist, n_tris: int):
    """(N, 3) sum of the log filters of the columns each segment crosses,
    with no floor on the total (the reference's dense `_shadow_kernel`)."""
    return shadow_sum_plain(pack10, logf, org, dirn, dist, n_tris)


def shadow_logsum_stream_plain(pack10, logf, org, dirn, dist, n_tris: int):
    """The same sum floored at -80 (opaque), as `_shadow_kernel_stream`
    floors it after each cluster."""
    return torch.clamp(shadow_sum_plain(pack10, logf, org, dirn, dist,
                                        n_tris), min=LOG_FLOOR)


def cluster_pair_tests(pack10, cluster8, org, dirn, lo, hi,
                       n_tris: int) -> tuple:
    """(pair tests, box tests) the dense and stream kernels' data needs:
    per ray, the real columns of every cluster whose box its interval
    [lo, hi] enters, and one box test per real cluster.  For the closest
    hit pass hi = min(tmax, the hit's t): the boxes a ray enters before
    its hit.  Any table of boxes over equal groups of columns takes the
    place of the cluster boxes: with the quarter boxes (box32) and
    hi = min(tmax, t) it counts what `closest_hit_stream`'s walk tests.
    Counts what the inputs need, for a kernel's bound; not a kernel
    path."""
    bt = pack10.shape[1] // cluster8.shape[1]
    cl_real = -(-n_tris // bt)
    cols = real_columns(bt, cl_real, n_tris, org.device)
    ent = box_entry(cluster8[:, :cl_real], org, dirn, lo, hi)
    pairs = int((torch.isfinite(ent).to(torch.int64) * cols).sum())
    return pairs, org.shape[0] * cl_real


def group_walk_pair_tests(boxes, org, dirn, dist, n_tris: int,
                          width: int = QUARTER,
                          rays_per_thread: int = SHADOW_DENSE_RAYS,
                          chunk: int = 1 << 18) -> tuple:
    """(pair tests, box tests) the column walk without its stop makes over
    the boxes (8, T'/width) of the pack's width-column groups
    (`shadow_logsum_dense` on the quarter boxes, `shadow_logsum_tiny` on
    `cuda_intersect.tiny_boxes`): a thread holds rays_per_thread
    consecutive rays (the last thread those left), tests each live ray's
    segment against every real box, and tests all its rays against the
    real columns of each group that one of its segments enters.  Counts
    what the kernel does on these inputs, not a kernel path."""
    r = rays_per_thread
    lo, hi = shadow_limits(dist)
    g_real = -(-n_tris // width)
    cols = real_columns(width, g_real, n_tris, org.device)
    n = org.shape[0]
    pairs = 0
    for r0 in range(0, n, chunk * r):
        sl = slice(r0, r0 + chunk * r)
        ent = torch.isfinite(box_entry(boxes[:, :g_real], org[sl], dirn[sl],
                                       lo[sl], hi[sl]))
        m = ent.shape[0]
        ent = torch.cat([ent, ent.new_zeros(((-m) % r, g_real))])
        taken = ent.reshape(-1, r, g_real).any(dim=1).to(torch.int64)
        rays = torch.full((taken.shape[0],), r, dtype=torch.int64,
                          device=org.device)
        rays[-1] = m - r * (taken.shape[0] - 1)
        pairs += int(((taken * cols).sum(dim=1) * rays).sum())
    return pairs, int((lo <= hi).sum()) * g_real


def stop_walk_pair_tests(pack10, box32, logf, org, dirn, dist, n_tris: int,
                         chunk: int = 1 << 20) -> tuple:
    """(pair tests, box tests) `shadow_logsum_stream`'s walk makes, which is
    also what each ray needs: per ray, the real columns of the quarters its
    segment enters, in rising order, up to and including the quarter after
    which all three channels of its running sum (its crossings' log
    filters, added in rising column order from 0) are <= -80; one box test
    per real quarter for each live ray.  Counts what the kernel does on
    these inputs, not a kernel path."""
    lo, hi = shadow_limits(dist)
    q_real = -(-n_tris // QUARTER)
    cols = real_columns(QUARTER, q_real, n_tris, org.device).tolist()
    pairs = 0
    for r0 in range(0, org.shape[0], chunk):
        o, d, h = org[r0:r0 + chunk], dirn[r0:r0 + chunk], hi[r0:r0 + chunk]
        ent = torch.isfinite(box_entry(box32[:, :q_real], o, d,
                                       lo[r0:r0 + chunk], h))
        acc = torch.zeros((o.shape[0], 3), dtype=torch.float32,
                          device=o.device)
        done = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        for q in range(q_real):
            walks = ent[:, q] & ~done
            pairs += int(walks.sum()) * cols[q]
            k0 = QUARTER * q
            t, _, _, ok = _mt_test(pack10, slice(k0, k0 + cols[q]),
                                   *(o[:, a:a + 1] for a in range(3)),
                                   *(d[:, a:a + 1] for a in range(3)))
            crossed = (ok & (t > SHADOW_TMIN) & (t < h[:, None])
                       & walks[:, None])
            for c in range(cols[q]):
                acc = acc + torch.where(crossed[:, c:c + 1],
                                        logf[:3, k0 + c][None], 0.0)
            done |= (acc <= LOG_FLOOR).all(dim=1)
    return pairs, int((lo <= hi).sum()) * q_real


def closest_walk_pair_tests(pack10, boxes, org, dirn, tmin, tmax,
                            n_tris: int, chunk: int = 1 << 16) -> tuple:
    """(pair tests listed, box tests) of the closest walk of
    csrc/column_walk.cuh (closest_items: `closest_hit_tiny` on
    `cuda_intersect.tiny_boxes`, `closest_hit_dense` on `dense_boxes`) over
    the boxes (8, T'/width) of the pack's width-column groups.  A live ray
    (tmin <= tmax) tests every real box against its whole interval and the
    real columns of the group it enters nearest (the lower group on equal
    entries); each other group it entered takes one more box test, against
    its interval cut at that first group's best t, and goes to the block's
    list where the cut interval enters it.  The kernel skips a listed item
    whose entry lies beyond the ray's best t when a thread takes it, which
    depends on the order the threads take the items: it tests at most the
    listed pairs.  Counts what the kernel does on these inputs, not a
    kernel path."""
    width = pack10.shape[1] // boxes.shape[1]
    g_real = -(-n_tris // width)
    cols = real_columns(width, g_real, n_tris, org.device)
    inf = float("inf")
    pairs = box_tests = 0
    for r0 in range(0, org.shape[0], chunk):
        o, d = org[r0:r0 + chunk], dirn[r0:r0 + chunk]
        lo, hi = tmin[r0:r0 + chunk], tmax[r0:r0 + chunk]
        live = lo <= hi
        ent = box_entry(boxes[:, :g_real], o, d, lo, hi)
        entered = torch.isfinite(ent) & live[:, None]
        first = torch.argmin(ent, dim=1)
        has = entered.any(dim=1)
        listed = (torch.arange(g_real, device=o.device)[None]
                  == first[:, None]) & has[:, None]
        # the first group's best t: its columns' nearest hit in (lo, hi)
        k = first[:, None] * width + torch.arange(width, device=o.device)
        t, _, _, ok = _mt_test(pack10[:, k.clamp(max=n_tris - 1)],
                               slice(None), *(o[:, a:a + 1] for a in range(3)),
                               *(d[:, a:a + 1] for a in range(3)))
        ok = ok & (k < n_tris) & (t > lo[:, None]) & (t < hi[:, None])
        t_first = torch.where(ok & has[:, None], t, inf).amin(dim=1)
        again = entered & ~listed
        listed |= again & torch.isfinite(box_entry(
            boxes[:, :g_real], o, d, lo, torch.minimum(hi, t_first)))
        pairs += int((listed.to(torch.int64) * cols).sum())
        box_tests += int(live.sum()) * g_real + int(again.sum())
    return pairs, box_tests


def shadow_limits(dist):
    """The interval (lo, hi) a shadow kernel tests along each segment."""
    return (torch.full_like(dist, SHADOW_TMIN),
            dist * (1.0 - 1e-4) - SHADOW_TMIN)


# ---- CUDA wrappers --------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = {
    "closest_hit_dense": [_P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P],
    "closest_hit_stream": [_P, _I, _P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _P,
                           _P, _P],
    "shadow_logsum_dense": [_P, _I, _P, _I, _P, _I, _I, _P, _I, _P, _P, _P,
                            _I, _P, _P],
    "shadow_logsum_stream": [_P, _I, _P, _I, _P, _I, _I, _P, _I, _P, _P, _P,
                             _I, _P, _P],
    "closest_hit_dense_before": [_P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _P,
                                 _P, _P],
    "closest_hit_stream_before": [_P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _P,
                                  _P, _P],
    "shadow_logsum_dense_before": [_P, _I, _P, _I, _I, _P, _I, _P, _P, _P,
                                   _I, _P, _P],
    "shadow_logsum_stream_before": [_P, _I, _P, _I, _I, _P, _I, _P, _P, _P,
                                    _I, _P, _P],
}


def _lib() -> ctypes.CDLL:
    lib = _build.load("cluster_intersect")
    if lib.closest_hit_dense_launch.argtypes is None:
        for name, args in _ARGS.items():
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes, fn.restype = args, _I
    return lib


def _check_scene(what: str, pack10, cluster8, box32, n_tris: int, device,
                 shadow: bool) -> None:
    """Checks the scene tensors.  The stream closest hit and both shadow
    sums require the quarter boxes; the dense closest hit (which builds
    its own boxes, at most DENSE_MAX_GROUPS) and the one-thread bodies
    (what "*_before") take none."""
    _check("pack10", pack10, (10, None), device)
    _check("cluster8", cluster8, (8, None), device)
    tp, n_cl = pack10.shape[1], cluster8.shape[1]
    if n_cl == 0 or tp % n_cl:
        raise ValueError(f"pack width {tp} is not {n_cl} equal clusters")
    if not 0 <= n_tris <= tp:
        raise ValueError(f"n_tris={n_tris} outside [0, {tp}]")
    if what.startswith("stream") and n_cl > MAX_STREAM_CLUSTERS:
        raise ValueError(f"{n_cl} clusters: the stream kernels take at most "
                         f"{MAX_STREAM_CLUSTERS}")
    smem = 4 * ((12 if shadow else 9) * tp + 6 * n_cl)
    if what == "dense" and not shadow:
        groups = -(-n_tris // DENSE_GROUP)
        if groups > DENSE_MAX_GROUPS:
            raise ValueError(f"{n_tris} triangles: the dense closest hit "
                             f"holds at most {DENSE_MAX_GROUPS} boxes of "
                             f"{DENSE_GROUP} columns")
        smem = 8 * _THREADS + 4 * (12 * n_tris + 6 * groups + 8 * _THREADS
                                   + 2 * DENSE_ITEMS + 1)
    if what == "stream" or (shadow and what == "dense"):
        if box32 is None:
            raise ValueError("box32: the pack's quarter boxes are required "
                             "(quarter_boxes)")
        _check("box32", box32, (8, tp // QUARTER), device)
        smem = max(smem, 4 * ((12 if shadow else 9) * tp + 6 * tp // QUARTER))
        if not shadow and tp // QUARTER > MAX_QUARTERS:
            raise ValueError(f"{tp // QUARTER} quarter boxes: the stream "
                             f"walk takes at most {MAX_QUARTERS}")
    if smem > _MAX_SMEM:
        raise ValueError(f"a pack of {tp} columns needs {smem} B of shared "
                         f"memory, more than a block's {_MAX_SMEM}")


def _launch(name: str, dev, *args) -> None:
    launch = getattr(_lib(), f"{name}_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = launch(*args, stream)
    if name in _WRAPPERS:  # the one-thread bodies are off every path
        _WRAPPERS[name].launches += 1
    _raise_on(code, name)


def _closest(what: str, pack10, cluster8, box32, org, dirn, tmin, tmax,
             n_tris: int):
    dev = org.device
    n = org.shape[0]
    _check_scene(what, pack10, cluster8, box32, n_tris, dev, shadow=False)
    _check("org", org, (n, 3), dev)
    _check("dirn", dirn, (n, 3), dev)
    _check("tmin", tmin, (n,), dev)
    _check("tmax", tmax, (n,), dev)
    if dev.type == "cpu":
        plain = (closest_dense_plain if what.startswith("dense")
                 else closest_stream_plain)
        return plain(pack10, org, dirn, tmin, tmax, n_tris)
    if dev.type != "cuda":
        raise ValueError(f"closest_hit_{what}: unsupported device {dev}")
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    col = torch.empty((n,), dtype=torch.int32, device=dev)
    scene = [pack10.data_ptr(), pack10.shape[1], cluster8.data_ptr(),
             cluster8.shape[1]]
    if what == "stream":
        scene += [box32.data_ptr(), box32.shape[1]]
    _launch(f"closest_hit_{what}", dev, *scene, n_tris, org.data_ptr(),
            dirn.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), n,
            t.data_ptr(), col.data_ptr())
    return t, col


def _shadow(what: str, pack10, cluster8, box32, logf, org, dirn, dist,
            n_tris: int):
    dev = org.device
    n = org.shape[0]
    _check_scene(what, pack10, cluster8, box32, n_tris, dev, shadow=True)
    _check("logf", logf, (None, pack10.shape[1]), dev)
    if logf.shape[0] < 3:
        raise ValueError(f"logf: needs 3 rgb rows, has {logf.shape[0]}")
    _check("org", org, (n, 3), dev)
    _check("dirn", dirn, (n, 3), dev)
    _check("dist", dist, (n,), dev)
    if dev.type == "cpu":
        plain = (shadow_logsum_dense_plain if what.startswith("dense")
                 else shadow_logsum_stream_plain)
        return plain(pack10, logf, org, dirn, dist, n_tris)
    if dev.type != "cuda":
        raise ValueError(f"shadow_logsum_{what}: unsupported device {dev}")
    lg = torch.empty((n, 3), dtype=torch.float32, device=dev)
    scene = [pack10.data_ptr(), pack10.shape[1], cluster8.data_ptr(),
             cluster8.shape[1]]
    if what in ("dense", "stream"):
        scene += [box32.data_ptr(), box32.shape[1]]
    _launch(f"shadow_logsum_{what}", dev, *scene, n_tris, logf.data_ptr(),
            logf.shape[1], org.data_ptr(), dirn.data_ptr(), dist.data_ptr(),
            n, lg.data_ptr())
    return lg


def closest_hit_dense(pack10, cluster8, org, dirn, tmin, tmax, n_tris: int):
    """(best t, best pack column (int32)) of each ray over the first n_tris
    pack columns, the lowest column on ties; `fine_intersect.
    closest_epilogue` turns them into a hit record.  On the card a ray's
    thread walks the DENSE_GROUP-column group whose box (`dense_boxes`) it
    enters nearest; the other groups it enters below that group's best t go
    to a list of (ray, group) items that the block's threads take in turn.

    pack10 (10, T'), cluster8 (8, n_cl), org/dirn (N, 3), tmin/tmax (N,):
    float32, contiguous, one device; at most DENSE_GROUP x DENSE_MAX_GROUPS
    triangles."""
    return _closest("dense", pack10, cluster8, None, org, dirn, tmin, tmax,
                    n_tris)


closest_hit_dense.launches = 0


def closest_hit_stream(pack10, cluster8, box32, org, dirn, tmin, tmax,
                       n_tris: int):
    """As `closest_hit_dense`, over a pack of at most MAX_STREAM_CLUSTERS
    clusters: on the card a warp takes a ray and visits the 32-column
    quarters whose boxes (box32 (8, T'/32), `quarter_boxes`) it enters,
    nearest entry first, until the next lies beyond its best hit."""
    return _closest("stream", pack10, cluster8, box32, org, dirn, tmin, tmax,
                    n_tris)


closest_hit_stream.launches = 0


def shadow_logsum_dense(pack10, cluster8, box32, logf, org, dirn, dist,
                        n_tris: int):
    """(N, 3) log transmission of each segment over the first n_tris pack
    columns, not floored; logf (>=3, T') holds the per-column log filter
    rows, box32 (8, T'/32) the quarter boxes (`quarter_boxes`).  All
    float32, contiguous, one device.  On the card a thread takes
    SHADOW_DENSE_RAYS neighbouring rays and the quarters one of them enters;
    each ray's terms are added in rising column order, the same bits in
    every call."""
    return _shadow("dense", pack10, cluster8, box32, logf, org, dirn, dist,
                   n_tris)


shadow_logsum_dense.launches = 0


def shadow_logsum_stream(pack10, cluster8, box32, logf, org, dirn, dist,
                         n_tris: int):
    """(N, 3) log transmission as `shadow_logsum_dense`'s, floored at -80,
    over a pack of at most MAX_STREAM_CLUSTERS clusters.  On the card a
    thread takes SHADOW_STREAM_RAYS rays; each ray adds, in rising
    column order, the crossings of the quarters (box32, `quarter_boxes`)
    it enters, until all three of its channels are <= -80; the floor is
    taken once at the end.  The same bits in every call; on filters of 0
    or 1 the plain version's bits."""
    return _shadow("stream", pack10, cluster8, box32, logf, org, dirn, dist,
                   n_tris)


shadow_logsum_stream.launches = 0


def _closest_hit_dense_before(pack10, cluster8, org, dirn, tmin, tmax,
                              n_tris: int):
    """`closest_hit_dense`'s function by the body its walk replaced, one
    thread a ray over the clusters in index order.  For timing beside the
    walk; no path calls it and its launches are not counted."""
    return _closest("dense_before", pack10, cluster8, None, org, dirn, tmin,
                    tmax, n_tris)


def _closest_hit_stream_before(pack10, cluster8, org, dirn, tmin, tmax,
                               n_tris: int):
    """`closest_hit_stream`'s function by the body its walk replaced, one
    thread a ray over the cluster boxes sorted by entry.  For timing beside
    the walk; no path calls it and its launches are not counted."""
    return _closest("stream_before", pack10, cluster8, None, org, dirn,
                    tmin, tmax, n_tris)


def _shadow_logsum_dense_before(pack10, cluster8, logf, org, dirn, dist,
                                n_tris: int):
    """`shadow_logsum_dense`'s function by the body its walk replaced, one
    thread a ray over the clusters in index order.  For timing beside the
    walk; no path calls it and its launches are not counted."""
    return _shadow("dense_before", pack10, cluster8, None, logf, org, dirn,
                   dist, n_tris)


def _shadow_logsum_stream_before(pack10, cluster8, logf, org, dirn, dist,
                                 n_tris: int):
    """`shadow_logsum_stream`'s function by the body its walk replaced, one
    thread a ray over the entered cluster boxes sorted by entry, stopping
    once opaque.  For timing beside the walk; no path calls it and its
    launches are not counted."""
    return _shadow("stream_before", pack10, cluster8, None, logf, org, dirn,
                   dist, n_tris)

# the wrappers whose launches _closest / _shadow count, bound here so a
# caller that wraps a module attribute (to record calls) keeps the counts
_WRAPPERS = {f.__name__: f for f in (closest_hit_dense, closest_hit_stream,
                                     shadow_logsum_dense,
                                     shadow_logsum_stream)}


def shadow_transmission_dense(pack10, cluster8, box32, filt4, org, dirn,
                              dist, n_tris: int):
    """(N, 3) transmission = exp(log sum), filt4 (4, T') rgb filter rows in
    pack order (0 = opaque)."""
    return torch.exp(shadow_logsum_dense(pack10, cluster8, box32,
                                         log_filter(filt4), org, dirn, dist,
                                         n_tris))


def shadow_transmission_stream(pack10, cluster8, box32, filt4, org, dirn,
                               dist, n_tris: int):
    """(N, 3) transmission = exp(floored log sum)."""
    return torch.exp(shadow_logsum_stream(pack10, cluster8, box32,
                                          log_filter(filt4), org, dirn, dist,
                                          n_tris))
