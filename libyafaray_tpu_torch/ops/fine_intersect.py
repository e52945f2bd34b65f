"""The large-scene intersection kernels: CUDA wrappers, plain PyTorch
versions, the sub-cluster box table they walk and the closest-hit epilogue.

Port of the gathered-fine section of libyafaray_tpu/ops/pallas_intersect.py
(`_closest_kernel_fine` with `_closest_fine_tcol` / `_run_fine_closest`,
`_shadow_kernel_fine` with `_shadow_fine_lg`, `_sub_aabbs`,
`_closest_epilogue`).  The kernels live in csrc/fine_intersect.cu and are
built by ops/_build.py at first use.

The kernels compute the reference's function, not its TPU schedule.  The
closest hit gives a warp to a ray and walks the cluster and sub-cluster
boxes nearest entry first; the shadow sum gives a block to a run of up to
256 rays, stages each 128-column sub-cluster some ray of the run enters in
shared memory and deals the (ray, sub-cluster) pairs to warps.  The plain
versions are a brute force over every real pack column in chunks, which
gives the same hits (the kernels' box skips are conservative) and the same
sums up to the order of the additions: exactly where every log filter is 0
or -80, to rounding otherwise.
Ties go to the lowest pack column in both.  The reference's ray sort, block
lists and next-group keys (`_ray_sort_perm`, `_entry_sort_perm`,
`_fine_block_keys`, `_next_group_keys`) schedule the TPU and are not
ported.

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

SUB_BT = 128  # sub-cluster width (pack columns)
FINE_GROUP = 8  # the reference's sub-clusters per visit: its lower n_sc bound
MAX_FINE_SC = 8192  # the reference's upper n_sc bound (1M triangles)
FB_MIN_CLUSTERS = 4  # fewer clusters take the reference's dense kernels
# rays x columns per chunk of the plain versions (bounds their temporaries)
_PLAIN_ELEMS = 1 << 23


def sub_aabbs(pack10: np.ndarray, n_tris: int) -> np.ndarray:
    """(8, T'/128) boxes of the pack's 128-column sub-clusters over its real
    columns (rows lo xyz | hi xyz | 0 0); all-pad sub-clusters get the
    inverted box (+inf, -inf).  Built once per scene at compile."""
    return _column_boxes(pack10, n_tris, SUB_BT)


def takes_fine_path(pack_w: int, n_cl: int) -> bool:
    """The reference's choice of the gathered-fine kernels for a pack of
    pack_w columns in n_cl clusters (`closest_hit_pallas`)."""
    n_sc = pack_w // SUB_BT
    return (n_cl >= FB_MIN_CLUSTERS and FINE_GROUP <= n_sc <= MAX_FINE_SC
            and pack_w % SUB_BT == 0)


# ---- plain PyTorch versions ---------------------------------------------


def _chunks(n_rays: int, n_tris: int):
    step = max(1, min(n_tris, _PLAIN_ELEMS // max(n_rays, 1)))
    return ((k0, min(k0 + step, n_tris)) for k0 in range(0, n_tris, step))


def closest_fine_plain(pack10, org, dirn, tmin, tmax, n_tris: int):
    """Nearest hit in (tmin, tmax) over the first n_tris pack columns, by
    brute force.  Returns (t (inf on a miss), col = pack column (int32, 0 on
    a miss)); the lowest column wins ties."""
    ox, oy, oz = (x[:, None] for x in org.unbind(-1))
    dx, dy, dz = (x[:, None] for x in dirn.unbind(-1))
    lo, hi = tmin[:, None], tmax[:, None]
    best_t = torch.full_like(tmax, float("inf"))
    best_c = torch.zeros(tmax.shape, dtype=torch.int32, device=tmax.device)
    big = torch.iinfo(torch.int32).max
    for k0, k1 in _chunks(org.shape[0], n_tris):
        t, _, _, ok = _mt_test(pack10, slice(k0, k1), ox, oy, oz, dx, dy, dz)
        t_ok = torch.where(ok & (t > lo) & (t < hi), t, float("inf"))
        cmin = t_ok.amin(dim=1)
        cols = torch.arange(k0, k1, dtype=torch.int32, device=t.device)
        kmin = torch.where(t_ok <= cmin[:, None], cols, big).amin(dim=1)
        better = cmin < best_t
        best_t = torch.where(better, cmin, best_t)
        best_c = torch.where(better, kmin, best_c)
    return best_t, best_c


def shadow_sum_plain(pack10, logf, org, dirn, dist, n_tris: int):
    """(N, 3) sum of the log filters of the triangles each segment
    org -> org + dirn·dist crosses, t in (5e-4, dist·(1-1e-4) - 5e-4), over
    the first n_tris pack columns, by brute force, with no floor."""
    ox, oy, oz = (x[:, None] for x in org.unbind(-1))
    dx, dy, dz = (x[:, None] for x in dirn.unbind(-1))
    hi = (dist * (1.0 - 1e-4) - SHADOW_TMIN)[:, None]
    lg = torch.zeros((org.shape[0], 3), dtype=torch.float32,
                     device=org.device)
    for k0, k1 in _chunks(org.shape[0], n_tris):
        t, _, _, ok = _mt_test(pack10, slice(k0, k1), ox, oy, oz, dx, dy, dz)
        okf = (ok & (t > SHADOW_TMIN) & (t < hi)).to(torch.float32)
        lg = lg + okf @ logf[:3, k0:k1].T
    return lg


def shadow_logsum_fine_plain(pack10, logf, org, dirn, dist, n_tris: int):
    """`shadow_sum_plain` floored at -80 (opaque)."""
    return torch.clamp(shadow_sum_plain(pack10, logf, org, dirn, dist,
                                        n_tris), min=LOG_FLOOR)


def box_entry(box8, org, dirn, lo, hi):
    """(N, C) entry distance of each ray's interval [lo, hi] into each box
    of a (8, C) table, widened as the kernels widen it (1e-5 of the largest
    face and ray-origin magnitude per axis); inf where the interval misses
    the box.  A (8, N, C) table, C boxes per ray, gives (1, N, C).  The
    boxes must be finite (real clusters)."""
    eps = 1e-12
    d = torch.where(dirn.abs() < eps, torch.where(dirn < 0, -eps, eps), dirn)
    iv = torch.ones_like(d) / d
    enter, exit_ = lo[:, None], hi[:, None]
    for a in range(3):
        bl, bh = box8[a][None], box8[a + 3][None]
        o = org[:, a:a + 1]
        pad = torch.maximum(1e-5 * o.abs(),
                            1e-5 * torch.maximum(bl.abs(), bh.abs()))
        t0 = (bl - pad - o) * iv[:, a:a + 1]
        t1 = (bh + pad - o) * iv[:, a:a + 1]
        enter = torch.maximum(enter, torch.minimum(t0, t1))
        exit_ = torch.minimum(exit_, torch.maximum(t0, t1))
    return torch.where(enter <= exit_, enter, float("inf"))


def real_columns(width: int, groups: int, n_tris: int, device):
    """(groups,) real columns of each `width`-column group of the pack."""
    start = torch.arange(groups, device=device) * width
    return torch.clamp(n_tris - start, 0, width)


def fine_pair_tests(cluster8, sub8, org, dirn, lo, hi, n_tris: int,
                    chunk: int = 1 << 16) -> tuple:
    """(pair tests, box tests) the fine kernels' data needs: per ray, the
    real columns of every sub-cluster whose box, and whose cluster's box,
    its interval [lo, hi] enters; a box test for every real cluster and
    for every real sub-cluster of an entered cluster.  For the closest hit
    pass hi = min(tmax, the hit's t): the boxes a ray enters before its
    hit.  Counts what the inputs need, for a kernel's bound; not a kernel
    path."""
    n_sc = sub8.shape[1]
    spc = n_sc // cluster8.shape[1]
    sc_real = -(-n_tris // SUB_BT)
    cl_real = -(-sc_real // spc)
    cols = real_columns(SUB_BT, sc_real, n_tris, org.device)
    pairs = boxes = 0
    for r0 in range(0, org.shape[0], chunk):
        sl = slice(r0, r0 + chunk)
        args = (org[sl], dirn[sl], lo[sl], hi[sl])
        c_in = torch.isfinite(box_entry(cluster8[:, :cl_real], *args))
        s_in = torch.isfinite(box_entry(sub8[:, :sc_real], *args))
        c_of_s = c_in.repeat_interleave(spc, dim=1)[:, :sc_real]
        pairs += int(((s_in & c_of_s).to(torch.int64) * cols).sum())
        boxes += c_in.shape[0] * cl_real + int(c_of_s.sum())
    return pairs, boxes


def closest_epilogue(pack10, org, dirn, t, col, n_tris: int):
    """(best t, best pack column) -> (t, tri = original triangle id, u, v,
    hit): u, v and t recomputed from one gather of the winning column with
    the kernels' own arithmetic (so t is unchanged on a hit), the id read
    from pack row 9.  Misses keep t = inf; their tri/u/v are column 0's."""
    hit = torch.isfinite(t)
    c10 = pack10[:, col.long()]
    t_re, u, v, _ = _mt_test(c10, slice(None), *org.unbind(-1),
                             *dirn.unbind(-1))
    tri = torch.clamp(c10[9].to(torch.int32), max=n_tris - 1)
    return torch.where(hit, t_re, float("inf")), tri, u, v, hit


# ---- CUDA wrappers --------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("fine_intersect")
    if lib.closest_hit_fine_launch.argtypes is None:
        lib.closest_hit_fine_launch.argtypes = [
            _P, _I, _P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P]
        lib.closest_hit_fine_launch.restype = _I
        lib.shadow_logsum_fine_launch.argtypes = [
            _P, _I, _P, _I, _P, _I, _I, _P, _I, _P, _P, _P, _I, _P, _P]
        lib.shadow_logsum_fine_launch.restype = _I
    return lib


def _check_scene(pack10, cluster8, sub8, n_tris: int, device) -> None:
    _check("pack10", pack10, (10, None), device)
    tp = pack10.shape[1]
    _check("cluster8", cluster8, (8, None), device)
    _check("sub8", sub8, (8, tp // SUB_BT), device)
    n_cl = cluster8.shape[1]
    if tp % SUB_BT or n_cl == 0 or (tp // SUB_BT) % n_cl:
        raise ValueError(f"pack width {tp} is not {n_cl} clusters of whole "
                         f"{SUB_BT}-column sub-clusters")
    if not 0 <= n_tris <= tp:
        raise ValueError(f"n_tris={n_tris} outside [0, {tp}]")


def _check_aligned(**tensors) -> None:
    """The shadow kernels copy pack and log-filter rows 16 bytes at a time."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: must start on a 16-byte boundary")


def _scene_args(pack10, cluster8, sub8, n_tris: int) -> tuple:
    return (pack10.data_ptr(), pack10.shape[1], cluster8.data_ptr(),
            cluster8.shape[1], sub8.data_ptr(), sub8.shape[1], n_tris)


def closest_hit_fine(pack10, cluster8, sub8, org, dirn, tmin, tmax,
                     n_tris: int):
    """(best t, best pack column (int32)) of each ray over the first n_tris
    pack columns; `closest_epilogue` turns them into a hit record.

    pack10 (10, T'), cluster8 (8, n_cl), sub8 (8, T'/128), org/dirn (N, 3),
    tmin/tmax (N,): float32, contiguous, one device."""
    dev = org.device
    n = org.shape[0]
    _check_scene(pack10, cluster8, sub8, n_tris, dev)
    _check("org", org, (n, 3), dev)
    _check("dirn", dirn, (n, 3), dev)
    _check("tmin", tmin, (n,), dev)
    _check("tmax", tmax, (n,), dev)
    if dev.type == "cpu":
        return closest_fine_plain(pack10, org, dirn, tmin, tmax, n_tris)
    if dev.type != "cuda":
        raise ValueError(f"closest_hit_fine: unsupported device {dev}")
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    col = torch.empty((n,), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.closest_hit_fine_launch(
            *_scene_args(pack10, cluster8, sub8, n_tris), org.data_ptr(),
            dirn.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), n,
            t.data_ptr(), col.data_ptr(), stream)
    _WRAPPERS["closest_hit_fine"].launches += 1
    _raise_on(code, "closest_hit_fine")
    return t, col


closest_hit_fine.launches = 0


def shadow_logsum_fine(pack10, cluster8, sub8, logf, org, dirn, dist,
                       n_tris: int):
    """(N, 3) log transmission of each segment over the first n_tris pack
    columns, floored at -80; logf (>=3, T') holds the per-column log filter
    rows.  All float32, contiguous, one device.  On the card one kernel body
    serves every batch: a block takes 256 consecutive rays, fewer (down to
    32) when the batch is too small to give every multiprocessor two
    blocks; pack10 and logf must start on a 16-byte boundary.  The sums are
    added sub-cluster by sub-cluster in pack order, the same bits in every
    call."""
    dev = org.device
    n = org.shape[0]
    _check_scene(pack10, cluster8, sub8, n_tris, dev)
    _check("logf", logf, (None, pack10.shape[1]), dev)
    if logf.shape[0] < 3:
        raise ValueError(f"logf: needs 3 rgb rows, has {logf.shape[0]}")
    _check("org", org, (n, 3), dev)
    _check("dirn", dirn, (n, 3), dev)
    _check("dist", dist, (n,), dev)
    if dev.type == "cpu":
        return shadow_logsum_fine_plain(pack10, logf, org, dirn, dist, n_tris)
    if dev.type != "cuda":
        raise ValueError(f"shadow_logsum_fine: unsupported device {dev}")
    _check_aligned(pack10=pack10, logf=logf)
    lg = torch.empty((n, 3), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.shadow_logsum_fine_launch(
            *_scene_args(pack10, cluster8, sub8, n_tris), logf.data_ptr(),
            logf.shape[1], org.data_ptr(), dirn.data_ptr(), dist.data_ptr(),
            n, lg.data_ptr(), stream)
    _WRAPPERS["shadow_logsum_fine"].launches += 1
    _raise_on(code, "shadow_logsum_fine")
    return lg


shadow_logsum_fine.launches = 0
# the wrappers whose launches they count, bound here so a caller that wraps
# a module attribute (to record calls) keeps the counts
_WRAPPERS = {f.__name__: f for f in (closest_hit_fine, shadow_logsum_fine)}


def shadow_transmission_fine(pack10, cluster8, sub8, filt4, org, dirn, dist,
                             n_tris: int):
    """(N, 3) transmission = exp(log sum), filt4 (4, T') rgb filter rows in
    pack order (0 = opaque)."""
    return torch.exp(shadow_logsum_fine(pack10, cluster8, sub8,
                                        log_filter(filt4), org, dirn, dist,
                                        n_tris))
