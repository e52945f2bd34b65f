"""The tiny-scene intersection kernels: CUDA wrappers, plain PyTorch versions
and the triangle pack they read.

Port of the tiny-scene section of libyafaray_tpu/ops/pallas_intersect.py
(`_closest_kernel_tiny`, `_shadow_kernel_tiny`, `_mt_test_scalar`) plus
the host-side pack build (`build_tri_pack`, `_pick_bt`).  The kernels live
in csrc/tiny_intersect.cu and are built by ops/_build.py at first use.

On the card both kernels walk the boxes of the pack's TINY_GROUP-column
groups (`tiny_boxes`, which each kernel builds from the pack in each
block; csrc/column_walk.cuh).  The closest hit gives a thread one ray and
the group it enters nearest, and lists the ray's other entered groups for
the block's threads to take in turn; the shadow sum gives a thread
TINY_RAYS neighbouring rays and walks the groups one of them enters.  The
one-thread bodies those walks replaced are launched only by
`_closest_hit_tiny_before` and `_shadow_logsum_tiny_before`, which no path
calls: `chip_smoke.py` times them beside the walks.

Each wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches its kernel on the current stream or raises.  Each wrapper keeps
a plain integer `launches` counter that rises by one per kernel launch, so
a run can show its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

TINY_TRIS = 64
NEG_EPS = 1e-12
SHADOW_TMIN = 5e-4
LOG_FLOOR = -80.0  # log filter of an opaque triangle (exp -> ~1.8e-35)
# columns of a box of the tiny kernels' walks and rays a thread of the shadow
# sum owns (TINY_GROUP, TINY_RAYS in csrc/tiny_intersect.cu), for counting
# their tests
TINY_GROUP = 2
TINY_RAYS = 2


# ---- host-side pack ------------------------------------------------------


def _pick_bt(t: int) -> int:
    """Pack padding width (the reference's cluster width)."""
    if t <= 32768:
        return 128
    if t <= 65536:
        return 256
    return 1024


def morton_order(v0, e1, e2) -> np.ndarray:
    """Permutation sorting triangles by the 30-bit Morton code of their
    centroid over the scene's centroid box (stable argsort), the pack order
    that gives clusters and sub-clusters tight boxes."""
    v0 = np.asarray(v0, np.float64)
    c = v0 + (np.asarray(e1, np.float64) + np.asarray(e2, np.float64)) / 3.0
    lo, hi = c.min(axis=0), c.max(axis=0)
    q = ((c - lo) / np.maximum(hi - lo, 1e-12) * 1023.0).astype(np.uint32)
    q = np.minimum(q, 1023)

    def spread(x):
        x = (x | (x << 16)) & np.uint32(0x030000FF)
        x = (x | (x << 8)) & np.uint32(0x0300F00F)
        x = (x | (x << 4)) & np.uint32(0x030C30C3)
        x = (x | (x << 2)) & np.uint32(0x09249249)
        return x

    code = (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint32(1))
            | (spread(q[:, 2]) << np.uint32(2)))
    return np.argsort(code, kind="stable")


def build_tri_pack(v0, e1, e2, order=None):
    """(10, T') float32 pack: rows v0 | e1 | e2 | original triangle id, in
    `order` (default: original order), T' padded to a `_pick_bt` multiple
    with degenerate (never-hit) columns; and the (8, T'/bt) cluster boxes
    (rows lo xyz | hi xyz | 0 0) over each bt-wide cluster's real
    triangles, inverted (+inf / -inf) for all-pad clusters.  Returns
    (pack10, cluster8, order), `order` the triangle id of each column
    (padded entries alias triangle 0).  Row 9 holds the id as float32,
    exact below 2^24."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    t = v0.shape[0]
    bt = _pick_bt(t)
    order = np.arange(t) if order is None else np.asarray(order)
    v0o, e1o, e2o = v0[order], e1[order], e2[order]
    pad = (-t) % bt
    if pad:
        z = np.zeros((pad, 3), np.float32)
        v0o = np.concatenate([v0o, z])
        e1o = np.concatenate([e1o, z])
        e2o = np.concatenate([e2o, z])
        order = np.concatenate([order, np.zeros(pad, order.dtype)])
    tp = v0o.shape[0]
    pack10 = np.empty((10, tp), np.float32)
    pack10[0:3] = v0o.T
    pack10[3:6] = e1o.T
    pack10[6:9] = e2o.T
    pack10[9] = order
    return pack10, _column_boxes(pack10, t, bt), order


def _column_boxes(pack10: np.ndarray, n_tris: int, width: int) -> np.ndarray:
    """(8, T'/width) boxes of consecutive `width`-column groups of the pack
    over its first n_tris (real) columns: rows lo xyz | hi xyz | 0 0; a
    group with no real column gets the inverted box (+inf, -inf)."""
    tp = pack10.shape[1]
    v0 = pack10[0:3]
    p1 = v0 + pack10[3:6]
    p2 = v0 + pack10[6:9]
    real = (np.arange(tp) < n_tris)[None, :]
    lo = np.where(real, np.minimum(np.minimum(v0, p1), p2), np.inf)
    hi = np.where(real, np.maximum(np.maximum(v0, p1), p2), -np.inf)
    c = tp // width
    out = np.zeros((8, c), np.float32)
    out[0:3] = lo.reshape(3, c, width).min(axis=2)
    out[3:6] = hi.reshape(3, c, width).max(axis=2)
    return out


def tiny_boxes(pack10: np.ndarray, n_tris: int) -> np.ndarray:
    """(8, T'/TINY_GROUP) boxes of the pack's TINY_GROUP-column groups over
    its real columns, as the tiny kernels build them in each block (the
    same float32 sums, minima and maxima): for counting their tests."""
    return _column_boxes(pack10, n_tris, TINY_GROUP)


def log_filter(filt4: torch.Tensor) -> torch.Tensor:
    """Per-triangle log transmission rows, floored at LOG_FLOOR (opaque)."""
    return torch.clamp(torch.log(torch.clamp(filt4, min=1e-35)),
                       min=LOG_FLOOR)


# ---- plain PyTorch versions ---------------------------------------------


def _mt_test(cols, k, ox, oy, oz, dx, dy, dz):
    """Möller-Trumbore test of pack column k against every ray, in the
    operation order of the reference's `_mt_test_scalar`."""
    v0x, v0y, v0z = cols[0, k], cols[1, k], cols[2, k]
    e1x, e1y, e1z = cols[3, k], cols[4, k], cols[5, k]
    e2x, e2y, e2z = cols[6, k], cols[7, k], cols[8, k]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = px * e1x + py * e1y + pz * e1z
    inv = 1.0 / torch.where(det.abs() < NEG_EPS, 1.0, det)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    ok = (det.abs() > NEG_EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, ok


def closest_hit_tiny_plain(pack10, org, dirn, tmin, tmax, n_tris: int):
    """Nearest hit in (tmin, tmax) over the first n_tris pack columns.
    Returns (t, tri = pack column (int32), u, v, hit); the first column
    wins ties."""
    cols = pack10[:9, :n_tris]
    ox, oy, oz = org.unbind(-1)
    dx, dy, dz = dirn.unbind(-1)
    best_t = torch.full_like(tmax, float("inf"))
    best_u = torch.zeros_like(tmax)
    best_v = torch.zeros_like(tmax)
    best_k = torch.zeros(tmax.shape, dtype=torch.int32, device=tmax.device)
    for k in range(n_tris):
        t, u, v, ok = _mt_test(cols, k, ox, oy, oz, dx, dy, dz)
        ok = ok & (t > tmin) & (t < best_t) & (t < tmax)
        best_t = torch.where(ok, t, best_t)
        best_u = torch.where(ok, u, best_u)
        best_v = torch.where(ok, v, best_v)
        best_k = torch.where(ok, k, best_k)
    return best_t, best_k, best_u, best_v, torch.isfinite(best_t)


def shadow_logsum_tiny_plain(pack10, logf, org, dirn, dist, n_tris: int):
    """(N, 3) sum of the log filters of the triangles each segment
    org -> org + dirn·dist crosses, t in (5e-4, dist·(1-1e-4) - 5e-4)."""
    cols = pack10[:9, :n_tris]
    ox, oy, oz = org.unbind(-1)
    dx, dy, dz = dirn.unbind(-1)
    tmax = dist * (1.0 - 1e-4) - SHADOW_TMIN
    lg_r = torch.zeros_like(dist)
    lg_g = torch.zeros_like(dist)
    lg_b = torch.zeros_like(dist)
    for k in range(n_tris):
        t, _, _, ok = _mt_test(cols, k, ox, oy, oz, dx, dy, dz)
        okf = (ok & (t > SHADOW_TMIN) & (t < tmax)).to(torch.float32)
        lg_r = lg_r + okf * logf[0, k]
        lg_g = lg_g + okf * logf[1, k]
        lg_b = lg_b + okf * logf[2, k]
    return torch.stack([lg_r, lg_g, lg_b], dim=-1)


# ---- CUDA wrappers --------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("tiny_intersect")
    if lib.closest_hit_tiny_launch.argtypes is None:
        for fn in (lib.closest_hit_tiny_launch,
                   lib.closest_hit_tiny_before_launch):
            fn.argtypes = [_P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                           _P]
            fn.restype = _I
        for fn in (lib.shadow_logsum_tiny_launch,
                   lib.shadow_logsum_tiny_before_launch):
            fn.argtypes = [_P, _I, _P, _I, _I, _P, _P, _P, _I, _P, _P]
            fn.restype = _I
    return lib


def _check(name: str, x: torch.Tensor, shape: tuple, device) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if len(x.shape) != len(shape) or any(
            want is not None and got != want
            for got, want in zip(x.shape, shape)):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")


def _check_pack(pack10: torch.Tensor, n_tris: int, device) -> None:
    _check("pack10", pack10, (10, None), device)
    if not 0 <= n_tris <= min(TINY_TRIS, pack10.shape[1]):
        raise ValueError(f"n_tris={n_tris} outside [0, min({TINY_TRIS}, "
                         f"{pack10.shape[1]})]")


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")


def _closest_tiny(entry: str, pack10, org, dirn, tmin, tmax, n_tris: int):
    dev = org.device
    n = org.shape[0]
    _check_pack(pack10, n_tris, dev)
    _check("org", org, (n, 3), dev)
    _check("dirn", dirn, (n, 3), dev)
    _check("tmin", tmin, (n,), dev)
    _check("tmax", tmax, (n,), dev)
    if dev.type == "cpu":
        return closest_hit_tiny_plain(pack10, org, dirn, tmin, tmax, n_tris)
    if dev.type != "cuda":
        raise ValueError(f"closest_hit_tiny: unsupported device {dev}")
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    launch = getattr(_lib(), f"{entry}_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = launch(pack10.data_ptr(), pack10.shape[1], n_tris,
                      org.data_ptr(), dirn.data_ptr(), tmin.data_ptr(),
                      tmax.data_ptr(), n, t.data_ptr(), tri.data_ptr(),
                      u.data_ptr(), v.data_ptr(), stream)
    if entry in _WRAPPERS:  # the one-thread body is off every path
        _WRAPPERS[entry].launches += 1
    _raise_on(code, entry)
    return t, tri, u, v, torch.isfinite(t)


def closest_hit_tiny(pack10, org, dirn, tmin, tmax, n_tris: int):
    """Nearest hit of each ray over the first n_tris (<= 64) pack columns.

    pack10 (10, T), org/dirn (N, 3), tmin/tmax (N,): float32, contiguous,
    one device.  Returns (t, tri (int32 pack column), u, v, hit); the first
    column wins ties.  On the card a ray tests the columns of the groups
    whose boxes (`tiny_boxes`) it enters at or below its best t."""
    return _closest_tiny("closest_hit_tiny", pack10, org, dirn, tmin, tmax,
                         n_tris)


closest_hit_tiny.launches = 0


def _closest_hit_tiny_before(pack10, org, dirn, tmin, tmax, n_tris: int):
    """`closest_hit_tiny`'s function by the body its walk replaced, one
    thread a ray over every column.  For timing beside the walk; no path
    calls it and its launches are not counted."""
    return _closest_tiny("closest_hit_tiny_before", pack10, org, dirn, tmin,
                         tmax, n_tris)


def _shadow_tiny(entry: str, pack10, logf, org, dirn, dist, n_tris: int):
    dev = org.device
    n = org.shape[0]
    _check_pack(pack10, n_tris, dev)
    _check("logf", logf, (None, pack10.shape[1]), dev)
    if logf.shape[0] < 3:
        raise ValueError(f"logf: needs 3 rgb rows, has {logf.shape[0]}")
    _check("org", org, (n, 3), dev)
    _check("dirn", dirn, (n, 3), dev)
    _check("dist", dist, (n,), dev)
    if dev.type == "cpu":
        return shadow_logsum_tiny_plain(pack10, logf, org, dirn, dist,
                                        n_tris)
    if dev.type != "cuda":
        raise ValueError(f"shadow_logsum_tiny: unsupported device {dev}")
    lg = torch.empty((n, 3), dtype=torch.float32, device=dev)
    launch = getattr(_lib(), f"{entry}_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = launch(pack10.data_ptr(), pack10.shape[1], logf.data_ptr(),
                      logf.shape[1], n_tris, org.data_ptr(), dirn.data_ptr(),
                      dist.data_ptr(), n, lg.data_ptr(), stream)
    if entry in _WRAPPERS:  # the one-thread body is off every path
        _WRAPPERS[entry].launches += 1
    _raise_on(code, entry)
    return lg


def shadow_logsum_tiny(pack10, logf, org, dirn, dist, n_tris: int):
    """(N, 3) log transmission of each segment over the first n_tris (<= 64)
    pack columns; logf (>=3, T) holds the per-column log filter rows.
    All float32, contiguous, one device.  On the card each ray's terms are
    added in rising column order, the same bits in every call."""
    return _shadow_tiny("shadow_logsum_tiny", pack10, logf, org, dirn, dist,
                        n_tris)


shadow_logsum_tiny.launches = 0


def _shadow_logsum_tiny_before(pack10, logf, org, dirn, dist, n_tris: int):
    """`shadow_logsum_tiny`'s function by the body its walk replaced, one
    thread a ray over every column.  For timing beside the walk; no path
    calls it and its launches are not counted."""
    return _shadow_tiny("shadow_logsum_tiny_before", pack10, logf, org, dirn,
                        dist, n_tris)


# the wrappers whose launches _closest_tiny / _shadow_tiny count, bound here
# so a caller that wraps a module attribute (to record calls) keeps the
# counts
_WRAPPERS = {f.__name__: f for f in (closest_hit_tiny, shadow_logsum_tiny)}


def shadow_transmission_tiny(pack10, filt4, org, dirn, dist, n_tris: int):
    """(N, 3) transmission = exp(log sum), filt4 (4, T) rgb filter rows in
    pack order (0 = opaque)."""
    return torch.exp(shadow_logsum_tiny(pack10, log_filter(filt4), org,
                                        dirn, dist, n_tris))
