"""The photon-gather kernels: photon packs, CUDA wrappers and plain PyTorch
versions.

Port of libyafaray_tpu/ops/photon_flash.py: the flash packs
(`make_photon_pack`), the Morton-sorted cluster packs
(`make_photon_pack_sorted`, `_spread3`, `_morton_points`), their dispatch
(`make_photon_pack_auto`, `density_auto`) and the three TPU kernels
`_density_kernel`, `_nearest_kernel` and `_density_kernel_culled`, which
live in csrc/photon_flash.cu and are built by ops/_build.py at first use.
Both gathers have two kernels there: the brute force over a flash pack
(the reference kernel's counterpart) and, over a sorted pack, one warp a
query that visits only the clusters near it (the nearest lookup's pack
also carries each photon's original block, `make_photon_pack_nearest`).

    density:  flux_q = sum_p [|q-p|^2 <= r^2] [n_q . dir_p > 0] value_p,
              count_q the number of such photons
    nearest:  the value of the nearest photon within r, per 512-photon
              block the mean over the photons at the block's minimum d2,
              an earlier block winning exact ties; found = a block won.
              Without blocks: the lexicographic minimum of (d2, original
              index // 512) over the photons with d2 <= r^2, the value
              averaged over the photons sharing that pair

Invalid photons sit at SENTINEL (1e9), so d2 (~1e18) stays finite and
fails every radius test.  The flux sum is float32 throughout (the TPU's is
a bf16 MXU dot; the reference's CPU path, which the port is held to, is
f32).

Each wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches its kernel on the current stream or raises, and counts the
launch in its `launches` attribute.  The sorted layouts are built only for
CUDA packs (`sorted_layout`), as the reference builds its culled layout
only where its Pallas kernels run; from CULL_MIN_PHOTONS photons the
density gather over a sorted pack is `density_culled`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .cuda_intersect import _check, _raise_on

BQ = 256  # queries per block of the culled kernel
BP = 512  # photons per block (the tie and cluster unit)
SENTINEL = 1.0e9  # invalid-photon position -> d2 ~ 1e18 fails any r2
CULL_MIN_PHOTONS = 1 << 20  # packs >= ~1M photons take the culled layout
_PLAIN_QUERIES = 1 << 16  # query chunk of the plain versions
_PLAIN_PAIRS = 1 << 25  # queries x photons per chunk of nearest_culled_plain
F32 = torch.float32


# ---- packs ----------------------------------------------------------------


def _pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return x
    return torch.cat([x, torch.zeros((pad,) + x.shape[1:], dtype=x.dtype,
                                     device=x.device)])


def make_photon_pack(pos, valid, direction, value) -> dict:
    """Flash pack: pos (P,3), valid (P,) bool, direction (P,3) (the stored
    incoming direction of the front-side test), value (P,3) (flux or
    radiance), padded to a BP multiple.  Layout: pos_t, aux_t (3, P') rows
    and val (P', 3); invalid photons at SENTINEL."""
    pad = (-pos.shape[0]) % BP
    pos, direction, value = (_pad_rows(x.to(F32), pad)
                             for x in (pos, direction, value))
    valid = _pad_rows(valid, pad)
    pos = torch.where(valid[:, None], pos, SENTINEL)
    return dict(pos_t=pos.T.contiguous(), aux_t=direction.T.contiguous(),
                val=value.contiguous())


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """10-bit ints (int64) -> their bits at every third position."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton_points(p: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor) -> torch.Tensor:
    """30-bit Morton keys (int64) of points p over the box [lo, hi]."""
    q = torch.clamp((p - lo) / torch.clamp(hi - lo, min=1e-9) * 1023.0,
                    0.0, 1023.0).to(torch.int64)
    return (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
            | (_spread3(q[:, 2]) << 2))


def _sorted_pack(pos, valid, direction, value) -> tuple:
    """(`make_photon_pack_sorted`'s pack, the (P,) sort permutation)."""
    pos = pos.to(F32)
    # Python-scalar fills: a 0-d tensor made from the host would be a
    # blocking copy, a device sync in the middle of the preprocess
    inf = float("inf")
    lo = torch.where(valid[:, None], pos, inf).amin(dim=0)
    hi = torch.where(valid[:, None], pos, -inf).amax(dim=0)
    key = torch.where(valid, _morton_points(pos, lo, hi), 0xFFFFFFFF)
    perm = torch.argsort(key, stable=True)
    pad = (-pos.shape[0]) % BP
    pos, direction, value = (_pad_rows(x.to(F32)[perm], pad)
                             for x in (pos, direction, value))
    valid = _pad_rows(valid[perm], pad)
    c = pos.shape[0] // BP
    lo_c = torch.where(valid[:, None], pos, inf).reshape(c, BP, 3).amin(1)
    hi_c = torch.where(valid[:, None], pos, -inf).reshape(c, BP, 3).amax(1)
    posv = torch.where(valid[:, None], pos, SENTINEL)
    tbl = torch.cat([posv.T, direction.T, value.T,
                     torch.zeros((7, posv.shape[0]), dtype=F32,
                                 device=pos.device)]).contiguous()
    return dict(tbl=tbl, cl_lo=lo_c.contiguous(), cl_hi=hi_c.contiguous(),
                n_valid=valid.sum(dtype=torch.int32)), perm


def make_photon_pack_sorted(pos, valid, direction, value) -> dict:
    """Morton-sorted pack for the culled gather: the (16, P') table (rows
    0:3 pos with invalid at SENTINEL, 3:6 dir, 6:9 value, 9:16 zero) in
    Morton order (invalid photons last, a stable sort: the key of an
    invalid photon is 0xFFFFFFFF, held in int64 so it sorts last), the
    (C, 3) boxes cl_lo / cl_hi of each BP-photon cluster's valid photons
    (+inf / -inf for a cluster without one) and n_valid."""
    return _sorted_pack(pos, valid, direction, value)[0]


def make_photon_pack_nearest(pos, valid, direction, value) -> dict:
    """Sorted pack for the nearest lookup: `make_photon_pack_sorted` with
    row 9 of the table holding each photon's block in the original order,
    index // BP (exact in float32 below 2^24 blocks; the padding keeps its
    place after the photons), the unit `nearest_flash` breaks ties by."""
    pack, perm = _sorted_pack(pos, valid, direction, value)
    tbl = pack["tbl"]
    n = perm.shape[0]
    index = torch.cat([perm, torch.arange(n, tbl.shape[1],
                                          device=perm.device)])
    tbl[9] = torch.div(index, BP, rounding_mode="floor").to(F32)
    return pack


def sorted_layout(device) -> bool:
    """Whether photon packs on `device` take the Morton-sorted layouts: on
    CUDA, where the culled kernels read them; on the CPU the flash layout,
    whose plain sweeps the tests hold to the reference's."""
    return torch.device(device).type == "cuda"


def make_photon_pack_lookup(pos, valid, direction, value) -> dict:
    """Pack for `nearest_flash`: `make_photon_pack_nearest` where
    `sorted_layout`, else the flash layout."""
    if sorted_layout(pos.device):
        return make_photon_pack_nearest(pos, valid, direction, value)
    return make_photon_pack(pos, valid, direction, value)


def make_photon_pack_auto(pos, valid, direction, value) -> dict:
    """Pack for `density_auto`: `make_photon_pack_sorted` where
    `sorted_layout`, at every size, else the flash layout."""
    if sorted_layout(pos.device):
        return make_photon_pack_sorted(pos, valid, direction, value)
    return make_photon_pack(pos, valid, direction, value)


def pack_layout(pack: dict) -> str:
    """The gather a density over `pack` takes (`density_auto`): "flash"
    (the brute force), "sorted" (`density_flash`'s culled search) or, from
    CULL_MIN_PHOTONS columns of a sorted pack, "culled"
    (`density_culled`)."""
    if "tbl" not in pack:
        return "flash"
    return "culled" if pack["tbl"].shape[1] >= CULL_MIN_PHOTONS else "sorted"


def flash_view(pack: dict) -> dict:
    """The flash layout of a sorted pack's photons (same order, same
    sentinels)."""
    tbl = pack["tbl"]
    return dict(pos_t=tbl[0:3].contiguous(), aux_t=tbl[3:6].contiguous(),
                val=tbl[6:9].T.contiguous())


def _r2(radius, n: int, device) -> torch.Tensor:
    """(n,) float32 squared radii from a scalar or (n,) radius (a scalar
    is filled on the device: no host copy, so the wrappers can be captured
    in a CUDA graph)."""
    if isinstance(radius, torch.Tensor):
        r = torch.broadcast_to(radius.to(device=device, dtype=F32), (n,))
    else:
        r = torch.full((n,), float(radius), dtype=F32, device=device)
    return r * r


# ---- plain PyTorch versions ---------------------------------------------


def _d2(qp, pos3):
    """(Q, B) squared distances, dx*dx + dy*dy + dz*dz left to right."""
    dx = qp[:, 0:1] - pos3[0:1]
    dy = qp[:, 1:2] - pos3[1:2]
    dz = qp[:, 2:3] - pos3[2:3]
    return dx * dx + dy * dy + dz * dz


def _density_block(qp, qn, r2, pos3, dir3, val, keep=None):
    """One photon block's (flux (Q,3), count (Q,)) of the density sum."""
    side = (qn[:, 0:1] * dir3[0:1] + qn[:, 1:2] * dir3[1:2]
            + qn[:, 2:3] * dir3[2:3])
    w = (_d2(qp, pos3) <= r2[:, None]) & (side > 0.0)
    if keep is not None:
        w = w & keep[:, None]
    w = w.to(F32)
    return w @ val, w.sum(dim=1)


def density_flash_plain(pack: dict, query_p, query_n, radius):
    """Plain density_flash: photon blocks of BP in order, each block's
    flux added as w @ value (the reference's `_density_ref`)."""
    n = query_p.shape[0]
    r2 = _r2(radius, n, query_p.device)
    pos_t, aux_t, val = pack["pos_t"], pack["aux_t"], pack["val"]
    flux = torch.zeros((n, 3), dtype=F32, device=query_p.device)
    cnt = torch.zeros((n,), dtype=F32, device=query_p.device)
    for q0 in range(0, n, _PLAIN_QUERIES):
        sl = slice(q0, q0 + _PLAIN_QUERIES)
        qp, qn = query_p[sl].to(F32), query_n[sl].to(F32)
        for b in range(0, pos_t.shape[1], BP):
            f, c = _density_block(qp, qn, r2[sl], pos_t[:, b:b + BP],
                                  aux_t[:, b:b + BP], val[b:b + BP])
            flux[sl] += f
            cnt[sl] += c
    return flux, cnt


def _nearest_flash_plain(pack: dict, query_p, radius):
    """(value, best d2) of `nearest_flash_plain`."""
    n = query_p.shape[0]
    r2 = _r2(radius, n, query_p.device)[:, None]
    pos_t, val = pack["pos_t"], pack["val"]
    out = torch.zeros((n, 3), dtype=F32, device=query_p.device)
    best = torch.full((n, 1), float("inf"), dtype=F32,
                      device=query_p.device)
    for q0 in range(0, n, _PLAIN_QUERIES):
        sl = slice(q0, q0 + _PLAIN_QUERIES)
        qp = query_p[sl].to(F32)
        bst, v_out = best[sl], out[sl]
        for b in range(0, pos_t.shape[1], BP):
            d2 = _d2(qp, pos_t[:, b:b + BP])
            m = d2.amin(dim=1, keepdim=True)
            onehot = (d2 <= m).to(F32)
            onehot = onehot / torch.clamp(onehot.sum(dim=1, keepdim=True),
                                          min=1.0)
            v = onehot @ val[b:b + BP]
            better = (m < bst) & (m <= r2[sl])
            bst = torch.where(better, m, bst)
            v_out = torch.where(better, v, v_out)
        best[sl], out[sl] = bst, v_out
    return out, best[:, 0]


def nearest_flash_plain(pack: dict, query_p, radius):
    """Plain nearest_flash (the reference's `_nearest_ref`)."""
    out, best = _nearest_flash_plain(pack, query_p, radius)
    return out, torch.isfinite(best)


def _nearest_culled_plain(pack: dict, query_p, radius):
    """(value, best d2) of `nearest_culled_plain`."""
    n = query_p.shape[0]
    tbl = pack["tbl"]
    r2 = _r2(radius, n, query_p.device)[:, None]
    blk, val = tbl[9:10], tbl[6:9].T
    out = torch.zeros((n, 3), dtype=F32, device=query_p.device)
    best = torch.full((n,), float("inf"), dtype=F32, device=query_p.device)
    step = max(1, _PLAIN_PAIRS // max(tbl.shape[1], 1))
    for q0 in range(0, n, step):
        sl = slice(q0, q0 + step)
        d2 = _d2(query_p[sl].to(F32), tbl[0:3])
        d2 = torch.where((d2 <= r2[sl]) & torch.isfinite(d2), d2,
                         float("inf"))
        m = d2.amin(dim=1, keepdim=True)
        tie = (d2 <= m) & torch.isfinite(d2)
        first = torch.where(tie, blk, float("inf")).amin(dim=1, keepdim=True)
        win = (tie & (blk == first)).to(F32)
        win = win / torch.clamp(win.sum(dim=1, keepdim=True), min=1.0)
        out[sl], best[sl] = win @ val, m[:, 0]
    return out, best


def nearest_culled_plain(pack: dict, query_p, radius):
    """Plain nearest_flash over a `make_photon_pack_nearest` pack: per
    query the lexicographic minimum of (d2, original block) over the
    photons within the radius, the value averaged over the photons that
    share that pair.  Equals `nearest_flash_plain` on the unsorted pack."""
    out, best = _nearest_culled_plain(pack, query_p, radius)
    return out, torch.isfinite(best)


def _box_d2(q, lo, hi):
    """Squared distance of points q (Q,3) to the box [lo, hi] (3,)."""
    dd = torch.maximum(torch.clamp(lo - q, min=0.0),
                       torch.clamp(q - hi, min=0.0))
    return dd[:, 0] * dd[:, 0] + dd[:, 1] * dd[:, 1] + dd[:, 2] * dd[:, 2]


def density_culled_plain(pack: dict, query_p, query_n, radius):
    """Plain density_culled: per query, only the clusters whose box lies
    within the radius (box d2 <= r2), summed as density_flash_plain sums,
    in cluster order."""
    n = query_p.shape[0]
    r2 = _r2(radius, n, query_p.device)
    tbl, lo, hi = pack["tbl"], pack["cl_lo"], pack["cl_hi"]
    flux = torch.zeros((n, 3), dtype=F32, device=query_p.device)
    cnt = torch.zeros((n,), dtype=F32, device=query_p.device)
    for q0 in range(0, n, _PLAIN_QUERIES):
        sl = slice(q0, q0 + _PLAIN_QUERIES)
        qp, qn = query_p[sl].to(F32), query_n[sl].to(F32)
        for c in range(lo.shape[0]):
            cols = slice(c * BP, (c + 1) * BP)
            keep = _box_d2(qp, lo[c], hi[c]) <= r2[sl]
            f, k = _density_block(qp, qn, r2[sl], tbl[0:3, cols],
                                  tbl[3:6, cols], tbl[6:9, cols].T, keep)
            flux[sl] += f
            cnt[sl] += k
    return flux, cnt


def _near_pair_tests(pack: dict, query_p, lim2, chunk: int) -> tuple:
    """(pair tests, box tests) of a search that visits, per query, every
    cluster whose box lies within the squared distance lim2 (N,): the
    valid photons of those clusters, and one box test per cluster."""
    lo, hi = pack["cl_lo"], pack["cl_hi"]
    n, n_cl = query_p.shape[0], lo.shape[0]
    valid = (pack["tbl"][0] < 0.5 * SENTINEL).reshape(n_cl, BP)
    per_cl = valid.sum(dim=1).to(torch.int64)
    pairs = 0
    for q0 in range(0, n, chunk):
        q = query_p[q0:q0 + chunk, None, :].to(F32)
        dd = torch.maximum(torch.clamp(lo[None] - q, min=0.0),
                           torch.clamp(q - hi[None], min=0.0))
        d2 = (dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1]
              + dd[..., 2] * dd[..., 2])
        near = d2 <= lim2[q0:q0 + chunk, None]
        pairs += int((near.to(torch.int64) * per_cl).sum())
    return pairs, n * n_cl


def culled_pair_tests(pack: dict, query_p, radius,
                      chunk: int = 4096) -> tuple:
    """(pair tests, box tests) the culled gather's data needs: per query,
    the valid photons of every cluster whose box lies within its radius,
    and one box test per cluster.  Counts what the inputs need, for a
    kernel's bound; not a kernel path."""
    return _near_pair_tests(
        pack, query_p, _r2(radius, query_p.shape[0], query_p.device), chunk)


def nearest_pair_tests(pack: dict, query_p, radius, best_d2,
                       chunk: int = 4096) -> tuple:
    """(pair tests, box tests) the culled nearest search's data needs: per
    query, the valid photons of every cluster whose box lies within
    min(r2, the query's final best d2), and one box test per cluster.
    Counts what the inputs need, for a kernel's bound; not a kernel path."""
    r2 = _r2(radius, query_p.shape[0], query_p.device)
    return _near_pair_tests(pack, query_p, torch.minimum(r2, best_d2), chunk)


# ---- CUDA wrappers --------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("photon_flash")
    if lib.density_flash_launch.argtypes is None:
        lib.density_flash_launch.argtypes = [
            _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P]
        lib.density_flash_launch.restype = _I
        lib.nearest_flash_launch.argtypes = [
            _P, _P, _I, _P, _P, _I, _P, _P, _P]
        lib.nearest_flash_launch.restype = _I
        lib.density_culled_launch.argtypes = [
            _P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P]
        lib.density_culled_launch.restype = _I
        lib.nearest_culled_launch.argtypes = [
            _P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _P]
        lib.nearest_culled_launch.restype = _I
        lib.density_sorted_launch.argtypes = [
            _P, _I, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P]
        lib.density_sorted_launch.restype = _I
    return lib


def _check_flash(pack: dict, dev, with_aux: bool) -> int:
    w = pack["pos_t"].shape[1]
    if w % BP:
        raise ValueError(f"pack width {w} is not a multiple of {BP}")
    _check("pos_t", pack["pos_t"], (3, w), dev)
    if with_aux:
        _check("aux_t", pack["aux_t"], (3, w), dev)
    _check("val", pack["val"], (w, 3), dev)
    return w


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_sorted(pack: dict, dev) -> int:
    n_cl = pack["cl_lo"].shape[0]
    _check("tbl", pack["tbl"], (16, n_cl * BP), dev)
    _check("cl_lo", pack["cl_lo"], (n_cl, 3), dev)
    _check("cl_hi", pack["cl_hi"], (n_cl, 3), dev)
    return n_cl


def density_flash(pack: dict, query_p, query_n, radius):
    """Σ value over the photons within `radius` (scalar or (N,)) of each
    query, front side only.  Returns (flux (N,3), count (N,)).  A flash
    pack takes the brute-force kernel; a sorted pack
    (`make_photon_pack_sorted`) one warp a query over the clusters whose
    box lies within its radius (on the CPU `density_culled_plain`: the same
    function)."""
    dev = query_p.device
    n = query_p.shape[0]
    _check("query_p", query_p, (n, 3), dev)
    _check("query_n", query_n, (n, 3), dev)
    culled = "tbl" in pack
    if culled:
        n_cl = _check_sorted(pack, dev)
    else:
        w = _check_flash(pack, dev, with_aux=True)
    if dev.type == "cpu":
        plain = density_culled_plain if culled else density_flash_plain
        return plain(pack, query_p, query_n, radius)
    if dev.type != "cuda":
        raise ValueError(f"density_flash: unsupported device {dev}")
    r2 = _r2(radius, n, dev)
    flux = torch.empty((n, 3), dtype=F32, device=dev)
    cnt = torch.empty((n,), dtype=F32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        if culled:
            code = lib.density_sorted_launch(
                pack["tbl"].data_ptr(), n_cl * BP, pack["cl_lo"].data_ptr(),
                pack["cl_hi"].data_ptr(), n_cl, query_p.data_ptr(),
                query_n.data_ptr(), r2.data_ptr(), n, flux.data_ptr(),
                cnt.data_ptr(), _stream(dev))
        else:
            code = lib.density_flash_launch(
                pack["pos_t"].data_ptr(), pack["aux_t"].data_ptr(),
                pack["val"].data_ptr(), w, query_p.data_ptr(),
                query_n.data_ptr(), r2.data_ptr(), n, flux.data_ptr(),
                cnt.data_ptr(), _stream(dev))
    density_flash.launches += 1
    _raise_on(code, "density_flash")
    return flux, cnt


density_flash.launches = 0


def nearest_flash_best(pack: dict, query_p, radius):
    """`nearest_flash` with the squared distance of the winner instead of
    the found flag: (value (N,3), best d2 (N,), inf where none is within
    the radius).  A flash pack takes the brute-force kernel, a
    `make_photon_pack_nearest` pack the culled search."""
    dev = query_p.device
    n = query_p.shape[0]
    _check("query_p", query_p, (n, 3), dev)
    culled = "tbl" in pack
    if culled:
        n_cl = _check_sorted(pack, dev)
    else:
        w = _check_flash(pack, dev, with_aux=False)
    if dev.type == "cpu":
        plain = _nearest_culled_plain if culled else _nearest_flash_plain
        return plain(pack, query_p, radius)
    if dev.type != "cuda":
        raise ValueError(f"nearest_flash: unsupported device {dev}")
    r2 = _r2(radius, n, dev)
    best = torch.empty((n,), dtype=F32, device=dev)
    val = torch.empty((n, 3), dtype=F32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        if culled:
            code = lib.nearest_culled_launch(
                pack["tbl"].data_ptr(), n_cl * BP, pack["cl_lo"].data_ptr(),
                pack["cl_hi"].data_ptr(), n_cl, query_p.data_ptr(),
                r2.data_ptr(), n, best.data_ptr(), val.data_ptr(),
                _stream(dev))
        else:
            code = lib.nearest_flash_launch(
                pack["pos_t"].data_ptr(), pack["val"].data_ptr(), w,
                query_p.data_ptr(), r2.data_ptr(), n, best.data_ptr(),
                val.data_ptr(), _stream(dev))
    nearest_flash.launches += 1
    _raise_on(code, "nearest_flash")
    return val, best


def nearest_flash(pack: dict, query_p, radius):
    """Value of the nearest photon within `radius` of each query (the
    reference's block semantics).  Returns (value (N,3), found (N,))."""
    val, best = nearest_flash_best(pack, query_p, radius)
    return val, torch.isfinite(best)


nearest_flash.launches = 0


def _query_blocks(qp, r2):
    """(B, 8) rows [lo xyz, hi xyz, max r2, 0] of consecutive BQ-query
    blocks."""
    n = qp.shape[0]
    pad = (-n) % BQ
    inf = float("inf")
    lo = torch.cat([qp, torch.full((pad, 3), inf, dtype=F32,
                                   device=qp.device)]).reshape(-1, BQ, 3)
    hi = torch.cat([qp, torch.full((pad, 3), -inf, dtype=F32,
                                   device=qp.device)]).reshape(-1, BQ, 3)
    rr = _pad_rows(r2, pad).reshape(-1, BQ)
    return torch.cat([lo.amin(1), hi.amax(1), rr.amax(1)[:, None],
                      torch.zeros_like(rr[:, :1])], dim=1).contiguous()


def density_culled(pack: dict, query_p, query_n, radius):
    """density_flash over a sorted pack, visiting per query only the
    clusters whose box lies within its radius.  On the card the queries
    are sorted along the pack's Morton curve first, so the 256 queries of
    a CTA share clusters, and un-permuted at the end."""
    dev = query_p.device
    n = query_p.shape[0]
    _check("query_p", query_p, (n, 3), dev)
    _check("query_n", query_n, (n, 3), dev)
    tbl, lo, hi = pack["tbl"], pack["cl_lo"], pack["cl_hi"]
    n_cl = _check_sorted(pack, dev)
    if dev.type == "cpu":
        return density_culled_plain(pack, query_p, query_n, radius)
    if dev.type != "cuda":
        raise ValueError(f"density_culled: unsupported device {dev}")
    r2 = _r2(radius, n, dev)
    perm = torch.argsort(_morton_points(query_p, lo.amin(0), hi.amax(0)),
                         stable=True)
    qp, qn, r2s = (x[perm].contiguous() for x in (query_p, query_n, r2))
    blk = _query_blocks(qp, r2s)
    flux = torch.empty((n, 3), dtype=F32, device=dev)
    cnt = torch.empty((n,), dtype=F32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.density_culled_launch(
            tbl.data_ptr(), tbl.shape[1], lo.data_ptr(), hi.data_ptr(), n_cl,
            qp.data_ptr(), qn.data_ptr(), r2s.data_ptr(), blk.data_ptr(), n,
            flux.data_ptr(), cnt.data_ptr(), _stream(dev))
    density_culled.launches += 1
    _raise_on(code, "density_culled")
    out_f = torch.empty_like(flux)
    out_c = torch.empty_like(cnt)
    out_f[perm] = flux
    out_c[perm] = cnt
    return out_f, out_c


density_culled.launches = 0


def density_auto(pack: dict, query_p, query_n, radius):
    """Density gather on the pack's layout (`pack_layout`)."""
    if pack_layout(pack) == "culled":
        return density_culled(pack, query_p, query_n, radius)
    return density_flash(pack, query_p, query_n, radius)
