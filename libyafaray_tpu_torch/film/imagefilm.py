"""Image film — weighted accumulation, splatting and adaptive AA (port of
libyafaray_tpu/film/imagefilm.py: film_init with the variance plane,
film_splat, splat_plane, their compact counterparts, film_image, the
adaptive estimators compute_aa_flags and compute_stderr_flags, and SPPM's
density layer, the alpha plane (film_alpha) and film save / load for
resume (film_param_hash, film_save, film_load, the reference's npz layout);
the AOV planes are film/passes.py's).

The dense lanes are pixel-ordered, one sample per pixel per plane, so
splatting a filter of radius R is (2R+1)² shifted plane-adds, never a
scatter.  A compact pass's lanes list only the flagged pixels: its splat
scatter-adds each lane's taps (`index_add`).  Within one filter offset the
live lanes of a batch slice name distinct pixels, and dead lanes and taps
off the film add exact zeros, so every pixel sees the dense splat's adds in
the dense splat's order.  A step of S samples a pixel computes each tap's
weights and contributions for all S at once, then adds them sample by
sample and tap by tap, in the reference's order.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..core.math import div
from .filters import eval_filter_2d, filter_radius

F32 = torch.float32


def film_init(h: int, w: int, device, with_density: bool = False,
              with_alpha: bool = False, with_variance: bool = False) -> dict:
    film = dict(
        wsum=torch.zeros((h, w, 3), dtype=F32, device=device),
        w=torch.zeros((h, w), dtype=F32, device=device),
        nsamples=torch.zeros((h, w), dtype=torch.int32, device=device),
    )
    if with_density:
        film["density"] = torch.zeros((h, w, 3), dtype=F32, device=device)
    if with_alpha:
        # coverage (bg_transp): filter-weighted like wsum, normalized by
        # the same w (film_alpha)
        film["alpha"] = torch.zeros((h, w, 1), dtype=F32, device=device)
    if with_variance:
        # second-moment plane (sum of w·C², wsum's footprint) for the
        # stderr estimator (compute_stderr_flags)
        film["m2"] = torch.zeros((h, w, 3), dtype=F32, device=device)
    return film


def _shift2d(a: torch.Tensor, oy: int, ox: int,
             batched: bool = False) -> torch.Tensor:
    """Shift a (H,W,...) plane, or each of a batch (S,H,W,...), by static
    offsets (out[y, x] = a[y-oy, x-ox]), zero-filling."""
    if oy == 0 and ox == 0:
        return a
    b = (slice(None),) if batched else ()
    h, w = a.shape[len(b)], a.shape[len(b) + 1]
    out = torch.zeros_like(a)
    out[b + (slice(max(oy, 0), h + min(oy, 0)),
             slice(max(ox, 0), w + min(ox, 0)))] = \
        a[b + (slice(max(-oy, 0), h - max(oy, 0)),
               slice(max(-ox, 0), w - max(ox, 0)))]
    return out


def clamp_sample(color: torch.Tensor, clamp_samples: float) -> torch.Tensor:
    """The reference's AA_clamp_samples: scale a sample down to a maximum
    channel of clamp_samples (0 = off).  The m2 plane squares the same
    clamped sample as wsum sums."""
    if clamp_samples <= 0.0:
        return color
    m = color.amax(dim=-1, keepdim=True)
    scale = torch.where(m > clamp_samples,
                        torch.full_like(m, clamp_samples)
                        / torch.clamp(m, min=1e-9), 1.0)
    return color * scale


def _taps(filter_type: str, pixel_width: float, sx, sy, active):
    """(oy, ox, weight) of each static neighbour offset: the filter at the
    distance from the neighbour's centre (o + 0.5) to the sample, times the
    lane's resample flag."""
    r = filter_radius(filter_type, pixel_width)
    for oy in range(-r, r + 1):
        for ox in range(-r, r + 1):
            yield oy, ox, eval_filter_2d(filter_type, ox + 0.5 - sx,
                                         oy + 0.5 - sy, pixel_width) * active


def _batch(lane_dims: int, color, *planes):
    """Sample planes with a leading batch axis: planes of lane_dims axes
    ((H,W) dense, (N,) compact) and their (..., C) color become a batch of
    one."""
    if planes[0].dim() > lane_dims:
        return (color,) + planes
    return tuple(x[None] for x in (color,) + planes)


def _splat_planes(planes: tuple, taps: list) -> tuple:
    """planes plus the taps' contributions, added slice by slice, tap by
    tap: the order in which the reference's step splats its batch, so a
    batch of S samples rounds as S splats in turn.  taps: per offset
    (add, (contribution of each plane, (S, ...) each))."""
    for k in range(taps[0][1][0].shape[0]):
        for add, contribs in taps:
            planes = tuple(add(acc, c[k]) for acc, c in zip(planes,
                                                            contribs))
    return planes


def film_splat(film: dict, color, sx, sy, active, filter_type: str,
               pixel_width: float, clamp_samples: float = 0.0) -> dict:
    """Accumulate one sample-per-pixel plane, or a batch of them, into the
    film.

    color: (H,W,3) radiance of this step's sample for each pixel, or
    (S,H,W,3) for S samples a pixel (splatted in order).
    sx, sy: (H,W) or (S,H,W) subpixel position in [0,1) of the sample in
    its pixel.
    active: (H,W) or (S,H,W) float 0/1 resample flag."""
    color, sx, sy, active = _batch(2, color, sx, sy, active)
    color = clamp_sample(color, clamp_samples)
    taps = [(torch.add, (_shift2d(wgt[..., None] * color, oy, ox, True),
                         _shift2d(wgt, oy, ox, True)))
            for oy, ox, wgt in _taps(filter_type, pixel_width, sx, sy,
                                     active)]
    wsum, wacc = _splat_planes((film["wsum"], film["w"]), taps)
    count = active.to(torch.int32)
    out = dict(film)
    out["wsum"] = wsum
    out["w"] = wacc
    out["nsamples"] = film["nsamples"] + (
        count[0] if count.shape[0] == 1
        else count.sum(dim=0, dtype=torch.int32))
    return out


def splat_plane(acc, val, sx, sy, active, filter_type: str,
                pixel_width: float):
    """Filter-weighted accumulation of one (H,W,C) sample plane, or a batch
    (S,H,W,C), with film_splat's wsum footprint (the m2 plane)."""
    val, sx, sy, active = _batch(2, val, sx, sy, active)
    taps = [(torch.add, (_shift2d(wgt[..., None] * val, oy, ox, True),))
            for oy, ox, wgt in _taps(filter_type, pixel_width, sx, sy,
                                     active)]
    return _splat_planes((acc,), taps)[0]


def _compact_taps(shape, pix, filter_type: str, pixel_width: float, sx, sy,
                  active):
    """(flat target pixel, weight) of each tap of a compact lane set: taps
    off the film and dead lanes (pix < 0) land on a real pixel with weight
    0."""
    h, w = shape
    pixc = torch.clamp(pix, min=0)
    py = torch.div(pixc, w, rounding_mode="floor")
    px = pixc - py * w
    for oy, ox, wgt in _taps(filter_type, pixel_width, sx, sy, active):
        yy, xx = py + oy, px + ox
        off = (yy < 0) | (yy >= h) | (xx < 0) | (xx >= w)
        wgt = torch.where(off, 0.0, wgt)
        flat = torch.clamp(yy, 0, h - 1) * w + torch.clamp(xx, 0, w - 1)
        yield flat.long(), wgt


def _scatter_add(plane: torch.Tensor, flat: torch.Tensor,
                 val: torch.Tensor) -> torch.Tensor:
    """plane (H,W,...) with val (N,...) added at flat pixel ids."""
    h, w = plane.shape[:2]
    return plane.reshape((h * w,) + plane.shape[2:]).index_add(
        0, flat, val).reshape(plane.shape)


def _scatter_at(flat: torch.Tensor):
    return lambda plane, val: _scatter_add(plane, flat, val)


def film_splat_compact(film: dict, color, pix, sx, sy, active,
                       filter_type: str, pixel_width: float,
                       clamp_samples: float = 0.0) -> dict:
    """film_splat for a compact lane set: color (N,3) samples of the flat
    pixel ids pix (N,) int32 (-1 marks a dead lane), sx, sy, active (N,);
    or a batch of S samples for each lane, color (S,N,3), sx, sy, active
    (S,N)."""
    color, sx, sy, active = _batch(1, color, sx, sy, active)
    color = clamp_sample(color, clamp_samples)
    taps = [(_scatter_at(flat), (wgt[..., None] * color, wgt))
            for flat, wgt in _compact_taps(film["w"].shape, pix,
                                           filter_type, pixel_width, sx, sy,
                                           active)]
    wsum, wacc = _splat_planes((film["wsum"], film["w"]), taps)
    count = (active > 0.0).to(torch.int32)
    out = dict(film)
    out["wsum"] = wsum
    out["w"] = wacc
    out["nsamples"] = _scatter_add(
        film["nsamples"], torch.clamp(pix, min=0).long(),
        count[0] if count.shape[0] == 1
        else count.sum(dim=0, dtype=torch.int32))
    return out


def splat_plane_compact(acc, val, pix, sx, sy, active, filter_type: str,
                        pixel_width: float):
    """splat_plane for a compact lane set (val (N,C), or (S,N,C))."""
    val, sx, sy, active = _batch(1, val, sx, sy, active)
    taps = [(_scatter_at(flat), (wgt[..., None] * val,))
            for flat, wgt in _compact_taps(acc.shape[:2], pix, filter_type,
                                           pixel_width, sx, sy, active)]
    return _splat_planes((acc,), taps)[0]


def film_image(film: dict) -> torch.Tensor:
    """Current weighted-mean image (H,W,3), linear RGB, plus the density
    layer where the film has one."""
    img = film["wsum"] / torch.clamp(film["w"], min=1e-8)[..., None]
    if "density" in film:
        img = img + film["density"]
    return img


def film_alpha(film: dict):
    """(H,W) weighted-mean alpha in [0, 1], or None when the film has no
    alpha plane; a pixel with no sample reads 0 (transparent)."""
    if "alpha" not in film:
        return None
    return torch.clamp(film["alpha"][..., 0]
                       / torch.clamp(film["w"], min=1e-8), 0.0, 1.0)


def _mean3(x: torch.Tensor) -> torch.Tensor:
    """Mean over a last axis of 3, summed in order and truly divided."""
    return div(x[..., 0] + x[..., 1] + x[..., 2], 3.0)


def _threshold(threshold: float, like: torch.Tensor, threshold_scale=None):
    thr = torch.tensor(threshold, dtype=F32, device=like.device)
    if threshold_scale is not None:
        # per-pixel scale (material samplingFactor: a factor > 1 lowers the
        # threshold there)
        thr = thr * threshold_scale
    return thr


def compute_aa_flags(film: dict, threshold: float,
                     dark_detection: str = "none", dark_factor: float = 1.0,
                     detect_color_noise: bool = False,
                     threshold_scale=None) -> torch.Tensor:
    """(H,W) bool resample flags for the next adaptive pass (the reference's
    contrast estimator): flag where the mean (detect_color_noise: max)
    channel delta to any 4-neighbour exceeds the threshold, lowered in dark
    regions by dark_detection "linear" or "curve"; then dilate the flags by
    one pixel."""
    img = film_image(film)
    thr = _threshold(threshold, img, threshold_scale)
    if dark_detection == "linear":
        thr = thr * torch.clamp(_mean3(img) * dark_factor, 0.25, 1.0)
    elif dark_detection == "curve":
        thr = thr * torch.clamp(torch.sqrt(torch.clamp(_mean3(img), min=0.0))
                                * dark_factor, 0.1, 1.0)
    steps = ((0, 1), (0, -1), (1, 0), (-1, 0))
    flag = torch.zeros(img.shape[:2], dtype=torch.bool, device=img.device)
    for oy, ox in steps:
        d = (img - _shift2d(img, oy, ox)).abs()
        delta = d.amax(dim=-1) if detect_color_noise else _mean3(d)
        flag = flag | (delta > thr)
    dil = flag
    for oy, ox in steps:
        dil = dil | _shift2d(flag, oy, ox)
    return dil


def film_stderr(film: dict) -> torch.Tensor:
    """(H,W) standard error of the filtered pixel mean from the m2 plane:
    sqrt(mean_rgb(var) / w), var = m2/w - (wsum/w)²."""
    w = torch.clamp(film["w"], min=1e-9)[..., None]
    mean = film["wsum"] / w
    var = torch.clamp(film["m2"] / w - mean * mean, min=0.0)
    return torch.sqrt(_mean3(var) / w[..., 0])


def compute_stderr_flags(film: dict, threshold: float,
                         threshold_scale=None) -> torch.Tensor:
    """(H,W) bool flags of the variance estimator: flag while a pixel's
    standard error exceeds the threshold (scaled per pixel as in
    compute_aa_flags), and every pixel with no sample yet."""
    err = film_stderr(film)
    return (err > _threshold(threshold, err, threshold_scale)) | (
        film["nsamples"] < 1)


def add_density(film: dict, contrib: torch.Tensor) -> dict:
    """SPPM's density layer accumulation (reference addDensitySample)."""
    base = film.get("density")
    return dict(film, density=contrib if base is None else base + contrib)


# ---- save / load for resume (the reference's binary film + autosave) -------


def film_param_hash(params: dict) -> str:
    s = repr(sorted(params.items()))
    return hashlib.sha256(s.encode()).hexdigest()[:16]


def film_save(path: str, film: dict, params: dict, pass_idx: int) -> None:
    """np.savez_compressed of every film key (tensors copied to the host in
    their dtypes) beside __hash__ (of params) and __pass__ (the pass or
    step to resume from).  numpy appends .npz to a path without it, as for
    the reference's writer."""
    arrays = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v) for k, v in film.items()}
    np.savez_compressed(path, __hash__=film_param_hash(params),
                        __pass__=pass_idx, **arrays)


def film_load(path: str, params: dict, device):
    """(film, pass_idx) of a film_save file, every array a tensor on
    `device` in its saved dtype; None when the file is missing or was saved
    under other params (the render then starts fresh)."""
    try:
        data = np.load(path, allow_pickle=False)
    except (FileNotFoundError, OSError):
        return None
    with data:
        if str(data["__hash__"]) != film_param_hash(params):
            return None
        film = {k: torch.from_numpy(np.array(data[k])).to(device)
                for k in data.files if not k.startswith("__")}
        return film, int(data["__pass__"])
