"""DebugIntegrator (port of libyafaray_tpu/integrators/debug.py, reference
src/integrators/DebugIntegrator.cc): geometry and shading-frame fields as
colour, one camera ray through each pixel centre.

    N, Ng      shading / geometric normal, n·0.5 + 0.5
    dPdU, dPdV the uv parameterization's derivatives, normalized
    NU, NV     dPdU orthonormalized against N (the ONB's u where dPdU is
               degenerate), and N × NU
    UV         (u, v, 0)
    anything   the hit distance t
    else
Missed pixels are black.  The film holds the image as its weighted sum
with unit weights, so film_image returns it as is.
"""
from __future__ import annotations

import time

import torch

from ..cameras.base import shoot_rays
from ..convert import to_tensors
from ..core import math as vmath
from ..film.imagefilm import film_init
from .config import RenderConfig
from .engine import (F32, _surface_point, check_arrays, check_supported,
                     closest_hit, resolve_device)
from .render import RenderResult, _sync

DEBUG_TYPES = ("N", "Ng", "dPdU", "dPdV", "NU", "NV", "UV", "t")


def _frame_u(sp):
    """NU: dPdU less its component along N, normalized; the ONB's u where
    that is shorter than 1e-9."""
    du = sp["dpdu"] - sp["n"] * vmath.dot(sp["n"], sp["dpdu"])[..., None]
    dl = vmath.length(du)[..., None]
    onb_u, _ = vmath.build_onb(sp["n"])
    return torch.where(dl > 1e-9, du / torch.clamp(dl, min=1e-9), onb_u)


def debug_colors(sp: dict, hit, debug_type: str) -> torch.Tensor:
    """(N, 3) colour of each lane's hit for debug_type."""
    if debug_type == "N":
        return sp["n"] * 0.5 + 0.5
    if debug_type == "Ng":
        return sp["ng"] * 0.5 + 0.5
    if debug_type == "dPdU":
        return vmath.normalize(sp["dpdu"]) * 0.5 + 0.5
    if debug_type == "dPdV":
        return vmath.normalize(sp["dpdv"]) * 0.5 + 0.5
    if debug_type == "NU":
        return _frame_u(sp) * 0.5 + 0.5
    if debug_type == "NV":
        return vmath.cross(sp["n"], _frame_u(sp)) * 0.5 + 0.5
    if debug_type == "UV":
        return torch.stack([sp["uv"][..., 0], sp["uv"][..., 1],
                            torch.zeros_like(hit.t)], dim=-1)
    return hit.t[..., None].expand(-1, 3)


def render_debug(cscene, cfg: RenderConfig, debug_type: str = "N", *,
                 device="cuda") -> RenderResult:
    """The debug image of `debug_type` (default "N", as the session asks
    for it).  stats: render_s (the traced pass, synchronized) and rays
    (one a pixel)."""
    dev = resolve_device(device)
    check_supported(cscene.static, cfg)
    arrays = to_tensors(cscene.arrays, dev)
    check_arrays(arrays, dev)
    static = cscene.static
    h, w = cfg.height, cfg.width
    n = h * w
    _sync(dev)
    t0 = time.perf_counter()
    lane = torch.arange(n, dtype=torch.int32, device=dev)
    py = torch.div(lane, w, rounding_mode="floor")
    px = lane - py * w
    zeros = torch.zeros((n,), dtype=F32, device=dev)  # no lens sample
    org, dirn, _ = shoot_rays(cscene.camera, px.to(F32) + 0.5,
                              py.to(F32) + 0.5, zeros, zeros)
    tmin = torch.full((n,), static.ray_min_dist, dtype=F32, device=dev)
    hit = closest_hit(arrays, static, org, dirn, tmin,
                      torch.full((n,), float("inf"), dtype=F32, device=dev))
    sp = _surface_point(arrays, hit, org, dirn, tex=True)
    c = torch.where(hit.hit[..., None], debug_colors(sp, hit, debug_type),
                    0.0)
    film = film_init(h, w, dev)
    film = dict(film, wsum=c.reshape(h, w, 3),
                w=torch.ones((h, w), dtype=F32, device=dev))
    _sync(dev)
    return RenderResult(film, dict(render_s=time.perf_counter() - t0,
                                   rays=float(n)), cfg)
