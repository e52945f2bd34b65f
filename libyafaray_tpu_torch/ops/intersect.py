"""Ray-scene intersection: the hit record and the dispatch to the kernels.

Port of the tiny-scene section of libyafaray_tpu/ops/intersect.py and
ops/pallas_intersect.py.  Scenes of at most TINY_TRIS triangles go to the
two tiny-scene kernels of `ops/cuda_intersect.py`, whose wrappers launch
the CUDA kernel for a CUDA tensor and run the plain PyTorch version for a
CPU tensor.  Larger scenes raise until the clustered kernels are ported.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import cuda_intersect

RAY_EPS = 5e-5  # reference ray_min_dist default
SHADOW_EPS = 5e-4  # reference shadow_bias default
TINY_TRIS = cuda_intersect.TINY_TRIS

_LARGER = ("scenes above {} triangles need the clustered intersection "
           "kernels, not ported yet: ROADMAP Queue 2 item 3 onward (items "
           "3-6)")


class Hit(NamedTuple):
    t: torch.Tensor  # (N,) hit distance (inf if miss)
    tri: torch.Tensor  # (N,) int32 triangle index (0 if miss; check .hit)
    u: torch.Tensor  # (N,) barycentric u (weight of corner 1)
    v: torch.Tensor  # (N,) barycentric v (weight of corner 2)
    hit: torch.Tensor  # (N,) bool


def intersector_for(device) -> str:
    """The reference's intersector choice, keyed on the torch device.  The
    port compiles at most 1024 triangles, below the reference's dense
    budget on either device, so the choice is "brute"; the budgets come
    with the BVH and clustered paths (ROADMAP Queue 2 item 3)."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no intersector for device {dev}")
    return "brute"


def pad_triangles(v0, e1, e2, multiple: int):
    """Pad triangle SoA numpy arrays to a multiple of `multiple` with
    never-hit degenerates (e1=e2=0 => det=0 => invalid)."""
    t = v0.shape[0]
    pad = (-t) % multiple
    if pad == 0:
        return v0, e1, e2, t
    z = np.zeros((pad, 3), np.float32)
    far = np.full((pad, 3), 1e30, np.float32)
    return (np.concatenate([v0, far]), np.concatenate([e1, z]),
            np.concatenate([e2, z]), t)


def _check_tiny(n_tris: int) -> None:
    if n_tris > TINY_TRIS:
        raise NotImplementedError(_LARGER.format(TINY_TRIS))


def closest_hit(arrays: dict, static, org, dirn, tmin, tmax) -> Hit:
    """Nearest hit of every ray in (tmin, tmax) over the scene triangles."""
    _check_tiny(static.n_tris_real)
    t, tri, u, v, hit = cuda_intersect.closest_hit_tiny(
        arrays["tri_pack10"], org.contiguous(), dirn.contiguous(),
        tmin.contiguous(), tmax.contiguous(), n_tris=static.n_tris_real)
    return Hit(t=t, tri=tri, u=u, v=v, hit=hit)


def shadow_transmission(arrays: dict, static, transp_shad: bool, org, dirn,
                        dist) -> torch.Tensor:
    """(N,3) transmission along org -> org + dirn·dist (0 = occluded)."""
    _check_tiny(static.n_stris_real)
    filt4 = arrays["sfilt4"] if transp_shad else arrays["sfilt4_binary"]
    return cuda_intersect.shadow_transmission_tiny(
        arrays["stri_pack10"], filt4, org.contiguous(), dirn.contiguous(),
        dist.contiguous(), n_tris=static.n_stris_real)
