"""Ray-scene intersection: the hit record and the dispatch to the kernels.

Port of libyafaray_tpu/ops/intersect.py's hit record, of the engine's
choice between the clustered kernels and the threaded BVH
(`static.intersector`: "bvh" above MAX_TRIS = 2^20 triangles, the walks of
`ops/bvh_traverse.py` over the scene's `bvh` / `sbvh`), and of the choice
`closest_hit_pallas` / `shadow_transmission_pallas` make in
ops/pallas_intersect.py among the clustered kernels, by pack shape:
- at most TINY_TRIS triangles: the tiny-scene kernels
  (`ops/cuda_intersect.py`);
- fewer than FB_MIN_CLUSTERS = 4 clusters: the dense kernels
  (`ops/cluster_intersect.py`, 65 to 384 triangles);
- 4 or more clusters that do not take the gathered-fine kernels (fewer
  than 8 sub-clusters): the streaming kernels (same module, 385 to 896);
- the rest: the gathered-fine kernels (`ops/fine_intersect.py`);
- on request (`Scene.compile(pairs=True)`, which sets `SceneStatic.pairs`)
  and at PAIRS_MIN_CLUSTERS = 64 clusters or more: the pair-granular route
  (`ops/pairs_intersect.py`), its stragglers through the fine kernels.
The reference takes its pair route from an environment flag
(`LIBYAF_PAIRS`); the port only from the caller's argument.  Neither
has an effect on a BVH scene.  Each wrapper
launches its CUDA kernel for a CUDA tensor and runs its plain PyTorch
version for a CPU tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import (bvh_traverse, cluster_intersect, cuda_intersect,
               fine_intersect, pairs_intersect)

RAY_EPS = 5e-5  # reference ray_min_dist default
SHADOW_EPS = 5e-4  # reference shadow_bias default
TINY_TRIS = cuda_intersect.TINY_TRIS
MAX_TRIS = 1 << 20  # the reference's budget for its clustered kernels

class Hit(NamedTuple):
    t: torch.Tensor  # (N,) hit distance (inf if miss)
    tri: torch.Tensor  # (N,) int32 triangle index (0 if miss; check .hit)
    u: torch.Tensor  # (N,) barycentric u (weight of corner 1)
    v: torch.Tensor  # (N,) barycentric v (weight of corner 2)
    hit: torch.Tensor  # (N,) bool


def intersector_for(device, n_tris: int) -> str:
    """The intersector for a scene of n_tris triangles rendered on `device`:
    "brute" (the tiny and clustered kernels) up to MAX_TRIS on either
    device, "bvh" (the threaded BVH walks) above it, as in the reference.
    Unlike the reference, the CPU does not switch to the BVH above
    CPU_DENSE_MAX = 131072: that switch is a speed heuristic of the JAX
    CPU path, and the port's CPU path runs the plain versions of its
    kernels, whose answers are the kernels' own."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no intersector for device {dev}")
    return "bvh" if n_tris > MAX_TRIS else "brute"


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


def route(pack10: torch.Tensor, cluster8: torch.Tensor, n_tris: int,
          pairs: bool = False) -> str:
    """The kernels a pack takes: "tiny", "dense", "stream" or "fine"; or
    "pairs" when the caller asks for it and the pack has at least
    PAIRS_MIN_CLUSTERS clusters."""
    if n_tris <= TINY_TRIS:
        return "tiny"
    tp, n_cl = pack10.shape[1], cluster8.shape[1]
    if pairs and n_cl >= pairs_intersect.PAIRS_MIN_CLUSTERS:
        # the pair route's stragglers take the fine kernels
        if not fine_intersect.takes_fine_path(tp, n_cl):
            raise ValueError(f"a pack of {tp} columns in {n_cl} clusters "
                             "cannot take the fine kernels the pair route's "
                             "stragglers need")
        return "pairs"
    if n_cl < fine_intersect.FB_MIN_CLUSTERS:
        return "dense"
    if not fine_intersect.takes_fine_path(tp, n_cl):
        return "stream"
    return "fine"


def closest_hit(arrays: dict, static, org, dirn, tmin, tmax) -> Hit:
    """Nearest hit of every ray in (tmin, tmax) over the scene triangles."""
    org, dirn = org.contiguous(), dirn.contiguous()
    tmin, tmax = tmin.contiguous(), tmax.contiguous()
    if static.intersector == "bvh":
        return Hit(*bvh_traverse.closest_hit_bvh(
            arrays["bvh"], arrays["tri_geom_pack"], org, dirn, tmin, tmax))
    n_tris = static.n_tris_real
    pack = arrays["tri_pack10"]
    cl = arrays["tri_cluster8"]
    kind = route(pack, cl, n_tris, static.pairs)
    if kind == "tiny":
        return Hit(*cuda_intersect.closest_hit_tiny(pack, org, dirn, tmin,
                                                    tmax, n_tris=n_tris))
    if kind in ("fine", "pairs"):
        kernel = (fine_intersect.closest_hit_fine if kind == "fine"
                  else pairs_intersect.closest_hit_pairs)
        t, col = kernel(pack, cl, arrays["tri_sub8"], org, dirn, tmin, tmax,
                        n_tris=n_tris)
    elif kind == "stream":
        t, col = cluster_intersect.closest_hit_stream(
            pack, cl, arrays["tri_box32"], org, dirn, tmin, tmax,
            n_tris=n_tris)
    else:
        t, col = cluster_intersect.closest_hit_dense(pack, cl, org, dirn,
                                                     tmin, tmax, n_tris=n_tris)
    return Hit(*fine_intersect.closest_epilogue(pack, org, dirn, t, col,
                                                n_tris))


def shadow_transmission(arrays: dict, static, transp_shad: bool, org, dirn,
                        dist) -> torch.Tensor:
    """(N,3) transmission along org -> org + dirn·dist (0 = occluded)."""
    org, dirn, dist = org.contiguous(), dirn.contiguous(), dist.contiguous()
    if static.intersector == "bvh":
        return bvh_traverse.shadow_transmission_bvh(
            arrays["sbvh"], arrays["stri_geom_pack"],
            arrays["sbvh_lf4" if transp_shad else "sbvh_lf4_binary"], org,
            dirn, dist)
    n_tris = static.n_stris_real
    pack = arrays["stri_pack10"]
    filt4 = arrays["sfilt4"] if transp_shad else arrays["sfilt4_binary"]
    cl = arrays["stri_cluster8"]
    kind = route(pack, cl, n_tris, static.pairs)
    if kind == "tiny":
        return cuda_intersect.shadow_transmission_tiny(
            pack, filt4, org, dirn, dist, n_tris=n_tris)
    if kind in ("fine", "pairs"):
        kernel = (fine_intersect.shadow_transmission_fine if kind == "fine"
                  else pairs_intersect.shadow_transmission_pairs)
        return kernel(pack, cl, arrays["stri_sub8"], filt4, org, dirn, dist,
                      n_tris=n_tris)
    if kind == "dense":
        return cluster_intersect.shadow_transmission_dense(
            pack, cl, arrays["stri_box32"], filt4, org, dirn, dist,
            n_tris=n_tris)
    return cluster_intersect.shadow_transmission_stream(
        pack, cl, arrays["stri_box32"], filt4, org, dirn, dist, n_tris=n_tris)
