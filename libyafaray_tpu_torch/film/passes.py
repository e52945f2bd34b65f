"""Render passes / AOVs (port of libyafaray_tpu/film/passes.py; reference
src/yafraycore/renderpasses.cc).

A pass plane lives in the film dict as `aov_<source>`, (H, W, C) float32 on
the render's device, accumulated by the sample step (integrators/engine.py
`advance`, the BDPT step's first-hit planes).  `extract_passes` runs on the
host in numpy at flush: it normalizes each plane by the pixel's sample
count (nsamples) or, for the filter-weighted planes, by the film's w, and
post-processes (normal remap, z normalization, index colors and masks,
mist, ao-clay, and the edge / toon / indirect planes composed from the
others).
"""
from __future__ import annotations

import numpy as np
import torch

# pass name -> (engine aux source, channels)
PASS_SOURCES = {
    "z-depth-abs": ("z", 1),
    "z-depth-norm": ("z", 1),
    "mist": ("z", 1),
    "normal-smooth": ("normal", 3),
    "normal-geom": ("geo_normal", 3),
    "uv": ("uv", 2),
    "mat-index-abs": ("mat_index", 1),
    "mat-index-norm": ("mat_index", 1),
    "mat-index-auto": ("mat_index", 1),
    "mat-index-mask": ("mat_index", 1),
    "obj-index-abs": ("obj_index", 1),
    "obj-index-norm": ("obj_index", 1),
    "obj-index-auto": ("obj_index", 1),
    "obj-index-mask": ("obj_index", 1),
    "diffuse-color": ("diffuse_color", 3),
    "emit": ("emit", 3),
    "direct": ("direct", 3),
    "diffuse-direct": ("direct", 3),
    "ao": ("ao", 3),
    "ao-clay": ("ao", 3),
    "shadow": ("shadow", 1),
    "reflect": ("reflect", 3),
    "refract": ("refract", 3),
    "debug-nu": ("nu", 3),
    "debug-nv": ("nv", 3),
    "debug-dpdu": ("dpdu", 3),
    "debug-dpdv": ("dpdv", 3),
}

# composed at flush from other planes: the edge and toon post-filters, and
# indirect / diffuse-indirect = combined - direct - emit - reflect - refract
POST_PASSES = ("edge", "toon", "indirect", "diffuse-indirect")
PASS_NAMES = tuple(PASS_SOURCES) + POST_PASSES

# planes splatted with the reconstruction filter's weights, like wsum
# (normalized by film["w"]): they enter the indirect decomposition against
# the filter-weighted combined image.  Every other plane is a plain
# per-sample sum (normalized by nsamples).
FILTER_WEIGHTED_AOVS = frozenset({"direct", "emit", "reflect", "refract"})


def film_add_passes(film: dict, h: int, w: int, passes: tuple,
                    device) -> dict:
    """Allocate (zeros on `device`) the planes the requested passes read."""
    need: dict[str, int] = {}
    for p in passes:
        if p in ("edge", "toon"):  # edge / toon read normals and z
            need["normal"] = 3
            need["z"] = 1
        if p in ("indirect", "diffuse-indirect"):
            need["direct"] = 3
            need["emit"] = 3
            need["reflect"] = 3
            need["refract"] = 3
        if p in PASS_SOURCES:
            src, ch = PASS_SOURCES[p]
            need[src] = ch
    for src, ch in need.items():
        film[f"aov_{src}"] = torch.zeros((h, w, ch), dtype=torch.float32,
                                         device=device)
    return film


def _host(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def extract_passes(film: dict, passes: tuple) -> dict:
    """-> name -> (H,W,C) float32 numpy planes, normalized and
    post-processed, in the reference's order of operations."""
    film = {k: _host(v) for k, v in film.items()}
    ns = np.maximum(np.asarray(film["nsamples"], np.float32), 1.0)[..., None]
    wf = np.maximum(np.asarray(film["w"]), 1e-8)[..., None]
    out = {}
    for p in passes:
        if p not in PASS_SOURCES:
            continue
        src, ch = PASS_SOURCES[p]
        norm = wf if src in FILTER_WEIGHTED_AOVS else ns
        plane = np.asarray(film[f"aov_{src}"]) / norm
        if p == "z-depth-norm":
            zmax = plane.max() or 1.0
            plane = plane / zmax
        elif p == "mist":
            zmax = plane.max() or 1.0
            plane = 1.0 - plane / zmax
        elif p in ("normal-smooth", "normal-geom"):
            plane = plane * 0.5 + 0.5
        elif p in ("mat-index-norm", "obj-index-norm"):
            m = plane.max() or 1.0
            plane = plane / m
        elif p in ("mat-index-auto", "obj-index-auto"):
            # a stable pseudo-random color per index (uint32 wrap-around)
            idx = np.round(plane[..., 0]).astype(np.uint32)
            h32 = (idx * np.uint32(2654435761)) & np.uint32(0xFFFFFF)
            plane = np.stack([(h32 >> 16) & 0xFF, (h32 >> 8) & 0xFF,
                              h32 & 0xFF], axis=-1) / 255.0
        elif p in ("mat-index-mask", "obj-index-mask"):
            # binary mask of index 0
            plane = (np.round(plane) == 0.0).astype(np.float32)
        elif p == "ao-clay":
            # AO on a white clay material: the luminance only
            lum = plane.mean(axis=-1, keepdims=True)
            plane = np.repeat(lum, 3, axis=-1)
        out[p] = plane.astype(np.float32)
    for p in passes:
        if p in ("indirect", "diffuse-indirect"):
            # combined - direct - emit - reflect - refract, clamped at 0
            img = np.asarray(film["wsum"]) / np.maximum(
                np.asarray(film["w"]), 1e-8)[..., None]
            sub = np.zeros_like(img)
            for src in ("direct", "emit", "reflect", "refract"):
                key = f"aov_{src}"
                if key in film:
                    sub = sub + np.asarray(film[key]) / wf
            out[p] = np.clip(img - sub, 0.0, None).astype(np.float32)
            continue
        if p not in ("edge", "toon"):
            continue
        ns2 = np.maximum(np.asarray(film["nsamples"], np.float32), 1.0)
        nrm = np.asarray(film["aov_normal"]) / ns2[..., None]
        z = (np.asarray(film["aov_z"]) / ns2[..., None])[..., 0]

        def grad(a):
            gx = np.zeros_like(a)
            gy = np.zeros_like(a)
            gx[:, 1:] = a[:, 1:] - a[:, :-1]
            gy[1:, :] = a[1:, :] - a[:-1, :]
            return np.abs(gx) + np.abs(gy)

        e_n = grad(nrm[..., 0]) + grad(nrm[..., 1]) + grad(nrm[..., 2])
        zmax = z.max() or 1.0
        e_z = grad(z / zmax)
        edge = np.clip(e_n * 0.5 + e_z * 4.0, 0.0, 1.0)
        if p == "edge":
            out[p] = np.repeat(edge[..., None], 3, axis=-1).astype(np.float32)
        else:  # toon: the quantized combined color with dark edges
            img = np.asarray(film["wsum"]) / np.maximum(
                np.asarray(film["w"]), 1e-8)[..., None]
            quant = np.round(np.clip(img, 0, 1) * 4.0) / 4.0
            out[p] = (quant * (1.0 - edge[..., None])).astype(np.float32)
    return out
