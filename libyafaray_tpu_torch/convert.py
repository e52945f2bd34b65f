"""Scene and config conversion (the renderer's "weights" are its compiled
scene).

`arrays_from_reference` takes the reference package's
`CompiledScene.arrays` (a nested dict of numpy arrays) and returns the
port's tensors for the keys the port reads; `static_from_reference`,
`camera_from_reference` and `config_from_reference` copy the plain fields
of the reference's SceneStatic, Camera and RenderConfig from duck-typed
objects.  Nothing here imports the reference package: the tests use these
to feed both engines identical scenes.  `to_tensors` is also how a render
moves the port's own compile to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .backgrounds.base import BackgroundSpec
from .cameras.base import Camera
from .integrators.config import RenderConfig
from .ops.bvh_traverse import leaf_lf4, log_filter4, pack_bvh
from .ops.cluster_intersect import quarter_boxes
from .ops.fine_intersect import sub_aabbs
from .scene.scene import (BACKGROUND_ARRAY_KEYS, LIGHT_ARRAY_PREFIXES,
                          ORCO_ARRAY_KEY, SLICE_ARRAY_KEYS, SPHERE_ARRAY_KEYS,
                          TEXTURE_ARRAY_PREFIXES, TRI_POS_KEY, LightStatic,
                          SceneStatic)
from .textures.nodes import NodeProgram, NodeSpec
from .volumes.factory import VolumeRegion, grid_arrays

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.bool_): torch.bool}


def to_tensors(arrays: dict, device, _done: dict | None = None) -> dict:
    """Nested dict of numpy arrays -> the same dict of tensors on `device`.
    Keeps float32 / int32 / bool; float64 and int64 are narrowed to
    float32 / int32 so no lane is promoted to 64 bits.  An array or dict
    that appears under several keys (the shadow set's packs and BVH when
    they alias the visible set's) is moved once and aliased."""
    done = {} if _done is None else _done
    out = {}
    for k, v in arrays.items():
        if id(v) in done:
            out[k] = done[id(v)][1]
            continue
        if isinstance(v, dict):
            out[k] = to_tensors(v, device, done)
            done[id(v)] = (v, out[k])
            continue
        a = np.asarray(v)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        if a.dtype not in _DTYPES:
            raise TypeError(f"array {k!r}: unsupported dtype {a.dtype}")
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        done[id(v)] = (v, out[k])
    return out


def arrays_from_reference(arrays: dict, device,
                          n_stris_real: int | None = None,
                          volumes: tuple = ()) -> dict:
    """The reference's CompiledScene.arrays -> the port's scene tensors:
    the keys the port reads (with the sphere pack, the textures, the orco
    pack, the background's map and IBL tables, the meshlights' and
    portals' CDFs with tri_pos, and the IES profiles where the scene has
    them), plus the sub-cluster and 32-column box tables the port builds
    once per scene (FINE_ARRAY_KEYS, QUARTER_ARRAY_KEYS), each set's from
    its own pack: the visible set's real width is the triangle count
    (tri_shade_pack rows), the shadow set's `n_stris_real` (the reference
    static's), which a scene whose shadow set differs must give; the
    reference's `bvh` / `sbvh` where it built them, packed for the card,
    with the rest of BVH_ARRAY_KEYS made from its shadow triangles and
    filters; and the density grids of `volumes` (the static's regions)
    that are GridVolumes."""
    missing = [k for k in SLICE_ARRAY_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"reference arrays lack {missing}")
    n_real = arrays["tri_shade_pack"].shape[0]
    same = np.array_equal(arrays["stri_pack10"], arrays["tri_pack10"])
    if n_stris_real is None:
        if not same:
            raise ValueError("the shadow set differs from the visible set: "
                             "pass the reference static's n_stris_real")
        n_stris_real = n_real
    tables = {"tri_sub8": sub_aabbs(arrays["tri_pack10"], n_real),
              "tri_box32": quarter_boxes(arrays["tri_pack10"], n_real)}
    if same and n_stris_real == n_real:
        tables.update(stri_sub8=tables["tri_sub8"],
                      stri_box32=tables["tri_box32"])
    else:
        tables.update(stri_sub8=sub_aabbs(arrays["stri_pack10"], n_stris_real),
                      stri_box32=quarter_boxes(arrays["stri_pack10"],
                                               n_stris_real))
    if "bvh" in arrays:
        st = arrays["stris"]
        sgeom9 = np.concatenate([st["v0"], st["e1"], st["e2"]],
                                axis=1)[:n_stris_real].astype(np.float32)
        bvh = pack_bvh(arrays["bvh"], arrays["tri_geom_pack"])
        sbvh = (bvh if arrays["sbvh"] is arrays["bvh"]
                else pack_bvh(arrays["sbvh"], sgeom9))
        tables.update(bvh=bvh, sbvh=sbvh, stri_geom_pack=sgeom9)
        for key, f in (("sbvh_lf4", "shadow_filt"),
                       ("sbvh_lf4_binary", "shadow_filt_binary")):
            tables[key] = leaf_lf4(sbvh, log_filter4(torch.from_numpy(
                np.asarray(arrays[f], np.float32)[:n_stris_real])).numpy())
    keys = SLICE_ARRAY_KEYS + tuple(
        k for k in arrays
        if k in SPHERE_ARRAY_KEYS + BACKGROUND_ARRAY_KEYS + (ORCO_ARRAY_KEY,)
        or k.startswith(TEXTURE_ARRAY_PREFIXES + LIGHT_ARRAY_PREFIXES))
    if any(k.startswith("mlight_cdf_") for k in keys):
        keys += (TRI_POS_KEY,)
    return to_tensors({**{k: arrays[k] for k in keys}, **tables,
                       **grid_arrays(volumes)}, device)


def _copy_fields(cls, ref, **override):
    return cls(**{f.name: override[f.name] if f.name in override
                  else getattr(ref, f.name) for f in dataclasses.fields(cls)})


def static_from_reference(static, materials: dict | None = None
                          ) -> SceneStatic:
    """The reference's SceneStatic -> the port's (the fields the port reads),
    its volume regions included.  The reference keeps no dispersion flag
    (its step always carries the wavelength lane): `materials`, the
    reference's compiled material table, sets it; without it the static
    has none."""
    # the reference takes its pair route from an environment flag, not its
    # static: a converted static asks for the default routes
    dispersion = materials is not None and bool(
        np.any(np.asarray(materials["dispersion_power"]) > 1e-6))
    return _copy_fields(
        SceneStatic, static, pairs=False, dispersion=dispersion,
        lights=tuple(_copy_fields(LightStatic, ls) for ls in static.lights),
        bg=_copy_fields(BackgroundSpec, static.bg),
        volumes=tuple(_copy_fields(VolumeRegion, v) for v in static.volumes),
        mat_families=tuple(int(c) for c in static.mat_families),
        node_programs=tuple(
            NodeProgram(nodes=tuple(NodeSpec(*nd) for nd in prog.nodes),
                        slots=tuple(prog.slots))
            for prog in static.node_programs))


def camera_from_reference(camera) -> Camera:
    return _copy_fields(Camera, camera)


def config_from_reference(cfg) -> RenderConfig:
    return _copy_fields(RenderConfig, cfg)
