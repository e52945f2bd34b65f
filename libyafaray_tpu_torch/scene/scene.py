"""Scene — host-side scene graph + compile to flat arrays (port of
libyafaray_tpu/scene/scene.py, restricted to what the ported slices
render).

`compile()` stays numpy and yields the reference's `CompiledScene.arrays`
keys that the slice reads, with equal values; `convert.to_tensors` moves
them to a torch device once per render.  Textures and their mip atlases,
the orco pack, the background map and the IBL light's alias tables ride
in the same dict (TEXTURE_ARRAY_PREFIXES, BACKGROUND_ARRAY_KEYS), and so
do the meshlights' and portals' triangle CDFs with the triangle corners
they index, and the IES lights' profiles (LIGHT_ARRAY_PREFIXES,
TRI_POS_KEY).

Object visibility splits the meshes into two triangle sets: the camera-
visible set (`normal` and `no_shadows` meshes: tri_* arrays) and the
shadow-caster set (`normal` and `shadow_only`: stri_*, sfilt4,
shadow_filt); an `invisible` mesh is in neither.  When every mesh is
`normal` the shadow set's packs alias the visible set's.  Volume regions
ride in SceneStatic.volumes.
`<smooth>` sets a mesh's smoothing angle and `<instance>` bakes a
transformed copy of a mesh into `extra_tri_blocks`, which compile appends
after the meshes with no mesh id (a meshlight cannot name one).
Above MAX_TRIS = 2^20 triangles (either set) compile takes the BVH route:
it builds the threaded BVH of each set (accel/bvh.py, BVH_ARRAY_KEYS) and
skips the box tables only the clustered kernels read.  The create* calls
keep their ParamMaps for the XML writer (scene/xml_writer.py).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..accel.bvh import build_bvh
from ..backgrounds.base import BackgroundSpec
from ..backgrounds.factory import background_from_params, blur_env_map
from ..backgrounds.host import bake_background_np
from ..cameras.base import Camera
from ..cameras.factory import camera_from_params
from ..lights.base import LT_MESH, build_light_table
from ..lights.bglight import build_bg_cdf
from ..lights.factory import bg_light_row, light_from_params
from ..materials.base import (MT_BLEND, MT_LIGHT, MT_MASK,
                              build_material_table, default_row)
from ..materials.bsdf import check_families
from ..materials.factory import material_row_from_params
from ..materials.host import shadow_filter_np
from ..ops.bvh_traverse import leaf_lf4, log_filter4, pack_bvh
from ..ops.cluster_intersect import quarter_boxes
from ..ops.cuda_intersect import build_tri_pack, morton_order
from ..ops.fine_intersect import sub_aabbs
from ..ops.intersect import intersector_for, pad_triangles
from ..textures.eval import DEFAULT_MAPPING
from ..textures.factory import build_mip_atlas, texture_from_params
from ..volumes.factory import grid_arrays, volume_from_params
from .mesh import TriMesh, finalize_mesh, transform_baked
from .params import ParamMap

log = logging.getLogger("libyafaray_tpu_torch")

# the arrays of the reference's CompiledScene.arrays that the port reads
SLICE_ARRAY_KEYS = (
    "tris", "tri_shade_pack", "tri_geom_pack", "tri_pack10", "tri_cluster8",
    "stri_pack10", "stri_cluster8", "sfilt4", "sfilt4_binary", "shadow_filt",
    "shadow_filt_binary", "materials", "lights",
)
# the sub-cluster box tables the port adds to them (the reference derives
# its own inside every intersection call)
FINE_ARRAY_KEYS = ("tri_sub8", "stri_sub8")
# the 32-column box tables the mid-size kernels skip by (closest_hit_stream,
# shadow_logsum_dense)
QUARTER_ARRAY_KEYS = ("tri_box32", "stri_box32")
# what the BVH route (intersector "bvh") adds: the visible set's BVH over
# tri_geom_pack, the shadow set's over stri_geom_pack (aliases when the sets
# are one), each with its packed rows for the card (ops/bvh_traverse.py
# PACKED_KEYS), and the shadow set's lf4 rows for the transparent and the
# binary filters, in the shadow BVH's leaf order
BVH_ARRAY_KEYS = ("bvh", "sbvh", "stri_geom_pack", "sbvh_lf4",
                  "sbvh_lf4_binary")
# the analytic sphere pack [cx cy cz r mat] and its shadow filters, present
# only in scenes with <sphere> elements
SPHERE_ARRAY_KEYS = ("spheres", "sphere_filt", "sphere_filt_binary")
# per-texture arrays (image tex_{i}, mip atlas mip_{i}) and the orco pack
# of a scene whose textures read orco / object coordinates
TEXTURE_ARRAY_PREFIXES = ("tex_", "mip_")
ORCO_ARRAY_KEY = "tri_orco_pack"
# a texture background's map, its blurred copy (ibl_blur) and the IBL
# light's alias tables
BACKGROUND_ARRAY_KEYS = ("bg_image", "bg_image_ibl", "bg_alias_prob",
                         "bg_alias", "bg_pdf_grid")
# per light li: a meshlight's / portal's area CDF over its triangles
# (mlight_cdf_{li}), an IES light's candela grid (ies_{li}); tri_pos, the
# (T,3,3) corners of the visible triangles in concatenation order, which a
# CDF's [tri_start, tri_start + tri_count) slice indexes, is present with
# the CDFs
LIGHT_ARRAY_PREFIXES = ("mlight_cdf_", "ies_")
TRI_POS_KEY = "tri_pos"
_TEX_COLS = ("tex_diffuse", "tex_glossy", "tex_mirror", "tex_transparency",
             "tex_translucency", "tex_blend", "tex_mask", "tex_sigma_oren",
             "tex_ior", "node_prog")


@dataclass(frozen=True)
class LightStatic:
    ltype: int
    samples: int
    is_delta: bool
    intersectable: bool
    cast_shadows: bool
    photon_only: bool
    enabled: bool
    tri_start: int = -1
    tri_count: int = 0


@dataclass(frozen=True)
class SceneStatic:
    """The SceneStatic fields of the reference that the port reads."""

    n_tris_real: int
    n_stris_real: int
    lights: tuple  # tuple[LightStatic, ...]
    bg: BackgroundSpec
    mat_families: tuple
    has_blend: int
    ray_min_dist: float
    shadow_bias: float
    intersector: str  # "brute" | "bvh"
    chunk: int
    n_spheres: int = 0
    # the caller asked for the pair-granular intersection route (packs of
    # PAIRS_MIN_CLUSTERS clusters or more take it; ops/intersect.py)
    pairs: bool = False
    textures: tuple = ()  # texture specs (textures/factory.py HostTexture)
    texture_mappings: tuple = ()  # per texture (texco, mapping, scale, off)
    node_programs: tuple = ()  # compiled shader DAGs (textures/nodes.py)
    # some composite child carries a texture slot or node program: blend.py
    # re-resolves child textures at every nesting level
    blend_child_textured: bool = False
    need_orco: bool = False  # some texco is orco / object: tri_orco_pack
    need_window: bool = False  # some texco is window: raster projection
    max_additional_depth: int = 0  # the largest material additionalDepth
    has_sampling_factor: bool = False  # some material samplingFactor != 1
    volumes: tuple = ()  # volume regions (volumes/factory.py VolumeRegion)
    # some material has dispersion_power > 0: the path tracer carries a
    # wavelength lane (-1 chromatic) and hands it to sample_bsdf
    dispersion: bool = False


@dataclass
class CompiledScene:
    # numpy arrays, SLICE_ARRAY_KEYS + FINE_ARRAY_KEYS + QUARTER_ARRAY_KEYS
    # (on the BVH route BVH_ARRAY_KEYS in place of all but tri_shade_pack,
    # tri_geom_pack, shadow_filt*, materials and lights; + SPHERE_ARRAY_KEYS
    # in a scene with spheres)
    arrays: dict
    static: SceneStatic
    camera: Camera
    # scene bounds over triangles and spheres (photon radii default to a
    # share of the diagonal)
    bound_min: tuple
    bound_max: tuple


def _is_composite(row: dict) -> bool:
    return row["mtype"] in (MT_BLEND, MT_MASK)


def _blend_depth(materials: list) -> int:
    """Maximum blend / mask nesting depth of the material table (0 without
    composites).  A composite met twice on one chain counts once; capped at
    4 levels."""

    def depth(i, seen):
        if i < 0 or i >= len(materials) or i in seen or len(seen) >= 4:
            return 0
        r = materials[i]
        if not _is_composite(r):
            return 0
        s = seen | {i}
        return 1 + max(depth(int(r.get("sub_mat1", 0)), s),
                       depth(int(r.get("sub_mat2", 0)), s))

    return max((depth(i, frozenset()) for i in range(len(materials))),
               default=0)


def _blend_child_textured(materials: list) -> bool:
    """Whether any material reachable as a composite's child carries a
    texture slot or a node program."""
    stack = []
    for r in materials:
        if _is_composite(r):
            stack += [int(r.get("sub_mat1", -1)), int(r.get("sub_mat2", -1))]
    seen = set()
    while stack:
        i = stack.pop()
        if i < 0 or i >= len(materials) or i in seen:
            continue
        seen.add(i)
        r = materials[i]
        if any(int(r.get(c, -1)) >= 0 for c in _TEX_COLS):
            return True
        if _is_composite(r):
            stack += [int(r.get("sub_mat1", -1)), int(r.get("sub_mat2", -1))]
    return False


def bvh_arrays(geom9: np.ndarray, sgeom9: np.ndarray, sfilt: np.ndarray,
               sfilt_bin: np.ndarray) -> dict:
    """BVH_ARRAY_KEYS of a scene whose visible and shadow triangles are the
    (T, 9) v0 | e1 | e2 rows geom9 and sgeom9 (the same array when the sets
    are one: its BVH is then built and packed once and aliased), with the
    shadow set's per-triangle filters (Ts, 3) and binary filters (Ts, 1)
    (their lf4 rows in the shadow BVH's leaf order)."""
    def bvh(g):
        return pack_bvh(build_bvh(g[:, 0:3], g[:, 3:6], g[:, 6:9]), g)

    out = dict(bvh=bvh(geom9), stri_geom_pack=sgeom9)
    out["sbvh"] = out["bvh"] if sgeom9 is geom9 else bvh(sgeom9)
    for key, f in (("sbvh_lf4", sfilt), ("sbvh_lf4_binary", sfilt_bin)):
        out[key] = leaf_lf4(out["sbvh"], log_filter4(torch.from_numpy(
            np.ascontiguousarray(f, np.float32))).numpy())
    return out


def clustered_arrays(tris: tuple, stris: tuple | None, padded: tuple,
                     sfilt: np.ndarray) -> dict:
    """The clustered kernels' arrays (SLICE_ARRAY_KEYS' packs and filters,
    FINE_ARRAY_KEYS, QUARTER_ARRAY_KEYS) of the visible triangles `tris`
    (v0, e1, e2) and the shadow set `stris` (None when it is the visible
    set: its arrays alias), with the padded visible set `padded` and the
    shadow set's (T_s, 3) filters `sfilt`.

    The (10, T') v0|e1|e2|orig_id pack is in Morton order above 1024
    triangles (column = triangle id below), with its cluster boxes, the
    128-column sub-cluster boxes the large-scene kernels walk and the
    32-column boxes the mid-size ones skip by; the shadow set's pack and
    tables come from its own triangles."""
    n_real = tris[0].shape[0]
    t_order = morton_order(*tris) if n_real > 1024 else None
    pack, cl, t_ord = build_tri_pack(*tris, t_order)
    out = dict(tris=dict(zip(("v0", "e1", "e2"), (
                   np.asarray(x, np.float32) for x in padded))),
               tri_pack10=pack, tri_cluster8=cl,
               tri_sub8=sub_aabbs(pack, n_real),
               tri_box32=quarter_boxes(pack, n_real))
    if stris is None:
        ns_real, s_ord = n_real, t_ord
        out.update(stri_pack10=pack, stri_cluster8=cl,
                   stri_sub8=out["tri_sub8"], stri_box32=out["tri_box32"])
    else:
        ns_real = stris[0].shape[0]
        s_order = morton_order(*stris) if ns_real > 1024 else None
        spack, scl, s_ord = build_tri_pack(*stris, s_order)
        out.update(stri_pack10=spack, stri_cluster8=scl,
                   stri_sub8=sub_aabbs(spack, ns_real),
                   stri_box32=quarter_boxes(spack, ns_real))
    # shadow filters in pack order (padded entries alias tri 0 — they are
    # degenerate and never hit)
    sfilt_pk = sfilt[s_ord]
    sfilt_bin_pk = np.where(
        np.min(sfilt_pk, axis=-1, keepdims=True) >= 1.0 - 1e-6,
        1.0, 0.0).astype(np.float32)
    zero = np.zeros((1, sfilt_pk.shape[0]), np.float32)
    out.update(
        sfilt4=np.concatenate([sfilt_pk.T.astype(np.float32), zero]),
        sfilt4_binary=np.concatenate(
            [np.broadcast_to(sfilt_bin_pk, (sfilt_pk.shape[0], 3))
             .T.astype(np.float32), zero]))
    return out


class Scene:
    """Host scene under construction through the flat API."""

    def __init__(self):
        self.meshes: dict[int, TriMesh] = {}
        self.materials: list[dict] = [default_row()]  # row 0 = fallback null
        self.material_names: dict[str, int] = {"__default__": 0}
        self.lights: list[dict] = []
        self.light_names: list[str] = []
        self.light_geometry: list = []  # parallel: geometry or None
        self.analytic_spheres: list = []  # (center, radius, mat_id)
        self.cameras: dict[str, Camera] = {}
        self.textures: dict = {}  # name -> HostTexture, in creation order
        self.texture_mappers: dict[int, tuple] = {}
        self.node_programs: list = []
        # (spec, lat-long map of a texture background or None)
        self.background: tuple = (BackgroundSpec(), None)
        self.render_params = ParamMap()
        self.integrator_params: dict[str, ParamMap] = {}
        self.volumes: list = []
        self.extra_tri_blocks: list = []  # baked instances
        self._cur_mesh: TriMesh | None = None
        self._next_mesh_id = 0
        self.shadow_bias = 5e-4
        self.ray_min_dist = 5e-5
        self.aborted = False
        # the create* calls' ParamMaps, kept for the XML writer
        # (scene/xml_writer.py)
        self.material_params: dict[str, ParamMap] = {}
        self.light_params: list[ParamMap] = []
        self.camera_params: dict[str, ParamMap] = {}
        self.background_params: ParamMap | None = None
        self.volume_params: list[ParamMap] = []
        self.texture_params: dict[str, ParamMap] = {}

    # ---- geometry streaming (yafrayInterface parity) -------------------

    def start_tri_mesh(self, mesh_id: int, has_uv: bool,
                       visibility: str, has_orco: bool = False) -> int:
        self._next_mesh_id = max(self._next_mesh_id, mesh_id + 1)
        if visibility not in ("normal", "invisible", "shadow_only",
                              "no_shadows"):
            log.warning("startTriMesh: unknown visibility %r -> normal",
                        visibility)
            visibility = "normal"
        self._cur_mesh = TriMesh(mesh_id=mesh_id, has_uv=bool(has_uv),
                                 has_orco=bool(has_orco),
                                 visibility=visibility)
        self.meshes[mesh_id] = self._cur_mesh
        return mesh_id

    def add_vertex(self, x, y, z):
        self._cur_mesh.add_vertex(x, y, z)
        return len(self._cur_mesh.vertices) - 1

    def add_normal(self, x, y, z):
        self._cur_mesh.add_normal(x, y, z)

    def add_uv(self, u, v):
        return self._cur_mesh.add_uv(u, v)

    def add_triangle(self, a, b, c, mat_id: int, uv_a=-1, uv_b=-1, uv_c=-1):
        self._cur_mesh.add_triangle(a, b, c, mat_id, uv_a, uv_b, uv_c)

    def end_tri_mesh(self):
        self._cur_mesh = None

    def smooth_mesh(self, mesh_id: int, angle_deg: float):
        """Smooth a mesh's normals within angle_deg; an unknown id falls
        back to the mesh being built."""
        m = self.meshes.get(int(mesh_id)) or self._cur_mesh
        if m is not None:
            m.smooth(angle_deg)

    def add_instance(self, base_mesh_id: int, matrix16):
        """Add a copy of a mesh under a 4x4 transform (16 numbers, row
        major), baked at once: later edits of the base do not reach it."""
        base = self.meshes.get(int(base_mesh_id))
        if base is None:
            log.warning("addInstance: unknown base mesh %s", base_mesh_id)
            return
        arrays = finalize_mesh(base)
        if arrays is None:
            return
        self.extra_tri_blocks.append(transform_baked(
            arrays, np.asarray(matrix16, np.float64).reshape(4, 4)))

    def add_sphere(self, center, radius, mat_name: str):
        """Analytic sphere primitive (reference std_primitives.cc "sphere"),
        intersected exactly by the engine's quadric pass.  (The reference's
        analytic=False icosphere is not ported.)"""
        self.analytic_spheres.append(
            (tuple(float(x) for x in center), float(radius),
             self.material_names.get(mat_name, 0)))

    # ---- factories (renderEnvironment_t::create*) ----------------------

    def create_material(self, name: str, params: ParamMap) -> int:
        self.material_params[name] = ParamMap(params)
        row = material_row_from_params(
            params, self.material_names,
            {n: i for i, n in enumerate(self.textures)},
            self.texture_mappers, node_programs=self.node_programs)
        if name in self.material_names:
            self.materials[self.material_names[name]] = row
            return self.material_names[name]
        self.materials.append(row)
        self.material_names[name] = len(self.materials) - 1
        return self.material_names[name]

    def create_light(self, name: str, params: ParamMap) -> int:
        self.light_params.append(ParamMap(params))
        row, geometry = light_from_params(params)
        self.lights.append(row)
        self.light_names.append(name)
        self.light_geometry.append(geometry)
        return len(self.lights) - 1

    def create_camera(self, name: str, params: ParamMap) -> Camera:
        self.camera_params[name] = ParamMap(params)
        cam = camera_from_params(params)
        self.cameras[name] = cam
        return cam

    def create_texture(self, name: str, params: ParamMap):
        self.texture_params[name] = ParamMap(params)
        self.textures[name] = texture_from_params(params)
        return self.textures[name]

    def create_background(self, name: str, params: ParamMap):
        self.background_params = ParamMap(params)
        self.background = background_from_params(params, self.textures)
        return self.background

    def create_volume_region(self, name: str, params: ParamMap):
        self.volume_params.append(ParamMap(params))
        self.volumes.append(volume_from_params(params))
        return self.volumes[-1]

    def create_integrator(self, name: str, params: ParamMap):
        self.integrator_params[name] = ParamMap(params)

    def set_render_params(self, params: ParamMap):
        self.render_params = ParamMap(params)
        self.shadow_bias = params.get_float("shadow_bias", 5e-4)
        self.ray_min_dist = params.get_float("ray_min_dist", 5e-5)

    def abort(self):
        """Flag the scene aborted (the flat API's abort; as in the
        reference, no render reads the flag)."""
        self.aborted = True

    # ---- compile (scene_t::update analog) ------------------------------

    def compile(self, device: str = "cuda", *,
                pairs: bool = False) -> CompiledScene:
        """Lower the scene to numpy arrays + statics.  `device` is the torch
        device the render will run on (default the card, as the entry
        points); it only picks the intersector, so it needs no card.
        pairs=True asks for the pair-granular intersection route, which
        packs of 64 or more clusters (above ~8,000 triangles) then take."""
        blocks, block_mesh_ids = [], []
        for mesh_id, m in self.meshes.items():
            b = finalize_mesh(m)
            if b is not None:
                blocks.append(b)
                block_mesh_ids.append(mesh_id)
        for b in self.extra_tri_blocks:
            blocks.append(dict(b))
            block_mesh_ids.append(None)
        materials = list(self.materials)
        # area-light panels -> synthetic light_mat + triangles
        for li, geom in enumerate(self.light_geometry):
            if geom is None:
                continue
            lm = default_row()
            lm["mtype"] = MT_LIGHT
            lm["emit_color"] = geom["radiance"]
            lm["diffuse_reflect"] = 0.0
            materials.append(lm)
            pos = geom["pos"]
            tcount = pos.shape[0]
            gn = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
            gn /= np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-20)
            blocks.append(dict(
                pos=pos.astype(np.float32),
                normal=np.repeat(gn[:, None, :], 3, axis=1).astype(np.float32),
                geo_n=gn.astype(np.float32),
                uv=np.zeros((tcount, 3, 2), np.float32),
                mat=np.full(tcount, len(materials) - 1, np.int32),
                light_id=np.full(tcount, li, np.int32),
            ))
            block_mesh_ids.append(None)
        if not blocks:
            # no triangles (a scene of analytic spheres): one degenerate
            # triangle far away, which no ray hits
            blocks.append(dict(
                pos=np.full((1, 3, 3), 1e30, np.float32),
                normal=np.zeros((1, 3, 3), np.float32),
                geo_n=np.zeros((1, 3), np.float32),
                uv=np.zeros((1, 3, 2), np.float32),
                mat=np.zeros(1, np.int32),
                light_id=np.full(1, -1, np.int32)))
            block_mesh_ids.append(None)
        vis_pairs = [(mid, b) for mid, b in zip(block_mesh_ids, blocks)
                     if b.get("visibility", "normal") in ("normal",
                                                          "no_shadows")]
        shadow_blocks = [b for b in blocks
                         if b.get("visibility", "normal") in ("normal",
                                                              "shadow_only")]
        if not vis_pairs:
            vis_pairs = [(block_mesh_ids[0], blocks[0])]
        if not shadow_blocks:
            shadow_blocks = blocks[:1]
        vis_blocks = [b for _, b in vis_pairs]
        # blocks without object coordinates (light panels) take local = pos
        # and orco = local normalised over the block's bounding box
        for b in blocks:
            if "local" not in b:
                b["local"] = b["pos"]
            if "orco" not in b:
                lp = b["local"].reshape(-1, 3)
                ctr = 0.5 * (lp.min(axis=0) + lp.max(axis=0))
                ext = np.maximum(0.5 * (lp.max(axis=0) - lp.min(axis=0)),
                                 1e-12)
                b["orco"] = ((b["local"] - ctr) / ext).astype(np.float32)
        families = tuple(sorted({r["mtype"] for r in materials}))
        check_families(families)

        def cat(key, bs=vis_blocks):
            return np.concatenate([b[key] for b in bs], axis=0)

        pos = cat("pos")  # (T,3,3)
        normal = cat("normal")
        geo_n = cat("geo_n")
        uv = cat("uv")
        mat = cat("mat")
        light_id = cat("light_id")
        n_real = pos.shape[0]

        # meshlights and portals (reference src/lights/meshlight.cc): the
        # object's triangle range in the concatenation, an area-weighted
        # CDF over it, radiance L = Φ/(π·A_total); a meshlight's triangles
        # carry its light id, so BSDF hits add its radiance (hit_radiance)
        # over the object's own material.  A missing object disables the
        # light.
        lights = [dict(r) for r in self.lights]
        mesh_ranges, cursor = {}, 0
        for mid, b in vis_pairs:
            if mid is not None:
                mesh_ranges[mid] = (cursor, b["pos"].shape[0])
            cursor += b["pos"].shape[0]
        light_arrays = {}
        for li, row in enumerate(lights):
            if "_object" not in row:
                continue
            try:
                obj_key = int(row["_object"])
            except (TypeError, ValueError):
                obj_key = None
            if obj_key not in mesh_ranges:
                log.warning("meshlight %s: object %r not found; disabled",
                            self.light_names[li], row["_object"])
                row["enabled"] = False
                continue
            start, cnt = mesh_ranges[obj_key]
            tri = pos[start:start + cnt]
            areas = 0.5 * np.linalg.norm(
                np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]),
                axis=1)
            total_area = float(max(areas.sum(), 1e-12))
            cdf = np.concatenate([[0.0], np.cumsum(areas / areas.sum())])
            cdf[-1] = 1.0
            light_arrays[f"mlight_cdf_{li}"] = cdf.astype(np.float32)
            row["area"] = total_area
            row["radiance"] = tuple(np.asarray(row["_color"]) * row["_power"]
                                    / (np.pi * total_area))
            row["tri_start"] = start
            row["tri_count"] = cnt
            if row["ltype"] == LT_MESH:  # portals do not emit at hits
                light_id[start:start + cnt] = li
        if light_arrays:
            light_arrays[TRI_POS_KEY] = pos.astype(np.float32)
        for li, r in enumerate(lights):
            if "_ies_profile" in r:
                light_arrays[f"ies_{li}"] = np.asarray(r["_ies_profile"],
                                                       np.float32)

        v0 = pos[:, 0]
        e1 = pos[:, 1] - pos[:, 0]
        e2 = pos[:, 2] - pos[:, 0]
        chunk = int(min(512, max(8, -(-n_real // 8) * 8)))
        v0p, e1p, e2p, _ = pad_triangles(v0, e1, e2, chunk)
        # the shadow set is the visible set when every mesh is "normal":
        # its packs alias the visible set's
        same_shadow = (len(shadow_blocks) == len(vis_blocks) and all(
            a is b for a, b in zip(shadow_blocks, vis_blocks)))
        if same_shadow:
            sv0, se1, se2, smat, sv0p = v0, e1, e2, mat, v0p
        else:
            spos = cat("pos", shadow_blocks)
            sv0 = spos[:, 0]
            se1 = spos[:, 1] - spos[:, 0]
            se2 = spos[:, 2] - spos[:, 0]
            smat = cat("mat", shadow_blocks)
            sv0p, _, _, _ = pad_triangles(sv0, se1, se2, chunk)
        ns_pad = sv0p.shape[0]
        ns_real = sv0.shape[0]
        intersector = intersector_for(device, max(n_real, ns_real))

        mats = build_material_table(materials)
        filt_m = shadow_filter_np(mats)  # (M,3)
        sfilt = filt_m[smat]
        sfilt = np.concatenate(
            [sfilt, np.zeros((ns_pad - sfilt.shape[0], 3), np.float32)])
        # binary variant for transpShad=false renders: only true
        # pass-through (null) materials don't block
        sfilt_bin = np.where(
            np.min(sfilt, axis=-1, keepdims=True) >= 1.0 - 1e-6, 1.0, 0.0
        ).astype(np.float32)

        # an `ibl` background adds the IBL light; a constant background is
        # baked to a small lat-long map so both sample one way
        bg_spec, bg_img = self.background
        all_lights = list(lights)
        if bg_spec.ibl:
            if bg_img is None:
                bg_img = bake_background_np(bg_spec, 32, 64)
            all_lights.append(bg_light_row(bg_spec.ibl_samples))
        lights_table = build_light_table(
            [{k: v for k, v in r.items() if not k.startswith("_")}
             for r in all_lights])
        # emission radiance for BSDF hits on meshlights (area and sphere
        # lights emit through their synthetic light_mat instead)
        hit_rad = np.zeros((len(all_lights), 3), np.float32)
        for li, r in enumerate(all_lights):
            if "_object" in r and r["enabled"] and r["ltype"] == LT_MESH:
                hit_rad[li] = np.asarray(r["radiance"], np.float32)
        lights_table["hit_radiance"] = hit_rad
        # per-light emission-hit attributes, one gather in the engine:
        # [area, double_sided, hit_radiance rgb, ltype, center xyz, radius]
        lights_table["hit_pack"] = np.concatenate([
            lights_table["area"][:, None].astype(np.float32),
            lights_table["double_sided"][:, None].astype(np.float32),
            hit_rad,
            lights_table["ltype"][:, None].astype(np.float32),
            lights_table["p0"].astype(np.float32),
            lights_table["radius"][:, None].astype(np.float32),
        ], axis=1) if all_lights else np.zeros((0, 10), np.float32)
        light_statics = tuple(
            LightStatic(
                ltype=int(r["ltype"]), samples=int(r["samples"]),
                is_delta=bool(r["is_delta"]),
                intersectable=bool(r["intersectable"]),
                cast_shadows=bool(r["cast_shadows"]),
                photon_only=bool(r["photon_only"]),
                enabled=bool(r["enabled"]),
                tri_start=int(r["tri_start"]),
                tri_count=int(r["tri_count"]),
            )
            for r in all_lights
        )

        # per-triangle uv density sqrt(uv_area / world_area)
        uv_e1 = uv[:, 1] - uv[:, 0]
        uv_e2 = uv[:, 2] - uv[:, 0]
        uv_area = 0.5 * np.abs(uv_e1[:, 0] * uv_e2[:, 1]
                               - uv_e1[:, 1] * uv_e2[:, 0])
        w_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
        uv_density = np.sqrt(uv_area / np.maximum(w_area, 1e-12))
        # surface derivatives dPdU/dPdV; degenerate UVs fall back to an
        # ONB of the geometric normal (branchless Duff construction)
        du1, dv1 = uv_e1[:, 0], uv_e1[:, 1]
        du2, dv2 = uv_e2[:, 0], uv_e2[:, 1]
        uv_det = du1 * dv2 - dv1 * du2
        ok_uv = np.abs(uv_det) > 1e-12
        inv_det = 1.0 / np.where(ok_uv, uv_det, 1.0)
        dpdu = (dv2[:, None] * e1 - dv1[:, None] * e2) * inv_det[:, None]
        dpdv = (-du2[:, None] * e1 + du1[:, None] * e2) * inv_det[:, None]
        gs = np.where(geo_n[:, 2] >= 0.0, 1.0, -1.0)
        ga = -1.0 / (gs + geo_n[:, 2])
        gb = geo_n[:, 0] * geo_n[:, 1] * ga
        onb_u = np.stack([1.0 + gs * geo_n[:, 0] ** 2 * ga, gs * gb,
                          -gs * geo_n[:, 0]], axis=1)
        onb_v = np.stack([gb, gs + geo_n[:, 1] ** 2 * ga,
                          -geo_n[:, 1]], axis=1)
        dpdu = np.where(ok_uv[:, None], dpdu, onb_u).astype(np.float32)
        dpdv = np.where(ok_uv[:, None], dpdv, onb_v).astype(np.float32)

        # packed per-triangle shading attributes, one gather per hit:
        # pos 0:9, normal 9:18, uv 18:24, geo_n 24:27, mat 27, light_id 28,
        # uv_density 29, dPdU 30:33, dPdV 33:36
        tri_shade_pack = np.concatenate([
            np.asarray(pos.reshape(n_real, 9), np.float32),
            np.asarray(normal.reshape(n_real, 9), np.float32),
            np.asarray(uv.reshape(n_real, 6), np.float32),
            np.asarray(geo_n, np.float32),
            mat[:, None].astype(np.float32),
            light_id[:, None].astype(np.float32),
            uv_density[:, None].astype(np.float32),
            dpdu, dpdv,
        ], axis=1)
        tri_geom_pack = np.concatenate(
            [np.asarray(v0, np.float32), np.asarray(e1, np.float32),
             np.asarray(e2, np.float32)], axis=1)
        if intersector == "bvh":
            # the BVH walks read the geometry packs, the BVHs and their lf4
            # rows only: the clustered kernels' packs, box tables and
            # filters below are not built
            route_arrays = bvh_arrays(
                tri_geom_pack, tri_geom_pack if same_shadow else
                np.concatenate([sv0, se1, se2], axis=1).astype(np.float32),
                sfilt[:ns_real], sfilt_bin[:ns_real])
        else:
            route_arrays = clustered_arrays(
                (v0, e1, e2), None if same_shadow else (sv0, se1, se2),
                (v0p, e1p, e2p), filt_m[smat])

        arrays = dict(
            tri_shade_pack=tri_shade_pack,
            tri_geom_pack=tri_geom_pack,
            **route_arrays,
            shadow_filt=sfilt.astype(np.float32),
            shadow_filt_binary=sfilt_bin,
            materials=mats,
            lights=lights_table,
            **light_arrays,
        )
        # the texture coordinate spaces the shading needs: orco / object
        # read the per-corner orco pack, window the raster projection.  (As
        # in the reference, only the textures' registered mappers count,
        # not the mappers inside node programs: ROADMAP Queue 3.)
        texcos = {self.texture_mappers.get(i, ("uv",))[0]
                  for i in range(len(self.textures))}
        need_orco = bool(texcos & {"orco", "object"})
        need_window = "window" in texcos
        if need_orco:
            # (T, 18): orco corners 0:9, local corners 9:18
            arrays[ORCO_ARRAY_KEY] = np.concatenate([
                cat("orco").reshape(n_real, 9).astype(np.float32),
                cat("local").reshape(n_real, 9).astype(np.float32)], axis=1)
        for ti, tex in enumerate(self.textures.values()):
            if tex.tex_type != "image":
                continue  # procedurals evaluate from their spec
            arrays[f"tex_{ti}"] = np.ascontiguousarray(tex.image[..., :3],
                                                       np.float32)
            if tex.interpolate.startswith("mipmap"):
                arrays[f"mip_{ti}"] = build_mip_atlas(tex.image[..., :3])
        if bg_img is not None:
            arrays["bg_image"] = np.asarray(bg_img, np.float32)
            if bg_spec.ibl_blur > 0.0:
                # the IBL light reads a blurred copy; the visible
                # background stays sharp
                arrays["bg_image_ibl"] = blur_env_map(bg_img,
                                                      bg_spec.ibl_blur)
            if bg_spec.ibl:
                arrays.update(build_bg_cdf(arrays.get("bg_image_ibl",
                                                      bg_img)))

        arrays.update(grid_arrays(self.volumes))
        if self.analytic_spheres:
            sp_rows = np.asarray([[c[0], c[1], c[2], r, float(m)]
                                  for (c, r, m) in self.analytic_spheres],
                                 np.float32)
            arrays["spheres"] = sp_rows
            arrays["sphere_filt"] = filt_m[sp_rows[:, 4].astype(np.int32)]
            arrays["sphere_filt_binary"] = np.where(
                np.min(arrays["sphere_filt"], axis=-1, keepdims=True)
                >= 1.0 - 1e-6, 1.0, 0.0).astype(np.float32) \
                * np.ones((1, 3), np.float32)

        finite = pos[np.all(np.isfinite(pos), axis=(1, 2))]
        bmin = finite.min(axis=(0, 1)) if finite.size else np.zeros(3)
        bmax = finite.max(axis=(0, 1)) if finite.size else np.ones(3)
        if self.analytic_spheres:
            sc = np.asarray([c for (c, r, m) in self.analytic_spheres])
            sr = np.asarray([[r] for (c, r, m) in self.analytic_spheres])
            bmin = np.minimum(bmin, (sc - sr).min(axis=0))
            bmax = np.maximum(bmax, (sc + sr).max(axis=0))

        static = SceneStatic(
            n_tris_real=n_real, n_stris_real=ns_real,
            lights=light_statics, bg=bg_spec,
            mat_families=families, has_blend=_blend_depth(materials),
            ray_min_dist=self.ray_min_dist, shadow_bias=self.shadow_bias,
            intersector=intersector, chunk=chunk,
            n_spheres=len(self.analytic_spheres), pairs=bool(pairs),
            textures=tuple(t.spec for t in self.textures.values()),
            texture_mappings=tuple(
                self.texture_mappers.get(i, DEFAULT_MAPPING)
                for i in range(len(self.textures))),
            node_programs=tuple(self.node_programs),
            blend_child_textured=_blend_child_textured(materials),
            need_orco=need_orco, need_window=need_window,
            max_additional_depth=int(max(
                (r.get("additional_depth", 0.0) for r in materials),
                default=0)),
            has_sampling_factor=any(
                abs(r.get("sampling_factor", 1.0) - 1.0) > 1e-9
                for r in materials),
            volumes=tuple(self.volumes),
            dispersion=any(r.get("dispersion_power", 0.0) > 1e-6
                           for r in materials),
        )
        cam = next(iter(self.cameras.values())) if self.cameras else Camera()
        cam_name = self.render_params.get_str("camera_name", "")
        if cam_name and cam_name in self.cameras:
            cam = self.cameras[cam_name]
        # <render> width/height override the camera resolution
        rw = self.render_params.get_int("width", cam.resx)
        rh = self.render_params.get_int("height", cam.resy)
        if rw != cam.resx or rh != cam.resy:
            cam = replace(cam, resx=rw, resy=rh)
        return CompiledScene(arrays=arrays, static=static, camera=cam,
                             bound_min=tuple(float(x) for x in bmin),
                             bound_max=tuple(float(x) for x in bmax))
