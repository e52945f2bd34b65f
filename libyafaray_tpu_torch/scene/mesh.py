"""Host-side triangle meshes (port of libyafaray_tpu/scene/mesh.py: TriMesh,
`finalize_mesh` for meshes with optional per-vertex normals, angle-
thresholded smoothing (`<smooth>`), UVs and orco coordinates,
`transform_baked` for `<instance>` copies, and `make_sphere_mesh`, the
icosphere that scene/generate.py tessellates).  Scene.compile flattens
them into SoA triangle arrays."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class TriMesh:
    """An indexed triangle mesh under construction via the flat API."""

    mesh_id: int
    has_uv: bool = False
    has_orco: bool = False
    vertices: list = field(default_factory=list)  # (x,y,z)
    orcos: list = field(default_factory=list)  # explicit orco coords
    normals: list = field(default_factory=list)  # explicit addNormal calls
    faces: list = field(default_factory=list)  # (a,b,c, mat_id)
    face_uvs: list = field(default_factory=list)  # (uva, uvb, uvc) uv indices
    uvs: list = field(default_factory=list)  # (u,v)
    smooth_angle: float | None = None  # degrees; None = faceted
    light_id: int = -1  # meshlight association
    visibility: str = "normal"  # normal|invisible|shadow_only|no_shadows

    def add_vertex(self, x, y, z, ox=None, oy=None, oz=None):
        """Append a vertex, with its orco coordinates when given."""
        self.vertices.append((float(x), float(y), float(z)))
        if ox is not None:
            self.orcos.append((float(ox), float(oy), float(oz)))

    def add_normal(self, x, y, z):
        self.normals.append((float(x), float(y), float(z)))

    def add_uv(self, u, v):
        self.uvs.append((float(u), float(v)))
        return len(self.uvs) - 1

    def add_triangle(self, a, b, c, mat_id, uv_a=-1, uv_b=-1, uv_c=-1):
        self.faces.append((int(a), int(b), int(c), int(mat_id)))
        self.face_uvs.append((int(uv_a), int(uv_b), int(uv_c)))

    def smooth(self, angle_deg: float):
        self.smooth_angle = float(angle_deg)


def compute_vertex_normals(verts: np.ndarray, faces: np.ndarray,
                           smooth_angle_deg: float) -> np.ndarray:
    """Angle-thresholded smoothed per-corner normals, (T,3,3).

    A vertex's normal is the area-weighted sum of its faces' normals; a
    corner takes it only where it lies within the smoothing angle of the
    corner's own face normal, else the face normal (angle >= 180 smooths
    every corner)."""
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted face normal
    fn_len = np.linalg.norm(fn, axis=1, keepdims=True)
    fn_unit = fn / np.maximum(fn_len, 1e-20)
    vnorm = np.zeros((len(verts), 3), np.float64)
    for k in range(3):
        np.add.at(vnorm, faces[:, k], fn)
    vn_unit = vnorm / np.maximum(np.linalg.norm(vnorm, axis=1, keepdims=True),
                                 1e-20)
    cos_thresh = np.cos(np.deg2rad(min(smooth_angle_deg, 180.0)))
    corner = np.empty((len(faces), 3, 3), np.float32)
    for k in range(3):
        cand = vn_unit[faces[:, k]]
        agree = np.sum(cand * fn_unit, axis=1) >= cos_thresh - 1e-6
        corner[:, k, :] = np.where(agree[:, None], cand,
                                   fn_unit).astype(np.float32)
    return corner


def finalize_mesh(mesh: TriMesh):
    """-> dict of numpy arrays: pos (T,3,3) corners, normal (T,3,3),
    geo_n (T,3), uv (T,3,2), mat (T,), light_id (T,), local (T,3,3) and
    orco (T,3,3); None if empty.  orco is the streamed orco where every
    vertex has one, else the local corners normalised to [-1, 1] over the
    mesh's bounding box."""
    verts = np.asarray(mesh.vertices, np.float64).reshape(-1, 3)
    if len(mesh.faces) == 0:
        return None
    faces = np.asarray([f[:3] for f in mesh.faces], np.int64)
    mats = np.asarray([f[3] for f in mesh.faces], np.int32)

    p0, p1, p2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    # drop degenerate faces (reference's degenerate-face handling)
    gn = np.cross(p1 - p0, p2 - p0)
    area2 = np.linalg.norm(gn, axis=1)
    ok = area2 > 1e-18
    faces, mats, p0, p1, p2, gn, area2 = (
        faces[ok], mats[ok], p0[ok], p1[ok], p2[ok], gn[ok], area2[ok]
    )
    gn_unit = gn / np.maximum(area2[:, None], 1e-20)

    if len(mesh.normals) == len(verts) and len(mesh.normals) > 0:
        vn = np.asarray(mesh.normals, np.float64)
        vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-20)
        corner_n = np.stack(
            [vn[faces[:, 0]], vn[faces[:, 1]], vn[faces[:, 2]]], axis=1
        ).astype(np.float32)
    elif mesh.smooth_angle is not None:  # explicit normals win over it
        corner_n = compute_vertex_normals(verts, faces, mesh.smooth_angle)
    else:
        corner_n = np.repeat(gn_unit[:, None, :], 3, axis=1).astype(
            np.float32)

    if mesh.has_uv and len(mesh.uvs) > 0:
        uvs = np.asarray(mesh.uvs, np.float32).reshape(-1, 2)
        fuv = np.asarray(mesh.face_uvs, np.int64)[ok]
        fuv = np.clip(fuv, 0, len(uvs) - 1)
        corner_uv = np.stack(
            [uvs[fuv[:, 0]], uvs[fuv[:, 1]], uvs[fuv[:, 2]]], axis=1
        )
    else:
        corner_uv = np.zeros((len(faces), 3, 2), np.float32)

    local = np.stack([p0, p1, p2], axis=1)
    if mesh.has_orco and len(mesh.orcos) == len(verts):
        ov = np.asarray(mesh.orcos, np.float64)
        orco = np.stack([ov[faces[:, 0]], ov[faces[:, 1]],
                         ov[faces[:, 2]]], axis=1)
    else:
        bmin = verts.min(axis=0)
        bmax = verts.max(axis=0)
        ctr = 0.5 * (bmin + bmax)
        ext = np.maximum(0.5 * (bmax - bmin), 1e-12)
        orco = (local - ctr) / ext

    return dict(
        pos=local.astype(np.float32).copy(),
        normal=corner_n.astype(np.float32),
        geo_n=gn_unit.astype(np.float32),
        uv=corner_uv.astype(np.float32),
        mat=mats,
        light_id=np.full(len(faces), mesh.light_id, np.int32),
        visibility=mesh.visibility,
        local=local.astype(np.float32),
        orco=orco.astype(np.float32),
    )


def transform_baked(tri_arrays: dict, matrix: np.ndarray) -> dict:
    """An instance of finalized triangle arrays under a 4x4 transform (the
    triangles re-added, transformed).  Normals go through the inverse
    transpose; a mirroring transform (det < 0) flips both normals.  local
    and orco stay the base mesh's."""
    m = np.asarray(matrix, np.float64).reshape(4, 4)
    r = m[:3, :3]
    t = m[:3, 3]
    pos = tri_arrays["pos"] @ r.T + t
    rit = np.linalg.inv(r).T
    nrm = tri_arrays["normal"] @ rit.T
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    gn = tri_arrays["geo_n"] @ rit.T
    gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    if np.linalg.det(r) < 0:
        gn = -gn
        nrm = -nrm
    out = dict(tri_arrays)
    out["pos"] = pos.astype(np.float32)
    out["normal"] = nrm.astype(np.float32)
    out["geo_n"] = gn.astype(np.float32)
    return out


def make_sphere_mesh(center, radius, mat_id, subdiv: int = 3) -> dict:
    """Sphere primitive (reference std_primitives.cc) — realized as a
    subdivided icosphere so the single intersector handles it.  subdiv=3
    gives 1280 faces; adequate for the std_primitives use cases."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdiv):
        edge_mid: dict = {}
        verts_list = list(verts)
        new_faces = []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts_list[a] + verts_list[b]
                m = m / np.linalg.norm(m)
                verts_list.append(m)
                edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)

    center = np.asarray(center, np.float64)
    pos = verts[faces] * radius + center  # (T,3,3)
    nrm = verts[faces]  # unit sphere normals
    gn = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    gn /= np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-20)
    # spherical uv
    u = 0.5 + np.arctan2(nrm[..., 1], nrm[..., 0]) / (2 * np.pi)
    v = 0.5 - np.arcsin(np.clip(nrm[..., 2], -1, 1)) / np.pi
    uv = np.stack([u, v], axis=-1)
    T = len(faces)
    return dict(
        pos=pos.astype(np.float32),
        normal=nrm.astype(np.float32),
        geo_n=gn.astype(np.float32),
        uv=uv.astype(np.float32),
        # local = sphere-centered coords; orco = unit-sphere coords
        local=(verts[faces] * radius).astype(np.float32),
        orco=nrm.astype(np.float32),
        mat=np.full(T, mat_id, np.int32),
        light_id=np.full(T, -1, np.int32),
        visibility="normal",
    )
