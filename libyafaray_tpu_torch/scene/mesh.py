"""Host-side triangle meshes (port of libyafaray_tpu/scene/mesh.py: TriMesh and
`finalize_mesh` for faceted meshes with optional per-vertex normals and
UVs).  Scene.compile flattens them into SoA triangle arrays."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class TriMesh:
    """An indexed triangle mesh under construction via the flat API."""

    mesh_id: int
    has_uv: bool = False
    vertices: list = field(default_factory=list)  # (x,y,z)
    normals: list = field(default_factory=list)  # explicit addNormal calls
    faces: list = field(default_factory=list)  # (a,b,c, mat_id)
    face_uvs: list = field(default_factory=list)  # (uva, uvb, uvc) uv indices
    uvs: list = field(default_factory=list)  # (u,v)
    light_id: int = -1  # meshlight association
    visibility: str = "normal"  # normal|invisible|shadow_only|no_shadows

    def add_vertex(self, x, y, z):
        self.vertices.append((float(x), float(y), float(z)))

    def add_normal(self, x, y, z):
        self.normals.append((float(x), float(y), float(z)))

    def add_uv(self, u, v):
        self.uvs.append((float(u), float(v)))
        return len(self.uvs) - 1

    def add_triangle(self, a, b, c, mat_id, uv_a=-1, uv_b=-1, uv_c=-1):
        self.faces.append((int(a), int(b), int(c), int(mat_id)))
        self.face_uvs.append((int(uv_a), int(uv_b), int(uv_c)))


def finalize_mesh(mesh: TriMesh):
    """-> dict of numpy arrays: pos (T,3,3) corners, normal (T,3,3),
    geo_n (T,3), uv (T,3,2), mat (T,), light_id (T,); None if empty."""
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

    return dict(
        pos=np.stack([p0, p1, p2], axis=1).astype(np.float32),
        normal=corner_n.astype(np.float32),
        geo_n=gn_unit.astype(np.float32),
        uv=corner_uv.astype(np.float32),
        mat=mats,
        light_id=np.full(len(faces), mesh.light_id, np.int32),
        visibility=mesh.visibility,
    )
