"""Generated grid-spheres scenes: a Cornell-style room with two layers of
G x G tessellated icospheres (white and mirror shinydiffuse, glossy
exponent 120), one area light with 8 samples, pathtracing with 3 bounces
and a gauss filter.

Port of scripts/make_large_scene.py: for the same arguments it writes the
same XML, byte for byte.  The triangle count is 20·4^subdiv per sphere
(80 at subdiv 1) times 2·G², plus 10 room and 2 light triangles; so
--grid 1 --subdiv 1 gives 172 triangles (the dense kernels), --grid 2
--subdiv 1 652 (the streaming kernels), --grid 2 --subdiv 2 2,572 and
--grid 4 --subdiv 4 163,852 (the gathered-fine kernels).

    python -m libyafaray_tpu_torch.scene.generate --grid 1 --subdiv 1 \\
        --out scene.xml

Also the intersection benchmarks' random triangle soup and ray batches
(`make_soup`, `make_rays`: the same arrays as scripts/bench_intersect.py
for the same arguments).
"""
from __future__ import annotations

import argparse
import io
import os

import numpy as np

from .mesh import make_sphere_mesh


def icosphere(subdiv: int):
    """(vertices (V, 3), faces (F, 3)) of the unit icosphere, its corners
    welded at 7 decimals."""
    soup = np.asarray(
        make_sphere_mesh(np.zeros(3), 1.0, 0, subdiv=subdiv)["pos"],
        np.float64)  # (F, 3, 3)
    flat = soup.reshape(-1, 3)
    verts, inv = np.unique(flat.round(decimals=7), axis=0,
                           return_inverse=True)
    return verts, inv.reshape(-1, 3)


def grid_spheres_xml(grid: int = 8, subdiv: int = 3, spp: int = 16,
                     size: int = 512) -> str:
    """The scene's XML text."""
    verts, faces = icosphere(subdiv)
    g = grid
    n_sph = g * g * 2
    total = n_sph * faces.shape[0] + 10
    room = 5.5

    buf = io.StringIO()
    w = buf.write
    w('<?xml version="1.0"?>\n')
    w(f"<!-- generated by scripts/make_large_scene.py: {n_sph} icospheres"
      f" x {faces.shape[0]} tris = {total} tris -->\n")
    w('<scene type="triangle">\n')
    w('<material name="white"><type sval="shinydiffusemat"/>'
      '<color r="0.73" g="0.71" b="0.68"/></material>\n')
    w('<material name="glossy"><type sval="glossy"/>'
      '<color r="0.2" g="0.25" b="0.7"/>'
      '<diffuse_color r="0.1" g="0.12" b="0.3"/>'
      '<exponent fval="120.0"/><glossy_reflect fval="0.7"/></material>\n')
    w('<material name="mirror"><type sval="shinydiffusemat"/>'
      '<color r="0.1" g="0.1" b="0.1"/><mirror_color r="0.9" g="0.9" '
      'b="0.9"/><specular_reflect fval="0.85"/></material>\n')
    w('<light name="lamp"><type sval="arealight"/>'
      f'<corner x="{room*0.62:.3f}" y="{room*0.41:.3f}" z="{room-0.02:.3f}"/>'
      f'<point1 x="{room*0.38:.3f}" y="{room*0.41:.3f}" z="{room-0.02:.3f}"/>'
      f'<point2 x="{room*0.62:.3f}" y="{room*0.60:.3f}" z="{room-0.02:.3f}"/>'
      '<color r="1.0" g="0.92" b="0.8"/><power fval="150.0"/>'
      '<samples ival="8"/></light>\n')
    w('<camera name="cam"><type sval="perspective"/>'
      f'<from x="{room/2:.3f}" y="-7.5" z="{room*0.55:.3f}"/>'
      f'<to x="{room/2:.3f}" y="0.0" z="{room*0.45:.3f}"/>'
      f'<up x="{room/2:.3f}" y="-7.5" z="{room*0.55+1:.3f}"/>'
      f'<resx ival="{size}"/><resy ival="{size}"/>'
      '<focal fval="1.4"/></camera>\n')
    w('<background name="bg"><type sval="constant"/>'
      '<color r="0.0" g="0.0" b="0.0"/></background>\n')

    # room: floor, ceiling, back, left and right walls as two-tri quads
    quads = [
        [(room, 0, 0), (0, 0, 0), (0, room, 0), (room, room, 0)],
        [(room, 0, room), (room, room, room), (0, room, room), (0, 0, room)],
        [(room, room, 0), (0, room, 0), (0, room, room), (room, room, room)],
        [(0, room, 0), (0, 0, 0), (0, 0, room), (0, room, room)],
        [(room, 0, 0), (room, room, 0), (room, room, room), (room, 0, room)],
    ]
    nv = sum(len(q) for q in quads)
    w(f'<mesh id="1" vertices="{nv}" faces="{len(quads)*2}" '
      'has_uv="false" type="0">\n')
    for q in quads:
        for (x, y, z) in q:
            w(f'<p x="{x}" y="{y}" z="{z}"/>\n')
    w('<set_material sval="white"/>\n')
    off = 0
    for q in quads:
        w(f'<f a="{off}" b="{off+1}" c="{off+2}"/>\n')
        w(f'<f a="{off}" b="{off+2}" c="{off+3}"/>\n')
        off += 4
    w('</mesh>\n')

    # sphere grid: two layers of g x g
    mats = ["white", "glossy", "mirror"]
    rad = room / (g * 2.6)
    mesh_id = 2
    for layer in range(2):
        zc = room * (0.18 + 0.35 * layer)
        for i in range(g):
            for j in range(g):
                cx = room * (i + 0.5) / g
                cy = room * (j + 0.5) / g
                v = verts * rad + np.array([cx, cy, zc])
                w(f'<mesh id="{mesh_id}" vertices="{v.shape[0]}" '
                  f'faces="{faces.shape[0]}" has_uv="false" type="0">\n')
                for p in v:
                    w(f'<p x="{p[0]:.5f}" y="{p[1]:.5f}" z="{p[2]:.5f}"/>\n')
                w(f'<set_material sval="{mats[(i + j + layer) % 3]}"/>\n')
                for f in faces:
                    w(f'<f a="{f[0]}" b="{f[1]}" c="{f[2]}"/>\n')
                w('</mesh>\n')
                mesh_id += 1

    w('<integrator name="default"><type sval="pathtracing"/>'
      '<raydepth ival="3"/><bounces ival="3"/></integrator>\n')
    w('<integrator name="volintegr"><type sval="none"/></integrator>\n')
    w(f'<render><camera_name sval="cam"/><integrator_name sval="default"/>'
      f'<width ival="{size}"/><height ival="{size}"/>'
      f'<AA_passes ival="1"/><AA_minsamples ival="{spp}"/>'
      '<filter_type sval="gauss"/></render>\n')
    w('</scene>\n')
    return buf.getvalue()


def write_grid_spheres(path: str, grid: int = 8, subdiv: int = 3,
                       spp: int = 16, size: int = 512) -> str:
    """Write the scene's XML to `path`; returns the path."""
    with open(path, "w") as fh:
        fh.write(grid_spheres_xml(grid, subdiv, spp, size))
    return path


def make_soup(n: int, seed: int = 0, extent: float = 10.0,
              tri_size: float = 0.4):
    """(v0, e1, e2) float32 (n, 3) of n random triangles: corners uniform in
    a cube of half-width `extent`, edges normal with deviation tri_size.
    Their Morton clusters overlap everywhere: the worst case for box
    culling."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, tri_size, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, tri_size, (n, 3)).astype(np.float32)
    return v0, e1, e2


def make_rays(n: int, kind: str, seed: int = 1, ctr=None, ext=None):
    """(org, dir) float32 (n, 3) of n rays over the box ctr ± ext (default
    the origin ± 10): "coherent" from one camera-like origin cluster towards
    targets in scanline order, as primary rays arrive; otherwise
    ("incoherent") origins uniform in the box and directions uniform on the
    sphere, as bounce rays."""
    rng = np.random.default_rng(seed)
    ctr = np.zeros(3) if ctr is None else np.asarray(ctr)
    ext = np.full(3, 10.0) if ext is None else np.asarray(ext)
    if kind == "coherent":
        org = (ctr + np.array([0.0, 0.0, 3.0]) * ext
               + rng.normal(0, 0.02, (n, 3)) * ext).astype(np.float32)
        side = int(np.sqrt(n))
        gy, gx = np.meshgrid(np.linspace(-1, 1, side),
                             np.linspace(-1, 1, side), indexing="ij")
        tgt = np.stack([gx.ravel(), gy.ravel(), np.zeros(side * side)],
                       axis=1)
        tgt = np.concatenate([tgt, tgt[: n - len(tgt)]])[:n] * ext + ctr
        d = tgt.astype(np.float32) - org
    else:
        org = (ctr + rng.uniform(-1, 1, (n, 3)) * ext).astype(np.float32)
        d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-12
    return org, d.astype(np.float32)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--grid", type=int, default=8,
                    help="grid is GxGx(rows of 2) spheres")
    ap.add_argument("--subdiv", type=int, default=3,
                    help="icosphere subdivision (3 -> 1280 tris each)")
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args(argv)
    write_grid_spheres(args.out, args.grid, args.subdiv, args.spp, args.size)
    print(f"wrote {args.out}: {os.path.getsize(args.out) / 1e6:.1f} MB")


if __name__ == "__main__":
    main()
