"""The film mesh: pixel rows split over the ranks of a process group (port
of libyafaray_tpu/parallel/mesh.py).

The reference shards each film plane by rows over a jax Mesh and lets XLA
insert the filter's halo exchange and the ray counter's psum.  Here a rank
holds the whole scene, traces only the pixels of its band of rows (its
lanes keyed by pixel as on one device: the compact lane lists of
`engine.make_sample_step`) and splats them into a full-size partial film,
zero outside the band and its filter's reach.  The full film is the sum
of the partial films (`sum_film`).  A pixel away from a band's edge has
one rank's adds only, so it is bit-equal to the one-device film; the rows
a filter reaches across an edge sum two partials, and the ray counter sums
one count a rank, both in another float order than one device's running
sums.  The sum is always taken of a copy: the running partial goes on
unsummed, or the next pass would add the other ranks' samples again.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from . import distributed as pd


@dataclass(frozen=True)
class FilmMesh:
    """One rank's view of the film mesh: its rank of `world`, its device,
    and its band of film rows [rows[0], rows[1])."""
    rank: int
    world: int
    device: torch.device
    rows: tuple

    def band_pixels(self, width: int) -> torch.Tensor:
        """This rank's flat pixel ids, row-major: the lane list of its
        band (int32, on its device)."""
        r0, r1 = self.rows
        return torch.arange(r0 * width, r1 * width, dtype=torch.int32,
                            device=self.device)

    def lanes(self, n: int) -> tuple:
        """This rank's share [lo, hi) of n photon lanes."""
        return self.rank * n // self.world, (self.rank + 1) * n // self.world


def sharded(mesh) -> bool:
    """Whether `mesh` splits the film over more than one rank."""
    return mesh is not None and mesh.world > 1


def lane_pixels(mesh, width: int):
    """The pixel ids a render's lanes trace: this rank's band on a mesh of
    several ranks, None (every pixel, the dense lanes) otherwise."""
    return mesh.band_pixels(width) if sharded(mesh) else None


def at_pixels(vals: torch.Tensor, pix, n_px: int) -> torch.Tensor:
    """Lane values (N, ...) at their flat pixel ids pix: an (n_px, ...)
    tensor, zero at every other pixel.  pix None: the lanes are every pixel
    already, and vals come back as they are."""
    if pix is None:
        return vals
    out = torch.zeros((n_px,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    out[pix.long()] = vals
    return out


def writes(mesh) -> bool:
    """Whether this rank writes the files (saved films): rank 0, or the
    only rank."""
    return mesh is None or mesh.rank == 0


def band_rows(height: int, world: int, rank: int) -> tuple:
    """Rank `rank`'s rows [r0, r1): the height split as evenly as it
    goes."""
    return rank * height // world, (rank + 1) * height // world


def auto_devices(n_devices: int | None, height: int, available: int) -> int:
    """The reference session's rule (`_auto_mesh`): None takes every
    available device, N is clamped to [1, available], then lowered to the
    largest divisor of the height."""
    want = available if n_devices is None else max(1, min(n_devices,
                                                          available))
    while want > 1 and height % want != 0:
        want -= 1
    return max(want, 1)


def make_device_mesh(n: int | None = None, height: int = 1,
                     device: str = "cuda") -> FilmMesh:
    """The film mesh over the live process group (n None or its world
    size), this rank on `distributed.rank_device(device)`; n = 1, or no
    group and n None, a mesh of one rank that owns every row.  More than
    one device takes a group of one rank a device (`distributed`)."""
    dev = pd.rank_device(device)
    if n == 1 or (n is None and not pd.is_live()):
        return FilmMesh(0, 1, dev, (0, height))
    if not pd.is_live():
        raise ValueError(f"a mesh of {n} devices with no process group: "
                         "start one rank a device (init_distributed, "
                         "spawn_ranks or torchrun) first")
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} devices in a group of {world} "
                         "ranks: start one rank a device")
    if world > height:
        raise ValueError(f"{world} ranks for {height} film rows: a rank "
                         "needs a row")
    return FilmMesh(rank, world, dev, band_rows(height, world, rank))


def film_shardings_for(film: dict) -> dict:
    """How each entry of a film combines across the mesh: "rows" for a
    plane (ndim >= 2: wsum, w, nsamples, alpha, the pass planes, m2,
    density) that each rank fills for its band's lanes and the ranks sum;
    "sum" for a counter (rays, summed in float64); "replicated" for the
    rest (the same on every rank)."""
    out = {}
    for k, v in film.items():
        if getattr(v, "ndim", 0) >= 2:
            out[k] = "rows"
        elif k == "rays":
            out[k] = "sum"
        else:
            out[k] = "replicated"
    return out


def sum_film(film: dict, mesh: FilmMesh, stats: dict | None = None) -> dict:
    """The full film: a copy of every rank's partial film summed plane by
    plane (replicated entries kept); `film` itself is left as it was.
    stats["reduce_s"] accumulates the host seconds of the sums.  Without
    a mesh of several ranks, `film` itself."""
    if not sharded(mesh):
        return film
    t0 = time.perf_counter()
    out = {}
    for k, how in film_shardings_for(film).items():
        v = film[k]
        if how == "rows":
            out[k] = pd.all_reduce_sum(v)
        elif how == "sum":
            out[k] = pd.all_reduce_sum(v.to(torch.float64)).to(v.dtype)
        else:
            out[k] = v
    if stats is not None:
        stats["reduce_s"] = (stats.get("reduce_s", 0.0)
                             + time.perf_counter() - t0)
    return out


def band_of(film: dict, mesh: FilmMesh) -> dict:
    """A full film (a loaded one) cut to this rank's partial: its band's
    rows kept and every other row zero, so the ranks' partials sum to it
    exactly.  Entries that are not planes stay whole on rank 0 (counters)
    or are kept as they are (replicated)."""
    if not sharded(mesh):
        return film
    r0, r1 = mesh.rows
    out = {}
    for k, how in film_shardings_for(film).items():
        v = film[k]
        if how == "rows":
            part = torch.zeros_like(v)
            part[r0:r1] = v[r0:r1]
            out[k] = part
        elif how == "sum":
            out[k] = v if mesh.rank == 0 else torch.zeros_like(v)
        else:
            out[k] = v
    return out


def finish(film: dict, mesh, stats: dict) -> dict:
    """A render's result film: on a mesh of several ranks stats gain
    rank_rays (this rank's) and mesh (rank, world, rows), and the summed
    film comes back."""
    if not sharded(mesh):
        return film
    stats.update(rank_rays=float(film["rays"]), mesh=dict(
        rank=mesh.rank, world=mesh.world, rows=mesh.rows))
    return sum_film(film, mesh, stats)


def render_sharded(cscene, cfg, mesh: FilmMesh, n_steps: int | None = None):
    """Render cfg.aa_samples (or n_steps) steps of the path tracer or
    direct lighting over every pixel across the mesh: this rank's band
    through the compact step, then the summed film (torch, on the rank's
    device; every rank returns it).  Nothing but the sample step: no
    caustic map, alpha or pass planes (the reference's render_sharded)."""
    from ..convert import to_tensors
    from ..integrators.engine import make_sample_step
    from ..integrators.render import _fresh_film

    arrays = to_tensors(cscene.arrays, mesh.device)
    pix = mesh.band_pixels(cfg.width)
    step = make_sample_step(cscene.static, cscene.camera, cfg, mesh.device,
                            compact_n=pix.numel())
    film = _fresh_film(cfg, mesh.device)
    for _ in range(n_steps or cfg.aa_samples):
        film = step(arrays, film, pix)
    return sum_film(film, mesh)
