"""Volume region factory (port of libyafaray_tpu/volumes/factory.py;
reference src/volumes/*): the five region types, `read_df3` and
`volume_from_params`.  An unknown type warns and becomes a UniformVolume;
a GridVolume whose file fails to load becomes uniform with a warning."""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from ..scene.params import ParamMap

log = logging.getLogger("libyafaray_tpu_torch")

VOL_UNIFORM = 0
VOL_EXP = 1
VOL_NOISE = 2
VOL_GRID = 3
VOL_SKY = 4

_TYPES = {
    "UniformVolume": VOL_UNIFORM,
    "ExpDensityVolume": VOL_EXP,
    "NoiseVolume": VOL_NOISE,
    "GridVolume": VOL_GRID,
    "SkyVolume": VOL_SKY,
}


def read_df3(path: str):
    """POV-Ray DF3 density file: 3x uint16 BE dims then scalar voxels
    (8/16/32-bit BE) — the loader the reference's GridVolume uses."""
    with open(path, "rb") as f:
        data = f.read()
    nx, ny, nz = (int.from_bytes(data[i:i + 2], "big") for i in (0, 2, 4))
    vox = data[6:]
    n = nx * ny * nz
    if len(vox) >= 4 * n:
        arr = np.frombuffer(vox, ">u4", n).astype(np.float32) / 4294967295.0
    elif len(vox) >= 2 * n:
        arr = np.frombuffer(vox, ">u2", n).astype(np.float32) / 65535.0
    else:
        arr = np.frombuffer(vox, "u1", n).astype(np.float32) / 255.0
    return arr.reshape(nz, ny, nx)


@dataclass(frozen=True)
class VolumeRegion:
    vtype: int
    bmin: tuple
    bmax: tuple
    sigma_a: float
    sigma_s: float
    l_e: float
    g: float  # phase anisotropy (reference keeps isotropic in practice)
    # exp density
    a: float = 1.0
    b: float = 1.0
    # noise volume
    sharpness: float = 1.0
    cover: float = 1.0
    density: float = 1.0
    # SkyVolume: Rayleigh/Mie scattering split (reference SkyVolume.cc)
    s_ray: float = 0.01
    s_mie: float = 0.001
    # GridVolume: hashable grid payload (tuple of floats + dims)
    grid_shape: tuple = ()
    grid_data: tuple = ()


def grid_arrays(volumes) -> dict:
    """The scene arrays of the GridVolumes that loaded: {"vol_grid_{vi}":
    (nz, ny, nx) float32 densities}, uploaded with the scene's other
    arrays."""
    return {f"vol_grid_{vi}": np.asarray(v.grid_data, np.float32).reshape(
        v.grid_shape) for vi, v in enumerate(volumes)
        if v.vtype == VOL_GRID and v.grid_shape}


def volume_from_params(params: ParamMap) -> VolumeRegion:
    tname = params.get_str("type", "UniformVolume")
    if tname not in _TYPES:
        log.warning("unknown volume type %r; UniformVolume", tname)
        tname = "UniformVolume"
    grid_shape = ()
    grid_data = ()
    if _TYPES[tname] == VOL_GRID:
        fname = params.get_str("density_file", params.get_str("file", ""))
        try:
            g = read_df3(fname)
            grid_shape = tuple(int(x) for x in g.shape)
            grid_data = tuple(float(x) for x in g.reshape(-1))
        except Exception as e:  # noqa: BLE001
            log.warning(
                "GridVolume: cannot read %r (%s); uniform fallback", fname, e)
    return VolumeRegion(
        vtype=_TYPES[tname],
        bmin=(params.get_float("minX", -1.0), params.get_float("minY", -1.0),
              params.get_float("minZ", -1.0)),
        bmax=(params.get_float("maxX", 1.0), params.get_float("maxY", 1.0),
              params.get_float("maxZ", 1.0)),
        sigma_a=params.get_float("sigma_a", 0.05),
        sigma_s=params.get_float("sigma_s", 0.05),
        l_e=params.get_float("l_e", 0.0),
        g=params.get_float("g", 0.0),
        a=params.get_float("a", 1.0),
        b=params.get_float("b", 1.0),
        sharpness=params.get_float("sharpness", 1.0),
        cover=params.get_float("cover", 1.0),
        density=params.get_float("density", 1.0),
        s_ray=params.get_float("sigma_r", params.get_float("s_ray", 0.01)),
        s_mie=params.get_float("sigma_m", params.get_float("s_mie", 0.001)),
        grid_shape=grid_shape,
        grid_data=grid_data,
    )
