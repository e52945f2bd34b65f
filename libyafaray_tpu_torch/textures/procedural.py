"""Procedural textures and noise generators (port of
libyafaray_tpu/textures/procedural.py).

The Blender-compatible set: clouds, marble, wood, voronoi (4 metrics,
weighted F1..F4), musgrave fractals (fBm, ridged, hybrid), distorted
noise, blend gradient and RGB cube, over a selectable noise basis:
`newperlin`/`stdperlin` are the canonical Improved Perlin (2002) with its
published permutation; `voronoi_f1..f4`, `crackle` and `cellnoise` use the
Worley machinery; `blender` (the default) keeps the reference's
hash-gradient stand-in for Blender's original noise, whose table is not
re-derivable (PARITY.md §2.7).

Lane-wise over (N, 3) points.  Hash words are int32 holding uint32 bits,
as in core/qmc.py; `_u32_mod` takes an unsigned remainder.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import qmc

F32 = torch.float32

# Ken Perlin's reference permutation (2002 "Improving Noise"), doubled to
# avoid index wrapping
_PERLIN_PERM = np.array([
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7,
    225, 140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6,
    148, 247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35,
    11, 32, 57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171,
    168, 68, 175, 74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158,
    231, 83, 111, 229, 122, 60, 211, 133, 230, 220, 105, 92, 41, 55,
    46, 245, 40, 244, 102, 143, 54, 65, 25, 63, 161, 1, 216, 80, 73,
    209, 76, 132, 187, 208, 89, 18, 169, 200, 196, 135, 130, 116, 188,
    159, 86, 164, 100, 109, 198, 173, 186, 3, 64, 52, 217, 226, 250,
    124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212, 207, 206,
    59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213, 119,
    248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9,
    129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185,
    112, 104, 218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12,
    191, 179, 162, 241, 81, 51, 145, 235, 249, 14, 239, 107, 49, 192,
    214, 31, 181, 199, 106, 157, 184, 84, 204, 176, 115, 121, 50, 45,
    127, 4, 150, 254, 138, 236, 205, 93, 222, 114, 67, 29, 24, 72, 243,
    141, 128, 195, 78, 66, 215, 61, 156, 180], np.int64)
_PERLIN_PERM2 = np.concatenate([_PERLIN_PERM, _PERLIN_PERM])


def _u32_mod(h: torch.Tensor, m: int) -> torch.Tensor:
    """(uint32 word h) mod m as int32."""
    return ((h.to(torch.int64) & 0xFFFFFFFF) % m).to(torch.int32)


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _lerp(lo, hi, t):
    return lo + (hi - lo) * t


def _perlin_grad(h, x, y, z):
    """Improved-Perlin gradient: h & 15 picks one of 12 edge vectors (4
    repeated), dotted with the offset."""
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return (torch.where((h & 1) == 0, u, -u)
            + torch.where((h & 2) == 0, v, -v))


def perlin_noise(p):
    """Improved Perlin noise (2002): the reference permutation, quintic
    fade, 12 edge gradients; zero at every lattice point, within [-1, 1]."""
    perm = torch.as_tensor(_PERLIN_PERM2, device=p.device)
    pi = torch.floor(p)
    pf = p - pi
    pi = pi.to(torch.int64)
    xi, yi, zi = pi[..., 0] & 255, pi[..., 1] & 255, pi[..., 2] & 255
    x, y, z = pf[..., 0], pf[..., 1], pf[..., 2]
    u, v, w = _fade(x), _fade(y), _fade(z)
    a = perm[xi] + yi
    aa = perm[a] + zi
    ab = perm[a + 1] + zi
    b = perm[xi + 1] + yi
    ba = perm[b] + zi
    bb = perm[b + 1] + zi
    c000 = _perlin_grad(perm[aa], x, y, z)
    c100 = _perlin_grad(perm[ba], x - 1, y, z)
    c010 = _perlin_grad(perm[ab], x, y - 1, z)
    c110 = _perlin_grad(perm[bb], x - 1, y - 1, z)
    c001 = _perlin_grad(perm[aa + 1], x, y, z - 1)
    c101 = _perlin_grad(perm[ba + 1], x - 1, y, z - 1)
    c011 = _perlin_grad(perm[ab + 1], x, y - 1, z - 1)
    c111 = _perlin_grad(perm[bb + 1], x - 1, y - 1, z - 1)
    return _lerp(
        _lerp(_lerp(c000, c100, u), _lerp(c010, c110, u), v),
        _lerp(_lerp(c001, c101, u), _lerp(c011, c111, u), v), w)


def _hash3(ix, iy, iz, seed: int = 0):
    """uint32 hash of an integer lattice cell (int32 words)."""
    return qmc.hash_combine(
        qmc.hash_combine(ix + qmc.i32(seed), iy), iz)


def _grad_dot(h, fx, fy, fz):
    """Gradient from a hash (12 directions), dotted with the offset."""
    h = _u32_mod(h, 12)
    u = torch.where(h < 8, fx, fy)
    v = torch.where(h < 4, fy, torch.where((h == 12) | (h == 14), fx, fz))
    su = torch.where((h & 1) == 0, u, -u)
    sv = torch.where((h & 2) == 0, v, -v)
    return su + sv


def _lattice(p):
    """(floor as int32 x, y, z, fractional part)."""
    pi = torch.floor(p)
    pf = p - pi
    pi = pi.to(torch.int32)
    return pi[..., 0], pi[..., 1], pi[..., 2], pf


def gradient_noise(p, seed: int = 0):
    """Perlin-style gradient noise over a hashed lattice, in [-1, 1]."""
    ix, iy, iz, pf = _lattice(p)
    fx, fy, fz = pf[..., 0], pf[..., 1], pf[..., 2]

    def corner(dx, dy, dz):
        h = _hash3(ix + dx, iy + dy, iz + dz, seed)
        return _grad_dot(h, fx - dx, fy - dy, fz - dz)

    u, v, w = _fade(fx), _fade(fy), _fade(fz)
    x00 = _lerp(corner(0, 0, 0), corner(1, 0, 0), u)
    x10 = _lerp(corner(0, 1, 0), corner(1, 1, 0), u)
    x01 = _lerp(corner(0, 0, 1), corner(1, 0, 1), u)
    x11 = _lerp(corner(0, 1, 1), corner(1, 1, 1), u)
    return _lerp(_lerp(x00, x10, v), _lerp(x01, x11, v), w) * 0.97


def noise_basis(p, basis: str = "blender", seed: int = 0):
    """Selectable noise basis in [-1, 1] (Blender noise_type values):
    blender (hash-gradient stand-in), newperlin/stdperlin (Improved
    Perlin), voronoi_f1..f4, voronoi_crackle / crackle, cellnoise."""
    if basis in ("newperlin", "improvedperlin", "stdperlin", "perlin"):
        return perlin_noise(p)
    if basis.startswith("voronoi") or basis == "crackle":
        f1, f2, f3, f4, _ = voronoi_f(p, "dist", seed)
        if basis.endswith("f2"):
            v = f2
        elif basis.endswith("f3"):
            v = f3
        elif basis.endswith("f4"):
            v = f4
        elif basis.endswith("crackle"):
            v = f2 - f1
        else:
            v = f1
        return torch.clamp(v, 0.0, 1.0) * 2.0 - 1.0
    if basis == "cellnoise":
        ix, iy, iz, _ = _lattice(p)
        h = _hash3(ix, iy, iz, seed)
        return (h & 0xFFFF).to(F32) / 32767.5 - 1.0
    return gradient_noise(p, seed)


def turbulence(p, octaves: int, hard: bool = False, seed: int = 0,
               basis: str = "blender"):
    """fBm / turbulence, ~[0, 1] (a sum of |noise| when hard)."""
    amp = 1.0
    freq = 1.0
    total = torch.zeros(p.shape[:-1], dtype=F32, device=p.device)
    norm = 0.0
    for o in range(max(1, min(octaves, 8))):
        n = noise_basis(p * freq, basis, seed + o)
        total = total + amp * (n.abs() if hard else n)
        norm += amp
        amp *= 0.5
        freq *= 2.0
    t = total / norm
    return t if hard else t * 0.5 + 0.5


def voronoi_f(p, metric: str = "dist", seed: int = 0):
    """Worley F1..F4 distances over the 27 neighbouring cells.  Returns
    (f1, f2, f3, f4, hash of the nearest feature's cell)."""
    ix0, iy0, iz0, pf = _lattice(p)
    big = torch.full(p.shape[:-1], 1e10, dtype=F32, device=p.device)
    f = [big] * 4
    best_h = torch.zeros(p.shape[:-1], dtype=torch.int32, device=p.device)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                h = _hash3(ix0 + dx, iy0 + dy, iz0 + dz, seed)
                jx = (h & 1023).to(F32) / 1023.0
                jy = ((h >> 10) & 1023).to(F32) / 1023.0
                jz = ((h >> 20) & 1023).to(F32) / 1023.0
                ox = dx + jx - pf[..., 0]
                oy = dy + jy - pf[..., 1]
                oz = dz + jz - pf[..., 2]
                if metric == "manhattan":
                    d = ox.abs() + oy.abs() + oz.abs()
                elif metric == "chebychev":
                    d = torch.maximum(torch.maximum(ox.abs(), oy.abs()),
                                      oz.abs())
                elif metric == "dist_squared":
                    d = ox * ox + oy * oy + oz * oz
                else:
                    d = torch.sqrt(ox * ox + oy * oy + oz * oz)
                best_h = torch.where(d < f[0], h, best_h)
                # keep the 4 smallest of {f1..f4, d} by min extraction
                rem = [f[0], f[1], f[2], f[3], d]
                fs = []
                for _ in range(4):
                    m = rem[0]
                    for r in rem[1:]:
                        m = torch.minimum(m, r)
                    fs.append(m)
                    removed = torch.zeros_like(m, dtype=torch.bool)
                    new_rem = []
                    for r in rem:
                        is_min = (r == m) & ~removed
                        removed = removed | is_min
                        new_rem.append(torch.where(is_min, 1e10, r))
                    rem = new_rem
                f = fs
    return f[0], f[1], f[2], f[3], best_h


def musgrave(p, mtype: str, octaves: int = 6, h_exp: float = 1.0,
             lacunarity: float = 2.0, offset: float = 1.0,
             gain: float = 1.0, seed: int = 0, basis: str = "blender"):
    """Musgrave fractals: ridged_multifractal, hybrid_multifractal, else
    fBm / multifractal."""
    freq = 1.0
    amp = 1.0
    if mtype == "ridged_multifractal":
        signal = offset - noise_basis(p, basis, seed).abs()
        signal = signal * signal
        value = signal
        for o in range(1, max(2, min(octaves, 8))):
            freq *= lacunarity
            weight = torch.clamp(signal * gain, 0.0, 1.0)
            signal = offset - noise_basis(p * freq, basis, seed + o).abs()
            signal = signal * signal * weight
            value = value + signal / (freq ** h_exp)
        return value
    if mtype == "hybrid_multifractal":
        value = noise_basis(p, basis, seed) + offset
        weight = value
        for o in range(1, max(2, min(octaves, 8))):
            freq *= lacunarity
            weight = torch.clamp(weight, max=1.0)
            signal = (noise_basis(p * freq, basis, seed + o) + offset) \
                / (freq ** h_exp)
            value = value + weight * signal
            weight = weight * signal
        return value
    value = torch.zeros(p.shape[:-1], dtype=F32, device=p.device)
    for o in range(max(1, min(octaves, 8))):
        value = value + noise_basis(p * freq, basis, seed + o) * amp
        freq *= lacunarity
        amp /= lacunarity ** h_exp
    return value


def _grey(t):
    return torch.stack([t, t, t], dim=-1)


def eval_procedural(spec: tuple, p, uv):
    """spec: (type, sorted scalar params, ramp) from textures/factory.py;
    p (N, 3) mapped coordinates, uv (N, 2).  Returns (N, 3)."""
    ttype = spec[0]
    params = dict(spec[1]) if len(spec) > 1 and spec[1] else {}
    q = p * float(params.get("size", 1.0))
    basis = str(params.get("noise_type", "blender")).lower()

    if ttype == "clouds":
        depth = int(params.get("depth", 2))
        return _grey(turbulence(q, depth + 1,
                                hard=bool(params.get("hard", False)),
                                basis=basis))

    if ttype == "marble":
        depth = int(params.get("depth", 2))
        turb = float(params.get("turbulence", 5.0))
        sharp = float(params.get("sharpness", 1.0))
        n = turb * turbulence(q, depth + 1, hard=True, basis=basis)
        t = torch.sin((q[..., 0] + q[..., 1] + q[..., 2]) * math.pi + n)
        t = torch.pow(t.abs(), 1.0 / max(sharp, 1e-3)) * torch.sign(t)
        return _grey(t * 0.5 + 0.5)

    if ttype == "wood":
        turb = float(params.get("turbulence", 2.0))
        n = turb * 0.1 * turbulence(q, 3, hard=True, basis=basis)
        r = torch.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2)
        wtype = params.get("wood_type", "rings")
        base = r if wtype in ("rings", "ringnoise") else (
            q[..., 0] + q[..., 1])
        return _grey(torch.sin(base * 10.0 + n * 6.2831).abs())

    if ttype == "voronoi":
        w1 = float(params.get("weight_1", 1.0))
        w2 = float(params.get("weight_2", 0.0))
        w3 = float(params.get("weight_3", 0.0))
        w4 = float(params.get("weight_4", 0.0))
        isc = float(params.get("intensity", 1.0))
        f1, f2, f3, f4, h = voronoi_f(q, params.get("distance_metric",
                                                    "dist"))
        t = torch.clamp(isc * (w1 * f1 + w2 * f2 + w3 * f3 + w4 * f4),
                        0.0, 1.0)
        if params.get("color_type", "int") in ("col1", "col2", "col3"):
            r = (h & 255).to(F32) / 255.0
            g = ((h >> 8) & 255).to(F32) / 255.0
            b = ((h >> 16) & 255).to(F32) / 255.0
            return torch.stack([r, g, b], dim=-1) * t[..., None]
        return _grey(t)

    if ttype == "musgrave":
        t = musgrave(
            q, params.get("musgrave_type", "fBm"),
            octaves=int(params.get("octaves", 6)),
            h_exp=float(params.get("H", 1.0)),
            lacunarity=float(params.get("lacunarity", 2.0)),
            offset=float(params.get("offset", 1.0)),
            gain=float(params.get("gain", 1.0)),
            basis=basis)
        return _grey(torch.clamp(
            t * float(params.get("intensity", 1.0)) * 0.5 + 0.5, 0.0, 1.0))

    if ttype == "distorted_noise":
        dist = float(params.get("distort", 1.0))
        b1 = str(params.get("noise_type1", basis)).lower()
        b2 = str(params.get("noise_type2", basis)).lower()
        # the +13.5 lattice offset decorrelates the distortion field from
        # the carrier when both use the same (seedless) basis
        n1 = noise_basis(q + 13.5, b1, 7)
        return _grey(noise_basis(q + dist * n1[..., None], b2, 13) * 0.5
                     + 0.5)

    if ttype == "blend":
        stype = params.get("stype", "lin")
        t = torch.clamp(uv[..., 0], 0.0, 1.0)
        if stype == "quad":
            t = t * t
        elif stype == "ease":
            t = t * t * (3.0 - 2.0 * t)
        elif stype == "diag":
            t = 0.5 * (uv[..., 0] + uv[..., 1])
        elif stype in ("sphere", "halo"):
            dx = uv[..., 0] - 0.5
            dy = uv[..., 1] - 0.5
            t = torch.clamp(1.0 - 2.0 * torch.sqrt(dx * dx + dy * dy),
                            0.0, 1.0)
        return _grey(t)

    if ttype == "rgb_cube":
        return torch.clamp(p.abs(), 0.0, 1.0)

    # unknown type: mid grey
    return _grey(torch.full(p.shape[:-1], 0.5, dtype=F32, device=p.device))
