"""IES photometric profiles (port of libyafaray_tpu/lights/ies.py).

The host parses an IESNA LM-63 file into a full (θ, φ) candela grid (the
LM-63 horizontal-symmetry rules expanded: 0° axial, 90° quadrant, 180°
bilateral, 360° full), peak-normalised; the device side modulates a point
light's intensity by bilinear interpolation of the grid at the emission
angles, the azimuth measured in a fixed frame around the light axis.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import math as vmath

PROFILE_RES = 91  # 2-degree vertical resolution, interpolated
PROFILE_HRES = 73  # 5-degree azimuthal resolution (phi in [0, 360])


def parse_ies(path: str) -> np.ndarray:
    """Parse an IESNA LM-63 file -> its candela grid over vertical angle
    theta in [0, 180] and azimuth phi in [0, 360], (PROFILE_RES,
    PROFILE_HRES) float32, peak-normalised (the light's `power` carries
    the magnitude).  A TILT=INCLUDE block is skipped."""
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        text = f.read()
    # find the TILT line; numeric payload starts after it
    lines = text.splitlines()
    start = 0
    for i, ln in enumerate(lines):
        if ln.strip().upper().startswith("TILT="):
            tilt = ln.split("=", 1)[1].strip().upper()
            start = i + 1
            if tilt == "INCLUDE":
                # skip tilt block: <angles line> <n> <angles...> <factors...>
                nums_seen = 0
                j = start
                vals = []
                while j < len(lines) and nums_seen < 2:
                    vals += lines[j].split()
                    j += 1
                    nums_seen = len(vals)
                n_tilt = int(float(vals[1]))
                need = 2 + 2 * n_tilt
                while len(vals) < need and j < len(lines):
                    vals += lines[j].split()
                    j += 1
                start = j
            break
    nums: list[float] = []
    for ln in lines[start:]:
        for tok in ln.replace(",", " ").split():
            try:
                nums.append(float(tok))
            except ValueError:
                pass
    # header: lamps, lumens/lamp, multiplier, n_v, n_h, photometric type,
    # units, width, length, height, ballast, future, watts
    if len(nums) < 13:
        raise ValueError("truncated IES file")
    n_v = int(nums[3])
    n_h = int(nums[4])
    mult = nums[2]
    idx = 13
    v_angles = np.asarray(nums[idx:idx + n_v])
    idx += n_v
    h_angles = np.asarray(nums[idx:idx + n_h])
    idx += n_h
    candela = np.asarray(nums[idx:idx + n_v * n_h])
    if candela.size < n_v * n_h:
        raise ValueError("truncated candela table")
    candela = candela.reshape(n_h, n_v) * mult

    # horizontal symmetry expansion (LM-63): the last horizontal angle
    # declares the coverage
    h_last = h_angles[-1] if n_h else 0.0
    if n_h <= 1 or h_last == 0.0:
        h_full = np.asarray([0.0, 360.0])
        c_full = np.broadcast_to(candela[:1], (2, n_v))
    elif abs(h_last - 90.0) < 1e-6:
        h_full = np.concatenate([h_angles, 180.0 - h_angles[::-1][1:],
                                 180.0 + h_angles[1:],
                                 360.0 - h_angles[::-1][1:]])
        c_full = np.concatenate([candela, candela[::-1][1:],
                                 candela[1:], candela[::-1][1:]])
    elif abs(h_last - 180.0) < 1e-6:
        h_full = np.concatenate([h_angles, 360.0 - h_angles[::-1][1:]])
        c_full = np.concatenate([candela, candela[::-1][1:]])
    else:
        h_full = h_angles
        c_full = candela

    theta = np.linspace(0.0, 180.0, PROFILE_RES)
    phi = np.linspace(0.0, 360.0, PROFILE_HRES)
    # resample each horizontal slice over theta, then over phi
    c_v = np.stack([
        np.interp(theta, v_angles, c_full[h],
                  left=c_full[h][0], right=0.0)
        for h in range(c_full.shape[0])
    ])  # (H_in, PROFILE_RES)
    grid = np.stack([
        np.interp(phi, h_full, c_v[:, t],
                  left=c_v[0, t], right=c_v[-1, t])
        for t in range(PROFILE_RES)
    ])  # (PROFILE_RES, PROFILE_HRES)
    peak = grid.max()
    if peak <= 0:
        raise ValueError("empty IES profile")
    return (grid / peak).astype(np.float32)


def apply_ies_profile(profile: torch.Tensor, light_dir: torch.Tensor,
                      wi: torch.Tensor) -> torch.Tensor:
    """The profile's factor (N,) at the emission direction -wi: profile is
    (PROFILE_RES,) vertical only or the (PROFILE_RES, PROFILE_HRES) full
    (θ, φ) grid, θ = 0 along light_dir; the azimuth frame is the ONB of
    light_dir."""
    d = -wi
    ld = light_dir + torch.zeros_like(wi)
    cos_t = torch.clamp(vmath.dot(d, ld), -1.0, 1.0)
    x = vmath.div(torch.arccos(cos_t), np.pi) * (PROFILE_RES - 1)
    i0 = torch.clamp(x.to(torch.int32), 0, PROFILE_RES - 2)
    fx = x - i0
    i0 = i0.long()
    if profile.dim() == 1:
        return profile[i0] * (1.0 - fx) + profile[i0 + 1] * fx
    t1, t2 = vmath.build_onb(vmath.normalize(ld))
    phi = torch.atan2(vmath.dot(d, t2), vmath.dot(d, t1))  # [-pi, pi]
    y = torch.remainder(vmath.div(phi, 2.0 * np.pi), 1.0) * (PROFILE_HRES - 1)
    j0 = torch.clamp(y.to(torch.int32), 0, PROFILE_HRES - 2)
    fy = y - j0
    j0 = j0.long()
    c00 = profile[i0, j0]
    c10 = profile[i0 + 1, j0]
    c01 = profile[i0, j0 + 1]
    c11 = profile[i0 + 1, j0 + 1]
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)
