"""Cameras — batched shootRay over pixel lanes (port of
libyafaray_tpu/cameras/base.py: the Camera record, the perspective branches
of `shoot_rays`, `pixel_cone`, `project_to_camera` and
`pixel_plane_area`)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import math as vmath

CAM_PERSPECTIVE = 0
CAM_ARCHITECT = 1
CAM_ANGULAR = 2
CAM_ORTHO = 3
CAM_EQUIRECT = 4


@dataclass
class Camera:
    cam_type: int = CAM_PERSPECTIVE
    resx: int = 512
    resy: int = 512
    origin: tuple = (0.0, 0.0, 0.0)
    # orthonormal camera frame (right, up, forward), row vectors
    right: tuple = (1.0, 0.0, 0.0)
    up: tuple = (0.0, 0.0, 1.0)
    fwd: tuple = (0.0, 1.0, 0.0)
    focal: float = 1.0
    aperture: float = 0.0
    dof_distance: float = 1.0
    bokeh_type: str = "disk1"
    bokeh_rotation: float = 0.0
    bokeh_bias: str = "uniform"
    aspect_ratio: float = 1.0
    angle_deg: float = 90.0
    circular: bool = True
    mirrored: bool = False
    max_angle_deg: float = 0.0
    scale: float = 1.0
    near_clip: float = 0.0
    far_clip: float = -1.0

    @staticmethod
    def from_lookat(cam_type, resx, resy, from_p, to_p, up_v, **kw):
        f = np.asarray(from_p, np.float64)
        t = np.asarray(to_p, np.float64)
        u = np.asarray(up_v, np.float64)
        fwd = t - f
        n = np.linalg.norm(fwd)
        fwd = fwd / max(n, 1e-12)
        # reference convention: `up` param is a point, up dir = up - from
        upd = u - f
        if np.linalg.norm(upd) < 1e-9:
            upd = u
        right = np.cross(fwd, upd)
        rn = np.linalg.norm(right)
        if rn < 1e-9:
            right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
            rn = np.linalg.norm(right)
            if rn < 1e-9:
                right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
                rn = np.linalg.norm(right)
        right /= rn
        up2 = np.cross(right, fwd)
        return Camera(
            cam_type=cam_type, resx=int(resx), resy=int(resy),
            origin=tuple(f), right=tuple(right), up=tuple(up2),
            fwd=tuple(fwd), **kw,
        )


def check_supported(cam: Camera) -> None:
    """Slice 1 renders through a pinhole perspective camera only."""
    if cam.cam_type != CAM_PERSPECTIVE:
        raise NotImplementedError(
            f"camera type {cam.cam_type} (architect/angular/ortho/"
            "equirect) is not ported yet: ROADMAP Queue 1 item 17")
    if cam.aperture > 0.0:
        raise NotImplementedError(
            "depth of field / bokeh is not ported yet: ROADMAP Queue 1 "
            "item 17")


def shoot_rays(cam: Camera, px: torch.Tensor, py: torch.Tensor):
    """(px, py): continuous pixel coords in [0, res), float32 lanes.
    Returns (org (N,3), dir (N,3), weight (N,)).  Image plane spans
    [-0.5, 0.5] horizontally at distance `focal`, y down the image."""
    check_supported(cam)
    dev = px.device
    right = torch.tensor(cam.right, dtype=torch.float32, device=dev)
    up = torch.tensor(cam.up, dtype=torch.float32, device=dev)
    fwd = torch.tensor(cam.fwd, dtype=torch.float32, device=dev)
    org0 = torch.tensor(cam.origin, dtype=torch.float32, device=dev)
    # true division by a tensor: a python-scalar divisor may be turned
    # into a multiply by its reciprocal on the GPU, which rounds otherwise
    resx = torch.tensor(float(cam.resx), dtype=torch.float32, device=dev)
    resy = torch.tensor(float(cam.resy), dtype=torch.float32, device=dev)
    u = px / resx - 0.5
    v = 0.5 - py / resy
    aspect = cam.resy / cam.resx * cam.aspect_ratio
    weight = torch.ones(px.shape, dtype=torch.float32, device=dev)
    d = (u[..., None] * right + (v * aspect)[..., None] * up
         + cam.focal * fwd)
    d = vmath.normalize(d)
    org = org0 + torch.zeros_like(d)
    return org, d, weight


def pixel_cone(cam: Camera) -> tuple:
    """Ray-cone initialization (spread_per_unit_distance, base_width) of
    the perspective camera."""
    check_supported(cam)
    return 1.0 / (cam.resx * max(cam.focal, 1e-6)), 0.0


def project_to_camera(cam: Camera, p: torch.Tensor):
    """World points (N, 3) -> (px, py, cos_cam, dist, valid) through the
    perspective camera, the inverse of shoot_rays (texco "window" reads
    px / resx, py / resy)."""
    check_supported(cam)
    dev = p.device
    right, up, fwd, org0 = (torch.tensor(a, dtype=torch.float32, device=dev)
                            for a in (cam.right, cam.up, cam.fwd,
                                      cam.origin))
    aspect = cam.resy / cam.resx * cam.aspect_ratio
    v = p - org0
    dist = torch.sqrt(torch.clamp(vmath.dot(v, v), min=1e-12))
    z = vmath.dot(v, fwd)
    safe_z = torch.clamp(z, min=1e-6)
    u = cam.focal * vmath.dot(v, right) / safe_z
    w = cam.focal * vmath.dot(v, up) / (safe_z * aspect)
    px = (u + 0.5) * cam.resx
    py = (0.5 - w) * cam.resy
    valid = ((z > 1e-4) & (px >= 0) & (px < cam.resx) & (py >= 0)
             & (py < cam.resy))
    return px, py, z / dist, dist, valid


def pixel_plane_area(cam: Camera) -> float:
    """Area of one pixel on the image plane at distance `focal` (the
    measure of BDPT's t=1 splats)."""
    aspect = cam.resy / cam.resx * cam.aspect_ratio
    return (1.0 / cam.resx) * (aspect / cam.resy)
