"""Cameras — batched shootRay over pixel lanes (port of
libyafaray_tpu/cameras/base.py: the Camera record, `shoot_rays` for every
camera type of the reference (perspective and architect with thin-lens
depth of field and bokeh, angular, orthographic, equirectangular),
`_bokeh_warp`, `pixel_cone`, `project_to_camera` and `pixel_plane_area`)."""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import math as vmath
from ..core.sampling import sample_disk_concentric

CAM_PERSPECTIVE = 0
CAM_ARCHITECT = 1
CAM_ANGULAR = 2
CAM_ORTHO = 3
CAM_EQUIRECT = 4

_BOKEH_SIDES = {
    "triangle": 3, "square": 4, "pentagon": 5, "hexagon": 6,
}


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
    bokeh_bias: str = "uniform"  # uniform | center | edge
    aspect_ratio: float = 1.0
    angle_deg: float = 90.0  # angular camera fov
    circular: bool = True  # angular camera mask
    mirrored: bool = False  # angular: horizontally mirrored projection
    max_angle_deg: float = 0.0  # angular: mask half-angle (0 = angle)
    scale: float = 1.0  # orthographic scale
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


def _vec(a, dev) -> torch.Tensor:
    return torch.tensor(a, dtype=torch.float32, device=dev)


def _bokeh_warp(cam: Camera, lu: torch.Tensor, lv: torch.Tensor):
    """Lens uniforms -> a point (x, y) on the aperture's shape: a regular
    polygon (triangle .. hexagon, a wedge picked by lu and its triangle
    warped), a ring, or the concentric disk (disk1 / disk2).  The center
    bias squares lu, the edge bias 1 - (1 - lu)^2."""
    bias = cam.bokeh_bias.lower()
    if bias == "center":
        lu = lu * lu
    elif bias == "edge":
        lu = 1.0 - (1.0 - lu) * (1.0 - lu)
    bt = cam.bokeh_type.lower()
    if bt in _BOKEH_SIDES:
        k = _BOKEH_SIDES[bt]
        rot = cam.bokeh_rotation * math.pi / 180.0
        wedge = torch.floor(lu * k)
        fu = lu * k - wedge
        a0 = vmath.div(wedge, k) * 2.0 * math.pi + rot
        a1 = vmath.div(wedge + 1.0, k) * 2.0 * math.pi + rot
        r = vmath.sqrt_rn(torch.clamp(lv, min=0.0))
        p0x, p0y = torch.cos(a0), torch.sin(a0)
        p1x, p1y = torch.cos(a1), torch.sin(a1)
        return r * (p0x + fu * (p1x - p0x)), r * (p0y + fu * (p1y - p0y))
    if bt == "ring":
        theta = 2.0 * math.pi * lu
        return torch.cos(theta), torch.sin(theta)
    return sample_disk_concentric(lu, lv)


def shoot_rays(cam: Camera, px: torch.Tensor, py: torch.Tensor,
               lu: torch.Tensor, lv: torch.Tensor):
    """(px, py): continuous pixel coords in [0, res), float32 lanes;
    (lu, lv): the lens uniforms (read by depth of field only).
    Returns (org (N,3), dir (N,3), weight (N,)).  The image plane spans
    [-0.5, 0.5] horizontally at distance `focal`, y down the image; an
    angular camera's lanes outside its circle get weight 0."""
    dev = px.device
    right, up, fwd, org0 = (_vec(a, dev) for a in (cam.right, cam.up,
                                                  cam.fwd, cam.origin))
    # true division by a tensor: a python-scalar divisor may be turned
    # into a multiply by its reciprocal on the GPU, which rounds otherwise
    u = vmath.div(px, cam.resx) - 0.5
    v = 0.5 - vmath.div(py, cam.resy)
    aspect = cam.resy / cam.resx * cam.aspect_ratio
    weight = torch.ones(px.shape, dtype=torch.float32, device=dev)
    zeros = torch.zeros(px.shape + (3,), dtype=torch.float32, device=dev)

    if cam.cam_type in (CAM_PERSPECTIVE, CAM_ARCHITECT):
        up_d = up
        if cam.cam_type == CAM_ARCHITECT:
            # vertical-line correction: up made orthogonal to fwd in
            # float64 on the host, then rounded (the reference's bits)
            cu, cf = np.asarray(cam.up), np.asarray(cam.fwd)
            up_d = _vec((cu - np.dot(cu, cf) * cf).astype(np.float32), dev)
        d = vmath.normalize(u[..., None] * right
                            + (v * aspect)[..., None] * up_d
                            + cam.focal * fwd)
        org = org0 + zeros
        if cam.aperture > 0.0:
            ax, ay = _bokeh_warp(cam, lu, lv)
            lens_off = ((ax * cam.aperture)[..., None] * right
                        + (ay * cam.aperture)[..., None] * up)
            # the focus plane lies dof_distance along fwd
            cos_f = torch.clamp(vmath.dot(d, fwd), min=1e-6)
            ft = torch.full_like(cos_f, cam.dof_distance) / cos_f
            focus_p = org + ft[..., None] * d
            org = org + lens_off
            d = vmath.normalize(focus_p - org)
        return org, d, weight

    if cam.cam_type == CAM_ANGULAR:
        half = 0.5 * cam.angle_deg * math.pi / 180.0
        ua = -u if cam.mirrored else u
        va = v * aspect
        r = vmath.sqrt_rn(ua * ua + va * va) * 2.0
        theta = r * half
        phi = torch.atan2(va, ua)
        st = torch.sin(theta)
        d = ((st * torch.cos(phi))[..., None] * right
             + (st * torch.sin(phi))[..., None] * up
             + torch.cos(theta)[..., None] * fwd)
        if cam.circular:
            # max_angle: the mask's half-angle, by default the fov's
            max_half = (0.5 * cam.max_angle_deg * math.pi / 180.0
                        if cam.max_angle_deg > 0.0 else half)
            weight = torch.where(theta <= max_half + 1e-7, weight, 0.0)
        return org0 + zeros, vmath.normalize(d), weight

    if cam.cam_type == CAM_ORTHO:
        org = (org0 + (u * cam.scale)[..., None] * right
               + (v * aspect * cam.scale)[..., None] * up)
        return org, fwd + zeros, weight

    if cam.cam_type == CAM_EQUIRECT:
        phi = 2.0 * math.pi * u
        theta = math.pi * v
        ct = torch.cos(theta)
        d = ((ct * torch.sin(phi))[..., None] * right
             + torch.sin(theta)[..., None] * up
             + (ct * torch.cos(phi))[..., None] * fwd)
        return org0 + zeros, vmath.normalize(d), weight

    raise ValueError(f"unknown camera type {cam.cam_type}")


def pixel_cone(cam: Camera) -> tuple:
    """Ray-cone initialization (spread_per_unit_distance, base_width): the
    cone width at distance t is base + spread·t, about one pixel's
    world-space footprint (texture mip LOD)."""
    if cam.cam_type in (CAM_PERSPECTIVE, CAM_ARCHITECT):
        return 1.0 / (cam.resx * max(cam.focal, 1e-6)), 0.0
    if cam.cam_type == CAM_ORTHO:
        return 0.0, cam.scale / cam.resx
    if cam.cam_type == CAM_ANGULAR:
        return (cam.angle_deg * np.pi / 180.0) / cam.resx, 0.0
    return 2.0 * np.pi / cam.resx, 0.0  # equirectangular


def project_to_camera(cam: Camera, p: torch.Tensor):
    """World points (N, 3) -> (px, py, cos_cam, dist, valid), the inverse
    of shoot_rays for the orthographic camera and the perspective family
    (the others project as perspective, as in the reference): texco
    "window" reads px / resx, py / resy, BDPT's t = 1 splats the rest."""
    dev = p.device
    right, up, fwd, org0 = (_vec(a, dev) for a in (cam.right, cam.up,
                                                  cam.fwd, cam.origin))
    aspect = cam.resy / cam.resx * cam.aspect_ratio
    v = p - org0
    dist = vmath.sqrt_rn(torch.clamp(vmath.dot(v, v), min=1e-12))
    z = vmath.dot(v, fwd)
    if cam.cam_type == CAM_ORTHO:
        x = vmath.div(vmath.dot(v, right), cam.scale)
        y = vmath.div(vmath.dot(v, up), cam.scale * aspect)
        px = (x + 0.5) * cam.resx
        py = (0.5 - y) * cam.resy
        valid = ((z > 1e-4) & (px >= 0) & (px < cam.resx) & (py >= 0)
                 & (py < cam.resy))
        return px, py, torch.ones_like(px), dist, valid
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
