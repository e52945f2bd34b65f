"""Vector math over stacked SoA tensors whose trailing axis is 3 (xyz).

Port of libyafaray_tpu/core/math.py, restricted to what the ported slices
call.
Sums over xyz are written out in x, y, z order so the float32 rounding
follows the reference's sequential reduction.
"""
from __future__ import annotations

import torch


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s as a true float32 division (a Python-scalar divisor may become
    a multiply by its reciprocal on the GPU)."""
    return x / torch.full((), float(s), dtype=x.dtype, device=x.device)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded to nearest, as IEEE (and XLA, and the
    card) computes it: torch's vectorised CPU kernel is only within ~0.5
    ulp, which a cone's 1 - cos_max or a spot's falloff amplifies.  On the
    CPU it goes through float64 (whose square root, rounded once more to
    float32, is the correctly rounded float32 one)."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def cos_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 cosine through float64 on every device: the card's and the
    CPU's float32 cos differ in the last bit on some inputs, and a sampled
    direction that a glass prism refracts several times carries that
    into another path."""
    return torch.cos(x.double()).float()


def sin_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 sine through float64 on every device (see cos_rn)."""
    return torch.sin(x.double()).float()


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3-vector dot product -> (...,) scalar."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length(v: torch.Tensor) -> torch.Tensor:
    return sqrt_rn(torch.clamp(dot(v, v), min=0.0))


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(length(v)[..., None], min=1e-20)


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror of the away-from-surface direction d about n: 2(n·d)n - d."""
    return 2.0 * dot(n, d)[..., None] * n - d


def refract(wo: torch.Tensor, n: torch.Tensor, eta: torch.Tensor):
    """Refract wo (away from the surface) through n with the relative IOR
    eta (N,) of the side wo lies on.  Returns (wi, valid); valid is False
    under total internal reflection."""
    cos_i = dot(n, wo)
    inv_eta = torch.ones_like(eta) / eta
    sin2_t = inv_eta * inv_eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    valid = sin2_t < 1.0
    cos_t = sqrt_rn(torch.clamp(1.0 - sin2_t, min=0.0))
    wi = -inv_eta[..., None] * wo + (inv_eta * cos_i - cos_t)[..., None] * n
    return normalize(wi), valid


def refract_unit_eta(wo: torch.Tensor, n: torch.Tensor):
    """`refract(wo, n, eta)` of the reference at eta = 1 (the null
    material's pass-through).  Returns (wi, valid)."""
    cos_i = dot(n, wo)
    sin2_t = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    valid = sin2_t < 1.0
    cos_t = sqrt_rn(torch.clamp(1.0 - sin2_t, min=0.0))
    wi = -wo + (cos_i - cos_t)[..., None] * n
    return normalize(wi), valid


def fresnel_dielectric(cos_i: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """Unpolarized Fresnel reflectance for a dielectric (1.0 under TIR)."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = (1.0 / (eta * eta)) * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t >= 1.0
    cos_t = sqrt_rn(torch.clamp(1.0 - sin2_t, min=0.0))
    r_par = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-12)
    r_perp = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t,
                                                 min=1e-12)
    kr = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, 1.0, torch.clamp(kr, 0.0, 1.0))


def build_onb(n: torch.Tensor):
    """Orthonormal basis from a unit normal (branchless Duff/Frisvad 2017).
    Returns (u, v) with (u, v, n) right-handed."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    u = torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=-1)
    v = torch.stack([b, s + ny * ny * a, -ny], dim=-1)
    return u, v


def to_local(u: torch.Tensor, v: torch.Tensor, n: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """World direction -> components in the frame (x=u, y=v, z=n)."""
    return torch.stack([dot(w, u), dot(w, v), dot(w, n)], dim=-1)


def from_local(u: torch.Tensor, v: torch.Tensor, n: torch.Tensor,
               wl: torch.Tensor) -> torch.Tensor:
    return wl[..., 0:1] * u + wl[..., 1:2] * v + wl[..., 2:3] * n


def face_forward(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Flip n to lie in the hemisphere of d."""
    return torch.where(dot(n, d)[..., None] < 0.0, -n, n)
