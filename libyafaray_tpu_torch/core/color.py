"""Color helpers (port of libyafaray_tpu/core/color.py: luminance and the
spectral dispersion helpers of a glass's `dispersion_power`)."""
from __future__ import annotations

import torch

from .math import div

# mean over a uniform wavelength parameter of each wl_to_rgb lobe sum
_WL_NORM = (0.29477, 0.26832, 0.19696)


def luminance(c: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance of linear RGB (..., 3)."""
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


def wl_to_rgb(w: torch.Tensor) -> torch.Tensor:
    """Wavelength parameter w in [0, 1] (380..780 nm, linear) -> a linear
    RGB weight (..., 3): Gaussian lobes of a CIE-like response, each
    channel normalised to a mean of ~1 over w."""
    nm = 380.0 + 400.0 * w

    def lobe(mu, sig):
        # exp through float64, so the card and the CPU round the weight
        # alike (their float32 exp differs in the last bit on ~half of
        # the lanes, and a drawn lane carries the weight to its end)
        t = div(nm - mu, sig)
        return torch.exp((-0.5 * (t * t)).double()).float()

    r = 1.065 * lobe(600.0, 38.0) + 0.30 * lobe(445.0, 22.0)
    g = 1.020 * lobe(548.0, 42.0)
    b = 1.130 * lobe(450.0, 28.0)
    return torch.stack([r, g, b], dim=-1) / torch.tensor(
        _WL_NORM, dtype=torch.float32, device=w.device)


def cauchy_coefficients(ior, dispersion_power):
    """Cauchy n(λ) = A + B/λ² (λ in micrometres) from a base IOR and the
    `dispersion_power` knob: B = dispersion_power / 100, A such that
    n(589 nm) = ior."""
    b = dispersion_power * 0.01
    a = ior - div(b, 0.589 ** 2)
    return a, b


def cauchy_ior(a, b, w: torch.Tensor) -> torch.Tensor:
    """IOR at the wavelength parameter w in [0, 1] (380..780 nm)."""
    lam = (380.0 + 400.0 * w) * 1e-3  # micrometres
    return a + b / (lam * lam)
