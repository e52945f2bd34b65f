"""Backgrounds (port of libyafaray_tpu/backgrounds/base.py: the spec record
and the none/constant branches of `eval_background`)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

BG_NONE = -1
BG_CONSTANT = 0
BG_GRADIENT = 1
BG_TEXTURE = 2
BG_SUNSKY = 3
BG_DARKSKY = 4


@dataclass(frozen=True)
class BackgroundSpec:
    bg_type: int = BG_NONE
    power: float = 1.0
    color: tuple = (0.0, 0.0, 0.0)
    horizon_color: tuple = (0.0, 0.0, 0.0)
    zenith_color: tuple = (0.0, 0.0, 0.0)
    horizon_ground_color: tuple = (0.0, 0.0, 0.0)
    zenith_ground_color: tuple = (0.0, 0.0, 0.0)
    mapping: str = "sphere"
    rotation: float = 0.0
    ibl: bool = False
    ibl_samples: int = 16
    ibl_blur: float = 0.0
    with_caustic: bool = True
    with_diffuse: bool = True


def check_supported(spec: BackgroundSpec) -> None:
    if spec.bg_type not in (BG_NONE, BG_CONSTANT):
        raise NotImplementedError(
            f"background type {spec.bg_type} is not ported yet: ROADMAP "
            "Queue 1 items 15 and 17")
    if spec.ibl:
        raise NotImplementedError(
            "background IBL lighting is not ported yet: ROADMAP Queue 1 "
            "item 15")


def eval_background(spec: BackgroundSpec, d: torch.Tensor) -> torch.Tensor:
    """Radiance of escaping rays with direction d (N,3)."""
    check_supported(spec)
    if spec.bg_type == BG_NONE:
        return torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32,
                           device=d.device)
    c = torch.tensor(spec.color, dtype=torch.float32, device=d.device) \
        * spec.power
    return c.expand(d.shape[:-1] + (3,))
