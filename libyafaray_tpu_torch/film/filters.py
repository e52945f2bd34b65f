"""Reconstruction filters (port of libyafaray_tpu/film/filters.py: the box
filter; mitchell, gauss and lanczos raise until ROADMAP Queue 1 item 17)."""
from __future__ import annotations

import math

import torch


def _check(filter_type: str) -> None:
    if filter_type != "box":
        raise NotImplementedError(
            f"filter {filter_type!r} is not ported yet: ROADMAP Queue 1 "
            "item 17")


def filter_radius(filter_type: str, pixel_width: float) -> int:
    """Static neighbor-offset radius needed to cover the filter support."""
    _check(filter_type)
    return 0 if pixel_width <= 1.0 else int(math.ceil((pixel_width - 1.0)
                                                       / 2.0))


def eval_filter_1d(filter_type: str, x: torch.Tensor,
                   pixel_width: float) -> torch.Tensor:
    """Filter weight at distance x (pixels) from the sample; support
    |x| <= pixel_width/2 (unnormalized; the film divides by the weight
    sum)."""
    _check(filter_type)
    return torch.where(x.abs() <= pixel_width * 0.5, 1.0, 0.0)


def eval_filter_2d(filter_type: str, dx: torch.Tensor, dy: torch.Tensor,
                   pixel_width: float) -> torch.Tensor:
    return eval_filter_1d(filter_type, dx, pixel_width) * eval_filter_1d(
        filter_type, dy, pixel_width)
