"""Color helpers (port of libyafaray_tpu/core/color.py, restricted to what
slice 1 calls)."""
from __future__ import annotations

import torch


def luminance(c: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance of linear RGB (..., 3)."""
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722
