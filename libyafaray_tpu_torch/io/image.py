"""Image output (port of libyafaray_tpu/io/image.py `save_image`): .exr
through io/exr.py's writer, .hdr through io/rgbe.py, and 8-bit formats
(PNG, JPEG, TGA, TIFF) through Pillow, imported at use, after the film's
output transform (sRGB, or a manual gamma, then clipped to [0, 1])."""
from __future__ import annotations

import os

import numpy as np


def _linear_to_srgb(c):
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.0031308, c * 12.92,
                    1.055 * np.maximum(c, 1e-8) ** (1.0 / 2.4) - 0.055)


def save_image(path: str, img: np.ndarray, color_space: str = "sRGB",
               gamma: float = 1.0, alpha: np.ndarray | None = None) -> None:
    """img: (H, W, 3) LINEAR float32; the format follows the extension.
    EXR and HDR keep the linear values; 8-bit formats take the color
    space's transform and `alpha` (H, W) as a fourth channel."""
    img = np.asarray(img, np.float32)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        from .rgbe import write_hdr

        write_hdr(path, img)
        return
    if ext == ".exr":
        from .exr import write_exr

        write_exr(path, img)
        return

    cs = (color_space or "sRGB").lower()
    if cs == "srgb":
        out = _linear_to_srgb(img)
    elif cs in ("raw_manual_gamma", "raw") and gamma != 1.0:
        out = np.clip(img, 0.0, 1.0) ** (1.0 / gamma)
    else:
        out = np.clip(img, 0.0, 1.0)
    u8 = (np.clip(out, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if alpha is not None:
        a8 = (np.clip(alpha, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        u8 = np.concatenate([u8, a8[..., None]], axis=-1)

    from PIL import Image

    Image.fromarray(u8).save(path)
