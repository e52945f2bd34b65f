"""Image comparison tool (port of libyafaray_tpu/cli/compare.py): the RMSE
gate of BASELINE.md, in linear RGB.

    python -m libyafaray_tpu_torch.cli.compare a.exr b.exr [--threshold T]

Prints one JSON line (rmse, threshold, pass, max_abs) and exits 0 when the
RMSE is within the threshold, 1 when it is not, 2 when the shapes differ.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean((a.astype(np.float64)
                                  - b.astype(np.float64)) ** 2)))


def load_linear(path: str) -> np.ndarray:
    from ..io.image import load_image

    img = load_image(path)  # decodes sRGB -> linear for 8-bit formats
    return np.asarray(img[..., :3], np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="lyt-compare")
    ap.add_argument("image_a")
    ap.add_argument("image_b")
    ap.add_argument("--threshold", type=float, default=1e-3)
    args = ap.parse_args(argv)
    a = load_linear(args.image_a)
    b = load_linear(args.image_b)
    if a.shape != b.shape:
        print(json.dumps({"error": f"shape mismatch {a.shape} vs {b.shape}"}))
        return 2
    r = rmse(a, b)
    print(json.dumps({
        "rmse": r, "threshold": args.threshold,
        "pass": bool(r <= args.threshold),
        "max_abs": float(np.abs(a.astype(np.float64) - b).max()),
    }))
    return 0 if r <= args.threshold else 1


if __name__ == "__main__":
    sys.exit(main())
