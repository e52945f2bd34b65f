"""Host-side (numpy) mirror of the per-material shadow filter, used at scene
compile (port of libyafaray_tpu/materials/host.py)."""
from __future__ import annotations

import numpy as np

from .base import MT_GLASS, MT_NULL, MT_ROUGH_GLASS, MT_SHINYDIFFUSE


def shadow_filter_np(mats: dict) -> np.ndarray:
    """(M, 3) transmission filter of each material; 0 = opaque."""
    mtype = np.asarray(mats["mtype"])
    m = len(mtype)
    out = np.zeros((m, 3), np.float32)

    # shinydiffuse: transparency share of the energy split at normal
    # incidence (cos=1 => fresnel kr at normal incidence when enabled)
    ior = np.maximum(np.asarray(mats["ior"], np.float64), 1.0 + 1e-5)
    kr0 = ((ior - 1.0) / (ior + 1.0)) ** 2
    kr = np.where(np.asarray(mats["fresnel_effect"]), kr0, 1.0)
    acc = 1.0 - np.asarray(mats["specular_reflect"], np.float64) * kr
    w_t = np.asarray(mats["transparency"], np.float64) * acc
    shiny = mtype == MT_SHINYDIFFUSE
    out[shiny] = (w_t[shiny, None]
                  * np.asarray(mats["filter_color"], np.float64)[shiny])

    glass = (mtype == MT_GLASS) | (mtype == MT_ROUGH_GLASS)
    fake = np.asarray(mats["fake_shadows"])
    out[glass & fake] = np.asarray(mats["filter_color"])[glass & fake]

    out[mtype == MT_NULL] = 1.0
    return np.clip(out, 0.0, 1.0).astype(np.float32)
