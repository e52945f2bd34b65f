"""ctypes loader for the C++ BVH builder (accel/cpp/bvh_builder.cpp; port
of libyafaray_tpu/accel/native.py).

The library is built with g++ at first use into the package's `_build/`
directory (ops/_build.py `load_host`, keyed on the source's hash).  When
g++ is missing or fails, `build_bvh_native` returns None with a warning and
accel/bvh.py takes its numpy builder, which gives the same arrays but
takes minutes for millions of triangles.
"""
from __future__ import annotations

import ctypes
import logging
import os

import numpy as np

from ..ops import _build

log = logging.getLogger("libyafaray_tpu_torch")

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp",
                   "bvh_builder.cpp")
_SIGNATURES = {"lyt_build_bvh": (ctypes.c_int, [
    ctypes.POINTER(ctypes.c_float)] * 3 + [ctypes.c_int] + [
    ctypes.POINTER(ctypes.c_float)] * 2 + [ctypes.POINTER(ctypes.c_int)] * 5)}


def build_bvh_native(v0: np.ndarray, e1: np.ndarray,
                     e2: np.ndarray) -> dict | None:
    """Same output dict as accel.bvh.build_bvh, or None if unavailable."""
    try:
        lib = _build.load_host(SRC, _SIGNATURES)
    except Exception as e:  # noqa: BLE001 — the numpy builder follows
        log.warning("native BVH builder unavailable (%s); numpy fallback", e)
        return None
    t = v0.shape[0]
    v0 = np.ascontiguousarray(v0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    cap = 2 * t
    bb_min = np.empty((cap, 3), np.float32)
    bb_max = np.empty((cap, 3), np.float32)
    hit_next = np.empty(cap, np.int32)
    miss_next = np.empty(cap, np.int32)
    first_tri = np.empty(cap, np.int32)
    tri_count = np.empty(cap, np.int32)
    tri_order = np.empty(t, np.int32)

    def p_f(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def p_i(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))

    n_nodes = lib.lyt_build_bvh(
        p_f(v0), p_f(e1), p_f(e2), t,
        p_f(bb_min), p_f(bb_max), p_i(hit_next), p_i(miss_next),
        p_i(first_tri), p_i(tri_count), p_i(tri_order),
    )
    if n_nodes <= 0:
        return None
    return dict(
        bb_min=bb_min[:n_nodes], bb_max=bb_max[:n_nodes],
        hit_next=hit_next[:n_nodes], miss_next=miss_next[:n_nodes],
        first_tri=first_tri[:n_nodes], tri_count=tri_count[:n_nodes],
        tri_order=tri_order,
    )
