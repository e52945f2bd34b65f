"""Build and load the port's native libraries (plain-C-ABI .so -> ctypes):
the CUDA kernels of `csrc/` with nvcc, and the host helpers (the BVH
builder `accel/cpp/bvh_builder.cpp`, the EXR Huffman coder
`io/cpp/exr_huf.cpp`) with g++.

A library is built at first use into `libyafaray_tpu_torch/_build/`, keyed
on a hash of its source (with the shared headers for a kernel) and the
flags, so a fresh checkout builds it on the first call and later calls in
the process reuse the loaded library.
Only the package's own sources are compiled; nothing is fetched.
A failed nvcc build raises with nvcc's stderr; a failed g++ build raises
too, and the host helpers' loaders decide what to do without them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# the csrc/ sources with kernels a render may launch
CUDA_SOURCES = ("tiny_intersect", "fine_intersect", "photon_flash",
                "cluster_intersect", "pairs_intersect", "bvh_walk")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_failed: dict[str, Exception] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def library_path(name: str) -> str:
    """Path of the built library for csrc/<name>.cu at its current source
    (the shared headers csrc/*.cuh included)."""
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for src in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC, src), "rb") as f:
            key.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{key.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless the keyed library exists; returns its
    path.  The ptxas report (registers, shared memory, spills) is kept
    beside it in a .log file."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({r.returncode}) building {name}.cu:\n"
            f"{' '.join(cmd)}\n{r.stderr}")
    with open(out[:-3] + ".log", "w") as f:
        f.write(r.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; cached per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib


def host_library_path(src: str) -> str:
    """Path of the built library for the C++ source `src` (absolute) at
    its current contents."""
    key = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(src, "rb") as f:
        key.update(f.read())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{name}_{key.hexdigest()[:16]}.so")


def load_host(src: str, signatures: dict) -> ctypes.CDLL:
    """Build `src` with g++ unless its keyed library exists, load it and
    give its functions their {name: (restype, argtypes)} `signatures`;
    cached per process.  Raises when g++ is missing or fails, and raises
    the same error again on later calls without building again."""
    with _lock:
        lib = _loaded.get(src)
        if lib is not None:
            return lib
        if src in _failed:
            raise _failed[src]
        try:
            lib = ctypes.CDLL(_build_host(src))
        except Exception as e:
            _failed[src] = e
            raise
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[src] = lib
        return lib


def _build_host(src: str) -> str:
    out = host_library_path(src)
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [gxx, *GXX_FLAGS, "-o", tmp, src]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed ({r.returncode}):\n"
                           f"{' '.join(cmd)}\n{r.stderr}")
    os.replace(tmp, out)
    return out
