"""The ablation of the port's threaded-BVH walks (csrc/bvh_walk.cu): each of
their parts added one at a time, timed on the same recorded rays.

On the generated 2,621,452-triangle grid (`chip_smoke.bvh_scene`) one 512²
sample step is run with `closest_hit_bvh` and `shadow_logsum_bvh` recording
their arguments; on each of the step's four batches (the primary and
bounce-1 closest hits, the bounce-0 and bounce-1 NEE shadow sums) the walk
runs by the body it replaced (`_<name>_before`, step 0) and by steps 1-7
of scripts/bvh_ablation.cu: the node records alone; + leaf-ordered
triangle rows; step 2 on the rays sorted by direction octant and the
Morton code of the origin (the key, the sort and the gather inside the
timed call); step 2 + unrolled leaf tests; + while-while; + persistent
warps; + wide L2 fetches (the port's body).  Every step's answers are held
bit for bit to step 0's.  Times are device ms a call
(`chip_smoke.device_ms`: a CUDA graph of 5 calls between CUDA events), in
two turns on the same rays, steps 0-7 and then 7-0.  A last line weights
the batches by their calls a step (primary 1, bounce 1 x bounces,
bounce-0 NEE 1, bounce-1 NEE x bounces) for a step's walk ms by step.

    python3 scripts/torch_bvh_ablation.py

Needs one NVIDIA GPU and nvcc; scripts/bvh_ablation.cu is built at first
use into the package's build directory.  Prints one line per batch, the
step line and the card's `nvidia-smi` name and power limit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import statistics
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "scripts", "bvh_ablation.cu")
STEPS = ("first body", "nodes", "+ leaf rows", "+ ray sort",
         "+ unrolled leaf", "+ while-while", "+ persistent warps",
         "+ wide L2 fetches")
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(_build) -> ctypes.CDLL:
    """scripts/bvh_ablation.cu built with the port's nvcc flags (its
    library keyed on the source, the shared header and the flags)."""
    header = os.path.join(_build.CSRC, "column_walk.cuh")
    key = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for path in (SRC, header):
        with open(path, "rb") as f:
            key.update(f.read())
    out = os.path.join(_build.BUILD_DIR,
                       f"libbvh_ablation_{key.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o",
               out, SRC]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n"
                               f"{' '.join(cmd)}\n{r.stderr}")
    lib = ctypes.CDLL(out)
    lib.bvh_ray_key_launch.argtypes = [_P] * 3 + [_I] + [_P] * 2
    lib.bvh_ablation_launch.argtypes = ([_I] * 2 + [_P] * 11 + [_I]
                                        + [_P] * 6)
    lib.bvh_ray_key_launch.restype = lib.bvh_ablation_launch.restype = _I
    return lib


def step_call(lib, bt, kind: str, step: int, args: tuple, by_tri):
    """A call of step 1-7 of the walk `kind` on a recorded call's `args`
    (by_tri: the shadow walk's lf4 in the triangles' order, for step 1)."""
    if kind == "closest":
        bvh, tri9, org, dirn, tmin, tmax = args
        lf4 = leaf = None
    else:
        bvh, tri9, leaf, org, dirn, tmax = args
        tmin, lf4 = None, by_tri
    dev, n = org.device, org.shape[0]

    def ptr(x):
        return 0 if x is None else x.data_ptr()

    def call():
        stream = torch.cuda.current_stream(dev).cuda_stream
        out = (bt._closest_out if kind == "closest" else bt._shadow_out)(
            n, dev)
        perm = None
        if step == 3:
            key = torch.empty((n,), dtype=torch.int32, device=dev)
            code = lib.bvh_ray_key_launch(bvh["nodes"].data_ptr(),
                                          org.data_ptr(), dirn.data_ptr(), n,
                                          key.data_ptr(), stream)
            if code:
                raise RuntimeError(f"bvh_ray_key_launch: CUDA error {code}")
            perm = torch.sort(key, stable=True).indices
        counter = torch.empty((1,), dtype=torch.int32, device=dev)
        outs = [x.data_ptr() for x in out] + [0] * (4 - len(out))
        code = lib.bvh_ablation_launch(
            0 if kind == "closest" else 1, step,
            *(ptr(x) for x in (bvh["nodes"], bvh["tris"], bvh["tri_order"],
                               tri9, lf4, leaf, org, dirn, tmin, tmax,
                               perm)), n, *outs, counter.data_ptr(), stream)
        if code:
            raise RuntimeError(f"bvh_ablation_launch({kind}, {step}): CUDA "
                               f"error {code}")
        return out

    return call


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_bvh_ablation: no CUDA device")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from libyafaray_tpu_torch.ops import _build
    from libyafaray_tpu_torch.ops import bvh_traverse as bt

    os.chdir(REPO)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lib = build(_build)
    with tempfile.TemporaryDirectory() as scenes:
        _, cfg, cscene, _ = cs.bvh_scene(smi, scenes)
        _, _, calls = cs.step_calls(cscene, cfg, bt, cs.BVH)
    batches = ((cs.BVH[0], 0, "primary"), (cs.BVH[0], 1, "bounce 1"),
               (cs.BVH[1], 0, "bounce-0 NEE"), (cs.BVH[1], 1, "bounce-1 NEE"))
    mean_ms = {}
    for name, k, rays in batches:
        kind = "closest" if name == cs.BVH[0] else "shadow"
        args = calls[name][k]
        old = cs.before_args(name, args)
        before = getattr(bt, f"_{name}_before")
        fns = [lambda: before(*old)] + [
            step_call(lib, bt, kind, s, args,
                      old[2] if kind == "shadow" else None)
            for s in range(1, len(STEPS))]
        ref = fns[0]()
        differ = [cs.ray_differ(fn(), ref) for fn in fns[1:]]
        ms = [[], []]
        for turn, order in enumerate((fns, fns[::-1])):
            for fn in order:
                ms[turn].append(round(cs.device_ms(fn, calls=5, replays=3),
                                      4))
        ms[1].reverse()
        cs.phase("bvh_ablation", kind=kind, rays=rays,
                 n=args[2 if kind == "closest" else 3].shape[0],
                 steps=STEPS, ms_turn1=ms[0], ms_turn2=ms[1],
                 differ_vs_first_body=differ, gpu=repr(smi))
        if any(differ):
            raise AssertionError(f"bvh_ablation ({kind}, {rays}): steps "
                                 f"differ from the first body: {differ}")
        mean_ms[(name, k)] = [statistics.mean(t) for t in zip(*ms)]
    weight = {(cs.BVH[0], 0): 1, (cs.BVH[0], 1): cfg.bounces,
              (cs.BVH[1], 0): 1, (cs.BVH[1], 1): cfg.bounces}
    cs.phase("bvh_ablation_step", steps=STEPS,
             step_ms=[round(sum(w * mean_ms[key][j]
                                for key, w in weight.items()), 4)
                      for j in range(len(STEPS))],
             weights="primary 1, bounce 1 x bounces, bounce-0 NEE 1, "
             "bounce-1 NEE x bounces; the mean of the two turns")
    print(smi, flush=True)


if __name__ == "__main__":
    main()
