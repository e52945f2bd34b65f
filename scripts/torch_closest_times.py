"""Device times of the port's two small-scene closest hits, for one tree of the
repository: `closest_hit_tiny` on every call one sample step of the Cornell
main path (512², 64 spp) makes, and `closest_hit_dense` on every call one
step of the generated 172-triangle scene (`--grid 1 --subdiv 1`, its own
settings) makes, each beside the one-thread body it replaced
(`_closest_hit_tiny_before`, `_closest_hit_dense_before`) on the same rays.

    python3 scripts/torch_closest_times.py [--repo DIR] [--label NAME]

DIR (default: the tree this script lies in) holds `chip_smoke.py` and
`libyafaray_tpu_torch/`; its kernels are built into its own build
directory, so variants of the kernels' sources, unpacked side by side
under a git-ignored directory, are timed one after another in one job:

    for d in _archive_check/a _archive_check/b; do
        python3 scripts/torch_closest_times.py --repo $d --label $d; done

Each call is held to the plain version and to the old body bit for bit
(every returned tensor) and called twice (the counts printed as
`differ_plain`, `differ_old`, `repeat`, all expected 0); times are device ms
per call (`chip_smoke.device_ms`: a CUDA graph of 20 calls between CUDA
events).  The ptxas lines of the two kernels give their registers and
spills.  Needs one NVIDIA GPU; prints one line per call.
"""
from __future__ import annotations

import argparse
import os
import re
import sys
import tempfile

import torch


def differ(a: tuple, b: tuple) -> int:
    """Rays where any tensor of a differs from its counterpart in b."""
    out = torch.zeros_like(a[0], dtype=torch.bool)
    for x, y in zip(a, b):
        out |= x != y
    return int(out.sum())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_closest_times: no CUDA device")
    sys.path.insert(0, os.path.abspath(opts.repo))
    import chip_smoke as cs
    from libyafaray_tpu_torch.ops import _build
    from libyafaray_tpu_torch.ops import cluster_intersect as cx
    from libyafaray_tpu_torch.ops import cuda_intersect as ci
    from libyafaray_tpu_torch.ops import intersect as isect
    from libyafaray_tpu_torch.scene.session import build_config
    from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

    label = opts.label or os.path.relpath(opts.repo)
    for src, kernels in (("tiny_intersect", ("closest_tiny_kernel",)),
                         ("cluster_intersect", ("closest_dense_kernel",))):
        _build.load(src)
        name = None
        with open(_build.library_path(src)[:-3] + ".log") as f:
            for line in f:
                if "Compiling entry" in line:
                    name = next((k for k in kernels if re.search(
                        k + r"(ILi\d+E)?E", line)), None)
                elif name and ("registers" in line or "spill" in line):
                    print(f"[{label}] ptxas {name}: {line.strip()}",
                          flush=True)

    def report(kernel, vertex, args, new, old, plain):
        """One call's line: new, old and plain on `args`, each answer cut
        to the tensors the plain version returns (t, tri, u, v for the
        tiny hit; t, column for the dense one)."""
        want = plain(*args)
        cut = len(want)
        got = new(*args)[:cut]
        row = dict(n=args[1].shape[0],
                   differ_plain=differ(got, want),
                   differ_old=differ(got, old(*args)[:cut]),
                   repeat=differ(got, new(*args)[:cut]),
                   ms=cs.device_ms(lambda: new(*args), calls=20),
                   ms_before=cs.device_ms(lambda: old(*args), calls=20))
        print(f"[{label}] {kernel} vertex {vertex}: {row}", flush=True)

    # the Cornell step's closest hits, recorded through intersect.closest_hit
    cscene, cfg = cs.cornell(device="cuda", **cs.MAIN)
    _, calls = cs.record_calls(isect, ("closest_hit",),
                               lambda: cs.step_calls(cscene, cfg, ci, ()))
    for vertex, (_, (arrays, static, *rays)) in enumerate(calls):
        args = (arrays["tri_pack10"], *(x.contiguous() for x in rays),
                static.n_tris_real)
        report("closest_hit_tiny", vertex, args, ci.closest_hit_tiny,
               ci._closest_hit_tiny_before,
               lambda *a: ci.closest_hit_tiny_plain(*a)[:4])
    with tempfile.TemporaryDirectory() as scenes:
        scene = parse_xml_file(cs.make_grid(scenes, 1, 1))
        _, _, calls = cs.step_calls(scene.compile(device="cuda"),
                                    build_config(scene), cx,
                                    ("closest_hit_dense",))
    for vertex, args in enumerate(calls["closest_hit_dense"]):
        pk, _, org, dirn, tmin, tmax, n_tris = args
        report("closest_hit_dense", vertex, args, cx.closest_hit_dense,
               cx._closest_hit_dense_before,
               lambda *a: cx.closest_dense_plain(pk, org, dirn, tmin, tmax,
                                                 n_tris))


if __name__ == "__main__":
    main()
