"""Kernel launches and device-busy milliseconds of one sample step of the
PyTorch port's Cornell main path (scenes/cornell.xml as pathtracing,
bounces 4, RR from 2) and IBL path (scenes/ibl_spheres.xml at its own
settings), 512², read from torch.profiler over one step after an
unprofiled one.  --repo runs the package of another checkout (unpacked
with `git archive`), so two trees compare in turns inside one call:

    for t in parent repo repo parent; do
        python3 scripts/torch_step_launches.py --repo $t; done

Needs a card; prints one JSON line a path and the card's name and power
limit as nvidia-smi gives them.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def step_launches(step, arrays, film, flags) -> dict:
    """One unprofiled step, then one profiled: launches (kernels, copies
    and memsets left out) and the union of the device intervals."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    film = step(arrays, film, flags)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(arrays, film, flags)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b, _ in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return dict(launches=sum(not n.startswith(("Memcpy", "Memset"))
                             for _, _, n in spans),
                busy_ms=busy / 1e3)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE,
                    help="checkout whose libyafaray_tpu_torch runs")
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args(argv)
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    os.chdir(repo)  # the scenes' assets are named from the checkout root
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_step_launches: no CUDA device")
    from libyafaray_tpu_torch.convert import to_tensors
    from libyafaray_tpu_torch.integrators import engine
    from libyafaray_tpu_torch.integrators.config import RenderConfig
    from libyafaray_tpu_torch.integrators.render import _fresh_film
    from libyafaray_tpu_torch.ops import _build
    from libyafaray_tpu_torch.scene.session import build_config
    from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

    _build.load("tiny_intersect")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = engine.resolve_device("cuda")
    for name, path, over in (
            ("cornell", "scenes/cornell.xml",
             dict(integrator="pathtracing", bounces=4, rr_min_bounces=2)),
            ("ibl", "scenes/ibl_spheres.xml", {})):
        scene = parse_xml_file(path)
        scene.render_params["width"] = args.size
        scene.render_params["height"] = args.size
        cfg = RenderConfig(**{**build_config(scene).__dict__, **over,
                              "width": args.size, "height": args.size})
        cs = scene.compile(device="cuda")
        step = engine.make_sample_step(cs.static, cs.camera, cfg, dev)
        flags = torch.ones((args.size, args.size), dtype=torch.bool,
                           device=dev)
        out = step_launches(step, to_tensors(cs.arrays, dev),
                            _fresh_film(cfg, dev), flags)
        print(json.dumps(dict(repo=os.path.basename(repo), path=name,
                              size=args.size, **out, gpu=smi)), flush=True)


if __name__ == "__main__":
    main()
