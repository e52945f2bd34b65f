"""Count the aten ops one sample step of the PyTorch port dispatches with
each group of film planes (alpha, reflect / refract, AO, ...) on top of the
plain film: where the film layer's added launches come from.

    python scripts/torch_film_ops.py [--scene scenes/ibl_passes.xml]
        [--size 16] [--device cpu]

Views (view, reshape, slice, select, expand, ...) launch nothing and are
not counted.  On the CPU the counts are dispatches, not device launches:
a kernel wrapper's plain version there dispatches many ops where the card
launches one kernel, so read the card's totals in chip_smoke.py's
[passes_profile].
"""
from __future__ import annotations

import argparse
import collections
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from libyafaray_tpu_torch.convert import to_tensors  # noqa: E402
from libyafaray_tpu_torch.film.passes import film_add_passes  # noqa: E402
from libyafaray_tpu_torch.integrators import engine  # noqa: E402
from libyafaray_tpu_torch.integrators.render import _fresh_film  # noqa: E402
from libyafaray_tpu_torch.scene.session import build_config  # noqa: E402
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file  # noqa: E402

VIEWS = {"aten.view", "aten._unsafe_view", "aten.unsqueeze", "aten.slice",
         "aten.select", "aten.expand", "aten.detach", "aten.alias",
         "aten.t", "aten.transpose", "aten.permute", "aten.squeeze",
         "aten.as_strided", "aten.lift_fresh", "aten.reshape"}
GROUPS = (("reflect", "refract"), ("ao",), ("shadow",),
          ("debug-nu", "debug-nv"), ("debug-dpdu", "debug-dpdv"),
          ("direct", "emit"), ("z-depth-abs", "uv", "normal-smooth",
                               "normal-geom", "mat-index-abs",
                               "obj-index-abs", "diffuse-color"))


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func.overloadpacket) not in VIEWS:
            self.ops += 1
        return func(*args, **(kwargs or {}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="scenes/ibl_passes.xml")
    ap.add_argument("--size", type=int, default=16)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    dev = engine.resolve_device(args.device)
    s = parse_xml_file(args.scene)
    s.render_params.update(width=args.size, height=args.size)
    cfg = build_config(s)
    cs = s.compile(device=dev)
    arrays = to_tensors(cs.arrays, dev)
    step = engine.make_sample_step(cs.static, cs.camera, cfg, dev)
    flags = torch.ones((args.size, args.size), dtype=torch.bool, device=dev)
    h = w = args.size
    films = collections.OrderedDict(
        plain=lambda: _fresh_film(cfg, dev),
        alpha=lambda: _fresh_film(cfg, dev, with_alpha=True),
        all=lambda: film_add_passes(_fresh_film(cfg, dev, with_alpha=True),
                                    h, w, cfg.passes, dev))
    for grp in GROUPS:
        films["+".join(grp)] = (lambda g=grp: film_add_passes(
            _fresh_film(cfg, dev), h, w, g, dev))
    base = None
    for name, make in films.items():
        film = step(arrays, make(), flags)
        with Count() as c:
            step(arrays, film, flags)
        base = c.ops if base is None else base
        print(f"{name:80s} ops {c.ops:6d} added {c.ops - base:5d}",
              flush=True)


if __name__ == "__main__":
    main()
