"""Which part of scenes/cornell_surfaces.xml moves the card's render off the
CPU's: the scene and variants of it (the rough glass made smooth, the
dispersion off, the prism's glass made diffuse, the cylinder's smoothing
off) rendered through render_scene on the card and on the CPU from the
same QMC stream; one JSON line a variant and integrator with the image
RMSE, the largest pixel difference and where it is, and both ray counts.

    python3 scripts/torch_surface_card_vs_cpu.py [--size 32] [--spp 4]
        [--integrators pathtracing directlighting] [--bsdf]

--bsdf instead samples the scene's dispersive glass (sample_bsdf with a
wavelength lane, half the lanes chromatic) on identical inputs on both
devices and prints, a returned field each, the lanes whose bits differ and
the largest difference, and so for wl_to_rgb and cauchy_ior.

Needs a CUDA device (the kernels build at first use).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libyafaray_tpu_torch.scene.session import render_scene  # noqa: E402
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_string  # noqa: E402

SURFACES = os.path.join(REPO, "scenes", "cornell_surfaces.xml")
VARIANTS = {
    "scene": (),
    "smooth_glass_ball": (('<type sval="rough_glass"/>',
                           '<type sval="glass"/>'),),
    "no_dispersion": (('<dispersion_power fval="2.0"/>', ""),),
    "diffuse_prism": (('<type sval="glass"/>\n    <IOR fval="1.55"/>',
                       '<type sval="shinydiffusemat"/>'),),
    "no_smoothing": (('<smooth ID="2" angle="60"/>', ""),),
}


def bsdf_lanes(smi: str, n: int = 1 << 20) -> None:
    """The dispersive glass's sample_bsdf, wl_to_rgb and cauchy_ior on the
    card and on the CPU from the same numpy-seeded inputs."""
    from libyafaray_tpu_torch.convert import to_tensors
    from libyafaray_tpu_torch.core import color
    from libyafaray_tpu_torch.materials import base as mbase
    from libyafaray_tpu_torch.materials import bsdf
    from libyafaray_tpu_torch.materials.factory import \
        material_row_from_params
    from libyafaray_tpu_torch.scene.params import ParamMap

    rng = np.random.default_rng(3)
    row = material_row_from_params(ParamMap({
        "type": "glass", "IOR": 1.55, "dispersion_power": 2.0}), {}, {}, {})
    table = mbase.build_material_table([row])
    v = rng.normal(size=(3, n, 3))
    n_, ng_, wo_ = (x / np.linalg.norm(x, axis=1, keepdims=True)
                    for x in v)
    u = rng.random((3, n)).astype(np.float32)
    wl = np.where(rng.random(n) < 0.5, -1.0, rng.random(n)).astype(
        np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        t = lambda x: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(x, np.float32)).to(dev)
        r = mbase.gather_rows(to_tensors(table, dev),
                              torch.zeros(n, dtype=torch.long, device=dev))
        smp = bsdf.sample_bsdf(r, t(n_), t(ng_), t(wo_), t(u[0]), t(u[1]),
                               t(u[2]), (mbase.MT_GLASS,), t(wl))
        w = t(u[0])
        a, b = color.cauchy_coefficients(r["ior"], r["dispersion_power"])
        smp["wl_to_rgb"] = color.wl_to_rgb(w)
        smp["cauchy_ior"] = color.cauchy_ior(a, b, w)
        out[dev] = {k: x.cpu().numpy() for k, x in smp.items()}
    for k in out["cpu"]:
        g, c = out["cuda"][k], out["cpu"][k]
        bad = (g != c).reshape(n, -1).any(axis=1)
        diff = (float(np.abs(g.astype(np.float64) - c).max())
                if g.dtype != np.bool_ else int(bad.sum()))
        print(json.dumps(dict(field=k, lanes=n, lanes_differ=int(bad.sum()),
                              max_diff=diff, gpu=smi)), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--integrators", nargs="+",
                    default=["pathtracing", "directlighting"])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    ap.add_argument("--bsdf", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_surface_card_vs_cpu: no CUDA device")
    os.chdir(REPO)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.bsdf:
        bsdf_lanes(smi)
        return
    with open(SURFACES) as f:
        base = f.read()
    for name in args.variants:
        text = base
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} not in the scene")
            text = text.replace(old, new)
        for integ in args.integrators:
            out = {}
            for dev in ("cuda", "cpu"):
                s = parse_xml_string(text)
                s.render_params.update(width=args.size, height=args.size,
                                       AA_minsamples=args.spp)
                s.integrator_params["default"]["type"] = integ
                out[dev] = render_scene(s, device=dev)
            d = np.abs(out["cuda"].image - out["cpu"].image).max(axis=-1)
            worst = np.unravel_index(int(np.argmax(d)), d.shape)
            print(json.dumps(dict(
                variant=name, integrator=integ,
                size=args.size, spp=args.spp,
                rmse=float(np.sqrt(np.mean(
                    (out["cuda"].image - out["cpu"].image) ** 2))),
                max_pixel_diff=float(d.max()),
                worst_pixel=[int(x) for x in worst],
                pixels_over_1e3=int((d > 1e-3).sum()),
                rays_gpu=out["cuda"].stats["rays"],
                rays_cpu=out["cpu"].stats["rays"], gpu=smi)), flush=True)


if __name__ == "__main__":
    main()
