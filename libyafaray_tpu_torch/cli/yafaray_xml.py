"""yafaray-xml compatible CLI of the port (counterpart of
libyafaray_tpu/cli/yafaray_xml.py, reference src/xml_loader/yafaray_xml.cc).

    python -m libyafaray_tpu_torch.cli.yafaray_xml scene.xml out.exr \\
        --json-stats [--device cpu]

It parses the scene, renders it through `scene/session.py` `render_scene`
on `--device` (default the card) with the scene's integrator
(pathtracing, directlighting, photonmapping, SPPM, bidirectional, or the
DebugIntegrator's normals image) and writes the image; `--json-stats`
prints one JSON line (output, wall_s, render_s, rays, mrays_per_sec).
With render passes (`render_passes`, or `-z` for z-depth-norm) an .exr
output is one multilayer file (the combined image, an `alpha` layer with
bg_transp, a layer a pass); any other format writes the image (RGBA with
an alpha plane, premultiplied under `premult`) and a `<base>.<pass><ext>`
file a pass.  `--film PATH` saves / resumes the film as the scene's
`film_save_load` and autosave parameters ask.

Several devices: `--devices N` starts N local ranks (one process a device,
`scene/session.py` `render_scene`); under torchrun (RANK / WORLD_SIZE in
the environment) every process joins one group and renders its band of
the film rows.  Only rank 0 writes the image, the pass files, the logs
and the `--json-stats` line (and, through the render, the film file).

    torchrun --nproc-per-node 2 -m libyafaray_tpu_torch.cli.yafaray_xml \
        scene.xml out.exr
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="yafaray-xml-torch",
        description="PyTorch + CUDA renderer with libYafaRay scene "
                    "compatibility (every surface integrator of the "
                    "reference: pathtracing, directlighting, photonmapping, "
                    "SPPM, bidirectional, DebugIntegrator)")
    ap.add_argument("input", help="scene XML file")
    ap.add_argument("output", nargs="?", default=None,
                    help="output image (default: <input>.png)")
    ap.add_argument("-f", "--format", default=None,
                    help="output format override (png/jpg/tga/tif/exr/hdr)")
    ap.add_argument("-t", "--threads", type=int, default=-1,
                    help="accepted for CLI parity (the device does the work)")
    ap.add_argument("-vl", "--verbosity", default="info",
                    help="console verbosity: mute|error|warning|info|debug")
    ap.add_argument("-z", "--z-channel", action="store_true",
                    help="enable the z-buffer pass (z-depth-norm)")
    ap.add_argument("--film", default=None,
                    help="film save/load path for resume")
    ap.add_argument("--badge", action="store_true",
                    help="draw the parameter badge into the output image")
    ap.add_argument("--logs", action="store_true",
                    help="export render log as .txt and .html next to "
                         "the output")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the render to DIR")
    ap.add_argument("--json-stats", action="store_true",
                    help="print one-line JSON render stats")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="devices to render on, one local rank each "
                         "(default: every visible card; on the CPU one); "
                         "lowered to a divisor of the height")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="accepted for CLI parity and has no effect: the "
                         "port compiles no XLA programs (its CUDA kernels "
                         "are built once into the package's _build/)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda; cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    level = dict(mute=logging.CRITICAL, error=logging.ERROR,
                 warning=logging.WARNING, info=logging.INFO,
                 debug=logging.DEBUG).get(args.verbosity, logging.INFO)
    logging.basicConfig(level=level, format="[%(levelname)s] %(message)s")
    log = logging.getLogger("libyafaray_tpu_torch")

    from ..io.image import save_image, save_multilayer_exr
    from ..parallel.distributed import init_distributed
    from ..scene.session import render_scene
    from ..scene.xml_parser import parse_xml_file
    from ..utils.observability import RenderLog

    t0 = time.perf_counter()
    if not os.path.isfile(args.input):
        print(f"yafaray-xml-torch: error: scene file not found: "
              f"{args.input}", file=sys.stderr)
        return 2
    try:
        scene = parse_xml_file(args.input)
    except Exception as e:  # noqa: BLE001 - CLI boundary
        print(f"yafaray-xml-torch: error: cannot parse {args.input}: {e}",
              file=sys.stderr)
        return 2
    if args.width:
        scene.render_params["width"] = args.width
    if args.height:
        scene.render_params["height"] = args.height
    if args.z_channel:
        scene.render_params["z_channel"] = True

    rlog = RenderLog(scene_name=os.path.basename(args.input))
    rlog.set_params("render", dict(scene.render_params))
    for iname, ip in scene.integrator_params.items():
        rlog.set_params(f"integrator:{iname}", dict(ip))

    def progress(p, total):
        rlog.event("info", f"pass {p}/{total}")

    # torchrun's ranks join one group (none is made without its
    # environment); a rank other than 0 renders its band and writes nothing
    init_distributed(device=args.device)
    rank = int(os.environ.get("RANK", 0))

    def run():
        return render_scene(scene, device=args.device, progress_cb=progress,
                            film_path=args.film, n_devices=args.devices)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if args.device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            result = run()
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace)
        log.info("profiler trace written to %s", trace)
    else:
        result = run()
    rlog.event("info", f"rendered on {args.device}")
    if rank != 0:
        return 0

    out = args.output or os.path.splitext(args.input)[0] + ".png"
    if args.format:
        out = os.path.splitext(out)[0] + "." + args.format.lstrip(".")
    cfg = result.cfg
    passes = result.passes if cfg.passes else {}
    if passes and out.lower().endswith(".exr"):
        # one multilayer file: the combined image, alpha, every pass
        layers = {"": result.image}
        if result.alpha is not None:
            layers["alpha"] = result.alpha[..., None]
        layers.update(passes)
        save_multilayer_exr(out, layers)
    else:
        img, alpha = result.image, result.alpha
        if alpha is not None and cfg.premult_alpha:
            img = img * alpha[..., None]
        if args.badge:
            from .. import __version__
            from ..utils.observability import draw_badge

            img = draw_badge(img, [
                f"libyafaray_tpu_torch {__version__} | "
                f"{os.path.basename(args.input)} | {cfg.integrator}",
                f"{cfg.width}x{cfg.height} | AA "
                f"{cfg.aa_passes}x{cfg.aa_samples}"
                f" | {result.mrays_per_sec:.1f} Mrays/s",
            ])
        save_image(out, img, color_space=cfg.color_space, gamma=cfg.gamma,
                   alpha=alpha)
        base, ext = os.path.splitext(out)
        for name, plane in passes.items():
            # a file a pass, its channels padded to RGB, linear
            if plane.shape[-1] == 1:
                plane = np.repeat(plane, 3, axis=-1)
            elif plane.shape[-1] == 2:
                plane = np.concatenate(
                    [plane, np.zeros_like(plane[..., :1])], axis=-1)
            save_image(f"{base}.{name}{ext}", plane, color_space="linear")
    wall = time.perf_counter() - t0
    log.info("wrote %s  [%.2fs total, %.1f Mrays/s]", out, wall,
             result.mrays_per_sec)
    if args.logs:
        base = os.path.splitext(out)[0]
        rlog.event("info", f"wrote {out}")
        rlog.set_params("stats", dict(result.stats))
        rlog.export_txt(base + ".log.txt")
        rlog.export_html(base + ".log.html")
    if args.json_stats:
        print(json.dumps(dict(
            output=out, wall_s=wall, render_s=result.stats["render_s"],
            rays=result.stats["rays"], mrays_per_sec=result.mrays_per_sec,
        )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
