"""Time-to-RMSE of the PyTorch + CUDA port (libyafaray_tpu_torch), the
counterpart of scripts/bench_time_to_rmse.py with its protocol and
defaults: wall-clock until the Cornell-box pathtracing film (scenes/
cornell.xml, bounces 4, rr_min_bounces 2) reaches RMSE <= 1e-3 (linear
RGB, mean over pixels and channels) against a golden.

  - golden: the same pipeline with an independent sampler stream
    (qmc_seed 0xB0B) at --golden-mult x the measurement's spp budget;
    its noise floor is an independent half-budget render (qmc_seed
    0xF100) against it;
  - uniform: steady-state steps of --spp-step samples a pixel (one step,
    spp_batch = --spp-step), one warm-up step off the clock, the RMSE
    computed on the device after every step;
  - --adaptive: --pass0-spp uniform samples, then one --spp-step burst a
    pass over the pixels the estimator flags (--estimator variance: the
    film's stderr, or contrast with --dark detection) at --aa-threshold,
    through the compact step where the flagged pixels fit a bucket of at
    most half the film (buckets of 512·2^k lanes, each built and run once
    off the clock), else the dense step masked by the flags;
  - --both: the uniform and the adaptive run against one golden.
Each run prints one JSON line: steady seconds to the threshold, spp,
rays, the final RMSE and the golden's noise floor.

    python scripts/torch_time_to_rmse.py [--size 128] [--max-steps 128]
        [--adaptive | --both] [--device cuda]

It imports only the port.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from libyafaray_tpu_torch.convert import to_tensors  # noqa: E402
from libyafaray_tpu_torch.film.imagefilm import film_image  # noqa: E402
from libyafaray_tpu_torch.integrators import render as rmod  # noqa: E402
from libyafaray_tpu_torch.integrators.config import RenderConfig  # noqa
from libyafaray_tpu_torch.integrators.engine import (  # noqa: E402
    make_sample_step, resolve_device)
from libyafaray_tpu_torch.scene.session import build_config  # noqa: E402
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file  # noqa


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--threshold", type=float, default=1e-3)
    ap.add_argument("--spp-step", type=int, default=64,
                    help="samples a pixel one step adds (its spp_batch)")
    ap.add_argument("--max-steps", type=int, default=128,
                    help="cap on timed steps (adaptive: passes)")
    ap.add_argument("--golden-mult", type=int, default=12,
                    help="golden spp = mult x the measurement's spp cap")
    ap.add_argument("--adaptive", action="store_true")
    ap.add_argument("--both", action="store_true",
                    help="the uniform and the adaptive run, one golden")
    ap.add_argument("--pass0-spp", type=int, default=256)
    ap.add_argument("--aa-threshold", type=float, default=2e-3)
    ap.add_argument("--dark", default="linear",
                    help="dark detection of the contrast estimator")
    ap.add_argument("--estimator", default="variance",
                    choices=("contrast", "variance"))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


class Bench:
    """The scene compiled once on the device, and the configs and steps
    the runs share."""

    def __init__(self, args):
        self.args = args
        self.dev = resolve_device(args.device)
        scene = parse_xml_file(os.path.join(ROOT, "scenes", "cornell.xml"))
        scene.render_params["width"] = args.size
        scene.render_params["height"] = args.size
        self.base = build_config(scene)
        self.cs = scene.compile(device=str(self.dev))
        self.arrays = to_tensors(self.cs.arrays, self.dev)
        self.flags = torch.ones((args.size, args.size), dtype=torch.bool,
                                device=self.dev)

    def cfg(self, seed: int, **over) -> RenderConfig:
        a = self.args
        return RenderConfig(**{
            **self.base.__dict__, "integrator": "pathtracing", "bounces": 4,
            "rr_min_bounces": 2, "width": a.size, "height": a.size,
            "aa_samples": a.spp_step, "aa_passes": 1, "qmc_seed": seed,
            "spp_batch": a.spp_step, **over})

    def step(self, cfg, compact_n: int = 0):
        return make_sample_step(self.cs.static, self.cs.camera, cfg,
                                self.dev, compact_n=compact_n)

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def uniform(self, cfg, n_steps: int, golden=None):
        """n_steps steps over every pixel after one warm-up step; with a
        golden, the RMSE after each step, stopping at the threshold.
        Returns (image, [(steady_s, spp, rays, rmse)])."""
        step = self.step(cfg)
        step(self.arrays, rmod._fresh_film(cfg, self.dev), self.flags)
        self.sync()
        film = rmod._fresh_film(cfg, self.dev)
        out = []
        t0 = time.perf_counter()
        for i in range(1, n_steps + 1):
            film = step(self.arrays, film, self.flags)
            if golden is not None:
                rmse = float(rmse_of(film, golden))
                out.append((time.perf_counter() - t0, i * cfg.spp_batch,
                            float(film["rays"]), rmse))
                if rmse <= self.args.threshold:
                    break
        self.sync()
        return film_image(film), out

    def adaptive(self, golden):
        """The adaptive protocol.  Returns [(steady_s, spp, rays, rmse,
        flagged)] at the start of each pass after pass 0."""
        a = self.args
        use_var = a.estimator == "variance"
        cfg = self.cfg(0, aa_estimator=a.estimator,
                       aa_threshold=a.aa_threshold, aa_dark_detection=a.dark,
                       aa_dark_factor=1.0)
        dense = self.step(cfg)
        n_px = a.size * a.size
        buckets = [b for b in (512, 1024, 2048, 4096, 8192, 16384)
                   if b <= n_px // 2]
        compact = {nc: self.step(cfg, compact_n=nc) for nc in buckets}

        def fresh():
            return rmod._fresh_film(cfg, self.dev, with_variance=use_var)

        # every step variant built and run once off the clock
        warm = dense(self.arrays, fresh(), self.flags)
        rmod.adaptive_flags(warm, cfg)
        for nc, st in compact.items():
            pix = torch.full((nc,), -1, dtype=torch.int32, device=self.dev)
            pix[0] = 0
            warm = st(self.arrays, warm, pix)
        self.sync()

        film = fresh()
        out = []
        t0 = time.perf_counter()
        p0_steps = -(-a.pass0_spp // a.spp_step)
        for _ in range(p0_steps):
            film = dense(self.arrays, film, self.flags)
        spp = p0_steps * a.spp_step
        for _ in range(1, a.max_steps):
            flags = rmod.adaptive_flags(film, cfg)
            rmse, nf = float(rmse_of(film, golden)), int(flags.sum())
            out.append((time.perf_counter() - t0, spp, float(film["rays"]),
                        rmse, nf))
            if rmse <= a.threshold or nf == 0:
                break
            nc = rmod.compact_bucket(nf)
            if nc in compact:
                film = compact[nc](self.arrays, film,
                                   rmod.compact_lanes(flags, nf))
            else:
                film = dense(self.arrays, film, flags)
            spp += a.spp_step
        self.sync()
        return out


def rmse_of(film: dict, golden: torch.Tensor) -> torch.Tensor:
    """The film's RMSE against the golden, on the film's device."""
    return torch.sqrt(torch.mean((film_image(film) - golden) ** 2))


def result(metric: str, args, checkpoints, floor: float, g_spp: int,
           device: str, **extra) -> dict:
    hit = [c for c in checkpoints if c[3] <= args.threshold]
    at = hit[0] if hit else checkpoints[-1]
    return dict(metric=metric, threshold=args.threshold,
                resolution=f"{args.size}x{args.size}", **extra,
                golden_spp=g_spp, noise_floor=floor, reached=bool(hit),
                steady_s=round(hit[0][0], 3) if hit else None, spp=at[1],
                rays=at[2], final_rmse=checkpoints[-1][3], device=device)


def main(argv=None) -> None:
    args = parse_args(argv)
    bench = Bench(args)
    device = (torch.cuda.get_device_name(bench.dev)
              if bench.dev.type == "cuda" else "cpu")
    g_steps = args.max_steps * args.golden_mult
    g_spp = g_steps * args.spp_step
    print(f"golden: seed=0xB0B, {g_spp} spp ...", flush=True)
    tg = time.perf_counter()
    golden, _ = bench.uniform(bench.cfg(0xB0B), g_steps)
    print(f"golden done in {time.perf_counter() - tg:.1f}s", flush=True)
    floor_img, _ = bench.uniform(bench.cfg(0xF100), g_steps // 2)
    floor = float(torch.sqrt(torch.mean((floor_img - golden) ** 2)))
    print(f"golden self-noise floor (half-budget indep): {floor:.2e}",
          flush=True)

    if not args.adaptive or args.both:
        _, cps = bench.uniform(bench.cfg(0), args.max_steps, golden)
        for (dt, spp, rays, rmse) in cps[-8:]:
            print(f"  t={dt:7.2f}s spp={spp:6d} rays={rays / 1e9:.2f}G "
                  f"rmse={rmse:.2e}")
        print(json.dumps(result("time_to_rmse", args, cps, floor, g_spp,
                                device, spp_step=args.spp_step)),
              flush=True)
    if args.adaptive or args.both:
        cps = bench.adaptive(golden)
        for (dt, spp, rays, rmse, nf) in cps[-10:]:
            print(f"  t={dt:7.2f}s spp={spp:6d} rays={rays / 1e9:.2f}G "
                  f"rmse={rmse:.2e} flagged={nf}")
        print(json.dumps(result(
            "time_to_rmse_adaptive", args, cps, floor, g_spp, device,
            spp_step=args.spp_step, pass0_spp=args.pass0_spp,
            aa_threshold=args.aa_threshold, estimator=args.estimator)),
            flush=True)


if __name__ == "__main__":
    main()
