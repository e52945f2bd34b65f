"""On-card smoke run of the PyTorch + CUDA port (libyafaray_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (one nvcc per source, all
started together) and drives the ported paths through them:
- slice 1, the Cornell pathtracing main path (bench.py config 1): the two
  tiny-scene kernels against their plain PyTorch versions at the path's
  shapes, the 512²·64 spp render, one profiled sample step, the physics
  against the stored golden and the card against the CPU;
- slice 2, the generated 164K-triangle grid-spheres scene (bench.py config
  3, written here by the port's generator, scene/generate.py): the two
  large-scene kernels against their plain versions at the path's shapes,
  the 512²·4 spp render, one profiled sample step, and the card against the
  CPU on a small generated grid;
- slice 3, photon mapping on scenes/cornell_photon.xml (BASELINE config 3,
  glass and glossy analytic spheres): the three photon-gather kernels
  against their plain versions at the path's shapes (the nearest lookup's
  culled search also against the brute-force kernel on every query), the
  full-width render
  (512², 16 spp, 200,000 + 100,000 photons, final gather 16) through the
  entry point `render_scene`, one profiled sample step, cornell.xml against
  the stored photon-mapping golden, the card against the CPU, and the
  2,000,000-photon scale route, where the diffuse map takes the culled
  layout and its kernel;
- slice 4, the generated mid-size scenes at their own settings (512²,
  16 spp): 172 triangles in 2 clusters (the dense kernels) and 652 in 6
  (the streaming kernels), each kernel against its plain version on rays
  recorded from a real sample step, the render through the entry point
  `render_scene`, the same scene through the port's CLI to an .exr, one
  profiled step, and the card against the CPU;
- slice 5, the pair-granular route (`Scene.compile(pairs=True)`): its two
  kernels against their plain versions on slots recorded from a real grid
  step, the fine kernels on the grid's recorded bounce-1 rays (the closest
  hit against its plain version where the walk order matters, the
  one-sample shadow launch with its bound), the pair route against the
  fine route on the grid's recorded
  bounce-1 and NEE rays, the 164K grid at 512², 4 spp through
  `render_scene(pairs=True)` against slice 2's fine-route render, one
  profiled step split by stage, the card against the CPU on the
  10,252-triangle grid, the 131,072-triangle random soup with 262,144
  incoherent and coherent rays on both routes against the brute force, and
  the fine closest hit on a 300,000-triangle soup (more cluster boxes than
  one sweep of its walk holds) against the brute force;
- slice 7, the two shadow-sum kernels rebuilt around one shared-memory tile
  routine (csrc/shadow_tile.cuh): inside the phases above,
  `shadow_logsum_fine` is held to its plain version on the grid's bounce-0
  batch and on its bounce-1 launch (rays from scattered bounce points),
  `pairs_shadow` takes the sub-box table, and on the soup, whose filters are
  not binary, each of the two is called twice and must repeat bit for bit;
- slice 8, `pairs_closest` on the same tile routine (a (t, column) minimum,
  sub-boxes skipped beyond a slot's best hit) and `density_flash` over
  Morton-sorted packs (one warp a query, the clusters within its radius):
  inside the phases above each is held to its plain version, called twice
  and compared bit for bit, and timed beside the body it replaced on the
  same inputs (`ms_before`: the one-thread pair body; the brute force over
  the same photons in their original order), with its registers.
Each path is rendered with every launch counter set to 0 just before it and
read just after.  Every kernel's line carries its bound: the larger of its
FP32 operations over the card's 67 TFLOP/s and its bytes (each input read
once, each output written once) over 3.35 TB/s, with the pair tests counted
from this run's rays.  Every phase prints one line; any failure raises and
the script exits non-zero without printing a result.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX and runs no other program of the repository.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from libyafaray_tpu_torch.cli.yafaray_xml import main as cli_main  # noqa: E402
from libyafaray_tpu_torch.convert import to_tensors  # noqa: E402
from libyafaray_tpu_torch.core import qmc  # noqa: E402
from libyafaray_tpu_torch.integrators import engine  # noqa: E402
from libyafaray_tpu_torch.integrators.config import RenderConfig  # noqa: E402
from libyafaray_tpu_torch.integrators.render import (  # noqa: E402
    _fresh_film, render, render_timed)
from libyafaray_tpu_torch.io.exr import read_exr  # noqa: E402
from libyafaray_tpu_torch.ops import _build  # noqa: E402
from libyafaray_tpu_torch.ops import cluster_intersect as cx  # noqa: E402
from libyafaray_tpu_torch.ops import cuda_intersect as ci  # noqa: E402
from libyafaray_tpu_torch.ops import fine_intersect as fi  # noqa: E402
from libyafaray_tpu_torch.ops import intersect as isect  # noqa: E402
from libyafaray_tpu_torch.ops import pairs_intersect as pi  # noqa: E402
from libyafaray_tpu_torch.ops import photon_flash as pf  # noqa: E402
from libyafaray_tpu_torch.integrators import photonmap  # noqa: E402
from libyafaray_tpu_torch.scene.generate import (  # noqa: E402
    make_rays, make_soup, write_grid_spheres)
from libyafaray_tpu_torch.scene.session import (  # noqa: E402
    build_config, render_scene)
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file  # noqa: E402

CORNELL = os.path.join(REPO, "scenes", "cornell.xml")
GOLDEN = os.path.join(REPO, "scenes", "goldens", "cornell_pathtracing.exr")
PHOTON = os.path.join(REPO, "scenes", "cornell_photon.xml")
PHOTON_GOLDEN = os.path.join(REPO, "scenes", "goldens",
                             "cornell_photonmapping.exr")
SOURCES = ("tiny_intersect", "fine_intersect", "photon_flash",
           "cluster_intersect", "pairs_intersect")
SRC = "libyafaray_tpu_torch/csrc/{}.cu"
PALLAS = "libyafaray_tpu/ops/pallas_intersect.py:{}"
FLASH = "libyafaray_tpu/ops/photon_flash.py:{}"
# main path: bench.py config 1
MAIN = dict(size=512, spp=64, bounces=4, rr_min_bounces=2)
# slice 2: bench.py config 3 (the scene's own pathtracing settings)
GRID = dict(grid=4, subdiv=4, size=512, spp=4)
# rays the grid kernels' plain brute force is compared and timed on (it
# runs ~40 ns a ray-triangle pair): every 4th primary ray, every 32nd of the
# bounce-0 NEE block (light samples x pixels)
PLAIN_GRID_STRIDE = dict(closest=4, shadow=32)
# slice 3 runs cornell_photon.xml at its own settings (BASELINE config 3);
# the golden is cornell.xml with the overrides it was rendered with
GOLDEN_PHOTON = dict(integrator="photonmapping", photons=200_000,
                     caustic_photons=50_000, fg_samples=24, raydepth=4,
                     aa_samples=24, aa_passes=1)
CARD_VS_CPU_PHOTON = dict(size=32, aa_samples=2, photons=16_384,
                          caustic_photons=8_192, fg_samples=4)
# the scale route: diffuse stores above CULL_MIN_PHOTONS
SCALE = dict(size=128, aa_samples=1, photons=2_000_000)
# queries the plain gathers are compared and timed on (bounds their time);
# the culled kernel's two plain versions over 3.68 M photons take half
PLAIN_QUERIES = 16384
PLAIN_CULLED_QUERIES = 8192
PHOTON_TAGS = ("closest_tiny_kernel", "shadow_tiny_kernel",
               "density_flash_kernel", "density_sorted_kernel",
               "nearest_flash_kernel", "nearest_culled_kernel")
# slice 4: the generated mid-size scenes at the generator's own settings
# (512², 16 spp, bounces 3, gauss filter, one area light with 8 samples)
MID = (("dense", 1), ("stream", 2))  # (kernel pair, --grid), --subdiv 1
MID_CARD_VS_CPU = dict(size=32, spp=2)
# slice 5: the pair route on the grid path (GRID) and, at 32², 2 spp, on
# the 10,252-triangle grid (81 clusters of 128); the 131K random soup of
# the intersection benchmarks, soup131 (BT 1,024, 128 clusters)
PAIRS_SMALL = dict(grid=2, subdiv=3, size=32, spp=2)
SOUP = dict(tris=131072, rays=262144)
# a pack of more clusters than one sweep of closest_hit_fine's walk holds
# (256): 300,000 triangles in 293 clusters of 1,024
SWEEPS = dict(tris=300_000, rays=16384)
# slots the plain pair versions are compared and timed on (bounds their time)
PLAIN_SLOTS = 1 << 22
PAIR_KERNELS = ("pairs_closest_kernel", "pairs_shadow_kernel",
                "closest_fine_kernel", "shadow_fine_kernel")
# the pair route's stages a profiled step splits its glue by
PAIR_STAGES = {"pairs.entries": (pi, "nearest_clusters"),
               "pairs.expand": (pi, "expand_pairs"),
               "pairs.route": (pi, "closest_hit_pairs"),
               "pairs.route_shadow": (pi, "shadow_logsum_pairs")}
# the bounds: NVIDIA H100 SXM datasheet peaks, FP32
# outside the tensor cores (counting a fused multiply-add as two; built with
# -fmad=false, the kernels can reach half of it) and device memory
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
MT_OPS = 45  # one Möller-Trumbore pair test: 44 add/mul/sub + 1 division
BOX_OPS = 39  # one widened slab test: per axis 4 add/sub, 3 mul, 6 min/max
DENSITY_OPS = 13  # d2 (3 sub, 3 mul, 2 add), side test (3 mul, 2 add)
NEAREST_OPS = 8  # d2
BOX_D2_OPS = 20  # point-box d2: per axis 2 sub, 3 max; then 3 mul, 2 add


START = time.perf_counter()


def phase(tag: str, **kv) -> None:
    """One line per phase, ending with the seconds since the script
    started (at_s): the run's time budget, phase by phase."""
    kv["at_s"] = round(time.perf_counter() - START, 1)
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (a dict counts its tensors)."""
    out = 0
    for x in tensors:
        if isinstance(x, dict):
            out += nbytes(*x.values())
        elif isinstance(x, torch.Tensor):
            out += x.numel() * x.element_size()
    return out


def registers(source: str, kernel: str) -> dict:
    """Registers a thread of `kernel` (a substring of its mangled name) in
    csrc/<source>.cu uses and the bytes it spills, from the ptxas report
    kept beside its library."""
    name, out = None, {}
    with open(_build.library_path(source)[:-3] + ".log") as f:
        for line in f:
            if "Compiling entry function" in line:
                name = line
            elif name and kernel in name and "spill stores" in line:
                out["spill_stores"] = int(
                    re.search(r"(\d+) bytes spill stores", line).group(1))
            elif name and kernel in name and "registers" in line:
                out["registers"] = int(
                    re.search(r"Used (\d+) registers", line).group(1))
                return out
    raise AssertionError(f"ptxas reports no {kernel} in {source}.cu")


def bound(ops: float, moved: int, **work) -> dict:
    """The least time the card could take for a call: the larger of its
    FP32 operations over FP32_PEAK and the bytes it must move (each input
    read once, each output written once) over HBM_RATE; which of the two
    bounds it; and the work counted.  No single PyTorch call computes any
    of the port's kernels, so library_ms is None."""
    t_ops, t_bytes = 1e3 * ops / FP32_PEAK, 1e3 * moved / HBM_RATE
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops=ops, bytes=moved, library_ms=None, **work)


def cornell(size: int, spp: int, bounces: int, rr_min_bounces: int,
            device: str):
    """The port's main path inputs: parse -> build_config -> compile."""
    scene = parse_xml_file(CORNELL)
    scene.render_params["width"] = size
    scene.render_params["height"] = size
    cfg = build_config(scene)
    cfg = RenderConfig(**{**cfg.__dict__, "integrator": "pathtracing",
                          "bounces": bounces,
                          "rr_min_bounces": rr_min_bounces,
                          "width": size, "height": size,
                          "aa_samples": spp, "aa_passes": 1})
    return scene.compile(device=device), cfg


def make_grid(out_dir: str, grid: int, subdiv: int) -> str:
    """Write a grid-spheres scene with the port's generator at its default
    settings (512², 16 spp)."""
    return write_grid_spheres(
        os.path.join(out_dir, f"grid{grid}_{subdiv}.xml"), grid, subdiv)


def grid(path: str, size: int, spp: int, device: str, pairs: bool = False):
    """Slice 2's inputs: parse -> build_config (the scene's own pathtracing
    settings and gauss filter) -> compile (for the pair route with
    pairs=True)."""
    scene = parse_xml_file(path)
    scene.render_params["width"] = size
    scene.render_params["height"] = size
    cfg = build_config(scene)
    cfg = RenderConfig(**{**cfg.__dict__, "width": size, "height": size,
                          "aa_samples": spp, "aa_passes": 1})
    return scene.compile(device=device, pairs=pairs), cfg


def device_ms(fn, calls: int, replays: int = 5) -> float:
    """Device milliseconds per fn() call: `calls` back-to-back calls
    captured in one CUDA graph and replayed between one pair of CUDA
    events, the median over `replays` replays divided by `calls`.  The
    graph leaves the host's launch work out of the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture stream, as capture asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / calls)
    return statistics.median(times)


def call_ms(fn, calls: int) -> float:
    """Milliseconds per eager fn() call, `calls` back-to-back calls between
    one pair of CUDA events: the device time or the host's launch work,
    whichever is longer, as the eager main path pays it."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(calls):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / calls


def once_ms(fn):
    """(fn()'s result, milliseconds between CUDA events around one eager
    call) for a call too long to repeat or capture."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1)


def main_path_rays(cscene, cfg, arrays):
    """The kernels' inputs at the main path's shapes, made by the engine's
    own functions: the primary camera rays of sample 0 (H·W), and the first
    light's NEE shadow rays from their hit points (samples·H·W)."""
    dev = arrays["tri_pack10"].device
    st = cscene.static
    px, py, ph = engine.pixel_lanes(cfg.height, cfg.width, cfg.qmc_seed, dev)
    s_idx = torch.zeros_like(px)
    _, _, org, dirn, wt = engine.camera_rays(cscene.camera, px, py, ph,
                                             s_idx)
    alive = wt > 0.0
    primary = (org.contiguous(), dirn.contiguous(),
               *engine.ray_bounds(st, alive))
    hit = isect.closest_hit(arrays, st, *primary)
    sp = engine._surface_point(arrays, hit)
    n_sh, ng_sh = engine.shading_frame(sp, -dirn)
    ns = engine.nee_count(st.lights[0], cfg, first=True)
    smp, _, org_s, dist = engine.shadow_rays(
        arrays, st, 0, ns, sp["p"], n_sh, ng_sh, alive & hit.hit, s_idx,
        engine.bounce_key(ph, 0), qmc.bounce_dim(0, 0), first=True)
    shadow = (org_s.contiguous(), smp["wi"].contiguous(), dist.contiguous())
    return primary, shadow


def check_kernels(cscene, cfg, arrays) -> list:
    st = cscene.static
    pack = arrays["tri_pack10"]
    logf = ci.log_filter(arrays["sfilt4_binary"])
    primary, shadow = main_path_rays(cscene, cfg, arrays)

    kt, ktri, ku, kv, khit = ci.closest_hit_tiny(pack, *primary,
                                                 st.n_tris_real)
    torch.cuda.synchronize()
    pt, ptri, pu, pv, phit = ci.closest_hit_tiny_plain(pack, *primary,
                                                       st.n_tris_real)
    torch.cuda.synchronize()
    if not torch.equal(khit, phit) or not torch.equal(ktri[phit],
                                                      ptri[phit]):
        raise AssertionError("closest_hit_tiny: hit/tri differ from plain")
    for name, a, b in (("t", kt, pt), ("u", ku, pu), ("v", kv, pv)):
        if not torch.allclose(a[phit], b[phit], rtol=1e-4):
            raise AssertionError(f"closest_hit_tiny: {name} beyond rtol 1e-4")
    differ = (kt != pt) | (ktri != ptri) | (ku != pu) | (kv != pv)
    n_diff = int(differ.sum())
    n_rays = kt.shape[0]
    err_c = max(float((a[phit] - b[phit]).abs().max())
                for a, b in ((kt, pt), (ku, pu), (kv, pv)))
    kernel_c = lambda: ci.closest_hit_tiny(  # noqa: E731
        pack, *primary, st.n_tris_real)
    ms_c = device_ms(kernel_c, calls=20)
    call_ms_c = call_ms(kernel_c, calls=20)
    plain_ms_c = device_ms(lambda: ci.closest_hit_tiny_plain(
        pack, *primary, st.n_tris_real), calls=2)
    pairs_c = n_rays * st.n_tris_real
    bound_c = bound(MT_OPS * pairs_c, nbytes(pack, *primary, kt, ktri, ku,
                                             kv), pair_tests=pairs_c)
    phase("kernel", name="closest_hit_tiny", rays=n_rays,
          hits=int(phit.sum()), differ=n_diff,
          differ_share=n_diff / n_rays, max_abs_err=err_c,
          tolerance="hit,tri equal; t,u,v rtol 1e-4",
          ms=round(ms_c, 4), call_ms=round(call_ms_c, 4),
          plain_ms=round(plain_ms_c, 4),
          bit_equal_expected=n_diff <= 1e-4 * n_rays, **bound_c)

    klg = ci.shadow_logsum_tiny(pack, logf, *shadow, st.n_stris_real)
    torch.cuda.synchronize()
    plg = ci.shadow_logsum_tiny_plain(pack, logf, *shadow, st.n_stris_real)
    torch.cuda.synchronize()
    err_s = float((torch.exp(klg) - torch.exp(plg)).abs().max())
    if err_s > 2e-3:
        raise AssertionError(f"shadow_logsum_tiny: transmission off by "
                             f"{err_s} > 2e-3")
    n_diff_s = int((klg != plg).any(dim=-1).sum())
    kernel_s = lambda: ci.shadow_logsum_tiny(  # noqa: E731
        pack, logf, *shadow, st.n_stris_real)
    ms_s = device_ms(kernel_s, calls=20)
    call_ms_s = call_ms(kernel_s, calls=20)
    plain_ms_s = device_ms(lambda: ci.shadow_logsum_tiny_plain(
        pack, logf, *shadow, st.n_stris_real), calls=2)
    n_sh = shadow[0].shape[0]
    pairs_s = n_sh * st.n_stris_real
    bound_s = bound(MT_OPS * pairs_s, nbytes(pack, logf, *shadow, klg),
                    pair_tests=pairs_s)
    phase("kernel", name="shadow_logsum_tiny", rays=n_sh,
          live=int((shadow[2] > 0).sum()), differ=n_diff_s,
          max_abs_err=err_s, tolerance="transmission atol 2e-3",
          ms=round(ms_s, 4), call_ms=round(call_ms_s, 4),
          plain_ms=round(plain_ms_s, 4), **bound_s)
    return [
        dict(name="closest_hit_tiny", route="cuda",
             source=SRC.format("tiny_intersect"),
             replaces=PALLAS.format(2259), max_abs_err=err_c, ms=ms_c,
             plain_ms=plain_ms_c, **bound_c),
        dict(name="shadow_logsum_tiny", route="cuda",
             source=SRC.format("tiny_intersect"),
             replaces=PALLAS.format(2281), max_abs_err=err_s, ms=ms_s,
             plain_ms=plain_ms_s, **bound_s),
    ]


def check_fine_kernels(cscene, cfg, arrays) -> list:
    """The two large-scene kernels against their plain versions at the grid
    path's shapes: closest hit on the 262,144 primary rays of sample 0
    (hit, tri equal after the epilogue; t, u, v rtol 1e-4), shadows on the
    bounce-0 NEE rays (transmission atol 2e-3), each compared with the plain
    brute force on a strided sample (PLAIN_GRID_STRIDE)."""
    st = cscene.static
    pk, cl, sub = (arrays[k] for k in ("tri_pack10", "tri_cluster8",
                                       "tri_sub8"))
    n_tris = st.n_tris_real
    logf = ci.log_filter(arrays["sfilt4_binary"])
    primary, shadow = main_path_rays(cscene, cfg, arrays)
    org, dirn = primary[0], primary[1]

    kt, kcol = fi.closest_hit_fine(pk, cl, sub, *primary, n_tris)
    torch.cuda.synchronize()
    sample_c = tuple(x[::PLAIN_GRID_STRIDE["closest"]].contiguous()
                     for x in primary)
    (pt, pcol), plain_ms_c = once_ms(
        lambda: fi.closest_fine_plain(pk, *sample_c, n_tris))
    kt_c, kcol_c = (x[::PLAIN_GRID_STRIDE["closest"]] for x in (kt, kcol))
    k_hit = fi.closest_epilogue(pk, *sample_c[:2], kt_c, kcol_c, n_tris)
    p_hit = fi.closest_epilogue(pk, *sample_c[:2], pt, pcol, n_tris)
    phit = p_hit[4]
    if not torch.equal(k_hit[4], phit) or not torch.equal(k_hit[1][phit],
                                                          p_hit[1][phit]):
        raise AssertionError("closest_hit_fine: hit/tri differ from plain")
    for name, i in (("t", 0), ("u", 2), ("v", 3)):
        if not torch.allclose(k_hit[i][phit], p_hit[i][phit], rtol=1e-4):
            raise AssertionError(f"closest_hit_fine: {name} beyond rtol 1e-4")
    n_diff = int(((kt_c != pt) | (kcol_c != pcol)).sum())
    n_rays = kt.shape[0]
    n_cmp = pt.shape[0]
    err_c = max(float((k_hit[i][phit] - p_hit[i][phit]).abs().max())
                for i in (0, 2, 3))
    kernel_c = lambda: fi.closest_hit_fine(  # noqa: E731
        pk, cl, sub, *primary, n_tris)
    ms_c = device_ms(kernel_c, calls=5, replays=3)
    call_ms_c = call_ms(kernel_c, calls=5)
    ms_c_sub = device_ms(lambda: fi.closest_hit_fine(
        pk, cl, sub, *sample_c, n_tris), calls=5, replays=3)
    pairs_c, boxes_c = fi.fine_pair_tests(
        cl, sub, org, dirn, primary[2], torch.minimum(primary[3], kt),
        n_tris)
    bound_c = bound(MT_OPS * pairs_c + BOX_OPS * boxes_c,
                    nbytes(pk, cl, sub, *primary, kt, kcol),
                    pair_tests=pairs_c, box_tests=boxes_c,
                    **walk_bracket(cl, sub, *primary, n_tris))
    phase("kernel", name="closest_hit_fine", tris=n_tris, rays=n_rays,
          compared_rays=n_cmp, hits=int(phit.sum()), differ=n_diff,
          max_abs_err=err_c, tolerance="hit,tri equal; t,u,v rtol 1e-4",
          ms=round(ms_c, 4), call_ms=round(call_ms_c, 4),
          ms_on_compared=round(ms_c_sub, 4), plain_ms=round(plain_ms_c, 4),
          plain=f"one eager call on every "
          f"{PLAIN_GRID_STRIDE['closest']}th ray", **bound_c)

    klg = fi.shadow_logsum_fine(pk, cl, sub, logf, *shadow, n_tris)
    torch.cuda.synchronize()
    sub_rays = tuple(x[::PLAIN_GRID_STRIDE["shadow"]].contiguous()
                     for x in shadow)
    plg, plain_ms_s = once_ms(
        lambda: fi.shadow_logsum_fine_plain(pk, logf, *sub_rays, n_tris))
    klg_sub = klg[::PLAIN_GRID_STRIDE["shadow"]]
    err_s = float((torch.exp(klg_sub) - torch.exp(plg)).abs().max())
    if err_s > 2e-3:
        raise AssertionError(f"shadow_logsum_fine: transmission off by "
                             f"{err_s} > 2e-3")
    n_diff_s = int((klg_sub != plg).any(dim=-1).sum())
    kernel_s = lambda: fi.shadow_logsum_fine(  # noqa: E731
        pk, cl, sub, logf, *shadow, n_tris)
    ms_s = device_ms(kernel_s, calls=3, replays=3)
    call_ms_s = call_ms(kernel_s, calls=3)
    ms_s_sub = device_ms(lambda: fi.shadow_logsum_fine(
        pk, cl, sub, logf, *sub_rays, n_tris), calls=5, replays=3)
    n_sh = shadow[0].shape[0]
    pairs_s, boxes_s = fi.fine_pair_tests(
        cl, sub, shadow[0], shadow[1], *cx.shadow_limits(shadow[2]), n_tris)
    bound_s = bound(MT_OPS * pairs_s + BOX_OPS * boxes_s,
                    nbytes(pk, cl, sub, logf, *shadow, klg),
                    pair_tests=pairs_s, box_tests=boxes_s)
    phase("kernel", name="shadow_logsum_fine", tris=n_tris, rays=n_sh,
          live=int((shadow[2] > 0).sum()), compared_rays=plg.shape[0],
          differ=n_diff_s, max_abs_err=err_s,
          tolerance="transmission atol 2e-3", ms=round(ms_s, 4),
          call_ms=round(call_ms_s, 4), ms_on_compared=round(ms_s_sub, 4),
          plain_ms=round(plain_ms_s, 4),
          plain=f"one eager call on every "
          f"{PLAIN_GRID_STRIDE['shadow']}th ray", **bound_s)
    return [
        dict(name="closest_hit_fine", route="cuda",
             source=SRC.format("fine_intersect"),
             replaces=PALLAS.format(910), max_abs_err=err_c, ms=ms_c,
             plain_ms=plain_ms_c, rays=n_rays, plain_rays=n_cmp,
             ms_on_plain_rays=ms_c_sub, **bound_c),
        dict(name="shadow_logsum_fine", route="cuda",
             source=SRC.format("fine_intersect"),
             replaces=PALLAS.format(1019), max_abs_err=err_s, ms=ms_s,
             plain_ms=plain_ms_s, rays=n_sh,
             plain_rays=plg.shape[0], ms_on_plain_rays=ms_s_sub,
             **bound_s),
    ]


def walk_bracket(cl, sub, org, dirn, tmin, tmax, n_tris) -> dict:
    """The most a closest-hit walk can need: the pair and box tests of
    every box the whole interval [tmin, tmax] enters (a walk that never
    culls by its best t).  With the bound's count (boxes entered before
    the hit) it brackets what a walk tests."""
    pairs, boxes = fi.fine_pair_tests(cl, sub, org, dirn, tmin, tmax, n_tris)
    return dict(pair_tests_no_cull=pairs, box_tests_no_cull=boxes)


# every kernel wrapper of the port, by name: each counts its launches
WRAPPERS = {fn.__name__: fn for fn in (
    ci.closest_hit_tiny, ci.shadow_logsum_tiny, fi.closest_hit_fine,
    fi.shadow_logsum_fine, pf.density_flash, pf.nearest_flash,
    pf.density_culled, cx.closest_hit_dense, cx.shadow_logsum_dense,
    cx.closest_hit_stream, cx.shadow_logsum_stream, pi.pairs_closest,
    pi.pairs_shadow)}


def counted(run):
    """run() with every launch counter set to 0 just before and read just
    after: (result, {wrapper name: launches})."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    out = run()
    return out, {k: fn.launches for k, fn in WRAPPERS.items()}


def render_counted(cscene, cfg, names: tuple):
    """render_timed on the card, counted; returns the launches of `names`
    and raises if any other kernel launched."""
    res, launches = counted(lambda: render_timed(cscene, cfg, device="cuda"))
    others = {k: v for k, v in launches.items() if k not in names and v}
    if others:
        raise AssertionError(f"kernels off the path launched: {others}")
    return res, {k: launches[k] for k in names}


def check_path(tag, res, cfg, launches, smi) -> None:
    """One path's phase line, and its image and launch checks: each
    kernel launches once per path vertex of every step, the warm-up step
    included."""
    img = res.image
    want = (cfg.bounces + 1) * (cfg.aa_samples + 1)
    phase(tag, size=f"{cfg.width}x{cfg.height}", spp=cfg.aa_samples,
          bounces=cfg.bounces, render_s=round(res.stats["render_s"], 4),
          rays=res.stats["rays"], mrays_per_s=round(res.mrays_per_sec, 3),
          launches=launches, expected_launches=want, gpu=repr(smi))
    if not np.all(np.isfinite(img)) or img.min() < 0.0:
        raise AssertionError(f"{tag}: image is not finite and >= 0")
    for k, v in launches.items():
        if v != want:
            raise AssertionError(f"{k}: {v} launches, expected {want}")


def card_vs_cpu(tag, make, size, spp) -> None:
    """The same render on the card (kernels) and the CPU (plain versions):
    RMSE <= 1e-4 and rays within 0.01%."""
    out = {}
    for dev in ("cuda", "cpu"):
        cs, cc = make(dev)
        out[dev] = render(cs, cc, device=dev)
    rmse = float(np.sqrt(np.mean((out["cuda"].image
                                  - out["cpu"].image) ** 2)))
    r_gpu, r_cpu = out["cuda"].stats["rays"], out["cpu"].stats["rays"]
    rel = abs(r_gpu - r_cpu) / max(r_cpu, 1.0)
    phase(tag, size=f"{size}x{size}", spp=spp, rmse=rmse, bound=1e-4,
          rays_gpu=r_gpu, rays_cpu=r_cpu, rays_rel=rel)
    if not (rmse <= 1e-4 and rel <= 1e-4):
        raise AssertionError(f"{tag}: card and CPU renders disagree")


def _stage_ms(events, stages) -> dict:
    """Device ms of the aten kernels launched inside each `stages` range
    (the innermost one), by the profiler's CPU-op -> kernel links."""
    out = dict.fromkeys(stages, 0.0)
    for e in events:
        if not getattr(e, "kernels", None):
            continue
        p = e
        while p is not None and p.name not in out:
            p = p.cpu_parent
        if p is not None:
            out[p.name] += sum(k.duration for k in e.kernels) / 1e3
    return {k: round(v, 4) for k, v in out.items()}


def profile_step(step, arrays, cfg, kernel_tags: tuple,
                 stages: dict | None = None) -> dict:
    """One sample step under torch.profiler, after an unprofiled one: its
    kernel launches, the device's busy milliseconds (the union of its
    kernel and copy intervals), the milliseconds of the ported kernels
    whose names hold one of `kernel_tags` (in all, per launch in launch
    order, and per tag as ms / launches), and the aten ops with the most
    device time (ms / calls).  `stages` ({range name: (module, function
    name)}) wraps those functions in profiler ranges for the profiled step
    and adds the device ms of the aten kernels inside each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = engine.resolve_device("cuda")
    flags = torch.ones((cfg.height, cfg.width), dtype=torch.bool, device=dev)
    film = step(arrays, _fresh_film(cfg, dev), flags)
    torch.cuda.synchronize()
    saved = {}
    for name, (module, fn_name) in (stages or {}).items():
        fn = saved[(module, fn_name)] = getattr(module, fn_name)

        def ranged(*a, _fn=fn, _name=name, **k):
            with record_function(_name):
                return _fn(*a, **k)
        setattr(module, fn_name, ranged)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(arrays, film, flags)
            torch.cuda.synchronize()
    finally:
        for (module, fn_name), fn in saved.items():
            setattr(module, fn_name, fn)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA)
    if not spans:
        return dict(device_busy_ms="not measured")
    busy_us, end = 0.0, float("-inf")
    for a, b, _ in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::") and e.device_time_total > 0),
                 key=lambda e: -e.device_time_total)[:6]
    ported = [(next(t for t in kernel_tags if t in n), (b - a) / 1e3)
              for a, b, n in spans if any(t in n for t in kernel_tags)]
    by_tag = {t: [ms for k, ms in ported if k == t] for t in kernel_tags}
    extra = {}
    if stages:
        extra["stage_ms"] = _stage_ms(prof.events(), stages)
    return dict(
        kernel_launches=sum(not n.startswith(("Memcpy", "Memset"))
                            for _, _, n in spans),
        device_busy_ms=busy_us / 1e3,
        ported_ms=sum(ms for _, ms in ported),
        ported_calls_ms=[round(ms, 4) for _, ms in ported],
        ported_by_kernel={t: f"{sum(v):.4f}ms/{len(v)}"
                          for t, v in by_tag.items()},
        top_ops={e.key: f"{e.device_time_total / 1e3:.4f}ms/{e.count}"
                 for e in ops}, **extra)


def profile(tag, res, step, arrays, cfg, kernel_tags, smi,
            stages=None) -> None:
    """The profile phase line of a path: one step profiled, its wall time
    the path's unprofiled render_s per sample."""
    step_ms = 1e3 * res.stats["render_s"] / cfg.aa_samples
    prof = profile_step(step, arrays, cfg, kernel_tags, stages)
    busy = prof["device_busy_ms"]
    phase(tag, step_ms=round(step_ms, 3), **prof,
          busy_share=(busy / step_ms if isinstance(busy, float)
                      else "not measured"), gpu=repr(smi))


def path_step(cscene, cfg):
    """A pathtracing sample step on the card and its scene tensors."""
    dev = engine.resolve_device("cuda")
    return (engine.make_sample_step(cscene.static, cscene.camera, cfg, dev),
            to_tensors(cscene.arrays, dev))


# ---- slice 3: photon mapping ----------------------------------------------


def photon_scene(path: str, device: str, size: int = 0, **over):
    """Slice 3's inputs: parse -> build_config (the scene's own settings,
    then `over`) -> compile.  size=0 keeps the scene's resolution."""
    scene = parse_xml_file(path)
    if size:
        scene.render_params["width"] = size
        scene.render_params["height"] = size
    cfg = build_config(scene)
    if size:
        over = dict(over, width=size, height=size)
    cfg = RenderConfig(**{**cfg.__dict__, **over})
    return scene.compile(device=device), cfg


def record_calls(module, names, run):
    """run() with the functions `names` of `module` recording their
    positional arguments.  Returns (run's result, [(name, args)])."""
    calls = []
    saved = {k: getattr(module, k) for k in names}

    def recorder(name, fn):
        def call(*args, **kwargs):
            calls.append((name, args + tuple(kwargs.values())))
            return fn(*args, **kwargs)
        return call

    for k, fn in saved.items():
        setattr(module, k, recorder(k, fn))
    try:
        out = run()
    finally:
        for k, fn in saved.items():
            setattr(module, k, fn)
    return out, calls


def gather_calls(run):
    """run() with photonmap's gathers (density_auto, nearest_flash) and
    the functions that pack the maps (the diffuse, then the caustic map;
    the radiance map) recording their arguments."""
    return record_calls(photonmap, ("density_auto", "nearest_flash",
                                    "make_photon_pack_auto",
                                    "make_photon_pack_lookup"), run)


def photon_inputs(cscene, cfg):
    """The gathers' arguments as the photon path makes them: the maps are
    built and installed, then one sample step runs.  Returns (step,
    arrays, pre_calls, step_calls): the step and its scene tensors with
    the packs, the radiance-map precompute's density gathers (one per
    65,536 queries) and the step's caustic density and fg_samples nearest
    lookups."""
    dev = engine.resolve_device("cuda")
    arrays = to_tensors(cscene.arrays, dev)
    maps, pre_calls = gather_calls(
        lambda: photonmap.install_photon_maps(cscene, cfg, arrays))
    step = photonmap.make_photon_sample_step(cscene, cfg, maps, dev)
    flags = torch.ones((cfg.height, cfg.width), dtype=torch.bool, device=dev)
    _, step_calls = gather_calls(
        lambda: step(arrays, _fresh_film(cfg, dev), flags))
    torch.cuda.synchronize()
    return step, arrays, pre_calls, step_calls


def compare_density(what, kernel, plain, pack, qp, qn, r, n_plain):
    """kernel(pack, qp, qn, r) against plain(...) on the first n_plain
    queries: counts equal, flux within rtol 1e-5 / atol 1e-6 of the flux
    scale.  Returns (kernel result, differ, max_abs_err, plain ms)."""
    kf, kc = kernel(pack, qp, qn, r)
    torch.cuda.synchronize()
    (pf_, pc), plain_ms = once_ms(
        lambda: plain(pack, qp[:n_plain], qn[:n_plain], r))
    differ = int((kc[:n_plain] != pc).sum())
    scale = float(pf_.abs().max())
    err = float((kf[:n_plain] - pf_).abs().max())
    if differ:
        raise AssertionError(f"{what}: {differ} counts differ from plain")
    if not torch.allclose(kf[:n_plain], pf_, rtol=1e-5, atol=1e-6 * scale):
        raise AssertionError(f"{what}: flux beyond rtol 1e-5 (err {err})")
    return (kf, kc), differ, err, plain_ms


def valid_photons(pack: dict) -> int:
    """Photons of a flash pack not at the sentinel (the pairs the brute
    force needs per query)."""
    return int((pack["pos_t"][0] < 0.5 * pf.SENTINEL).sum())


def check_density(what: str, args, photons) -> dict:
    """density_flash on one of the path's sorted packs (the warp-per-query
    search) against density_flash_plain on its flash view (every query:
    counts equal, flux rtol 1e-5), against the brute-force kernel over the
    same photons in their original order (`photons`, the pack's recorded
    arguments), and against itself (two calls bit for bit); ms, and
    ms_before the brute force's.  The bound counts the pairs of the
    clusters within each query's radius and one box test a cluster;
    bound_ms_before the brute force's pairs."""
    pack, qp, qn, r = args
    if pf.pack_layout(pack) != "sorted":
        raise AssertionError(f"density_flash ({what}): the path's pack is "
                             "not the sorted layout")
    n = qp.shape[0]
    (kf, kc), differ, err, plain_ms = compare_density(
        "density_flash", pf.density_flash,
        lambda p, *a: pf.density_flash_plain(pf.flash_view(p), *a),
        pack, qp, qn, r, n)
    af, ac = pf.density_flash(pack, qp, qn, r)
    brute = pf.make_photon_pack(*photons)
    bf, bc = pf.density_flash(brute, qp, qn, r)
    torch.cuda.synchronize()
    repeat = int(((af != kf).any(dim=1) | (ac != kc)).sum())
    differ_b = int((bc != kc).sum())
    err_b = float((bf - kf).abs().max())
    if brute["pos_t"].shape[1] != pack["tbl"].shape[1] or differ_b or repeat:
        raise AssertionError(f"density_flash ({what}): {differ_b} counts "
                             f"differ from the brute force's, {repeat} "
                             "from a second call")
    if not torch.allclose(kf, bf, rtol=1e-5, atol=1e-6 * float(
            bf.abs().max())):
        raise AssertionError(f"density_flash ({what}): flux beyond rtol 1e-5 "
                             f"of the brute force's (err {err_b})")
    kernel = lambda: pf.density_flash(pack, qp, qn, r)  # noqa: E731
    ms = device_ms(kernel, calls=3, replays=3)
    ms_before = device_ms(lambda: pf.density_flash(brute, qp, qn, r),
                          calls=2, replays=3)
    pairs, boxes = pf.culled_pair_tests(pack, qp, r)
    bnd = bound(DENSITY_OPS * pairs + BOX_D2_OPS * boxes,
                nbytes(pack["tbl"][0:9], pack["cl_lo"], pack["cl_hi"], qp,
                       qn) + 4 * n + 16 * n,
                pair_tests=pairs, box_tests=boxes)
    pairs_b = n * valid_photons(brute)
    bnd_b = bound(DENSITY_OPS * pairs_b,
                  nbytes(brute, qp, qn) + 4 * n + 16 * n)
    regs = registers("photon_flash", "density_sorted_kernel")
    phase("kernel", name="density_flash", gather=what, queries=n,
          photons=int(pack["n_valid"]), pack=pack["tbl"].shape[1],
          clusters=pack["cl_lo"].shape[0], radius=r,
          counted=int(kc.sum()), differ=differ, max_abs_err=err,
          differ_vs_brute=differ_b, max_abs_err_vs_brute=err_b,
          repeat_differ=repeat,
          tolerance="counts equal; flux rtol 1e-5, atol 1e-6*scale",
          ms=round(ms, 4), ms_before=round(ms_before, 4),
          call_ms=round(call_ms(kernel, 3), 4),
          plain_ms=round(plain_ms, 4),
          plain="density_flash_plain on the flash view, one eager call",
          **regs, clusters_per_query=round(pairs / pf.BP / n, 3),
          bound_ms_before=bnd_b["bound_ms"], pair_tests_before=pairs_b,
          **bnd)
    return dict(ms=ms, plain_ms=plain_ms, err=err, ms_before=ms_before,
                bound=bnd, bound_before=bnd_b, regs=regs)


def check_photon_kernels(pre_calls, step_calls) -> list:
    """density_flash at both of the path's shapes (the step's caustic
    gather, the first radiance-map precompute gather: `check_density`), and
    nearest_flash at the step's first final-gather lookup: the culled
    search on the path's sorted pack against the brute-force kernel on the
    same photons in their original order, on every query (found and best
    d2 equal, values rtol 1e-5), each kernel against its plain version on
    the first PLAIN_QUERIES queries."""
    caustic = next(a for name, a in step_calls if name == "density_auto")
    nearest = next(a for name, a in step_calls if name == "nearest_flash")
    radiance = next(a for name, a in pre_calls if name == "density_auto")
    diffuse_photons, caustic_photons = (
        a for name, a in pre_calls if name == "make_photon_pack_auto")
    photons = next(a for name, a in pre_calls
                   if name == "make_photon_pack_lookup")
    out = {what: check_density(what, args, raw) for what, args, raw in (
        ("caustic", caustic, caustic_photons),
        ("radiance", radiance, diffuse_photons))}

    pack, qp, r = nearest
    if "tbl" not in pack:
        raise AssertionError("nearest_flash: the path's radiance pack is "
                             "not the sorted layout")
    flash = pf.make_photon_pack(*photons)
    n = PLAIN_QUERIES
    nq = qp.shape[0]
    kv, kbest = pf.nearest_flash_best(pack, qp, r)
    bv, bbest = pf.nearest_flash_best(flash, qp, r)
    torch.cuda.synchronize()
    kfound = torch.isfinite(kbest)
    scale = float(bv.abs().max())
    differ_b = int((kbest != bbest).sum())
    err_b = float((kv - bv).abs().max())
    if differ_b or not torch.allclose(kv, bv, rtol=1e-5, atol=1e-6 * scale):
        raise AssertionError(f"nearest_flash: {differ_b} best d2 differ from "
                             f"the brute-force kernel's, value err {err_b}")
    err, differ_p = 0.0, 0
    plain_ms = {}
    for what, kernel_v, kernel_best, plain, p in (
            ("culled", kv, kbest, pf.nearest_culled_plain, pack),
            ("brute", bv, bbest, pf.nearest_flash_plain, flash)):
        (pv, pfound), plain_ms[what] = once_ms(lambda: plain(p, qp[:n], r))
        differ = int((torch.isfinite(kernel_best[:n]) != pfound).sum())
        e = float((kernel_v[:n] - pv).abs().max())
        err, differ_p = max(err, e), max(differ_p, differ)
        if differ or not torch.allclose(kernel_v[:n], pv, rtol=1e-5,
                                        atol=1e-6 * scale):
            raise AssertionError(f"nearest_flash ({what}): {differ} found "
                                 f"flags differ from plain, value err {e}")
    kernel = lambda: pf.nearest_flash(pack, qp, r)  # noqa: E731
    brute = lambda: pf.nearest_flash(flash, qp, r)  # noqa: E731
    ms_n = device_ms(kernel, calls=4, replays=3)
    ms_brute = device_ms(brute, calls=2, replays=3)
    ms_n_sub = device_ms(lambda: pf.nearest_flash(pack, qp[:n], r),
                         calls=5, replays=3)
    moved = nbytes(pack["tbl"][0:3], pack["tbl"][6:10], pack["cl_lo"],
                   pack["cl_hi"], qp) + 4 * nq + 16 * nq
    pairs, boxes = pf.nearest_pair_tests(pack, qp, r, kbest)
    bnd = bound(NEAREST_OPS * pairs + BOX_D2_OPS * boxes, moved,
                pair_tests=pairs, box_tests=boxes)
    pairs_b = nq * valid_photons(flash)
    bnd_b = bound(NEAREST_OPS * pairs_b,
                  nbytes(flash["pos_t"], flash["val"], qp) + 4 * nq + 16 * nq)
    phase("kernel", name="nearest_flash", queries=nq,
          photons=pack["tbl"].shape[1], clusters=pack["cl_lo"].shape[0],
          radius=r, compared_queries=n, found=int(kfound.sum()),
          differ=differ_p, differ_vs_brute=differ_b, max_abs_err=err,
          max_abs_err_vs_brute=err_b,
          tolerance="found, best d2 equal; value rtol 1e-5",
          ms=round(ms_n, 4), ms_before=round(ms_brute, 4),
          call_ms=round(call_ms(kernel, 4), 4),
          ms_on_compared=round(ms_n_sub, 4),
          plain_ms=round(plain_ms["culled"], 4),
          plain_ms_brute=round(plain_ms["brute"], 4),
          plain=f"one eager call on the first {n} queries",
          bound_ms_before=bnd_b["bound_ms"], pair_tests_before=pairs_b,
          clusters_per_query=round(pairs / pf.BP / nq, 3), **bnd)
    c, rd = out["caustic"], out["radiance"]
    return [
        dict(name="density_flash", route="cuda",
             source=SRC.format("photon_flash"), replaces=FLASH.format(104),
             max_abs_err=max(c["err"], rd["err"]), ms=c["ms"],
             plain_ms=c["plain_ms"], ms_before=c["ms_before"],
             bound_ms_before=c["bound_before"]["bound_ms"],
             ms_radiance=rd["ms"], plain_ms_radiance=rd["plain_ms"],
             ms_before_radiance=rd["ms_before"],
             bound_ms_radiance=rd["bound"]["bound_ms"],
             bound_ms_before_radiance=rd["bound_before"]["bound_ms"],
             **c["regs"], **c["bound"]),
        dict(name="nearest_flash", route="cuda",
             source=SRC.format("photon_flash"), replaces=FLASH.format(123),
             max_abs_err=err, ms=ms_n, plain_ms=plain_ms["culled"],
             plain_queries=n, ms_on_plain_queries=ms_n_sub,
             ms_brute=ms_brute, bound_ms_brute=bnd_b["bound_ms"],
             pair_tests_brute=pairs_b, **bnd),
    ]


def check_culled_kernel(calls) -> dict:
    """density_culled on the scale route's culled diffuse pack and its
    radiance-map queries: counts equal to density_flash_plain's and
    density_culled_plain's on the first PLAIN_CULLED_QUERIES queries, and
    to the flash kernel's over the same sorted photons and density_flash's
    warp-per-query search over the same pack on all of them; and the culled
    nearest search over that pack (thousands of clusters) against the
    brute-force kernel in best d2."""
    pack, qp, qn, r = next(a for name, a in calls if name == "density_auto"
                           and pf.pack_layout(a[0]) == "culled")
    n = PLAIN_CULLED_QUERIES
    (kf, kc), differ, err, plain_ms = compare_density(
        "density_culled", pf.density_culled, pf.density_culled_plain,
        pack, qp, qn, r, n)
    compare_density("density_culled vs flash plain", pf.density_culled,
                    lambda p, *a: pf.density_flash_plain(pf.flash_view(p),
                                                         *a),
                    pack, qp, qn, r, n)
    flat = pf.flash_view(pack)
    (ff, fc), flash_ms = once_ms(lambda: pf.density_flash(flat, qp, qn, r))
    (_, wc), warp_ms = once_ms(lambda: pf.density_flash(pack, qp, qn, r))
    if not (torch.equal(fc, kc) and torch.equal(wc, kc)):
        raise AssertionError("density_culled: counts differ from the flash "
                             "kernel's or the warp search's over the same "
                             "photons")
    # the nearest search over the same pack: thousands of clusters, many
    # sweeps of 256; its best d2 equals the brute force's over the photons
    _, nbest = pf.nearest_flash_best(pack, qp, r)
    _, fbest = pf.nearest_flash_best(flat, qp, r)
    if not torch.equal(nbest, fbest):
        raise AssertionError("nearest_flash: best d2 over the culled pack "
                             "differs from the brute-force kernel's")
    kernel = lambda: pf.density_culled(pack, qp, qn, r)  # noqa: E731
    ms = device_ms(kernel, calls=3, replays=3)
    nq = qp.shape[0]
    pairs, boxes = pf.culled_pair_tests(pack, qp, r)
    bnd = bound(DENSITY_OPS * pairs + BOX_D2_OPS * boxes,
                nbytes(pack["tbl"][0:9], pack["cl_lo"], pack["cl_hi"], qp,
                       qn) + 4 * nq + 16 * nq,
                pair_tests=pairs, box_tests=boxes)
    phase("kernel", name="density_culled", queries=qp.shape[0],
          photons=int(pack["n_valid"]), pack=pack["tbl"].shape[1],
          clusters=pack["cl_lo"].shape[0], radius=r, compared_queries=n,
          counted=int(kc.sum()), differ=differ, max_abs_err=err,
          flux_differ_vs_flash_kernel=int((kf != ff).any(dim=1).sum()),
          nearest_found=int(torch.isfinite(nbest).sum()),
          nearest_differ_vs_brute=int((nbest != fbest).sum()),
          tolerance="counts equal; flux rtol 1e-5, atol 1e-6*scale",
          ms=round(ms, 4), call_ms=round(call_ms(kernel, 3), 4),
          flash_kernel_ms=round(flash_ms, 4),
          warp_search_ms=round(warp_ms, 4), plain_ms=round(plain_ms, 4),
          plain=f"density_culled_plain, one eager call on the first {n} "
                "queries", **bnd)
    return dict(name="density_culled", route="cuda",
                source=SRC.format("photon_flash"),
                replaces=FLASH.format(330), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, plain_queries=n, **bnd)


def photon_launch_counts(cfg, maps_info) -> dict:
    """Launches a timed photon render makes (its warm-up step included):
    per step fg_samples nearest lookups, one caustic density, raydepth + 1
    + fg_samples closest hits and one NEE shadow batch per light; at
    preprocess one density per 65,536 radiance queries and one closest
    hit per bounce slot of every photon pass."""
    steps = cfg.aa_samples + 1
    passes = sum(maps_info[m]["passes"] for m in ("diffuse", "caustic"))
    return dict(
        density_flash=steps + -(-maps_info["radiance"]["queries"]
                                // photonmap.RADIANCE_QUERIES),
        nearest_flash=steps * cfg.fg_samples,
        closest_hit_tiny=steps * (cfg.raydepth + 1 + cfg.fg_samples)
        + passes * (cfg.photon_bounces + 1),
        shadow_logsum_tiny=steps)


def photon_path(smi) -> dict:
    """cornell_photon.xml at its own settings through the entry point."""
    scene = parse_xml_file(PHOTON)
    cfg = build_config(scene)
    res, launches = counted(
        lambda: render_scene(scene, device="cuda", timed=True))
    info = res.stats["photon_maps"]
    img = res.image
    phase("photon_maps", preprocess_s=round(res.stats["preprocess_s"], 4),
          **{m: info[m] for m in ("diffuse", "caustic", "radiance")})
    want = photon_launch_counts(cfg, info)
    phase("photon_path", size=f"{cfg.width}x{cfg.height}",
          spp=cfg.aa_samples, raydepth=cfg.raydepth,
          photons=cfg.photons, caustic_photons=cfg.caustic_photons,
          fg_samples=cfg.fg_samples,
          render_s=round(res.stats["render_s"], 4),
          preprocess_s=round(res.stats["preprocess_s"], 4),
          rays=res.stats["rays"], mrays_per_s=round(res.mrays_per_sec, 3),
          launches=launches, expected_launches=want,
          image_mean=float(img.mean()), gpu=repr(smi))
    if not np.all(np.isfinite(img)) or img.min() < 0.0 or img.mean() <= 0:
        raise AssertionError("photon_path: image is not finite, >= 0, lit")
    for k, v in want.items():
        if launches[k] != v:
            raise AssertionError(f"photon_path: {k} launched {launches[k]} "
                                 f"times, expected {v}")
    return res, launches


def photon_golden() -> None:
    """cornell.xml with the golden's photonmapping overrides
    against the stored golden."""
    golden = read_exr(PHOTON_GOLDEN)
    gs = golden.shape[0]
    cs, cc = photon_scene(CORNELL, "cuda", size=gs, **GOLDEN_PHOTON)
    img = photonmap.render_photonmap(cs, cc, device="cuda").image
    rmse = float(np.sqrt(np.mean((img - golden) ** 2)))
    phase("photon_golden", size=f"{gs}x{gs}", spp=cc.aa_samples,
          photons=cc.photons, caustic_photons=cc.caustic_photons,
          fg_samples=cc.fg_samples, raydepth=cc.raydepth, rmse=rmse,
          bound=0.02)
    if not rmse < 0.02:
        raise AssertionError(f"photon golden RMSE {rmse} >= 0.02")


def photon_card_vs_cpu() -> None:
    """The same photon render on the card (kernels) and the CPU (plain
    versions): image RMSE <= 1e-3, stored photons and rays within 0.1%."""
    out = {}
    for dev in ("cuda", "cpu"):
        cs, cc = photon_scene(PHOTON, dev, **CARD_VS_CPU_PHOTON)
        out[dev] = photonmap.render_photonmap(cs, cc, device=dev)
    rmse = float(np.sqrt(np.mean((out["cuda"].image
                                  - out["cpu"].image) ** 2)))
    rel = {}
    for what, get in (
            ("rays", lambda r: r.stats["rays"]),
            ("stored_diffuse",
             lambda r: r.stats["photon_maps"]["diffuse"]["stored"]),
            ("stored_caustic",
             lambda r: r.stats["photon_maps"]["caustic"]["stored"])):
        a, b = get(out["cuda"]), get(out["cpu"])
        rel[what] = (a, b, abs(a - b) / max(b, 1.0))
    phase("photon_card_vs_cpu", **CARD_VS_CPU_PHOTON, rmse=rmse, bound=1e-3,
          **{k: f"{a}/{b} rel={r}" for k, (a, b, r) in rel.items()},
          rel_bound=1e-3)
    if not (rmse <= 1e-3 and all(r <= 1e-3 for _, _, r in rel.values())):
        raise AssertionError("photon_card_vs_cpu: card and CPU disagree")


def photon_scale(cs, cc, smi) -> int:
    """The scale route: 2,000,000 diffuse photons store over
    CULL_MIN_PHOTONS, so the diffuse pack takes the culled layout and the
    radiance-map precompute runs density_culled.  The image is held
    against the same render with the diffuse and caustic packs forced onto
    the flash layout (the brute-force kernel)."""
    res, launches = counted(
        lambda: photonmap.render_photonmap(cs, cc, device="cuda"))
    info = res.stats["photon_maps"]["diffuse"]
    cull_min = pf.CULL_MIN_PHOTONS
    photonmap.make_photon_pack_auto = pf.make_photon_pack
    try:
        flash = photonmap.render_photonmap(cs, cc, device="cuda")
    finally:
        photonmap.make_photon_pack_auto = pf.make_photon_pack_auto
    if {flash.stats["photon_maps"][m]["layout"]
            for m in ("diffuse", "caustic")} != {"flash"}:
        raise AssertionError("photon_scale: the forced render is not flash")
    rmse = float(np.sqrt(np.mean((res.image - flash.image) ** 2)))
    phase("photon_scale", size=f"{cc.width}x{cc.height}", spp=cc.aa_samples,
          photons=cc.photons, diffuse=info,
          preprocess_s=round(res.stats["preprocess_s"], 4),
          flash_preprocess_s=round(flash.stats["preprocess_s"], 4),
          launches=launches, rmse_vs_flash=rmse, bound=1e-5,
          gpu=repr(smi))
    if info["layout"] != "culled" or info["stored"] < cull_min:
        raise AssertionError("photon_scale: the diffuse pack is not culled")
    if launches["density_culled"] < 1:
        raise AssertionError("photon_scale: density_culled never launched")
    if not rmse <= 1e-5:
        raise AssertionError(f"photon_scale: RMSE vs flash {rmse} > 1e-5")
    return launches["density_culled"]


def photon_phases(smi) -> list:
    """Slice 3: the photon kernels against their plain versions at the
    path's shapes, the full-width path through the entry point, one
    profiled step, the golden, the card against the CPU, and the scale
    route with the culled kernel."""
    t0 = time.perf_counter()
    cs, cfg = photon_scene(PHOTON, "cuda")
    phase("photon_scene", tris=cs.static.n_tris_real,
          spheres=cs.static.n_spheres,
          compile_s=round(time.perf_counter() - t0, 3),
          integrator=cfg.integrator, size=f"{cfg.width}x{cfg.height}",
          spp=cfg.aa_samples, filter=cfg.filter_type)
    step, arrays, pre_calls, step_calls = photon_inputs(cs, cfg)
    kernels = check_photon_kernels(pre_calls, step_calls)
    del pre_calls, step_calls

    res, launches = photon_path(smi)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    profile("photon_profile", res, step, arrays, cfg, PHOTON_TAGS, smi)
    del step, arrays

    photon_golden()
    photon_card_vs_cpu()

    scs, scfg = photon_scene(PHOTON, "cuda", **SCALE)
    _, scalls = gather_calls(lambda: photonmap.install_photon_maps(
        scs, scfg, to_tensors(scs.arrays, "cuda")))
    culled = check_culled_kernel(scalls)
    del scalls
    culled["launches"] = photon_scale(scs, scfg, smi)
    return kernels + [culled]


# ---- slice 4: mid-size meshes (the dense and streaming kernels) -----------


def step_calls(cscene, cfg, module, names: tuple):
    """One sample step on the card with the wrappers `names` of `module`
    recording their arguments, in call order (per path vertex a closest
    hit, the first on the primary rays, and an NEE shadow batch, the first
    at bounce 0: light samples x pixels).  Returns (step, arrays, {name:
    [args, ...]})."""
    step, arrays = path_step(cscene, cfg)
    dev = engine.resolve_device("cuda")
    flags = torch.ones((cfg.height, cfg.width), dtype=torch.bool, device=dev)
    _, calls = record_calls(module, names, lambda: step(
        arrays, _fresh_film(cfg, dev), flags))
    torch.cuda.synchronize()
    return step, arrays, {n: [a for k, a in calls if k == n] for n in names}


def check_mid_closest(kind: str, args, rays: str) -> dict:
    """closest_hit_<kind> against its plain version on recorded rays: hit
    and tri equal after the epilogue, t, u, v within rtol 1e-4."""
    pk, c8, org, dirn, tmin, tmax, n_tris = args
    kernel = getattr(cx, f"closest_hit_{kind}")
    plain = getattr(cx, f"closest_{kind}_plain")
    kt, kcol = kernel(pk, c8, org, dirn, tmin, tmax, n_tris)
    torch.cuda.synchronize()
    (pt, pcol), plain_ms = once_ms(
        lambda: plain(pk, org, dirn, tmin, tmax, n_tris))
    k_hit = fi.closest_epilogue(pk, org, dirn, kt, kcol, n_tris)
    p_hit = fi.closest_epilogue(pk, org, dirn, pt, pcol, n_tris)
    phit = p_hit[4]
    name = f"closest_hit_{kind}"
    if not torch.equal(k_hit[4], phit) or not torch.equal(k_hit[1][phit],
                                                          p_hit[1][phit]):
        raise AssertionError(f"{name}: hit/tri differ from plain ({rays})")
    for what, i in (("t", 0), ("u", 2), ("v", 3)):
        if not torch.allclose(k_hit[i][phit], p_hit[i][phit], rtol=1e-4):
            raise AssertionError(f"{name}: {what} beyond rtol 1e-4 ({rays})")
    n_diff = int(((kt != pt) | (kcol != pcol)).sum())
    err = max(float((k_hit[i][phit] - p_hit[i][phit]).abs().max())
              for i in (0, 2, 3))
    call = lambda: kernel(pk, c8, org, dirn, tmin, tmax, n_tris)  # noqa: E731
    ms = device_ms(call, calls=20, replays=3)
    pairs, boxes = cx.cluster_pair_tests(pk, c8, org, dirn, tmin,
                                         torch.minimum(tmax, kt), n_tris)
    bnd = bound(MT_OPS * pairs + BOX_OPS * boxes,
                nbytes(pk, c8, org, dirn, tmin, tmax, kt, kcol),
                pair_tests=pairs, box_tests=boxes)
    phase("kernel", name=name, rays=rays, n=org.shape[0], tris=n_tris,
          hits=int(phit.sum()), differ=n_diff, max_abs_err=err,
          tolerance="hit,tri equal; t,u,v rtol 1e-4", ms=round(ms, 4),
          call_ms=round(call_ms(call, calls=20), 4),
          plain_ms=round(plain_ms, 4), plain="one eager call", **bnd)
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound=bnd)


def check_mid_shadow(kind: str, args) -> dict:
    """shadow_logsum_<kind> against its plain version on the recorded
    bounce-0 NEE rays: transmission within atol 2e-3."""
    pk, c8, logf, org, dirn, dist, n_tris = args
    kernel = getattr(cx, f"shadow_logsum_{kind}")
    plain = getattr(cx, f"shadow_logsum_{kind}_plain")
    name = f"shadow_logsum_{kind}"
    klg = kernel(pk, c8, logf, org, dirn, dist, n_tris)
    torch.cuda.synchronize()
    plg, plain_ms = once_ms(lambda: plain(pk, logf, org, dirn, dist, n_tris))
    err = float((torch.exp(klg) - torch.exp(plg)).abs().max())
    if err > 2e-3:
        raise AssertionError(f"{name}: transmission off by {err} > 2e-3")
    n_diff = int((klg != plg).any(dim=-1).sum())
    call = lambda: kernel(pk, c8, logf, org, dirn, dist, n_tris)  # noqa: E731
    ms = device_ms(call, calls=10, replays=3)
    pairs, boxes = cx.cluster_pair_tests(pk, c8, org, dirn,
                                         *cx.shadow_limits(dist), n_tris)
    bnd = bound(MT_OPS * pairs + BOX_OPS * boxes,
                nbytes(pk, c8, logf, org, dirn, dist, klg),
                pair_tests=pairs, box_tests=boxes)
    phase("kernel", name=name, rays="bounce-0 NEE", n=org.shape[0],
          tris=n_tris, live=int((dist > 0).sum()),
          opaque=int((klg <= -80.0).all(dim=-1).sum()), differ=n_diff,
          max_abs_err=err, tolerance="transmission atol 2e-3",
          ms=round(ms, 4), call_ms=round(call_ms(call, calls=10), 4),
          plain_ms=round(plain_ms, 4), plain="one eager call", **bnd)
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound=bnd)


def mid_cli(kind: str, path: str, res, smi) -> None:
    """The scene through the port's CLI to an .exr at its own settings: the
    image read back, its --json-stats rays equal to the entry point's
    render's (the CLI's render is untimed, the same steps without the
    warm-up) and its image within RMSE 1e-4 of it."""
    out = os.path.join(os.path.dirname(path), f"{kind}.exr")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([path, out, "--json-stats", "-vl", "warning"])
    stats = json.loads([line for line in buf.getvalue().splitlines()
                        if line.startswith("{")][-1])
    img = read_exr(out)
    rmse = float(np.sqrt(np.mean((img - res.image) ** 2)))
    rel = abs(stats["rays"] - res.stats["rays"]) / max(res.stats["rays"], 1)
    phase(f"{kind}_cli", rc=rc, output=os.path.basename(out),
          shape=img.shape, wall_s=round(stats["wall_s"], 4),
          render_s=round(stats["render_s"], 4), rays=stats["rays"],
          mrays_per_s=round(stats["mrays_per_sec"], 3), rays_rel=rel,
          rmse_vs_path=rmse, bound=1e-4, gpu=repr(smi))
    if rc != 0 or stats["output"] != out or img.shape != res.image.shape:
        raise AssertionError(f"{kind}_cli: no image of the path's shape")
    if not (np.all(np.isfinite(img)) and rel <= 1e-4 and rmse <= 1e-4):
        raise AssertionError(f"{kind}_cli: the CLI's render disagrees")


def mid_phases(scenes: str, smi) -> list:
    """Slice 4: each generated mid-size scene, its kernels against their
    plain versions on recorded rays, the path through the entry point at
    the scene's own settings, the CLI, one profiled step, and the card
    against the CPU."""
    kernels = []
    for kind, g in MID:
        t0 = time.perf_counter()
        path = make_grid(scenes, g, 1)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        scene = parse_xml_file(path)
        cfg = build_config(scene)
        cs = scene.compile(device="cuda")
        a = cs.arrays
        n = cs.static.n_tris_real
        routes = (isect.route(a["tri_pack10"], a["tri_cluster8"], n),
                  isect.route(a["stri_pack10"], a["stri_cluster8"],
                              cs.static.n_stris_real))
        phase(f"{kind}_scene", tris=n, pack=tuple(a["tri_pack10"].shape),
              clusters=a["tri_cluster8"].shape[1],
              sub_clusters=a["tri_sub8"].shape[1], routes=routes,
              generate_s=round(gen_s, 3),
              parse_compile_s=round(time.perf_counter() - t0, 3),
              integrator=cfg.integrator, bounces=cfg.bounces,
              filter=cfg.filter_type, size=f"{cfg.width}x{cfg.height}",
              spp=cfg.aa_samples)
        if routes != (kind, kind):
            raise AssertionError(f"{kind}_scene: routed {routes}")
        names = (f"closest_hit_{kind}", f"shadow_logsum_{kind}")
        step, arrays, calls = step_calls(cs, cfg, cx, names)
        prim = check_mid_closest(kind, calls[names[0]][0], "primary")
        bounce = check_mid_closest(kind, calls[names[0]][1], "bounce 1")
        shad = check_mid_shadow(kind, calls[names[1]][0])
        del calls

        res, launches = counted(
            lambda: render_scene(scene, device="cuda", timed=True))
        others = {k: v for k, v in launches.items() if k not in names and v}
        if others:
            raise AssertionError(f"{kind}_path: off-path kernels {others}")
        check_path(f"{kind}_path", res, cfg,
                   {k: launches[k] for k in names}, smi)
        mid_cli(kind, path, res, smi)
        profile(f"{kind}_profile", res, step, arrays, cfg,
                (f"closest_{kind}_kernel", f"shadow_{kind}_kernel"), smi)
        del step, arrays
        card_vs_cpu(f"{kind}_card_vs_cpu", lambda dev: grid(
            path, MID_CARD_VS_CPU["size"], MID_CARD_VS_CPU["spp"], dev),
            MID_CARD_VS_CPU["size"], MID_CARD_VS_CPU["spp"])

        src = SRC.format("cluster_intersect")
        line = PALLAS.format(308 if kind == "dense" else 592)
        kernels.append(dict(
            name=names[0], route="cuda", source=src, replaces=line,
            launches=launches[names[0]], max_abs_err=max(prim["err"],
                                                         bounce["err"]),
            ms=prim["ms"], plain_ms=prim["plain_ms"],
            ms_bounce=bounce["ms"], plain_ms_bounce=bounce["plain_ms"],
            bound_ms_bounce=bounce["bound"]["bound_ms"], **prim["bound"]))
        kernels.append(dict(
            name=names[1], route="cuda", source=src,
            replaces=PALLAS.format(353 if kind == "dense" else 693),
            launches=launches[names[1]], max_abs_err=shad["err"],
            ms=shad["ms"], plain_ms=shad["plain_ms"], **shad["bound"]))
    return kernels


# ---- slice 5: the pair-granular route -------------------------------------


def ties_only(pack10, org, dirn, col, other, t) -> bool:
    """Where two closest-hit columns differ, the other column gives the
    same t in the kernels' arithmetic: an exact tie."""
    c10 = pack10[:, other.long()]
    t_o, _, _, ok = ci._mt_test(c10, slice(None), *org.unbind(-1),
                                *dirn.unbind(-1))
    return bool(ok.all()) and torch.equal(t_o, t)


def plain_sample(p: int) -> slice:
    """Every k-th slot, at most PLAIN_SLOTS of them: the slots are sorted by
    cluster, so a stride reaches every cluster where a prefix would not."""
    return slice(None, None, -(-p // PLAIN_SLOTS))


def check_pairs_closest(args) -> dict:
    """pairs_closest against its plain version on recorded slots (the
    grid's bounce-1 rays, round 1): t, col and the hits equal on a strided
    sample of at most PLAIN_SLOTS slots, and two calls equal bit for bit;
    ms_before the one-thread body (no sub-box table) on the same slots,
    whose answers must be the same.  The bound counts, per slot, the
    columns of its cluster's sub-clusters entered below min(tmax, its t);
    pair_tests_no_skip the sub-clusters entered below tmax, what the walk
    would test without its skip; bound_ms_before every real column of each
    slot's cluster, what the one-thread body tests."""
    pk, n_cl, sub8, sray, scl, org, dirn, tmin, tmax, n_tris = args
    p = sray.shape[0]
    kt, kcol = pi.pairs_closest(*args)
    at, acol = pi.pairs_closest(*args)
    thread = lambda: pi.pairs_closest(pk, n_cl, None,  # noqa: E731
                                      *args[3:])
    tt, tcol = thread()
    torch.cuda.synchronize()
    repeat = int(((at != kt) | (acol != kcol)).sum())
    differ_thread = int(((tt != kt) | (tcol != kcol)).sum())
    sel = plain_sample(p)
    (pt, pcol), plain_ms = once_ms(lambda: pi.pairs_closest_plain(
        pk, n_cl, sray[sel], scl[sel], org, dirn, tmin, tmax, n_tris))
    kt_s, kcol_s = kt[sel], kcol[sel]
    m = pt.shape[0]
    hit = torch.isfinite(pt)
    if not (torch.equal(torch.isfinite(kt_s), hit)
            and torch.equal(kt_s, pt) and torch.equal(kcol_s, pcol)):
        raise AssertionError("pairs_closest: t, col or hits differ from "
                             "plain")
    if repeat or differ_thread:
        raise AssertionError(f"pairs_closest: {repeat} slots differ from a "
                             f"second call, {differ_thread} from the "
                             "one-thread body")
    err = float((kt_s[hit] - pt[hit]).abs().max()) if hit.any() else 0.0
    call = lambda: pi.pairs_closest(*args)  # noqa: E731
    ms = device_ms(call, calls=5, replays=3)
    ms_before = device_ms(thread, calls=3, replays=3)
    r = sray.long()
    pairs, boxes = pi.slot_pair_tests(sub8, n_cl, sray, scl, org, dirn,
                                      tmin[r], torch.minimum(tmax[r], kt),
                                      n_tris)
    pairs_ns, _ = pi.slot_pair_tests(sub8, n_cl, sray, scl, org, dirn,
                                     tmin[r], tmax[r], n_tris)
    bnd = bound(MT_OPS * pairs + BOX_OPS * boxes,
                nbytes(pk, sub8, sray, scl, org, dirn, tmin, tmax, kt, kcol),
                pair_tests=pairs, box_tests=boxes, slots=p)
    pairs_b = int(fi.real_columns(pk.shape[1] // n_cl, n_cl, n_tris,
                                  pk.device)[scl.long()].sum())
    bnd_b = bound(MT_OPS * pairs_b,
                  nbytes(pk, sray, scl, org, dirn, tmin, tmax, kt, kcol))
    regs = registers("pairs_intersect", "pairs_closest_kernel")
    phase("kernel", name="pairs_closest", rays="bounce 1, round 1",
          n=org.shape[0], tris=n_tris, clusters=n_cl, compared_slots=m,
          compared_stride=sel.step, hits=int(torch.isfinite(kt).sum()),
          differ=int(((kt_s != pt) | (kcol_s != pcol)).sum()),
          repeat_differ=repeat, differ_vs_thread_body=differ_thread,
          max_abs_err=err, tolerance="t, col, hits equal", ms=round(ms, 4),
          ms_before=round(ms_before, 4),
          call_ms=round(call_ms(call, calls=5), 4),
          plain_ms=round(plain_ms, 4),
          plain=f"one eager call on every {sel.step}th slot ({m})",
          **regs, pair_tests_no_skip=pairs_ns,
          bound_ms_before=bnd_b["bound_ms"], pair_tests_before=pairs_b,
          **bnd)
    return dict(name="pairs_closest", route="cuda",
                source=SRC.format("pairs_intersect"),
                replaces=PALLAS.format(1237), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, plain_slots=m, ms_before=ms_before,
                bound_ms_before=bnd_b["bound_ms"], **regs, **bnd)


def check_pairs_shadow(args) -> dict:
    """pairs_shadow against its plain version on recorded slots (the grid's
    bounce-0 NEE rays): transmission within atol 2e-3 on a strided sample
    of at most PLAIN_SLOTS slots.  The bound counts, per slot, the columns
    of its cluster's sub-clusters the segment enters."""
    pk, n_cl, sub8, logf, sray, scl, org, dirn, dist, n_tris = args
    p = sray.shape[0]
    klg = pi.pairs_shadow(*args)
    torch.cuda.synchronize()
    sel = plain_sample(p)
    plg, plain_ms = once_ms(lambda: pi.pairs_shadow_plain(
        pk, n_cl, logf, sray[sel], scl[sel], org, dirn, dist, n_tris))
    klg_s = klg[sel]
    m = plg.shape[0]
    err = float((torch.exp(klg_s) - torch.exp(plg)).abs().max())
    if err > 2e-3:
        raise AssertionError(f"pairs_shadow: transmission off by {err} > "
                             "2e-3")
    call = lambda: pi.pairs_shadow(*args)  # noqa: E731
    ms = device_ms(call, calls=3, replays=3)
    lo, hi = cx.shadow_limits(dist)
    r = sray.long()
    pairs, boxes = pi.slot_pair_tests(sub8, n_cl, sray, scl, org, dirn,
                                      lo[r], hi[r], n_tris)
    bnd = bound(MT_OPS * pairs + BOX_OPS * boxes,
                nbytes(pk, sub8, logf, sray, scl, org, dirn, dist, klg),
                pair_tests=pairs, box_tests=boxes, slots=p)
    phase("kernel", name="pairs_shadow", rays="bounce-0 NEE",
          n=org.shape[0], tris=n_tris, clusters=n_cl, compared_slots=m,
          compared_stride=sel.step,
          differ=int((klg_s != plg).any(dim=-1).sum()),
          max_abs_err=err, tolerance="transmission atol 2e-3",
          ms=round(ms, 4), call_ms=round(call_ms(call, calls=3), 4),
          plain_ms=round(plain_ms, 4),
          plain=f"one eager call on every {sel.step}th slot ({m})", **bnd)
    return dict(name="pairs_shadow", route="cuda",
                source=SRC.format("pairs_intersect"),
                replaces=PALLAS.format(1283), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, plain_slots=m, **bnd)


def compare_routes(what: str, closest, shadow) -> None:
    """The pair route against the fine route on the same rays (closest
    args of `closest_hit_fine`, shadow args of `shadow_logsum_fine`): t and
    hits equal, columns only on exact ties, transmission within atol 2e-3;
    eager ms per call of each (the pair route reads slot and straggler
    counts from the device, so it is not captured in a graph)."""
    pk, cl, sub, org, dirn, tmin, tmax, n_tris = closest
    ft, fcol = fi.closest_hit_fine(*closest)
    pt, pcol = pi.closest_hit_pairs(*closest)
    flip = torch.isfinite(ft) & (pcol != fcol)
    if not torch.equal(pt, ft) or not ties_only(
            pk, org[flip], dirn[flip], pcol[flip], fcol[flip], ft[flip]):
        raise AssertionError(f"{what}: the pair route's closest hits differ "
                             "from the fine route's")
    c_pairs = call_ms(lambda: pi.closest_hit_pairs(*closest), calls=3)
    c_fine = call_ms(lambda: fi.closest_hit_fine(*closest), calls=3)
    flg = fi.shadow_logsum_fine(*shadow)
    plg = pi.shadow_logsum_pairs(*shadow)
    err = float((torch.exp(plg) - torch.exp(flg)).abs().max())
    if err > 2e-3:
        raise AssertionError(f"{what}: pair route transmission off by {err}")
    s_pairs = call_ms(lambda: pi.shadow_logsum_pairs(*shadow), calls=2)
    s_fine = call_ms(lambda: fi.shadow_logsum_fine(*shadow), calls=2)
    phase("pairs_vs_fine", scene=what, closest_rays=org.shape[0],
          hits=int(torch.isfinite(ft).sum()), col_ties=int(flip.sum()),
          closest_pairs_ms=round(c_pairs, 4), closest_fine_ms=round(c_fine, 4),
          shadow_rays=shadow[4].shape[0], shadow_max_abs_err=err,
          shadow_pairs_ms=round(s_pairs, 4), shadow_fine_ms=round(s_fine, 4))


def fine_bounce(closest, fine_kernel: dict) -> None:
    """closest_hit_fine on the grid's recorded bounce-1 rays, where a
    warp's rays share no boxes and the walk order matters: t and col equal
    to the plain brute force on a strided sample, its ms and its bound
    there, added to its kernel entry."""
    pk, cl, sub, org, dirn, tmin, tmax, n_tris = closest
    kt, kcol = fi.closest_hit_fine(*closest)
    torch.cuda.synchronize()
    step = PLAIN_GRID_STRIDE["closest"]
    sample = tuple(x[::step].contiguous() for x in (org, dirn, tmin, tmax))
    (pt, pcol), plain_ms = once_ms(
        lambda: fi.closest_fine_plain(pk, *sample, n_tris))
    differ = int(((kt[::step] != pt) | (kcol[::step] != pcol)).sum())
    if differ:
        raise AssertionError(f"closest_hit_fine: {differ} bounce-1 rays "
                             "differ from plain in t or col")
    ms = device_ms(lambda: fi.closest_hit_fine(*closest), calls=3, replays=3)
    pairs, boxes = fi.fine_pair_tests(cl, sub, org, dirn, tmin,
                                      torch.minimum(tmax, kt), n_tris)
    bnd = bound(MT_OPS * pairs + BOX_OPS * boxes,
                nbytes(pk, cl, sub, org, dirn, tmin, tmax) + 8 * org.shape[0],
                pair_tests=pairs, box_tests=boxes,
                **walk_bracket(cl, sub, org, dirn, tmin, tmax, n_tris))
    phase("kernel", name="closest_hit_fine", rays="bounce 1",
          n=org.shape[0], hits=int(torch.isfinite(kt).sum()),
          compared_rays=pt.shape[0], differ=differ,
          tolerance="t, col equal", ms=round(ms, 4),
          plain_ms=round(plain_ms, 4),
          plain=f"one eager call on every {step}th ray", **bnd)
    fine_kernel.update(ms_bounce=ms, bound_ms_bounce=bnd["bound_ms"],
                       pair_tests_bounce=pairs, box_tests_bounce=boxes)


def fine_bounce_shadow(shadow, fine_kernel: dict) -> None:
    """shadow_logsum_fine on the grid's recorded bounce-1 NEE rays (one
    light sample a pixel, from scattered bounce points: a block's rays
    share few tiles): transmission within atol 2e-3 of the plain brute
    force on a strided sample, its ms and its bound there, added to its
    kernel entry."""
    pk, cl, sub, logf, org, dirn, dist, n_tris = shadow
    lg = fi.shadow_logsum_fine(*shadow)
    torch.cuda.synchronize()
    step = PLAIN_GRID_STRIDE["closest"]
    plg, plain_ms = once_ms(lambda: fi.shadow_logsum_fine_plain(
        pk, logf, *(x[::step].contiguous() for x in (org, dirn, dist)),
        n_tris))
    err = float((torch.exp(lg[::step]) - torch.exp(plg)).abs().max())
    if err > 2e-3:
        raise AssertionError(f"shadow_logsum_fine: bounce-1 transmission off "
                             f"by {err} > 2e-3")
    ms = device_ms(lambda: fi.shadow_logsum_fine(*shadow), calls=3,
                   replays=3)
    pairs, boxes = fi.fine_pair_tests(cl, sub, org, dirn,
                                      *cx.shadow_limits(dist), n_tris)
    bnd = bound(MT_OPS * pairs + BOX_OPS * boxes,
                nbytes(pk, cl, sub, logf, org, dirn, dist, lg),
                pair_tests=pairs, box_tests=boxes)
    phase("kernel", name="shadow_logsum_fine", rays="bounce-1 NEE",
          n=org.shape[0], live=int((dist > 0).sum()),
          compared_rays=plg.shape[0],
          differ=int((lg[::step] != plg).any(dim=-1).sum()),
          max_abs_err=err, tolerance="transmission atol 2e-3",
          ms=round(ms, 4), plain_ms=round(plain_ms, 4),
          plain=f"one eager call on every {step}th ray", **bnd)
    fine_kernel.update(ms_bounce=ms, bound_ms_bounce=bnd["bound_ms"],
                       pair_tests_bounce=pairs, box_tests_bounce=boxes,
                       max_abs_err_bounce=err)


def pairs_path(path: str, gcfg, fine_res, smi):
    """The grid at GRID's settings through render_scene(pairs=True), held to
    slice 2's fine-route render: rays within 0.01%, image RMSE <= 1e-4.
    The pair kernels launch, the fine kernels only for stragglers, no
    other kernel."""
    scene = parse_xml_file(path)
    scene.render_params.update(width=GRID["size"], height=GRID["size"],
                               AA_minsamples=GRID["spp"], AA_passes=1)
    cfg = build_config(scene)
    if cfg != gcfg:
        raise AssertionError("pairs_path: not the grid path's config")
    res, launches = counted(lambda: render_scene(
        scene, device="cuda", timed=True, pairs=True))
    names = ("pairs_closest", "pairs_shadow", "closest_hit_fine",
             "shadow_logsum_fine")
    others = {k: v for k, v in launches.items() if k not in names and v}
    rmse = float(np.sqrt(np.mean((res.image - fine_res.image) ** 2)))
    r_p, r_f = res.stats["rays"], fine_res.stats["rays"]
    rel = abs(r_p - r_f) / max(r_f, 1.0)
    steps = cfg.aa_samples + 1
    phase("pairs_path", size=f"{cfg.width}x{cfg.height}", spp=cfg.aa_samples,
          bounces=cfg.bounces, render_s=round(res.stats["render_s"], 4),
          rays=r_p, mrays_per_s=round(res.mrays_per_sec, 3),
          fine_mrays_per_s=round(fine_res.mrays_per_sec, 3),
          launches={k: launches[k] for k in names},
          launches_per_step={k: launches[k] / steps for k in names},
          rmse_vs_fine=rmse, rays_rel=rel, bound=1e-4, gpu=repr(smi))
    if others:
        raise AssertionError(f"pairs_path: off-path kernels {others}")
    if not (launches["pairs_closest"] and launches["pairs_shadow"]):
        raise AssertionError("pairs_path: a pair kernel never launched")
    if not np.all(np.isfinite(res.image)) or res.image.min() < 0.0:
        raise AssertionError("pairs_path: image is not finite and >= 0")
    if not (rmse <= 1e-4 and rel <= 1e-4):
        raise AssertionError("pairs_path: the pair route's render differs "
                             "from the fine route's")
    return res, launches


def soup131(smi) -> None:
    """The 131,072-triangle random soup (BT 1,024, 128 clusters) with
    262,144 incoherent and coherent rays (`scene/generate.py` make_soup /
    make_rays, the benchmarks' bench_pairs rays and filters), the pair and
    the fine route for
    closest hits and shadows, each against the plain brute force on the
    first 16,384 rays; eager ms per call of each route; and each shadow
    kernel called twice on the same rays or slots, bit-equal."""
    v0, e1, e2 = make_soup(SOUP["tris"])
    n_tris = v0.shape[0]
    pack, cl8, s_ord = ci.build_tri_pack(v0, e1, e2,
                                         ci.morton_order(v0, e1, e2))
    rng = np.random.default_rng(9)
    filt = (rng.random((n_tris, 3))
            * (rng.random((n_tris, 1)) > 0.5)).astype(np.float32)
    tp = pack.shape[1]
    fcols = np.where((np.arange(tp) < n_tris)[None, :], filt[s_ord].T, 1.0)
    dev = "cuda"
    pk = torch.from_numpy(pack).to(dev)
    cl = torch.from_numpy(cl8).to(dev)
    sub = torch.from_numpy(fi.sub_aabbs(pack, n_tris)).to(dev)
    logf = ci.log_filter(torch.from_numpy(
        np.ascontiguousarray(fcols, np.float32)).to(dev))
    n = SOUP["rays"]
    m = PLAIN_QUERIES
    for kind in ("incoherent", "coherent"):
        o, d = (torch.from_numpy(x).to(dev) for x in make_rays(n, kind))
        tmin = torch.full((n,), 1e-3, device=dev)
        tmax = torch.full((n,), 1e9, device=dev)
        dist = torch.from_numpy(rng.uniform(0.3, 1.5, n).astype(np.float32)
                                * 10.0).to(dev)
        closest = (pk, cl, sub, o, d, tmin, tmax, n_tris)
        shadow = (pk, cl, sub, logf, o, d, dist, n_tris)
        bt, bcol = fi.closest_fine_plain(pk, o[:m], d[:m], tmin[:m],
                                         tmax[:m], n_tris)
        blg = fi.shadow_logsum_fine_plain(pk, logf, o[:m], d[:m], dist[:m],
                                          n_tris)
        out = {}
        for route, c_fn, s_fn in (
                ("pairs", pi.closest_hit_pairs, pi.shadow_logsum_pairs),
                ("fine", fi.closest_hit_fine, fi.shadow_logsum_fine)):
            t, col = c_fn(*closest)
            flip = torch.isfinite(bt) & (col[:m] != bcol)
            if not torch.equal(t[:m], bt) or not ties_only(
                    pk, o[:m][flip], d[:m][flip], col[:m][flip], bcol[flip],
                    bt[flip]):
                raise AssertionError(f"soup131 {kind}: {route} closest hits "
                                     "differ from the brute force")
            err = float((torch.exp(s_fn(*shadow)[:m])
                         - torch.exp(blg)).abs().max())
            if err > 2e-3:
                raise AssertionError(f"soup131 {kind}: {route} shadows off "
                                     f"by {err}")
            out[route] = dict(
                col_ties=int(flip.sum()), shadow_err=err,
                closest_ms=round(call_ms(lambda: c_fn(*closest), 2), 4),
                shadow_ms=round(call_ms(lambda: s_fn(*shadow), 2), 4))
        # the soup's filters are not binary, so the order of a sum shows in
        # its last bits: two calls of a shadow kernel must still agree
        lg1, lg2 = (fi.shadow_logsum_fine(*shadow) for _ in range(2))
        _, rec = record_calls(pi, ("pairs_shadow",),
                              lambda: pi.shadow_logsum_pairs(*shadow))
        sl1, sl2 = (pi.pairs_shadow(*rec[0][1]) for _ in range(2))
        repeat = dict(
            shadow_logsum_fine=int((lg1 != lg2).any(dim=-1).sum()),
            pairs_shadow=int((sl1 != sl2).any(dim=-1).sum()))
        phase("soup131", rays=kind, n=n, tris=n_tris,
              clusters=cl.shape[1], sub_clusters=sub.shape[1],
              compared_rays=m, hits=int(torch.isfinite(bt).sum()),
              pairs=out["pairs"], fine=out["fine"],
              partly_lit=int(((lg1 > -80.0) & (lg1 < 0.0)).any(dim=-1).sum()),
              slots=sl1.shape[0], repeat_differ=repeat,
              closest_speedup=out["fine"]["closest_ms"]
              / out["pairs"]["closest_ms"],
              shadow_speedup=out["fine"]["shadow_ms"]
              / out["pairs"]["shadow_ms"], gpu=repr(smi))
        if any(repeat.values()):
            raise AssertionError(f"soup131 {kind}: two calls of a shadow "
                                 f"kernel differ: {repeat}")


def fine_sweeps() -> None:
    """closest_hit_fine on a random soup of more than 256 clusters, where
    its walk takes the cluster boxes in more than one sweep: t and col
    equal to the plain brute force on incoherent rays."""
    v0, e1, e2 = make_soup(SWEEPS["tris"])
    n_tris = v0.shape[0]
    pack, cl8, _ = ci.build_tri_pack(v0, e1, e2, ci.morton_order(v0, e1, e2))
    pk, cl, sub = (torch.from_numpy(x).to("cuda") for x in (
        pack, cl8, fi.sub_aabbs(pack, n_tris)))
    n = SWEEPS["rays"]
    o, d = (torch.from_numpy(x).to("cuda")
            for x in make_rays(n, "incoherent"))
    tmin = torch.full((n,), 1e-3, device="cuda")
    tmax = torch.full((n,), 1e9, device="cuda")
    kt, kcol = fi.closest_hit_fine(pk, cl, sub, o, d, tmin, tmax, n_tris)
    pt, pcol = fi.closest_fine_plain(pk, o, d, tmin, tmax, n_tris)
    differ = int(((kt != pt) | (kcol != pcol)).sum())
    phase("fine_sweeps", tris=n_tris, clusters=cl.shape[1], rays=n,
          hits=int(torch.isfinite(pt).sum()), differ=differ,
          tolerance="t, col equal")
    if cl.shape[1] <= 256 or differ:
        raise AssertionError(f"fine_sweeps: {differ} rays differ from plain "
                             f"over {cl.shape[1]} clusters")


def pairs_phases(scenes: str, grid_path: str, gscene, gcfg, fine_res,
                 fine_kernels, smi) -> list:
    """Slice 5: the pair kernels against their plain versions on slots
    recorded from a grid step, the fine kernels on bounce-1 rays, the two
    routes on the same recorded rays, the grid path through the pair route,
    one profiled step, the card against the CPU on the 10K grid, the soup,
    and the fine closest hit over a pack of several sweeps."""
    _, _, calls = step_calls(gscene, gcfg, fi, ("closest_hit_fine",
                                                "shadow_logsum_fine"))
    fine_bounce(calls["closest_hit_fine"][1], fine_kernels[0])
    fine_bounce_shadow(calls["shadow_logsum_fine"][1], fine_kernels[1])
    compare_routes("grid164k", calls["closest_hit_fine"][1],
                   calls["shadow_logsum_fine"][0])
    del calls

    pscene, _ = grid(grid_path, GRID["size"], GRID["spp"], "cuda",
                     pairs=True)
    step, arrays, calls = step_calls(pscene, gcfg, pi, ("pairs_closest",
                                                        "pairs_shadow"))
    rounds = [a[3].shape[0] for a in calls["pairs_closest"]]
    phase("pairs_slots", closest_per_round=rounds,
          shadow=[a[4].shape[0] for a in calls["pairs_shadow"]])
    kernels = [check_pairs_closest(calls["pairs_closest"][2]),
               check_pairs_shadow(calls["pairs_shadow"][0])]
    del calls

    res, launches = pairs_path(grid_path, gcfg, fine_res, smi)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    profile("pairs_profile", res, step, arrays, gcfg, PAIR_KERNELS, smi,
            stages=PAIR_STAGES)
    del step, arrays

    small = make_grid(scenes, PAIRS_SMALL["grid"], PAIRS_SMALL["subdiv"])
    cs, _ = grid(small, PAIRS_SMALL["size"], PAIRS_SMALL["spp"], "cuda",
                 pairs=True)
    a = cs.arrays
    route = isect.route(a["tri_pack10"], a["tri_cluster8"],
                        cs.static.n_tris_real, cs.static.pairs)
    phase("pairs_small_scene", tris=cs.static.n_tris_real,
          clusters=a["tri_cluster8"].shape[1], route=route)
    if route != "pairs":
        raise AssertionError(f"pairs_small_scene: routed {route}")
    card_vs_cpu("pairs_card_vs_cpu", lambda dev: grid(
        small, PAIRS_SMALL["size"], PAIRS_SMALL["spp"], dev, pairs=True),
        PAIRS_SMALL["size"], PAIRS_SMALL["spp"])

    soup131(smi)
    fine_sweeps()
    return kernels


def main() -> None:
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); nothing was run")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    phase("device", kind=repr(kind), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(_build.build, SOURCES))
    for name, lib in zip(SOURCES, libs):
        _build.load(name)
        phase("build", source=name,
              seconds=round(time.perf_counter() - t0, 3),
              lib=os.path.relpath(lib, REPO))
        with open(lib[:-3] + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print("  ptxas: " + line.strip(), flush=True)

    # 3. kernels vs plain at the main path's shapes
    cscene, cfg = cornell(device="cuda", **MAIN)
    arrays = to_tensors(cscene.arrays, "cuda")
    kernels = check_kernels(cscene, cfg, arrays)

    # 4. main path at full size, through the kernels
    res, launches = render_counted(cscene, cfg, ("closest_hit_tiny",
                                                 "shadow_logsum_tiny"))
    check_path("main_path", res, cfg, launches, smi)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    # 5. where one step's time goes
    profile("profile", res, *path_step(cscene, cfg), cfg, ("tiny_kernel",),
            smi)

    # 6. physics on the card: the stored golden (96², 256 spp)
    golden = read_exr(GOLDEN)
    gs = golden.shape[0]
    cs, cc = cornell(size=gs, spp=64, bounces=6, rr_min_bounces=2,
                     device="cuda")
    rmse_g = float(np.sqrt(np.mean((render(cs, cc, device="cuda").image
                                    - golden) ** 2)))
    phase("golden", size=f"{gs}x{gs}", spp=64, bounces=6, rmse=rmse_g,
          bound=0.02)
    if not rmse_g < 0.02:
        raise AssertionError(f"golden RMSE {rmse_g} >= 0.02")

    # 7. card vs CPU on the same QMC stream
    card_vs_cpu("card_vs_cpu", lambda dev: cornell(
        size=64, spp=4, bounces=4, rr_min_bounces=2, device=dev), 64, 4)

    with tempfile.TemporaryDirectory() as scenes:
        # 8. slice 2: the 164K-triangle grid-spheres scene
        t0 = time.perf_counter()
        path = make_grid(scenes, GRID["grid"], GRID["subdiv"])
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gscene, gcfg = grid(path, GRID["size"], GRID["spp"], "cuda")
        garrays = to_tensors(gscene.arrays, "cuda")
        torch.cuda.synchronize()
        phase("grid_scene", tris=gscene.static.n_tris_real,
              pack=tuple(gscene.arrays["tri_pack10"].shape),
              clusters=gscene.arrays["tri_cluster8"].shape[1],
              sub_clusters=gscene.arrays["tri_sub8"].shape[1],
              generate_s=round(gen_s, 3),
              parse_compile_upload_s=round(time.perf_counter() - t0, 3),
              integrator=gcfg.integrator, bounces=gcfg.bounces,
              filter=gcfg.filter_type)
        fine = check_fine_kernels(gscene, gcfg, garrays)
        del garrays
        res, launches = render_counted(gscene, gcfg, ("closest_hit_fine",
                                                      "shadow_logsum_fine"))
        check_path("grid_path", res, gcfg, launches, smi)
        for k in fine:
            k["launches"] = launches[k["name"]]
        profile("grid_profile", res, *path_step(gscene, gcfg), gcfg,
                ("fine_kernel",), smi)

        # 9. slice 2 card vs CPU on a small generated grid (fine path too)
        small = make_grid(scenes, 2, 2)
        card_vs_cpu("grid_card_vs_cpu", lambda dev: grid(small, 32, 2, dev),
                    32, 2)

        # 10. slice 5: the pair route on the grid, the 10K grid and the soup
        pairs = pairs_phases(scenes, path, gscene, gcfg, res, fine, smi)

        # 11. slice 4: the mid-size scenes on the dense and stream kernels
        mid = mid_phases(scenes, smi)

    # 12. slice 3: photon mapping on cornell_photon.xml
    photon = photon_phases(smi)

    print(json.dumps({"kernels": kernels + fine + photon + mid + pairs}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
