"""On-card smoke run of the PyTorch + CUDA port (libyafaray_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (one nvcc per source, all
started together) and drives the two ported paths through them:
- slice 1, the Cornell pathtracing main path (bench.py config 1): the two
  tiny-scene kernels against their plain PyTorch versions at the path's
  shapes, the 512²·64 spp render, one profiled sample step, the physics
  against the stored golden and the card against the CPU;
- slice 2, the generated 164K-triangle grid-spheres scene (bench.py config
  3, made here by scripts/make_large_scene.py in a subprocess): the two
  large-scene kernels against their plain versions at the path's shapes,
  the 512²·4 spp render, one profiled sample step, and the card against the
  CPU on a small generated grid.
Each path is rendered with every launch counter set to 0 just before it and
read just after.  Every phase prints one line; any failure raises and the
script exits non-zero without printing a result.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
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

from libyafaray_tpu_torch.convert import to_tensors  # noqa: E402
from libyafaray_tpu_torch.core import qmc  # noqa: E402
from libyafaray_tpu_torch.integrators import engine  # noqa: E402
from libyafaray_tpu_torch.integrators.config import RenderConfig  # noqa: E402
from libyafaray_tpu_torch.integrators.render import (  # noqa: E402
    _fresh_film, render, render_timed)
from libyafaray_tpu_torch.io.exr import read_exr  # noqa: E402
from libyafaray_tpu_torch.ops import _build  # noqa: E402
from libyafaray_tpu_torch.ops import cuda_intersect as ci  # noqa: E402
from libyafaray_tpu_torch.ops import fine_intersect as fi  # noqa: E402
from libyafaray_tpu_torch.ops import intersect as isect  # noqa: E402
from libyafaray_tpu_torch.scene.session import build_config  # noqa: E402
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file  # noqa: E402

CORNELL = os.path.join(REPO, "scenes", "cornell.xml")
GOLDEN = os.path.join(REPO, "scenes", "goldens", "cornell_pathtracing.exr")
SOURCES = ("tiny_intersect", "fine_intersect")
SRC = "libyafaray_tpu_torch/csrc/{}.cu"
PALLAS = "libyafaray_tpu/ops/pallas_intersect.py:{}"
# main path: bench.py config 1
MAIN = dict(size=512, spp=64, bounces=4, rr_min_bounces=2)
# slice 2: bench.py config 3 (the scene's own pathtracing settings)
GRID = dict(grid=4, subdiv=4, size=512, spp=4)
# shadow rays the plain brute force is compared and timed on: the first
# (contiguous) light sample of the bounce-0 NEE block, one per pixel
PLAIN_SHADOW_RAYS = 262144


def phase(tag: str, **kv) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


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
    """Generate a grid-spheres scene with the repository's generator, in a
    subprocess (the generator imports the JAX package's mesh module)."""
    path = os.path.join(out_dir, f"grid{grid}_{subdiv}.xml")
    subprocess.run([sys.executable,
                    os.path.join(REPO, "scripts", "make_large_scene.py"),
                    "--grid", str(grid), "--subdiv", str(subdiv),
                    "--out", path], check=True, capture_output=True)
    return path


def grid(path: str, size: int, spp: int, device: str):
    """Slice 2's inputs: parse -> build_config (the scene's own pathtracing
    settings and gauss filter) -> compile."""
    scene = parse_xml_file(path)
    scene.render_params["width"] = size
    scene.render_params["height"] = size
    cfg = build_config(scene)
    cfg = RenderConfig(**{**cfg.__dict__, "width": size, "height": size,
                          "aa_samples": spp, "aa_passes": 1})
    return scene.compile(device=device), cfg


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
    phase("kernel", name="closest_hit_tiny", rays=n_rays,
          hits=int(phit.sum()), differ=n_diff,
          differ_share=n_diff / n_rays, max_abs_err=err_c,
          tolerance="hit,tri equal; t,u,v rtol 1e-4",
          ms=round(ms_c, 4), call_ms=round(call_ms_c, 4),
          plain_ms=round(plain_ms_c, 4),
          bit_equal_expected=n_diff <= 1e-4 * n_rays)

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
    phase("kernel", name="shadow_logsum_tiny", rays=n_sh,
          live=int((shadow[2] > 0).sum()), differ=n_diff_s,
          max_abs_err=err_s, tolerance="transmission atol 2e-3",
          ms=round(ms_s, 4), call_ms=round(call_ms_s, 4),
          plain_ms=round(plain_ms_s, 4))
    return [
        dict(name="closest_hit_tiny", route="cuda",
             source=SRC.format("tiny_intersect"),
             replaces=PALLAS.format(2259), max_abs_err=err_c, ms=ms_c,
             plain_ms=plain_ms_c),
        dict(name="shadow_logsum_tiny", route="cuda",
             source=SRC.format("tiny_intersect"),
             replaces=PALLAS.format(2281), max_abs_err=err_s, ms=ms_s,
             plain_ms=plain_ms_s),
    ]


def check_fine_kernels(cscene, cfg, arrays) -> list:
    """The two large-scene kernels against their plain versions at the grid
    path's shapes: closest hit on the 262,144 primary rays of sample 0
    (hit, tri equal after the epilogue; t, u, v rtol 1e-4), shadows on the
    bounce-0 NEE rays, the plain brute force on their first 262,144."""
    st = cscene.static
    pk, cl, sub = (arrays[k] for k in ("tri_pack10", "tri_cluster8",
                                       "tri_sub8"))
    n_tris = st.n_tris_real
    logf = ci.log_filter(arrays["sfilt4_binary"])
    primary, shadow = main_path_rays(cscene, cfg, arrays)
    org, dirn = primary[0], primary[1]

    kt, kcol = fi.closest_hit_fine(pk, cl, sub, *primary, n_tris)
    torch.cuda.synchronize()
    (pt, pcol), plain_ms_c = once_ms(
        lambda: fi.closest_fine_plain(pk, *primary, n_tris))
    k_hit = fi.closest_epilogue(pk, org, dirn, kt, kcol, n_tris)
    p_hit = fi.closest_epilogue(pk, org, dirn, pt, pcol, n_tris)
    phit = p_hit[4]
    if not torch.equal(k_hit[4], phit) or not torch.equal(k_hit[1][phit],
                                                          p_hit[1][phit]):
        raise AssertionError("closest_hit_fine: hit/tri differ from plain")
    for name, i in (("t", 0), ("u", 2), ("v", 3)):
        if not torch.allclose(k_hit[i][phit], p_hit[i][phit], rtol=1e-4):
            raise AssertionError(f"closest_hit_fine: {name} beyond rtol 1e-4")
    n_diff = int(((kt != pt) | (kcol != pcol)).sum())
    n_rays = kt.shape[0]
    err_c = max(float((k_hit[i][phit] - p_hit[i][phit]).abs().max())
                for i in (0, 2, 3))
    kernel_c = lambda: fi.closest_hit_fine(  # noqa: E731
        pk, cl, sub, *primary, n_tris)
    ms_c = device_ms(kernel_c, calls=5, replays=3)
    call_ms_c = call_ms(kernel_c, calls=5)
    phase("kernel", name="closest_hit_fine", tris=n_tris, rays=n_rays,
          hits=int(phit.sum()), differ=n_diff, max_abs_err=err_c,
          tolerance="hit,tri equal; t,u,v rtol 1e-4",
          ms=round(ms_c, 4), call_ms=round(call_ms_c, 4),
          plain_ms=round(plain_ms_c, 4), plain="one eager call")

    klg = fi.shadow_logsum_fine(pk, cl, sub, logf, *shadow, n_tris)
    torch.cuda.synchronize()
    sub_rays = tuple(x[:PLAIN_SHADOW_RAYS] for x in shadow)
    plg, plain_ms_s = once_ms(
        lambda: fi.shadow_logsum_fine_plain(pk, logf, *sub_rays, n_tris))
    klg_sub = klg[:PLAIN_SHADOW_RAYS]
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
    phase("kernel", name="shadow_logsum_fine", tris=n_tris, rays=n_sh,
          live=int((shadow[2] > 0).sum()), compared_rays=PLAIN_SHADOW_RAYS,
          differ=n_diff_s, max_abs_err=err_s,
          tolerance="transmission atol 2e-3", ms=round(ms_s, 4),
          call_ms=round(call_ms_s, 4), ms_on_compared=round(ms_s_sub, 4),
          plain_ms=round(plain_ms_s, 4),
          plain=f"one eager call on the first {PLAIN_SHADOW_RAYS} rays")
    return [
        dict(name="closest_hit_fine", route="cuda",
             source=SRC.format("fine_intersect"),
             replaces=PALLAS.format(910), max_abs_err=err_c, ms=ms_c,
             plain_ms=plain_ms_c),
        dict(name="shadow_logsum_fine", route="cuda",
             source=SRC.format("fine_intersect"),
             replaces=PALLAS.format(1019), max_abs_err=err_s, ms=ms_s,
             plain_ms=plain_ms_s, rays=n_sh,
             plain_rays=PLAIN_SHADOW_RAYS, ms_on_plain_rays=ms_s_sub),
    ]


def render_counted(cscene, cfg, wrappers: dict):
    """render_timed on the card with the given wrappers' launch counters
    set to 0 just before and read just after."""
    for fn in wrappers.values():
        fn.launches = 0
    res = render_timed(cscene, cfg, device="cuda")
    return res, {k: fn.launches for k, fn in wrappers.items()}


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


def profile_step(cscene, cfg, kernel_tag: str) -> dict:
    """One sample step under torch.profiler, after an unprofiled one: its
    kernel launches, the device's busy milliseconds (the union of its
    kernel and copy intervals), the milliseconds of the ported kernels
    whose names hold `kernel_tag` (in all and per launch, in launch order),
    and the aten ops with the most device time (ms / calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = engine.resolve_device("cuda")
    arrays = to_tensors(cscene.arrays, dev)
    step = engine.make_sample_step(cscene.static, cscene.camera, cfg, dev)
    flags = torch.ones((cfg.height, cfg.width), dtype=torch.bool, device=dev)
    film = step(arrays, _fresh_film(cfg, dev), flags)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(arrays, film, flags)
        torch.cuda.synchronize()
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
    return dict(
        kernel_launches=sum(not n.startswith(("Memcpy", "Memset"))
                            for _, _, n in spans),
        device_busy_ms=busy_us / 1e3,
        ported_ms=sum(b - a for a, b, n in spans if kernel_tag in n) / 1e3,
        ported_calls_ms=[round((b - a) / 1e3, 4) for a, b, n in spans
                         if kernel_tag in n],
        top_ops={e.key: f"{e.device_time_total / 1e3:.4f}ms/{e.count}"
                 for e in ops})


def profile(tag, res, cscene, cfg, kernel_tag, smi) -> None:
    """The profile phase line of a path: one step profiled, its wall time
    the path's unprofiled render_s per sample."""
    step_ms = 1e3 * res.stats["render_s"] / cfg.aa_samples
    prof = profile_step(cscene, cfg, kernel_tag)
    busy = prof["device_busy_ms"]
    phase(tag, step_ms=round(step_ms, 3), **prof,
          busy_share=(busy / step_ms if isinstance(busy, float)
                      else "not measured"), gpu=repr(smi))


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
    res, launches = render_counted(cscene, cfg, {
        "closest_hit_tiny": ci.closest_hit_tiny,
        "shadow_logsum_tiny": ci.shadow_logsum_tiny})
    check_path("main_path", res, cfg, launches, smi)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    # 5. where one step's time goes
    profile("profile", res, cscene, cfg, "tiny_kernel", smi)

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
        res, launches = render_counted(gscene, gcfg, {
            "closest_hit_fine": fi.closest_hit_fine,
            "shadow_logsum_fine": fi.shadow_logsum_fine})
        check_path("grid_path", res, gcfg, launches, smi)
        for k in fine:
            k["launches"] = launches[k["name"]]
        profile("grid_profile", res, gscene, gcfg, "fine_kernel", smi)

        # 9. slice 2 card vs CPU on a small generated grid (fine path too)
        small = make_grid(scenes, 2, 2)
        card_vs_cpu("grid_card_vs_cpu", lambda dev: grid(small, 32, 2, dev),
                    32, 2)

    print(json.dumps({"kernels": kernels + fine}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
