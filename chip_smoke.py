"""On-card smoke run of the PyTorch + CUDA port (libyafaray_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version at the shapes of the main path, renders the Cornell
pathtracing main path at full size through the kernels, profiles one of
its sample steps with torch.profiler, and checks the physics against the
stored golden and the card against the CPU.  Every phase prints one line;
any failure raises and the script exits non-zero without printing a
result.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

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
from libyafaray_tpu_torch.ops.intersect import Hit  # noqa: E402
from libyafaray_tpu_torch.scene.session import build_config  # noqa: E402
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file  # noqa: E402

CORNELL = os.path.join(REPO, "scenes", "cornell.xml")
GOLDEN = os.path.join(REPO, "scenes", "goldens", "cornell_pathtracing.exr")
SRC = "libyafaray_tpu_torch/csrc/tiny_intersect.cu"
# main path: bench.py config 1
MAIN = dict(size=512, spp=64, bounces=4, rr_min_bounces=2)


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


def main_path_rays(cscene, cfg, arrays):
    """The kernels' inputs at the main path's shapes, made by the engine's
    own functions: the primary camera rays of sample 0 (H·W), and the first
    light's NEE shadow rays from their hit points (16·H·W)."""
    dev = arrays["tri_pack10"].device
    st = cscene.static
    px, py, ph = engine.pixel_lanes(cfg.height, cfg.width, cfg.qmc_seed, dev)
    s_idx = torch.zeros_like(px)
    _, _, org, dirn, wt = engine.camera_rays(cscene.camera, px, py, ph,
                                             s_idx)
    alive = wt > 0.0
    primary = (org.contiguous(), dirn.contiguous(),
               *engine.ray_bounds(st, alive))
    t, tri, u, v, hit = ci.closest_hit_tiny_plain(
        arrays["tri_pack10"], *primary, st.n_tris_real)
    sp = engine._surface_point(arrays, Hit(t, tri, u, v, hit))
    n_sh, ng_sh = engine.shading_frame(sp, -dirn)
    ns = engine.nee_count(st.lights[0], cfg, first=True)
    smp, _, org_s, dist = engine.shadow_rays(
        arrays, st, 0, ns, sp["p"], n_sh, ng_sh, alive & hit, s_idx,
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
        dict(name="closest_hit_tiny", route="cuda", source=SRC,
             replaces="libyafaray_tpu/ops/pallas_intersect.py:2259",
             max_abs_err=err_c, ms=ms_c, plain_ms=plain_ms_c),
        dict(name="shadow_logsum_tiny", route="cuda", source=SRC,
             replaces="libyafaray_tpu/ops/pallas_intersect.py:2281",
             max_abs_err=err_s, ms=ms_s, plain_ms=plain_ms_s),
    ]


def profile_step(cscene, cfg) -> dict:
    """One main-path sample step under torch.profiler, after an unprofiled
    one: its kernel launches, the device's busy milliseconds (the union of
    its kernel and copy intervals), the two ported kernels' milliseconds,
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
        ported_ms=sum(b - a for a, b, n in spans if "tiny_kernel" in n) / 1e3,
        top_ops={e.key: f"{e.device_time_total / 1e3:.4f}ms/{e.count}"
                 for e in ops})


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

    # 2. build
    t0 = time.perf_counter()
    _build.load("tiny_intersect")
    lib = _build.library_path("tiny_intersect")
    phase("build", seconds=round(time.perf_counter() - t0, 3),
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
    ci.closest_hit_tiny.launches = 0
    ci.shadow_logsum_tiny.launches = 0
    res = render_timed(cscene, cfg, device="cuda")
    launches = {"closest_hit_tiny": ci.closest_hit_tiny.launches,
                "shadow_logsum_tiny": ci.shadow_logsum_tiny.launches}
    img = res.image
    steps = cfg.aa_samples + 1  # + the warm-up step
    want = (cfg.bounces + 1) * steps
    phase("main_path", size=f"{cfg.width}x{cfg.height}", spp=cfg.aa_samples,
          bounces=cfg.bounces, render_s=round(res.stats["render_s"], 4),
          rays=res.stats["rays"], mrays_per_s=round(res.mrays_per_sec, 3),
          launches=launches, expected_launches=want, gpu=repr(smi))
    if not np.all(np.isfinite(img)) or img.min() < 0.0:
        raise AssertionError("main path image is not finite and >= 0")
    for k, v in launches.items():
        if v != want:
            raise AssertionError(f"{k}: {v} launches, expected {want}")
    for k in kernels:
        k["launches"] = launches[k["name"]]

    # 5. where one step's time goes
    step_ms = 1e3 * res.stats["render_s"] / cfg.aa_samples
    prof = profile_step(cscene, cfg)
    busy = prof["device_busy_ms"]
    phase("profile", step_ms=round(step_ms, 3), **prof,
          busy_share=(busy / step_ms if isinstance(busy, float)
                      else "not measured"), gpu=repr(smi))

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
    out = {}
    for dev in ("cuda", "cpu"):
        cs, cc = cornell(size=64, spp=4, bounces=4, rr_min_bounces=2,
                         device=dev)
        out[dev] = render(cs, cc, device=dev)
    rmse_c = float(np.sqrt(np.mean((out["cuda"].image
                                    - out["cpu"].image) ** 2)))
    r_gpu, r_cpu = out["cuda"].stats["rays"], out["cpu"].stats["rays"]
    rel = abs(r_gpu - r_cpu) / max(r_cpu, 1.0)
    phase("card_vs_cpu", size="64x64", spp=4, rmse=rmse_c, bound=1e-4,
          rays_gpu=r_gpu, rays_cpu=r_cpu, rays_rel=rel)
    if not (rmse_c <= 1e-4 and rel <= 1e-4):
        raise AssertionError("card and CPU renders disagree")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
