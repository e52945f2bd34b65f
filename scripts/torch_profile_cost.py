"""Where the time of a chip_smoke.py `*_profile` phase goes, on the card.

A profile phase renders two sample steps, the second under torch.profiler,
then reads the trace (chip_smoke.py `profile_step`).  This script times
each part of that for one scene's path step: the unprofiled step, the
profiled step with the profiler's start and stop, the parse of the trace
into events (`prof.events()`), the walk over them (the device spans), the
per-op summary (`prof.key_averages()`), the same profile's summary read
from the raw trace as `profile_step` now reads it (`trace_events`,
`trace_summary`), checked equal field by field to the summary from the
parsed events, and the whole `profile_step` call; it prints one JSON line
per scene.  With --cpu-threads it also times the
CPU half of a card-against-CPU phase (cornell_lights.xml through
render_scene on the CPU, 32², 4 spp, pathtracing) at torch's default
thread count and at one thread, in turns.

    python3 scripts/torch_profile_cost.py [--scenes ibl lights surfaces]
        [--cpu-threads]

Needs a CUDA device; builds the kernels of chip_smoke.py's SOURCES first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs_mod  # noqa: E402
from libyafaray_tpu_torch.integrators import engine  # noqa: E402
from libyafaray_tpu_torch.integrators.render import _fresh_film  # noqa: E402
from libyafaray_tpu_torch.ops import _build  # noqa: E402
from libyafaray_tpu_torch.scene.session import build_config  # noqa: E402

SCENES = {"ibl": cs_mod.IBL, "lights": cs_mod.LIGHTS,
          "surfaces": cs_mod.SURFACES}


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def events_summary(prof, kernel_tags: tuple) -> dict:
    """profile_step's fields read from torch's parsed events
    (`prof.events()`, `prof.key_averages()`): the reading that
    trace_summary replaced."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA)
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
    return dict(
        kernel_launches=sum(not n.startswith(("Memcpy", "Memset"))
                            for _, _, n in spans),
        device_busy_ms=busy_us / 1e3,
        ported_ms=sum(ms for _, ms in ported),
        ported_calls_ms=[round(ms, 4) for _, ms in ported],
        ported_by_kernel={t: f"{sum(v):.4f}ms/{len(v)}"
                          for t, v in by_tag.items()},
        top_ops={e.key: f"{e.device_time_total / 1e3:.4f}ms/{e.count}"
                 for e in ops})


def measure(path: str) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scene = cs_mod.scene_at(path)
    cfg = build_config(scene)
    cscene = scene.compile(device="cuda")
    step, arrays = cs_mod.path_step(cscene, cfg)
    dev = engine.resolve_device("cuda")
    flags = torch.ones((cfg.height, cfg.width), dtype=torch.bool, device=dev)
    film, warm_s = timed(lambda: step(arrays, _fresh_film(cfg, dev), flags))
    _, step_s = timed(lambda: step(arrays, film, flags))
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(arrays, film, flags)
        torch.cuda.synchronize()
    profiled_s = time.perf_counter() - t0
    tags = ("closest", "shadow")
    t0 = time.perf_counter()
    lean = cs_mod.trace_summary(cs_mod.trace_events(prof), tags, None)
    lean_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    old = events_summary(prof, tags)
    old_s = time.perf_counter() - t0
    differ = sorted(k for k in old if old[k] != lean.get(k))
    events, events_s = timed(lambda: prof.events())
    t0 = time.perf_counter()
    spans = [e for e in events
             if getattr(e, "device_type", None) == DeviceType.CUDA]
    walk_s = time.perf_counter() - t0
    ops, key_avg_s = timed(lambda: sorted(
        (e for e in prof.key_averages() if e.key.startswith("aten::")
         and e.device_time_total > 0), key=lambda e: -e.device_time_total))
    _, whole_s = timed(lambda: cs_mod.profile_step(
        step, arrays, cfg, ("kernel",)))
    return dict(scene=os.path.relpath(path, REPO), size=cfg.width,
                warm_step_s=warm_s, step_s=step_s, profiled_step_s=profiled_s,
                events=len(events), device_spans=len(spans),
                events_s=events_s, walk_s=walk_s, key_averages_s=key_avg_s,
                top_op=ops[0].key if ops else None,
                profile_step_s=whole_s, trace_summary_s=lean_s,
                events_summary_s=old_s, fields_differ=differ,
                launches=lean.get("kernel_launches"),
                busy_ms=lean.get("device_busy_ms"),
                top_ops_lean=lean.get("top_ops"),
                top_ops_events=old.get("top_ops"))


def cpu_threads() -> dict:
    """Seconds of one CPU render (the CPU half of a card-vs-CPU phase) at
    the default thread count and at one thread, default, 1, 1, default."""
    from libyafaray_tpu_torch.scene.session import render_scene

    default = torch.get_num_threads()

    def run(n):
        torch.set_num_threads(n)
        s = cs_mod.scene_at(cs_mod.LIGHTS, dict(width=32, height=32,
                                                AA_minsamples=4))
        t0 = time.perf_counter()
        img = render_scene(s, device="cpu").image
        return time.perf_counter() - t0, img

    out = {}
    for n in (default, 1, 1, default):
        sec, img = run(n)
        out.setdefault(f"threads_{n}_s", []).append(sec)
        out.setdefault(f"threads_{n}_image_sum", float(img.sum()))
    torch.set_num_threads(default)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenes", nargs="+", default=list(SCENES),
                    choices=list(SCENES))
    ap.add_argument("--cpu-threads", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_cost: no CUDA device")
    os.chdir(REPO)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for name in cs_mod.SOURCES:
        _build.build(name)
        _build.load(name)
    for name in args.scenes:
        print(json.dumps(dict(measure(SCENES[name]), gpu=smi)), flush=True)
    if args.cpu_threads:
        print(json.dumps(dict(cpu_threads(), gpu=smi)), flush=True)


if __name__ == "__main__":
    main()
