"""Device times of the port's redesigned kernels at their paths' shapes, for
one tree of the repository: `closest_hit_fine` and `shadow_logsum_fine` on
the rays a sample step of the 164K-triangle grid scene hands them (the
primary rays and each bounce's; the bounce-0 NEE batch and each bounce's
one-sample launch), `pairs_closest` on the bounce-1 slots of round 1 and
`pairs_shadow` on the bounce-0 NEE slots of the same step on the pair route
and `shadow_logsum_fine` on that pass's stragglers, `density_flash` on a
photon step's caustic gather and on the radiance-map precompute's first
gather, and `nearest_flash` on the step's first final-gather lookup; the
four mid-size kernels (`closest_hit_dense` / `shadow_logsum_dense` on the
172-triangle scene, `closest_hit_stream` / `shadow_logsum_stream` on the
652-triangle one) on every call one sample step of their scene makes, and
beside them `closest_hit_tiny` and `shadow_logsum_tiny` on every call of
one step of the Cornell main path (512², 64 spp), and `closest_hit_tiny`
on the first and the last call of a photon step; and, of one sample step
of each of the six
paths under `torch.profiler` (Cornell with the mid-size ones), the CUDA
kernels launched, the device's busy ms and the ms of the ported kernels,
and the photon maps' build (the preprocess of a photon image: host ms
between synchronizes, the median of five builds, and in one more under
`torch.profiler` the device's busy ms, the host's waits on the device and
its costliest ops); and the scale route, `cornell_photon.xml` at its own
512², 16 spp and raydepth with 2,000,000 photons (the diffuse map over
2^20 stored photons takes `density_culled`), rendered with its final
gather and without: the preprocess split into photon shooting, pack
building, the radiance precompute's gathers and the rest, its device busy
ms, `render_s` and Mrays/s, one profiled step, and `density_culled` on
that image's gathers (the precompute's queries, or one step's hit points)
timed, with its launches and its share of the image's device time (the
`culled` path: only `density_culled` at those two shapes, beside the body
it replaced where the tree has it, `_density_culled_before`).

    python3 scripts/torch_kernel_times.py [--repo DIR] [--out FILE]
                                          [--same-as FILE] [--paths P,...]

--paths takes a comma-separated subset of grid, pairs, photon, mid, scale
and culled (default: the first five; mid includes the Cornell step; scale
includes culled); two runs compared by --same-as take the same paths.

DIR (default: the tree this script lies in) is the root of a checkout that
holds `chip_smoke.py` and `libyafaray_tpu_torch/`; its kernels are built
into its own build directory.  The script uses only what every tree of the
port since slice 5 has, so two commits are compared on one card by running
it on both inside one job, in turns (parent, change, change, parent):

    git archive --prefix=_archive_check/parent/ <commit> | tar -x
    python3 scripts/torch_kernel_times.py --repo _archive_check/parent \
        --out parent.json
    python3 scripts/torch_kernel_times.py --same-as parent.json

Each kernel is also held to its plain version on a sample (the wrapper's
CPU route for the nearest lookup, the plain versions on the card for the
rays, slots and densities), the redesigned kernels are called twice and the
answers compared bit for bit, and the sums printed per call are equal
between two trees that give the same answers: --same-as FILE (a JSON line
written by --out) fails unless the counts and sums equal that run's, the
flux and value sums (float32 sums a redesign may reorder) within rtol
1e-5.  Every call replays the arguments its own tree's step recorded, so a
tree whose pair kernels take no sub-box table is called without one, and a
tree whose photon packs are flash gathers through the brute force.  Times
are device ms per call (a CUDA graph of back-to-back calls between CUDA
events, `chip_smoke.device_ms`); a step is profiled by
`chip_smoke.profile_step`.  Prints one line per measurement and a last JSON
line with all of them; needs one NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

PLAIN_RAYS = 16384
PLAIN_SLOTS = 1 << 18
PLAIN_QUERIES = 2048
# what two trees that give the same answers print alike: exactly, and the
# float32 sums whose order a redesign may change, within rtol 1e-5
EXACT = ("rays", "slots", "queries", "live", "hits", "t_sum", "col_sum",
         "u_sum", "v_sum", "lg_sum", "below_floor", "counted", "found")
CLOSE = ("flux_sum", "value_sum")
KERNELS = ("closest_hit_fine", "shadow_logsum_fine", "pairs_closest",
           "pairs_shadow", "density_flash", "nearest_flash",
           "closest_hit_dense", "shadow_logsum_dense", "closest_hit_stream",
           "shadow_logsum_stream", "shadow_logsum_tiny", "closest_hit_tiny",
           "density_culled")
PATHS = ("grid", "pairs", "photon", "mid", "scale", "culled")
SCALE_PHOTONS = 2_000_000


def profiled_ms(fn) -> dict:
    """fn() under torch.profiler: the device's busy milliseconds (the union
    of its kernel and copy intervals), and on the host the CUDA runtime
    calls that wait for the device and the aten ops with the most self CPU
    time (ms / calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if getattr(e, "device_type", None) == DeviceType.CUDA):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    avg = prof.key_averages()
    waits = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
             "cudaMemcpyAsync", "cudaMemcpy")
    ops = sorted((e for e in avg if e.key.startswith("aten::")),
                 key=lambda e: -e.self_cpu_time_total)[:8]
    return dict(
        busy_ms=busy / 1e3,
        host_waits={e.key: f"{e.cpu_time_total / 1e3:.3f}ms/{e.count}"
                    for e in avg if e.key in waits},
        host_ops={e.key: f"{e.self_cpu_time_total / 1e3:.3f}ms/{e.count}"
                  for e in ops})


def split_build(photonmap, build) -> dict:
    """build() (a photon-map build) with photonmap's shooting, compaction,
    pack and gather functions timed on the host between synchronizes:
    ms of the photon passes and compaction (shoot_ms), the packs
    (packs_ms), the radiance precompute's gathers (precompute_ms), the
    rest (other_ms) and in all (total_ms)."""
    spans = collections.defaultdict(float)

    def timed(key, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans[key] += 1e3 * (time.perf_counter() - t0)
            return out
        return call

    keys = dict(compact_photons_device="shoot_ms",
                make_photon_pack_auto="packs_ms",
                make_photon_pack_lookup="packs_ms",
                density_auto="precompute_ms")
    saved = {k: getattr(photonmap, k) for k in (*keys, "make_photon_pass")}
    for k, key in keys.items():
        setattr(photonmap, k, timed(key, saved[k]))
    photonmap.make_photon_pass = lambda *a, **k: timed(
        "shoot_ms", saved["make_photon_pass"](*a, **k))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        build()
        torch.cuda.synchronize()
        total = 1e3 * (time.perf_counter() - t0)
    finally:
        for k, fn in saved.items():
            setattr(photonmap, k, fn)
    out = {k: spans[k] for k in ("shoot_ms", "packs_ms", "precompute_ms")}
    return dict(out, other_ms=total - sum(out.values()), total_ms=total)


def answers_differ(a: dict, b: dict) -> list:
    """The (kernel, call, key) whose answers differ between two runs."""
    bad = []
    for k in KERNELS:
        if a[k].keys() != b[k].keys():
            bad.append((k, sorted(a[k]), sorted(b[k])))
            continue
        for call, row in a[k].items():
            other = b[k][call]
            bad += [(k, call, key) for key in EXACT
                    if key in row and row[key] != other.get(key)]
            bad += [(k, call, key) for key in CLOSE
                    if key in row and not abs(row[key] - other[key])
                    <= 1e-5 * abs(other[key])]
    return bad


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--out", help="write the last JSON line to this file")
    ap.add_argument("--same-as", help="fail unless the answers equal those "
                    "of this --out file")
    ap.add_argument("--paths", default=",".join(PATHS[:-1]),
                    help="comma-separated subset of " + ", ".join(PATHS))
    opts = ap.parse_args()
    paths = opts.paths.split(",")
    if not set(paths) <= set(PATHS):
        raise SystemExit(f"torch_kernel_times: --paths takes {PATHS}")
    repo = os.path.abspath(opts.repo)
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_times: no CUDA device")
    sys.path.insert(0, repo)
    import chip_smoke as cs
    from libyafaray_tpu_torch.ops import cluster_intersect as cx
    from libyafaray_tpu_torch.ops import cuda_intersect as ci
    from libyafaray_tpu_torch.ops import fine_intersect as fi
    from libyafaray_tpu_torch.ops import intersect as isect
    from libyafaray_tpu_torch.ops import pairs_intersect as pi
    from libyafaray_tpu_torch.ops import photon_flash as pf

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = dict(repo=os.path.relpath(repo), gpu=smi, paths=paths, step={},
               **{k: {} for k in KERNELS})

    def profiled(name, step, arrays, cfg, tags):
        prof = cs.profile_step(step, arrays, cfg, tags)
        out["step"][name] = {k: prof[k] for k in (
            "kernel_launches", "device_busy_ms", "ported_ms",
            "ported_by_kernel")}
        print(f"[step] path={name!r} "
              + " ".join(f"{k}={v}" for k, v in out["step"][name].items()),
              flush=True)

    def shadow_row(kernel, lg, plain_lg, sample, **counts):
        """One shadow call's line: sums, the strided sample against the
        plain version, a second call against the first, device ms."""
        again = kernel()
        tr_err = (torch.exp(lg[sample]) - torch.exp(plain_lg)).abs().max()
        return dict(
            **counts, lg_sum=float(lg.double().sum()),
            below_floor=int((lg <= -80.0).all(dim=-1).sum()),
            differ_from_plain=int((lg[sample] != plain_lg).any(dim=-1).sum()),
            transmission_max_abs_err=float(tr_err),
            compared=plain_lg.shape[0],
            repeat_differ=int((again != lg).any(dim=-1).sum()),
            ms=cs.device_ms(kernel, calls=3, replays=5))

    def report(kernel, name, row):
        out[kernel][name] = row
        print(f"[{kernel}] call={name!r} "
              + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)

    def fine_shadow(name, args):
        pk, _, _, logf, org, dirn, dist, n_tris = args
        lg = fi.shadow_logsum_fine(*args)
        sample = slice(None, None, max(1, org.shape[0] // PLAIN_RAYS))
        plain_lg = fi.shadow_logsum_fine_plain(
            pk, logf, *(x[sample].contiguous() for x in (org, dirn, dist)),
            n_tris)
        report("shadow_logsum_fine", name, shadow_row(
            lambda: fi.shadow_logsum_fine(*args), lg, plain_lg, sample,
            rays=org.shape[0], live=int((dist > 0).sum())))

    def closest_row(kernel, args, t, col, **counts):
        """One closest-hit call's line: sums, a strided sample against the
        plain version, a second call against the first, device ms."""
        pk, (org, dirn, tmin, tmax, n_tris) = args[0], args[-5:]
        again = kernel(*args)
        stride = max(1, org.shape[0] // PLAIN_RAYS)
        pt, pcol = fi.closest_fine_plain(
            pk, *(x[::stride].contiguous() for x in (org, dirn, tmin, tmax)),
            n_tris)
        hit = torch.isfinite(t)
        return dict(
            **counts, rays=org.shape[0], hits=int(hit.sum()),
            t_sum=float(t[hit].double().sum()), col_sum=int(col.long().sum()),
            differ_from_plain=int(((t[::stride] != pt)
                                   | (col[::stride] != pcol)).sum()),
            compared=pt.shape[0],
            repeat_differ=int(((again[0] != t) | (again[1] != col)).sum()),
            ms=cs.device_ms(lambda: kernel(*args), calls=3, replays=5))

    def tiny_closest(name, call):
        """closest_hit_tiny on the arguments of a recorded
        `intersect.closest_hit` call (which every tree's engine makes by its
        module attribute): sums, a strided sample against the plain
        version, a second call against the first, device ms."""
        arrays, static, *rays = call
        org, dirn, tmin, tmax = (x.contiguous() for x in rays)
        args = (arrays["tri_pack10"], org, dirn, tmin, tmax,
                static.n_tris_real)
        t, tri, u, v, hit = ci.closest_hit_tiny(*args)
        again = ci.closest_hit_tiny(*args)
        stride = max(1, org.shape[0] // PLAIN_RAYS)
        plain = ci.closest_hit_tiny_plain(
            args[0], *(x[::stride].contiguous()
                       for x in (org, dirn, tmin, tmax)), args[5])
        got = (t, tri, u, v)
        report("closest_hit_tiny", name, dict(
            rays=org.shape[0], hits=int(hit.sum()),
            t_sum=float(t[hit].double().sum()), col_sum=int(tri.long().sum()),
            u_sum=float(u.double().sum()), v_sum=float(v.double().sum()),
            differ_from_plain=int(sum((a[::stride] != b) for a, b in zip(
                got, plain[:4])).bool().sum()),
            compared=plain[0].shape[0],
            repeat_differ=int(sum((a != b) for a, b in zip(
                got, again[:4])).bool().sum()),
            ms=cs.device_ms(lambda: ci.closest_hit_tiny(*args), calls=3,
                            replays=5)))

    def mid_scene(scenes, kind, g):
        """One sample step of a generated mid-size scene (its own settings):
        profiled, and every call of its two kernels timed."""
        from libyafaray_tpu_torch.scene.session import build_config
        from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

        scene = parse_xml_file(cs.make_grid(scenes, g, 1))
        cfg = build_config(scene)
        names = (f"closest_hit_{kind}", f"shadow_logsum_{kind}")
        step, arrays, calls = cs.step_calls(scene.compile(device="cuda"),
                                            cfg, cx, names)
        profiled(kind, step, arrays, cfg,
                 (f"closest_{kind}_kernel", f"shadow_{kind}_kernel"))
        del step, arrays
        closest, shadow = (getattr(cx, n) for n in names)
        for vertex, args in enumerate(calls[names[0]]):
            t, col = closest(*args)
            report(names[0], "primary" if vertex == 0 else f"bounce {vertex}",
                   closest_row(closest, args, t, col))
        for vertex, args in enumerate(calls[names[1]]):
            pk, (logf, org, dirn, dist, n_tris) = args[0], args[-5:]
            lg = shadow(*args)
            sample = slice(None, None, max(1, org.shape[0] // PLAIN_RAYS))
            plain = getattr(cx, f"{names[1]}_plain")
            plain_lg = plain(pk, logf, *(x[sample].contiguous()
                                         for x in (org, dirn, dist)), n_tris)
            report(names[1], f"bounce-{vertex} NEE", shadow_row(
                lambda: shadow(*args), lg, plain_lg, sample,
                rays=org.shape[0], live=int((dist > 0).sum())))

    def cornell_step():
        """One sample step of the Cornell main path: profiled, and every
        call of shadow_logsum_tiny timed (recorded through
        shadow_transmission_tiny, which every tree calls by its module
        attribute)."""
        cscene, cfg = cs.cornell(device="cuda", **cs.MAIN)
        name = "shadow_logsum_tiny"
        (step, arrays, calls), closest = cs.record_calls(
            isect, ("closest_hit",), lambda: cs.step_calls(
                cscene, cfg, ci, ("shadow_transmission_tiny",)))
        profiled("cornell", step, arrays, cfg, ("closest_tiny_kernel",
                                                "shadow_tiny_kernel"))
        del step, arrays
        for vertex, (_, call) in enumerate(closest):
            tiny_closest("primary" if vertex == 0 else f"bounce {vertex}",
                         call)
        for vertex, (pk, filt4, org, dirn, dist, n_tris) in enumerate(
                calls["shadow_transmission_tiny"]):
            logf = ci.log_filter(filt4)
            args = (pk, logf, org, dirn, dist, n_tris)
            lg = ci.shadow_logsum_tiny(*args)
            sample = slice(None, None, max(1, org.shape[0] // PLAIN_RAYS))
            plain_lg = ci.shadow_logsum_tiny_plain(
                pk, logf, *(x[sample].contiguous() for x in (org, dirn, dist)),
                n_tris)
            report(name, f"bounce-{vertex} NEE", shadow_row(
                lambda: ci.shadow_logsum_tiny(*args), lg, plain_lg, sample,
                rays=org.shape[0], live=int((dist > 0).sum())))

    def scale_image(fg: bool, full: bool):
        """The scale route at full size, with (fg) or without final
        gather.  With `full`: the preprocess split (one instrumented build;
        the host ms of three more, their median; one under the profiler:
        busy ms), the timed render (render_s, Mrays/s, launches) and one
        profiled step.  Always: density_culled on this image's culled
        gather (the precompute's queries, or one step's hit points), device
        ms a call, sums, a second call, and where the tree has it the body
        it replaced (ms_before, queries whose counts differ or whose flux
        is beyond rtol 1e-5); with `full` its launches and share of the
        image's device time (preprocess busy + spp x step busy)."""
        from libyafaray_tpu_torch.convert import to_tensors

        name = "scale, final gather" if fg else "scale, no final gather"
        scene, cfg = cs.photon_scene(cs.PHOTON, "cuda", photons=SCALE_PHOTONS,
                                     final_gather=fg)
        step, arrays, pre_calls, step_calls = cs.photon_inputs(scene, cfg)
        culled = [a for n, a in (pre_calls if fg else step_calls)
                  if n == "density_auto" and pf.pack_layout(a[0]) == "culled"]
        del pre_calls, step_calls
        shares = {}
        if full:
            build = lambda: cs.photonmap.build_photon_maps(  # noqa: E731
                scene, cfg, to_tensors(scene.arrays, "cuda"))
            split = split_build(cs.photonmap, build)
            builds = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                build()
                torch.cuda.synchronize()
                builds.append(1e3 * (time.perf_counter() - t0))
            busy_pre = profiled_ms(build)["busy_ms"]
            res, launches = cs.counted(
                lambda: cs.photonmap.render_photonmap_timed(scene, cfg,
                                                            device="cuda"))
            prof = cs.profile_step(step, arrays, cfg,
                                   (*cs.PHOTON_TAGS, "density_culled"))
            out["step"][name] = {k: prof[k] for k in (
                "kernel_launches", "device_busy_ms", "ported_ms",
                "ported_by_kernel")}
            image_ms = busy_pre + cfg.aa_samples * prof["device_busy_ms"]
            info = res.stats["photon_maps"]
            per_image = launches["density_culled"] - (0 if fg else 1)
            row = dict(
                size=f"{cfg.width}x{cfg.height}", spp=cfg.aa_samples,
                raydepth=cfg.raydepth, photons=cfg.photons,
                fg_samples=cfg.fg_samples if fg else 0,
                stored_diffuse=info["diffuse"]["stored"],
                diffuse_layout=info["diffuse"]["layout"],
                preprocess_ms_median=statistics.median(builds),
                preprocess_ms=builds, preprocess_busy_ms=busy_pre,
                **{f"split_{k}": v for k, v in split.items()},
                render_s=res.stats["render_s"], rays=res.stats["rays"],
                mrays_per_s=res.mrays_per_sec,
                preprocess_s=res.stats["preprocess_s"],
                step_busy_ms=prof["device_busy_ms"],
                step_launches=prof["kernel_launches"],
                step_ported=prof["ported_by_kernel"],
                image_device_ms=image_ms, launches=launches,
                density_culled_per_image=per_image)
            print(f"[scale] image={name!r} "
                  + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
            shares = dict(launches_per_image=per_image, image_ms=image_ms)
        del step, arrays
        args = culled[0]
        flux, cnt = pf.density_culled(*args)
        again = pf.density_culled(*args)
        row = dict(
            queries=args[1].shape[0], clusters=args[0]["cl_lo"].shape[0],
            calls_recorded=len(culled), counted=int(cnt.sum()),
            flux_sum=float(flux.double().sum()),
            repeat_differ=int(((again[0] != flux).any(dim=1)
                               | (again[1] != cnt)).sum()),
            ms=cs.device_ms(lambda: pf.density_culled(*args), calls=3,
                            replays=3))
        before = getattr(pf, "_density_culled_before", None)
        if before is not None:
            bf, bc = before(*args)
            far = ~torch.isclose(flux, bf, rtol=1e-5, atol=1e-6 * float(
                bf.abs().max())).all(dim=1)
            row.update(differ_vs_before=int(((cnt != bc) | far).sum()),
                       ms_before=cs.device_ms(lambda: before(*args), calls=2,
                                              replays=3))
        if shares:
            row.update(launches_per_image=shares["launches_per_image"],
                       share_of_image_device_ms=row["ms"]
                       * shares["launches_per_image"] / shares["image_ms"])
        report("density_culled", name, row)
        del culled, args, flux, cnt, again

    with tempfile.TemporaryDirectory() as scenes:
        if "mid" in paths:
            cornell_step()
            for kind, g in cs.MID:
                mid_scene(scenes, kind, g)
        if {"grid", "pairs"} & set(paths):
            path = cs.make_grid(scenes, cs.GRID["grid"], cs.GRID["subdiv"])
            gscene, gcfg = cs.grid(path, cs.GRID["size"], cs.GRID["spp"],
                                   "cuda")
            pscene, _ = cs.grid(path, cs.GRID["size"], cs.GRID["spp"], "cuda",
                                pairs=True)
    if "grid" in paths:
        step, arrays, calls = cs.step_calls(
            gscene, gcfg, fi, ("closest_hit_fine", "shadow_logsum_fine"))
        profiled("grid", step, arrays, gcfg, ("fine_kernel",))
        del step, arrays
        for vertex, args in enumerate(calls["closest_hit_fine"]):
            pk, _, _, org, dirn, tmin, tmax, n_tris = args
            t, col = fi.closest_hit_fine(*args)
            stride = max(1, org.shape[0] // PLAIN_RAYS)
            pt, pcol = fi.closest_fine_plain(
                pk, *(x[::stride].contiguous()
                      for x in (org, dirn, tmin, tmax)), n_tris)
            hit = torch.isfinite(t)
            row = dict(
                rays=org.shape[0], hits=int(hit.sum()),
                t_sum=float(t[hit].double().sum()),
                col_sum=int(col.long().sum()),
                differ_from_plain=int(((t[::stride] != pt)
                                       | (col[::stride] != pcol)).sum()),
                compared=pt.shape[0],
                ms=cs.device_ms(lambda: fi.closest_hit_fine(*args), calls=3,
                                replays=5))
            report("closest_hit_fine",
                   "primary" if vertex == 0 else f"bounce {vertex}", row)
        for vertex, args in enumerate(calls["shadow_logsum_fine"]):
            fine_shadow(f"bounce-{vertex} NEE", args)
        del calls

    if "pairs" in paths:
        # the pair route: one step, its pair slots and its stragglers
        (step, arrays, calls), stragglers = cs.record_calls(
            fi, ("shadow_logsum_fine",), lambda: cs.step_calls(
                pscene, gcfg, pi, ("pairs_closest", "pairs_shadow")))
        profiled("pairs", step, arrays, gcfg, cs.PAIR_KERNELS)
        del step, arrays
        # bounce 1, round 1: (pack, clusters, [sub-boxes,] slot rays, slot
        # clusters, origins, directions, tmin, tmax, triangles)
        args = calls["pairs_closest"][2]
        (pk, n_cl), (sray, scl, org, dirn, tmin, tmax, n_tris) = (args[:2],
                                                                  args[-7:])
        t, col = pi.pairs_closest(*args)
        again = pi.pairs_closest(*args)
        sample = slice(None, None, max(1, sray.shape[0] // PLAIN_SLOTS))
        pt, pcol = pi.pairs_closest_plain(
            pk, n_cl, sray[sample].contiguous(), scl[sample].contiguous(), org,
            dirn, tmin, tmax, n_tris)
        hit = torch.isfinite(t)
        report("pairs_closest", "bounce 1, round 1", dict(
            slots=sray.shape[0], rays=org.shape[0], hits=int(hit.sum()),
            t_sum=float(t[hit].double().sum()), col_sum=int(col.long().sum()),
            differ_from_plain=int(((t[sample] != pt) | (col[sample] != pcol))
                                  .sum()),
            compared=pt.shape[0],
            repeat_differ=int(((again[0] != t) | (again[1] != col)).sum()),
            ms=cs.device_ms(lambda: pi.pairs_closest(*args), calls=3,
                            replays=5)))
        args = calls["pairs_shadow"][0]
        # (pack, clusters, [sub-boxes,] log filters, slot rays, slot clusters,
        # origins, directions, lengths, triangles)
        head, (logf, sray, scl, org, dirn, dist, n_tris) = args[:-7], args[-7:]
        lg = pi.pairs_shadow(*args)
        sample = slice(None, None, max(1, sray.shape[0] // PLAIN_SLOTS))
        plain_lg = pi.pairs_shadow_plain(
            *head[:2], logf, sray[sample].contiguous(),
            scl[sample].contiguous(), org, dirn, dist, n_tris)
        report("pairs_shadow", "bounce-0 NEE", shadow_row(
            lambda: pi.pairs_shadow(*args), lg, plain_lg, sample,
            slots=sray.shape[0], rays=org.shape[0]))
        del calls, lg, plain_lg, t, col, again
        for vertex, (_, args) in enumerate(stragglers):
            fine_shadow(f"pair-route stragglers, bounce-{vertex} NEE", args)
        del stragglers

    if "photon" in paths:
        pscene, pcfg = cs.photon_scene(cs.PHOTON, "cuda")
        step, arrays, pre_calls, step_calls = cs.photon_inputs(pscene, pcfg)
        profiled("photon", step, arrays, pcfg, cs.PHOTON_TAGS)
        flags = torch.ones((pcfg.height, pcfg.width), dtype=torch.bool,
                           device="cuda")
        _, closest = cs.record_calls(isect, ("closest_hit",), lambda: step(
            arrays, cs._fresh_film(pcfg, "cuda"), flags))
        for name, (_, call) in (("photon step, first", closest[0]),
                                ("photon step, last", closest[-1])):
            tiny_closest(f"{name} of {len(closest)}", call)
        del closest
        build = lambda: cs.photonmap.build_photon_maps(  # noqa: E731
            pscene, pcfg, arrays)
        builds = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            build()
            torch.cuda.synchronize()
            builds.append(1e3 * (time.perf_counter() - t0))
        prof = profiled_ms(build)
        out["step"]["photon"].update(preprocess_ms=statistics.median(builds),
                                     preprocess_busy_ms=prof["busy_ms"])
        print(f"[preprocess] build_photon_maps_ms={builds} "
              + " ".join(f"{k}={v}" for k, v in prof.items()), flush=True)
        del step, arrays
        for name, args in (
                ("caustic", next(a for n, a in step_calls
                                 if n == "density_auto")),
                ("radiance precompute",
                 next(a for n, a in pre_calls if n == "density_auto"))):
            pack, qp, qn, r = args
            flux, cnt = pf.density_flash(*args)
            again = pf.density_flash(*args)
            m = min(qp.shape[0], 8 * PLAIN_QUERIES)
            pflux, pcnt = pf.density_flash_plain(
                pf.flash_view(pack) if "tbl" in pack else pack, qp[:m], qn[:m],
                r)
            report("density_flash", name, dict(
                queries=qp.shape[0],
                layout="sorted" if "tbl" in pack else "flash",
                counted=int(cnt.sum()), flux_sum=float(flux.double().sum()),
                count_differ_from_plain=int((cnt[:m] != pcnt).sum()),
                flux_max_abs_err=float((flux[:m] - pflux).abs().max()),
                compared=m,
                repeat_differ=int(((again[0] != flux).any(dim=1)
                                   | (again[1] != cnt)).sum()),
                ms=cs.device_ms(lambda: pf.density_flash(*args), calls=3,
                                replays=5)))
        del pre_calls
        pack, qp, r = next(a for name, a in step_calls
                           if name == "nearest_flash")
        val, found = pf.nearest_flash(pack, qp, r)
        cpu_pack = {k: v.cpu() for k, v in pack.items()}
        pv, pfound = pf.nearest_flash(cpu_pack, qp[:PLAIN_QUERIES].cpu(), r)
        report("nearest_flash", "final gather", dict(
            queries=qp.shape[0], layout="sorted" if "tbl" in pack else "flash",
            found=int(found.sum()), value_sum=float(val.double().sum()),
            found_differ_from_plain=int((found[:PLAIN_QUERIES].cpu()
                                         != pfound).sum()),
            value_max_abs_err=float((val[:PLAIN_QUERIES].cpu()
                                     - pv).abs().max()),
            compared=PLAIN_QUERIES,
            ms=cs.device_ms(lambda: pf.nearest_flash(pack, qp, r), calls=3,
                            replays=5)))
    if {"scale", "culled"} & set(paths):
        for fg in (True, False):
            scale_image(fg, full="scale" in paths)
    build = os.path.join(repo, "libyafaray_tpu_torch", "_build")
    for log in sorted(f for f in os.listdir(build) if f.endswith(".log")):
        with open(os.path.join(build, log)) as f:
            for line in f:
                if any(w in line for w in ("Compiling entry", "registers",
                                           "spill")):
                    print(f"  ptxas {log.split('_')[0]}: {line.strip()}",
                          flush=True)
    print(json.dumps(out), flush=True)
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(out, f)
    if opts.same_as:
        with open(opts.same_as) as f:
            bad = answers_differ(out, json.load(f))
        if bad:
            raise SystemExit(f"torch_kernel_times: answers differ from "
                             f"{opts.same_as}: {bad}")
        print(f"[same_as] {opts.same_as}: counts and sums equal", flush=True)


if __name__ == "__main__":
    main()
