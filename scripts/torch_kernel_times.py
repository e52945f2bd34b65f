"""Device times of the port's redesigned kernels at their paths' shapes, for
one tree of the repository: `closest_hit_fine` and `shadow_logsum_fine` on
the rays a sample step of the 164K-triangle grid scene hands them (the
primary rays and each bounce's; the bounce-0 NEE batch and each bounce's
one-sample launch), `pairs_closest` on the bounce-1 slots of round 1 and
`pairs_shadow` on the bounce-0 NEE slots of the same step on the pair route
and `shadow_logsum_fine` on that pass's stragglers, `density_flash` on a
photon step's caustic gather and on the radiance-map precompute's first
gather, and `nearest_flash` on the step's first final-gather lookup; and,
of one sample step of each of the three paths under `torch.profiler`, the
CUDA kernels launched, the device's busy ms and the ms of the ported
kernels, and the photon maps' build (the preprocess of a photon image:
host ms between synchronizes, the median of five builds, and in one more
under `torch.profiler` the device's busy ms, the host's waits on the device
and its costliest ops).

    python3 scripts/torch_kernel_times.py [--repo DIR] [--out FILE]
                                          [--same-as FILE]

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
         "lg_sum", "below_floor", "counted", "found")
CLOSE = ("flux_sum", "value_sum")
KERNELS = ("closest_hit_fine", "shadow_logsum_fine", "pairs_closest",
           "pairs_shadow", "density_flash", "nearest_flash")


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
    opts = ap.parse_args()
    repo = os.path.abspath(opts.repo)
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_times: no CUDA device")
    sys.path.insert(0, repo)
    import chip_smoke as cs
    from libyafaray_tpu_torch.ops import fine_intersect as fi
    from libyafaray_tpu_torch.ops import pairs_intersect as pi
    from libyafaray_tpu_torch.ops import photon_flash as pf

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = dict(repo=os.path.relpath(repo), gpu=smi, step={},
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

    with tempfile.TemporaryDirectory() as scenes:
        path = cs.make_grid(scenes, cs.GRID["grid"], cs.GRID["subdiv"])
        gscene, gcfg = cs.grid(path, cs.GRID["size"], cs.GRID["spp"], "cuda")
        pscene, _ = cs.grid(path, cs.GRID["size"], cs.GRID["spp"], "cuda",
                            pairs=True)
    step, arrays, calls = cs.step_calls(
        gscene, gcfg, fi, ("closest_hit_fine", "shadow_logsum_fine"))
    profiled("grid", step, arrays, gcfg, ("fine_kernel",))
    del step, arrays
    for vertex, args in enumerate(calls["closest_hit_fine"]):
        pk, _, _, org, dirn, tmin, tmax, n_tris = args
        t, col = fi.closest_hit_fine(*args)
        stride = max(1, org.shape[0] // PLAIN_RAYS)
        pt, pcol = fi.closest_fine_plain(
            pk, *(x[::stride].contiguous() for x in (org, dirn, tmin, tmax)),
            n_tris)
        hit = torch.isfinite(t)
        row = dict(
            rays=org.shape[0], hits=int(hit.sum()),
            t_sum=float(t[hit].double().sum()), col_sum=int(col.long().sum()),
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
        *head[:2], logf, sray[sample].contiguous(), scl[sample].contiguous(),
        org, dirn, dist, n_tris)
    report("pairs_shadow", "bounce-0 NEE", shadow_row(
        lambda: pi.pairs_shadow(*args), lg, plain_lg, sample,
        slots=sray.shape[0], rays=org.shape[0]))
    del calls, lg, plain_lg, t, col, again
    for vertex, (_, args) in enumerate(stragglers):
        fine_shadow(f"pair-route stragglers, bounce-{vertex} NEE", args)
    del stragglers

    pscene, pcfg = cs.photon_scene(cs.PHOTON, "cuda")
    step, arrays, pre_calls, step_calls = cs.photon_inputs(pscene, pcfg)
    profiled("photon", step, arrays, pcfg, cs.PHOTON_TAGS)
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
            ("caustic", next(a for n, a in step_calls if n == "density_auto")),
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
    pack, qp, r = next(a for name, a in step_calls if name == "nearest_flash")
    val, found = pf.nearest_flash(pack, qp, r)
    cpu_pack = {k: v.cpu() for k, v in pack.items()}
    pv, pfound = pf.nearest_flash(cpu_pack, qp[:PLAIN_QUERIES].cpu(), r)
    report("nearest_flash", "final gather", dict(
        queries=qp.shape[0], layout="sorted" if "tbl" in pack else "flash",
        found=int(found.sum()), value_sum=float(val.double().sum()),
        found_differ_from_plain=int((found[:PLAIN_QUERIES].cpu()
                                     != pfound).sum()),
        value_max_abs_err=float((val[:PLAIN_QUERIES].cpu() - pv).abs().max()),
        compared=PLAIN_QUERIES,
        ms=cs.device_ms(lambda: pf.nearest_flash(pack, qp, r), calls=3,
                        replays=5)))
    build = os.path.join(repo, "libyafaray_tpu_torch", "_build")
    for log in sorted(f for f in os.listdir(build) if f.endswith(".log")):
        with open(os.path.join(build, log)) as f:
            for line in f:
                if "registers" in line or "spill" in line:
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
