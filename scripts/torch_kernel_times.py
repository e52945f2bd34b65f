"""Device times of the port's redesigned kernels at their paths' shapes, for
one tree of the repository: `closest_hit_fine` and `shadow_logsum_fine` on
the rays a sample step of the 164K-triangle grid scene hands them (the
primary rays and each bounce's; the bounce-0 NEE batch and each bounce's
one-sample launch), `pairs_shadow` on the bounce-0 NEE slots of the same
step on the pair route and `shadow_logsum_fine` on that pass's stragglers,
and `nearest_flash` on a photon step's first final-gather lookup; and, of
one sample step of each of the three paths under `torch.profiler`, the CUDA
kernels launched, the device's busy ms and the ms of the ported kernels.

    python3 scripts/torch_kernel_times.py [--repo DIR]

DIR (default: the tree this script lies in) is the root of a checkout that
holds `chip_smoke.py` and `libyafaray_tpu_torch/`; its kernels are built
into its own build directory.  The script uses only what every tree of the
port since slice 5 has, so two commits are compared on one card by running
it on both inside one job, in turns (parent, change, change, parent):

    git archive --prefix=_archive_check/parent/ <commit> | tar -x
    python3 scripts/torch_kernel_times.py --repo _archive_check/parent
    python3 scripts/torch_kernel_times.py

Each kernel is also held to its plain version on a sample (the wrapper's
CPU route for the photons, the plain brute force on the card for the rays
and slots), each shadow kernel is called twice and the answers compared bit
for bit, and the sums printed per call are equal between two trees that
give the same answers.  Every call replays the arguments its own tree's
step recorded, so a tree whose `pairs_shadow` takes no sub-box table is
called without one.  Times are device ms per call (a CUDA graph of
back-to-back calls between CUDA events, `chip_smoke.device_ms`); a step is
profiled by `chip_smoke.profile_step`.  Prints one line per measurement and
a last JSON line with all of them; needs one NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

PLAIN_RAYS = 16384
PLAIN_SLOTS = 1 << 18
PLAIN_QUERIES = 2048


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    repo = os.path.abspath(ap.parse_args().repo)
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
    out = dict(repo=os.path.relpath(repo), gpu=smi, closest_hit_fine={},
               shadow_logsum_fine={}, pairs_shadow={}, nearest_flash={},
               step={})

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

    def fine_shadow(name, args):
        pk, _, _, logf, org, dirn, dist, n_tris = args
        lg = fi.shadow_logsum_fine(*args)
        sample = slice(None, None, max(1, org.shape[0] // PLAIN_RAYS))
        plain_lg = fi.shadow_logsum_fine_plain(
            pk, logf, *(x[sample].contiguous() for x in (org, dirn, dist)),
            n_tris)
        row = shadow_row(lambda: fi.shadow_logsum_fine(*args), lg, plain_lg,
                         sample, rays=org.shape[0],
                         live=int((dist > 0).sum()))
        out["shadow_logsum_fine"][name] = row
        print(f"[shadow_logsum_fine] rays={name!r} "
              + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)

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
        name = "primary" if vertex == 0 else f"bounce {vertex}"
        out["closest_hit_fine"][name] = row
        print(f"[closest_hit_fine] rays={name!r} "
              + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    for vertex, args in enumerate(calls["shadow_logsum_fine"]):
        fine_shadow(f"bounce-{vertex} NEE", args)
    del calls

    # the pair route: one step, its pair shadow slots and its stragglers
    (step, arrays, calls), stragglers = cs.record_calls(
        fi, ("shadow_logsum_fine",), lambda: cs.step_calls(
            pscene, gcfg, pi, ("pairs_shadow",)))
    profiled("pairs", step, arrays, gcfg, cs.PAIR_KERNELS)
    del step, arrays
    args = calls["pairs_shadow"][0]
    # (pack, clusters, [sub-boxes,] log filters, slot rays, slot clusters,
    # origins, directions, lengths, triangles)
    head, (logf, sray, scl, org, dirn, dist, n_tris) = args[:-7], args[-7:]
    lg = pi.pairs_shadow(*args)
    sample = slice(None, None, max(1, sray.shape[0] // PLAIN_SLOTS))
    plain_lg = pi.pairs_shadow_plain(
        *head[:2], logf, sray[sample].contiguous(), scl[sample].contiguous(),
        org, dirn, dist, n_tris)
    row = shadow_row(lambda: pi.pairs_shadow(*args), lg, plain_lg, sample,
                     slots=sray.shape[0], rays=org.shape[0])
    out["pairs_shadow"]["bounce-0 NEE"] = row
    print("[pairs_shadow] rays='bounce-0 NEE' "
          + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    del calls, lg, plain_lg
    for vertex, (_, args) in enumerate(stragglers):
        fine_shadow(f"pair-route stragglers, bounce-{vertex} NEE", args)
    del stragglers

    pscene, pcfg = cs.photon_scene(cs.PHOTON, "cuda")
    step, arrays, _, step_calls = cs.photon_inputs(pscene, pcfg)
    profiled("photon", step, arrays, pcfg, cs.PHOTON_TAGS)
    del step, arrays
    pack, qp, r = next(a for name, a in step_calls if name == "nearest_flash")
    val, found = pf.nearest_flash(pack, qp, r)
    cpu_pack = {k: v.cpu() for k, v in pack.items()}
    pv, pfound = pf.nearest_flash(cpu_pack, qp[:PLAIN_QUERIES].cpu(), r)
    row = dict(
        queries=qp.shape[0], layout="culled" if "tbl" in pack else "flash",
        found=int(found.sum()), value_sum=float(val.double().sum()),
        found_differ_from_plain=int((found[:PLAIN_QUERIES].cpu()
                                     != pfound).sum()),
        value_max_abs_err=float((val[:PLAIN_QUERIES].cpu() - pv).abs().max()),
        compared=PLAIN_QUERIES,
        ms=cs.device_ms(lambda: pf.nearest_flash(pack, qp, r), calls=3,
                        replays=5))
    out["nearest_flash"] = row
    print("[nearest_flash] " + " ".join(f"{k}={v}" for k, v in row.items()),
          flush=True)
    build = os.path.join(repo, "libyafaray_tpu_torch", "_build")
    for log in sorted(f for f in os.listdir(build) if f.endswith(".log")):
        with open(os.path.join(build, log)) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {log.split('_')[0]}: {line.strip()}",
                          flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
