"""Run kernels of csrc/ on the CPU, for checking their logic where there is
no card: a build of csrc/tiny_intersect.cu, csrc/cluster_intersect.cu and
csrc/photon_flash.cu with g++ against a stand-in for the CUDA runtime, in
which every CUDA thread of a block is a host thread (std::thread), a
__syncthreads a std::barrier, and the atomics are host atomics; shared
memory is static storage, used by one block at a time.  The closest hits
(`closest_tiny_kernel`, `closest_dense_kernel`, and the one-thread bodies
they replaced) and `shadow_tiny_kernel` are then held to their plain
versions bit for bit on the Cornell box, a 64-triangle soup, the generated
172-triangle scene and a 300-triangle soup (rays from points inside each
scene, rays aimed at shared edges, dead rays); `density_culled_kernel` and
the body it replaced to `density_culled_plain` on a sorted pack of 300,000
photons in two far-apart clumps (counts equal, flux rtol 1e-5), once with
the kernel's list window and once with a window of 32 clusters (the list's
overflow path), which must give the same bits.

    python3 scripts/cpu_emulate_kernels.py [--cap N]

--cap N builds the closest hits' item lists N long (a short list runs the
overflow path).  In the two intersection sources the warp collectives are
emulated per thread (__activemask() is the thread's own lane); in
photon_flash.cu they are exchanges between the 32 host threads of a warp
(a std::barrier a warp), and a cp.async copy lands only when its thread
waits for it.  This checks what each thread computes, not how fast a warp
does it; no time it prints means anything for the card.  Needs g++ with
C++20; exits non-zero if any kernel differs from its plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from libyafaray_tpu_torch.ops import cluster_intersect as cx  # noqa: E402
from libyafaray_tpu_torch.ops import cuda_intersect as ci  # noqa: E402
from libyafaray_tpu_torch.ops import photon_flash as pf  # noqa: E402
from libyafaray_tpu_torch.scene.generate import grid_spheres_xml  # noqa: E402
from libyafaray_tpu_torch.scene.xml_parser import (  # noqa: E402
    parse_xml_file, parse_xml_string)

RUNTIME = r"""
#pragma once
#include <math.h>
#include <string.h>
#include <algorithm>
#include <atomic>
#include <barrier>
#include <functional>
#include <memory>
#include <thread>
#include <tuple>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
struct float4 { float x, y, z, w; };
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;
inline std::barrier<>* emu_barrier = nullptr;
typedef void* cudaStream_t;
enum cudaError { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError cudaGetLastError() { return cudaSuccess; }
template <class K> cudaError cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 1; return cudaSuccess;
}
template <class K>
cudaError cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, K, int, int) {
  *v = 1; return cudaSuccess;
}
#define __syncthreads() emu_barrier->arrive_and_wait()
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline unsigned __float_as_uint(float f) {
  unsigned u; __builtin_memcpy(&u, &f, 4); return u;
}
inline float __uint_as_float(unsigned u) {
  float f; __builtin_memcpy(&f, &u, 4); return f;
}
inline unsigned __activemask() { return 1u << (threadIdx.x & 31); }
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
#ifdef EMU_WARPS
// every lane's value, exchanged through slots between two warp barriers
inline unsigned long long emu_slots[1024];
inline void emu_share(unsigned long long v, unsigned long long* all) {
  const int w = threadIdx.x >> 5;
  emu_slots[threadIdx.x] = v;
  emu_warp_barriers[w]->arrive_and_wait();
  for (int k = 0; k < 32; ++k) all[k] = emu_slots[32 * w + k];
  emu_warp_barriers[w]->arrive_and_wait();
}
template <class T> T emu_pick(T v, int src) {
  unsigned long long u = 0, all[32];
  memcpy(&u, &v, sizeof(T));
  emu_share(u, all);
  T out;
  memcpy(&out, &all[src & 31], sizeof(T));
  return out;
}
template <class T> T __shfl_sync(unsigned, T v, int src) {
  return emu_pick(v, src);
}
template <class T> T __shfl_xor_sync(unsigned, T v, int off) {
  return emu_pick(v, (int)(threadIdx.x & 31) ^ off);
}
inline unsigned __ballot_sync(unsigned, int p) {
  unsigned long long all[32];
  emu_share(p != 0, all);
  unsigned m = 0;
  for (int k = 0; k < 32; ++k) m |= all[k] ? 1u << k : 0u;
  return m;
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  unsigned long long all[32];
  emu_share(v, all);
  return (unsigned)*std::min_element(all, all + 32);
}
#else
template <class T> T __shfl_sync(unsigned, T v, int) { return v; }
inline unsigned __reduce_min_sync(unsigned, unsigned v) { return v; }
inline unsigned __ballot_sync(unsigned, int p) { return p; }
template <class T> T __shfl_xor_sync(unsigned, T v, int) { return v; }
#endif
inline int __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
// cp.async: a copy is queued and lands when its thread waits for it
#define EMULATED_ASYNC_COPY
inline thread_local std::vector<std::tuple<void*, const void*, int>>
    emu_copies;
inline void cp_async16(void* d, const void* s) {
  emu_copies.emplace_back(d, s, 16);
}
inline void cp_async4(void* d, const void* s) {
  emu_copies.emplace_back(d, s, 4);
}
inline void cp_async_wait_all() {
  for (auto& [d, s, n] : emu_copies) memcpy(d, s, n);
  emu_copies.clear();
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned long long atomicMin(unsigned long long* p,
                                    unsigned long long v) {
  unsigned long long o = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v < o && !__atomic_compare_exchange_n(p, &o, v, false,
                                               __ATOMIC_SEQ_CST,
                                               __ATOMIC_SEQ_CST)) {}
  return o;
}
using std::min;
using std::max;
inline void emu_launch(long long grid, int block, std::function<void()> fn) {
  gridDim.x = (unsigned)grid;
  blockDim.x = block;
  for (long long b = 0; b < grid; ++b) {
    blockIdx.x = (unsigned)b;
    std::barrier<> bar(block);
    emu_barrier = &bar;
    emu_warp_barriers.clear();
    for (int w = 0; 32 * w < block; ++w) {
      emu_warp_barriers.push_back(
          std::make_unique<std::barrier<>>(std::min(32, block - 32 * w)));
    }
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t) {
      threads.emplace_back([&, t] { threadIdx.x = t; fn(); });
    }
    for (auto& th : threads) th.join();
  }
}
"""
# (library, source, extra g++ flags, #define rewrites)
BUILDS = (("tiny_intersect", "tiny_intersect", (), ()),
          ("cluster_intersect", "cluster_intersect", (), ()),
          ("photon_flash", "photon_flash", ("-DEMU_WARPS",), ()),
          ("photon_flash_window32", "photon_flash", ("-DEMU_WARPS",),
           (("CULL_MASK_WORDS", 1),)))
LAUNCH = re.compile(r"(\w+(?:<\w+>)?)<<<([^,]+),\s*([^,>]+)(?:,[^>]*)?>>>"
                    r"(\((?:[^()]|\((?:[^()]|\([^()]*\))*\))*\))", re.S)


def build(out: str, cap: int | None) -> dict:
    """Copy csrc/ into `out`, rewrite its launches and dynamic shared memory
    for the stand-in runtime, build each of BUILDS; {library: CDLL}."""
    csrc = os.path.join(REPO, "libyafaray_tpu_torch", "csrc")
    for f in os.listdir(csrc):
        shutil.copy(os.path.join(csrc, f), out)
    with open(os.path.join(out, "cuda_runtime.h"), "w") as f:
        f.write(RUNTIME)
    for hdr in ("column_walk.cuh", "warp_walk.cuh"):
        hp = os.path.join(out, hdr)
        with open(hp) as f:
            h = f.read()
        with open(hp, "w") as f:
            f.write(h.replace("#include <cuda_runtime.h>",
                              '#include "cuda_runtime.h"'))
    libs = {}
    for name, source, flags, defines in BUILDS:
        with open(os.path.join(csrc, f"{source}.cu")) as f:
            src = f.read()
        src = src.replace("#include <cuda_runtime.h>",
                          '#include "cuda_runtime.h"')
        src = src.replace("extern __shared__ float4 sm4[];",
                          "static float4 sm4[16384];")
        src = src.replace("extern __shared__ float sm[];",
                          "static float sm[65536];")
        src = LAUNCH.sub(r"emu_launch((\2), (\3), [&]{ \1\4; })", src)
        if cap is not None:
            src = re.sub(r"#define (DENSE|TINY)_ITEMS \d+",
                         rf"#define \1_ITEMS {cap}", src)
        for key, value in defines:
            src, k = re.subn(rf"#define {key} \d+", f"#define {key} {value}",
                             src)
            if k != 1:
                raise SystemExit(f"cpu_emulate_kernels: no #define {key}")
        path = os.path.join(out, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(out, f"lib{name}.so")
        subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off",
                        "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
                        *flags, "-I", out, "-o", lib, "-x", "c++", path],
                       check=True)
        libs[name] = ctypes.CDLL(lib)
    return libs


def cases(rng) -> list:
    """(name, pack10, cluster8, n_tris, org, dir, tmin, tmax)."""
    out = []
    cs = parse_xml_file(os.path.join(REPO, "scenes", "cornell.xml")).compile(
        device="cpu")
    grid = parse_xml_string(grid_spheres_xml(1, 1, 2, 16)).compile(
        device="cpu")
    soups = {}
    for n_tris, spread in ((64, 2.0), (300, 4.0)):
        v0 = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
        e1 = rng.normal(0, 0.5, (n_tris, 3)).astype(np.float32)
        e2 = rng.normal(0, 0.5, (n_tris, 3)).astype(np.float32)
        soups[n_tris] = ci.build_tri_pack(v0, e1, e2,
                                          ci.morton_order(v0, e1, e2))[:2]
    for name, pack, c8, n_tris, centre in (
            ("cornell", cs.arrays["tri_pack10"], cs.arrays["tri_cluster8"],
             cs.static.n_tris_real, 2.75),
            ("soup64", *soups[64], 64, 0.0),
            ("grid1", grid.arrays["tri_pack10"], grid.arrays["tri_cluster8"],
             grid.static.n_tris_real, 2.75),
            ("soup300", *soups[300], 300, 0.0)):
        n = 700
        org = (centre + rng.uniform(-2.5, 2.5, (n, 3))).astype(np.float32)
        d = rng.normal(size=(n, 3))
        # aim every other ray of the last 200 at an edge's midpoint or a
        # vertex: exact ties where triangles share it
        k = rng.integers(0, n_tris, 200)
        aim = pack[0:3, k].T + 0.5 * (np.arange(200) % 2)[:, None] * (
            pack[3:6, k].T)
        d[-200:] = aim - org[-200:]
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        tmin = np.full(n, 5e-5, np.float32)
        tmax = np.full(n, np.inf, np.float32)
        tmax[::7] = 1.5
        tmax[::11] = -1.0
        out.append((name, np.ascontiguousarray(pack), np.ascontiguousarray(c8),
                    n_tris, org, d, tmin, tmax))
    return out


def culled_case(rng) -> tuple:
    """A sorted pack of 300,000 photons (10% invalid) in two clumps 10
    apart on every axis, and 2,000 queries with radii 0.05-0.3: most on
    photons of either clump, a tenth anywhere in the box that holds both
    (their Morton runs jump, so tile boxes grow)."""
    n, nq = 300_000, 2000
    centre = np.where(rng.random(n)[:, None] < 0.5, 0.0, 10.0)
    pos = (centre + rng.normal(0.0, 1.0, (n, 3))).astype(np.float32)
    dirs = rng.normal(size=(n, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(
        np.float32)
    power = rng.random((n, 3)).astype(np.float32)
    valid = rng.random(n) > 0.1
    pack = pf.make_photon_pack_sorted(*(torch.from_numpy(x) for x in (
        pos, valid, dirs, power)))
    qp = pos[rng.integers(0, n, nq)] + rng.normal(0.0, 0.05, (nq, 3))
    qp[::10] = rng.uniform(-3.0, 13.0, (nq // 10, 3))
    qn = rng.normal(size=(nq, 3))
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    radius = rng.uniform(0.05, 0.3, nq)
    return pack, *(torch.from_numpy(x.astype(np.float32))
                   for x in (qp, qn, radius))


def check_culled(libs: dict, rng) -> int:
    """density_culled_kernel (its list window as built, and a window of 32
    clusters) and the body it replaced against density_culled_plain: the
    counts that differ, plus the queries whose flux is beyond rtol 1e-5 /
    atol 1e-6 of the flux scale, plus those where the two windows' bits
    differ."""
    P, I = ctypes.c_void_p, ctypes.c_int
    pack, qp, qn, radius = culled_case(rng)
    tbl, lo, hi = pack["tbl"], pack["cl_lo"], pack["cl_hi"]
    n, n_cl = qp.shape[0], lo.shape[0]
    want_f, want_c = pf.density_culled_plain(pack, qp, qn, radius)
    words, cand, listed = pf.culled_tile_lists(pack, qp, radius)
    print(f"[culled] {n} queries, {n_cl} clusters, {int(want_c.sum())} "
          f"photons counted; a tile's near words mean "
          f"{float(words.sum(1).float().mean()):.1f} of {words.shape[1]}, "
          f"candidates mean "
          f"{float(cand.sum(1).float().mean()):.1f} max "
          f"{int(cand.sum(1).max())}, listed mean "
          f"{float(listed.sum(1).float().mean()):.1f} max "
          f"{int(listed.sum(1).max())}", flush=True)
    r2 = radius * radius
    perm = pf.cull_order(pack, qp)
    qs, ns, r2s = (x[perm].contiguous() for x in (qp, qn, r2))
    blk = pf._query_blocks(qs, r2s)
    wbox = pf._word_boxes(lo, hi)
    runs = {}
    for entry, lib, args in (
            ("density_culled", "photon_flash", (qp, qn, r2, perm, wbox)),
            ("density_culled", "photon_flash_window32",
             (qp, qn, r2, perm, wbox)),
            ("density_culled_before", "photon_flash", (qs, ns, r2s, blk))):
        fn = getattr(libs[lib], f"{entry}_launch")
        fn.argtypes = [P, I, P, P, I, *[P] * len(args), I, P, P, P]
        flux, cnt = torch.empty((n, 3)), torch.empty(n)
        code = fn(tbl.data_ptr(), tbl.shape[1], lo.data_ptr(), hi.data_ptr(),
                  n_cl, *(x.data_ptr() for x in args), n, flux.data_ptr(),
                  cnt.data_ptr(), None)
        if entry == "density_culled_before":
            flux[perm], cnt[perm] = flux.clone(), cnt.clone()
        runs[(entry, lib)] = flux, cnt
        scale = float(want_f.abs().max())
        far = ~torch.isclose(flux, want_f, rtol=1e-5,
                             atol=1e-6 * scale).all(dim=1)
        diff = int((cnt != want_c).sum()) + int(far.sum()) + abs(code)
        print(f"[culled] {entry} ({lib}): {diff} queries differ "
              f"(launch {code}, flux max abs err "
              f"{float((flux - want_f).abs().max()):.3g})", flush=True)
        runs["bad"] = runs.get("bad", 0) + diff
    (f1, c1), (f2, c2) = (runs[("density_culled", lib)] for lib in (
        "photon_flash", "photon_flash_window32"))
    same = int(((f1 != f2).any(dim=1) | (c1 != c2)).sum())
    print(f"[culled] density_culled, window 32 vs its own: {same} queries "
          "differ in any bit", flush=True)
    return runs["bad"] + same


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cap", type=int, default=None)
    opts = ap.parse_args()
    torch.set_num_threads(1)
    bad = 0
    with tempfile.TemporaryDirectory() as out:
        libs = build(out, opts.cap)
        tiny, clu = libs["tiny_intersect"], libs["cluster_intersect"]
        P, I = ctypes.c_void_p, ctypes.c_int
        for fn in (tiny.closest_hit_tiny_launch,
                   tiny.closest_hit_tiny_before_launch):
            fn.argtypes = [P, I, I, P, P, P, P, I, P, P, P, P, P]
        for fn in (clu.closest_hit_dense_launch,
                   clu.closest_hit_dense_before_launch):
            fn.argtypes = [P, I, P, I, I, P, P, P, P, I, P, P, P]
        tiny.shadow_logsum_tiny_launch.argtypes = [P, I, P, I, I, P, P, P, I,
                                                   P, P]
        rng = np.random.default_rng(5)
        for name, pack, c8, n_tris, *rays in cases(rng):
            pk, cl8 = torch.from_numpy(pack), torch.from_numpy(c8)
            org, d, tmin, tmax = (torch.from_numpy(x) for x in rays)
            n = org.shape[0]
            ptr = [x.data_ptr() for x in (org, d, tmin, tmax)]
            if n_tris <= ci.TINY_TRIS:
                want = ci.closest_hit_tiny_plain(pk, org, d, tmin, tmax,
                                                 n_tris)[:4]
                for entry in ("closest_hit_tiny", "closest_hit_tiny_before"):
                    got = (torch.empty(n), torch.empty(n, dtype=torch.int32),
                           torch.empty(n), torch.empty(n))
                    getattr(tiny, f"{entry}_launch")(
                        pk.data_ptr(), pk.shape[1], n_tris, *ptr[:4], n,
                        *(x.data_ptr() for x in got), None)
                    diff = sum(int((a != b).sum()) for a, b in zip(got, want))
                    bad += diff
                    print(f"[{name}] {entry}: {diff} values differ",
                          flush=True)
                dist = torch.from_numpy(rng.uniform(0.5, 12, n).astype(
                    np.float32))
                dist[::9] = -1.0
                logf = ci.log_filter(torch.from_numpy(rng.uniform(
                    0, 1, (4, pack.shape[1])).astype(np.float32)))
                lg = torch.empty((n, 3))
                tiny.shadow_logsum_tiny_launch(
                    pk.data_ptr(), pk.shape[1], logf.data_ptr(), logf.shape[1],
                    n_tris, ptr[0], ptr[1], dist.data_ptr(), n, lg.data_ptr(),
                    None)
                want = ci.shadow_logsum_tiny_plain(pk, logf, org, d, dist,
                                                   n_tris)
                diff = int((lg != want).any(dim=1).sum())
                bad += diff
                print(f"[{name}] shadow_logsum_tiny: {diff} rays differ",
                      flush=True)
            want = cx.closest_dense_plain(pk, org, d, tmin, tmax, n_tris)
            for entry in ("closest_hit_dense", "closest_hit_dense_before"):
                got = (torch.empty(n), torch.empty(n, dtype=torch.int32))
                code = getattr(clu, f"{entry}_launch")(
                    pk.data_ptr(), pk.shape[1], cl8.data_ptr(), cl8.shape[1],
                    n_tris, *ptr[:4], n, *(x.data_ptr() for x in got), None)
                diff = sum(int((a != b).sum()) for a, b in zip(got, want))
                bad += diff + abs(code)
                print(f"[{name}] {entry}: {diff} values differ "
                      f"(launch {code})", flush=True)
        bad += check_culled(libs, rng)
    print(f"cpu_emulate_kernels: {bad} differences")
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
