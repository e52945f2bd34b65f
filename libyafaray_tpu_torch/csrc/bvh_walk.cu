// Threaded-BVH walks for Hopper (sm_90a): the intersector of scenes above
// 2^20 triangles.
//
// Replace the reference's stackless BVH walks, which are lax.while_loop
// code, not Pallas kernels (libyafaray_tpu/ops/bvh_traverse.py):
//   bvh_closest_kernel <- closest_hit_bvh: nearest hit -> (t, tri, u, v)
//   bvh_shadow_kernel  <- shadow_transmission_bvh: sum of the log filters
//                         of every crossing and the opaque flag (the
//                         wrapper takes exp and applies the flag)
// Their plain versions are the reference's lockstep walk written in torch
// (ops/bvh_traverse.py `closest_bvh_plain`, `shadow_bvh_plain`).
//
// The walk.  accel/bvh.py's node array is threaded in depth-first
// pre-order: a ray that enters an inner node goes on to node + 1 (its left
// child); a ray that misses a node, or has tested an entered leaf, goes to
// the node's miss_next; -1 ends the walk.  So a ray needs no stack: one
// thread a ray holds its node index and its best hit (t, tri, u, v), or its
// running log sum and blocked flag, in registers.
//
// Bit-equality with the plain versions.  Each step repeats the reference's
// arithmetic in its order: the +-1e-12 guard of the inverse direction, the
// slab test `max(max_axis tlo, tmin) <= min(min_axis thi, tmax)` (the
// closest walk passes min(tmax, best t) as tmax), Moller-Trumbore with the
// det guard 1e-12 and t strictly inside (tmin, tmax), built with
// -fmad=false (ops/_build.py) so no product is fused.  A hit replaces the
// best only where t < best t, so the first winner in walk order is kept.
// The shadow walk adds a crossing's log filter where its test passes and
// stops a ray after the leaf in which it met an opaque triangle (the other
// triangles of that leaf still add, as in the lockstep walk).  Every ray
// walks the same nodes and tests the same triangles in the same order in
// every body below, so all of them give the same bits.
//
// What bounds it.  A walk is a chain of dependent, scattered loads: ~40-80
// node visits and ~4-10 triangle tests a ray on the 2.6M-triangle grid,
// whose 52 MB of nodes and 126 MB of triangle rows do not fit the 50 MB
// L2; each warp-wide load of 32 scattered rows costs an L1 wavefront a
// distinct line, so the walk is bound by its load requests and their
// latency, not by its ~25 operations a box.  The design cuts the requests
// (ops/bvh_traverse.py `pack_bvh` builds the layout once a scene):
//  - a node is one 32-byte record, two float4 loads from one sector:
//    (min xyz, miss_next) and (max xyz, leaf word: -1 for an inner node,
//    first << 3 | count for a leaf); hit_next is implicit.  The builder's
//    five arrays cost 4-6 sectors and 8-9 scalar loads a visit.
//  - a leaf's <= 4 triangles are contiguous rows in leaf order, three
//    float4 loads each, (v0, original index) (e1, 0) (e2, 0), and the
//    shadow walk's log filters are in the same order: no tri_order load
//    before the triangle, no scattered filter load after it.
//  - a leaf's tests are unrolled, and a lane walks nodes until it enters a
//    leaf before the warp tests leaves ("while-while", Aila & Laine, HPG
//    2009): a warp's lanes test their leaves together instead of each
//    leaf visit holding the lanes still on inner nodes.
//  - warps are persistent: each takes its next 32 rays from a global
//    counter once all its lanes are done, so no warp idles behind a block
//    whose other warps still walk.
//  - node loads ask the L2 for the 128 bytes around them, a leaf's rows
//    for 256 (ld_wide): an entered node's next visit is node + 1, and a
//    leaf's rows lie together, so one memory fetch serves several of the
//    walk's dependent loads.
// Each part was measured on the card, added one at a time on the same
// recorded rays (scripts/torch_bvh_ablation.py, which builds the walk with
// each part on or off from scripts/bvh_ablation.cu): a 512² step's eight
// walks on the 2.6M-triangle grid took 7.38 ms by the first bodies, 5.13
// with the node records, 4.81 + leaf rows, 4.76 + unrolled leaf tests,
// 4.61 + while-while, 4.41 + persistent warps, 4.17 + wide L2 fetches
// (NVIDIA H100 80GB HBM3 at 700 W), so each part is kept.  Sorting the
// rays by direction octant and the origin's Morton code in the root box
// (on top of the leaf rows) took 5.93 ms, the sort's own time included,
// so the walks take the rays in the caller's order.
//
// The first bodies (bvh_closest_before_kernel, bvh_shadow_before_kernel:
// one thread a ray in the caller's order over the builder's arrays) stay
// for timing beside the walk; no path launches them.

#include <cuda_runtime.h>

#include "column_walk.cuh"

#define BVH_THREADS 128
#define LEAF_BITS 3  // a leaf word is first << LEAF_BITS | count
#define LEAF_MAX 4   // triangles a leaf at most (accel/bvh.py LEAF_SIZE)

namespace {

// The reference's _aabb_hit: does the interval [lo, hi] of the ray meet
// the box [bmin, bmax]?
__device__ __forceinline__ bool slab(const float (&bmin)[3],
                                     const float (&bmax)[3],
                                     const float (&o)[3],
                                     const float (&iv)[3], float lo,
                                     float hi) {
  float tlo[3], thi[3];
  for (int a = 0; a < 3; ++a) {
    const float t0 = (bmin[a] - o[a]) * iv[a];
    const float t1 = (bmax[a] - o[a]) * iv[a];
    tlo[a] = fminf(t0, t1);
    thi[a] = fmaxf(t0, t1);
  }
  const float enter = fmaxf(fmaxf(fmaxf(tlo[0], tlo[1]), tlo[2]), lo);
  const float exit_ = fminf(fminf(fminf(thi[0], thi[1]), thi[2]), hi);
  return enter <= exit_;
}

__device__ __forceinline__ void load_ray(const float* __restrict__ org,
                                         const float* __restrict__ dir, int i,
                                         float (&o)[3], float (&d)[3],
                                         float (&iv)[3]) {
  const float eps = (float)1e-12;
  for (int a = 0; a < 3; ++a) {
    o[a] = org[3 * i + a];
    d[a] = dir[3 * i + a];
    const float dd = fabsf(d[a]) < eps ? (d[a] < 0.0f ? -eps : eps) : d[a];
    iv[a] = 1.0f / dd;
  }
}

// Per-ray work of a walk, written only by the counting launches (kCount):
// nodes visited and triangle tests made, and a 1 for every node and
// triangle touched.  For a bound from the run's own walk; no path uses it.
struct Counts {
  int* per_ray;                  // (n, 2)
  unsigned char* node_touched;   // (N,)
  unsigned char* tri_touched;    // (T,)
};

// ---- the walk ---------------------------------------------------------------

// The scene side: the packed node records and leaf-ordered triangle rows.
struct Packed {
  const float4* nodes;  // (N, 2)
  const float4* rows;   // (T, 3)
};

struct Rays {
  const float* org;
  const float* dir;
  const float* tmin;  // null for a shadow walk
  const float* tmax;
  int n;
};

// A float4 load that asks the L2 to fetch the kBytes (128 or 256) around
// it from memory, not the 32-byte sector alone: a walk that enters a node
// reads node + 1 next, and a leaf's rows lie together.
template <int kBytes>
__device__ __forceinline__ float4 ld_wide(const float4* q) {
  float4 v;
  if constexpr (kBytes == 128)
    asm("ld.global.nc.L2::128B.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
        : "l"(q));
  else
    asm("ld.global.nc.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
        : "l"(q));
  return v;
}

// Moller-Trumbore of the ray against the j-th triangle in leaf order;
// *id is its original index.  t, u, v valid on true.
__device__ __forceinline__ bool tri_test(const Packed& p, int j,
                                         const float (&o)[3],
                                         const float (&d)[3], float* t,
                                         float* u, float* v, int* id) {
  const float4* r = p.rows + 3 * (long long)j;
  const float4 a = ld_wide<256>(r), b = ld_wide<256>(r + 1),
               c = ld_wide<256>(r + 2);
  *id = __float_as_int(a.w);
  return mt_uvt<true>(a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z, o, d, t,
                      u, v);
}

// One node visit: is the node's box entered, and its leaf word.
__device__ __forceinline__ bool visit(const Packed& p, int node,
                                      const float (&o)[3],
                                      const float (&iv)[3], float lo,
                                      float hi, int* miss, int* leaf) {
  const float4 a = ld_wide<128>(p.nodes + 2 * node);
  const float4 b = ld_wide<128>(p.nodes + 2 * node + 1);
  *miss = __float_as_int(a.w);
  *leaf = __float_as_int(b.w);
  const float bmin[3] = {a.x, a.y, a.z}, bmax[3] = {b.x, b.y, b.z};
  return slab(bmin, bmax, o, iv, lo, hi);
}

// Calls walk(i) for every ray i < n: warps take 32 rays at a time from
// *counter, which the launch zeroes, until none is left.
template <class F>
__device__ __forceinline__ void for_rays(int n, int* counter, F&& walk) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, 32);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= n) return;
    if (base + lane < n) walk(base + lane);
  }
}

// The walk of one ray from the root: test(leaf word) at every entered
// leaf, in walk order, until the walk ends or done() holds after a leaf;
// hi() the interval's end at each visit.  A lane visits nodes until it
// enters a leaf, then tests it (while-while).
template <bool kCount, class Hi, class Test, class Done>
__device__ __forceinline__ void walk_nodes(const Packed& p,
                                           const float (&o)[3],
                                           const float (&iv)[3], float lo,
                                           Hi&& hi, Test&& test, Done&& done,
                                           const Counts& c, int* visits) {
  int node = 0;
  while (node >= 0) {
    int leaf = -1;
    while (node >= 0) {
      int miss, word;
      const bool entered = visit(p, node, o, iv, lo, hi(), &miss, &word);
      if constexpr (kCount) {
        ++*visits;
        c.node_touched[node] = 1;
      }
      if (entered && word >= 0) {
        leaf = word;
        node = miss;
        break;
      }
      node = entered ? node + 1 : miss;
    }
    if (leaf >= 0) {
      test(leaf);
      if (done()) return;
    }
  }
}

// Calls hit(q, ok, t, u, v, id) for the leaf's triangles q in order.
template <bool kCount, class Hit>
__device__ __forceinline__ void leaf_tests(const Packed& p, int word,
                                           const float (&o)[3],
                                           const float (&d)[3],
                                           const Counts& c, int* tests,
                                           Hit&& hit) {
  const int first = word >> LEAF_BITS;
  const int cnt = word & ((1 << LEAF_BITS) - 1);
#pragma unroll
  for (int q = 0; q < LEAF_MAX; ++q) {
    if (q < cnt) {
      float t, u, v;
      int id;
      const bool ok = tri_test(p, first + q, o, d, &t, &u, &v, &id);
      if constexpr (kCount) {
        ++*tests;
        c.tri_touched[id] = 1;
      }
      hit(q, ok, t, u, v, id);
    }
  }
}

struct ClosestOut {
  float* t;
  int* tri;
  float* u;
  float* v;
};

template <bool kCount>
__device__ __forceinline__ void closest_walk(const Packed& p, const Rays& r,
                                             const ClosestOut& out,
                                             const Counts& c, int* counter) {
  for_rays(r.n, counter, [&](int i) {
    float o[3], d[3], iv[3];
    load_ray(r.org, r.dir, i, o, d, iv);
    const float lo = r.tmin[i], hi = r.tmax[i];
    float best_t = INFINITY, best_u = 0.0f, best_v = 0.0f;
    int best_tri = 0, visits = 0, tests = 0;
    walk_nodes<kCount>(
        p, o, iv, lo, [&] { return fminf(hi, best_t); },
        [&](int word) {
          leaf_tests<kCount>(
              p, word, o, d, c, &tests,
              [&](int, bool ok, float t, float u, float v, int id) {
                if (ok && t > lo && t < fminf(hi, best_t) && t < best_t) {
                  best_t = t;
                  best_tri = id;
                  best_u = u;
                  best_v = v;
                }
              });
        },
        [] { return false; }, c, &visits);
    out.t[i] = best_t;
    out.tri[i] = best_tri;
    out.u[i] = best_u;
    out.v[i] = best_v;
    if constexpr (kCount) {
      c.per_ray[2 * i] = visits;
      c.per_ray[2 * i + 1] = tests;
    }
  });
}

struct ShadowOut {
  float* lg;
  unsigned char* blocked;
};

// lf4: the log filter r g b of each triangle and 1 where it is opaque, in
// leaf order (row j for the triangle of rows[j]).
template <bool kCount>
__device__ __forceinline__ void shadow_walk(const Packed& p,
                                            const float4* __restrict__ lf4,
                                            const Rays& r,
                                            const ShadowOut& out,
                                            const Counts& c, int* counter) {
  for_rays(r.n, counter, [&](int i) {
    float o[3], d[3], iv[3];
    load_ray(r.org, r.dir, i, o, d, iv);
    const float lo = SHADOW_LO, hi = r.tmax[i];
    float lg0 = 0.0f, lg1 = 0.0f, lg2 = 0.0f;
    bool blocked = false;
    int visits = 0, tests = 0;
    walk_nodes<kCount>(
        p, o, iv, lo, [&] { return hi; },
        [&](int word) {
          const int first = word >> LEAF_BITS;
          leaf_tests<kCount>(
              p, word, o, d, c, &tests,
              [&](int q, bool ok, float t, float, float, int) {
                if (ok && t > lo && t < hi) {
                  const float4 f = __ldg(lf4 + first + q);
                  lg0 = lg0 + f.x;
                  lg1 = lg1 + f.y;
                  lg2 = lg2 + f.z;
                  blocked = blocked || f.w != 0.0f;
                }
              });
        },
        [&] { return blocked; }, c, &visits);
    out.lg[3 * i] = lg0;
    out.lg[3 * i + 1] = lg1;
    out.lg[3 * i + 2] = lg2;
    out.blocked[i] = blocked ? 1 : 0;
    if constexpr (kCount) {
      c.per_ray[2 * i] = visits;
      c.per_ray[2 * i + 1] = tests;
    }
  });
}

__global__ void __launch_bounds__(BVH_THREADS)
bvh_closest_kernel(Packed p, Rays r, ClosestOut out, Counts c, int* ctr) {
  closest_walk<false>(p, r, out, c, ctr);
}

__global__ void __launch_bounds__(BVH_THREADS)
bvh_closest_count_kernel(Packed p, Rays r, ClosestOut out, Counts c,
                         int* ctr) {
  closest_walk<true>(p, r, out, c, ctr);
}

__global__ void __launch_bounds__(BVH_THREADS)
bvh_shadow_kernel(Packed p, const float4* lf4, Rays r, ShadowOut out,
                  Counts c, int* ctr) {
  shadow_walk<false>(p, lf4, r, out, c, ctr);
}

__global__ void __launch_bounds__(BVH_THREADS)
bvh_shadow_count_kernel(Packed p, const float4* lf4, Rays r, ShadowOut out,
                        Counts c, int* ctr) {
  shadow_walk<true>(p, lf4, r, out, c, ctr);
}

// ---- the first bodies -------------------------------------------------------

struct Bvh {
  const float* bb_min;   // (N, 3)
  const float* bb_max;   // (N, 3)
  const int* hit_next;   // (N,)
  const int* miss_next;  // (N,)
  const int* first_tri;  // (N,)
  const int* tri_count;  // (N,)
  const int* tri_order;  // (T,)
  int n_order;
  const float* tri9;     // (T, 9) v0 | e1 | e2
};

__device__ __forceinline__ bool node_entered(const Bvh& b, int node,
                                             const float (&o)[3],
                                             const float (&iv)[3], float lo,
                                             float hi) {
  float bmin[3], bmax[3];
  for (int a = 0; a < 3; ++a) {
    bmin[a] = __ldg(b.bb_min + 3 * node + a);
    bmax[a] = __ldg(b.bb_max + 3 * node + a);
  }
  return slab(bmin, bmax, o, iv, lo, hi);
}

__device__ __forceinline__ bool before_test(const Bvh& b, int first, int k,
                                            const float (&o)[3],
                                            const float (&d)[3], float* t,
                                            float* u, float* v, int* ti) {
  *ti = __ldg(b.tri_order + min(max(first + k, 0), b.n_order - 1));
  const float* g = b.tri9 + 9 * (long long)*ti;
  return mt_uvt<true>(__ldg(g), __ldg(g + 1), __ldg(g + 2), __ldg(g + 3),
                      __ldg(g + 4), __ldg(g + 5), __ldg(g + 6), __ldg(g + 7),
                      __ldg(g + 8), o, d, t, u, v);
}

__global__ void __launch_bounds__(BVH_THREADS)
bvh_closest_before_kernel(Bvh b, const float* __restrict__ org,
                          const float* __restrict__ dir,
                          const float* __restrict__ tmin,
                          const float* __restrict__ tmax, int n,
                          ClosestOut out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float o[3], d[3], iv[3];
  load_ray(org, dir, i, o, d, iv);
  const float lo = tmin[i], hi = tmax[i];
  float best_t = INFINITY, best_u = 0.0f, best_v = 0.0f;
  int best_tri = 0;
  int node = 0;
  while (node >= 0) {
    const bool entered = node_entered(b, node, o, iv, lo, fminf(hi, best_t));
    const int first = __ldg(b.first_tri + node);
    if (entered && first >= 0) {
      const int cnt = __ldg(b.tri_count + node);
      for (int k = 0; k < cnt; ++k) {
        float t, u, v;
        int ti;
        if (before_test(b, first, k, o, d, &t, &u, &v, &ti) && t > lo &&
            t < fminf(hi, best_t) && t < best_t) {
          best_t = t;
          best_tri = ti;
          best_u = u;
          best_v = v;
        }
      }
    }
    node = (entered && first < 0) ? __ldg(b.hit_next + node)
                                  : __ldg(b.miss_next + node);
  }
  out.t[i] = best_t;
  out.tri[i] = best_tri;
  out.u[i] = best_u;
  out.v[i] = best_v;
}

__global__ void __launch_bounds__(BVH_THREADS)
bvh_shadow_before_kernel(Bvh b, const float4* __restrict__ lf4,
                         const float* __restrict__ org,
                         const float* __restrict__ dir,
                         const float* __restrict__ tmax, int n,
                         ShadowOut out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float o[3], d[3], iv[3];
  load_ray(org, dir, i, o, d, iv);
  const float lo = SHADOW_LO, hi = tmax[i];
  float lg0 = 0.0f, lg1 = 0.0f, lg2 = 0.0f;
  bool blocked = false;
  int node = 0;
  while (node >= 0 && !blocked) {
    const bool entered = node_entered(b, node, o, iv, lo, hi);
    const int first = __ldg(b.first_tri + node);
    if (entered && first >= 0) {
      const int cnt = __ldg(b.tri_count + node);
      for (int k = 0; k < cnt; ++k) {
        float t, u, v;
        int ti;
        if (before_test(b, first, k, o, d, &t, &u, &v, &ti) && t > lo &&
            t < hi) {
          const float4 f = __ldg(lf4 + ti);
          lg0 = lg0 + f.x;
          lg1 = lg1 + f.y;
          lg2 = lg2 + f.z;
          blocked = blocked || f.w != 0.0f;
        }
      }
    }
    node = (entered && first < 0) ? __ldg(b.hit_next + node)
                                  : __ldg(b.miss_next + node);
  }
  out.lg[3 * i] = lg0;
  out.lg[3 * i + 1] = lg1;
  out.lg[3 * i + 2] = lg2;
  out.blocked[i] = blocked ? 1 : 0;
}

// A launch of `kernel` over n rays on `stream`: one thread a launch
// position, or (persistent) as many blocks as the card holds at once, the
// position counter zeroed first on the same stream (a memset node when a
// CUDA graph captures the call).
template <class Kernel, class... Args>
int launch(Kernel kernel, bool persistent, int n, int* counter,
           cudaStream_t stream, Args... args) {
  if (n <= 0) return (int)cudaGetLastError();
  int blocks = (n + BVH_THREADS - 1) / BVH_THREADS;
  if (persistent) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        BVH_THREADS, 0);
    if (e == cudaSuccess)
      e = cudaMemsetAsync(counter, 0, sizeof(int), stream);
    if (e != cudaSuccess) return (int)e;
    blocks = min(blocks, max(1, sms * per_sm));
  }
  kernel<<<blocks, BVH_THREADS, 0, stream>>>(args...);
  return (int)cudaGetLastError();
}

Counts make_counts(void* per_ray, void* node_touched, void* tri_touched) {
  return Counts{(int*)per_ray, (unsigned char*)node_touched,
                (unsigned char*)tri_touched};
}

bool misaligned(const void* p) { return ((size_t)p & 15) != 0; }

}  // namespace

// The path's walks.  nodes (N, 8) and rows (T, 12) float32 from pack_bvh;
// counter one int32 of scratch.  counts: null, or (per_ray (n, 2) int32,
// node_touched (N,) uint8, tri_touched (T,) uint8), zeroed by the caller:
// the counting launch.
extern "C" int bvh_closest_launch(const void* nodes, const void* rows,
                                  const void* org, const void* dir,
                                  const void* tmin, const void* tmax, int n,
                                  void* t_out, void* tri_out, void* u_out,
                                  void* v_out, void* counter, void* per_ray,
                                  void* node_touched, void* tri_touched,
                                  void* stream) {
  if (misaligned(nodes) || misaligned(rows)) return (int)cudaErrorInvalidValue;
  const ClosestOut out{(float*)t_out, (int*)tri_out, (float*)u_out,
                       (float*)v_out};
  return launch(per_ray ? bvh_closest_count_kernel : bvh_closest_kernel,
                true, n, (int*)counter, (cudaStream_t)stream,
                Packed{(const float4*)nodes, (const float4*)rows},
                Rays{(const float*)org, (const float*)dir,
                     (const float*)tmin, (const float*)tmax, n},
                out, make_counts(per_ray, node_touched, tri_touched),
                (int*)counter);
}

// lf4 (T, 4) float32 in leaf order (bvh_traverse.py leaf_lf4).
extern "C" int bvh_shadow_launch(const void* nodes, const void* rows,
                                 const void* lf4, const void* org,
                                 const void* dir, const void* tmax, int n,
                                 void* lg_out, void* blocked_out,
                                 void* counter, void* per_ray,
                                 void* node_touched, void* tri_touched,
                                 void* stream) {
  if (misaligned(nodes) || misaligned(rows) || misaligned(lf4))
    return (int)cudaErrorInvalidValue;
  const ShadowOut out{(float*)lg_out, (unsigned char*)blocked_out};
  return launch(per_ray ? bvh_shadow_count_kernel : bvh_shadow_kernel, true,
                n, (int*)counter, (cudaStream_t)stream,
                Packed{(const float4*)nodes, (const float4*)rows},
                (const float4*)lf4,
                Rays{(const float*)org, (const float*)dir, nullptr,
                     (const float*)tmax, n},
                out, make_counts(per_ray, node_touched, tri_touched),
                (int*)counter);
}

// The first bodies on the builder's arrays (tri9 (T, 9), lf4 (T, 4) in the
// triangles' order).
extern "C" int bvh_closest_before_launch(
    const void* bb_min, const void* bb_max, const void* hit_next,
    const void* miss_next, const void* first_tri, const void* tri_count,
    const void* tri_order, int n_order, const void* tri9, const void* org,
    const void* dir, const void* tmin, const void* tmax, int n, void* t_out,
    void* tri_out, void* u_out, void* v_out, void* stream) {
  if (n_order <= 0) return (int)cudaErrorInvalidValue;
  const Bvh b{(const float*)bb_min,  (const float*)bb_max,
              (const int*)hit_next,  (const int*)miss_next,
              (const int*)first_tri, (const int*)tri_count,
              (const int*)tri_order, n_order,
              (const float*)tri9};
  const ClosestOut out{(float*)t_out, (int*)tri_out, (float*)u_out,
                       (float*)v_out};
  return launch(bvh_closest_before_kernel, false, n, nullptr,
                (cudaStream_t)stream, b, (const float*)org, (const float*)dir,
                (const float*)tmin, (const float*)tmax, n, out);
}

extern "C" int bvh_shadow_before_launch(
    const void* bb_min, const void* bb_max, const void* hit_next,
    const void* miss_next, const void* first_tri, const void* tri_count,
    const void* tri_order, int n_order, const void* tri9, const void* lf4,
    const void* org, const void* dir, const void* tmax, int n, void* lg_out,
    void* blocked_out, void* stream) {
  if (n_order <= 0 || misaligned(lf4)) return (int)cudaErrorInvalidValue;
  const Bvh b{(const float*)bb_min,  (const float*)bb_max,
              (const int*)hit_next,  (const int*)miss_next,
              (const int*)first_tri, (const int*)tri_count,
              (const int*)tri_order, n_order,
              (const float*)tri9};
  const ShadowOut out{(float*)lg_out, (unsigned char*)blocked_out};
  return launch(bvh_shadow_before_kernel, false, n, nullptr,
                (cudaStream_t)stream, b, (const float4*)lf4,
                (const float*)org, (const float*)dir, (const float*)tmax, n,
                out);
}
