// The ablation of the threaded-BVH walks of
// libyafaray_tpu_torch/csrc/bvh_walk.cu: the same walk with each of its
// parts on or off, for scripts/torch_bvh_ablation.py, which builds this
// file (with -I libyafaray_tpu_torch/csrc) and times the steps on the same
// recorded rays.  No path of the port launches these bodies.
//
// Steps 1-7 of a walk (kind 0 closest, 1 shadow):
//   1 the 32-byte node records alone (the triangles through tri_order from
//     the (T, 9) v0 | e1 | e2 rows, lf4 in the triangles' order, the rays
//     in the caller's order, one thread a ray);
//   2 + leaf-ordered triangle rows (lf4 in leaf order);
//   3 step 2 on the rays in the order perm (a sort by bvh_ray_key_kernel's
//     key, made by the script);
//   4 step 2 + a leaf's tests unrolled;
//   5 + while-while: a lane walks nodes until it enters a leaf before the
//     warp tests leaves (Aila & Laine, HPG 2009);
//   6 + persistent warps, 32 rays at a time from a global counter;
//   7 + loads that ask the L2 for 128 (a node) or 256 (a leaf's rows)
//     bytes around them: the port's body.
// Every step walks each ray over the same nodes and triangles in the same
// order as the port's bodies, with the same arithmetic, so every step
// gives the same bits.

#include <cuda_runtime.h>

#include "column_walk.cuh"

#define BVH_THREADS 128
#define LEAF_BITS 3
#define LEAF_MAX 4

namespace {

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

struct Packed {
  const float4* nodes;  // (N, 2)
  const float4* rows;   // (T, 3), leaf order
  const int* tri_order;
  const float* tri9;
};

// perm[k] is the caller index of the k-th ray walked (kSorted)
struct Rays {
  const float* org;
  const float* dir;
  const float* tmin;  // null for a shadow walk
  const float* tmax;
  const long long* perm;
  int n;
};

template <bool Rows, bool Sorted, bool Persistent, bool Unroll, bool WW,
          bool Fetch>
struct Cfg {
  static constexpr bool kRows = Rows;
  static constexpr bool kSorted = Sorted;
  static constexpr bool kPersistent = Persistent;
  static constexpr bool kUnroll = Unroll;
  static constexpr bool kWhileWhile = WW;
  static constexpr bool kFetch = Fetch;
};

template <class C, int kBytes>
__device__ __forceinline__ float4 ld_row(const float4* q) {
  if constexpr (!C::kFetch) {
    return __ldg(q);
  } else {
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
}

template <class C>
__device__ __forceinline__ bool tri_test(const Packed& p, int j,
                                         const float (&o)[3],
                                         const float (&d)[3], float* t,
                                         float* u, float* v, int* id) {
  if constexpr (C::kRows) {
    const float4* r = p.rows + 3 * (long long)j;
    const float4 a = ld_row<C, 256>(r), b = ld_row<C, 256>(r + 1),
                 c = ld_row<C, 256>(r + 2);
    *id = __float_as_int(a.w);
    return mt_uvt<true>(a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z, o, d,
                        t, u, v);
  } else {
    const int ti = __ldg(p.tri_order + j);
    *id = ti;
    const float* g = p.tri9 + 9 * (long long)ti;
    return mt_uvt<true>(__ldg(g), __ldg(g + 1), __ldg(g + 2), __ldg(g + 3),
                        __ldg(g + 4), __ldg(g + 5), __ldg(g + 6),
                        __ldg(g + 7), __ldg(g + 8), o, d, t, u, v);
  }
}

template <class C>
__device__ __forceinline__ bool visit(const Packed& p, int node,
                                      const float (&o)[3],
                                      const float (&iv)[3], float lo,
                                      float hi, int* miss, int* leaf) {
  const float4 a = ld_row<C, 128>(p.nodes + 2 * node);
  const float4 b = ld_row<C, 128>(p.nodes + 2 * node + 1);
  *miss = __float_as_int(a.w);
  *leaf = __float_as_int(b.w);
  const float bmin[3] = {a.x, a.y, a.z}, bmax[3] = {b.x, b.y, b.z};
  return slab(bmin, bmax, o, iv, lo, hi);
}

template <bool kPersistent, class F>
__device__ __forceinline__ void for_rays(int n, int* counter, F&& walk) {
  if constexpr (kPersistent) {
    const int lane = threadIdx.x & 31;
    for (;;) {
      int base = 0;
      if (lane == 0) base = atomicAdd(counter, 32);
      base = __shfl_sync(0xffffffffu, base, 0);
      if (base >= n) return;
      if (base + lane < n) walk(base + lane);
    }
  } else {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k < n) walk(k);
  }
}

template <class C, class Hi, class Test, class Done>
__device__ __forceinline__ void walk_nodes(const Packed& p,
                                           const float (&o)[3],
                                           const float (&iv)[3], float lo,
                                           Hi&& hi, Test&& test,
                                           Done&& done) {
  int node = 0;
  if constexpr (C::kWhileWhile) {
    while (node >= 0) {
      int leaf = -1;
      while (node >= 0) {
        int miss, word;
        const bool entered = visit<C>(p, node, o, iv, lo, hi(), &miss, &word);
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
  } else {
    while (node >= 0) {
      int miss, word;
      const bool entered = visit<C>(p, node, o, iv, lo, hi(), &miss, &word);
      if (entered && word >= 0) {
        test(word);
        if (done()) return;
      }
      node = (entered && word < 0) ? node + 1 : miss;
    }
  }
}

template <class C, class Hit>
__device__ __forceinline__ void leaf_tests(const Packed& p, int word,
                                           const float (&o)[3],
                                           const float (&d)[3], Hit&& hit) {
  const int first = word >> LEAF_BITS;
  const int cnt = word & ((1 << LEAF_BITS) - 1);
  auto one = [&](int q) {
    float t, u, v;
    int id;
    const bool ok = tri_test<C>(p, first + q, o, d, &t, &u, &v, &id);
    hit(q, ok, t, u, v, id);
  };
  if constexpr (C::kUnroll) {
#pragma unroll
    for (int q = 0; q < LEAF_MAX; ++q)
      if (q < cnt) one(q);
  } else {
    for (int q = 0; q < cnt; ++q) one(q);
  }
}

struct ClosestOut {
  float* t;
  int* tri;
  float* u;
  float* v;
};

template <class C>
__global__ void __launch_bounds__(BVH_THREADS)
ablation_closest(Packed p, Rays r, ClosestOut out, int* counter) {
  for_rays<C::kPersistent>(r.n, counter, [&](int k) {
    const int i = C::kSorted ? (int)__ldg(r.perm + k) : k;
    float o[3], d[3], iv[3];
    load_ray(r.org, r.dir, i, o, d, iv);
    const float lo = r.tmin[i], hi = r.tmax[i];
    float best_t = INFINITY, best_u = 0.0f, best_v = 0.0f;
    int best_tri = 0;
    walk_nodes<C>(
        p, o, iv, lo, [&] { return fminf(hi, best_t); },
        [&](int word) {
          leaf_tests<C>(p, word, o, d,
                        [&](int, bool ok, float t, float u, float v, int id) {
                          if (ok && t > lo && t < fminf(hi, best_t) &&
                              t < best_t) {
                            best_t = t;
                            best_tri = id;
                            best_u = u;
                            best_v = v;
                          }
                        });
        },
        [] { return false; });
    out.t[i] = best_t;
    out.tri[i] = best_tri;
    out.u[i] = best_u;
    out.v[i] = best_v;
  });
}

struct ShadowOut {
  float* lg;
  unsigned char* blocked;
};

// lf4: in leaf order (kRows) or in the triangles' own order
template <class C>
__global__ void __launch_bounds__(BVH_THREADS)
ablation_shadow(Packed p, const float4* __restrict__ lf4, Rays r,
                ShadowOut out, int* counter) {
  for_rays<C::kPersistent>(r.n, counter, [&](int k) {
    const int i = C::kSorted ? (int)__ldg(r.perm + k) : k;
    float o[3], d[3], iv[3];
    load_ray(r.org, r.dir, i, o, d, iv);
    const float lo = SHADOW_LO, hi = r.tmax[i];
    float lg0 = 0.0f, lg1 = 0.0f, lg2 = 0.0f;
    bool blocked = false;
    walk_nodes<C>(
        p, o, iv, lo, [&] { return hi; },
        [&](int word) {
          const int first = word >> LEAF_BITS;
          leaf_tests<C>(
              p, word, o, d,
              [&](int q, bool ok, float t, float, float, int id) {
                if (ok && t > lo && t < hi) {
                  const float4 f = __ldg(lf4 + (C::kRows ? first + q : id));
                  lg0 = lg0 + f.x;
                  lg1 = lg1 + f.y;
                  lg2 = lg2 + f.z;
                  blocked = blocked || f.w != 0.0f;
                }
              });
        },
        [&] { return blocked; });
    out.lg[3 * i] = lg0;
    out.lg[3 * i + 1] = lg1;
    out.lg[3 * i + 2] = lg2;
    out.blocked[i] = blocked ? 1 : 0;
  });
}

// The low 9 bits of x spread to every third bit.
__device__ __forceinline__ unsigned spread3(unsigned x) {
  x &= 0x1ffu;
  x = (x | (x << 16)) & 0x030000ffu;
  x = (x | (x << 8)) & 0x0300f00fu;
  x = (x | (x << 4)) & 0x030c30c3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

// key[i] = octant << 27 | Morton code of the origin on a 512^3 grid over
// the root box (node 0): the octant bit a is set where dir[a] < 0; the
// cell is floor((o - min) * (512 / (max - min))) clamped to [0, 511].
__global__ void __launch_bounds__(BVH_THREADS)
ray_key_kernel(const float4* __restrict__ nodes,
               const float* __restrict__ org, const float* __restrict__ dir,
               int n, int* __restrict__ key) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4 a = __ldg(nodes), b = __ldg(nodes + 1);
  const float lo[3] = {a.x, a.y, a.z}, hi[3] = {b.x, b.y, b.z};
  unsigned code = 0, oct = 0;
  for (int ax = 0; ax < 3; ++ax) {
    const float s = 512.0f / (hi[ax] - lo[ax]);
    const float q = fminf(fmaxf(floorf((org[3 * i + ax] - lo[ax]) * s), 0.0f),
                          511.0f);
    code |= spread3((unsigned)q) << ax;
    oct |= (dir[3 * i + ax] < 0.0f ? 1u : 0u) << ax;
  }
  key[i] = (int)(oct << 27 | code);
}

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

bool misaligned(const void* p) { return ((size_t)p & 15) != 0; }

}  // namespace

extern "C" int bvh_ray_key_launch(const void* nodes, const void* org,
                                  const void* dir, int n, void* key,
                                  void* stream) {
  if (misaligned(nodes)) return (int)cudaErrorInvalidValue;
  if (n > 0)
    ray_key_kernel<<<(n + BVH_THREADS - 1) / BVH_THREADS, BVH_THREADS, 0,
                     (cudaStream_t)stream>>>((const float4*)nodes,
                                             (const float*)org,
                                             (const float*)dir, n, (int*)key);
  return (int)cudaGetLastError();
}

// Step 1-7 of a walk (kind 0 closest, 1 shadow) on the port's packed
// arrays: nodes (N, 8) and rows (T, 12) float32 (pack_bvh), the builder's
// tri_order and tri9 for step 1, lf4 (T, 4) in the triangles' order for
// step 1 and lf4_leaf in leaf order for the others, perm (n,) int64 for
// step 3, out0-out3 the closest walk's t, tri, u, v or the shadow walk's
// log sum and blocked flags; counter one int32 of scratch.
extern "C" int bvh_ablation_launch(
    int kind, int step, const void* nodes, const void* rows,
    const void* tri_order, const void* tri9, const void* lf4,
    const void* lf4_leaf, const void* org, const void* dir, const void* tmin,
    const void* tmax, const void* perm, int n, void* out0, void* out1,
    void* out2, void* out3, void* counter, void* stream) {
  if (misaligned(nodes) || misaligned(rows) || (lf4 && misaligned(lf4)) ||
      (lf4_leaf && misaligned(lf4_leaf)) || step < 1 || step > 7)
    return (int)cudaErrorInvalidValue;
  const Packed p{(const float4*)nodes, (const float4*)rows,
                 (const int*)tri_order, (const float*)tri9};
  const Rays r{(const float*)org,  (const float*)dir,
               (const float*)tmin, (const float*)tmax,
               (const long long*)perm, n};
  int* ctr = (int*)counter;
  const cudaStream_t s = (cudaStream_t)stream;
  const ClosestOut co{(float*)out0, (int*)out1, (float*)out2, (float*)out3};
  const ShadowOut so{(float*)out0, (unsigned char*)out1};
  const float4* f = (const float4*)(step == 1 ? lf4 : lf4_leaf);
#define ABL(CFG)                                                          \
  return kind == 0 ? launch(ablation_closest<CFG>, CFG::kPersistent, n,  \
                            ctr, s, p, r, co, ctr)                        \
                   : launch(ablation_shadow<CFG>, CFG::kPersistent, n,   \
                            ctr, s, p, f, r, so, ctr)
  using Nodes = Cfg<false, false, false, false, false, false>;
  using Rows = Cfg<true, false, false, false, false, false>;
  using Sorted = Cfg<true, true, false, false, false, false>;
  using Unrolled = Cfg<true, false, false, true, false, false>;
  using WhileWhile = Cfg<true, false, false, true, true, false>;
  using Persistent = Cfg<true, false, true, true, true, false>;
  using Wide = Cfg<true, false, true, true, true, true>;
  switch (step) {
    case 1: ABL(Nodes);
    case 2: ABL(Rows);
    case 3: ABL(Sorted);
    case 4: ABL(Unrolled);
    case 5: ABL(WhileWhile);
    case 6: ABL(Persistent);
    default: ABL(Wide);
  }
#undef ABL
}
