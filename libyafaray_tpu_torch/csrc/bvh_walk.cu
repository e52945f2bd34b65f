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
// The walk.  accel/bvh.py's node array is threaded: every node names the
// node to visit next when the ray enters its box (hit_next: the left child
// of an inner node) and when it does not (miss_next), and -1 ends the walk.
// So a ray needs no stack: one thread a ray holds its node index and its
// best hit (t, tri, u, v), or its running log sum and blocked flag, in
// registers.  A node's box and counts are read through __ldg; an entered
// leaf's <= 4 triangles are gathered through tri_order from the (T, 9)
// v0 | e1 | e2 table.
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
// triangles of that leaf still add, as in the lockstep walk).
//
// What bounds it.  Per ray the walk reads ~80 nodes (32 bytes of box and
// counts each) and ~10 triangles (36 bytes and the 4-byte index): scattered
// loads, one chain of dependent reads a ray.  The work is ~39 FP32
// operations a box and ~45 a triangle.  Neighbouring bounce rays walk
// different nodes, so a warp diverges; this first kernel keeps one thread
// a ray and the node layout of the builder (wide nodes, leaf-ordered
// triangle copies and ray sorting are later work).

#include <cuda_runtime.h>

#include "column_walk.cuh"

#define BVH_THREADS 128

namespace {

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

// The reference's _aabb_hit: does the interval [lo, hi] of the ray meet
// the node's box?
__device__ __forceinline__ bool node_entered(const Bvh& b, int node,
                                             const float (&o)[3],
                                             const float (&iv)[3], float lo,
                                             float hi) {
  float tlo[3], thi[3];
  for (int a = 0; a < 3; ++a) {
    const float t0 = (__ldg(b.bb_min + 3 * node + a) - o[a]) * iv[a];
    const float t1 = (__ldg(b.bb_max + 3 * node + a) - o[a]) * iv[a];
    tlo[a] = fminf(t0, t1);
    thi[a] = fmaxf(t0, t1);
  }
  const float enter = fmaxf(fmaxf(fmaxf(tlo[0], tlo[1]), tlo[2]), lo);
  const float exit_ = fminf(fminf(fminf(thi[0], thi[1]), thi[2]), hi);
  return enter <= exit_;
}

// Index of the k-th triangle of a leaf whose range starts at `first`.
__device__ __forceinline__ int leaf_tri(const Bvh& b, int first, int k) {
  const int j = min(max(first + k, 0), b.n_order - 1);
  return __ldg(b.tri_order + j);
}

// Moller-Trumbore of the ray against triangle ti; t, u, v valid on true.
__device__ __forceinline__ bool tri_test(const Bvh& b, int ti,
                                         const float (&o)[3],
                                         const float (&d)[3], float* t,
                                         float* u, float* v) {
  const float* g = b.tri9 + 9 * (long long)ti;
  return mt_uvt<true>(__ldg(g), __ldg(g + 1), __ldg(g + 2), __ldg(g + 3),
                      __ldg(g + 4), __ldg(g + 5), __ldg(g + 6), __ldg(g + 7),
                      __ldg(g + 8), o, d, t, u, v);
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

template <bool kCount>
__device__ __forceinline__ void closest_walk(
    const Bvh& b, const float* __restrict__ org,
    const float* __restrict__ dir, const float* __restrict__ tmin,
    const float* __restrict__ tmax, int n, float* __restrict__ t_out,
    int* __restrict__ tri_out, float* __restrict__ u_out,
    float* __restrict__ v_out, Counts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float o[3], d[3], iv[3];
  load_ray(org, dir, i, o, d, iv);
  const float lo = tmin[i], hi = tmax[i];
  float best_t = INFINITY, best_u = 0.0f, best_v = 0.0f;
  int best_tri = 0, visits = 0, tests = 0;
  int node = 0;
  while (node >= 0) {
    const bool entered = node_entered(b, node, o, iv, lo, fminf(hi, best_t));
    const int first = __ldg(b.first_tri + node);
    if constexpr (kCount) {
      ++visits;
      c.node_touched[node] = 1;
    }
    if (entered && first >= 0) {
      const int cnt = __ldg(b.tri_count + node);
      for (int k = 0; k < cnt; ++k) {
        const int ti = leaf_tri(b, first, k);
        if constexpr (kCount) {
          ++tests;
          c.tri_touched[ti] = 1;
        }
        float t, u, v;
        if (tri_test(b, ti, o, d, &t, &u, &v) && t > lo &&
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
  t_out[i] = best_t;
  tri_out[i] = best_tri;
  u_out[i] = best_u;
  v_out[i] = best_v;
  if constexpr (kCount) {
    c.per_ray[2 * i] = visits;
    c.per_ray[2 * i + 1] = tests;
  }
}

// lf4 (T, 4): log filter r g b of each triangle and 1 where it is opaque.
template <bool kCount>
__device__ __forceinline__ void shadow_walk(
    const Bvh& b, const float4* __restrict__ lf4,
    const float* __restrict__ org, const float* __restrict__ dir,
    const float* __restrict__ tmax, int n, float* __restrict__ lg_out,
    unsigned char* __restrict__ blocked_out, Counts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float o[3], d[3], iv[3];
  load_ray(org, dir, i, o, d, iv);
  const float lo = SHADOW_LO, hi = tmax[i];
  float lg0 = 0.0f, lg1 = 0.0f, lg2 = 0.0f;
  bool blocked = false;
  int node = 0, visits = 0, tests = 0;
  while (node >= 0 && !blocked) {
    const bool entered = node_entered(b, node, o, iv, lo, hi);
    const int first = __ldg(b.first_tri + node);
    if constexpr (kCount) {
      ++visits;
      c.node_touched[node] = 1;
    }
    if (entered && first >= 0) {
      const int cnt = __ldg(b.tri_count + node);
      for (int k = 0; k < cnt; ++k) {
        const int ti = leaf_tri(b, first, k);
        if constexpr (kCount) {
          ++tests;
          c.tri_touched[ti] = 1;
        }
        float t, u, v;
        if (tri_test(b, ti, o, d, &t, &u, &v) && t > lo && t < hi) {
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
  lg_out[3 * i] = lg0;
  lg_out[3 * i + 1] = lg1;
  lg_out[3 * i + 2] = lg2;
  blocked_out[i] = blocked ? 1 : 0;
  if constexpr (kCount) {
    c.per_ray[2 * i] = visits;
    c.per_ray[2 * i + 1] = tests;
  }
}

#define CLOSEST_ARGS                                                      \
  Bvh b, const float* __restrict__ org, const float* __restrict__ dir,    \
      const float* __restrict__ tmin, const float* __restrict__ tmax,     \
      int n, float* __restrict__ t_out, int* __restrict__ tri_out,        \
      float* __restrict__ u_out, float* __restrict__ v_out, Counts c
#define SHADOW_ARGS                                                       \
  Bvh b, const float4* __restrict__ lf4, const float* __restrict__ org,   \
      const float* __restrict__ dir, const float* __restrict__ tmax,      \
      int n, float* __restrict__ lg_out,                                  \
      unsigned char* __restrict__ blocked_out, Counts c

__global__ void __launch_bounds__(BVH_THREADS)
bvh_closest_kernel(CLOSEST_ARGS) {
  closest_walk<false>(b, org, dir, tmin, tmax, n, t_out, tri_out, u_out,
                      v_out, c);
}

__global__ void __launch_bounds__(BVH_THREADS)
bvh_closest_count_kernel(CLOSEST_ARGS) {
  closest_walk<true>(b, org, dir, tmin, tmax, n, t_out, tri_out, u_out,
                     v_out, c);
}

__global__ void __launch_bounds__(BVH_THREADS)
bvh_shadow_kernel(SHADOW_ARGS) {
  shadow_walk<false>(b, lf4, org, dir, tmax, n, lg_out, blocked_out, c);
}

__global__ void __launch_bounds__(BVH_THREADS)
bvh_shadow_count_kernel(SHADOW_ARGS) {
  shadow_walk<true>(b, lf4, org, dir, tmax, n, lg_out, blocked_out, c);
}

}  // namespace

static Bvh make_bvh(const void* bb_min, const void* bb_max,
                    const void* hit_next, const void* miss_next,
                    const void* first_tri, const void* tri_count,
                    const void* tri_order, int n_order, const void* tri9) {
  return Bvh{(const float*)bb_min,    (const float*)bb_max,
             (const int*)hit_next,    (const int*)miss_next,
             (const int*)first_tri,   (const int*)tri_count,
             (const int*)tri_order,   n_order,
             (const float*)tri9};
}

// counts: null, or (per_ray (n, 2) int32, node_touched (N,) uint8,
// tri_touched (T,) uint8), zeroed by the caller: the counting launch.
extern "C" int bvh_closest_launch(
    const void* bb_min, const void* bb_max, const void* hit_next,
    const void* miss_next, const void* first_tri, const void* tri_count,
    const void* tri_order, int n_order, const void* tri9, const void* org,
    const void* dir, const void* tmin, const void* tmax, int n, void* t_out,
    void* tri_out, void* u_out, void* v_out, void* per_ray,
    void* node_touched, void* tri_touched, void* stream) {
  if (n_order <= 0) return (int)cudaErrorInvalidValue;
  const Bvh b = make_bvh(bb_min, bb_max, hit_next, miss_next, first_tri,
                         tri_count, tri_order, n_order, tri9);
  const Counts c{(int*)per_ray, (unsigned char*)node_touched,
                 (unsigned char*)tri_touched};
  if (n > 0) {
    const int blocks = (n + BVH_THREADS - 1) / BVH_THREADS;
    auto kernel = per_ray ? bvh_closest_count_kernel : bvh_closest_kernel;
    kernel<<<blocks, BVH_THREADS, 0, (cudaStream_t)stream>>>(
        b, (const float*)org, (const float*)dir, (const float*)tmin,
        (const float*)tmax, n, (float*)t_out, (int*)tri_out, (float*)u_out,
        (float*)v_out, c);
  }
  return (int)cudaGetLastError();
}

extern "C" int bvh_shadow_launch(
    const void* bb_min, const void* bb_max, const void* hit_next,
    const void* miss_next, const void* first_tri, const void* tri_count,
    const void* tri_order, int n_order, const void* tri9, const void* lf4,
    const void* org, const void* dir, const void* tmax, int n, void* lg_out,
    void* blocked_out, void* per_ray, void* node_touched, void* tri_touched,
    void* stream) {
  if (n_order <= 0 || ((size_t)lf4 & 15)) return (int)cudaErrorInvalidValue;
  const Bvh b = make_bvh(bb_min, bb_max, hit_next, miss_next, first_tri,
                         tri_count, tri_order, n_order, tri9);
  const Counts c{(int*)per_ray, (unsigned char*)node_touched,
                 (unsigned char*)tri_touched};
  if (n > 0) {
    const int blocks = (n + BVH_THREADS - 1) / BVH_THREADS;
    auto kernel = per_ray ? bvh_shadow_count_kernel : bvh_shadow_kernel;
    kernel<<<blocks, BVH_THREADS, 0, (cudaStream_t)stream>>>(
        b, (const float4*)lf4, (const float*)org, (const float*)dir,
        (const float*)tmax, n, (float*)lg_out, (unsigned char*)blocked_out,
        c);
  }
  return (int)cudaGetLastError();
}
