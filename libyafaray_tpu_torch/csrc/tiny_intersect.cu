// Tiny-scene ray-triangle intersection kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of libyafaray_tpu/ops/pallas_intersect.py for
// scenes of at most 64 triangles:
//   closest_tiny_kernel  <- _closest_kernel_tiny (wrapper _closest_hit_tiny)
//   shadow_tiny_kernel   <- _shadow_kernel_tiny  (wrapper
//                           _shadow_transmission_tiny)
// with the per-pair math of _mt_test_scalar (Moller-Trumbore).
// Rays come as the engine holds them: (N, 3) contiguous org / dir and
// (N,) tmin / tmax / dist; the TPU's (3, M, 128) tiling is not reproduced.
//
// Both are walks of column_walk.cuh over the boxes of the pack's
// TINY_GROUP-column groups (one box a quad of the Cornell box, at most 32).
// A block stages the n_tris real columns column-major (at most 3 KB) and
// builds the boxes from them, each the min / max over its real columns of
// v0, v0 + e1 and v0 + e2 in float32: the table _column_boxes(pack, n_tris,
// TINY_GROUP) of ops/cuda_intersect.py gives (tiny_boxes), built where the
// pack already is, so the wrappers and the scene need nothing new.
//
// closest_tiny_kernel: the closest walk (closest_items).  A ray's thread
// box-tests the 16 quads and tests the quad it enters nearest; its other
// entered quads go to a list of (ray, quad) items the block's threads take
// in turn, and each ray's (t, column) minimum is kept as one 64-bit key
// lowered with an atomic minimum: the first column wins ties, as in the
// reference.  u and v are computed again for the winning column at the
// end.  Walked by its own thread, each ray of a warp would wait on the
// others: the rays that bounce off the walls scatter, and a warp tested
// the columns of the union of its rays' quads (about nine of 16 where a ray
// needs ~1.3), slower than every column on the photon path's final-gather
// calls (PERF.md).
//
// shadow_tiny_kernel: TINY_RAYS neighbouring rays a thread.  A thread tests
// its live rays against the boxes, ORs the groups they enter into one mask
// and walks it: each ray adds a column's log filters where its own test
// passes, columns in rising order, no floor and no early exit, as in the
// reference.
//
// The one-thread bodies the walks replaced stay, launched only by
// closest_hit_tiny_before_launch and shadow_logsum_tiny_before_launch for
// chip_smoke.py to time beside them.
//
// What bounds them on the H100.  A ray-triangle test is about 45 FP32
// operations; a box test about 39.  The one-thread bodies test every column
// (32 on the Cornell box: ~1,400 operations a ray against 28-44 B of rays
// and outputs).  A room's quads are small against its rays, so a camera
// ray enters about three of the 16 quad boxes below its hit and a shadow
// segment about one: 16 box tests and ~2 pair tests in place of 32 pair
// tests, and both kernels are bound by their bytes.
//
// Built with -fmad=false and IEEE division (no --use_fast_math) on
// purpose: no product is contracted into an FMA and 1/det is the correctly
// rounded quotient, so every operation rounds exactly as one float32 op of
// the plain PyTorch version in ops/cuda_intersect.py (and of the JAX
// reference) does.  The kernels then reproduce the plain version bit for
// bit, which lets chip_smoke.py hold them to equality, not only tolerance.
// Constants are written as (float)<double> to round as the reference's
// Python-float constants do.

#include <cuda_runtime.h>
#include <math.h>

#include "column_walk.cuh"

#define TINY_TRIS 64
#define THREADS 256
#define TINY_GROUP 2  // columns of a box of shadow_tiny_kernel
#define TINY_BOXES (TINY_TRIS / TINY_GROUP)
#define TINY_RAYS 2   // rays a thread of shadow_tiny_kernel owns
#define TINY_ITEMS 1024  // (ray, group) items closest_tiny_kernel lists

namespace {

// Moller-Trumbore test of triangle k (staged pack s, row stride nt)
// against one ray, in the operation order of _mt_test_scalar.
__device__ __forceinline__ bool mt_test(const float* s, int nt, int k,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float* t, float* u, float* v) {
  const float v0x = s[0 * nt + k], v0y = s[1 * nt + k], v0z = s[2 * nt + k];
  const float e1x = s[3 * nt + k], e1y = s[4 * nt + k], e1z = s[5 * nt + k];
  const float e2x = s[6 * nt + k], e2y = s[7 * nt + k], e2z = s[8 * nt + k];
  const float eps = (float)1e-12;
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = px * e1x + py * e1y + pz * e1z;
  const float inv = 1.0f / (fabsf(det) < eps ? 1.0f : det);
  const float tx = ox - v0x;
  const float ty = oy - v0y;
  const float tz = oz - v0z;
  *u = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  *v = (dx * qx + dy * qy + dz * qz) * inv;
  *t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  return (fabsf(det) > eps) & (*u >= 0.0f) & (*v >= 0.0f) &
         (*u + *v <= 1.0f);
}

// Copies rows [0, rows) x columns [0, nt) of a row-major (.., w) array
// into s[r * nt + k].
__device__ __forceinline__ void stage(float* s, const float* src, int w,
                                      int rows, int nt) {
  for (int i = threadIdx.x; i < rows * nt; i += blockDim.x) {
    const int r = i / nt;
    const int k = i - r * nt;
    s[i] = src[(long long)r * w + k];
  }
}

// Thread t of block b owns ray b * THREADS + t.  Dynamic shared memory:
// item_smem_bytes(n_tris, groups, TINY_ITEMS, THREADS).
__global__ void __launch_bounds__(THREADS, ITEM_MIN_BLOCKS)
closest_tiny_kernel(const float* __restrict__ pack, int pack_w, int n_tris,
                    const float* __restrict__ org,
                    const float* __restrict__ dir,
                    const float* __restrict__ tmin,
                    const float* __restrict__ tmax, int n,
                    float* __restrict__ t_out, int* __restrict__ tri_out,
                    float* __restrict__ u_out, float* __restrict__ v_out) {
  extern __shared__ float4 sm4[];
  const int groups = (n_tris + TINY_GROUP - 1) / TINY_GROUP;
  float4* tab;
  float* box;
  const ItemSmem m = item_smem(sm4, n_tris, groups, TINY_ITEMS, &tab, &box);
  stage_columns(reinterpret_cast<float*>(tab), pack, pack_w, nullptr, 0,
                n_tris);
  __syncthreads();
  build_group_boxes<TINY_GROUP>(box, groups,
                                reinterpret_cast<const float*>(tab), n_tris);
  __syncthreads();
  closest_items<TINY_GROUP, 1, true>(
      tab, box, groups, groups, n_tris, m, org, dir, tmin, tmax,
      (long long)blockIdx.x * blockDim.x, n, t_out, tri_out, u_out, v_out);
}

// Thread t of block b owns rays (b * THREADS + t) * R + j, j < R.
__global__ void __launch_bounds__(THREADS)
shadow_tiny_kernel(const float* __restrict__ pack, int pack_w,
                   const float* __restrict__ logf, int logf_w, int n_tris,
                   const float* __restrict__ org,
                   const float* __restrict__ dir,
                   const float* __restrict__ dist, int n,
                   float* __restrict__ lg_out) {
  __shared__ float4 tab[3 * TINY_TRIS];
  __shared__ float box[6 * TINY_BOXES];
  stage_columns(reinterpret_cast<float*>(tab), pack, pack_w, logf, logf_w,
                n_tris);
  __syncthreads();
  build_group_boxes<TINY_GROUP>(box, TINY_BOXES,
                                reinterpret_cast<const float*>(tab), n_tris);
  __syncthreads();
  constexpr int R = TINY_RAYS;
  const long long i0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * R;
  if (i0 >= n) return;
  float o[R][3], d[R][3], hi[R], acc[R][3];
  load_segments<R>(org, dir, dist, i0, n, o, d, hi, acc);
  unsigned enter[R];
  enter_groups<R>(box, TINY_BOXES, 0, (n_tris + TINY_GROUP - 1) / TINY_GROUP,
                  o, d, hi, enter);
  sum_groups<R, TINY_GROUP, false>(tab, n_tris, 0, enter, o, d, hi, acc);
  store_sums<R>(lg_out, i0, n, acc);
}

// ---- the one-thread bodies the walks replaced -----------------------------

__global__ void closest_tiny_thread_kernel(
    const float* __restrict__ pack, int pack_w, int n_tris,
    const float* __restrict__ org, const float* __restrict__ dir,
    const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float s[9 * TINY_TRIS];
  stage(s, pack, pack_w, 9, n_tris);
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = org[3 * i], oy = org[3 * i + 1], oz = org[3 * i + 2];
  const float dx = dir[3 * i], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
  const float lo = tmin[i], hi = tmax[i];
  float best_t = INFINITY, best_u = 0.0f, best_v = 0.0f;
  int best_k = 0;
  for (int k = 0; k < n_tris; ++k) {
    float t, u, v;
    const bool ok = mt_test(s, n_tris, k, ox, oy, oz, dx, dy, dz, &t, &u, &v);
    // strict t < best_t: the first column wins ties, as in the reference
    if (ok && t > lo && t < best_t && t < hi) {
      best_t = t;
      best_u = u;
      best_v = v;
      best_k = k;
    }
  }
  t_out[i] = best_t;
  tri_out[i] = best_k;
  u_out[i] = best_u;
  v_out[i] = best_v;
}

__global__ void shadow_tiny_thread_kernel(
    const float* __restrict__ pack, int pack_w, const float* __restrict__ logf,
    int logf_w, int n_tris, const float* __restrict__ org,
    const float* __restrict__ dir, const float* __restrict__ dist, int n,
    float* __restrict__ lg_out) {
  __shared__ float s[9 * TINY_TRIS];
  __shared__ float lf[3 * TINY_TRIS];
  stage(s, pack, pack_w, 9, n_tris);
  stage(lf, logf, logf_w, 3, n_tris);
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = org[3 * i], oy = org[3 * i + 1], oz = org[3 * i + 2];
  const float dx = dir[3 * i], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
  const float lo = (float)5e-4;
  const float hi = dist[i] * (float)(1.0 - 1e-4) - (float)5e-4;
  float lr = 0.0f, lg = 0.0f, lb = 0.0f;
  for (int k = 0; k < n_tris; ++k) {
    float t, u, v;
    const bool ok = mt_test(s, n_tris, k, ox, oy, oz, dx, dy, dz, &t, &u, &v);
    if (ok && t > lo && t < hi) {
      lr += lf[k];
      lg += lf[n_tris + k];
      lb += lf[2 * n_tris + k];
    }
  }
  lg_out[3 * i] = lr;
  lg_out[3 * i + 1] = lg;
  lg_out[3 * i + 2] = lb;
}

// closest_tiny_kernel (walk) or the one-thread body, one thread a ray.
template <typename K>
int launch_closest(K kernel, bool walk, const void* pack, int pack_w,
                   int n_tris, const void* org, const void* dir,
                   const void* tmin, const void* tmax, int n, void* t_out,
                   void* tri_out, void* u_out, void* v_out, void* stream) {
  if (n_tris < 0 || n_tris > TINY_TRIS || n_tris > pack_w) {
    return (int)cudaErrorInvalidValue;
  }
  const int groups = (n_tris + TINY_GROUP - 1) / TINY_GROUP;
  const int bytes =
      walk ? item_smem_bytes(n_tris, groups, TINY_ITEMS, THREADS) : 0;
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    kernel<<<blocks, THREADS, bytes, (cudaStream_t)stream>>>(
        (const float*)pack, pack_w, n_tris, (const float*)org,
        (const float*)dir, (const float*)tmin, (const float*)tmax, n,
        (float*)t_out, (int*)tri_out, (float*)u_out, (float*)v_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// `stream` is a cudaStream_t.  Each returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int closest_hit_tiny_launch(const void* pack, int pack_w,
                                       int n_tris, const void* org,
                                       const void* dir, const void* tmin,
                                       const void* tmax, int n, void* t_out,
                                       void* tri_out, void* u_out,
                                       void* v_out, void* stream) {
  return launch_closest(closest_tiny_kernel, true, pack, pack_w, n_tris, org,
                        dir, tmin, tmax, n, t_out, tri_out, u_out, v_out,
                        stream);
}

extern "C" int shadow_logsum_tiny_launch(const void* pack, int pack_w,
                                         const void* logf, int logf_w,
                                         int n_tris, const void* org,
                                         const void* dir, const void* dist,
                                         int n, void* lg_out, void* stream) {
  if (n_tris < 0 || n_tris > TINY_TRIS || n_tris > pack_w ||
      n_tris > logf_w) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    const long long per_block = (long long)THREADS * TINY_RAYS;
    const int blocks = (int)((n + per_block - 1) / per_block);
    shadow_tiny_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)pack, pack_w, (const float*)logf, logf_w, n_tris,
        (const float*)org, (const float*)dir, (const float*)dist, n,
        (float*)lg_out);
  }
  return (int)cudaGetLastError();
}

// The one-thread bodies closest_hit_tiny_launch and
// shadow_logsum_tiny_launch replaced, every column for every ray.
extern "C" int closest_hit_tiny_before_launch(
    const void* pack, int pack_w, int n_tris, const void* org,
    const void* dir, const void* tmin, const void* tmax, int n, void* t_out,
    void* tri_out, void* u_out, void* v_out, void* stream) {
  return launch_closest(closest_tiny_thread_kernel, false, pack, pack_w,
                        n_tris, org, dir, tmin, tmax, n, t_out, tri_out,
                        u_out, v_out, stream);
}

extern "C" int shadow_logsum_tiny_before_launch(
    const void* pack, int pack_w, const void* logf, int logf_w, int n_tris,
    const void* org, const void* dir, const void* dist, int n, void* lg_out,
    void* stream) {
  if (n_tris < 0 || n_tris > TINY_TRIS || n_tris > pack_w ||
      n_tris > logf_w) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    shadow_tiny_thread_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)pack, pack_w, (const float*)logf, logf_w, n_tris,
        (const float*)org, (const float*)dir, (const float*)dist, n,
        (float*)lg_out);
  }
  return (int)cudaGetLastError();
}
