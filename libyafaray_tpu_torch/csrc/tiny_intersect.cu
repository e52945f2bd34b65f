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
// closest_tiny_kernel: one thread per ray, no reduction across threads.
// Each block stages the n_tris x 9 floats of the (10, T) pack (rows
// v0|e1|e2) into shared memory once (at most 2.3 KB), then every thread
// walks the triangles in column order.
//
// shadow_tiny_kernel: the column walk of column_walk.cuh with R = TINY_RAYS
// neighbouring rays a thread.  A block stages the n_tris real columns
// column-major (12 floats a column, at most 3 KB) and builds the boxes of
// the TINY_GROUP-column groups (one box a quad of the Cornell box, at most
// 32), each the min / max over its real columns of v0, v0 + e1 and v0 + e2
// in float32: the table _column_boxes(pack, n_tris, TINY_GROUP) of
// ops/cuda_intersect.py gives, built where the pack already is, so the
// wrapper and the scene need nothing new.  A thread tests its live rays
// against the boxes, ORs the groups they enter into one mask and walks it:
// each ray adds a column's log filters where its own test passes, columns
// in rising order, no floor and no early exit, as in the reference.  The
// one-thread body it replaced stays, launched only by
// shadow_logsum_tiny_before_launch for chip_smoke.py to time beside it.
//
// What bounds it on the H100: FP32 compute.  A ray-triangle test is about
// 45 operations; a box test about 39.  The one-thread body tests every
// column (32 on the Cornell box: ~1,400 operations a ray against 28 B read
// and 12 B written).  A room's quads are small against its segments, so a
// ray enters about one of the 16 quad boxes: 16 box tests and ~2 pair tests
// in place of 32 pair tests.
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

__global__ void closest_tiny_kernel(
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

// Box b of the (6, TINY_BOXES) table `box`: lo xyz | hi xyz of v0, v0 + e1
// and v0 + e2 over the real columns of group b (columns TINY_GROUP b on,
// below n_tris), in float32 as _column_boxes rounds them; one box a thread.
__device__ __forceinline__ void build_boxes(float* box,
                                            const float* __restrict__ pack,
                                            int w, int n_tris) {
  const int b = threadIdx.x;
  if (b >= (n_tris + TINY_GROUP - 1) / TINY_GROUP) return;
  const int k1 = min((b + 1) * TINY_GROUP, n_tris);
  for (int a = 0; a < 3; ++a) {
    float lo = INFINITY, hi = -INFINITY;
    for (int k = b * TINY_GROUP; k < k1; ++k) {
      const float v0 = pack[a * w + k];
      const float p1 = v0 + pack[(a + 3) * w + k];
      const float p2 = v0 + pack[(a + 6) * w + k];
      lo = fminf(lo, fminf(fminf(v0, p1), p2));
      hi = fmaxf(hi, fmaxf(fmaxf(v0, p1), p2));
    }
    box[a * TINY_BOXES + b] = lo;
    box[(a + 3) * TINY_BOXES + b] = hi;
  }
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
  build_boxes(box, pack, pack_w, n_tris);
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

// ---- the one-thread body shadow_tiny_kernel replaced ----------------------

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
  if (n_tris < 0 || n_tris > TINY_TRIS || n_tris > pack_w) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    closest_tiny_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)pack, pack_w, n_tris, (const float*)org,
        (const float*)dir, (const float*)tmin, (const float*)tmax, n,
        (float*)t_out, (int*)tri_out, (float*)u_out, (float*)v_out);
  }
  return (int)cudaGetLastError();
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

// The one-thread body shadow_logsum_tiny_launch replaced, every column for
// every ray.
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
