// The column walk of the port's shadow sums, shared by shadow_dense_kernel
// and shadow_stream_kernel (cluster_intersect.cu) and shadow_tiny_kernel
// (tiny_intersect.cu), with the ray, box and Moller-Trumbore primitives of
// the mid-size kernels.
//
// A block stages the pack column-major (stage_columns): 12 floats a column,
// v0 | e1 | e2 | log filter rgb, so a thread reads a column with three
// 16-byte broadcast loads.  A thread owns R neighbouring segments.  It tests
// each live segment against the boxes of the pack's G-column groups
// (enter_groups) and walks the groups one of them enters (sum_groups),
// groups and columns in rising order, each column read once for all R
// segments; a segment adds a column's log filters where its own test passes.
// A group a segment's box test would have culled holds no crossing of that
// segment (boxes widened as box_entry says), so every sum is the brute
// force's, its terms added in rising column order from 0.
//
// The stream sum (kStop) is floored at -80 by its caller, once, at the end.
// Every log filter is <= 0, so the running sum only falls: once all three
// channels of a segment are <= -80 its floored result is -80 whatever it
// crosses later.  Such a segment stops testing; a segment tests only the
// groups it enters itself; a thread stops once none of its segments is
// left.  A segment opaque in one or two channels walks on.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define TAB 12  // floats a staged column: v0 | e1 | e2 | log filter rgb
#define SHADOW_LO ((float)5e-4)  // a shadow segment's tested interval starts
#define LOG_FLOOR (-80.0f)  // log transmission of an opaque crossing

namespace {

struct Ray {
  float o[3], d[3], iv[3], pad[3];
};

__device__ __forceinline__ Ray make_ray(const float (&o)[3],
                                        const float (&d)[3]) {
  Ray r;
  for (int a = 0; a < 3; ++a) {
    r.o[a] = o[a];
    r.d[a] = d[a];
    // _inv_dir: |d| < 1e-12 -> +-1e-12 before inverting
    const float eps = (float)1e-12;
    const float dd = fabsf(d[a]) < eps ? (d[a] < 0.0f ? -eps : eps) : d[a];
    r.iv[a] = 1.0f / dd;
    r.pad[a] = (float)1e-5 * fabsf(o[a]);
  }
  return r;
}

// Entry of the ray's interval [lo, hi] into box j of a row-major (6, w)
// table (rows lo xyz | hi xyz), widened on each axis by 1e-5 of the largest
// magnitude among the box's faces and the ray origin, so a skip never drops
// a crossing the brute force takes; +inf if the interval misses it.
__device__ __forceinline__ float box_entry(const float* box, int w, int j,
                                           const Ray& r, float lo, float hi) {
  float enter = lo, exit_ = hi;
  for (int a = 0; a < 3; ++a) {
    const float bl = box[a * w + j];
    const float bh = box[(a + 3) * w + j];
    const float pad = fmaxf(r.pad[a],
                            (float)1e-5 * fmaxf(fabsf(bl), fabsf(bh)));
    const float t0 = (bl - pad - r.o[a]) * r.iv[a];
    const float t1 = (bh + pad - r.o[a]) * r.iv[a];
    enter = fmaxf(enter, fminf(t0, t1));
    exit_ = fminf(exit_, fmaxf(t0, t1));
  }
  return enter <= exit_ ? enter : INFINITY;
}

// Moller-Trumbore test of one triangle (v0, e1, e2) against a ray (o, d) in
// the operation order of _mt_tile; returns det/barycentric validity, t in
// *t.  With kCut it returns false as soon as det or u rules the pair out
// (u outside [0, 1]: with v >= 0, u + v <= 1 fails too), before q, v and
// t: the same answer in fewer instructions where most pairs miss.
template <bool kCut>
__device__ __forceinline__ bool mt_core(float v0x, float v0y, float v0z,
                                        float e1x, float e1y, float e1z,
                                        float e2x, float e2y, float e2z,
                                        const float (&o)[3],
                                        const float (&d)[3], float* t) {
  const float ox = o[0], oy = o[1], oz = o[2];
  const float dx = d[0], dy = d[1], dz = d[2];
  const float eps = (float)1e-12;
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = px * e1x + py * e1y + pz * e1z;
  const float inv = 1.0f / (fabsf(det) < eps ? 1.0f : det);
  const float tx = ox - v0x;
  const float ty = oy - v0y;
  const float tz = oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv;
  if constexpr (kCut) {
    if (!((fabsf(det) > eps) & (u >= 0.0f) & (u <= 1.0f))) return false;
  }
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (dx * qx + dy * qy + dz * qz) * inv;
  *t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  return (fabsf(det) > eps) & (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f);
}

// Stage columns [0, cols) of the pack's geometry rows (row stride w) and of
// the log-filter rows (row stride lw) column-major: tab[TAB k + r] holds row
// r (0-8 v0 | e1 | e2, 9-11 the log filters r g b) of column k.
__device__ __forceinline__ void stage_columns(float* tab,
                                              const float* __restrict__ pack,
                                              int w,
                                              const float* __restrict__ logf,
                                              int lw, int cols) {
  for (int i = threadIdx.x; i < TAB * cols; i += blockDim.x) {
    const int r = i / cols;
    const int k = i - r * cols;
    tab[TAB * k + r] = r < 9 ? pack[r * w + k] : logf[(r - 9) * lw + k];
  }
}

// Segments i0 + j, j < R, of a batch of n: origin, direction, the end hi of
// the tested interval (SHADOW_LO, hi), and a zero sum.  A segment past the
// batch gets an empty interval, as a dead one (dist < 0) has.
template <int R>
__device__ __forceinline__ void load_segments(
    const float* __restrict__ org, const float* __restrict__ dir,
    const float* __restrict__ dist, long long i0, int n, float (&o)[R][3],
    float (&d)[R][3], float (&hi)[R], float (&acc)[R][3]) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const long long i = i0 + j;
    const bool has = i < n;
    for (int a = 0; a < 3; ++a) {
      o[j][a] = has ? org[3 * i + a] : 0.0f;
      d[j][a] = has ? dir[3 * i + a] : 0.0f;
      acc[j][a] = 0.0f;
    }
    hi[j] = has ? dist[i] * (float)(1.0 - 1e-4) - SHADOW_LO : -1.0f;
  }
}

// Bit b of enter[j]: segment j's interval enters box g0 + b (b < nb <= 32)
// of the (6, w) table `box`; no bit for a segment whose interval is empty.
template <int R>
__device__ __forceinline__ void enter_groups(const float* box, int w, int g0,
                                             int nb, const float (&o)[R][3],
                                             const float (&d)[R][3],
                                             const float (&hi)[R],
                                             unsigned (&enter)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    enter[j] = 0;
    if (!(SHADOW_LO <= hi[j])) continue;
    const Ray r = make_ray(o[j], d[j]);
    for (int b = 0; b < nb; ++b) {
      if (box_entry(box, w, g0 + b, r, SHADOW_LO, hi[j]) < INFINITY)
        enter[j] |= 1u << b;
    }
  }
}

// Add to each of R segments (origin o[j], direction d[j], interval
// (SHADOW_LO, hi[j])) the log filters of the columns it crosses among
// [G g, min(G g + G, n_tris)) for each group g = g0 + b whose bit b is set
// in one of enter[]: groups and columns in rising order, each column read
// once (three broadcast 16-byte loads of the stage_columns table) for all R
// segments.  Without kStop every segment tests every walked group.  With
// kStop a segment tests only the groups of its own enter[j], and after each
// group one whose three channels are all <= LOG_FLOOR is dropped (its enter
// bits cleared, hi[j] set below SHADOW_LO so a later sweep skips it too);
// the walk ends once no segment is left.
template <int R, int G, bool kStop>
__device__ __forceinline__ void sum_groups(const float4* __restrict__ tab,
                                           int n_tris, int g0,
                                           unsigned (&enter)[R],
                                           const float (&o)[R][3],
                                           const float (&d)[R][3],
                                           float (&hi)[R],
                                           float (&acc)[R][3]) {
  unsigned left = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) left |= enter[j];
  while (left) {
    const int b = __ffs(left) - 1;
    left &= left - 1;
    const int g = g0 + b;
    bool on[R];
#pragma unroll
    for (int j = 0; j < R; ++j) on[j] = !kStop || ((enter[j] >> b) & 1u);
    const int k1 = min((g + 1) * G, n_tris);
    for (int k = g * G; k < k1; ++k) {
      const float4 a = tab[3 * k], bq = tab[3 * k + 1], c = tab[3 * k + 2];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (!on[j]) continue;
        float t;
        const bool ok = mt_core<true>(a.x, a.y, a.z, a.w, bq.x, bq.y, bq.z,
                                      bq.w, c.x, o[j], d[j], &t);
        if (ok && t > SHADOW_LO && t < hi[j]) {
          acc[j][0] += c.y;
          acc[j][1] += c.z;
          acc[j][2] += c.w;
        }
      }
    }
    if constexpr (kStop) {
      unsigned live = 0;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (acc[j][0] <= LOG_FLOOR && acc[j][1] <= LOG_FLOOR &&
            acc[j][2] <= LOG_FLOOR) {
          enter[j] = 0;
          hi[j] = -1.0f;
        }
        live |= enter[j];
      }
      left &= live;
    }
  }
}

// Write the R segments' sums (N, 3) for those inside the batch.
template <int R>
__device__ __forceinline__ void store_sums(float* __restrict__ lg_out,
                                           long long i0, int n,
                                           const float (&acc)[R][3]) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const long long i = i0 + j;
    if (i < n) {
      lg_out[3 * i] = acc[j][0];
      lg_out[3 * i + 1] = acc[j][1];
      lg_out[3 * i + 2] = acc[j][2];
    }
  }
}

}  // namespace
