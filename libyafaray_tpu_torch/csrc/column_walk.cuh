// The column walks of the port's mid-size and tiny kernels, with the ray,
// box and Moller-Trumbore primitives they share: the shadow sums
// shadow_dense_kernel and shadow_stream_kernel (cluster_intersect.cu) and
// shadow_tiny_kernel (tiny_intersect.cu), and the closest hits
// closest_dense_kernel and closest_tiny_kernel.
//
// A block stages the pack column-major (stage_columns): 12 floats a column,
// v0 | e1 | e2 | log filter rgb (the closest hits stage the geometry
// alone), so a thread reads a column with three 16-byte broadcast loads.
// The boxes of the pack's G-column groups come from the compile (box32) or
// are built by the block from the staged columns (build_group_boxes).
//
// Shadow sums.  A thread owns R neighbouring segments.  It tests each live
// segment against the group boxes (enter_groups) and walks the groups one
// of them enters (sum_groups), groups and columns in rising order, each
// column read once for all R segments; a segment adds a column's log
// filters where its own test passes.  A group a segment's box test would
// have culled holds no crossing of that segment (boxes widened as box_entry
// says), so every sum is the brute force's, its terms added in rising
// column order from 0.
//
// The stream sum (kStop) is floored at -80 by its caller, once, at the end.
// Every log filter is <= 0, so the running sum only falls: once all three
// channels of a segment are <= -80 its floored result is -80 whatever it
// crosses later.  Such a segment stops testing; a segment tests only the
// groups it enters itself; a thread stops once none of its segments is
// left.  A segment opaque in one or two channels walks on.
//
// Closest hits (closest_items).  A thread owns one ray, its interval
// [lo, hi] and its best hit (t, column), kept in shared memory as one
// 64-bit key (hit_key) that orders as (t, column) does.  It box-tests its
// ray against every group and walks the group the ray enters nearest
// itself (closest_item); the ray's other entered groups go to a list the
// block's threads share, each taken by one thread, which tests the group's
// columns where its entry lies at or below the ray's best t and lowers
// the ray's key with an atomic minimum.  A group the ray's interval cut at
// its best t misses holds no hit at t <= best, so the key ends at the
// brute force's answer, the lexicographic minimum (t, column) over the
// real columns hit in (lo, hi), in whatever order the items are taken.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define TAB 12  // floats a staged column: v0 | e1 | e2 | log filter rgb
#define SHADOW_LO ((float)5e-4)  // a shadow segment's tested interval starts
#define LOG_FLOOR (-80.0f)  // log transmission of an opaque crossing
// blocks of 256 threads an SM holds of a kernel of closest_items: at most 64
// registers a thread
#define ITEM_MIN_BLOCKS 4

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
// the operation order of _mt_tile; returns det/barycentric validity, t, u
// and v in *t, *u, *v.  With kCut it returns false as soon as det or u
// rules the pair out (u outside [0, 1]: with v >= 0, u + v <= 1 fails too),
// before q, v and t: the same answer in fewer instructions where most pairs
// miss.
template <bool kCut>
__device__ __forceinline__ bool mt_uvt(float v0x, float v0y, float v0z,
                                       float e1x, float e1y, float e1z,
                                       float e2x, float e2y, float e2z,
                                       const float (&o)[3],
                                       const float (&d)[3], float* t,
                                       float* u_out, float* v_out) {
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
  *u_out = u;
  *v_out = v;
  return (fabsf(det) > eps) & (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f);
}

// mt_uvt for a caller that needs only t.
template <bool kCut>
__device__ __forceinline__ bool mt_core(float v0x, float v0y, float v0z,
                                        float e1x, float e1y, float e1z,
                                        float e2x, float e2y, float e2z,
                                        const float (&o)[3],
                                        const float (&d)[3], float* t) {
  float u, v;
  return mt_uvt<kCut>(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, o, d, t,
                      &u, &v);
}

// Stage columns [0, cols) of the pack's geometry rows (row stride w) and of
// the log-filter rows (row stride lw) column-major: tab[TAB k + r] holds row
// r (0-8 v0 | e1 | e2, 9-11 the log filters r g b) of column k.  Without
// log filters (logf null: the closest hits) rows 9-11 are not written.
__device__ __forceinline__ void stage_columns(float* tab,
                                              const float* __restrict__ pack,
                                              int w,
                                              const float* __restrict__ logf,
                                              int lw, int cols) {
  const int rows = logf ? TAB : 9;
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols;
    const int k = i - r * cols;
    tab[TAB * k + r] = r < 9 ? pack[r * w + k] : logf[(r - 9) * lw + k];
  }
}

// Boxes of the G-column groups of the staged columns [0, n_tris) into the
// (6, nb) table `box` (rows lo xyz | hi xyz): group b the min / max over
// its real columns of v0, v0 + e1 and v0 + e2 in float32, as _column_boxes
// (ops/cuda_intersect.py) rounds them; one box a thread.  Call after the
// stage is complete.
template <int G>
__device__ __forceinline__ void build_group_boxes(float* box, int nb,
                                                  const float* tab,
                                                  int n_tris) {
  const int groups = (n_tris + G - 1) / G;
  for (int b = threadIdx.x; b < groups; b += blockDim.x) {
    const int k1 = min((b + 1) * G, n_tris);
    for (int a = 0; a < 3; ++a) {
      float lo = INFINITY, hi = -INFINITY;
      for (int k = b * G; k < k1; ++k) {
        const float v0 = tab[TAB * k + a];
        const float p1 = v0 + tab[TAB * k + 3 + a];
        const float p2 = v0 + tab[TAB * k + 6 + a];
        lo = fminf(lo, fminf(fminf(v0, p1), p2));
        hi = fmaxf(hi, fmaxf(fmaxf(v0, p1), p2));
      }
      box[a * nb + b] = lo;
      box[(a + 3) * nb + b] = hi;
    }
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

// ---- closest hits ----------------------------------------------------------

// Ray i of a batch of n (org / dir (n, 3), tmin / tmax (n,)) and its
// interval [lo, hi]; a ray past the batch gets an empty interval, as a dead
// one (tmax < tmin) has.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ org,
                                        const float* __restrict__ dir,
                                        const float* __restrict__ tmin,
                                        const float* __restrict__ tmax,
                                        long long i, int n, float* lo,
                                        float* hi) {
  const bool has = i < n;
  float o[3], d[3];
  for (int a = 0; a < 3; ++a) {
    o[a] = has ? org[3 * i + a] : 0.0f;
    d[a] = has ? dir[3 * i + a] : 1.0f;
  }
  *lo = has ? tmin[i] : 0.0f;
  *hi = has ? tmax[i] : -1.0f;
  return make_ray(o, d);
}

// A hit as a 64-bit key that orders as (t, column) does: t's bits mapped to
// an unsigned of the same order (any sign) above the column.
__device__ __forceinline__ unsigned long long hit_key(float t, int k) {
  const unsigned u = __float_as_uint(t);
  const unsigned ot = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (unsigned long long)ot << 32 | (unsigned)k;
}

__device__ __forceinline__ float key_t(unsigned long long key) {
  const unsigned ot = (unsigned)(key >> 32);
  return __uint_as_float((ot & 0x80000000u) ? (ot & 0x7fffffffu) : ~ot);
}

// A slot of the list `count` counts for each active lane of the warp, with
// one atomic a warp.
__device__ __forceinline__ int append_slot(int* count) {
  const unsigned mask = __activemask();
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int first = 0;
  if (lane == leader) first = atomicAdd(count, __popc(mask));
  first = __shfl_sync(mask, first, leader);
  return first + __popc(mask & ((1u << lane) - 1u));
}

// Shared memory of closest_items beyond the staged columns and the boxes:
// each ray's best hit as a hit_key, the rays (8 rows of blockDim.x: o xyz |
// d xyz | lo | hi), a list of `cap` (ray, group) items with the entry of
// the group's box, and the list's length.
struct ItemSmem {
  unsigned long long* key;
  float* ray;
  unsigned* item;
  float* ent;
  int* count;
  int cap;
};

// The dynamic shared memory of a kernel of closest_items, in order: the
// rays' keys, the n_tris staged columns, the (6, groups) boxes, the rays
// and a list of `cap` items.
__host__ __device__ __forceinline__ int item_smem_bytes(int n_tris,
                                                        int groups, int cap,
                                                        int threads) {
  return (int)sizeof(unsigned long long) * threads +
         (int)sizeof(float) *
             (TAB * n_tris + 6 * groups + 8 * threads + 2 * cap + 1);
}

// That memory from its start `base`: the ItemSmem, and in *tab and *box
// the staged columns' and the boxes' places.
__device__ __forceinline__ ItemSmem item_smem(float4* base, int n_tris,
                                              int groups, int cap,
                                              float4** tab, float** box) {
  ItemSmem m;
  m.key = reinterpret_cast<unsigned long long*>(base);
  *tab = reinterpret_cast<float4*>(m.key + blockDim.x);
  *box = reinterpret_cast<float*>(*tab) + TAB * n_tris;
  m.ray = *box + 6 * groups;
  m.item = reinterpret_cast<unsigned*>(m.ray + 8 * blockDim.x);
  m.cap = cap;
  m.ent = reinterpret_cast<float*>(m.item + cap);
  m.count = reinterpret_cast<int*>(m.ent + cap);
  return m;
}

// Test the columns of group g (rising, below n_tris) against ray r of the
// block's ItemSmem and lower its key to the nearest hit found.
template <int G>
__device__ __forceinline__ void closest_item(const float4* __restrict__ tab,
                                             int n_tris, const ItemSmem& m,
                                             int r, int g) {
  const int stride = blockDim.x;
  const float o[3] = {m.ray[r], m.ray[stride + r], m.ray[2 * stride + r]};
  const float d[3] = {m.ray[3 * stride + r], m.ray[4 * stride + r],
                      m.ray[5 * stride + r]};
  const float lo = m.ray[6 * stride + r], hi = m.ray[7 * stride + r];
  float best = INFINITY;
  int best_k = 0;
  const int k1 = min((g + 1) * G, n_tris);
  for (int k = g * G; k < k1; ++k) {
    const float4 a = tab[3 * k], b = tab[3 * k + 1], c = tab[3 * k + 2];
    float t;
    if (mt_core<true>(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, o, d,
                      &t) &&
        t > lo && t < hi && t < best) {
      best = t;
      best_k = k;
    }
  }
  if (best < INFINITY) atomicMin(&m.key[r], hit_key(best, best_k));
}

// The nearest hit (t, column) of each ray base + t, t < blockDim.x, of a
// batch of n among the real columns [0, n_tris) staged in `tab`, skipping
// by the boxes of the G-column groups (the (6, nb) table `box`, `groups`
// real groups, at most 32 NW), to t_out / k_out (t = inf, column 0 on a
// miss) and, with kUV, its u and v (0 on a miss), computed again for the
// hit's column in the same operations as the test that found it.  Every
// thread of the block calls it.
//
// A thread box-tests its ray against every group over the whole interval
// and tests the group it enters nearest (the lower group on equal entries)
// itself.  The other groups its ray entered go to a list the
// block shares, where the interval cut at the ray's best t still enters
// them; the block's threads then take the list's items in turn, each
// testing one group's columns against its ray where the group's entry
// lies at or below the ray's best t so far, and lowering the ray's key
// (hit_key: the lexicographic (t, column) minimum) with an atomic minimum.
// A ray's walk thus spreads over the block: a warp's threads no longer
// wait on the one ray among them that enters the most groups.  The list
// takes the groups of 32 at a time (one mask word); an item that finds
// the list full is tested by its ray's own thread.
template <int G, int NW, bool kUV>
__device__ __forceinline__ void closest_items(
    const float4* __restrict__ tab, const float* box, int nb, int groups,
    int n_tris, const ItemSmem& m, const float* __restrict__ org,
    const float* __restrict__ dir, const float* __restrict__ tmin,
    const float* __restrict__ tmax, long long base, int n,
    float* __restrict__ t_out, int* __restrict__ k_out,
    float* __restrict__ u_out, float* __restrict__ v_out) {
  const int tid = threadIdx.x, stride = blockDim.x;
  float lo, hi;
  const Ray ray = load_ray(org, dir, tmin, tmax, base + tid, n, &lo, &hi);
  for (int a = 0; a < 3; ++a) {
    m.ray[a * stride + tid] = ray.o[a];
    m.ray[(a + 3) * stride + tid] = ray.d[a];
  }
  m.ray[6 * stride + tid] = lo;
  m.ray[7 * stride + tid] = hi;
  m.key[tid] = hit_key(INFINITY, 0);
  unsigned enter[NW];
  int first = -1;
  {
    float near = INFINITY;
#pragma unroll
    for (int c = 0; c < NW; ++c) {
      unsigned word = 0;
      if (lo <= hi) {
        for (int g = 32 * c; g < min(32 * c + 32, groups); ++g) {
          const float e = box_entry(box, nb, g, ray, lo, hi);
          if (e < INFINITY) word |= 1u << (g - 32 * c);
          if (e < near) {
            near = e;
            first = g;
          }
        }
      }
      enter[c] = word;
    }
  }
  if (first >= 0) {
    closest_item<G>(tab, n_tris, m, tid, first);
#pragma unroll
    for (int c = 0; c < NW; ++c) {
      if (first >> 5 == c) enter[c] &= ~(1u << (first & 31));
    }
  }
  float best = key_t(m.key[tid]);
#pragma unroll
  for (int c = 0; c < NW; ++c) {
    if (tid == 0) *m.count = 0;
    __syncthreads();
    for (unsigned w = enter[c]; w; w &= w - 1) {
      const int g = 32 * c + __ffs(w) - 1;
      const float e = box_entry(box, nb, g, ray, lo, fminf(hi, best));
      if (!(e < INFINITY)) continue;
      const int slot = append_slot(m.count);
      if (slot < m.cap) {
        m.item[slot] = (unsigned)tid << 16 | (unsigned)g;
        m.ent[slot] = e;
      } else {
        closest_item<G>(tab, n_tris, m, tid, g);
      }
    }
    __syncthreads();
    const int items = min(*m.count, m.cap);
    for (int k = tid; k < items; k += stride) {
      const int r = (int)(m.item[k] >> 16), g = (int)(m.item[k] & 0xffffu);
      const volatile unsigned long long* key = m.key;
      if (m.ent[k] <= fminf(m.ray[7 * stride + r], key_t(key[r]))) {
        closest_item<G>(tab, n_tris, m, r, g);
      }
    }
    __syncthreads();
    best = key_t(m.key[tid]);
  }
  const long long i = base + tid;
  if (i >= n) return;
  const int k = (int)(m.key[tid] & 0xffffffffu);
  t_out[i] = best;
  k_out[i] = k;
  if constexpr (kUV) {
    float t, u = 0.0f, v = 0.0f;
    if (best < INFINITY) {
      const float4 a = tab[3 * k], b = tab[3 * k + 1], c = tab[3 * k + 2];
      mt_uvt<false>(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, ray.o, ray.d,
                    &t, &u, &v);
    }
    u_out[i] = u;
    v_out[i] = v;
  }
}

}  // namespace
