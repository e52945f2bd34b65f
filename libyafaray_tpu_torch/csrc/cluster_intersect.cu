// Mid-size-scene ray-triangle intersection kernels for Hopper (sm_90a).
//
// Replace the dense and streaming TPU kernels of
// libyafaray_tpu/ops/pallas_intersect.py, which carry every scene of 65 to
// 896 triangles (packs of 2 to 7 clusters of 128 columns):
//   closest_dense_kernel  <- _closest_kernel (fewer than 4 clusters):
//                            nearest hit -> (t, pack column)
//   shadow_dense_kernel   <- _shadow_kernel: sum of per-column log filters,
//                            no floor on the total
//   closest_stream_kernel <- _closest_kernel_stream (4 or more clusters, fewer
//                            than 8 sub-clusters): the same function, walked
//                            front to back
//   shadow_stream_kernel  <- _shadow_kernel_stream: the same sum floored at
//                            -80, with the opaque early exit
// with the per-pair math of _mt_tile (Moller-Trumbore, its operation order).
//
// The function, not the TPU schedule.  The TPU kernels build per-512-ray
// block cluster lists, sort them by the block's nearest entry and stream
// (16, 128) tiles through a two-slot DMA pipeline.  Here one thread owns one
// ray, and a 256-thread block stages the whole pack once into shared memory
// (9 geometry rows, plus the 3 log-filter rows for shadows: at most 43 KB
// at 896 columns), so every thread of a warp reads the same column as a
// broadcast.  Dense kernels visit the clusters in index order and skip one
// whose box the ray cannot enter nearer than its best hit.  Stream kernels
// compute the ray's entry into each entered cluster box in registers, sort
// the entries (insertion sort, at most MAX_CL) and walk them nearest first:
// the closest hit stops at the first box entered beyond its best t, the
// shadow sum once all three channels are opaque (<= -80).
//
// Exactness against the plain brute force of ops/cluster_intersect.py:
// * Boxes are widened by 1e-5 of the largest magnitude among their faces and
//   the ray origin on each axis (as in fine_intersect.cu), so a skip never
//   drops a hit the brute force takes.
// * The closest hit keeps the lowest pack column among equal t: dense walks
//   columns in rising order with a strict `<`; stream, whose walk order is
//   the ray's, replaces an equal t only by a lower column, and continues into
//   a box whose entry equals its best t.  (The reference's stream kernel
//   keeps the first-visited column on an exact tie; the t is the same.)
// * Shadows: every log filter is <= 0, so the running sum only falls; the
//   stream kernel's one floor at the end equals the reference's per-cluster
//   floor, and once all three channels are <= -80 the result is -80.  The
//   dense sum has no floor and no early exit, as in the reference.
//
// What bounds it on the H100: FP32 instructions of the Moller-Trumbore tests
// (45 operations per ray-triangle pair, -fmad=false, IEEE division); the
// bytes are the rays (28-32 B each) and the outputs.  Divergence between the
// rays of a warp costs on bounce rays.  First, untuned version: no ray
// sorting, no warp-level cooperation, no register tiling.
//
// Built with -fmad=false and IEEE division, so each operation rounds as the
// plain PyTorch version's float32 op does.

#include <cuda_runtime.h>
#include <math.h>

#define THREADS 256
#define MAX_CL 8            // clusters a stream kernel sorts in registers
#define MAX_SMEM 232448     // shared memory a block may use on Hopper
#define STATIC_SMEM 49152   // above this only after cudaFuncSetAttribute

namespace {

struct Ray {
  float o[3], d[3], iv[3], pad[3];
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ org,
                                        const float* __restrict__ dir,
                                        long long i) {
  Ray r;
  for (int a = 0; a < 3; ++a) {
    r.o[a] = org[3 * i + a];
    r.d[a] = dir[3 * i + a];
    // _inv_dir: |d| < 1e-12 -> +-1e-12 before inverting
    const float eps = (float)1e-12;
    const float dd = fabsf(r.d[a]) < eps ? (r.d[a] < 0.0f ? -eps : eps)
                                         : r.d[a];
    r.iv[a] = 1.0f / dd;
    r.pad[a] = (float)1e-5 * fabsf(r.o[a]);
  }
  return r;
}

// Entry of the ray's interval [lo, hi] into box j of a row-major (6, w)
// table (rows lo xyz | hi xyz), widened as the header says; +inf if the
// interval misses it.
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

// Moller-Trumbore test of column k of the staged rows (row stride w) in the
// operation order of _mt_tile; returns det/barycentric validity, t in *t.
__device__ __forceinline__ bool mt_test(const float* p, int w, int k,
                                        const Ray& r, float* t) {
  const float v0x = p[k], v0y = p[w + k], v0z = p[2 * w + k];
  const float e1x = p[3 * w + k], e1y = p[4 * w + k], e1z = p[5 * w + k];
  const float e2x = p[6 * w + k], e2y = p[7 * w + k], e2z = p[8 * w + k];
  const float ox = r.o[0], oy = r.o[1], oz = r.o[2];
  const float dx = r.d[0], dy = r.d[1], dz = r.d[2];
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
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (dx * qx + dy * qy + dz * qz) * inv;
  *t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  return (fabsf(det) > eps) & (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f);
}

struct Scene {
  const float* pack;  // (10, pack_w)
  int pack_w;
  const float* cl8;   // (8, n_cl)
  int n_cl;
  int n_tris;
  const float* logf;  // (>= 3, pack_w) log filters, shadows only
};

// Shared-memory layout: geometry rows (9, pack_w), then for shadows the log
// filter rows (3, pack_w), then the cluster boxes (6, n_cl).
__host__ __device__ __forceinline__ int smem_floats(const Scene& s,
                                                    bool shadow) {
  return (shadow ? 12 : 9) * s.pack_w + 6 * s.n_cl;
}

// Stage the block's shared copy; returns the box table's start.
__device__ __forceinline__ float* stage(float* sm, const Scene& s,
                                        bool shadow) {
  const int geo = 9 * s.pack_w;
  for (int i = threadIdx.x; i < geo; i += blockDim.x) sm[i] = s.pack[i];
  int off = geo;
  if (shadow) {
    for (int i = threadIdx.x; i < 3 * s.pack_w; i += blockDim.x)
      sm[off + i] = s.logf[i];
    off += 3 * s.pack_w;
  }
  for (int i = threadIdx.x; i < 6 * s.n_cl; i += blockDim.x)
    sm[off + i] = s.cl8[i];
  return sm + off;
}

// Sort the ray's entries into the clusters it enters within [lo, hi],
// nearest first (ties by cluster index); returns how many it enters.
__device__ __forceinline__ int sorted_entries(const float* box, const Scene& s,
                                              int n_real_cl, const Ray& r,
                                              float lo, float hi,
                                              float* ent, int* cid) {
  int m = 0;
  for (int c = 0; c < n_real_cl; ++c) {
    const float e = box_entry(box, s.n_cl, c, r, lo, hi);
    if (!(e < INFINITY)) continue;
    int j = m++;
    while (j > 0 && ent[j - 1] > e) {
      ent[j] = ent[j - 1];
      cid[j] = cid[j - 1];
      --j;
    }
    ent[j] = e;
    cid[j] = c;
  }
  return m;
}

template <bool kStream>
__device__ __forceinline__ void closest_body(
    const Scene& s, const float* __restrict__ org,
    const float* __restrict__ dir, const float* __restrict__ tmin,
    const float* __restrict__ tmax, int n, float* __restrict__ t_out,
    int* __restrict__ col_out) {
  extern __shared__ float sm[];
  const float* box = stage(sm, s, false);
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(org, dir, i);
  const float lo = tmin[i], hi = tmax[i];
  const int bt = s.pack_w / s.n_cl;
  const int n_real_cl = (s.n_tris + bt - 1) / bt;
  float best = INFINITY;
  int best_k = 0;
  if constexpr (kStream) {
    float ent[MAX_CL];
    int cid[MAX_CL];
    const int m = sorted_entries(box, s, n_real_cl, r, lo, hi, ent, cid);
    for (int j = 0; j < m; ++j) {
      if (ent[j] > best) break;  // every later box is entered further on
      const int c = cid[j];
      const int k1 = min((c + 1) * bt, s.n_tris);
      for (int k = c * bt; k < k1; ++k) {
        float t;
        const bool ok = mt_test(sm, s.pack_w, k, r, &t);
        if (ok && t > lo && t < hi && (t < best || (t == best && k < best_k))) {
          best = t;
          best_k = k;
        }
      }
    }
  } else {
    for (int c = 0; c < n_real_cl; ++c) {
      if (!(box_entry(box, s.n_cl, c, r, lo, fminf(hi, best)) < INFINITY))
        continue;
      const int k1 = min((c + 1) * bt, s.n_tris);
      for (int k = c * bt; k < k1; ++k) {
        float t;
        const bool ok = mt_test(sm, s.pack_w, k, r, &t);
        // columns rise along the walk: strict < keeps the lowest on ties
        if (ok && t > lo && t < hi && t < best) {
          best = t;
          best_k = k;
        }
      }
    }
  }
  t_out[i] = best;
  col_out[i] = best_k;
}

template <bool kStream>
__device__ __forceinline__ void shadow_body(const Scene& s,
                                            const float* __restrict__ org,
                                            const float* __restrict__ dir,
                                            const float* __restrict__ dist,
                                            int n, float* __restrict__ lg_out) {
  extern __shared__ float sm[];
  const float* box = stage(sm, s, true);
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(org, dir, i);
  const float lo = (float)5e-4;
  const float hi = dist[i] * (float)(1.0 - 1e-4) - (float)5e-4;
  const float floor_ = -80.0f;
  const float* lf = sm + 9 * s.pack_w;
  const int w = s.pack_w;
  const int bt = w / s.n_cl;
  const int n_real_cl = (s.n_tris + bt - 1) / bt;
  float lr = 0.0f, lg = 0.0f, lb = 0.0f;
  // sum one cluster's crossings, in column order
  auto sum_cluster = [&](int c) {
    const int k1 = min((c + 1) * bt, s.n_tris);
    for (int k = c * bt; k < k1; ++k) {
      float t;
      const bool ok = mt_test(sm, w, k, r, &t);
      if (ok && t > lo && t < hi) {
        lr += lf[k];
        lg += lf[w + k];
        lb += lf[2 * w + k];
      }
    }
  };
  if constexpr (kStream) {
    float ent[MAX_CL];
    int cid[MAX_CL];
    const int m = sorted_entries(box, s, n_real_cl, r, lo, hi, ent, cid);
    for (int j = 0; j < m; ++j) {
      sum_cluster(cid[j]);
      // opaque in every channel: the floored result is -80 already
      if (lr <= floor_ && lg <= floor_ && lb <= floor_) break;
    }
  } else {
    for (int c = 0; c < n_real_cl; ++c) {
      if (box_entry(box, s.n_cl, c, r, lo, hi) < INFINITY) sum_cluster(c);
    }
  }
  if constexpr (kStream) {
    lr = fmaxf(lr, floor_);
    lg = fmaxf(lg, floor_);
    lb = fmaxf(lb, floor_);
  }
  lg_out[3 * i] = lr;
  lg_out[3 * i + 1] = lg;
  lg_out[3 * i + 2] = lb;
}

__global__ void closest_dense_kernel(Scene s, const float* __restrict__ org,
                                     const float* __restrict__ dir,
                                     const float* __restrict__ tmin,
                                     const float* __restrict__ tmax, int n,
                                     float* __restrict__ t_out,
                                     int* __restrict__ col_out) {
  closest_body<false>(s, org, dir, tmin, tmax, n, t_out, col_out);
}

__global__ void closest_stream_kernel(Scene s, const float* __restrict__ org,
                                      const float* __restrict__ dir,
                                      const float* __restrict__ tmin,
                                      const float* __restrict__ tmax, int n,
                                      float* __restrict__ t_out,
                                      int* __restrict__ col_out) {
  closest_body<true>(s, org, dir, tmin, tmax, n, t_out, col_out);
}

__global__ void shadow_dense_kernel(Scene s, const float* __restrict__ org,
                                    const float* __restrict__ dir,
                                    const float* __restrict__ dist, int n,
                                    float* __restrict__ lg_out) {
  shadow_body<false>(s, org, dir, dist, n, lg_out);
}

__global__ void shadow_stream_kernel(Scene s, const float* __restrict__ org,
                                     const float* __restrict__ dir,
                                     const float* __restrict__ dist, int n,
                                     float* __restrict__ lg_out) {
  shadow_body<true>(s, org, dir, dist, n, lg_out);
}

// 0 if the scene is one the kernels take, else a cudaError value.
int check_scene(const Scene& s, bool stream, bool shadow) {
  if (s.pack_w <= 0 || s.n_cl <= 0 || s.pack_w % s.n_cl != 0 ||
      s.n_tris < 0 || s.n_tris > s.pack_w || (stream && s.n_cl > MAX_CL) ||
      smem_floats(s, shadow) * (int)sizeof(float) > MAX_SMEM) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Dynamic shared memory for a kernel: above the static limit only after
// raising the kernel's attribute.  Returns 0 or a cudaError value.
template <typename K>
int prepare(K kernel, int bytes) {
  if (bytes <= STATIC_SMEM) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename K>
int launch_closest(K kernel, bool stream, const Scene& s, const void* org,
                   const void* dir, const void* tmin, const void* tmax, int n,
                   void* t_out, void* col_out, void* st) {
  if (const int bad = check_scene(s, stream, false)) return bad;
  const int bytes = smem_floats(s, false) * (int)sizeof(float);
  if (const int bad = prepare(kernel, bytes)) return bad;
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    kernel<<<blocks, THREADS, bytes, (cudaStream_t)st>>>(
        s, (const float*)org, (const float*)dir, (const float*)tmin,
        (const float*)tmax, n, (float*)t_out, (int*)col_out);
  }
  return (int)cudaGetLastError();
}

template <typename K>
int launch_shadow(K kernel, bool stream, const Scene& s, int logf_w,
                  const void* org, const void* dir, const void* dist, int n,
                  void* lg_out, void* st) {
  if (const int bad = check_scene(s, stream, true)) return bad;
  if (logf_w != s.pack_w) return (int)cudaErrorInvalidValue;
  const int bytes = smem_floats(s, true) * (int)sizeof(float);
  if (const int bad = prepare(kernel, bytes)) return bad;
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    kernel<<<blocks, THREADS, bytes, (cudaStream_t)st>>>(
        s, (const float*)org, (const float*)dir, (const float*)dist, n,
        (float*)lg_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// `stream` is a cudaStream_t.  Each returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for a scene it does not
// take.
extern "C" int closest_hit_dense_launch(const void* pack, int pack_w,
                                        const void* cl8, int n_cl, int n_tris,
                                        const void* org, const void* dir,
                                        const void* tmin, const void* tmax,
                                        int n, void* t_out, void* col_out,
                                        void* stream) {
  const Scene s{(const float*)pack, pack_w, (const float*)cl8, n_cl, n_tris,
                nullptr};
  return launch_closest(closest_dense_kernel, false, s, org, dir, tmin, tmax,
                        n, t_out, col_out, stream);
}

extern "C" int closest_hit_stream_launch(const void* pack, int pack_w,
                                         const void* cl8, int n_cl, int n_tris,
                                         const void* org, const void* dir,
                                         const void* tmin, const void* tmax,
                                         int n, void* t_out, void* col_out,
                                         void* stream) {
  const Scene s{(const float*)pack, pack_w, (const float*)cl8, n_cl, n_tris,
                nullptr};
  return launch_closest(closest_stream_kernel, true, s, org, dir, tmin, tmax,
                        n, t_out, col_out, stream);
}

extern "C" int shadow_logsum_dense_launch(const void* pack, int pack_w,
                                          const void* cl8, int n_cl,
                                          int n_tris, const void* logf,
                                          int logf_w, const void* org,
                                          const void* dir, const void* dist,
                                          int n, void* lg_out, void* stream) {
  const Scene s{(const float*)pack, pack_w, (const float*)cl8, n_cl, n_tris,
                (const float*)logf};
  return launch_shadow(shadow_dense_kernel, false, s, logf_w, org, dir, dist,
                       n, lg_out, stream);
}

extern "C" int shadow_logsum_stream_launch(const void* pack, int pack_w,
                                           const void* cl8, int n_cl,
                                           int n_tris, const void* logf,
                                           int logf_w, const void* org,
                                           const void* dir, const void* dist,
                                           int n, void* lg_out, void* stream) {
  const Scene s{(const float*)pack, pack_w, (const float*)cl8, n_cl, n_tris,
                (const float*)logf};
  return launch_shadow(shadow_stream_kernel, true, s, logf_w, org, dir, dist,
                       n, lg_out, stream);
}
