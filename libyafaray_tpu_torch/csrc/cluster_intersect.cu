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
//                            -80
// with the per-pair math of _mt_tile (Moller-Trumbore, its operation order).
//
// The function, not the TPU schedule.  The TPU kernels build per-512-ray
// block cluster lists, sort them by the block's nearest entry and stream
// (16, 128) tiles through a two-slot DMA pipeline.  Here a 256-thread block
// stages the whole pack once into shared memory (at most 43 KB at 896
// columns), and every pack read is a shared-memory read.
//
// closest_dense_kernel: the closest walk of column_walk.cuh (closest_items)
// over the pack's real columns staged column-major and the boxes of its
// DENSE_GROUP-column groups, which each block builds from the staged
// columns (at most DENSE_MAX_GROUPS, two 32-bit masks: every pack of the
// dense and stream routes).  A ray's thread box-tests every group and
// walks the group the ray enters nearest; the ray's other entered groups
// go to a list of (ray, group) items that the block's threads take in
// turn, each skipped once the ray's best t lies before its entry.  The
// bounce rays of a warp scatter: walked by their own threads, a warp waits
// on the ray among them that enters the most groups (~2x a ray's mean on
// the 172-triangle scene); the list spreads that work over the block.
// 16-column groups measured faster than 8 and 32, and a one-thread walk
// (nearest group first, then the rest in rising order), a full
// nearest-first order, two rays a thread and sorting a block's rays by the
// groups they enter all slower on an H100 (PERF.md).
//
// shadow_dense_kernel and shadow_stream_kernel: the column walk of
// column_walk.cuh over the pack staged column-major and its 32-column
// quarter boxes (box32), R neighbouring rays a thread.  The thread tests
// each ray against the quarter boxes and walks the quarters in rising
// order; each ray adds a column's log filters where its own test passes, so
// every sum is the brute force's with its terms in rising column order.
// The dense sum has no floor and no early exit, as in the reference's
// _shadow_kernel: a thread walks the quarters one of its rays enters, every
// ray testing each; R = DENSE_RAYS = 2 measured fastest of 1 to 4 on an
// H100 (PERF.md).  The stream sum is floored at -80 once, at the end, which
// equals the reference's floor after each cluster because every log filter
// is <= 0; a ray tests only the quarters it enters, and stops once all
// three of its channels are <= -80 (its floored result is then fixed).  One
// channel at -80 stops nothing.  Its rays enter more of their pack's 13-28
// quarters, and differently, than the dense rays do the 3-12 of theirs:
// with R = STREAM_RAYS = 1 a thread walks one ray's quarters, not the union
// of two, and the warp's threads diverge less (faster than R = 2 on an
// H100, PERF.md).
//
// closest_stream_kernel: one warp a ray (the design of closest_fine_kernel
// in fine_intersect.cu on a pack staged per block, with the warp-walk
// primitives of warp_walk.cuh).  A stream pack has at most 8 clusters of 128
// columns, so at most 32 quarter boxes: lane q tests quarter q against the
// ray's interval [tmin, tmax] and keeps its entry in a register.  The warp
// visits the entered quarters nearest entry first (one warp-wide minimum a
// pick, ties to the lower quarter); on a visit lane l tests column 32q + l,
// so every lane has one pair and reads its own bank.  After each visit the
// lanes' best t is reduced, and the walk stops once the next entry lies
// strictly beyond min(tmax, best t): a quarter entered at exactly the best
// t is still visited, so an exact tie keeps the lowest column.  Each lane
// keeps the lexicographic minimum (t, column) of its hits, reduced over the
// lanes at the end: the answer does not depend on the visit order.  The
// blocks loop over the rays (eight at a time, one a warp), so each stages
// the pack once for many rays.
//
// The bodies these replaced are kept, for chip_smoke.py to time beside them
// on the same inputs (their own entries, *_before_launch, which no path
// calls), one thread a ray over the cluster boxes (cl8):
//   closest_dense_thread_kernel: the clusters in index order, skipping one
//     whose box the ray cannot enter nearer than its best hit;
//   closest_stream_thread_kernel: the boxes sorted by entry (insertion sort,
//     at most MAX_CL), stopping at the first box entered beyond its best t;
//   shadow_dense_thread_kernel: the clusters in index order, skipping the
//     boxes its segment does not enter;
//   shadow_stream_thread_kernel: the entered boxes sorted by entry, stopping
//     once all three channels are opaque (<= -80).
//
// Exactness against the plain brute force of ops/cluster_intersect.py:
// * Boxes are widened by 1e-5 of the largest magnitude among their faces and
//   the ray origin on each axis (as in fine_intersect.cu), so a skip never
//   drops a hit the brute force takes.
// * The closest hit keeps the lowest pack column among equal t: the
//   one-thread dense body walks columns in rising order with a strict `<`;
//   the other walks, whose order is the ray's, replace an equal t only by a
//   lower column, and continue into a box whose entry equals their best t.
//   (The reference's stream kernel keeps the first-visited column on an
//   exact tie; the t is the same.)
// * Shadows: every log filter is <= 0, so the running sum only falls; the
//   stream sum's one floor at the end equals the reference's per-cluster
//   floor, and once all three channels are <= -80 the result is -80.
//
// What bounds it on the H100: FP32 instructions of the Moller-Trumbore tests
// (45 operations per ray-triangle pair, -fmad=false, IEEE division); the
// bytes are the rays (28-32 B each) and the outputs.  The shadow walks
// run little beside the tests.  closest_dense_kernel trades pair tests for
// box tests (39 operations): on the 172-triangle scene a camera ray enters
// ~52 columns of 16-column groups below its hit against 151 of the cluster
// boxes, for 11 box tests.  closest_stream_kernel tests few pairs a
// ray (two to four quarters), and its per-visit warp minima, integer work,
// cost about as much as the tests themselves.
//
// Built with -fmad=false and IEEE division, so each operation rounds as the
// plain PyTorch version's float32 op does.

#include <cuda_runtime.h>
#include <math.h>

#include "column_walk.cuh"
#include "warp_walk.cuh"

#define THREADS 256
#define WARPS (THREADS / 32)  // rays a block of closest_stream_kernel holds
#define MAX_CL 8            // clusters a stream kernel sorts in registers
#define QUARTER 32          // columns of a quarter box (the box32 table)
#define MAX_QUARTERS 32     // quarter boxes closest_stream_kernel holds
#define DENSE_RAYS 2        // rays a thread of shadow_dense_kernel owns
#define DENSE_GROUP 16      // columns of a box of closest_dense_kernel
#define DENSE_MAX_GROUPS 64  // boxes closest_dense_kernel holds (two masks)
#define DENSE_ITEMS 2048    // (ray, group) items closest_dense_kernel lists
#define STREAM_RAYS 1       // rays a thread of shadow_stream_kernel owns
#define MAX_SMEM 232448     // shared memory a block may use on Hopper
#define STATIC_SMEM 49152   // above this only after cudaFuncSetAttribute

namespace {

__device__ __forceinline__ Ray load_ray(const float* __restrict__ org,
                                        const float* __restrict__ dir,
                                        long long i) {
  const float o[3] = {org[3 * i], org[3 * i + 1], org[3 * i + 2]};
  const float d[3] = {dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]};
  return make_ray(o, d);
}

// mt_core on column k of the staged rows (row stride w).
__device__ __forceinline__ bool mt_test(const float* p, int w, int k,
                                        const Ray& r, float* t) {
  return mt_core<false>(p[k], p[w + k], p[2 * w + k], p[3 * w + k],
                        p[4 * w + k], p[5 * w + k], p[6 * w + k],
                        p[7 * w + k], p[8 * w + k], r.o, r.d, t);
}

struct Scene {
  const float* pack;  // (10, pack_w)
  int pack_w;
  const float* cl8;   // (8, n_cl)
  int n_cl;
  int n_tris;
  const float* logf;  // (>= 3, pack_w) log filters, shadows only
};

// Shared-memory layout of the one-thread bodies: geometry rows (9, pack_w),
// then for shadows the log filter rows (3, pack_w), then the cluster boxes
// (6, n_cl).
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

// Copy the (6, n) rows of a box table to shared memory.
__device__ __forceinline__ void stage_boxes(float* dst,
                                            const float* __restrict__ box,
                                            int n) {
  for (int i = threadIdx.x; i < 6 * n; i += blockDim.x) dst[i] = box[i];
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

// ---- shadow_dense_kernel, shadow_stream_kernel: R rays a thread ----------

// The column walk over the staged pack and its quarter boxes (box32, n_q
// of them), R rays a thread; with kStop the stream sum's opaque stop and
// its floor.  Thread t of block b owns rays (b * THREADS + t) * R + j,
// j < R.
template <int R, bool kStop>
__device__ __forceinline__ void shadow_quarters(
    const Scene& s, const float* __restrict__ box32, int n_q,
    const float* __restrict__ org, const float* __restrict__ dir,
    const float* __restrict__ dist, int n, float* __restrict__ lg_out) {
  extern __shared__ float4 sm4[];
  float* tab = reinterpret_cast<float*>(sm4);
  float* qbox = tab + TAB * s.pack_w;
  stage_columns(tab, s.pack, s.pack_w, s.logf, s.pack_w, s.pack_w);
  stage_boxes(qbox, box32, n_q);
  __syncthreads();
  const long long i0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * R;
  if (i0 >= n) return;
  float o[R][3], d[R][3], hi[R], acc[R][3];
  load_segments<R>(org, dir, dist, i0, n, o, d, hi, acc);
  const int q_real = (s.n_tris + QUARTER - 1) / QUARTER;
  for (int q0 = 0; q0 < q_real; q0 += 32) {
    unsigned enter[R];
    enter_groups<R>(qbox, n_q, q0, min(32, q_real - q0), o, d, hi, enter);
    sum_groups<R, QUARTER, kStop>(sm4, s.n_tris, q0, enter, o, d, hi, acc);
  }
  if constexpr (kStop) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      for (int a = 0; a < 3; ++a) acc[j][a] = fmaxf(acc[j][a], LOG_FLOOR);
    }
  }
  store_sums<R>(lg_out, i0, n, acc);
}

__global__ void __launch_bounds__(THREADS)
shadow_dense_kernel(Scene s, const float* __restrict__ box32, int n_q,
                    const float* __restrict__ org,
                    const float* __restrict__ dir,
                    const float* __restrict__ dist, int n,
                    float* __restrict__ lg_out) {
  shadow_quarters<DENSE_RAYS, false>(s, box32, n_q, org, dir, dist, n,
                                     lg_out);
}

__global__ void __launch_bounds__(THREADS)
shadow_stream_kernel(Scene s, const float* __restrict__ box32, int n_q,
                     const float* __restrict__ org,
                     const float* __restrict__ dir,
                     const float* __restrict__ dist, int n,
                     float* __restrict__ lg_out) {
  shadow_quarters<STREAM_RAYS, true>(s, box32, n_q, org, dir, dist, n,
                                     lg_out);
}

// ---- closest_stream_kernel: one warp a ray over the quarter boxes --------

// The nearest hit of the warp's ray among the real columns of the quarters
// its interval [lo, hi] enters (qbox: the (6, n_q) quarter boxes in shared
// memory, geo: the staged geometry rows): (t, column) with the lowest column
// on ties, in every lane.
__device__ __forceinline__ void closest_quarters(const float* geo, int w,
                                                 int n_tris, const float* qbox,
                                                 int n_q, const Ray& r,
                                                 float lo, float hi, int lane,
                                                 float* best_t, int* best_k) {
  const int q_real = (n_tris + QUARTER - 1) / QUARTER;
  float ent = lane < q_real ? box_entry(qbox, n_q, lane, r, lo, hi)
                            : INFINITY;  // this lane's quarter
  float lt = INFINITY;  // this lane's best hit
  int lcol = 0x7fffffff;
  float lim = hi;  // min(tmax, the warp's best t): no box beyond it matters
  for (;;) {
    float e;
    const int q = nearest_within(ent, lim, &e);  // nearest not yet visited
    if (q < 0) break;
    if (lane == q) ent = INFINITY;
    const int k = q * QUARTER + lane;
    if (k < n_tris) {
      float t;
      const bool ok = mt_test(geo, w, k, r, &t);
      keep_nearest(ok && t > lo && t < hi, t, k, &lt, &lcol);
    }
    lim = fminf(hi, warp_min(lt));
  }
  warp_nearest(lt, lcol, best_t, best_k);
}

// Warp w of block b takes rays b * WARPS + w, then every gridDim.x * WARPS
// further on.
__global__ void __launch_bounds__(THREADS)
closest_stream_kernel(Scene s, const float* __restrict__ box32, int n_q,
                      const float* __restrict__ org,
                      const float* __restrict__ dir,
                      const float* __restrict__ tmin,
                      const float* __restrict__ tmax, int n,
                      float* __restrict__ t_out, int* __restrict__ col_out) {
  extern __shared__ float sm[];
  const int geo = 9 * s.pack_w;
  for (int i = threadIdx.x; i < geo; i += blockDim.x) sm[i] = s.pack[i];
  float* qbox = sm + geo;
  stage_boxes(qbox, box32, n_q);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (long long i = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       i < n; i += (long long)gridDim.x * WARPS) {
    const Ray r = load_ray(org, dir, i);
    float best;
    int col;
    closest_quarters(sm, s.pack_w, s.n_tris, qbox, n_q, r, tmin[i], tmax[i],
                     lane, &best, &col);
    if (lane == 0) {
      t_out[i] = best;
      col_out[i] = best < INFINITY ? col : 0;
    }
  }
}

// ---- closest_dense_kernel: the closest walk (closest_items) --------------

// Thread t of block b owns ray b * THREADS + t; it holds the groups it
// enters in NW 32-bit masks (the launch takes the fewest that hold the
// pack's groups).  Dynamic shared memory: item_smem_bytes(n_tris, groups,
// DENSE_ITEMS, THREADS).
template <int NW>
__global__ void __launch_bounds__(THREADS, ITEM_MIN_BLOCKS)
closest_dense_kernel(Scene s, const float* __restrict__ org,
                     const float* __restrict__ dir,
                     const float* __restrict__ tmin,
                     const float* __restrict__ tmax, int n,
                     float* __restrict__ t_out, int* __restrict__ col_out) {
  extern __shared__ float4 sm4[];
  const int groups = (s.n_tris + DENSE_GROUP - 1) / DENSE_GROUP;
  float4* tab;
  float* box;
  const ItemSmem m =
      item_smem(sm4, s.n_tris, groups, DENSE_ITEMS, &tab, &box);
  stage_columns(reinterpret_cast<float*>(tab), s.pack, s.pack_w, nullptr, 0,
                s.n_tris);
  __syncthreads();
  build_group_boxes<DENSE_GROUP>(box, groups,
                                 reinterpret_cast<const float*>(tab),
                                 s.n_tris);
  __syncthreads();
  closest_items<DENSE_GROUP, NW, false>(
      tab, box, groups, groups, s.n_tris, m, org, dir, tmin, tmax,
      (long long)blockIdx.x * blockDim.x, n, t_out, col_out, nullptr,
      nullptr);
}

// ---- the one-thread bodies -------------------------------------------------

__global__ void closest_dense_thread_kernel(
    Scene s, const float* __restrict__ org, const float* __restrict__ dir,
    const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
    float* __restrict__ t_out, int* __restrict__ col_out) {
  closest_body<false>(s, org, dir, tmin, tmax, n, t_out, col_out);
}

__global__ void closest_stream_thread_kernel(
    Scene s, const float* __restrict__ org, const float* __restrict__ dir,
    const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
    float* __restrict__ t_out, int* __restrict__ col_out) {
  closest_body<true>(s, org, dir, tmin, tmax, n, t_out, col_out);
}

__global__ void shadow_dense_thread_kernel(Scene s,
                                           const float* __restrict__ org,
                                           const float* __restrict__ dir,
                                           const float* __restrict__ dist,
                                           int n, float* __restrict__ lg_out) {
  shadow_body<false>(s, org, dir, dist, n, lg_out);
}

__global__ void shadow_stream_thread_kernel(Scene s,
                                            const float* __restrict__ org,
                                            const float* __restrict__ dir,
                                            const float* __restrict__ dist,
                                            int n,
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

// 0 if box32 is the scene's quarter-box table and `floats` of shared memory
// fit a block, else a cudaError value.
int check_quarters(const Scene& s, const void* box32, int n_q, int floats) {
  if (box32 == nullptr || n_q * QUARTER != s.pack_w ||
      floats * (int)sizeof(float) > MAX_SMEM) {
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

template <int NW>
int launch_closest_dense(const Scene& s, int bytes, const void* org,
                         const void* dir, const void* tmin, const void* tmax,
                         int n, void* t_out, void* col_out, void* st) {
  if (const int bad = prepare(closest_dense_kernel<NW>, bytes)) return bad;
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    closest_dense_kernel<NW><<<blocks, THREADS, bytes, (cudaStream_t)st>>>(
        s, (const float*)org, (const float*)dir, (const float*)tmin,
        (const float*)tmax, n, (float*)t_out, (int*)col_out);
  }
  return (int)cudaGetLastError();
}

int launch_closest_dense(const Scene& s, const void* org, const void* dir,
                         const void* tmin, const void* tmax, int n,
                         void* t_out, void* col_out, void* st) {
  if (const int bad = check_scene(s, false, false)) return bad;
  const int groups = (s.n_tris + DENSE_GROUP - 1) / DENSE_GROUP;
  const int bytes = item_smem_bytes(s.n_tris, groups, DENSE_ITEMS, THREADS);
  if (groups > DENSE_MAX_GROUPS || bytes > MAX_SMEM) {
    return (int)cudaErrorInvalidValue;
  }
  if (groups <= 32) {
    return launch_closest_dense<1>(s, bytes, org, dir, tmin, tmax, n, t_out,
                                   col_out, st);
  }
  return launch_closest_dense<DENSE_MAX_GROUPS / 32>(
      s, bytes, org, dir, tmin, tmax, n, t_out, col_out, st);
}

int launch_closest_stream(const Scene& s, const void* box32, int n_q,
                          const void* org, const void* dir, const void* tmin,
                          const void* tmax, int n, void* t_out, void* col_out,
                          void* st) {
  const int floats = 9 * s.pack_w + 6 * n_q;
  if (const int bad = check_scene(s, true, false)) return bad;
  if (const int bad = check_quarters(s, box32, n_q, floats)) return bad;
  if (n_q > MAX_QUARTERS) return (int)cudaErrorInvalidValue;
  const int bytes = floats * (int)sizeof(float);
  if (const int bad = prepare(closest_stream_kernel, bytes)) return bad;
  if (n > 0) {
    // as many blocks as the card holds at once, each looping over rays, so
    // a block stages the pack once for many rays
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, closest_stream_kernel, THREADS, bytes);
    const long long want = ((long long)n + WARPS - 1) / WARPS;
    const int full = per_sm * sms > 0 ? per_sm * sms : 1;
    const int blocks = want < full ? (int)want : full;
    closest_stream_kernel<<<blocks, THREADS, bytes, (cudaStream_t)st>>>(
        s, (const float*)box32, n_q, (const float*)org, (const float*)dir,
        (const float*)tmin, (const float*)tmax, n, (float*)t_out,
        (int*)col_out);
  }
  return (int)cudaGetLastError();
}

// shadow_dense_kernel or shadow_stream_kernel (stream), `rays` a thread.
template <typename K>
int launch_shadow_quarters(K kernel, bool stream, int rays, const Scene& s,
                           int logf_w, const void* box32, int n_q,
                           const void* org, const void* dir, const void* dist,
                           int n, void* lg_out, void* st) {
  const int floats = TAB * s.pack_w + 6 * n_q;
  if (const int bad = check_scene(s, stream, true)) return bad;
  if (const int bad = check_quarters(s, box32, n_q, floats)) return bad;
  if (logf_w != s.pack_w) return (int)cudaErrorInvalidValue;
  const int bytes = floats * (int)sizeof(float);
  if (const int bad = prepare(kernel, bytes)) return bad;
  if (n > 0) {
    const long long per_block = (long long)THREADS * rays;
    const int blocks = (int)((n + per_block - 1) / per_block);
    kernel<<<blocks, THREADS, bytes, (cudaStream_t)st>>>(
        s, (const float*)box32, n_q, (const float*)org, (const float*)dir,
        (const float*)dist, n, (float*)lg_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// `stream` is a cudaStream_t.  Each returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for a scene it does not
// take.  box32 (8, n_q) is the pack's quarter-box table.
extern "C" int closest_hit_dense_launch(const void* pack, int pack_w,
                                        const void* cl8, int n_cl, int n_tris,
                                        const void* org, const void* dir,
                                        const void* tmin, const void* tmax,
                                        int n, void* t_out, void* col_out,
                                        void* stream) {
  const Scene s{(const float*)pack, pack_w, (const float*)cl8, n_cl, n_tris,
                nullptr};
  return launch_closest_dense(s, org, dir, tmin, tmax, n, t_out, col_out,
                              stream);
}

extern "C" int closest_hit_stream_launch(const void* pack, int pack_w,
                                         const void* cl8, int n_cl,
                                         const void* box32, int n_q,
                                         int n_tris, const void* org,
                                         const void* dir, const void* tmin,
                                         const void* tmax, int n, void* t_out,
                                         void* col_out, void* stream) {
  const Scene s{(const float*)pack, pack_w, (const float*)cl8, n_cl, n_tris,
                nullptr};
  return launch_closest_stream(s, box32, n_q, org, dir, tmin, tmax, n, t_out,
                               col_out, stream);
}

extern "C" int shadow_logsum_dense_launch(
    const void* pack, int pack_w, const void* cl8, int n_cl,
    const void* box32, int n_q, int n_tris, const void* logf, int logf_w,
    const void* org, const void* dir, const void* dist, int n, void* lg_out,
    void* stream) {
  const Scene s{(const float*)pack, pack_w, (const float*)cl8, n_cl, n_tris,
                (const float*)logf};
  return launch_shadow_quarters(shadow_dense_kernel, false, DENSE_RAYS, s,
                                logf_w, box32, n_q, org, dir, dist, n, lg_out,
                                stream);
}

extern "C" int shadow_logsum_stream_launch(
    const void* pack, int pack_w, const void* cl8, int n_cl,
    const void* box32, int n_q, int n_tris, const void* logf, int logf_w,
    const void* org, const void* dir, const void* dist, int n, void* lg_out,
    void* stream) {
  const Scene s{(const float*)pack, pack_w, (const float*)cl8, n_cl, n_tris,
                (const float*)logf};
  return launch_shadow_quarters(shadow_stream_kernel, true, STREAM_RAYS, s,
                                logf_w, box32, n_q, org, dir, dist, n, lg_out,
                                stream);
}

// The one-thread bodies closest_hit_dense_launch, closest_hit_stream_launch,
// shadow_logsum_dense_launch and shadow_logsum_stream_launch replaced, over
// the cluster boxes alone.
extern "C" int closest_hit_dense_before_launch(
    const void* pack, int pack_w, const void* cl8, int n_cl, int n_tris,
    const void* org, const void* dir, const void* tmin, const void* tmax,
    int n, void* t_out, void* col_out, void* stream) {
  const Scene s{(const float*)pack, pack_w, (const float*)cl8, n_cl, n_tris,
                nullptr};
  return launch_closest(closest_dense_thread_kernel, false, s, org, dir, tmin,
                        tmax, n, t_out, col_out, stream);
}

extern "C" int closest_hit_stream_before_launch(
    const void* pack, int pack_w, const void* cl8, int n_cl, int n_tris,
    const void* org, const void* dir, const void* tmin, const void* tmax,
    int n, void* t_out, void* col_out, void* stream) {
  const Scene s{(const float*)pack, pack_w, (const float*)cl8, n_cl, n_tris,
                nullptr};
  return launch_closest(closest_stream_thread_kernel, true, s, org, dir, tmin,
                        tmax, n, t_out, col_out, stream);
}

extern "C" int shadow_logsum_dense_before_launch(
    const void* pack, int pack_w, const void* cl8, int n_cl, int n_tris,
    const void* logf, int logf_w, const void* org, const void* dir,
    const void* dist, int n, void* lg_out, void* stream) {
  const Scene s{(const float*)pack, pack_w, (const float*)cl8, n_cl, n_tris,
                (const float*)logf};
  return launch_shadow(shadow_dense_thread_kernel, false, s, logf_w, org, dir,
                       dist, n, lg_out, stream);
}

extern "C" int shadow_logsum_stream_before_launch(
    const void* pack, int pack_w, const void* cl8, int n_cl, int n_tris,
    const void* logf, int logf_w, const void* org, const void* dir,
    const void* dist, int n, void* lg_out, void* stream) {
  const Scene s{(const float*)pack, pack_w, (const float*)cl8, n_cl, n_tris,
                (const float*)logf};
  return launch_shadow(shadow_stream_thread_kernel, true, s, logf_w, org, dir,
                       dist, n, lg_out, stream);
}
