// Each ray's nearest cluster entries for the pair route, for Hopper (sm_90a).
//
// Replaces _ray_cluster_entries (libyafaray_tpu/ops/pallas_intersect.py:1173)
// together with the nearest-k pick its two callers take from it: the stable
// jnp.argsort of _closest_hit_pairs (:1396) and the lax.top_k of
// _shadow_transmission_pairs (:2135).  The reference leaves both to XLA
// inside its compiled step; the port's plain version
// (ops/pairs_intersect.py nearest_clusters_plain) builds the rays x boxes
// table of entries and sorts it.
//   nearest_clusters_kernel: per ray, the entry of its interval [lo, hi]
//   into each cluster (the minimum over the cluster's real 128-column
//   sub-boxes, or the cluster box where the pack takes no sub-box table),
//   its k <= 32 nearest as (entry, cluster id) ascending with the lower id
//   first on equal entries, ids past the clusters it enters n_cl, and the
//   count of clusters it enters.
//
// No rays x boxes table is written.  One block of 256 threads stages the box
// tables once in shared memory (rows lo xyz | hi xyz only: 6 x (n_cl + n_sc)
// floats, 35 KB on the 164K grid, at most 74 KB for 2,048 sub-boxes), then
// each warp takes rays in turn, one ray at a time:
// * lane l tests clusters c0 + l, c0 + 32 + l, ... (LANE_CL a sweep, 256
//   clusters) and keeps each entry in a register.  A cluster's sub-boxes are
//   tested only when the ray enters its cluster box.  That is exact: a
//   sub-box lies inside its cluster box and is widened by no more (its faces
//   are no larger in magnitude), and every step of the slab test rounds
//   monotonically, so the widened slab interval of a sub-box lies inside its
//   cluster's: a ray that misses the cluster box misses every sub-box.  The
//   sub-boxes are staged transposed (sub-box b of cluster c at [row][b][c]),
//   so that the 32 lanes read 32 consecutive words.
// * The sweep's entries are merged with the picks of the sweeps before, held
//   one a lane (pick j in lane j), by up to k rounds: each lane offers its
//   least (entry, id), the warp takes the least of the offers with two
//   __reduce_min_sync (the entry as an ordered key, then the id among the
//   lanes that hold that entry), the owner drops it and lane q keeps pick q.
//   Ids are unique, so the order is total: the stable sort's.  The rounds
//   stop at the first +inf, so a ray that enters few clusters takes few.
// * -0 entries are written as +0 (as the plain version writes them), so that
//   equal entries order by id alone.
// The box tests are those of fine_intersect.cu (slab in shadow_tile.cuh: IEEE
// 1/d after the 1e-12 clamp, boxes widened by 1e-5), built with -fmad=false,
// so the entries equal the plain version's bit for bit.
//
// What bounds it on the H100: FP32 instructions of the box tests, 39
// operations a box (every real cluster box, and the real sub-boxes of each
// entered cluster), their operands read from shared memory; the merge is
// integer work beside them.  The bytes are the rays once (32 B a ray), the
// tables once a block, and the outputs (8k + 4 B a ray).

#include "shadow_tile.cuh"
#include "warp_walk.cuh"

#define NC_THREADS 256
#define NC_WARPS (NC_THREADS / 32)
#define LANE_CL 8     // clusters a lane tests a sweep: 256 a sweep
#define MAX_PICKS 32  // k: one pick a lane
#define BOX_ROWS 6    // lo xyz | hi xyz of a (8, w) box table
#define MAX_DEVICES 64

namespace {

struct Tables {
  const float* cl8;  // (8, n_cl) cluster boxes
  int n_cl;
  int cl_real;       // clusters with a real triangle
  const float* sub8;  // (8, n_sc) sub-boxes, read only where n_sub > 1
  int n_sc;
  int n_sub;    // sub-boxes a cluster's entry is the minimum over; 1: the box
  int sc_real;  // sub-boxes with a real triangle
};

// The entry of the ray's interval into cluster c (c < cl_real) from the
// staged tables; +inf if it enters none of its real sub-boxes (n_sub > 1)
// or its box.
__device__ __forceinline__ float cluster_entry(const Tables& t,
                                               const float* s_cl,
                                               const float* s_sub, int c,
                                               const Ray& r, float lo,
                                               float hi) {
  float enter, exit_;
  slab<false>(s_cl, t.n_cl, c, r, lo, hi, &enter, &exit_);
  if (!(enter <= exit_)) return INFINITY;
  if (t.n_sub == 1) return enter;
  float e = INFINITY;
  for (int b = 0; b < t.n_sub && c * t.n_sub + b < t.sc_real; ++b) {
    slab<false>(s_sub + b * t.n_cl, t.n_sc, c, r, lo, hi, &enter, &exit_);
    if (enter <= exit_) e = fminf(e, enter);
  }
  return e;
}

__global__ void __launch_bounds__(NC_THREADS)
nearest_clusters_kernel(Tables t, const float* __restrict__ org,
                        const float* __restrict__ dir,
                        const float* __restrict__ lo_in,
                        const float* __restrict__ hi_in, int n, int k,
                        float* __restrict__ ent_out, int* __restrict__ id_out,
                        int* __restrict__ cnt_out) {
  extern __shared__ float smem[];
  float* s_cl = smem;                        // (6, n_cl)
  float* s_sub = smem + BOX_ROWS * t.n_cl;  // (6, n_sub, n_cl)
  for (int e = threadIdx.x; e < BOX_ROWS * t.n_cl; e += NC_THREADS) {
    s_cl[e] = t.cl8[e];
  }
  if (t.n_sub > 1) {
    for (int e = threadIdx.x; e < BOX_ROWS * t.n_sc; e += NC_THREADS) {
      const int row = e / t.n_sc, j = e - row * t.n_sc;
      const int c = j / t.n_sub, b = j - c * t.n_sub;
      s_sub[(row * t.n_sub + b) * t.n_cl + c] = t.sub8[e];
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned inf_key = ordered(INFINITY);
  for (long long i = (long long)blockIdx.x * NC_WARPS + (threadIdx.x >> 5);
       i < n; i += (long long)gridDim.x * NC_WARPS) {  // the whole warp
    const Ray r = load_ray(org, dir, i);
    const float lo = lo_in[i], hi = hi_in[i];
    float pe = INFINITY;  // pick `lane` so far: entry and cluster id
    int pid = t.n_cl;
    int count = 0;  // clusters of this lane the ray enters
    for (int c0 = 0; c0 < t.cl_real; c0 += 32 * LANE_CL) {
      float ent[LANE_CL];
#pragma unroll
      for (int b = 0; b < LANE_CL; ++b) {
        const int c = c0 + 32 * b + lane;
        const float e = c < t.cl_real
                            ? cluster_entry(t, s_cl, s_sub, c, r, lo, hi)
                            : INFINITY;
        ent[b] = e == 0.0f ? 0.0f : e;  // -0 as +0
        count += e < INFINITY;
      }
      // merge: the picks held so far (lower ids than this sweep's) and
      // this sweep's entries, k rounds of a warp-wide least (entry, id)
      bool held = pe < INFINITY;
      float ne = INFINITY;
      int nid = t.n_cl;
      for (int q = 0; q < k; ++q) {
        // this lane's least: its held pick, else its first least entry
        // (rising b is rising id; strict < keeps the lower id)
        float be = held ? pe : INFINITY;
        int bb = -1;
#pragma unroll
        for (int b = 0; b < LANE_CL; ++b) {
          if (ent[b] < be) {
            be = ent[b];
            bb = b;
          }
        }
        const unsigned key = ordered(be);
        const unsigned m = __reduce_min_sync(FULL, key);
        if (m == inf_key) break;  // no entered cluster left
        const int id = bb >= 0 ? c0 + 32 * bb + lane : pid;
        const int w = (int)__reduce_min_sync(
            FULL, key == m ? (unsigned)id : 0xffffffffu);
        if (key == m && id == w) {  // the owner drops it
#pragma unroll
          for (int b = 0; b < LANE_CL; ++b) {
            if (b == bb) ent[b] = INFINITY;
          }
          if (bb < 0) held = false;
        }
        if (lane == q) {
          ne = unordered(m);
          nid = w;
        }
      }
      pe = ne;
      pid = nid;
    }
    const int total = __reduce_add_sync(FULL, count);
    if (lane < k) {
      ent_out[i * k + lane] = pe;
      id_out[i * k + lane] = pid;
    }
    if (lane == 0) cnt_out[i] = total;
  }
}

// Per device: SMs, the shared memory a block may opt in to (set on the
// kernel at first use), and the blocks an SM holds at the last table size.
struct DeviceInfo {
  int sms = 0, max_smem = 0;
  size_t smem = 0;
  int blocks_per_sm = 0;
};
DeviceInfo g_dev[MAX_DEVICES];

int device_info(size_t smem, DeviceInfo** out) {
  int dev;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) {
    return (int)cudaErrorInvalidDevice;
  }
  DeviceInfo& d = g_dev[dev];
  if (d.sms == 0) {
    if (cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev) ||
        cudaDeviceGetAttribute(&d.max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) ||
        cudaFuncSetAttribute(nearest_clusters_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             d.max_smem)) {
      d.sms = 0;
      return (int)cudaGetLastError();
    }
  }
  if (smem > (size_t)d.max_smem) return (int)cudaErrorInvalidValue;
  if (d.smem != smem || d.blocks_per_sm == 0) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &d.blocks_per_sm, nearest_clusters_kernel, NC_THREADS, smem)) {
      d.blocks_per_sm = 0;
      return (int)cudaGetLastError();
    }
    d.smem = smem;
  }
  *out = &d;
  return 0;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// `stream` is a cudaStream_t.  cl8 (8, n_cl), sub8 (8, n_sc) with n_sc a
// multiple of n_cl and 128 columns a sub-box; n_sub 1 (the cluster boxes)
// or n_sc / n_cl; org, dir (n, 3), lo, hi (n,); outputs (n, k) float32 and
// int32, and (n,) int32.  Returns cudaGetLastError() after the launch
// (0 = launched), or cudaErrorInvalidValue on arguments it does not take;
// no rays, no launch.  The grid is persistent: as many blocks as the SMs
// hold at this table size, or fewer for few rays.
extern "C" int nearest_clusters_launch(
    const void* cl8, int n_cl, const void* sub8, int n_sc, int n_sub,
    int n_tris, const void* org, const void* dir, const void* lo,
    const void* hi, int n, int k, void* ent_out, void* id_out, void* cnt_out,
    void* stream) {
  if (n_cl <= 0 || n_sc <= 0 || n_sc % n_cl != 0 ||
      (n_sub != 1 && n_sub != n_sc / n_cl) || n_tris < 0 ||
      (long long)n_tris > (long long)n_sc * SUB_BT || n < 0 || k < 1 ||
      k > MAX_PICKS || k > n_cl) {
    return (int)cudaErrorInvalidValue;
  }
  const long long bt = (long long)n_sc * SUB_BT / n_cl;
  const int sc_real = (int)(((long long)n_tris + SUB_BT - 1) / SUB_BT);
  const int cl_real = (int)(((long long)n_tris + bt - 1) / bt);
  const Tables t{(const float*)cl8, n_cl, cl_real, (const float*)sub8, n_sc,
                 n_sub, sc_real};
  const size_t smem =
      sizeof(float) * BOX_ROWS * ((size_t)n_cl + (n_sub > 1 ? n_sc : 0));
  if (n == 0) return 0;
  DeviceInfo* d;
  if (const int bad = device_info(smem, &d)) return bad;
  const long long want = ((long long)n + NC_WARPS - 1) / NC_WARPS;
  const int blocks = (int)(want < (long long)d->sms * d->blocks_per_sm
                               ? want
                               : (long long)d->sms * d->blocks_per_sm);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  nearest_clusters_kernel<<<blocks, NC_THREADS, smem, (cudaStream_t)stream>>>(
      t, (const float*)org, (const float*)dir, (const float*)lo,
      (const float*)hi, n, k, (float*)ent_out, (int*)id_out, (int*)cnt_out);
  return (int)cudaGetLastError();
}
