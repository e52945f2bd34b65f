// Pair-granular ray-triangle intersection kernels for Hopper (sm_90a).
//
// Replace the pair kernels of libyafaray_tpu/ops/pallas_intersect.py, the
// opt-in route for packs of 64 or more clusters:
//   pairs_closest_kernel <- _pairs_closest_kernel (launched by _pairs_sweep):
//                           per (ray, cluster) slot, the nearest t in
//                           (tmin, tmax) over the cluster's columns -> (t,
//                           pack column)
//   pairs_shadow_kernel  <- _pairs_shadow_kernel: per slot, the sum of the
//                           log filters of the cluster's columns the segment
//                           crosses, not floored
// with the per-pair math of _mt_test_scalar (Moller-Trumbore, its operation
// order), as in tiny_intersect.cu and fine_intersect.cu.
//
// The function, not the TPU schedule.  The TPU kernels walk visit tables
// (one entry per 128-slot block and distinct cluster), DMA each visit's
// (16, BT) tile through a two-slot pipeline and mask the block's rows to the
// slots of that cluster.  Here a slot reads its ray through the slot's ray id
// (no gathered copy of the rays), and the slots arrive sorted by cluster
// (ops/pairs_intersect.py), so neighbouring slots test the same triangles.
//
// Both kernels: one block owns 256 consecutive slots and meets their cluster
// as 128-column tiles staged in shared memory (shadow_tile.cuh).  A segment
// enters a few of its cluster's sub-boxes, but which ones differs from slot
// to slot, so a thread-per-slot skip would diverge over nearly the whole
// cluster.  Instead each thread tests its slot's segment against the
// cluster's sub-boxes, and tile_group lists per tile the slots that enter it
// and deals them to warps, a (slot, tile) item at a time, 32 lanes across
// the tile's columns.  The block takes its slots' clusters one after the
// other, the lowest id first: one cluster nearly always (~116 K slots a
// cluster on the 164K grid), a few where the id changes inside the block,
// and any number if the slots come unsorted (slower, the same answers).
//   pairs_closest_kernel: the running answer is the slot's (t, column); an
//     item whose sub-box the ray enters beyond that t is skipped, so a slot
//     tests its entered tiles up to the one that holds its hit, not all
//     1,024 columns.  Only the 9 pack rows are staged.
//   pairs_shadow_kernel: the running answer is the three log sums, not
//     floored; nothing is skipped.
// pairs_closest_thread_kernel is the body before the tile walk, one thread a
// slot over every column of its cluster from global memory; it runs only
// when no sub-box table is given, the yardstick chip_smoke.py times.
//
// Exactness against the plain versions of ops/pairs_intersect.py: the closest
// hit visits tiles in rising order with a strict `t < best` and reduces each
// tile to its lexicographic minimum (t, column), so the lowest column wins
// among equal t; columns past n_tris are padding and are never tested.  A
// sub-box is skipped only when the segment cannot enter it before its best
// hit (boxes widened by 1e-5, as in fine_intersect.cu).  The shadow sums are
// added in the fixed order shadow_tile.cuh states, which is not the plain
// version's, so non-binary filters agree to rounding and repeat bit for bit.
// A slot whose ray or cluster id is out of range tests nothing (inf / 0, or
// a zero sum): ids are not checked on the host, where reading them would
// wait for the device.
//
// What bounds it on the H100: FP32 instructions of the Moller-Trumbore tests,
// 45 operations per slot and tested column (-fmad=false, IEEE division),
// their operands read from shared memory.  The bytes are the pack once, 8 B
// of ids per slot, the rays once and the outputs.
//
// Built with -fmad=false and IEEE division, so each operation rounds as the
// plain PyTorch version's float32 op does.

#include <limits.h>

#include "shadow_tile.cuh"

namespace {

struct Slot {
  Ray ray;     // origin and direction only
  int k0, k1;  // the slot's cluster columns [k0, k1)
};

// The slot's ray and its cluster's real columns; false if an id is out of
// range (the slot then tests nothing).
__device__ __forceinline__ bool load_slot(const int* __restrict__ sray,
                                          const int* __restrict__ scl,
                                          long long i, int n_rays, int n_cl,
                                          int bt, int n_tris,
                                          const float* __restrict__ org,
                                          const float* __restrict__ dir,
                                          Slot* s, int* ray) {
  const int r = sray[i], c = scl[i];
  if (r < 0 || r >= n_rays || c < 0 || c >= n_cl) return false;
  for (int a = 0; a < 3; ++a) {
    s->ray.o[a] = org[3LL * r + a];
    s->ray.d[a] = dir[3LL * r + a];
  }
  s->k0 = c * bt;
  s->k1 = min(s->k0 + bt, n_tris);
  *ray = r;
  return true;
}

struct Pack {
  const float* p;  // (10, w), rows v0 | e1 | e2 | id
  int w;
  int n_cl;
  int bt;  // columns per cluster, w / n_cl
  int n_tris;
};

__global__ void pairs_closest_thread_kernel(
    Pack pk, const int* __restrict__ sray, const int* __restrict__ scl,
    int n_slots, const float* __restrict__ org,
    const float* __restrict__ dir, const float* __restrict__ tmin,
    const float* __restrict__ tmax, int n_rays, float* __restrict__ t_out,
    int* __restrict__ col_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  Slot s;
  int r;
  float best = INFINITY;
  int best_k = 0;
  if (load_slot(sray, scl, i, n_rays, pk.n_cl, pk.bt, pk.n_tris, org, dir,
                &s, &r)) {
    const float lo = tmin[r], hi = tmax[r];
    for (int k = s.k0; k < s.k1; ++k) {
      float t;
      const bool ok = mt_test(pk.p, pk.w, k, s.ray, &t);
      // columns rise along the loop: strict < keeps the lowest on ties
      if (ok && t > lo && t < hi && t < best) {
        best = t;
        best_k = k;
      }
    }
  }
  t_out[i] = best;
  col_out[i] = best_k;
}

// The block's slots against their clusters' tiles, one cluster id at a
// time, the lowest first; `c` is this thread's slot's cluster (-1: it tests
// nothing).  Called by every thread of the block.
template <int OP>
__device__ __forceinline__ void walk_clusters(TileSmem& sm, int& next_cl,
                                              const TileSrc& ts,
                                              const float* __restrict__ sub8,
                                              int n_sc, int bt, int c) {
  const int tid = threadIdx.x;
  const int spc = bt / SUB_BT;
  const int sc_real = (ts.n_tris + SUB_BT - 1) / SUB_BT;
  for (;;) {
    // the lowest cluster id still waiting in the block
    if (tid == 0) next_cl = INT_MAX;
    __syncthreads();
    if (c >= 0) atomicMin(&next_cl, c);
    __syncthreads();
    const int cur = next_cl;
    __syncthreads();  // all have read it before thread 0 resets it
    if (cur == INT_MAX) break;
    const bool mine = c == cur;
    if (mine) c = -1;
    const int s1 = min((cur + 1) * spc, sc_real);
    for (int j0 = cur * spc; j0 < s1; j0 += GROUP) {
      const unsigned mask =
          mine ? entered_mask(sm, tid, sub8, n_sc, j0, min(GROUP, s1 - j0))
               : 0u;
      tile_group<OP>(sm, ts, j0, mask);
    }
  }
}

// Slot i's ray and cluster ids if both are in range: its cluster, else -1.
__device__ __forceinline__ int slot_cluster(const int* __restrict__ sray,
                                            const int* __restrict__ scl,
                                            long long i, int n_slots,
                                            int n_rays, int n_cl, int* ray) {
  if (i >= n_slots) return -1;
  *ray = sray[i];
  const int cl = scl[i];
  return *ray >= 0 && *ray < n_rays && cl >= 0 && cl < n_cl ? cl : -1;
}

__global__ void __launch_bounds__(SHADOW_THREADS, SHADOW_MIN_BLOCKS)
pairs_closest_kernel(Pack pk, const float* __restrict__ sub8, int n_sc,
                     const int* __restrict__ sray,
                     const int* __restrict__ scl, int n_slots,
                     const float* __restrict__ org,
                     const float* __restrict__ dir,
                     const float* __restrict__ tmin,
                     const float* __restrict__ tmax, int n_rays,
                     float* __restrict__ t_out, int* __restrict__ col_out) {
  __shared__ TileSmem sm;
  __shared__ int next_cl;
  const int tid = threadIdx.x;
  const long long i = (long long)blockIdx.x * SHADOW_THREADS + tid;
  int ray = 0;
  int c = slot_cluster(sray, scl, i, n_slots, n_rays, pk.n_cl, &ray);
  {
    Ray r = {};
    float lo = 0.0f, hi = -1.0f;
    if (c >= 0) {
      r = load_ray(org, dir, ray);
      lo = tmin[ray];
      hi = tmax[ray];
      // an empty interval (tmin >= tmax, or NaN) holds no hit
      if (!(lo < hi)) c = -1;
    }
    put_segment<CLOSEST>(sm, tid, r, lo, hi);
  }
  walk_clusters<CLOSEST>(sm, next_cl, TileSrc{pk.p, pk.p, pk.w, pk.n_tris},
                         sub8, n_sc, pk.bt, c);
  if (i < n_slots) {
    t_out[i] = sm.acc[0][tid];
    col_out[i] = __float_as_int(sm.acc[1][tid]);
  }
}

__global__ void __launch_bounds__(SHADOW_THREADS, SHADOW_MIN_BLOCKS)
pairs_shadow_kernel(Pack pk, const float* __restrict__ sub8, int n_sc,
                    const float* __restrict__ logf,
                    const int* __restrict__ sray, const int* __restrict__ scl,
                    int n_slots, const float* __restrict__ org,
                    const float* __restrict__ dir,
                    const float* __restrict__ dist, int n_rays,
                    float* __restrict__ lg_out) {
  __shared__ TileSmem sm;
  __shared__ int next_cl;
  const int tid = threadIdx.x;
  const long long i = (long long)blockIdx.x * SHADOW_THREADS + tid;
  int ray = 0;
  int c = slot_cluster(sray, scl, i, n_slots, n_rays, pk.n_cl, &ray);
  {
    Ray r = {};
    float hi = -1.0f;
    if (c >= 0) {
      r = load_ray(org, dir, ray);
      hi = shadow_hi(dist[ray]);
      // a dead lane (dist < 0) has an empty interval and enters nothing
      if (!(SHADOW_LO <= hi)) c = -1;
    }
    put_segment<SUM>(sm, tid, r, SHADOW_LO, hi);
  }
  walk_clusters<SUM>(sm, next_cl, TileSrc{pk.p, logf, pk.w, pk.n_tris},
                     sub8, n_sc, pk.bt, c);
  if (i < n_slots) {
    lg_out[3 * i] = sm.acc[0][tid];
    lg_out[3 * i + 1] = sm.acc[1][tid];
    lg_out[3 * i + 2] = sm.acc[2][tid];
  }
}

int check_pack(const Pack& pk) {
  if (pk.w <= 0 || pk.n_cl <= 0 || pk.w % pk.n_cl != 0 || pk.n_tris < 0 ||
      pk.n_tris > pk.w) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// The tile walk's pack and sub-box table: clusters of whole 128-column
// tiles, one box a tile.
int check_tiles(const Pack& pk, int n_sc) {
  return pk.bt % SUB_BT == 0 && n_sc * SUB_BT == pk.w
             ? 0
             : (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// `stream` is a cudaStream_t.  Each returns cudaGetLastError() after the
// launch (0 = launched); no slots, no launch.
// sub8 NULL: the one-thread body, which needs no sub-box table.
extern "C" int pairs_closest_launch(
    const void* pack, int pack_w, int n_cl, int n_tris, const void* sub8,
    int n_sc, const void* sray, const void* scl, int n_slots,
    const void* org, const void* dir, const void* tmin, const void* tmax,
    int n_rays, void* t_out, void* col_out, void* stream) {
  const Pack pk{(const float*)pack, pack_w, n_cl,
                n_cl > 0 ? pack_w / n_cl : 0, n_tris};
  if (const int bad = check_pack(pk)) return bad;
  if (n_slots < 0 || n_rays < 0) return (int)cudaErrorInvalidValue;
  if (sub8 != nullptr && (check_tiles(pk, n_sc) ||
                          !tiles_ok(pack, pack, pack_w))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_slots > 0 && sub8 != nullptr) {
    const int blocks = (n_slots + SHADOW_THREADS - 1) / SHADOW_THREADS;
    pairs_closest_kernel<<<blocks, SHADOW_THREADS, 0, (cudaStream_t)stream>>>(
        pk, (const float*)sub8, n_sc, (const int*)sray, (const int*)scl,
        n_slots, (const float*)org, (const float*)dir, (const float*)tmin,
        (const float*)tmax, n_rays, (float*)t_out, (int*)col_out);
  } else if (n_slots > 0) {
    const int blocks = (n_slots + THREADS - 1) / THREADS;
    pairs_closest_thread_kernel<<<blocks, THREADS, 0,
                                  (cudaStream_t)stream>>>(
        pk, (const int*)sray, (const int*)scl, n_slots, (const float*)org,
        (const float*)dir, (const float*)tmin, (const float*)tmax, n_rays,
        (float*)t_out, (int*)col_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int pairs_shadow_launch(
    const void* pack, int pack_w, int n_cl, int n_tris, const void* sub8,
    int n_sc, const void* logf, int logf_w, const void* sray,
    const void* scl, int n_slots, const void* org, const void* dir,
    const void* dist, int n_rays, void* lg_out, void* stream) {
  const Pack pk{(const float*)pack, pack_w, n_cl,
                n_cl > 0 ? pack_w / n_cl : 0, n_tris};
  if (const int bad = check_pack(pk)) return bad;
  if (logf_w != pack_w || !tiles_ok(pack, logf, pack_w) ||
      check_tiles(pk, n_sc) || n_slots < 0 || n_rays < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_slots > 0) {
    const int blocks = (n_slots + SHADOW_THREADS - 1) / SHADOW_THREADS;
    pairs_shadow_kernel<<<blocks, SHADOW_THREADS, 0, (cudaStream_t)stream>>>(
        pk, (const float*)sub8, n_sc, (const float*)logf, (const int*)sray,
        (const int*)scl, n_slots, (const float*)org, (const float*)dir,
        (const float*)dist, n_rays, (float*)lg_out);
  }
  return (int)cudaGetLastError();
}
