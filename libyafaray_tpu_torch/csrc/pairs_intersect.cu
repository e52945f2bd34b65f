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
// pairs_closest_kernel: one thread owns one slot and loops over its
// cluster's real columns in global memory; the 32 threads of a warp read the
// same column at the same step, one broadcast served from L1 / L2 (the pack
// is 6.6 MB at 164K triangles, well inside the 50 MB L2), and a warp diverges
// only where the cluster id changes inside it.
//
// pairs_shadow_kernel: one block owns 256 consecutive slots and meets their
// cluster as 128-column tiles staged in shared memory (shadow_tile.cuh).  A
// segment enters about a sixth of its cluster's columns, but which sub-boxes
// differs from slot to slot, so a thread-per-slot skip would diverge over
// nearly the whole cluster.  Instead each thread tests its slot's segment
// against the cluster's sub-boxes, and tile_group lists per tile the slots
// that enter it and deals them to warps, a (slot, tile) item at a time, 32
// lanes across the tile's columns.  The block takes its slots' clusters one
// after the other, the lowest id first: one cluster nearly always (~116 K
// slots a cluster on the 164K grid), a few where the id changes inside the
// block, and any number if the slots come unsorted (slower, the same sums).
//
// Exactness against the plain versions of ops/pairs_intersect.py: the closest
// hit visits columns in rising order with a strict `t < best`, so the lowest
// column wins among equal t; columns past n_tris are padding and are never
// tested.  The shadow sums skip a sub-box only when the segment cannot enter
// it (boxes widened by 1e-5, as in fine_intersect.cu) and are not floored;
// they are added in the fixed order shadow_tile.cuh states, which is not the
// plain version's, so non-binary filters agree to rounding and repeat bit for
// bit.  A slot whose ray or cluster id is out of range tests nothing (inf /
// 0, or a zero sum): ids are not checked on the host, where reading them
// would wait for the device.
//
// What bounds it on the H100: FP32 instructions of the Moller-Trumbore tests,
// 45 operations per slot and tested column (-fmad=false, IEEE division).  The
// bytes are the pack once, 8 B of ids per slot, the rays once and the
// outputs.  The closest hit still tests every column of a slot's cluster from
// global memory, with no sub-box skip.
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

__global__ void pairs_closest_kernel(Pack pk, const int* __restrict__ sray,
                                     const int* __restrict__ scl, int n_slots,
                                     const float* __restrict__ org,
                                     const float* __restrict__ dir,
                                     const float* __restrict__ tmin,
                                     const float* __restrict__ tmax,
                                     int n_rays, float* __restrict__ t_out,
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
  int c = -1;  // this slot's cluster while it waits its turn, then -1
  {
    Ray r = {};
    float hi = -1.0f;
    if (i < n_slots) {
      const int ray = sray[i], cl = scl[i];
      if (ray >= 0 && ray < n_rays && cl >= 0 && cl < pk.n_cl) {
        r = load_ray(org, dir, ray);
        hi = shadow_hi(dist[ray]);
        // a dead lane (dist < 0) has an empty interval and enters nothing
        if (SHADOW_LO <= hi) c = cl;
      }
    }
    put_segment(sm, tid, r, hi);
  }
  const TileSrc ts{pk.p, logf, pk.w, pk.n_tris};
  const int spc = pk.bt / SUB_BT;
  const int sc_real = (pk.n_tris + SUB_BT - 1) / SUB_BT;
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
      tile_group<false>(sm, ts, j0, mask);
    }
  }
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

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// `stream` is a cudaStream_t.  Each returns cudaGetLastError() after the
// launch (0 = launched); no slots, no launch.
extern "C" int pairs_closest_launch(
    const void* pack, int pack_w, int n_cl, int n_tris, const void* sray,
    const void* scl, int n_slots, const void* org, const void* dir,
    const void* tmin, const void* tmax, int n_rays, void* t_out,
    void* col_out, void* stream) {
  const Pack pk{(const float*)pack, pack_w, n_cl,
                n_cl > 0 ? pack_w / n_cl : 0, n_tris};
  if (const int bad = check_pack(pk)) return bad;
  if (n_slots < 0 || n_rays < 0) return (int)cudaErrorInvalidValue;
  if (n_slots > 0) {
    const int blocks = (n_slots + THREADS - 1) / THREADS;
    pairs_closest_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
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
      pk.bt % SUB_BT != 0 || n_sc * SUB_BT != pack_w || n_slots < 0 ||
      n_rays < 0) {
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
