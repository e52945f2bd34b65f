// The tile routine shared by shadow_fine_kernel (fine_intersect.cu),
// pairs_shadow_kernel and pairs_closest_kernel (pairs_intersect.cu), with the
// ray, box and Moller-Trumbore helpers those sources use.
//
// "A staged tile x the list of segments that enter it."  The kernels answer,
// per ray or (ray, cluster) slot, a question over the triangles a segment
// [lo, hi] crosses (the sum of their log filters, or the nearest of them),
// and all three meet the pack as 128-column sub-clusters (tiles) with a box
// each.  A block of 256 threads owns up to 256 segments, kept in shared
// memory (origin, direction and its inverse, near and far limits, running
// answers).  For a group of up to 8 neighbouring tiles each thread says which
// of them its segment enters (a bit mask from the box tests, the entry
// distances kept beside it); tile_group then
//   1. compacts, per tile, the entering segments into a list in shared
//      memory: one ballot per tile and warp, the warps' counts exchanged
//      through shared memory, each entry placed by a prefix count, so a list
//      holds its segments in thread order;
//   2. stages each tile that has takers into shared memory with 16-byte
//      cp.async copies, double-buffered, the next tile with takers loading
//      while this one is tested: pack rows 0-8 (v0 | e1 | e2), and for the
//      sums the three log-filter rows, 9 or 12 x 512 B;
//   3. deals the list to warps, one (segment, tile) item at a time: the 32
//      lanes take columns k, k+32, k+64, k+96 from shared memory
//      (consecutive words, no bank conflict), so every lane works however few
//      segments enter and a ray-triangle pair costs shared-memory reads, not
//      L2 reads.  A sum: each lane sums its columns in rising order, the
//      lanes are added by a fixed __shfl_xor_sync tree, and lane 0 adds the
//      tile's sum to the segment's running sum.  A closest hit: each lane
//      keeps its nearest column (strict <, rising), the lanes reduce the
//      lexicographic minimum of (t, column) by shuffles, and lane 0 keeps it
//      if it is strictly nearer than the segment's best so far.
// A segment appears at most once in a tile's list and tiles are visited in
// rising order with a barrier between them, so a segment's answer is taken
// in one fixed order whatever warp handles it: the same bits in every run,
// no atomics, and on equal t the lowest column wins.
//
// Skips.  With SUM_FLOORED (shadow_fine_kernel) an item whose segment
// already has all three sums <= -80 is skipped: log filters are <= 0, so its
// floored answer is -80 whatever else it crosses.  With CLOSEST an item is
// skipped when the segment enters the tile's box strictly beyond its best t
// so far (read after the previous tile's barrier): every hit in the tile
// lies at or past the entry, so none can be nearer, and a tie at the entry
// would lose to the lower column already held.  pairs_shadow_kernel's slot
// sums (SUM) are not floored and skip nothing.
//
// Every barrier is reached by the whole block: which tiles have takers is
// computed by every thread from the same counts in shared memory.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

#define SUB_BT 128   // tile width: pack columns of a sub-cluster
#define THREADS 256  // the closest-hit kernels' block
// a shadow block: its threads, and the most segments it owns.  64 registers
// a thread let an SM hold SHADOW_MIN_BLOCKS = 4 such blocks, which measured
// faster than the unspilled build of 92-128 registers and 2 blocks an SM;
// 512-thread blocks measured slower.
#define SHADOW_THREADS 256
#define SHADOW_MIN_BLOCKS 4
#define WARPS (SHADOW_THREADS / 32)
#define FULL 0xffffffffu
#define TILE_ROWS 12  // pack rows 0-8 (v0 | e1 | e2), log-filter rows r g b
#define PACK_ROWS 9   // the rows a closest hit stages
#define GROUP 8       // tiles whose lists are built together
#define SHADOW_LO ((float)5e-4)
#define LOG_FLOOR (-80.0f)

namespace {

// What tile_group computes per segment.
enum TileOp {
  SUM_FLOORED,  // the log-filter sum, items of opaque segments skipped
  SUM,          // the log-filter sum, not floored
  CLOSEST,      // the nearest (t, pack column) in (lo, hi)
};

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
    // _inv_dir: |d| < 1e-12 -> +-1e-12 before inverting, so an axis-parallel
    // ray gives a finite slope, never 0 * inf = NaN
    const float eps = (float)1e-12;
    const float dd = fabsf(r.d[a]) < eps ? (r.d[a] < 0.0f ? -eps : eps)
                                         : r.d[a];
    r.iv[a] = 1.0f / dd;
    r.pad[a] = (float)1e-5 * fabsf(r.o[a]);
  }
  return r;
}

// The far limit of a shadow segment of length dist; the near one is
// SHADOW_LO.  dist < 0 marks a dead lane: its interval is empty.
__device__ __forceinline__ float shadow_hi(float dist) {
  return dist * (float)(1.0 - 1e-4) - (float)5e-4;
}

// Slab test of the ray's interval [lo, hi] against box j of a row-major
// (8, w) table (rows lo xyz | hi xyz): each box is widened by 1e-5 of the
// largest magnitude among its faces and the ray origin on that axis.  The
// interval's part inside the box is [*enter, *exit_], empty if it misses.
// GLOBAL: the table lies in device memory (read through the read-only
// cache); false for a table staged in shared memory.
template <bool GLOBAL = true>
__device__ __forceinline__ void slab(const float* __restrict__ tab, int w,
                                     int j, const Ray& r, float lo, float hi,
                                     float* enter, float* exit_) {
  *enter = lo, *exit_ = hi;
  for (int a = 0; a < 3; ++a) {
    const float bl = GLOBAL ? __ldg(tab + a * w + j) : tab[a * w + j];
    const float bh =
        GLOBAL ? __ldg(tab + (a + 3) * w + j) : tab[(a + 3) * w + j];
    const float pad = fmaxf(r.pad[a],
                            (float)1e-5 * fmaxf(fabsf(bl), fabsf(bh)));
    const float t0 = (bl - pad - r.o[a]) * r.iv[a];
    const float t1 = (bh + pad - r.o[a]) * r.iv[a];
    *enter = fmaxf(*enter, fminf(t0, t1));
    *exit_ = fminf(*exit_, fmaxf(t0, t1));
  }
}

// Does the ray's interval [lo, hi] enter box j?
__device__ __forceinline__ bool box_entered(const float* __restrict__ tab,
                                            int w, int j, const Ray& r,
                                            float lo, float hi) {
  float enter, exit_;
  slab(tab, w, j, r, lo, hi, &enter, &exit_);
  return enter <= exit_;
}

// Moller-Trumbore test of pack column k (row stride w) in the operation
// order of _mt_test_scalar; returns det/barycentric validity, t in *t.
__device__ __forceinline__ bool mt_test(const float* __restrict__ p, int w,
                                        int k, const Ray& r, float* t) {
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

// Where the tiles come from: the (10, pack_w) pack and the (>= 3, pack_w)
// log-filter rows (none for a closest hit), both 16-byte aligned with pack_w
// a multiple of SUB_BT.
struct TileSrc {
  const float* pack;
  const float* logf;
  int pack_w;
  int n_tris;
};

typedef unsigned char seg_t;  // a segment's index in its block
static_assert(SHADOW_THREADS <= 256, "seg_t holds a thread index");

// A block's shared memory: two tile buffers, its segments (with the
// inverse directions of their box tests, which a thread reloads for each
// cluster instead of holding them in registers across the tile work), their
// running answers (three sums, or for CLOSEST acc[0] the best t and acc[1]
// its pack column as int bits), each segment's entry distance into the
// group's tiles, the per-tile lists (segment indices), the warps' counts per
// tile and their totals.
struct __align__(16) TileSmem {
  float tile[2][TILE_ROWS * SUB_BT];
  float o[3][SHADOW_THREADS], d[3][SHADOW_THREADS];
  float iv[3][SHADOW_THREADS];
  float lo[SHADOW_THREADS], hi[SHADOW_THREADS];
  float acc[3][SHADOW_THREADS];
  float ent[GROUP][SHADOW_THREADS];
  int cnt[WARPS][GROUP];
  int tot[GROUP];
  seg_t list[GROUP][SHADOW_THREADS];
};

// Thread `tid`'s segment [lo, hi] into shared memory: its sums set to zero,
// or for CLOSEST no hit yet (inf, column 0).
template <int OP>
__device__ __forceinline__ void put_segment(TileSmem& sm, int tid,
                                            const Ray& r, float lo,
                                            float hi) {
  for (int a = 0; a < 3; ++a) {
    sm.o[a][tid] = r.o[a];
    sm.d[a][tid] = r.d[a];
    sm.iv[a][tid] = r.iv[a];
    sm.acc[a][tid] = 0.0f;
  }
  if (OP == CLOSEST) sm.acc[0][tid] = INFINITY;
  sm.lo[tid] = lo;
  sm.hi[tid] = hi;
}

// Thread `tid`'s segment back, for its box tests.
__device__ __forceinline__ Ray get_segment(const TileSmem& sm, int tid) {
  Ray r;
  for (int a = 0; a < 3; ++a) {
    r.o[a] = sm.o[a][tid];
    r.d[a] = sm.d[a][tid];
    r.iv[a] = sm.iv[a][tid];
    r.pad[a] = (float)1e-5 * fabsf(r.o[a]);  // as load_ray sets it
  }
  return r;
}

// Bit b set where the segment's interval [lo, hi] enters box j0 + b of the
// (8, n_sc) sub-box table, for the nb (<= GROUP) boxes from j0; the entry
// distances go to sm.ent[b] (read by CLOSEST's skip).  Called after the
// barrier that ends the previous tile_group.
__device__ __forceinline__ unsigned entered_mask(TileSmem& sm, int tid,
                                                 const float* __restrict__ sub8,
                                                 int n_sc, int j0, int nb) {
  const Ray r = get_segment(sm, tid);
  const float lo = sm.lo[tid], hi = sm.hi[tid];
  unsigned mask = 0;
  for (int b = 0; b < nb; ++b) {
    float enter, exit_;
    slab(sub8, n_sc, j0 + b, r, lo, hi, &enter, &exit_);
    sm.ent[b][tid] = enter;
    if (enter <= exit_) mask |= 1u << b;
  }
  return mask;
}

// Are all three sums of segment q at or below the floor?
__device__ __forceinline__ bool opaque(const TileSmem& sm, int q) {
  return sm.acc[0][q] <= LOG_FLOOR && sm.acc[1][q] <= LOG_FLOOR &&
         sm.acc[2][q] <= LOG_FLOOR;
}

// Start the copy of the first ROWS rows of tile j into dst, the whole block
// sharing its ROWS x 32 16-byte pieces; one cp.async group per thread.
template <int ROWS>
__device__ __forceinline__ void stage_tile(float* dst, const TileSrc& ts,
                                           int j) {
  const int per_row = SUB_BT / 4;
  for (int ch = threadIdx.x; ch < ROWS * per_row; ch += SHADOW_THREADS) {
    const int row = ch / per_row, off = 4 * (ch % per_row);
    const float* src = (row < 9 ? ts.pack + (size_t)row * ts.pack_w
                                : ts.logf + (size_t)(row - 9) * ts.pack_w) +
                       (size_t)j * SUB_BT + off;
    __pipeline_memcpy_async(dst + row * SUB_BT + off, src, 16);
  }
  __pipeline_commit();
}

// Segment q's ray, from shared memory.
__device__ __forceinline__ Ray item_ray(const TileSmem& sm, int q) {
  Ray r;
  for (int a = 0; a < 3; ++a) {
    r.o[a] = sm.o[a][q];
    r.d[a] = sm.d[a][q];
  }
  return r;
}

// One (segment, tile) item of a sum: the log filters of the first ncols
// columns the segment crosses, lane sums in rising column order, a fixed
// tree, added to the segment's running sum by lane 0.
__device__ __forceinline__ void sum_item(TileSmem& sm, const float* tile,
                                         int q, int ncols) {
  const int lane = threadIdx.x & 31;
  const Ray r = item_ray(sm, q);
  const float lo = sm.lo[q], hi = sm.hi[q];
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int round = 0; round < SUB_BT / 32; ++round) {
    const int k = 32 * round + lane;
    if (k < ncols) {
      float t;
      const bool ok = mt_test(tile, SUB_BT, k, r, &t);
      if (ok && t > lo && t < hi) {
        s0 += tile[9 * SUB_BT + k];
        s1 += tile[10 * SUB_BT + k];
        s2 += tile[11 * SUB_BT + k];
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s0 += __shfl_xor_sync(FULL, s0, off);
    s1 += __shfl_xor_sync(FULL, s1, off);
    s2 += __shfl_xor_sync(FULL, s2, off);
  }
  if (lane == 0) {
    sm.acc[0][q] += s0;
    sm.acc[1][q] += s1;
    sm.acc[2][q] += s2;
  }
}

// One item of a closest hit: the nearest t in (lo, hi) among the first
// ncols columns of tile col0 / SUB_BT, the lowest column on equal t, kept by
// lane 0 if it is strictly nearer than the segment's best so far.  Compares
// floats, not bit patterns: t may be negative.
__device__ __forceinline__ void closest_item(TileSmem& sm, const float* tile,
                                             int q, int col0, int ncols) {
  const int lane = threadIdx.x & 31;
  const Ray r = item_ray(sm, q);
  const float lo = sm.lo[q], hi = sm.hi[q];
  float bt = INFINITY;
  int bk = SUB_BT;  // no hit
#pragma unroll
  for (int round = 0; round < SUB_BT / 32; ++round) {
    const int k = 32 * round + lane;
    if (k < ncols) {
      float t;
      const bool ok = mt_test(tile, SUB_BT, k, r, &t);
      // a lane's columns rise: strict < keeps its lowest on equal t
      if (ok && t > lo && t < hi && t < bt) {
        bt = t;
        bk = k;
      }
    }
  }
  // the lexicographic minimum of (t, column) over the lanes; every lane
  // ends with it
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(FULL, bt, off);
    const int ocol = __shfl_xor_sync(FULL, bk, off);
    if (ot < bt || (ot == bt && ocol < bk)) {
      bt = ot;
      bk = ocol;
    }
  }
  // tiles come in rising column order: strict < keeps the earlier tile's
  if (lane == 0 && bt < sm.acc[0][q]) {
    sm.acc[0][q] = bt;
    sm.acc[1][q] = __int_as_float(col0 + bk);
  }
}

// The listed segments of tile j0 + b (staged in `tile`) against its first
// ncols columns, one (segment, tile) item per warp and turn.
template <int OP>
__device__ __forceinline__ void test_tile(TileSmem& sm, const float* tile,
                                          int j0, int b, int ncols) {
  const int warp = threadIdx.x >> 5;
  const int n_items = sm.tot[b];
  for (int it = warp; it < n_items; it += WARPS) {
    const int q = sm.list[b][it];
    if (OP == CLOSEST) {
      // the tile begins beyond the best hit so far: nothing in it is nearer
      if (sm.ent[b][q] > sm.acc[0][q]) continue;
      closest_item(sm, tile, q, (j0 + b) * SUB_BT, ncols);
    } else {
      // opaque in every channel: the floored result is -80 already
      if (OP == SUM_FLOORED && opaque(sm, q)) continue;
      sum_item(sm, tile, q, ncols);
    }
  }
}

// Tiles j0 .. j0 + GROUP - 1 against the block's segments: bit b of `mask`
// says that this thread's segment enters tile j0 + b (bits of tiles that are
// padding or past the group stay 0).  Called by every thread of the block;
// ends with a barrier, after which each segment's answer is up to date.
template <int OP>
__device__ __forceinline__ void tile_group(TileSmem& sm, const TileSrc& ts,
                                           int j0, unsigned mask) {
  constexpr int ROWS = OP == CLOSEST ? PACK_ROWS : TILE_ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned bal[GROUP];
#pragma unroll
  for (int b = 0; b < GROUP; ++b) {
    bal[b] = __ballot_sync(FULL, (mask >> b) & 1u);
    if (lane == b) sm.cnt[warp][b] = __popc(bal[b]);
  }
  __syncthreads();
  unsigned takers = 0;  // tiles with a non-empty list
#pragma unroll
  for (int b = 0; b < GROUP; ++b) {
    int before = 0, all = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = sm.cnt[w][b];
      before += w < warp ? c : 0;
      all += c;
    }
    if (tid == b) sm.tot[b] = all;
    if (all) takers |= 1u << b;
    if ((mask >> b) & 1u) {
      sm.list[b][before + __popc(bal[b] & ((1u << lane) - 1u))] = (seg_t)tid;
    }
  }
  int buf = 0;
  if (takers) stage_tile<ROWS>(sm.tile[0], ts, j0 + __ffs(takers) - 1);
  while (takers) {
    const int b = __ffs(takers) - 1;
    takers &= takers - 1;
    __pipeline_wait_prior(0);
    // tile b has landed for every thread, the lists and totals are written,
    // the previous tile's answers are in, and the other buffer's last
    // readers are done
    __syncthreads();
    if (takers) stage_tile<ROWS>(sm.tile[buf ^ 1], ts, j0 + __ffs(takers) - 1);
    test_tile<OP>(sm, sm.tile[buf], j0, b,
                  min(SUB_BT, ts.n_tris - (j0 + b) * SUB_BT));
    buf ^= 1;
  }
  __syncthreads();
}

// The pack and log-filter rows as stage_tile needs them (a closest hit
// passes the pack as both).
inline bool tiles_ok(const void* pack, const void* logf, int pack_w) {
  return pack_w > 0 && pack_w % SUB_BT == 0 &&
         (size_t)pack % 16 == 0 && (size_t)logf % 16 == 0;
}

}  // namespace
