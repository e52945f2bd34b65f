// The shadow-sum routine shared by shadow_fine_kernel (fine_intersect.cu) and
// pairs_shadow_kernel (pairs_intersect.cu), with the ray, box and
// Moller-Trumbore helpers both sources use.
//
// "A staged tile x the list of rays that enter it."  Both kernels sum, per
// ray or (ray, cluster) slot, the log filters of the triangles a shadow
// segment crosses, and both meet the pack as 128-column sub-clusters (tiles)
// with a box each.  A block of 256 threads owns up to 256 segments, kept in
// shared memory (origin, direction and its inverse, far limit, running
// sums).  For a group of up to 8 neighbouring tiles each thread says which of
// them its segment enters (a bit mask from the box tests); tile_group then
//   1. compacts, per tile, the entering segments into a list in shared
//      memory: one ballot per tile and warp, the warps' counts exchanged
//      through shared memory, each entry placed by a prefix count, so a list
//      holds its segments in thread order;
//   2. stages each tile that has takers into shared memory: pack rows 0-8
//      and the three log-filter rows, 12 x 512 B, with 16-byte cp.async
//      copies, double-buffered, the next tile with takers loading while this
//      one is tested;
//   3. deals the list to warps, one (segment, tile) item at a time: the 32
//      lanes take columns k, k+32, k+64, k+96 from shared memory
//      (consecutive words, no bank conflict), so every lane works however few
//      segments enter and a ray-triangle pair costs shared-memory reads, not
//      L2 reads.  Each lane sums its columns in rising order, the lanes are
//      added by a fixed __shfl_xor_sync tree, and lane 0 adds the tile's sum
//      to the segment's running sum.
// A segment appears at most once in a tile's list and tiles are visited in
// rising order with a barrier between them, so a segment's sum is taken in
// one fixed order whatever warp handles it: the same bits in every run, and
// no atomics on floats.
//
// With FLOOR (shadow_fine_kernel) an item whose segment already has all
// three sums <= -80 is skipped: log filters are <= 0, so its floored answer
// is -80 whatever else it crosses.  pairs_shadow_kernel's slot sums are not
// floored and skip nothing.
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
#define GROUP 8       // tiles whose lists are built together
#define SHADOW_LO ((float)5e-4)
#define LOG_FLOOR (-80.0f)

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
__device__ __forceinline__ void slab(const float* __restrict__ tab, int w,
                                     int j, const Ray& r, float lo, float hi,
                                     float* enter, float* exit_) {
  *enter = lo, *exit_ = hi;
  for (int a = 0; a < 3; ++a) {
    const float bl = __ldg(tab + a * w + j);
    const float bh = __ldg(tab + (a + 3) * w + j);
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
// log-filter rows, both 16-byte aligned with pack_w a multiple of SUB_BT.
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
// running sums, the per-tile lists (segment indices), the warps' counts per
// tile and their totals.
struct __align__(16) TileSmem {
  float tile[2][TILE_ROWS * SUB_BT];
  float o[3][SHADOW_THREADS], d[3][SHADOW_THREADS];
  float iv[3][SHADOW_THREADS];
  float hi[SHADOW_THREADS];
  float acc[3][SHADOW_THREADS];
  int cnt[WARPS][GROUP];
  int tot[GROUP];
  seg_t list[GROUP][SHADOW_THREADS];
};

// Thread `tid`'s segment into shared memory, its sums set to zero.
__device__ __forceinline__ void put_segment(TileSmem& sm, int tid,
                                            const Ray& r, float hi) {
  for (int a = 0; a < 3; ++a) {
    sm.o[a][tid] = r.o[a];
    sm.d[a][tid] = r.d[a];
    sm.iv[a][tid] = r.iv[a];
    sm.acc[a][tid] = 0.0f;
  }
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

// Bit b set where the segment's interval [SHADOW_LO, hi] enters box j0 + b
// of the (8, n_sc) sub-box table, for the nb (<= GROUP) boxes from j0.
__device__ __forceinline__ unsigned entered_mask(const TileSmem& sm, int tid,
                                                 const float* __restrict__ sub8,
                                                 int n_sc, int j0, int nb) {
  const Ray r = get_segment(sm, tid);
  const float hi = sm.hi[tid];
  unsigned mask = 0;
  for (int b = 0; b < nb; ++b) {
    if (box_entered(sub8, n_sc, j0 + b, r, SHADOW_LO, hi)) mask |= 1u << b;
  }
  return mask;
}

// Are all three sums of segment q at or below the floor?
__device__ __forceinline__ bool opaque(const TileSmem& sm, int q) {
  return sm.acc[0][q] <= LOG_FLOOR && sm.acc[1][q] <= LOG_FLOOR &&
         sm.acc[2][q] <= LOG_FLOOR;
}

// Start the copy of tile j into dst, the whole block sharing its 384
// 16-byte pieces; one cp.async group per thread.
__device__ __forceinline__ void stage_tile(float* dst, const TileSrc& ts,
                                           int j) {
  const int per_row = SUB_BT / 4;
  for (int ch = threadIdx.x; ch < TILE_ROWS * per_row; ch += SHADOW_THREADS) {
    const int row = ch / per_row, off = 4 * (ch % per_row);
    const float* src = (row < 9 ? ts.pack + (size_t)row * ts.pack_w
                                : ts.logf + (size_t)(row - 9) * ts.pack_w) +
                       (size_t)j * SUB_BT + off;
    __pipeline_memcpy_async(dst + row * SUB_BT + off, src, 16);
  }
  __pipeline_commit();
}

// The listed segments against the first ncols columns of a staged tile, one
// (segment, tile) item per warp and turn.
template <bool FLOOR>
__device__ __forceinline__ void sum_tile(TileSmem& sm, const float* tile,
                                         const seg_t* list,
                                         int n_items, int ncols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int it = warp; it < n_items; it += WARPS) {
    const int q = list[it];
    // opaque in every channel: the floored result is -80 already
    if (FLOOR && opaque(sm, q)) continue;
    Ray r;
    for (int a = 0; a < 3; ++a) {
      r.o[a] = sm.o[a][q];
      r.d[a] = sm.d[a][q];
    }
    const float hi = sm.hi[q];
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int round = 0; round < SUB_BT / 32; ++round) {
      const int k = 32 * round + lane;
      if (k < ncols) {
        float t;
        const bool ok = mt_test(tile, SUB_BT, k, r, &t);
        if (ok && t > SHADOW_LO && t < hi) {
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
}

// Tiles j0 .. j0 + GROUP - 1 against the block's segments: bit b of `mask`
// says that this thread's segment enters tile j0 + b (bits of tiles that are
// padding or past the group stay 0).  Called by every thread of the block;
// ends with a barrier, after which each segment's sums are up to date.
template <bool FLOOR>
__device__ __forceinline__ void tile_group(TileSmem& sm, const TileSrc& ts,
                                           int j0, unsigned mask) {
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
  if (takers) stage_tile(sm.tile[0], ts, j0 + __ffs(takers) - 1);
  while (takers) {
    const int b = __ffs(takers) - 1;
    takers &= takers - 1;
    __pipeline_wait_prior(0);
    // tile b has landed for every thread, the lists and totals are written,
    // and the other buffer's last readers are done
    __syncthreads();
    if (takers) stage_tile(sm.tile[buf ^ 1], ts, j0 + __ffs(takers) - 1);
    sum_tile<FLOOR>(sm, sm.tile[buf], sm.list[b], sm.tot[b],
                    min(SUB_BT, ts.n_tris - (j0 + b) * SUB_BT));
    buf ^= 1;
  }
  __syncthreads();
}

// The pack and log-filter rows as stage_tile needs them.
inline bool tiles_ok(const void* pack, const void* logf, int pack_w) {
  return pack_w > 0 && pack_w % SUB_BT == 0 &&
         (size_t)pack % 16 == 0 && (size_t)logf % 16 == 0;
}

}  // namespace
