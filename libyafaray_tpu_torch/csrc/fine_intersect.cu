// Large-scene ray-triangle intersection kernels for Hopper (sm_90a).
//
// Replace the gathered-fine TPU kernels of libyafaray_tpu/ops/pallas_intersect.py,
// which carry every scene from ~900 to 1M triangles:
//   closest_fine_kernel <- _closest_kernel_fine (wrappers _closest_fine_tcol,
//                          _run_fine_closest): nearest hit -> (t, pack column)
//   shadow_fine_kernel  <- _shadow_kernel_fine (wrapper _shadow_fine_lg):
//                          sum of per-triangle log filters, floored at -80
// with the per-pair math of _mt_tile / _mt_test_scalar (Moller-Trumbore).
//
// The function, not the TPU schedule.  The TPU kernels sort rays, build
// per-128-ray-block front-to-back sub-cluster lists and gather 8 sub-clusters
// per DMA visit, because a TPU core has no per-ray control flow.  Here a ray
// walks the scene's two-level box hierarchy itself: the (8, n_cl) cluster
// boxes of the pack (tri_cluster8) and, inside an entered cluster, its
// (8, n_sc) 128-column sub-cluster boxes; an entered sub-cluster runs
// Moller-Trumbore over its real columns.
//
// closest_fine_kernel: one warp per ray.  Bounce rays have no coherence
// between neighbours, so with one thread per ray a warp's 32 rays walk 32
// different boxes: every pack read is 32 scattered 4-byte loads and lanes
// idle while others test.  With the warp on one ray the 32 lanes
// * test 32 cluster boxes at once and keep each entry distance in a register
//   (LANE_BOXES per lane: 256 clusters a sweep, larger packs in several);
// * visit the entered clusters nearest entry first (one warp-wide minimum
//   per pick), so the best t shrinks early and culls what lies behind it: a
//   box is skipped only when its entry lies beyond min(tmax, best t), entry
//   == best is still visited;
// * test the picked cluster's sub-boxes in parallel, one lane each, and
//   visit them nearest first under the same rule;
// * take columns k, k+32, k+64, k+96 of an entered sub-cluster, so each of
//   the nine pack-row reads of a test is one coalesced 128-byte load.
// Each lane keeps its own (t, column); the warp-wide best t is refreshed
// after every sub-cluster for the cull.  The answer is the lexicographic
// minimum of (t, column) over the lanes, so it does not depend on the visit
// order: the lowest column wins ties, as in the plain versions of
// ops/fine_intersect.py (the reference's fine kernel keeps the first visited
// group's winner instead; the t is the same).  One launch a call, no sort of
// the rays and no scratch memory.
//
// shadow_fine_kernel: one block per run of up to 256 consecutive rays, the
// pack met as 128-column tiles staged in shared memory (shadow_tile.cuh).
// Its rays enter ~12x the pairs of a closest-hit call, which a warp per ray
// would read from L2 once per ray; here a tile is read from L2 once per block
// that has a taker for it.  Each thread tests its own ray against the real
// cluster boxes in pack order; a cluster no ray of the block enters is
// skipped by a block-wide vote, an entered one has its sub-boxes tested and
// its tiles summed by tile_group: the rays that enter a tile are listed and
// dealt to warps, a (ray, tile) item at a time.  NEE rays arrive as light
// sample x pixel, so the rays of a block are neighbouring pixels aimed at one
// light and share their tiles; rays from scattered bounce points share few,
// and then a tile has one or two takers but still all 32 lanes of a warp on
// each.  A launch of few rays (the pair route's stragglers) gives a block
// fewer rays, down to 32, so that the card has blocks to run; the threads
// past a block's rays own none and only join the tile work.
//
// Exactness against the plain brute force:
// * A box is skipped only when the ray's interval cannot enter it: entry
//   beyond min(tmax, best t) for the closest hit, beyond the segment for
//   shadows.  Each box is widened by 1e-5 of the largest magnitude among its
//   faces and the ray origin on that axis, so float rounding of the slab
//   test or of Moller-Trumbore's barycentrics (a hit accepted a few ulp
//   outside its triangle, or on a box of zero extent such as a wall) never
//   skips a hit the brute force takes.
// * Sub-clusters past ceil(n_tris / 128) and columns past n_tris are padding
//   and are never visited (their boxes are inverted, +inf / -inf, which the
//   slab form would count as entered).
// * Shadows: log filters are <= 0, so the running sum only falls; flooring it
//   once at -80 at the end equals the reference's per-group floor, and once
//   all three channels are <= -80 the result is exactly -80 and the walk
//   stops (the reference's opaque early exit).
//
// What bounds it on the H100.  The closest hit: L2 reads.  A ray-triangle
// pair is 36 bytes of the pack, read once per ray (the pack, 6.6 MB at 164K
// triangles, stays in L2; rays of one block that share a sub-cluster meet in
// L1), against ~45 FP32 operations; a warp-wide minimum and a sub-box round
// per visit are the walk's overhead.  Shadows: FP32 instructions of the
// Moller-Trumbore tests (-fmad=false, IEEE division), their operands read
// from shared memory; beside them the box tests every thread makes for its
// ray (all real clusters, and the sub-boxes of each cluster its block
// enters) and a barrier per visited tile.
//
// Built with -fmad=false and IEEE division like tiny_intersect.cu, so each
// operation rounds as the plain PyTorch version's float32 op does.

#include "shadow_tile.cuh"
#include "warp_walk.cuh"

#define RAYS_PER_CTA (THREADS / 32)  // closest hit: one warp per ray
#define LANE_BOXES 8  // cluster entries a lane holds: 32 * 8 clusters a sweep

namespace {

// Where the ray's interval [lo, hi] enters box j; +inf if it does not.
__device__ __forceinline__ float box_entry(const float* __restrict__ tab,
                                           int w, int j, const Ray& r,
                                           float lo, float hi) {
  float enter, exit_;
  slab(tab, w, j, r, lo, hi, &enter, &exit_);
  return enter <= exit_ ? enter : INFINITY;
}

struct Scene {
  const float* pack;  // (10, pack_w)
  int pack_w;
  const float* cl8;   // (8, n_cl)
  int n_cl;
  const float* sub8;  // (8, n_sc), n_sc = pack_w / SUB_BT
  int n_sc;
  int n_tris;
};

// Moller-Trumbore over the real columns of sub-cluster j, 32 columns a
// round; each lane keeps the lexicographic minimum (t, column) of its hits.
__device__ __forceinline__ void closest_sub(const Scene& s, int j,
                                            const Ray& r, float lo, float hi,
                                            int lane, float* lt, int* lcol) {
  const int k1 = min((j + 1) * SUB_BT, s.n_tris);
#pragma unroll
  for (int q = 0; q < SUB_BT / 32; ++q) {
    const int k = j * SUB_BT + 32 * q + lane;
    if (k < k1) {
      float t;
      const bool ok = mt_test(s.pack, s.pack_w, k, r, &t);
      keep_nearest(ok && t > lo && t < hi, t, k, lt, lcol);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
closest_fine_kernel(Scene s, const float* __restrict__ org,
                    const float* __restrict__ dir,
                    const float* __restrict__ tmin,
                    const float* __restrict__ tmax, int n,
                    float* __restrict__ t_out, int* __restrict__ col_out) {
  const int lane = threadIdx.x & 31;
  const long long i =
      (long long)blockIdx.x * RAYS_PER_CTA + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp
  const Ray r = load_ray(org, dir, i);
  const float lo = tmin[i], hi = tmax[i];
  const int spc = s.n_sc / s.n_cl;
  const int sc_real = (s.n_tris + SUB_BT - 1) / SUB_BT;
  const int cl_real = (sc_real + spc - 1) / spc;
  float lt = INFINITY;  // this lane's best hit
  int lcol = 0x7fffffff;
  float lim = hi;  // min(tmax, the warp's best t): no box beyond it matters
  for (int c0 = 0; c0 < cl_real; c0 += 32 * LANE_BOXES) {
    float ent[LANE_BOXES];  // entry distances of this lane's clusters
#pragma unroll
    for (int b = 0; b < LANE_BOXES; ++b) {
      const int c = c0 + 32 * b + lane;
      ent[b] = c < cl_real ? box_entry(s.cl8, s.n_cl, c, r, lo, lim)
                           : INFINITY;
    }
    for (;;) {
      // the nearest entered cluster not yet visited
      float mine = ent[0];
#pragma unroll
      for (int b = 1; b < LANE_BOXES; ++b) mine = fminf(mine, ent[b]);
      float e;
      const int src = nearest_within(mine, lim, &e);
      if (src < 0) break;
      int c = 0;
      if (lane == src) {
        bool taken = false;
#pragma unroll
        for (int b = 0; b < LANE_BOXES; ++b) {
          if (!taken && ent[b] == e) {
            ent[b] = INFINITY;
            c = c0 + 32 * b + lane;
            taken = true;
          }
        }
      }
      c = __shfl_sync(FULL, c, src);
      // its sub-boxes, one lane each, nearest entry first
      const int j0 = c * spc;
      const int n_sub = min(spc, sc_real - j0);
      for (int s0 = 0; s0 < n_sub; s0 += 32) {
        float sub = s0 + lane < n_sub
                        ? box_entry(s.sub8, s.n_sc, j0 + s0 + lane, r, lo, lim)
                        : INFINITY;
        for (;;) {
          float se;
          const int sl = nearest_within(sub, lim, &se);
          if (sl < 0) break;
          if (lane == sl) sub = INFINITY;
          closest_sub(s, j0 + s0 + sl, r, lo, hi, lane, &lt, &lcol);
          lim = fminf(hi, warp_min(lt));
        }
      }
    }
  }
  float best;
  int col;
  warp_nearest(lt, lcol, &best, &col);
  if (lane == 0) {
    t_out[i] = best;
    col_out[i] = best < INFINITY ? col : 0;
  }
}

// rpb: rays per block, a multiple of 32 up to SHADOW_THREADS; thread
// t < rpb owns ray blockIdx.x * rpb + t.
__global__ void __launch_bounds__(SHADOW_THREADS, SHADOW_MIN_BLOCKS)
shadow_fine_kernel(Scene s, const float* __restrict__ logf,
                   const float* __restrict__ org,
                   const float* __restrict__ dir,
                   const float* __restrict__ dist, int n, int rpb,
                   float* __restrict__ lg_out) {
  __shared__ TileSmem sm;
  const int tid = threadIdx.x;
  const long long i = (long long)blockIdx.x * rpb + tid;
  const bool has = tid < rpb && i < n;
  {
    Ray r = {};
    float hi = -1.0f;
    if (has) {
      r = load_ray(org, dir, i);
      hi = shadow_hi(dist[i]);
    }
    put_segment<SUM_FLOORED>(sm, tid, r, SHADOW_LO, hi);
  }
  // a dead lane (dist < 0) has an empty interval and enters nothing
  bool open = has && SHADOW_LO <= sm.hi[tid];  // live and not yet opaque
  const TileSrc ts{s.pack, logf, s.pack_w, s.n_tris};
  const int spc = s.n_sc / s.n_cl;
  const int sc_real = (s.n_tris + SUB_BT - 1) / SUB_BT;
  // a block of dead rays ends at this vote, a block whose rays have all
  // turned opaque at the vote after the cluster that closed the last one
  bool any_open = __syncthreads_or(open);
  for (int c = 0; any_open && c < s.n_cl && c * spc < sc_real; ++c) {
    const bool in_c = open && box_entered(s.cl8, s.n_cl, c,
                                          get_segment(sm, tid), SHADOW_LO,
                                          sm.hi[tid]);
    if (!__syncthreads_or(in_c)) continue;
    const int s1 = min((c + 1) * spc, sc_real);
    for (int j0 = c * spc; j0 < s1; j0 += GROUP) {
      const unsigned mask =
          in_c ? entered_mask(sm, tid, s.sub8, s.n_sc, j0, min(GROUP, s1 - j0))
               : 0u;
      tile_group<SUM_FLOORED>(sm, ts, j0, mask);
    }
    if (open) open = !opaque(sm, tid);
    any_open = __syncthreads_or(open);
  }
  if (has) {
    lg_out[3 * i] = fmaxf(sm.acc[0][tid], LOG_FLOOR);
    lg_out[3 * i + 1] = fmaxf(sm.acc[1][tid], LOG_FLOOR);
    lg_out[3 * i + 2] = fmaxf(sm.acc[2][tid], LOG_FLOOR);
  }
}

int check_scene(const Scene& s) {
  if (s.pack_w <= 0 || s.pack_w % SUB_BT != 0 || s.n_sc * SUB_BT != s.pack_w ||
      s.n_cl <= 0 || s.n_sc % s.n_cl != 0 || s.n_tris < 0 ||
      s.n_tris > s.pack_w) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// `stream` is a cudaStream_t.  Each returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int closest_hit_fine_launch(
    const void* pack, int pack_w, const void* cl8, int n_cl, const void* sub8,
    int n_sc, int n_tris, const void* org, const void* dir, const void* tmin,
    const void* tmax, int n, void* t_out, void* col_out, void* stream) {
  const Scene s{(const float*)pack, pack_w, (const float*)cl8, n_cl,
                (const float*)sub8, n_sc, n_tris};
  if (const int bad = check_scene(s)) return bad;
  if (n > 0) {
    const int blocks = (n + RAYS_PER_CTA - 1) / RAYS_PER_CTA;
    closest_fine_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        s, (const float*)org, (const float*)dir, (const float*)tmin,
        (const float*)tmax, n, (float*)t_out, (int*)col_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int shadow_logsum_fine_launch(
    const void* pack, int pack_w, const void* cl8, int n_cl, const void* sub8,
    int n_sc, int n_tris, const void* logf, int logf_w, const void* org,
    const void* dir, const void* dist, int n, void* lg_out, void* stream) {
  const Scene s{(const float*)pack, pack_w, (const float*)cl8, n_cl,
                (const float*)sub8, n_sc, n_tris};
  if (const int bad = check_scene(s)) return bad;
  if (logf_w != pack_w || !tiles_ok(pack, logf, pack_w)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    // 256 rays a block while that leaves every SM (132 on an H100) two
    // blocks; fewer rays a block for smaller launches
    int rpb = SHADOW_THREADS;
    while (rpb > 32 && (n + rpb - 1) / rpb < 2 * 132) rpb /= 2;
    const int blocks = (n + rpb - 1) / rpb;
    shadow_fine_kernel<<<blocks, SHADOW_THREADS, 0, (cudaStream_t)stream>>>(
        s, (const float*)logf, (const float*)org, (const float*)dir,
        (const float*)dist, n, rpb, (float*)lg_out);
  }
  return (int)cudaGetLastError();
}
