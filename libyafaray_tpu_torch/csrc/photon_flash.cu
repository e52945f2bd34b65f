// Photon-gather kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of libyafaray_tpu/ops/photon_flash.py:
//   density_flash_kernel,
//   density_sorted_kernel  <- _density_kernel        (wrapper density_flash:
//                             flash packs / sorted packs)
//   nearest_flash_kernel,
//   nearest_culled_kernel  <- _nearest_kernel        (wrapper nearest_flash:
//                             flash packs / sorted packs)
//   density_culled_kernel  <- _density_kernel_culled (wrapper
//                             density_culled; the body it replaced,
//                             density_culled_before_kernel, stays behind the
//                             private _density_culled_before)
//
// density_flash_kernel, nearest_flash_kernel and density_culled_before_
// kernel: one thread per query, no reduction across threads.  A CTA of 256
// queries walks the photons in 512-photon tiles (the reference's BP blocks,
// which are also the nearest lookup's tie unit and the sorted pack's
// clusters), staged once per CTA into shared memory as nine SoA rows (pos
// xyz, dir xyz, value xyz: 18 KB); every thread then reads each photon as a
// broadcast.  The TPU kernels compute the (BQ, BP) indicator tile on the
// VPU and push the flux sum through the MXU; here the indicator is a branch
// and the sum is kept in registers, one partial per tile added to the
// running total in photon order.  The old culled body scans the cluster
// boxes in index order, every thread alike: a cluster is staged if its box
// lies within the CTA's largest radius of the CTA's query box, and a thread
// sums it if the box lies within its own radius of its query.  Both tests
// are conservative: with the same operation order, the distance to a box
// never exceeds the distance to a photon inside it.  What bounds these
// three on the H100: the FP32 instruction rate.  A pair test is ~11
// operations (3 sub, 3 mul, 2 add for d2, 3 mul + 2 add for the side test,
// the compares) against 36 B of shared memory read as broadcasts.
//
// density_culled_kernel, the culled density over a Morton-sorted pack (the
// radiance-map precompute from 2^20 photons, and every sample step without
// final gather).  The queries come sorted along the pack's Morton curve
// (the wrapper's permutation, read and written through here).  What held
// the old body back, at 64,602 queries x 7,192 clusters: a CTA of 256
// sorted queries whose run jumps across the scene gets a query box that
// spans it and staged up to 2,293 clusters where its queries needed 288;
// its 253 CTAs ran in one wave, so the longest one set the time; each
// staged cluster waited for its 18 KB with two barriers; and every thread
// walked all 7,192 boxes serially.  What this body does:
// - a tile of CULL_QUERIES = 32 queries a CTA, CULL_TPQ = 16 threads a
//   query, CULL_QPT = 2 queries a thread (2,019 CTAs at the precompute,
//   8,192 at a 512^2 step; four resident an SM at 64 registers).  Thread j
//   of a query sums photons k = j mod 16 of each listed cluster into a
//   partial, added to its total after the cluster (a running sum over
//   thousands of photons drifts past rtol 1e-5), and a fixed
//   __shfl_xor_sync tree adds the 16 totals at the end.  A thread's two
//   queries share each photon it reads from shared memory;
// - an exact list: a thread tests a word of 32 clusters (their union box,
//   from the wrapper) against the tile's query box and largest radius; the
//   near words are dealt to the warps, a lane tests one cluster's box the
//   same way, and for each candidate the warp's lanes test the tile's
//   queries against it (their own point-box d2 <= r2), a ballot keeping
//   it if any passes.  The list is a bit a cluster over a window of
//   CULL_WINDOW clusters, read in rising index; a pack of more clusters
//   takes several windows, one after the other (the list's overflow path);
// - a two-deep ring of stages in shared memory, filled by cp.async: the
//   copy of the next listed cluster's nine rows and box overlaps the tests
//   on this one, with one barrier a cluster; a warp none of whose queries
//   needs the staged cluster skips it.
// The order of a thread's sum is fixed (listed clusters in rising index,
// its photons in rising index), so every call gives the same bits; counts
// equal the plain version's, the flux is a reordered float32 sum.  What
// bounds it now: the instruction rate of its pair tests (nine shared loads
// and ~40 other instructions a photon for a thread's two queries), ~70%
// of its time; the stages' copies from L2 (18 KB a listed cluster, ~2.5
// GB a call) most of the rest.  Its box tests are under 0.3% of its pair
// tests' operations.
//
// nearest_culled_kernel: one warp per query over a Morton-sorted pack.  The
// brute force (nearest_flash_kernel, kept for flash packs) tests every
// photon: 15.4 G pairs a call at 262,144 queries x 58,880 radiance photons,
// within 2.5x of what the FP32 rate allows, yet the nearest photon of a
// surface point lies in a few of the pack's clusters.  The function is the
// lexicographic minimum of (d2, original 512-photon block) over the photons
// within the radius, the value averaged over the photons sharing that pair:
// a form that does not depend on the order photons are met in, so the
// search may cull.  Final-gather queries have no coherence between
// neighbours, so the warp, not the CTA, shares a query: its lanes compute
// the point-to-box d2 of 32 cluster boxes at once (LANE_BOXES a lane in
// registers), the warp visits clusters nearest box first while box d2 <=
// min(r2, best d2) (<=: a box touching the best distance may hold a tie
// from an earlier block), and inside a cluster the lanes stride the 512
// positions, so each row read is one coalesced 128-byte load; a lane reads
// the block id and value rows only when its candidate improves or ties.
// One shuffle reduction at the end takes the minimum pair and sums value
// and count over the lanes that hold it.  One launch a call, no sort of
// the queries.  What bounds it: L2 reads of the visited clusters' position
// rows (6 KB a visit; the pack stays in L2) and the latency of the serial
// picks; FP32 work is small.
//
// density_sorted_kernel: the density over a Morton-sorted pack, one warp a
// query, the structure of nearest_culled_kernel.  The brute force
// (density_flash_kernel, kept for flash packs) tests every photon: 20.7 G
// pairs at the radiance precompute's 58,710 queries x 352,256 photons, in
// shooting order, whose 512-photon tiles have no box worth testing.  Sorted,
// a query needs only the clusters whose box lies within its radius.  The
// precompute's queries are strided photons in shooting order, with no
// coherence inside a CTA, so each warp culls for its own query: the lanes
// compute the point-box d2 of 32 x LANE_BOXES clusters, a ballot keeps those
// with box d2 <= r2, and the warp visits them in rising cluster index (a
// density needs every such cluster, in a fixed order); inside a cluster the
// lanes stride its 512 photons, each row read one coalesced 128-byte load
// of the L2-resident table (rows 0-5; the value rows only for a photon that
// counts).  Per-lane partial sums, one fixed __shfl_xor_sync tree at the
// end: the same bits in every call.  What bounds it: L2 reads of the
// visited clusters' position and direction rows (12 KB a visit) and the
// FP32 work of their pairs.
//
// Built with -fmad=false: d2 = dx*dx + dy*dy + dz*dz and
// side = nx*ax + ny*ay + nz*az round exactly as the plain PyTorch versions
// in ops/photon_flash.py do, so the radius and side tests, and hence the
// counts, found flags and best distances, are bit-equal to them.  Flux, and
// the value of a tie, is a reordered float32 sum.

#include <cuda_runtime.h>
#include <math.h>

#define BP 512
#define THREADS 256
#define QUERIES_PER_CTA (THREADS / 32)  // the warp kernels: a warp a query
#define LANE_BOXES 8  // box distances a lane holds: 32 * 8 clusters a sweep
#define FULL 0xffffffffu

namespace {

struct Tile {
  float px[BP], py[BP], pz[BP];
  float ax[BP], ay[BP], az[BP];
  float vx[BP], vy[BP], vz[BP];
};

// Photons [base, base + BP) of row arrays with row stride w: pos rows
// pos[0..2], dir rows aux[0..2] (if aux), values either as rows val[0..2]
// (val_rows) or as (w, 3) row-major triples.
__device__ __forceinline__ void stage(Tile& s, const float* __restrict__ pos,
                                      const float* __restrict__ aux,
                                      const float* __restrict__ val,
                                      bool val_rows, long long w,
                                      long long base) {
  for (int k = threadIdx.x; k < BP; k += blockDim.x) {
    const long long j = base + k;
    s.px[k] = pos[j];
    s.py[k] = pos[w + j];
    s.pz[k] = pos[2 * w + j];
    if (aux != nullptr) {
      s.ax[k] = aux[j];
      s.ay[k] = aux[w + j];
      s.az[k] = aux[2 * w + j];
    }
    if (val_rows) {
      s.vx[k] = val[j];
      s.vy[k] = val[w + j];
      s.vz[k] = val[2 * w + j];
    } else {
      s.vx[k] = val[3 * j];
      s.vy[k] = val[3 * j + 1];
      s.vz[k] = val[3 * j + 2];
    }
  }
}

// Adds one staged tile's density terms for query (q, nq, rr) to
// (fx, fy, fz, c): a partial sum over the tile, then one add each.
__device__ __forceinline__ void density_tile(const Tile& s, float qx, float qy,
                                             float qz, float nx, float ny,
                                             float nz, float rr, float* fx,
                                             float* fy, float* fz, float* c) {
  float bx = 0.0f, by = 0.0f, bz = 0.0f, bc = 0.0f;
#pragma unroll 4
  for (int k = 0; k < BP; ++k) {
    const float dx = qx - s.px[k];
    const float dy = qy - s.py[k];
    const float dz = qz - s.pz[k];
    const float d2 = dx * dx + dy * dy + dz * dz;
    const float side = nx * s.ax[k] + ny * s.ay[k] + nz * s.az[k];
    if (d2 <= rr && side > 0.0f) {
      bx += s.vx[k];
      by += s.vy[k];
      bz += s.vz[k];
      bc += 1.0f;
    }
  }
  *fx += bx;
  *fy += by;
  *fz += bz;
  *c += bc;
}

__global__ void density_flash_kernel(
    const float* __restrict__ pos, const float* __restrict__ aux,
    const float* __restrict__ val, int w, const float* __restrict__ qp,
    const float* __restrict__ qn, const float* __restrict__ r2, int n,
    float* __restrict__ flux, float* __restrict__ cnt) {
  __shared__ Tile s;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  float rr = -1.0f;
  if (live) {
    qx = qp[3 * i], qy = qp[3 * i + 1], qz = qp[3 * i + 2];
    nx = qn[3 * i], ny = qn[3 * i + 1], nz = qn[3 * i + 2];
    rr = r2[i];
  }
  float fx = 0.0f, fy = 0.0f, fz = 0.0f, c = 0.0f;
  for (long long base = 0; base < w; base += BP) {
    __syncthreads();
    stage(s, pos, aux, val, false, w, base);
    __syncthreads();
    if (live) density_tile(s, qx, qy, qz, nx, ny, nz, rr, &fx, &fy, &fz, &c);
  }
  if (live) {
    flux[3 * i] = fx;
    flux[3 * i + 1] = fy;
    flux[3 * i + 2] = fz;
    cnt[i] = c;
  }
}

__global__ void nearest_flash_kernel(
    const float* __restrict__ pos, const float* __restrict__ val, int w,
    const float* __restrict__ qp, const float* __restrict__ r2, int n,
    float* __restrict__ best_out, float* __restrict__ val_out) {
  __shared__ Tile s;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f, rr = -1.0f;
  if (live) {
    qx = qp[3 * i], qy = qp[3 * i + 1], qz = qp[3 * i + 2];
    rr = r2[i];
  }
  float best = INFINITY, ox = 0.0f, oy = 0.0f, oz = 0.0f;
  for (long long base = 0; base < w; base += BP) {
    __syncthreads();
    stage(s, pos, nullptr, val, false, w, base);
    __syncthreads();
    if (!live) continue;
    // the block's minimum d2, its tie count and the sum of the tied values
    float bm = INFINITY, bc = 0.0f, bx = 0.0f, by = 0.0f, bz = 0.0f;
#pragma unroll 4
    for (int k = 0; k < BP; ++k) {
      const float dx = qx - s.px[k];
      const float dy = qy - s.py[k];
      const float dz = qz - s.pz[k];
      const float d2 = dx * dx + dy * dy + dz * dz;
      if (d2 < bm) {
        bm = d2;
        bc = 1.0f;
        bx = s.vx[k];
        by = s.vy[k];
        bz = s.vz[k];
      } else if (d2 == bm) {
        bc += 1.0f;
        bx += s.vx[k];
        by += s.vy[k];
        bz += s.vz[k];
      }
    }
    // strict <: on equal minima the earlier block keeps its value
    if (bm < best && bm <= rr) {
      const float inv = 1.0f / bc;
      best = bm;
      ox = bx * inv;
      oy = by * inv;
      oz = bz * inv;
    }
  }
  if (live) {
    best_out[i] = best;
    val_out[3 * i] = ox;
    val_out[3 * i + 1] = oy;
    val_out[3 * i + 2] = oz;
  }
}

// Squared distance from (x, y, z) to the box [l, h] (per-axis gaps clamped
// at 0, summed x, y, z).
__device__ __forceinline__ float box_d2(float lx, float ly, float lz,
                                        float hx, float hy, float hz, float x,
                                        float y, float z) {
  const float ex = fmaxf(fmaxf(lx - x, 0.0f), fmaxf(x - hx, 0.0f));
  const float ey = fmaxf(fmaxf(ly - y, 0.0f), fmaxf(y - hy, 0.0f));
  const float ez = fmaxf(fmaxf(lz - z, 0.0f), fmaxf(z - hz, 0.0f));
  return ex * ex + ey * ey + ez * ez;
}

__global__ void density_culled_before_kernel(
    const float* __restrict__ tbl, int w, const float* __restrict__ cl_lo,
    const float* __restrict__ cl_hi, int n_cl, const float* __restrict__ qp,
    const float* __restrict__ qn, const float* __restrict__ r2,
    const float* __restrict__ blk, int n, float* __restrict__ flux,
    float* __restrict__ cnt) {
  __shared__ Tile s;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  float rr = -1.0f;
  if (live) {
    qx = qp[3 * i], qy = qp[3 * i + 1], qz = qp[3 * i + 2];
    nx = qn[3 * i], ny = qn[3 * i + 1], nz = qn[3 * i + 2];
    rr = r2[i];
  }
  // this CTA's query box and largest squared radius
  const float* b = blk + 8LL * blockIdx.x;
  const float blx = b[0], bly = b[1], blz = b[2];
  const float bhx = b[3], bhy = b[4], bhz = b[5], rmax2 = b[6];
  float fx = 0.0f, fy = 0.0f, fz = 0.0f, c = 0.0f;
  for (int cl = 0; cl < n_cl; ++cl) {
    const float lx = cl_lo[3 * cl], ly = cl_lo[3 * cl + 1],
                lz = cl_lo[3 * cl + 2];
    const float hx = cl_hi[3 * cl], hy = cl_hi[3 * cl + 1],
                hz = cl_hi[3 * cl + 2];
    // box-to-box gap: the same for every thread of the CTA
    const float gx = fmaxf(fmaxf(lx - bhx, 0.0f), fmaxf(blx - hx, 0.0f));
    const float gy = fmaxf(fmaxf(ly - bhy, 0.0f), fmaxf(bly - hy, 0.0f));
    const float gz = fmaxf(fmaxf(lz - bhz, 0.0f), fmaxf(blz - hz, 0.0f));
    if (!(gx * gx + gy * gy + gz * gz <= rmax2)) continue;
    __syncthreads();
    stage(s, tbl, tbl + 3LL * w, tbl + 6LL * w, true, w, (long long)cl * BP);
    __syncthreads();
    if (live && box_d2(lx, ly, lz, hx, hy, hz, qx, qy, qz) <= rr) {
      density_tile(s, qx, qy, qz, nx, ny, nz, rr, &fx, &fy, &fz, &c);
    }
  }
  if (live) {
    flux[3 * i] = fx;
    flux[3 * i + 1] = fy;
    flux[3 * i + 2] = fz;
    cnt[i] = c;
  }
}

// ---- density_culled_kernel ---------------------------------------------

#define CULL_TPQ 16                           // threads a query
#define CULL_QPT 2                            // queries a thread
#define CULL_QUERIES (THREADS / CULL_TPQ * CULL_QPT)  // queries a tile
#define CULL_MASK_WORDS 256                   // the list's window, in words
#define CULL_WINDOW (32 * CULL_MASK_WORDS)    // clusters a window
#define STAGE_ROWS 9                          // pos xyz, dir xyz, value xyz
#define STAGE_CHUNKS (STAGE_ROWS * BP / 4)    // 16-byte copies a cluster
static_assert(CULL_MASK_WORDS <= THREADS, "a thread tests one word's box");

// One staged cluster: its nine rows and its box (lo xyz, hi xyz).
struct __align__(16) Stage {
  float rows[STAGE_ROWS][BP];
  float box[8];
};

#ifndef EMULATED_ASYNC_COPY  // the CPU stand-in runtime brings plain copies
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
// Waits for every copy this thread has started.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
#endif

// Starts this thread's share of the copies of cluster cl (rows of the
// (9+, w) table tbl, box from cl_lo / cl_hi) into st.
__device__ __forceinline__ void stage_async(Stage& st,
                                            const float* __restrict__ tbl,
                                            long long w,
                                            const float* __restrict__ cl_lo,
                                            const float* __restrict__ cl_hi,
                                            int cl) {
  const long long base = (long long)cl * BP;
  for (int u = threadIdx.x; u < STAGE_CHUNKS; u += blockDim.x) {
    const int row = u / (BP / 4), off = 4 * (u % (BP / 4));
    cp_async16(&st.rows[row][off], tbl + row * w + base + off);
  }
  if (threadIdx.x < 3) {
    cp_async4(&st.box[threadIdx.x], cl_lo + 3LL * cl + threadIdx.x);
  } else if (threadIdx.x < 6) {
    cp_async4(&st.box[threadIdx.x], cl_hi + 3LL * cl + threadIdx.x - 3);
  }
}

// The next cluster of the window's list after the one taken from
// (*wi, *bits), in rising index, or -1: every thread walks it alike.
__device__ __forceinline__ int next_listed(const unsigned* mask, int words,
                                           int c0, int* wi, unsigned* bits) {
  while (*bits == 0u) {
    if (++*wi >= words) return -1;
    *bits = mask[*wi];
  }
  const int b = __ffs(*bits) - 1;
  *bits &= *bits - 1u;
  return c0 + 32 * *wi + b;
}

// Cluster cl's box from cl_lo / cl_hi, or an empty one (+inf, -inf) if
// cl >= n_cl.
__device__ __forceinline__ void load_box(const float* __restrict__ cl_lo,
                                         const float* __restrict__ cl_hi,
                                         int cl, int n_cl, float* b) {
  if (cl < n_cl) {
    b[0] = cl_lo[3 * cl], b[1] = cl_lo[3 * cl + 1], b[2] = cl_lo[3 * cl + 2];
    b[3] = cl_hi[3 * cl], b[4] = cl_hi[3 * cl + 1], b[5] = cl_hi[3 * cl + 2];
  } else {
    b[0] = b[1] = b[2] = INFINITY;
    b[3] = b[4] = b[5] = -INFINITY;
  }
}

// Squared gap between the boxes [l, h] and [bl, bh] (per axis the larger
// of the two one-sided gaps, clamped at 0).
__device__ __forceinline__ float box_gap2(float lx, float ly, float lz,
                                          float hx, float hy, float hz,
                                          float blx, float bly, float blz,
                                          float bhx, float bhy, float bhz) {
  const float gx = fmaxf(fmaxf(lx - bhx, 0.0f), fmaxf(blx - hx, 0.0f));
  const float gy = fmaxf(fmaxf(ly - bhy, 0.0f), fmaxf(bly - hy, 0.0f));
  const float gz = fmaxf(fmaxf(lz - bhz, 0.0f), fmaxf(blz - hz, 0.0f));
  return gx * gx + gy * gy + gz * gz;
}

// perm (n,) int64: the queries in the pack's Morton order; query perm[i]
// is tile i / CULL_QUERIES's, and its answer is written back there.  wbox
// (ceil(n_cl / 32), 6): the union box (lo xyz, hi xyz) of each 32
// clusters.  A thread takes CULL_QPT neighbouring queries of its tile and,
// for each, the photons k = j mod CULL_TPQ of every listed cluster.
__global__ void __launch_bounds__(THREADS, 4) density_culled_kernel(
    const float* __restrict__ tbl, int w, const float* __restrict__ cl_lo,
    const float* __restrict__ cl_hi, int n_cl, const float* __restrict__ qp,
    const float* __restrict__ qn, const float* __restrict__ r2,
    const long long* __restrict__ perm, const float* __restrict__ wbox, int n,
    float* __restrict__ flux, float* __restrict__ cnt) {
  __shared__ Stage st[2];
  __shared__ float4 tq[CULL_QUERIES];  // the tile's queries: xyz, r2 (-1: none)
  __shared__ unsigned mask[CULL_MASK_WORDS];
  __shared__ unsigned wmask[THREADS / 32];  // the near words
  __shared__ float tbox[8];  // the tile's query box, its largest r2
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = threadIdx.x % CULL_TPQ;
  const int first = threadIdx.x / CULL_TPQ * CULL_QPT;  // in the tile
  long long src[CULL_QPT];
  float qx[CULL_QPT], qy[CULL_QPT], qz[CULL_QPT];
  float nx[CULL_QPT], ny[CULL_QPT], nz[CULL_QPT], rr[CULL_QPT];
#pragma unroll
  for (int m = 0; m < CULL_QPT; ++m) {
    const long long i = (long long)blockIdx.x * CULL_QUERIES + first + m;
    src[m] = -1;
    qx[m] = qy[m] = qz[m] = nx[m] = ny[m] = nz[m] = 0.0f;
    rr[m] = -1.0f;
    if (i < n) {
      const long long q = perm[i];
      src[m] = q;
      qx[m] = qp[3 * q], qy[m] = qp[3 * q + 1], qz[m] = qp[3 * q + 2];
      nx[m] = qn[3 * q], ny[m] = qn[3 * q + 1], nz[m] = qn[3 * q + 2];
      rr[m] = r2[q];
    }
    if (j == 0) {
      float4& t = tq[first + m];
      t.x = qx[m], t.y = qy[m], t.z = qz[m], t.w = rr[m];
    }
  }
  __syncthreads();
  if (warp == 0) {
    float lx = INFINITY, ly = INFINITY, lz = INFINITY;
    float hx = -INFINITY, hy = -INFINITY, hz = -INFINITY, m = -INFINITY;
    for (int q = lane; q < CULL_QUERIES; q += 32) {
      const float4 t = tq[q];
      if (t.w >= 0.0f) {
        lx = fminf(lx, t.x), ly = fminf(ly, t.y), lz = fminf(lz, t.z);
        hx = fmaxf(hx, t.x), hy = fmaxf(hy, t.y), hz = fmaxf(hz, t.z);
        m = fmaxf(m, t.w);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      lx = fminf(lx, __shfl_xor_sync(FULL, lx, off));
      ly = fminf(ly, __shfl_xor_sync(FULL, ly, off));
      lz = fminf(lz, __shfl_xor_sync(FULL, lz, off));
      hx = fmaxf(hx, __shfl_xor_sync(FULL, hx, off));
      hy = fmaxf(hy, __shfl_xor_sync(FULL, hy, off));
      hz = fmaxf(hz, __shfl_xor_sync(FULL, hz, off));
      m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    }
    if (lane == 0) {
      tbox[0] = lx, tbox[1] = ly, tbox[2] = lz;
      tbox[3] = hx, tbox[4] = hy, tbox[5] = hz, tbox[6] = m;
    }
  }
  __syncthreads();
  const float blx = tbox[0], bly = tbox[1], blz = tbox[2];
  const float bhx = tbox[3], bhy = tbox[4], bhz = tbox[5], rmax2 = tbox[6];
  float fx[CULL_QPT], fy[CULL_QPT], fz[CULL_QPT], c[CULL_QPT];
#pragma unroll
  for (int m = 0; m < CULL_QPT; ++m) fx[m] = fy[m] = fz[m] = c[m] = 0.0f;
  for (int c0 = 0; c0 < n_cl; c0 += CULL_WINDOW) {
    const int words = min(CULL_MASK_WORDS, (n_cl - c0 + 31) / 32);
    // (1) the window's list.  A thread a word of 32 clusters: its union box
    // against the tile's query box and largest radius
    bool near = false;
    if (threadIdx.x < words) {
      mask[threadIdx.x] = 0u;
      const float* wb = wbox + 6LL * (c0 / 32 + threadIdx.x);
      near = box_gap2(wb[0], wb[1], wb[2], wb[3], wb[4], wb[5], blx, bly,
                      blz, bhx, bhy, bhz) <= rmax2;
    }
    const unsigned nw = __ballot_sync(FULL, near);
    if (lane == 0) wmask[warp] = nw;
    __syncthreads();
    // then the near words, dealt to the warps in turn: a lane a cluster's
    // box against the tile's box, and each candidate against every query
    // of the tile (their own point-box d2 <= r2), kept if any passes
    int dealt = 0;
    for (int ww = 0; ww < THREADS / 32; ++ww) {
      for (unsigned wm = wmask[ww]; wm; wm &= wm - 1u) {
        if (dealt++ % (THREADS / 32) != warp) continue;
        const int word = 32 * ww + __ffs(wm) - 1;
        float b[6];
        load_box(cl_lo, cl_hi, c0 + 32 * word + lane, n_cl, b);
        unsigned m = __ballot_sync(
            FULL, box_gap2(b[0], b[1], b[2], b[3], b[4], b[5], blx, bly, blz,
                           bhx, bhy, bhz) <= rmax2);
        unsigned keep = 0u;
        while (m) {
          const int k = __ffs(m) - 1;
          m &= m - 1u;
          float e[6];
#pragma unroll
          for (int a = 0; a < 6; ++a) e[a] = __shfl_sync(FULL, b[a], k);
          bool need = false;
          for (int q = lane; q < CULL_QUERIES; q += 32) {
            const float4 t = tq[q];
            need = need || box_d2(e[0], e[1], e[2], e[3], e[4], e[5], t.x,
                                  t.y, t.z) <= t.w;
          }
          if (__any_sync(FULL, need)) keep |= 1u << k;
        }
        if (lane == 0) mask[word] = keep;
      }
    }
    __syncthreads();
    // (2) the listed clusters in rising index, two stages deep
    int wi = 0;
    unsigned bits = words > 0 ? mask[0] : 0u;
    int cur = next_listed(mask, words, c0, &wi, &bits);
    if (cur >= 0) stage_async(st[0], tbl, w, cl_lo, cl_hi, cur);
    for (int s = 0; cur >= 0; s ^= 1) {
      cp_async_wait_all();
      // every copy of `cur` has landed; every thread is done with st[s ^ 1]
      __syncthreads();
      const int nxt = next_listed(mask, words, c0, &wi, &bits);
      if (nxt >= 0) stage_async(st[s ^ 1], tbl, w, cl_lo, cl_hi, nxt);
      const Stage& t = st[s];
      bool need = false;
#pragma unroll
      for (int m = 0; m < CULL_QPT; ++m) {
        need = need || box_d2(t.box[0], t.box[1], t.box[2], t.box[3],
                              t.box[4], t.box[5], qx[m], qy[m], qz[m]) <=
                           rr[m];
      }
      if (__any_sync(FULL, need)) {
        // this cluster's partial sums, added to the totals after it
        float bx[CULL_QPT], by[CULL_QPT], bz[CULL_QPT], bc[CULL_QPT];
#pragma unroll
        for (int m = 0; m < CULL_QPT; ++m) bx[m] = by[m] = bz[m] = bc[m] = 0.0f;
#pragma unroll 4
        for (int k = j; k < BP; k += CULL_TPQ) {
          const float px = t.rows[0][k], py = t.rows[1][k], pz = t.rows[2][k];
          const float ax = t.rows[3][k], ay = t.rows[4][k], az = t.rows[5][k];
          bool pass[CULL_QPT];
          bool any = false;
#pragma unroll
          for (int m = 0; m < CULL_QPT; ++m) {
            const float dx = qx[m] - px;
            const float dy = qy[m] - py;
            const float dz = qz[m] - pz;
            const float d2 = dx * dx + dy * dy + dz * dz;
            const float side = nx[m] * ax + ny[m] * ay + nz[m] * az;
            pass[m] = d2 <= rr[m] && side > 0.0f;
            any = any || pass[m];
          }
          if (any) {
            const float vx = t.rows[6][k], vy = t.rows[7][k];
            const float vz = t.rows[8][k];
#pragma unroll
            for (int m = 0; m < CULL_QPT; ++m) {
              if (pass[m]) {
                bx[m] += vx;
                by[m] += vy;
                bz[m] += vz;
                bc[m] += 1.0f;
              }
            }
          }
        }
#pragma unroll
        for (int m = 0; m < CULL_QPT; ++m) {
          fx[m] += bx[m];
          fy[m] += by[m];
          fz[m] += bz[m];
          c[m] += bc[m];
        }
      }
      cur = nxt;
    }
    __syncthreads();  // the mask and the stages are free again
  }
  // the CULL_TPQ partials of a query, added by a fixed tree
#pragma unroll
  for (int m = 0; m < CULL_QPT; ++m) {
    for (int off = CULL_TPQ / 2; off > 0; off >>= 1) {
      fx[m] += __shfl_xor_sync(FULL, fx[m], off);
      fy[m] += __shfl_xor_sync(FULL, fy[m], off);
      fz[m] += __shfl_xor_sync(FULL, fz[m], off);
      c[m] += __shfl_xor_sync(FULL, c[m], off);
    }
    if (j == 0 && src[m] >= 0) {
      flux[3 * src[m]] = fx[m];
      flux[3 * src[m] + 1] = fy[m];
      flux[3 * src[m] + 2] = fz[m];
      cnt[src[m]] = c[m];
    }
  }
}

// A warp's query: the density over the clusters of a sorted pack (tbl rows
// 0:3 pos, 3:6 dir, 6:9 value) whose box lies within its radius.
__global__ void __launch_bounds__(THREADS) density_sorted_kernel(
    const float* __restrict__ tbl, int w, const float* __restrict__ cl_lo,
    const float* __restrict__ cl_hi, int n_cl, const float* __restrict__ qp,
    const float* __restrict__ qn, const float* __restrict__ r2, int n,
    float* __restrict__ flux, float* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  const long long i =
      (long long)blockIdx.x * QUERIES_PER_CTA + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp
  const float qx = qp[3 * i], qy = qp[3 * i + 1], qz = qp[3 * i + 2];
  const float nx = qn[3 * i], ny = qn[3 * i + 1], nz = qn[3 * i + 2];
  const float rr = r2[i];
  const float* __restrict__ px = tbl;
  const float* __restrict__ py = tbl + w;
  const float* __restrict__ pz = tbl + 2LL * w;
  const float* __restrict__ ax = tbl + 3LL * w;
  const float* __restrict__ ay = tbl + 4LL * w;
  const float* __restrict__ az = tbl + 5LL * w;
  const float* __restrict__ vx = tbl + 6LL * w;
  const float* __restrict__ vy = tbl + 7LL * w;
  const float* __restrict__ vz = tbl + 8LL * w;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f, c = 0.0f;  // this lane's part
  for (int c0 = 0; c0 < n_cl; c0 += 32 * LANE_BOXES) {
    // bit l of near[b]: cluster c0 + 32 b + l lies within the radius
    unsigned near[LANE_BOXES];
#pragma unroll
    for (int b = 0; b < LANE_BOXES; ++b) {
      const int cl = c0 + 32 * b + lane;
      near[b] = __ballot_sync(
          FULL, cl < n_cl &&
                    box_d2(cl_lo[3 * cl], cl_lo[3 * cl + 1], cl_lo[3 * cl + 2],
                           cl_hi[3 * cl], cl_hi[3 * cl + 1], cl_hi[3 * cl + 2],
                           qx, qy, qz) <= rr);
    }
#pragma unroll 1
    for (int b = 0; b < LANE_BOXES; ++b) {
      unsigned m = 0;  // near[b], picked without indexing the array
#pragma unroll
      for (int k = 0; k < LANE_BOXES; ++k) m = k == b ? near[k] : m;
      while (m) {  // rising cluster index
        const long long base = (long long)(c0 + 32 * b + __ffs(m) - 1) * BP;
        m &= m - 1;
#pragma unroll 4
        for (int it = 0; it < BP / 32; ++it) {
          const long long j = base + 32 * it + lane;
          const float dx = qx - px[j];
          const float dy = qy - py[j];
          const float dz = qz - pz[j];
          const float d2 = dx * dx + dy * dy + dz * dz;
          const float side = nx * ax[j] + ny * ay[j] + nz * az[j];
          if (d2 <= rr && side > 0.0f) {
            fx += vx[j];
            fy += vy[j];
            fz += vz[j];
            c += 1.0f;
          }
        }
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    fx += __shfl_xor_sync(FULL, fx, off);
    fy += __shfl_xor_sync(FULL, fy, off);
    fz += __shfl_xor_sync(FULL, fz, off);
    c += __shfl_xor_sync(FULL, c, off);
  }
  if (lane == 0) {
    flux[3 * i] = fx;
    flux[3 * i + 1] = fy;
    flux[3 * i + 2] = fz;
    cnt[i] = c;
  }
}

// Non-negative floats order as their bit patterns: the warp-wide minimum
// of squared distances (and block ids) is one integer reduction.
__device__ __forceinline__ float warp_min_nonneg(float f) {
  return __uint_as_float(__reduce_min_sync(FULL, __float_as_uint(f)));
}

__global__ void __launch_bounds__(THREADS) nearest_culled_kernel(
    const float* __restrict__ tbl, int w, const float* __restrict__ cl_lo,
    const float* __restrict__ cl_hi, int n_cl, const float* __restrict__ qp,
    const float* __restrict__ r2, int n, float* __restrict__ best_out,
    float* __restrict__ val_out) {
  const int lane = threadIdx.x & 31;
  const long long i =
      (long long)blockIdx.x * QUERIES_PER_CTA + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp
  const float qx = qp[3 * i], qy = qp[3 * i + 1], qz = qp[3 * i + 2];
  const float rr = r2[i];
  const float* __restrict__ px = tbl;
  const float* __restrict__ py = tbl + w;
  const float* __restrict__ pz = tbl + 2LL * w;
  const float* __restrict__ vx = tbl + 6LL * w;
  const float* __restrict__ vy = tbl + 7LL * w;
  const float* __restrict__ vz = tbl + 8LL * w;
  const float* __restrict__ blk = tbl + 9LL * w;
  // this lane's best (d2, block), the photons it met there and their sum
  float ld2 = INFINITY, lblk = 0.0f, cnt = 0.0f;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  float lim = rr;  // min(r2, the warp's best d2)
  for (int c0 = 0; c0 < n_cl; c0 += 32 * LANE_BOXES) {
    float bd[LANE_BOXES];  // box distances of this lane's clusters
#pragma unroll
    for (int b = 0; b < LANE_BOXES; ++b) {
      const int c = c0 + 32 * b + lane;
      bd[b] = INFINITY;
      if (c < n_cl) {
        bd[b] = box_d2(cl_lo[3 * c], cl_lo[3 * c + 1], cl_lo[3 * c + 2],
                       cl_hi[3 * c], cl_hi[3 * c + 1], cl_hi[3 * c + 2], qx,
                       qy, qz);
      }
    }
    for (;;) {
      // the nearest box not yet visited
      float mine = bd[0];
#pragma unroll
      for (int b = 1; b < LANE_BOXES; ++b) mine = fminf(mine, bd[b]);
      const float e = warp_min_nonneg(mine);
      if (!(e <= lim) || e == INFINITY) break;
      const int src = __ffs(__ballot_sync(FULL, mine == e)) - 1;
      int c = 0;
      if (lane == src) {
        bool taken = false;
#pragma unroll
        for (int b = 0; b < LANE_BOXES; ++b) {
          if (!taken && bd[b] == e) {
            bd[b] = INFINITY;
            c = c0 + 32 * b + lane;
            taken = true;
          }
        }
      }
      c = __shfl_sync(FULL, c, src);
      const long long base = (long long)c * BP;
#pragma unroll 8
      for (int it = 0; it < BP / 32; ++it) {
        const long long j = base + 32 * it + lane;
        const float dx = qx - px[j];
        const float dy = qy - py[j];
        const float dz = qz - pz[j];
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 <= lim && d2 <= ld2 && d2 < INFINITY) {
          const float b = blk[j];
          if (d2 < ld2 || b < lblk) {
            ld2 = d2, lblk = b, cnt = 1.0f;
            sx = vx[j], sy = vy[j], sz = vz[j];
          } else if (b == lblk) {
            cnt += 1.0f;
            sx += vx[j], sy += vy[j], sz += vz[j];
          }
        }
      }
      lim = fminf(rr, warp_min_nonneg(ld2));
    }
  }
  // the lexicographic minimum (d2, block) over the lanes, and the sum over
  // the lanes that hold it
  const float best = warp_min_nonneg(ld2);
  const bool at = ld2 == best && best < INFINITY;
  const unsigned first = __reduce_min_sync(
      FULL, at ? __float_as_uint(lblk) : 0xffffffffu);
  const bool win = at && __float_as_uint(lblk) == first;
  float c = win ? cnt : 0.0f;
  float x = win ? sx : 0.0f, y = win ? sy : 0.0f, z = win ? sz : 0.0f;
  for (int off = 16; off > 0; off >>= 1) {
    c += __shfl_xor_sync(FULL, c, off);
    x += __shfl_xor_sync(FULL, x, off);
    y += __shfl_xor_sync(FULL, y, off);
    z += __shfl_xor_sync(FULL, z, off);
  }
  if (lane == 0) {
    const float inv = best < INFINITY ? 1.0f / c : 0.0f;
    best_out[i] = best;
    val_out[3 * i] = x * inv;
    val_out[3 * i + 1] = y * inv;
    val_out[3 * i + 2] = z * inv;
  }
}

int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// `stream` is a cudaStream_t.  Each returns cudaGetLastError() after the
// launch (0 = launched).  Pack widths must be multiples of 512.
extern "C" int density_flash_launch(const void* pos, const void* aux,
                                    const void* val, int w, const void* qp,
                                    const void* qn, const void* r2, int n,
                                    void* flux, void* cnt, void* stream) {
  if (w < 0 || w % BP != 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    density_flash_kernel<<<blocks_for(n), THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const float*)pos, (const float*)aux, (const float*)val, w,
        (const float*)qp, (const float*)qn, (const float*)r2, n,
        (float*)flux, (float*)cnt);
  }
  return (int)cudaGetLastError();
}

extern "C" int nearest_flash_launch(const void* pos, const void* val, int w,
                                    const void* qp, const void* r2, int n,
                                    void* best, void* val_out,
                                    void* stream) {
  if (w < 0 || w % BP != 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    nearest_flash_kernel<<<blocks_for(n), THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const float*)pos, (const float*)val, w, (const float*)qp,
        (const float*)r2, n, (float*)best, (float*)val_out);
  }
  return (int)cudaGetLastError();
}

// Sorted pack: tbl (16, w) with rows 0:3 pos, 6:9 value, 9 the photon's
// original 512-photon block; cl_lo / cl_hi (n_cl, 3) the cluster boxes.
extern "C" int nearest_culled_launch(const void* tbl, int w,
                                     const void* cl_lo, const void* cl_hi,
                                     int n_cl, const void* qp, const void* r2,
                                     int n, void* best, void* val_out,
                                     void* stream) {
  if (w < 0 || w != n_cl * BP || n < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int blocks = (n + QUERIES_PER_CTA - 1) / QUERIES_PER_CTA;
    nearest_culled_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)tbl, w, (const float*)cl_lo, (const float*)cl_hi, n_cl,
        (const float*)qp, (const float*)r2, n, (float*)best,
        (float*)val_out);
  }
  return (int)cudaGetLastError();
}

// Sorted pack as for nearest_culled_launch (rows 3:6 dir read too).
extern "C" int density_sorted_launch(const void* tbl, int w,
                                     const void* cl_lo, const void* cl_hi,
                                     int n_cl, const void* qp,
                                     const void* qn, const void* r2, int n,
                                     void* flux, void* cnt, void* stream) {
  if (w < 0 || w != n_cl * BP || n < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int blocks = (n + QUERIES_PER_CTA - 1) / QUERIES_PER_CTA;
    density_sorted_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)tbl, w, (const float*)cl_lo, (const float*)cl_hi, n_cl,
        (const float*)qp, (const float*)qn, (const float*)r2, n,
        (float*)flux, (float*)cnt);
  }
  return (int)cudaGetLastError();
}

// Sorted pack as for density_sorted_launch; perm (n,) int64 the queries in
// the pack's Morton order (a permutation of 0..n-1); wbox
// (ceil(n_cl / 32), 6) float the union box of each 32 clusters.  tbl must
// be 16-byte aligned (the stages copy 16 bytes at a time).
extern "C" int density_culled_launch(const void* tbl, int w,
                                     const void* cl_lo, const void* cl_hi,
                                     int n_cl, const void* qp,
                                     const void* qn, const void* r2,
                                     const void* perm, const void* wbox,
                                     int n, void* flux, void* cnt,
                                     void* stream) {
  if (w < 0 || w != n_cl * BP || n < 0 || (size_t)tbl % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    const int blocks = (n + CULL_QUERIES - 1) / CULL_QUERIES;
    density_culled_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)tbl, w, (const float*)cl_lo, (const float*)cl_hi, n_cl,
        (const float*)qp, (const float*)qn, (const float*)r2,
        (const long long*)perm, (const float*)wbox, n, (float*)flux,
        (float*)cnt);
  }
  return (int)cudaGetLastError();
}

// The body density_culled_kernel replaced, on queries already sorted, blk
// (ceil(n / 256), 8) each 256-query block's query box and largest r2.
extern "C" int density_culled_before_launch(const void* tbl, int w,
                                            const void* cl_lo,
                                            const void* cl_hi, int n_cl,
                                            const void* qp, const void* qn,
                                            const void* r2, const void* blk,
                                            int n, void* flux, void* cnt,
                                            void* stream) {
  if (w < 0 || w != n_cl * BP || n < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    density_culled_before_kernel<<<blocks_for(n), THREADS, 0,
                                   (cudaStream_t)stream>>>(
        (const float*)tbl, w, (const float*)cl_lo, (const float*)cl_hi, n_cl,
        (const float*)qp, (const float*)qn, (const float*)r2,
        (const float*)blk, n, (float*)flux, (float*)cnt);
  }
  return (int)cudaGetLastError();
}
