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
// slots of that cluster.  Here one thread owns one slot: it reads its ray
// through the slot's ray id (no gathered copy of the rays) and loops over its
// cluster's real columns in global memory.  The slots arrive sorted by
// cluster (ops/pairs_intersect.py), so the 32 threads of a warp read the same
// column at the same step, one broadcast served from L1 / L2 (the pack is
// 6.6 MB at 164K triangles, well inside the 50 MB L2); a warp diverges only
// where the cluster id changes inside it.
//
// Exactness against the plain versions of ops/pairs_intersect.py: columns
// are visited in rising order with a strict `t < best`, so the lowest column
// wins among equal t; columns past n_tris are padding and are never tested.
// A slot whose ray or cluster id is out of range tests nothing (inf / 0, or a
// zero sum): ids are not checked on the host, where reading them would wait
// for the device.
//
// What bounds it on the H100: FP32 instructions of the Moller-Trumbore tests,
// 45 operations per slot and real column (-fmad=false, IEEE division).  The
// bytes are the pack once, 8 B of ids per slot, the rays once and the
// outputs.  First, untuned version: no shared-memory tile per cluster, no
// sub-cluster box skip inside a slot's cluster, no tensor cores.
//
// Built with -fmad=false and IEEE division, so each operation rounds as the
// plain PyTorch version's float32 op does.

#include <cuda_runtime.h>
#include <math.h>

#define THREADS 256

namespace {

struct Slot {
  float o[3], d[3];
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
    s->o[a] = org[3LL * r + a];
    s->d[a] = dir[3LL * r + a];
  }
  s->k0 = c * bt;
  s->k1 = min(s->k0 + bt, n_tris);
  *ray = r;
  return true;
}

// Moller-Trumbore test of pack column k (row stride w) in the operation
// order of _mt_test_scalar; returns det/barycentric validity, t in *t.
__device__ __forceinline__ bool mt_test(const float* __restrict__ p, int w,
                                        int k, const Slot& r, float* t) {
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
      const bool ok = mt_test(pk.p, pk.w, k, s, &t);
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

__global__ void pairs_shadow_kernel(Pack pk, const float* __restrict__ logf,
                                    int logf_w, const int* __restrict__ sray,
                                    const int* __restrict__ scl, int n_slots,
                                    const float* __restrict__ org,
                                    const float* __restrict__ dir,
                                    const float* __restrict__ dist,
                                    int n_rays, float* __restrict__ lg_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  Slot s;
  int r;
  float lr = 0.0f, lg = 0.0f, lb = 0.0f;
  if (load_slot(sray, scl, i, n_rays, pk.n_cl, pk.bt, pk.n_tris, org, dir,
                &s, &r)) {
    const float lo = (float)5e-4;
    const float hi = dist[r] * (float)(1.0 - 1e-4) - (float)5e-4;
    for (int k = s.k0; k < s.k1; ++k) {
      float t;
      const bool ok = mt_test(pk.p, pk.w, k, s, &t);
      if (ok && t > lo && t < hi) {
        lr += logf[k];
        lg += logf[logf_w + k];
        lb += logf[2 * logf_w + k];
      }
    }
  }
  lg_out[3 * i] = lr;
  lg_out[3 * i + 1] = lg;
  lg_out[3 * i + 2] = lb;
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
    const void* pack, int pack_w, int n_cl, int n_tris, const void* logf,
    int logf_w, const void* sray, const void* scl, int n_slots,
    const void* org, const void* dir, const void* dist, int n_rays,
    void* lg_out, void* stream) {
  const Pack pk{(const float*)pack, pack_w, n_cl,
                n_cl > 0 ? pack_w / n_cl : 0, n_tris};
  if (const int bad = check_pack(pk)) return bad;
  if (logf_w < n_tris || n_slots < 0 || n_rays < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_slots > 0) {
    const int blocks = (n_slots + THREADS - 1) / THREADS;
    pairs_shadow_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        pk, (const float*)logf, logf_w, (const int*)sray, (const int*)scl,
        n_slots, (const float*)org, (const float*)dir, (const float*)dist,
        n_rays, (float*)lg_out);
  }
  return (int)cudaGetLastError();
}
