// The warp-per-ray walk's primitives, shared by closest_fine_kernel
// (fine_intersect.cu) and closest_stream_kernel (cluster_intersect.cu).
//
// A warp owns one ray.  Its lanes hold box entry distances (+inf for a box
// the ray does not enter or one already visited); the walk picks the nearest
// entry with one warp-wide minimum, visits that box, and stops once the next
// entry lies strictly beyond min(tmax, the warp's best t).  Each lane keeps
// the lexicographic minimum (t, column) of its own hits, and the warp's
// answer is the minimum over the lanes: the lowest column wins an exact tie
// whatever order the boxes were visited in.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Floats as unsigned keys of the same order (any sign), for the warp-wide
// integer minimum, and back.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ float warp_min(float f) {
  return unordered(__reduce_min_sync(0xffffffffu, ordered(f)));
}

// The lane holding the warp's smallest `f` (the lowest such lane) and, in
// *m, that value.
__device__ __forceinline__ int warp_argmin(float f, float* m) {
  const unsigned key = ordered(f);
  const unsigned best = __reduce_min_sync(0xffffffffu, key);
  *m = unordered(best);
  return __ffs(__ballot_sync(0xffffffffu, key == best)) - 1;
}

// The lane holding the nearest entry `ent` of the warp (the lowest such
// lane), its entry in *e; -1 if that entry lies beyond `lim` or is +inf (no
// box left that can hold a hit at or before lim).
__device__ __forceinline__ int nearest_within(float ent, float lim, float* e) {
  const int lane = warp_argmin(ent, e);
  return (*e <= lim && *e != INFINITY) ? lane : -1;
}

// A lane's hit at t in column k: kept if it is (t, k)-lexicographically
// below the lane's best (*lt, *lcol).  The walk does not meet the columns
// in rising order, so an equal t keeps the lower column.
__device__ __forceinline__ void keep_nearest(bool hit, float t, int k,
                                             float* lt, int* lcol) {
  if (hit && (t < *lt || (t == *lt && k < *lcol))) {
    *lt = t;
    *lcol = k;
  }
}

// The warp's minimum (t, column) over its lanes' (lt, lcol), in every lane.
__device__ __forceinline__ void warp_nearest(float lt, int lcol, float* t,
                                             int* col) {
  *t = warp_min(lt);
  *col = (int)__reduce_min_sync(0xffffffffu,
                                lt == *t ? (unsigned)lcol : 0x7fffffffu);
}

}  // namespace
