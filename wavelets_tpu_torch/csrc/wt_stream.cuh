// Device helpers of the residue-class streams (whiten_step.cu's deep step
// and whiten_pair.cu's bfloat16 pair): the block size, cp.async groups, the
// row fetch into a ring slot, and paired loads and stores of float32 or
// bfloat16 elements.

#pragma once

#include <cuda_bf16.h>

#include "wt_tile.cuh"

namespace wt {

// threads a block of either stream
constexpr int kStreamThreads = 512;

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy n elements of a row into dst: element v from column col(v) of the
// row through the symmetric map of an axis of W.  16-byte cp.async where
// the kV elements from v name kV in-frame columns on a 16-byte boundary
// (within one window of `win` elements; a power of two takes a mask, not
// a remainder), else loads and stores.  `elem0` is the row's element
// offset from the 16-byte aligned base.
template <class T, class Col>
__device__ __forceinline__ void fetch_row(T* dst, const T* row,
                                          long long elem0, int n, int W,
                                          int win, bool vec, Col col) {
  constexpr int kV = 16 / sizeof(T);
  const bool pow2 = (win & (win - 1)) == 0;
  for (int v = threadIdx.x * kV; v < n; v += kStreamThreads * kV) {
    const long long c = col(v);
    if (vec && v + kV <= n && c >= 0 && c + kV <= W &&
        ((elem0 + c) & (kV - 1)) == 0 &&
        (pow2 ? (v & (win - 1)) : v % win) + kV <= win) {
      wt::cp_async16(dst + v, row + c);
    } else {
      for (int e = 0; e < kV && v + e < n; ++e)
        dst[v + e] = row[wt::sym_index(col(v + e), W)];
    }
  }
}

// Two consecutive elements as float32 (8-byte or 4-byte aligned).
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Store two consecutive elements (8-byte or 4-byte aligned).
__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace wt
