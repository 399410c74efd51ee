// Device helpers of the shared-memory kernels (whiten_group.cu,
// whiten_pair.cu, wt_step.cuh, wt_ring.cuh): numpy's periodic
// 'symmetric' index map in 32-bit arithmetic with an in-range fast path,
// and 16-byte cp.async copies from device memory into shared memory.
// The folds keep the JAX package's order and rounding (wt_common.cuh):
// x*t_0 first, then t_j*(l + r) added for j = 1 .. hw, every step one
// __fmul_rn/__fadd_rn.
// Host side: the once-per-device shared-memory opt-in of a kernel, and
// the dilation taken modulo the symmetric map's period (map_step).
//
// Variant builds.  scripts/kernel_variants.py compiles these sources with
// -DWT_VARIANT_<NAME> to time a kernel with one part changed or cut out;
// a normal build defines none of them.  Here: RUNTIME_TAPS (the taps'
// half width at run time in every kernel).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "wt_common.cuh"

namespace wt {

// The taps' half width: HW where the kernel is instantiated for it (the
// B3spline's 2, the Triangle's 1), else the runtime value.  With a
// compile-time HW the tap loops unroll and the weights stay in registers;
// a runtime loop index into the Taps argument copies it to local memory
// (scripts/kernel_variants.py on an H100: 0.43-0.48 -> 0.21-0.23 ms of
// device time per deep step at 4096^2).
template <int HW>
__device__ __forceinline__ int half_width(const Taps& t) {
  return HW > 0 ? HW : t.hw;
}

// Run f.template operator()<HW>() with HW = 1, 2 or 0 (any other width).
template <class F>
inline int dispatch_hw(int hw, F f) {
#ifndef WT_VARIANT_RUNTIME_TAPS
  if (hw == 2) return f(std::integral_constant<int, 2>());
  if (hw == 1) return f(std::integral_constant<int, 1>());
#endif
  return f(std::integral_constant<int, 0>());
}

constexpr int kMaxDevices = 16;

// Opt `kernel` in to `bytes` of dynamic shared memory on the current
// device.  `done` is a static of the caller's template instance that
// keeps the largest size opted in per device, so a later launch of the
// same instance skips the driver call (the opt-in only ever grows).
// cudaFuncSetAttribute itself refuses a size beyond the card's limit.
template <class K>
inline cudaError_t smem_optin(K kernel, int bytes, std::atomic<int>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<int>* seen = dev < kMaxDevices ? done + dev : nullptr;
  if (seen && seen->load(std::memory_order_relaxed) >= bytes)
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && seen) {
    int prev = seen->load(std::memory_order_relaxed);
    while (prev < bytes && !seen->compare_exchange_weak(prev, bytes)) {
    }
  }
  return err;
}

// The dilation a kernel takes on an axis of n for a true dilation D: D,
// or from 2n on (the symmetric map's period) 2n + D mod 2n, which names
// the same taps, residue classes and segment layout in 32-bit index math
// (ops/hopper_conv.py::map_step).
__host__ inline long long map_step(long long D, long long n) {
  return D < 2 * n ? D : 2 * n + D % (2 * n);
}

// numpy's symmetric extension of an axis of n points, any k (it may
// reflect several times when n is smaller than the reach).
__device__ __forceinline__ int sym32(int k, int n) {
  if (static_cast<unsigned>(k) < static_cast<unsigned>(n)) return k;
  int p = k % (2 * n);
  if (p < 0) p += 2 * n;
  return p < n ? p : 2 * n - 1 - p;
}

// One 16-byte asynchronous copy global -> shared (both 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

}  // namespace wt
