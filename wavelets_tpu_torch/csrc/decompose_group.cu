// À trous decomposition of a group of g scales on the card (kernel C).
// Plain C interface, loaded with ctypes (wavelets_tpu_torch/ops/_build.py);
// wrapper in ops/hopper_conv.py (fused_group).
//
// Replaces wavelets_tpu/ops/pallas_conv.py::_fused_group (_make_kernel):
// g chained smooths at dilations 2^offset .. 2^(offset+g-1) on halo'd
// VMEM tiles, emitting the g detail planes and the carry, or only the
// carry with smooth_only (the 3-D volume path's in-plane pass).  The TPU
// kernel's tile planner, nine DMA window variants and MXU mirrors exist
// for VMEM and Mosaic; none of that carries over.
//
// Design.  Per scale, two launches of the separable dilated 1-D passes
// shared with kernel A (wt_common.cuh):
//   1. rows pass on the current carry                 -> tmp
//   2. cols pass on tmp, epilogue: c_next, detail = carry - c_next
//      (no detail with smooth_only).
// Each thread owns one output pixel and reads its taps at stride D through
// numpy's periodic symmetric index map, so any H, W and dilation work and
// no scale is left to a plain tail.  The carry of scale k+1 is written in
// place over the carry of scale k inside the output cube: the cols
// epilogue reads carry[i] and writes c_next[i] at the same pixel only.
// The one scratch plane is tmp.
//
// Bound: by design device memory.  The function must read x once and
// write g+1 planes (0.34 GB at 4096^2, g = 3: about 0.10 ms at
// 3.35 TB/s); the design moves 5 images per scale (reads: carry twice,
// tmp once; writes: tmp, c_next, detail), and the row reads of the
// shallow scales hit L2.  Keeping a group's carries in shared-memory
// tiles (reach hw*2^offset*(2^g-1)) is later work.
//
// Rounding.  The folds round step by step in the JAX package's order
// (wt_common.cuh) and the detail is one IEEE subtraction, so details and
// carry are bitwise equal to the plain PyTorch version on the same card.

#include "wt_common.cuh"

namespace {

using wt::Taps;

// c_next may alias carry (in-place carry update): neither is __restrict__.
__global__ void cols_decompose(const float* __restrict__ tmp,
                               const float* carry, float* c_next,
                               float* __restrict__ detail, Taps taps,
                               long long B, long long H, long long W,
                               long long D) {
  WT_FOR_EACH_PIXEL {
    long long row = (b * H + h) * W, i = row + w;
    float cn = wt::fold_cols(tmp + row, taps, w, W, D);
    if (detail) detail[i] = __fsub_rn(carry[i], cn);
    c_next[i] = cn;
  }
}

}  // namespace

extern "C" {

const char* wt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// g scales at dilations 2^(offset+k) of a contiguous (B, H, W) float32
// stack x on the device.  out is the contiguous (g+1, B, H, W) cube
// (detail planes, then the carry), or (1, B, H, W) with smooth_only (the
// carry only); tmp is a (B, H, W) scratch plane.  taps: n_taps symmetric
// host-side weights.  Returns cudaGetLastError() after the first failing
// launch, or 0.
int wt_decompose_group_f32(const float* x, float* out, float* tmp, int g,
                           int offset, int smooth_only, const double* taps,
                           int n_taps, long long B, long long H, long long W,
                           void* stream) {
  Taps tp;
  if (!wt::make_taps(taps, n_taps, &tp) || !x || !out || !tmp || g < 1 ||
      offset < 0 || offset + g > 62 || B < 1 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 block(256);
  dim3 grid = wt::pixel_grid(B, H, W, block);
  const long long plane = B * H * W;
  float* carry = out + (smooth_only ? 0 : g) * plane;
  for (int k = 0; k < g; ++k) {
    const long long D = 1ll << (offset + k);
    const float* src = k == 0 ? x : carry;
    float* detail = smooth_only ? nullptr : out + k * plane;
    wt::rows_pass<false><<<grid, block, 0, s>>>(src, tmp, tp, B, H, W, D);
    WT_CHECK_LAUNCH();
    cols_decompose<<<grid, block, 0, s>>>(tmp, src, carry, detail, tp, B, H,
                                          W, D);
    WT_CHECK_LAUNCH();
  }
  return 0;
}

}  // extern "C"
