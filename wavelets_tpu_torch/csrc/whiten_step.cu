// One WOW scale on the card: chain smooth, detail, power smooth, mask,
// whiten, accumulate.  Plain C interface, loaded with ctypes
// (wavelets_tpu_torch/ops/_build.py); wrapper in ops/hopper_conv.py.
//
// Replaces the per-scale step of two TPU kernels, which compute the same
// thing and differ only in how they fit the TPU's VMEM:
//   wavelets_tpu/ops/pallas_conv.py::_fused_wow_group (_make_kernel,
//     whiten=...), g scales per launch on halo'd tiles;
//   wavelets_tpu/ops/pallas_deep.py::deep_whiten_step (_make_stream_kernel
//     / _make_deep_kernel), one deep scale per launch on row streams.
// The TPU kernels' nine-window tiles, residue-class streams and MXU
// mirrors exist because Mosaic has no `rev` and VMEM windows are tiled;
// none of that carries over.
//
// Design.  One separable dilated 1-D pass kernel, templated on its axis,
// prologue and epilogue, launched four times per scale at dilation D:
//   1. rows pass on the carry                      -> tmp
//   2. cols pass on tmp, epilogue: c_next, detail = carry - c_next
//   3. rows pass on detail^2 (squared on load)     -> tmp
//   4. cols pass on tmp, epilogue: lp = sqrt(max(lp, 1e-15) rule),
//      mask (erf or hard, threshold 0 = no mask), white = wc*(fac/lp),
//      optional white write, optional acc (set or +=).
// Each thread owns one output pixel and reads its taps at stride D
// through the periodic symmetric index map (numpy's 'symmetric' pad for
// any width), so any H, W and D work: no W%128, H%2^s or single-bounce
// gates.  Offsets are 64-bit.  The folds, index map and epilogue (pass 4,
// wt::cols_whiten) are shared with kernels C, D and G (wt_common.cuh).
//
// Bound: by design device memory.  A scale moves about 11 images (reads:
// carry x2, tmp x2, detail x2, acc; writes: tmp x2, c_next, detail,
// white, acc), 0.74 GB at 4096^2, and the 5-tap folds are a few FLOPs per
// byte.  Threads of a warp cover neighbouring columns, so every tap read
// is coalesced, and the dilated row reads of passes 1/3 hit L2 for the
// shallow scales.  Measured on an H100 80GB HBM3 (700 W): 1.02-1.26 ms
// per scale at 4096^2, about 0.7 TB/s, so the passes are still bound by
// per-pixel instruction latency (64-bit index math, five dependent loads
// per output), not by the bytes.  Fusing passes into shared-memory tiles
// is later work.
//
// Rounding.  The folds round step by step in the JAX package's order
// (wt_common.cuh), so c_next and the detail are bitwise equal to the
// plain PyTorch version on the same card.  The epilogue uses IEEE sqrt
// and division; erff may differ from torch.erf in the last place, which
// bounds |white - plain| well inside 5e-6*max.

#include "wt_common.cuh"

namespace {

using wt::Taps;

__global__ void cols_detail(const float* __restrict__ tmp,
                            const float* __restrict__ carry,
                            float* __restrict__ c_next,
                            float* __restrict__ detail, Taps taps,
                            long long B, long long H, long long W,
                            long long D) {
  WT_FOR_EACH_PIXEL {
    long long row = (b * H + h) * W, i = row + w;
    float cn = wt::fold_cols(tmp + row, taps, w, W, D);
    c_next[i] = cn;
    detail[i] = __fsub_rn(carry[i], cn);
  }
}

}  // namespace

extern "C" {

const char* wt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One scale at dilation D on a (B, H, W) float32 stack, all pointers on
// the device and contiguous.  tmp and detail are scratch of the same
// size; white and acc may be null (acc_mode 0 = none, 1 = acc = white,
// 2 = acc += white).  thr points at B per-frame thresholds (read only
// when masked).  taps: n_taps symmetric host-side weights.  Returns
// cudaGetLastError() after the first failing launch, or 0.
int wt_whiten_step_f32(const float* carry, float* c_next, float* detail,
                       float* tmp, float* white, float* acc, int acc_mode,
                       const float* thr, float fac, int masked, int soft,
                       const double* taps, int n_taps, long long B,
                       long long H, long long W, long long D,
                       void* stream) {
  Taps tp;
  if (!wt::make_taps(taps, n_taps, &tp) || B < 1 || H < 1 || W < 1 ||
      D < 1 || (acc_mode != 0 && !acc) || (masked && !thr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 block(256);
  dim3 grid = wt::pixel_grid(B, H, W, block);
  wt::rows_pass<false><<<grid, block, 0, s>>>(carry, tmp, tp, B, H, W, D);
  WT_CHECK_LAUNCH();
  cols_detail<<<grid, block, 0, s>>>(tmp, carry, c_next, detail, tp, B, H, W, D);
  WT_CHECK_LAUNCH();
  wt::rows_pass<true><<<grid, block, 0, s>>>(detail, tmp, tp, B, H, W, D);
  WT_CHECK_LAUNCH();
  wt::cols_whiten<<<grid, block, 0, s>>>(tmp, detail, white, acc, acc_mode,
                                         thr, fac, masked, soft, tp, B, H, W,
                                         D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
