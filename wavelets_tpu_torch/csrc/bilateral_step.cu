// One deep bilateral WOW scale on the card (kernel G): bilateral chain
// smooth, detail, power smooth, mask, whiten.  Plain C interface, loaded
// with ctypes (wavelets_tpu_torch/ops/_build.py); wrapper in
// ops/hopper_deep.py (deep_bilateral_whiten_step).
//
// Replaces wavelets_tpu/ops/pallas_deep.py::deep_bilateral_whiten_step
// (_make_bilateral_stream_kernel): the deferred-tail scales of bilateral
// WOW, one scale per launch from the carry, on residue-class row streams
// through VMEM rings.  The stream geometry, its gates (W % 128, Rc >= 32,
// single-bounce reflection, H % D) and the per-row regrouping of the tap
// sums exist for VMEM; none of that carries over.
//
// Design.  Five launches at dilation D:
//   1-3. the bilateral chain smooth of wt_bilateral.cuh (rows_moments,
//        cols_range, bilateral_taps) -> c_next, detail = carry - c_next;
//   4.   kernel A's power-smooth rows pass on detail^2 (squared on load);
//   5.   kernel A's cols pass with the whitening epilogue (wt::cols_whiten:
//        lp = sqrt(max-rule), erf or hard mask, white = wc*(fac/lp),
//        optional white write, optional recon += white).
// Any H, W and dilation work through the periodic symmetric index map.
// Scratch: tm, tq (tm again for pass 4) and detail, which also carries
// inv2v between passes 2 and 3.
//
// Bound: by design float32 operations: the bilateral smooth's ~210
// operations per pixel plus 24 expf, then the power smooth and epilogue
// (~35); the function reads the carry once and writes c_next and white
// (0.20 GB at 4096^2: 0.06 ms at 3.35 TB/s) against about 0.11 ms of
// operations at 67 TFLOP/s.  The design moves about 15 images.
//
// Rounding.  The JAX package's XLA order (_smooth_step, then the
// power smooth and whitening of models/wow.py::_deep_tail_scales), one
// IEEE operation per step, so c_next differs from the plain PyTorch
// version on the same card at most through expf, and white also through
// erff.

#include "wt_bilateral.cuh"

extern "C" {

const char* wt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One scale at dilation D on a (B, H, W) float32 stack, all pointers on
// the device and contiguous.  detail, tm and tq are scratch of the same
// size; white and acc may be null (acc_mode 0 = none, 2 = acc += white).
// thr points at B per-frame thresholds (read only when masked).
// sig2 = sigma_b[s]^2, scl = s+1 under bilateral scaling, else 1.
// taps: n_taps symmetric host-side weights; kern: their dense outer
// product.  Returns cudaGetLastError() after the first failing launch,
// or 0.
int wt_bilateral_step_f32(const float* carry, float* c_next, float* detail,
                          float* tm, float* tq, float* white, float* acc,
                          int acc_mode, const float* thr, float fac,
                          int masked, int soft, float sig2, float scl,
                          const double* taps, int n_taps, const double* kern,
                          long long B, long long H, long long W, long long D,
                          void* stream) {
  wt::Taps tp;
  wt::BilKernel bk;
  if (!wt::make_taps(taps, n_taps, &tp) ||
      !wt::make_bil_kernel(kern, tp.hw, &bk) || !carry || !c_next ||
      !detail || !tm || !tq || B < 1 || H < 1 || W < 1 || D < 1 ||
      (acc_mode != 0 && acc_mode != 2) || (acc_mode != 0 && !acc) ||
      (masked && !thr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = wt::bilateral_scale(carry, c_next, detail, tm, tq, sig2,
                                        scl, tp, bk, B, H, W, D, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 block(256);
  dim3 grid = wt::pixel_grid(B, H, W, block);
  wt::rows_pass<true><<<grid, block, 0, s>>>(detail, tm, tp, B, H, W, D);
  WT_CHECK_LAUNCH();
  wt::cols_whiten<<<grid, block, 0, s>>>(tm, detail, white, acc, acc_mode,
                                         thr, fac, masked, soft, tp, B, H, W,
                                         D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
