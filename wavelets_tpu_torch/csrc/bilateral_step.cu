// One deep bilateral WOW scale on the card (kernel G): bilateral chain
// smooth, detail, power smooth, mask, whiten.  Plain C interface, loaded
// with ctypes (wavelets_tpu_torch/ops/_build.py); wrapper and launch
// plans in ops/hopper_deep.py (deep_bilateral_whiten_step), ops/
// hopper_bilateral.py (bilateral_plan) and ops/hopper_conv.py
// (step_plan).
//
// Replaces wavelets_tpu/ops/pallas_deep.py::deep_bilateral_whiten_step
// (_make_bilateral_stream_kernel): the deferred-tail scales of bilateral
// WOW, one scale per launch from the carry, on residue-class row streams
// through VMEM rings.  The stream geometry, its gates (W % 128, Rc >= 32,
// single-bounce reflection, H % D) and the per-row regrouping of the tap
// sums exist for VMEM; none of that carries over.
//
// Design.  Two launches at dilation D:
//   1. kernel F's ring (wt_ring.cuh), one scale: a block walks a chunk of
//      the output rows of one residue class with the 2hw+1 carry rows of
//      the taps as a ring in shared memory, folds the moments, keeps the
//      range factor in a register and runs the (2hw+1)^2 - 1 taps from
//      the ring -> c_next and detail = carry - c_next;
//   2. the SECOND pass of wt_step.cuh, kernel A's deep-step row buffer:
//      rows fold of detail^2 into shared memory, cols fold -> lp, the
//      whitening epilogue (wt::whiten_value: lp = sqrt(max-rule), erf or
//      hard mask, white = wc*(fac/lp)), optional white write, optional
//      recon += white; blocks in residue-class row order.
// The carry is read once, c_next and the detail written once, the detail
// read once more: one scratch plane (detail) against three (tm, tq and
// detail/inv2v) and about 15 plane moves in five per-pixel launches
// before.  Both launches take any H, W and dilation (map_step) and
// batches past 65535 frames as several launches.
//
// Bound: by design float32 operations: the bilateral smooth's ~210
// operations per pixel plus 24 expf, then the power smooth and epilogue
// (~35); the function reads the carry once and writes c_next and white
// (0.20 GB at 4096^2: 0.06 ms at 3.35 TB/s) against about 0.11 ms of
// operations at 67 TFLOP/s.  Measured on an H100 80GB HBM3 at 700 W
// (scripts/kernel_variants.py, device time at 4096^2): 0.480-0.553 ms a
// scale for s = 3..9, the ring 0.340-0.400 and the second pass
// 0.139-0.152 of it; the five per-pixel launches took 1.724-2.397.
//
// Rounding.  The JAX package's XLA order (_smooth_step, then the power
// smooth and whitening of models/wow.py::_deep_tail_scales), one IEEE
// operation per step, so c_next differs from the plain PyTorch version on
// the same card at most through expf, and white also through erff.
// c_next, white and recon are bitwise those of the earlier five-launch
// body, kept as the check-only entry wt_bilateral_step_ref_f32 (the
// three passes of wt_bilateral.cuh, then wt_common.cuh's rows_pass and
// cols_whiten): an independent reference for kernels F and G on the
// card, which no path calls.

#include "wt_ring.cuh"
#include "wt_step.cuh"

extern "C" {

const char* wt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One scale at dilation D (any, up to 2^62) on a (B, H, W) float32
// stack, all pointers on the device and contiguous.  detail is scratch
// of the same size; white and acc may be null (acc_mode 0 = none, 2 =
// acc += white).  thr points at B per-frame thresholds (read only when
// masked).  sig2 = sigma_b[s]^2, scl = s+1 under bilateral scaling, else
// 1.  taps: n_taps symmetric host-side weights; kern: their dense outer
// product.  The launches are the wrapper's plans, a launch each per
// `frames` consecutive frames: the ring's (ring_rows output rows of a
// residue class per block, segments of ring_seg columns, ring_grid_x x
// ring_grid_y blocks, ring_smem bytes) and the second pass's (seg,
// grid_rows x grid_segs blocks, smem_bytes), with index_bits (32 or 64)
// wide offsets.  Returns cudaErrorInvalidValue for arguments or a plan
// the kernels do not take, else cudaGetLastError() after the first
// failing launch, or 0.
int wt_bilateral_step_f32(const float* carry, float* c_next, float* detail,
                          float* white, float* acc, int acc_mode,
                          const float* thr, float fac, int masked, int soft,
                          float sig2, float scl, const double* taps,
                          int n_taps, const double* kern, long long B,
                          long long H, long long W, long long D,
                          long long ring_rows, long long ring_seg,
                          long long ring_grid_x, long long ring_grid_y,
                          long long ring_smem, long long seg,
                          long long grid_rows, long long grid_segs,
                          long long smem_bytes, long long frames,
                          int index_bits, void* stream) {
  wt::RingArgs r;
  wt::StepArgs a = {};
  const wt::RingPlan rp = {ring_rows, ring_seg, ring_grid_x, ring_grid_y,
                           ring_smem};
  const wt::StepPlan p = {seg, grid_rows, grid_segs, frames, smem_bytes,
                          index_bits};
  if (!wt::make_taps(taps, n_taps, &r.taps) ||
      !wt::make_bil_kernel(kern, r.taps.hw, &r.kern) || !carry || !c_next ||
      !detail || (acc_mode != 0 && acc_mode != 2) || (acc_mode != 0 && !acc) ||
      (masked && !thr) || !wt::step_plan_ok(p, r.taps.hw, B, H, W, D) ||
      !wt::ring_plan_ok(rp, r.taps.hw, H, W, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 1. the ring: c_next and the detail
  r.sig2 = sig2;
  r.scl = scl;
  r.H = static_cast<int>(H);
  r.W = static_cast<int>(W);
  r.D = static_cast<int>(wt::map_step(D, H));
  r.Dc = static_cast<int>(wt::map_step(D, W));
  r.rows = static_cast<int>(ring_rows);
  r.seg = static_cast<int>(ring_seg);
  r.n_cls = static_cast<int>(D < H ? D : H);
  for (long long b0 = 0; b0 < B; b0 += frames) {
    const long long off = b0 * H * W;
    r.src = carry + off;
    r.c_next = c_next + off;
    r.detail = detail + off;
    const dim3 grid(static_cast<unsigned>(ring_grid_x),
                    static_cast<unsigned>(ring_grid_y),
                    static_cast<unsigned>(B - b0 < frames ? B - b0 : frames));
    const int err = wt::run_bilateral_ring(
        r, grid, static_cast<int>(ring_smem), index_bits == 32, s);
    if (err) return err;
  }
  // 2. the power smooth of detail^2 and the whitening
  a.detail = detail;
  a.white = white;
  a.acc = acc;
  a.thr = thr;
  a.fac = fac;
  a.acc_mode = acc_mode;
  a.masked = masked;
  a.soft = soft;
  a.H = static_cast<int>(H);
  a.W = static_cast<int>(W);
  a.taps = r.taps;
  return wt::run_step_pass<true>(a, p, B, D, s);
}

// Check-only: the earlier five-launch body of one scale, each thread one
// output pixel, every tap through the symmetric index map in 64-bit
// arithmetic: wt_bilateral.cuh's rows_moments, cols_range and
// bilateral_taps (c_next, detail = carry - c_next), then rows_pass<true>
// and cols_whiten.  detail, tm and tq are scratch of the carry's size;
// the other arguments are those of wt_bilateral_step_f32.  Returns
// cudaGetLastError() after the first failing launch, or 0.
int wt_bilateral_step_ref_f32(const float* carry, float* c_next,
                              float* detail, float* tm, float* tq,
                              float* white, float* acc, int acc_mode,
                              const float* thr, float fac, int masked,
                              int soft, float sig2, float scl,
                              const double* taps, int n_taps,
                              const double* kern, long long B, long long H,
                              long long W, long long D, void* stream) {
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
