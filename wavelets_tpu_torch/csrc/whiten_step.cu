// One WOW scale on the card (kernel A, deep form): chain smooth, detail,
// power smooth, mask, whiten, accumulate, in two launches.  Plain C
// interface, loaded with ctypes (wavelets_tpu_torch/ops/_build.py);
// wrapper and host-side plan in ops/hopper_conv.py (launch_whiten_step,
// step_plan), called by ops/hopper_deep.py::deep_whiten_step.
//
// Replaces wavelets_tpu/ops/pallas_deep.py::deep_whiten_step
// (_make_stream_kernel / _make_deep_kernel), one deep scale per launch on
// row streams.  The TPU kernel's residue-class streams and MXU mirrors
// exist because Mosaic has no `rev` and VMEM windows are tiled; none of
// that carries over.  (The shallow group, pallas_conv._fused_wow_group,
// is whiten_group.cu; this kernel runs its scales only where no group
// tile fits the shared memory.)
//
// Design.  Two launches of wt_step.cuh's row-buffer pass at dilation D:
//   launch 1 (FIRST): rows fold of the carry, cols fold -> c_next,
//             detail = carry - c_next;
//   launch 2 (SECOND): rows fold of detail^2, cols fold -> lp, the
//             whitening epilogue (wt::whiten_value) -> white (optional),
//             acc (set, += or none).
// Each folds a row into a shared-memory row buffer, with the raw centre
// row beside it, and the cols fold out of it, blocks in residue-class
// row order (wt_step.cuh).  So the rows-pass scratch plane of the
// earlier four launches (tmp) never reaches device memory: a scale moves
// about 7 planes (reads: carry, detail, acc; writes: c_next, detail,
// white, acc) in 2 launches against 11 in 4.  Kernels C
// (decompose_group.cu) and G (bilateral_step.cu) launch the same pass.
//
// Bound: device memory, 5 planes by the function's bytes (read carry and
// acc, write white, c_next and acc: 0.100 ms at 4096^2); the detail
// plane between the launches adds 2, 0.140 ms for the 7.  Measured on an
// H100 80GB HBM3 at 700 W: 0.29-0.36 ms per scale at 4096^2 for
// s = 0..9 around the call (chip_smoke.py), 0.21-0.23 ms of device time
// (scripts/kernel_variants.py), flat in the dilation (the earlier four
// launches: 1.03-1.19 ms); 0.43-0.48 ms of device time with the taps at
// run time, a loop over the Taps argument that the compiler copies to
// local memory.
//
// Rounding.  The folds round step by step in the JAX package's order,
// as wt_common.cuh's fold_rows/fold_cols, so c_next and the detail are
// bitwise equal to the plain PyTorch version on the same card and to
// the earlier four-launch kernel.  The epilogue uses IEEE sqrt and
// division; erff may differ from torch.erf in the last place, which
// bounds |white - plain| well inside 5e-6*max.
//
// bfloat16.  wt_whiten_step_bf16 is the same two launches on a bfloat16
// carry (the JAX kernel's bfloat16 stream, pallas_deep.py:329-340): the
// folds read the carry as float32, the detail between the launches stays
// float32, and c_next, the white and acc round to bfloat16 on store
// (acc += white: the white rounded first, the sum in float32, one
// rounding, as the JAX package's XLA add of the two planes).
//
// Launch.  Segment width, grid, shared-memory bytes and offset width are
// the wrapper's plan (step_plan), passed in and checked here, so the
// plan the CPU tests hold is the one launched.

#include "wt_step.cuh"

namespace {

// One scale of kernel A's deep form with planes stored as S (float or
// __nv_bfloat16); the detail scratch is float32 for both.
template <class S>
int whiten_step(const S* carry, S* c_next, float* detail, S* white, S* acc,
                int acc_mode, const float* thr, float fac, int masked,
                int soft, const double* taps, int n_taps, long long B,
                long long H, long long W, long long D, long long seg,
                long long grid_rows, long long grid_segs, long long frames,
                long long smem_bytes, int index_bits, void* stream) {
  wt::StepArgsT<S> a = {};
  const wt::StepPlan p = {seg, grid_rows, grid_segs, frames, smem_bytes,
                          index_bits};
  if (!wt::make_taps(taps, n_taps, &a.taps) || !carry || !c_next ||
      !detail || (acc_mode != 0 && !acc) || (masked && !thr) ||
      !wt::step_plan_ok(p, a.taps.hw, B, H, W, D))
    return static_cast<int>(cudaErrorInvalidValue);
  a.carry = carry;
  a.c_next = c_next;
  a.detail = detail;
  a.H = static_cast<int>(H);
  a.W = static_cast<int>(W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = wt::run_step_pass<false>(a, p, B, D, s);
  if (err) return err;
  a.carry = nullptr;
  a.c_next = nullptr;
  a.white = white;
  a.acc = acc;
  a.thr = thr;
  a.fac = fac;
  a.acc_mode = acc_mode;
  a.masked = masked;
  a.soft = soft;
  return wt::run_step_pass<true>(a, p, B, D, s);
}

}  // namespace

extern "C" {

const char* wt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One scale at dilation D (any, up to 2^62) on a (B, H, W) float32
// stack, all pointers on the device and contiguous.  detail is scratch of
// the same size; white and acc may be null (acc_mode 0 = none, 1 = acc =
// white, 2 = acc += white).  thr points at B per-frame thresholds (read
// only when masked).  taps: n_taps symmetric host-side weights.  The
// launch is the wrapper's plan (ops/hopper_conv.py::step_plan), the same
// for both launches: seg (0 for whole rows, else the segment width),
// grid_rows x grid_segs x frames blocks (a launch per `frames`
// consecutive frames), smem_bytes of shared memory, index_bits (32 or 64)
// wide offsets; it is checked (wt::step_plan_ok) and launched as given.
// Returns cudaErrorInvalidValue for arguments or a plan the kernel does
// not take, else cudaGetLastError() after the first failing launch, or 0.
int wt_whiten_step_f32(const float* carry, float* c_next, float* detail,
                       float* white, float* acc, int acc_mode,
                       const float* thr, float fac, int masked, int soft,
                       const double* taps, int n_taps, long long B,
                       long long H, long long W, long long D, long long seg,
                       long long grid_rows, long long grid_segs,
                       long long frames, long long smem_bytes,
                       int index_bits, void* stream) {
  return whiten_step<float>(carry, c_next, detail, white, acc, acc_mode, thr,
                            fac, masked, soft, taps, n_taps, B, H, W, D, seg,
                            grid_rows, grid_segs, frames, smem_bytes,
                            index_bits, stream);
}

// The same scale on a bfloat16 carry: c_next, white and acc bfloat16, the
// detail scratch and the thresholds float32.
int wt_whiten_step_bf16(const __nv_bfloat16* carry, __nv_bfloat16* c_next,
                        float* detail, __nv_bfloat16* white,
                        __nv_bfloat16* acc, int acc_mode, const float* thr,
                        float fac, int masked, int soft, const double* taps,
                        int n_taps, long long B, long long H, long long W,
                        long long D, long long seg, long long grid_rows,
                        long long grid_segs, long long frames,
                        long long smem_bytes, int index_bits, void* stream) {
  return whiten_step<__nv_bfloat16>(
      carry, c_next, detail, white, acc, acc_mode, thr, fac, masked, soft,
      taps, n_taps, B, H, W, D, seg, grid_rows, grid_segs, frames,
      smem_bytes, index_bits, stream);
}

}  // extern "C"
