// Whitening of one given detail plane on the card (kernel D): power
// smooth, mask, runtime factor, partial reconstruction and the gamma sum.
// Plain C interface, loaded with ctypes (wavelets_tpu_torch/ops/_build.py);
// wrappers in ops/hopper_wow.py (fused_whiten_pieces) and
// ops/hopper_deep.py (deep_whiten_plane).
//
// Replaces two TPU kernels that whiten materialized planes and differ only
// in how they fit the TPU's VMEM, as kernel A serves the two chained ones:
//   wavelets_tpu/ops/pallas_wow.py::fused_whiten_pieces
//     (_make_whiten_kernel), scales 0..n-1 of decompose pieces on halo'd
//     tiles with a (scale, frame) factor table, partial recon and gamma;
//   wavelets_tpu/ops/pallas_deep.py::deep_whiten_plane
//     (_make_plane_kernel), one deep plane on residue-class row streams.
//
// Design.  One launch pair per scale at dilation D, sharing kernel A's
// passes and epilogue (wt_common.cuh):
//   1. rows pass on c^2 (squared on load)             -> tmp
//   2. cols pass on tmp, epilogue: lp = sqrt(max-rule), mask (erf or hard,
//      threshold 0 = none), white = wc*(fac/lp); then the optional white
//      write, the partial recon (set or +=) and the optional gamma sum of
//      the masked, unwhitened wc (set or +=).
// The factor and the threshold are read per frame from device memory
// (fac[b], thr[b]), so preserve_variance's w*sqrt(mean(c^2)) and the
// noise estimate never make a host round trip.  Scale by scale the
// wrapper sets recon and gamma at the first scale and adds the later
// ones in order, the JAX kernel's accumulation order.
//
// Bound: by design device memory.  Per scale the function must read the
// plane (and recon, gamma when it adds) and write white, recon and gamma;
// the design moves 4 images more (tmp written once, read five times
// mostly from L2, the plane read twice).  Keeping the power smooth in a
// shared-memory tile is later work.
//
// Rounding.  The power smooth rounds step by step in the JAX package's
// order; the epilogue uses IEEE sqrt and division; erff may differ from
// torch.erf in the last place, inside the 5e-6*max standard.

#include "wt_common.cuh"

namespace {

using wt::Taps;

__global__ void cols_whiten_plane(const float* __restrict__ tmp,
                                  const float* __restrict__ plane,
                                  float* __restrict__ white,
                                  float* __restrict__ recon, int recon_mode,
                                  float* __restrict__ gamma, int gamma_mode,
                                  const float* __restrict__ fac,
                                  const float* __restrict__ thr, int soft,
                                  Taps taps, long long B, long long H,
                                  long long W, long long D) {
  WT_FOR_EACH_PIXEL {
    long long row = (b * H + h) * W, i = row + w;
    float wc;
    float v = wt::whiten_value(plane[i],
                               wt::fold_cols(tmp + row, taps, w, W, D),
                               fac[b], thr ? thr + b : nullptr, soft, &wc);
    if (white) white[i] = v;
    if (recon_mode == 1) recon[i] = v;
    else if (recon_mode == 2) recon[i] = __fadd_rn(recon[i], v);
    if (gamma_mode == 1) gamma[i] = wc;
    else if (gamma_mode == 2) gamma[i] = __fadd_rn(gamma[i], wc);
  }
}

}  // namespace

extern "C" {

const char* wt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Whiten the contiguous (B, H, W) float32 detail plane at dilation D.
// tmp: (B, H, W) scratch.  white, recon, gamma: (B, H, W) or null;
// recon_mode / gamma_mode 0 = none, 1 = set, 2 = +=.  fac: B per-frame
// factors on the device; thr: B per-frame thresholds on the device, or
// null for no mask.  taps: n_taps symmetric host-side weights.  Returns
// cudaGetLastError() after the first failing launch, or 0.
int wt_whiten_plane_f32(const float* plane, float* tmp, float* white,
                        float* recon, int recon_mode, float* gamma,
                        int gamma_mode, const float* fac, const float* thr,
                        int soft, const double* taps, int n_taps, long long B,
                        long long H, long long W, long long D, void* stream) {
  Taps tp;
  if (!wt::make_taps(taps, n_taps, &tp) || !plane || !tmp || !fac ||
      B < 1 || H < 1 || W < 1 || D < 1 || (recon_mode != 0 && !recon) ||
      (gamma_mode != 0 && !gamma))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 block(256);
  dim3 grid = wt::pixel_grid(B, H, W, block);
  wt::rows_pass<true><<<grid, block, 0, s>>>(plane, tmp, tp, B, H, W, D);
  WT_CHECK_LAUNCH();
  cols_whiten_plane<<<grid, block, 0, s>>>(tmp, plane, white, recon,
                                           recon_mode, gamma, gamma_mode,
                                           fac, thr, soft, tp, B, H, W, D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
