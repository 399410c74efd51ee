// Bilateral à trous decomposition of a group of g scales on the card
// (kernel F).  Plain C interface, loaded with ctypes
// (wavelets_tpu_torch/ops/_build.py); wrapper in ops/hopper_bilateral.py
// (fused_bilateral_group).
//
// Replaces wavelets_tpu/ops/pallas_bilateral.py::_fused_group
// (_make_kernel): per scale the local variance (two separable smooths of
// x and x^2), the range factor, the (k^2-1)-tap range-weighted smooth with
// its normalizer and the detail, the carry chained, on halo'd VMEM tiles.
// The TPU kernel's tile planner, exact-matmul border flips and row strips
// exist for VMEM and Mosaic; none of that carries over.
//
// Design.  Per scale at dilation D = 2^(offset+k), the three launches of
// wt_bilateral.cuh: rows_moments, cols_range, bilateral_taps.  Each
// thread owns one output pixel and reads its taps through numpy's
// periodic symmetric index map, so any H, W and dilation work (at D >=
// H/2 a tap reflects more than once) and no scale is left to a plain
// tail.  The tap pass reads 24 neighbours of the carry, so c_next cannot
// overwrite it in place as in kernel C: two carry buffers (the output
// cube's carry row and one spare plane) alternate, chosen so that the
// last scale lands in the carry row.  inv2v rides in the scale's detail
// row between passes 2 and 3 (the tap pass reads inv2v[i] and writes
// detail[i] at the same pixel only), so the scratch is tm, tq and spare.
//
// Bound: by design float32 operations, not bytes.  A pixel and scale
// costs about 40 operations of folds and range factor and 24 taps of
// 7 operations plus one expf; the function must read x once and write
// g+1 planes (0.34 GB at 4096^2, g = 3: 0.10 ms at 3.35 TB/s), against
// about 0.3 ms of float32 operations at 67 TFLOP/s.  The design moves
// about 10 images per scale (reads: carry twice, tm, tq, inv2v, carry's
// taps through L1/L2; writes: tm, tq, inv2v, c_next, detail), and the
// 24 dilated tap reads per pixel hit L1/L2 (neighbouring threads read
// neighbouring columns).
//
// Rounding.  The JAX package's XLA order, one IEEE operation per step
// (wt_bilateral.cuh), so the result differs from the plain PyTorch version
// on the same card at most through expf.

#include "wt_bilateral.cuh"

extern "C" {

const char* wt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// g bilateral scales at dilations 2^(offset+k) of a contiguous (B, H, W)
// float32 stack x on the device.  out is the contiguous (g+1, B, H, W)
// cube (detail planes, then the carry); tm, tq and spare are (B, H, W)
// scratch planes.  sig2[k] = sigma_b[offset+k]^2 and scl[k] (offset+k+1
// under bilateral scaling, else 1) are g host floats; taps: n_taps
// symmetric host-side weights; kern: their dense (n_taps, n_taps) outer
// product.  Returns cudaGetLastError() after the first failing launch,
// or 0.
int wt_bilateral_group_f32(const float* x, float* out, float* tm, float* tq,
                           float* spare, int g, int offset, const float* sig2,
                           const float* scl, const double* taps, int n_taps,
                           const double* kern, long long B, long long H,
                           long long W, void* stream) {
  wt::Taps tp;
  wt::BilKernel bk;
  if (!wt::make_taps(taps, n_taps, &tp) ||
      !wt::make_bil_kernel(kern, tp.hw, &bk) || !x || !out || !tm || !tq ||
      !spare || !sig2 || !scl || g < 1 || offset < 0 || offset + g > 62 ||
      B < 1 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plane = B * H * W;
  float* carry = out + g * plane;
  const float* src = x;
  for (int k = 0; k < g; ++k) {
    float* dst = (g - 1 - k) % 2 == 0 ? carry : spare;
    cudaError_t err = wt::bilateral_scale(
        src, dst, out + k * plane, tm, tq, sig2[k], scl[k], tp, bk, B, H, W,
        1ll << (offset + k), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}

}  // extern "C"
