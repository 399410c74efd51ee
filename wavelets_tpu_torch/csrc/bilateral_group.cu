// Bilateral à trous decomposition of a group of g scales on the card
// (kernel F).  Plain C interface, loaded with ctypes
// (wavelets_tpu_torch/ops/_build.py); wrapper and launch plan in
// ops/hopper_bilateral.py (fused_bilateral_group, bilateral_plan).
//
// Replaces wavelets_tpu/ops/pallas_bilateral.py::_fused_group
// (_make_kernel): per scale the local variance (two separable smooths of
// x and x^2), the range factor, the (k^2-1)-tap range-weighted smooth with
// its normalizer and the detail, the carry chained, on halo'd VMEM tiles.
// The TPU kernel's tile planner, exact-matmul border flips and row strips
// exist for VMEM and Mosaic; none of that carries over.
//
// Design.  One launch per scale at dilation D = 2^(offset+k): the ring
// kernel of wt_ring.cuh.  A block walks a chunk of the output rows of one
// residue class mod D with the 2hw+1 carry rows of the taps as a ring in
// shared memory (one new row a step, cp.async), folds the moments, keeps
// the range factor in a register and runs the taps from the ring, so only
// c_next and the detail reach device memory: about one plane read and two
// written a scale, against ten planes in three launches before (tm and
// tq, then inv2v, then the taps).  The taps' half width (1..4) is a
// template parameter of every fold, moments included; offsets are 32-bit
// where B*H*W < 2^31.  Columns come in segments (whole rows where they
// fit) laid out so that every tap is a plain offset at any dilation
// (wt_ring.cuh), so any H, W and dilation work and there is no route back
// to the three passes; a dilation past the symmetric map's period is
// taken modulo it (wt_tile.cuh::map_step), so any scale up to 2^62 runs.
// The taps read neighbours of the carry across blocks, so c_next cannot
// overwrite it: two carry buffers (the output cube's carry row and one
// spare plane) alternate, chosen so that the last scale lands in the
// carry row.
//
// Bound: float32 instruction issue and the special-function pipe, not
// bytes.  A pixel and scale costs about 340 non-contracted float32
// operations (folds, range factor, 24 taps of 7 operations, the accurate
// expf's range reduction) and 24 ex2 on the special-function pipe; the
// function reads x once and writes g+1 planes (0.34 GB at 4096^2, g = 3:
// 0.10 ms at 3.35 TB/s).  At the 67 TFLOP/s peak, which counts an FMA as
// two, the operations take 0.30 ms a group of 3; one-operation-per-step
// code issues at about half that, so the floor is nearer 0.5-0.6 ms.
// Measured on an H100 80GB HBM3 at 700 W: 1.026-1.032 ms of device time
// a group of 3 at 4096^2, offsets 0 and 3 (scripts/kernel_variants.py;
// the three-pass design: 3.67 ms by chip_smoke.py's profile).
//
// Launch.  Rows per chunk, segment width, grid, shared-memory bytes and
// offset width are the wrapper's plan per scale (bilateral_plan), checked
// here and launched as given.

#include "wt_ring.cuh"

extern "C" {

const char* wt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// g bilateral scales at dilations 2^(offset+k) (offset + g <= 63) of a
// contiguous (B, H, W) float32 stack x on the device.  out is the
// contiguous (g+1, B, H, W) cube (detail planes, then the carry); spare
// is a (B, H, W) scratch plane.  sig2[k] = sigma_b[offset+k]^2 and scl[k] (offset+k+1 under
// bilateral scaling, else 1) are g host floats; taps: n_taps symmetric
// host-side weights; kern: their dense (n_taps, n_taps) outer product.
// The launch of scale k is the wrapper's plan: rows[k] output rows of a
// residue class per block, segments of seg[k] columns, grid_x[k] x
// grid_y[k] x B blocks, smem[k] bytes of shared memory, index_bits (32 or
// 64) wide offsets.  Returns cudaErrorInvalidValue for arguments or a plan
// the kernel does not take, else cudaGetLastError() after the first
// failing launch, or 0.
int wt_bilateral_group_f32(const float* x, float* out, float* spare, int g,
                           int offset, const float* sig2, const float* scl,
                           const double* taps, int n_taps, const double* kern,
                           long long B, long long H, long long W,
                           const long long* rows, const long long* seg,
                           const long long* grid_x, const long long* grid_y,
                           const long long* smem, int index_bits,
                           void* stream) {
  wt::RingArgs a;
  if (!wt::make_taps(taps, n_taps, &a.taps) ||
      !wt::make_bil_kernel(kern, a.taps.hw, &a.kern) || !x || !out ||
      !spare || !sig2 || !scl || !rows || !seg || !grid_x || !grid_y ||
      !smem || g < 1 || offset < 0 || offset + g > 63 || B < 1 ||
      B > 65535 || H < 1 || W < 1 || H >= (1ll << 30) || W >= (1ll << 30) ||
      !(index_bits == 64 || (index_bits == 32 && B * H * W < (1ll << 31))))
    return static_cast<int>(cudaErrorInvalidValue);
  // the plans (wt::ring_plan_ok)
  for (int k = 0; k < g; ++k) {
    const wt::RingPlan p = {rows[k], seg[k], grid_x[k], grid_y[k], smem[k]};
    if (!wt::ring_plan_ok(p, a.taps.hw, H, W, 1ll << (offset + k)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plane = B * H * W;
  float* carry = out + g * plane;
  a.src = x;
  a.H = static_cast<int>(H);
  a.W = static_cast<int>(W);
  for (int k = 0; k < g; ++k) {
    const long long D = 1ll << (offset + k);
    a.c_next = (g - 1 - k) % 2 == 0 ? carry : spare;
    a.detail = out + k * plane;
    a.sig2 = sig2[k];
    a.scl = scl[k];
    a.D = static_cast<int>(wt::map_step(D, H));
    a.Dc = static_cast<int>(wt::map_step(D, W));
    a.rows = static_cast<int>(rows[k]);
    a.seg = static_cast<int>(seg[k]);
    a.n_cls = static_cast<int>(D < H ? D : H);
    dim3 grid(static_cast<unsigned>(grid_x[k]),
              static_cast<unsigned>(grid_y[k]), static_cast<unsigned>(B));
    int err = wt::run_bilateral_ring(a, grid, static_cast<int>(smem[k]),
                                     index_bits == 32, s);
    if (err) return err;
    a.src = a.c_next;
  }
  return 0;
}

}  // extern "C"
