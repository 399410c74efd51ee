// The bilateral chain smooth one pixel a thread: the dense tap weights
// (BilKernel) that the ring of kernels F and G reads (wt_ring.cuh), and
// the three launches of kernel G's check-only reference entry
// (bilateral_step.cu, wt_bilateral_step_ref_f32), an independent
// reference on the card for the ring's bits.  One scale at dilation D
// is three launches, each thread owning one output pixel:
//   1. rows_moments: the rows folds of x and of x*x        -> tm, tq
//   2. cols_range:   the cols folds of both (mean, m2), then the range
//      factor inv2v = 0.5 / ((max-rule(m2 - mean*mean) * sig2) * scl)
//   3. bilateral_taps<HW>: the dense (2HW+1)^2 - 1 taps at (dy*D, dx*D)
//      through the 2-D symmetric index map, in the reference's order
//      (dy, then dx, each descending; watroo/wavelets.py:89-91), with
//        w = k * expf(-(diff*diff) * inv2v),  nrm += w,  acc += w*sh,
//      then c_next = acc / nrm and detail = carry - c_next.
// The order is that of the JAX package's XLA chain (ops/conv.py
// local_variance and atrous_conv_nd), every step one IEEE operation
// (__fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn, never contracted into an FMA:
// m2 - mean*mean cancels on data with a large mean), and expf the
// accurate one (no __expf, no --use_fast_math).  So the result differs
// from the plain PyTorch version on the same card at most through expf.

#pragma once

#include "wt_common.cuh"

#define WT_BIL_MAX_HW 4

namespace wt {

// The dense 2-D tap weights, row-major: k[(HW+dy)*(2HW+1) + HW+dx] is the
// host's float64 product t[HW+dy]*t[HW+dx] rounded to float.
struct BilKernel {
  float k[(2 * WT_BIL_MAX_HW + 1) * (2 * WT_BIL_MAX_HW + 1)];
};

// (2hw+1)^2 host-side weights -> BilKernel; false if they do not fit.
inline bool make_bil_kernel(const double* kern, int hw, BilKernel* out) {
  if (!kern || hw < 1 || hw > WT_BIL_MAX_HW) return false;
  const int n = 2 * hw + 1;
  for (int i = 0; i < n * n; ++i) out->k[i] = static_cast<float>(kern[i]);
  return true;
}

__global__ void rows_moments(const float* __restrict__ src,
                             float* __restrict__ tm, float* __restrict__ tq,
                             Taps taps, long long B, long long H, long long W,
                             long long D) {
  WT_FOR_EACH_PIXEL {
    const float* plane = src + b * H * W;
    const long long i = (b * H + h) * W + w;
    tm[i] = fold_rows<false>(plane, taps, h, w, H, W, D);
    tq[i] = fold_rows<true>(plane, taps, h, w, H, W, D);
  }
}

// scl is s+1 under bilateral scaling, else 1 (a product by 1 is exact).
__global__ void cols_range(const float* __restrict__ tm,
                           const float* __restrict__ tq,
                           float* __restrict__ inv2v, float sig2, float scl,
                           Taps taps, long long B, long long H, long long W,
                           long long D) {
  WT_FOR_EACH_PIXEL {
    const long long row = (b * H + h) * W, i = row + w;
    const float mean = fold_cols(tm + row, taps, w, W, D);
    const float m2 = fold_cols(tq + row, taps, w, W, D);
    float vari = __fsub_rn(m2, __fmul_rn(mean, mean));
    if (vari <= 0.0f) vari = 1e-20f;
    inv2v[i] = __fdiv_rn(0.5f, __fmul_rn(__fmul_rn(vari, sig2), scl));
  }
}

// inv2v may alias detail: each thread reads inv2v[i] before it writes
// detail[i], and touches no other pixel of either (no __restrict__).
template <int HW>
__global__ void bilateral_taps(const float* __restrict__ carry,
                               const float* inv2v, float* __restrict__ c_next,
                               float* detail, BilKernel kern, long long B,
                               long long H, long long W, long long D) {
  constexpr int N = 2 * HW + 1;
  WT_FOR_EACH_PIXEL {
    const float* plane = carry + b * H * W;
    const long long i = (b * H + h) * W + w;
    long long rows[N], cols[N];  // tap t sits at offset HW - t (descending)
#pragma unroll
    for (int t = 0; t < N; ++t) {
      rows[t] = sym_index(h + (HW - t) * D, H) * W;
      cols[t] = sym_index(w + (HW - t) * D, W);
    }
    const float c = plane[h * W + w];
    const float iv = inv2v[i];
    const float kc = kern.k[HW * N + HW];
    float acc = __fmul_rn(c, kc);
    float nrm = kc;
#pragma unroll
    for (int ty = 0; ty < N; ++ty) {
#pragma unroll
      for (int tx = 0; tx < N; ++tx) {
        if (ty == HW && tx == HW) continue;
        const float k = kern.k[(N - 1 - ty) * N + (N - 1 - tx)];
        if (k == 0.0f) continue;
        const float sh = plane[rows[ty] + cols[tx]];
        const float diff = __fsub_rn(c, sh);
        const float e = expf(__fmul_rn(-__fmul_rn(diff, diff), iv));
        const float wt = __fmul_rn(k, e);
        nrm = __fadd_rn(nrm, wt);
        acc = __fadd_rn(acc, __fmul_rn(wt, sh));
      }
    }
    const float cn = __fdiv_rn(acc, nrm);
    c_next[i] = cn;
    detail[i] = __fsub_rn(c, cn);
  }
}

// Launch the tap pass for the half width hw (1..WT_BIL_MAX_HW).
inline cudaError_t launch_bilateral_taps(int hw, dim3 grid, dim3 block,
                                         cudaStream_t s, const float* carry,
                                         const float* inv2v, float* c_next,
                                         float* detail, const BilKernel& kern,
                                         long long B, long long H,
                                         long long W, long long D) {
  switch (hw) {
    case 1:
      bilateral_taps<1><<<grid, block, 0, s>>>(carry, inv2v, c_next, detail,
                                               kern, B, H, W, D);
      break;
    case 2:
      bilateral_taps<2><<<grid, block, 0, s>>>(carry, inv2v, c_next, detail,
                                               kern, B, H, W, D);
      break;
    case 3:
      bilateral_taps<3><<<grid, block, 0, s>>>(carry, inv2v, c_next, detail,
                                               kern, B, H, W, D);
      break;
    case 4:
      bilateral_taps<4><<<grid, block, 0, s>>>(carry, inv2v, c_next, detail,
                                               kern, B, H, W, D);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// One bilateral chain smooth at dilation D: src -> c_next, detail (detail
// also carries inv2v between passes 2 and 3; tm, tq are scratch).
inline cudaError_t bilateral_scale(const float* src, float* c_next,
                                   float* detail, float* tm, float* tq,
                                   float sig2, float scl, const Taps& taps,
                                   const BilKernel& kern, long long B,
                                   long long H, long long W, long long D,
                                   cudaStream_t s) {
  dim3 block(256);
  dim3 grid = pixel_grid(B, H, W, block);
  rows_moments<<<grid, block, 0, s>>>(src, tm, tq, taps, B, H, W, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cols_range<<<grid, block, 0, s>>>(tm, tq, detail, sig2, scl, taps, B, H, W,
                                    D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_bilateral_taps(taps.hw, grid, block, s, src, detail, c_next,
                               detail, kern, B, H, W, D);
}

}  // namespace wt
