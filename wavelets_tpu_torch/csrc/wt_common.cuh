// Device helpers shared by every kernel: the symmetric taps, numpy's
// periodic 'symmetric' index map, the whitening epilogue, and the
// per-pixel passes (the check-only reference entries of whiten_plane.cu
// and bilateral_step.cu) with the dilated 1-D folds rounded step by step in
// the JAX package's order
//   x*t_c + sum_j t_{c+j}*(x<-jD + x->jD),
// with __fmul_rn/__fadd_rn, which nvcc never contracts into FMAs, so a
// fold is bitwise equal to the plain PyTorch version on the same card.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define WT_MAX_HW 8

namespace wt {

struct Taps {
  float t[WT_MAX_HW + 1];  // t[j]: weight of the taps at offsets -j and +j
  int hw;
};

// n_taps symmetric host-side weights -> Taps; false if they do not fit.
inline bool make_taps(const double* taps, int n_taps, Taps* out) {
  if (!taps || n_taps < 1 || n_taps % 2 == 0 || (n_taps - 1) / 2 > WT_MAX_HW)
    return false;
  out->hw = (n_taps - 1) / 2;
  for (int j = 0; j <= out->hw; ++j)
    out->t[j] = static_cast<float>(taps[out->hw + j]);
  return true;
}

// Storage types.  The kernels of the bfloat16 WOW route (whiten_group.cu,
// whiten_step.cu, whiten_pair.cu) store their whites as float or
// __nv_bfloat16: every fold runs in float32, and a value is rounded
// (round to nearest even, as torch rounds) only where it is stored as S.
// For S = float the store is the identity, so the float32 instantiations
// keep their bits.
template <class S>
__device__ __forceinline__ S from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ long long sym_index(long long k, long long n) {
  if (k >= 0 && k < n) return k;
  long long p = k % (2 * n);
  if (p < 0) p += 2 * n;
  return p < n ? p : 2 * n - 1 - p;
}

template <bool SQUARE>
__device__ __forceinline__ float load(const float* __restrict__ p, long long i) {
  float v = p[i];
  return SQUARE ? __fmul_rn(v, v) : v;
}

// Fold along the rows axis (stride W) around (h, w) of one plane.
template <bool SQUARE>
__device__ __forceinline__ float fold_rows(const float* __restrict__ plane,
                                           const Taps& taps, long long h,
                                           long long w, long long H,
                                           long long W, long long D) {
  float out = __fmul_rn(load<SQUARE>(plane, h * W + w), taps.t[0]);
  for (int j = 1; j <= taps.hw; ++j) {
    float l = load<SQUARE>(plane, sym_index(h - j * D, H) * W + w);
    float r = load<SQUARE>(plane, sym_index(h + j * D, H) * W + w);
    out = __fadd_rn(out, __fmul_rn(taps.t[j], __fadd_rn(l, r)));
  }
  return out;
}

// Fold along the columns axis (stride 1) around (., w) of one row.
__device__ __forceinline__ float fold_cols(const float* __restrict__ row,
                                           const Taps& taps, long long w,
                                           long long W, long long D) {
  float out = __fmul_rn(row[w], taps.t[0]);
  for (int j = 1; j <= taps.hw; ++j) {
    float l = row[sym_index(w - j * D, W)];
    float r = row[sym_index(w + j * D, W)];
    out = __fadd_rn(out, __fmul_rn(taps.t[j], __fadd_rn(l, r)));
  }
  return out;
}

// The significance mask and whitening of one detail value, in the JAX
// package's rounding order: wc = c * mask (erf or hard; a threshold of 0
// means no mask), white = wc * (fac / lp) with lp = sqrt(max-rule(p)).
// Returns white; *masked_out receives wc.
__device__ __forceinline__ float whiten_value(float c, float p, float fac,
                                              const float* thr, int soft,
                                              float* masked_out) {
  float lp = p <= 0.0f ? 1e-15f : p;
  lp = __fsqrt_rn(lp);
  float wc = c;
  if (thr) {
    float t = *thr;
    if (t != 0.0f) {
      float m = soft ? erff(fabsf(__fdiv_rn(wc, t)))
                     : (fabsf(wc) > t ? 1.0f : 0.0f);
      wc = __fmul_rn(wc, m);
    }
  }
  *masked_out = wc;
  return __fmul_rn(wc, __fdiv_rn(fac, lp));
}

// Grid: x over columns, y over rows, z over frames, each grid-strided;
// no integer division per pixel.
#define WT_FOR_EACH_PIXEL                                                  \
  for (long long b = blockIdx.z; b < B; b += gridDim.z)                    \
    for (long long h = blockIdx.y; h < H; h += gridDim.y)                  \
      for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x; \
           w < W; w += (long long)gridDim.x * blockDim.x)

template <bool SQUARE>
__global__ void rows_pass(const float* __restrict__ src,
                          float* __restrict__ dst, Taps taps, long long B,
                          long long H, long long W, long long D) {
  WT_FOR_EACH_PIXEL {
    const float* plane = src + b * H * W;
    dst[(b * H + h) * W + w] = fold_rows<SQUARE>(plane, taps, h, w, H, W, D);
  }
}

// Power-smooth cols pass with the whitening epilogue (kernel G's
// reference entry):
// lp = fold of tmp (the rows pass of detail^2), white = whiten_value(...),
// optionally written; acc_mode 1 sets acc = white, 2 adds acc += white.
__global__ void cols_whiten(const float* __restrict__ tmp,
                            const float* __restrict__ detail,
                            float* __restrict__ white, float* __restrict__ acc,
                            int acc_mode, const float* __restrict__ thr,
                            float fac, int masked, int soft, Taps taps,
                            long long B, long long H, long long W,
                            long long D) {
  WT_FOR_EACH_PIXEL {
    long long row = (b * H + h) * W, i = row + w;
    float wc;
    float v = whiten_value(detail[i], fold_cols(tmp + row, taps, w, W, D),
                           fac, masked ? thr + b : nullptr, soft, &wc);
    if (white) white[i] = v;
    if (acc_mode == 1) acc[i] = v;
    else if (acc_mode == 2) acc[i] = __fadd_rn(acc[i], v);
  }
}

inline dim3 pixel_grid(long long B, long long H, long long W, dim3 block) {
  long long gx = (W + block.x - 1) / block.x;
  return dim3(static_cast<unsigned>(gx < 65535 ? gx : 65535),
              static_cast<unsigned>(H < 65535 ? H : 65535),
              static_cast<unsigned>(B < 65535 ? B : 65535));
}

}  // namespace wt

// Return cudaGetLastError() from the enclosing C entry point if a launch
// failed.
#define WT_CHECK_LAUNCH()                                                  \
  do {                                                                     \
    cudaError_t wt_err_ = cudaGetLastError();                              \
    if (wt_err_ != cudaSuccess) return static_cast<int>(wt_err_);          \
  } while (0)
