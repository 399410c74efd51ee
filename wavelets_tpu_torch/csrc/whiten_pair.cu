// Two consecutive deep WOW scales (s, s+1) in one launch (kernel E): the
// scale-s smooth (the middle carry) never goes to device memory.  Plain C
// interface, loaded with ctypes (wavelets_tpu_torch/ops/_build.py);
// wrapper in ops/hopper_deep.py (deep_whiten_step2).
//
// Replaces wavelets_tpu/ops/pallas_deep.py::deep_whiten_step2
// (_make_stream2_kernel), which streams each row residue class mod D
// through a VMEM ring with two computed-smooth rings and re-mirrors the
// columns with lane reversals.
//
// Design.  With D = 2^s dividing H and W, every tap of both scales (offsets
// j*D and j*2D) and every symmetric reflection of a row or column stays
// inside the residue classes r and D-1-r (mod D) of that axis: a
// reflection maps k to -k-1 or 2H-1-k, and both turn class r into D-1-r.
// Restricted to the classes {r, D-1-r}, numpy's symmetric extension is a
// sequence of period 2M (M = H/D): rows r, r+D, .., r+(M-1)D, then
// D-1-r+(M-1)D, .., D-1-r.  So one block owns the 2M x 2N "torus" of the
// row classes {r, D-1-r} and column classes {q, D-1-q} (N = W/D), and on
// it the dilated folds become circular folds of step 1 (scale s) and 2
// (scale s+1).  The block loads the torus once into shared memory and
// runs, with a barrier between passes:
//   X  = carry;          C1 = smooth_s(X)   (rows pass -> T, cols -> C1)
//   T  = rows(( X - C1)^2);  white_s   = whiten(X - C1, cols(T))  -> X
//   C2 = smooth_s+1(C1) (rows pass -> T, cols -> C2)
//   T  = rows((C1 - C2)^2);  white_s+1 = whiten(C1 - C2, cols(T))
// then writes c_next2 = C2, the two whites and recon = (recon + white_s)
// + white_s+1 (the order of two kernel A steps).  Four torus buffers,
// 16 * 2M * 2N bytes: 64 KB for the 64 x 64 torus of 4096^2 at s = 7 or
// 512^2 at s = 4.  The gate (D | H, D | W, the torus fits the opt-in
// shared memory) is this kernel's own; the wrapper's caller takes two
// kernel A steps where it refuses.  For D = 1 the one class is its own
// mirror, the torus holds every pixel twice, and only the first copy is
// written.
//
// Bound: device memory by the function's bytes (read carry and recon,
// write c_next2, two whites and recon: 6 images, 0.40 GB at 4096^2), but
// by design the accesses: neighbouring torus columns are D pixels apart
// in memory, so every load and store touches its own 32-byte sector, an
// 8x amplification at D >= 8.  A block that owns several column classes,
// so a warp covers neighbouring pixels, is later work.
//
// Rounding.  Every fold rounds step by step in the JAX package's order
// and the left and right taps are added as (l + r), which commutes, so
// the mirrored torus gives the same bits as the index map of kernel A:
// c_next2 is bitwise equal to two kernel A steps and to two plain steps;
// the whites differ from the plain version only through erff.

#include "wt_common.cuh"

namespace {

using wt::Taps;

__device__ __forceinline__ int wrap(int i, int L) {
  i %= L;
  return i < 0 ? i + L : i;
}

// Image coordinate of torus index u on an axis of M points per class.
__device__ __forceinline__ long long torus_pos(int u, int M, long long r,
                                               long long D) {
  return u < M ? r + (long long)u * D
               : (D - 1 - r) + (long long)(2 * M - 1 - u) * D;
}

struct Plain {
  const float* a;
  int Lc;
  __device__ float operator()(int u, int v) const { return a[u * Lc + v]; }
};

struct DiffSq {
  const float* a;
  const float* b;
  int Lc;
  __device__ float operator()(int u, int v) const {
    float d = __fsub_rn(a[u * Lc + v], b[u * Lc + v]);
    return __fmul_rn(d, d);
  }
};

// Circular fold along the torus rows (u) with tap step st.
template <class V>
__device__ __forceinline__ float fold_u(const V& val, const Taps& t, int u,
                                        int v, int st, int Lr) {
  float out = __fmul_rn(val(u, v), t.t[0]);
  for (int j = 1; j <= t.hw; ++j) {
    float l = val(wrap(u - j * st, Lr), v);
    float r = val(wrap(u + j * st, Lr), v);
    out = __fadd_rn(out, __fmul_rn(t.t[j], __fadd_rn(l, r)));
  }
  return out;
}

// Circular fold along the torus columns (v) with tap step st.
__device__ __forceinline__ float fold_v(const float* a, const Taps& t, int u,
                                        int v, int st, int Lc) {
  const float* row = a + u * Lc;
  float out = __fmul_rn(row[v], t.t[0]);
  for (int j = 1; j <= t.hw; ++j) {
    float l = row[wrap(v - j * st, Lc)];
    float r = row[wrap(v + j * st, Lc)];
    out = __fadd_rn(out, __fmul_rn(t.t[j], __fadd_rn(l, r)));
  }
  return out;
}

#define WT_FOR_TORUS                                        \
  for (int u = threadIdx.y; u < Lr; u += blockDim.y)        \
    for (int v = threadIdx.x; v < Lc; v += blockDim.x)

// Grid: x over column class pairs q, y over row class pairs r, z over
// frames.  thr: (2, B) thresholds of the two scales.
__global__ void whiten_pair(const float* __restrict__ carry,
                            float* __restrict__ c_next2,
                            float* __restrict__ white1,
                            float* __restrict__ white2,
                            float* __restrict__ recon,
                            const float* __restrict__ thr, float fac1,
                            float fac2, int masked1, int masked2, int soft,
                            Taps taps, long long B, long long H, long long W,
                            long long D, int M, int N) {
  extern __shared__ float sm[];
  const int Lr = 2 * M, Lc = 2 * N, n = Lr * Lc;
  float* X = sm;
  float* C1 = sm + n;
  float* C2 = sm + 2 * n;
  float* T = sm + 3 * n;
  const long long q = blockIdx.x, r = blockIdx.y, b = blockIdx.z;
  const float* src = carry + b * H * W;

  WT_FOR_TORUS X[u * Lc + v] = src[torus_pos(u, M, r, D) * W +
                                   torus_pos(v, N, q, D)];
  __syncthreads();
  // scale s: chain smooth, then the power smooth of its detail
  WT_FOR_TORUS T[u * Lc + v] = fold_u(Plain{X, Lc}, taps, u, v, 1, Lr);
  __syncthreads();
  WT_FOR_TORUS C1[u * Lc + v] = fold_v(T, taps, u, v, 1, Lc);
  __syncthreads();
  WT_FOR_TORUS T[u * Lc + v] = fold_u(DiffSq{X, C1, Lc}, taps, u, v, 1, Lr);
  __syncthreads();
  // white_s replaces the carry at the thread's own point: no other thread
  // reads X from here on
  WT_FOR_TORUS {
    const int i = u * Lc + v;
    float wc;
    X[i] = wt::whiten_value(__fsub_rn(X[i], C1[i]),
                            fold_v(T, taps, u, v, 1, Lc), fac1,
                            masked1 ? thr + b : nullptr, soft, &wc);
  }
  __syncthreads();
  // scale s+1 on the middle carry C1, taps two torus steps apart
  WT_FOR_TORUS T[u * Lc + v] = fold_u(Plain{C1, Lc}, taps, u, v, 2, Lr);
  __syncthreads();
  WT_FOR_TORUS C2[u * Lc + v] = fold_v(T, taps, u, v, 2, Lc);
  __syncthreads();
  WT_FOR_TORUS T[u * Lc + v] = fold_u(DiffSq{C1, C2, Lc}, taps, u, v, 2, Lr);
  __syncthreads();
  WT_FOR_TORUS {
    if (D == 1 && (u >= M || v >= N)) continue;  // the mirrored copy
    const int i = u * Lc + v;
    float wc;
    float w2 = wt::whiten_value(__fsub_rn(C1[i], C2[i]),
                                fold_v(T, taps, u, v, 2, Lc), fac2,
                                masked2 ? thr + B + b : nullptr, soft, &wc);
    const long long g =
        b * H * W + torus_pos(u, M, r, D) * W + torus_pos(v, N, q, D);
    c_next2[g] = C2[i];
    if (white1) white1[g] = X[i];
    if (white2) white2[g] = w2;
    if (recon) recon[g] = __fadd_rn(__fadd_rn(recon[g], X[i]), w2);
  }
}

}  // namespace

extern "C" {

const char* wt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared-memory bytes of one block at dilation D, or -1 when D does not
// divide H and W.
long long wt_whiten_pair_smem_bytes(long long H, long long W, long long D) {
  if (D < 1 || H < 1 || W < 1 || H % D || W % D) return -1;
  return 16ll * (2 * (H / D)) * (2 * (W / D));
}

// Scales s and s+1 (D = 2^s) of a contiguous (B, H, W) float32 carry on
// the device: c_next2 (B, H, W) receives the scale-(s+1) smooth; white1,
// white2 (B, H, W) or null; recon (B, H, W) or null, += white1 then
// white2 in place.  thr: (2, B) per-scale, per-frame thresholds on the
// device (read where masked1 / masked2).  Returns cudaErrorInvalidValue
// where the gate refuses the shape, else cudaGetLastError() after the
// launch.
int wt_whiten_pair_f32(const float* carry, float* c_next2, float* white1,
                       float* white2, float* recon, const float* thr,
                       float fac1, float fac2, int masked1, int masked2,
                       int soft, const double* taps, int n_taps, long long B,
                       long long H, long long W, long long D, void* stream) {
  Taps tp;
  long long bytes = wt_whiten_pair_smem_bytes(H, W, D);
  if (!wt::make_taps(taps, n_taps, &tp) || !carry || !c_next2 || bytes < 0 ||
      B < 1 || B > 65535 || D / 2 > 65535 || ((masked1 || masked2) && !thr) ||
      (!recon && !(white1 && white2)))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, max_bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_bytes,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes > max_bytes) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(whiten_pair,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned classes = static_cast<unsigned>(D >= 2 ? D / 2 : 1);
  dim3 block(32, 8);
  dim3 grid(classes, classes, static_cast<unsigned>(B));
  whiten_pair<<<grid, block, static_cast<size_t>(bytes),
                static_cast<cudaStream_t>(stream)>>>(
      carry, c_next2, white1, white2, recon, thr, fac1, fac2, masked1,
      masked2, soft, tp, B, H, W, D, static_cast<int>(H / D),
      static_cast<int>(W / D));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
