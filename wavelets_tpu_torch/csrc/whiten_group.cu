// The shallow WOW scales [offset, offset + g) in one launch (kernel A,
// group form): chain smooth, detail, power smooth, mask, whiten and
// accumulate for g scales on a shared-memory tile.  Plain C interface,
// loaded with ctypes (wavelets_tpu_torch/ops/_build.py); wrapper and
// host-side plan in ops/hopper_conv.py (fused_wow_group, group_plan).
//
// Replaces wavelets_tpu/ops/pallas_conv.py::_fused_wow_group (the
// whiten=... form of _make_kernel): g scales per launch on halo'd tiles,
// the raw detail planes never in device memory.
//
// Design.  A block of 256 threads (8 warps) owns a TH x 64 output tile
// of one frame (TH = 64, 32 or 16, chosen by the plan) and fills two
// shared-memory planes of (TH + 2R) x (64 + 2Rc) floats with the carry
// and its halo, R = hw*2^offset*(3*2^(g-1) - 1), the reach of the group
// (the JAX _wow_group_halo; 22 pixels for the B3spline at offset 0 and
// g = 3), Rc = R rounded up to 4.  An interior tile (and W % 4 == 0)
// fills with 16-byte cp.async copies, four floats a thread, a row of
// the tile per warp; a border tile maps each row once and each column
// through numpy's periodic symmetric index map, so a frame smaller than
// the halo works too.  Numpy's symmetric extension commutes with a
// symmetric fold (a reflected point's taps are the reflected taps, l and
// r swapped, and l + r commutes), so every later scale folds the tile
// with plain offsets and gives the bits of the per-scale index map.
// Per scale k (dilation d = 2^(offset+k), reach hd = hw*d), on the
// margins M_k = max(2hd, M_(k+1) + hd), M_g = 0, that the later scales
// still need:
//   1. each warp takes one row: the rows fold of the carry into a
//      private row buffer, then the cols fold from it -> c_next (C),
//      each lane folding four columns 32 apart before it stores any, so
//      their shared-memory loads overlap (warp_row);
//   2. detail = carry - c_next, in place of the carry;
//   3. each warp takes one output row: the rows fold of detail^2 into
//      its row buffer, the cols fold, the whitening epilogue
//      (wt::whiten_value), white to device memory unless need_cube is
//      off, acc += white in registers (each thread owns the same 2*TH/8
//      pixels at every scale);
// then the carry and c_next planes swap.  The last carry and acc are
// written once.  Device memory: 1 plane read, g + 2 written (g whites,
// carry, acc), against 33 plane moves in 12 launches when each scale ran
// as the earlier four-launch kernel A.
//
// Bound.  By the function's bytes, 0.120 ms at 4096^2, g = 3 (0.060 ms
// with need_cube off); in fact by the instructions of the folds in
// shared memory: each fold reads its 2hw+1 taps from shared memory, and
// the tile recomputes the halo.  At offset 0, g = 3, B3spline the plan
// takes a 32 x 64 output tile: 76 x 112 loaded, a recompute ratio of
// 4.2 for the first chain smooth, falling with the margins to 1.0 for
// the last power smooth, in 70 KB (71680 bytes), so at least two blocks
// fit on an SM (a 64 x 64 tile, ratio 2.95 in 98 KB, ran 6% slower).
// The taps' half width is a template parameter (1, 2, or any at run
// time): with it the tap loops unroll and the weights stay in
// registers.  Measured on an H100 80GB HBM3 at 700 W
// (scripts/kernel_variants.py, device time): 0.756 ms for the group at
// 4096^2 (0.92-0.93 ms around the call), the same with need_cube off
// (so not the bytes); 0.81 ms with one fold a lane at a time, 0.80 ms
// with the 64-row tile, 1.41 ms with the taps at run time, 0.65 ms
// without the whitening epilogue; against 3 x 1.03-1.19 ms for three of
// the earlier four-launch steps.  At offset 1
// the halo doubles and one block fits; where no tile fits 227 KB (for
// the B3spline from offset 2 at g = 3) the plan says so and the wrapper
// runs the scales as deep steps (whiten_step.cu), a rule on the shape.
//
// Rounding.  Every fold is x*t_0 + sum_j t_j*(l + r) with __fmul_rn /
// __fadd_rn in the JAX order, as wt_common.cuh's folds, so c_next is
// bitwise equal to the plain version; the whites and acc differ from it
// only through erff.
//
// bfloat16.  wt_whiten_group_bf16 is the same kernel with the tile, the
// row buffers and the outputs in bfloat16, rounded where the JAX kernel
// stores into a scratch of the input dtype (pallas_conv.py:137,
// :300-376): each separable pass of the chain smooth, carry - c_next,
// its square, and both passes of the power smooth.  The mask, lp, the
// white and acc stay float32 in registers; the white and acc round on
// store.  Two-byte tiles halve the shared memory, so the merged bfloat16
// path takes g = 4 (the JAX plan, scales 0-3; halo 46 at offset 0): a
// 64 x 64 tile of 156 x 160 elements, 100 KB, two blocks an SM, which
// folds 44.5 values an output pixel against the 32-row tile's 64.9:
// 1.72 against 2.26 ms of device time at 4096^2, 1.84 against 2.41-2.48
// ms by CUDA events (scripts/kernel_variants.py, an H100 80GB HBM3 at
// 700 W), bitwise the same.
//
// Launch.  Tile height, halo, grid and shared-memory bytes are the
// wrapper's plan (group_plan), passed in and checked here, so the plan
// the CPU tests hold is the one launched.  Variant builds (wt_tile.cuh):
// NO_EPILOGUE (the power smooth stored unwhitened), ONE_FOLD (one fold a
// lane at a time); the 64-row tile is a plan variant.

#include "wt_common.cuh"
#include "wt_tile.cuh"

#define WT_MAX_G 8

namespace {

using wt::Taps;

constexpr int kTW = 64;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// S: the storage type of the input, the tile, the whites, carry and acc.
template <class S>
struct GroupArgs {
  const S* x;
  S* white[WT_MAX_G];  // null: that plane is not written
  S* carry;
  S* acc;
  const float* thr;  // (g, B)
  float fac[WT_MAX_G];
  int masked[WT_MAX_G];
  int soft, g, offset, B, H, W, R, Rc, vec;
  Taps taps;
};

__host__ __device__ inline int group_halo(int hw, int offset, int g) {
  return (hw << offset) * (3 * (1 << (g - 1)) - 1);
}

// The margin of the carry that scales k .. g-1 still need.
__device__ __forceinline__ int margin(int k, int g, int hw, int offset) {
  int m = 0;
  for (int j = g - 1; j >= k; --j) {
    const int hd = hw << (offset + j);
    m = max(2 * hd, m + hd);
  }
  return m;
}

// x*x as the JAX kernel forms the power plane in S: the square of an S
// value rounded to S (exact in float32, then one rounding).
template <class S>
__device__ __forceinline__ float square(float x) {
  return wt::round_to<S>(__fmul_rn(x, x));
}

// The fold x*t_0 + sum_t t_t*(l + r) around p with taps st apart (of the
// squares where SQUARE), in float32, rounded step by step in the JAX
// order.
template <bool SQUARE, int HW, class S>
__device__ __forceinline__ float fold(const S* p, int st, const Taps& tp) {
  const float c = wt::to_f32(p[0]);
  float o = __fmul_rn(SQUARE ? square<S>(c) : c, tp.t[0]);
#pragma unroll
  for (int t = 1; t <= wt::half_width<HW>(tp); ++t) {
    float l = wt::to_f32(p[-t * st]), r = wt::to_f32(p[t * st]);
    if (SQUARE) {
      l = square<S>(l);
      r = square<S>(r);
    }
    o = __fadd_rn(o, __fmul_rn(tp.t[t], __fadd_rn(l, r)));
  }
  return o;
}

// Columns a lane folds before it stores any (variant ONE_FOLD: one).
#ifdef WT_VARIANT_ONE_FOLD
constexpr int kFolds = 1;
#else
constexpr int kFolds = 4;
#endif

// s(j, f(j)) for j = lo + lane, lo + lane + 32, .. < hi, kFolds columns at
// a time: the folds are computed before any is stored, so their loads
// from shared memory overlap (the compiler cannot tell the buffers apart).
template <class F, class S>
__device__ __forceinline__ void warp_row(int lo, int hi, int lane, F f, S s) {
  for (int j0 = lo + lane; j0 < hi; j0 += kFolds * 32) {
    float o[kFolds];
#pragma unroll
    for (int q = 0; q < kFolds; ++q)
      if (j0 + 32 * q < hi) o[q] = f(j0 + 32 * q);
#pragma unroll
    for (int q = 0; q < kFolds; ++q)
      if (j0 + 32 * q < hi) s(j0 + 32 * q, o[q]);
  }
}

template <class S, int TH, int HW>
__global__ void __launch_bounds__(kThreads, 2) whiten_group(GroupArgs<S> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  S* sm = reinterpret_cast<S*>(smem);
  const int SH = TH + 2 * a.R, SW = kTW + 2 * a.Rc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  S* X = sm;
  S* C = sm + SH * SW;
  S* rowbuf = sm + 2 * SH * SW + warp * SW;
  const int b = blockIdx.z, h0 = blockIdx.y * TH, w0 = blockIdx.x * kTW;
  const int H = a.H, W = a.W;
  const size_t plane = static_cast<size_t>(b) * H * W;
  const S* src = a.x + plane;
  const Taps& tp = a.taps;
  const int hw = wt::half_width<HW>(tp);

  // the carry and its halo
  if (a.vec && h0 - a.R >= 0 && h0 + TH + a.R <= H && w0 - a.Rc >= 0 &&
      w0 + kTW + a.Rc <= W) {
    constexpr int kVec = 16 / sizeof(S);  // elements a 16-byte copy
    const int nv = SW / kVec;
    for (int i = warp; i < SH; i += kWarps) {
      const S* row =
          src + static_cast<size_t>(h0 - a.R + i) * W + (w0 - a.Rc);
      for (int j = lane; j < nv; j += 32)
        wt::cp_async16(X + i * SW + kVec * j, row + kVec * j);
    }
    wt::cp_async_wait_all();
  } else {
    for (int i = warp; i < SH; i += kWarps) {
      const S* row =
          src + static_cast<size_t>(wt::sym32(h0 - a.R + i, H)) * W;
      for (int j = lane; j < SW; j += 32)
        X[i * SW + j] = row[wt::sym32(w0 - a.Rc + j, W)];
    }
  }
  __syncthreads();

  float acc[TH / kWarps][2];
  for (int k = 0; k < a.g; ++k) {
    const int d = 1 << (a.offset + k), hd = hw * d, dS = d * SW;
    const int Cm = max(hd, margin(k + 1, a.g, hw, a.offset));
    const int Mk = Cm + hd;
    // 1. chain smooth on rows [-Cm, TH + Cm): rows fold -> row buffer,
    //    cols fold -> C
    for (int i = -Cm + warp; i < TH + Cm; i += kWarps) {
      const S* xr = X + (i + a.R) * SW + a.Rc;
      S* rb = rowbuf + a.Rc;
      warp_row(
          -Mk, kTW + Mk, lane,
          [&](int j) { return fold<false, HW>(xr + j, dS, tp); },
          [&](int j, float o) { rb[j] = wt::from_f32<S>(o); });
      __syncwarp();
      S* cr = C + (i + a.R) * SW + a.Rc;
      warp_row(
          -Cm, kTW + Cm, lane,
          [&](int j) { return fold<false, HW>(rb + j, d, tp); },
          [&](int j, float o) { cr[j] = wt::from_f32<S>(o); });
      __syncwarp();
    }
    __syncthreads();
    // 2. detail = carry - c_next, in place, on the power smooth's reach
    for (int i = -hd + warp; i < TH + hd; i += kWarps) {
      S* xr = X + (i + a.R) * SW + a.Rc;
      const S* cr = C + (i + a.R) * SW + a.Rc;
      for (int j = -hd + lane; j < kTW + hd; j += 32)
        xr[j] = wt::from_f32<S>(
            __fsub_rn(wt::to_f32(xr[j]), wt::to_f32(cr[j])));
    }
    __syncthreads();
    // 3. power smooth of detail^2 and the whitening of the output tile
    const float* thr = a.masked[k] ? a.thr + k * a.B + b : nullptr;
    S* white = a.white[k];
#pragma unroll
    for (int r = 0; r < TH / kWarps; ++r) {
      const int i = warp + r * kWarps;
      const S* xr = X + (i + a.R) * SW + a.Rc;
      S* rb = rowbuf + a.Rc;
      warp_row(
          -hd, kTW + hd, lane,
          [&](int j) { return fold<true, HW>(xr + j, dS, tp); },
          [&](int j, float o) { rb[j] = wt::from_f32<S>(o); });
      __syncwarp();
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        // the power smooth as the JAX kernel stores it (its tmp plane)
        const float lp = wt::round_to<S>(fold<false, HW>(rb + j, d, tp));
#ifdef WT_VARIANT_NO_EPILOGUE
        const float v = lp;
        (void)thr;
#else
        float wc;
        const float v = wt::whiten_value(wt::to_f32(xr[j]), lp, a.fac[k],
                                         thr, a.soft, &wc);
#endif
        acc[r][c] = k == 0 ? v : __fadd_rn(acc[r][c], v);
        const int gh = h0 + i, gw = w0 + j;
        if (white && gh < H && gw < W)
          white[plane + static_cast<size_t>(gh) * W + gw] =
              wt::from_f32<S>(v);
      }
      __syncwarp();
    }
    __syncthreads();
    S* s = X;
    X = C;
    C = s;
  }
  // the last carry and acc
#pragma unroll
  for (int r = 0; r < TH / kWarps; ++r) {
    const int i = warp + r * kWarps;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c, gh = h0 + i, gw = w0 + j;
      if (gh < H && gw < W) {
        const size_t g = plane + static_cast<size_t>(gh) * W + gw;
        a.carry[g] = X[(i + a.R) * SW + a.Rc + j];
        a.acc[g] = wt::from_f32<S>(acc[r][c]);
      }
    }
  }
}

template <class S, int TH, int HW>
int launch(const GroupArgs<S>& a, dim3 grid, int bytes, cudaStream_t s) {
  static std::atomic<int> optin[wt::kMaxDevices];
  cudaError_t err = wt::smem_optin(whiten_group<S, TH, HW>, bytes, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  whiten_group<S, TH, HW>
      <<<grid, kThreads, static_cast<size_t>(bytes), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Scales offset .. offset+g-1 of a contiguous (B, H, W) stack of S.
template <class S>
int whiten_group_entry(const S* x, S* const* whites, S* carry, S* acc,
                       const float* thr, const float* fac, const int* masked,
                       int soft, int g, int offset, const double* taps,
                       int n_taps, long long B, long long H, long long W,
                       int tile_h, int halo, int halo_cols, long long grid_x,
                       long long grid_y, long long smem_bytes, void* stream) {
  GroupArgs<S> a;
  if (!wt::make_taps(taps, n_taps, &a.taps) || !x || !carry || !acc ||
      !fac || !masked || g < 1 || g > WT_MAX_G || offset < 0 ||
      offset + g > 20 || B < 1 || B > 65535 || H < 1 || W < 1 ||
      H * W >= (1ll << 31) || (H + 15) / 16 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the plan: the group's reach as halo, columns rounded up to 16-byte
  // copies, tiles covering the frame once, two planes and eight row
  // buffers of 64 + 2*halo_cols elements of S in the shared memory
  constexpr int kVec = 16 / sizeof(S);
  const long long sw = kTW + 2ll * halo_cols;
  if ((tile_h != 64 && tile_h != 32 && tile_h != 16) ||
      halo != group_halo(a.taps.hw, offset, g) || halo_cols < halo ||
      halo_cols % kVec != 0 || grid_x != (W + kTW - 1) / kTW ||
      grid_y != (H + tile_h - 1) / tile_h ||
      smem_bytes < static_cast<long long>(sizeof(S)) *
                       (2 * (tile_h + 2ll * halo) * sw + kWarps * sw) ||
      smem_bytes > (1ll << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < g; ++k) {
    a.white[k] = whites ? whites[k] : nullptr;
    a.fac[k] = fac[k];
    a.masked[k] = masked[k];
    if (masked[k] && !thr) return static_cast<int>(cudaErrorInvalidValue);
  }
  a.x = x;
  a.carry = carry;
  a.acc = acc;
  a.thr = thr;
  a.soft = soft;
  a.g = g;
  a.offset = offset;
  a.B = static_cast<int>(B);
  a.H = static_cast<int>(H);
  a.W = static_cast<int>(W);
  a.R = halo;
  a.Rc = halo_cols;
  a.vec = W % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(grid_y), static_cast<unsigned>(B));
  const int bytes = static_cast<int>(smem_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wt::dispatch_hw(a.taps.hw, [&](auto hw) {
    constexpr int HW = decltype(hw)::value;
    if (tile_h == 64) return launch<S, 64, HW>(a, grid, bytes, s);
    if (tile_h == 32) return launch<S, 32, HW>(a, grid, bytes, s);
    return launch<S, 16, HW>(a, grid, bytes, s);
  });
}

}  // namespace

extern "C" {

const char* wt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Scales offset .. offset+g-1 of a contiguous (B, H, W) float32 stack x
// on the device.  whites: g device pointers (null entries, or whites
// null: not written); carry, acc: (B, H, W) outputs; thr: (g, B)
// thresholds on the device (read where masked[k]); fac, masked: g host
// values.  The launch is the wrapper's plan (ops/hopper_conv.py::
// group_plan): tile_h (64, 32 or 16) output rows a block, halo and
// halo_cols, grid_x x grid_y tiles, smem_bytes of shared memory; it is
// checked against what the kernel needs and launched as given.  Returns
// cudaErrorInvalidValue for arguments or a plan the kernel does not
// take, else cudaGetLastError() after the launch.
int wt_whiten_group_f32(const float* x, float* const* whites, float* carry,
                        float* acc, const float* thr, const float* fac,
                        const int* masked, int soft, int g, int offset,
                        const double* taps, int n_taps, long long B,
                        long long H, long long W, int tile_h, int halo,
                        int halo_cols, long long grid_x, long long grid_y,
                        long long smem_bytes, void* stream) {
  return whiten_group_entry<float>(x, whites, carry, acc, thr, fac, masked,
                                   soft, g, offset, taps, n_taps, B, H, W,
                                   tile_h, halo, halo_cols, grid_x, grid_y,
                                   smem_bytes, stream);
}

// The same group on a bfloat16 stack: the tile, whites, carry and acc
// bfloat16 (halo_cols a multiple of 8, the plan's bytes for 2-byte
// elements), thresholds and factors float32.
int wt_whiten_group_bf16(const __nv_bfloat16* x, __nv_bfloat16* const* whites,
                         __nv_bfloat16* carry, __nv_bfloat16* acc,
                         const float* thr, const float* fac,
                         const int* masked, int soft, int g, int offset,
                         const double* taps, int n_taps, long long B,
                         long long H, long long W, int tile_h, int halo,
                         int halo_cols, long long grid_x, long long grid_y,
                         long long smem_bytes, void* stream) {
  return whiten_group_entry<__nv_bfloat16>(
      x, whites, carry, acc, thr, fac, masked, soft, g, offset, taps, n_taps,
      B, H, W, tile_h, halo, halo_cols, grid_x, grid_y, smem_bytes, stream);
}

}  // extern "C"
