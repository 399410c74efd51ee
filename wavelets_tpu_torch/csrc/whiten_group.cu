// The shallow WOW scales [offset, offset + g) in one launch (kernel A,
// group form): chain smooth, detail, power smooth, mask, whiten and
// accumulate for g scales in shared memory.  Plain C interface, loaded
// with ctypes (wavelets_tpu_torch/ops/_build.py); wrapper and host-side
// plans in ops/hopper_conv.py (fused_wow_group, group_plan, stream_plan).
//
// Replaces wavelets_tpu/ops/pallas_conv.py::_fused_wow_group (the
// whiten=... form of _make_kernel): g scales per launch on halo'd tiles,
// the raw detail planes never in device memory.  Two designs here:
//
// The float32 tile (wt_whiten_group_f32).  A block of 256 threads (8
// warps) owns a TH x 64 output tile of one frame (TH = 64, 32 or 16,
// chosen by the plan) and fills two shared-memory planes of
// (TH + 2R) x (64 + 2Rc) floats with the carry and its halo,
// R = hw*2^offset*(3*2^(g-1) - 1), the reach of the group (the JAX
// _wow_group_halo; 22 pixels for the B3spline at offset 0 and g = 3), Rc
// = R rounded up to 4.  An interior tile (and W % 4 == 0) fills with
// 16-byte cp.async copies, four floats a thread, a row of the tile per
// warp; a border tile maps each row once and each column through numpy's
// periodic symmetric index map, so a frame smaller than the halo works
// too.  Numpy's symmetric extension commutes with a symmetric fold (a
// reflected point's taps are the reflected taps, l and r swapped, and
// l + r commutes), so every later scale folds the tile with plain
// offsets and gives the bits of the per-scale index map.  Per scale k
// (dilation d = 2^(offset+k), reach hd = hw*d), on the margins
// M_k = max(2hd, M_(k+1) + hd), M_g = 0, that the later scales still
// need:
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
// written once.  Bound: by the function's bytes 0.120 ms at 4096^2,
// g = 3; in fact by the folds in shared memory, the halo recomputed:
// at offset 0, g = 3, B3spline the 32 x 64 output tile loads 76 x 112,
// a recompute ratio of 4.2 for the first chain smooth, falling to 1.0
// for the last power smooth, in 70 KB, two blocks an SM.  Measured on an
// H100 80GB HBM3 at 700 W (scripts/kernel_variants.py, device time):
// 0.756 ms at 4096^2, the same with need_cube off (so not the bytes);
// 0.81 ms with one fold a lane at a time, 0.80 ms with the 64-row tile,
// 1.41 ms with the taps at run time, 0.65 ms without the whitening
// epilogue.  At offset 1 the halo doubles and one block fits; where no
// tile fits 227 KB (the B3spline from offset 2 at g = 3) the plan says so
// and the wrapper runs the scales as deep steps (whiten_step.cu).
//
// The streamed group (wt_whiten_group_bf16), the bfloat16 route's group:
// g = 4 at offset 0 (halo 46, ops/hopper_conv.py::N_STREAM), the float32
// carry and acc out.  On a tile that cost 44.5 folds an output pixel,
// most of them the halo recomputed every 64 rows, of which 16 are the
// function's: 1.71-1.72 ms of device time at 4096^2 against a 0.070 ms
// bound by bytes.  Here a block of 8 warps owns a strip of Ws
// output columns and a band of Hb rows of one frame (the plan's,
// stream_plan) and walks down the band 8 rows a step, one a warp:
//   * rings of rows in shared memory: the input's, 2hd_0 + 16 rows of
//     the strip and its margins in the input's type (a step's rows read
//     while the next step's arrive by 16-byte cp.async); per scale k,
//     c_next (carry_(k+1)) and the detail's square sq_k, 2hd + 8 float32
//     rows each, on the margins the later scales still need; the float32
//     sum of the whites, R - 2hd_0 + 8 rows;
//   * a step of scale k: the chain's rows fold of carry_k into the
//     warp's scratch row, its cols fold -> c_next, the detail's square ->
//     sq_k; a block barrier; the rows fold of sq_k, its cols fold, the
//     whitening of the detail of that row (carry_k - c_next, both still
//     in their rings), the white to device memory, acc += white.  So the
//     vertical halo is computed once a band, not once a tile: 25.0 folds
//     an output pixel at 4096^2 against 44.5 (the strip's margins cost
//     1.7x on the chain smooth);
//   * each lane folds two neighbouring columns (at d = 1 from a window
//     of ceil(hw/2)*2 + 1 pairs), every lane the same rounds (a pair past
//     the row's end folds the last pair again and is not stored), so
//     only the stores branch.
// Virtual rows and columns go through the symmetric map once, at the
// input, so the rings' rows need no reflection, frames smaller than the
// halo and batches included.  Bound: by instruction issue (cuobjdump of
// the hot loops: about 50 instructions a column pair a rows fold, 170 a
// pair in the whitening loop with its erff, two IEEE divisions and a
// square root a pixel), not by shared-memory bandwidth or latency: one
// pair a lane ran faster than two or four, two warps a row (32 warps an
// SM) slower than one, and a two-phase schedule (every scale's chain,
// one barrier, every power smooth) slower than g + 1 barriers a step.
// Measured on an H100 80GB HBM3 at 700 W (scripts/kernel_variants.py,
// device time at 4096^2, g = 4), in the JAX package's bfloat16 rounding
// (bfloat16 rings, this kernel's earlier form): 1.30-1.33 ms against the
// tile's 1.71, 0.93 without the whitening epilogue, 1.59 on 96-column
// strips, 1.69-1.73 on 64, 1.71-1.74 with float32 rings (twice the
// bytes, one block an SM), which the float32 inside now takes.
//
// Rounding.  Every fold is x*t_0 + sum_j t_j*(l + r) with __fmul_rn /
// __fadd_rn in the JAX order, as wt_common.cuh's folds, so c_next is
// bitwise equal to the plain version; in float32 the whites and acc
// differ from it only through erff.  The streamed group is float32
// inside: it reads a bfloat16 frame, and only the whites round, on their
// store; the carry and acc leave in float32.  This departs from the JAX
// package's bfloat16 group, which rounds each separable pass, the detail,
// its square and the power smooth to bfloat16 (pallas_conv.py:137,
// :300-376): on frames of hundreds of counts that rounding cancels most
// digits of the fine details and missed a float32 WOW of the same frame
// by up to 0.25 (rel. L2) in a plane (PERF.md, section 6).
//
// Launch.  Tile height, strip width, band height, halo, grid and
// shared-memory bytes are the wrapper's plans (group_plan, stream_plan),
// passed in and checked here, so the plans the CPU tests hold are the
// ones launched.  Variant builds (wt_tile.cuh): NO_EPILOGUE (the power
// smooth stored unwhitened, both designs), ONE_FOLD (the tile: one fold
// a lane at a time); tile heights, strip widths and band heights are
// plan variants.

#include "wt_common.cuh"
#include "wt_tile.cuh"

#define WT_MAX_G 8

namespace {

using wt::Taps;

constexpr int kTW = 64;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

struct GroupArgs {
  const float* x;
  float* white[WT_MAX_G];  // null: that plane is not written
  float* carry;
  float* acc;
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

// The fold x*t_0 + sum_t t_t*(l + r) around p with taps st apart (of the
// squares where SQUARE), in float32, rounded step by step in the JAX
// order.
template <bool SQUARE, int HW>
__device__ __forceinline__ float fold(const float* p, int st,
                                      const Taps& tp) {
  const float c = p[0];
  float o = __fmul_rn(SQUARE ? __fmul_rn(c, c) : c, tp.t[0]);
#pragma unroll
  for (int t = 1; t <= wt::half_width<HW>(tp); ++t) {
    float l = p[-t * st], r = p[t * st];
    if (SQUARE) {
      l = __fmul_rn(l, l);
      r = __fmul_rn(r, r);
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

template <int TH, int HW>
__global__ void __launch_bounds__(kThreads, 2) whiten_group(GroupArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  const int SH = TH + 2 * a.R, SW = kTW + 2 * a.Rc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* X = sm;
  float* C = sm + SH * SW;
  float* rowbuf = sm + 2 * SH * SW + warp * SW;
  const int b = blockIdx.z, h0 = blockIdx.y * TH, w0 = blockIdx.x * kTW;
  const int H = a.H, W = a.W;
  const size_t plane = static_cast<size_t>(b) * H * W;
  const float* src = a.x + plane;
  const Taps& tp = a.taps;
  const int hw = wt::half_width<HW>(tp);

  // the carry and its halo
  if (a.vec && h0 - a.R >= 0 && h0 + TH + a.R <= H && w0 - a.Rc >= 0 &&
      w0 + kTW + a.Rc <= W) {
    constexpr int kVec = 4;  // floats a 16-byte copy
    const int nv = SW / kVec;
    for (int i = warp; i < SH; i += kWarps) {
      const float* row =
          src + static_cast<size_t>(h0 - a.R + i) * W + (w0 - a.Rc);
      for (int j = lane; j < nv; j += 32)
        wt::cp_async16(X + i * SW + kVec * j, row + kVec * j);
    }
    wt::cp_async_wait_all();
  } else {
    for (int i = warp; i < SH; i += kWarps) {
      const float* row =
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
      const float* xr = X + (i + a.R) * SW + a.Rc;
      float* rb = rowbuf + a.Rc;
      warp_row(
          -Mk, kTW + Mk, lane,
          [&](int j) { return fold<false, HW>(xr + j, dS, tp); },
          [&](int j, float o) { rb[j] = o; });
      __syncwarp();
      float* cr = C + (i + a.R) * SW + a.Rc;
      warp_row(
          -Cm, kTW + Cm, lane,
          [&](int j) { return fold<false, HW>(rb + j, d, tp); },
          [&](int j, float o) { cr[j] = o; });
      __syncwarp();
    }
    __syncthreads();
    // 2. detail = carry - c_next, in place, on the power smooth's reach
    for (int i = -hd + warp; i < TH + hd; i += kWarps) {
      float* xr = X + (i + a.R) * SW + a.Rc;
      const float* cr = C + (i + a.R) * SW + a.Rc;
      for (int j = -hd + lane; j < kTW + hd; j += 32)
        xr[j] = __fsub_rn(xr[j], cr[j]);
    }
    __syncthreads();
    // 3. power smooth of detail^2 and the whitening of the output tile
    const float* thr = a.masked[k] ? a.thr + k * a.B + b : nullptr;
    float* white = a.white[k];
#pragma unroll
    for (int r = 0; r < TH / kWarps; ++r) {
      const int i = warp + r * kWarps;
      const float* xr = X + (i + a.R) * SW + a.Rc;
      float* rb = rowbuf + a.Rc;
      warp_row(
          -hd, kTW + hd, lane,
          [&](int j) { return fold<true, HW>(xr + j, dS, tp); },
          [&](int j, float o) { rb[j] = o; });
      __syncwarp();
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        const float lp = fold<false, HW>(rb + j, d, tp);
#ifdef WT_VARIANT_NO_EPILOGUE
        const float v = lp;
        (void)thr;
#else
        float wc;
        const float v =
            wt::whiten_value(xr[j], lp, a.fac[k], thr, a.soft, &wc);
#endif
        acc[r][c] = k == 0 ? v : __fadd_rn(acc[r][c], v);
        const int gh = h0 + i, gw = w0 + j;
        if (white && gh < H && gw < W)
          white[plane + static_cast<size_t>(gh) * W + gw] = v;
      }
      __syncwarp();
    }
    __syncthreads();
    float* s = X;
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
        a.acc[g] = acc[r][c];
      }
    }
  }
}

template <int TH, int HW>
int launch(const GroupArgs& a, dim3 grid, int bytes, cudaStream_t s) {
  static std::atomic<int> optin[wt::kMaxDevices];
  cudaError_t err = wt::smem_optin(whiten_group<TH, HW>, bytes, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  whiten_group<TH, HW><<<grid, kThreads, static_cast<size_t>(bytes), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
// Scales offset .. offset+g-1 of a contiguous (B, H, W) float32 stack.
int whiten_group_entry(const float* x, float* const* whites, float* carry,
                       float* acc, const float* thr, const float* fac,
                       const int* masked, int soft, int g, int offset,
                       const double* taps, int n_taps, long long B,
                       long long H, long long W, int tile_h, int halo,
                       int halo_cols, long long grid_x, long long grid_y,
                       long long smem_bytes, void* stream) {
  GroupArgs a;
  if (!wt::make_taps(taps, n_taps, &a.taps) || !x || !carry || !acc ||
      !fac || !masked || g < 1 || g > WT_MAX_G || offset < 0 ||
      offset + g > 20 || B < 1 || B > 65535 || H < 1 || W < 1 ||
      H * W >= (1ll << 31) || (H + 15) / 16 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the plan: the group's reach as halo, columns rounded up to 16-byte
  // copies, tiles covering the frame once, two planes and eight row
  // buffers of 64 + 2*halo_cols floats in the shared memory
  constexpr int kVec = 4;
  const long long sw = kTW + 2ll * halo_cols;
  if ((tile_h != 64 && tile_h != 32 && tile_h != 16) ||
      halo != group_halo(a.taps.hw, offset, g) || halo_cols < halo ||
      halo_cols % kVec != 0 || grid_x != (W + kTW - 1) / kTW ||
      grid_y != (H + tile_h - 1) / tile_h ||
      smem_bytes < 4ll * (2 * (tile_h + 2ll * halo) * sw + kWarps * sw) ||
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
    if (tile_h == 64) return launch<64, HW>(a, grid, bytes, s);
    if (tile_h == 32) return launch<32, HW>(a, grid, bytes, s);
    return launch<16, HW>(a, grid, bytes, s);
  });
}

// ---------------------------------------------------------------------
// The streamed group: a block walks a band of rows down a strip of
// columns, each scale on rings of rows in shared memory.
// ---------------------------------------------------------------------

// Rows a step, one a warp.
constexpr int kRS = 8;
constexpr int kSThreads = 32 * kRS;
// Rings: the carries 0 .. g at [0, g], the squared details 0 .. g-1 from
// kSq, the float32 sums of the whites last.
constexpr int kSq = WT_MAX_G + 1;
constexpr int kAcc = 2 * WT_MAX_G + 1;
constexpr int kRings = kAcc + 1;
// Bytes at the front of the shared memory for the block's table.
constexpr int kTableBytes = 1024;

struct StreamRing {
  int off;     // byte offset of slot 0's first element
  int pitch;   // elements a slot (a row of the strip and its margins)
  int rows;    // slots
  int margin;  // columns left of the strip's column 0
};

using bf16 = __nv_bfloat16;

// The input and the whites are bfloat16, the carry and acc float32.
struct StreamArgs {
  const bf16* x;
  bf16* white[WT_MAX_G];
  float* carry;
  float* acc;
  const float* thr;  // (g, B)
  float fac[WT_MAX_G];
  int masked[WT_MAX_G];
  StreamRing ring[kRings];
  int head0[kRings];  // slot of each ring's reference row at step 0
  // column margins of scale k: c_next computed on [-ec, Ws + ec), the
  // chain's rows fold on [-ecar, Ws + ecar), the detail on [-eq, Ws + eq)
  int ec[WT_MAX_G], ecar[WT_MAX_G], eq[WT_MAX_G];
  int soft, g, offset, B, H, W, Ws, Hb, R, Rc, vec, tmp_off, tmp_pitch;
  Taps taps;
};

// What a scale reads by a run-time index lives in shared memory (a
// kernel argument indexed at run time would be copied to local memory).
struct StreamTable {
  StreamRing ring[kRings];
  int head[2][kRings];  // by step parity
  bf16* white[WT_MAX_G];
  float fac[WT_MAX_G];
  int masked[WT_MAX_G], ec[WT_MAX_G], ecar[WT_MAX_G], eq[WT_MAX_G];
};

// Two neighbouring columns as float2 (a 4-byte bfloat16 pair, an 8-byte
// float pair; the column even), and back (a bfloat16 pair rounded).
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
// A bfloat16 is the high half of its float: a pair unpacks in two
// instructions.
__device__ __forceinline__ float2 unpack2(unsigned u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return unpack2(*reinterpret_cast<const unsigned*>(p));
}
__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void st2(bf16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

// The fold of the columns j, j + 1 across the rows rows[0 .. 2hw] (the
// taps -hw .. hw).
template <int HW, class T>
__device__ __forceinline__ float2 vfold2(const T* const* rows, int j,
                                         const Taps& tp) {
  const int hw = wt::half_width<HW>(tp);
  const float2 c = ld2(rows[hw] + j);
  float2 o = make_float2(__fmul_rn(c.x, tp.t[0]), __fmul_rn(c.y, tp.t[0]));
#pragma unroll
  for (int t = 1; t <= hw; ++t) {
    const float2 l = ld2(rows[hw - t] + j), r = ld2(rows[hw + t] + j);
    o.x = __fadd_rn(o.x, __fmul_rn(tp.t[t], __fadd_rn(l.x, r.x)));
    o.y = __fadd_rn(o.y, __fmul_rn(tp.t[t], __fadd_rn(l.y, r.y)));
  }
  return o;
}

// The fold of the columns j, j + 1 along a float32 row at dilation d.  An
// even d keeps every tap pair 8-byte aligned; at d = 1 the 2hw + 2
// columns around the pair are loaded once, as ceil(hw/2)*2 + 1 pairs.
template <int HW>
__device__ __forceinline__ float2 hfold2(const float* p, int j, int d,
                                         const Taps& tp) {
  if (d == 1) {
    if (HW == 0)
      return make_float2(fold<false, HW>(p + j, 1, tp),
                         fold<false, HW>(p + j + 1, 1, tp));
    constexpr int P = (HW + 1) / 2;
    float v[4 * P + 2];
#pragma unroll
    for (int q = 0; q <= 2 * P; ++q) {
      const float2 u = ld2(p + j + 2 * (q - P));
      v[2 * q] = u.x;
      v[2 * q + 1] = u.y;
    }
    float2 o = make_float2(__fmul_rn(v[2 * P], tp.t[0]),
                           __fmul_rn(v[2 * P + 1], tp.t[0]));
#pragma unroll
    for (int t = 1; t <= HW; ++t) {
      o.x = __fadd_rn(o.x, __fmul_rn(tp.t[t],
                                     __fadd_rn(v[2 * P - t], v[2 * P + t])));
      o.y = __fadd_rn(o.y, __fmul_rn(tp.t[t], __fadd_rn(v[2 * P + 1 - t],
                                                        v[2 * P + 1 + t])));
    }
    return o;
  }
  const int hw = wt::half_width<HW>(tp);
  const float* q = p + j;
  const float2 c = ld2(q);
  float2 o = make_float2(__fmul_rn(c.x, tp.t[0]), __fmul_rn(c.y, tp.t[0]));
#pragma unroll
  for (int t = 1; t <= hw; ++t) {
    const float2 l = ld2(q - t * d), r = ld2(q + t * d);
    o.x = __fadd_rn(o.x, __fmul_rn(tp.t[t], __fadd_rn(l.x, r.x)));
    o.y = __fadd_rn(o.y, __fmul_rn(tp.t[t], __fadd_rn(l.y, r.y)));
  }
  return o;
}

// s(j, f(j)) for the column pairs j = lo, lo + 2, .. < hi (lo, hi even),
// a pair a lane.  Every lane runs the same rounds, and a pair past hi
// folds the last pair again and is not stored, so only the stores branch.
template <class F, class St>
__device__ __forceinline__ void warp_pairs(int lo, int hi, int lane, F f,
                                           St s) {
  const int n = (hi - lo) >> 1;
  for (int r = 0; r < n; r += 32) {
    const auto o = f(lo + 2 * min(r + lane, n - 1));
    if (r + lane < n) s(lo + 2 * (r + lane), o);
  }
}

// Column 0 of the slot of row ref + o in a ring whose reference row sits
// in slot `head` (|o| < rows).
template <class T>
__device__ __forceinline__ T* ring_at(unsigned char* smem,
                                      const StreamRing& r, int head, int o) {
  int m = head + o;
  m += m < 0 ? r.rows : 0;
  m -= m >= r.rows ? r.rows : 0;
  return reinterpret_cast<T*>(smem + r.off) + m * r.pitch + r.margin;
}

// Two values into a row of a device plane at column gw (even), paired
// where the row is 4-byte (8-byte) aligned and both columns are in it.
template <class S>
__device__ __forceinline__ void store_pair(S* row, int gw, int W, bool pairs,
                                           float2 v) {
  if (pairs && gw + 1 < W) {
    st2(row + gw, v);
    return;
  }
  if (gw < W) row[gw] = wt::from_f32<S>(v.x);
  if (gw + 1 < W) row[gw + 1] = wt::from_f32<S>(v.y);
}

// One step of scale k, each step row r by its threads.  Its chain: the
// rows fold of carry_k around row u + r, u = the reference row of the
// rings that scale k writes (the rows of carry_k that scale k - 1 wrote
// this step, less hd), into the row's scratch row, its cols fold ->
// c_next (carry_(k+1)'s ring), the detail's square (sq_k's ring).  After
// a block barrier, its power smooth: the rows fold of sq_k around row
// u - hd + r into the scratch row, its cols fold, the whitening of that
// row's detail (carry_k and carry_(k+1), still in their rings), the white
// (and at the last scale the acc and the group's carry) to device memory,
// acc += white in the acc ring.  Everything is float32 but the input's
// ring (Tc = bfloat16 at scale 0, float after) and the white's store.
struct StreamStep {
  int k, d, hd, hd0, lag;  // lag: S_k = hd_0 + .. + hd_(k-1)
  int step_row;            // the virtual row of the input's step
};

template <int HW, class A>
__device__ __forceinline__ StreamStep stream_step(const A& a, int k,
                                                  int step_row) {
  StreamStep st;
  const int hw = wt::half_width<HW>(a.taps);
  st.k = k;
  st.d = 1 << (a.offset + k);
  st.hd = hw * st.d;
  st.hd0 = hw << a.offset;
  st.lag = st.hd0 * ((1 << k) - 1);
  st.step_row = step_row;
  return st;
}

struct ChainOut {
  float2 c, sq;  // c_next and the detail's square
};

template <int HW, class Tc>
__device__ __forceinline__ void stream_chain(
    const StreamArgs& a, StreamTable* tab, unsigned char* smem,
    const int* head, float* tmp, const StreamStep& st, int h0, int h1,
    int w0, size_t plane, int row, int lane) {
  const Taps& tp = a.taps;
  const int hw = wt::half_width<HW>(tp);
  const int k = st.k, d = st.d, hd = st.hd, Ws = a.Ws, W = a.W;
  const int ec = tab->ec[k], ecar = tab->ecar[k], eq = tab->eq[k];
  const StreamRing &rc = tab->ring[k], &rn = tab->ring[k + 1],
                   &rq = tab->ring[kSq + k];
  const int hc = head[k], hn = head[k + 1], hq = head[kSq + k];
  constexpr int NT = HW > 0 ? 2 * HW + 1 : 2 * WT_MAX_HW + 1;
  {
    const Tc* rows[NT];
#pragma unroll
    for (int t = 0; t <= 2 * hw; ++t)
      rows[t] = ring_at<const Tc>(smem, rc, hc, -hd + row + (t - hw) * d);
    warp_pairs(
        -ecar, Ws + ecar, lane,
        [&](int j) { return vfold2<HW>(rows, j, tp); },
        [&](int j, float2 o) { st2(tmp + j, o); });
  }
  __syncwarp();
  const Tc* cr = ring_at<const Tc>(smem, rc, hc, -hd + row);
  float* cn = ring_at<float>(smem, rn, hn, row);
  float* sq = ring_at<float>(smem, rq, hq, row);
  warp_pairs(
      -ec, Ws + ec, lane,
      [&](int j) {
        ChainOut o;
        o.c = hfold2<HW>(tmp, j, d, tp);
        const float2 x = ld2(cr + j);
        const float2 e =
            make_float2(__fsub_rn(x.x, o.c.x), __fsub_rn(x.y, o.c.y));
        o.sq = make_float2(__fmul_rn(e.x, e.x), __fmul_rn(e.y, e.y));
        return o;
      },
      [&](int j, const ChainOut& o) {
        st2(cn + j, o.c);
        if (j >= -eq && j < Ws + eq) st2(sq + j, o.sq);
      });
  __syncwarp();
}

template <int HW, class Tc>
__device__ __forceinline__ void stream_power(
    const StreamArgs& a, StreamTable* tab, unsigned char* smem,
    const int* head, float* tmp, const StreamStep& st, int h0, int h1,
    int w0, size_t plane, int row, int lane) {
  const Taps& tp = a.taps;
  const int hw = wt::half_width<HW>(tp);
  const int k = st.k, d = st.d, hd = st.hd, Ws = a.Ws, W = a.W;
  const int eq = tab->eq[k];
  const StreamRing &rc = tab->ring[k], &rn = tab->ring[k + 1],
                   &rq = tab->ring[kSq + k], &ra = tab->ring[kAcc];
  const int hc = head[k], hn = head[k + 1], hq = head[kSq + k],
            ha = head[kAcc];
  constexpr int NT = HW > 0 ? 2 * HW + 1 : 2 * WT_MAX_HW + 1;
  {
    const float* rows[NT];
#pragma unroll
    for (int t = 0; t <= 2 * hw; ++t)
      rows[t] = ring_at<const float>(smem, rq, hq, -hd + row + (t - hw) * d);
    warp_pairs(
        -eq, Ws + eq, lane,
        [&](int j) { return vfold2<HW>(rows, j, tp); },
        [&](int j, float2 o) { st2(tmp + j, o); });
  }
  __syncwarp();
  const Tc* cr = ring_at<const Tc>(smem, rc, hc, -2 * hd + row);
  const float* cn = ring_at<const float>(smem, rn, hn, -hd + row);
  float* ac = ring_at<float>(smem, ra, ha,
                             row - (st.lag + 2 * hd - 2 * st.hd0));
  const int gh = st.step_row - st.lag - 2 * hd + row;
  const bool in = gh >= h0 && gh < h1, pairs = W % 2 == 0;
  const size_t at = plane + static_cast<size_t>(gh) * W + w0;
  bf16* white = in && tab->white[k] ? tab->white[k] + at : nullptr;
  // at the last scale the acc and the group's carry, c_next of this row
  float* acc = in && k == a.g - 1 ? a.acc + at : nullptr;
  float* carry = acc ? a.carry + at : nullptr;
  // the threshold read once a row (a local: whiten_value reads *thr)
  const float t_k = tab->masked[k] ? a.thr[k * a.B + blockIdx.z] : 0.0f;
  const float* thr = tab->masked[k] ? &t_k : nullptr;
  const float fac = tab->fac[k];
  warp_pairs(
      0, Ws, lane,
      [&](int j) {
        const float2 lp = hfold2<HW>(tmp, j, d, tp);
        const float2 x = ld2(cr + j), c = ld2(cn + j);
        const float2 e =
            make_float2(__fsub_rn(x.x, c.x), __fsub_rn(x.y, c.y));
        float wc;
#ifdef WT_VARIANT_NO_EPILOGUE
        (void)thr;
        (void)fac;
        (void)wc;
        (void)e;
        return lp;
#else
        return make_float2(wt::whiten_value(e.x, lp.x, fac, thr, a.soft, &wc),
                           wt::whiten_value(e.y, lp.y, fac, thr, a.soft, &wc));
#endif
      },
      [&](int j, float2 v) {
        if (white) store_pair(white, j, W - w0, pairs, v);
        if (carry) store_pair(carry, j, W - w0, pairs, ld2(cn + j));
        if (k > 0) {
          const float2 s = ld2(ac + j);
          v = make_float2(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y));
        }
        if (acc)
          store_pair(acc, j, W - w0, pairs, v);
        else
          st2(ac + j, v);
      });
  __syncwarp();
}

// The input's ring is bfloat16; the rings of the later carries, the
// squared details, the acc and the warps' rows are float32.
template <int HW>
__global__ void __launch_bounds__(kSThreads, 2)
    whiten_stream(StreamArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* tab = reinterpret_cast<StreamTable*>(smem);
  const int tid = threadIdx.x, row = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < kRings; ++i)
    if (tid == i) {
      tab->ring[i] = a.ring[i];
      tab->head[0][i] = a.head0[i];
    }
#pragma unroll
  for (int k = 0; k < WT_MAX_G; ++k)
    if (tid == kRings + k) {
      tab->white[k] = a.white[k];
      tab->fac[k] = a.fac[k];
      tab->masked[k] = a.masked[k];
      tab->ec[k] = a.ec[k];
      tab->ecar[k] = a.ecar[k];
      tab->eq[k] = a.eq[k];
    }
  const int b = blockIdx.z, h0 = blockIdx.y * a.Hb, w0 = blockIdx.x * a.Ws;
  const int H = a.H, W = a.W, R = a.R, g = a.g;
  const int h1 = min(h0 + a.Hb, H);
  // virtual row of the input ring's slot 0 at step 0
  const int a0 = h0 - R;
  const int steps = (h1 - h0 + 2 * R + kRS - 1) / kRS;
  const size_t plane = static_cast<size_t>(b) * H * W;
  const bf16* src = a.x + plane;
  const StreamRing in = a.ring[0];
  float* tmp = reinterpret_cast<float*>(smem + a.tmp_off) +
               row * a.tmp_pitch + a.ecar[0];

  // the input rows of step t: virtual rows through the symmetric map,
  // one a row, 16-byte copies where a chunk lies inside the frame
  auto fetch = [&](int t) {
    constexpr int kV = 8;  // bfloat16 elements a 16-byte copy
    const int q = t * kRS + row;
    bf16* dst =
        reinterpret_cast<bf16*>(smem + in.off) + (q % in.rows) * in.pitch;
    const bf16* row = src + static_cast<size_t>(wt::sym32(a0 + q, H)) * W;
    const int c0 = w0 - a.Rc;
    for (int c = lane * kV; c < in.pitch; c += 32 * kV) {
      if (a.vec && c0 + c >= 0 && c0 + c + kV <= W) {
        wt::cp_async16(dst + c, row + c0 + c);
      } else {
#pragma unroll
        for (int e = 0; e < kV; ++e) dst[c + e] = row[wt::sym32(c0 + c + e, W)];
      }
    }
  };

  fetch(0);
  for (int t = 0; t < steps; ++t) {
    wt::cp_async_wait_all();
    __syncthreads();
    const int* head = tab->head[t & 1];
    if (tid < kRings && tab->ring[tid].rows > 0) {
      const int h = head[tid] + kRS, L = tab->ring[tid].rows;
      tab->head[(t + 1) & 1][tid] = h >= L ? h - L : h;
    }
    // the next step's rows arrive while this step computes
    if (t + 1 < steps) fetch(t + 1);
    for (int k = 0; k < g; ++k) {
      const StreamStep st = stream_step<HW>(a, k, a0 + t * kRS);
      if (k > 0) {
        stream_chain<HW, float>(a, tab, smem, head, tmp, st, h0, h1, w0,
                                plane, row, lane);
        __syncthreads();
        stream_power<HW, float>(a, tab, smem, head, tmp, st, h0, h1, w0,
                                plane, row, lane);
      } else {
        stream_chain<HW, bf16>(a, tab, smem, head, tmp, st, h0, h1, w0,
                               plane, row, lane);
        __syncthreads();
        stream_power<HW, bf16>(a, tab, smem, head, tmp, st, h0, h1, w0,
                               plane, row, lane);
      }
    }
  }
}

template <int HW>
int launch_stream(const StreamArgs& a, dim3 grid, int bytes,
                  cudaStream_t s) {
  static std::atomic<int> optin[wt::kMaxDevices];
  cudaError_t err = wt::smem_optin(whiten_stream<HW>, bytes, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  whiten_stream<HW><<<grid, kSThreads, static_cast<size_t>(bytes), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

inline long long align16(long long n) { return (n + 15) / 16 * 16; }
inline int even(int n) { return n + (n & 1); }

// The rings of a strip of Ws columns for g scales from offset: their
// rows, margins and byte offsets into a, and the shared bytes they take
// (the table, the input's bfloat16 ring, the float32 rings, the warps'
// float32 rows).  ops/hopper_conv.py::stream_smem is the same arithmetic.
long long stream_layout(StreamArgs* a, int g, int hw, int offset, int Ws) {
  int hd[WT_MAX_G];
  for (int k = 0; k < g; ++k) hd[k] = hw << (offset + k);
  int ecar_next = 0;
  for (int k = g - 1; k >= 0; --k) {
    a->ec[k] = even(max(hd[k], ecar_next));
    a->ecar[k] = even(a->ec[k] + hd[k]);
    a->eq[k] = even(hd[k]);
    ecar_next = a->ecar[k];
  }
  constexpr int kV = 8;
  const int Rc = (a->ecar[0] + kV - 1) / kV * kV;
  const int R = group_halo(hw, offset, g);
  long long off = kTableBytes;
  auto place = [&](StreamRing* r, int rows, int margin, int pitch,
                   int elem) {
    r->off = static_cast<int>(off);
    r->rows = rows;
    r->margin = margin;
    r->pitch = pitch;
    off += align16(static_cast<long long>(rows) * pitch * elem);
  };
  for (int i = 0; i < kRings; ++i) a->ring[i] = StreamRing{0, 0, 0, 0};
  place(&a->ring[0], 2 * hd[0] + 2 * kRS, Rc, Ws + 2 * Rc, sizeof(bf16));
  for (int k = 1; k < g; ++k)
    place(&a->ring[k], 2 * hd[k] + kRS, a->ec[k - 1], Ws + 2 * a->ec[k - 1],
          sizeof(float));
  place(&a->ring[g], hd[g - 1] + kRS, a->ec[g - 1], Ws + 2 * a->ec[g - 1],
        sizeof(float));
  for (int k = 0; k < g; ++k)
    place(&a->ring[kSq + k], 2 * hd[k] + kRS, a->eq[k], Ws + 2 * a->eq[k],
          sizeof(float));
  place(&a->ring[kAcc], R - 2 * hd[0] + kRS, 0, Ws, sizeof(float));
  a->tmp_off = static_cast<int>(off);
  a->tmp_pitch = Ws + 2 * a->ecar[0];
  off += align16(static_cast<long long>(kRS) * a->tmp_pitch * sizeof(float));
  // each ring's reference row at step 0, relative to the input's first
  // virtual row: the input's ring holds the step's rows, 8 t on; scale k
  // writes c_next rows u_k = 8 t - S_(k+1), S_k = hd_0 (2^k - 1), into
  // ring k + 1 and sq_k; acc's row is scale 0's whitened row, u_0 - hd_0
  auto mod = [](long long v, int n) {
    return static_cast<int>(((v % n) + n) % n);
  };
  for (int i = 0; i < kRings; ++i) a->head0[i] = 0;
  const long long hd0 = hd[0];
  for (int k = 1; k <= g; ++k)
    a->head0[k] = mod(-hd0 * ((1ll << k) - 1), a->ring[k].rows);
  for (int k = 0; k < g; ++k)
    a->head0[kSq + k] =
        mod(-hd0 * ((1ll << (k + 1)) - 1), a->ring[kSq + k].rows);
  a->head0[kAcc] = mod(-2 * hd0, a->ring[kAcc].rows);
  a->Rc = Rc;
  a->R = R;
  return off;
}

// Scales offset .. offset+g-1 of a contiguous (B, H, W) bfloat16 stack on
// the streamed plan, the whites stored in bfloat16, carry and acc float32.
int whiten_stream_entry(const bf16* x, bf16* const* whites, float* carry,
                        float* acc, const float* thr, const float* fac,
                        const int* masked, int soft, int g, int offset,
                        const double* taps, int n_taps, long long B,
                        long long H, long long W, int strip_w, int band_h,
                        int halo, int halo_cols, long long grid_x,
                        long long grid_y, long long smem_bytes,
                        void* stream) {
  static_assert(sizeof(StreamTable) <= kTableBytes, "table");
  StreamArgs a;
  if (!wt::make_taps(taps, n_taps, &a.taps) || !x || !carry || !acc ||
      !fac || !masked || g < 1 || g > WT_MAX_G || offset < 0 ||
      offset + g > 20 || B < 1 || B > 65535 || H < 1 || W < 1 ||
      H * W >= (1ll << 31) || strip_w < 8 || strip_w > 1024 ||
      strip_w % 8 != 0 || band_h < 1 || band_h > H ||
      (a.taps.hw << (offset + g - 1)) > (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  // the plan: the group's reach as the rows' halo, the columns' margin
  // rounded up to 16-byte copies, strips and bands covering the frame
  // once, the rings within the shared bytes given
  const long long need =
      stream_layout(&a, g, a.taps.hw, static_cast<int>(offset), strip_w);
  if (halo != a.R || halo_cols != a.Rc ||
      grid_x != (W + strip_w - 1) / strip_w ||
      grid_y != (H + band_h - 1) / band_h || grid_y > 65535 ||
      smem_bytes < need || smem_bytes > (1ll << 30) ||
      H + band_h + 2ll * halo >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < WT_MAX_G; ++k) {
    a.white[k] = k < g && whites ? whites[k] : nullptr;
    a.fac[k] = k < g ? fac[k] : 0.0f;
    a.masked[k] = k < g ? masked[k] : 0;
    if (k < g && masked[k] && !thr)
      return static_cast<int>(cudaErrorInvalidValue);
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
  a.Ws = strip_w;
  a.Hb = band_h;
  a.vec = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(grid_y), static_cast<unsigned>(B));
  const int bytes = static_cast<int>(smem_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wt::dispatch_hw(a.taps.hw, [&](auto hw) {
    constexpr int HW = decltype(hw)::value;
    return launch_stream<HW>(a, grid, bytes, s);
  });
}

}  // namespace

extern "C" {

const char* wt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Scales offset .. offset+g-1 of a contiguous (B, H, W) float32 stack x
// on the device, on the tile.  whites: g device pointers (null entries,
// or whites null: not written); carry, acc: (B, H, W) outputs; thr: (g,
// B) thresholds on the device (read where masked[k]); fac, masked: g host
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
  return whiten_group_entry(x, whites, carry, acc, thr, fac, masked, soft,
                            g, offset, taps, n_taps, B, H, W, tile_h, halo,
                            halo_cols, grid_x, grid_y, smem_bytes, stream);
}

// The same group, streamed, on a bfloat16 stack: every fold, the detail,
// its square, the power smooth, the mask and the white in float32, the
// whites stored in bfloat16, the carry and acc in float32 (the bfloat16
// route: float32 inside, bfloat16 at the boundary), thresholds and
// factors float32.  The launch is the wrapper's plan (ops/hopper_conv.py::
// stream_plan): strip_w output columns (a multiple of 8) and band_h output
// rows a block, halo (the group's reach) and halo_cols (the input ring's
// column margin), grid_x x grid_y blocks, smem_bytes of shared memory;
// checked against the rings the kernel lays out and launched as given.
int wt_whiten_group_bf16(const __nv_bfloat16* x, __nv_bfloat16* const* whites,
                         float* carry, float* acc, const float* thr,
                         const float* fac, const int* masked, int soft,
                         int g, int offset, const double* taps, int n_taps,
                         long long B, long long H, long long W, int strip_w,
                         int band_h, int halo, int halo_cols,
                         long long grid_x, long long grid_y,
                         long long smem_bytes, void* stream) {
  return whiten_stream_entry(x, whites, carry, acc, thr, fac, masked, soft, g,
                             offset, taps, n_taps, B, H, W, strip_w, band_h,
                             halo, halo_cols, grid_x, grid_y, smem_bytes,
                             stream);
}

}  // extern "C"
