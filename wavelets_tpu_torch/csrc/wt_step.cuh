// The row-buffer pass of a separable dilated smooth, one launch per
// pass pair, shared by kernel A's float32 deep step (whiten_step.cu), kernel C
// (decompose_group.cu), kernel D's deep-plane form (whiten_plane.cu) and
// kernel G (bilateral_step.cu).  Host-side
// plan: ops/hopper_conv.py::step_plan.
//
// step_pass<SECOND, WHOLE, Idx, HW> at dilation D:
//   FIRST  (SECOND = false): rows fold of the carry, cols fold -> c_next,
//          detail = carry - c_next (unless detail is null);
//   SECOND (SECOND = true):  rows fold of detail^2, cols fold -> lp, the
//          whitening epilogue (wt::whiten_value) -> white (optional), acc
//          (acc_mode 0 none, 1 set, 2 +=), with the host float fac;
//          with PlaneArgs (kernel D's deep-plane form, SECOND only) the
//          factor facp[b] per frame from device memory and the masked,
//          unwhitened value into gamma (gamma_mode 0 none, 1 set, 2 +=).
// A block owns one image row h of one frame and a run of its columns:
// whole rows while two rows of floats fit the opt-in shared memory beside
// the static tap-row table (W <= 29038), else segments of `seg` columns.
// It maps the 2hw+1 tap rows h + jD through numpy's periodic symmetric
// index map once, into a table in shared memory, then folds down the
// columns: the rows fold reads whole rows, coalesced, into a row buffer
// in shared memory, with the raw centre row beside it; the cols fold
// reads its taps from the buffer.  So the rows pass never reaches device memory.  A segment of
// seg output columns from w0 lays its row buffer out as kernel F's ring
// (wt_ring.cuh): shared index v holds column
//   w0 + (v / S - hw) * Dc + v % S,   S = min(Dc, seg),
// a contiguous hw*Dc halo where Dc <= seg and the 2hw+1 tap windows side
// by side beyond, so the cols fold reads T[v +- jS] and the buffer never
// exceeds (2hw+2)*seg floats at any dilation.  Blocks walk the rows in
// residue-class order (h, h+D, h+2D, ...) where D < H, so the far row
// taps h +- jD of neighbouring blocks are the same rows and stay in L2 at
// every dilation.  The taps' half width is a template parameter (1, 2,
// or any at run time), so the tap loops unroll and the weights stay in
// registers.
//
// Dilations.  The symmetric map has period 2n on an axis of n, so the
// rows' and the columns' dilation are each taken as map_step(D, n)
// (wt_tile.cuh): the same taps at any scale, in 32-bit index math.
// Frames.  The grid's z holds at most 65535 frames; a larger batch runs
// as several launches over consecutive frames (run_step_pass).
//
// The arguments' type is a template parameter, so kernels A, C and G
// launch the pass they had before kernel D shared it, on the same
// StepArgs: run-time branches on facp and gamma_mode cost kernel G's
// second pass 4% of its device time, the fields added to StepArgs
// behind a compile-time switch 2.5-2.9%, this 0 (scripts/
// kernel_variants.py, PERF.md).
//
// Rounding.  The folds round step by step in the JAX package's order, as
// wt_common.cuh's fold_rows/fold_cols, so c_next and the detail are
// bitwise equal to the plain PyTorch version on the same card, and the
// second pass's lp to wt_common.cuh's rows_pass<true> + cols_whiten.
// Float32 only: kernel A's bfloat16 deep step and its halo mode run
// whiten_step.cu's residue-class stream, which keeps the detail on chip.
//
// Linkage.  The launch helpers are static (internal linkage): each
// library that includes this header has its own shared-memory opt-in
// cache (a local static of an inline template is one object in a
// process, shared by every library that instantiates it).

#pragma once

#include "wt_common.cuh"
#include "wt_tile.cuh"

namespace wt {

constexpr int kStepThreads = 256;
// frames one launch takes: the grid's z
constexpr long long kMaxFrames = 65535;

struct StepArgs {
  const float* carry;  // FIRST: the source
  float* c_next;       // FIRST
  float* detail;       // FIRST: written unless null; SECOND: the source
  float* white;        // SECOND, may be null
  float* acc;          // SECOND, acc_mode 1 or 2
  const float* thr;    // SECOND, one per frame, read where masked
  float fac;
  int acc_mode, masked, soft;
  int H, W;
  int D, Dc;  // the rows' and the columns' dilation (map_step)
  int seg;    // 0: whole rows
  Taps taps;
};

// Kernel D's deep-plane form: the SECOND pass's arguments and the gamma
// sum and per-frame factors.
struct PlaneArgs : StepArgs {
  float* gamma;        // gamma_mode 1 or 2: the masked detail
  const float* facp;   // one factor per frame
  int gamma_mode;
};

template <class Args>
constexpr bool is_plane = std::is_same<Args, PlaneArgs>::value;

template <bool SECOND, bool WHOLE, typename Idx, int HW,
          class Args = StepArgs>
__global__ void __launch_bounds__(kStepThreads) step_pass(Args a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ Idx roff[2 * WT_MAX_HW + 1];
  const int H = a.H, W = a.W, D = a.D, Dc = a.Dc;
  const int hw = half_width<HW>(a.taps);
  int h = blockIdx.x;
  if (D < H) {
    const int P = (H + D - 1) / D;  // rows per residue class, at most
    h = (blockIdx.x % P) * D + blockIdx.x / P;
  }
  if (h >= H) return;  // the whole block, before any barrier
  const int b = blockIdx.z;
  const Idx base = static_cast<Idx>(b) * H * W;
  if (threadIdx.x <= 2 * hw) {
    const int tap_row = sym32(h + (int(threadIdx.x) - hw) * D, H);
    roff[threadIdx.x] = base + static_cast<Idx>(tap_row) * W;
  }
  __syncthreads();
  const int w0 = WHOLE ? 0 : blockIdx.y * a.seg;
  const int n_out = WHOLE ? W : min(a.seg, W - w0);
  const int S = WHOLE ? Dc : min(Dc, a.seg);
  const bool windows = !WHOLE && S < Dc;
  const int span = WHOLE ? W : 2 * hw * S + (windows ? a.seg : n_out);
  float* T = sm;
  float* ctr = sm + span;
  const float* src = SECOND ? a.detail : a.carry;
  const float* __restrict__ cen = src + roff[hw];
  for (int v = threadIdx.x; v < span; v += kStepThreads) {
    int c = v;
    if (!WHOLE) {
      if (windows) {
        const int q = v / S;
        c = sym32(w0 + (q - hw) * Dc + (v - q * S), W);
      } else {
        c = sym32(w0 - hw * S + v, W);
      }
    }
    const float x0 = cen[c];
    float o = __fmul_rn(SECOND ? __fmul_rn(x0, x0) : x0, a.taps.t[0]);
#pragma unroll
    for (int j = 1; j <= hw; ++j) {
      float l = src[roff[hw - j] + c];
      float r = src[roff[hw + j] + c];
      if (SECOND) {
        l = __fmul_rn(l, l);
        r = __fmul_rn(r, r);
      }
      o = __fadd_rn(o, __fmul_rn(a.taps.t[j], __fadd_rn(l, r)));
    }
    T[v] = o;
    const int u = WHOLE ? v : v - hw * S;
    if (WHOLE || (u >= 0 && u < n_out)) ctr[u] = x0;
  }
  __syncthreads();
  const Idx row = base + static_cast<Idx>(h) * W;
  float facb = 0.0f;
  if constexpr (is_plane<Args>) facb = a.facp[b];
  for (int o = threadIdx.x; o < n_out; o += kStepThreads) {
    const int w = w0 + o, v = WHOLE ? w : o + hw * S;
    float f = __fmul_rn(T[v], a.taps.t[0]);
#pragma unroll
    for (int j = 1; j <= hw; ++j) {
      const float l = T[WHOLE ? sym32(w - j * Dc, W) : v - j * S];
      const float r = T[WHOLE ? sym32(w + j * Dc, W) : v + j * S];
      f = __fadd_rn(f, __fmul_rn(a.taps.t[j], __fadd_rn(l, r)));
    }
    const Idx g = row + w;
    if (!SECOND) {
      // the detail from the unrounded smooth, as the JAX stream forms it
      a.c_next[g] = f;
      if (a.detail) a.detail[g] = __fsub_rn(ctr[o], f);
    } else {
      float wc;
      const float v2 = whiten_value(ctr[o], f,
                                    is_plane<Args> ? facb : a.fac,
                                    a.masked ? a.thr + b : nullptr, a.soft,
                                    &wc);
      if (a.white) a.white[g] = v2;
      if (a.acc_mode == 1) a.acc[g] = v2;
      else if (a.acc_mode == 2) a.acc[g] = __fadd_rn(a.acc[g], v2);
      if constexpr (is_plane<Args>) {
        if (a.gamma_mode == 1) a.gamma[g] = wc;
        else if (a.gamma_mode == 2) a.gamma[g] = __fadd_rn(a.gamma[g], wc);
      }
    }
  }
}

// The plan of one step pass (ops/hopper_conv.py::StepPlan), as the C
// entries receive it.
struct StepPlan {
  long long seg, grid_rows, grid_segs, frames, smem;
  int index_bits;
};

// Whether step_pass runs `p` on a (B, H, W) stack at the true dilation D
// with taps of half width hw: every row once in residue-class order,
// every segment, at most kMaxFrames frames a launch, the row buffer and
// centre row in the shared memory, the taps' reach in 32-bit index math,
// 32-bit offsets only where they cannot overflow.
inline bool step_plan_ok(const StepPlan& p, int hw, long long B, long long H,
                         long long W, long long D) {
  if (B < 1 || H < 1 || W < 1 || D < 1 || H >= (1ll << 30) ||
      W >= (1ll << 30) || p.seg < 0 || (p.seg > 0 && p.seg >= W))
    return false;
  const long long Dr = map_step(D, H), Dc = map_step(D, W);
  const long long S = p.seg == 0 ? Dc : (Dc < p.seg ? Dc : p.seg);
  const long long need = p.seg == 0 ? 8 * W : 4 * (2 * p.seg + 2ll * hw * S);
  const long long frames = B < kMaxFrames ? B : kMaxFrames;
  return H + hw * Dr < (1ll << 31) && W + p.seg + hw * Dc < (1ll << 31) &&
         p.grid_rows == (Dr >= H ? H : Dr * ((H + Dr - 1) / Dr)) &&
         p.grid_segs == (p.seg == 0 ? 1 : (W + p.seg - 1) / p.seg) &&
         p.grid_segs <= 65535 && p.frames == frames && p.smem >= need &&
         p.smem <= (1ll << 30) &&
         (p.index_bits == 64 ||
          (p.index_bits == 32 && frames * H * W < (1ll << 31)));
}

template <bool SECOND, bool WHOLE, typename Idx, int HW, class Args>
static int launch_step_pass(const Args& a, dim3 grid, int bytes,
                            cudaStream_t s) {
  static std::atomic<int> optin[kMaxDevices];
  cudaError_t err =
      smem_optin(step_pass<SECOND, WHOLE, Idx, HW, Args>, bytes, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  step_pass<SECOND, WHOLE, Idx, HW, Args>
      <<<grid, kStepThreads, static_cast<size_t>(bytes), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class P>
inline P* shift(P* p, long long n) { return p ? p + n : p; }

// One step pass of a checked plan `p` on B frames, at the true dilation
// D: a launch per p.frames consecutive frames.  a's pointers are those of
// frame 0; H, W, taps and the epilogue's fields are set by the caller.
template <bool SECOND, class Args = StepArgs>
static int run_step_pass(Args a, const StepPlan& p, long long B,
                         long long D, cudaStream_t s) {
  a.D = static_cast<int>(map_step(D, a.H));
  a.Dc = static_cast<int>(map_step(D, a.W));
  a.seg = static_cast<int>(p.seg);
  const long long plane = static_cast<long long>(a.H) * a.W;
  for (long long b0 = 0; b0 < B; b0 += p.frames) {
    Args c = a;
    const long long off = b0 * plane;
    c.carry = shift(a.carry, off);
    c.c_next = shift(a.c_next, off);
    c.detail = shift(a.detail, off);
    c.white = shift(a.white, off);
    c.acc = shift(a.acc, off);
    c.thr = a.thr ? a.thr + b0 : nullptr;
    if constexpr (is_plane<Args>) {
      c.gamma = shift(a.gamma, off);
      c.facp = a.facp + b0;
    }
    const long long nb = B - b0 < p.frames ? B - b0 : p.frames;
    const dim3 grid(static_cast<unsigned>(p.grid_rows),
                    static_cast<unsigned>(p.grid_segs),
                    static_cast<unsigned>(nb));
    const int bytes = static_cast<int>(p.smem);
    const int err = dispatch_hw(c.taps.hw, [&](auto hw) {
      constexpr int HW = decltype(hw)::value;
      if (p.index_bits == 32)
        return c.seg == 0 ? launch_step_pass<SECOND, true, int, HW>(
                                c, grid, bytes, s)
                          : launch_step_pass<SECOND, false, int, HW>(
                                c, grid, bytes, s);
      return c.seg == 0 ? launch_step_pass<SECOND, true, long long, HW>(
                              c, grid, bytes, s)
                        : launch_step_pass<SECOND, false, long long, HW>(
                              c, grid, bytes, s);
    });
    if (err) return err;
  }
  return 0;
}

}  // namespace wt
