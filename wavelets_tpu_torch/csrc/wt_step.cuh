// The row-buffer pass of a separable dilated smooth, one launch per
// pass pair, shared by kernel A's deep form (whiten_step.cu), kernel C
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
// With bfloat16 storage (StepArgsT<__nv_bfloat16>) the folds read the
// carry as float32 and only c_next, the white and acc round, on store.
//
// Halo mode (HaloArgs, kernel A's deep step on a pre-extended band): the
// rows read the source at an offset without reflection, at the true row
// dilation, and FIRST writes c_next for the interior rows only; a
// compile-time switch, so the other arguments' instantiations keep their
// code.
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

// S is the storage type of the carry, c_next, white and acc (float, or
// __nv_bfloat16 for kernel A's bfloat16 deep step); the detail plane
// between the two passes is float32 either way, as the JAX package's deep
// stream keeps the chain smooth and the detail in float32.  C and N, the
// carry's and c_next's types, default to S; kernel A's bfloat16 pair of
// steps with a float32 middle carry sets one of them to float.
template <class S, class C = S, class N = S>
struct StepArgsT {
  using storage = S;
  using carry_t = C;
  using next_t = N;
  // halo mode (HaloArgs): rows read a pre-extended source, no reflection
  static constexpr bool kHalo = false;
  const C* carry;   // FIRST: the source
  N* c_next;        // FIRST
  float* detail;    // FIRST: written unless null; SECOND: the source
  S* white;         // SECOND, may be null
  S* acc;           // SECOND, acc_mode 1 or 2
  const float* thr; // SECOND, one per frame, read where masked
  float fac;
  int acc_mode, masked, soft;
  int H, W;
  int D, Dc;  // the rows' and the columns' dilation (map_step)
  int seg;    // 0: whole rows
  Taps taps;
};
using StepArgs = StepArgsT<float>;

// Kernel D's deep-plane form: the SECOND pass's arguments and the gamma
// sum and per-frame factors.
struct PlaneArgs : StepArgs {
  float* gamma;        // gamma_mode 1 or 2: the masked detail
  const float* facp;   // one factor per frame
  int gamma_mode;
};

template <class Args>
constexpr bool is_plane = std::is_same<Args, PlaneArgs>::value;

// Kernel A's deep step in halo mode (the sharded engine's band tail):
// the source of a pass has Hs rows, output row h reads source rows
// h + off + jD with no row reflection (the caller extended the band with
// its neighbours' rows or the image's reflection), columns reflect as
// ever.  FIRST writes the detail for all H output rows and c_next only
// for rows next_off .. next_off + next_H - 1, at row h - next_off of a
// next_H-row plane.
struct HaloArgs : StepArgs {
  static constexpr bool kHalo = true;
  int Hs, off, next_off, next_H;
};

template <bool SECOND, bool WHOLE, typename Idx, int HW,
          class Args = StepArgs>
__global__ void __launch_bounds__(kStepThreads) step_pass(Args a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ Idx roff[2 * WT_MAX_HW + 1];
  constexpr bool HALO = Args::kHalo;
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
    if constexpr (HALO) {
      const int tap_row = h + a.off + (int(threadIdx.x) - hw) * D;
      roff[threadIdx.x] = static_cast<Idx>(b) * a.Hs * W +
                          static_cast<Idx>(tap_row) * W;
    } else {
      const int tap_row = sym32(h + (int(threadIdx.x) - hw) * D, H);
      roff[threadIdx.x] = base + static_cast<Idx>(tap_row) * W;
    }
  }
  __syncthreads();
  const int w0 = WHOLE ? 0 : blockIdx.y * a.seg;
  const int n_out = WHOLE ? W : min(a.seg, W - w0);
  const int S = WHOLE ? Dc : min(Dc, a.seg);
  const bool windows = !WHOLE && S < Dc;
  const int span = WHOLE ? W : 2 * hw * S + (windows ? a.seg : n_out);
  float* T = sm;
  float* ctr = sm + span;
  using Store = typename Args::storage;
  using Src = std::conditional_t<SECOND, float, typename Args::carry_t>;
  const Src* src;
  if constexpr (SECOND) src = a.detail;
  else src = a.carry;
  const Src* __restrict__ cen = src + roff[hw];
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
    const float x0 = to_f32(cen[c]);
    float o = __fmul_rn(SECOND ? __fmul_rn(x0, x0) : x0, a.taps.t[0]);
#pragma unroll
    for (int j = 1; j <= hw; ++j) {
      float l = to_f32(src[roff[hw - j] + c]);
      float r = to_f32(src[roff[hw + j] + c]);
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
      using Next = typename Args::next_t;
      if constexpr (HALO) {
        const int hn = h - a.next_off;
        if (hn >= 0 && hn < a.next_H)
          a.c_next[(static_cast<Idx>(b) * a.next_H + hn) * W + w] =
              from_f32<Next>(f);
      } else {
        a.c_next[g] = from_f32<Next>(f);
      }
      if (a.detail) a.detail[g] = __fsub_rn(ctr[o], f);
    } else {
      float wc;
      const float v2 = whiten_value(ctr[o], f,
                                    is_plane<Args> ? facb : a.fac,
                                    a.masked ? a.thr + b : nullptr, a.soft,
                                    &wc);
      if (a.white) a.white[g] = from_f32<Store>(v2);
      if (a.acc_mode == 1) a.acc[g] = from_f32<Store>(v2);
      else if (a.acc_mode == 2) a.acc[g] = add_rounded<Store>(a.acc[g], v2);
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
// 32-bit offsets only where they cannot overflow.  Halo mode
// (src_rows > 0): the rows take the true dilation, and the offsets must
// also hold a source of src_rows rows a frame.
inline bool step_plan_ok(const StepPlan& p, int hw, long long B, long long H,
                         long long W, long long D, long long src_rows = 0) {
  if (B < 1 || H < 1 || W < 1 || D < 1 || H >= (1ll << 30) ||
      W >= (1ll << 30) || src_rows >= (1ll << 30) || p.seg < 0 ||
      (p.seg > 0 && p.seg >= W))
    return false;
  const long long Dr = src_rows ? D : map_step(D, H), Dc = map_step(D, W);
  const long long Hi = src_rows > H ? src_rows : H;
  const long long S = p.seg == 0 ? Dc : (Dc < p.seg ? Dc : p.seg);
  const long long need = p.seg == 0 ? 8 * W : 4 * (2 * p.seg + 2ll * hw * S);
  const long long frames = B < kMaxFrames ? B : kMaxFrames;
  return Hi + hw * Dr < (1ll << 31) && W + p.seg + hw * Dc < (1ll << 31) &&
         p.grid_rows == (Dr >= H ? H : Dr * ((H + Dr - 1) / Dr)) &&
         p.grid_segs == (p.seg == 0 ? 1 : (W + p.seg - 1) / p.seg) &&
         p.grid_segs <= 65535 && p.frames == frames && p.smem >= need &&
         p.smem <= (1ll << 30) &&
         (p.index_bits == 64 ||
          (p.index_bits == 32 && frames * Hi * W < (1ll << 31)));
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
  constexpr bool HALO = Args::kHalo;
  a.D = static_cast<int>(HALO ? D : map_step(D, a.H));
  a.Dc = static_cast<int>(map_step(D, a.W));
  a.seg = static_cast<int>(p.seg);
  const long long plane = static_cast<long long>(a.H) * a.W;
  long long src = plane, next = plane;
  if constexpr (HALO) {
    src = static_cast<long long>(a.Hs) * a.W;
    next = static_cast<long long>(a.next_H) * a.W;
  }
  for (long long b0 = 0; b0 < B; b0 += p.frames) {
    Args c = a;
    const long long off = b0 * plane;
    c.carry = a.carry ? a.carry + b0 * src : nullptr;
    c.c_next = shift(a.c_next, b0 * next);
    c.detail = shift(a.detail, b0 * (SECOND ? src : plane));
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
