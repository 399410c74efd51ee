// One WOW scale on the card (kernel A, deep form): chain smooth, detail,
// power smooth, mask, whiten, accumulate, in two launches.  Plain C
// interface, loaded with ctypes (wavelets_tpu_torch/ops/_build.py);
// wrapper and host-side plan in ops/hopper_conv.py (launch_whiten_step,
// step_plan), called by ops/hopper_deep.py::deep_whiten_step.
//
// Replaces wavelets_tpu/ops/pallas_deep.py::deep_whiten_step
// (_make_stream_kernel / _make_deep_kernel), one deep scale per launch on
// row streams.  The TPU kernel's residue-class streams and MXU mirrors
// exist because Mosaic has no `rev` and VMEM windows are tiled; none of
// that carries over.  (The shallow group, pallas_conv._fused_wow_group,
// is whiten_group.cu; this kernel runs its scales only where no group
// tile fits the shared memory.)
//
// Design.  One kernel, templated on the launch, runs a separable dilated
// pass pair per launch at dilation D:
//   launch 1: rows fold of the carry, cols fold -> c_next,
//             detail = carry - c_next;
//   launch 2: rows fold of detail^2, cols fold -> lp, the whitening
//             epilogue (wt::whiten_value) -> white (optional), acc (set,
//             += or none).
// A block owns one image row h (whole rows while two rows of floats fit
// the opt-in shared memory, W <= 29056; beyond, segments of 4096 columns
// with an hw*D halo of recomputed rows-fold values on each side).  It
// maps the 2hw+1 tap rows h + jD through numpy's periodic symmetric
// index map once, into a table in shared memory, then folds down the
// columns: the rows fold reads whole rows, coalesced, into a row buffer
// in shared memory, with the raw centre row beside it; the cols fold
// reads its taps from the buffer, mapping a column only where it leaves
// the row.  So the rows-pass scratch plane of the earlier four launches
// (tmp) never reaches device memory: a scale moves about 7 planes (reads:
// carry, detail, acc; writes: c_next, detail, white, acc) in 2 launches
// against 11 in 4.  Offsets are 32-bit where B*H*W < 2^31 (a template on
// the shape).  Blocks walk the rows in residue-class order (h, h+D,
// h+2D, ...) where D < H, so the far row taps h +- jD of neighbouring
// blocks are the same rows and stay in L2 at every dilation.  The taps'
// half width is a template parameter (1, 2, or any at run time), so the
// tap loops unroll and the weights stay in registers.
//
// Bound: device memory, 5 planes by the function's bytes (read carry and
// acc, write white, c_next and acc: 0.100 ms at 4096^2); the detail
// plane between the launches adds 2, 0.140 ms for the 7.  Measured on an
// H100 80GB HBM3 at 700 W: 0.29-0.36 ms per scale at 4096^2 for
// s = 0..9 around the call (chip_smoke.py), 0.21-0.23 ms of device time
// (scripts/kernel_variants.py), flat in the dilation (the earlier four
// launches: 1.03-1.19 ms); 0.43-0.48 ms of device time with the taps at
// run time, a loop over the Taps argument that the compiler copies to
// local memory.
//
// Rounding.  The folds round step by step in the JAX package's order,
// as wt_common.cuh's fold_rows/fold_cols, so c_next and the detail are
// bitwise equal to the plain PyTorch version on the same card and to
// the earlier four-launch kernel.  The epilogue uses IEEE sqrt and
// division; erff may differ from torch.erf in the last place, which
// bounds |white - plain| well inside 5e-6*max.
//
// Launch.  Segment width, grid, shared-memory bytes and offset width are
// the wrapper's plan (step_plan), passed in and checked here, so the
// plan the CPU tests hold is the one launched.

#include "wt_common.cuh"
#include "wt_tile.cuh"

namespace {

using wt::Taps;

constexpr int kThreads = 256;

struct StepArgs {
  const float* carry;
  float* c_next;
  float* detail;
  float* white;
  float* acc;
  const float* thr;
  float fac;
  int acc_mode, masked, soft;
  int B, H, W, D, seg;  // seg 0: whole rows
  Taps taps;
};

template <bool SECOND, bool WHOLE, typename Idx, int HW>
__global__ void __launch_bounds__(kThreads) step_pass(StepArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ Idx roff[2 * WT_MAX_HW + 1];
  const int H = a.H, W = a.W, D = a.D;
  const int hw = wt::half_width<HW>(a.taps), hd = hw * D;
  int h = blockIdx.x;
  if (D < H) {
    const int P = (H + D - 1) / D;  // rows per residue class, at most
    h = (blockIdx.x % P) * D + blockIdx.x / P;
  }
  if (h >= H) return;  // the whole block, before any barrier
  const int b = blockIdx.z;
  const Idx base = static_cast<Idx>(b) * H * W;
  if (threadIdx.x <= 2 * hw) {
    const int tap_row = wt::sym32(h + (int(threadIdx.x) - hw) * D, H);
    roff[threadIdx.x] = base + static_cast<Idx>(tap_row) * W;
  }
  __syncthreads();
  const int w0 = WHOLE ? 0 : blockIdx.y * a.seg;
  const int n_out = WHOLE ? W : min(a.seg, W - w0);
  const int lo = WHOLE ? 0 : w0 - hd;
  const int span = WHOLE ? W : n_out + 2 * hd;
  float* T = sm;
  float* ctr = sm + span;
  const float* src = SECOND ? a.detail : a.carry;
  const float* __restrict__ cen = src + roff[hw];
  for (int v = threadIdx.x; v < span; v += kThreads) {
    const int c = WHOLE ? v : wt::sym32(lo + v, W);
    const float x0 = cen[c];
    float o = __fmul_rn(SECOND ? __fmul_rn(x0, x0) : x0, a.taps.t[0]);
#pragma unroll
    for (int j = 1; j <= hw; ++j) {
      float l = src[roff[hw - j] + c], r = src[roff[hw + j] + c];
      if (SECOND) {
        l = __fmul_rn(l, l);
        r = __fmul_rn(r, r);
      }
      o = __fadd_rn(o, __fmul_rn(a.taps.t[j], __fadd_rn(l, r)));
    }
    T[v] = o;
    const int u = WHOLE ? v : v - hd;
    if (WHOLE || (u >= 0 && u < n_out)) ctr[u] = x0;
  }
  __syncthreads();
  const Idx row = base + static_cast<Idx>(h) * W;
  for (int o = threadIdx.x; o < n_out; o += kThreads) {
    const int w = w0 + o, v = WHOLE ? w : o + hd;
    float f = __fmul_rn(T[v], a.taps.t[0]);
#pragma unroll
    for (int j = 1; j <= hw; ++j) {
      const float l = T[WHOLE ? wt::sym32(w - j * D, W) : v - j * D];
      const float r = T[WHOLE ? wt::sym32(w + j * D, W) : v + j * D];
      f = __fadd_rn(f, __fmul_rn(a.taps.t[j], __fadd_rn(l, r)));
    }
    const Idx g = row + w;
    if (!SECOND) {
      a.c_next[g] = f;
      a.detail[g] = __fsub_rn(ctr[o], f);
    } else {
      float wc;
      const float v2 = wt::whiten_value(ctr[o], f, a.fac,
                                        a.masked ? a.thr + b : nullptr,
                                        a.soft, &wc);
      if (a.white) a.white[g] = v2;
      if (a.acc_mode == 1) a.acc[g] = v2;
      else if (a.acc_mode == 2) a.acc[g] = __fadd_rn(a.acc[g], v2);
    }
  }
}

template <bool SECOND, bool WHOLE, typename Idx, int HW>
int launch(const StepArgs& a, dim3 grid, int bytes, cudaStream_t s) {
  static std::atomic<int> optin[wt::kMaxDevices];
  cudaError_t err =
      wt::smem_optin(step_pass<SECOND, WHOLE, Idx, HW>, bytes, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  step_pass<SECOND, WHOLE, Idx, HW>
      <<<grid, kThreads, static_cast<size_t>(bytes), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Idx, int HW>
int run(const StepArgs& a, dim3 grid, int bytes, cudaStream_t s) {
  int err = a.seg == 0 ? launch<false, true, Idx, HW>(a, grid, bytes, s)
                       : launch<false, false, Idx, HW>(a, grid, bytes, s);
  if (err) return err;
  return a.seg == 0 ? launch<true, true, Idx, HW>(a, grid, bytes, s)
                    : launch<true, false, Idx, HW>(a, grid, bytes, s);
}

}  // namespace

extern "C" {

const char* wt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One scale at dilation D on a (B, H, W) float32 stack, all pointers on
// the device and contiguous.  detail is scratch of the same size; white
// and acc may be null (acc_mode 0 = none, 1 = acc = white, 2 = acc +=
// white).  thr points at B per-frame thresholds (read only when
// masked).  taps: n_taps symmetric host-side weights.  The launch is the
// wrapper's plan (ops/hopper_conv.py::step_plan): seg (0 for whole rows,
// else the segment width), grid_rows x grid_segs blocks, smem_bytes of
// shared memory, index_bits (32 or 64) wide offsets; it is checked
// against what the kernel needs and launched as given.  Returns
// cudaErrorInvalidValue for arguments or a plan the kernel does not
// take, else cudaGetLastError() after the first failing launch, or 0.
int wt_whiten_step_f32(const float* carry, float* c_next, float* detail,
                       float* white, float* acc, int acc_mode,
                       const float* thr, float fac, int masked, int soft,
                       const double* taps, int n_taps, long long B,
                       long long H, long long W, long long D, long long seg,
                       long long grid_rows, long long grid_segs,
                       long long smem_bytes, int index_bits, void* stream) {
  StepArgs a;
  if (!wt::make_taps(taps, n_taps, &a.taps) || !carry || !c_next ||
      !detail || B < 1 || B > 65535 || H < 1 || W < 1 || D < 1 ||
      H >= (1ll << 30) || W >= (1ll << 30) || D >= (1ll << 26) ||
      seg < 0 || (seg > 0 && seg >= W) || (acc_mode != 0 && !acc) ||
      (masked && !thr))
    return static_cast<int>(cudaErrorInvalidValue);
  // the plan: every row once in residue-class order, every segment, the
  // row buffer and centre row (with the hw*D halo of a segment) in the
  // shared memory, 32-bit offsets only where they cannot overflow
  const long long need =
      seg == 0 ? 8 * W : 4 * (2 * seg + 2ll * a.taps.hw * D);
  if (grid_rows != (D >= H ? H : D * ((H + D - 1) / D)) ||
      grid_segs != (seg == 0 ? 1 : (W + seg - 1) / seg) ||
      smem_bytes < need || smem_bytes > (1ll << 30) ||
      !(index_bits == 64 || (index_bits == 32 && B * H * W < (1ll << 31))))
    return static_cast<int>(cudaErrorInvalidValue);
  a.carry = carry;
  a.c_next = c_next;
  a.detail = detail;
  a.white = white;
  a.acc = acc;
  a.thr = thr;
  a.fac = fac;
  a.acc_mode = acc_mode;
  a.masked = masked;
  a.soft = soft;
  a.B = static_cast<int>(B);
  a.H = static_cast<int>(H);
  a.W = static_cast<int>(W);
  a.D = static_cast<int>(D);
  a.seg = static_cast<int>(seg);
  dim3 grid(static_cast<unsigned>(grid_rows),
            static_cast<unsigned>(grid_segs), static_cast<unsigned>(B));
  const int bytes = static_cast<int>(smem_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wt::dispatch_hw(a.taps.hw, [&](auto hw) {
    constexpr int HW = decltype(hw)::value;
    return index_bits == 32 ? run<int, HW>(a, grid, bytes, s)
                            : run<long long, HW>(a, grid, bytes, s);
  });
}

}  // extern "C"
