// One WOW scale on the card (kernel A, deep form): chain smooth, detail,
// power smooth, mask, whiten, accumulate.  Plain C interface, loaded with
// ctypes (wavelets_tpu_torch/ops/_build.py); wrappers and host-side plans
// in ops/hopper_conv.py (launch_whiten_step and step_plan for float32,
// launch_whiten_stream and stream_step_plan for the rest), called by
// ops/hopper_deep.py::deep_whiten_step.
//
// Replaces wavelets_tpu/ops/pallas_deep.py::deep_whiten_step (:514), one
// deep scale per launch, and its residue-class stream _make_stream_kernel
// (:311), with its bfloat16 form and its halo mode.  (The shallow group,
// pallas_conv._fused_wow_group, is whiten_group.cu; this kernel runs its
// scales only where no group tile fits the shared memory.)
//
// Two designs, one per form.
//
// Float32 (wt_whiten_step_f32, the main path's step): two launches of
// wt_step.cuh's row-buffer pass at dilation D:
//   launch 1 (FIRST): rows fold of the carry, cols fold -> c_next,
//             detail = carry - c_next;
//   launch 2 (SECOND): rows fold of detail^2, cols fold -> lp, the
//             whitening epilogue (wt::whiten_value) -> white (optional),
//             acc (set, += or none).
// Bound: device memory, 5 planes by the function's bytes (read carry and
// acc, write white, c_next and acc: 0.100 ms at 4096^2); the detail
// plane between the launches adds 2.  Measured on an H100 80GB HBM3 at
// 700 W: 0.21-0.23 ms of device time per scale at 4096^2
// (scripts/kernel_variants.py), flat in the dilation.
//
// The residue-class stream (deep_stream below; wt_whiten_step_bf16, the
// bfloat16 route's step, and the halo mode wt_whiten_step_halo_f32), one
// launch a scale, from a float32 carry.  What bounds it on the H100: the
// function moves 18 bytes a pixel in the bfloat16 route (read carry and
// acc, write c_next and acc in float32, the white in bfloat16: 0.090 ms
// at 4096^2), so the two-launch pass's float32 detail plane (8 bytes a
// pixel more, and in halo mode H + R rows each way) and its five reads of
// every tap row a pass were most of its traffic; what is left is
// instruction issue: four
// folds a pixel and the epilogue's IEEE square root and division (with
// erff and a second division where masked).  The design keeps every
// intermediate on chip and folds each value once:
//   - a block owns a frame, a residue class r of the rows' dilation D, a
//     chunk of that class's rows (positions p: rows r + pD) and a run of
//     columns (whole rows where they fit), and walks down the positions
//     one tick at a time; blocks take such items grid-stride, so any
//     batch is one launch;
//   - each tick one carry row enters a ring of 2hw+2 float32 rows
//     (16-byte cp.async a tick ahead where the chunk lies inside the
//     frame on a 16-byte boundary), the chain's rows fold runs over the
//     class's 2hw+1 ring rows into a row buffer, and its cols fold gives
//     c_next and the detail, which goes into a ring of 2hw+1 rows;
//   - one tick behind, the power smooth's rows fold squares the detail
//     ring's rows into a second buffer, and its cols fold, the epilogue
//     and the acc row (fetched by cp.async in the same tick) give white
//     and acc: two barriers a tick;
//   - a chunk warms up on the 2hw positions before it (4hw carry rows),
//     which the plan weighs against filling 132 SMs; where D divides H a
//     work item walks a class and its mirror class D - 1 - r as one
//     stream of 2P positions (position P + k of class r is the mirror's
//     position P - 1 - k), so a class's reflected ends are rows it owns;
//   - a thread takes a pair of columns at a time, read as float2 and
//     stored in pairs where aligned.
// Borders: a position outside [0, P) reads row sym(r + pD) directly.
// The folds are symmetric, so the smooth and the detail there equal those
// of the reflected row bit for bit (the JAX stream's identity,
// pallas_deep.py:321-333), for any H (sym has period 2H); where D >= H the
// rows take map_step(D, H) (wt_tile.cuh).  Halo mode: the band arrives
// extended by R = 2hw*D rows a side, so every position is a real row at
// an offset and nothing reflects; the outputs are the H interior rows.
// Columns: whole rows reflect in the cols folds (symmetric index map);
// a run of seg columns lays its buffers out as wt_step.cuh's segments,
// shared index v holding column w0 + (v / S - e) * Dc + v % S with
// S = min(Dc, seg) and e = 2hw for the carry and the chain's rows fold
// (the chain smooth is needed 2hw*Dc beyond the run), e = hw for the
// detail and the power smooth: a contiguous margin where Dc <= seg, the
// tap windows side by side beyond, at the cost of the chain smooth
// computed again on the windows.
//
// Rounding (both designs).  The folds round step by step in the JAX
// package's order, as wt_common.cuh's fold_rows/fold_cols: x*t_0, then
// t_j*(l + r) added for j = 1..hw.  Everything is float32 (carry, detail,
// c_next, acc += white); in the bfloat16 route only the white rounds, on
// its store, and acc adds the unrounded white.  This departs from the JAX
// package's bfloat16 stream, which stores c_next and acc in bfloat16: on
// frames of hundreds of counts a bfloat16 carry's spacing (2 at 300)
// swamps the details it feeds, and the route missed a float32 WOW of the
// same frame by up to 0.25 (rel. L2) in a plane; a carry rounded once,
// after scale 3, still left 0.063 in plane 4 (PERF.md §6).  So every
// output is bitwise equal to the plain PyTorch version on the same card
// (the float32 step on the carry, the white rounded on store).  The
// epilogue uses IEEE sqrt and division; erff may differ from torch.erf in
// the last place, bounded well inside 5e-6*max in float32.
//
// Measured (scripts/kernel_variants.py, NVIDIA H100 80GB HBM3, 700 W,
// device ms a scale at 4096^2, PERF.md): the JAX-rounding bfloat16 form
// (bfloat16 carry, 10 bytes a pixel) 0.186-0.240 against the two
// launches' 0.219-0.245 on the same card, halo mode on a 4096-row band
// 0.186-0.280 against 0.246-0.313.  The stream moves a
// third of the bytes but stays bound by issue and latency: without the
// whitening epilogue it takes 0.17-0.22, with one column a thread instead
// of a pair 0.27-0.32; 1024 threads gained 2%, the acc row read into
// registers instead of by cp.async lost 28%.  Variant hooks
// (scripts/kernel_variants.py):
// STREAM_SCALAR (one column a thread), NO_EPILOGUE (the white is c + lp).
//
// Launch.  Each form's plan (segment width, grid, shared-memory bytes,
// offset width; the stream's chunk length) is the wrapper's, passed in,
// checked here and launched as given, so the plan the CPU tests hold is
// the one launched.

#include "wt_step.cuh"
#include "wt_stream.cuh"

namespace {

// One scale of the float32 deep step: two launches of the row-buffer
// pass, the detail plane (scratch) between them.
int whiten_step_f32(const float* carry, float* c_next, float* detail,
                    float* white, float* acc, int acc_mode, const float* thr,
                    float fac, int masked, int soft, const double* taps,
                    int n_taps, long long B, long long H, long long W,
                    long long D, long long seg, long long grid_rows,
                    long long grid_segs, long long frames,
                    long long smem_bytes, int index_bits, void* stream) {
  wt::StepArgs a = {};
  const wt::StepPlan p = {seg, grid_rows, grid_segs, frames, smem_bytes,
                          index_bits};
  if (!wt::make_taps(taps, n_taps, &a.taps) || !carry || !c_next ||
      !detail || (acc_mode != 0 && !acc) || (masked && !thr) ||
      !wt::step_plan_ok(p, a.taps.hw, B, H, W, D))
    return static_cast<int>(cudaErrorInvalidValue);
  a.carry = carry;
  a.c_next = c_next;
  a.detail = detail;
  a.H = static_cast<int>(H);
  a.W = static_cast<int>(W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = wt::run_step_pass<false>(a, p, B, D, s);
  if (err) return err;
  a.carry = nullptr;
  a.c_next = nullptr;
  a.white = white;
  a.acc = acc;
  a.thr = thr;
  a.fac = fac;
  a.acc_mode = acc_mode;
  a.masked = masked;
  a.soft = soft;
  return wt::run_step_pass<true>(a, p, B, D, s);
}

// ---------------------------------------------------------------------
// The residue-class stream
// ---------------------------------------------------------------------

using wt::aligned16;
using wt::cp_commit;
using wt::cp_wait;
using wt::fetch_row;
using wt::kStreamThreads;
using wt::ld2;
using wt::st2;

// columns a thread takes at a time: a pair, read as float2 where aligned
#ifdef WT_VARIANT_STREAM_SCALAR
constexpr int kCols = 1;
#else
constexpr int kCols = 2;
#endif
constexpr long long kStreamSmemMax = 232448;  // the H100's opt-in

// The stream's plan (ops/hopper_conv.py::StreamStepPlan): seg (0 for
// whole rows, else the run width, a multiple of 8), chunk (positions of a
// class a block walks), grid (blocks, each taking items grid-stride),
// smem (dynamic shared bytes).
struct StreamPlan {
  long long seg, chunk, grid, smem;
};

// S: the white's type; the carry, c_next and acc are float32.
template <class S>
struct StreamArgs {
  const float* carry;
  float* c_next;
  S* white;          // may be null
  float* acc;        // acc_mode 1 (set) or 2 (+=)
  const float* thr;  // one per frame, read where masked
  float fac;
  int acc_mode, masked, soft;
  int H, W;          // output rows and columns a frame
  long long Hs;      // source rows a frame (H, or H + 2*halo)
  long long off;     // source row of output row 0 (halo, or 0)
  long long Dr, Dc;  // the rows' and the columns' dilation
  int halo;          // rows read at an offset, without reflection
  int mirror;        // a class walks on into its mirror class
  int seg, win_w, windows;  // win_w: S = min(Dc, seg)
  int n_cls, runs;
  long long chunk, n_chunks, items;
  int pitch_c, pitch_d;                  // ring rows, in elements
  int off_t1, off_t2, off_det, off_acc;  // shared regions, in bytes
  int vec_c, vec_a;  // carry / acc 16-byte aligned: cp.async may copy
  int st_pairs;      // W even, outputs aligned: pairs stored together
  wt::Taps taps;
};

inline long long align16(long long n) { return (n + 15) / 16 * 16; }

// Lay out the stream's shared memory for the plan p and check that the
// kernel runs it on a (B, H, W) stack at the true dilation D (halo > 0:
// a source of H + 2*halo rows a frame, halo = 2*hw*D): ops/hopper_conv.py
// ::stream_step_smem and stream_step_plan mirror it.
template <class S>
bool stream_layout(StreamArgs<S>* a, const StreamPlan& p, long long B,
                   long long H, long long W, long long D, long long halo) {
  const long long hw = a->taps.hw;
  if (B < 1 || H < 1 || W < 1 || D < 1 || H >= (1ll << 30) ||
      W >= (1ll << 30) || halo < 0 || p.seg < 0 ||
      (p.seg && (p.seg % 8 || p.seg >= W)) || p.chunk < 1 || p.grid < 1)
    return false;
  if (halo && (D >= (1ll << 26) || halo != 2 * hw * D ||
               H + 2 * halo >= (1ll << 30)))
    return false;
  const long long Dr = halo ? D : wt::map_step(D, H);
  const long long Dc = wt::map_step(D, W);
  // mirror: where Dr divides H, position P + k of class r is row
  // sym(r + (P + k) Dr) = position P - 1 - k of class Dr - 1 - r, so an
  // item walks the pair (r, Dr - 1 - r) as one stream of 2P positions
  const bool mirror = !halo && Dr < H && H % Dr == 0 && Dr % 2 == 0;
  const long long n_cls = mirror ? Dr / 2 : (Dr < H ? Dr : H);
  const long long P = mirror ? 2 * (H / Dr) : (H + Dr - 1) / Dr;
  const long long seg = p.seg, sw = seg ? (Dc < seg ? Dc : seg) : 0;
  const long long m = seg ? seg : W;
  const long long span_c = seg ? 4 * hw * sw + m : W;
  const long long span_d = seg ? 2 * hw * sw + m : W;
  const long long pitch_c = (span_c + 3) / 4 * 4;
  const long long pitch_d = (span_d + 3) / 4 * 4;
  const long long t1 = align16((2 * hw + 2) * pitch_c * 4);
  const long long t2 = t1 + align16(4 * span_c);
  const long long det = t2 + align16(4 * span_d);
  const long long acc = det + align16((2 * hw + 1) * pitch_d * 4);
  const long long need = acc + align16(m * 4);
  const long long runs = seg ? (W + seg - 1) / seg : 1;
  const long long n_chunks = (P + p.chunk - 1) / p.chunk;
  const long long items = B * runs * n_cls * n_chunks;
  if (p.chunk > P || need > p.smem || p.smem > kStreamSmemMax ||
      p.grid > items || p.grid > 0x7fffffffll)
    return false;
  a->H = static_cast<int>(H);
  a->W = static_cast<int>(W);
  a->Hs = H + 2 * halo;
  a->off = halo;
  a->halo = halo > 0;
  a->mirror = mirror;
  a->Dr = Dr;
  a->Dc = Dc;
  a->seg = static_cast<int>(seg);
  a->win_w = static_cast<int>(sw);
  a->windows = seg && sw < Dc;
  a->n_cls = static_cast<int>(n_cls);
  a->runs = static_cast<int>(runs);
  a->chunk = p.chunk;
  a->n_chunks = n_chunks;
  a->items = items;
  a->pitch_c = static_cast<int>(pitch_c);
  a->pitch_d = static_cast<int>(pitch_d);
  a->off_t1 = static_cast<int>(t1);
  a->off_t2 = static_cast<int>(t2);
  a->off_det = static_cast<int>(det);
  a->off_acc = static_cast<int>(acc);
  return true;
}

// numpy's symmetric map of k on an axis of n: one reflection for k in
// [-2n, 2n), the periodic map beyond.
__device__ __forceinline__ int reflect(int k, int n) {
  if (k < 0) k = -1 - k;
  if (k >= n) k = 2 * n - 1 - k;
  return static_cast<unsigned>(k) < static_cast<unsigned>(n) ? k
                                                             : wt::sym32(k, n);
}

// The cols fold of a whole row T at column w (dilation Dc), reflecting
// only near the borders.
template <int HW>
__device__ __forceinline__ float fold_whole(const float* T, int w, int W,
                                            int Dc, const wt::Taps& tp) {
  const int hw = wt::half_width<HW>(tp);
  float f = __fmul_rn(T[w], tp.t[0]);
  if (w >= hw * Dc && w + hw * Dc < W) {
#pragma unroll
    for (int j = 1; j <= hw; ++j)
      f = __fadd_rn(f, __fmul_rn(tp.t[j],
                                 __fadd_rn(T[w - j * Dc], T[w + j * Dc])));
  } else {
#pragma unroll
    for (int j = 1; j <= hw; ++j)
      f = __fadd_rn(f, __fmul_rn(tp.t[j],
                                 __fadd_rn(T[reflect(w - j * Dc, W)],
                                           T[reflect(w + j * Dc, W)])));
  }
  return f;
}

// The cols fold of a run's buffer T at index v: its taps are v +- jS.
template <int HW>
__device__ __forceinline__ float fold_run(const float* T, int v, int S,
                                          const wt::Taps& tp) {
  const int hw = wt::half_width<HW>(tp);
  float f = __fmul_rn(T[v], tp.t[0]);
#pragma unroll
  for (int j = 1; j <= hw; ++j)
    f = __fadd_rn(f, __fmul_rn(tp.t[j], __fadd_rn(T[v - j * S], T[v + j * S])));
  return f;
}

template <int HW, bool WHOLE, class S>
__global__ void __launch_bounds__(kStreamThreads, 1)
    deep_stream(StreamArgs<S> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* T1 = reinterpret_cast<float*>(smem + a.off_t1);
  float* T2 = reinterpret_cast<float*>(smem + a.off_t2);
  float* det = reinterpret_cast<float*>(smem + a.off_det);
  float* accb = reinterpret_cast<float*>(smem + a.off_acc);
  const int hw = wt::half_width<HW>(a.taps);
  const int NC = 2 * hw + 2, ND = 2 * hw + 1;
  const int H = a.H, W = a.W, tid = threadIdx.x;
  const int Sw = WHOLE ? 0 : a.win_w;
  const int Dc = WHOLE ? static_cast<int>(a.Dc) : 0;
  const int win = (WHOLE || !a.windows) ? (1 << 30) : Sw;
  const float t0 = a.taps.t[0];
  for (long long it = blockIdx.x; it < a.items; it += gridDim.x) {
    // item = ((frame * runs + run) * n_chunks + chunk) * n_cls + class
    long long q = it;
    const int r = static_cast<int>(q % a.n_cls);
    q /= a.n_cls;
    const long long k = q % a.n_chunks;
    q /= a.n_chunks;
    const int g = static_cast<int>(q % a.runs);
    const long long b = q / a.runs;
    // the class's positions, and the output row of position p (the
    // mirror class's rows from P on)
    const long long P = a.mirror ? 2 * (H / a.Dr) : (H - r + a.Dr - 1) / a.Dr;
    auto out_row = [&](long long p) -> long long {
      const long long v = r + p * a.Dr;
      return a.mirror ? wt::sym_index(v, H) : v;
    };
    const long long p0 = k * a.chunk;
    if (p0 >= P) continue;  // the whole block
    const long long p1 = min(p0 + a.chunk, P);
    const int w0 = WHOLE ? 0 : g * a.seg;
    const int n_out = WHOLE ? W : min(a.seg, W - w0);
    const int m = WHOLE ? W : (a.windows ? a.seg : n_out);
    const int span_c = WHOLE ? W : 4 * hw * Sw + m;
    const int span_d = WHOLE ? W : 2 * hw * Sw + m;
    const long long frame_src = b * a.Hs * W, frame_out = b * H * W;
    const float thr_b = a.masked ? a.thr[b] : 0.0f;
    const float* thr = a.masked ? &thr_b : nullptr;
    auto whiten = [&](float c, float lp, float* wc) {
#ifdef WT_VARIANT_NO_EPILOGUE
      *wc = c;
      return __fadd_rn(c, lp);
#else
      return wt::whiten_value(c, lp, a.fac, thr, a.soft, wc);
#endif
    };
    // the source row of position p: r + pD through the symmetric map, or
    // at the halo's offset
    auto src_row = [&](long long p) -> long long {
      const long long v = r + p * a.Dr;
      return a.halo ? a.off + v : wt::sym_index(v, H);
    };
    // the frame column of carry-ring index v
    auto ccol = [&](int v) -> long long {
      if (WHOLE) return v;
      if (!a.windows) return static_cast<long long>(w0) - 2ll * hw * Sw + v;
      const int qv = v / Sw;
      return w0 + static_cast<long long>(qv - 2 * hw) * a.Dc + (v - qv * Sw);
    };
    auto fetch_carry = [&](long long p) {
      const int slot = static_cast<int>((p - p0 + 2 * hw) % NC);
      const long long ro = frame_src + src_row(p) * W;
      fetch_row(ring + slot * a.pitch_c, a.carry + ro, ro, span_c, W, win,
                a.vec_c, ccol);
    };
    const long long n_ticks = p1 - p0 + 2 * hw + 1;
    for (long long p = p0 - 2 * hw; p <= p0; ++p) fetch_carry(p);
    cp_commit();
    for (long long t = 0; t < n_ticks; ++t) {
      // the chain at position qc, the output one tick behind at qo
      const long long qc = p0 - hw + t, qo = qc - hw - 1;
      const bool chain = qc < p1 + hw, out = qo >= p0;
      cp_wait<0>();
      __syncthreads();
      const bool acc_in = out && a.acc_mode == 2;
      const long long ro = frame_out + out_row(qo) * W + w0;
      if (acc_in) {
        fetch_row(accb, a.acc + ro, ro, n_out, n_out, 1 << 30, a.vec_a,
                  [](int v) { return static_cast<long long>(v); });
        cp_commit();
      }
      const bool more = qc + hw + 1 < p1 + 2 * hw;
      if (more) {
        fetch_carry(qc + hw + 1);
        cp_commit();
      }
      // ring slots: carry position p in (p - p0 + 2hw) % NC, detail
      // position p in (p - p0 + hw) % ND; ti = qc - p0 + hw
      const int ti = static_cast<int>(t);
      int so[2 * WT_MAX_HW + 1], dso[2 * WT_MAX_HW + 1];
#pragma unroll
      for (int i = 0; i <= 2 * hw; ++i) {
        so[i] = (ti + i) % NC * a.pitch_c;    // carry qc - hw + i
        dso[i] = (ti + i) % ND * a.pitch_d;   // detail qo - hw + i
      }
      if (chain) {
        for (int v = tid * kCols; v < span_c; v += kStreamThreads * kCols) {
          if (kCols == 2 && v + 1 < span_c) {
            const float2 c = ld2(ring + so[hw] + v);
            float ox = __fmul_rn(c.x, t0), oy = __fmul_rn(c.y, t0);
#pragma unroll
            for (int j = 1; j <= hw; ++j) {
              const float2 l = ld2(ring + so[hw - j] + v);
              const float2 rr = ld2(ring + so[hw + j] + v);
              ox = __fadd_rn(ox, __fmul_rn(a.taps.t[j], __fadd_rn(l.x, rr.x)));
              oy = __fadd_rn(oy, __fmul_rn(a.taps.t[j], __fadd_rn(l.y, rr.y)));
            }
            *reinterpret_cast<float2*>(T1 + v) = make_float2(ox, oy);
            continue;
          }
          for (int e = v; e < min(v + kCols, span_c); ++e) {
            float o = __fmul_rn(ring[so[hw] + e], t0);
#pragma unroll
            for (int j = 1; j <= hw; ++j)
              o = __fadd_rn(o, __fmul_rn(a.taps.t[j],
                                         __fadd_rn(ring[so[hw - j] + e],
                                                   ring[so[hw + j] + e])));
            T1[e] = o;
          }
        }
      }
      if (out) {
        for (int u = tid * kCols; u < span_d; u += kStreamThreads * kCols) {
          if (kCols == 2 && u + 1 < span_d) {
            const float2 x = ld2(det + dso[hw] + u);
            float ox = __fmul_rn(__fmul_rn(x.x, x.x), t0);
            float oy = __fmul_rn(__fmul_rn(x.y, x.y), t0);
#pragma unroll
            for (int j = 1; j <= hw; ++j) {
              const float2 l = ld2(det + dso[hw - j] + u);
              const float2 rr = ld2(det + dso[hw + j] + u);
              ox = __fadd_rn(ox, __fmul_rn(a.taps.t[j],
                                           __fadd_rn(__fmul_rn(l.x, l.x),
                                                     __fmul_rn(rr.x, rr.x))));
              oy = __fadd_rn(oy, __fmul_rn(a.taps.t[j],
                                           __fadd_rn(__fmul_rn(l.y, l.y),
                                                     __fmul_rn(rr.y, rr.y))));
            }
            *reinterpret_cast<float2*>(T2 + u) = make_float2(ox, oy);
            continue;
          }
          for (int e = u; e < min(u + kCols, span_d); ++e) {
            const float x = det[dso[hw] + e];
            float o = __fmul_rn(__fmul_rn(x, x), t0);
#pragma unroll
            for (int j = 1; j <= hw; ++j) {
              const float l = det[dso[hw - j] + e], rr = det[dso[hw + j] + e];
              o = __fadd_rn(o, __fmul_rn(a.taps.t[j],
                                         __fadd_rn(__fmul_rn(l, l),
                                                   __fmul_rn(rr, rr))));
            }
            T2[e] = o;
          }
        }
      }
      if (acc_in) {
        if (more) cp_wait<1>();
        else cp_wait<0>();
      }
      __syncthreads();
      // the cols folds: a pair of columns from float2 taps where the
      // pair's taps are pairs (an even dilation; whole rows: inside the
      // row), else one column at a time
      const int step = WHOLE ? Dc : Sw, reach = hw * step;
      const bool pairs = kCols == 2 && (step & 1) == 0;
      auto cols2 = [&](const float* T, int c, bool inner) -> float2 {
        if (inner) {
          const float2 m0 = *reinterpret_cast<const float2*>(T + c);
          float fx = __fmul_rn(m0.x, t0), fy = __fmul_rn(m0.y, t0);
#pragma unroll
          for (int j = 1; j <= hw; ++j) {
            const float2 l = *reinterpret_cast<const float2*>(T + c - j * step);
            const float2 rr = *reinterpret_cast<const float2*>(T + c + j * step);
            fx = __fadd_rn(fx, __fmul_rn(a.taps.t[j], __fadd_rn(l.x, rr.x)));
            fy = __fadd_rn(fy, __fmul_rn(a.taps.t[j], __fadd_rn(l.y, rr.y)));
          }
          return make_float2(fx, fy);
        }
        if (WHOLE)
          return make_float2(fold_whole<HW>(T, c, W, Dc, a.taps),
                             fold_whole<HW>(T, c + 1, W, Dc, a.taps));
        return make_float2(fold_run<HW>(T, c, Sw, a.taps),
                           fold_run<HW>(T, c + 1, Sw, a.taps));
      };
      if (chain) {
        const int sd = ti % ND * a.pitch_d;
        const bool own = qc >= p0 && qc < p1;
        float* nrow = a.c_next + frame_out + out_row(qc) * W + w0;
        for (int u = tid * kCols; u < span_d; u += kStreamThreads * kCols) {
          const int uc = WHOLE ? u : u + hw * Sw;
          const int o = WHOLE ? u : u - hw * Sw;
          if (pairs && u + 1 < span_d) {
            const float2 f = cols2(T1, uc, !WHOLE || (uc >= reach &&
                                                      uc + 1 + reach < W));
            const float2 c = ld2(ring + so[hw] + uc);
            // the detail from the unrounded smooth, as the JAX stream
            // forms it
            *reinterpret_cast<float2*>(det + sd + u) =
                make_float2(__fsub_rn(c.x, f.x), __fsub_rn(c.y, f.y));
            if (own && a.st_pairs && o >= 0 && o + 1 < n_out) {
              st2(nrow + o, f.x, f.y);
              continue;
            }
            if (own && o >= 0 && o < n_out) nrow[o] = f.x;
            if (own && o + 1 >= 0 && o + 1 < n_out) nrow[o + 1] = f.y;
            continue;
          }
          for (int e = 0; e < kCols && u + e < span_d; ++e) {
            const float f = WHOLE ? fold_whole<HW>(T1, u + e, W, Dc, a.taps)
                                  : fold_run<HW>(T1, uc + e, Sw, a.taps);
            det[sd + u + e] = __fsub_rn(ring[so[hw] + uc + e], f);
            if (own && o + e >= 0 && o + e < n_out) nrow[o + e] = f;
          }
        }
      }
      if (out) {
        auto epilogue = [&](int o, float c, float lp) {
          float wc;
          const float v2 = whiten(c, lp, &wc);
          if (a.white) a.white[ro + o] = wt::from_f32<S>(v2);
          if (a.acc_mode == 1) a.acc[ro + o] = v2;
          else if (a.acc_mode == 2) a.acc[ro + o] = __fadd_rn(accb[o], v2);
        };
        for (int o = tid * kCols; o < n_out; o += kStreamThreads * kCols) {
          const int u = WHOLE ? o : o + hw * Sw;
          if (pairs && o + 1 < n_out) {
            const float2 lp = cols2(T2, u, !WHOLE || (u >= reach &&
                                                      u + 1 + reach < W));
            const float2 c = ld2(det + dso[hw] + u);
            if (a.st_pairs) {
              float wc;
              const float vx = whiten(c.x, lp.x, &wc);
              const float vy = whiten(c.y, lp.y, &wc);
              if (a.white) st2(a.white + ro + o, vx, vy);
              if (a.acc_mode == 1) st2(a.acc + ro + o, vx, vy);
              else if (a.acc_mode == 2)
                st2(a.acc + ro + o, __fadd_rn(accb[o], vx),
                    __fadd_rn(accb[o + 1], vy));
              continue;
            }
            epilogue(o, c.x, lp.x);
            epilogue(o + 1, c.y, lp.y);
            continue;
          }
          for (int e = 0; e < kCols && o + e < n_out; ++e) {
            const float lp = WHOLE ? fold_whole<HW>(T2, o + e, W, Dc, a.taps)
                                   : fold_run<HW>(T2, u + e, Sw, a.taps);
            epilogue(o + e, det[dso[hw] + u + e], lp);
          }
        }
      }
    }
    __syncthreads();  // the next item's prologue refills the rings
  }
}

template <int HW, bool WHOLE, class S>
static int launch_stream(const StreamArgs<S>& a, long long grid, int bytes,
                         cudaStream_t s) {
  static std::atomic<int> optin[wt::kMaxDevices];
  cudaError_t err = wt::smem_optin(deep_stream<HW, WHOLE, S>, bytes, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  deep_stream<HW, WHOLE, S>
      <<<static_cast<unsigned>(grid), kStreamThreads,
         static_cast<size_t>(bytes), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One scale on the stream: carry (B, Hs, W), c_next and acc (B, H, W) of
// float32, white (B, H, W) of S; Hs = H + 2*halo.
template <class S>
int whiten_stream(const float* carry, float* c_next, S* white, float* acc,
                  int acc_mode, const float* thr, float fac, int masked,
                  int soft,
                  const double* taps, int n_taps, long long B, long long H,
                  long long W, long long D, long long halo,
                  const StreamPlan& p, void* stream) {
  StreamArgs<S> a = {};
  if (!wt::make_taps(taps, n_taps, &a.taps) || !carry || !c_next ||
      acc_mode < 0 || acc_mode > 2 || (acc_mode != 0 && !acc) ||
      (masked && !thr) || !stream_layout(&a, p, B, H, W, D, halo))
    return static_cast<int>(cudaErrorInvalidValue);
  a.carry = carry;
  a.c_next = c_next;
  a.white = white;
  a.acc = acc;
  a.thr = thr;
  a.fac = fac;
  a.acc_mode = acc_mode;
  a.masked = masked;
  a.soft = soft;
  a.vec_c = aligned16(carry);
  a.vec_a = acc != nullptr && aligned16(acc);
  a.st_pairs = W % 2 == 0 && aligned16(c_next) &&
               (white == nullptr || aligned16(white)) &&
               (acc == nullptr || aligned16(acc));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bytes = static_cast<int>(p.smem);
  return wt::dispatch_hw(a.taps.hw, [&](auto hw) {
    constexpr int HW = decltype(hw)::value;
    return p.seg == 0 ? launch_stream<HW, true>(a, p.grid, bytes, s)
                      : launch_stream<HW, false>(a, p.grid, bytes, s);
  });
}

}  // namespace

extern "C" {

const char* wt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One scale at dilation D (any, up to 2^62) on a (B, H, W) float32
// stack, all pointers on the device and contiguous.  detail is scratch of
// the same size; white and acc may be null (acc_mode 0 = none, 1 = acc =
// white, 2 = acc += white).  thr points at B per-frame thresholds (read
// only when masked).  taps: n_taps symmetric host-side weights.  The
// launch is the wrapper's plan (ops/hopper_conv.py::step_plan), the same
// for both launches: seg (0 for whole rows, else the segment width),
// grid_rows x grid_segs x frames blocks (a launch per `frames`
// consecutive frames), smem_bytes of shared memory, index_bits (32 or 64)
// wide offsets; it is checked (wt::step_plan_ok) and launched as given.
// Returns cudaErrorInvalidValue for arguments or a plan the kernel does
// not take, else cudaGetLastError() after the first failing launch, or 0.
int wt_whiten_step_f32(const float* carry, float* c_next, float* detail,
                       float* white, float* acc, int acc_mode,
                       const float* thr, float fac, int masked, int soft,
                       const double* taps, int n_taps, long long B,
                       long long H, long long W, long long D, long long seg,
                       long long grid_rows, long long grid_segs,
                       long long frames, long long smem_bytes,
                       int index_bits, void* stream) {
  return whiten_step_f32(carry, c_next, detail, white, acc, acc_mode, thr,
                         fac, masked, soft, taps, n_taps, B, H, W, D, seg,
                         grid_rows, grid_segs, frames, smem_bytes,
                         index_bits, stream);
}

// The same scale on the stream from a float32 carry, the white stored in
// bfloat16 (the bfloat16 route's deep step): c_next and acc float32, the
// thresholds float32, nothing rounded but the white on its store.  The
// plan is the wrapper's (ops/hopper_conv.py::stream_step_plan): seg,
// chunk, grid and smem_bytes as StreamPlan above, checked (stream_layout)
// and launched as given.  Returns as wt_whiten_step_f32.
int wt_whiten_step_bf16(const float* carry, float* c_next,
                        __nv_bfloat16* white, float* acc, int acc_mode,
                        const float* thr, float fac, int masked, int soft,
                        const double* taps, int n_taps, long long B,
                        long long H, long long W, long long D, long long seg,
                        long long chunk, long long grid, long long smem_bytes,
                        void* stream) {
  return whiten_stream(carry, c_next, white, acc, acc_mode, thr, fac, masked,
                       soft, taps, n_taps, B, H, W, D, 0,
                       StreamPlan{seg, chunk, grid, smem_bytes}, stream);
}

// One scale in halo mode on a float32 band, one launch of the stream:
// carry (B, H + 2*halo, W), a band extended by halo = 2*hw*D rows a side
// (its neighbours' rows or the image's reflection), read without row
// reflection; c_next, white and acc (B, H, W), the interior rows.  The
// plan is the wrapper's (stream_step_plan with halo), as above.
int wt_whiten_step_halo_f32(
    const float* carry, float* c_next, float* white, float* acc,
    int acc_mode, const float* thr, float fac, int masked, int soft,
    const double* taps, int n_taps, long long B, long long H, long long W,
    long long D, long long halo, long long seg, long long chunk,
    long long grid, long long smem_bytes, void* stream) {
  if (halo < 1) return static_cast<int>(cudaErrorInvalidValue);
  return whiten_stream(carry, c_next, white, acc, acc_mode, thr, fac, masked,
                       soft, taps, n_taps, B, H, W, D, halo,
                       StreamPlan{seg, chunk, grid, smem_bytes}, stream);
}

}  // extern "C"
