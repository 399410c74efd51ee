// Whitening of given detail planes on the card (kernel D): power smooth,
// mask, runtime factor, partial reconstruction and the gamma sum.
// Plain C interface, loaded with ctypes (wavelets_tpu_torch/ops/_build.py);
// wrappers and launch plans in ops/hopper_wow.py (fused_whiten_pieces,
// pieces_plan, launch_whiten_plane) and ops/hopper_deep.py
// (deep_whiten_plane), the deep form's plan ops/hopper_conv.py::step_plan.
//
// Replaces two TPU kernels that whiten materialized planes and differ only
// in how they fit the TPU's VMEM:
//   wavelets_tpu/ops/pallas_wow.py::fused_whiten_pieces
//     (_make_whiten_kernel), scales 0..n-1 of decompose pieces on halo'd
//     tiles with a (scale, frame) factor table, partial recon and gamma;
//   wavelets_tpu/ops/pallas_deep.py::deep_whiten_plane
//     (_make_plane_kernel), one deep plane on residue-class row streams.
// Per scale s, at dilation 2^s: the power smooth of c^2, clamped <=0 ->
// 1e-15, then sqrt; the erf or hard mask (threshold 0 = none) giving wc;
// white = wc*(fac/lp), fac and thr per frame from device memory, so
// preserve_variance's w*sqrt(mean(c^2)) and the noise estimate never
// make a host round trip.
//
// Design.  Two forms, both row-buffer passes with no scratch plane:
//   deep plane (wt_whiten_plane_f32): one launch of wt_step.cuh's SECOND
//     pass, kernel A's deep step and kernel G's second launch: a block
//     folds one image row (or a segment) of c^2 down the 2hw+1 tap rows
//     into shared memory, the raw centre row beside it, and the columns
//     out of it; the epilogue writes the white (optional), recon (set or
//     +=) and gamma (set or +=), fac[b] read per frame.  A plane moves 2
//     plane-sized arrays (read c, write white), 4 with recon +=.
//   pieces (wt_whiten_pieces_f32): scales 0..n-1 (n <= 3) in one launch.
//     A block owns image row h (or a segment of it) and, for each scale,
//     folds the tap rows h + j*2^s of that scale's plane^2, each plane
//     by its own pointer, into a row buffer beside its raw centre row: 2n
//     buffers, in segments of 2048 columns with a contiguous hw*2^s halo
//     (whole rows up to W = 2372), 49 KB for n = 3, so that four blocks of
//     512 threads share an SM.  The three scales' fills run in one loop,
//     so a thread has 3(2hw+1) loads in flight.  The
//     epilogue whitens the scales of a column and writes the whites,
//     recon = (w0 + w1) + w2 and gamma = (wc0 + wc1) + wc2: 8 arrays at
//     n = 3 with gamma (read 3 planes; write 3 whites, recon, gamma),
//     against 16 for three deep-form launches.  The whites go to n
//     pointers with a frame stride: n (B, H, W) planes (scale-major), or
//     rows 0..n-1 of the batch-major (B, R, H, W) cube a frame stack keeps
//     its planes in, written in place as the TPU kernel's batch-major
//     block does (pallas_wow.py:346-355); rows n..R-1 are the caller's.
//
// Bound: device memory.  The pieces form must read 3 planes and write 3
// whites, recon and gamma (0.54 GB at 4096^2: 0.160 ms at 3.35 TB/s), a
// deep plane with recon += read the plane and recon and write the white
// and recon (0.080 ms).  Measured on an H100 80GB HBM3 at 700 W
// (scripts/kernel_variants.py, device time at 4096^2): the pieces form
// 0.389-0.390 ms (whole rows, two blocks to an SM: 0.447; three
// deep-form launches: 0.553; the first-port design: 1.501), a deep plane
// 0.158-0.174 ms for s = 3..9 (first port: 0.518-0.629 with the separate
// recon add).  A block reads each of its 2hw+1 tap rows a scale from L2,
// so the pieces form moves 3(2hw+1) plane rows through L2 a row of
// output; a block owning several rows would share them (PERF.md).
//
// Rounding.  The folds round step by step in the JAX package's order
// (wt_common.cuh), the epilogue is wt::whiten_value and the sums add in
// the scale order, so both forms are bitwise equal to the first-port
// design, kept as the check-only entry wt_whiten_plane_ref_f32 (a rows
// pass into a tmp plane, then a per-pixel cols pass with the epilogue),
// which no path calls.  Against the plain PyTorch version erff may differ
// from torch.erf in the last place, inside the 5e-6*max standard.
//
// Launch.  Segment width, grid, shared bytes and offset width are the
// wrappers' plans (step_plan, pieces_plan), checked here and launched as
// given; a batch past 65535 frames runs as several launches.

#include "wt_step.cuh"

namespace {

using wt::Taps;

// the scales one pieces launch whitens at most (N_FAST)
constexpr int kPieces = 3;
constexpr int kPiecesThreads = 512;

struct PiecesArgs {
  const float* src[kPieces];  // scale s's plane, this launch's frame 0
  float* white[kPieces];      // or null
  float* recon;               // set
  float* gamma;               // set, or null
  const float* fac;           // (n, stride) table from this launch's frame
  const float* thr;           // likewise, or null: no mask
  long long stride;           // frames of the tables
  long long wstride;          // elements from a frame's white to the next
  int n, soft, H, W, seg;
  int Dr[kPieces], Dc[kPieces];  // map_step(2^s) of the rows, the columns
  Taps taps;
};

// Rows h of one frame (blockIdx.x, blockIdx.z), columns of one segment
// (blockIdx.y) or whole rows.  Shared memory, per scale s: the row buffer
// T_s (the segment and a contiguous hw*Dc_s halo on each side; the row
// where whole) and the raw centre row ctr_s.
template <bool WHOLE, typename Idx, int HW>
__global__ void __launch_bounds__(kPiecesThreads)
    pieces_pass(PiecesArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ Idx roff[kPieces][2 * WT_MAX_HW + 1];
  const int H = a.H, W = a.W, n = a.n;
  const int hw = wt::half_width<HW>(a.taps);
  const int h = blockIdx.x, b = blockIdx.z;
  const Idx base = static_cast<Idx>(b) * H * W;
  for (int i = threadIdx.x; i < n * (2 * hw + 1); i += kPiecesThreads) {
    const int s = i / (2 * hw + 1), j = i - s * (2 * hw + 1);
    roff[s][j] =
        base + static_cast<Idx>(wt::sym32(h + (j - hw) * a.Dr[s], H)) * W;
  }
  const int w0 = WHOLE ? 0 : blockIdx.y * a.seg;
  const int n_out = WHOLE ? W : min(a.seg, W - w0);
  float* T[kPieces];
  float* ctr[kPieces];
  int span[kPieces];
  int span_max = 0;
  float* next = sm;
#pragma unroll
  for (int s = 0; s < kPieces; ++s) {
    span[s] = WHOLE ? W : 2 * hw * a.Dc[s] + n_out;
    T[s] = next;
    ctr[s] = next + (WHOLE ? W : 2 * hw * a.Dc[s] + a.seg);
    next = ctr[s] + (WHOLE ? W : a.seg);
    if (s < n) span_max = max(span_max, span[s]);
  }
  __syncthreads();
  for (int v = threadIdx.x; v < span_max; v += kPiecesThreads) {
#pragma unroll
    for (int s = 0; s < kPieces; ++s) {
      if (s >= n || (!WHOLE && v >= span[s])) continue;
      const int c = WHOLE ? v : wt::sym32(w0 - hw * a.Dc[s] + v, W);
      const float* __restrict__ src = a.src[s];
      const float x0 = src[roff[s][hw] + c];
      float o = __fmul_rn(__fmul_rn(x0, x0), a.taps.t[0]);
#pragma unroll
      for (int j = 1; j <= hw; ++j) {
        float l = src[roff[s][hw - j] + c], r = src[roff[s][hw + j] + c];
        l = __fmul_rn(l, l);
        r = __fmul_rn(r, r);
        o = __fadd_rn(o, __fmul_rn(a.taps.t[j], __fadd_rn(l, r)));
      }
      T[s][v] = o;
      const int u = WHOLE ? v : v - hw * a.Dc[s];
      if (WHOLE || (u >= 0 && u < n_out)) ctr[s][u] = x0;
    }
  }
  __syncthreads();
  float fac[kPieces];
  const float* thr[kPieces];
#pragma unroll
  for (int s = 0; s < kPieces; ++s) {
    fac[s] = s < n ? a.fac[s * a.stride + b] : 0.0f;
    thr[s] = a.thr && s < n ? a.thr + s * a.stride + b : nullptr;
  }
  const Idx row = base + static_cast<Idx>(h) * W;
  for (int o = threadIdx.x; o < n_out; o += kPiecesThreads) {
    const int w = w0 + o;
    const Idx g = row + w;
    const Idx gw = static_cast<Idx>(b) * a.wstride +
                   static_cast<Idx>(h) * W + w;
    float rec = 0.0f, gam = 0.0f;
#pragma unroll
    for (int s = 0; s < kPieces; ++s) {
      if (s >= n) continue;
      const int Dc = a.Dc[s];
      const int v = WHOLE ? w : o + hw * Dc;
      float f = __fmul_rn(T[s][v], a.taps.t[0]);
#pragma unroll
      for (int j = 1; j <= hw; ++j) {
        const float l = T[s][WHOLE ? wt::sym32(w - j * Dc, W) : v - j * Dc];
        const float r = T[s][WHOLE ? wt::sym32(w + j * Dc, W) : v + j * Dc];
        f = __fadd_rn(f, __fmul_rn(a.taps.t[j], __fadd_rn(l, r)));
      }
      float wc;
      const float wv =
          wt::whiten_value(ctr[s][o], f, fac[s], thr[s], a.soft, &wc);
      if (a.white[s]) a.white[s][gw] = wv;
      // the first-port design's order (set at scale 0, add the later
      // ones), so recon and gamma keep its bits
      rec = s == 0 ? wv : __fadd_rn(rec, wv);
      gam = s == 0 ? wc : __fadd_rn(gam, wc);
    }
    a.recon[g] = rec;
    if (a.gamma) a.gamma[g] = gam;
  }
}

// Shared bytes of a pieces block: per scale a row buffer and a centre
// row, whole (2W floats) or of a segment (2 seg + 2hw*Dc_s floats).
long long pieces_smem(int n, int hw, long long W, long long seg) {
  long long floats = 0;
  for (int s = 0; s < n; ++s)
    floats += seg == 0 ? 2 * W : 2 * seg + 2ll * hw * wt::map_step(1ll << s, W);
  return 4 * floats;
}

// Whether pieces_pass runs `p` on n scales of a (B, H, W) stack with taps
// of half width hw and whites wstride >= H*W elements from frame to frame:
// a block row per image row, every segment, at most kMaxFrames frames a
// launch, each segment's halo contiguous (Dc_s <= seg), the buffers in the
// shared memory, the taps' reach in 32-bit index math, 32-bit offsets only
// where they cannot overflow (the whites' too).
bool pieces_plan_ok(const wt::StepPlan& p, int hw, int n, long long B,
                    long long H, long long W, long long wstride) {
  if (n < 1 || n > kPieces || B < 1 || H < 1 || W < 1 || H >= (1ll << 30) ||
      W >= (1ll << 30) || p.seg < 0 || (p.seg > 0 && p.seg >= W) ||
      wstride < H * W)
    return false;
  for (int s = 0; s < n; ++s) {
    const long long Dr = wt::map_step(1ll << s, H);
    const long long Dc = wt::map_step(1ll << s, W);
    if (H + hw * Dr >= (1ll << 31) || W + p.seg + hw * Dc >= (1ll << 31) ||
        (p.seg > 0 && Dc > p.seg))
      return false;
  }
  const long long frames = B < wt::kMaxFrames ? B : wt::kMaxFrames;
  return p.grid_rows == H &&
         p.grid_segs == (p.seg == 0 ? 1 : (W + p.seg - 1) / p.seg) &&
         p.grid_segs <= 65535 && p.frames == frames &&
         p.smem >= pieces_smem(n, hw, W, p.seg) && p.smem <= (1ll << 30) &&
         (p.index_bits == 64 ||
          (p.index_bits == 32 && frames * wstride < (1ll << 31)));
}

template <bool WHOLE, typename Idx, int HW>
static int launch_pieces(const PiecesArgs& a, dim3 grid, int bytes,
                         cudaStream_t s) {
  static std::atomic<int> optin[wt::kMaxDevices];
  cudaError_t err =
      wt::smem_optin(pieces_pass<WHOLE, Idx, HW>, bytes, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  pieces_pass<WHOLE, Idx, HW>
      <<<grid, kPiecesThreads, static_cast<size_t>(bytes), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The first-port cols pass of the check-only reference entry.
__global__ void cols_whiten_plane(const float* __restrict__ tmp,
                                  const float* __restrict__ plane,
                                  float* __restrict__ white,
                                  float* __restrict__ recon, int recon_mode,
                                  float* __restrict__ gamma, int gamma_mode,
                                  const float* __restrict__ fac,
                                  const float* __restrict__ thr, int soft,
                                  Taps taps, long long B, long long H,
                                  long long W, long long D) {
  WT_FOR_EACH_PIXEL {
    long long row = (b * H + h) * W, i = row + w;
    float wc;
    float v = wt::whiten_value(plane[i],
                               wt::fold_cols(tmp + row, taps, w, W, D),
                               fac[b], thr ? thr + b : nullptr, soft, &wc);
    if (white) white[i] = v;
    if (recon_mode == 1) recon[i] = v;
    else if (recon_mode == 2) recon[i] = __fadd_rn(recon[i], v);
    if (gamma_mode == 1) gamma[i] = wc;
    else if (gamma_mode == 2) gamma[i] = __fadd_rn(gamma[i], wc);
  }
}

bool mode_ok(int mode, const float* out) {
  return mode == 0 || ((mode == 1 || mode == 2) && out);
}

}  // namespace

extern "C" {

const char* wt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The deep-plane form: whiten the contiguous (B, H, W) float32 detail
// plane at dilation D (any, up to 2^62) in one row-buffer launch (a launch
// per `frames` frames).  white, recon, gamma: (B, H, W) or null, none of
// them the plane; recon_mode / gamma_mode 0 = none, 1 = set, 2 = +=.
// fac: B per-frame factors on the device; thr: B per-frame thresholds on
// the device, or null for no mask.  taps: n_taps symmetric host-side
// weights.  The launch is the wrapper's step_plan (seg, grid_rows x
// grid_segs x frames blocks, smem_bytes, index_bits), checked
// (wt::step_plan_ok) and launched as given.  Returns
// cudaErrorInvalidValue for arguments or a plan the kernel does not
// take, else cudaGetLastError() after the launches, or 0.
int wt_whiten_plane_f32(const float* plane, float* white, float* recon,
                        int recon_mode, float* gamma, int gamma_mode,
                        const float* fac, const float* thr, int soft,
                        const double* taps, int n_taps, long long B,
                        long long H, long long W, long long D, long long seg,
                        long long grid_rows, long long grid_segs,
                        long long frames, long long smem_bytes,
                        int index_bits, void* stream) {
  wt::PlaneArgs a = {};
  const wt::StepPlan p = {seg, grid_rows, grid_segs, frames, smem_bytes,
                          index_bits};
  if (!wt::make_taps(taps, n_taps, &a.taps) || !plane || !fac ||
      !mode_ok(recon_mode, recon) || !mode_ok(gamma_mode, gamma) ||
      white == plane || recon == plane || gamma == plane ||
      !wt::step_plan_ok(p, a.taps.hw, B, H, W, D))
    return static_cast<int>(cudaErrorInvalidValue);
  a.detail = const_cast<float*>(plane);
  a.white = white;
  a.acc = recon;
  a.acc_mode = recon_mode;
  a.gamma = gamma;
  a.gamma_mode = gamma_mode;
  a.facp = fac;
  a.thr = thr;
  a.masked = thr != nullptr;
  a.soft = soft;
  a.H = static_cast<int>(H);
  a.W = static_cast<int>(W);
  return wt::run_step_pass<true>(a, p, B, D,
                                static_cast<cudaStream_t>(stream));
}

// The pieces form: scales 0..n-1 (n <= 3) at dilations 2^s in one launch
// (a launch per `frames` frames).  src: n contiguous (B, H, W) float32
// planes on the device; white: n pointers to frame 0 of a scale's white,
// frames wstride >= H*W elements apart (H*W: n (B, H, W) planes; R*H*W:
// scale s of a batch-major (B, R, H, W) cube, which leaves the rows past
// n to the caller), or null pointers (or a null array); recon (set) and
// gamma (set, or null) (B, H, W); no output is a source.  fac: (n, B)
// factors on the device; thr: (n, B)
// thresholds (0 = no mask) or null.  The launch is the wrapper's
// pieces_plan (seg, grid_rows x grid_segs x frames blocks of 512 threads,
// smem_bytes, index_bits), checked (pieces_plan_ok) and launched as
// given.  Returns cudaErrorInvalidValue for arguments or a plan the
// kernel does not take, else cudaGetLastError() after the launches, or 0.
int wt_whiten_pieces_f32(const float* const* src, float* const* white,
                         float* recon, float* gamma, const float* fac,
                         const float* thr, int soft, int n,
                         const double* taps, int n_taps, long long B,
                         long long H, long long W, long long wstride,
                         long long seg, long long grid_rows,
                         long long grid_segs, long long frames,
                         long long smem_bytes, int index_bits,
                         void* stream) {
  PiecesArgs a = {};
  const wt::StepPlan p = {seg, grid_rows, grid_segs, frames, smem_bytes,
                          index_bits};
  if (!wt::make_taps(taps, n_taps, &a.taps) || !src || !recon || !fac ||
      !pieces_plan_ok(p, a.taps.hw, n, B, H, W, wstride))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int s = 0; s < n; ++s) {
    const float* outs[] = {recon, gamma, white ? white[s] : nullptr};
    if (!src[s]) return static_cast<int>(cudaErrorInvalidValue);
    for (int k = 0; k < n; ++k)
      for (const float* out : outs)
        if (out == src[k]) return static_cast<int>(cudaErrorInvalidValue);
  }
  a.n = n;
  a.soft = soft;
  a.H = static_cast<int>(H);
  a.W = static_cast<int>(W);
  a.seg = static_cast<int>(seg);
  a.stride = B;
  a.wstride = wstride;
  for (int s = 0; s < n; ++s) {
    a.Dr[s] = static_cast<int>(wt::map_step(1ll << s, H));
    a.Dc[s] = static_cast<int>(wt::map_step(1ll << s, W));
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (long long b0 = 0; b0 < B; b0 += frames) {
    PiecesArgs c = a;
    const long long off = b0 * H * W;
    for (int s = 0; s < n; ++s) {
      c.src[s] = src[s] + off;
      c.white[s] = white ? wt::shift(white[s], b0 * wstride) : nullptr;
    }
    c.recon = recon + off;
    c.gamma = wt::shift(gamma, off);
    c.fac = fac + b0;
    c.thr = thr ? thr + b0 : nullptr;
    const dim3 grid(static_cast<unsigned>(grid_rows),
                    static_cast<unsigned>(grid_segs),
                    static_cast<unsigned>(B - b0 < frames ? B - b0 : frames));
    const int bytes = static_cast<int>(smem_bytes);
    const int err = wt::dispatch_hw(c.taps.hw, [&](auto hw) {
      constexpr int HW = decltype(hw)::value;
      if (index_bits == 32)
        return seg == 0 ? launch_pieces<true, int, HW>(c, grid, bytes, st)
                        : launch_pieces<false, int, HW>(c, grid, bytes, st);
      return seg == 0
                 ? launch_pieces<true, long long, HW>(c, grid, bytes, st)
                 : launch_pieces<false, long long, HW>(c, grid, bytes, st);
    });
    if (err) return err;
  }
  return 0;
}

// Check-only: the first-port design of one scale, two per-pixel launches
// through tmp ((B, H, W) scratch): wt_common.cuh's rows_pass<true> on c^2,
// then cols_whiten_plane with the epilogue, every tap through the
// symmetric index map in 64-bit arithmetic.  The other arguments are
// those of wt_whiten_plane_f32 without the plan.  Returns
// cudaGetLastError() after the first failing launch, or 0.
int wt_whiten_plane_ref_f32(const float* plane, float* tmp, float* white,
                            float* recon, int recon_mode, float* gamma,
                            int gamma_mode, const float* fac,
                            const float* thr, int soft, const double* taps,
                            int n_taps, long long B, long long H, long long W,
                            long long D, void* stream) {
  Taps tp;
  if (!wt::make_taps(taps, n_taps, &tp) || !plane || !tmp || !fac ||
      B < 1 || H < 1 || W < 1 || D < 1 || !mode_ok(recon_mode, recon) ||
      !mode_ok(gamma_mode, gamma))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 block(256);
  dim3 grid = wt::pixel_grid(B, H, W, block);
  wt::rows_pass<true><<<grid, block, 0, s>>>(plane, tmp, tp, B, H, W, D);
  WT_CHECK_LAUNCH();
  cols_whiten_plane<<<grid, block, 0, s>>>(tmp, plane, white, recon,
                                           recon_mode, gamma, gamma_mode,
                                           fac, thr, soft, tp, B, H, W, D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
