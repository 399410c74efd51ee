// Device code of the bilateral chain smooth on a ring of carry rows in
// shared memory, one launch per scale: kernels F (bilateral_group.cu) and
// G (bilateral_step.cu).
//
// A block owns a chunk of output rows of one residue class mod D (h,
// h+D, h+2D, ...) and one column segment.  The 2HW+1 carry rows h + jD
// (j = -HW..HW, through numpy's periodic symmetric index map) are a ring
// in shared memory: the next output row of the class needs one new row,
// loaded with cp.async into the slot of the row that left, 16 bytes a
// copy inside the frame and one reflected column a copy outside it.  Per
// output row, in the JAX package's XLA order (wt_bilateral.cuh):
//   A. the rows folds of x and x*x across the ring -> tm, tq rows in
//      shared memory;
//   B. per output pixel: the cols folds of tm and tq, the range factor
//      inv2v = 0.5 / ((max-rule(m2 - mean*mean) * sig2) * scl), kept in a
//      register, then the dense (2HW+1)^2 - 1 taps from the ring in
//      descending (dy, dx) order, w = k * expf(-(diff*diff) * inv2v),
//      nrm += w, acc += w*sh; c_next = acc / nrm and detail = carry -
//      c_next go to device memory.
// Every step is one IEEE operation (__fmul_rn/__fadd_rn/__fsub_rn/
// __fdiv_rn, never contracted) and expf the accurate one, so c_next and
// the detail are bitwise those of wt_bilateral.cuh's three passes.  No
// tm, tq or inv2v plane reaches device memory.
//
// Dilations.  The symmetric map has period 2n on an axis of n, so the
// kernel takes the rows' and the columns' dilation each as D, or, from
// 2n on, as 2n + D mod 2n (map_step): the same taps, the same residue
// classes and segment layout, in 32-bit index math at any scale.
//
// Segment layout.  A segment of `seg` output columns from w0 needs the
// columns w0 + jD + u (j = -HW..HW, u < seg) for the taps and for the
// cols folds of tm and tq (whose rows folds read the same ring columns).
// With S = min(D, seg), shared index v holds column
//   w0 + (v / S - HW) * D + v % S        (v < 2*HW*S + seg),
// mapped through the symmetric index map: for D < seg a contiguous span
// with an HW*D halo, for D >= seg the 2HW+1 windows side by side.  The
// tap at (dy, dx) of output u is then ring row HW+dy at (HW+dx)*S + u:
// plain offsets, no index map, at every dilation.  A ring row starts
// (c0 mod 4) floats past a 16-byte boundary, c0 the column of its index
// 0, so that shared and global addresses agree mod 16 bytes where the
// frame's rows do (W a multiple of 4) and the in-frame columns go in
// 16-byte copies; ring_smem gives the block's bytes.
//
// Issue.  The 24 taps of a pixel are one unrolled run of code with no
// branch, so the compiler interleaves their independent expf chains.  A
// tap of weight 0, which the reference skips, exists only for scaling
// functions with a zero tap (none of the repo's): the C entry then
// launches the ZEROS instance, which computes the tap and leaves it out
// of nrm and acc by a select.  256 threads a block, two blocks to an SM
// where the plan's shared memory allows.  Measured on an H100 at 700 W
// (scripts/kernel_variants.py, device time of a group of 3 at 4096^2):
// a branch a tap 1.36 ms, a select a tap 1.27 ms, neither 1.08 ms, at
// 512 threads; then 256 threads, two pixels a thread, 2048-column
// segments all 1.05-1.13 ms; the ring rows' 16-byte copies took 1.078 ->
// 1.038 ms at offset 0 and 1.091 -> 1.064 ms at offset 3 (one call), and
// as loops, not unrolled, 1.026-1.032 ms at both.

#pragma once

#include "wt_bilateral.cuh"
#include "wt_tile.cuh"

namespace wt {

constexpr int kRingThreads = 256;

struct RingArgs {
  const float* src;  // the carry, (B, H, W)
  float* c_next;     // (B, H, W)
  float* detail;     // (B, H, W)
  float sig2, scl;
  int H, W;
  int D, Dc;  // the rows' and the columns' dilation (map_step)
  int rows;   // output rows of a class per block
  int seg;    // output columns per block
  int n_cls;  // residue classes, min(D, H)
  Taps taps;
  BilKernel kern;
};

// One 4-byte asynchronous copy global -> shared.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// Floats of a ring row, and of the tm and tq rows: 2*HW*min(D, seg) +
// seg (ops/hopper_bilateral.py::ring_span).
__host__ __device__ inline long long ring_span(int hw, long long D,
                                               long long seg) {
  return 2ll * hw * (D < seg ? D : seg) + seg;
}

// Floats from one ring row's slot to the next: the span and room to
// start it up to 3 floats in, rounded to 16 bytes.
__host__ __device__ inline long long ring_stride(long long span) {
  return (span + 3 + 3) / 4 * 4;
}

// Shared bytes of a block: 2HW+1 ring slots, the tm and tq rows
// (ops/hopper_bilateral.py::ring_smem).
__host__ __device__ inline long long ring_smem(int hw, long long D,
                                               long long seg) {
  const long long span = ring_span(hw, D, seg);
  return 4 * ((2ll * hw + 1) * ring_stride(span) + 2 * span);
}

// The plan of one ring launch (ops/hopper_bilateral.py::BilateralPlan),
// as the C entries receive it.
struct RingPlan {
  long long rows, seg, grid_x, grid_y, smem;
};

// Whether bilateral_ring runs `p` on (H, W) frames at the true dilation
// D with taps of half width hw: every row of every residue class in one
// chunk, every column in one segment, the ring and the tm, tq rows in
// the shared memory, the taps' reach in 32-bit index math.  (The frames
// and the offset width are the caller's to check.)
inline bool ring_plan_ok(const RingPlan& p, int hw, long long H, long long W,
                         long long D) {
  if (H < 1 || W < 1 || D < 1 || H >= (1ll << 30) || W >= (1ll << 30))
    return false;
  const long long n_cls = D < H ? D : H, P = (H + D - 1) / D;
  return p.rows >= 1 && p.rows <= P && p.seg >= 1 && p.seg <= W &&
         p.grid_x == n_cls * ((P + p.rows - 1) / p.rows) &&
         p.grid_x <= 0x7fffffffll && p.grid_y == (W + p.seg - 1) / p.seg &&
         p.grid_y <= 65535 && p.smem >= ring_smem(hw, D, p.seg) &&
         p.smem <= (1ll << 30) &&
         H + (hw + 1ll) * map_step(D, H) < (1ll << 31) &&
         W + p.seg + hw * map_step(D, W) < (1ll << 31);
}

// Columns c0 .. c0+len-1 of `row` into dst[0..len), through the symmetric
// map of a row of W: those inside the frame in 16-byte copies where dst
// and the row agree mod 16 bytes (else 4-byte ones), the reflected ones
// outside it one by one.  Every thread of the block calls it.
__device__ __forceinline__ void load_span(float* dst, const float* row,
                                          int c0, int len, int W) {
  const int lo = min(max(-c0, 0), len);      // first index in the frame
  const int hi = max(min(W - c0, len), lo);  // end of the frame's part
  const int n_out = lo + (len - hi);
  for (int v = threadIdx.x; v < n_out; v += kRingThreads) {
    const int u = v < lo ? v : hi + (v - lo);
    cp_async4(dst + u, row + sym32(c0 + u, W));
  }
  float* d = dst + lo;
  const float* g = row + (c0 + lo);
  const int n = hi - lo;
  const unsigned da = static_cast<unsigned>(reinterpret_cast<uintptr_t>(d));
  const unsigned ga = static_cast<unsigned>(reinterpret_cast<uintptr_t>(g));
  int head = n, n4 = 0;  // scalars before the 16-byte run, its vectors
  if (((da ^ ga) & 15u) == 0u) {
    head = min(n, static_cast<int>(((16u - (da & 15u)) & 15u) >> 2));
    n4 = (n - head) >> 2;
  }
  for (int v = threadIdx.x; v < n4; v += kRingThreads)
    cp_async16(d + head + 4 * v, g + head + 4 * v);
  const int n1 = n - 4 * n4;  // the head and the tail, one by one
  for (int v = threadIdx.x; v < n1; v += kRingThreads) {
    const int u = v < head ? v : v + 4 * n4;
    cp_async4(d + u, g + u);
  }
}

template <int HW, typename Idx, bool ZEROS>
__global__ void __launch_bounds__(kRingThreads, 2)
    bilateral_ring(RingArgs a) {
  constexpr int N = 2 * HW + 1;
  extern __shared__ __align__(16) float sm[];
  const int H = a.H, W = a.W, D = a.D, Dc = a.Dc;
  const int cls = blockIdx.x % a.n_cls;
  const int i0 = (blockIdx.x / a.n_cls) * a.rows;
  const int P = (H - cls + D - 1) / D;  // rows of this class
  if (i0 >= P) return;  // the whole block, before any barrier
  const int i1 = min(i0 + a.rows, P);
  const int w0 = blockIdx.y * a.seg;
  const int n_out = min(a.seg, W - w0);
  const int S = min(Dc, a.seg);
  const int span = 2 * HW * S + a.seg;
  const int stride = static_cast<int>(ring_stride(span));
  const int c0 = w0 - HW * Dc;  // the column of shared index 0
  const int pad = c0 & 3;       // ring rows start c0 mod 4 floats in
  float* tm = sm + N * stride;
  float* tq = tm + span;
  const Idx plane = static_cast<Idx>(blockIdx.z) * H * W;
  const float* __restrict__ src = a.src + plane;
  float t[HW + 1];
#pragma unroll
  for (int j = 0; j <= HW; ++j) t[j] = a.taps.t[j];

  // carry row r into ring slot `slot`, in the segment layout: one
  // contiguous span, or the 2HW+1 windows of the taps (window q at shared
  // q*S from column c0 + q*Dc).  Loops, not unrolled: the loads are a
  // small part of a row's work, and unrolled copies of load_span took
  // the B3spline instance from 2312 to 22776 SASS instructions and the
  // library's nvcc build to 118 s.
  const int n_pieces = S < a.seg ? 1 : N;
  const int piece = S < a.seg ? span : S;
  auto load_row = [&](int slot, int r) {
    const float* row = src + static_cast<Idx>(r) * W;
    float* dst = sm + slot * stride + pad;
#pragma unroll 1
    for (int q = 0; q < n_pieces; ++q)
      load_span(dst + q * S, row, c0 + q * Dc, piece, W);
  };

  int h = cls + i0 * D;
#pragma unroll 1
  for (int j = -HW; j <= HW; ++j) load_row(j + HW, sym32(h + j * D, H));
  cp_async_wait_all();
  __syncthreads();
  int slot0 = 0;  // ring slot of row h - HW*D
  for (int i = i0; i < i1; ++i, h += D) {
    int ro[N];  // shared offset of ring row h + (j - HW)*D
#pragma unroll
    for (int j = 0; j < N; ++j) ro[j] = ((slot0 + j) % N) * stride + pad;
    // A: the rows folds of x and x*x
    for (int v = threadIdx.x; v < span; v += kRingThreads) {
      const float c = sm[ro[HW] + v];
      float m = __fmul_rn(c, t[0]);
      float q = __fmul_rn(__fmul_rn(c, c), t[0]);
#pragma unroll
      for (int j = 1; j <= HW; ++j) {
        const float l = sm[ro[HW - j] + v], r = sm[ro[HW + j] + v];
        m = __fadd_rn(m, __fmul_rn(t[j], __fadd_rn(l, r)));
        q = __fadd_rn(q, __fmul_rn(t[j], __fadd_rn(__fmul_rn(l, l),
                                                   __fmul_rn(r, r))));
      }
      tm[v] = m;
      tq[v] = q;
    }
    __syncthreads();
    // B: the cols folds, the range factor and the taps, per pixel
    const Idx out_row = plane + static_cast<Idx>(h) * W + w0;
    const float kc = a.kern.k[HW * N + HW];
    for (int u = threadIdx.x; u < n_out; u += kRingThreads) {
      const int vc = HW * S + u;
      float mean = __fmul_rn(tm[vc], t[0]);
      float m2 = __fmul_rn(tq[vc], t[0]);
#pragma unroll
      for (int j = 1; j <= HW; ++j) {
        mean = __fadd_rn(mean, __fmul_rn(t[j], __fadd_rn(tm[vc - j * S],
                                                         tm[vc + j * S])));
        m2 = __fadd_rn(m2, __fmul_rn(t[j], __fadd_rn(tq[vc - j * S],
                                                     tq[vc + j * S])));
      }
      float vari = __fsub_rn(m2, __fmul_rn(mean, mean));
      if (vari <= 0.0f) vari = 1e-20f;
      const float iv = __fdiv_rn(0.5f, __fmul_rn(__fmul_rn(vari, a.sig2),
                                                 a.scl));
      const float c = sm[ro[HW] + vc];
      float acc = __fmul_rn(c, kc);
      float nrm = kc;
#pragma unroll
      for (int ty = 0; ty < N; ++ty) {
#pragma unroll
        for (int tx = 0; tx < N; ++tx) {
          if (ty == HW && tx == HW) continue;
          const float k = a.kern.k[(N - 1 - ty) * N + (N - 1 - tx)];
          const float sh = sm[ro[N - 1 - ty] + (N - 1 - tx) * S + u];
          const float diff = __fsub_rn(c, sh);
          const float e = expf(__fmul_rn(-__fmul_rn(diff, diff), iv));
          const float w = __fmul_rn(k, e);
          const float nrm1 = __fadd_rn(nrm, w);
          const float acc1 = __fadd_rn(acc, __fmul_rn(w, sh));
          nrm = ZEROS && k == 0.0f ? nrm : nrm1;
          acc = ZEROS && k == 0.0f ? acc : acc1;
        }
      }
      const float cn = __fdiv_rn(acc, nrm);
      a.c_next[out_row + u] = cn;
      a.detail[out_row + u] = __fsub_rn(c, cn);
    }
    if (i + 1 < i1) {
      __syncthreads();  // every read of the leaving row done
      load_row(slot0, sym32(h + (HW + 1) * D, H));
      slot0 = slot0 + 1 == N ? 0 : slot0 + 1;
      cp_async_wait_all();
      __syncthreads();
    }
  }
}

// static: internal linkage, so the opt-in cache below is this library's
// own (a local static of an inline template is one object in a process,
// shared by every library that instantiates it, each with its own kernel).
template <int HW, typename Idx, bool ZEROS>
static int launch_bilateral_ring(const RingArgs& a, dim3 grid, int bytes,
                                 cudaStream_t s) {
  static std::atomic<int> optin[kMaxDevices];
  cudaError_t err =
      smem_optin(bilateral_ring<HW, Idx, ZEROS>, bytes, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  bilateral_ring<HW, Idx, ZEROS>
      <<<grid, kRingThreads, static_cast<size_t>(bytes), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HW>
static int launch_bilateral_ring(const RingArgs& a, dim3 grid, int bytes,
                                 bool idx32, bool zeros, cudaStream_t s) {
  if (zeros)
    return idx32 ? launch_bilateral_ring<HW, int, true>(a, grid, bytes, s)
                 : launch_bilateral_ring<HW, long long, true>(a, grid, bytes,
                                                              s);
  return idx32 ? launch_bilateral_ring<HW, int, false>(a, grid, bytes, s)
               : launch_bilateral_ring<HW, long long, false>(a, grid, bytes,
                                                             s);
}

// Launch the ring kernel for the half width a.taps.hw (1..WT_BIL_MAX_HW),
// 32- or 64-bit offsets, with the select for weights of 0 where the
// dense kernel has one.
static int run_bilateral_ring(const RingArgs& a, dim3 grid, int bytes,
                              bool idx32, cudaStream_t s) {
  const int n = (2 * a.taps.hw + 1) * (2 * a.taps.hw + 1);
  bool zeros = false;
  for (int i = 0; i < n && a.taps.hw <= WT_BIL_MAX_HW; ++i)
    zeros = zeros || a.kern.k[i] == 0.0f;
#define WT_RING_CASE(HWV) \
  case HWV:               \
    return launch_bilateral_ring<HWV>(a, grid, bytes, idx32, zeros, s);
  switch (a.taps.hw) {
    WT_RING_CASE(1)
    WT_RING_CASE(2)
    WT_RING_CASE(3)
    WT_RING_CASE(4)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WT_RING_CASE
}

}  // namespace wt
