// Two consecutive deep WOW scales (s, s+1) in one launch (kernel E): the
// scale-s smooth (the middle carry) never goes to device memory.  Plain C
// interface, loaded with ctypes (wavelets_tpu_torch/ops/_build.py);
// wrapper and host-side plan in ops/hopper_deep.py (deep_whiten_step2,
// pair_plan).
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
// (scale s+1).  The block holds the torus in shared memory and runs,
// with a barrier between passes:
//   X  = carry;          C1 = smooth_s(X)   (rows pass -> T, cols -> C1)
//   T  = rows(( X - C1)^2);  white_s   = whiten(X - C1, cols(T))  -> X
//   C2 = smooth_s+1(C1) (rows pass -> T, cols -> C2)
//   T  = rows((C1 - C2)^2);  white_s+1 = whiten(C1 - C2, cols(T)) -> C1
// then c_next2 = C2, the two whites and recon = (recon + white_s) +
// white_s+1 (the order of two kernel A steps) go out.  Four torus
// buffers, 16 * 2M * 2N bytes: 64 KB for the 64 x 64 torus of 4096^2 at
// s = 7 or 512^2 at s = 4.  The gate (D | H, D | W, the torus fits the
// opt-in shared memory) is this kernel's own; the wrapper's caller takes
// two kernel A steps where it refuses.  For D = 1 the one class is its
// own mirror, the torus holds every pixel twice, and only the first copy
// is written.
//
// Sectors.  Neighbouring points of one torus are D floats apart in
// memory, so a block that loaded its own torus touched a 32-byte sector
// for every 4-byte load and store (this kernel's first form: 8x the
// sectors at D >= 16).  Here the blocks of the CW = min(8, D/2) adjacent column
// classes q0 .. q0+CW-1 form a thread-block cluster (their mirrors
// D-1-q0-CW+1 .. D-1-q0 are adjacent too).  The cluster loads each
// sector once, CW lanes on CW contiguous floats, and each lane writes its
// float into the shared memory of the block that owns its class, through
// distributed shared memory; the stores gather the same way.  At
// D >= 16 every load and store covers whole 32-byte sectors; at D < 16
// the cluster narrows to D/2 blocks by the shape alone.  Every circular
// tap wraps with a compare and add instead of an integer remainder, and
// the taps' half width is a template parameter (1, 2, or any at run
// time), so the tap loops unroll.
//
// Bound: device memory by the function's bytes (read carry and recon,
// write c_next2, two whites and recon: 6 images, 0.120 ms at 4096^2).
// Measured on an H100 80GB HBM3 at 700 W at (7, 8) on 4096^2, device
// time (scripts/kernel_variants.py): 0.64 ms, of which the load and
// store phases alone take 0.43 ms and the compute passes alone
// 0.51-0.52 ms; without the cluster (one block a class, 4-byte
// accesses D floats apart) 1.69 ms; with the wrap by remainder 0.82 ms,
// with the taps at run time 0.80 ms.  Around the call (chip_smoke.py)
// 0.73-0.79 ms against 1.83 ms for its first form, and still above two
// deep steps of whiten_step.cu (0.52-0.59 ms); at (4, 5) on 512^2 the
// pair wins, 0.08-0.11 against 0.11-0.19 ms.
//
// Rounding.  Every fold rounds step by step in the JAX package's order
// and the left and right taps are added as (l + r), which commutes, so
// the mirrored torus gives the same bits as the index map of kernel A:
// c_next2 is bitwise equal to two kernel A steps and to two plain steps;
// the whites differ from the plain version only through erff.
//
// bfloat16.  wt_whiten_pair_bf16 loads a bfloat16 carry into the same
// float32 tori and stores c_next2, the whites and recon in bfloat16: the
// JAX pair's bfloat16 form (pallas_deep.py:914-920), whose middle carry
// stays float32, so its scale s+1 is not two bfloat16 steps'.  recon
// takes the whites a plane at a time, each rounded to bfloat16 first (the
// JAX package's deferred tail adds the two planes to the reconstruction
// one XLA add each, models/wow.py:240-268).  A cluster's lanes then load
// 16 of a sector's 32 bytes.
//
// Launch.  The grid, cluster width and shared-memory bytes are the
// wrapper's plan (pair_plan), passed in and checked here, so the plan the
// CPU tests hold is the one launched.  Variant builds (wt_tile.cuh):
// WRAP_REM (the wrap by remainder), NO_COMPUTE (the load and store
// phases alone), NO_MEMORY (the compute passes alone); the variant
// without a cluster is a plan of cluster 1.

#include <cooperative_groups.h>

#include "wt_common.cuh"
#include "wt_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using wt::Taps;

// i mod L for a torus of length L.  FAST: -L <= i < 2L, true where no tap
// step (at most 2hw) is longer than the torus (hw <= M, N), so a compare
// and add suffices; the remainder form costs about 0.2 ms of the pair at
// 4096^2 (scripts/kernel_variants.py, an H100 80GB HBM3 at 700 W).
template <bool FAST>
__device__ __forceinline__ int wrap(int i, int L) {
  if (FAST) {
    i += i < 0 ? L : 0;
    return i >= L ? i - L : i;
  }
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
template <int HW, bool FAST, class V>
__device__ __forceinline__ float fold_u(const V& val, const Taps& t, int u,
                                        int v, int st, int Lr) {
  float out = __fmul_rn(val(u, v), t.t[0]);
#pragma unroll
  for (int j = 1; j <= wt::half_width<HW>(t); ++j) {
    float l = val(wrap<FAST>(u - j * st, Lr), v);
    float r = val(wrap<FAST>(u + j * st, Lr), v);
    out = __fadd_rn(out, __fmul_rn(t.t[j], __fadd_rn(l, r)));
  }
  return out;
}

// Circular fold along the torus columns (v) with tap step st.
template <int HW, bool FAST>
__device__ __forceinline__ float fold_v(const float* a, const Taps& t, int u,
                                        int v, int st, int Lc) {
  const float* row = a + u * Lc;
  float out = __fmul_rn(row[v], t.t[0]);
#pragma unroll
  for (int j = 1; j <= wt::half_width<HW>(t); ++j) {
    float l = row[wrap<FAST>(v - j * st, Lc)];
    float r = row[wrap<FAST>(v + j * st, Lc)];
    out = __fadd_rn(out, __fmul_rn(t.t[j], __fadd_rn(l, r)));
  }
  return out;
}

#define WT_FOR_TORUS                                        \
  for (int u = threadIdx.y; u < Lr; u += blockDim.y)        \
    for (int v = threadIdx.x; v < Lc; v += blockDim.x)

// S: the storage type of the carry, c_next2, the whites and recon; the
// tori in shared memory are float32 for both (the middle carry never
// rounds, as in the JAX pair's float32 rings, pallas_deep.py:914-920).
template <class S>
struct PairArgs {
  const S* carry;
  S* c_next2;
  S* white1;
  S* white2;
  S* recon;
  const float* thr;  // (2, B)
  float fac1, fac2;
  int masked1, masked2, soft;
  Taps taps;
  long long B, H, W, D;
  int M, N, cw;
};

// The cluster's sectors: item it = (u, v) of the torus; lane e of an item
// holds column class q0 + e (v < N) or the mirror class D-1-q0-(cw-1)+e
// (v >= N), owned by block rank e or cw-1-e.  Calls f(u, v, image offset
// within the frame, owner rank) for this block's share.
template <class S, class F>
__device__ __forceinline__ void for_each_sector(const PairArgs<S>& a, int rank,
                                                int q0, long long r, F f) {
  const int Lc = 2 * a.N, items = 2 * a.M * Lc, cw = a.cw;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int per = (blockDim.x * blockDim.y) / cw;
  const int e = tid % cw, slot = tid / cw;
  for (int it = rank * per + slot; it < items; it += cw * per) {
    const int u = it / Lc, v = it - u * Lc;
    const long long row = torus_pos(u, a.M, r, a.D);
    long long col;
    int owner;
    if (v < a.N) {
      col = q0 + (long long)v * a.D + e;
      owner = e;
    } else {
      col = (a.D - q0 - cw) + (long long)(2 * a.N - 1 - v) * a.D + e;
      owner = cw - 1 - e;
    }
    f(u, v, row * a.W + col, owner);
  }
}

// Grid: x over column classes q (clusters of cw adjacent ones), y over
// row class pairs r, z over frames.
template <class S, int HW, bool FAST>
__global__ void whiten_pair(PairArgs<S> a) {
  extern __shared__ float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int M = a.M, N = a.N;
  const int Lr = 2 * M, Lc = 2 * N, n = Lr * Lc;
  float* X = sm;
  float* C1 = sm + n;
  float* C2 = sm + 2 * n;
  float* T = sm + 3 * n;
  const int rank = static_cast<int>(cluster.block_rank());
  const int q0 = static_cast<int>(blockIdx.x) - rank;
  const long long r = blockIdx.y, b = blockIdx.z;
  const Taps& taps = a.taps;
  const S* src = a.carry + b * a.H * a.W;

  for_each_sector(a, rank, q0, r,
                  [&](int u, int v, long long off, int owner) {
#ifdef WT_VARIANT_NO_MEMORY
                    if (off < 0) X[0] = wt::to_f32(src[off]);  // never
#else
                    cluster.map_shared_rank(X, owner)[u * Lc + v] =
                        wt::to_f32(src[off]);
#endif
                  });
  cluster.sync();
#ifndef WT_VARIANT_NO_COMPUTE
  // scale s: chain smooth, then the power smooth of its detail
  WT_FOR_TORUS T[u * Lc + v] =
      fold_u<HW, FAST>(Plain{X, Lc}, taps, u, v, 1, Lr);
  __syncthreads();
  WT_FOR_TORUS C1[u * Lc + v] =
      fold_v<HW, FAST>(T, taps, u, v, 1, Lc);
  __syncthreads();
  WT_FOR_TORUS T[u * Lc + v] =
      fold_u<HW, FAST>(DiffSq{X, C1, Lc}, taps, u, v, 1, Lr);
  __syncthreads();
  // white_s replaces the carry at the thread's own point: no other thread
  // reads X from here on
  WT_FOR_TORUS {
    const int i = u * Lc + v;
    float wc;
    X[i] = wt::whiten_value(__fsub_rn(X[i], C1[i]),
                            fold_v<HW, FAST>(T, taps, u, v, 1, Lc), a.fac1,
                            a.masked1 ? a.thr + b : nullptr, a.soft, &wc);
  }
  __syncthreads();
  // scale s+1 on the middle carry C1, taps two torus steps apart
  WT_FOR_TORUS T[u * Lc + v] =
      fold_u<HW, FAST>(Plain{C1, Lc}, taps, u, v, 2, Lr);
  __syncthreads();
  WT_FOR_TORUS C2[u * Lc + v] =
      fold_v<HW, FAST>(T, taps, u, v, 2, Lc);
  __syncthreads();
  WT_FOR_TORUS T[u * Lc + v] =
      fold_u<HW, FAST>(DiffSq{C1, C2, Lc}, taps, u, v, 2, Lr);
  __syncthreads();
  // white_s+1 replaces the middle carry at the thread's own point
  WT_FOR_TORUS {
    const int i = u * Lc + v;
    float wc;
    C1[i] = wt::whiten_value(__fsub_rn(C1[i], C2[i]),
                             fold_v<HW, FAST>(T, taps, u, v, 2, Lc), a.fac2,
                             a.masked2 ? a.thr + a.B + b : nullptr, a.soft,
                             &wc);
  }
#endif
  cluster.sync();
  const long long frame = b * a.H * a.W;
  for_each_sector(a, rank, q0, r,
                  [&](int u, int v, long long off, int owner) {
#ifdef WT_VARIANT_NO_MEMORY
                    if (off >= 0) return;  // always
#endif
                    if (a.D == 1 && (u >= M || v >= N)) return;  // mirror
                    const int i = u * Lc + v;
                    const float w1 = cluster.map_shared_rank(X, owner)[i];
                    const float w2 = cluster.map_shared_rank(C1, owner)[i];
                    const long long g = frame + off;
                    a.c_next2[g] = wt::from_f32<S>(
                        cluster.map_shared_rank(C2, owner)[i]);
                    if (a.white1) a.white1[g] = wt::from_f32<S>(w1);
                    if (a.white2) a.white2[g] = wt::from_f32<S>(w2);
                    // a plane at a time, as two kernel A steps add
                    if (a.recon)
                      a.recon[g] = wt::add_rounded<S>(
                          wt::add_rounded<S>(a.recon[g], w1), w2);
                  });
  // a block's shared memory must outlive its peers' reads
  cluster.sync();
}

template <class S, int HW, bool FAST>
int launch(const cudaLaunchConfig_t& cfg, const PairArgs<S>& a) {
  static std::atomic<int> optin[wt::kMaxDevices];
  cudaError_t err =
      wt::smem_optin(whiten_pair<S, HW, FAST>,
                     static_cast<int>(cfg.dynamicSmemBytes), optin);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, whiten_pair<S, HW, FAST>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Scales s and s+1 of a contiguous (B, H, W) carry of S (see the entries).
template <class S>
int whiten_pair_entry(const S* carry, S* c_next2, S* white1, S* white2,
                      S* recon, const float* thr, float fac1, float fac2,
                      int masked1, int masked2, int soft, const double* taps,
                      int n_taps, long long B, long long H, long long W,
                      long long D, long long grid_x, long long grid_y,
                      int cluster, long long smem_bytes, void* stream) {
  PairArgs<S> a;
  if (!wt::make_taps(taps, n_taps, &a.taps) || !carry || !c_next2 ||
      B < 1 || B > 65535 || H < 1 || W < 1 || D < 1 || H % D || W % D ||
      D / 2 > 65535 || (D & (D - 1)) != 0 ||
      ((masked1 || masked2) && !thr) || (!recon && !(white1 && white2)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the plan: one block per column class and row class pair, a cluster
  // of a power of two (at most 8) adjacent classes, four 2M x 2N float32
  // tori
  const long long classes = D >= 2 ? D / 2 : 1;
  if (grid_x != classes || grid_y != classes || cluster < 1 ||
      cluster > 8 || (cluster & (cluster - 1)) != 0 ||
      classes % cluster != 0 ||
      smem_bytes < 16ll * (2 * (H / D)) * (2 * (W / D)) ||
      smem_bytes > (1ll << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  a.carry = carry;
  a.c_next2 = c_next2;
  a.white1 = white1;
  a.white2 = white2;
  a.recon = recon;
  a.thr = thr;
  a.fac1 = fac1;
  a.fac2 = fac2;
  a.masked1 = masked1;
  a.masked2 = masked2;
  a.soft = soft;
  a.B = B;
  a.H = H;
  a.W = W;
  a.D = D;
  a.M = static_cast<int>(H / D);
  a.N = static_cast<int>(W / D);
  a.cw = cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid_x),
                     static_cast<unsigned>(grid_y), static_cast<unsigned>(B));
  cfg.blockDim = dim3(32, 8);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.cw);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
#ifdef WT_VARIANT_WRAP_REM
  const bool fast = false;
#else
  const bool fast = a.taps.hw <= a.M && a.taps.hw <= a.N;
#endif
  return wt::dispatch_hw(a.taps.hw, [&](auto hw) {
    constexpr int HW = decltype(hw)::value;
    return fast ? launch<S, HW, true>(cfg, a) : launch<S, HW, false>(cfg, a);
  });
}

}  // namespace

extern "C" {

const char* wt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Scales s and s+1 (D = 2^s) of a contiguous (B, H, W) float32 carry on
// the device: c_next2 (B, H, W) receives the scale-(s+1) smooth; white1,
// white2 (B, H, W) or null; recon (B, H, W) or null, += white1 then
// white2 in place.  thr: (2, B) per-scale, per-frame thresholds on the
// device (read where masked1 / masked2).  The launch is the wrapper's
// plan (ops/hopper_deep.py::pair_plan): grid_x column classes by
// grid_y row class pairs, clusters of `cluster` adjacent column classes,
// smem_bytes of shared memory; it is checked against what the kernel
// needs and launched as given.  Returns cudaErrorInvalidValue where the
// gate refuses the shape or the plan does not fit it, else the launch's
// error, or 0.
int wt_whiten_pair_f32(const float* carry, float* c_next2, float* white1,
                       float* white2, float* recon, const float* thr,
                       float fac1, float fac2, int masked1, int masked2,
                       int soft, const double* taps, int n_taps, long long B,
                       long long H, long long W, long long D,
                       long long grid_x, long long grid_y, int cluster,
                       long long smem_bytes, void* stream) {
  return whiten_pair_entry<float>(carry, c_next2, white1, white2, recon, thr,
                                  fac1, fac2, masked1, masked2, soft, taps,
                                  n_taps, B, H, W, D, grid_x, grid_y, cluster,
                                  smem_bytes, stream);
}

// The same pair on a bfloat16 carry: c_next2, the whites and recon
// bfloat16 (recon += white_s, then += white_s+1, each white rounded to
// bfloat16, the sum in float32, one rounding), the tori and the
// thresholds float32.
int wt_whiten_pair_bf16(const __nv_bfloat16* carry, __nv_bfloat16* c_next2,
                        __nv_bfloat16* white1, __nv_bfloat16* white2,
                        __nv_bfloat16* recon, const float* thr, float fac1,
                        float fac2, int masked1, int masked2, int soft,
                        const double* taps, int n_taps, long long B,
                        long long H, long long W, long long D,
                        long long grid_x, long long grid_y, int cluster,
                        long long smem_bytes, void* stream) {
  return whiten_pair_entry<__nv_bfloat16>(
      carry, c_next2, white1, white2, recon, thr, fac1, fac2, masked1,
      masked2, soft, taps, n_taps, B, H, W, D, grid_x, grid_y, cluster,
      smem_bytes, stream);
}

}  // extern "C"
