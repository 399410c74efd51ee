// Two consecutive deep WOW scales (s, s+1) in one launch (kernel E): the
// scale-s smooth (the middle carry) never goes to device memory.  Plain C
// interface, loaded with ctypes (wavelets_tpu_torch/ops/_build.py);
// wrapper and host-side plans in ops/hopper_deep.py (deep_whiten_step2;
// pair_plan for float32, pair_stream_plan for bfloat16).
//
// Replaces wavelets_tpu/ops/pallas_deep.py::deep_whiten_step2 (:929,
// launched at :995) and its stream _make_stream2_kernel (:713), which
// walks each row residue class mod D through VMEM rings (6hw+2 carry
// rows, computed-smooth rings of 8hw+1 and 4hw+1 rows, :986-988) and
// re-mirrors the columns with lane reversals; in bfloat16 its middle
// carry stays float32 in VMEM (:914-920).
//
// The classes.  With D = 2^s dividing H and W, every tap of both scales
// (offsets j*D and j*2D) and every symmetric reflection of a row or
// column stays inside the residue classes r and D-1-r (mod D) of that
// axis: a reflection maps k to -k-1 or 2H-1-k, and both turn class r into
// D-1-r.  Restricted to the classes {r, D-1-r}, numpy's symmetric
// extension is a sequence of period 2M (M = H/D): rows r, r+D, ..,
// r+(M-1)D, then D-1-r+(M-1)D, .., D-1-r.  On such a circle the dilated
// folds become circular folds of step 1 (scale s) and 2 (scale s+1), and
// the columns make circles of 2N positions the same way (N = W/D).  For
// D = 1 the one class is its own mirror, its circle holds every row (or
// column) twice, and only the first copy is written.
//
// Two designs, one a form.
//
// Float32 (wt_whiten_pair_f32, the main path's pair): the torus.  One
// block owns the 2M x 2N torus of the row classes {r, D-1-r} and column
// classes {q, D-1-q}, holds it in shared memory and runs, with a barrier
// between passes:
//   X  = carry;          C1 = smooth_s(X)   (rows pass -> T, cols -> C1)
//   T  = rows(( X - C1)^2);  white_s   = whiten(X - C1, cols(T))  -> X
//   C2 = smooth_s+1(C1) (rows pass -> T, cols -> C2)
//   T  = rows((C1 - C2)^2);  white_s+1 = whiten(C1 - C2, cols(T)) -> C1
// then c_next2 = C2, the two whites and recon = (recon + white_s) +
// white_s+1 (the order of two kernel A steps) go out.  Four torus
// buffers, 16 * 2M * 2N bytes: 64 KB for the 64 x 64 torus of 4096^2 at
// s = 7 or 512^2 at s = 4.  Neighbouring points of one torus are D floats
// apart in memory, so the blocks of the CW = min(8, D/2) adjacent column
// classes q0 .. q0+CW-1 form a thread-block cluster (their mirrors
// D-1-q0-CW+1 .. D-1-q0 are adjacent too): the cluster loads each 32-byte
// sector once, CW lanes on CW contiguous floats, and each lane writes its
// float into the shared memory of the block that owns its class, through
// distributed shared memory; the stores gather the same way.  Every
// circular tap wraps with a compare and add, and the taps' half width is
// a template parameter (1, 2, or any at run time), so the tap loops
// unroll.  Bound: device memory by the function's bytes (read carry and
// recon, write c_next2, two whites and recon: 6 images, 0.120 ms at
// 4096^2).  Measured on an H100 80GB HBM3 at 700 W at (7, 8) on 4096^2,
// device time (scripts/kernel_variants.py): 0.645 ms, of which the load
// and store phases alone take 0.43 ms and the compute passes alone 0.51;
// without the cluster 1.65 ms, with the wrap by remainder 0.82, with the
// taps at run time 0.80.  Launch: the grid, cluster width and shared
// bytes are the wrapper's plan (pair_plan), checked here.  Variant hooks
// (wt_tile.cuh): WRAP_REM (the wrap by remainder), NO_COMPUTE (the load
// and store phases alone), NO_MEMORY (the compute passes alone); the
// variant without a cluster is a plan of cluster 1.
//
// The bfloat16 route's pair (wt_whiten_pair_bf16): the residue-class
// stream, from a float32 carry and recon to a float32 c_next2 and recon
// and bfloat16 whites.  What bounds it on the H100: the function moves 20
// bytes a pixel (read carry and recon, write c_next2 and recon in
// float32, two whites in bfloat16: 0.100 ms at 4096^2), so what is left
// is instruction issue: eight folds a pixel, the details' squares, two
// whitening epilogues (IEEE square root and division, with erff and a
// second division where masked), and the ring and address arithmetic
// around them.  The torus above, run on bfloat16 (this
// kernel's earlier form), took 0.622 ms of device time at (7, 8) on
// 4096^2 (H100 80GB HBM3, 700 W, scripts/kernel_variants.py): its load
// and store phases alone 0.381 (the cluster's lanes read half of each
// 32-byte sector, one 2-byte element a lane, and made three remote shared
// reads and five 2-byte global accesses a point on store), its compute
// passes alone 0.505 (seven full-torus passes between barriers, the
// detail squared again at every tap); with a cluster of 16 (a
// non-portable size: whole sectors) 0.730.  The stream keeps every
// intermediate on chip, folds each value once and needs no cluster:
//   - a work item is a frame, a row class pair {r, D-1-r} walked as its
//     circle of 2M positions (or a chunk of them: the plan weighs the
//     warm-up against filling 132 SMs), and a group of k adjacent column
//     classes q0 .. q0+k-1 with their mirrors, held as their circle of 2N
//     positions of k points, two adjacent points a thread (k = 8 at
//     (7, 8) on 4096^2: 512 points, 256 threads, one block of 122 KiB an
//     SM); blocks take items grid-stride;
//   - each tick one carry row of the group enters a ring of 2hw+2 float32
//     rows by 16-byte cp.async, two ticks ahead: a position's k classes
//     are k contiguous elements of the image row (whole 32-byte sectors
//     at k = 8), the mirror half's in reverse class order, which the
//     first rows fold undoes as it writes its buffer in circle order;
//   - a tick runs four rows folds (the chain of s at position q1; the
//     chain of s+1 at q2 = q1-2hw-1 on the middle carry's ring, step 2;
//     the power smooths at o1 = q1-hw-1 and o2 = q1-4hw-2 on the squared
//     details' rings), one barrier, then their four cols folds (steps k
//     and 2k along the circle; the buffers carry hw or 2hw positions of
//     margin a side filled with copies, so no tap wraps) with the
//     details, c_next2, white_s and white_s+1.  The rings of a point (the
//     middle carry, 4hw+2 rows of float32, never rounded; the details of
//     s and s+1, 2hw+2 and 4hw+2 rows, squared once as they enter, beside
//     hw+2 and 2hw+2 rows of the plain values the epilogues read) are its
//     thread's own, so with the rows-fold buffers double-buffered one
//     barrier a tick suffices;
//   - in the steady ticks, where all four stages are on, each phase runs
//     its four folds unconditionally with every load before any store, so
//     the folds overlap; the warm-up and tail ticks run only the stages
//     that are on.  Ring slots advance a tick at a time (no remainder),
//     and pairs load and store as one 8-byte shared access;
//   - white_s waits for white_s+1 of its row in a ring of 3hw+2 float32
//     rows; the recon row arrives by cp.async a tick ahead and is written
//     once;
//   - where the circle passes the block (2N*k above two points a thread,
//     or the shared memory), the columns run as windows of `run` output
//     positions with 5hw positions of margin a side, each stage computed
//     on the part of the window that the next one reads.
// Measured at (7, 8) on 4096^2 in the JAX package's bfloat16 rounding
// (bfloat16 carry, recon and white_s rings, this kernel's earlier form;
// scripts/kernel_variants.py, H100 80GB HBM3, 700 W, device ms): 0.399
// (k = 16), 0.409-0.410 on two 256-thread
// blocks an SM (k = 8), against 0.433 for the split pair (two launches of
// whiten_step.cu's stream) in the same call; without the whitening
// epilogues 0.320-0.322.  Tried and dropped: four points a thread (float4
// rings: 8 warps an SM, latency-bound, 0.718), the folds of the active
// stages only in every tick (0.510 against 0.486 unconditional).
// Launch: the stream's plan (k, run, chunk, threads, grid, shared bytes)
// is the wrapper's (pair_stream_plan), checked here (pair_layout) and
// launched as given.  Variant hook (scripts/kernel_variants.py):
// NO_EPILOGUE (the whites are c + lp).
//
// Rounding (both).  Every fold rounds step by step in the JAX package's
// order (x*t_0, then t_j*(l + r) for j = 1..hw) and the left and right
// taps are added as (l + r), which commutes, so the mirrored circles give
// the same bits as the symmetric index map: every output is bitwise equal
// to the plain version on the same card (two plain float32 steps; in the
// bfloat16 route the whites rounded on store, recon += white_s then +=
// white_s+1 unrounded, in float32).  The bfloat16 route departs on
// purpose from the JAX package's bfloat16 pair, which rounds c_next2 and
// the recon to bfloat16 (PERF.md, section 6).  The epilogue uses IEEE
// sqrt and division; erff may differ from torch.erf in the last place.

#include <cooperative_groups.h>

#include <climits>
#include <type_traits>

#include "wt_common.cuh"
#include "wt_stream.cuh"
#include "wt_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using wt::Taps;

// ---------------------------------------------------------------------
// Float32: the torus
// ---------------------------------------------------------------------

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

struct PairArgs {
  const float* carry;
  float* c_next2;
  float* white1;
  float* white2;
  float* recon;
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
template <class F>
__device__ __forceinline__ void for_each_sector(const PairArgs& a, int rank,
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
template <int HW, bool FAST>
__global__ void whiten_pair(PairArgs a) {
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
  const float* src = a.carry + b * a.H * a.W;

  for_each_sector(a, rank, q0, r,
                  [&](int u, int v, long long off, int owner) {
#ifdef WT_VARIANT_NO_MEMORY
                    if (off < 0) X[0] = src[off];  // never
#else
                    cluster.map_shared_rank(X, owner)[u * Lc + v] = src[off];
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
                    a.c_next2[g] = cluster.map_shared_rank(C2, owner)[i];
                    if (a.white1) a.white1[g] = w1;
                    if (a.white2) a.white2[g] = w2;
                    // a plane at a time, as two kernel A steps add
                    if (a.recon)
                      a.recon[g] = __fadd_rn(__fadd_rn(a.recon[g], w1), w2);
                  });
  // a block's shared memory must outlive its peers' reads
  cluster.sync();
}

template <int HW, bool FAST>
int launch(const cudaLaunchConfig_t& cfg, const PairArgs& a) {
  static std::atomic<int> optin[wt::kMaxDevices];
  cudaError_t err = wt::smem_optin(
      whiten_pair<HW, FAST>, static_cast<int>(cfg.dynamicSmemBytes), optin);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, whiten_pair<HW, FAST>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// Bfloat16: the residue-class stream
// ---------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using wt::kStreamThreads;

// The stream's arguments and the layout its plan implies (pair_layout).
struct PairStream {
  const float* carry;
  float* c_next2;
  bf16* white1;  // may be null
  bf16* white2;  // may be null
  float* recon;  // may be null
  const float* thr;  // (2, B)
  float fac1, fac2;
  int masked1, masked2, soft;
  Taps taps;
  long long B, H, W, D;
  int M, N;            // rows and columns a class
  int k, kshift;       // column classes a group, log2 k
  int pairs, groups;   // row class pairs, column groups
  int rows_out;        // output positions of the row circle (M at D = 1)
  int cols_out;        // the column circle's (N at D = 1)
  int run, runs;       // output positions a window (0: the circle)
  int window, lead;    // window positions; its margin (5hw, 0 circle)
  int m1, m2;          // rows-fold buffer margins (hw, 2hw on the circle)
  int pts;             // window * k
  int threads;         // a block's (a point or a pair each)
  int chunk, chunks;
  long long items;
  int pf;              // row pitch in floats
  int o_rec, o_w1, o_c1, o_q1, o_d1, o_q2, o_d2, o_t;  // bytes
  int t1, t2;          // a rows-fold buffer of scale s / s+1, floats
  int vec_c, vec_r;    // carry / recon 16-byte aligned
  int st_vec;          // outputs aligned for paired stores
};

// Lay out the stream's shared memory for the plan (k, run, chunk,
// threads, grid, smem) and check that the kernel runs it on a (B, H, W)
// stack at the dilation D: ops/hopper_deep.py::pair_stream_smem and pair_stream_plan
// mirror it.  Regions, in order (each a multiple of 16 bytes), float32
// with rows of pf elements: the carry's ring (2hw+2 rows), two recon
// rows, white_s's ring (3hw+2), the middle carry's ring (4hw+2), the
// squared and the plain detail of s (2hw+2, hw+2) and of s+1 (4hw+2,
// 2hw+2); two sets of the rows-fold buffers T1, T2 (t1 floats) and T1b,
// T2b (t2).
bool pair_layout(PairStream* a, long long B, long long H, long long W,
                 long long D, long long k, long long run, long long chunk,
                 long long threads, long long grid, long long smem) {
  const long long hw = a->taps.hw;
  if (B < 1 || B > 65535 || H < 1 || W < 1 || D < 1 || (D & (D - 1)) ||
      H % D || W % D || H >= (1ll << 30) || W >= (1ll << 30))
    return false;
  const long long classes = D >= 2 ? D / 2 : 1;
  if (k < 1 || (k & (k - 1)) || classes % k || run < 0 || chunk < 1 ||
      grid < 1 || threads < 64 || threads > kStreamThreads || threads % 64)
    return false;
  const long long M = H / D, N = W / D;
  const long long rows_out = D == 1 ? M : 2 * M;
  const long long cols_out = D == 1 ? N : 2 * N;
  const long long window = run ? run + 10 * hw : 2 * N;
  const long long pts = window * k;
  const long long max_pts = (k >= 2 ? 2 : 1) * threads;
  if (pts > max_pts || chunk > rows_out || run > cols_out) return false;
  const long long m1 = run ? 0 : hw, m2 = run ? 0 : 2 * hw;
  const long long pf = (pts + 3) / 4 * 4;
  const long long t1 = ((window + 2 * m1) * k + 3) / 4 * 4;
  const long long t2 = ((window + 2 * m2) * k + 3) / 4 * 4;
  long long o = (2 * hw + 2) * pf * 4;
  a->o_rec = static_cast<int>(o);
  o += 2 * pf * 4;
  a->o_w1 = static_cast<int>(o);
  o += (3 * hw + 2) * pf * 4;
  a->o_c1 = static_cast<int>(o);
  o += (4 * hw + 2) * pf * 4;
  a->o_q1 = static_cast<int>(o);
  o += (2 * hw + 2) * pf * 4;
  a->o_d1 = static_cast<int>(o);
  o += (hw + 2) * pf * 4;
  a->o_q2 = static_cast<int>(o);
  o += (4 * hw + 2) * pf * 4;
  a->o_d2 = static_cast<int>(o);
  o += (2 * hw + 2) * pf * 4;
  a->o_t = static_cast<int>(o);
  o += 2 * (2 * t1 + 2 * t2) * 4;
  const long long runs = run ? (cols_out + run - 1) / run : 1;
  const long long chunks = (rows_out + chunk - 1) / chunk;
  const long long items = B * chunks * classes * runs * (classes / k);
  if (o > smem || smem > 232448 || grid > items || grid > INT_MAX)
    return false;
  a->B = B;
  a->H = H;
  a->W = W;
  a->D = D;
  a->M = static_cast<int>(M);
  a->N = static_cast<int>(N);
  a->k = static_cast<int>(k);
  int sh = 0;
  while ((1ll << sh) < k) ++sh;
  a->kshift = sh;
  a->pairs = static_cast<int>(classes);
  a->groups = static_cast<int>(classes / k);
  a->rows_out = static_cast<int>(rows_out);
  a->cols_out = static_cast<int>(cols_out);
  a->run = static_cast<int>(run);
  a->runs = static_cast<int>(runs);
  a->window = static_cast<int>(window);
  a->lead = static_cast<int>(run ? 5 * hw : 0);
  a->m1 = static_cast<int>(m1);
  a->m2 = static_cast<int>(m2);
  a->pts = static_cast<int>(pts);
  a->threads = static_cast<int>(threads);
  a->chunk = static_cast<int>(chunk);
  a->chunks = static_cast<int>(chunks);
  a->items = items;
  a->pf = static_cast<int>(pf);
  a->t1 = static_cast<int>(t1);
  a->t2 = static_cast<int>(t2);
  return true;
}

// NP values of a thread's points: two adjacent points of one window
// position (k >= 2), or one.
template <int NP>
struct Vf {
  float x[NP];
};

// Element i of a shared region (i even for a pair, one 8-byte or 4-byte
// access: CUDA's float2 is a struct, which the compiler may load element
// by element).  The accesses keep their program order (volatile), so a
// phase issues its loads before its stores as written.
__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int NP>
__device__ __forceinline__ Vf<NP> ld(const float* base, int i) {
  Vf<NP> v;
  const unsigned a = saddr(base) + 4u * static_cast<unsigned>(i);
  if constexpr (NP == 2)
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                 : "=f"(v.x[0]), "=f"(v.x[1]) : "r"(a));
  else
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v.x[0]) : "r"(a));
  return v;
}

template <int NP>
__device__ __forceinline__ Vf<NP> ld(const bf16* base, int i) {
  Vf<NP> v;
  const unsigned a = saddr(base) + 2u * static_cast<unsigned>(i);
  if constexpr (NP == 2) {
    unsigned u;
    asm volatile("ld.shared.b32 %0, [%1];" : "=r"(u) : "r"(a));
    v.x[0] = __uint_as_float(u << 16);
    v.x[1] = __uint_as_float(u & 0xffff0000u);
  } else {
    unsigned short u;
    asm volatile("ld.shared.u16 %0, [%1];" : "=h"(u) : "r"(a));
    v.x[0] = __uint_as_float(static_cast<unsigned>(u) << 16);
  }
  return v;
}

template <int NP>
__device__ __forceinline__ void st(float* base, int i, const Vf<NP>& v) {
  const unsigned a = saddr(base) + 4u * static_cast<unsigned>(i);
  if constexpr (NP == 2)
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(a), "f"(v.x[0]),
                 "f"(v.x[1])
                 : "memory");
  else
    asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v.x[0]) : "memory");
}

template <int NP>
__device__ __forceinline__ void st(bf16* base, int i, const Vf<NP>& v) {
  const unsigned a = saddr(base) + 2u * static_cast<unsigned>(i);
  if constexpr (NP == 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v.x[0], v.x[1]);
    asm volatile("st.shared.b32 [%0], %1;" ::"r"(a),
                 "r"(*reinterpret_cast<const unsigned*>(&h))
                 : "memory");
  } else {
    const bf16 h = wt::from_f32<bf16>(v.x[0]);
    asm volatile("st.shared.u16 [%0], %1;" ::"r"(a),
                 "h"(*reinterpret_cast<const unsigned short*>(&h))
                 : "memory");
  }
}

// Store to device memory (rounded to bfloat16 in a bfloat16 row): v.x[j]
// at row[i + j], i even for a pair.
template <int NP>
__device__ __forceinline__ void stg(bf16* row, long long i, const Vf<NP>& v) {
  if constexpr (NP == 2)
    reinterpret_cast<__nv_bfloat162*>(row)[i >> 1] =
        __floats2bfloat162_rn(v.x[0], v.x[1]);
  else
    row[i] = wt::from_f32<bf16>(v.x[0]);
}
template <int NP>
__device__ __forceinline__ void stg(float* row, long long i,
                                    const Vf<NP>& v) {
  if constexpr (NP == 2)
    reinterpret_cast<float2*>(row)[i >> 1] = make_float2(v.x[0], v.x[1]);
  else
    row[i] = v.x[0];
}

// v in reverse order where rev (the mirror half's memory order)
template <int NP>
__device__ __forceinline__ Vf<NP> ordered(const Vf<NP>& v, bool rev) {
  Vf<NP> o;
#pragma unroll
  for (int i = 0; i < NP; ++i) o.x[i] = rev ? v.x[NP - 1 - i] : v.x[i];
  return o;
}

// The rows fold over 2hw+1 ring rows: tap row i (i = 0 .. 2hw, the centre
// hw) in slot (s0 + i*st) mod n, its values ld(slot).
template <int HW, int NP, class Ld>
__device__ __forceinline__ Vf<NP> fold_ring(const Ld& ld, int s0, int st,
                                            int n, const Taps& tp) {
  const int hw = wt::half_width<HW>(tp);
  int s[2 * WT_MAX_HW + 1];
  s[0] = s0;
#pragma unroll
  for (int i = 1; i <= 2 * hw; ++i) {
    const int x = s[i - 1] + st;
    s[i] = x >= n ? x - n : x;
  }
  const Vf<NP> c = ld(s[hw]);
  Vf<NP> out;
#pragma unroll
  for (int e = 0; e < NP; ++e) out.x[e] = __fmul_rn(c.x[e], tp.t[0]);
#pragma unroll
  for (int j = 1; j <= hw; ++j) {
    const Vf<NP> l = ld(s[hw - j]), r = ld(s[hw + j]);
#pragma unroll
    for (int e = 0; e < NP; ++e)
      out.x[e] = __fadd_rn(out.x[e],
                           __fmul_rn(tp.t[j], __fadd_rn(l.x[e], r.x[e])));
  }
  return out;
}

// The cols fold of a rows-fold buffer at index x: taps x +- j*step.
template <int HW, int NP>
__device__ __forceinline__ Vf<NP> fold_buf(const float* T, int x, int step,
                                           const Taps& tp) {
  const int hw = wt::half_width<HW>(tp);
  const Vf<NP> c = ld<NP>(T, x);
  Vf<NP> out;
#pragma unroll
  for (int e = 0; e < NP; ++e) out.x[e] = __fmul_rn(c.x[e], tp.t[0]);
#pragma unroll
  for (int j = 1; j <= hw; ++j) {
    const Vf<NP> l = ld<NP>(T, x - j * step), r = ld<NP>(T, x + j * step);
#pragma unroll
    for (int e = 0; e < NP; ++e)
      out.x[e] = __fadd_rn(out.x[e],
                           __fmul_rn(tp.t[j], __fadd_rn(l.x[e], r.x[e])));
  }
  return out;
}

// Write a rows fold's values into its buffer at index x0 and at its
// copies x0 + m*period below lim (the circle's margins).
template <int NP>
__device__ __forceinline__ void put(float* T, int x0, int period, int lim,
                                    const Vf<NP>& v) {
  for (int x = x0; x < lim; x += period) st<NP>(T, x, v);
}

// The next slot of a ring of n rows.
__device__ __forceinline__ int adv(int s, int n) {
  return s + 1 == n ? 0 : s + 1;
}

template <int HW, int NP, bool CIRCLE>
__global__ void __launch_bounds__(kStreamThreads, 1)
    pair_stream(PairStream a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* rst = reinterpret_cast<float*>(smem + a.o_rec);
  float* w1r = reinterpret_cast<float*>(smem + a.o_w1);
  float* c1r = reinterpret_cast<float*>(smem + a.o_c1);
  float* q1r = reinterpret_cast<float*>(smem + a.o_q1);
  float* d1r = reinterpret_cast<float*>(smem + a.o_d1);
  float* q2r = reinterpret_cast<float*>(smem + a.o_q2);
  float* d2r = reinterpret_cast<float*>(smem + a.o_d2);
  float* tbuf = reinterpret_cast<float*>(smem + a.o_t);
  const Taps& tp = a.taps;
  const int hw = wt::half_width<HW>(tp);
  // ring rows: carry, middle carry, squared / plain detail of s and s+1,
  // white_s.  A stage writes its row of tick t into slot t mod n; every
  // ring but the carry's reads its oldest row, slot (t + 1) mod n, first
  const int NC = 2 * hw + 2, N1 = 4 * hw + 2, NQ1 = 2 * hw + 2;
  const int ND1 = hw + 2, NQ2 = 4 * hw + 2, ND2 = 2 * hw + 2;
  const int NW = 3 * hw + 2;
  const int k = a.k, pf = a.pf, Vw = a.window;
  const int M = a.M, N = a.N, Lr = 2 * M, Lc = 2 * N;
  const long long W = a.W, D = a.D;
  // this thread's points: window row index f (and f + 1), window
  // position lam, class e of the group (in circle order)
  const int f = static_cast<int>(threadIdx.x) * NP;
  const bool has = f < a.pts;
  const int lam = f >> a.kshift, e = f & (k - 1);
  const int fs = has ? f : 0;  // an index every load may take
  // the part of a window each stage is computed on (all of the circle)
  const bool r1 = has && (CIRCLE || (lam >= hw && lam < Vw - hw));
  const bool r2 = has && (CIRCLE || (lam >= 3 * hw && lam < Vw - 3 * hw));
  const bool ro = has && (CIRCLE || (lam >= 5 * hw && lam < Vw - 5 * hw));
  // rows-fold buffers: index (lam + m) * k + e, with copies a circle apart
  // in the margins; the cols folds read at x1 (step k) and x2 (step 2k),
  // an index whose taps stay in the buffer where the stage is off
  const int x1 = r1 ? (lam + a.m1) * k + e : hw * k;
  const int x2 = r2 ? (lam + a.m2) * k + e : 2 * hw * k;
  const int c1 = ((lam + a.m1) % Vw) * k + e;
  const int c2 = ((lam + a.m2) % Vw) * k + e;
  const int lim1 = (Vw + 2 * a.m1) * k, lim2 = (Vw + 2 * a.m2) * k;
  const int period = Vw * k, set = 2 * a.t1 + 2 * a.t2;
#ifdef WT_VARIANT_NO_EPILOGUE
  auto whiten = [](float c, float lp, float, const float*, int) {
    return __fadd_rn(c, lp);
  };
#else
  auto whiten = [](float c, float lp, float fac, const float* th, int soft) {
    float wc;
    return wt::whiten_value(c, lp, fac, th, soft, &wc);
  };
#endif
  // position p of a circle of n, for any integer p
  auto circ = [](int p, int n) {
    const int u = p % n;
    return u < 0 ? u + n : u;
  };

  for (long long it = blockIdx.x; it < a.items; it += gridDim.x) {
    // item = (((frame * chunks + chunk) * pairs + r) * runs + run) *
    // groups + group: adjacent blocks share rows and sectors
    long long q = it;
    const int g = static_cast<int>(q % a.groups);
    q /= a.groups;
    const int rn = static_cast<int>(q % a.runs);
    q /= a.runs;
    const long long r = q % a.pairs;
    q /= a.pairs;
    const int ck = static_cast<int>(q % a.chunks);
    const long long b = q / a.chunks;
    const int q0 = g * k, v0 = rn * a.run;
    const int p0 = ck * a.chunk, p1 = min(p0 + a.chunk, a.rows_out);
    // the thread's columns: circle position vt; the mirror half holds
    // the group's classes in reverse order in memory
    const int vt = circ(v0 - a.lead + lam, Lc);
    const bool rev = vt >= N;
    const int ri = lam * k + (rev ? k - 1 - e : e);
    // the first of the thread's elements in memory order
    const int rb = has ? (rev ? ri - (NP - 1) : ri) : 0;
    const long long col = rev ? (2ll * N - 1 - vt) * D + (D - 1 - q0 - e)
                              : static_cast<long long>(vt) * D + q0 + e;
    const long long cb = rev ? col - (NP - 1) : col;
    const bool own = ro && (D != 1 || !rev) &&
                     (CIRCLE || lam - a.lead < min(a.run, a.cols_out - v0));
    const float* thr1 = a.masked1 ? a.thr + b : nullptr;
    const float* thr2 = a.masked2 ? a.thr + a.B + b : nullptr;
    float* const frame_c = a.c_next2 + b * a.H * W;
    bf16* const frame_w1 = a.white1 ? a.white1 + b * a.H * W : nullptr;
    bf16* const frame_w2 = a.white2 ? a.white2 + b * a.H * W : nullptr;
    float* const frame_r = a.recon ? a.recon + b * a.H * W : nullptr;
    const long long frame = b * a.H * W;
    // the image row of row-circle position u
    auto row_at = [&](int u) -> long long {
      return u < M ? r + static_cast<long long>(u) * D
                   : (D - 1 - r) + static_cast<long long>(Lr - 1 - u) * D;
    };
    // the image column of window-row element v, in memory order
    auto colf = [&](int v) -> long long {
      const int l = v >> a.kshift, i = v & (k - 1);
      int w = v0 - a.lead + l;
      while (w < 0) w += Lc;
      while (w >= Lc) w -= Lc;
      return w < N ? static_cast<long long>(w) * D + q0 + i
                   : (2ll * N - 1 - w) * D + (D - q0 - k) + i;
    };
    // the column of the thread's first copy (4 floats), once an item
    const int v_own = static_cast<int>(threadIdx.x) * 4;
    const long long c_own = v_own < a.pts ? colf(v_own) : 0;
    auto fetch = [&](float* dst, const float* src, int u, bool vec) {
      const long long off = frame + row_at(u) * W;
      wt::fetch_row(dst, src + off, off, a.pts, static_cast<int>(W), k, vec,
                    [&](int v) { return v == v_own ? c_own : colf(v); });
    };
    // store v (circle order) into a row at the thread's points' columns:
    // a bfloat16 row (the whites) rounds, a float32 row keeps v
    auto store = [&](auto* row, const Vf<NP>& v) {
      using T = std::remove_pointer_t<decltype(row)>;
      if (NP > 1 && a.st_vec) {
        stg<NP>(row, cb, ordered<NP>(v, rev));
        return;
      }
#pragma unroll
      for (int i = 0; i < NP; ++i)
        row[rev ? col - i : col + i] = wt::from_f32<T>(v.x[i]);
    };

    // tick t: the chain of s at q1 = p0 - 4hw + t, the chain of s+1 at
    // q2 = q1 - 2hw - 1, white_s at o1 = q1 - hw - 1, white_s+1 and recon
    // at o2 = q1 - 4hw - 2; the carry of position p in slot (p - p0 + 5hw)
    // mod NC.  Row-circle positions advance a tick at a time: u_f of the
    // carry fetched (q1 + hw + 2), u_q2, u_o1, u_o2
    const int T = (p1 - p0) + 8 * hw + 2;
    for (int i = 0; i < NC; ++i)
      fetch(ring + i * pf, a.carry, circ(p0 - 5 * hw + i, Lr), a.vec_c);
    wt::cp_commit();
    wt::cp_wait<0>();
    __syncthreads();
    int u_f = circ(p0 - 3 * hw + 2, Lr), u_q2 = circ(p0 - 6 * hw - 1, Lr);
    int u_o1 = circ(p0 - 5 * hw - 1, Lr), u_o2 = circ(p0 - 8 * hw - 2, Lr);
    // the ring slots of tick t: the carry's oldest, then each ring's
    // write slot t mod n
    int sC = 0, s1 = 0, sq1 = 0, sd1 = 0, sq2 = 0, sd2 = 0, sw = 0;
    // a tick; ALL: every stage is on (the steady ticks), so each phase
    // runs its four folds unconditionally, loads before stores; else
    // only the stages on (a chunk's warm-up and tail)
    auto tick = [&](int t, auto all) {
      constexpr bool ALL = decltype(all)::value;
      const int q2 = p0 - 6 * hw - 1 + t, o1 = p0 - 5 * hw - 1 + t;
      const bool a1 = ALL || t < T - 2;
      const bool a2 = ALL || (t >= 4 * hw + 1 && t < T - 1);
      const bool aw1 = ALL || (o1 >= p0 && o1 < p1);
      const bool aw2 = ALL || t >= 8 * hw + 2;
      float* T1 = tbuf + (t & 1) * set;
      float* T2 = T1 + a.t1;
      float* T1b = T2 + a.t1;
      float* T2b = T1b + a.t2;
      const int o1s = adv(s1, N1), oq1 = adv(sq1, NQ1), oq2 = adv(sq2, NQ2);
      // the rows folds, all loads before any store
      Vf<NP> v1 = {}, v2 = {}, v3 = {}, v4 = {};
      if (a1)
        v1 = fold_ring<HW, NP>(
            [&](int s) { return ld<NP>(ring, s * pf + rb); }, sC, 1, NC,
            tp);
      if (a2)
        v2 = fold_ring<HW, NP>(
            [&](int s) { return ld<NP>(c1r, s * pf + fs); }, o1s, 2, N1,
            tp);
      if (aw1)
        v3 = fold_ring<HW, NP>(
            [&](int s) { return ld<NP>(q1r, s * pf + fs); }, oq1, 1, NQ1,
            tp);
      if (aw2)
        v4 = fold_ring<HW, NP>(
            [&](int s) { return ld<NP>(q2r, s * pf + fs); }, oq2, 2, NQ2,
            tp);
      if (a1 && has) put<NP>(T1, c1, period, lim1, ordered<NP>(v1, rev));
      if (a2 && r1) put<NP>(T1b, c2, period, lim2, v2);
      if (aw1 && r1) put<NP>(T2, c1, period, lim1, v3);
      if (aw2 && r2) put<NP>(T2b, c2, period, lim2, v4);
      wt::cp_wait<0>();
      __syncthreads();
      // two ticks ahead the carry of q1 + hw + 2, into the slot q1 - hw
      // left; a tick ahead the recon row of o2 + 1
      if (t + 2 < T - 2) fetch(ring + sC * pf, a.carry, u_f, a.vec_c);
      const int u_r = adv(u_o2, Lr);
      if (frame_r && t + 1 >= 8 * hw + 2 && t + 1 < T)
        fetch(rst + ((t + 1) & 1) * pf, a.recon, u_r, a.vec_r);
      wt::cp_commit();
      // the cols folds and the loads of their tails, then the stores
      int sx = sC + hw;
      sx -= sx >= NC ? NC : 0;
      int sm = o1s + 2 * hw;
      sm -= sm >= N1 ? N1 : 0;
      Vf<NP> c = {}, x = {}, c2v = {}, mid = {}, lp1 = {}, dd1 = {};
      Vf<NP> lp2 = {}, dd2 = {}, w1h = {}, rc = {};
      if (a1) {
        c = fold_buf<HW, NP>(T1, x1, k, tp);
        x = ordered<NP>(ld<NP>(ring, sx * pf + rb), rev);
      }
      if (a2) {
        c2v = fold_buf<HW, NP>(T1b, x2, 2 * k, tp);
        mid = ld<NP>(c1r, sm * pf + fs);
      }
      if (aw1) {
        lp1 = fold_buf<HW, NP>(T2, x1, k, tp);
        dd1 = ld<NP>(d1r, adv(sd1, ND1) * pf + fs);
      }
      if (aw2) {
        lp2 = fold_buf<HW, NP>(T2b, x2, 2 * k, tp);
        dd2 = ld<NP>(d2r, adv(sd2, ND2) * pf + fs);
        w1h = ld<NP>(w1r, adv(sw, NW) * pf + fs);
        rc = ordered<NP>(ld<NP>(rst, (t & 1) * pf + rb), rev);
      }
      Vf<NP> d1, q1v, d2, q2v, w1, w2, out;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        d1.x[i] = __fsub_rn(x.x[i], c.x[i]);
        q1v.x[i] = __fmul_rn(d1.x[i], d1.x[i]);
        d2.x[i] = __fsub_rn(mid.x[i], c2v.x[i]);
        q2v.x[i] = __fmul_rn(d2.x[i], d2.x[i]);
        if (aw1) w1.x[i] = whiten(dd1.x[i], lp1.x[i], a.fac1, thr1, a.soft);
        if (aw2) {
          w2.x[i] = whiten(dd2.x[i], lp2.x[i], a.fac2, thr2, a.soft);
          // recon += white_s, then += white_s+1, in float32
          out.x[i] = __fadd_rn(__fadd_rn(rc.x[i], w1h.x[i]), w2.x[i]);
        }
      }
      if (a1 && r1) {
        st<NP>(c1r, s1 * pf + f, c);
        st<NP>(q1r, sq1 * pf + f, q1v);
        st<NP>(d1r, sd1 * pf + f, d1);
      }
      if (a2 && r2) {
        st<NP>(q2r, sq2 * pf + f, q2v);
        st<NP>(d2r, sd2 * pf + f, d2);
        if (own && q2 >= p0 && q2 < p1)
          store(frame_c + row_at(u_q2) * W, c2v);
      }
      if (aw1 && ro) {
        if (own && frame_w1) store(frame_w1 + row_at(u_o1) * W, w1);
        st<NP>(w1r, sw * pf + f, w1);
      }
      if (aw2 && own) {
        const long long ro2 = row_at(u_o2) * W;
        if (frame_w2) store(frame_w2 + ro2, w2);
        if (frame_r) store(frame_r + ro2, out);
      }
      u_f = adv(u_f, Lr);
      u_q2 = adv(u_q2, Lr);
      u_o1 = adv(u_o1, Lr);
      u_o2 = u_r;
      sC = adv(sC, NC);
      s1 = o1s;
      sq1 = oq1;
      sq2 = oq2;
      sd1 = adv(sd1, ND1);
      sd2 = adv(sd2, ND2);
      sw = adv(sw, NW);
    };
    // every stage is on from white_s+1's first tick to white_s's last
    const int all0 = 8 * hw + 2, all1 = (p1 - p0) + 5 * hw + 1;
    for (int t = 0; t < T; ++t) {
      if (t >= all0 && t < all1)
        tick(t, std::true_type());
      else
        tick(t, std::false_type());
    }
    __syncthreads();  // the next item's prologue refills the rings
  }
}

template <int HW, int NP, bool CIRCLE>
static int launch_pair_stream(const PairStream& a, long long grid, int bytes,
                              cudaStream_t s) {
  static std::atomic<int> optin[wt::kMaxDevices];
  cudaError_t err = wt::smem_optin(pair_stream<HW, NP, CIRCLE>, bytes, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_stream<HW, NP, CIRCLE>
      <<<static_cast<unsigned>(grid), a.threads, static_cast<size_t>(bytes),
         s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3) == 0;
}

bool aligned8(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7) == 0;
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
  PairArgs a;
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
    return fast ? launch<HW, true>(cfg, a) : launch<HW, false>(cfg, a);
  });
}

// The same pair in the bfloat16 route, one launch of the stream: a
// float32 carry, c_next2 and recon (recon += white_s, then += white_s+1,
// unrounded), the whites stored in bfloat16, the middle carry, the
// details and the thresholds float32.  The launch is
// the wrapper's plan (ops/hopper_deep.py::pair_stream_plan): k column
// classes a group, run output positions a column window (0: the whole
// circle), chunk positions of the row circle an item, threads a block
// (128, 256 or 512), grid blocks, smem_bytes of shared memory; it is checked (pair_layout) and launched
// as given.  Returns as wt_whiten_pair_f32.
int wt_whiten_pair_bf16(const float* carry, float* c_next2, bf16* white1,
                        bf16* white2, float* recon, const float* thr,
                        float fac1, float fac2, int masked1, int masked2,
                        int soft, const double* taps, int n_taps, long long B,
                        long long H, long long W, long long D, long long k,
                        long long run, long long chunk, long long threads,
                        long long grid, long long smem_bytes, void* stream) {
  PairStream a = {};
  if (!wt::make_taps(taps, n_taps, &a.taps) || !carry || !c_next2 ||
      ((masked1 || masked2) && !thr) || (!recon && !(white1 && white2)) ||
      !pair_layout(&a, B, H, W, D, k, run, chunk, threads, grid,
                   smem_bytes))
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
  a.vec_c = wt::aligned16(carry);
  a.vec_r = recon != nullptr && wt::aligned16(recon);
  a.st_vec = aligned8(c_next2) && (!white1 || aligned4(white1)) &&
             (!white2 || aligned4(white2)) && (!recon || aligned8(recon));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bytes = static_cast<int>(smem_bytes);
  return wt::dispatch_hw(a.taps.hw, [&](auto hw) {
    constexpr int HW = decltype(hw)::value;
    if (k >= 2)
      return run ? launch_pair_stream<HW, 2, false>(a, grid, bytes, s)
                 : launch_pair_stream<HW, 2, true>(a, grid, bytes, s);
    return run ? launch_pair_stream<HW, 1, false>(a, grid, bytes, s)
               : launch_pair_stream<HW, 1, true>(a, grid, bytes, s);
  });
}

}  // extern "C"
