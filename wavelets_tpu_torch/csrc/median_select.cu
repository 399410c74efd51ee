// Exact order statistics of |x| for float32 x: the two middle values
// behind numpy's median, by a radix select on the bit patterns (kernel B).
// Plain C interface, loaded with ctypes (wavelets_tpu_torch/ops/_build.py);
// wrapper and launch plan in ops/hopper_stats.py (median_bits2,
// select_plan).
//
// Replaces wavelets_tpu/ops/pallas_stats.py::median_bits2 (_make_kernel),
// which bisects the int32 patterns in 12 passes of 8-way rank counts on
// the TPU's sequential grid (one launch, SMEM interval state) and counts
// in float32, exact only below 2^24 per lane.
//
// Design.  Non-negative IEEE floats order like their uint32 patterns, and
// masking the sign bit turns x into |x| on load.  The 31 bits left are
// three digits, bits 20-30, 10-19 and 0-9, selected in four launches:
//   1. init: the state and the first histogram zeroed;
//   2. digit 1 over the whole plane: each block counts into a private
//      shared-memory histogram (where a warp's lanes all fall into one
//      bin, as with ties, it adds once, not 32 colliding atomics) and
//      flushes it to a global 64-bit histogram
//      and, as it is, to its own row of a per-block histogram table.  The
//      last block to finish (an atomic ticket) scans the histogram block-
//      wide, picks the bin of the lower statistic k_lo, and, from the
//      table, each block's offset in the candidate scratch;
//   3. digit 2, the second and last full read: the elements of the chosen
//      bin are histogrammed by their second digit and, where the bin's
//      count is at most the wrapper's cap, compacted into the scratch at
//      their block's offset (no global atomics; a warp scan and one shared
//      atomic a warp and 256 patterns); the least pattern above
//      the bin (the upper statistic where k_hi = k_lo + 1 leaves the bin)
//      is taken in the same read.  Where the count exceeds the cap (heavy
//      ties) nothing is compacted, a decision made on the device;
//   4. digit 3 over the candidates, or over the plane where none were
//      compacted: the last block picks the lower statistic's last digit
//      and the upper statistic: the lower one itself where count(<= lower)
//      > k_hi, else the least pattern above it, from the three levels
//      (above the first bin: launch 3; above the second: this launch's
//      read; above the third: the next non-empty bin of this histogram).
// The last block of each launch zeroes the next histogram.  Counts are
// 64-bit integers; any n >= 1 works; nothing is copied to the host.
//
// Bound: device memory, two reads of the n patterns (64 MB each at
// 4096^2, 0.020 ms each at 3.35 TB/s), plus the candidates (about an
// eighth of the plane for a normal frame, an L2-resident read) and four
// launches' latency, which dominates at 512^2.  Measured on an H100 80GB
// HBM3 at 700 W (scripts/kernel_variants.py, device time): 0.094 ms at
// 4096^2 (digit 1 0.036, digit 2 0.047, digit 3 0.007), 0.023 ms at
// 512^2; the earlier design took nine launches, three one-thread
// histogram scans (about 0.18 ms at 4096^2) and four full reads.
//
// Launch.  The grid, the candidate cap and the scratch bytes are the
// wrapper's plan (select_plan), checked here and launched as given; the
// block width and the digits are this file's constants, the sizes of its
// shared histograms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kAbs = 0x7fffffffu;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the digits, most significant first: bits 20-30, 10-19, 0-9
constexpr int kShift1 = 20, kBins1 = 2048;
constexpr int kShift2 = 10, kBins2 = 1024;
constexpr int kBins3 = 1024;
constexpr long long kStateBytes = 64;

struct SelState {
  unsigned long long k;     // rank of the lower statistic inside the bins
                            // chosen so far
  unsigned long long less;  // elements below the bins chosen so far
  unsigned long long cnt;   // elements of the first digit's chosen bin
  unsigned prefix;          // the pattern bits chosen so far
  unsigned min_gt;          // least pattern above the lower statistic seen
  unsigned compact;         // 1: the candidates are in the scratch
  unsigned ticket[3];       // blocks finished, per histogram launch
};
static_assert(sizeof(SelState) <= kStateBytes, "state");

struct Scratch {
  SelState* st;
  unsigned long long* hist1;  // kBins1
  unsigned long long* hist2;  // kBins2
  unsigned long long* hist3;  // kBins3
  unsigned long long* base;   // per block: its first candidate slot
  unsigned* bhist;            // per block: its digit-1 histogram
  unsigned* cand;             // cap candidates
};

// Byte offsets of the scratch's parts for `blocks` blocks and `cap`
// candidates, each 16-byte aligned; returns the total (select_plan).
inline long long scratch_layout(long long blocks, long long cap,
                                long long off[5]) {
  off[0] = kStateBytes;                              // hist1..3
  off[1] = off[0] + 8ll * (kBins1 + kBins2 + kBins3);  // base
  off[2] = off[1] + 16ll * ((blocks + 1) / 2);         // bhist
  off[3] = off[2] + 4ll * kBins1 * blocks;             // cand
  off[4] = off[3] + 4ll * cap;
  return off[4];
}

// Call f(v, ok) for the n patterns at p, kPer patterns v[0..kPer) of a
// lane at a time with their flags ok[], every lane of a warp together (f
// may use warp votes): two 16-byte loads a lane and an iteration, from
// the first 16-byte boundary (`head` patterns before it); the last
// block's first warp takes the head and the ragged tail, one pattern a
// lane.  The split of the patterns among blocks depends on n, head and
// the grid only, so two launches with one grid give each block the same
// patterns.
constexpr int kPer = 8;

template <class F>
__device__ __forceinline__ void for_each(const unsigned* __restrict__ p,
                                         long long n, int head, F f) {
  const int lane = threadIdx.x & 31;
  const long long n4 = (n - head) / 4;
  const uint4* __restrict__ v4 = reinterpret_cast<const uint4*>(p + head);
  const long long stride = 2ll * gridDim.x * blockDim.x;
  for (long long i0 = 2ll * (static_cast<long long>(blockIdx.x) * blockDim.x +
                             (threadIdx.x & ~31));
       i0 < n4; i0 += stride) {
    const long long i = i0 + lane, j = i + 32;
    const bool ok_i = i < n4, ok_j = j < n4;
    const uint4 a = ok_i ? v4[i] : make_uint4(0u, 0u, 0u, 0u);
    const uint4 b = ok_j ? v4[j] : make_uint4(0u, 0u, 0u, 0u);
    const unsigned v[kPer] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const bool ok[kPer] = {ok_i, ok_i, ok_i, ok_i, ok_j, ok_j, ok_j, ok_j};
    f(v, ok);
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < 32) {
    const long long tail = head + 4 * n4;
    const int extra = head + static_cast<int>(n - tail);  // at most 6
    const bool in = lane < extra;
    const long long at = lane < head ? lane : tail + (lane - head);
    const unsigned v[kPer] = {in ? p[at] : 0u};
    const bool ok[kPer] = {in};
    f(v, ok);
  }
}

// One count into bin `bin` of a shared histogram for each lane with ok.
// Where every such lane of the warp has the same bin (ties), the warp
// adds once; else each lane adds (a shared atomic; the hardware
// serializes the lanes that collide).
__device__ __forceinline__ void hist_add(unsigned* sh, unsigned bin,
                                         bool ok) {
  const unsigned act = __ballot_sync(kAll, ok);
  if (!ok) return;
  const int leader = __ffs(act) - 1;
  if (__all_sync(act, bin == __shfl_sync(act, bin, leader))) {
    if ((threadIdx.x & 31) == leader) atomicAdd(sh + bin, __popc(act));
  } else {
    atomicAdd(sh + bin, 1u);
  }
}

// Exclusive prefix sum of one value a thread over the block; *total gets
// the block's sum.  Every thread calls it; it synchronizes.
__device__ unsigned long long block_scan(unsigned long long v,
                                         unsigned long long* total) {
  __shared__ unsigned long long warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long t = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl += t;
  }
  __syncthreads();  // warp_sum free from an earlier call
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  unsigned long long before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += warp_sum[w];
    all += warp_sum[w];
  }
  *total = all;
  return before + incl - v;
}

struct Choice {
  int bin;                   // the bin holding rank k
  int next;                  // the first non-empty bin above it, or NB
  unsigned long long below;  // elements in the bins below it
  unsigned long long cnt;    // elements in it
};

// The bin of a global histogram of NB bins that holds rank k (0-based),
// by a block-wide scan; every thread calls it and sees the result.
template <int NB>
__device__ void choose_bin(const unsigned long long* hist,
                           unsigned long long k, Choice* ch) {
  constexpr int kPer = NB / kThreads;
  static_assert(NB % kThreads == 0, "bins per thread");
  const int first = threadIdx.x * kPer;
  unsigned long long c[kPer], sum = 0, total;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    c[j] = __ldcg(hist + first + j);
    sum += c[j];
  }
  if (threadIdx.x == 0) ch->next = NB;
  unsigned long long cum = block_scan(sum, &total);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (k >= cum && k - cum < c[j]) {
      ch->bin = first + j;
      ch->below = cum;
      ch->cnt = c[j];
    }
    cum += c[j];
  }
  __syncthreads();
  const int bin = ch->bin;
  int next = NB;
#pragma unroll
  for (int j = kPer - 1; j >= 0; --j)
    if (first + j > bin && c[j]) next = first + j;
  if (next < NB) atomicMin(&ch->next, next);
  __syncthreads();
}

// Whether this block is the last of the grid to finish its flush.  Every
// thread calls it.
__device__ bool last_block(unsigned* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The block's least pattern m (one value a thread) into st->min_gt.
__device__ void block_min_to(unsigned m, unsigned* dst) {
  __shared__ unsigned warp_min[kWarps];
  m = __reduce_min_sync(kAll, m);
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) m = min(m, warp_min[w]);
    if (m != kAll) atomicMin(dst, m);
  }
}

template <int NB>
__device__ void flush(const unsigned* sh, unsigned long long* hist) {
  for (int i = threadIdx.x; i < NB; i += kThreads)
    if (sh[i]) atomicAdd(hist + i, static_cast<unsigned long long>(sh[i]));
}

__global__ void __launch_bounds__(kThreads)
    sel_init(Scratch s, unsigned long long k_lo) {
  for (int i = threadIdx.x; i < kBins1; i += kThreads) s.hist1[i] = 0ull;
  if (threadIdx.x == 0) {
    SelState* st = s.st;
    st->k = k_lo;
    st->less = 0ull;
    st->cnt = 0ull;
    st->prefix = 0u;
    st->min_gt = kAll;
    st->compact = 0u;
    st->ticket[0] = st->ticket[1] = st->ticket[2] = 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
    sel_digit1(const unsigned* __restrict__ bits, long long n, int head,
               Scratch s, long long cap) {
  __shared__ unsigned sh[kBins1];
  __shared__ Choice ch;
  for (int i = threadIdx.x; i < kBins1; i += kThreads) sh[i] = 0u;
  __syncthreads();
  for_each(bits, n, head, [&](const unsigned* v, const bool* ok) {
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      hist_add(sh, (v[e] & kAbs) >> kShift1, ok[e]);
  });
  __syncthreads();
  unsigned* row = s.bhist + static_cast<long long>(blockIdx.x) * kBins1;
  for (int i = threadIdx.x; i < kBins1; i += kThreads) row[i] = sh[i];
  flush<kBins1>(sh, s.hist1);
  if (!last_block(&s.st->ticket[0])) return;
  SelState* st = s.st;
  choose_bin<kBins1>(s.hist1, st->k, &ch);
  if (threadIdx.x == 0) {
    st->prefix = static_cast<unsigned>(ch.bin) << kShift1;
    st->k -= ch.below;
    st->less += ch.below;
    st->cnt = ch.cnt;
    st->compact = ch.cnt <= static_cast<unsigned long long>(cap) ? 1u : 0u;
  }
  // each block's first candidate slot: the blocks' counts in the chosen
  // bin, summed in block order
  unsigned long long run = 0, total;
  for (int b0 = 0; b0 < static_cast<int>(gridDim.x); b0 += kThreads) {
    const int b = b0 + threadIdx.x;
    const unsigned long long c =
        b < static_cast<int>(gridDim.x)
            ? __ldcg(s.bhist + static_cast<long long>(b) * kBins1 + ch.bin)
            : 0ull;
    const unsigned long long at = run + block_scan(c, &total);
    if (b < static_cast<int>(gridDim.x)) s.base[b] = at;
    run += total;
  }
  for (int i = threadIdx.x; i < kBins2; i += kThreads) s.hist2[i] = 0ull;
}

__global__ void __launch_bounds__(kThreads)
    sel_digit2(const unsigned* __restrict__ bits, long long n, int head,
               Scratch s) {
  __shared__ unsigned sh[kBins2];
  __shared__ unsigned n_cand;
  __shared__ Choice ch;
  for (int i = threadIdx.x; i < kBins2; i += kThreads) sh[i] = 0u;
  if (threadIdx.x == 0) n_cand = 0u;
  __syncthreads();
  SelState* st = s.st;
  const unsigned b1 = st->prefix >> kShift1;
  const bool compact = st->compact != 0u;
  unsigned* __restrict__ out = s.cand + (compact ? s.base[blockIdx.x] : 0ull);
  const int lane = threadIdx.x & 31;
  unsigned m = kAll;
  for_each(bits, n, head, [&](const unsigned* v0, const bool* ok) {
    unsigned v[kPer];
    bool in[kPer];
    int mine = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      v[e] = v0[e] & kAbs;
      const unsigned d1 = v[e] >> kShift1;
      if (ok[e] && d1 > b1) m = min(m, v[e]);
      in[e] = ok[e] && d1 == b1;
      mine += in[e];
      hist_add(sh, (v[e] >> kShift2) & (kBins2 - 1), in[e]);
    }
    if (compact) {
      // the lanes' candidates in lane order: one warp scan and one shared
      // atomic a warp and iteration
      int before = mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kAll, before, o);
        if (lane >= o) before += t;
      }
      const int total = __shfl_sync(kAll, before, 31);
      if (total) {
        unsigned at = 0u;
        if (lane == 31) at = atomicAdd(&n_cand, static_cast<unsigned>(total));
        at = __shfl_sync(kAll, at, 31) + (before - mine);
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          if (in[e]) out[at++] = v[e];
      }
    }
  });
  block_min_to(m, &st->min_gt);
  __syncthreads();
  flush<kBins2>(sh, s.hist2);
  if (!last_block(&st->ticket[1])) return;
  choose_bin<kBins2>(s.hist2, st->k, &ch);
  if (threadIdx.x == 0) {
    st->prefix |= static_cast<unsigned>(ch.bin) << kShift2;
    st->k -= ch.below;
    st->less += ch.below;
  }
  for (int i = threadIdx.x; i < kBins3; i += kThreads) s.hist3[i] = 0ull;
}

__global__ void __launch_bounds__(kThreads)
    sel_digit3(const unsigned* __restrict__ bits, long long n, int head,
               Scratch s, unsigned long long k_hi, unsigned* out) {
  __shared__ unsigned sh[kBins3];
  __shared__ Choice ch;
  for (int i = threadIdx.x; i < kBins3; i += kThreads) sh[i] = 0u;
  __syncthreads();
  SelState* st = s.st;
  const unsigned prefix = st->prefix, hi = prefix >> kShift2;
  unsigned m = kAll;
  auto f = [&](const unsigned* v0, const bool* ok) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const unsigned v = v0[e] & kAbs, vh = v >> kShift2;
      if (ok[e] && vh > hi &&
          (vh >> (kShift1 - kShift2)) == (hi >> (kShift1 - kShift2)))
        m = min(m, v);
      hist_add(sh, v & (kBins3 - 1), ok[e] && vh == hi);
    }
  };
  if (st->compact)
    for_each(s.cand, static_cast<long long>(st->cnt), 0, f);
  else
    for_each(bits, n, head, f);
  block_min_to(m, &st->min_gt);
  __syncthreads();
  flush<kBins3>(sh, s.hist3);
  if (!last_block(&st->ticket[2])) return;
  choose_bin<kBins3>(s.hist3, st->k, &ch);
  if (threadIdx.x == 0) {
    const unsigned lo = prefix | static_cast<unsigned>(ch.bin);
    const unsigned long long le = st->less + ch.below + ch.cnt;
    unsigned gt = __ldcg(&st->min_gt);
    if (ch.next < kBins3) gt = min(gt, prefix | static_cast<unsigned>(ch.next));
    out[0] = lo;
    out[1] = le > k_hi ? lo : gt;
  }
}

}  // namespace

extern "C" {

const char* wt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Patterns of the k_lo-th and k_hi-th smallest |x| (0-based ranks,
// k_lo <= k_hi <= k_lo + 1, k_hi < n) of n float32 patterns on the
// device, written to out[0], out[1].  The launch is the wrapper's plan
// (ops/hopper_stats.py::select_plan): `blocks` blocks for each histogram
// launch, at most `cap` compacted candidates, and `scratch_bytes` of
// 16-byte aligned device scratch; it is checked against what the kernels
// need and launched as given.  Returns cudaErrorInvalidValue for
// arguments or a plan the kernels do not take, else cudaGetLastError()
// after the first failing launch, or 0.
int wt_median_select(const unsigned* bits, long long n, long long k_lo,
                     long long k_hi, unsigned* out, void* scratch,
                     long long scratch_bytes, long long blocks,
                     long long cap, void* stream) {
  long long off[5];
  if (n < 1 || k_lo < 0 || k_hi < k_lo || k_hi > k_lo + 1 || k_hi >= n ||
      !bits || !out || !scratch ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(bits) & 3) != 0 || blocks < 1 ||
      blocks > 65535 || cap < 0 || cap > n ||
      scratch_bytes < scratch_layout(blocks, cap, off))
    return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(scratch);
  Scratch s;
  s.st = reinterpret_cast<SelState*>(base);
  s.hist1 = reinterpret_cast<unsigned long long*>(base + off[0]);
  s.hist2 = s.hist1 + kBins1;
  s.hist3 = s.hist2 + kBins2;
  s.base = reinterpret_cast<unsigned long long*>(base + off[1]);
  s.bhist = reinterpret_cast<unsigned*>(base + off[2]);
  s.cand = reinterpret_cast<unsigned*>(base + off[3]);
  // patterns before the first 16-byte boundary
  int head = static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(bits) & 15)) & 15) / 4);
  if (head > n) head = static_cast<int>(n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  cudaError_t err;
  sel_init<<<1, kThreads, 0, st>>>(s, static_cast<unsigned long long>(k_lo));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  sel_digit1<<<grid, kThreads, 0, st>>>(bits, n, head, s, cap);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  sel_digit2<<<grid, kThreads, 0, st>>>(bits, n, head, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  sel_digit3<<<grid, kThreads, 0, st>>>(bits, n, head, s,
                                        static_cast<unsigned long long>(k_hi),
                                        out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
