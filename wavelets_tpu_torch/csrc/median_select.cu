// Exact order statistics of |x| for float32 x: the two middle values
// behind numpy's median, by a radix select on the bit patterns.  Plain C
// interface, loaded with ctypes (wavelets_tpu_torch/ops/_build.py);
// wrapper in ops/hopper_stats.py.
//
// Replaces wavelets_tpu/ops/pallas_stats.py::median_bits2 (_make_kernel),
// which bisects the int32 patterns in 12 passes of 8-way rank counts on
// the TPU's sequential grid (one launch, SMEM interval state) and counts
// in float32, exact only below 2^24 per lane.
//
// Design.  Non-negative IEEE floats order like their uint32 patterns, and
// masking the sign bit turns x into |x| on load (no abs pass).  The lower
// middle statistic k_lo = (n-1)//2 is selected by three histogram passes
// over 11/11/10 bits of the pattern: each block counts the elements that
// match the prefix found so far into a shared-memory histogram, flushes
// it to a global 64-bit histogram with atomics, and a one-thread kernel
// scans the histogram and narrows the prefix on the device.  A fourth
// pass takes the minimum pattern above the lower statistic (warp
// reduction, atomicMin), and a last one-thread kernel picks the upper
// statistic k_hi = n//2: the lower one itself when count(<= lower) >
// k_hi, else that minimum (pallas_stats.py:100-123's finish).  Counts are
// integers; any n works; nothing is copied to the host.
//
// Bound: by design device memory, four streaming reads of n patterns
// (about 0.27 GB for a 4096^2 frame).  Measured on an H100 80GB HBM3
// (700 W): 0.27-0.29 ms for a 4096^2 frame, of which the three
// one-thread histogram scans (select_bin) take about 0.18 ms and the
// histogram passes 0.12 ms; a block-wide scan and warp-aggregated
// counting are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct SelState {
  unsigned long long k_rem;     // rank still sought inside the prefix
  unsigned long long cnt_less;  // elements strictly below the prefix
  unsigned long long cnt_eq;    // elements in the last selected bin
  unsigned prefix;              // pattern bits selected so far
  unsigned mask;                // which bits of the pattern are selected
  unsigned min_gt;              // min pattern above the lower statistic
  unsigned pad;
};

constexpr unsigned kAbs = 0x7fffffffu;
constexpr int kMaxBins = 2048;

__global__ void init_state(SelState* st, unsigned long long* hist,
                           int n_hist, unsigned long long k_lo) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_hist;
       i += gridDim.x * blockDim.x)
    hist[i] = 0ull;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    st->k_rem = k_lo;
    st->cnt_less = 0ull;
    st->cnt_eq = 0ull;
    st->prefix = 0u;
    st->mask = 0u;
    st->min_gt = 0xffffffffu;
  }
}

__global__ void hist_pass(const unsigned* __restrict__ bits, long long n,
                          const SelState* __restrict__ st,
                          unsigned long long* __restrict__ hist, int shift,
                          int nbins) {
  __shared__ unsigned sh[kMaxBins];
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) sh[i] = 0u;
  __syncthreads();
  const unsigned prefix = st->prefix, mask = st->mask;
  const unsigned bin_mask = static_cast<unsigned>(nbins - 1);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    unsigned v = bits[i] & kAbs;
    if ((v & mask) == prefix) atomicAdd(&sh[(v >> shift) & bin_mask], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nbins; i += blockDim.x)
    if (sh[i]) atomicAdd(&hist[i], static_cast<unsigned long long>(sh[i]));
}

__global__ void select_bin(SelState* st, const unsigned long long* hist,
                           int shift, int nbins) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  unsigned long long k = st->k_rem, cum = 0ull;
  for (int b = 0; b < nbins; ++b) {
    unsigned long long c = hist[b];
    if (cum + c > k) {
      st->prefix |= static_cast<unsigned>(b) << shift;
      st->mask |= static_cast<unsigned>(nbins - 1) << shift;
      st->k_rem = k - cum;
      st->cnt_less += cum;
      st->cnt_eq = c;
      return;
    }
    cum += c;
  }
}

__global__ void min_above(const unsigned* __restrict__ bits, long long n,
                          SelState* st) {
  __shared__ unsigned warp_min[32];
  const unsigned lo = st->prefix;
  unsigned m = 0xffffffffu;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    unsigned v = bits[i] & kAbs;
    if (v > lo && v < m) m = v;
  }
  m = __reduce_min_sync(0xffffffffu, m);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_min[warp] = m;
  __syncthreads();
  if (warp == 0) {
    int n_warps = (blockDim.x + 31) >> 5;
    m = lane < n_warps ? warp_min[lane] : 0xffffffffu;
    m = __reduce_min_sync(0xffffffffu, m);
    if (lane == 0) atomicMin(&st->min_gt, m);
  }
}

__global__ void finish(const SelState* st, unsigned long long k_hi,
                       unsigned* out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  unsigned lo = st->prefix;
  unsigned long long cnt_le = st->cnt_less + st->cnt_eq;
  out[0] = lo;
  out[1] = cnt_le >= k_hi + 1ull ? lo : st->min_gt;
}

}  // namespace

extern "C" {

const char* wt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of device scratch wt_median_select needs.
long long wt_median_scratch_bytes(void) {
  return static_cast<long long>(sizeof(SelState)) +
         3ll * kMaxBins * static_cast<long long>(sizeof(unsigned long long));
}

// Patterns of the k_lo-th and k_hi-th smallest |x| (0-based ranks,
// k_lo <= k_hi < n) of n float32 patterns on the device, written to
// out[0], out[1].  scratch: wt_median_scratch_bytes() on the device,
// 8-byte aligned.  Returns cudaGetLastError() after the first failing
// launch, or 0.
int wt_median_select(const unsigned* bits, long long n, long long k_lo,
                     long long k_hi, unsigned* out, void* scratch,
                     int n_sms, void* stream) {
  if (n < 1 || k_lo < 0 || k_hi < k_lo || k_hi >= n || !bits || !out ||
      !scratch || n_sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SelState* st = static_cast<SelState*>(scratch);
  unsigned long long* hist = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(scratch) + sizeof(SelState));
  const int threads = 256;
  long long want = (n + threads * 16 - 1) / (threads * 16);
  long long cap = 8ll * n_sms;
  unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  cudaError_t err;
  init_state<<<(3 * kMaxBins + threads - 1) / threads, threads, 0, s>>>(
      st, hist, 3 * kMaxBins, static_cast<unsigned long long>(k_lo));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int shifts[3] = {21, 10, 0};
  const int widths[3] = {11, 11, 10};
  for (int p = 0; p < 3; ++p) {
    int nbins = 1 << widths[p];
    unsigned long long* h = hist + p * kMaxBins;
    hist_pass<<<blocks, threads, 0, s>>>(bits, n, st, h, shifts[p], nbins);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    select_bin<<<1, 1, 0, s>>>(st, h, shifts[p], nbins);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  min_above<<<blocks, threads, 0, s>>>(bits, n, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  finish<<<1, 1, 0, s>>>(st, static_cast<unsigned long long>(k_hi), out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
