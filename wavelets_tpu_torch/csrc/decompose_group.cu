// À trous decomposition of a group of g scales on the card (kernel C).
// Plain C interface, loaded with ctypes (wavelets_tpu_torch/ops/_build.py);
// wrapper, buffer choice and launch plans in ops/hopper_conv.py
// (fused_group, decompose_buffers, step_plan).
//
// Replaces wavelets_tpu/ops/pallas_conv.py::_fused_group (_make_kernel):
// g chained smooths at dilations 2^offset .. 2^(offset+g-1) on halo'd
// VMEM tiles, emitting the g detail planes and the carry, or only the
// carry with smooth_only (the 3-D volume path's in-plane pass).  The TPU
// kernel's tile planner, nine DMA window variants and MXU mirrors exist
// for VMEM and Mosaic; none of that carries over.
//
// Design.  One launch per scale: the FIRST pass of wt_step.cuh, kernel
// A's deep-step row buffer.  A block folds one image row (or a segment
// of it) down the 2hw+1 tap rows into a shared-memory row buffer, with
// the raw centre row beside it, then folds the buffer along the columns:
// c_next, and detail = carry - c_next (no detail with smooth_only).
// Blocks walk the rows in residue-class order, so the far tap rows of
// neighbouring blocks stay in L2.  A scale moves 3 planes (read the
// carry; write c_next and the detail), 2 with smooth_only, against 5 in
// the earlier two per-pixel launches through a tmp plane.  The rows fold
// reads carry rows that belong to other blocks, so c_next cannot
// overwrite the carry: the wrapper names each scale's source, c_next and
// detail (decompose_buffers), c_next alternating between the cube's
// carry row and one spare plane so that the last scale lands in the
// carry row; x is the first source and is never written.  Dilations past
// the symmetric map's period run as their remainder (map_step) and
// batches past 65535 frames as several launches, so every offset + g <=
// 62 runs at any (B, H, W) the plan's 32-bit reach allows.
//
// Bound: device memory.  The function must read x once and write g+1
// planes (0.34 GB at 4096^2, g = 3: about 0.10 ms at 3.35 TB/s).
// Measured on an H100 80GB HBM3 at 700 W (scripts/kernel_variants.py,
// device time): 0.257-0.264 ms a group of 3 at 4096^2, offsets 0 and 3
// (the two per-pixel launches a scale: 1.47 ms around the call);
// kernel A's group tile (whiten_group.cu) as the whole group in one
// launch, with its halo of 14, took 0.323 ms at offset 0 and was
// dropped.
//
// Rounding.  The folds round step by step in the JAX package's order
// (wt_common.cuh) and the detail is one IEEE subtraction, so details and
// carry are bitwise equal to the plain PyTorch version on the same card.
//
// Launch.  Each scale's segment width, grid, shared-memory bytes and
// offset width are the wrapper's plan (step_plan), checked here and
// launched as given.

#include "wt_step.cuh"


extern "C" {

const char* wt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// g scales at dilations 2^(offset+k) (offset + g <= 62) of a contiguous
// (B, H, W) float32 stack.  Scale k reads src[k], writes c_next[k] and,
// unless it is null, detail[k]: g device pointers each, the wrapper's
// buffer choice (ops/hopper_conv.py::decompose_buffers), so that src[0]
// is the input, src[k+1] = c_next[k], and the three of a scale are
// distinct.  taps: n_taps symmetric host-side weights.  The launch of
// scale k is the wrapper's plan: seg[k], grid_rows[k] x grid_segs[k] x
// frames blocks (a launch per `frames` consecutive frames), smem[k]
// bytes of shared memory, index_bits (32 or 64) wide offsets.  Returns
// cudaErrorInvalidValue for arguments or a plan the kernel does not
// take, else cudaGetLastError() after the first failing launch, or 0.
int wt_decompose_group_f32(const float* const* src, float* const* c_next,
                           float* const* detail, int g, int offset,
                           const double* taps, int n_taps, long long B,
                           long long H, long long W, const long long* seg,
                           const long long* grid_rows,
                           const long long* grid_segs, long long frames,
                           const long long* smem, int index_bits,
                           void* stream) {
  wt::StepArgs a = {};
  if (!wt::make_taps(taps, n_taps, &a.taps) || !src || !c_next ||
      !detail || !seg || !grid_rows || !grid_segs || !smem || g < 1 ||
      offset < 0 || offset + g > 62)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < g; ++k) {
    const wt::StepPlan p = {seg[k], grid_rows[k], grid_segs[k], frames,
                            smem[k], index_bits};
    if (!src[k] || !c_next[k] || src[k] == c_next[k] ||
        (detail[k] && (detail[k] == src[k] || detail[k] == c_next[k])) ||
        (k > 0 && src[k] != c_next[k - 1]) ||
        !wt::step_plan_ok(p, a.taps.hw, B, H, W, 1ll << (offset + k)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  a.H = static_cast<int>(H);
  a.W = static_cast<int>(W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int k = 0; k < g; ++k) {
    const wt::StepPlan p = {seg[k], grid_rows[k], grid_segs[k], frames,
                            smem[k], index_bits};
    a.carry = src[k];
    a.c_next = c_next[k];
    a.detail = detail[k];
    const int err =
        wt::run_step_pass<false>(a, p, B, 1ll << (offset + k), s);
    if (err) return err;
  }
  return 0;
}

}  // extern "C"
