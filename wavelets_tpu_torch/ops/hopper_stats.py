"""Exact ``median(|x|)`` of a float32 plane (kernel B).

Counterpart of ``wavelets_tpu/ops/pallas_stats.py::median_bits2`` and of
``wavelets_tpu/ops/stats.py::_median_nonneg_pallas``.  On a CUDA tensor
the order statistics come from the hand-written radix select
``csrc/median_select.cu`` (see the source's note for its design and
bound), launched as :func:`select_plan` says; on a CPU tensor the plain
version sorts.  Either way the result is bitwise numpy's median: the
mean of the two middle values for an even count.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from .. import tracing
from . import _build

__all__ = ["median_bits2", "median_bits2_plain", "median_abs", "middle_ranks",
           "SelectPlan", "select_plan"]

KERNEL = "median_select"

_ABS = 0x7FFFFFFF

#: the first digit's histogram pass takes about this many patterns a
#: block; the grid is capped at 4 blocks an SM (the per-block histogram
#: table of the compaction offsets grows with the grid)
SELECT_PER_BLOCK = 4096
SELECT_BLOCKS_PER_SM = 4
#: the first digit's chosen bin is compacted into scratch where it holds
#: at most ``ceil(n / SELECT_CAP_DIV)`` patterns (a normal frame's median
#: bin holds about 8%); beyond, as for heavy ties, the later digits read
#: the plane again
SELECT_CAP_DIV = 4
#: the kernel's scratch besides the candidates: its state, and its three
#: global histograms (the radix digits of the 31-bit |x| pattern, bits
#: 20-30, 10-19 and 0-9, are the kernel's constants), each 64-bit; then 8
#: bytes a block of offsets and, a block, the first digit's 2048 32-bit
#: counters
_STATE_BYTES = 64
_HIST_BINS = 2048 + 1024 + 1024
_FIRST_BINS = 2048


@dataclass(frozen=True)
class SelectPlan:
    """Kernel B's launch, passed to ``csrc/median_select.cu`` as it
    stands (the C entry checks it and launches it): ``blocks`` blocks for
    each of its three histogram launches, at most ``cap`` compacted
    candidates, ``scratch_bytes`` of device scratch (state, three
    histograms, the per-block offsets and digit-1 histograms, the
    candidates)."""
    blocks: int
    cap: int
    scratch_bytes: int


def select_plan(n: int, n_sms: int) -> SelectPlan:
    """Kernel B's launch for ``n`` patterns on a card of ``n_sms`` SMs."""
    if n < 1 or n_sms < 1:
        raise ValueError(f"select_plan: n = {n}, n_sms = {n_sms}")
    blocks = max(1, min(-(-n // SELECT_PER_BLOCK),
                        SELECT_BLOCKS_PER_SM * n_sms))
    cap = -(-n // SELECT_CAP_DIV)
    scratch = (_STATE_BYTES + 8 * _HIST_BINS + 16 * -(-blocks // 2)
               + 4 * _FIRST_BINS * blocks + 4 * cap)
    return SelectPlan(blocks, cap, scratch)


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def middle_ranks(n: int):
    """0-based ranks of numpy's two middle order statistics."""
    return (n - 1) // 2, n // 2


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.wt_median_select
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3
                   + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check_ks(n: int, ks: Sequence[int]):
    k_lo, k_hi = (int(k) for k in ks)
    if n < 1 or not 0 <= k_lo <= k_hi < n:
        raise ValueError(f"ranks {ks} out of range for {n} elements")
    return k_lo, k_hi


def median_bits2_plain(bits: torch.Tensor, ks: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version of :func:`median_bits2`: a sort of the
    sign-masked patterns."""
    with tracing.plain(KERNEL):
        flat = bits.reshape(-1) & _ABS
        k_lo, k_hi = _check_ks(flat.numel(), ks)
        return torch.sort(flat).values[[k_lo, k_hi]]


def median_bits2(bits: torch.Tensor, ks: Sequence[int]) -> torch.Tensor:
    """Bit patterns (int32) of the ``ks = (k_lo, k_hi)``-th smallest
    ``|x|`` (0-based, ``k_lo <= k_hi``) among the float32 values whose
    patterns are ``bits`` (any shape; the sign bit is ignored, so
    non-negative patterns as the TPU kernel takes them work unchanged).
    Returns a ``(2,)`` int32 tensor on ``bits``' device.  A CPU tensor
    runs :func:`median_bits2_plain` (any ranks); a CUDA tensor runs
    kernel B, which takes neighbouring ranks (``k_hi <= k_lo + 1``, as
    every median asks), or raises."""
    if not bits.is_cuda:
        return median_bits2_plain(bits, ks)
    if bits.dtype != torch.int32:
        raise TypeError(f"median_bits2: the CUDA kernel takes int32 "
                        f"patterns, got {bits.dtype}")
    if not bits.is_contiguous():
        raise ValueError("median_bits2: the CUDA kernel needs a contiguous "
                         "tensor")
    n = bits.numel()
    k_lo, k_hi = _check_ks(n, ks)
    if k_hi > k_lo + 1:
        raise ValueError(f"median_bits2: the CUDA kernel takes neighbouring "
                         f"ranks, got {ks}")
    plan = select_plan(n, _n_sms(bits.device.index
                                 if bits.device.index is not None
                                 else torch.cuda.current_device()))
    with tracing.launch(KERNEL):
        lib = _lib()
        # scratch held by name until the launches are queued
        scratch = torch.empty(-(-plan.scratch_bytes // 8), dtype=torch.int64,
                              device=bits.device)
        out = torch.empty(2, dtype=torch.int32, device=bits.device)
        code = lib.wt_median_select(
            ctypes.c_void_p(bits.data_ptr()), n, k_lo, k_hi,
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(scratch.data_ptr()), plan.scratch_bytes,
            plan.blocks, plan.cap, _build.stream_ptr(bits.device))
        _build.check(lib, code, "median_select")
    return out


def median_abs(x: torch.Tensor,
               select: Callable = median_bits2) -> torch.Tensor:
    """Exact ``median(|x|)`` of a float32 tensor as a 0-d float32 tensor
    on its device: both middle order statistics by ``select`` (kernel B's
    wrapper, or its plain version), then numpy's mean of the two."""
    if x.dtype != torch.float32:
        raise TypeError(f"median_abs takes float32, got {x.dtype}")
    bits = x.contiguous().reshape(-1).view(torch.int32)
    vals = select(bits, middle_ranks(bits.numel())).view(torch.float32)
    return (vals[0] + vals[1]) / 2
