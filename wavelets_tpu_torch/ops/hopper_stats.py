"""Exact ``median(|x|)`` of a float32 plane (kernel B).

Counterpart of ``wavelets_tpu/ops/pallas_stats.py::median_bits2`` and of
``wavelets_tpu/ops/stats.py::_median_nonneg_pallas``.  On a CUDA tensor
the order statistics come from the hand-written radix select
``csrc/median_select.cu`` (see the source's note for its design and
bound); on a CPU tensor the plain version sorts.  Either way the result
is bitwise numpy's median: the mean of the two middle values for an
even count.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Sequence

import torch

from . import _build

__all__ = ["median_bits2", "median_bits2_plain", "median_abs", "middle_ranks"]

KERNEL = "median_select"

_ABS = 0x7FFFFFFF


def middle_ranks(n: int):
    """0-based ranks of numpy's two middle order statistics."""
    return (n - 1) // 2, n // 2


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.wt_median_select
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.wt_median_scratch_bytes.argtypes = []
    lib.wt_median_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _check_ks(n: int, ks: Sequence[int]):
    k_lo, k_hi = (int(k) for k in ks)
    if n < 1 or not 0 <= k_lo <= k_hi < n:
        raise ValueError(f"ranks {ks} out of range for {n} elements")
    return k_lo, k_hi


def median_bits2_plain(bits: torch.Tensor, ks: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version of :func:`median_bits2`: a sort of the
    sign-masked patterns."""
    _build.PLAIN_CALLS[KERNEL] += 1
    flat = bits.reshape(-1) & _ABS
    k_lo, k_hi = _check_ks(flat.numel(), ks)
    return torch.sort(flat).values[[k_lo, k_hi]]


def median_bits2(bits: torch.Tensor, ks: Sequence[int]) -> torch.Tensor:
    """Bit patterns (int32) of the ``ks = (k_lo, k_hi)``-th smallest
    ``|x|`` (0-based, ``k_lo <= k_hi``) among the float32 values whose
    patterns are ``bits`` (any shape; the sign bit is ignored, so
    non-negative patterns as the TPU kernel takes them work unchanged).
    Returns a ``(2,)`` int32 tensor on ``bits``' device.  A CPU tensor
    runs :func:`median_bits2_plain`; a CUDA tensor runs kernel B or
    raises."""
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
    lib = _lib()
    scratch = torch.empty(-(-lib.wt_median_scratch_bytes() // 8),
                          dtype=torch.int64, device=bits.device)
    out = torch.empty(2, dtype=torch.int32, device=bits.device)
    n_sms = torch.cuda.get_device_properties(bits.device).multi_processor_count
    code = lib.wt_median_select(
        ctypes.c_void_p(bits.data_ptr()), n, k_lo, k_hi,
        ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(scratch.data_ptr()),
        n_sms, _build.stream_ptr(bits.device))
    _build.check(lib, code, "median_select")
    _build.LAUNCHES[KERNEL] += 1
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
