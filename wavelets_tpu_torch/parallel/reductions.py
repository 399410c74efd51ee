"""Distributed reductions for the sharded pipelines.

Counterpart of ``wavelets_tpu/parallel/reductions.py``: moments, min and
max are ``all_reduce``s of local reductions, and the MAD noise
estimator's **exact median** is found without gathering the plane: a
bisection on the bit patterns of the non-negative values (IEEE floats
≥ 0 order as their integer bits), one ``all_reduce(SUM)`` of the
per-batch rank counts a round, ``itemsize·8`` rounds.  The counts are
integers, so the median is exact on every backend.  Kernel B (the
single-device median) is not used: JAX's engine does not use its Pallas
select either, and kernel B's wrapper takes the ranks of one frame.

Every function takes leading batch dimensions (``batch_ndim``): the
reduction runs per batch element over the remaining local axes and the
ranks of ``group``, so a frame stack split over the data axis keeps
per-frame statistics.  The mean and std sum in float64 whatever the
input's dtype (JAX's sum in it): a float32 sum of a 4096² plane of mean
10 loses about 1e-5 of the mean, and the residual's whitening (the
residual over its std, which is far below its mean) amplified that to
1e-4 of the reconstruction on the H100, past the float32 standard
against single-device ``wow`` (its ``torch.std``).  The sums' order
across ranks is the backend's, not XLA's: mean and std agree with JAX
to the float standards, not bitwise.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import all_reduce

__all__ = ["kth_smallest", "distributed_median", "distributed_mean",
           "distributed_std", "distributed_min", "distributed_max"]

_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _red_axes(a: torch.Tensor, batch_ndim: int):
    return tuple(range(batch_ndim, a.ndim))


def _expand(v: torch.Tensor, a: torch.Tensor, batch_ndim: int):
    return v.reshape(v.shape + (1,) * (a.ndim - batch_ndim))


def kth_smallest(a: torch.Tensor, k, group,
                 batch_ndim: int = 0) -> torch.Tensor:
    """Exact k-th (0-indexed) smallest element of non-negative ``a``
    across the ranks of ``group`` and the local non-batch axes; shape
    ``a.shape[:batch_ndim]``.  Bisection over the integer bit patterns:
    the answer's pattern stays in ``[lo, hi]``, and each of the
    ``itemsize·8`` rounds halves the interval with one ``all_reduce`` of
    the counts ``≤ mid``."""
    idt = _BITS[a.element_size()]
    nbits = a.element_size() * 8
    bits = a.contiguous().view(idt)
    red = _red_axes(a, batch_ndim)
    bshape = a.shape[:batch_ndim]
    k = torch.as_tensor(k, dtype=torch.int64, device=a.device)
    lo = torch.zeros(bshape, dtype=torch.int64, device=a.device)
    hi = torch.full(bshape, (1 << (nbits - 1)) - 1, dtype=torch.int64,
                    device=a.device)  # the sign bit clear
    for _ in range(nbits):
        mid = lo + (hi - lo) // 2
        cnt = torch.sum(bits <= _expand(mid.to(idt), a, batch_ndim),
                        dim=red)
        all_reduce(cnt, group)
        take_low = cnt >= k + 1
        lo = torch.where(take_low, lo, mid + 1)
        hi = torch.where(take_low, mid, hi)
    return hi.to(idt).view(a.dtype)


def distributed_median(a: torch.Tensor, group, total_count: int,
                       batch_ndim: int = 0) -> torch.Tensor:
    """Exact global median of non-negative ``a`` (numpy's rule: the mean
    of the two middle order statistics for an even count).
    ``total_count`` is the global element count per batch element."""
    k_lo = (total_count - 1) // 2
    k_hi = total_count // 2
    lo = kth_smallest(a, k_lo, group, batch_ndim)
    if k_hi == k_lo:
        return lo
    hi = kth_smallest(a, k_hi, group, batch_ndim)
    return (lo + hi) / 2


def _sum64(a: torch.Tensor, batch_ndim: int) -> torch.Tensor:
    return torch.sum(a, dim=_red_axes(a, batch_ndim), dtype=torch.float64)


def distributed_mean(a: torch.Tensor, group, total_count: int,
                     batch_ndim: int = 0) -> torch.Tensor:
    return (all_reduce(_sum64(a, batch_ndim), group)
            / total_count).to(a.dtype)


def distributed_std(a: torch.Tensor, group, total_count: int,
                    batch_ndim: int = 0) -> torch.Tensor:
    """Global std (numpy ``ddof=0``) from ``all_reduce``d moments."""
    mean = distributed_mean(a, group, total_count, batch_ndim)
    dev = a - _expand(mean, a, batch_ndim)
    var = all_reduce(_sum64(dev ** 2, batch_ndim), group) / total_count
    return torch.sqrt(var).to(a.dtype)


def distributed_min(a: torch.Tensor, group,
                    batch_ndim: int = 0) -> torch.Tensor:
    return all_reduce(torch.amin(a, dim=_red_axes(a, batch_ndim)), group,
                      dist.ReduceOp.MIN)


def distributed_max(a: torch.Tensor, group,
                    batch_ndim: int = 0) -> torch.Tensor:
    return all_reduce(torch.amax(a, dim=_red_axes(a, batch_ndim)), group,
                      dist.ReduceOp.MAX)
