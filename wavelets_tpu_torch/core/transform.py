"""The à trous transform: standard decomposition and synthesis.

Counterpart of ``wavelets_tpu/core/transform.py`` for the standard
(non-bilateral) algorithm (watroo/wavelets.py:408-444): chained
smoothing with dilation ``2^s``; plane ``s`` is ``smooth_s −
smooth_{s+1}`` and plane ``level`` the residual, so synthesis is a plain
sum and exact by construction.  Plain PyTorch; the fused decompose
kernel (``pallas_conv._fused_group``) is still to be ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.conv import boundary_for_ndim, smooth
from ..ops.filters import ScalingFunction
from ..ops.layout import stack_planes

__all__ = ["decompose", "synthesize", "normalize_bilateral"]


def normalize_bilateral(bilateral, level: int):
    """Reference list-padding convention for per-scale bilateral σ
    (watroo/wavelets.py:349-352, :421-424): scalar → repeated level+1
    times; list shorter than level+1 → extended with 1s."""
    if bilateral is None:
        return None
    if isinstance(bilateral, (list, tuple)):
        sig = list(bilateral)
    else:
        sig = [bilateral] * (level + 1)
    if len(sig) <= level:
        sig.extend([1] * (level - len(sig) + 1))
    return tuple(float(s) for s in sig)


def decompose(
    x: torch.Tensor,
    level: int,
    sf: ScalingFunction,
    *,
    axes: Optional[Tuple[int, ...]] = None,
    boundary: Optional[str] = None,
    scale_offset: int = 0,
) -> torch.Tensor:
    """À trous decomposition → coefficient cube ``(level+1, *x.shape)``.

    ``axes`` selects the spatial axes (default: all); leading non-spatial
    axes are a batch.  ``scale_offset`` starts the dilation ladder at
    ``2^offset``."""
    if axes is None:
        axes = tuple(range(x.ndim))
    axes = tuple(a % x.ndim for a in axes)
    if boundary is None:
        boundary = boundary_for_ndim(len(axes))
    planes = []
    c = x
    for s in range(level):
        c_next = smooth(c, sf, s + scale_offset, axes=axes, boundary=boundary)
        planes.append(c - c_next)
        c = c_next
    planes.append(c)
    return stack_planes(planes)


def synthesize(planes: torch.Tensor) -> torch.Tensor:
    """Inverse transform: the sum of the planes (watroo/utils.py:98)."""
    return torch.sum(planes, dim=0)
