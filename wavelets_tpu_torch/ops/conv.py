"""Dilated ("à trous") convolution primitives in plain PyTorch.

Counterpart of ``wavelets_tpu/ops/conv.py``.  These are the plain
versions: the CPU path, the float64 path on the card, and the reference
the Hopper kernels (``ops/hopper_conv.py``) are held against.

* Dilation is an index stride: tap ``j`` of the scale-``s`` kernel reads
  the sample ``j·2^s`` away; the kernel's zeros are never materialized.
* Boundaries are index maps, not pads.  ``symmetric`` is numpy's
  edge-duplicating reflection (cv2 ``BORDER_REFLECT``), which for a pad
  wider than the extent repeats with period ``2n``;
  ``torch.nn.functional.pad`` has no such mode.  ``reflect`` is
  numpy's whole-sample reflection (reflect-101), period ``2n − 2``.
  2-D/3-D transforms use ``symmetric``, 1-D uses ``reflect``
  (watroo/wavelets.py:35-69, SURVEY §2.4).
* Symmetric taps fold pairwise in the JAX package's order,
  ``x·t_c + Σ_j t_{c+j}·(x←jd + x→jd)``, axis by axis in the order
  given, so float64 parity stays at round-off and float32 is bitwise.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .filters import ScalingFunction

__all__ = ["boundary_for_ndim", "boundary_index", "separable_smooth_axis",
           "smooth"]


def boundary_for_ndim(n_dim: int) -> str:
    """Reference boundary mode per dimensionality (SURVEY §2.4):
    'symmetric' for 2-D/3-D, 'reflect' for 1-D (and >3-D)."""
    return "symmetric" if n_dim in (2, 3) else "reflect"


def boundary_index(n: int, shift: int, boundary: str,
                   device=None) -> torch.Tensor:
    """Source index of every output sample ``i`` for the value at
    ``i + shift`` on an extent ``n`` extended by ``boundary`` — the
    index form of ``np.pad(..., mode=boundary)`` for any pad width."""
    i = torch.arange(n, device=device, dtype=torch.int64) + shift
    if boundary == "symmetric":
        p = torch.remainder(i, 2 * n)
        return torch.where(p < n, p, 2 * n - 1 - p)
    if boundary == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        p = torch.remainder(i, 2 * n - 2)
        return torch.where(p < n, p, 2 * n - 2 - p)
    raise ValueError(f"unsupported boundary {boundary!r}")


def separable_smooth_axis(
    x: torch.Tensor,
    taps: Tuple[float, ...],
    scale: int,
    axis: int,
    boundary: str = "symmetric",
) -> torch.Tensor:
    """1-D dilated convolution along ``axis`` with dilation ``2**scale``."""
    k = len(taps)
    hw = (k - 1) // 2
    if hw == 0:
        return x * taps[0]
    d = 2 ** scale
    n = x.shape[axis]

    def shifted(offset):
        return x.index_select(
            axis, boundary_index(n, offset, boundary, x.device))

    symmetric = all(taps[i] == taps[-1 - i] for i in range(hw))
    out = x * taps[hw]
    if symmetric:
        for j in range(1, hw + 1):
            out = out + taps[hw + j] * (shifted(-j * d) + shifted(j * d))
    else:
        for j in range(1, hw + 1):
            out = out + taps[hw - j] * shifted(-j * d)
            out = out + taps[hw + j] * shifted(j * d)
    return out


def smooth(
    x: torch.Tensor,
    sf: ScalingFunction,
    scale: int = 0,
    axes: Optional[Sequence[int]] = None,
    boundary: Optional[str] = None,
) -> torch.Tensor:
    """Separable n-D dilated smoothing ≡ reference ``convolution``
    (watroo/wavelets.py:35-71).  ``axes=None`` smooths every axis; pass
    explicit axes to smooth a batched stack (``axes=(1, 2)`` for
    ``(B, H, W)``)."""
    if axes is None:
        axes = tuple(range(x.ndim))
    if boundary is None:
        boundary = boundary_for_ndim(len(axes))
    out = x
    for ax in axes:
        out = separable_smooth_axis(out, sf.taps, scale, ax, boundary)
    return out
