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
  (watroo/wavelets.py:35-69, SURVEY §2.4); ``wrap`` and ``edge`` are
  numpy's modes of those names, for ``atrous_convolution(mode=...)``.
* Symmetric taps fold pairwise in the JAX package's order,
  ``x·t_c + Σ_j t_{c+j}·(x←jd + x→jd)``, axis by axis in the order
  given, so float64 parity stays at round-off and float32 is bitwise.
* The bilateral smooth (:func:`bilateral_smooth`, the bilateral branch
  of the JAX ``_smooth_step``) is the local variance under the scale
  window times ``σ_b²`` (times ``s+1`` under bilateral scaling), then the
  dense ``(k²−1)``-tap range-weighted sum of :func:`atrous_conv_nd` with
  its normalizer, in the reference's tap order (watroo/wavelets.py:
  24-32, 74-105, 429-440).  These are kernels F and G's plain versions.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .filters import ScalingFunction

__all__ = ["boundary_for_ndim", "boundary_index", "separable_smooth_axis",
           "smooth", "local_variance", "sdev_loc", "atrous_conv_nd",
           "bilateral_smooth", "low_precision", "widen",
           "weak_scalar"]


def low_precision(dtype) -> bool:
    """Whether ``dtype`` is a float type narrower than float32 (bfloat16,
    float16), which the JAX package sends to XLA and whose kernels' plain
    versions fold in float32 and round where the JAX kernels store."""
    return dtype.is_floating_point and torch.finfo(dtype).bits < 32


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 below float32 (:func:`low_precision`), else as it
    is: where a kernel's plain version folds."""
    return x.float() if low_precision(x.dtype) else x


def weak_scalar(v: float, dtype):
    """A Python scalar as the JAX package's weakly typed one meets an array
    of ``dtype``: rounded to it below float32 (torch would compute with
    the scalar at float32 precision), else as it is."""
    return torch.tensor(v, dtype=dtype) if low_precision(dtype) else v


def boundary_for_ndim(n_dim: int) -> str:
    """Reference boundary mode per dimensionality (SURVEY §2.4):
    'symmetric' for 2-D/3-D, 'reflect' for 1-D (and >3-D)."""
    return "symmetric" if n_dim in (2, 3) else "reflect"


def boundary_index(n: int, shift: int, boundary: str,
                   device=None, length: Optional[int] = None) -> torch.Tensor:
    """Source index of every output sample ``i < length`` (default
    ``n``) for the value at ``i + shift`` on an extent ``n`` extended by
    ``boundary`` — the index form of ``np.pad(..., mode=boundary)`` for
    any pad width: ``symmetric``, ``reflect``, ``wrap`` or ``edge``."""
    i = torch.arange(n if length is None else length, device=device,
                     dtype=torch.int64) + shift
    if boundary == "symmetric":
        p = torch.remainder(i, 2 * n)
        return torch.where(p < n, p, 2 * n - 1 - p)
    if boundary == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        p = torch.remainder(i, 2 * n - 2)
        return torch.where(p < n, p, 2 * n - 2 - p)
    if boundary == "wrap":
        return torch.remainder(i, n)
    if boundary == "edge":
        return torch.clamp(i, 0, n - 1)
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


def local_variance(
    x: torch.Tensor,
    sf: ScalingFunction,
    scale: int = 0,
    axes: Optional[Sequence[int]] = None,
    boundary: Optional[str] = None,
    floor: float = 1e-20,
) -> torch.Tensor:
    """Local variance ``⟨x²⟩ − ⟨x⟩²`` under the scaling window at
    ``scale``, clamped ``≤0 → floor`` (``sdev_loc(..., variance=True)``,
    watroo/wavelets.py:24-32).  ``mean·mean`` is rounded before the
    subtraction, as in the JAX package; on data with a large mean the
    difference cancels, so every step is one IEEE operation."""
    mean = smooth(x, sf, scale, axes, boundary)
    mean2 = mean * mean
    vari = smooth(x * x, sf, scale, axes, boundary) - mean2
    return torch.where(vari <= 0, floor, vari)


def sdev_loc(
    x: torch.Tensor,
    sf: ScalingFunction,
    scale: int = 0,
    variance: bool = False,
    axes: Optional[Sequence[int]] = None,
    boundary: Optional[str] = None,
) -> torch.Tensor:
    """Local standard deviation (or variance) under the scale window."""
    v = local_variance(x, sf, scale, axes, boundary)
    return v if variance else torch.sqrt(v)


def _noncenter_offsets(shape: Tuple[int, ...]) -> list:
    """Tap offsets (relative to the centre, in tap units) of a dense n-D
    kernel in the reference's iteration order (watroo/wavelets.py:89-91:
    a meshgrid of descending indices with the centre masked)."""
    hws = tuple(s // 2 for s in shape)
    grids = np.meshgrid(
        *[np.arange(s - 1, -1, -1, dtype=int) for s in shape], indexing="ij")
    mask = np.ones(shape, dtype=bool)
    mask[hws] = False
    return [tuple(int(i) - hw for i, hw in zip(flat, hws))
            for flat in zip(*[g[mask] for g in grids])]


def atrous_conv_nd(
    image: torch.Tensor,
    kernel: np.ndarray,
    scale: int = 0,
    bilateral_variance: Optional[torch.Tensor] = None,
    boundary: str = "symmetric",
) -> torch.Tensor:
    """Dense n-D à trous convolution, plus the bilateral variant
    (watroo/wavelets.py:74-105).

    ``kernel`` is the dense undilated host kernel (float64, e.g.
    ``sf.kernel_nd(n)``); it convolves the last ``kernel.ndim`` axes of
    ``image`` (leading axes are a batch) with the taps ``2^scale`` apart,
    read through the ``boundary`` index map.  Each tap weight is the
    float64 entry rounded to the image's dtype.  With
    ``bilateral_variance`` (the range variance, ``image``'s shape) each
    tap is weighted by ``k·exp(−(x − x_tap)²·(0.5/variance))`` and the sum
    divided by the sum of the weights, the centre counting ``k_c``."""
    kernel = np.asarray(kernel)
    nd = kernel.ndim
    if image.ndim < nd:
        raise ValueError("kernel ndim exceeds image ndim")
    axes = tuple(range(image.ndim - nd, image.ndim))
    d = 2 ** scale
    hws = tuple(s // 2 for s in kernel.shape)

    def weight(k):
        return torch.tensor(k, dtype=image.dtype)

    def tap(off):
        out = image
        for ax, o in zip(axes, off):
            if o:
                out = out.index_select(ax, boundary_index(
                    image.shape[ax], o * d, boundary, image.device))
        return out

    center = float(kernel[hws])
    out = image * weight(center)
    if bilateral_variance is not None:
        norm = torch.full_like(image, center)
        # a true division, as the JAX package's ``0.5 / variance``
        inv_two_var = torch.div(weight(0.5), bilateral_variance)
    for off in _noncenter_offsets(kernel.shape):
        k = float(kernel[tuple(hw + o for hw, o in zip(hws, off))])
        if k == 0.0:
            continue
        shifted = tap(off)
        if bilateral_variance is None:
            out = out + shifted * weight(k)
        else:
            diff = image - shifted
            w = weight(k) * torch.exp(-(diff * diff) * inv_two_var)
            norm = norm + w
            out = out + w * shifted
    if bilateral_variance is not None:
        out = out / norm
    return out


def bilateral_smooth(
    x: torch.Tensor,
    sf: ScalingFunction,
    scale: int,
    sigma2: float,
    bilateral_scaling: bool = False,
    axes: Optional[Sequence[int]] = None,
    boundary: Optional[str] = None,
) -> torch.Tensor:
    """One scale of the bilateral chain smooth (watroo/wavelets.py:
    429-440), the bilateral branch of the JAX package's ``_smooth_step``:
    the range variance is the local variance (``boundary``, the
    dimension's default) times ``sigma2 = σ_b[scale]²`` rounded to the
    dtype, times ``scale + 1`` under ``bilateral_scaling``, one rounding
    each; the range-weighted dense conv always reads through the
    ``symmetric`` map, as the reference does.  ``axes`` must be the
    trailing axes (leading ones are a batch)."""
    if axes is None:
        axes = tuple(range(x.ndim))
    axes = tuple(a % x.ndim for a in axes)
    if axes != tuple(range(x.ndim - len(axes), x.ndim)):
        raise ValueError("batch axes must be leading")
    if boundary is None:
        boundary = boundary_for_ndim(len(axes))
    variance = local_variance(x, sf, scale, axes=axes, boundary=boundary)
    variance = variance * torch.tensor(sigma2, dtype=x.dtype)
    if bilateral_scaling:
        variance = variance * (scale + 1)
    return atrous_conv_nd(x, sf.kernel_nd(len(axes)), scale,
                          bilateral_variance=variance, boundary="symmetric")
