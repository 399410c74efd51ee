"""The à trous transform: decomposition and synthesis, standard and
bilateral.

Counterpart of ``wavelets_tpu/core/transform.py`` (watroo/wavelets.py:
408-444): chained smoothing with dilation ``2^s``; plane ``s`` is
``smooth_s − smooth_{s+1}`` and plane ``level`` the residual, so
synthesis is a plain sum and exact by construction.  With ``bilateral``
(per-scale σ_b, normalized to ``level+1`` entries) each smooth is the
bilateral one (``ops/conv.py::bilateral_smooth``, the JAX ``_smooth_step``).

Dispatch is by a documented rule, not a fallback: a float32 2-D frame or
``(B, H, W)`` stack (spatial axes the last two) goes through kernel C's
wrapper (``ops/hopper_conv.fused_decompose``), or kernel F's
(``ops/hopper_bilateral.fused_bilateral_pieces``) when bilateral; a
float32 3-D volume through the volume path (``fused_volume_decompose``:
plain axial pass, kernel C in-plane).  Float64, 1-D, ``fuse=False`` and
bilateral 3-D volumes run the plain chain, as the JAX package runs them
in XLA (no Pallas kernel takes them; ``fuse=False`` is its
``use_pallas=False``).  Each wrapper runs its kernel on a CUDA tensor and
its plain version on a CPU tensor.

``recursive_borders=True`` gives the reference's recursive algorithm's
output (watroo/wavelets.py:330-406): the input padded once, numpy
``symmetric``, by ``half_width·2^(level−1)`` on the transform axes, the
standard decomposition of the padded input (kernel C or F like any
frame), then cropped.  The decimated recursion itself is a CPU cache
device with no counterpart here, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops import hopper_bilateral, hopper_conv
from ..ops.conv import (bilateral_smooth, boundary_for_ndim, boundary_index,
                        smooth)
from ..ops.filters import ScalingFunction
from ..ops.layout import stack_planes

__all__ = ["decompose", "decompose_pieces", "assemble_pieces", "synthesize",
           "normalize_bilateral", "pad_symmetric"]


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


def _axes_and_boundary(x, axes, boundary):
    if axes is None:
        axes = tuple(range(x.ndim))
    axes = tuple(a % x.ndim for a in axes)
    if boundary is None:
        boundary = boundary_for_ndim(len(axes))
    return axes, boundary


def pad_symmetric(x: torch.Tensor, pad: int, axes) -> torch.Tensor:
    """``np.pad(x, pad, mode="symmetric")`` on ``axes`` (any pad width,
    also wider than the extent: repeated reflection) by the boundary
    index map; ``F.pad(mode="reflect")`` is numpy's ``reflect``, not
    ``symmetric``."""
    for ax in axes:
        n = x.shape[ax]
        x = x.index_select(ax, boundary_index(n, -pad, "symmetric",
                                              x.device, n + 2 * pad))
    return x


def _smooth_step(c, s, sf, axes, boundary, bilateral, bilateral_scaling):
    """One scale of the chained smoothing (watroo/wavelets.py:429-440):
    the separable smooth, or the bilateral one with ``σ_b[s]``.  The
    local variance takes the dimension's ``boundary``; the range-weighted
    taps always the symmetric map, as the reference does."""
    if bilateral is None:
        return smooth(c, sf, s, axes=axes, boundary=boundary)
    return bilateral_smooth(c, sf, s, float(bilateral[s]) ** 2,
                            bilateral_scaling, axes=axes, boundary=boundary)


def _can_fuse(x, level, axes, boundary) -> bool:
    """Kernel C takes a float32 2-D frame or a ``(B, H, W)`` stack whose
    spatial axes are the last two, with the symmetric boundary."""
    return (level >= 1 and boundary == "symmetric"
            and x.dtype == torch.float32 and x.ndim in (2, 3)
            and axes == tuple(range(x.ndim - 2, x.ndim)))


def _can_fuse_volume(x, level, axes, boundary) -> bool:
    """The volume path takes a float32 ``(D, H, W)`` volume transformed
    over all three axes (not a frame stack)."""
    return (level >= 1 and boundary == "symmetric"
            and x.dtype == torch.float32 and x.ndim == 3
            and axes == (0, 1, 2))


def decompose(
    x: torch.Tensor,
    level: int,
    sf: ScalingFunction,
    *,
    axes: Optional[Tuple[int, ...]] = None,
    bilateral: Optional[Tuple[float, ...]] = None,
    bilateral_scaling: bool = False,
    recursive_borders: bool = False,
    boundary: Optional[str] = None,
    scale_offset: int = 0,
    fuse: bool = True,
) -> torch.Tensor:
    """À trous decomposition → coefficient cube ``(level+1, *x.shape)``.

    ``axes`` selects the spatial axes (default: all); leading non-spatial
    axes are a batch.  ``bilateral`` is the per-scale σ_b, already
    normalized to ``level+1`` entries (:func:`normalize_bilateral`).
    ``scale_offset`` starts the dilation ladder at ``2^offset``.
    ``fuse=False`` runs the plain chain.  ``recursive_borders=True`` pads
    by ``half_width·2^(level−1)`` (numpy ``symmetric``), decomposes and
    crops (the reference's recursive algorithm's borders, watroo/
    wavelets.py:394-395); the interior equals the standard path's."""
    axes, boundary = _axes_and_boundary(x, axes, boundary)
    if recursive_borders:
        if scale_offset:
            raise ValueError("recursive_borders takes no scale_offset")
        hw = sf.half_width * 2 ** (level - 1) if level > 0 else 0
        planes = decompose(pad_symmetric(x, hw, axes), level, sf, axes=axes,
                           bilateral=bilateral,
                           bilateral_scaling=bilateral_scaling,
                           boundary=boundary, fuse=fuse)
        crop = tuple(slice(hw, x.shape[a] + hw) if a in axes
                     else slice(None) for a in range(x.ndim))
        return planes[(slice(None),) + crop].contiguous()
    if fuse and scale_offset == 0:
        if _can_fuse(x, level, axes, boundary):
            if bilateral is not None:
                pieces, layout, _ = hopper_bilateral.fused_bilateral_pieces(
                    x, level, sf, bilateral, bilateral_scaling)
                return assemble_pieces(pieces, [layout[s]
                                                for s in range(level + 1)])
            return hopper_conv.fused_decompose(x, level, sf)
        if bilateral is None and _can_fuse_volume(x, level, axes, boundary):
            return hopper_conv.fused_volume_decompose(x, level, sf)
    planes = []
    c = x
    for s in range(level):
        c_next = _smooth_step(c, s + scale_offset, sf, axes, boundary,
                              bilateral, bilateral_scaling)
        planes.append(c - c_next)
        c = c_next
    planes.append(c)
    return stack_planes(planes)


def decompose_pieces(
    x: torch.Tensor,
    level: int,
    sf: ScalingFunction,
    *,
    axes: Optional[Tuple[int, ...]] = None,
    bilateral: Optional[Tuple[float, ...]] = None,
    bilateral_scaling: bool = False,
    boundary: Optional[str] = None,
    fuse: bool = True,
    defer_tail: bool = False,
):
    """Decomposition as ``(pieces, layout)``, the kernels' native form
    with no plane-cube concatenation: ``pieces`` is a tuple of cubes and
    ``layout[s] = (piece, row)`` locates the detail plane of scale ``s``
    (``layout[level]`` the residual).

    With ``defer_tail=True`` the return is ``(pieces, layout, tail)``: on
    kernel C's route the scales past the first group are left uncomputed
    and ``tail = (carry, n_tail)`` hands the smooth carry to the consumer
    (None when every scale was computed; ``layout`` then covers
    ``level + 1`` entries).  A bilateral decomposition takes kernel F's
    route (``fused_bilateral_pieces``), a standard one kernel C's."""
    axes, boundary = _axes_and_boundary(x, axes, boundary)
    if fuse and _can_fuse(x, level, axes, boundary):
        if bilateral is not None:
            pieces, layout, tail = hopper_bilateral.fused_bilateral_pieces(
                x, level, sf, bilateral, bilateral_scaling,
                defer_tail=defer_tail)
        else:
            pieces, layout, tail = hopper_conv.fused_decompose_pieces(
                x, level, sf, defer_tail=defer_tail)
        n_done = level + 1 - (tail[1] + 1 if tail is not None else 0)
        layout = tuple(layout[s] for s in range(n_done))
        if defer_tail:
            return tuple(pieces), layout, tail
        return tuple(pieces), layout
    planes = decompose(x, level, sf, axes=axes, bilateral=bilateral,
                       bilateral_scaling=bilateral_scaling,
                       boundary=boundary, fuse=fuse)
    layout = tuple((0, s) for s in range(level + 1))
    if defer_tail:
        return (planes,), layout, None
    return (planes,), layout


def assemble_pieces(pieces, layout) -> torch.Tensor:
    """Plane cube from ``(pieces, layout)``; free when the decomposition
    produced a single cube in scale order."""
    if len(pieces) == 1 and tuple(layout) == tuple(
            (0, s) for s in range(len(layout))):
        return pieces[0]
    return stack_planes([pieces[k][r] for (k, r) in layout])


def synthesize(planes: torch.Tensor) -> torch.Tensor:
    """Inverse transform: the sum of the planes (watroo/utils.py:98)."""
    return torch.sum(planes, dim=0)
