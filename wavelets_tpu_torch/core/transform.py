"""The à trous transform: standard decomposition and synthesis.

Counterpart of ``wavelets_tpu/core/transform.py`` for the standard
(non-bilateral) algorithm (watroo/wavelets.py:408-444): chained
smoothing with dilation ``2^s``; plane ``s`` is ``smooth_s −
smooth_{s+1}`` and plane ``level`` the residual, so synthesis is a plain
sum and exact by construction.

Dispatch is by a documented rule, not a fallback: a float32 2-D frame or
``(B, H, W)`` stack (spatial axes the last two) goes through kernel C's
wrapper (``ops/hopper_conv.fused_decompose``), a float32 3-D volume
through the volume path (``fused_volume_decompose``: plain axial pass,
kernel C in-plane); float64, 1-D and ``fuse=False`` run the plain chain,
as the JAX package sends them to XLA (``fuse=False`` is its
``use_pallas=False``).  Each wrapper runs its kernel on a CUDA tensor and
its plain version on a CPU tensor; all routes give the same bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops import hopper_conv
from ..ops.conv import boundary_for_ndim, smooth
from ..ops.filters import ScalingFunction
from ..ops.layout import stack_planes

__all__ = ["decompose", "decompose_pieces", "assemble_pieces", "synthesize",
           "normalize_bilateral"]


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


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to wavelets_tpu_torch yet "
        f"(ROADMAP.md queue A: {item})")


def _axes_and_boundary(x, axes, boundary):
    if axes is None:
        axes = tuple(range(x.ndim))
    axes = tuple(a % x.ndim for a in axes)
    if boundary is None:
        boundary = boundary_for_ndim(len(axes))
    return axes, boundary


def _check_options(bilateral, recursive_borders):
    if bilateral is not None:
        raise _not_ported("the bilateral transform", "bilateral")
    if recursive_borders:
        raise _not_ported("recursive_borders=True", "transform options")


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
    axes are a batch.  ``scale_offset`` starts the dilation ladder at
    ``2^offset``.  ``fuse=False`` runs the plain chain.  ``bilateral``
    and ``recursive_borders`` raise ``NotImplementedError``."""
    _check_options(bilateral, recursive_borders)
    axes, boundary = _axes_and_boundary(x, axes, boundary)
    if fuse and scale_offset == 0:
        if _can_fuse(x, level, axes, boundary):
            return hopper_conv.fused_decompose(x, level, sf)
        if _can_fuse_volume(x, level, axes, boundary):
            return hopper_conv.fused_volume_decompose(x, level, sf)
    planes = []
    c = x
    for s in range(level):
        c_next = smooth(c, sf, s + scale_offset, axes=axes, boundary=boundary)
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
    ``level + 1`` entries)."""
    _check_options(bilateral, recursive_borders=False)
    axes, boundary = _axes_and_boundary(x, axes, boundary)
    if fuse and _can_fuse(x, level, axes, boundary):
        pieces, layout, tail = hopper_conv.fused_decompose_pieces(
            x, level, sf, defer_tail=defer_tail)
        n_done = level + 1 - (tail[1] + 1 if tail is not None else 0)
        layout = tuple(layout[s] for s in range(n_done))
        if defer_tail:
            return tuple(pieces), layout, tail
        return tuple(pieces), layout
    planes = decompose(x, level, sf, axes=axes, boundary=boundary, fuse=fuse)
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
