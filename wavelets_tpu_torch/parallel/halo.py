"""Scale-dependent halo exchange for dilated stencils across ranks.

Counterpart of ``wavelets_tpu/parallel/halo.py``: the à trous kernel at
scale ``s`` reaches ``hw·2^s`` pixels, so a block needs that many
boundary rows or columns from each neighbour before the stencil.  JAX's
``lax.ppermute`` to a ring neighbour is one batch of point-to-point
sends and receives between the global ranks of the axis group; the
first and last block substitute the image border's reflection and post
nothing across it.  The taps fold in the order of
:func:`~wavelets_tpu_torch.ops.conv.separable_smooth_axis`, so a sharded
smooth is bitwise the single-device one.

Deep scales whose reach exceeds the local extent fall back to a tiled
all-gather of the (heavily smoothed) plane along that axis.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..ops.conv import separable_smooth_axis
from .mesh import all_gather_axis, exchange

__all__ = ["halo_smooth_axis", "halo_exchange_axis"]


def _reflect_halos(x: torch.Tensor, h: int, axis: int, boundary: str):
    """The image border's halos of a block, ``h`` wide: ``symmetric``
    duplicates the edge (cv2 BORDER_REFLECT), ``reflect`` is the
    whole-sample reflection (reflect-101)."""
    n = x.shape[axis]
    if boundary == "symmetric":
        left = x.narrow(axis, 0, h).flip(axis)
        right = x.narrow(axis, n - h, h).flip(axis)
    elif boundary == "reflect":
        left = x.narrow(axis, 1, h).flip(axis)
        right = x.narrow(axis, n - h - 1, h).flip(axis)
    else:
        raise ValueError(f"unsupported boundary {boundary!r}")
    return left, right


def halo_exchange_axis(x: torch.Tensor, h: int, axis: int, group,
                       boundary: str = "symmetric") -> torch.Tensor:
    """Extend the local block by ``h`` rows or columns on each side along
    ``axis``: interior halos from the neighbours of this rank in
    ``group`` (the axis's ranks, in block order), the first and last
    block's from the border reflection.  Requires ``h ≤`` the local
    extent (single-neighbour reach)."""
    n = x.shape[axis]
    if h > n:
        raise ValueError(f"halo {h} exceeds local extent {n}")
    n_shards = dist.get_world_size(group)
    idx = dist.get_rank(group)
    left, right = _reflect_halos(x, h, axis, boundary)
    sends, recvs = [], []
    if idx > 0:
        left = torch.empty_like(left)
        sends.append((x.narrow(axis, 0, h), idx - 1))
        recvs.append((left, idx - 1))
    if idx < n_shards - 1:
        right = torch.empty_like(right)
        sends.append((x.narrow(axis, n - h, h), idx + 1))
        recvs.append((right, idx + 1))
    if n_shards > 1:
        exchange(sends, recvs, group)
    return torch.cat([left, x, right], dim=axis)


def halo_smooth_axis(x: torch.Tensor, taps: Tuple[float, ...], scale: int,
                     axis: int, group,
                     boundary: str = "symmetric") -> torch.Tensor:
    """1-D dilated convolution along an axis split over ``group``, per
    element the arithmetic of the single-device
    :func:`~wavelets_tpu_torch.ops.conv.separable_smooth_axis`."""
    n_shards = dist.get_world_size(group)
    if n_shards == 1:
        return separable_smooth_axis(x, taps, scale, axis, boundary)
    k = len(taps)
    hw = (k - 1) // 2
    if hw == 0:
        return x * taps[0]
    axis = axis % x.ndim
    d = 2 ** scale
    h = hw * d
    n = x.shape[axis]

    if h > n:
        # deep-scale fallback: the reach exceeds the block, so gather the
        # whole axis, smooth it and take this block back
        full = all_gather_axis(x, axis, group)
        out = separable_smooth_axis(full, taps, scale, axis, boundary)
        return out.narrow(axis, dist.get_rank(group) * n, n)

    ext = halo_exchange_axis(x, h, axis, group, boundary)

    def shifted(offset):
        return ext.narrow(axis, h + offset, n)

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
