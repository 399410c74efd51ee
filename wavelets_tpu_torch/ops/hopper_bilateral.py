"""The bilateral decompose group (kernel F).

Counterpart of ``wavelets_tpu/ops/pallas_bilateral.py``: ``_fused_group``
is :func:`fused_bilateral_group` (kernel F, ``csrc/bilateral_group.cu``)
and ``fused_bilateral_pieces`` keeps its name and ``(pieces, layout,
tail)`` contract.  Per scale ``s = offset + k`` of a group:

1. the local variance of the carry under the scale window (two separable
   smooths, of ``x`` and ``x²``), clamped ``≤0 → 1e-20``;
2. the range variance: that times ``σ_b[s]²``, times ``s+1`` under
   bilateral scaling, one rounding each;
3. the ``(k²−1)``-tap range-weighted smooth with its normalizer, the taps
   ``2^s`` apart through the symmetric index map, in the reference's
   order;
4. the detail ``carry − c_next``; ``c_next`` chains to the next scale.

This is the JAX package's XLA order (``ops/conv.py::local_variance``,
``atrous_conv_nd``; the TPU kernel regroups ``(0.5/σ²)/vari``), which the
plain version :func:`~.conv.bilateral_smooth` follows too.  On the card
each scale is one launch of the ring kernel (``csrc/wt_ring.cuh``) that
:func:`bilateral_plan` sizes.  Groups are of :data:`~.hopper_conv.N_FAST`
scales; the kernel takes any dilation, so the split groups launches and
changes no number: there is no tile planner and no plain tail.  A CPU
tensor runs the plain version; a CUDA tensor runs kernel F or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from .. import tracing
from . import _build
from .conv import bilateral_smooth
from .filters import ScalingFunction
from .hopper_conv import (SMEM_OPTIN, SMEM_TWO_PER_SM, _ptr,
                          check_kernel_input, group_pieces, map_step)
from .layout import stack_planes

__all__ = ["fused_bilateral_group", "fused_bilateral_group_plain",
           "fused_bilateral_pieces", "kernel_weights", "MAX_HW",
           "BilateralPlan", "bilateral_plan", "ring_span", "ring_smem",
           "map_step"]

KERNEL = "bilateral_group"

#: largest half width the bilateral kernels take (WT_BIL_MAX_HW, a 9×9
#: dense kernel); the B3spline has 2, the triangle 1
MAX_HW = 4

#: output rows of a residue class a block walks on its ring, at most: the
#: ring's warm-up loads 2·hw more rows per chunk; fewer rows a chunk
#: where the frame would give fewer than :data:`RING_BLOCKS` blocks
RING_ROWS = 16
RING_MIN_ROWS = 4
#: blocks a launch should give the card: two to each of the H100's 132 SMs
RING_BLOCKS = 264
#: output columns of a block: whole rows up to the first, else segments
#: of the first of these that fits (two blocks to an SM where one does)
RING_SEGS = (4096, 2048, 1024, 512, 256)


def ring_span(hw: int, D: int, seg: int) -> int:
    """Floats of one ring row of kernel F's block: ``seg`` output columns
    and the taps' reach, ``2·hw·min(D, seg)`` (``csrc/wt_ring.cuh``'s
    segment layout: a contiguous ``hw·D`` halo where ``D < seg``, else the
    ``2hw+1`` windows of the taps side by side)."""
    return 2 * hw * min(D, seg) + seg


def ring_smem(hw: int, D: int, seg: int) -> int:
    """Shared bytes of kernel F's block: ``2hw+1`` ring slots, each the
    span with room to start it up to 3 floats in (so that in-frame
    columns copy 16 bytes at a time), rounded to 16 bytes, then the
    ``tm`` and ``tq`` rows."""
    span = ring_span(hw, D, seg)
    return 4 * ((2 * hw + 1) * (-(-(span + 3) // 4) * 4) + 2 * span)


@dataclass(frozen=True)
class BilateralPlan:
    """Kernel F's launch for one scale, passed to
    ``csrc/bilateral_group.cu`` as it stands (the C entry checks it and
    launches it): ``rows`` output rows of a residue class per block,
    segments of ``seg`` columns, ``smem_bytes`` of shared memory (the
    ``2hw+1`` ring rows and the ``tm``, ``tq`` rows), ``grid = (classes ×
    chunks, segments, frames)``, 32- or 64-bit offsets."""
    rows: int
    seg: int
    smem_bytes: int
    grid: Tuple[int, int, int]
    index_bits: int


def bilateral_plan(B: int, H: int, W: int, D: int, hw: int) -> BilateralPlan:
    """Kernel F's launch at dilation ``D`` on a ``(B, H, W)`` stack with
    taps of half width ``hw``: whole rows where they fit, else the widest
    segment of :data:`RING_SEGS`, two blocks to an SM where any fits so;
    raises where not even the narrowest segment fits the shared memory,
    or where the taps' reach (:func:`map_step`) passes 32-bit index
    math."""
    if not 1 <= hw <= MAX_HW:
        raise ValueError(f"bilateral_plan: half width {hw} not in "
                         f"1..{MAX_HW}")
    if not 1 <= D < 2 ** 63:
        raise ValueError(f"bilateral_plan: dilation {D} not in 1..2^62")
    segs = ([W] if W <= RING_SEGS[0] else []) + [s for s in RING_SEGS
                                                  if s < W]
    for limit in (SMEM_TWO_PER_SM, SMEM_OPTIN):
        for seg in segs:
            smem = ring_smem(hw, D, seg)
            if smem <= limit:
                if max(H + (hw + 1) * map_step(D, H),
                       W + seg + hw * map_step(D, W)) >= 2 ** 31:
                    raise ValueError(
                        f"bilateral_plan: the taps of a {H}x{W} frame at "
                        f"dilation {D} reach past 32-bit index math "
                        "(2^31)")
                n_cls, P = min(D, H), -(-H // D)
                n_segs = -(-W // seg)
                rows = min(RING_ROWS, P, max(
                    RING_MIN_ROWS, -(-n_cls * P * n_segs * B // RING_BLOCKS)))
                grid = (n_cls * -(-P // rows), n_segs, B)
                return BilateralPlan(rows, seg, smem, grid,
                                     32 if B * H * W < 2 ** 31 else 64)
    raise ValueError(f"bilateral_plan: the ring of a {segs[-1]}-column "
                     f"segment at dilation {D} does not fit the shared "
                     "memory")


def _check_input(x: torch.Tensor, sf: ScalingFunction) -> None:
    """Raise unless kernel F takes ``x`` and ``sf``: a contiguous float32
    CUDA tensor and symmetric taps of half width ≤ :data:`MAX_HW`."""
    check_kernel_input(x, sf, "fused_bilateral_group")
    if not 1 <= sf.half_width <= MAX_HW:
        raise ValueError(f"fused_bilateral_group: the bilateral kernels take "
                         f"half widths 1..{MAX_HW}, got {sf.half_width}")


def kernel_weights(sf: ScalingFunction):
    """The dense 2-D tap weights as a ctypes double array, row-major: the
    float64 outer product the plain version reads (``sf.kernel_nd(2)``),
    rounded to float32 in the kernel."""
    k = sf.kernel_nd(2).ravel()
    return (ctypes.c_double * k.size)(*k.tolist())


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.wt_bilateral_group_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check_group(level, variances):
    if level < 1:
        raise ValueError("a bilateral group needs at least one scale")
    if len(variances) != level:
        raise ValueError("variances needs one entry per scale")


def fused_bilateral_group_plain(x: torch.Tensor, level: int,
                                sf: ScalingFunction,
                                variances: Sequence[float], offset: int = 0,
                                bilateral_scaling: bool = False
                                ) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_bilateral_group` (any dtype
    or device)."""
    with tracing.plain(KERNEL, offset):
        _check_group(level, variances)
        rows, cur = [], x
        for k in range(level):
            c_next = bilateral_smooth(cur, sf, offset + k, float(variances[k]),
                                      bilateral_scaling, axes=(-2, -1),
                                      boundary="symmetric")
            rows.append(cur - c_next)
            cur = c_next
        rows.append(cur)
        return stack_planes(rows)


def fused_bilateral_group(x: torch.Tensor, level: int, sf: ScalingFunction,
                          variances: Sequence[float], offset: int = 0,
                          bilateral_scaling: bool = False) -> torch.Tensor:
    """Bilateral decomposition of ``level`` scales at dilation base
    ``2^offset`` on the last two axes → ``(level+1, *x.shape)``: the
    detail planes of scales ``offset .. offset+level−1``, then the carry.

    ``variances[k] = σ_b[offset+k]²``; with ``bilateral_scaling`` the
    range variance is further multiplied by ``offset+k+1`` (the TPU
    kernel takes the product of the two as one static factor; the port
    keeps the XLA chain's two roundings).  ``x`` is ``(H, W)`` or a frame
    stack ``(B, H, W)``.  A CPU ``x`` runs
    :func:`fused_bilateral_group_plain`; a CUDA ``x`` runs kernel F
    (``csrc/bilateral_group.cu``, one launch per scale as
    :func:`bilateral_plan` says) or raises."""
    if not x.is_cuda:
        return fused_bilateral_group_plain(x, level, sf, variances, offset,
                                           bilateral_scaling)
    _check_input(x, sf)
    _check_group(level, variances)
    if x.ndim not in (2, 3):
        raise ValueError("fused_bilateral_group takes (H, W) or (B, H, W)")
    out = torch.empty((level + 1,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    B = x.shape[0] if x.ndim == 3 else 1
    H, W = x.shape[-2:]
    sig2 = (ctypes.c_float * level)(*[float(v) for v in variances])
    scl = (ctypes.c_float * level)(*[
        float(offset + k + 1) if bilateral_scaling else 1.0
        for k in range(level)])
    taps = (ctypes.c_double * len(sf.taps))(*sf.taps)
    plans = [bilateral_plan(B, H, W, 1 << (offset + k), sf.half_width)
             for k in range(level)]

    def per_scale(field):
        return (ctypes.c_longlong * level)(*[field(p) for p in plans])

    with tracing.launch(KERNEL, offset):
        # scratch held by name until the launch is queued: a tensor made
        # inline for _ptr() is freed at once and its block handed to the
        # next
        spare = torch.empty_like(x)
        lib = _lib()
        code = lib.wt_bilateral_group_f32(
            _ptr(x), _ptr(out), _ptr(spare), int(level), int(offset), sig2,
            scl, taps, len(sf.taps), kernel_weights(sf), B, H, W,
            per_scale(lambda p: p.rows), per_scale(lambda p: p.seg),
            per_scale(lambda p: p.grid[0]), per_scale(lambda p: p.grid[1]),
            per_scale(lambda p: p.smem_bytes), plans[0].index_bits,
            _build.stream_ptr(x.device))
        _build.check(lib, code, "bilateral_group")
    return out


def fused_bilateral_pieces(
    x: torch.Tensor,
    level: int,
    sf: ScalingFunction,
    bilateral: Tuple[float, ...],
    bilateral_scaling: bool = False,
    *,
    defer_tail: bool = False,
):
    """Bilateral decomposition as ``(pieces, layout, tail)``, the
    bilateral counterpart of ``hopper_conv.fused_decompose_pieces``:
    groups of ``N_FAST`` scales on kernel F's wrapper; with
    ``defer_tail`` the first group only and ``tail = (carry, level −
    N_FAST)`` (None when every scale was computed).  ``bilateral[s]`` is
    the per-scale σ_b, already normalized to ``level+1`` entries
    (``core.transform.normalize_bilateral``)."""
    def run_group(cur, g, offset):
        return fused_bilateral_group(
            cur, g, sf, tuple(float(bilateral[offset + k]) ** 2
                              for k in range(g)),
            offset, bilateral_scaling)

    return group_pieces(x, level, run_group, defer_tail)
