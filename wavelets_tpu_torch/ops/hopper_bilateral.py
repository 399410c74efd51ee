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
plain version :func:`~.conv.bilateral_smooth` follows too.  Groups are of
:data:`~.hopper_conv.N_FAST` scales; the kernel takes any dilation, so the
split groups launches and changes no number: there is no tile planner
and no plain tail.  A CPU tensor runs the plain version; a CUDA tensor
runs kernel F or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build
from .conv import bilateral_smooth
from .filters import ScalingFunction
from .hopper_conv import _ptr, check_kernel_input, group_pieces
from .layout import stack_planes

__all__ = ["fused_bilateral_group", "fused_bilateral_group_plain",
           "fused_bilateral_pieces", "kernel_weights", "MAX_HW"]

KERNEL = "bilateral_group"

#: largest half width the bilateral kernels take (WT_BIL_MAX_HW, a 9×9
#: dense kernel); the B3spline has 2, the triangle 1
MAX_HW = 4


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
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
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
    _build.PLAIN_CALLS[KERNEL] += 1
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
    (``csrc/bilateral_group.cu``) or raises."""
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
    # scratch held by name until the launch is queued: a tensor made
    # inline for _ptr() is freed at once and its block handed to the next
    tm, tq, spare = torch.empty((3,) + tuple(x.shape), dtype=x.dtype,
                                device=x.device)
    lib = _lib()
    code = lib.wt_bilateral_group_f32(
        _ptr(x), _ptr(out), _ptr(tm), _ptr(tq), _ptr(spare), int(level),
        int(offset), sig2, scl, taps, len(sf.taps), kernel_weights(sf), B, H,
        W, _build.stream_ptr(x.device))
    _build.check(lib, code, "bilateral_group")
    _build.LAUNCHES[KERNEL] += 1
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
