"""Merged decompose + whiten of a group of WOW scales (kernel A).

Counterpart of ``wavelets_tpu/ops/pallas_conv.py::_fused_wow_group``,
with its signature and return contract.  Per scale ``s = offset + k``:

1. chain smooth at dilation ``2^s``, symmetric reflection of the
   current smooth at the image border;
2. detail = carry − next;
3. power smooth of detail² at the same dilation, clamped ``≤0 → 1e-15``,
   then sqrt;
4. erf or hard significance mask, a threshold of 0 meaning no mask;
5. multiply by ``factor/lp``;
6. accumulate into ``acc``.

On a CUDA tensor each scale is one call of the hand-written kernel
``csrc/whiten_step.cu`` (four launches; see the source's note for its
design and bound); on a CPU tensor the plain PyTorch version below runs.
There is no fallback between the two: a CUDA tensor the kernel cannot
take raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build
from .conv import smooth
from .filters import ScalingFunction

__all__ = ["fused_wow_group", "fused_wow_group_plain", "whiten_scale_plain"]

KERNEL = "whiten_step"


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.wt_whiten_step_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int] + [ctypes.c_longlong] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def check_kernel_input(x: torch.Tensor, sf: ScalingFunction,
                       what: str) -> None:
    """Raise unless ``x`` is a contiguous float32 CUDA tensor and ``sf``
    has the symmetric taps the kernel folds pairwise."""
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: the CUDA kernel takes float32, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the CUDA kernel needs a contiguous tensor")
    if not sf.is_symmetric or sf.half_width > 8:
        raise ValueError(f"{what}: the CUDA kernel needs symmetric taps "
                         "of half width <= 8")


def launch_whiten_step(carry, c_next, detail, tmp, white, acc, acc_mode,
                       thr, fac, masked, soft, sf, scale) -> None:
    """One scale of kernel A on ``(B, H, W)`` float32 CUDA tensors; the
    launch counter is incremented here and nowhere else."""
    lib = _lib()
    B, H, W = carry.shape
    taps = (ctypes.c_double * len(sf.taps))(*sf.taps)
    code = lib.wt_whiten_step_f32(
        _ptr(carry), _ptr(c_next), _ptr(detail), _ptr(tmp), _ptr(white),
        _ptr(acc), int(acc_mode), _ptr(thr), float(fac), int(bool(masked)),
        int(bool(soft)), taps, len(sf.taps), B, H, W, 1 << scale,
        _build.stream_ptr(carry.device))
    _build.check(lib, code, "whiten_step")
    _build.LAUNCHES[KERNEL] += 1


def whiten_scale_plain(carry: torch.Tensor, thr: torch.Tensor, fac: float,
                       sf: ScalingFunction, scale: int, soft: bool,
                       masked: bool):
    """One WOW scale in plain PyTorch on the last two axes → ``(white,
    c_next)``.  ``thr`` broadcasts against ``carry`` (a scalar, or
    ``(B, 1, 1)`` per frame)."""
    c_next = smooth(carry, sf, scale=scale, axes=(-2, -1))
    c = carry - c_next
    lp = smooth(c * c, sf, scale=scale, axes=(-2, -1))
    lp = torch.sqrt(torch.where(lp <= 0, 1e-15, lp))
    if masked:
        safe_t = torch.where(thr == 0, torch.ones_like(thr), thr)
        if soft:
            mask = torch.erf(torch.abs(c / safe_t))
        else:
            mask = (torch.abs(c) > safe_t).to(c.dtype)
        c = c * torch.where(thr == 0, torch.ones_like(mask), mask)
    # a true division: ``fac / lp`` on a tensor multiplies by the
    # reciprocal, one rounding more than the kernel and the JAX package
    return c * torch.div(torch.tensor(fac, dtype=lp.dtype), lp), c_next


def _group_args(x, factors, thresholds, g, masked):
    if g < 1:
        raise ValueError("a group needs at least one scale")
    batched = x.ndim == 3
    xb = x if batched else x[None]
    B = xb.shape[0]
    factors = [float(f) for f in factors]
    masked = tuple(bool(m) for m in masked) or (False,) * g
    if len(factors) != g or len(masked) != g:
        raise ValueError("factors and masked need one entry per scale")
    thr = torch.as_tensor(thresholds, dtype=x.dtype, device=x.device)
    thr = thr.reshape(g, -1).expand(g, B)
    return batched, xb, factors, masked, thr


def fused_wow_group_plain(x: torch.Tensor, factors: Sequence[float],
                          thresholds, g: int, sf: ScalingFunction,
                          offset: int = 0, soft: bool = True,
                          masked: Tuple[bool, ...] = (),
                          need_cube: bool = True):
    """Plain PyTorch version of :func:`fused_wow_group` (any dtype or
    device)."""
    _build.PLAIN_CALLS[KERNEL] += 1
    batched, xb, factors, masked, thr = _group_args(
        x, factors, thresholds, g, masked)
    rows, acc, cur = [], None, xb
    for k in range(g):
        white, cur = whiten_scale_plain(
            cur, thr[k][:, None, None], factors[k], sf, offset + k, soft,
            masked[k])
        acc = white if acc is None else acc + white
        if need_cube:
            rows.append(white)
    if g == 1:
        acc = acc.clone()  # its own tensor, as the kernel's acc is
    rows.append(cur)
    if not batched:
        return tuple(r[0] for r in rows), acc[0]
    return tuple(rows), acc


def fused_wow_group(x: torch.Tensor, factors: Sequence[float], thresholds,
                    g: int, sf: ScalingFunction, offset: int = 0,
                    soft: bool = True, masked: Tuple[bool, ...] = (),
                    need_cube: bool = True):
    """Fused decompose+whiten of ``g`` scales at dilation base
    ``2^offset``: returns ``(rows, acc)`` where ``rows`` holds the ``g``
    whitened detail planes then the carry (the carry alone when
    ``need_cube=False``) and ``acc`` is Σ whitened.

    ``x`` is ``(H, W)`` or a frame stack ``(B, H, W)``; ``factors`` are
    ``g`` host floats (the per-scale weights); ``thresholds`` is a tensor
    of shape ``(g,)`` or ``(g, B)`` on ``x``'s device, used for the scales
    with ``masked[k]``.  A CPU ``x`` runs :func:`fused_wow_group_plain`;
    a CUDA ``x`` runs kernel A once per scale or raises."""
    if not x.is_cuda:
        return fused_wow_group_plain(x, factors, thresholds, g, sf, offset,
                                     soft, masked, need_cube)
    check_kernel_input(x, sf, "fused_wow_group")
    batched, xb, factors, masked, thr = _group_args(
        x, factors, thresholds, g, masked)
    thr = thr.contiguous()
    detail = torch.empty_like(xb)
    tmp = torch.empty_like(xb)
    acc = torch.empty_like(xb)
    rows, cur = [], xb
    for k in range(g):
        white = torch.empty_like(xb) if need_cube else None
        c_next = torch.empty_like(xb)
        launch_whiten_step(cur, c_next, detail, tmp, white, acc,
                           1 if k == 0 else 2, thr[k], factors[k],
                           masked[k], soft, sf, offset + k)
        if need_cube:
            rows.append(white)
        cur = c_next
    rows.append(cur)
    if not batched:
        return tuple(r[0] for r in rows), acc[0]
    return tuple(rows), acc
