"""Whitening of materialized detail planes (kernel D).

Counterpart of ``wavelets_tpu/ops/pallas_wow.py::fused_whiten_pieces``,
with its signature and return contract: the detail planes of scales
``0 .. n_fast−1`` are read straight from the decompose pieces
(``layout[s] = (piece, row)``), and per scale

1. power smooth of ``c²`` at dilation ``2^s``, clamped ``≤0 → 1e-15``,
   then sqrt;
2. erf or hard significance mask, a threshold of 0 meaning no mask;
3. ``white = wc·(factor/lp)`` with a runtime factor table ``(n,)`` or
   ``(n, B)`` on the device (``preserve_variance`` folds its per-scale
   power norm in there);
4. the partial reconstruction Σ white and, with ``write_gamma``, the sum
   of the masked, unwhitened planes (the gamma-blend input).

On a CUDA tensor each scale is one call of the hand-written kernel
``csrc/whiten_plane.cu`` (two launches; see the source's note for its
design and bound), which ``hopper_deep.deep_whiten_plane`` drives for one
deep plane too; on a CPU tensor the plain PyTorch version below runs.  A
CUDA tensor the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build
from .filters import ScalingFunction
from .hopper_conv import _ptr, check_kernel_input, whiten_detail_plain

__all__ = ["fused_whiten_pieces", "fused_whiten_pieces_plain",
           "launch_whiten_plane"]

KERNEL = "whiten_plane"


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.wt_whiten_plane_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def launch_whiten_plane(plane, white, recon, recon_mode, gamma, gamma_mode,
                        fac, thr, soft, sf, scale) -> None:
    """One scale of kernel D on ``(B, H, W)`` float32 CUDA tensors;
    ``fac`` and ``thr`` (or None: no mask) are ``(B,)`` float32 device
    tensors.  The launch counter is incremented here and nowhere else."""
    lib = _lib()
    B, H, W = plane.shape
    taps = (ctypes.c_double * len(sf.taps))(*sf.taps)
    code = lib.wt_whiten_plane_f32(
        _ptr(plane), _ptr(torch.empty_like(plane)), _ptr(white), _ptr(recon),
        int(recon_mode), _ptr(gamma), int(gamma_mode), _ptr(fac), _ptr(thr),
        int(bool(soft)), taps, len(sf.taps), B, H, W, 1 << scale,
        _build.stream_ptr(plane.device))
    _build.check(lib, code, "whiten_plane")
    _build.LAUNCHES[KERNEL] += 1


def _table(values, n: int, B: int, like: torch.Tensor) -> torch.Tensor:
    """``(n,)`` or ``(n, B)`` → a contiguous ``(n, B)`` table of
    ``like``'s dtype on its device."""
    t = torch.as_tensor(values, dtype=like.dtype, device=like.device)
    return t.reshape(n, -1).expand(n, B).contiguous()


def _check_args(pieces, n_fast, layout, batch_major, out_rows_total):
    if batch_major or out_rows_total:
        raise NotImplementedError(
            "batch-major planes (wow_stack) are not ported to "
            "wavelets_tpu_torch yet (ROADMAP.md queue A: volumes and "
            "wow_stack)")
    if n_fast < 1 or len(layout) < n_fast:
        raise ValueError("fused_whiten_pieces needs a layout entry for each "
                         "of its n_fast >= 1 scales")
    if any(p.ndim != 4 for p in pieces):
        raise ValueError("pieces are (rows, B, H, W) cubes")


def fused_whiten_pieces_plain(
    pieces, factors, thresholds, sf: ScalingFunction, n_fast: int,
    layout: Sequence[Tuple[int, int]], soft: bool = True,
    write_planes: bool = True, batch_major: bool = False,
    out_rows_total: int = 0, write_gamma: bool = False,
):
    """Plain PyTorch version of :func:`fused_whiten_pieces` (any dtype or
    device)."""
    _build.PLAIN_CALLS[KERNEL] += 1
    _check_args(pieces, n_fast, layout, batch_major, out_rows_total)
    B = pieces[0].shape[1]
    fac = _table(factors, n_fast, B, pieces[0])
    thr = _table(thresholds, n_fast, B, pieces[0])
    whites, recon, gamma = [], None, None
    for s in range(n_fast):
        k, r = layout[s]
        white, wc = whiten_detail_plain(
            pieces[k][r], fac[s][:, None, None], thr[s][:, None, None], sf, s,
            soft)
        # the kernel's order: set at the first scale, add the later ones
        recon = white.clone() if recon is None else recon + white
        if write_gamma:
            gamma = wc.clone() if gamma is None else gamma + wc
        if write_planes:
            whites.append(white)
    planes = torch.stack(whites) if write_planes else None
    if write_gamma:
        return planes, recon, gamma
    return planes, recon


def fused_whiten_pieces(
    pieces, factors, thresholds, sf: ScalingFunction, n_fast: int,
    layout: Sequence[Tuple[int, int]], soft: bool = True,
    write_planes: bool = True, batch_major: bool = False,
    out_rows_total: int = 0, write_gamma: bool = False,
):
    """Whiten detail scales ``0 .. n_fast−1`` read from decompose pieces.

    ``pieces``: tuple of plane cubes, each ``(rows, B, H, W)``;
    ``layout[s] = (piece, row)`` locates scale ``s``.  ``factors``: the
    multiplier table (``w_s · power_norm_s``), ``(n_fast,)`` or
    ``(n_fast, B)``, host values or a device tensor; ``thresholds``:
    ``(n_fast,)`` or ``(n_fast, B)`` on the device (0 → no mask).

    Returns ``(whitened (n_fast, B, H, W) or None, partial_recon
    (B, H, W))``, plus the gamma sum ``(B, H, W)`` of the masked,
    unwhitened planes with ``write_gamma``.  ``batch_major`` and
    ``out_rows_total`` (the frame-stack layouts) raise
    ``NotImplementedError``.  CPU pieces run
    :func:`fused_whiten_pieces_plain`; CUDA pieces run kernel D once per
    scale or raise."""
    if not pieces[0].is_cuda:
        return fused_whiten_pieces_plain(
            pieces, factors, thresholds, sf, n_fast, layout, soft,
            write_planes, batch_major, out_rows_total, write_gamma)
    _check_args(pieces, n_fast, layout, batch_major, out_rows_total)
    for p in pieces:
        check_kernel_input(p, sf, "fused_whiten_pieces")
    _, B, H, W = pieces[0].shape
    dev = pieces[0].device
    fac = _table(factors, n_fast, B, pieces[0])
    thr = _table(thresholds, n_fast, B, pieces[0])
    planes = (torch.empty((n_fast, B, H, W), dtype=torch.float32, device=dev)
              if write_planes else None)
    recon = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    gamma = torch.empty_like(recon) if write_gamma else None
    for s in range(n_fast):
        k, r = layout[s]
        mode = 1 if s == 0 else 2
        launch_whiten_plane(pieces[k][r], planes[s] if write_planes else None,
                            recon, mode, gamma, mode if write_gamma else 0,
                            fac[s], thr[s], soft, sf, s)
    if write_gamma:
        return planes, recon, gamma
    return planes, recon
