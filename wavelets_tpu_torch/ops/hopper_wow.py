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

The whites come out scale-major ``(n, B, H, W)``, or with
``batch_major`` into rows ``0 .. n−1`` of a frame stack's ``(B, R, H,
W)`` plane cube, in place.

On CUDA pieces the ``n_fast`` scales are one launch of the hand-written
kernel ``csrc/whiten_plane.cu`` (its pieces form, sized by
:func:`pieces_plan`; see the source's note for its design and bound);
:func:`launch_whiten_plane` is the same kernel's deep-plane form, one
row-buffer launch sized by :func:`~.hopper_conv.step_plan`, which
``hopper_deep.deep_whiten_plane`` drives.  On a CPU tensor the plain
PyTorch version below runs.  A CUDA tensor the kernel cannot take
raises.  :func:`fused_whiten_pieces_ref` runs the first-port design
(two per-pixel launches a scale through a scratch plane), a check-only
reference on the card that no path calls.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .. import tracing
from . import _build
from .filters import ScalingFunction
from .hopper_conv import (MAX_FRAMES, STEP_SEGS, N_FAST, StepPlan, _ptr,
                          check_kernel_input, map_step, step_plan,
                          whiten_detail_plain)

__all__ = ["fused_whiten_pieces", "fused_whiten_pieces_plain",
           "fused_whiten_pieces_ref", "pieces_plan", "pieces_smem",
           "launch_whiten_plane", "launch_whiten_plane_ref"]

KERNEL = "whiten_plane"
#: the span of kernel D's pieces form, which counts under :data:`KERNEL`
PIECES = "whiten_pieces"
#: the launch counter of kernel D's check-only reference entry
REF = "whiten_plane_ref"
#: the pieces kernel's static shared bytes (its tap-row table, 3 × 17
#: offsets of 8 bytes, as ptxas lays it out)
PIECES_STATIC_SMEM = 416
#: dynamic shared bytes a block of the pieces form may take so that four
#: blocks of 512 threads, a full SM, share its 228 KB (233472 bytes, 1 KB
#: of it reserved per block) beside the static table: whole rows held
#: two blocks to an SM and took 15% more device time than 2048-column
#: segments at 4096² (scripts/kernel_variants.py, PERF.md)
PIECES_SMEM = 233472 // 4 - 1024 - PIECES_STATIC_SMEM


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.wt_whiten_plane_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int,
                   ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.wt_whiten_pieces_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int,
                   ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ref = lib.wt_whiten_plane_ref_f32
    ref.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int] + [ctypes.c_void_p] * 2
                    + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                    + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
    ref.restype = ctypes.c_int
    return lib


def pieces_smem(n: int, hw: int, W: int, seg: int) -> int:
    """Shared bytes of a pieces block: per scale ``s`` a row buffer and
    the centre row, two rows of floats, or for a segment of ``seg``
    columns ``2·seg + 2hw·Dc_s`` floats (the segment and a contiguous
    ``hw·Dc_s`` halo on each side, ``Dc_s = map_step(2^s, W)``)."""
    if seg == 0:
        return 8 * n * W
    return 4 * sum(2 * seg + 2 * hw * map_step(1 << s, W) for s in range(n))


def pieces_plan(B: int, H: int, W: int, n: int, hw: int,
                rows: int = 1) -> StepPlan:
    """The pieces form's launch on the card, from the shape, the number
    of scales ``n ≤ N_FAST`` and the taps' half width: a block a row
    (``grid = (H, segments, frames a launch)``), whole rows while the
    ``2n`` rows of floats fit :data:`PIECES_SMEM` (four blocks to an SM;
    ``W ≤ 2372`` at ``n = 3``), else the widest segment of
    :data:`~.hopper_conv.STEP_SEGS` whose buffers fit (2048 columns for
    the B3spline); a batch past :data:`~.hopper_conv.MAX_FRAMES` runs as
    several launches.  ``rows`` is the whites' frame stride in planes: 1
    for ``n`` planes ``(B, H, W)``, ``R`` for the batch-major cube ``(B,
    R, H, W)``; offsets are 32-bit while a launch's whites span fewer than
    2^31 elements.  Raises where a side reaches 2^30, the taps' reach
    passes 32-bit index math or a row has more than 65535 segments."""
    if not 1 <= n <= N_FAST or rows < 1:
        raise ValueError(f"pieces_plan: {n} scales, not 1..{N_FAST}, or "
                         f"{rows} rows a frame")
    if max(H, W) >= 2 ** 30:
        raise ValueError(f"pieces_plan: a {H}x{W} frame passes 32-bit "
                         "index math (2^30 a side)")
    if pieces_smem(n, hw, W, 0) <= PIECES_SMEM:
        seg = 0
    else:
        seg = next(s for s in STEP_SEGS
                   if pieces_smem(n, hw, W, s) <= PIECES_SMEM)
    frames = min(B, MAX_FRAMES)
    grid = (H, 1 if seg == 0 else -(-W // seg), frames)
    if grid[1] > 65535:
        raise ValueError(f"pieces_plan: {grid[1]} segments of a "
                         f"{W}-column row pass the grid's 65535")
    return StepPlan(seg, pieces_smem(n, hw, W, seg), grid,
                    32 if frames * rows * H * W < 2 ** 31 else 64)


def launch_whiten_plane(plane, white, recon, recon_mode, gamma, gamma_mode,
                        fac, thr, soft, sf, scale) -> None:
    """One scale of kernel D's deep-plane form on ``(B, H, W)`` float32
    CUDA tensors, one row-buffer launch (a launch per 65535 frames);
    ``fac`` and ``thr`` (or None: no mask) are ``(B,)`` float32 device
    tensors, ``recon_mode``/``gamma_mode`` 0 none, 1 set, 2 +=.  The
    launch counter is incremented here and nowhere else."""
    with tracing.launch(KERNEL, scale):
        lib = _lib()
        B, H, W = plane.shape
        plan = step_plan(B, H, W, 1 << scale, sf.half_width)
        taps = (ctypes.c_double * len(sf.taps))(*sf.taps)
        code = lib.wt_whiten_plane_f32(
            _ptr(plane), _ptr(white), _ptr(recon), int(recon_mode),
            _ptr(gamma), int(gamma_mode), _ptr(fac), _ptr(thr),
            int(bool(soft)), taps, len(sf.taps), B, H, W, 1 << scale,
            plan.seg, plan.grid[0], plan.grid[1], plan.grid[2],
            plan.smem_bytes, plan.index_bits, _build.stream_ptr(plane.device))
        _build.check(lib, code, "whiten_plane")


def launch_whiten_plane_ref(plane, white, recon, recon_mode, gamma,
                            gamma_mode, fac, thr, soft, sf, scale) -> None:
    """Check-only: :func:`launch_whiten_plane` through the first-port
    design, two per-pixel launches through a scratch plane
    (``wt_whiten_plane_ref_f32``).  Counted under :data:`REF`."""
    with tracing.launch(REF, scale):
        lib = _lib()
        B, H, W = plane.shape
        taps = (ctypes.c_double * len(sf.taps))(*sf.taps)
        # scratch held by name until the launches are queued
        tmp = torch.empty_like(plane)
        code = lib.wt_whiten_plane_ref_f32(
            _ptr(plane), _ptr(tmp), _ptr(white), _ptr(recon),
            int(recon_mode), _ptr(gamma), int(gamma_mode), _ptr(fac),
            _ptr(thr), int(bool(soft)), taps, len(sf.taps), B, H, W,
            1 << scale, _build.stream_ptr(plane.device))
        _build.check(lib, code, "whiten_plane_ref")


def _table(values, n: int, B: int, like: torch.Tensor) -> torch.Tensor:
    """``(n,)`` or ``(n, B)`` → a contiguous ``(n, B)`` table of
    ``like``'s dtype on its device."""
    t = tracing.as_tensor(values, dtype=like.dtype, device=like.device,
                          site="pieces.table")
    return t.reshape(n, -1).expand(n, B).contiguous()


def _check_args(pieces, n_fast, layout, batch_major, out_rows_total, out):
    """Raise for arguments outside the contract → the planes of a frame
    in the whites' output: 0 for the scale-major ``(n_fast, B, H, W)``,
    ``max(out_rows_total, n_fast)`` for the batch-major cube."""
    if n_fast < 1 or len(layout) < n_fast:
        raise ValueError("fused_whiten_pieces needs a layout entry for each "
                         "of its n_fast >= 1 scales")
    if any(p.ndim != 4 for p in pieces):
        raise ValueError("pieces are (rows, B, H, W) cubes")
    if not batch_major:
        if out_rows_total or out is not None:
            raise ValueError("out_rows_total and out are batch-major only")
        return 0
    _, B, H, W = pieces[0].shape
    rows = max(out_rows_total, n_fast)
    if out is not None and (tuple(out.shape) != (B, rows, H, W)
                            or out.dtype != pieces[0].dtype
                            or out.device != pieces[0].device):
        raise ValueError(f"out must be a {pieces[0].dtype} ({B}, {rows}, "
                         f"{H}, {W}) cube on the pieces' device")
    return rows


def _planes_out(n_fast, B, H, W, like, write_planes, rows, out):
    """The whites' output: None, the scale-major ``(n_fast, B, H, W)``
    planes, or the batch-major ``(B, rows, H, W)`` cube (``out`` when
    given), rows past ``n_fast`` left as they are."""
    if not write_planes:
        return None
    if not rows:
        return torch.empty((n_fast, B, H, W), dtype=like.dtype,
                           device=like.device)
    if out is not None:
        return out
    return torch.empty((B, rows, H, W), dtype=like.dtype, device=like.device)


def _white_of(planes, s, rows):
    """Scale ``s``'s whites ``(B, H, W)`` in either layout (a view)."""
    return planes[:, s] if rows else planes[s]


def fused_whiten_pieces_plain(
    pieces, factors, thresholds, sf: ScalingFunction, n_fast: int,
    layout: Sequence[Tuple[int, int]], soft: bool = True,
    write_planes: bool = True, batch_major: bool = False,
    out_rows_total: int = 0, write_gamma: bool = False, out=None,
):
    """Plain PyTorch version of :func:`fused_whiten_pieces` (any dtype or
    device)."""
    with tracing.plain(KERNEL, label=PIECES):
        rows = _check_args(pieces, n_fast, layout, batch_major,
                           out_rows_total, out)
        _, B, H, W = pieces[0].shape
        fac = _table(factors, n_fast, B, pieces[0])
        thr = _table(thresholds, n_fast, B, pieces[0])
        planes = _planes_out(n_fast, B, H, W, pieces[0], write_planes, rows,
                             out)
        recon, gamma = None, None
        for s in range(n_fast):
            k, r = layout[s]
            white, wc = whiten_detail_plain(
                pieces[k][r], fac[s][:, None, None], thr[s][:, None, None],
                sf, s, soft)
            # the kernel's order: set at the first scale, add the later ones
            recon = white.clone() if recon is None else recon + white
            if write_gamma:
                gamma = wc.clone() if gamma is None else gamma + wc
            if write_planes:
                _white_of(planes, s, rows).copy_(white)
    if write_gamma:
        return planes, recon, gamma
    return planes, recon


def _kernel_args(pieces, factors, thresholds, sf, n_fast, layout,
                 batch_major, out_rows_total, out, write_planes, write_gamma,
                 what):
    """Check CUDA pieces for kernel D → the planes of the scales, the
    contiguous ``(n, B)`` factor and threshold tables, the whites' frame
    stride in planes (``rows``, 0 scale-major) and the outputs
    ``(planes, recon, gamma)``."""
    rows = _check_args(pieces, n_fast, layout, batch_major, out_rows_total,
                       out)
    for p in pieces:
        check_kernel_input(p, sf, what)
    if out is not None:
        check_kernel_input(out, sf, what)
    src = [pieces[k][r] for k, r in layout[:n_fast]]
    _, B, H, W = pieces[0].shape
    planes = _planes_out(n_fast, B, H, W, pieces[0], write_planes, rows, out)
    recon = torch.empty((B, H, W), dtype=torch.float32,
                        device=pieces[0].device)
    gamma = torch.empty_like(recon) if write_gamma else None
    return (src, _table(factors, n_fast, B, pieces[0]),
            _table(thresholds, n_fast, B, pieces[0]), rows,
            (planes, recon, gamma))


def fused_whiten_pieces(
    pieces, factors, thresholds, sf: ScalingFunction, n_fast: int,
    layout: Sequence[Tuple[int, int]], soft: bool = True,
    write_planes: bool = True, batch_major: bool = False,
    out_rows_total: int = 0, write_gamma: bool = False, out=None,
):
    """Whiten detail scales ``0 .. n_fast−1`` read from decompose pieces.

    ``pieces``: tuple of plane cubes, each ``(rows, B, H, W)``;
    ``layout[s] = (piece, row)`` locates scale ``s``.  ``factors``: the
    multiplier table (``w_s · power_norm_s``), ``(n_fast,)`` or
    ``(n_fast, B)``, host values or a device tensor; ``thresholds``:
    ``(n_fast,)`` or ``(n_fast, B)`` on the device (0 → no mask).

    Returns ``(whitened (n_fast, B, H, W) or None, partial_recon
    (B, H, W))``, plus the gamma sum ``(B, H, W)`` of the masked,
    unwhitened planes with ``write_gamma``.  With ``batch_major`` the
    whites come out ``(B, R, H, W)``, ``R = max(out_rows_total,
    n_fast)``, written in that layout by the kernel (a frame stack's
    plane cube, no relayout); rows ``n_fast ..`` are left as they are
    for the caller to fill, in ``out`` when given (a ``(B, R, H, W)``
    cube), else in a new uninitialized cube.  CPU pieces run
    :func:`fused_whiten_pieces_plain`; CUDA pieces run kernel D's pieces
    form, one launch for the ``n_fast`` scales, or raise."""
    if not pieces[0].is_cuda:
        return fused_whiten_pieces_plain(
            pieces, factors, thresholds, sf, n_fast, layout, soft,
            write_planes, batch_major, out_rows_total, write_gamma, out)
    src, fac, thr, rows, (planes, recon, gamma) = _kernel_args(
        pieces, factors, thresholds, sf, n_fast, layout, batch_major,
        out_rows_total, out, write_planes, write_gamma,
        "fused_whiten_pieces")
    _, B, H, W = pieces[0].shape
    plan = pieces_plan(B, H, W, n_fast, sf.half_width, max(rows, 1))
    with tracing.launch(KERNEL, label=PIECES):
        lib = _lib()
        ptrs = ctypes.c_void_p * n_fast
        taps = (ctypes.c_double * len(sf.taps))(*sf.taps)
        code = lib.wt_whiten_pieces_f32(
            ptrs(*(_ptr(p) for p in src)),
            ptrs(*(_ptr(_white_of(planes, s, rows)) for s in range(n_fast)))
            if write_planes else None,
            _ptr(recon), _ptr(gamma), _ptr(fac), _ptr(thr), int(bool(soft)),
            n_fast, taps, len(sf.taps), B, H, W, max(rows, 1) * H * W,
            plan.seg, plan.grid[0], plan.grid[1], plan.grid[2],
            plan.smem_bytes, plan.index_bits,
            _build.stream_ptr(pieces[0].device))
        _build.check(lib, code, "whiten_pieces")
    if write_gamma:
        return planes, recon, gamma
    return planes, recon


def fused_whiten_pieces_ref(
    pieces, factors, thresholds, sf: ScalingFunction, n_fast: int,
    layout: Sequence[Tuple[int, int]], soft: bool = True,
    write_planes: bool = True, batch_major: bool = False,
    out_rows_total: int = 0, write_gamma: bool = False, out=None,
):
    """Check-only: :func:`fused_whiten_pieces` through kernel D's
    first-port design, one :func:`launch_whiten_plane_ref` a scale that
    sets recon and gamma at scale 0 and adds the later scales in order;
    a batch-major cube gets each scale's whites by a copy into its rows,
    so the pieces form's layout is held against PyTorch's indexing.  An
    independent reference for the pieces form's bits; no path calls it.
    Takes CUDA pieces only."""
    if not pieces[0].is_cuda:
        raise ValueError("fused_whiten_pieces_ref: a check on the card; it "
                         "takes CUDA pieces")
    src, fac, thr, rows, (planes, recon, gamma) = _kernel_args(
        pieces, factors, thresholds, sf, n_fast, layout, batch_major,
        out_rows_total, out, write_planes, write_gamma,
        "fused_whiten_pieces_ref")
    for s in range(n_fast):
        mode = 1 if s == 0 else 2
        white = None
        if write_planes:
            white = torch.empty_like(recon) if rows else planes[s]
        launch_whiten_plane_ref(src[s], white, recon, mode, gamma,
                                mode if write_gamma else 0, fac[s], thr[s],
                                soft, sf, s)
        if write_planes and rows:
            planes[:, s].copy_(white)
    if write_gamma:
        return planes, recon, gamma
    return planes, recon
