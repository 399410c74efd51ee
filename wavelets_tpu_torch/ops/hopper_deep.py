"""The deep WOW scales: one scale, a scale pair, one given plane.

Counterpart of ``wavelets_tpu/ops/pallas_deep.py`` (signatures minus
``interpret``):

* :func:`deep_whiten_step` — one scale from the carry, on kernel A's
  deep form (``csrc/whiten_step.cu``).  Float32: two launches, each a
  rows fold into a shared-memory row buffer and a cols fold out of it,
  the first writing ``c_next`` and the detail, the second the white and
  ``recon`` (launch sizes: :func:`~.hopper_conv.step_plan`).  The
  bfloat16 route (a float32 carry, ``white_dtype`` bfloat16): one launch
  of the residue-class stream, the detail kept on chip
  (:func:`~.hopper_conv.stream_step_plan`).  The shallow scales' group
  tile (``csrc/whiten_group.cu``) cannot hold a deep scale's halo, as on
  the TPU.  ``halo=R`` is the JAX kernel's halo mode, which only the
  sharded engine's band tail runs (``parallel/sharded.py``): the carry
  is a row band extended by ``R = 2·hw·2^scale`` rows a side, read
  without row reflection, and the outputs are its interior rows (one
  launch of the stream, counter ``whiten_step_halo``, float32 only, as
  the JAX package's sharded gate sends it).
* :func:`deep_whiten_step2` — scales ``(s, s+1)`` from the carry in one
  launch of kernel E (``csrc/whiten_pair.cu``), the middle carry kept on
  chip.  Float32: the torus, loaded and stored in whole 32-byte sectors
  by a cluster of ``min(8, D/2)`` blocks (:func:`pair_plan`).  The
  bfloat16 route (``white_dtype`` bfloat16): the residue-class stream, a
  row class pair's circle walked a tick a row with ``k`` column classes
  held as their circle (:func:`pair_stream_plan`).  :func:`can_deep2` is
  kernel E's gate, the float32 tori's, for both forms (the stream takes
  every shape it admits and more: the route's pairs and launch counts
  stay); where it refuses, the caller takes two :func:`deep_whiten_step`
  calls, the JAX package's rule when ``can_deep2`` is false (the two are
  numerically identical, pallas_deep.py:950-952), the bfloat16 route
  too (its middle carry is float32 either way).
* :func:`deep_whiten_plane` — whiten one materialized deep plane, on
  kernel D's deep-plane form (``csrc/whiten_plane.cu``: one launch of
  the row-buffer pass that kernel A's deep step and kernel G's second
  launch run, sized by :func:`~.hopper_conv.step_plan`), with a runtime
  factor, an optional gamma sum and an optional in-place recon add.
  :func:`deep_whiten_plane_ref` runs kernel D's first-port design (two
  per-pixel launches through a scratch plane), a check-only reference
  that no path calls.
* :func:`deep_bilateral_whiten_step` — one deep *bilateral* scale from the
  carry on kernel G (``csrc/bilateral_step.cu``), two launches: kernel
  F's ring at one scale (``c_next`` and the detail, sized by
  :func:`~.hopper_bilateral.bilateral_plan`), then the second pass of
  kernel A's deep step (the power smooth and whitening, sized by
  :func:`~.hopper_conv.step_plan`).  :func:`can_deep_bilateral` is the
  port's own gate (dtype, rank and taps only: the kernel takes any H, W
  and dilation).  :func:`deep_bilateral_whiten_step_ref` runs kernel G's
  earlier five per-pixel launches, an independent reference on the card
  for kernels F and G that no path calls.

Kernel A's deep step and kernel E have the bfloat16 route's forms
(counters ``whiten_step_bf16``, ``whiten_pair_bf16``): float32 inside,
bfloat16 at the boundary.  They read a float32 carry and recon, compute
every fold, the detail and the pair's middle carry in float32, write
``c_next`` and the recon in float32 (recon += the unrounded white) and
round only the whites, on store; thresholds float32.  Their plain
versions are the float32 plain versions on the widened carry, the whites
rounded to ``white_dtype`` on store.  This departs on purpose from the
JAX package's bfloat16 stream (pallas_deep.py:329-340, :914-920), which
rounds ``c_next`` and the recon to bfloat16 (PERF.md, section 6).
Kernels D and G have none: the JAX package runs them in float32 only.

A CPU tensor runs each kernel's plain version; a CUDA tensor runs the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import tracing
from . import _build
from .conv import bilateral_smooth, low_precision, separable_smooth_axis, widen
from .filters import ScalingFunction
from .hopper_bilateral import MAX_HW, bilateral_plan, kernel_weights
from .hopper_conv import (H100_SMS, HALO_KERNEL, KERNEL, MAX_FRAMES,
                          SMEM_OPTIN, _ptr, check_kernel_input,
                          launch_whiten_step, launch_whiten_stream, step_plan,
                          stream_chunk, threshold_dtype, whiten_detail_plain,
                          whiten_power_plain, whiten_scale_plain)
from .hopper_wow import KERNEL as PLANE_KERNEL
from .hopper_wow import launch_whiten_plane, launch_whiten_plane_ref

__all__ = ["deep_whiten_step", "deep_whiten_step_plain", "can_deep2",
           "PairPlan", "pair_plan", "PairStreamPlan", "pair_stream_plan",
           "pair_stream_smem", "PAIR_STREAM_THREADS",
           "deep_whiten_step2", "deep_whiten_step2_plain",
           "deep_whiten_plane", "deep_whiten_plane_plain",
           "deep_whiten_plane_ref",
           "can_deep_bilateral", "deep_bilateral_whiten_step",
           "deep_bilateral_whiten_step_plain",
           "deep_bilateral_whiten_step_ref"]

PAIR_KERNEL = "whiten_pair"
BILATERAL_KERNEL = "bilateral_step"
#: the launch counter of kernel G's check-only reference entry
BILATERAL_REF = "bilateral_step_ref"


def _check_same_dtype(carry, recon, what):
    if recon.dtype != carry.dtype:
        raise TypeError(f"{what}: recon is {recon.dtype}, the carry "
                        f"{carry.dtype}")


def _check_args(carry, recon, write_plane, what="deep_whiten_step"):
    if carry.ndim != 3:
        raise ValueError(f"{what} takes a (B, H, W) carry")
    if recon is None and not write_plane:
        raise ValueError(f"{what}: recon=None needs write_plane")
    if recon is not None and recon.shape != carry.shape:
        raise ValueError(f"{what}: recon must match the carry")


def _halo_rows(carry: torch.Tensor, halo: int, sf: ScalingFunction,
               scale: int) -> int:
    """The interior rows of a halo-mode carry, after checking ``halo``
    (the JAX assertion, pallas_deep.py:555-557), the dtype and taps."""
    if halo != 2 * sf.half_width * (1 << scale):
        raise ValueError(f"deep_whiten_step: halo mode requires halo == "
                         f"2*hw*2^scale = {2 * sf.half_width << scale}, "
                         f"got {halo}")
    if low_precision(carry.dtype):
        raise TypeError("deep_whiten_step: halo mode is float32 only, as "
                        "the JAX package's sharded gate sends it (stage 2 "
                        "takes float32 frames, parallel/sharded.py)")
    if not sf.is_symmetric:
        raise ValueError("deep_whiten_step: halo mode folds symmetric taps")
    H = carry.shape[-2] - 2 * halo
    if carry.ndim != 3 or H < 1:
        raise ValueError(f"deep_whiten_step: a halo-mode carry is (B, H + "
                         f"2*{halo}, W) with H >= 1, got {tuple(carry.shape)}")
    return H


def _check_halo_recon(carry, recon, H, write_plane):
    if recon is None and not write_plane:
        raise ValueError("deep_whiten_step: recon=None needs write_plane")
    if recon is not None and tuple(recon.shape) != (carry.shape[0], H,
                                                    carry.shape[2]):
        raise ValueError("deep_whiten_step: in halo mode recon covers the "
                         "carry's interior rows")


def _rows_fold(x: torch.Tensor, taps, D: int, off: int,
               n: int) -> torch.Tensor:
    """Rows ``off .. off+n−1`` of the rows fold of ``x`` at dilation
    ``D``, every tap read inside ``x`` (no reflection), in the fold order
    of :func:`~.conv.separable_smooth_axis`."""
    hw = (len(taps) - 1) // 2

    def rows(o):
        return x[..., off + o:off + o + n, :]

    out = rows(0) * taps[hw]
    for j in range(1, hw + 1):
        out = out + taps[hw + j] * (rows(-j * D) + rows(j * D))
    return out


def _step_halo_plain(carry, recon, thr, sf, scale, weight, soft, masked,
                     write_plane, halo):
    H = _halo_rows(carry, halo, sf, scale)
    _check_halo_recon(carry, recon, H, write_plane)
    D, r = 1 << scale, halo // 2
    # the detail of the interior and of hw·D rows either side, which the
    # power smooth reads; columns reflect at the band's full width
    c_ext = separable_smooth_axis(_rows_fold(carry, sf.taps, D, r, H + halo),
                                  sf.taps, scale, -1, "symmetric")
    detail = carry[..., r:r + H + halo, :] - c_ext
    lp = separable_smooth_axis(_rows_fold(detail * detail, sf.taps, D, r, H),
                               sf.taps, scale, -1, "symmetric")
    white, _ = whiten_power_plain(detail[..., r:r + H, :], lp, weight, thr,
                                  soft, masked)
    if recon is not None:
        recon.add_(white)
    return (white if write_plane else None), recon, c_ext[..., r:r + H, :]


def _step_plain(carry, recon, threshold, sf, scale, weight, soft, masked,
                write_plane, store):
    """Plain kernel A deep step: the float32 step on the widened carry
    (any dtype), ``recon`` += the unrounded white, the white stored as
    ``store``, ``c_next`` left in the widened dtype, counted under the
    store's counter."""
    with tracing.plain(tracing.counter(KERNEL, store), scale):
        _check_args(carry, recon, write_plane)
        thr = tracing.as_tensor(threshold, dtype=threshold_dtype(store),
                                device=carry.device,
                                site="step.threshold").reshape(-1)
        thr = thr.expand(carry.shape[0])[:, None, None]
        white, c_next = whiten_scale_plain(widen(carry), thr, weight, sf,
                                           scale, soft, masked)
        if recon is not None:
            recon.add_(white)
        return (white.to(store) if write_plane else None), recon, c_next


def deep_whiten_step_plain(carry: torch.Tensor,
                           recon: Optional[torch.Tensor],
                           threshold: torch.Tensor, *, sf: ScalingFunction,
                           scale: int, weight: float, soft: bool = True,
                           masked: bool = False, write_plane: bool = True,
                           halo: int = 0, white_dtype=None):
    """Plain PyTorch version of :func:`deep_whiten_step` (any dtype or
    device: the float32 step on a carry below float32, the white stored
    in ``white_dtype``, by default the carry's; halo mode in float32 and
    float64); like the kernel it adds into ``recon`` in place."""
    if halo:
        with tracing.plain(HALO_KERNEL, scale):
            thr = tracing.as_tensor(threshold, dtype=carry.dtype,
                                    device=carry.device,
                                    site="step.threshold").reshape(-1)
            return _step_halo_plain(
                carry, recon, thr.expand(carry.shape[0])[:, None, None], sf,
                scale, weight, soft, masked, write_plane, halo)
    return _step_plain(carry, recon, threshold, sf, scale, weight, soft,
                       masked, write_plane,
                       carry.dtype if white_dtype is None else white_dtype)


def deep_whiten_step(carry: torch.Tensor, recon: Optional[torch.Tensor],
                     threshold: torch.Tensor, *, sf: ScalingFunction,
                     scale: int, weight: float, soft: bool = True,
                     masked: bool = False, write_plane: bool = True,
                     halo: int = 0, white_dtype=None):
    """One WOW scale at dilation ``2^scale``: returns ``(white, recon',
    c_next)`` where ``c_next`` is the next scale's carry.

    ``carry``: ``(B, H, W)``; ``threshold``: ``(B,)`` per-frame
    significance threshold on the carry's device (read only when
    ``masked``).  ``recon`` (or None) is accumulated **in place**,
    ``recon' = recon += white``, which saves the separate read of
    ``white`` an out-of-place sum would cost; ``white`` is None when
    ``write_plane=False`` (then ``recon`` is required).  ``white_dtype``
    (by default the carry's) is the white's dtype: bfloat16 from a
    float32 carry and recon is the bfloat16 route's step, whose
    ``c_next`` and recon stay float32.  A CPU carry runs
    :func:`deep_whiten_step_plain`; a float32 CUDA carry runs kernel A's
    deep form (two launches of the row-buffer pass, or for bfloat16
    whites one launch of the stream); any other raises.

    ``halo > 0`` is halo mode (the sharded engine's band tail): ``carry``
    is ``(B, H + 2·halo, W)``, a band extended by its neighbours' rows or
    the image's reflection, ``halo == 2·hw·2^scale``; rows are read
    without reflection, columns reflect as ever, and ``white``,
    ``recon`` and ``c_next`` cover the ``H`` interior rows.  Float32
    only (a bfloat16 carry raises: the JAX package's stage-2 gate sends
    float32 alone), on kernel A's halo entry on the card (counter
    ``whiten_step_halo``)."""
    if not carry.is_cuda:
        return deep_whiten_step_plain(
            carry, recon, threshold, sf=sf, scale=scale, weight=weight,
            soft=soft, masked=masked, write_plane=write_plane, halo=halo,
            white_dtype=white_dtype)
    check_kernel_input(carry, sf, "deep_whiten_step")
    store = carry.dtype if white_dtype is None else white_dtype
    if store not in (torch.float32, torch.bfloat16) or (
            halo and store != torch.float32):
        raise TypeError(f"deep_whiten_step: no kernel stores {store} whites"
                        f"{' in halo mode' if halo else ''}")
    if halo:
        H = _halo_rows(carry, halo, sf, scale)
        _check_halo_recon(carry, recon, H, write_plane)
        out_shape = (carry.shape[0], H, carry.shape[2])
    else:
        _check_args(carry, recon, write_plane)
        out_shape = carry.shape
    if recon is not None:
        _check_same_dtype(carry, recon, "deep_whiten_step")
        check_kernel_input(recon, sf, "deep_whiten_step")
    thr = tracing.as_tensor(threshold, dtype=torch.float32,
                            device=carry.device,
                            site="step.threshold").reshape(-1)
    thr = thr.expand(carry.shape[0]).contiguous()
    white = (torch.empty(out_shape, dtype=store, device=carry.device)
             if write_plane else None)
    c_next = torch.empty(out_shape, dtype=carry.dtype, device=carry.device)
    acc_mode = 0 if recon is None else 2
    if halo or store == torch.bfloat16:
        launch_whiten_stream(carry, c_next, white, recon, acc_mode, thr,
                             weight, masked, soft, sf, scale, halo)
    else:
        # float32 scratch, held by name until the launches are queued
        detail = torch.empty_like(carry)
        launch_whiten_step(carry, c_next, detail, white, recon, acc_mode,
                           thr, weight, masked, soft, sf, scale)
    return white, recon, c_next


# ---------------------------------------------------------------------
# Kernel E: two deep scales per launch
# ---------------------------------------------------------------------

@dataclass(frozen=True)
class PairPlan:
    """Kernel E's float32 launch (``wt_whiten_pair_f32``, the torus),
    passed to ``csrc/whiten_pair.cu`` as it stands
    (the kernel checks it and launches it): one block per (column class,
    row class pair, frame), ``grid``; ``cluster`` adjacent column classes
    per thread-block cluster, which load and store whole sectors
    together; ``smem_bytes`` per block (four ``2M × 2N`` float32 tori)."""
    cluster: int
    smem_bytes: int
    grid: Tuple[int, int, int]


def pair_plan(B: int, H: int, W: int, scale: int) -> Optional[PairPlan]:
    """Kernel E's float32 launch for the pair ``(scale, scale+1)`` (and
    :func:`can_deep2`'s gate) from the shape alone, or None where ``D =
    2^scale`` does not divide ``H`` and ``W`` or the tori do not fit the
    shared memory.  The cluster is 8 blocks (one 32-byte sector of column
    classes) and narrows to ``D/2`` below ``D = 16``."""
    D = 1 << scale
    if H % D or W % D:
        return None
    smem = 16 * (2 * H // D) * (2 * W // D)  # four float32 tori
    if smem > SMEM_OPTIN:
        return None
    classes = max(1, D // 2)
    return PairPlan(min(8, classes), smem, (classes, classes, B))


def can_deep2(carry: torch.Tensor, sf: ScalingFunction, scale: int) -> bool:
    """Kernel E's gate for the pair ``(scale, scale+1)`` on a ``(B, H, W)``
    carry: ``D = 2^scale`` divides ``H`` and ``W`` (every tap and
    reflection then stays in a pair of residue classes per axis) and the
    float32 torus's four ``2H/D × 2W/D`` buffers fit the shared memory
    (:func:`pair_plan`).  The same gate for bfloat16, whose stream
    (:func:`pair_stream_plan`) takes every shape it admits, so the route
    pairs where it did.  It depends on the shape only, so the plain
    versions dispatch as the kernels do."""
    if not sf.is_symmetric or sf.half_width > 8:
        return False
    B = carry.shape[0] if carry.ndim == 3 else 1
    return pair_plan(B, *carry.shape[-2:], scale) is not None


#: kernel E's bfloat16 stream: the threads a block may have, each taking
#: two adjacent points of a window row (one where a group is one class),
#: and the threads it keeps on an SM
PAIR_STREAM_THREADS = (512, 256, 128, 64)
PAIR_STREAM_SM_THREADS = 512
#: the least a tick of the stream costs an SM, in points' work: below it
#: a tick waits on latency, not issue
PAIR_STREAM_MIN_WORK = 512
#: an SM's shared memory and what each block reserves of it (H100)
SM_SMEM, BLOCK_RESERVED = 233472, 1024


@dataclass(frozen=True)
class PairStreamPlan:
    """Kernel E's bfloat16 launch (``wt_whiten_pair_bf16``), passed to
    ``csrc/whiten_pair.cu`` as it stands (the kernel lays out its rings,
    checks the plan against them and launches it): ``k`` adjacent column
    classes a group, with their mirrors; ``run`` output positions of the
    column circle a window (0: the whole circle, whose cols folds wrap
    through margins filled with copies); ``chunk`` output positions of the
    row circle a work item walks; ``threads`` a block; ``smem_bytes`` per
    block; ``grid`` blocks, each taking the items (frame, chunk, row pair,
    run, group) grid-stride."""
    k: int
    run: int
    chunk: int
    threads: int
    smem_bytes: int
    grid: int


def pair_stream_smem(k: int, window: int, hw: int, circle: bool) -> int:
    """Shared bytes of a stream block, as ``csrc/whiten_pair.cu::
    pair_layout`` lays them out, all float32, each row of ``pts =
    window·k`` points padded to 16 bytes: the carry's ring of ``2hw+2``
    rows, two recon rows, the ring of ``white_s`` (``3hw+2`` rows), the
    middle carry's ring (``4hw+2`` rows), the squared and the plain
    detail of scale ``s`` (``2hw+2`` and ``hw+2``) and of ``s+1``
    (``4hw+2`` and ``2hw+2``); two sets of the four rows-fold buffers,
    each with ``hw`` (scale ``s``) or ``2hw`` (``s+1``) positions of
    margin a side on the circle."""
    pf = -(-(window * k) // 4) * 4
    m1, m2 = (hw, 2 * hw) if circle else (0, 0)
    t1 = -(-(window + 2 * m1) * k // 4) * 4
    t2 = -(-(window + 2 * m2) * k // 4) * 4
    rows = ((2 * hw + 2) + 2 + (3 * hw + 2) + 2 * (4 * hw + 2)
            + 2 * (2 * hw + 2) + (hw + 2))
    return 4 * pf * rows + 4 * 2 * (2 * t1 + 2 * t2)


@functools.lru_cache(maxsize=None)
def pair_stream_plan(B: int, H: int, W: int, D: int,
                     hw: int) -> PairStreamPlan:
    """Kernel E's bfloat16 launch on an H100 from the shape, the dilation
    ``D = 2^s`` and the half width of the taps.  A work item walks the
    circle of a row class pair ``{r, D−1−r}`` (``2M`` positions, ``M =
    H/D``; for ``D = 1`` the one class, output on its first ``M``) with
    a group of ``k`` column classes ``{q, D−1−q}`` held as their circle of
    ``2N`` positions (``N = W/D``), or where that passes the block (two
    points a thread, one at ``k = 1``, or the shared memory) as windows of
    ``run`` output positions and ``5hw`` of margin a side.  Of every ``k``
    (powers of two dividing the ``D/2`` classes) and block of
    :data:`PAIR_STREAM_THREADS`, with as many blocks an SM as its shared
    memory and :data:`PAIR_STREAM_SM_THREADS` allow, the one whose chunk
    (:func:`~.hopper_conv.stream_chunk`, a chunk of ``L`` positions taking
    ``L + 8hw + 2`` ticks) takes the fewest ticks on the busiest SM, each
    tick priced by its points (twice where a thread takes one: its ring
    slots and addresses cost as much as two points'; at least
    :data:`PAIR_STREAM_MIN_WORK`), ties to groups of 16-byte loads (``k ≥
    8``), then the larger ``k`` (fewer items, each warming up once), more
    blocks an SM and the fewer threads.  Raises where ``D`` does not
    divide ``H`` and ``W``, or a side, the batch or the taps pass what the
    kernel takes."""
    if D < 1 or D & (D - 1) or H % D or W % D:
        raise ValueError(f"pair_stream_plan: D = {D} must be a power of two "
                         f"dividing {H}x{W}")
    if not (1 <= B <= MAX_FRAMES and max(H, W) < 2 ** 30 and 1 <= hw <= 8):
        raise ValueError(f"pair_stream_plan: B = {B}, {H}x{W}, hw = {hw} "
                         "out of range")
    M, N = H // D, W // D
    classes = max(1, D // 2)
    rows_out = M if D == 1 else 2 * M
    cols_out = N if D == 1 else 2 * N
    best = None
    for threads in PAIR_STREAM_THREADS:
        k = classes
        while k >= 1:
            max_pts = threads * (2 if k >= 2 else 1)
            window, run = 2 * N, 0
            if 2 * N * k > max_pts or pair_stream_smem(
                    k, window, hw, True) > SMEM_OPTIN:
                window = min(max_pts // k, cols_out + 10 * hw)
                while window > 10 * hw and pair_stream_smem(
                        k, window, hw, False) > SMEM_OPTIN:
                    window -= 1
                run = window - 10 * hw if window > 10 * hw else -1
            if run >= 0 and window * k <= max_pts:
                smem = pair_stream_smem(k, window, hw, run == 0)
                per_sm = min(SM_SMEM // (smem + BLOCK_RESERVED),
                             PAIR_STREAM_SM_THREADS // threads)
                runs = 1 if run == 0 else -(-cols_out // run)
                per = B * classes * runs * (classes // k)
                chunk, ticks = stream_chunk(rows_out, per, 8 * hw + 2)
                work = window * k * (1 if k >= 2 else 2)
                cost = (ticks * max(work, PAIR_STREAM_MIN_WORK), k < 8, -k,
                        -per_sm, threads)
                if best is None or cost < best[0]:
                    items = per * -(-rows_out // chunk)
                    best = (cost, PairStreamPlan(
                        k, run, chunk, threads, smem,
                        min(items, H100_SMS * per_sm)))
            k //= 2
    if best is None:
        raise ValueError(f"pair_stream_plan: no window of a {H}x{W} frame "
                         f"at D = {D} fits the shared memory")
    return best[1]


def _lib_pair():
    lib = _build.load(PAIR_KERNEL)
    fn = lib.wt_whiten_pair_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.wt_whiten_pair_bf16
    # a float32 carry, c_next and recon, bfloat16 whites, ..., B, H, W,
    # D, then k, run, chunk, threads, grid, shared bytes
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_longlong] * 10 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _pair_args(carry, recon, thresholds, weights, masked, write_plane):
    _check_args(carry, recon, write_plane)
    if len(weights) != 2 or len(masked) != 2:
        raise ValueError("deep_whiten_step2 takes two weights and two "
                         "masked flags")
    thr = tracing.as_tensor(thresholds, dtype=threshold_dtype(carry.dtype),
                            device=carry.device,
                            site="pair.thresholds").reshape(2, -1)
    return thr.expand(2, carry.shape[0]).contiguous()


def deep_whiten_step2_plain(carry: torch.Tensor,
                            recon: Optional[torch.Tensor],
                            thresholds: torch.Tensor, *,
                            sf: ScalingFunction, scale: int, weights,
                            soft: bool = True, masked=(False, False),
                            write_plane: bool = True, white_dtype=None):
    """Plain PyTorch version of :func:`deep_whiten_step2` (any dtype or
    device): two plain float32 steps on the widened carry; like the
    kernel it adds the unrounded whites into ``recon`` in place, scale
    ``s`` first, and stores the whites in ``white_dtype`` (by default the
    carry's), ``c_next2`` in the widened dtype."""
    store = carry.dtype if white_dtype is None else white_dtype
    with tracing.plain(tracing.counter(PAIR_KERNEL, store), scale):
        thr = _pair_args(carry, recon, thresholds, weights, masked,
                         write_plane)
        whites, cur = [], widen(carry)
        for k in range(2):
            white, cur = whiten_scale_plain(
                cur, thr[k][:, None, None], float(weights[k]), sf, scale + k,
                soft, bool(masked[k]))
            if recon is not None:
                recon.add_(white)
            whites.append(white.to(store) if write_plane else None)
        return whites[0], whites[1], recon, cur


def deep_whiten_step2(carry: torch.Tensor, recon: Optional[torch.Tensor],
                      thresholds: torch.Tensor, *, sf: ScalingFunction,
                      scale: int, weights, soft: bool = True,
                      masked=(False, False), write_plane: bool = True,
                      white_dtype=None):
    """Two consecutive deep WOW scales ``(scale, scale+1)`` in one pass:
    returns ``(white_s, white_s1, recon', c_next2)``.  ``thresholds``:
    ``(2, B)`` (or ``(2,)``) per-scale, per-frame thresholds on the
    carry's device; ``weights``/``masked``: pairs.  ``recon`` (or None) is
    accumulated in place, ``(recon + white_s) + white_s1``, the order of
    two :func:`deep_whiten_step` calls; the whites are None when
    ``write_plane=False``.  ``white_dtype`` (by default the carry's) is
    the whites' dtype: bfloat16 from a float32 carry and recon is the
    bfloat16 route's pair, whose ``c_next2`` and recon stay float32.
    Gate with :func:`can_deep2`.  A CPU carry runs
    :func:`deep_whiten_step2_plain`; a float32 CUDA carry kernel E's torus
    (raises where :func:`pair_plan` refuses), or for bfloat16 whites its
    stream (raises where :func:`pair_stream_plan` does); any other
    raises."""
    if not carry.is_cuda:
        return deep_whiten_step2_plain(
            carry, recon, thresholds, sf=sf, scale=scale, weights=weights,
            soft=soft, masked=masked, write_plane=write_plane,
            white_dtype=white_dtype)
    check_kernel_input(carry, sf, "deep_whiten_step2")
    store = carry.dtype if white_dtype is None else white_dtype
    if store not in (torch.float32, torch.bfloat16):
        raise TypeError(f"deep_whiten_step2: no kernel stores {store} "
                        "whites")
    thr = _pair_args(carry, recon, thresholds, weights, masked, write_plane)
    if recon is not None:
        _check_same_dtype(carry, recon, "deep_whiten_step2")
        check_kernel_input(recon, sf, "deep_whiten_step2")
    B, H, W = carry.shape
    if store == torch.bfloat16:
        p = pair_stream_plan(B, H, W, 1 << scale, sf.half_width)
    else:
        p = pair_plan(B, H, W, scale)
        if p is None:
            raise ValueError("deep_whiten_step2: kernel E does not take "
                             "this shape (use can_deep2 before dispatch)")
    c_next = torch.empty_like(carry)
    w1 = torch.empty_like(carry, dtype=store) if write_plane else None
    w2 = torch.empty_like(carry, dtype=store) if write_plane else None
    with tracing.launch(tracing.counter(PAIR_KERNEL, store), scale):
        lib = _lib_pair()
        taps = (ctypes.c_double * len(sf.taps))(*sf.taps)
        args = (_ptr(carry), _ptr(c_next), _ptr(w1), _ptr(w2), _ptr(recon),
                _ptr(thr), float(weights[0]), float(weights[1]),
                int(bool(masked[0])), int(bool(masked[1])), int(bool(soft)),
                taps, len(sf.taps), B, H, W, 1 << scale)
        if store == torch.bfloat16:
            code = lib.wt_whiten_pair_bf16(
                *args, p.k, p.run, p.chunk, p.threads, p.grid, p.smem_bytes,
                _build.stream_ptr(carry.device))
        else:
            code = lib.wt_whiten_pair_f32(
                *args, p.grid[0], p.grid[1], p.cluster, p.smem_bytes,
                _build.stream_ptr(carry.device))
        _build.check(lib, code, "whiten_pair")
    return w1, w2, recon, c_next


# ---------------------------------------------------------------------
# Kernel D: one given deep plane
# ---------------------------------------------------------------------

def _plane_args(plane, threshold, weight, gamma, recon, write_plane):
    if plane.ndim != 3:
        raise ValueError("deep_whiten_plane takes a (B, H, W) plane")
    if gamma is not None and gamma.shape != plane.shape:
        raise ValueError("deep_whiten_plane: gamma must match the plane")
    _check_args(plane, recon, write_plane, "deep_whiten_plane")
    B = plane.shape[0]
    fac = tracing.as_tensor(weight, dtype=plane.dtype, device=plane.device,
                            site="plane.weight").reshape(-1).expand(B)
    thr = tracing.as_tensor(threshold, dtype=plane.dtype,
                            device=plane.device,
                            site="plane.threshold").reshape(-1).expand(B)
    return fac.contiguous(), thr.contiguous()


def deep_whiten_plane_plain(plane: torch.Tensor, threshold, *,
                            sf: ScalingFunction, scale: int, weight,
                            soft: bool = True, masked: bool = False,
                            gamma: Optional[torch.Tensor] = None,
                            recon: Optional[torch.Tensor] = None,
                            write_plane: bool = True):
    """Plain PyTorch version of :func:`deep_whiten_plane` (any dtype or
    device); like the kernel it adds into ``gamma`` and ``recon`` in
    place."""
    with tracing.plain(PLANE_KERNEL, scale):
        fac, thr = _plane_args(plane, threshold, weight, gamma, recon,
                               write_plane)
        white, wc = whiten_detail_plain(plane, fac[:, None, None],
                                        thr[:, None, None], sf, scale, soft,
                                        masked)
        if gamma is not None:
            gamma.add_(wc)
        if recon is not None:
            recon.add_(white)
        return white if write_plane else None


def _plane_kernel_args(plane, threshold, weight, sf, gamma, recon,
                       write_plane, what):
    check_kernel_input(plane, sf, what)
    fac, thr = _plane_args(plane, threshold, weight, gamma, recon,
                           write_plane)
    for t in (gamma, recon):
        if t is not None:
            check_kernel_input(t, sf, what)
    return fac, thr


def deep_whiten_plane(plane: torch.Tensor, threshold, *,
                      sf: ScalingFunction, scale: int, weight,
                      soft: bool = True, masked: bool = False,
                      gamma: Optional[torch.Tensor] = None,
                      recon: Optional[torch.Tensor] = None,
                      write_plane: bool = True):
    """Whiten one materialized deep detail plane: returns ``white =
    plane·sig·(weight / sqrt(max(smooth_s(plane²), 1e-15)))``.

    ``plane``: ``(B, H, W)``; ``threshold``: ``(B,)`` (read only when
    ``masked``).  ``weight`` is a float or a ``(B,)`` tensor on the
    plane's device, so a runtime factor (``preserve_variance``'s
    ``w·sqrt(mean(c²))``) needs no host round trip.  ``gamma`` (or None)
    is a ``(B, H, W)`` tensor to which the masked, unwhitened plane is
    added in place (the gamma-blend input); ``recon`` (or None) one to
    which the white is added in place, ``recon += white``, the same float32
    add as an out-of-place sum.  With ``write_plane=False`` no white is
    written and None is returned (then ``recon`` is required).  The
    defaults are the JAX signature and contract.  A CPU plane runs
    :func:`deep_whiten_plane_plain`; a CUDA plane runs kernel D's
    deep-plane form (one row-buffer launch) or raises."""
    if not plane.is_cuda:
        return deep_whiten_plane_plain(
            plane, threshold, sf=sf, scale=scale, weight=weight, soft=soft,
            masked=masked, gamma=gamma, recon=recon, write_plane=write_plane)
    fac, thr = _plane_kernel_args(plane, threshold, weight, sf, gamma, recon,
                                  write_plane, "deep_whiten_plane")
    white = torch.empty_like(plane) if write_plane else None
    launch_whiten_plane(plane, white, recon, 0 if recon is None else 2,
                        gamma, 0 if gamma is None else 2, fac,
                        thr if masked else None, soft, sf, scale)
    return white


def deep_whiten_plane_ref(plane: torch.Tensor, threshold, *,
                          sf: ScalingFunction, scale: int, weight,
                          soft: bool = True, masked: bool = False,
                          gamma: Optional[torch.Tensor] = None,
                          recon: Optional[torch.Tensor] = None,
                          write_plane: bool = True):
    """Check-only: :func:`deep_whiten_plane` through kernel D's first-port
    design, two per-pixel launches through a scratch plane
    (``csrc/whiten_plane.cu`` ``wt_whiten_plane_ref_f32``).  An
    independent reference for the deep-plane form's bits; no path calls
    it.  Takes a CUDA plane only; counted under
    :data:`~.hopper_wow.REF`."""
    if not plane.is_cuda:
        raise ValueError("deep_whiten_plane_ref: a check on the card; it "
                         "takes a CUDA plane")
    fac, thr = _plane_kernel_args(plane, threshold, weight, sf, gamma, recon,
                                  write_plane, "deep_whiten_plane_ref")
    white = torch.empty_like(plane) if write_plane else None
    launch_whiten_plane_ref(plane, white, recon, 0 if recon is None else 2,
                            gamma, 0 if gamma is None else 2, fac,
                            thr if masked else None, soft, sf, scale)
    return white


# ---------------------------------------------------------------------
# Kernel G: one deep bilateral scale
# ---------------------------------------------------------------------

def can_deep_bilateral(carry: torch.Tensor, sf: ScalingFunction,
                       scale: int) -> bool:
    """Kernel G's gate: a float32 ``(H, W)`` or ``(B, H, W)`` carry and
    symmetric taps of half width 1..``MAX_HW``.  It depends on dtype,
    rank and taps only: the kernel reads every tap through the periodic
    symmetric index map, so any H, W and ``scale`` work (the TPU gates,
    ``W % 128``, ``Rc ≥ 32``, one reflection, ``H % D``, are not needed)."""
    return (carry.dtype == torch.float32 and carry.ndim in (2, 3)
            and scale >= 0 and sf.is_symmetric
            and 1 <= sf.half_width <= MAX_HW)


def _lib_bilateral():
    lib = _build.load(BILATERAL_KERNEL)
    fn = lib.wt_bilateral_step_f32
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p] + [ctypes.c_longlong] * 14
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ref = lib.wt_bilateral_step_ref_f32
    ref.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_float] + [ctypes.c_int] * 2
                    + [ctypes.c_float] * 2 + [ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p] + [ctypes.c_longlong] * 4
                    + [ctypes.c_void_p])
    ref.restype = ctypes.c_int
    return lib


def _bilateral_args(carry, threshold, recon, write_plane):
    _check_args(carry, recon, write_plane, "deep_bilateral_whiten_step")
    thr = tracing.as_tensor(threshold, dtype=carry.dtype,
                            device=carry.device,
                            site="bilateral.threshold").reshape(-1)
    return thr.expand(carry.shape[0])


def _bilateral_kernel_args(carry, threshold, sf, scale, recon, write_plane,
                           what):
    """Check a CUDA carry (and recon) for kernel G's entries → the
    contiguous per-frame thresholds."""
    check_kernel_input(carry, sf, what)
    if not can_deep_bilateral(carry, sf, scale):
        raise ValueError(f"{what}: kernel G does not take this carry or "
                         "scaling function (use can_deep_bilateral before "
                         "dispatch)")
    thr = _bilateral_args(carry, threshold, recon, write_plane).contiguous()
    if recon is not None:
        check_kernel_input(recon, sf, what)
    return thr


def deep_bilateral_whiten_step_plain(
        carry: torch.Tensor, threshold, *, sf: ScalingFunction, scale: int,
        var_factor: float, weight: float, soft: bool = True,
        masked: bool = False, bilateral_scaling: bool = False,
        recon: Optional[torch.Tensor] = None, write_plane: bool = True):
    """Plain PyTorch version of :func:`deep_bilateral_whiten_step` (any
    dtype or device): the JAX package's XLA deferred-tail step
    (``_smooth_step``, the difference, the power smooth and the
    whitening); like the kernel it adds into ``recon`` in place."""
    with tracing.plain(BILATERAL_KERNEL, scale):
        thr = _bilateral_args(carry, threshold, recon, write_plane)
        c_next = bilateral_smooth(carry, sf, scale, float(var_factor),
                                  bilateral_scaling, axes=(-2, -1),
                                  boundary="symmetric")
        white, _ = whiten_detail_plain(carry - c_next, float(weight),
                                       thr[:, None, None], sf, scale, soft,
                                       masked)
        if recon is not None:
            recon.add_(white)
        return (white if write_plane else None), c_next


def deep_bilateral_whiten_step(
        carry: torch.Tensor, threshold, *, sf: ScalingFunction, scale: int,
        var_factor: float, weight: float, soft: bool = True,
        masked: bool = False, bilateral_scaling: bool = False,
        recon: Optional[torch.Tensor] = None, write_plane: bool = True):
    """One deferred-tail *bilateral* WOW scale at dilation ``2^scale``:
    returns ``(white, c_next)``.

    The chain smooth is the bilateral one (local variance × ``var_factor
    = σ_b[scale]²``, × ``scale+1`` under ``bilateral_scaling``, then the
    range-weighted taps); the power smooth stays plain
    (watroo/utils.py:194).  ``carry``: ``(B, H, W)``; ``threshold``:
    ``(B,)`` per-frame significance threshold (read only when
    ``masked``).  ``recon`` (or None) is accumulated in place, ``recon +=
    white``, as ``deep_whiten_step`` does; ``white`` is None when
    ``write_plane=False`` (then ``recon`` is required).  A CPU carry runs
    :func:`deep_bilateral_whiten_step_plain`; a CUDA carry runs kernel G
    (``csrc/bilateral_step.cu``) or raises."""
    if not carry.is_cuda:
        return deep_bilateral_whiten_step_plain(
            carry, threshold, sf=sf, scale=scale, var_factor=var_factor,
            weight=weight, soft=soft, masked=masked,
            bilateral_scaling=bilateral_scaling, recon=recon,
            write_plane=write_plane)
    thr = _bilateral_kernel_args(carry, threshold, sf, scale, recon,
                                 write_plane, "deep_bilateral_whiten_step")
    B, H, W = carry.shape
    D, hw = 1 << scale, sf.half_width
    step = step_plan(B, H, W, D, hw)
    ring = bilateral_plan(step.grid[2], H, W, D, hw)
    c_next = torch.empty_like(carry)
    white = torch.empty_like(carry) if write_plane else None
    with tracing.launch(BILATERAL_KERNEL, scale):
        # scratch held by name until the launches are queued (see
        # hopper_bilateral.fused_bilateral_group)
        detail = torch.empty_like(carry)
        lib = _lib_bilateral()
        taps = (ctypes.c_double * len(sf.taps))(*sf.taps)
        code = lib.wt_bilateral_step_f32(
            _ptr(carry), _ptr(c_next), _ptr(detail), _ptr(white), _ptr(recon),
            0 if recon is None else 2, _ptr(thr), float(weight),
            int(bool(masked)), int(bool(soft)), float(var_factor),
            float(scale + 1) if bilateral_scaling else 1.0, taps, len(sf.taps),
            kernel_weights(sf), B, H, W, D, ring.rows, ring.seg,
            ring.grid[0], ring.grid[1], ring.smem_bytes, step.seg,
            step.grid[0], step.grid[1], step.smem_bytes, step.grid[2],
            step.index_bits, _build.stream_ptr(carry.device))
        _build.check(lib, code, "bilateral_step")
    return white, c_next


def deep_bilateral_whiten_step_ref(
        carry: torch.Tensor, threshold, *, sf: ScalingFunction, scale: int,
        var_factor: float, weight: float, soft: bool = True,
        masked: bool = False, bilateral_scaling: bool = False,
        recon: Optional[torch.Tensor] = None, write_plane: bool = True):
    """Check-only: :func:`deep_bilateral_whiten_step` through kernel G's
    earlier five per-pixel launches on the card (``csrc/bilateral_step.cu``
    ``wt_bilateral_step_ref_f32``: the three passes of
    ``wt_bilateral.cuh``, every tap through the symmetric index map, then
    the power smooth and whitening one pixel a thread).  An independent
    reference for the bits of kernels F and G; no path calls it.  Takes a
    CUDA carry only; counted under :data:`BILATERAL_REF`."""
    if not carry.is_cuda:
        raise ValueError("deep_bilateral_whiten_step_ref: a check on the "
                         "card; it takes a CUDA carry")
    thr = _bilateral_kernel_args(carry, threshold, sf, scale, recon,
                                 write_plane, "deep_bilateral_whiten_step_ref")
    B, H, W = carry.shape
    c_next = torch.empty_like(carry)
    white = torch.empty_like(carry) if write_plane else None
    with tracing.launch(BILATERAL_REF, scale):
        # scratch held by name until the launches are queued
        detail, tm, tq = torch.empty((3, B, H, W), dtype=carry.dtype,
                                     device=carry.device)
        lib = _lib_bilateral()
        taps = (ctypes.c_double * len(sf.taps))(*sf.taps)
        code = lib.wt_bilateral_step_ref_f32(
            _ptr(carry), _ptr(c_next), _ptr(detail), _ptr(tm), _ptr(tq),
            _ptr(white), _ptr(recon), 0 if recon is None else 2, _ptr(thr),
            float(weight), int(bool(masked)), int(bool(soft)),
            float(var_factor), float(scale + 1) if bilateral_scaling else 1.0,
            taps, len(sf.taps), kernel_weights(sf), B, H, W, 1 << scale,
            _build.stream_ptr(carry.device))
        _build.check(lib, code, "bilateral_step_ref")
    return white, c_next
