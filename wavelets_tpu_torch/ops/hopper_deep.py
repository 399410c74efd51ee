"""The deep WOW scales: one scale, a scale pair, one given plane.

Counterpart of ``wavelets_tpu/ops/pallas_deep.py`` (signatures minus
``interpret``):

* :func:`deep_whiten_step` — one scale from the carry, on kernel A's
  deep form (``csrc/whiten_step.cu``): two launches, each a rows fold
  into a shared-memory row buffer and a cols fold out of it, the first
  writing ``c_next`` and the detail, the second the white and ``recon``
  (launch sizes: :func:`~.hopper_conv.step_plan`).  The shallow scales'
  group tile (``csrc/whiten_group.cu``) cannot hold a deep scale's halo,
  as on the TPU.  ``halo=R`` is the JAX kernel's halo mode, which only
  the sharded engine's band tail runs (``parallel/sharded.py``): the
  carry is a row band extended by ``R = 2·hw·2^scale`` rows a side, read
  without row reflection, and the outputs are its interior rows
  (counter ``whiten_step_halo``, float32 only, as the JAX package's
  sharded gate sends it).
* :func:`deep_whiten_step2_split` — the bfloat16 pair ``(s, s+1)`` as
  two launches of kernel A's bfloat16 deep step with the middle carry
  stored in float32: the JAX pair's rounding where kernel E's float32
  tori do not fit the shared memory.
* :func:`deep_whiten_step2` — scales ``(s, s+1)`` from the carry in one
  launch of kernel E (``csrc/whiten_pair.cu``), the middle carry kept in
  shared memory, the torus loaded and stored in whole 32-byte sectors by
  a cluster of ``min(8, D/2)`` blocks (:func:`pair_plan`).
  :func:`can_deep2` is kernel E's own gate; where it refuses, the caller
  takes two :func:`deep_whiten_step` calls, the JAX package's rule when
  ``can_deep2`` is false (the two are numerically identical,
  pallas_deep.py:950-952).
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

Kernel A's deep step and kernel E have bfloat16 forms (counters
``whiten_step_bf16``, ``whiten_pair_bf16``), the JAX package's bfloat16
stream (pallas_deep.py:329-340, :914-920): the carry read as float32,
every fold, the detail and the pair's middle carry in float32, and
``c_next``, the whites and the recon add rounded to bfloat16 on store;
thresholds float32.  Their plain versions do the same for any dtype
below float32.  Kernels D and G have none: the JAX package runs them in
float32 only.

A CPU tensor runs each kernel's plain version; a CUDA tensor runs the
kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import _build
from .conv import bilateral_smooth, low_precision, separable_smooth_axis, widen
from .filters import ScalingFunction
from .hopper_bilateral import MAX_HW, bilateral_plan, kernel_weights
from .hopper_conv import (KERNEL, SMEM_OPTIN, _lib as _lib_step, _ptr,
                          check_kernel_input, launch_whiten_step, step_plan,
                          threshold_dtype, whiten_detail_plain,
                          whiten_power_plain, whiten_scale_plain)
from .hopper_wow import KERNEL as PLANE_KERNEL
from .hopper_wow import launch_whiten_plane, launch_whiten_plane_ref

__all__ = ["deep_whiten_step", "deep_whiten_step_plain", "can_deep2",
           "halo_step_plans", "PairPlan", "pair_plan",
           "deep_whiten_step2", "deep_whiten_step2_plain",
           "deep_whiten_step2_split", "deep_whiten_step2_split_plain",
           "deep_whiten_plane", "deep_whiten_plane_plain",
           "deep_whiten_plane_ref",
           "can_deep_bilateral", "deep_bilateral_whiten_step",
           "deep_bilateral_whiten_step_plain",
           "deep_bilateral_whiten_step_ref"]

#: the launch counter of kernel A's deep step in halo mode
HALO_KERNEL = "whiten_step_halo"
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
                write_plane, store, nxt):
    """Plain kernel A deep step: the folds in float32 from the carry (any
    dtype), the white and ``recon`` stored as ``store``, ``c_next`` as
    ``nxt``, counted under the store's counter."""
    _build.PLAIN_CALLS[_build.counter(KERNEL, store)] += 1
    _check_args(carry, recon, write_plane)
    thr = torch.as_tensor(threshold, dtype=threshold_dtype(store),
                          device=carry.device).reshape(-1)
    thr = thr.expand(carry.shape[0])[:, None, None]
    # below float32 in float32 from the carry, rounded on store, as the
    # JAX package's low-precision stream does
    white, c_next = whiten_scale_plain(widen(carry), thr, weight, sf, scale,
                                       soft, masked)
    white, c_next = white.to(store), c_next.to(nxt)
    if recon is not None:
        recon.add_(white)
    return (white if write_plane else None), recon, c_next


def deep_whiten_step_plain(carry: torch.Tensor,
                           recon: Optional[torch.Tensor],
                           threshold: torch.Tensor, *, sf: ScalingFunction,
                           scale: int, weight: float, soft: bool = True,
                           masked: bool = False, write_plane: bool = True,
                           halo: int = 0):
    """Plain PyTorch version of :func:`deep_whiten_step` (any dtype or
    device; below float32 the bfloat16 form's rounding; halo mode in
    float32 and float64); like the kernel it adds into ``recon`` in
    place."""
    if halo:
        _build.PLAIN_CALLS[HALO_KERNEL] += 1
        thr = torch.as_tensor(threshold, dtype=carry.dtype,
                              device=carry.device).reshape(-1)
        return _step_halo_plain(
            carry, recon, thr.expand(carry.shape[0])[:, None, None], sf,
            scale, weight, soft, masked, write_plane, halo)
    return _step_plain(carry, recon, threshold, sf, scale, weight, soft,
                       masked, write_plane, carry.dtype, carry.dtype)


def halo_step_plans(B: int, H: int, W: int, scale: int, hw: int):
    """The plans of kernel A's two passes in halo mode on a band of ``H``
    interior rows: the first over the ``H + R`` rows whose detail the
    power smooth reads (source ``H + 2R`` rows), the second over the
    interior (source the ``H + R`` detail rows), ``R = 2·hw·2^scale``."""
    D = 1 << scale
    R = 2 * hw * D
    return (step_plan(B, H + R, W, D, hw, src_rows=H + 2 * R),
            step_plan(B, H, W, D, hw, src_rows=H + R))


def _launch_step_halo(carry, c_next, detail, white, recon, thr, weight,
                      masked, soft, sf, scale, halo):
    lib = _lib_step()
    B, _, W = carry.shape
    H = c_next.shape[1]
    p1, p2 = halo_step_plans(B, H, W, scale, sf.half_width)
    taps = (ctypes.c_double * len(sf.taps))(*sf.taps)

    def plan_args(p):
        return (p.seg, p.grid[0], p.grid[1], p.grid[2], p.smem_bytes,
                p.index_bits)

    code = lib.wt_whiten_step_halo_f32(
        _ptr(carry), _ptr(c_next), _ptr(detail), _ptr(white), _ptr(recon),
        0 if recon is None else 2, _ptr(thr), float(weight),
        int(bool(masked)), int(bool(soft)), taps, len(sf.taps), B, H, W,
        1 << scale, halo, *plan_args(p1), *plan_args(p2),
        _build.stream_ptr(carry.device))
    _build.check(lib, code, "whiten_step_halo")
    _build.LAUNCHES[HALO_KERNEL] += 1


def deep_whiten_step(carry: torch.Tensor, recon: Optional[torch.Tensor],
                     threshold: torch.Tensor, *, sf: ScalingFunction,
                     scale: int, weight: float, soft: bool = True,
                     masked: bool = False, write_plane: bool = True,
                     halo: int = 0):
    """One WOW scale at dilation ``2^scale``: returns ``(white, recon',
    c_next)`` where ``c_next`` is the next scale's carry.

    ``carry``: ``(B, H, W)``; ``threshold``: ``(B,)`` per-frame
    significance threshold on the carry's device (read only when
    ``masked``).  ``recon`` (or None) is accumulated **in place**,
    ``recon' = recon += white``, which saves the separate read of
    ``white`` an out-of-place sum would cost; ``white`` is None when
    ``write_plane=False`` (then ``recon`` is required).  A CPU carry runs
    :func:`deep_whiten_step_plain`; a float32 or bfloat16 CUDA carry
    runs kernel A's deep form in that dtype; any other raises.

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
            soft=soft, masked=masked, write_plane=write_plane, halo=halo)
    check_kernel_input(carry, sf, "deep_whiten_step", bf16=not halo)
    if halo:
        H = _halo_rows(carry, halo, sf, scale)
        _check_halo_recon(carry, recon, H, write_plane)
        out_shape = (carry.shape[0], H, carry.shape[2])
        detail_shape = (carry.shape[0], H + halo, carry.shape[2])
    else:
        _check_args(carry, recon, write_plane)
        out_shape = detail_shape = carry.shape
    if recon is not None:
        _check_same_dtype(carry, recon, "deep_whiten_step")
        check_kernel_input(recon, sf, "deep_whiten_step", bf16=True)
    thr = torch.as_tensor(threshold, dtype=torch.float32,
                          device=carry.device).reshape(-1)
    thr = thr.expand(carry.shape[0]).contiguous()
    white = (torch.empty(out_shape, dtype=carry.dtype, device=carry.device)
             if write_plane else None)
    c_next = torch.empty(out_shape, dtype=carry.dtype, device=carry.device)
    # float32 scratch, held by name until the launches are queued
    detail = torch.empty(detail_shape, dtype=torch.float32,
                         device=carry.device)
    if halo:
        _launch_step_halo(carry, c_next, detail, white, recon, thr, weight,
                          masked, soft, sf, scale, halo)
    else:
        launch_whiten_step(carry, c_next, detail, white, recon,
                           0 if recon is None else 2, thr, weight, masked,
                           soft, sf, scale)
    return white, recon, c_next


def deep_whiten_step2_split_plain(carry: torch.Tensor,
                                  recon: torch.Tensor, thresholds, *,
                                  sf: ScalingFunction, scale: int, weights,
                                  soft: bool = True, masked=(False, False),
                                  write_plane: bool = True):
    """Plain PyTorch version of :func:`deep_whiten_step2_split`: two plain
    steps, the middle carry kept in float32 (bitwise
    :func:`deep_whiten_step2_plain`), counted as two plain calls of the
    bfloat16 step."""
    thr = _pair_args(carry, recon, thresholds, weights, masked, write_plane)
    w1, _, mid = _step_plain(carry, recon, thr[0], sf, scale,
                             float(weights[0]), soft, bool(masked[0]),
                             write_plane, carry.dtype, torch.float32)
    w2, _, c_next = _step_plain(mid, recon, thr[1], sf, scale + 1,
                                float(weights[1]), soft, bool(masked[1]),
                                write_plane, carry.dtype, carry.dtype)
    return w1, w2, recon, c_next


def deep_whiten_step2_split(carry: torch.Tensor, recon: torch.Tensor,
                            thresholds, *, sf: ScalingFunction, scale: int,
                            weights, soft: bool = True,
                            masked=(False, False), write_plane: bool = True):
    """The bfloat16 pair ``(scale, scale+1)`` as two launches of kernel A's
    bfloat16 deep step, the middle carry stored in float32: the rounding
    of the JAX pair (whose middle carry never leaves VMEM) where kernel
    E's float32 tori do not fit the shared memory (:func:`can_deep2`
    false).  The signature and returns of :func:`deep_whiten_step2`, with
    ``recon`` required (the tail always accumulates).  A CPU carry runs
    :func:`deep_whiten_step2_split_plain`; a bfloat16 CUDA carry the two
    launches (``wt_whiten_step_bf16_f32next``, then
    ``wt_whiten_step_bf16_f32carry``, each counted as ``whiten_step_bf16``);
    any other raises."""
    if not carry.is_cuda:
        return deep_whiten_step2_split_plain(
            carry, recon, thresholds, sf=sf, scale=scale, weights=weights,
            soft=soft, masked=masked, write_plane=write_plane)
    if carry.dtype != torch.bfloat16 or recon is None:
        raise TypeError("deep_whiten_step2_split: a bfloat16 carry and "
                        "recon (the float32-carry pair is bfloat16's)")
    check_kernel_input(carry, sf, "deep_whiten_step2_split", bf16=True)
    check_kernel_input(recon, sf, "deep_whiten_step2_split", bf16=True)
    thr = _pair_args(carry, recon, thresholds, weights, masked, write_plane)
    mid = torch.empty(carry.shape, dtype=torch.float32, device=carry.device)
    c_next = torch.empty_like(carry)
    whites = []
    for k, (src, dst) in enumerate(((carry, mid), (mid, c_next))):
        white = torch.empty_like(carry) if write_plane else None
        detail = torch.empty(carry.shape, dtype=torch.float32,
                             device=carry.device)
        launch_whiten_step(src, dst, detail, white, recon, 2,
                           thr[k].contiguous(), float(weights[k]),
                           bool(masked[k]), soft, sf, scale + k)
        whites.append(white)
    return whites[0], whites[1], recon, c_next


# ---------------------------------------------------------------------
# Kernel E: two deep scales per launch
# ---------------------------------------------------------------------

@dataclass(frozen=True)
class PairPlan:
    """Kernel E's launch, passed to ``csrc/whiten_pair.cu`` as it stands
    (the kernel checks it and launches it): one block per (column class,
    row class pair, frame), ``grid``; ``cluster`` adjacent column classes
    per thread-block cluster, which load and store whole sectors
    together; ``smem_bytes`` per block (four ``2M × 2N`` float32 tori)."""
    cluster: int
    smem_bytes: int
    grid: Tuple[int, int, int]


def pair_plan(B: int, H: int, W: int, scale: int) -> Optional[PairPlan]:
    """Kernel E's launch for the pair ``(scale, scale+1)`` from the shape
    alone, or None where ``D = 2^scale`` does not divide ``H`` and ``W``
    or the tori do not fit the shared memory.  The cluster is 8 blocks
    (one 32-byte sector of column classes) and narrows to ``D/2`` below
    ``D = 16``."""
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
    block's four ``2H/D × 2W/D`` float32 buffers fit the shared memory
    (:func:`pair_plan`).  It depends on the shape only, so the plain
    versions dispatch as the kernels do."""
    if not sf.is_symmetric or sf.half_width > 8:
        return False
    B = carry.shape[0] if carry.ndim == 3 else 1
    return pair_plan(B, *carry.shape[-2:], scale) is not None


def _lib_pair():
    lib = _build.load(PAIR_KERNEL)
    for sfx in ("f32", "bf16"):
        fn = getattr(lib, f"wt_whiten_pair_{sfx}")
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_float] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_longlong] * 6 + [ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _pair_args(carry, recon, thresholds, weights, masked, write_plane):
    _check_args(carry, recon, write_plane)
    if len(weights) != 2 or len(masked) != 2:
        raise ValueError("deep_whiten_step2 takes two weights and two "
                         "masked flags")
    thr = torch.as_tensor(thresholds, dtype=threshold_dtype(carry.dtype),
                          device=carry.device).reshape(2, -1)
    return thr.expand(2, carry.shape[0]).contiguous()


def deep_whiten_step2_plain(carry: torch.Tensor,
                            recon: Optional[torch.Tensor],
                            thresholds: torch.Tensor, *,
                            sf: ScalingFunction, scale: int, weights,
                            soft: bool = True, masked=(False, False),
                            write_plane: bool = True):
    """Plain PyTorch version of :func:`deep_whiten_step2` (any dtype or
    device): two plain steps; like the kernel it adds into ``recon`` in
    place, scale ``s`` first.  Below float32 both steps run in float32
    from the carry, so the middle carry never rounds, and the whites and
    ``c_next2`` round on store (the JAX pair's bfloat16 form)."""
    _build.PLAIN_CALLS[_build.counter(PAIR_KERNEL, carry.dtype)] += 1
    thr = _pair_args(carry, recon, thresholds, weights, masked, write_plane)
    dt = carry.dtype
    whites, cur = [], widen(carry)
    for k in range(2):
        white, cur = whiten_scale_plain(
            cur, thr[k][:, None, None], float(weights[k]), sf, scale + k,
            soft, bool(masked[k]))
        white = white.to(dt)
        if recon is not None:
            recon.add_(white)
        whites.append(white if write_plane else None)
    return whites[0], whites[1], recon, cur.to(dt)


def deep_whiten_step2(carry: torch.Tensor, recon: Optional[torch.Tensor],
                      thresholds: torch.Tensor, *, sf: ScalingFunction,
                      scale: int, weights, soft: bool = True,
                      masked=(False, False), write_plane: bool = True):
    """Two consecutive deep WOW scales ``(scale, scale+1)`` in one pass:
    returns ``(white_s, white_s1, recon', c_next2)``.  ``thresholds``:
    ``(2, B)`` (or ``(2,)``) per-scale, per-frame thresholds on the
    carry's device; ``weights``/``masked``: pairs.  ``recon`` (or None) is
    accumulated in place, ``(recon + white_s) + white_s1``, the order of
    two :func:`deep_whiten_step` calls; the whites are None when
    ``write_plane=False``.  Gate with :func:`can_deep2`.  A CPU carry runs
    :func:`deep_whiten_step2_plain`; a float32 or bfloat16 CUDA carry
    runs kernel E in that dtype; any other raises."""
    if not carry.is_cuda:
        return deep_whiten_step2_plain(
            carry, recon, thresholds, sf=sf, scale=scale, weights=weights,
            soft=soft, masked=masked, write_plane=write_plane)
    check_kernel_input(carry, sf, "deep_whiten_step2", bf16=True)
    thr = _pair_args(carry, recon, thresholds, weights, masked, write_plane)
    if recon is not None:
        _check_same_dtype(carry, recon, "deep_whiten_step2")
        check_kernel_input(recon, sf, "deep_whiten_step2", bf16=True)
    B, H, W = carry.shape
    plan = pair_plan(B, H, W, scale)
    if plan is None:
        raise ValueError("deep_whiten_step2: kernel E does not take this "
                         "shape (use can_deep2 before dispatch)")
    c_next = torch.empty_like(carry)
    w1 = torch.empty_like(carry) if write_plane else None
    w2 = torch.empty_like(carry) if write_plane else None
    lib = _lib_pair()
    taps = (ctypes.c_double * len(sf.taps))(*sf.taps)
    entry = getattr(lib, f"wt_whiten_pair_{_build.dtype_suffix(carry.dtype)}")
    code = entry(
        _ptr(carry), _ptr(c_next), _ptr(w1), _ptr(w2), _ptr(recon), _ptr(thr),
        float(weights[0]), float(weights[1]), int(bool(masked[0])),
        int(bool(masked[1])), int(bool(soft)), taps, len(sf.taps), B, H, W,
        1 << scale, plan.grid[0], plan.grid[1], plan.cluster,
        plan.smem_bytes, _build.stream_ptr(carry.device))
    _build.check(lib, code, "whiten_pair")
    _build.LAUNCHES[_build.counter(PAIR_KERNEL, carry.dtype)] += 1
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
    fac = torch.as_tensor(weight, dtype=plane.dtype,
                          device=plane.device).reshape(-1).expand(B)
    thr = torch.as_tensor(threshold, dtype=plane.dtype,
                          device=plane.device).reshape(-1).expand(B)
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
    _build.PLAIN_CALLS[PLANE_KERNEL] += 1
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
    thr = torch.as_tensor(threshold, dtype=carry.dtype,
                          device=carry.device).reshape(-1)
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
    _build.PLAIN_CALLS[BILATERAL_KERNEL] += 1
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
        kernel_weights(sf), B, H, W, D, ring.rows, ring.seg, ring.grid[0],
        ring.grid[1], ring.smem_bytes, step.seg, step.grid[0], step.grid[1],
        step.smem_bytes, step.grid[2], step.index_bits,
        _build.stream_ptr(carry.device))
    _build.check(lib, code, "bilateral_step")
    _build.LAUNCHES[BILATERAL_KERNEL] += 1
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
    # scratch held by name until the launches are queued
    detail, tm, tq = torch.empty((3, B, H, W), dtype=carry.dtype,
                                 device=carry.device)
    lib = _lib_bilateral()
    taps = (ctypes.c_double * len(sf.taps))(*sf.taps)
    code = lib.wt_bilateral_step_ref_f32(
        _ptr(carry), _ptr(c_next), _ptr(detail), _ptr(tm), _ptr(tq),
        _ptr(white), _ptr(recon), 0 if recon is None else 2, _ptr(thr),
        float(weight), int(bool(masked)), int(bool(soft)), float(var_factor),
        float(scale + 1) if bilateral_scaling else 1.0, taps, len(sf.taps),
        kernel_weights(sf), B, H, W, 1 << scale,
        _build.stream_ptr(carry.device))
    _build.check(lib, code, "bilateral_step_ref")
    _build.LAUNCHES[BILATERAL_REF] += 1
    return white, c_next
