"""WOW — Wavelets Optimized Whitening (reference: watroo/utils.py:105-219).

Counterpart of ``wavelets_tpu/models/wow.py`` for WOW, standard and
bilateral, on a 2-D frame (float64, float32, bfloat16 or float16), a
3-D volume and a ``(B, H, W)`` frame stack (``wow_stack``, per-frame
statistics), with three bodies:

* ``_wow_body_merged`` — standard WOW (whitening, ``h == 0``, no
  ``preserve_variance``), the main path: lazy MAD noise from ``w0 = data
  − smooth(data, 0)`` when some scale is denoised and no noise is given
  (on the card the detail row of one kernel C launch at scale 0, and
  kernel B's median); the scales ``[0, N_FAST)`` (``[0, N_STREAM)`` in
  bfloat16) in one ``fused_wow_group`` call (kernel A), the deeper ones
  from the carry by ``_deep_tail_scales``: a pair ``deep_whiten_step2``
  (kernel E) where ``H >> s ≤ 32`` and kernel E's gate admits it, else
  one ``deep_whiten_step`` (kernel A) per scale;
* ``_wow_body_fused`` — the materialized-plane route of bilateral WOW,
  ``preserve_variance``, the gamma blend (``0 < h < 1``) and the
  ``wow(Coefficients)`` reuse entry: decomposition by kernel C, or by
  kernel F when bilateral, the scales ``[0, N_FAST)`` whitened from the
  pieces by ``fused_whiten_pieces`` and the deeper materialized ones by
  ``deep_whiten_plane`` (both kernel D, with a device factor table and
  the gamma sum), a deferred tail by ``_deep_tail_scales`` (bilateral
  WOW with ``h == 0`` and no ``preserve_variance``: one
  ``deep_bilateral_whiten_step``, kernel G, per scale past the first
  group, the JAX package's route, wavelets_tpu/models/wow.py:961-987);
* ``_wow_body`` — the plain per-scale loop: ``whitening=False``,
  ``h ≥ 1`` (decomposition by kernel C or F on the card), 3-D volumes
  (kernel C's volume pass) and the plain route of the options above.

A stack runs the first two bodies batched (kernels A, C, D, E, F and G
take ``(B, H, W)``, kernel B runs once a frame) by the JAX package's
stack rule (``wow_core``), or a loop of single-frame calls.

Every body ends with the residual divided by its population std (clamped
``≤0 → 1e-15``), the sum of the planes and, for ``h > 0``, the gamma
blend.  Dispatch is by a documented rule, not a fallback: ``fuse=True``
on a float32 tensor goes through the kernels' wrappers (the kernels on a
CUDA tensor, their plain versions on a CPU tensor); ``fuse=False`` or a
float64 tensor runs the plain versions, as the JAX package sends float64
to XLA.  The bilateral σ_e table is read wherever the transform is
bilateral; the power smooth stays plain either way (watroo/utils.py:194).

bfloat16 and float16 follow the JAX package's low-precision dispatch
(wavelets_tpu/models/wow.py:921-941): a bfloat16 frame, or a bfloat16
``(B, H, W)`` stack in serving mode, with ``fuse``, standard WOW and
known noise takes ``_wow_body_merged`` on the bfloat16 forms of kernels
A and E where the JAX package's gate merges it (:func:`_lowp_merges`),
with the float32 route's geometry; every other bfloat16 case and every
float16 case runs the plain bodies in the input dtype on the input's
device, as the JAX package sends them to XLA.
:func:`wow_stack` never merges below float32 (the JAX ``_stack_core``
merges float32 only): its frames run the plain bodies one by one.  The
merged route departs on purpose from the JAX package's bfloat16
arithmetic: it is bfloat16 at the boundary and float32 inside (the
frame read in bfloat16, every pass, carry and the recon's sum in
float32, the whites, the residual plane and the recon rounded once, on
store), each output within bfloat16 rounding of a float32 WOW of the
same frame.  The JAX rule, which rounds every pass and the carry to
bfloat16, missed that by up to 0.25 (rel. L2) in a plane on 4096²
frames of hundreds of counts (PERF.md, section 6).

Paper: Auchère et al. 2023, A&A 670, A66 (reference README.md:111).
"""

from __future__ import annotations

import copy
import numbers
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..api import (DEFAULT_DEVICE, B3spline, Coefficients, _as_tensor,
                   _spec_of)
from ..core.transform import (assemble_pieces, decompose_pieces,
                              normalize_bilateral, synthesize)
from ..ops import hopper_conv, hopper_deep, hopper_wow
from ..ops.conv import low_precision, smooth, weak_scalar
from ..ops.filters import ScalingFunction
from ..ops.hopper_conv import N_FAST
from ..ops.layout import stack_planes
from ..ops.stats import (MAD_TO_SIGMA, _div_scalars, mad_noise,
                         mad_noise_frames, median_abs, significance)
from . import lowp_route

__all__ = ["wow", "wow_core", "wow_stack", "normalize_wow_params", "N_FAST"]

#: the deep pair (kernel E) takes scales ``(s, s+1)`` where the frame has
#: at most this many rows per residue class, ``H >> s`` — the JAX
#: package's dispatch rule (wavelets_tpu/models/wow.py:219-247)
PAIR_MAX_CLASS_ROWS = 32

def _lowp_merges(data: torch.Tensor, sf: ScalingFunction, n_scales: int,
                 lazy: bool, need_planes: bool) -> bool:
    """The JAX package's bfloat16 merged gate (wow.py:921-941,
    ``_can_merge_whiten``): a bfloat16 frame, or a stack with
    ``need_planes=False``, no lazy masked noise, and a shape the JAX
    plan merges (:func:`~.lowp_route.lowp_merges_shape`).  Float16 never
    merges: the JAX gate admits float32 and bfloat16 only."""
    if data.dtype != torch.bfloat16 or lazy:
        return False
    if data.ndim == 3 and need_planes:
        return False
    return lowp_route.lowp_merges_shape(*data.shape[-2:], sf, n_scales)


def normalize_wow_params(spec, n_scales, weights, denoise_coefficients,
                         bilateral, h, n_dims, min_extent=None):
    """Static parameter normalization shared by the WOW front doors: auto
    scale count from the smallest extent (watroo/utils.py:122-127), clamp
    to the σ_e table length with the reference's warning (:135-138),
    weight / denoise list padding (:160-170), and bilateral σ-list
    normalization (:140-146).

    ``min_extent=None`` skips the auto-derivation/max clamp.  Returns
    ``(n_scales, weights, denoise, sigma_bilateral)`` with the lists as
    float tuples of length ``n_scales + 1``."""
    denoise_coefficients = list(denoise_coefficients)
    if min_extent is not None:
        max_scales = int(np.round(
            np.log2(min_extent) - np.log2(len(spec.taps))))
        if n_scales is None:
            n_scales = (max_scales if h < 1
                        else len(denoise_coefficients))
        elif n_scales > max_scales:
            n_scales = max_scales
    table_len = len(spec.sigma_e(n_dims, bilateral is not None))
    if len(denoise_coefficients) >= table_len:
        warnings.warn(
            "Required number of scales larger than the maximum for "
            f"scaling function. Using {table_len}.")
        n_scales = table_len
    sigma_bilateral = normalize_bilateral(bilateral, n_scales)
    w = list(copy.copy(weights))
    if len(w) <= n_scales:
        w.extend([1] * (n_scales - len(w) + 1))
    d = denoise_coefficients
    if len(d) < n_scales:
        d.extend([0] * (n_scales - len(d)))
    if len(d) == n_scales:
        d.extend([1])
    return (n_scales,
            tuple(float(x) for x in w[:n_scales + 1]),
            tuple(float(x) for x in d[:n_scales + 1]),
            sigma_bilateral)


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to wavelets_tpu_torch yet "
        f"(ROADMAP.md queue A: {item})")


def _check_slice(data, axes):
    """What ``data`` is to WOW → ``"frame"`` (2-D), ``"volume"`` (3-D
    transformed over all three axes) or ``"stack"`` (``(B, H, W)`` with
    ``axes=(1, 2)``); raise for every option outside the ported slice, on
    every device: no option may run without its kernel."""
    if data.dtype not in (torch.float64, torch.float32, torch.bfloat16,
                          torch.float16):
        raise TypeError(f"WOW takes a floating-point frame, not {data.dtype}")
    spatial = (None if axes is None
               else tuple(a % max(data.ndim, 1) for a in axes))
    if data.ndim == 2 and spatial in (None, (0, 1)):
        return "frame"
    if data.ndim == 3 and spatial in (None, (0, 1, 2)):
        return "volume"
    if data.ndim == 3 and spatial == (1, 2):
        return "stack"
    raise ValueError(f"WOW takes a 2-D frame, a 3-D volume (axes=None) or "
                     f"a (B, H, W) stack (axes=(1, 2)), not {data.ndim}-D "
                     f"data with axes={axes}")


def _per_frame(fn, x, batched):
    """``fn`` of ``x``, or with ``batched`` of each frame of the stack
    ``x`` alone → ``(B,)``: a frame of a stack gets the bits its
    statistics have as a single frame (one reduction over the same
    contiguous plane), per-frame statistics being wow_stack's semantics
    (a loop of single-frame ``wow`` calls)."""
    if not batched:
        return fn(x)
    return torch.stack([fn(x[b]) for b in range(x.shape[0])])


def _frame_bcast(t, batched):
    """A per-frame ``(B,)`` statistic as ``(B, 1, 1)`` against the
    stack; a single frame's as it is."""
    return t.reshape(-1, 1, 1) if batched else t


def _frame_noise(noise, batched, like):
    """Noise as a float32 tensor on ``like``'s device: ``(B,)`` for a
    stack (a scalar broadcast to every frame, wavelets_tpu/models/
    wow.py:1260-1265), 0-d for one frame."""
    noise = tracing.as_tensor(noise, dtype=torch.float32, device=like.device,
                              site="noise")
    if batched:
        noise = noise.reshape(-1).expand(like.shape[-3]).contiguous()
    return noise


def _threshold_fn(noise, sigma_e, denoise_coefficients):
    """``thr_of(k)``: the significance threshold of scale ``k`` as a
    tensor of ``noise``'s shape on its device, 0 for an undenoised scale.
    Guarded: sigma_e may be shorter than n_scales, and the reference
    never touches sigma_e[k] for undenoised scales
    (watroo/wavelets.py:136)."""
    def thr_of(k):
        if denoise_coefficients[k] == 0:
            return torch.zeros_like(noise)
        return (denoise_coefficients[k] * float(sigma_e[k])) * noise
    return thr_of


def _deep_tail_scales(carry, recon, thr_of, sf, start, n_scales, weights,
                      denoise_coefficients, soft_threshold, kernels,
                      write_planes=True, bilateral=None,
                      bilateral_scaling=False, white_dtype=None):
    """Whiten scales ``start .. n_scales−1`` from the smooth ``carry``
    (one frame), adding into ``recon`` in place.  A bilateral chain takes
    one ``deep_bilateral_whiten_step`` (kernel G) per scale: the pair and
    kernel A refuse bilateral, as ``can_deep2``/``can_deep`` do in the JAX
    package (wavelets_tpu/models/wow.py:272-294).  Otherwise a pair
    ``(s, s+1)`` runs as one ``deep_whiten_step2`` (kernel E) where ``H >>
    s ≤ 32`` and kernel E's gate admits the shape; elsewhere, and where
    the gate refuses, each scale is one ``deep_whiten_step`` (kernel A),
    the JAX package's rule when ``can_deep2`` is false
    (wavelets_tpu/ops/pallas_deep.py:688-710).  The bfloat16 route
    (``white_dtype`` bfloat16: a float32 carry and recon, bfloat16
    whites) takes the same scales: the route is float32 inside, so a pair
    is bitwise its two steps.  ``kernels`` selects the wrappers over
    their plain versions.  ``carry`` and ``recon`` are one frame ``(H,
    W)`` or a stack ``(B, H, W)`` with ``thr_of(s)`` per frame ``(B,)``.
    Returns ``(rows, residual)``."""
    step = (hopper_deep.deep_whiten_step if kernels
            else hopper_deep.deep_whiten_step_plain)
    pair = (hopper_deep.deep_whiten_step2 if kernels
            else hopper_deep.deep_whiten_step2_plain)
    bil_step = (hopper_deep.deep_bilateral_whiten_step if kernels
                else hopper_deep.deep_bilateral_whiten_step_plain)
    with tracing.span("wt.deep_tail"):
        batched = carry.ndim == 3
        rows = []
        carry, acc = ((carry, recon) if batched
                      else (carry[None], recon[None]))

        def row(white):
            return white if batched else white[0]

        def masked(k):
            return denoise_coefficients[k] != 0

        s = start
        while s < n_scales:
            if bilateral is not None:
                white, carry = bil_step(
                    carry, thr_of(s).reshape(-1), sf=sf, scale=s,
                    var_factor=float(bilateral[s]) ** 2, weight=weights[s],
                    soft=soft_threshold, masked=masked(s),
                    bilateral_scaling=bilateral_scaling, recon=acc,
                    write_plane=write_planes)
                whites = [white]
            elif (s + 1 < n_scales
                    and (carry.shape[-2] >> s) <= PAIR_MAX_CLASS_ROWS
                    and hopper_deep.can_deep2(carry, sf, s)):
                w1, w2, _, carry = pair(
                    carry, acc, torch.stack([thr_of(s), thr_of(s + 1)])
                    .reshape(2, -1), sf=sf, scale=s,
                    weights=(weights[s], weights[s + 1]),
                    soft=soft_threshold, masked=(masked(s), masked(s + 1)),
                    write_plane=write_planes, white_dtype=white_dtype)
                whites = [w1, w2]
            else:
                white, _, carry = step(
                    carry, acc, thr_of(s).reshape(-1), sf=sf, scale=s,
                    weight=weights[s], soft=soft_threshold, masked=masked(s),
                    write_plane=write_planes, white_dtype=white_dtype)
                whites = [white]
            if write_planes:
                rows.extend(row(w) for w in whites)
            s += len(whites)
        return rows, row(carry)


def _pop_std(x: torch.Tensor) -> torch.Tensor:
    """The population std of ``x`` as ``jnp.std`` computes it: below
    float32 the variance in float32, rounded to ``x``'s dtype, then the
    square root in that dtype."""
    if not low_precision(x.dtype):
        return torch.std(x, correction=0)
    x32 = x.float()
    var = torch.mean((x32 - torch.mean(x32)) ** 2)
    return torch.sqrt(var.to(x.dtype))


def _residual_std(residual, batched=False):
    """``(std, clamped std)`` of the residual plane, per frame
    ``(B, 1, 1)`` with ``batched``: the population std (``jnp.std``),
    clamped ``≤0 → 1e-15`` for the whitening (watroo/utils.py:185-191)."""
    std = _frame_bcast(_per_frame(_pop_std, residual, batched), batched)
    return std, torch.where(std <= 0, 1e-15, std)


def _gamma_blend(recon, gamma_scaled, gamma, gamma_min, gamma_max, h,
                 batched=False, rops=None):
    """Gamma-blend tone mapping (watroo/utils.py:205-217), its bounds per
    frame with ``batched``, or from ``rops`` (the sharded engine's
    collectives) where given."""
    def bound(fn):
        return _frame_bcast(_per_frame(fn, gamma_scaled, batched), batched)

    gmin = ((rops.min(gamma_scaled) if rops else bound(torch.min))
            if gamma_min is None
            else torch.tensor(gamma_min, dtype=recon.dtype))
    gmax = ((rops.max(gamma_scaled) if rops else bound(torch.max))
            if gamma_max is None
            else torch.tensor(gamma_max, dtype=recon.dtype))
    gs = (gamma_scaled - gmin) / (gmax - gmin)
    gs = torch.clamp(gs, 0.0, 1.0) ** weak_scalar(1.0 / gamma, gs.dtype)
    return (1 - h) * recon + h * gs


def _wow_body_merged(data, noise, has_noise, sf, n_scales, weights,
                     denoise_coefficients, soft_threshold, kernels,
                     need_planes=True):
    """The WOW pass over one frame, or a ``(B, H, W)`` stack with
    per-frame statistics (noise ``(B,)``, a scalar broadcast; thresholds
    ``(g, B)``; the residual's std per frame) → ``(recon, rows)``;
    ``kernels`` selects the kernels' wrappers over their plain
    versions.

    One group of the first ``min(n_scales, depth)`` scales (kernel A's
    group form; ``depth`` is its kernel's: :data:`N_FAST` for the float32
    tile, :data:`~.hopper_conv.N_STREAM` for the bfloat16 streamed
    group), then the deep steps and pairs of ``_deep_tail_scales``.  A
    bfloat16 ``data`` (known noise only, :func:`_lowp_merges`) is float32
    inside: the group reads the bfloat16 frame, every carry, the
    thresholds and the recon's sum are float32, and the whites, the
    residual plane and the recon are rounded to bfloat16 once, on
    store."""
    group = (hopper_conv.fused_wow_group if kernels
             else hopper_conv.fused_wow_group_plain)
    batched = data.ndim == 3
    lowp = low_precision(data.dtype)
    store = data.dtype
    sigma_e = sf.sigma_e(2, False)
    if not has_noise and any(
        d != 0 for d in denoise_coefficients[:n_scales]
    ):
        with tracing.span("wt.noise"):
            # on the kernels' route the finest detail is one launch of
            # kernel C (its carry row is dropped), bitwise the plain form
            w0 = (hopper_conv.fused_group(data, 1, sf)[0] if kernels
                  else data - smooth(data, sf, scale=0, axes=(-2, -1)))
            noise = (mad_noise_frames if batched else mad_noise)(
                w0, float(sigma_e[0]), fuse=kernels)
            # C's two planes, or the plain plane, are not held through
            # the scales: the group allocates its own
            del w0
    if batched:
        noise = _frame_noise(noise, True, data)
    elif lowp:
        noise = noise.float()
    thr_of = _threshold_fn(noise, sigma_e, denoise_coefficients)

    n_fast = min(n_scales, hopper_conv.N_STREAM if lowp else N_FAST)
    out_rows, recon, carry = [], None, data
    if n_fast:
        rows, recon = group(
            data, weights[:n_fast],
            torch.stack([thr_of(k) for k in range(n_fast)]), n_fast, sf,
            soft=soft_threshold,
            masked=tuple(d != 0 for d in denoise_coefficients[:n_fast]),
            need_cube=need_planes)
        out_rows.extend(rows[:-1])
        carry = rows[-1]
        # recon accumulates in place inside the deep steps
        deep_rows, carry = _deep_tail_scales(
            carry, recon, thr_of, sf, n_fast, n_scales, weights,
            denoise_coefficients, soft_threshold, kernels, need_planes,
            white_dtype=store)
        out_rows.extend(deep_rows)

    with tracing.span("wt.residual"):
        _, lp = _residual_std(carry, batched)
        c = carry * torch.div(torch.tensor(weights[n_scales], dtype=lp.dtype),
                              lp)
        recon = c if recon is None else recon + c
        # bfloat16 at the boundary: the residual plane and the float32
        # recon rounded once
        out_rows.append(c.to(store))
        return recon.to(store), out_rows


def _wow_body_fused(pieces, layout, tail, noise, has_noise, sf, n_scales,
                    weights, denoise_coefficients, soft_threshold,
                    bilateral=None, bilateral_scaling=False,
                    preserve_variance=False, h=0.0, gamma=3.2,
                    gamma_min=None, gamma_max=None, need_planes=True,
                    planes_layout="cube"):
    """WOW of one float32 frame from its decompose ``pieces``/``layout``
    (core.transform.decompose_pieces), through the kernels' wrappers.
    The scales ``[0, N_FAST)`` go to ``fused_whiten_pieces``, the deeper
    materialized ones to ``deep_whiten_plane`` (kernel D for both:
    ``preserve_variance``'s power norm ``w·sqrt(mean(c²))`` rides in the
    device factor table, the gamma sum of the masked planes in the
    kernel's gamma output, the deep planes' recon add in its epilogue).  Scales past the pieces arrive deferred,
    ``tail = (carry, n_tail)``, and run ``_deep_tail_scales`` without
    materializing their detail planes; ``preserve_variance`` and the
    gamma blend need every plane, so they take no tail.  ``bilateral``
    (the σ_b tuple, or None) selects the bilateral σ_e table and the
    bilateral chain of the tail.

    Pieces of a ``(B, H, W)`` stack (``(rows, B, H, W)`` cubes) take
    per-frame statistics: the noise (kernel B once a frame), thresholds
    and ``preserve_variance``'s factors per (scale, frame), the residual's
    std and the gamma bounds per frame; the planes come back as the
    batch-major cube ``(B, n_scales+1, H, W)``, rows ``0 .. N_FAST−1``
    written in place by kernel D's pieces form, the deeper ones copied
    into their rows (the JAX package's ``dynamic_update_slice``)."""
    batched = pieces[0].ndim == 4

    def plane(s):
        k, r = layout[s]
        return pieces[k][r]

    tail_start = n_scales - tail[1] if tail is not None else n_scales
    if tail is not None and (preserve_variance or h > 0):
        raise ValueError("preserve_variance and the gamma blend need every "
                         "plane materialized (no deferred tail)")
    sigma_e = sf.sigma_e(2, bilateral is not None)
    if not has_noise and any(
        d != 0 for d in denoise_coefficients[:n_scales]
    ):
        with tracing.span("wt.noise"):
            noise = (mad_noise_frames if batched else mad_noise)(
                plane(0), float(sigma_e[0]))
    noise = _frame_noise(noise, batched, plane(0))
    thr_of = _threshold_fn(noise, sigma_e, denoise_coefficients)

    def factor(s):
        # the per-scale power norm sqrt(mean(c²)) (watroo/utils.py:178-184),
        # per frame for a stack; else the weight as a fill on the frame's
        # device: a copy from host memory would wait for the calls queued
        # before this one
        if preserve_variance:
            return weights[s] * _per_frame(
                lambda c: torch.sqrt(torch.mean(c ** 2)), plane(s), batched)
        return torch.full((), float(weights[s]), dtype=torch.float32,
                          device=noise.device)

    def one(t):
        # a single frame as the kernels' batch of one
        return t if batched else t[None]

    n_fast = min(n_scales, N_FAST, tail_start)
    outs = hopper_wow.fused_whiten_pieces(
        pieces if batched else tuple(p[:, None] for p in pieces),
        torch.stack([factor(s) for s in range(n_fast)]),
        torch.stack([thr_of(s) for s in range(n_fast)]), sf, n_fast,
        tuple(layout[:n_fast]), soft=soft_threshold,
        write_planes=need_planes, batch_major=batched,
        out_rows_total=n_scales + 1 if batched else 0, write_gamma=h > 0)
    # a stack's planes: the batch-major cube, its fast rows written
    cube = outs[0] if batched and need_planes else None
    recon = outs[1] if batched else outs[1][0]
    gamma_scaled = None
    if h > 0:
        gamma_scaled = outs[2] if batched else outs[2][0]
    out_rows = ([outs[0][s, 0] for s in range(n_fast)]
                if need_planes and not batched else [])

    def keep(s, row):
        if cube is not None:
            cube[:, s].copy_(row)
        elif need_planes:
            out_rows.append(row)

    for s in range(n_fast, tail_start):
        # recon += white rides the kernel's epilogue: the same float32 add
        # in the same scale order as an out-of-place sum
        white = hopper_deep.deep_whiten_plane(
            one(plane(s)), thr_of(s).reshape(-1), sf=sf, scale=s,
            weight=factor(s), soft=soft_threshold,
            masked=denoise_coefficients[s] != 0,
            gamma=None if gamma_scaled is None else one(gamma_scaled),
            recon=one(recon), write_plane=need_planes)
        if need_planes:
            keep(s, white if batched else white[0])
    if tail is not None:
        deep_rows, residual = _deep_tail_scales(
            tail[0], recon, thr_of, sf, tail_start, n_scales, weights,
            denoise_coefficients, soft_threshold, True, need_planes,
            bilateral, bilateral_scaling)
        for s, row in enumerate(deep_rows, start=tail_start):
            keep(s, row)
    else:
        residual = plane(n_scales)
    with tracing.span("wt.residual"):
        std, lp = _residual_std(residual, batched)
        # the residual's power norm is the unclamped std
        # (watroo/utils.py:182)
        pn = std if preserve_variance else torch.ones((), dtype=std.dtype)
        c = residual * (weights[n_scales] * pn / lp)
        keep(n_scales, c)
        recon = recon + c
    if gamma_scaled is not None:
        recon = _gamma_blend(recon, gamma_scaled + residual, gamma,
                             gamma_min, gamma_max, h, batched)
    if not need_planes:
        return recon, None
    if batched:
        return recon, cube
    if planes_layout == "rows":
        return recon, tuple(out_rows)
    return recon, stack_planes(out_rows)


class LocalReduceOps:
    """The single-device global reductions of :func:`_wow_body` over a
    whole plane (JAX ``LocalReduceOps``); the sharded engine substitutes
    collective ones (``parallel.sharded.ShardedReduceOps``), so the body
    is written once for both.  ``fuse`` sends the median through kernel
    B's wrapper, else its plain version."""

    def __init__(self, fuse: bool = True):
        self.fuse = fuse

    def median_abs(self, x):
        return median_abs(x, self.fuse)

    def mean(self, x):
        return torch.mean(x)

    def std(self, x):
        return _pop_std(x)

    def min(self, x):
        return torch.min(x)

    def max(self, x):
        return torch.max(x)


def _wow_body(planes, noise, has_noise, sf, n_scales, weights, whitening,
              denoise_coefficients, soft_threshold, preserve_variance, gamma,
              gamma_min, gamma_max, h, fuse=True, planes_layout="cube",
              bilateral=False, smooth_fn=None, rops=None, n_dim=None):
    """The per-scale whitening loop (watroo/utils.py:157-219) over the
    coefficient cube ``(n_scales+1, H, W)`` in plain PyTorch; the lazy
    MAD noise goes through kernel B's wrapper unless ``fuse=False``.
    ``bilateral`` is a flag: it selects the bilateral σ_e table.
    ``smooth_fn(x, s)``, ``rops`` (the reductions) and ``n_dim`` (the
    σ_e table's dimensionality) default to the single-device ones; the
    sharded engine passes halo-exchange smoothing and collective
    reductions over a block's planes ``(n_scales+1, [B,] h, w)``."""
    if smooth_fn is None:
        smooth_fn = lambda x, s: smooth(x, sf, scale=s)  # noqa: E731
    if rops is None:
        rops = LocalReduceOps(fuse)
    sigma_e = sf.sigma_e(planes.ndim - 1 if n_dim is None else n_dim,
                         bilateral)
    if not has_noise and any(
        d != 0 for d in denoise_coefficients[:n_scales]
    ):
        with tracing.span("wt.noise"):
            noise = _div_scalars(rops.median_abs(planes[0]), MAD_TO_SIGMA,
                                 float(sigma_e[0]))
    one = torch.ones((), dtype=planes.dtype)
    gamma_scaled = torch.zeros_like(planes[0]) if h > 0 else None
    out_planes = []
    for s in range(n_scales + 1):
        c = planes[s]
        power = c * c
        if preserve_variance:
            power_norm = (rops.std(c) if s == n_scales
                          else torch.sqrt(rops.mean(power)))
        else:
            power_norm = one
        if s == n_scales:
            if whitening and h < 1:
                lp = rops.std(c)
                local_power = torch.where(lp <= 0, 1e-15, lp)
            else:
                local_power = one
        else:
            if whitening and h < 1:
                lp = smooth_fn(power, s)
                local_power = torch.sqrt(torch.where(lp <= 0, 1e-15, lp))
            else:
                local_power = one
            if denoise_coefficients[s] != 0:
                c = c * significance(c, denoise_coefficients[s], noise,
                                     float(sigma_e[s]), soft_threshold)
        if h > 0:
            gamma_scaled = gamma_scaled + c
        c = c * (weak_scalar(float(weights[s]), c.dtype) * power_norm
                 / local_power)
        out_planes.append(c)

    if planes_layout == "rows":
        out = tuple(out_planes)
        recon = out_planes[0]
        for c in out_planes[1:]:
            recon = recon + c
    else:
        out = stack_planes(out_planes)
        recon = synthesize(out)
    if h > 0:
        recon = _gamma_blend(recon, gamma_scaled, gamma, gamma_min,
                             gamma_max, h, rops=rops)
    return recon, out


def wow_core(
    data: torch.Tensor,
    noise: torch.Tensor,
    *,
    sf: ScalingFunction,
    n_scales: int,
    weights: Tuple[float, ...],
    whitening: bool,
    denoise_coefficients: Tuple[float, ...],
    bilateral: Optional[Tuple[float, ...]],
    bilateral_scaling: bool,
    soft_threshold: bool,
    preserve_variance: bool,
    gamma: float,
    gamma_min: Optional[float],
    gamma_max: Optional[float],
    h: float,
    has_noise: bool,
    axes: Optional[Tuple[int, ...]] = None,
    fuse: bool = True,
    need_planes: bool = True,
    planes_layout: str = "cube",
):
    """Decomposition + whitening from raw data → ``(recon, planes)``, with
    the JAX package's signature.  ``data`` is a 2-D frame, a 3-D volume
    (``axes=None``, transformed over all three axes) or a ``(B, H, W)``
    frame stack (``axes=(1, 2)``, per-frame statistics).  ``noise`` is a
    tensor on ``data``'s device (read when ``has_noise``): 0-d, or
    ``(B,)`` for a stack.  ``fuse=False`` runs the kernels' plain
    versions.  ``need_planes=False`` skips the whitened plane writes and
    returns ``(recon, None)``; ``planes_layout="rows"`` returns a frame's
    or a volume's planes as a tuple instead of a stacked cube (a stack's
    are always the cube ``(B, n_scales+1, H, W)``).

    Dispatch (wavelets_tpu/models/wow.py:961-1003, :1166-1204): standard
    WOW of a frame takes ``_wow_body_merged``; bilateral WOW,
    ``preserve_variance`` or ``0 < h < 1`` of a frame on the kernels'
    route take ``_wow_body_fused`` over kernel C's or kernel F's pieces,
    bilateral WOW with ``h == 0`` and no ``preserve_variance`` with the
    scales past the first group deferred to kernel G; a stack takes the
    merged body only in serving mode (``need_planes=False``) with known
    noise for standard WOW, and ``_wow_body_fused`` for everything else
    with whitening and ``h < 1``, both batched, when the kernels' route
    is on (``fuse`` and float32), else a loop of single-frame
    ``wow_core`` calls (the JAX package's per-frame ``vmap``);
    ``whitening=False``, ``h ≥ 1``, a volume and the plain route of the
    options above take ``_wow_body`` over the decomposition (kernel C's
    volume pass for a float32 volume).  Below float32 the JAX package's
    low-precision rule holds (:func:`_lowp_merges`: the bfloat16 merged
    body, or the plain bodies in the input dtype; a stack that does not
    merge runs per-frame plain calls, the JAX package's per-frame XLA
    ``vmap``)."""
    mode = _check_slice(data, axes)
    lowp = low_precision(data.dtype)
    kernels = bool(fuse) and data.dtype == torch.float32
    bil = dict(bilateral=bilateral, bilateral_scaling=bilateral_scaling)
    standard = (whitening and h == 0 and not preserve_variance
                and bilateral is None)
    fast = kernels and whitening and h < 1
    lazy = not has_noise and any(
        d != 0 for d in denoise_coefficients[:n_scales])
    if lowp:
        # the JAX low-precision rule: the bfloat16 merged body or plain
        merged = (bool(fuse) and standard and mode != "volume"
                  and _lowp_merges(data, sf, n_scales, lazy, need_planes))
    else:
        merged = standard and (mode == "frame" or (
            mode == "stack" and not need_planes and not lazy))
    if mode == "stack" and not (merged if lowp else fast):
        with tracing.span("wt.body.frames"):
            return _stack_frames(data, noise, need_planes, dict(
                sf=sf, n_scales=n_scales, weights=weights,
                whitening=whitening,
                denoise_coefficients=denoise_coefficients, **bil,
                soft_threshold=soft_threshold,
                preserve_variance=preserve_variance, gamma=gamma,
                gamma_min=gamma_min, gamma_max=gamma_max, h=h,
                has_noise=has_noise, fuse=fuse and not lowp))
    sp_axes = None if mode == "volume" else (-2, -1)
    if merged:
        with tracing.span("wt.body.merged"):
            recon, rows = _wow_body_merged(
                data, noise, has_noise, sf, n_scales, weights,
                denoise_coefficients, soft_threshold, kernels or lowp,
                need_planes=need_planes)
            if mode == "stack":
                out = torch.stack(rows, dim=1) if need_planes else None
            else:
                out = rows if planes_layout == "rows" else stack_planes(rows)
    elif fast and mode != "volume":
        # preserve_variance and the gamma blend need every plane: no tail
        defer = h == 0 and not preserve_variance
        with tracing.span("wt.body.fused"):
            with tracing.span("wt.decompose"):
                out = decompose_pieces(data, n_scales, sf, axes=sp_axes,
                                       defer_tail=defer, **bil)
            pieces, layout, tail = out if defer else (*out, None)
            recon, out = _wow_body_fused(
                pieces, layout, tail, noise, has_noise, sf, n_scales,
                weights, denoise_coefficients, soft_threshold, **bil,
                preserve_variance=preserve_variance, h=h, gamma=gamma,
                gamma_min=gamma_min, gamma_max=gamma_max,
                need_planes=need_planes, planes_layout=planes_layout)
    else:
        with tracing.span("wt.body.plain"):
            with tracing.span("wt.decompose"):
                pieces, layout = decompose_pieces(
                    data, n_scales, sf, axes=sp_axes, fuse=kernels, **bil)
            recon, out = _wow_body(
                assemble_pieces(pieces, layout),
                # the plain bodies run in the frame's dtype (JAX's XLA rule)
                noise.to(data.dtype) if lowp else noise, has_noise, sf,
                n_scales, weights, whitening, denoise_coefficients,
                soft_threshold, preserve_variance, gamma, gamma_min,
                gamma_max, h, fuse=kernels, planes_layout=planes_layout,
                bilateral=bilateral is not None)
    if not need_planes:
        return recon, None
    return recon, (tuple(out) if planes_layout == "rows"
                   and mode != "stack" else out)


def _stack_frames(data, noise, need_planes, statics):
    """A ``(B, H, W)`` stack as a loop of single-frame :func:`wow_core`
    calls (the JAX package's per-frame ``vmap`` fallback,
    wavelets_tpu/models/wow.py:1196-1204) → ``(recon (B, H, W), planes
    (B, n_scales+1, H, W) or None)``."""
    runs = [wow_core(data[b], noise[b], need_planes=need_planes, **statics)
            for b in range(data.shape[0])]
    recon = torch.stack([r for r, _ in runs])
    return recon, (torch.stack([p for _, p in runs]) if need_planes
                   else None)


def _wow_from_planes_core(planes, noise, *, sf, n_scales, weights, whitening,
                          denoise_coefficients, soft_threshold,
                          preserve_variance, gamma, gamma_min, gamma_max, h,
                          has_noise, fuse=True, bilateral=False):
    """Whitening from a precomputed coefficient set (the
    ``wow(Coefficients)`` reuse entry, watroo/utils.py:128-133,152-155).
    ``planes`` is the ``(n_scales+1, H, W)`` cube or a tuple of
    ``n_scales+1`` per-scale rows (the form ``wow`` emits), which pass
    through without stacking.  A float32 2-D set with whitening on and
    ``h < 1`` rides ``_wow_body_fused`` with the planes as decompose
    pieces (the cube is one piece with ``layout[s] = (0, s)``; rows are
    one piece each, ``layout[s] = (s, 0)``); everything else runs
    ``_wow_body``.  ``bilateral`` is only a flag here (the chain is
    already decomposed): it selects the bilateral σ_e table, through a
    placeholder σ tuple on the fused body as in the JAX package."""
    rows = planes if isinstance(planes, tuple) else None
    first = rows[0] if rows is not None else planes[0]
    if (fuse and whitening and h < 1 and first.dtype == torch.float32
            and first.ndim == 2):
        if rows is not None:
            pieces = tuple(r[None] for r in rows)
            layout = tuple((s, 0) for s in range(n_scales + 1))
        else:
            pieces = (planes,)
            layout = tuple((0, s) for s in range(n_scales + 1))
        with tracing.span("wt.body.fused"):
            return _wow_body_fused(
                pieces, layout, None, noise, has_noise, sf, n_scales,
                weights, denoise_coefficients, soft_threshold,
                bilateral=(1.0,) * (n_scales + 1) if bilateral else None,
                preserve_variance=preserve_variance, h=h, gamma=gamma,
                gamma_min=gamma_min, gamma_max=gamma_max,
                planes_layout="rows")
    with tracing.span("wt.body.plain"):
        cube = stack_planes(list(planes)) if rows is not None else planes
        return _wow_body(
            cube, noise, has_noise, sf, n_scales, weights, whitening,
            denoise_coefficients, soft_threshold, preserve_variance, gamma,
            gamma_min, gamma_max, h,
            fuse=fuse and first.dtype == torch.float32,
            planes_layout="rows" if rows is not None else "cube",
            bilateral=bilateral)


@tracing.entry("wt.wow")
def wow(data,
        scaling_function=B3spline,
        n_scales=None,
        weights=[],
        whitening=True,
        denoise_coefficients=[],
        noise=None,
        bilateral=None,
        bilateral_scaling=False,
        soft_threshold=True,
        preserve_variance=False,
        gamma=3.2,
        gamma_min=None,
        gamma_max=None,
        h=0,
        fuse=True,
        device=DEFAULT_DEVICE):
    """Wavelets Optimized Whitening, signature-compatible with
    ``watroo.utils.wow`` (watroo/utils.py:105-219) plus ``fuse`` and
    ``device``.

    ``data`` is a raw 2-D frame, a 3-D volume (transformed over all three
    axes) or a precomputed :class:`Coefficients` of either (the reuse
    entry, watroo/utils.py:128-133).  A tensor, and the planes
    of a ``Coefficients``, stay on their device; a numpy frame goes to
    ``device``, the card by default.  Returns ``(reconstruction,
    Coefficients)``.
    """
    from_coefficients = isinstance(data, Coefficients)
    if from_coefficients:
        n_scales = len(data) - 1
        first = data[0]
        _check_slice(first, None)
        n_dims = first.ndim
        scaling_function = data.scaling_function.__class__
        min_extent = None
    else:
        if not isinstance(data, (np.ndarray, torch.Tensor)):
            # parity with watroo/utils.py:133
            raise ValueError("Unknown input type")
        if data.ndim not in (2, 3):
            # parity with watroo/utils.py:52
            raise ValueError("Unsupported number of dimensions")
        data = _as_tensor(data, device)
        n_dims = data.ndim
        min_extent = min(data.shape)
    spec = _spec_of(scaling_function)

    n_scales, weights_t, denoise_t, sigma_bilateral = normalize_wow_params(
        spec, n_scales, weights, denoise_coefficients, bilateral, h,
        n_dims, min_extent)

    has_noise = noise is not None
    static = dict(
        sf=spec,
        n_scales=n_scales,
        weights=weights_t,
        whitening=bool(whitening),
        denoise_coefficients=denoise_t,
        soft_threshold=bool(soft_threshold),
        preserve_variance=bool(preserve_variance),
        gamma=float(gamma),
        gamma_min=None if gamma_min is None else float(gamma_min),
        gamma_max=None if gamma_max is None else float(gamma_max),
        h=float(h),
        has_noise=has_noise,
        fuse=fuse)

    if from_coefficients:
        # rows pass through as they are: stacking them here would cost
        # the cube the rows form exists to avoid
        planes = data._rows if data._rows is not None else data.data
        given = noise if has_noise else data.noise
        noise_arr = (tracing.as_tensor(given, dtype=first.dtype,
                                       device=first.device, site="noise")
                     if given is not None
                     else torch.zeros((), dtype=first.dtype,
                                      device=first.device))
        if data.noise is not None:
            static["has_noise"] = True
        recon, out_planes = _wow_from_planes_core(
            planes, noise_arr, bilateral=data.bilateral is not None, **static)
        coeffs = Coefficients(out_planes, data.scaling_function,
                              data.bilateral)
        coeffs.noise = data.noise
        return recon, coeffs

    noise_arr = _noise_arg(noise, data)
    recon, out_planes = wow_core(
        data, noise_arr,
        bilateral=sigma_bilateral,
        bilateral_scaling=bool(bilateral_scaling),
        planes_layout="rows",
        **static)
    coeffs = Coefficients(out_planes, scaling_function(n_dims), bilateral)
    coeffs.noise = noise
    return recon, coeffs


def _noise_arg(noise, data):
    """``wow``'s noise as the 0-d tensor ``wow_core`` takes, on the
    frame's device: float64 for a float64 frame, else float32 (the
    thresholds' dtype; the plain bodies below float32 round it to the
    frame's dtype).  A known scalar is a fill kernel with the value as its
    argument, not a copy from host memory, so the call does not wait for
    the card; an array noise keeps its counted copy (``wt.sync.noise``).
    No noise is a zero."""
    dtype = torch.float64 if data.dtype == torch.float64 else torch.float32
    if noise is None:
        return torch.zeros((), dtype=dtype, device=data.device)
    if isinstance(noise, numbers.Real):
        return torch.full((), float(noise), dtype=dtype, device=data.device)
    return tracing.as_tensor(noise, dtype=dtype, device=data.device,
                             site="noise")


def _stack_core(data, noise_arr, with_coefficients, statics, fuse=True):
    """The batched ``(B, H, W)`` dispatch of :func:`wow_stack` (JAX
    ``_stack_core``, wavelets_tpu/models/wow.py:1166-1204): ``wow_core``
    with ``axes=(1, 2)`` and ``need_planes=with_coefficients``, which
    takes the batched bodies where the kernels' route admits them and the
    per-frame loop elsewhere.  Below float32 every stack runs the
    per-frame loop of plain bodies: the JAX ``_stack_core`` merges
    float32 stacks only (its ``serving_merge``) and its pieces route is
    float32 only, so a bfloat16 stack never takes the bfloat16 kernels
    that a bfloat16 frame takes.  ``noise_arr`` is ``(B,)`` on
    ``data``'s device."""
    return wow_core(data, noise_arr, axes=(1, 2),
                    fuse=fuse and not low_precision(data.dtype),
                    need_planes=with_coefficients, **statics)


@tracing.entry("wt.wow_stack")
def wow_stack(data, noise=None, with_coefficients=True, fuse=True,
              device=DEFAULT_DEVICE, **kwargs):
    """Per-frame WOW over a frame stack ``(B, H, W)``, the batched
    serving path.  Statistics (MAD noise, residual std, the gamma bounds,
    ``preserve_variance``'s norms) are computed per frame, matching a loop
    of single-frame :func:`wow` calls.  Returns ``(recon (B, H, W),
    planes (B, n_scales+1, H, W))``; ``with_coefficients=False`` skips
    the plane writes and returns ``(recon, None)``.

    ``noise`` is None (lazy MAD noise per frame), a scalar (every frame)
    or one value a frame.  Takes the keyword arguments of :func:`wow`
    (the automatic ``n_scales`` from the frame shape); an unknown one
    raises ``TypeError``.  A tensor stays on its device; other input goes
    to ``device``, the card by default.  ``fuse=False`` runs the plain
    versions.  Dispatch: :func:`_stack_core`."""
    data = _as_tensor(data, device)
    if data.ndim != 3:
        raise ValueError("wow_stack expects a (B, H, W) stack")
    scaling_function = kwargs.pop("scaling_function", B3spline)
    spec = _spec_of(scaling_function)
    n_scales = kwargs.pop("n_scales", None)
    h = float(kwargs.pop("h", 0))
    denoise_coefficients = list(kwargs.pop("denoise_coefficients", []))
    weights = list(kwargs.pop("weights", []))
    bilateral = kwargs.pop("bilateral", None)
    n_scales, weights_t, denoise_t, sigma_bilateral = normalize_wow_params(
        spec, n_scales, weights, denoise_coefficients, bilateral, h,
        n_dims=2, min_extent=min(data.shape[1:]))
    gamma_min = kwargs.pop("gamma_min", None)
    gamma_max = kwargs.pop("gamma_max", None)
    has_noise = noise is not None
    statics = dict(
        sf=spec,
        n_scales=n_scales,
        weights=weights_t,
        whitening=bool(kwargs.pop("whitening", True)),
        denoise_coefficients=denoise_t,
        bilateral=sigma_bilateral,
        bilateral_scaling=bool(kwargs.pop("bilateral_scaling", False)),
        soft_threshold=bool(kwargs.pop("soft_threshold", True)),
        preserve_variance=bool(kwargs.pop("preserve_variance", False)),
        gamma=float(kwargs.pop("gamma", 3.2)),
        gamma_min=None if gamma_min is None else float(gamma_min),
        gamma_max=None if gamma_max is None else float(gamma_max),
        h=h,
        has_noise=has_noise,
    )
    if kwargs:
        raise TypeError(f"unexpected arguments: {sorted(kwargs)}")
    B = data.shape[0]
    if has_noise:
        noise_arr = tracing.as_tensor(noise, dtype=data.dtype,
                                      device=data.device,
                                      site="noise").reshape(-1)
        noise_arr = noise_arr.expand(B).contiguous()
    else:
        noise_arr = torch.zeros((B,), dtype=data.dtype, device=data.device)
    return _stack_core(data, noise_arr, with_coefficients, statics, fuse)
