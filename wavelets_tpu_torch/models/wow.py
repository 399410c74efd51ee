"""WOW — Wavelets Optimized Whitening (reference: watroo/utils.py:105-219).

Counterpart of ``wavelets_tpu/models/wow.py`` for standard (non-bilateral)
WOW on one 2-D float32 or float64 frame.  The body mirrors the JAX
package's merged route (``_wow_body_merged`` with the standard branch of
``_deep_tail_scales``), in both of its noise modes:

* lazy MAD noise from ``w0 = data − smooth(data, 0)`` when some scale is
  denoised and no noise is given (kernel B on the card);
* the shallow scales ``[0, n_fast)`` in one ``fused_wow_group`` call,
  the deeper ones one ``deep_whiten_step`` each (kernel A on the card);
  the significance thresholds stay device tensors from the noise
  estimate to the kernels, with no host round trip;
* the residual divided by its population std (clamped ``≤0 → 1e-15``),
  and the sum of the whitened planes.

Dispatch is by a documented rule, not a fallback: ``fuse=True`` on a
float32 tensor goes through the kernels' wrappers (the kernels on a CUDA
tensor, their plain versions on a CPU tensor); ``fuse=False`` or a
float64 tensor runs the plain versions, as the JAX package sends float64
to XLA.  Options outside this slice raise ``NotImplementedError`` on
every device.

Paper: Auchère et al. 2023, A&A 670, A66 (reference README.md:111).
"""

from __future__ import annotations

import copy
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ..api import B3spline, Coefficients, _as_tensor, _spec_of
from ..core.transform import normalize_bilateral
from ..ops import hopper_conv, hopper_deep
from ..ops.conv import smooth
from ..ops.filters import ScalingFunction
from ..ops.layout import stack_planes
from ..ops.stats import mad_noise

__all__ = ["wow", "wow_core", "wow_stack", "normalize_wow_params", "N_FAST"]

#: scales ``[0, N_FAST)`` run as one ``fused_wow_group`` call, the rest as
#: one ``deep_whiten_step`` each.  Both drive the same per-scale kernel
#: today, so the split changes no number; it marks the scales whose
#: whitening reach ``hw·(3·2^(g−1)−1)`` (22 pixels for the B3spline at
#: g = 3) fits a shared-memory tile with a 32-pixel halo, the group a
#: later fused kernel takes.
N_FAST = 3


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


def _check_slice(data, whitening, bilateral, preserve_variance, h, axes):
    """Raise for every option outside the ported slice, on every device:
    no option may run without its kernel."""
    if bilateral is not None:
        raise _not_ported("bilateral WOW", "bilateral")
    if preserve_variance:
        raise _not_ported("preserve_variance", "WOW options")
    if h != 0:
        raise _not_ported("the gamma blend (h > 0)", "WOW options")
    if not whitening:
        raise _not_ported("whitening=False", "WOW options")
    if data.ndim != 2 or axes not in (None, (0, 1), (-2, -1)):
        raise _not_ported("WOW of 3-D volumes and frame stacks",
                          "volumes and wow_stack")
    if data.dtype not in (torch.float32, torch.float64):
        raise _not_ported(f"WOW in {data.dtype}", "bfloat16 and float16")


def _wow_body_merged(data, noise, has_noise, sf, n_scales, weights,
                     denoise_coefficients, soft_threshold, kernels,
                     need_planes=True):
    """The WOW pass over one frame → ``(recon, rows)``; ``kernels``
    selects the kernels' wrappers over their plain versions."""
    group = (hopper_conv.fused_wow_group if kernels
             else hopper_conv.fused_wow_group_plain)
    step = (hopper_deep.deep_whiten_step if kernels
            else hopper_deep.deep_whiten_step_plain)
    sigma_e = sf.sigma_e(2, False)
    if not has_noise and any(
        d != 0 for d in denoise_coefficients[:n_scales]
    ):
        w0 = data - smooth(data, sf, scale=0)
        noise = mad_noise(w0, float(sigma_e[0]), fuse=kernels)

    def thr_of(k):
        # guarded: sigma_e may be shorter than n_scales; the reference
        # never touches sigma_e[k] for un-denoised scales
        # (watroo/wavelets.py:136)
        if denoise_coefficients[k] == 0:
            return torch.zeros_like(noise)
        return (denoise_coefficients[k] * float(sigma_e[k])) * noise

    def masked(k):
        return denoise_coefficients[k] != 0

    n_fast = min(n_scales, N_FAST)
    out_rows, recon, carry = [], None, data
    if n_fast:
        rows, recon = group(
            data, weights[:n_fast], torch.stack([thr_of(k)
                                                 for k in range(n_fast)]),
            n_fast, sf, offset=0, soft=soft_threshold,
            masked=tuple(masked(k) for k in range(n_fast)),
            need_cube=need_planes)
        out_rows.extend(rows[:-1])
        carry = rows[-1]
    for s in range(n_fast, n_scales):
        # recon accumulates in place inside the step
        white, _, carry = step(
            carry[None], recon[None], thr_of(s).reshape(1), sf=sf, scale=s,
            weight=weights[s], soft=soft_threshold, masked=masked(s),
            write_plane=need_planes)
        carry = carry[0]
        if need_planes:
            out_rows.append(white[0])

    # residual: global population-std normalization, clamped
    # (watroo/utils.py:185-191; jnp.std is the population std)
    lp = torch.std(carry, correction=0)
    lp = torch.where(lp <= 0, 1e-15, lp)
    c = carry * torch.div(torch.tensor(weights[n_scales], dtype=lp.dtype), lp)
    out_rows.append(c)
    recon = c if recon is None else recon + c
    return recon, out_rows


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
    """Fused decomposition + whitening from a raw 2-D frame → ``(recon,
    planes)``, with the JAX package's signature.  ``noise`` is a 0-d
    tensor on ``data``'s device (read when ``has_noise``).  ``fuse=False``
    runs the kernels' plain versions.  ``need_planes=False`` skips the
    whitened plane writes and returns ``(recon, None)``;
    ``planes_layout="rows"`` returns the planes as a tuple instead of a
    stacked cube."""
    _check_slice(data, whitening, bilateral, preserve_variance, h, axes)
    kernels = bool(fuse) and data.dtype == torch.float32
    recon, rows = _wow_body_merged(
        data, noise, has_noise, sf, n_scales, weights,
        denoise_coefficients, soft_threshold, kernels,
        need_planes=need_planes)
    if not need_planes:
        return recon, None
    if planes_layout == "rows":
        return recon, tuple(rows)
    return recon, stack_planes(rows)


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
        fuse=True):
    """Wavelets Optimized Whitening, signature-compatible with
    ``watroo.utils.wow`` (watroo/utils.py:105-219) plus ``fuse``.

    ``data`` is a 2-D numpy array (placed on the CPU) or tensor (kept on
    its device).  Returns ``(reconstruction, Coefficients)``.
    """
    if isinstance(data, Coefficients):
        raise _not_ported("wow(Coefficients)", "WOW options")
    if not isinstance(data, (np.ndarray, torch.Tensor)):
        # parity with watroo/utils.py:133
        raise ValueError("Unknown input type")
    if data.ndim not in (2, 3):
        # parity with watroo/utils.py:52
        raise ValueError("Unsupported number of dimensions")
    data = _as_tensor(data)
    spec = _spec_of(scaling_function)
    n_dims = data.ndim

    n_scales, weights_t, denoise_t, sigma_bilateral = normalize_wow_params(
        spec, n_scales, weights, denoise_coefficients, bilateral, h,
        n_dims, min(data.shape))

    has_noise = noise is not None
    noise_arr = (torch.as_tensor(noise, dtype=data.dtype, device=data.device)
                 if has_noise
                 else torch.zeros((), dtype=data.dtype, device=data.device))
    recon, out_planes = wow_core(
        data, noise_arr,
        sf=spec,
        n_scales=n_scales,
        weights=weights_t,
        whitening=bool(whitening),
        denoise_coefficients=denoise_t,
        bilateral=sigma_bilateral,
        bilateral_scaling=bool(bilateral_scaling),
        soft_threshold=bool(soft_threshold),
        preserve_variance=bool(preserve_variance),
        gamma=float(gamma),
        gamma_min=None if gamma_min is None else float(gamma_min),
        gamma_max=None if gamma_max is None else float(gamma_max),
        h=float(h),
        has_noise=has_noise,
        fuse=fuse,
        planes_layout="rows")
    coeffs = Coefficients(out_planes, scaling_function(n_dims), bilateral)
    coeffs.noise = noise
    return recon, coeffs


def wow_stack(data, noise=None, with_coefficients=True, **kwargs):
    """Per-frame WOW over a ``(B, H, W)`` stack — not ported yet."""
    raise _not_ported("wow_stack", "volumes and wow_stack")
