"""Wavelet denoising (reference: ``denoise``, watroo/utils.py:83-102).

Counterpart of ``wavelets_tpu/models/denoise.py``: decomposition (kernel C
on the card for float32, kernel F when ``bilateral`` is given,
:func:`~..core.transform.decompose`), MAD noise from the finest plane
(kernel B) with the σ_e table of the transform, erf or hard significance
per scale, synthesis, and the optional generalized Anscombe transform
around it.  ``fuse=False`` runs the plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..api import DEFAULT_DEVICE, B3spline, _as_tensor, _spec_of
from ..core.transform import decompose, normalize_bilateral, synthesize
from ..ops.filters import ScalingFunction
from ..ops.stats import apply_denoise, generalized_anscombe, mad_noise

__all__ = ["denoise", "denoise_core"]


def denoise_core(
    data: torch.Tensor,
    noise: Optional[torch.Tensor],
    weights: Tuple[float, ...],
    sf: ScalingFunction,
    bilateral: Optional[Tuple[float, ...]] = None,
    soft_threshold: bool = True,
    anscombe: bool = False,
    axes: Optional[Tuple[int, ...]] = None,
    has_noise: bool = False,
    fuse: bool = True,
) -> torch.Tensor:
    """The denoise pipeline with the JAX package's signature plus
    ``fuse``; ``has_noise=False`` estimates the noise by MAD on the
    data's device."""
    if anscombe:
        data = generalized_anscombe(data)
    level = len(weights)
    planes = decompose(data, level, sf, axes=axes, bilateral=bilateral,
                       fuse=fuse)
    sigma_e = sf.sigma_e(len(axes) if axes is not None else data.ndim,
                         bilateral is not None)
    if not has_noise:
        noise = mad_noise(planes[0], float(sigma_e[0]), fuse=fuse)
    out_planes = apply_denoise(
        planes, weights, (1.0,) * level,
        tuple(float(v) for v in sigma_e[:level]), noise, soft_threshold)
    out = synthesize(out_planes)
    if anscombe:
        out = generalized_anscombe(out, inverse=True)
    return out


def denoise(data, weights, scaling_function=B3spline, noise=None,
            bilateral=None, soft_threshold=True, anscombe=False, fuse=True,
            device=DEFAULT_DEVICE):
    """Denoise, signature-compatible with watroo/utils.py:83-102 plus
    ``fuse`` and ``device``.

    :param data: the data to denoise; a tensor stays on its device, other
        input goes to ``device`` (the card by default)
    :param weights: per-scale significance thresholds (σ multiples); the
        number of scales is ``len(weights)``
    :param scaling_function: scaling function (class, instance, or spec)
    :param noise: known noise level (scalar or array); ``None`` → MAD
    :param bilateral: per-scale bilateral σ (scalar or list) or ``None``
    :param soft_threshold: erf-based soft masking vs hard thresholding
    :param anscombe: apply the generalized Anscombe transform around the
        pipeline
    :return: the denoised data, a tensor on the data's device
    """
    data = _as_tensor(data, device)
    spec = _spec_of(scaling_function)
    weights = tuple(float(w) for w in weights)
    bil = normalize_bilateral(bilateral, len(weights))
    has_noise = noise is not None
    noise_arr = (torch.as_tensor(noise, dtype=data.dtype, device=data.device)
                 if has_noise
                 else torch.zeros((), dtype=data.dtype, device=data.device))
    return denoise_core(data, noise_arr, weights, spec, bilateral=bil,
                        soft_threshold=soft_threshold, anscombe=anscombe,
                        has_noise=has_noise, fuse=fuse)
