"""Coefficient statistics: Anscombe, MAD noise, significance, denoise.

Counterpart of ``wavelets_tpu/ops/stats.py`` (the reference's coefficient
algebra, watroo/wavelets.py:14-21 and :126-149).
"""

from __future__ import annotations

import torch

from .. import tracing
from . import hopper_stats
from .conv import weak_scalar
from .layout import stack_planes

__all__ = ["MAD_TO_SIGMA", "generalized_anscombe", "median_abs", "mad_noise",
           "median_abs_frames", "mad_noise_frames", "significance_soft",
           "significance_hard", "significance", "apply_denoise"]

#: MAD → σ conversion constant for a Gaussian (watroo/wavelets.py:127).
MAD_TO_SIGMA = 0.6745


def _div_scalars(x: torch.Tensor, *scalars) -> torch.Tensor:
    """``x / s_0 / s_1 ...`` as the JAX package computes it, each Python
    scalar a weakly typed one (:func:`~.conv.weak_scalar`)."""
    for v in scalars:
        x = x / weak_scalar(v, x.dtype)
    return x


def generalized_anscombe(signal, alpha=1.0, g=0.0, sigma=0.0, inverse=False):
    """Generalized Anscombe variance-stabilizing transform, with the
    forward branch's ``≤0 → 0`` clamp (watroo/wavelets.py:14-21)."""
    signal = torch.as_tensor(signal)
    if inverse:
        return ((alpha * signal / 2) ** 2 + alpha * g - sigma ** 2
                - 3 * alpha / 8) / alpha
    dum = alpha * signal + 3 * alpha ** 2 / 8 + sigma ** 2 - alpha * g
    dum = torch.where(dum <= 0, torch.zeros((), dtype=dum.dtype,
                                            device=dum.device), dum)
    return 2 * torch.sqrt(dum) / alpha


def median_abs(x: torch.Tensor, fuse: bool = True) -> torch.Tensor:
    """``median(|x|)`` with numpy's even-count rule, as a 0-d tensor on
    ``x``'s device (``torch.median`` returns the lower middle value and is
    not used).  float32 goes through kernel B's wrapper
    (:func:`hopper_stats.median_bits2`: the kernel on the card, a sort on
    the CPU) or, with ``fuse=False``, its plain version; other dtypes sort
    in their own precision, as the JAX package sends them to XLA."""
    if x.dtype == torch.float32:
        return hopper_stats.median_abs(
            x, hopper_stats.median_bits2 if fuse
            else hopper_stats.median_bits2_plain)
    a = torch.sort(torch.abs(x).reshape(-1)).values
    k_lo, k_hi = hopper_stats.middle_ranks(a.numel())
    return (a[k_lo] + a[k_hi]) / 2


def mad_noise(w0: torch.Tensor, sigma_e0: float,
              fuse: bool = True) -> torch.Tensor:
    """Noise level from the finest detail plane via the MAD estimator:
    ``median(|w0|) / 0.6745 / σ_e[0]`` (watroo/wavelets.py:126-127)."""
    return _div_scalars(median_abs(w0, fuse), MAD_TO_SIGMA, sigma_e0)


def median_abs_frames(x: torch.Tensor, fuse: bool = True) -> torch.Tensor:
    """Per-frame ``median(|x|)`` over a stack ``(B, ...)`` → ``(B,)`` on
    ``x``'s device: :func:`median_abs` of each contiguous frame, one call
    a frame (kernel B on the card for float32), as the JAX package runs
    one single-frame select a frame (wavelets_tpu/ops/stats.py:144-161);
    ``fuse=False`` runs the plain version, a sort of each frame."""
    x = x.contiguous()
    return torch.stack([median_abs(x[b], fuse) for b in range(x.shape[0])])


def mad_noise_frames(w0: torch.Tensor, sigma_e0: float,
                     fuse: bool = True) -> torch.Tensor:
    """Per-frame MAD noise over a stack of finest detail planes ``(B, H,
    W)`` → ``(B,)``."""
    return _div_scalars(median_abs_frames(w0, fuse), MAD_TO_SIGMA, sigma_e0)


def significance_soft(w: torch.Tensor, threshold) -> torch.Tensor:
    """Smooth multiplicative mask ``erf(|w/t|)`` (watroo/wavelets.py:136-139)."""
    return torch.erf(torch.abs(w / threshold))


def significance_hard(w: torch.Tensor, threshold) -> torch.Tensor:
    """Boolean mask ``|w| > t`` (watroo/wavelets.py:141)."""
    return torch.abs(w) > threshold


def significance(w: torch.Tensor, sigma: float, noise, sigma_e_scale: float,
                 soft_threshold: bool = True) -> torch.Tensor:
    """Per-plane significance for a known ``noise`` level
    (watroo/wavelets.py:129-143).  The ``sigma == 0`` shortcut is the
    caller's; a zero threshold (``noise == 0``) yields ones, the
    reference's explicit ``noise == 0`` branch (:133-135), without a
    host-side branch on the value.  A ``noise`` tensor below float32
    takes the scalars rounded to its dtype, as the JAX package does."""
    if isinstance(noise, torch.Tensor):
        t = (weak_scalar(sigma, noise.dtype) * noise
             * weak_scalar(sigma_e_scale, noise.dtype))
    else:
        t = sigma * noise * sigma_e_scale
    t = tracing.as_tensor(t, dtype=w.dtype, device=w.device,
                          site="significance.threshold")
    safe_t = torch.where(t == 0, torch.ones_like(t), t)
    if soft_threshold:
        mask = significance_soft(w, safe_t)
    else:
        mask = significance_hard(w, safe_t).to(w.dtype)
    return torch.where(t == 0, torch.ones_like(mask), mask)


def apply_denoise(planes: torch.Tensor, sigmas, weights, sigma_e, noise,
                  soft_threshold: bool = True) -> torch.Tensor:
    """Scale-wise denoise of a coefficient cube ``(level+1, ...)``
    (watroo/wavelets.py:145-149).  ``zip`` truncation: only the
    ``min(len(planes), len(sigmas), len(weights))`` leading planes are
    modified; the trailing ones (typically the residual) pass through."""
    sigmas = tuple(sigmas)
    weights = tuple(weights) if weights is not None else (1.0,) * len(sigmas)
    n = min(planes.shape[0], len(sigmas), len(weights))
    out = []
    for s in range(planes.shape[0]):
        c = planes[s]
        if s < n:
            wgt = torch.tensor(weights[s], dtype=c.dtype)
            if sigmas[s] != 0:
                mask = significance(c, sigmas[s], noise, sigma_e[s],
                                    soft_threshold)
                c = c * (wgt * mask)
            else:
                c = c * wgt
        out.append(c)
    return stack_planes(out)
