"""Monte-Carlo regeneration of the σ_e noise tables.

Counterpart of ``wavelets_tpu/utils/noise_calibration.py``.  The
reference estimates the per-scale std of the transform of unit Gaussian
noise in a serial loop on the host (``watroo/wavelets.py:221-229``); that
is how its hard-coded tables (``:241-254, 270-283``) were made.  Here the
trials are drawn in batches from a ``torch.Generator`` seeded with
``seed`` on the target device and go through the batched
:func:`~wavelets_tpu_torch.core.transform.decompose` (kernel C on the
card for 2-D float32), so memory stays at one batch of trials whatever
``n_trials``.  The generator's numbers are not ``jax.random``'s: the two
packages agree on the statistic of given noise
(:func:`batch_sigma_sum`), and on the tables within Monte-Carlo spread.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import DEFAULT_DEVICE, _target_device
from ..core.transform import decompose, normalize_bilateral
from ..ops.filters import ScalingFunction

__all__ = ["compute_noise_weights", "batch_sigma_sum"]

#: one batch of trial planes is kept under this many bytes, as in the JAX
#: package
BATCH_BYTES = 256 << 20


def batch_sigma_sum(noise: torch.Tensor, sf: ScalingFunction, n_scales: int,
                    bilateral=None, bilateral_scaling: bool = False,
                    fuse: bool = True) -> torch.Tensor:
    """Per-detail-plane population std of each trial of ``noise`` (a
    ``(batch, *spatial)`` tensor), summed over the batch → ``(n_scales,)``
    (watroo/wavelets.py:227).  ``bilateral`` is normalized to
    ``n_scales + 1`` entries.  ``torch.std`` defaults to the sample std;
    ``correction=0`` is ``jnp.std``'s population std."""
    n_dim = noise.ndim - 1
    planes = decompose(noise, n_scales, sf, axes=tuple(range(1, n_dim + 1)),
                       bilateral=bilateral,
                       bilateral_scaling=bilateral_scaling, fuse=fuse)
    stds = torch.std(planes[:-1], dim=tuple(range(2, n_dim + 2)),
                     correction=0)
    return torch.sum(stds, dim=1)


def compute_noise_weights(
    sf: ScalingFunction,
    n_dim: int,
    n_scales: int,
    n_trials: int = 100,
    bilateral=None,
    bilateral_scaling: bool = False,
    seed: int = 0,
    batch: int = None,
    fuse: bool = True,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """Monte-Carlo σ_e estimate with the semantics of
    ``AbstractScalingFunction.compute_noise_weights``
    (watroo/wavelets.py:221-229): the mean over trials of the per-detail-
    plane std of transformed float32 unit Gaussian noise, input extent
    ``len(sigma_e_1d)·2^n_scales`` per dimension.  ``batch`` trials at a
    time (default: as many as fit in :data:`BATCH_BYTES`, a divisor of
    ``n_trials``), on ``device`` (the card by default)."""
    device = _target_device(device)
    size = len(sf.sigma_e(1, False)) * 2 ** n_scales
    if batch is None:
        per_trial = (size ** n_dim) * 4 * (n_scales + 2)
        batch = max(1, min(n_trials, BATCH_BYTES // max(per_trial, 1)))
    while n_trials % batch:
        batch -= 1
    bil = normalize_bilateral(bilateral, n_scales)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    acc = torch.zeros((n_scales,), dtype=torch.float32, device=device)
    shape = (batch,) + (size,) * n_dim
    for _ in range(n_trials // batch):
        noise = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device)
        acc = acc + batch_sigma_sum(noise, sf, n_scales, bil,
                                    bilateral_scaling, fuse)
    return (acc / n_trials).cpu().numpy()
