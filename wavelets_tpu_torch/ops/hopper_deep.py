"""One deep WOW scale (kernel A, one scale per call).

Counterpart of ``wavelets_tpu/ops/pallas_deep.py::deep_whiten_step``
with its signature minus ``interpret`` and ``halo``.  The TPU needs a
separate deep kernel because its group tiles cannot hold the halo of a
deep scale; on the card the same per-scale kernel as the shallow group
(``csrc/whiten_step.cu``) serves every dilation, so this wrapper drives
it for one scale.  ``deep_whiten_step2`` (two scales per pass) is two
calls of this step: the JAX package documents the two as numerically
identical (pallas_deep.py:950-952).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .filters import ScalingFunction
from .hopper_conv import (KERNEL, check_kernel_input, launch_whiten_step,
                          whiten_scale_plain)

__all__ = ["deep_whiten_step", "deep_whiten_step_plain"]


def _check_args(carry, recon, write_plane):
    if carry.ndim != 3:
        raise ValueError("deep_whiten_step takes a (B, H, W) carry")
    if recon is None and not write_plane:
        raise ValueError("deep_whiten_step: recon=None needs write_plane")
    if recon is not None and recon.shape != carry.shape:
        raise ValueError("deep_whiten_step: recon must match the carry")


def deep_whiten_step_plain(carry: torch.Tensor,
                           recon: Optional[torch.Tensor],
                           threshold: torch.Tensor, *, sf: ScalingFunction,
                           scale: int, weight: float, soft: bool = True,
                           masked: bool = False, write_plane: bool = True):
    """Plain PyTorch version of :func:`deep_whiten_step` (any dtype or
    device); like the kernel it adds into ``recon`` in place."""
    _build.PLAIN_CALLS[KERNEL] += 1
    _check_args(carry, recon, write_plane)
    thr = torch.as_tensor(threshold, dtype=carry.dtype,
                          device=carry.device).reshape(-1)
    thr = thr.expand(carry.shape[0])[:, None, None]
    white, c_next = whiten_scale_plain(carry, thr, weight, sf, scale, soft,
                                       masked)
    if recon is not None:
        recon.add_(white)
    return (white if write_plane else None), recon, c_next


def deep_whiten_step(carry: torch.Tensor, recon: Optional[torch.Tensor],
                     threshold: torch.Tensor, *, sf: ScalingFunction,
                     scale: int, weight: float, soft: bool = True,
                     masked: bool = False, write_plane: bool = True):
    """One WOW scale at dilation ``2^scale``: returns ``(white, recon',
    c_next)`` where ``c_next`` is the next scale's carry.

    ``carry``: ``(B, H, W)``; ``threshold``: ``(B,)`` per-frame
    significance threshold on the carry's device (read only when
    ``masked``).  ``recon`` (or None) is accumulated **in place**,
    ``recon' = recon += white``, which saves the separate read of
    ``white`` an out-of-place sum would cost; ``white`` is None when
    ``write_plane=False`` (then ``recon`` is required).  A CPU carry runs
    :func:`deep_whiten_step_plain`; a CUDA carry runs kernel A or
    raises."""
    if not carry.is_cuda:
        return deep_whiten_step_plain(
            carry, recon, threshold, sf=sf, scale=scale, weight=weight,
            soft=soft, masked=masked, write_plane=write_plane)
    check_kernel_input(carry, sf, "deep_whiten_step")
    _check_args(carry, recon, write_plane)
    if recon is not None:
        check_kernel_input(recon, sf, "deep_whiten_step")
    thr = torch.as_tensor(threshold, dtype=torch.float32,
                          device=carry.device).reshape(-1)
    thr = thr.expand(carry.shape[0]).contiguous()
    white = torch.empty_like(carry) if write_plane else None
    c_next = torch.empty_like(carry)
    launch_whiten_step(carry, c_next, torch.empty_like(carry),
                       torch.empty_like(carry), white, recon,
                       0 if recon is None else 2, thr, weight, masked, soft,
                       sf, scale)
    return white, recon, c_next
