"""Per-channel denoise/enhance pipeline (reference: watroo/utils.py:10-80).

Counterpart of ``wavelets_tpu/models/enhance.py``.  ``prepare_params``
normalizes scalar/list/None per-channel parameter specs to nested lists;
``enhance`` runs the denoise and weight pipeline on one image, or on each
channel along axis 0 of a 3-D input.  A 3-D input whose channels share
one scale count runs as one batched call (:func:`_enhance_channels`):
kernel C (or F when bilateral) over the channels, kernel B once a
channel for the lazy noise; mixed lengths run channel by channel.
"""

from __future__ import annotations

import torch

from ..api import DEFAULT_DEVICE, AtrousTransform, _as_tensor, _spec_of
from ..core.transform import decompose, normalize_bilateral, synthesize
from ..ops.layout import stack_planes
from ..ops.stats import (apply_denoise, mad_noise, mad_noise_frames,
                         significance)

__all__ = ["enhance", "prepare_params"]


def prepare_params(param, ndims):
    """Normalize a per-channel parameter spec to a list (2-D) or a list of
    per-channel lists (3-D), the output contract of watroo/utils.py:10-33.

    2-D: ``None`` → ``[]``, a scalar → ``[scalar]``, a list is copied.
    3-D: a non-list is broadcast to every channel; a list must have one
    entry per channel, each normalized recursively (``None`` → ``[]``).
    """
    if ndims == 2:
        if param is None:
            return []
        return list(param) if isinstance(param, list) else [param]
    if not isinstance(param, list):
        return [prepare_params(param, 2) for _ in range(ndims)]
    if len(param) != ndims:
        raise ValueError("Invalid number of parameters")
    return [prepare_params(p, 2) for p in param]


def _pad_pair(wgt, dns):
    """Pad the shorter of ``(weights, denoise)`` so both cover the same
    scale count: missing weights are 1, missing denoise 0
    (watroo/utils.py:65-68)."""
    wgt = list(wgt) + [1] * (len(dns) - len(wgt))
    dns = list(dns) + [0] * (len(wgt) - len(dns))
    return wgt, dns


def _enhance_channels(img, noise, *, spec, level, wgts, dnss, soft,
                      bilateral, bilateral_scaling, fuse):
    """All channels of a 3-D ``enhance`` in one batched pass: the
    decomposition over ``axes=(1, 2)`` (kernel C, or F when bilateral),
    per-channel weights, σ and noise as ``(C, 1, 1)`` factor tables, the
    planes summed in ascending order, residual last, as the reference's
    ``np.sum(coeffs, axis=0)``.  ``noise[c]`` is None for a channel whose
    noise comes from the MAD of its finest plane (kernel B once a channel,
    watroo/utils.py:71-74).  A channel whose σ at a scale is 0 gets an
    exact ones mask (``significance`` with a zero threshold), so it is
    ``c·w`` bitwise, as in the per-channel loop."""
    C = img.shape[0]
    planes = decompose(img, level, spec, axes=(1, 2),
                       bilateral=normalize_bilateral(bilateral, level),
                       bilateral_scaling=bilateral_scaling, fuse=fuse)
    sigma_e = spec.sigma_e(2, bilateral is not None)
    lazy = [n is None for n in noise]
    known = torch.tensor([0.0 if n is None else float(n) for n in noise],
                         dtype=planes.dtype, device=planes.device)
    if any(lazy):
        if any(any(d != 0 for d in dns) for dns in dnss):
            mad = mad_noise_frames(planes[0], float(sigma_e[0]), fuse)
        else:
            mad = torch.zeros((C,), dtype=planes.dtype, device=planes.device)
        mask = torch.tensor(lazy, device=planes.device)
        known = torch.where(mask, mad.to(planes.dtype), known)
    noise_b = known[:, None, None]

    def table(vals):
        return torch.tensor(vals, dtype=planes.dtype,
                            device=planes.device)[:, None, None]

    out = None
    for s in range(level):
        c = planes[s]
        wgt = table([w[s] for w in wgts])
        sig = [d[s] for d in dnss]
        if any(v != 0 for v in sig):
            m = significance(c, table(sig), noise_b, float(sigma_e[s]), soft)
            c = c * (wgt * m)
        else:
            c = c * wgt
        out = c if out is None else out + c
    return planes[level] if out is None else out + planes[level]


def enhance(*args, weights=None, denoise=None, soft_threshold=True, out=None,
            fuse=True, device=DEFAULT_DEVICE, **kwargs):
    """De-noising and/or enhancement by modification of wavelet
    coefficients (reference semantics: watroo/utils.py:36-80).

    ``args[0]`` is the image (2-D, or 3-D with channels on axis 0);
    optional ``args[1]`` supplies a noise level (per channel for 3-D, an
    entry None for a channel whose noise is estimated).  Extra keyword
    arguments go to :class:`AtrousTransform` (``scaling_function_class``,
    ``bilateral``, ``bilateral_scaling``).  A tensor stays on its device;
    other input goes to ``device``, the card by default.  ``out=``, a
    numpy array, is filled and returned.

    Departure from the JAX package: a per-channel noise with a
    list-valued ``bilateral`` runs as the reference's per-channel loop
    does; JAX's batched path raises ``TypeError`` there (ROADMAP.md
    queue C)."""
    img = args[0]
    noise = args[1] if len(args) == 2 else None
    weights = prepare_params(weights, img.ndim)
    denoise = prepare_params(denoise, img.ndim)
    atrous = AtrousTransform(**kwargs)

    def one_channel(channel, wgt, dns, channel_noise):
        wgt, dns = _pad_pair(wgt, dns)
        coeffs = atrous(channel, len(wgt), fuse=fuse, device=device)
        planes = coeffs.data
        sigma_e = coeffs.sigma_e
        if channel_noise is None:
            channel_noise = mad_noise(planes[0], float(sigma_e[0]), fuse)
        planes = apply_denoise(planes, dns, wgt,
                               tuple(float(v) for v in sigma_e[:len(dns)]),
                               channel_noise, soft_threshold)
        return synthesize(planes)

    if img.ndim == 3:
        # the reference loops over three channels (watroo/utils.py:60)
        padded = [_pad_pair(weights[c], denoise[c]) for c in range(3)]
        lengths = {len(w) for w, _ in padded}
        if lengths == {0}:
            # no weights or denoise anywhere: the image passes through
            result = _as_tensor(img, device)
        elif len(lengths) == 1:
            imgd = _as_tensor(img, device)
            result = _enhance_channels(
                imgd, [None if noise is None else noise[c] for c in range(3)],
                spec=_spec_of(atrous.scaling_function_class),
                level=lengths.pop(),
                wgts=[[float(v) for v in w] for w, _ in padded],
                dnss=[[float(v) for v in d] for _, d in padded],
                soft=bool(soft_threshold), bilateral=atrous.bilateral,
                bilateral_scaling=bool(atrous.bilateral_scaling), fuse=fuse)
        else:
            result = stack_planes([
                one_channel(img[c], weights[c], denoise[c],
                            None if noise is None else noise[c])
                for c in range(3)])
    else:
        result = one_channel(img, weights, denoise, noise)

    if out is not None:
        out[...] = result.detach().cpu().numpy()
        return out
    return result
