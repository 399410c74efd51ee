"""Coefficient persistence: ``Coefficients`` to and from an npz file.

Counterpart of ``wavelets_tpu/utils/io.py`` (the port's own copy) with
the same npz keys (``data``, ``scaling_function``, ``n_dim``,
``bilateral``, ``noise``), so a file written by either package loads in
the other.  WOW's only state across calls is the ``Coefficients`` that
``wow`` returns and accepts back (watroo/utils.py:128-131, 152-153).
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import DEFAULT_DEVICE, B3spline, Coefficients, Triangle

__all__ = ["save_coefficients", "load_coefficients"]

_COMPAT = {"triangle": Triangle, "b3spline": B3spline}


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_coefficients(path: str, coefficients: Coefficients) -> None:
    noise = coefficients.noise
    np.savez_compressed(
        path,
        data=_host(coefficients.data),
        scaling_function=coefficients.scaling_function.name,
        n_dim=coefficients.scaling_function.n_dim,
        bilateral=np.asarray(
            [] if coefficients.bilateral is None
            else np.atleast_1d(coefficients.bilateral), dtype=np.float64),
        noise=_host(np.nan if noise is None else noise),
    )


def load_coefficients(path: str, device=DEFAULT_DEVICE) -> Coefficients:
    """The saved ``Coefficients``, its planes on ``device`` (the card by
    default)."""
    with np.load(path, allow_pickle=False) as f:
        name = str(f["scaling_function"])
        n_dim = int(f["n_dim"])
        bilateral = f["bilateral"]
        bilateral = None if bilateral.size == 0 else list(bilateral)
        if bilateral is not None and len(bilateral) == 1:
            bilateral = bilateral[0]
        coeffs = Coefficients(f["data"], _COMPAT[name](n_dim), bilateral,
                              device=device)
        noise = f["noise"]
        if not np.isnan(noise).all():
            coeffs.noise = noise if noise.ndim else float(noise)
    return coeffs
