"""Plain PyTorch reference of watroo's ``wow`` on a 2-D frame.

Written from watroo's semantics (``watroo/utils.py:105-219`` and
``watroo/wavelets.py``, as SURVEY.md §3.3 and its C3, C7 and C11 rows
cite them), independent of the package under test: it imports nothing of
it and takes nothing it made.  Every step is a separate, unfused tensor
operation in float32 (TF32 plays no part: there is no matrix product),
with the global reductions that decide a threshold or a scale (the
median, the residual's standard deviation) taken exactly.

* À trous decomposition with the B3spline's taps dilated ``2**s`` apart,
  numpy's ``symmetric`` border (edge-duplicating reflection, period
  ``2n``); ``w_s = c_s - c_{s+1}``.
* Bilateral decomposition: ``c_{s+1}`` is the range-weighted 5×5 dilated
  sum ``Σ k·exp(-(c - c_tap)²/(2·var))·c_tap / Σ k·exp(...)`` (the centre
  weighs ``k_c``), ``var = σ_b²·(⟨c²⟩ - ⟨c⟩²)`` under the scale's window,
  clamped ``≤ 0 → 1e-20``.
* Noise: ``median(|w_0|) / 0.6745 / σ_e[0]`` (numpy's median: the mean of
  the two middle values of an even count).
* Per detail plane: ``local power = sqrt(max(smooth_s(w²), ≤0 → 1e-15))``,
  the soft mask ``erf(|w / (d_s·noise·σ_e[s])|)`` where ``d_s != 0``,
  then ``w · weight_s / local power``; the residual is divided by its
  population standard deviation.  The reconstruction is the sum of the
  whitened planes.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

#: watroo/wavelets.py:268-283 (Starck & Murtagh's B3spline)
B3SPLINE_TAPS = (1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16)
#: per-scale std of a 2-D plane of unit Gaussian noise (wavelets.py:276-279)
B3SPLINE_SIGMA_E_2D = (8.907e-01, 2.0072e-01, 8.5551e-02, 4.1261e-02,
                       2.0470e-02, 1.0232e-02, 5.1435e-03, 2.6008e-03,
                       1.3161e-03, 6.7359e-04, 4.0040e-04)
#: the bilateral transform's table (wavelets.py:280-281), ten entries
B3SPLINE_SIGMA_E_2D_BILATERAL = (0.38234752, 0.24305799, 0.16012153,
                                 0.10633541, 0.07083733, 0.04728659,
                                 0.03163678, 0.02122341, 0.01429102,
                                 0.00952376)
MAD_TO_SIGMA = 0.6745
#: the keys of a configuration that choose WOW's options
OPTION_KEYS = ("scaling_function", "n_scales", "denoise_coefficients",
               "noise", "bilateral", "soft_threshold", "gamma", "h")


def options(config: dict) -> dict:
    """The WOW options a configuration states, as keyword arguments of
    watroo's ``wow`` (and of the port's), with the defaults left out.
    Raises where the configuration states a value this reference does
    not compute: another scaling function, hard thresholds, ``h != 0``
    (``gamma`` acts only through ``h``, so any ``gamma`` is accepted)."""
    missing = [k for k in OPTION_KEYS if k not in config]
    if missing:
        raise KeyError(f"the configuration lacks {', '.join(missing)}")
    if config["scaling_function"] != "B3spline":
        raise ValueError("the reference knows the B3spline only")
    if config["soft_threshold"] is not True:
        raise ValueError("the reference computes soft thresholds only")
    if config["h"] != 0:
        raise ValueError("the reference computes h = 0 only")
    kw = dict(denoise_coefficients=list(config["denoise_coefficients"]),
              soft_threshold=True, gamma=float(config["gamma"]), h=0)
    for key in ("n_scales", "noise", "bilateral"):
        if config[key] is not None:
            kw[key] = config[key]
    return kw


def auto_scales(height: int, width: int, n_taps: int = 5) -> int:
    """``round(log2(min(shape)) - log2(len(taps)))`` (utils.py:122)."""
    return int(round(math.log2(min(height, width)) - math.log2(n_taps)))


def _symmetric_index(n: int, shift: int, device) -> torch.Tensor:
    i = torch.arange(n, device=device) + shift
    p = torch.remainder(i, 2 * n)
    return torch.where(p < n, p, 2 * n - 1 - p)


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``x`` read at ``(i + dy, j + dx)`` through the symmetric border."""
    if dy:
        x = x.index_select(-2, _symmetric_index(x.shape[-2], dy, x.device))
    if dx:
        x = x.index_select(-1, _symmetric_index(x.shape[-1], dx, x.device))
    return x


def smooth(x: torch.Tensor, scale: int,
           taps: Sequence[float] = B3SPLINE_TAPS) -> torch.Tensor:
    """Separable dilated convolution, rows then columns."""
    d = 2 ** scale
    h = len(taps) // 2
    out = x
    for axis in (0, 1):
        acc = out * taps[h]
        for j in range(1, h + 1):
            a = (_shift(out, -j * d, 0) if axis == 0
                 else _shift(out, 0, -j * d))
            b = (_shift(out, j * d, 0) if axis == 0
                 else _shift(out, 0, j * d))
            acc = acc + taps[h + j] * (a + b)
        out = acc
    return out


def bilateral_smooth(x: torch.Tensor, scale: int, sigma_b: float,
                     taps: Sequence[float] = B3SPLINE_TAPS) -> torch.Tensor:
    """One scale of the bilateral chain (wavelets.py:24-32, 74-105)."""
    mean = smooth(x, scale, taps)
    var = smooth(x * x, scale, taps) - mean * mean
    var = torch.where(var <= 0, torch.full_like(var, 1e-20), var)
    var = var * (sigma_b * sigma_b)
    inv_two_var = 0.5 / var
    d = 2 ** scale
    h = len(taps) // 2
    centre = taps[h] * taps[h]
    num = x * centre
    den = torch.full_like(x, centre)
    for i in range(-h, h + 1):
        for j in range(-h, h + 1):
            if i == 0 and j == 0:
                continue
            k = taps[h + i] * taps[h + j]
            t = _shift(x, i * d, j * d)
            diff = x - t
            w = k * torch.exp(-(diff * diff) * inv_two_var)
            num = num + w * t
            den = den + w
    return num / den


def decompose(x: torch.Tensor, n_scales: int,
              bilateral: Optional[Sequence[float]] = None) -> List[torch.Tensor]:
    """Detail planes ``w_0 .. w_{n-1}`` and the residual ``c_n``."""
    planes, c = [], x
    for s in range(n_scales):
        nxt = (smooth(c, s) if bilateral is None
               else bilateral_smooth(c, s, float(bilateral[s])))
        planes.append(c - nxt)
        c = nxt
    planes.append(c)
    return planes


def median_abs(x: torch.Tensor) -> torch.Tensor:
    a = torch.sort(torch.abs(x).reshape(-1)).values
    n = a.numel()
    return (a[(n - 1) // 2] + a[n // 2]) / 2


def wow(frame: torch.Tensor, *, denoise_coefficients: Sequence[float] = (),
        n_scales: Optional[int] = None, bilateral: Optional[float] = None,
        noise: Optional[float] = None, soft_threshold: bool = True,
        gamma: float = 3.2, h: float = 0,
        keep_planes: bool = True) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``watroo.utils.wow(frame, denoise_coefficients=..., bilateral=...)``
    with the defaults for every other option (B3spline, weights 1) →
    ``(recon, whitened planes)``; the planes list is empty unless
    ``keep_planes``.  Soft thresholds and ``h = 0`` only (``gamma`` acts
    only where ``h > 0``)."""
    if frame.ndim != 2:
        raise ValueError("the reference takes one 2-D frame")
    if soft_threshold is not True or h != 0:
        raise ValueError("the reference computes soft thresholds, h = 0 only")
    x = frame.float()
    if n_scales is None:
        n_scales = auto_scales(*x.shape)
    sigma_e = (B3SPLINE_SIGMA_E_2D if bilateral is None
               else B3SPLINE_SIGMA_E_2D_BILATERAL)
    if len(denoise_coefficients) >= len(sigma_e):
        raise ValueError("more denoised scales than the σ_e table holds")
    d = list(denoise_coefficients) + [0.0] * n_scales
    planes = decompose(x, n_scales, None if bilateral is None
                       else [float(bilateral)] * (n_scales + 1))
    if noise is None and any(d[s] != 0 for s in range(n_scales)):
        noise_t = median_abs(planes[0]) / MAD_TO_SIGMA / sigma_e[0]
    else:
        noise_t = torch.tensor(0.0 if noise is None else float(noise),
                               device=x.device)
    out, recon = [], None
    for s in range(n_scales + 1):
        w = planes[s]
        if s == n_scales:
            std = torch.std(w.double(), correction=0).float()
            lp = torch.where(std <= 0, torch.full_like(std, 1e-15), std)
        else:
            p = smooth(w * w, s)
            lp = torch.sqrt(torch.where(p <= 0, torch.full_like(p, 1e-15), p))
            if d[s] != 0:
                t = d[s] * noise_t * sigma_e[s]
                mask = torch.erf(torch.abs(w / torch.where(t == 0, 1.0, t)))
                w = w * torch.where(t == 0, torch.ones_like(mask), mask)
        w = w / lp
        recon = w if recon is None else recon + w
        if keep_planes:
            out.append(w)
        planes[s] = None
    return recon, out
