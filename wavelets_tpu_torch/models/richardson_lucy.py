"""Multiresolution-supported Richardson-Lucy deconvolution
(reference: watroo/utils.py:222-290).

Counterpart of ``wavelets_tpu/models/richardson_lucy.py``.  Each
iteration blurs the estimate with the PSF, à trous-transforms the
residual (:func:`~..core.transform.decompose`: kernel C on the card for
float32, batched over the frames of a stack), masks it with the
multiresolution support and applies the multiplicative RL update.  The
JAX scan is a Python loop carrying ``(psi, mrs)``.  The MAD noise runs
kernel B: once a call (once a frame for a stack), or once an iteration
under ``uniform_init``.  ``fuse=False`` runs the plain versions of both.

The PSF convolutions, which the JAX package leaves to XLA (no Pallas
kernel), are plain PyTorch: the direct path is a correlation with a
symmetric border (cv2 ``BORDER_REFLECT``, watroo/utils.py:257), the FFT
path a product with the centred, rolled PSF spectrum
(``torch.fft.rfft2``, :245-250).  Below float32 (bfloat16, float16) the
correlation is the JAX package's shift-add, rounded after every tap, and
the FFT path raises ``ValueError`` on every device, as JAX's ``rfft``
refuses those dtypes (cuFFT would take float16 on the card).
``fft="auto"`` keeps the JAX rule, FFT above :data:`_FFT_AUTO_TAPS`
taps, so ``auto`` gives the JAX package's answer; that crossover was
measured on a TPU, and ``chip_smoke.py`` measures the H100's (PERF.md).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..api import DEFAULT_DEVICE, _as_tensor
from ..core.transform import decompose, synthesize
from ..ops.conv import boundary_index, low_precision
from ..ops.filters import B3SPLINE, ScalingFunction
from ..ops.layout import stack_planes
from ..ops.stats import mad_noise, mad_noise_frames, significance

__all__ = ["richardson_lucy", "richardson_lucy_core",
           "richardson_lucy_stack"]


def _pad_psf_symmetric(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """``x`` padded by ``ph − 1`` rows and ``pw − 1`` columns with numpy's
    ``symmetric`` map, the extra one of an even side at the bottom and
    right (cv2's anchor at ``(ph // 2, pw // 2)``)."""
    H, W = x.shape[-2:]
    rows = boundary_index(H, -(ph // 2), "symmetric", x.device, H + ph - 1)
    cols = boundary_index(W, -(pw // 2), "symmetric", x.device, W + pw - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def _correlate2d_shift_add(x: torch.Tensor, psf: torch.Tensor) -> torch.Tensor:
    """2-D correlation with a symmetric border as a shift-add in the JAX
    package's tap order (row-major, ``out + psf[i, j]·slice``); ``x`` is
    a frame ``(H, W)`` or a stack ``(B, H, W)``.  The check version of
    :func:`_correlate2d_symmetric`."""
    ph, pw = psf.shape
    H, W = x.shape[-2:]
    xp = _pad_psf_symmetric(x, ph, pw)
    out = torch.zeros_like(x)
    for i in range(ph):
        for j in range(pw):
            out = out + psf[i, j] * xp[..., i:i + H, j:j + W]
    return out


def _correlate2d_symmetric(x: torch.Tensor, psf: torch.Tensor) -> torch.Tensor:
    """2-D correlation with a symmetric (edge-duplicated) border, matching
    ``cv2.filter2D(..., BORDER_REFLECT)`` (watroo/utils.py:257, :286):
    ``F.conv2d`` (a correlation) of the padded input.  cv2 correlates, so
    the reference flips the PSF for the forward blur and leaves it for
    the adjoint.  cuDNN computes a float32 convolution in TF32 by
    default; it is turned off here, so the result is float32 (checked on
    the card against :func:`_correlate2d_shift_add`).  Below float32 it
    is :func:`_correlate2d_shift_add` on every device: ``F.conv2d``
    accumulates in float32 and rounds once, the JAX package's shift-add
    after every tap."""
    if low_precision(x.dtype):
        return _correlate2d_shift_add(x, psf)
    ph, pw = psf.shape
    xp = _pad_psf_symmetric(x, ph, pw)
    lead = x.shape[:-2]
    xp = xp.reshape((-1, 1) + tuple(xp.shape[-2:]))
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        out = F.conv2d(xp, psf.reshape(1, 1, ph, pw))
    return out.reshape(lead + tuple(x.shape[-2:]))


def _frames(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of a frame, or of each frame of a stack as a single-frame
    call computes it: a batched inverse FFT rounds otherwise (pocketfft's
    and cuFFT's batched plans), and cuDNN may pick another convolution
    for a batch, so a frame of a stack keeps a single frame's bits."""
    if x.ndim == 2:
        return fn(x)
    return torch.stack([fn(f) for f in x])


def _fft_psf(psf: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Centred, rolled PSF spectrum (watroo/utils.py:245-250); the PSF's
    corner is clamped into the frame as ``lax.dynamic_update_slice``
    clamps it."""
    H, W = shape
    ph, pw = psf.shape
    if ph > H or pw > W:
        raise ValueError(f"a {ph}×{pw} PSF does not fit a {H}×{W} frame")
    r0 = min(max(H // 2 - ph // 2, 0), H - ph)
    c0 = min(max(W // 2 - pw // 2, 0), W - pw)
    padded = torch.zeros(shape, dtype=psf.dtype, device=psf.device)
    padded[r0:r0 + ph, c0:c0 + pw] = psf
    return torch.fft.rfft2(torch.roll(padded, (H // 2, W // 2), dims=(0, 1)))


#: ``fft="auto"`` takes the FFT path above this many PSF taps: the JAX
#: package's crossover, measured on a TPU v5e (wavelets_tpu/models/
#: richardson_lucy.py:85-97) and kept so that ``auto`` gives the JAX
#: answer; the H100's own crossover is in PERF.md
_FFT_AUTO_TAPS = 36


def _fft_auto(fft, psf_shape) -> bool:
    if fft == "auto" or fft is None:
        return int(np.prod(psf_shape)) > _FFT_AUTO_TAPS
    return bool(fft)


def richardson_lucy_core(
    data: torch.Tensor,
    psf: torch.Tensor,
    *,
    iterations: int = 10,
    denoise_coefficients: Tuple[float, ...] = (5.0, 2.0, 1.0),
    threshold_type: str = "soft",
    uniform_init: bool = False,
    persistent_mrs: bool = True,
    fft: bool = False,
    sf: ScalingFunction = B3SPLINE,
    fuse: bool = True,
) -> torch.Tensor:
    """One frame ``(H, W)`` or a stack ``(B, H, W)`` (per-frame noise
    statistics and initialization) on ``data``'s device; ``psf`` is a 2-D
    tensor of ``data``'s dtype and device, ``fft`` resolved to a bool."""
    if fft and low_precision(data.dtype):
        # jnp.fft.rfft2's refusal, raised here on every device
        raise ValueError(f"RFFT input must be float32 or float64, got "
                         f"{data.dtype}: pass fft=False for {data.dtype}")
    batched = data.ndim == 3
    sp_axes = (1, 2) if batched else None
    level = len(denoise_coefficients)
    soft = threshold_type == "soft"
    sigma_e = sf.sigma_e(2, False)
    dtype = data.dtype

    def noise_of(planes0):
        if batched:
            return mad_noise_frames(planes0, float(sigma_e[0]),
                                    fuse)[:, None, None]
        return mad_noise(planes0, float(sigma_e[0]), fuse)

    # ---- initialization (watroo/utils.py:229-243) ----
    if uniform_init:
        # each frame's mean reduced alone, as a single frame's is
        frames = data if batched else data[None]
        mean = torch.stack([f.mean() for f in frames])[:, None, None]
        psi = (mean if batched else mean[0]).expand(data.shape).clone()
        # the reference never runs coefficients.denoise here, so the noise
        # stays unset and is estimated from each iteration's residual
        init_noise = None
    else:
        init_planes = decompose(data, level, sf, axes=sp_axes, fuse=fuse)
        init_noise = (noise_of(init_planes[0])
                      if any(d != 0 for d in denoise_coefficients) else None)
        masked = []
        for s in range(level + 1):
            c = init_planes[s]
            if s < level and denoise_coefficients[s] != 0:
                c = c * significance(c, float(denoise_coefficients[s]),
                                     init_noise, float(sigma_e[s]), soft)
            masked.append(c)
        psi = synthesize(stack_planes(masked))
        del init_planes, masked

    mrs = [(torch.ones_like if soft else torch.zeros_like)(data)
           for _ in range(level)]

    # the blur and its adjoint: the PSF's spectrum and its conjugate, or
    # the flipped PSF and the PSF (cv2 correlates), computed once
    if fft:
        shape = tuple(data.shape[-2:])
        fwd = _fft_psf(psf, shape)
        adj = fwd.conj_physical()

        def apply(x, k):
            return _frames(lambda f: torch.fft.irfft2(torch.fft.rfft2(f) * k,
                                                      s=shape), x)
    else:
        fwd, adj = torch.flip(psf, (0, 1)), psf

        def apply(x, k):
            return _frames(lambda f: _correlate2d_symmetric(f, k), x)

    # ---- RL iterations (watroo/utils.py:252-288) ----
    for it in range(iterations):
        phi = apply(psi, fwd)
        res = data - phi
        res_planes = decompose(res, level, sf, axes=sp_axes, fuse=fuse)
        noise = (init_noise if init_noise is not None
                 else noise_of(res_planes[0]))
        # 1/(it+1) in the data's dtype, as the JAX scan computes it
        expo = 1.0 / (torch.tensor(float(it), dtype=dtype) + 1.0)
        masked = []
        for s in range(level):
            sig = significance(res_planes[s], float(denoise_coefficients[s]),
                               noise, float(sigma_e[s]), soft)
            if not soft:
                # hard: sticky support (watroo/utils.py:266-270)
                m = torch.maximum(mrs[s], sig) if persistent_mrs else sig
                masked.append(res_planes[s] * m)
            else:
                # soft: multiplicative support with a decaying exponent
                # (watroo/utils.py:272-276)
                m = mrs[s] * sig if persistent_mrs else sig
                masked.append(res_planes[s] * (m ** expo))
            mrs[s] = m
        masked.append(res_planes[level])
        del res_planes
        res = synthesize(stack_planes(masked))
        del masked
        res = (res + phi) / phi
        psi = psi * apply(res, adj)
    return psi


def _deconvolve(data, psf, device, *, iterations, denoise_coefficients,
                fft, uniform_init, persistent_mrs, **kw):
    """The front doors' common part: the recast and device rules of
    ``_as_tensor`` for the data, the PSF on the data's device and dtype,
    the options normalized and ``fft`` resolved."""
    data = _as_tensor(data, device)
    psf = _as_tensor(psf, data.device)
    if psf.ndim != 2:
        raise ValueError("the PSF must be 2-D")
    return richardson_lucy_core(
        data, psf.to(device=data.device, dtype=data.dtype),
        iterations=int(iterations),
        denoise_coefficients=tuple(float(d) for d in denoise_coefficients),
        fft=_fft_auto(fft, tuple(psf.shape)), uniform_init=bool(uniform_init),
        persistent_mrs=bool(persistent_mrs), **kw)


def richardson_lucy(data, psf, iterations=10, denoise_coefficients=(5, 2, 1),
                    threshold_type="soft", uniform_init=False,
                    persistent_mrs=True, fft="auto", fuse=True,
                    device=DEFAULT_DEVICE):
    """Richardson-Lucy deconvolution with multiresolution support,
    signature-compatible with ``watroo.utils.richardson_lucy``
    (watroo/utils.py:222-290) plus ``fuse`` and ``device``.

    As in the JAX package, ``fft="auto"`` departs from the reference's
    default (direct correlation): the FFT path above 36 PSF taps.  The two
    paths differ near the borders (circular against symmetric), as the
    reference's own ``fft`` flag does; pass ``fft=False`` or ``True`` to
    pin either.  A tensor stays on its device; other input goes to
    ``device``, the card by default."""
    return _deconvolve(
        data, psf, device, iterations=iterations,
        denoise_coefficients=denoise_coefficients, fft=fft,
        uniform_init=uniform_init, persistent_mrs=persistent_mrs,
        threshold_type=threshold_type, fuse=fuse)


def richardson_lucy_stack(data, psf, *, iterations=10,
                          denoise_coefficients=(5, 2, 1),
                          threshold_type="soft", uniform_init=False,
                          persistent_mrs=True, fft="auto", sf=B3SPLINE,
                          fuse=True, device=DEFAULT_DEVICE):
    """Per-frame RL deconvolution of a stack ``(B, H, W)``: per-frame MAD
    noise (kernel B once a frame) and ``uniform_init`` mean, the shared
    PSF sliding over the last two axes, and the batched decomposition
    (kernel C over the frames) — a loop of single-frame
    :func:`richardson_lucy` calls in one, each frame bit for bit.

    Takes the keyword arguments of :func:`richardson_lucy` (and ``sf``).
    Departure from the JAX package: an unknown keyword argument raises
    ``TypeError``; JAX's ``richardson_lucy_stack`` ignores it silently,
    so a misspelt option would run with its default (a defect of the JAX
    package, ROADMAP.md queue C)."""
    if np.ndim(data) != 3:
        raise ValueError("richardson_lucy_stack expects a (B, H, W) stack")
    return _deconvolve(
        data, psf, device, iterations=iterations,
        denoise_coefficients=denoise_coefficients, fft=fft,
        uniform_init=uniform_init, persistent_mrs=persistent_mrs,
        threshold_type=threshold_type, sf=sf, fuse=fuse)
