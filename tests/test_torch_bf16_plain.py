"""bfloat16 and float16 on the plain routes, against the JAX package on
the CPU (its XLA path, where it sends both dtypes): ``wow`` with every
option outside the bfloat16 merged route, a volume, a stack with planes
and ``wow(Coefficients)``; ``AtrousTransform``, ``denoise`` and
``enhance``; and Richardson-Lucy's low-precision correlation and FFT
refusal.

Tolerances: planes and the reconstruction within ``2^-8·max|ref recon|``
(one bfloat16 unit at the largest value); the transform, ``denoise``,
``enhance`` and RL's direct path bitwise in bfloat16, and within
``2^-8·max|ref|`` in float16 (measured below 1.1e-3·max); RL in float16
bitwise to the JAX package run op by op (``jax.disable_jit``).  The port's
``fuse=True`` takes the same plain route as ``fuse=False``, bitwise."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wavelets_tpu as J
import wavelets_tpu_torch as T
from tests.torch_parity import assert_close_scaled, to_np
from wavelets_tpu_torch.ops import _build

RTOL = 2 ** -8
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}


def _pair(shape, dtype, seed=0, mean=0.0):
    jd, td = DTYPES[dtype]
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    j = jnp.asarray(x * 3 + mean).astype(jd)
    return j, torch.from_numpy(to_np(j).astype(np.float32)).to(td)


def _same(got, ref):
    np.testing.assert_array_equal(to_np(got).astype(np.float32),
                                  to_np(ref).astype(np.float32))


def _close(got, ref, scale=None):
    assert_close_scaled(to_np(got).astype(np.float32),
                        to_np(ref).astype(np.float32), RTOL, scale)


# ---------------------------------------------------------------------
# (c) wow on the plain route
# ---------------------------------------------------------------------

WOW = {
    "lazy": dict(n_scales=4, denoise_coefficients=[3, 1]),
    "bilateral": dict(n_scales=4, bilateral=1, noise=0.5,
                      denoise_coefficients=[3, 1]),
    "preserve-variance": dict(n_scales=4, preserve_variance=True,
                              noise=0.5, denoise_coefficients=[3, 1]),
    "h-0.5": dict(n_scales=4, h=0.5, noise=0.5,
                  denoise_coefficients=[3, 1]),
    "no-whitening": dict(n_scales=4, whitening=False),
    "known-noise": dict(n_scales=4, noise=0.5, denoise_coefficients=[3]),
}


@pytest.mark.parametrize("case", sorted(WOW))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_wow_plain_route_matches_jax(case, dtype):
    # 64² frames: not a multiple of 256, so no case merges in bfloat16
    # ("known-noise" merges at 256 multiples, tests/test_torch_bf16.py)
    j, t = _pair((64, 64), dtype, seed=len(case))
    kw = WOW[case]
    r_j, c_j = J.wow(j, **kw)
    _build.reset_counters()
    r_t, c_t = T.wow(t, **kw)
    assert not _build.LAUNCHES
    assert not any(k.endswith("_bf16") for k in _build.PLAIN_CALLS)
    assert r_t.dtype == t.dtype and len(c_t) == len(c_j)
    scale = float(np.abs(to_np(r_j).astype(np.float32)).max())
    _close(r_t, r_j)
    for k in range(len(c_j)):
        _close(c_t[k], c_j[k], scale)
    r_p, c_p = T.wow(t, fuse=False, **kw)
    _same(r_t, r_p)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_wow_volume_matches_jax(dtype):
    j, t = _pair((8, 32, 32), dtype, seed=3)
    kw = dict(denoise_coefficients=[3, 1])
    r_j, c_j = J.wow(j, **kw)
    r_t, c_t = T.wow(t, **kw)
    assert r_t.shape == (8, 32, 32) and r_t.dtype == t.dtype
    scale = float(np.abs(to_np(r_j).astype(np.float32)).max())
    _close(r_t, r_j)
    for k in range(len(c_j)):
        _close(c_t[k], c_j[k], scale)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("noise", [None, 0.5])
def test_wow_stack_with_planes_matches_jax(dtype, noise):
    twow = importlib.import_module("wavelets_tpu_torch.models.wow")
    j, t = _pair((3, 64, 64), dtype, seed=4)
    kw = dict(n_scales=4, denoise_coefficients=[3, 1])
    r_j, p_j = J.wow_stack(j, noise=noise, **kw)
    _build.reset_counters()
    r_t, p_t = twow.wow_stack(t, noise=noise, **kw)
    assert not _build.LAUNCHES
    assert p_t.shape == (3, 5, 64, 64) and p_t.dtype == t.dtype
    scale = float(np.abs(to_np(r_j).astype(np.float32)).max())
    _close(r_t, r_j)
    _close(p_t, p_j, scale)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_wow_of_coefficients_matches_jax(dtype):
    j, t = _pair((64, 64), dtype, seed=5)
    kw = dict(denoise_coefficients=[3, 1], noise=0.5)
    r_j, _ = J.wow(J.AtrousTransform()(j, 4), **kw)
    r_t, _ = T.wow(T.AtrousTransform()(t, 4), **kw)
    assert r_t.dtype == t.dtype
    _close(r_t, r_j)


# ---------------------------------------------------------------------
# (d) the transform, denoise and enhance
# ---------------------------------------------------------------------

def _check(got, ref, dtype):
    if dtype == "bf16":
        _same(got, ref)
    else:
        _close(got, ref)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_atrous_transform_low_precision(dtype):
    j, t = _pair((64, 64), dtype, seed=6, mean=10.0)
    c_j = J.AtrousTransform()(j, 4)
    c_t = T.AtrousTransform()(t, 4)
    assert c_t.data.dtype == t.dtype
    _check(c_t.data, c_j.data, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("noise", [None, 0.5])
def test_denoise_low_precision(dtype, noise):
    j, t = _pair((64, 64), dtype, seed=7, mean=10.0)
    kw = {} if noise is None else dict(noise=noise)
    got = T.denoise(t, [3, 2], **kw)
    assert got.dtype == t.dtype
    _check(got, J.denoise(j, [3, 2], **kw), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_enhance_low_precision(dtype):
    j, t = _pair((40, 48), dtype, seed=8, mean=10.0)
    kw = dict(weights=[1.5, 1.2], denoise=[5, 3])
    got = T.enhance(t, **kw)
    assert got.dtype == t.dtype
    _check(got, J.enhance(j, **kw), dtype)


# ---------------------------------------------------------------------
# (e) Richardson-Lucy below float32
# ---------------------------------------------------------------------

HANN5 = np.outer(np.hanning(7)[1:-1], np.hanning(7)[1:-1])
HANN5 = (HANN5 / HANN5.sum()).astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("threshold_type", ["soft", "hard"])
def test_richardson_lucy_direct_bitwise(dtype, threshold_type):
    j, t = _pair((64, 64), dtype, seed=9, mean=10.0)
    kw = dict(iterations=3, fft=False, threshold_type=threshold_type)
    if dtype == "f16":
        # float16 op by op: under jit, XLA's CPU backend keeps float16
        # chains in float32 inside a fusion (excess precision), which
        # bfloat16 does not get; measured against the jitted JAX here:
        # soft 0.0547 at |ref| 18.9, hard 1.28 at 15.1 (flipped masks)
        with jax.disable_jit():
            ref = J.richardson_lucy(jnp.abs(j), HANN5, **kw)
    else:
        ref = J.richardson_lucy(jnp.abs(j), HANN5, **kw)
    got = T.richardson_lucy(torch.abs(t), HANN5, **kw)
    assert got.dtype == t.dtype
    _same(got, ref)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_correlation_low_precision_is_the_shift_add(dtype):
    trl = importlib.import_module("wavelets_tpu_torch.models.richardson_lucy")
    jrl = importlib.import_module("wavelets_tpu.models.richardson_lucy")
    j, t = _pair((2, 33, 40), dtype, seed=10)
    psf = torch.from_numpy(HANN5).to(t.dtype)
    got = trl._correlate2d_symmetric(t, psf)
    _same(got, trl._correlate2d_shift_add(t, psf))
    _same(got, jrl._correlate2d_symmetric(j, jnp.asarray(HANN5)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("fft", [True, "auto"])
def test_richardson_lucy_fft_refuses_low_precision(dtype, fft):
    j, t = _pair((64, 64), dtype, seed=11, mean=10.0)
    psf = np.full((15, 15), 1 / 225, np.float32)
    with pytest.raises(ValueError):
        J.richardson_lucy(jnp.abs(j), psf, iterations=1, fft=fft)
    with pytest.raises(ValueError, match="float32 or float64"):
        T.richardson_lucy(torch.abs(t), psf, iterations=1, fft=fft)
    with pytest.raises(ValueError, match="float32 or float64"):
        T.richardson_lucy_stack(torch.abs(t)[None], psf, iterations=1,
                                fft=fft)
