"""Denoising in the port against the JAX package: ``denoise`` (soft and
hard, known and lazy noise, Anscombe, Triangle, 1-D, 2-D and a 3-D
volume), the coefficient algebra of ``Coefficients`` (``get_noise``,
``significance``, ``denoise``, item assignment) and the statistics it
rests on (``generalized_anscombe``, ``apply_denoise``).

Tolerances: float64 ≤1e-12 relative; float32 within ``5e-6·max|ref|``
(``max(|x|, 1)`` for the decompositions behind them)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import wavelets_tpu as J
import wavelets_tpu_torch as T
from tests.torch_parity import assert_close_scaled, assert_rel, to_np
from wavelets_tpu.ops import stats as jstats
from wavelets_tpu_torch.ops import _build
from wavelets_tpu_torch.ops import stats as tstats

CASES = {
    "soft-lazy": (dict(), (256, 256)),
    "hard-known": (dict(noise=0.8, soft_threshold=False), (256, 256)),
    "anscombe": (dict(anscombe=True), (200, 328)),
    "triangle": (dict(scaling_function="Triangle"), (200, 328)),
    "1d": (dict(), (2000,)),
    "3d-volume": (dict(), (16, 64, 64)),
}


def _close(got, ref, dtype, scale=None):
    if dtype == np.float64:
        assert_rel(got, ref, 1e-12)
    else:
        assert_close_scaled(got, ref, 5e-6, scale)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_denoise_matches_jax(case, dtype):
    kw, shape = CASES[case]
    x = np.random.default_rng(len(case)).normal(size=shape) * 3 + 10
    x = x.astype(dtype)
    weights = [3, 3, 3] if len(shape) == 3 else [5, 3, 2]
    jkw, tkw = dict(kw), dict(kw)
    if "scaling_function" in kw:
        jkw["scaling_function"] = getattr(J, kw["scaling_function"])
        tkw["scaling_function"] = getattr(T, kw["scaling_function"])
    ref = np.asarray(J.denoise(x, weights, **jkw))
    _build.reset_counters()
    got = T.denoise(x, weights, device="cpu", **tkw)
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == shape
    # float32 frames and volumes decompose through kernel C's wrapper and
    # estimate lazy noise through kernel B's (their plain versions here)
    fused = dtype == np.float32 and len(shape) > 1
    assert ("decompose_group" in _build.PLAIN_CALLS) == fused
    assert ("median_select" in _build.PLAIN_CALLS) == (
        dtype == np.float32 and "noise" not in kw)
    _close(got, ref, dtype, float(np.abs(x).max()))
    plain = T.denoise(x, weights, device="cpu", fuse=False, **tkw)
    assert torch.equal(got, plain)


@pytest.fixture(scope="module")
def coeffs_pair():
    x = np.random.default_rng(5).normal(size=(128, 96)) * 2 + 5
    return J.AtrousTransform()(x, 4), x


def _port_coeffs(jc, rows=False):
    cube = torch.from_numpy(np.asarray(jc.data).copy())
    data = tuple(cube[s] for s in range(len(cube))) if rows else cube
    return T.Coefficients(data, T.B3spline(2))


@pytest.mark.parametrize("rows", [False, True])
def test_coefficients_noise_and_significance(coeffs_pair, rows):
    jc, _ = coeffs_pair
    tc = _port_coeffs(jc, rows)
    assert_rel(tc.get_noise(), np.asarray(jc.get_noise()), 1e-12)
    for sigma, scale, soft in [(3, 1, True), (2, 0, False), (0, 2, True)]:
        ref = np.asarray(jc.significance(sigma, scale, soft))
        got = tc.significance(sigma, scale, soft)
        assert_rel(got, ref.astype(np.float64), 1e-12)
    assert tc.noise is not None and rows == (tc._rows is not None)
    # a noise of 0 means no mask, as in the reference
    tc.noise = 0.0
    assert torch.equal(tc.significance(3, 1), torch.ones(128, 96,
                                                         dtype=torch.float64))


@pytest.mark.parametrize("sigma,weights,soft", [
    ((3, 2, 1, 1), None, True),          # residual untouched (zip)
    ((3, 0, 2, 1, 1), (1, 2, 1, 1, 0.5), False),
])
def test_coefficients_denoise(coeffs_pair, sigma, weights, soft):
    jc, _ = coeffs_pair
    jc = J.Coefficients(jc.data, jc.scaling_function)
    tc = _port_coeffs(jc, rows=True)
    jc.denoise(sigma, weights, soft)
    tc.denoise(sigma, weights, soft)
    assert_rel(tc.data, np.asarray(jc.data), 1e-12)
    assert_rel(tc.noise, np.asarray(jc.noise), 1e-12)


def test_coefficients_item_assignment(coeffs_pair):
    jc, _ = coeffs_pair
    for rows in (False, True):
        tc = _port_coeffs(jc, rows)
        before = tc.data.clone() if not rows else None
        tc[1] = tc[1] * 2
        tc[3] = np.zeros((128, 96))
        if rows:
            assert tc._rows is not None and len(tc) == 5
        else:
            assert not torch.equal(tc.data, before)
        ref = np.asarray(jc.data).copy()
        ref[1] *= 2
        ref[3] = 0
        assert np.array_equal(np.asarray(tc), ref)
    tc.data = np.ones((5, 4, 4))
    assert tc.data.shape == (5, 4, 4) and tc._rows is None


@pytest.mark.parametrize("inverse", [False, True])
def test_generalized_anscombe(inverse):
    x = np.random.default_rng(1).normal(size=(64, 64)) * 4
    kw = dict(alpha=1.3, g=0.2, sigma=0.5, inverse=inverse)
    assert_rel(tstats.generalized_anscombe(torch.from_numpy(x), **kw),
               np.asarray(jstats.generalized_anscombe(jnp.asarray(x), **kw)),
               1e-12)


@pytest.mark.parametrize("soft", [True, False])
def test_apply_denoise(coeffs_pair, soft):
    jc, _ = coeffs_pair
    planes = np.asarray(jc.data).copy()
    args = ((4, 0, 2), (1.0, 0.5, 2.0, 3.0), (0.9, 0.2, 0.08), 0.3, soft)
    ref = jstats.apply_denoise(jnp.asarray(planes), *args)
    got = tstats.apply_denoise(torch.from_numpy(planes), *args[:3],
                               torch.tensor(0.3, dtype=torch.float64),
                               soft)
    assert_rel(got, np.asarray(ref), 1e-12)
    assert np.array_equal(to_np(got)[3:], planes[3:])

