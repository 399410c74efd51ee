"""Noise statistics of the PyTorch port vs the JAX package: the exact
median (bitwise, numpy's even-count rule), the MAD noise and the
significance masks."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_parity import assert_rel
from wavelets_tpu.ops import pallas_stats
from wavelets_tpu.ops import stats as jstats
from wavelets_tpu_torch.ops import _build, hopper_stats
from wavelets_tpu_torch.ops import stats as tstats


def _data(rng, n, kind, dtype):
    if kind == "normal":
        return rng.normal(size=n).astype(dtype)
    if kind == "ties":
        # heavy ties straddling the middle, with signs
        return rng.choice(np.array([-2.0, -1.0, 0.0, 1.0, 1.5]),
                          size=n).astype(dtype)
    return (rng.normal(size=n) * 1e-30).astype(dtype)  # tiny / subnormal


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 1001, 4096])
@pytest.mark.parametrize("kind", ["normal", "ties", "tiny"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_median_abs_bitwise(rng, n, kind, dtype):
    x = _data(rng, n, kind, dtype)
    got = tstats.median_abs(torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype and got.ndim == 0
    want = np.median(np.abs(x))
    assert got.numpy().tobytes() == want.tobytes()
    assert np.asarray(jnp.median(jnp.abs(jnp.asarray(x)))).tobytes() \
        == want.tobytes()


@pytest.mark.parametrize("fuse", [True, False])
def test_median_abs_float32_goes_through_kernel_b(rng, fuse):
    x = torch.from_numpy(rng.normal(size=(30, 40)).astype(np.float32))
    _build.reset_counters()
    tstats.median_abs(x, fuse=fuse)
    # a CPU tensor takes the plain version either way, never a launch
    assert _build.PLAIN_CALLS[hopper_stats.KERNEL] == 1
    assert _build.LAUNCHES[hopper_stats.KERNEL] == 0


def test_median_of_2d_frame(rng):
    x = rng.normal(size=(64, 96)).astype(np.float32)
    got = tstats.median_abs(torch.from_numpy(x))
    assert float(got) == float(np.median(np.abs(x)))


@pytest.mark.parametrize("rows", [1, 3, 64])
@pytest.mark.parametrize("kind", ["normal", "ties", "tiny"])
def test_median_bits2_plain_vs_pallas(rng, rows, kind):
    """The plain version of kernel B against the TPU kernel in interpret
    mode, on the TPU kernel's (rows, 1024) layout: bitwise."""
    x = np.abs(_data(rng, rows * 1024, kind, np.float32)).reshape(rows, 1024)
    bits = x.view(np.int32)
    n = bits.size
    ks = [(n - 1) // 2, n // 2]
    ref = pallas_stats.median_bits2(jnp.asarray(bits),
                                    jnp.asarray(ks, jnp.int32),
                                    interpret=True)
    got = hopper_stats.median_bits2_plain(torch.from_numpy(bits), ks)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("ks", [(0, 0), (5, 6), (4095, 4095), (100, 3000)])
def test_median_bits2_any_ranks(rng, ks):
    x = rng.normal(size=4096).astype(np.float32)
    got = hopper_stats.median_bits2(torch.from_numpy(x.view(np.int32)), ks)
    srt = np.sort(np.abs(x))
    assert np.array_equal(got.numpy().view(np.float32), srt[list(ks)])


def test_median_bits2_rejects_bad_ranks():
    bits = torch.zeros(8, dtype=torch.int32)
    for ks in [(3, 2), (-1, 0), (7, 8)]:
        with pytest.raises(ValueError):
            hopper_stats.median_bits2(bits, ks)
    with pytest.raises(TypeError):
        hopper_stats.median_abs(torch.zeros(4, dtype=torch.float64))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mad_noise(rng, dtype):
    w0 = rng.normal(size=(80, 64)).astype(dtype) * 0.3
    ref = jstats.mad_noise(jnp.asarray(w0), 0.8907)
    got = tstats.mad_noise(torch.from_numpy(w0), 0.8907)
    assert_rel(got, ref, 1e-12 if dtype == np.float64 else 1e-6)


@pytest.mark.parametrize("soft", [True, False])
@pytest.mark.parametrize("noise", [0.0, 0.05, 0.7])
@pytest.mark.parametrize("sigma", [1.0, 3.0])
def test_significance(rng, soft, noise, sigma):
    w = rng.normal(size=(40, 50))
    ref = jstats.significance(jnp.asarray(w), sigma, jnp.asarray(noise),
                              0.2, soft)
    got = tstats.significance(torch.from_numpy(w), sigma,
                              torch.tensor(noise, dtype=torch.float64), 0.2,
                              soft)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=0)
    if noise == 0.0:
        assert bool((got == 1).all())


def test_significance_elementary_masks(rng):
    w = rng.normal(size=200)
    t = 0.4
    np.testing.assert_allclose(
        tstats.significance_soft(torch.from_numpy(w), t).numpy(),
        np.asarray(jstats.significance_soft(jnp.asarray(w), t)),
        rtol=1e-12)
    assert np.array_equal(
        tstats.significance_hard(torch.from_numpy(w), t).numpy(),
        np.asarray(jstats.significance_hard(jnp.asarray(w), t)))
    assert tstats.MAD_TO_SIGMA == jstats.MAD_TO_SIGMA
