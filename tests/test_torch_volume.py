"""3-D volume WOW: ``wavelets_tpu_torch.wow`` of a ``(D, H, W)`` volume
(transformed over all three axes) and of a volume's ``Coefficients``
against ``wavelets_tpu.wow`` (its XLA per-scale loop on the CPU, the
route the JAX package takes for volumes), and the volume's route through
kernel C's volume pass and kernel B.

Tolerances: float64 recon and planes ≤1e-12 relative; float32 within
``5e-6·max|ref recon|``."""

import numpy as np
import pytest
import torch

import wavelets_tpu as J
import wavelets_tpu_torch as T
from tests.torch_parity import assert_close_scaled, assert_rel
from wavelets_tpu_torch.ops import _build

CASES = {
    "lazy": dict(denoise_coefficients=[5, 2]),
    "known-hard": dict(noise=0.3, denoise_coefficients=[3, 1],
                       soft_threshold=False),
    "h-0.5": dict(h=0.5, denoise_coefficients=[3]),
    "preserve-variance": dict(preserve_variance=True, weights=[1, 2]),
    "no-whitening": dict(whitening=False, n_scales=2),
    "bilateral": dict(bilateral=1, denoise_coefficients=[3]),
}


@pytest.fixture(scope="module")
def volume():
    return np.random.default_rng(31).normal(size=(16, 40, 48))


def _hold(rt, ct, rj, cj, dtype):
    rj = np.asarray(rj)
    assert len(ct) == len(cj) and rt.shape == rj.shape
    for k in range(len(cj)):
        assert ct[k].shape == np.asarray(cj[k]).shape
        if dtype == np.float64:
            assert_rel(ct[k], np.asarray(cj[k]), 1e-12)
        else:
            assert_close_scaled(ct[k], np.asarray(cj[k]), 5e-6,
                                float(np.abs(rj).max()))
    if dtype == np.float64:
        assert_rel(rt, rj, 1e-12)
    else:
        assert_close_scaled(rt, rj, 5e-6)


VOLUME_CASES = ([(c, np.float64) for c in sorted(CASES)]
                + [(c, np.float32) for c in sorted(set(CASES) - {"bilateral"})])


@pytest.mark.parametrize("case,dtype", VOLUME_CASES,
                         ids=[f"{np.dtype(d).name}-{c}"
                              for c, d in VOLUME_CASES])
def test_volume_wow_matches_jax(volume, case, dtype):
    x = volume.astype(dtype)
    rj, cj = J.wow(x, **CASES[case])
    rt, ct = T.wow(x, device="cpu", **CASES[case])
    assert rt.dtype == torch.from_numpy(x).dtype
    assert ct.scaling_function.n_dim == 3
    _hold(rt, ct, rj, cj, dtype)


@pytest.mark.parametrize("case", ["lazy", "h-0.5", "no-whitening"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_volume_coefficients_wow_matches_jax(volume, case, dtype):
    x = volume.astype(dtype)
    rj, cj = J.wow(J.AtrousTransform()(x, 2), **CASES[case])
    rt, ct = T.wow(T.AtrousTransform()(x, 2, device="cpu"), **CASES[case])
    _hold(rt, ct, rj, cj, dtype)


def test_volume_route():
    # float32: kernel C's volume pass a scale, kernel B on the finest
    # plane (their plain versions on a CPU tensor), the per-scale loop;
    # fuse=False runs the plain chain and kernel B's plain version
    x = np.random.default_rng(2).normal(size=(16, 64, 64)).astype(np.float32)
    _build.reset_counters()
    r, c = T.wow(x, denoise_coefficients=[5, 2], device="cpu")
    assert dict(_build.PLAIN_CALLS) == {"decompose_group": len(c) - 1,
                                        "median_select": 1}
    _build.reset_counters()
    r_p, _ = T.wow(x, denoise_coefficients=[5, 2], fuse=False, device="cpu")
    assert dict(_build.PLAIN_CALLS) == {"median_select": 1}
    assert not _build.LAUNCHES
    assert torch.equal(r, r_p)
    # float16 (once refused): the plain per-scale loop in float16, as the
    # JAX package sends it to XLA, within 2^-8 of JAX's reconstruction
    h = (x[:8, :32, :32] * 3).astype(np.float16)
    _build.reset_counters()
    r16, c16 = T.wow(torch.from_numpy(h), denoise_coefficients=[5, 2])
    assert r16.dtype == torch.float16 and not _build.LAUNCHES
    assert "decompose_group" not in _build.PLAIN_CALLS
    assert_close_scaled(r16.float(), np.asarray(J.wow(
        h, denoise_coefficients=[5, 2])[0], np.float32), 2 ** -8)
