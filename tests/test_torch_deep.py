"""Kernel A driven for one deep scale: the plain version of
``hopper_deep.deep_whiten_step`` against the TPU kernel it replaces,
``pallas_deep.deep_whiten_step``, in interpret mode.

Tolerances as in tests/test_torch_kernels.py: whitened plane and recon
within ``5e-6·max|ref|``; the carry ≤1 ulp against the JAX package's
XLA smooth and within 4 units in the last place of its magnitude against
the interpret-mode kernel (FMA contraction, tests/test_pallas_deep.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_parity import assert_close_scaled, to_np, ulp_distance
from wavelets_tpu.ops import conv as jconv
from wavelets_tpu.ops import pallas_deep
from wavelets_tpu.ops.filters import B3SPLINE as JB3
from wavelets_tpu_torch.ops import hopper_deep
from wavelets_tpu_torch.ops.filters import B3SPLINE


def _stack(seed, n, b=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, n, n)).astype(np.float32)


def _compare(carry, thr, s, soft, masked, weight, with_recon):
    recon = (np.random.default_rng(3).normal(size=carry.shape)
             .astype(np.float32) if with_recon else None)
    white, rec, cn = pallas_deep.deep_whiten_step(
        jnp.asarray(carry), None if recon is None else jnp.asarray(recon),
        jnp.asarray(thr), sf=JB3, scale=s, weight=weight, soft=soft,
        masked=masked, interpret=True)
    t_recon = None if recon is None else torch.from_numpy(recon.copy())
    gw, grec, gcn = hopper_deep.deep_whiten_step_plain(
        torch.from_numpy(carry), t_recon, torch.from_numpy(thr), sf=B3SPLINE,
        scale=s, weight=weight, soft=soft, masked=masked)
    assert_close_scaled(gw, white, 5e-6)
    if with_recon:
        assert grec is t_recon
        assert_close_scaled(grec, rec, 5e-6)
    else:
        assert grec is None
    for b in range(carry.shape[0]):
        xla = jconv.smooth(jnp.asarray(carry[b]), JB3, scale=s)
        assert ulp_distance(gcn[b], xla) <= 1
    ref = np.asarray(cn)
    err = np.abs(to_np(gcn) - ref).max()
    assert err <= 4 * np.spacing(np.abs(ref).max()), err


@pytest.mark.parametrize("s", [4, 5, 6])
def test_deep_step_masked_soft_per_frame(s):
    carry = _stack(s, 256)
    # frame 1 has threshold 0: no mask there
    thr = np.asarray([0.15, 0.0], np.float32)
    _compare(carry, thr, s, soft=True, masked=True, weight=1.5,
             with_recon=False)


def test_deep_step_masked_hard():
    _compare(_stack(11, 256), np.asarray([0.1, 0.3], np.float32), 5,
             soft=False, masked=True, weight=0.5, with_recon=False)


def test_deep_step_unmasked_with_recon_512():
    _compare(_stack(12, 512, b=1), np.zeros(1, np.float32), 6, soft=True,
             masked=False, weight=1.0, with_recon=True)


def test_deep_step_argument_checks():
    x = torch.zeros(1, 16, 16)
    with pytest.raises(ValueError):
        hopper_deep.deep_whiten_step_plain(
            x[0], None, torch.zeros(1), sf=B3SPLINE, scale=1, weight=1.0)
    with pytest.raises(ValueError):
        hopper_deep.deep_whiten_step_plain(
            x, None, torch.zeros(1), sf=B3SPLINE, scale=1, weight=1.0,
            write_plane=False)
    with pytest.raises(ValueError):
        hopper_deep.deep_whiten_step_plain(
            x, torch.zeros(1, 8, 8), torch.zeros(1), sf=B3SPLINE, scale=1,
            weight=1.0)


def test_deep_step_without_plane():
    x = torch.from_numpy(_stack(5, 64, b=1))
    recon = torch.zeros_like(x)
    white, rec, cn = hopper_deep.deep_whiten_step_plain(
        x, recon, torch.zeros(1), sf=B3SPLINE, scale=2, weight=1.0,
        write_plane=False)
    w2, _, cn2 = hopper_deep.deep_whiten_step_plain(
        x, None, torch.zeros(1), sf=B3SPLINE, scale=2, weight=1.0)
    assert white is None and torch.equal(rec, w2) and torch.equal(cn, cn2)
