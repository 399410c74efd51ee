"""Kernel A's deep step in halo mode (the sharded engine's band tail):
``hopper_deep.deep_whiten_step_plain(halo=R)`` on row bands, extended as
the sharded engine extends them, against the single-frame step, and
against JAX's ``pallas_deep.deep_whiten_step(halo=R)`` in interpret mode.

Tolerances: the bands concatenated are bitwise the single-frame plain
step (symmetric taps fold the same pairs whichever side the reflection
puts them, so the reflected halo equals the in-kernel reflection), s =
3..9; against JAX's interpret mode, the float32 standard 5e-6·max|ref|.
The kernel itself is held bitwise to this plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_close_scaled
from wavelets_tpu.ops import pallas_deep
from wavelets_tpu.ops.filters import B3SPLINE as JB3
from wavelets_tpu_torch.ops import _build, hopper_deep
from wavelets_tpu_torch.ops.conv import boundary_index
from wavelets_tpu_torch.ops.filters import B3SPLINE, TRIANGLE


def _bands(x, n_bands, R):
    """The windows of ``n_bands`` row bands of ``x`` extended by ``R`` rows
    a side, as the sharded engine builds them (a neighbour's rows, the
    image's symmetric reflection at its border, and past a band, the
    gathered plane read through the symmetric map)."""
    H = x.shape[-2]
    Hb = H // n_bands
    return [x.index_select(-2, boundary_index(H, b * Hb - R, "symmetric",
                                              length=Hb + 2 * R))
            .contiguous() for b in range(n_bands)]


@pytest.mark.parametrize("scale", range(3, 10))
@pytest.mark.parametrize("sf", [B3SPLINE, TRIANGLE], ids=["b3", "tri"])
def test_halo_bands_bitwise_to_the_frame(sf, scale):
    # 4 bands of 64 rows: from s = 4 (B3spline) the reach 2hw*2^s passes
    # the band, so the windows are gathered ones, reflected more than once
    rng = np.random.default_rng(scale)
    x = torch.from_numpy(rng.normal(size=(2, 256, 40)).astype(np.float32))
    recon = torch.from_numpy(
        rng.normal(size=(2, 256, 40)).astype(np.float32))
    thr = torch.tensor([0.5, 0.7])
    kw = dict(sf=sf, scale=scale, weight=1.3, masked=True)
    w, r, c = hopper_deep.deep_whiten_step_plain(x, recon.clone(), thr, **kw)
    R = 2 * sf.half_width << scale
    _build.reset_counters()
    outs = [hopper_deep.deep_whiten_step_plain(
        ext, recon[:, 64 * b:64 * (b + 1)].clone(), thr, halo=R, **kw)
        for b, ext in enumerate(_bands(x, 4, R))]
    assert dict(_build.PLAIN_CALLS) == {"whiten_step_halo": 4}
    for k, ref in enumerate((w, r, c)):
        np.testing.assert_array_equal(
            torch.cat([o[k] for o in outs], dim=1).numpy(), ref.numpy())


def test_halo_step_matches_jax_interpret():
    # one band of 64 interior rows, 128 columns, s = 4 (R = 64): the JAX
    # stream's halo mode (halo_blocks = R / 16) in interpret mode
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 64 + 128, 128)).astype(np.float32)
    recon = rng.normal(size=(1, 64, 128)).astype(np.float32)
    thr = np.array([0.6], np.float32)
    w_j, r_j, c_j = pallas_deep.deep_whiten_step(
        jnp.asarray(x), jnp.asarray(recon), jnp.asarray(thr), sf=JB3,
        scale=4, weight=1.1, soft=True, masked=True, interpret=True,
        halo=64)
    w, r, c = hopper_deep.deep_whiten_step(
        torch.from_numpy(x), torch.from_numpy(recon.copy()),
        torch.from_numpy(thr), sf=B3SPLINE, scale=4, weight=1.1,
        masked=True, halo=64)
    scale = float(np.abs(np.asarray(r_j)).max())
    assert_close_scaled(c, c_j, 5e-6)
    assert_close_scaled(w, w_j, 5e-6, scale)
    assert_close_scaled(r, r_j, 5e-6)


def test_halo_mode_arguments():
    x = torch.zeros((1, 64 + 2 * 32, 48))
    kw = dict(sf=B3SPLINE, scale=3, weight=1.0)
    with pytest.raises(ValueError, match="2\\*hw\\*2\\^scale"):
        hopper_deep.deep_whiten_step(x, None, torch.zeros(1), halo=16, **kw)
    with pytest.raises(TypeError, match="float32 only"):
        hopper_deep.deep_whiten_step(x.to(torch.bfloat16), None,
                                     torch.zeros(1), halo=32, **kw)
    with pytest.raises(ValueError, match="interior rows"):
        hopper_deep.deep_whiten_step(x, torch.zeros((1, 128, 48)),
                                     torch.zeros(1), halo=32, **kw)
    w, r, c = hopper_deep.deep_whiten_step(x, None, torch.zeros(1), halo=32,
                                           **kw)
    assert w.shape == c.shape == (1, 64, 48) and r is None


def test_halo_step_plans():
    # the two passes: H + R rows reading H + 2R, then H reading H + R, at
    # the true row dilation (no reflection: no map_step on the rows)
    p1, p2 = hopper_deep.halo_step_plans(3, 1024, 4096, 9, 2)
    assert p1.grid == (3072, 1, 3) and p2.grid == (1024, 1, 3)
    assert p1.index_bits == p2.index_bits == 32
    # 8 interior rows, R = 2048: 2056 rows in residue-class order of the
    # true dilation 512, five rows a class, the last class short
    p1, p2 = hopper_deep.halo_step_plans(1, 8, 64, 9, 2)
    assert p1.grid[0] == 512 * 5 and p2.grid[0] == 8
    # offsets span the source: 64 frames of 8192 (pass 1) and of 6144
    # (pass 2) rows of 4096
    p1, p2 = hopper_deep.halo_step_plans(64, 4096, 4096, 9, 2)
    assert p1.index_bits == 64 and p2.index_bits == 32
