"""Kernels D and E through their plain versions against the TPU kernels
they replace, in interpret mode: ``hopper_wow.fused_whiten_pieces_plain``
against ``pallas_wow.fused_whiten_pieces``,
``hopper_deep.deep_whiten_plane_plain`` against
``pallas_deep.deep_whiten_plane`` and
``hopper_deep.deep_whiten_step2_plain`` against
``pallas_deep.deep_whiten_step2``.

Tolerances: whitened planes, the partial reconstruction and the gamma
sum within ``5e-6·max|ref|`` (the standard of
tests/test_pallas_merged.py:61; the TPU kernels' Abramowitz-Stegun erf
differs from the true erf by ≤1.5e-7); the pair's carry within 4 units
in the last place of its magnitude against the interpret-mode kernel
(one FMA contracted per fold) and ≤1 ulp against the JAX package's
smooth run op by op."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_parity import assert_close_scaled, to_np, ulp_distance
from wavelets_tpu.ops import conv as jconv
from wavelets_tpu.ops import pallas_conv, pallas_deep, pallas_wow
from wavelets_tpu.ops.filters import B3SPLINE as JB3
from wavelets_tpu_torch.ops import _build, hopper_conv, hopper_deep, hopper_wow
from wavelets_tpu_torch.ops.filters import B3SPLINE

LAYOUT = ((0, 0), (0, 1), (0, 2))


@pytest.fixture(scope="module")
def pieces():
    """Two frames of 256², decomposed over 3 scales: ``(4, 2, 256, 256)``."""
    x = np.random.default_rng(21).normal(size=(2, 256, 256)) * 3 + 10
    return np.asarray(pallas_conv._fused_group(
        jnp.asarray(x.astype(np.float32)), 3, JB3, interpret=True)
    ).astype(np.float32)


@pytest.mark.parametrize("per_frame", [False, True])
@pytest.mark.parametrize("write_planes,write_gamma",
                         [(True, False), (False, False), (True, True),
                          (False, True)])
def test_whiten_pieces_plain_vs_pallas(pieces, per_frame, write_planes,
                                       write_gamma):
    fac = np.asarray([[1.5, 0.7], [0.5, 2.0], [2.0, 1.0]], np.float32)
    fac = fac if per_frame else fac[:, 0]
    sig = np.abs(pieces[:3]).std(axis=(2, 3))
    # thresholds near each plane's scale; a zero one means no mask
    thr = (np.asarray([[2.0, 0.0], [0.7, 1.0], [0.0, 3.0]]) * sig
           ).astype(np.float32)
    ref = pallas_wow.fused_whiten_pieces(
        (jnp.asarray(pieces),), jnp.asarray(fac), jnp.asarray(thr), JB3, 3,
        LAYOUT, write_planes=write_planes, write_gamma=write_gamma,
        interpret=True)
    got = hopper_wow.fused_whiten_pieces_plain(
        (torch.from_numpy(pieces),), torch.from_numpy(fac),
        torch.from_numpy(thr), B3SPLINE, 3, LAYOUT,
        write_planes=write_planes, write_gamma=write_gamma)
    assert len(got) == len(ref)
    recon_scale = float(np.abs(np.asarray(ref[1])).max())
    assert_close_scaled(got[1], ref[1], 5e-6)
    if write_planes:
        assert got[0].shape == (3, 2, 256, 256)
        assert_close_scaled(got[0], ref[0], 5e-6, recon_scale)
    else:
        assert got[0] is None and ref[0] is None
    if write_gamma:
        assert_close_scaled(got[2], ref[2], 5e-6)


def test_whiten_pieces_layouts_and_dispatch(pieces):
    # rows as pieces of their own give the cube's numbers; a CPU tensor
    # takes the plain version; the frame-stack layout is the scale-major
    # whites permuted, in place in a given cube whose later rows stay
    cube = torch.from_numpy(pieces)
    rows = tuple(cube[s][None] for s in range(3))
    args = (torch.ones(3), torch.zeros(3), B3SPLINE, 3)
    _build.reset_counters()
    a = hopper_wow.fused_whiten_pieces((cube,), *args, LAYOUT)
    b = hopper_wow.fused_whiten_pieces(rows, *args,
                                       ((0, 0), (1, 0), (2, 0)))
    assert _build.PLAIN_CALLS == {"whiten_plane": 2}
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[1].data_ptr() != a[0].data_ptr()
    out = torch.full((cube.shape[1], 5) + cube.shape[2:], -7.0)
    c = hopper_wow.fused_whiten_pieces((cube,), *args, LAYOUT,
                                       batch_major=True, out_rows_total=5,
                                       out=out)
    assert c[0] is out and torch.equal(c[1], a[1])
    assert torch.equal(out[:, :3], a[0].permute(1, 0, 2, 3))
    assert bool((out[:, 3:] == -7.0).all())
    with pytest.raises(ValueError, match="batch-major only"):
        hopper_wow.fused_whiten_pieces((cube,), *args, LAYOUT,
                                       out_rows_total=5)


@pytest.mark.parametrize("s", [4, 5])
@pytest.mark.parametrize("mode", ["soft", "hard", "unmasked"])
def test_deep_plane_plain_vs_pallas(s, mode):
    c = np.random.default_rng(s).normal(size=(1, 256, 256)).astype(np.float32)
    thr = np.asarray([0.8], np.float32)
    kw = dict(scale=s, weight=1.5, soft=mode == "soft",
              masked=mode != "unmasked")
    ref = pallas_deep.deep_whiten_plane(jnp.asarray(c), jnp.asarray(thr),
                                        sf=JB3, interpret=True, **kw)
    got = hopper_deep.deep_whiten_plane_plain(
        torch.from_numpy(c), torch.from_numpy(thr), sf=B3SPLINE, **kw)
    assert_close_scaled(got, ref, 5e-6)


@pytest.mark.parametrize("mode", ["soft", "hard", "unmasked"])
@pytest.mark.parametrize("write_plane", [True, False])
def test_deep_plane_recon_vs_pallas(mode, write_plane):
    # the recon add in the kernel's epilogue: recon += white in place,
    # white written or not; the white against the interpret-mode kernel,
    # the recon it was added to bitwise the out-of-place sum of the same
    # white
    rng = np.random.default_rng(13)
    c = rng.normal(size=(2, 256, 256)).astype(np.float32)
    recon0 = rng.normal(size=(2, 256, 256)).astype(np.float32)
    thr = np.asarray([0.8, 0.0], np.float32)
    kw = dict(scale=4, weight=1.5, soft=mode == "soft",
              masked=mode != "unmasked")
    ref = pallas_deep.deep_whiten_plane(jnp.asarray(c), jnp.asarray(thr),
                                        sf=JB3, interpret=True, **kw)
    recon = torch.from_numpy(recon0.copy())
    _build.reset_counters()
    got = hopper_deep.deep_whiten_plane(
        torch.from_numpy(c), torch.from_numpy(thr), sf=B3SPLINE, recon=recon,
        write_plane=write_plane, **kw)
    assert _build.PLAIN_CALLS == {"whiten_plane": 1}
    white = hopper_deep.deep_whiten_plane(
        torch.from_numpy(c), torch.from_numpy(thr), sf=B3SPLINE, **kw)
    assert_close_scaled(white, ref, 5e-6)
    assert torch.equal(recon, torch.from_numpy(recon0) + white)
    assert_close_scaled(recon, recon0 + np.asarray(ref), 5e-6)
    if write_plane:
        assert torch.equal(got, white)
    else:
        assert got is None
    with pytest.raises(ValueError, match="write_plane"):
        hopper_deep.deep_whiten_plane(
            torch.from_numpy(c), torch.from_numpy(thr), sf=B3SPLINE,
            write_plane=False, **kw)


def test_deep_plane_runtime_factor_and_gamma():
    c = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 64, 64))
                         .astype(np.float32))
    thr = torch.tensor([0.5, 0.0])
    gamma = torch.ones_like(c)
    w = hopper_deep.deep_whiten_plane(c, thr, sf=B3SPLINE, scale=3,
                                      weight=torch.tensor([2.0, 0.5]),
                                      masked=True, gamma=gamma)
    for b, f in enumerate((2.0, 0.5)):
        ref, wc = hopper_conv.whiten_detail_plain(
            c[b], f, thr[b], B3SPLINE, 3, True)
        assert torch.equal(w[b], ref)
        assert torch.equal(gamma[b], 1 + wc)


PAIR_CASES = {
    "soft-first-masked": (True, (True, False), False),
    "hard-both-masked-recon": (False, (True, True), True),
    "unmasked-recon": (True, (False, False), True),
}


@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_deep_pair_plain_vs_pallas(case):
    soft, masked, with_recon = PAIR_CASES[case]
    rng = np.random.default_rng(len(case))
    carry = (rng.normal(size=(1, 256, 256)) * 3 + 10).astype(np.float32)
    recon = (rng.normal(size=carry.shape).astype(np.float32)
             if with_recon else None)
    thr = np.asarray([[0.3], [0.1]], np.float32)
    kw = dict(scale=4, weights=(1.5, 0.5), soft=soft, masked=masked)
    assert pallas_deep.can_deep2(jnp.asarray(carry), JB3, 4, None)
    w1, w2, rec, cn = pallas_deep.deep_whiten_step2(
        jnp.asarray(carry), None if recon is None else jnp.asarray(recon),
        jnp.asarray(thr), sf=JB3, interpret=True, **kw)
    t_recon = None if recon is None else torch.from_numpy(recon.copy())
    g1, g2, grec, gcn = hopper_deep.deep_whiten_step2_plain(
        torch.from_numpy(carry), t_recon, torch.from_numpy(thr), sf=B3SPLINE,
        **kw)
    assert_close_scaled(g1, w1, 5e-6)
    assert_close_scaled(g2, w2, 5e-6)
    if with_recon:
        assert grec is t_recon
        assert_close_scaled(grec, rec, 5e-6)
    else:
        assert grec is None
    ref = np.asarray(cn)
    assert np.abs(to_np(gcn) - ref).max() <= 4 * np.spacing(np.abs(ref).max())
    xla = jnp.asarray(carry[0])
    for s in (4, 5):
        xla = jconv.smooth(xla, JB3, scale=s)
    assert ulp_distance(gcn[0], xla) <= 1


def test_pair_gate():
    # kernel E's own gate: 2^s divides H and W, and the four torus
    # buffers (16·(2H/D)·(2W/D) bytes) fit 227 KB of shared memory
    assert hopper_deep.can_deep2(torch.zeros(1, 256, 256), B3SPLINE, 4)
    assert hopper_deep.can_deep2(torch.zeros(1, 4096, 4096), B3SPLINE, 7)
    assert hopper_deep.can_deep2(torch.zeros(1, 200, 328), B3SPLINE, 3)
    assert not hopper_deep.can_deep2(torch.zeros(1, 250, 256), B3SPLINE, 3)
    assert not hopper_deep.can_deep2(torch.zeros(1, 4096, 4096), B3SPLINE, 4)
