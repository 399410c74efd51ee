"""The bilateral slice of the port against the JAX package: the plain
primitives (``local_variance``, ``sdev_loc``, ``atrous_conv_nd``), kernel
F's plain version (``hopper_bilateral.fused_bilateral_group_plain``)
against ``pallas_bilateral._fused_group`` in interpret mode, kernel G's
(``hopper_deep.deep_bilateral_whiten_step_plain``) against
``pallas_deep.deep_bilateral_whiten_step`` in interpret mode, and the
bilateral transform, ``denoise`` and ``wow`` against the JAX package's
XLA route, with the launch counters of each route.

Tolerances: float64 ≤1e-12 relative; float32 within ``5e-6·max|ref|``
(whitened planes at the reconstruction's scale, as tests/test_torch_wow.py
holds them).  The inputs are zero-mean: the bilateral range weights
``exp(−Δ²/2V)`` amplify float32 round-off of the local variance, which
cancels on data with a large mean, in the JAX package and the port alike;
the large-mean case is held where both sides run the same operations."""

import importlib
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import wavelets_tpu as J
import wavelets_tpu_torch as T
from tests.torch_parity import assert_close_scaled, assert_rel, to_np
from wavelets_tpu.core import transform as jtransform
from wavelets_tpu.ops import conv as jconv
from wavelets_tpu.ops import pallas_bilateral, pallas_deep
from wavelets_tpu.ops.filters import B3SPLINE as JB3
from wavelets_tpu.ops.filters import TRIANGLE as JTRI
from wavelets_tpu_torch.core import transform as ttransform
from wavelets_tpu_torch.ops import _build, hopper_bilateral, hopper_deep
from wavelets_tpu_torch.ops import conv as tconv
from wavelets_tpu_torch.ops.filters import B3SPLINE, TRIANGLE

jwow = importlib.import_module("wavelets_tpu.models.wow")
twow = importlib.import_module("wavelets_tpu_torch.models.wow")

SPECS = {"b3": (JB3, B3SPLINE), "tri": (JTRI, TRIANGLE)}
SHAPES = {1: (300,), 2: (48, 56), 3: (10, 14, 12)}


def _x(shape, seed=0, dtype=np.float32, offset=0.0):
    return (np.random.default_rng(seed).normal(size=shape) + offset
            ).astype(dtype)


def _close(got, ref, dtype, scale=None):
    """float64 ≤1e-12 and float32 ≤5e-6 of ``max(max|ref|, scale)``: a
    whitened plane is held at the reconstruction's ``scale`` (a deep plane
    of a small frame is round-off of a nearly constant carry)."""
    ref = np.asarray(ref)
    if dtype == np.float64 and scale is None:
        assert_rel(got, ref, 1e-12)
    elif dtype == np.float64:
        err = float(np.abs(to_np(got) - ref).max())
        assert err <= 1e-12 * max(scale, float(np.abs(ref).max())), err
    else:
        assert_close_scaled(got, ref, 5e-6, scale)


# ---------------------------------------------------------------------
# the plain primitives (ops/conv.py)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("offset", [0.0, 1000.0])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("variance", [True, False])
def test_sdev_loc_matches_jax(nd, offset, dtype, variance):
    x = _x(SHAPES[nd], seed=nd, dtype=dtype, offset=offset)
    for s in (0, 2):
        ref = jconv.sdev_loc(jnp.asarray(x), JB3, s, variance=variance)
        got = tconv.sdev_loc(torch.from_numpy(x), B3SPLINE, s,
                             variance=variance)
        assert got.dtype == torch.from_numpy(x).dtype
        _close(got, ref, dtype)
    # the local variance alone, and its ≤0 → 1e-20 clamp on a constant
    c = np.full(SHAPES[nd], 3.0, dtype)
    assert np.all(tconv.local_variance(torch.from_numpy(c), B3SPLINE, 1)
                  .numpy() == np.asarray(jconv.local_variance(
                      jnp.asarray(c), JB3, 1)))


@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("bilateral", [False, True])
@pytest.mark.parametrize("offset", [0.0, 1000.0])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_atrous_conv_nd_matches_jax(nd, bilateral, offset, dtype):
    x = _x(SHAPES[nd], seed=10 + nd, dtype=dtype, offset=offset)
    kernel = JB3.kernel_nd(nd)
    for s in (0, 1, 3):
        var = None
        if bilateral:
            var = np.asarray(jconv.local_variance(jnp.asarray(x), JB3, s)
                             * jnp.asarray(2.25, x.dtype))
        ref = jconv.atrous_conv_nd(
            jnp.asarray(x), kernel, s,
            bilateral_variance=None if var is None else jnp.asarray(var))
        got = tconv.atrous_conv_nd(
            torch.from_numpy(x), kernel, s,
            bilateral_variance=None if var is None else torch.from_numpy(
                var.copy()))
        _close(got, ref, dtype)


@pytest.mark.parametrize("shape", [(3,), (5, 5), (3, 5), (3, 3, 3)])
def test_noncenter_offsets_match_jax(shape):
    assert tconv._noncenter_offsets(shape) == jconv._noncenter_offsets(shape)


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_kernel_nd_matches_jax(name, nd):
    jspec, tspec = SPECS[name]
    got, ref = tspec.kernel_nd(nd), jspec.kernel_nd(nd)
    assert got.dtype == ref.dtype == np.float64
    assert np.array_equal(got, ref)


def test_bilateral_smooth_batches_leading_axes():
    x = torch.from_numpy(_x((3, 32, 40), seed=4, dtype=np.float64))
    got = tconv.bilateral_smooth(x, B3SPLINE, 2, 1.5, True, axes=(1, 2))
    for b in range(3):
        want = tconv.bilateral_smooth(x[b], B3SPLINE, 2, 1.5, True)
        assert torch.equal(got[b], want)
    with pytest.raises(ValueError, match="leading"):
        tconv.bilateral_smooth(x, B3SPLINE, 0, 1.0, axes=(0, 2))


# ---------------------------------------------------------------------
# kernel F's plain version against the TPU kernel (interpret mode)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("offset", [0, 2])
@pytest.mark.parametrize("scaling", [False, True])
def test_bilateral_group_plain_vs_pallas(offset, scaling):
    x = _x((128, 256), seed=offset)
    sig = (1.5, 0.7, 2.0)
    # the TPU kernel takes σ²·(s+1) as one static factor
    var_factors = tuple(v * v * ((offset + k + 1) if scaling else 1)
                        for k, v in enumerate(sig))
    ref = np.asarray(pallas_bilateral._fused_group(
        jnp.asarray(x), 3, JB3, var_factors, offset=offset, interpret=True))
    _build.reset_counters()
    got = hopper_bilateral.fused_bilateral_group(
        torch.from_numpy(x), 3, B3SPLINE, [v * v for v in sig], offset,
        scaling)
    assert _build.PLAIN_CALLS == {"bilateral_group": 1}
    assert got.shape == ref.shape == (4, 128, 256)
    assert_close_scaled(got, ref, 5e-6)
    # round trip of the group: details + carry give back the input
    assert_close_scaled(got.sum(0), x, 1e-6)


def test_bilateral_group_plain_is_the_plain_chain():
    x = torch.from_numpy(_x((2, 40, 56), seed=3))
    bil = (1.0, 2.0, 0.5, 1.5)
    got = hopper_bilateral.fused_bilateral_group_plain(
        x, 3, B3SPLINE, [v * v for v in bil[:3]], 0, True)
    want = ttransform.decompose(x, 3, B3SPLINE, axes=(1, 2), bilateral=bil,
                                bilateral_scaling=True, fuse=False)
    assert torch.equal(got, want)


def test_bilateral_group_rejects_bad_arguments():
    x = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="at least one"):
        hopper_bilateral.fused_bilateral_group_plain(x, 0, B3SPLINE, ())
    with pytest.raises(ValueError, match="one entry per scale"):
        hopper_bilateral.fused_bilateral_group(x, 2, B3SPLINE, (1.0,))


# ---------------------------------------------------------------------
# kernel G's plain version against the TPU kernel (interpret mode)
# ---------------------------------------------------------------------

STEP_CASES = {
    "soft": dict(masked=True, soft=True, scaling=False, thr=(0.6,)),
    "hard-scaling": dict(masked=True, soft=False, scaling=True, thr=(0.6,)),
    "unmasked": dict(masked=False, soft=True, scaling=False, thr=(0.0,)),
    "stack": dict(masked=True, soft=True, scaling=True, thr=(0.6, 0.0)),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_deep_bilateral_step_plain_vs_pallas(case):
    c = STEP_CASES[case]
    s, sigma, weight = 4, 1.5, 1.25
    x = _x((len(c["thr"]), 256, 256), seed=len(case))
    thr = np.asarray(c["thr"], np.float32)
    assert pallas_deep.can_deep_bilateral(jnp.asarray(x), JB3, s)
    vf = sigma ** 2 * ((s + 1) if c["scaling"] else 1)
    ref_w, ref_c = pallas_deep.deep_bilateral_whiten_step(
        jnp.asarray(x), jnp.asarray(thr), sf=JB3, scale=s, var_factor=vf,
        weight=weight, soft=c["soft"], masked=c["masked"], interpret=True)
    recon = torch.from_numpy(_x(x.shape, seed=99))
    recon0 = recon.clone()
    _build.reset_counters()
    got_w, got_c = hopper_deep.deep_bilateral_whiten_step(
        torch.from_numpy(x), torch.from_numpy(thr), sf=B3SPLINE, scale=s,
        var_factor=sigma ** 2, weight=weight, soft=c["soft"],
        masked=c["masked"], bilateral_scaling=c["scaling"], recon=recon)
    assert _build.PLAIN_CALLS == {"bilateral_step": 1}
    assert_close_scaled(got_c, np.asarray(ref_c), 5e-6)
    assert_close_scaled(got_w, np.asarray(ref_w), 5e-6)
    # recon accumulates the whitened plane in place
    assert torch.equal(recon, recon0 + got_w)


def test_deep_bilateral_step_plain_without_plane():
    x = torch.from_numpy(_x((1, 64, 80), seed=5))
    recon = torch.zeros_like(x)
    kw = dict(sf=B3SPLINE, scale=3, var_factor=1.0, weight=1.0)
    white, c_next = hopper_deep.deep_bilateral_whiten_step(x, 0.0, **kw)
    none, c_next2 = hopper_deep.deep_bilateral_whiten_step(
        x, 0.0, recon=recon, write_plane=False, **kw)
    assert none is None and torch.equal(c_next, c_next2)
    assert torch.equal(recon, white)
    with pytest.raises(ValueError, match="write_plane"):
        hopper_deep.deep_bilateral_whiten_step(x, 0.0, write_plane=False,
                                               **kw)


def test_can_deep_bilateral_takes_any_shape():
    for shape, s in [((1, 257, 513), 8), ((1, 37, 70), 9), ((64, 96), 0)]:
        assert hopper_deep.can_deep_bilateral(torch.zeros(shape), B3SPLINE,
                                              s)
    assert not hopper_deep.can_deep_bilateral(
        torch.zeros(1, 8, 8, dtype=torch.float64), B3SPLINE, 0)
    assert not hopper_deep.can_deep_bilateral(torch.zeros(8), B3SPLINE, 0)


# ---------------------------------------------------------------------
# the bilateral transform
# ---------------------------------------------------------------------

DECOMPOSE_CASES = {
    # name: (shape, level, bilateral as given, scaling, axes)
    "scalar": ((64, 80), 4, 1.5, False, None),
    "short-list": ((64, 80), 5, [2.0, 0.5], False, None),
    "scaling": ((64, 80), 4, [1.0, 2.0, 0.5, 1.0, 1.5], True, None),
    "stack": ((2, 48, 56), 4, 1.0, True, (1, 2)),
    "1d": ((300,), 4, [1.0, 0.5], False, None),
    "3d": ((10, 14, 12), 2, 1.0, False, None),
}


@pytest.mark.parametrize("case", sorted(DECOMPOSE_CASES))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_decompose_bilateral_matches_jax(case, dtype):
    shape, level, bil, scaling, axes = DECOMPOSE_CASES[case]
    x = _x(shape, seed=len(case), dtype=dtype)
    sig = ttransform.normalize_bilateral(bil, level)
    assert sig == jtransform.normalize_bilateral(bil, level)
    ref = np.asarray(jtransform.decompose(
        jnp.asarray(x), level, JB3, axes=axes, bilateral=sig,
        bilateral_scaling=scaling))
    _build.reset_counters()
    got = ttransform.decompose(torch.from_numpy(x), level, B3SPLINE,
                               axes=axes, bilateral=sig,
                               bilateral_scaling=scaling)
    # a float32 frame or stack takes kernel F's route, groups of 3 scales;
    # 1-D, volumes and float64 the plain chain
    on_kernel = dtype == np.float32 and len(shape) - (axes is not None) == 2
    assert _build.PLAIN_CALLS == (
        {"bilateral_group": -(-level // 3)} if on_kernel else {})
    assert got.shape == ref.shape == (level + 1,) + shape
    _close(got, ref, dtype)
    # the round trip
    _close(got.sum(0), x, dtype, float(np.abs(x).max()))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("scaling", [False, True])
def test_atrous_transform_bilateral_matches_jax(dtype, scaling):
    x = _x((64, 72), seed=6, dtype=dtype)
    jc = J.AtrousTransform(J.B3spline, bilateral=[1.5, 1.0],
                           bilateral_scaling=scaling)(x, 5)
    tc = T.AtrousTransform(T.B3spline, bilateral=[1.5, 1.0],
                           bilateral_scaling=scaling)(x, 5, device="cpu")
    assert len(tc) == len(jc) == 6
    assert tc.bilateral == jc.bilateral == [1.5, 1.0]
    assert list(tc.sigma_e) == list(jc.sigma_e)
    _close(tc.data, jc.data, dtype)


def test_decompose_pieces_bilateral_defers_the_tail():
    x = _x((64, 80), seed=7)
    sig = (1.0, 2.0, 0.5, 1.0, 1.5, 1.0)
    ref = np.asarray(jtransform.decompose(jnp.asarray(x), 5, JB3,
                                          bilateral=sig))
    ref3 = np.asarray(jtransform.decompose(jnp.asarray(x), 3, JB3,
                                           bilateral=sig))
    xt = torch.from_numpy(x)
    pieces, layout, tail = ttransform.decompose_pieces(
        xt, 5, B3SPLINE, bilateral=sig, defer_tail=True)
    assert len(layout) == 3 and tail[1] == 2
    for s in range(3):
        k, r = layout[s]
        assert_close_scaled(pieces[k][r], ref[s], 5e-6)
    assert_close_scaled(tail[0], ref3[3], 5e-6)
    pieces, layout = ttransform.decompose_pieces(xt, 5, B3SPLINE,
                                                 bilateral=sig)
    assert len(layout) == 6
    cube = ttransform.assemble_pieces(pieces, layout)
    assert_close_scaled(cube, ref, 5e-6)
    # fuse=False: one cube of the plain chain, no tail
    pieces, layout, tail = ttransform.decompose_pieces(
        xt, 5, B3SPLINE, bilateral=sig, fuse=False, defer_tail=True)
    assert tail is None and len(pieces) == 1
    assert torch.equal(pieces[0], cube)


# ---------------------------------------------------------------------
# denoise and wow
# ---------------------------------------------------------------------

DENOISE_CASES = {
    "lazy": (([3, 3, 3],), dict(bilateral=1)),
    "known-noise": (([5, 2],), dict(bilateral=[2.0, 1.0], noise=0.5)),
    "hard": (([3, 2],), dict(bilateral=1.5, soft_threshold=False)),
    "anscombe": (([3, 2],), dict(bilateral=1, anscombe=True)),
}


@pytest.mark.parametrize("case", sorted(DENOISE_CASES))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_denoise_bilateral_matches_jax(case, dtype):
    args, kw = DENOISE_CASES[case]
    x = _x((96, 112), seed=8, dtype=dtype)
    if kw.get("anscombe"):
        x = (np.abs(x) * 20).astype(dtype)
    ref = np.asarray(J.denoise(x, *args, **kw))
    _build.reset_counters()
    got = T.denoise(x, *args, device="cpu", **kw)
    if dtype == np.float32:
        assert _build.PLAIN_CALLS["bilateral_group"] == 1
    _close(got, ref, dtype)


WOW_CASES = {
    "known-noise": dict(bilateral=1, denoise_coefficients=[5, 2],
                        noise=1.0),
    "lazy": dict(bilateral=1, denoise_coefficients=[5, 2]),
    "scaling": dict(bilateral=[1.0, 2.0, 0.5], bilateral_scaling=True,
                    denoise_coefficients=[5, 2]),
    "preserve-variance": dict(bilateral=1, preserve_variance=True,
                              denoise_coefficients=[3]),
    "h": dict(bilateral=1.5, h=0.5, denoise_coefficients=[5, 2]),
    "no-whitening": dict(bilateral=1, whitening=False,
                         denoise_coefficients=[3]),
    "hard-weights": dict(bilateral=1, soft_threshold=False,
                         weights=[1, 2, 0.5], denoise_coefficients=[4, 2]),
    # ten denoised scales: clamped to the 2-D bilateral B3spline table's
    # 10 entries (with the reference's warning); deep taps reflect many
    # times at 128²
    "table-10": dict(bilateral=1, denoise_coefficients=[2] * 10),
}


@pytest.mark.parametrize("case", sorted(WOW_CASES))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_wow_bilateral_matches_jax(case, dtype):
    kw = WOW_CASES[case]
    x = _x((128, 128), seed=9, dtype=dtype) * 3
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        rj, cj = J.wow(x, **kw)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        rt, ct = T.wow(x, device="cpu", **kw)
    assert [str(m.message) for m in tw] == [str(m.message) for m in jw]
    assert len(ct) == len(cj)
    assert ct.bilateral == cj.bilateral == kw["bilateral"]
    whitened = kw.get("whitening", True) and kw.get("h", 0) < 1
    rj = np.asarray(rj)
    _close(rt, rj, dtype)
    scale = float(np.abs(rj).max())
    for k in range(len(cj)):
        ref = np.asarray(cj[k])
        _close(ct[k], ref, dtype,
               scale if whitened else max(scale, float(np.abs(ref).max())))


@pytest.mark.parametrize("noise", [None, 0.5])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_wow_of_bilateral_coefficients_matches_jax(noise, dtype):
    x = _x((128, 128), seed=11, dtype=dtype) * 3
    jc = J.AtrousTransform(bilateral=1)(x, 6)
    tc = T.AtrousTransform(bilateral=1)(x, 6, device="cpu")
    jc.noise = tc.noise = noise
    rj, cj = J.wow(jc, denoise_coefficients=[5, 2])
    _build.reset_counters()
    rt, ct = T.wow(tc, denoise_coefficients=[5, 2])
    assert ct.bilateral == cj.bilateral == 1
    if dtype == np.float32:
        # the σ_e table is the bilateral one; the whitening is kernel D's
        assert _build.PLAIN_CALLS["whiten_plane"] >= 2
        assert ("median_select" in _build.PLAIN_CALLS) == (noise is None)
    rj = np.asarray(rj)
    _close(rt, rj, dtype)
    scale = float(np.abs(rj).max())
    for k in range(len(cj)):
        _close(ct[k], cj[k], dtype, scale)


def test_fused_body_on_bilateral_pieces_matches_jax():
    # _wow_body_fused over kernel F's first group with the scales past it
    # deferred to kernel G, against the JAX package's XLA body
    x = _x((256, 256), seed=12)
    bil = (1.0,) * 7
    d, w = (5.0, 2.0, 0.0, 1.0, 0.0, 0.0, 1.0), (1.0,) * 7
    pieces, layout, tail = ttransform.decompose_pieces(
        torch.from_numpy(x), 6, B3SPLINE, bilateral=bil, defer_tail=True)
    assert tail[1] == 3
    zero = torch.zeros(())
    _build.reset_counters()
    got_r, got_p = twow._wow_body_fused(
        pieces, layout, tail, zero, False, B3SPLINE, 6, w, d, True,
        bilateral=bil)
    assert _build.PLAIN_CALLS == {"whiten_plane": 1, "median_select": 1,
                                  "bilateral_step": 3}
    planes = jtransform.decompose(jnp.asarray(x), 6, JB3, bilateral=bil)
    ref_r, ref_p = jwow._wow_body(
        planes, jnp.zeros(()), False, JB3, 6, w, True, d, True, True, False,
        3.2, None, None, 0.0)
    scale = float(jnp.max(jnp.abs(ref_r)))
    assert_close_scaled(got_r, np.asarray(ref_r), 5e-6)
    assert_close_scaled(got_p, np.asarray(ref_p), 5e-6, scale)


# ---------------------------------------------------------------------
# the routes: which kernels' wrappers each one calls (their plain
# versions on the CPU; the kernels on the card, tests/test_torch_cuda.py)
# ---------------------------------------------------------------------

def _routes(x):
    return {
        # B1: kernel F (scales 0-2), kernel D (their whitening), kernel G
        # (scales 3-5); known noise, so no median
        "B1": (lambda: T.wow(x, bilateral=1, denoise_coefficients=[5, 2],
                             noise=1.0),
               {"bilateral_group": 1, "whiten_plane": 1,
                "bilateral_step": 3}),
        "B1-lazy": (lambda: T.wow(x, bilateral=1, bilateral_scaling=True,
                                  denoise_coefficients=[5, 2]),
                    {"bilateral_group": 1, "whiten_plane": 1,
                     "bilateral_step": 3, "median_select": 1}),
        "B2": (lambda: T.AtrousTransform(T.B3spline, bilateral=1)(x, 6),
               {"bilateral_group": 2}),
        "B3": (lambda: T.denoise(x, [3, 3, 3], bilateral=1),
               {"bilateral_group": 1, "median_select": 1}),
        # the reuse entry: every plane given, so kernel D whitens scales
        # 0-2 from the pieces and 3-5 one plane each
        "B4": (lambda: T.wow(T.AtrousTransform(bilateral=1)(x, 6)),
               {"bilateral_group": 2, "whiten_plane": 4}),
    }


@pytest.mark.parametrize("route", ["B1", "B1-lazy", "B2", "B3", "B4"])
def test_bilateral_routes_call_the_kernels_wrappers(route):
    x = torch.from_numpy(_x((256, 256), seed=13) * 3)
    run, want = _routes(x)[route]
    _build.reset_counters()
    out = run()
    assert dict(_build.PLAIN_CALLS) == want
    assert not _build.LAUNCHES
    out = out[0] if isinstance(out, tuple) else out
    out = out.data if isinstance(out, T.Coefficients) else out
    assert bool(torch.isfinite(out).all())


def test_bilateral_wow_kernel_route_is_the_plain_route_on_cpu():
    x = torch.from_numpy(_x((256, 256), seed=14) * 3)
    kw = dict(bilateral=1, denoise_coefficients=[5, 2])
    r1, c1 = T.wow(x, **kw)
    _build.reset_counters()
    r2, c2 = T.wow(x, fuse=False, **kw)
    # fuse=False runs the plain chain, not the kernels' wrappers
    assert not {"bilateral_group", "bilateral_step",
                "whiten_plane"} & set(_build.PLAIN_CALLS)
    assert not _build.LAUNCHES
    scale = float(r2.abs().max())
    assert_close_scaled(r1, r2, 5e-6)
    for k in range(len(c1)):
        assert_close_scaled(c1[k], c2[k], 5e-6, scale)


def test_no_bilateral_option_raises():
    x = np.zeros((32, 32), np.float32)
    T.wow(x, bilateral=1.0, device="cpu")
    T.denoise(x, [3], bilateral=1.0, device="cpu")
    T.AtrousTransform(bilateral=1.0)(x, 2, device="cpu")
    c = T.AtrousTransform()(x, 2, device="cpu")
    c.bilateral = 1.0
    T.wow(c)
