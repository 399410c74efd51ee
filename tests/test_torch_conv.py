"""Plain smoothing, boundaries, decomposition and the transform façade of
the PyTorch port vs the JAX package's XLA path.

float64 agrees to round-off (≤1e-12 relative); float32 is bitwise
expected and asserted to ≤1 ulp, since both fold the taps in the same
order with no FMA contraction."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_parity import assert_rel, to_np, ulp_distance
from wavelets_tpu import api as japi
from wavelets_tpu.core import transform as jtransform
from wavelets_tpu.ops import conv as jconv
from wavelets_tpu.ops.filters import B3SPLINE as JB3
from wavelets_tpu.ops.filters import TRIANGLE as JTRI
from wavelets_tpu_torch import api as tapi
from wavelets_tpu_torch.core import transform as ttransform
from wavelets_tpu_torch.ops import conv as tconv
from wavelets_tpu_torch.ops.filters import B3SPLINE, TRIANGLE
from wavelets_tpu_torch.ops.layout import stack_planes

SFS = {"b3spline": (JB3, B3SPLINE), "triangle": (JTRI, TRIANGLE)}


def _assert_parity(got, ref, dtype):
    if dtype == np.float64:
        assert_rel(got, ref, 1e-12)
    else:
        assert ulp_distance(got, ref) <= 1


@pytest.mark.parametrize("boundary", ["symmetric", "reflect"])
@pytest.mark.parametrize("n", [1, 2, 5, 9])
@pytest.mark.parametrize("shift", [-12, -5, -1, 0, 3, 12])
def test_boundary_index_matches_np_pad(boundary, n, shift):
    pad = 12
    x = np.arange(n)
    padded = np.pad(x, pad, mode=boundary)
    want = padded[pad + shift:pad + shift + n]
    got = tconv.boundary_index(n, shift, boundary)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["b3spline", "triangle"])
@pytest.mark.parametrize("shape,scale", [
    ((64, 64), 0), ((64, 64), 3), ((33, 50), 2),
    ((7, 9), 3),       # pad 2·8 = 16 wider than both extents
    ((5, 6), 4),       # pad 2·16 = 32: several bounces
])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_smooth_2d(rng, name, shape, scale, dtype):
    jsf, tsf = SFS[name]
    x = rng.normal(size=shape).astype(dtype)
    ref = jconv.smooth(jnp.asarray(x), jsf, scale=scale)
    got = tconv.smooth(torch.from_numpy(x), tsf, scale=scale)
    _assert_parity(got, ref, dtype)


@pytest.mark.parametrize("shape,scale", [((300,), 2), ((9,), 3), ((8, 12, 10), 1)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_smooth_1d_and_3d(rng, shape, scale, dtype):
    x = rng.normal(size=shape).astype(dtype)
    ref = jconv.smooth(jnp.asarray(x), JB3, scale=scale)
    got = tconv.smooth(torch.from_numpy(x), B3SPLINE, scale=scale)
    _assert_parity(got, ref, dtype)


def test_smooth_batched_axes(rng):
    x = rng.normal(size=(3, 20, 24))
    ref = jconv.smooth(jnp.asarray(x), JB3, scale=1, axes=(1, 2))
    got = tconv.smooth(torch.from_numpy(x), B3SPLINE, scale=1, axes=(1, 2))
    assert_rel(got, ref, 1e-12)


def test_asymmetric_taps(rng):
    from wavelets_tpu.ops.filters import ScalingFunction as JSF

    from wavelets_tpu_torch.ops.filters import ScalingFunction as TSF

    taps = (0.1, 0.5, 0.4)
    x = rng.normal(size=(16, 16))
    ref = jconv.smooth(jnp.asarray(x), JSF("asym", taps), scale=1)
    got = tconv.smooth(torch.from_numpy(x), TSF("asym", taps), scale=1)
    assert_rel(got, ref, 1e-12)


def test_boundary_for_ndim():
    for n in (1, 2, 3, 4):
        assert tconv.boundary_for_ndim(n) == jconv.boundary_for_ndim(n)
    # "wrap" and "edge" are index maps now (atrous_convolution's modes);
    # "constant" is not one
    with pytest.raises(ValueError):
        tconv.boundary_index(4, 1, "constant")


@pytest.mark.parametrize("shape,level", [((64, 64), 6), ((48, 40), 4),
                                         ((256,), 5), ((8, 16, 16), 2)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_decompose(rng, shape, level, dtype):
    x = rng.normal(size=shape).astype(dtype)
    ref = jtransform.decompose(jnp.asarray(x), level, JB3, use_pallas=False)
    got = ttransform.decompose(torch.from_numpy(x), level, B3SPLINE)
    assert got.shape == (level + 1,) + shape
    if dtype == np.float64:
        assert_rel(got, ref, 1e-12)
    else:
        # The same XLA function run op by op is bitwise.  Jitted, XLA
        # contracts the folds into FMAs; that chain stays within 4 units
        # in the last place of each plane's magnitude.
        eager = jtransform.decompose.__wrapped__(
            jnp.asarray(x), level, JB3, use_pallas=False)
        assert ulp_distance(got, eager) <= 1
        for k in range(level + 1):
            r = np.asarray(ref[k])
            err = np.abs(to_np(got[k]) - r).max()
            assert err <= 4 * np.spacing(np.abs(r).max()), (k, err)
    # synthesis telescopes back to the input
    assert_rel(ttransform.synthesize(got), x, 1e-12 if dtype == np.float64
               else 1e-5)


def test_decompose_scale_offset(rng):
    x = rng.normal(size=(40, 40))
    ref = jtransform.decompose(jnp.asarray(x), 2, JB3, scale_offset=3,
                               use_pallas=False)
    got = ttransform.decompose(torch.from_numpy(x), 2, B3SPLINE,
                               scale_offset=3)
    assert_rel(got, ref, 1e-12)


@pytest.mark.parametrize("cls", ["B3spline", "Triangle"])
def test_atrous_transform(rng, cls):
    x = rng.normal(size=(96, 80))
    jc = japi.AtrousTransform(getattr(japi, cls))(x, 5)
    tc = tapi.AtrousTransform(getattr(tapi, cls))(x, 5, device="cpu")
    assert len(tc) == len(jc) == 6
    assert tc.scaling_function.name == jc.scaling_function.name
    assert_rel(np.asarray(tc), np.asarray(jc), 1e-12)
    assert_rel(tc[2], np.asarray(jc.data)[2], 1e-12)


def test_atrous_transform_options_outside_the_slice():
    # recursive=True is in the slice now: the JAX package's planes
    x = np.random.default_rng(3).normal(size=(8, 8))
    got = tapi.AtrousTransform()(x, 2, recursive=True, device="cpu")
    assert_rel(np.asarray(got),
               np.asarray(japi.AtrousTransform()(x, 2, recursive=True)),
               1e-12)
    with pytest.raises(ValueError):
        tapi.AtrousTransform()(np.zeros((2, 2, 2, 2)), 1)


@pytest.mark.parametrize("dtype,want", [
    (np.int32, torch.float64), (np.int64, torch.float64),
    (np.uint16, torch.float64), (">f4", torch.float64),
    (">f8", torch.float64), (np.float32, torch.float32),
    (np.float64, torch.float64),
])
def test_as_tensor_dtype_rules(dtype, want):
    arr = np.arange(6).reshape(2, 3).astype(dtype)
    t = tapi._as_tensor(arr, device="cpu")
    assert t.dtype == want and t.device.type == "cpu"
    assert np.array_equal(to_np(t), arr.astype(np.float64))
    # the JAX package applies the same rule
    assert str(japi._as_device_array(arr).dtype) == str(want).split(".")[1]


def test_as_tensor_keeps_tensors():
    t = torch.arange(4, dtype=torch.float32)
    assert tapi._as_tensor(t) is t
    assert tapi._as_tensor(torch.arange(4)).dtype == torch.float64


def test_array_input_without_a_card_raises(monkeypatch):
    # array input goes to the card by default and never carries on
    # silently on the CPU; a CPU tensor keeps its device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi._as_tensor(np.zeros((4, 4)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.Coefficients(np.zeros((2, 4, 4)), tapi.B3spline(2))
    t = torch.zeros(4, 4)
    assert tapi._as_tensor(t) is t


def test_stack_planes():
    rows = [torch.full((2, 3), float(k)) for k in range(4)]
    cube = stack_planes(rows)
    assert cube.shape == (4, 2, 3) and float(cube[3, 1, 2]) == 3.0


def test_coefficients_rows_and_cube():
    rows = tuple(torch.full((4, 4), float(k)) for k in range(3))
    c = tapi.Coefficients(rows, tapi.B3spline(2))
    assert len(c) == 3 and c[1] is rows[1] and c.noise is None
    assert np.asarray(c).shape == (3, 4, 4)
    assert np.asarray(c, dtype=np.float32).dtype == np.float32
    assert c.data.shape == (3, 4, 4) and float(c[2][0, 0]) == 2.0
    cube = tapi.Coefficients(np.zeros((2, 3, 3)), tapi.B3spline(2),
                             device="cpu")
    assert len(cube) == 2 and cube[0].shape == (3, 3)
