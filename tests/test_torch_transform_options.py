"""The transform options and the compatibility surface in the port against
the JAX package: ``convolution``, ``sdev_loc`` and ``atrous_convolution``
(1-D, 2-D and 3-D, scales, bilateral variance, boundary modes, the
ignored ``output=``), the scaling-function classes' kernel methods,
``recursive=True`` / ``atrous_recursive`` / ``recursive_borders``
(also with a pad wider than the frame, and the kernels' plain versions
it runs), and the names the package root, ``wavelets`` and ``utils``
give.

Tolerances: float64 within 1e-12 relative; float32 within
``5e-6·max(|ref|, 1)``."""

import importlib

import numpy as np
import pytest
import torch

import wavelets_tpu as J
import wavelets_tpu_torch as T
from tests.torch_parity import assert_close_scaled, assert_rel
from wavelets_tpu_torch.core import transform as ttransform
from wavelets_tpu_torch.ops import _build

SHAPES = {1: (300,), 2: (40, 52), 3: (10, 20, 24)}


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape) * 3 + 10


def _close(got, ref, dtype):
    if dtype == np.float64:
        assert_rel(got, ref, 1e-12)
    else:
        assert_close_scaled(got, ref, 5e-6)


@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("s", [0, 1, 3])
@pytest.mark.parametrize("cls", ["B3spline", "Triangle"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_convolution_matches_jax(nd, s, cls, dtype):
    x = _x(SHAPES[nd], seed=nd + s).astype(dtype)
    ref = np.asarray(J.convolution(x, getattr(J, cls), s=s))
    got = T.convolution(x, getattr(T, cls), s=s, device="cpu")
    assert got.dtype == torch.from_numpy(x).dtype
    _close(got, ref, dtype)


@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("s", [0, 2])
@pytest.mark.parametrize("variance", [False, True])
def test_sdev_loc_matches_jax(nd, s, variance):
    x = _x(SHAPES[nd], seed=nd)
    ref = np.asarray(J.sdev_loc(x, J.B3spline, s=s, variance=variance))
    got = T.sdev_loc(x, T.B3spline(nd), s=s, variance=variance,
                     device="cpu")
    assert_rel(got, ref, 1e-12)


@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("s", [0, 2])
@pytest.mark.parametrize("mode", ["symmetric", "reflect", "wrap", "edge"])
@pytest.mark.parametrize("bilateral", [False, True])
def test_atrous_convolution_matches_jax(nd, s, mode, bilateral):
    x = _x(SHAPES[nd], seed=s)
    kernel = J.B3spline(nd).make_kernel()
    var = None
    if bilateral:
        var = np.random.default_rng(7).uniform(0.5, 4.0, size=x.shape)
    ref = np.asarray(J.atrous_convolution(x, kernel, bilateral_variance=var,
                                          s=s, mode=mode))
    got = T.atrous_convolution(x, kernel, bilateral_variance=var, s=s,
                               mode=mode, device="cpu")
    assert_rel(got, ref, 1e-12)


def test_atrous_convolution_float32_on_a_cpu_tensor():
    x = torch.from_numpy(_x((40, 52)).astype(np.float32))
    var = np.full((40, 52), 2.0, np.float32)
    kernel = T.Triangle(2).make_kernel()
    got = T.atrous_convolution(x, kernel, bilateral_variance=var, s=1)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    ref = np.asarray(J.atrous_convolution(x.numpy(), kernel,
                                          bilateral_variance=var, s=1))
    assert_close_scaled(got, ref, 5e-6)


def test_output_argument_warns_and_is_not_filled():
    x = _x((16, 16))
    for fn, args in ((T.convolution, (x, T.B3spline)),
                     (T.atrous_convolution,
                      (x, T.B3spline(2).make_kernel()))):
        out = np.zeros_like(x)
        with pytest.warns(UserWarning, match="IGNORED"):
            got = fn(*args, output=out, device="cpu")
        assert not out.any() and got.shape == x.shape


@pytest.mark.parametrize("cls", ["B3spline", "Triangle"])
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_scaling_function_methods_match_jax(cls, nd):
    j, t = getattr(J, cls)(nd), getattr(T, cls)(nd)
    assert np.array_equal(t.coefficients_2d, j.coefficients_2d)
    assert np.array_equal(t.coefficients_3d, j.coefficients_3d)
    assert np.array_equal(t.make_kernel(), j.make_kernel())
    assert np.array_equal(t.kernel, j.kernel)
    assert np.array_equal(t.coefficients_1d, j.coefficients_1d)
    for scale in (0, 1, 3):
        assert np.array_equal(t.atrous_kernel(scale), j.atrous_kernel(scale))
    for bil in (None, 1):
        a, b = t.sigma_e(bilateral=bil), j.sigma_e(bilateral=bil)
        assert (a is None and b is None) or np.array_equal(a, b)


RECURSIVE = [((40, 52), 3), ((12, 10), 4), ((9, 7), 5), ((300,), 4),
             ((10, 12, 14), 2), ((3, 5, 6), 3)]


# the 3-D bilateral transform (124 range-weighted taps) takes JAX 10-25 s
# to compile a case, so bilateral runs on the 1-D and 2-D shapes
@pytest.mark.parametrize("shape,level,bilateral", [
    (shape, level, bil) for shape, level in RECURSIVE
    for bil in ((None, 1) if len(shape) < 3 else (None,))])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_recursive_matches_jax(shape, level, bilateral, dtype):
    # (12, 10) at level 4 pads by 2·8 = 16 > 10, (9, 7) at 5 by 32: the
    # symmetric reflection repeats, as numpy's does
    if bilateral is not None and dtype == np.float32:
        x = _x(shape, seed=level) - 10  # zero mean: bilateral conditioning
    else:
        x = _x(shape, seed=level)
    x = x.astype(dtype)
    jt = J.AtrousTransform(bilateral=bilateral)
    tt = T.AtrousTransform(bilateral=bilateral)
    ref = np.asarray(jt(x, level, recursive=True).data)
    got = tt(x, level, recursive=True, device="cpu")
    assert len(got) == level + 1
    _close(got.data, ref, dtype)
    assert_rel(tt.atrous_recursive(x, level, device="cpu"),
               jt.atrous_recursive(x, level), 1e-12 if dtype == np.float64
               else 5e-6)


def test_recursive_interior_equals_the_standard_path():
    # the borders differ, the interior (beyond the transform's reach
    # from the edge) is the same arithmetic, so bitwise
    x = torch.from_numpy(_x((96, 80)).astype(np.float32))
    level = 3
    reach = T.B3SPLINE.half_width * (2 ** level - 1)
    rec = T.AtrousTransform()(x, level, recursive=True).data
    std = T.AtrousTransform()(x, level).data
    inner = (slice(None), slice(reach, -reach), slice(reach, -reach))
    assert torch.equal(rec[inner], std[inner])
    assert not torch.equal(rec, std)


def test_recursive_runs_kernel_c_on_the_padded_frame():
    x = torch.from_numpy(_x((40, 52)).astype(np.float32))
    _build.reset_counters()
    got = ttransform.decompose(x, 6, T.B3SPLINE, recursive_borders=True)
    assert _build.PLAIN_CALLS == {"decompose_group": 2}
    _build.reset_counters()
    plain = ttransform.decompose(x, 6, T.B3SPLINE, recursive_borders=True,
                                 fuse=False)
    assert not _build.PLAIN_CALLS
    assert torch.equal(got, plain) and got.is_contiguous()


@pytest.mark.parametrize("pad", [0, 1, 5, 13, 40])
def test_pad_symmetric_is_numpys(pad):
    x = _x((6, 7, 5))
    for axes in ((0,), (1, 2), (0, 1, 2)):
        want = np.pad(x, [(pad, pad) if a in axes else (0, 0)
                          for a in range(3)], mode="symmetric")
        got = ttransform.pad_symmetric(torch.from_numpy(x), pad, axes)
        assert np.array_equal(got.numpy(), want)


def test_root_names_match_jax():
    port_only = {"decompose", "synthesize", "wow_core", "process_stack"}
    assert set(T.__all__) == set(J.__all__) | port_only
    for name in T.__all__:
        assert hasattr(T, name), name
    assert T.__version__ == J.__version__


def test_wavelets_shim_names_match_jax():
    jw = importlib.import_module("wavelets_tpu.wavelets")
    tw = importlib.import_module("wavelets_tpu_torch.wavelets")
    assert tw.__all__ == jw.__all__
    for name in tw.__all__:
        assert getattr(tw, name) is getattr(T, name)


@pytest.mark.parametrize("name", ["denoise", "wow", "richardson_lucy",
                                  "enhance", "prepare_params"])
def test_utils_aliases(name):
    import wavelets_tpu.utils as jutils
    import wavelets_tpu_torch.utils as tutils

    assert getattr(tutils, name) is getattr(T, name)
    assert name in tutils.__all__
    assert set(tutils.__all__) == set(jutils.__all__)
    with pytest.raises(AttributeError):
        tutils.no_such_name


def test_every_module_of_the_port_loads_no_jax():
    import pkgutil
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    names = [m.name for m in pkgutil.walk_packages(
        T.__path__, "wavelets_tpu_torch.") if not m.name.endswith("__main__")]
    assert "wavelets_tpu_torch.models.richardson_lucy" in names
    code = (f"import sys, importlib; [importlib.import_module(m) for m in "
            f"{names!r}]; print('jax' in sys.modules, "
            f"'wavelets_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]
