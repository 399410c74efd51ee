"""Filter bank of the PyTorch port vs the JAX package: exact equality of
every field, and the array carry-across."""

import dataclasses

import numpy as np
import pytest

from wavelets_tpu import api as japi
from wavelets_tpu.ops import filters as jfilters
from wavelets_tpu_torch import api as tapi
from wavelets_tpu_torch.ops import filters as tfilters

NAMES = ["b3spline", "triangle"]
TABLES = ["sigma_e_1d", "sigma_e_2d", "sigma_e_3d", "sigma_e_1d_bilateral",
          "sigma_e_2d_bilateral", "sigma_e_3d_bilateral"]


def _arrays(spec):
    return {f: (None if getattr(spec, f) is None
                else np.asarray(getattr(spec, f), np.float64))
            for f in TABLES}


@pytest.mark.parametrize("name", NAMES)
def test_fields_equal_jax(name):
    j = jfilters.get_scaling_function(name)
    t = tfilters.get_scaling_function(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.half_width == j.half_width and t.is_symmetric == j.is_symmetric


@pytest.mark.parametrize("name", NAMES)
def test_from_arrays_carries_the_jax_bank(name):
    j = jfilters.get_scaling_function(name)
    t = tfilters.scaling_function_from_arrays(
        j.name, np.asarray(j.taps), **_arrays(j))
    assert t == tfilters.get_scaling_function(name)


def test_short_bilateral_table_kept():
    # the reference's 2-D bilateral B3spline table has 10 entries
    assert len(tfilters.B3SPLINE.sigma_e_2d_bilateral) == 10
    assert tfilters.B3SPLINE.sigma_e_1d_bilateral is None


def test_from_arrays_rejects_unknown_table():
    with pytest.raises(TypeError):
        tfilters.scaling_function_from_arrays("x", [0.5, 0.5, 0.5],
                                              sigma_e_4d=[1.0])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n_dim", [1, 2, 3])
@pytest.mark.parametrize("bilateral", [False, True])
def test_sigma_e_tables(name, n_dim, bilateral):
    j = jfilters.get_scaling_function(name).sigma_e(n_dim, bilateral)
    t = tfilters.get_scaling_function(name).sigma_e(n_dim, bilateral)
    if j is None:
        assert t is None
    else:
        assert t.dtype == np.float64 and np.array_equal(t, j)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n_dim,scale", [(1, 0), (2, 2), (3, 1)])
def test_dense_kernels(name, n_dim, scale):
    j = jfilters.get_scaling_function(name)
    t = tfilters.get_scaling_function(name)
    assert np.array_equal(t.kernel_nd(n_dim), j.kernel_nd(n_dim))
    assert np.array_equal(t.atrous_kernel_nd(n_dim, scale),
                          j.atrous_kernel_nd(n_dim, scale))
    assert t.reach(scale) == j.reach(scale)
    assert t.cumulative_reach(scale) == j.cumulative_reach(scale)


def test_unknown_name_and_even_taps():
    with pytest.raises(ValueError):
        tfilters.get_scaling_function("haar")
    with pytest.raises(ValueError):
        tfilters.ScalingFunction(name="even", taps=(0.5, 0.5))


@pytest.mark.parametrize("cls", ["B3spline", "Triangle"])
@pytest.mark.parametrize("n_dim", [1, 2, 3])
def test_compat_classes(cls, n_dim):
    j = getattr(japi, cls)(n_dim)
    t = getattr(tapi, cls)(n_dim)
    assert t.name == j.name and np.array_equal(t.kernel, j.kernel)
    assert np.array_equal(t.sigma_e(), j.sigma_e())
    assert np.array_equal(getattr(tapi, cls).coefficients_1d,
                          getattr(japi, cls).coefficients_1d)
    assert tapi._spec_of(t) == tapi._spec_of(getattr(tapi, cls))


def test_spec_of_rejects_other_objects():
    with pytest.raises(TypeError):
        tapi._spec_of("b3spline")
    with pytest.raises(TypeError):
        tapi.AbstractScalingFunction(2)
