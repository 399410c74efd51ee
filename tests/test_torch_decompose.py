"""Decomposition in the port against the JAX package: kernel C's plain
version (``hopper_conv.fused_group_plain``) against the TPU kernel it
replaces, ``pallas_conv._fused_group``, in interpret mode; ``decompose``,
``decompose_pieces`` and ``AtrousTransform`` against the JAX package's
transform; the dispatch to the kernel's wrapper.

Tolerances: against the interpret-mode kernel, details and carry within
4 units in the last place of the input's magnitude (interpret mode
contracts one FMA per fold, tests/test_pallas_deep.py:1-13), and ≤1 ulp
against the JAX package's smooth run op by op; float64 paths ≤1e-12
relative; float32 paths within ``5e-6·max|x|`` of the JAX package's
jitted transform (whose folds XLA contracts into FMAs on the CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import wavelets_tpu as J
import wavelets_tpu_torch as T
from tests.torch_parity import assert_close_scaled, assert_rel, ulp_distance
from wavelets_tpu.ops import conv as jconv
from wavelets_tpu.ops import pallas_conv
from wavelets_tpu.ops.filters import B3SPLINE as JB3
from wavelets_tpu_torch.core import transform as ttransform
from wavelets_tpu_torch.ops import _build, hopper_conv
from wavelets_tpu_torch.ops.filters import B3SPLINE, TRIANGLE


def _x(shape, seed=0, dtype=np.float32):
    return (np.random.default_rng(seed).normal(size=shape) * 3 + 10
            ).astype(dtype)


@pytest.mark.parametrize("shape", [(256, 256), (2, 256, 256)])
@pytest.mark.parametrize("g,offset", [(1, 0), (3, 0), (1, 2), (3, 2)])
@pytest.mark.parametrize("smooth_only", [False, True])
def test_group_plain_vs_pallas(shape, g, offset, smooth_only):
    x = _x(shape, seed=g + offset)
    ref = np.asarray(pallas_conv._fused_group(
        jnp.asarray(x), g, JB3, offset=offset, interpret=True,
        smooth_only=smooth_only))
    got = hopper_conv.fused_group_plain(torch.from_numpy(x), g, B3SPLINE,
                                        offset, smooth_only)
    assert got.shape == ref.shape == ((1 if smooth_only else g + 1),) + shape
    tol = 4 * np.spacing(np.float32(np.abs(x).max()))
    assert np.abs(got.numpy() - ref).max() <= tol
    # op by op, the JAX package's chain gives the same values
    cur, rows = jnp.asarray(x), []
    axes = (-2, -1)
    for s in range(offset, offset + g):
        nxt = jconv.smooth(cur, JB3, scale=s, axes=axes)
        rows.append(cur - nxt)
        cur = nxt
    want = [cur] if smooth_only else rows + [cur]
    for k, w in enumerate(want):
        assert ulp_distance(got[k], w) <= 1


CASES = {
    "1d": ((1000,), 5),
    "2d": ((256, 256), 5),
    "2d-odd": ((200, 328), 5),
    "3d": ((16, 64, 64), 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("sf_name", ["B3spline", "Triangle"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_atrous_transform_matches_jax(case, sf_name, dtype):
    shape, level = CASES[case]
    x = _x(shape, seed=len(shape), dtype=dtype)
    jc = J.AtrousTransform(getattr(J, sf_name))(x, level)
    _build.reset_counters()
    tc = T.AtrousTransform(getattr(T, sf_name))(x, level, device="cpu")
    # float32 2-D and 3-D go through kernel C's wrapper (its plain version
    # here, on the CPU); float64 and 1-D run the plain chain
    fused = dtype == np.float32 and len(shape) > 1
    n_groups = (level if len(shape) == 3
                else -(-level // hopper_conv.N_FAST))
    assert _build.PLAIN_CALLS.get("decompose_group", 0) == (
        n_groups if fused else 0)
    assert len(tc) == level + 1 and tc[0].dtype == torch.from_numpy(x).dtype
    ref = np.asarray(jc.data)
    if dtype == np.float64:
        assert_rel(tc.data, ref, 1e-12)
        assert_rel(T.synthesize(tc.data), x, 1e-12)
    else:
        scale = float(np.abs(x).max())
        assert_close_scaled(tc.data, ref, 5e-6, scale)
        assert_close_scaled(T.synthesize(tc.data), x, 5e-6, scale)
    assert np.array_equal(
        T.AtrousTransform(getattr(T, sf_name)).atrous_standard(
            x, level, device="cpu"), tc.data.numpy())


@pytest.mark.parametrize("shape", [(256, 256), (2, 96, 80)])
@pytest.mark.parametrize("level", [2, 7])
def test_decompose_routes_agree_bitwise(shape, level):
    x = torch.from_numpy(_x(shape, seed=level))
    axes = (-2, -1)
    fused = ttransform.decompose(x, level, B3SPLINE, axes=axes)
    plain = ttransform.decompose(x, level, B3SPLINE, axes=axes, fuse=False)
    assert torch.equal(fused, plain)
    pieces, layout = ttransform.decompose_pieces(x, level, B3SPLINE,
                                                 axes=axes)
    assert len(pieces) == -(-level // hopper_conv.N_FAST)
    assert len(layout) == level + 1
    assert torch.equal(ttransform.assemble_pieces(pieces, layout), plain)
    k, r = layout[level]
    assert torch.equal(pieces[k][r], plain[level])


def test_decompose_pieces_defer_tail():
    x = torch.from_numpy(_x((128, 96), seed=3))
    pieces, layout, tail = ttransform.decompose_pieces(
        x, 6, B3SPLINE, defer_tail=True)
    full = ttransform.decompose(x, 6, B3SPLINE, fuse=False)
    # the first group is materialized; the carry hands scales 3-5 over
    assert len(pieces) == 1 and len(layout) == hopper_conv.N_FAST
    carry, n_tail = tail
    assert n_tail == 3
    assert torch.equal(carry, ttransform.decompose(
        x, 3, B3SPLINE, fuse=False)[3])
    for s in range(3):
        assert torch.equal(pieces[0][s], full[s])
    # nothing deferred when the first group covers every scale
    _, layout2, tail2 = ttransform.decompose_pieces(
        x, 2, B3SPLINE, defer_tail=True)
    assert tail2 is None and len(layout2) == 3


def test_volume_route_is_the_plain_chain():
    x = torch.from_numpy(_x((8, 40, 48), seed=5))
    _build.reset_counters()
    got = ttransform.decompose(x, 3, TRIANGLE)
    assert _build.PLAIN_CALLS == {"decompose_group": 3}
    assert torch.equal(got, ttransform.decompose(x, 3, TRIANGLE, fuse=False))
    # a frame stack (spatial axes the last two) is not a volume
    _build.reset_counters()
    ttransform.decompose(x, 3, TRIANGLE, axes=(1, 2))
    assert _build.PLAIN_CALLS == {"decompose_group": 1}


def test_decompose_options_outside_the_slice_raise():
    # recursive_borders is ported; with a scale offset (which the JAX
    # package drops there) it raises
    x = torch.zeros(16, 16)
    with pytest.raises(ValueError, match="scale_offset"):
        ttransform.decompose(x, 2, B3SPLINE, recursive_borders=True,
                             scale_offset=1)


def test_fused_group_rejects_bad_arguments():
    with pytest.raises(ValueError):
        hopper_conv.fused_group_plain(torch.zeros(8, 8), 0, B3SPLINE)
