"""``enhance`` and ``prepare_params`` in the port against the JAX package:
2-D images, 3-D channel stacks with one scale count (the batched pass)
and with mixed lengths (the per-channel loop), lazy, given and partly
``None`` per-channel noise, bilateral and Triangle transforms, hard
thresholds, the pass-through, ``out=``, and the kernels' plain versions
the batched pass runs.

Tolerances: float64 within 1e-12 relative; float32 within
``5e-6·max|ref|``."""

import numpy as np
import pytest
import torch

import wavelets_tpu as J
import wavelets_tpu_torch as T
from tests.torch_parity import assert_close_scaled, assert_rel
from wavelets_tpu_torch.ops import _build


@pytest.mark.parametrize("param,ndims,want", [
    (None, 2, []), (3, 2, [3]), ([1, 2], 2, [1, 2]), ((1, 2), 2, [(1, 2)]),
    (None, 3, [[], [], []]), (2.5, 3, [[2.5], [2.5], [2.5]]),
    ([[1, 2], None, 3], 3, [[1, 2], [], [3]]),
    ([None, None, None], 3, [[], [], []]),
])
def test_prepare_params(param, ndims, want):
    assert T.prepare_params(param, ndims) == want
    assert J.prepare_params(param, ndims) == want


def test_prepare_params_rejects_a_wrong_channel_count():
    for fn in (T.prepare_params, J.prepare_params):
        with pytest.raises(ValueError, match="Invalid number"):
            fn([1, 2], 3)


def _image(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape) * 3 + 10


UNIFORM = dict(weights=[[1.5, 1.2]] * 3, denoise=[[5, 3]] * 3)
CASES = {
    # 2-D
    "2d": ((), dict(weights=[1.5, 1.2], denoise=[5, 3])),
    "2d-noise": ((0.7,), dict(weights=[1.5], denoise=[5, 3, 1])),
    "2d-weights-only": ((), dict(weights=[2.0, 0.5, 1.5])),
    "2d-hard": ((), dict(denoise=[3, 3], soft_threshold=False)),
    "2d-triangle": ((), dict(weights=[1.2], denoise=[4, 2],
                             scaling_function_class="Triangle")),
    "2d-pass": ((), dict()),
    # 3-D, one scale count: the batched pass
    "3d-lazy": ((), UNIFORM),
    "3d-given": (([0.5, 0.8, 1.0],), UNIFORM),
    "3d-partly-none": (([0.5, None, 1.0],),
                       dict(weights=[[1.5, 1.2]] * 3,
                            denoise=[[5, 3], [2, 0], None])),
    "3d-scalar-params": ((), dict(weights=2.0, denoise=3,
                                  soft_threshold=False)),
    "3d-weights-only": ((), dict(weights=[[2.0, 0.5]] * 3)),
    "3d-bilateral": ((), dict(UNIFORM, bilateral=1)),
    # 3-D, mixed lengths: the per-channel loop
    "3d-mixed": ((), dict(weights=[[1.5, 1.2], [2], None],
                          denoise=[[5, 3], None, [1, 1, 1]])),
    "3d-mixed-noise": (([None, 0.9, 0.4],),
                       dict(weights=[[1.5], [2, 2], None],
                            denoise=[[5, 3], None, [1]])),
    "3d-pass": ((), dict()),
}


def _kw(kw, package):
    kw = dict(kw)
    if "scaling_function_class" in kw:
        kw["scaling_function_class"] = getattr(package,
                                               kw["scaling_function_class"])
    return kw


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_enhance_matches_jax(case, dtype):
    noise, kw = CASES[case]
    shape = (3, 40, 48) if case.startswith("3d") else (40, 48)
    x = _image(shape, seed=len(case)).astype(dtype)
    ref = np.asarray(J.enhance(x, *noise, **_kw(kw, J)))
    got = T.enhance(x, *noise, device="cpu", **_kw(kw, T))
    assert got.shape == shape and got.dtype == torch.from_numpy(x).dtype
    if dtype == np.float64:
        assert_rel(got, ref, 1e-12)
    else:
        assert_close_scaled(got, ref, 5e-6)


@pytest.mark.parametrize("case", ["2d", "3d-lazy", "3d-mixed"])
def test_enhance_out(case):
    _, kw = CASES[case]
    shape = (3, 24, 32) if case.startswith("3d") else (24, 32)
    x = _image(shape, seed=7)
    out = np.full(shape, np.nan)
    got = T.enhance(x, out=out, device="cpu", **kw)
    assert got is out
    assert_rel(out, np.asarray(J.enhance(x, **kw)), 1e-12)


def test_pass_through_keeps_the_image():
    x = _image((3, 16, 20)).astype(np.float32)
    got = T.enhance(x, device="cpu")
    assert torch.equal(got, torch.from_numpy(x))
    got = T.enhance(torch.from_numpy(x), weights=[[], [], []])
    assert torch.equal(got, torch.from_numpy(x))


@pytest.mark.parametrize("noise,n_median", [(None, 3), ([0.5, None, 1], 3),
                                            ([0.5, 0.6, 1], 0)])
def test_batched_pass_runs_the_kernels_plain_versions(noise, n_median):
    # float32 channels on the CPU: kernel C's wrapper once for the three
    # channels, kernel B's once a channel when some noise is lazy
    x = torch.from_numpy(_image((3, 32, 40)).astype(np.float32))
    args = () if noise is None else (noise,)
    _build.reset_counters()
    got = T.enhance(x, *args, **UNIFORM)
    want = {"decompose_group": 1}
    if n_median:
        want["median_select"] = n_median
    assert _build.PLAIN_CALLS == want and not _build.LAUNCHES
    _build.reset_counters()
    plain = T.enhance(x, *args, fuse=False, **UNIFORM)
    assert "decompose_group" not in _build.PLAIN_CALLS
    assert torch.equal(got, plain)


def test_batched_pass_equals_the_per_channel_loop():
    # the batched pass against the same channels one at a time (2-D calls)
    x = torch.from_numpy(_image((3, 32, 40), seed=3).astype(np.float32))
    noise = [None, 0.8, None]
    got = T.enhance(x, noise, weights=[[1.5, 1.2]] * 3,
                    denoise=[[5, 3], [2, 0], [1, 1]])
    for c, (n, d) in enumerate(zip(noise, ([5, 3], [2, 0], [1, 1]))):
        args = () if n is None else (n,)
        one = T.enhance(x[c], *args, weights=[1.5, 1.2], denoise=d)
        assert torch.equal(got[c], one)


def test_list_bilateral_with_per_channel_noise():
    # JAX's batched pass raises a TypeError here (an unhashable static
    # argument; a defect of the JAX package); the port runs the
    # reference's per-channel semantics, held against JAX's per-channel
    # path (mixed lengths, so the same options one channel at a time)
    x = _image((3, 32, 40), seed=4)
    kw = dict(weights=[[1.5, 1.2]] * 3, denoise=[[5, 3]] * 3,
              bilateral=[1.0, 2.0])
    got = T.enhance(x, [0.5, None, 0.9], device="cpu", **kw)
    for c, n in enumerate([0.5, None, 0.9]):
        args = () if n is None else (n,)
        ref = np.asarray(J.enhance(x[c], *args, weights=[1.5, 1.2],
                                   denoise=[5, 3], bilateral=[1.0, 2.0]))
        assert_rel(got[c], ref, 1e-12)
