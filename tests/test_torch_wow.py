"""The ported slice end to end: ``wavelets_tpu_torch.wow`` against
``wavelets_tpu.wow`` (the XLA path with the true erf, on the CPU), plus
parameter normalization, the options outside the slice and the package's
independence from JAX.

Tolerances: float64 recon and every plane ≤1e-12 relative; float32
recon and every plane within ``5e-6·max|ref recon|``."""

import importlib
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import wavelets_tpu as J
import wavelets_tpu_torch as T
from tests.torch_parity import assert_close_scaled, assert_rel
from wavelets_tpu.models.wow import normalize_wow_params as j_normalize
from wavelets_tpu.ops.filters import B3SPLINE as JB3
from wavelets_tpu.ops.filters import TRIANGLE as JTRI
from wavelets_tpu_torch.ops import _build
from wavelets_tpu_torch.ops.filters import B3SPLINE, TRIANGLE

twow = importlib.import_module("wavelets_tpu_torch.models.wow")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "auto-lazy": dict(denoise_coefficients=[5, 2]),
    "L6-known-noise": dict(n_scales=6, noise=0.4, denoise_coefficients=[3, 1]),
    "L6-hard": dict(n_scales=6, soft_threshold=False,
                    denoise_coefficients=[5, 2]),
    "auto-weights": dict(weights=[1, 2, 0.5, 3]),
    "L6-lazy-weights": dict(n_scales=6, weights=[0.5, 1, 2],
                            denoise_coefficients=[4, 2, 1]),
}


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(2024)
    return {shape: rng.normal(size=shape) * 3 + 10
            for shape in [(256, 256), (200, 328)]}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("shape", [(256, 256), (200, 328)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_wow_matches_jax(frames, case, shape, dtype):
    x = frames[shape].astype(dtype)
    kw = CASES[case]
    rj, cj = J.wow(x, **kw)
    rt, ct = T.wow(x, **kw)
    assert rt.dtype == torch.from_numpy(x).dtype and rt.shape == shape
    assert len(ct) == len(cj)
    assert ct.noise == cj.noise
    if dtype == np.float64:
        assert_rel(rt, np.asarray(rj), 1e-12)
        for k in range(len(cj)):
            assert_rel(ct[k], np.asarray(cj[k]), 1e-12)
    else:
        # planes at the reconstruction's scale, as the JAX package holds
        # its merged body (tests/test_pallas_merged.py:105-106): a deep
        # detail is a small difference of O(carry) values, so float32
        # round-off of the carry is amplified by the whitening
        scale = float(np.abs(np.asarray(rj)).max())
        assert_close_scaled(rt, np.asarray(rj), 5e-6)
        for k in range(len(cj)):
            assert_close_scaled(ct[k], np.asarray(cj[k]), 5e-6, scale)


@pytest.mark.parametrize("sf_name", ["B3spline", "Triangle"])
def test_wow_scaling_functions(frames, sf_name):
    x = frames[(256, 256)]
    rj, cj = J.wow(x, scaling_function=getattr(J, sf_name), n_scales=4,
                   denoise_coefficients=[3])
    rt, ct = T.wow(x, scaling_function=getattr(T, sf_name), n_scales=4,
                   denoise_coefficients=[3])
    assert_rel(rt, np.asarray(rj), 1e-12)
    assert ct.scaling_function.name == cj.scaling_function.name


def test_wow_fuse_false_is_the_same_on_cpu(frames):
    x = torch.from_numpy(frames[(200, 328)].astype(np.float32))
    _build.reset_counters()
    r1, c1 = T.wow(x, denoise_coefficients=[5, 2])
    counts = dict(_build.PLAIN_CALLS)
    r2, c2 = T.wow(x, denoise_coefficients=[5, 2], fuse=False)
    assert torch.equal(r1, r2)
    assert all(torch.equal(c1[k], c2[k]) for k in range(len(c1)))
    # CPU tensors take the plain versions: one group, one step per deeper
    # scale, one median; nothing launches
    n_scales = len(c1) - 1
    assert counts == {"whiten_step": 1 + n_scales - twow.N_FAST,
                      "median_select": 1}
    assert sum(_build.LAUNCHES.values()) == 0


def test_wow_core_layouts(frames):
    x = torch.from_numpy(frames[(256, 256)])
    kw = dict(sf=B3SPLINE, n_scales=5, weights=(1.0,) * 6, whitening=True,
              denoise_coefficients=(3.0, 0.0, 0.0, 0.0, 0.0, 1.0),
              bilateral=None, bilateral_scaling=False, soft_threshold=True,
              preserve_variance=False, gamma=3.2, gamma_min=None,
              gamma_max=None, h=0.0, has_noise=False)
    noise = torch.zeros((), dtype=x.dtype)
    r_cube, cube = T.wow_core(x, noise, **kw)
    r_rows, rows = T.wow_core(x, noise, planes_layout="rows", **kw)
    r_none, none = T.wow_core(x, noise, need_planes=False, **kw)
    assert cube.shape == (6, 256, 256) and len(rows) == 6 and none is None
    assert torch.equal(r_cube, r_rows) and torch.equal(r_cube, r_none)
    assert torch.equal(cube[3], rows[3])


def test_wow_constant_frame_is_finite():
    r, c = T.wow(np.full((64, 64), 3.0), denoise_coefficients=[5, 2])
    assert torch.isfinite(r).all()


def test_wow_numpy_goes_to_cpu_and_int_to_float64():
    r, _ = T.wow(np.arange(64 * 64).reshape(64, 64).astype(np.int32))
    assert r.dtype == torch.float64 and r.device.type == "cpu"


NORMALIZE_CASES = [
    # (spec name, n_scales, weights, denoise, bilateral, h, n_dims, extent)
    ("b3", None, [], [], None, 0, 2, 4096),
    ("b3", None, [], [5, 2], None, 0, 2, 512),
    ("b3", 6, [1, 2], [5, 2], None, 0, 2, 512),
    ("b3", 20, [], [], None, 0, 2, 300),
    ("b3", None, [], [1] * 12, None, 0, 2, 4096),   # table clamp + warning
    ("tri", None, [], [3], None, 0.5, 2, 200),
    ("tri", None, [2] * 9, [], None, 0, 1, 1000),
    ("b3", 4, [], [1, 1], 1.5, 0, 2, 64),
    ("b3", 3, [], [], [1, 2], 0, 3, 64),
    ("b3", None, [], [2, 2], None, 1.0, 2, 64),
    ("b3", 5, [], [], None, 0, 2, None),
]


@pytest.mark.parametrize("case", range(len(NORMALIZE_CASES)))
def test_normalize_wow_params(case):
    name, n, w, d, bil, h, nd, ext = NORMALIZE_CASES[case]
    jspec, tspec = {"b3": (JB3, B3SPLINE), "tri": (JTRI, TRIANGLE)}[name]
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        ref = j_normalize(jspec, n, list(w), list(d), bil, h, nd, ext)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = twow.normalize_wow_params(tspec, n, list(w), list(d), bil, h,
                                        nd, ext)
    assert got == ref
    assert [str(m.message) for m in tw] == [str(m.message) for m in jw]


@pytest.mark.parametrize("option", [
    "bilateral", "preserve_variance", "h", "whitening", "coefficients",
    "bfloat16", "3d", "wow_stack",
])
def test_options_outside_the_slice_raise(option):
    x = np.zeros((32, 32), np.float32)
    calls = {
        "bilateral": lambda: T.wow(x, bilateral=1.0),
        "preserve_variance": lambda: T.wow(x, preserve_variance=True),
        "h": lambda: T.wow(x, h=0.5),
        "whitening": lambda: T.wow(x, whitening=False),
        "coefficients": lambda: T.wow(T.wow(x)[1]),
        "bfloat16": lambda: T.wow(torch.zeros(32, 32, dtype=torch.bfloat16)),
        "3d": lambda: T.wow(np.zeros((2, 32, 32), np.float32)),
        "wow_stack": lambda: twow.wow_stack(np.zeros((2, 32, 32))),
    }
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A"):
        calls[option]()


def test_bad_inputs_raise_value_error():
    with pytest.raises(ValueError, match="Unknown input type"):
        T.wow([[1.0, 2.0], [3.0, 4.0]])
    with pytest.raises(ValueError, match="dimensions"):
        T.wow(np.zeros(16))


def test_import_loads_no_jax():
    code = ("import sys, wavelets_tpu_torch, wavelets_tpu_torch.ops.hopper_conv, "
            "wavelets_tpu_torch.ops.hopper_deep, wavelets_tpu_torch.ops."
            "hopper_stats; print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_exports():
    for name in ["wow", "wow_core", "AtrousTransform", "B3spline", "Triangle",
                 "Coefficients", "ScalingFunction", "B3SPLINE", "TRIANGLE"]:
        assert name in T.__all__ and hasattr(T, name)
