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
from wavelets_tpu_torch.core.transform import (
    decompose_pieces as tdecompose_pieces)
from wavelets_tpu_torch.ops import _build
from wavelets_tpu_torch.ops.conv import smooth
from wavelets_tpu_torch.ops.filters import B3SPLINE, TRIANGLE
from wavelets_tpu_torch.ops.stats import mad_noise

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
    rt, ct = T.wow(x, device="cpu", **kw)
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
                   denoise_coefficients=[3], device="cpu")
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
    # CPU tensors take the plain versions: the lazy noise's one-scale
    # decompose group and its median, one group (scales 0-2), one pair for
    # scales 3 and 4 (200 >> 3 = 25 rows per residue class, and 8 divides
    # 200 and 328); nothing launches
    assert len(c1) - 1 == twow.N_FAST + 2
    assert counts == {"decompose_group": 1, "whiten_group": 1,
                      "whiten_pair": 1, "median_select": 1}
    assert sum(_build.LAUNCHES.values()) == 0


OPTION_CASES = {
    "pv-lazy": dict(preserve_variance=True, denoise_coefficients=[5, 2]),
    "pv-known-hard": dict(n_scales=6, preserve_variance=True, noise=0.5,
                          soft_threshold=False, denoise_coefficients=[3, 1]),
    "gamma": dict(h=0.5, denoise_coefficients=[5, 2]),
    "gamma-bounds": dict(h=0.3, gamma=2.0, gamma_min=0.0, gamma_max=40.0),
    "no-whitening": dict(whitening=False, denoise_coefficients=[3]),
    "h1": dict(h=1, denoise_coefficients=[3, 2]),
}


def _assert_wow_close(rt, ct, rj, cj, dtype, whitened=True):
    assert len(ct) == len(cj)
    if dtype == np.float64:
        assert_rel(rt, np.asarray(rj), 1e-12)
        for k in range(len(cj)):
            assert_rel(ct[k], np.asarray(cj[k]), 1e-12)
        return
    scale = float(np.abs(np.asarray(rj)).max())
    assert_close_scaled(rt, np.asarray(rj), 5e-6)
    for k in range(len(cj)):
        ref = np.asarray(cj[k])
        # whitened planes at the reconstruction's scale; planes that are
        # not whitened (whitening=False, h >= 1) at their own
        assert_close_scaled(ct[k], ref, 5e-6, scale if whitened else max(
            scale, float(np.abs(ref).max())))


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_wow_options_match_jax(frames, case, dtype):
    kw = OPTION_CASES[case]
    x = frames[(256, 256)].astype(dtype)
    rj, cj = J.wow(x, **kw)
    _build.reset_counters()
    rt, ct = T.wow(x, device="cpu", **kw)
    whitened = kw.get("whitening", True) and kw.get("h", 0) < 1
    if dtype == np.float32 and whitened:
        # the materialized-plane route: kernel C's pieces, kernel D's
        # whitening (their plain versions on the CPU)
        assert _build.PLAIN_CALLS["decompose_group"] >= 1
        assert _build.PLAIN_CALLS["whiten_plane"] >= 2
    _assert_wow_close(rt, ct, rj, cj, dtype, whitened)


@pytest.mark.parametrize("case", ["pv-lazy", "gamma"])
def test_wow_options_odd_shape(frames, case):
    x = frames[(200, 328)].astype(np.float32)
    kw = OPTION_CASES[case]
    rj, cj = J.wow(x, **kw)
    rt, ct = T.wow(x, device="cpu", **kw)
    _assert_wow_close(rt, ct, rj, cj, np.float32)


REUSE_CASES = [("cube", None), ("rows", None), ("cube", 0.4),
               ("rows", 0.4)]


@pytest.mark.parametrize("form,noise", REUSE_CASES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_wow_from_coefficients_matches_jax(frames, form, noise, dtype):
    x = frames[(256, 256)].astype(dtype)
    jc = J.AtrousTransform()(x, 6)
    jc.noise = noise
    cube = np.asarray(jc.data)
    data = (tuple(torch.from_numpy(cube[s].copy()) for s in range(7))
            if form == "rows" else cube.copy())
    tc = T.Coefficients(data, T.B3spline(2), device="cpu")
    tc.noise = noise
    kw = dict(denoise_coefficients=[5, 2])
    rj, cj = J.wow(jc, **kw)
    _build.reset_counters()
    rt, ct = T.wow(tc, **kw)
    assert ct.noise == cj.noise == noise
    assert ("median_select" in _build.PLAIN_CALLS) == (
        noise is None and dtype == np.float32)
    if form == "rows":
        assert ct._rows is not None
    _assert_wow_close(rt, ct, rj, cj, dtype)


@pytest.mark.parametrize("case", ["pv-lazy", "gamma"])
def test_wow_from_coefficients_options(frames, case):
    x = frames[(256, 256)].astype(np.float32)
    kw = {k: v for k, v in OPTION_CASES[case].items() if k != "n_scales"}
    rj, cj = J.wow(J.AtrousTransform()(x, 6), **kw)
    rt, ct = T.wow(T.AtrousTransform()(x, 6, device="cpu"), **kw)
    _assert_wow_close(rt, ct, rj, cj, np.float32)


@pytest.mark.parametrize("shape,pairs,steps", [
    ((512, 512), 1, 1),      # L6: group 0-2, step 3, pair (4, 5)
    ((250, 256), 0, 3),      # 8 does not divide 250: no pair, 3 steps
])
def test_main_path_takes_the_pair(shape, pairs, steps):
    x = (np.random.default_rng(1).normal(size=shape) * 3 + 10
         ).astype(np.float32)
    _build.reset_counters()
    rt, ct = T.wow(x, n_scales=6, denoise_coefficients=[5, 2], device="cpu")
    assert _build.PLAIN_CALLS == {
        "decompose_group": 1, "whiten_group": 1, "whiten_step": steps,
        "median_select": 1, **({"whiten_pair": pairs} if pairs else {})}
    rj, cj = J.wow(x, n_scales=6, denoise_coefficients=[5, 2])
    _assert_wow_close(rt, ct, rj, cj, np.float32)


@pytest.mark.parametrize("shape", [(37, 70), (64, 64), (200, 328)])
def test_lazy_noise_is_bitwise_the_plain_w0(shape):
    # the lazy noise's w0 is kernel C's one-scale detail (its plain version
    # on the CPU): recon and planes bit for bit those of a call given the
    # MAD noise of the plain w0 = x − smooth(x, 0) as known noise
    x = torch.from_numpy((np.random.default_rng(8).normal(size=shape) * 3
                          + 10).astype(np.float32))
    w0 = x - smooth(x, B3SPLINE, scale=0, axes=(-2, -1))
    noise = mad_noise(w0, float(B3SPLINE.sigma_e(2, False)[0]))
    assert noise.ndim == 0
    _build.reset_counters()
    r_l, c_l = T.wow(x, denoise_coefficients=[5, 2], device="cpu")
    assert _build.PLAIN_CALLS["decompose_group"] == 1
    n, w, d, _ = twow.normalize_wow_params(B3SPLINE, None, [], [5, 2], None,
                                           0, 2, min(shape))
    r_k, p_k = twow.wow_core(
        x, noise, sf=B3SPLINE, n_scales=n, weights=w, whitening=True,
        denoise_coefficients=d, bilateral=None, bilateral_scaling=False,
        soft_threshold=True, preserve_variance=False, gamma=3.2,
        gamma_min=None, gamma_max=None, h=0.0, has_noise=True,
        planes_layout="rows")
    assert torch.equal(r_l, r_k)
    assert len(c_l) == len(p_k) == n + 1
    for k in range(n + 1):
        assert torch.equal(c_l[k], p_k[k]), k


def test_fused_body_with_deferred_tail_is_the_merged_body(frames):
    # the materialized-plane body over kernel C's first group, with scales
    # 3.. deferred to the deep steps and the pair, gives the main path's
    # bits
    x = torch.from_numpy(frames[(256, 256)].astype(np.float32))
    n, w, d = 6, (1.0, 2.0, 0.5, 1.0, 1.5, 1.0, 1.0), (5, 2, 0, 1, 0, 0, 1)
    pieces, layout, tail = tdecompose_pieces(x, n, B3SPLINE, defer_tail=True)
    assert tail[1] == 3
    zero = torch.zeros((), dtype=x.dtype)
    r_f, c_f = twow._wow_body_fused(pieces, layout, tail, zero, False,
                                    B3SPLINE, n, w, d, True,
                                    planes_layout="rows")
    r_m, c_m = twow._wow_body_merged(x, zero, False, B3SPLINE, n, w, d, True,
                                     kernels=True)
    assert torch.equal(r_f, r_m)
    assert all(torch.equal(a, b) for a, b in zip(c_f, c_m))


FUSED_CASES = {
    # P3: the gamma blend, and with preserve_variance
    "P3-gamma": dict(h=0.5, denoise_coefficients=[5, 2]),
    "P3-pv": dict(h=0.5, preserve_variance=True,
                  denoise_coefficients=[5, 2]),
    # B4: WOW of a bilateral transform's planes
    "B4": dict(bilateral=1),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
@pytest.mark.parametrize("need_planes", [True, False])
def test_fused_body_with_materialized_deep_planes_matches_jax(frames, case,
                                                              need_planes):
    # _wow_body_fused, which adds each deep plane's white into the recon
    # inside kernel D's wrapper (and writes no deep white without planes):
    # one pieces call for scales 0-2, one plane call a deeper scale, the
    # recon bitwise the same with and without planes, against the JAX
    # package
    n = 6
    kw = dict(FUSED_CASES[case])
    bilateral = kw.pop("bilateral", None)
    x = frames[(256, 256)].astype(np.float32)
    if bilateral:
        x = x - 10   # zero mean keeps the bilateral chain well conditioned
        rj, cj = J.wow(J.AtrousTransform(bilateral=1)(x, n))
        cube = T.AtrousTransform(bilateral=1)(x, n, device="cpu").data
        pieces, layout = (cube,), tuple((0, s) for s in range(n + 1))
    else:
        rj, cj = J.wow(x, n_scales=n, **kw)
        pieces, layout = tdecompose_pieces(torch.from_numpy(x), n, B3SPLINE)
    _, w, d, _ = twow.normalize_wow_params(
        B3SPLINE, n, [], kw.pop("denoise_coefficients", []), None, 0, 2)
    zero = torch.zeros(())
    run = dict(bilateral=(1.0,) * (n + 1) if bilateral else None,
               planes_layout="rows", **kw)
    _build.reset_counters()
    rt, ct = twow._wow_body_fused(pieces, layout, None, zero, False,
                                  B3SPLINE, n, w, d, True,
                                  need_planes=need_planes, **run)
    assert _build.PLAIN_CALLS["whiten_plane"] == 1 + n - twow.N_FAST
    assert_close_scaled(rt, np.asarray(rj), 5e-6)
    if need_planes:
        _assert_wow_close(rt, ct, rj, cj, np.float32)
        r2, none = twow._wow_body_fused(pieces, layout, None, zero, False,
                                        B3SPLINE, n, w, d, True,
                                        need_planes=False, **run)
        assert none is None and torch.equal(rt, r2)
    else:
        assert ct is None


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
    r, c = T.wow(np.full((64, 64), 3.0), denoise_coefficients=[5, 2],
                 device="cpu")
    assert torch.isfinite(r).all()


def test_wow_numpy_goes_to_cpu_and_int_to_float64():
    # numpy goes where ``device`` says; int goes to float64
    r, c = T.wow(np.arange(64 * 64).reshape(64, 64).astype(np.int32),
                 device="cpu")
    assert r.dtype == torch.float64 and r.device.type == "cpu"
    assert c[0].device.type == "cpu"


@pytest.mark.parametrize("entry", ["wow", "denoise", "AtrousTransform"])
def test_numpy_input_without_device_needs_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: numpy input goes there")
    x = np.zeros((32, 32), np.float32)
    calls = {"wow": lambda: T.wow(x),
             "denoise": lambda: T.denoise(x, [3]),
             "AtrousTransform": lambda: T.AtrousTransform()(x, 2)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


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


@pytest.mark.parametrize("option", ["bfloat16", "3d", "wow_stack"])
def test_low_precision_front_doors_match_jax(option):
    # once refused: bfloat16 and float16 through every front door, on the
    # CPU, held within 2^-8 of the JAX package's reconstruction (its XLA
    # path, where it sends both dtypes on the CPU)
    import jax.numpy as jnp
    rng = np.random.default_rng(len(option))
    shape = (16, 32, 32) if option == "3d" else (
        (2, 64, 64) if option == "wow_stack" else (64, 64))
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    dt_j, dt_t = ((jnp.float16, torch.float16) if option == "3d"
                  else (jnp.bfloat16, torch.bfloat16))
    j = jnp.asarray(x).astype(dt_j)
    t = torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(dt_t)
    kw = dict(denoise_coefficients=[3, 1])
    if option == "wow_stack":
        r_j, _ = J.wow_stack(j, n_scales=4, **kw)
        r_t, _ = twow.wow_stack(t, n_scales=4, device="cpu", **kw)
    else:
        r_j, _ = J.wow(j, **kw)
        r_t, _ = T.wow(t, device="cpu", **kw)
    assert r_t.dtype == dt_t and r_t.shape == shape
    assert_close_scaled(r_t.float(), np.asarray(r_j.astype(jnp.float32)),
                        2 ** -8)


def test_bad_inputs_raise_value_error():
    with pytest.raises(ValueError, match="Unknown input type"):
        T.wow([[1.0, 2.0], [3.0, 4.0]])
    with pytest.raises(ValueError, match="dimensions"):
        T.wow(np.zeros(16))


def test_import_loads_no_jax():
    modules = ["wavelets_tpu_torch", "wavelets_tpu_torch.api",
               "wavelets_tpu_torch.core.transform",
               "wavelets_tpu_torch.models.denoise",
               "wavelets_tpu_torch.models.wow",
               "wavelets_tpu_torch.ops.hopper_bilateral",
               "wavelets_tpu_torch.ops.hopper_conv",
               "wavelets_tpu_torch.ops.hopper_deep",
               "wavelets_tpu_torch.ops.hopper_stats",
               "wavelets_tpu_torch.ops.hopper_wow",
               "wavelets_tpu_torch.ops.stats"]
    code = (f"import sys, importlib; [importlib.import_module(m) for m in "
            f"{modules!r}]; print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_exports():
    for name in ["wow", "wow_core", "denoise", "decompose", "synthesize",
                 "AtrousTransform", "B3spline", "Triangle", "Coefficients",
                 "ScalingFunction", "B3SPLINE", "TRIANGLE"]:
        assert name in T.__all__ and hasattr(T, name)
