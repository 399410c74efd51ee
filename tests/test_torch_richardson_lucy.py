"""Richardson-Lucy deconvolution in the port against the JAX package:
``richardson_lucy`` on a frame and ``richardson_lucy_stack`` on a stack,
the direct, FFT and automatic paths, soft and hard thresholds,
``uniform_init`` and ``persistent_mrs=False``, odd shapes and an even,
asymmetric PSF; the pieces (the symmetric correlation, the PSF spectrum,
the ``fft="auto"`` rule), the kernels' plain versions the path runs, and
the stack's unknown keyword arguments.

Tolerances: float64 within 1e-12 relative, the FFT path too (the two
packages' FFTs differ by a few units of float64 round-off: 1e-15
relative measured on these inputs); float32 within ``5e-6·max|ref|``."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import wavelets_tpu as J
import wavelets_tpu_torch as T
from tests.torch_parity import assert_close_scaled, assert_rel, to_np
from wavelets_tpu_torch.ops import _build

# the packages' ``models`` export a function of the module's name
jrl = importlib.import_module("wavelets_tpu.models.richardson_lucy")
trl = importlib.import_module("wavelets_tpu_torch.models.richardson_lucy")

SHAPE = (37, 53)


def _hanning_psf(n):
    h = np.hanning(n + 2)[1:-1]
    psf = np.outer(h, h)
    return psf / psf.sum()


#: even and asymmetric: cv2's anchor and the flip are both visible
EVEN = np.random.default_rng(9).uniform(0.1, 1.0, size=(4, 6))
PSFS = {
    "hann5": _hanning_psf(5),
    "hann7": _hanning_psf(7),
    "even4x6": EVEN / EVEN.sum(),
}
OPTIONS = {
    "soft": dict(),
    "hard": dict(threshold_type="hard"),
    "uniform_init": dict(uniform_init=True),
    "not_persistent": dict(persistent_mrs=False),
    "hard_not_persistent": dict(threshold_type="hard", persistent_mrs=False,
                                denoise_coefficients=(3, 0, 2)),
}


def _data(shape, seed=0):
    # the JAX benchmark's RL input: x·x + 1, x standard normal
    return np.random.default_rng(seed).normal(size=shape) ** 2 + 1


def _close(got, ref, dtype):
    if dtype == np.float64:
        assert_rel(got, ref, 1e-12)
    else:
        assert_close_scaled(got, ref, 5e-6)


@pytest.mark.parametrize("psf", sorted(PSFS))
@pytest.mark.parametrize("fft", [False, True, "auto"], ids=str)
@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_richardson_lucy_matches_jax(psf, fft, option, dtype):
    x = _data(SHAPE).astype(dtype)
    p = PSFS[psf].astype(dtype)
    kw = dict(OPTIONS[option], iterations=3, fft=fft)
    ref = np.asarray(J.richardson_lucy(x, p, **kw))
    got = T.richardson_lucy(x, p, device="cpu", **kw)
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == SHAPE
    _close(got, ref, dtype)


@pytest.mark.parametrize("fft", [False, True], ids=str)
@pytest.mark.parametrize("option", ["soft", "hard"])
def test_unnormalized_psf_float64(fft, option):
    # a kernel that does not sum to 1 scales each iteration by its sum:
    # float32 is then ill-conditioned in both packages (JAX's float32
    # strays 1.4e-5·max from float64 on this input, the port's 3.5e-6),
    # so the semantics are held in float64
    x = _data(SHAPE)
    kw = dict(OPTIONS[option], iterations=3, fft=fft)
    assert_rel(T.richardson_lucy(x, EVEN, device="cpu", **kw),
               np.asarray(J.richardson_lucy(x, EVEN, **kw)), 1e-12)


@pytest.mark.parametrize("fft", [False, True, "auto"], ids=str)
@pytest.mark.parametrize("option", ["soft", "hard", "uniform_init"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_richardson_lucy_stack_matches_jax(fft, option, dtype):
    x = _data((2,) + SHAPE, seed=1).astype(dtype)
    x[1] *= 3.0  # per-frame statistics differ
    p = PSFS["hann7"].astype(dtype)
    kw = dict(OPTIONS[option], iterations=3, fft=fft)
    ref = np.asarray(J.richardson_lucy_stack(x, p, **kw))
    got = T.richardson_lucy_stack(x, p, device="cpu", **kw)
    _close(got, ref, dtype)


@pytest.mark.parametrize("fft", [False, True], ids=str)
@pytest.mark.parametrize("option", ["soft", "uniform_init"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_stack_is_a_loop_of_frames(fft, option, dtype):
    # bitwise: per-frame statistics, and the PSF transforms run a frame
    # at a time (a batched inverse FFT rounds otherwise)
    x = torch.from_numpy(_data((3, 24, 40), seed=2).astype(dtype))
    x[2] += 5.0
    p = PSFS["even4x6"].astype(dtype)
    kw = dict(OPTIONS[option], iterations=3, fft=fft)
    got = T.richardson_lucy_stack(x, p, **kw)
    for b in range(3):
        assert torch.equal(got[b], T.richardson_lucy(x[b], p, **kw))


@pytest.mark.parametrize("shape", [(37, 53), (3, 21, 16)])
@pytest.mark.parametrize("psf", sorted(PSFS))
def test_correlation_matches_jax(shape, psf):
    x = _data(shape, seed=3)
    p = PSFS[psf]
    ref = np.asarray(jrl._correlate2d_symmetric(jnp.asarray(x),
                                                jnp.asarray(p)))
    xt, pt = torch.from_numpy(x), torch.from_numpy(p)
    assert_rel(trl._correlate2d_symmetric(xt, pt), ref, 1e-12)
    assert_rel(trl._correlate2d_shift_add(xt, pt), ref, 1e-12)


@pytest.mark.parametrize("shape", [(37, 53), (16, 16), (8, 9), (7, 7),
                                   (5, 4)])
@pytest.mark.parametrize("psf", sorted(PSFS))
def test_fft_psf_matches_jax(shape, psf):
    p = PSFS[psf]
    if p.shape[0] > shape[0] or p.shape[1] > shape[1]:
        # a PSF wider than the frame has no place in it: both refuse it
        with pytest.raises(TypeError):
            jrl._fft_psf(jnp.asarray(p), shape)
        with pytest.raises(ValueError):
            trl._fft_psf(torch.from_numpy(p), shape)
        return
    ref = np.asarray(jrl._fft_psf(jnp.asarray(p), shape))
    got = trl._fft_psf(torch.from_numpy(p), shape)
    assert_rel(got, ref, 1e-12)


@pytest.mark.parametrize("shape", [(1, 1), (3, 3), (5, 5), (6, 6), (6, 7),
                                   (7, 7), (15, 15), (4, 9), (1, 37)])
@pytest.mark.parametrize("fft", ["auto", None, True, False, 0, 1])
def test_fft_auto_rule(shape, fft):
    assert trl._fft_auto(fft, shape) == jrl._fft_auto(fft, shape)


def test_stack_unknown_keyword_raises():
    # JAX's richardson_lucy_stack ignores an unknown keyword silently
    # (a defect of the JAX package); the port raises
    x = _data((2, 16, 16))
    with pytest.raises(TypeError):
        T.richardson_lucy_stack(x, PSFS["hann5"], iteration=3, device="cpu")
    with pytest.raises(TypeError):
        T.richardson_lucy_stack(x, PSFS["hann5"], denoise=(5, 2),
                                device="cpu")
    with pytest.raises(ValueError):
        T.richardson_lucy_stack(x[0], PSFS["hann5"], device="cpu")


@pytest.mark.parametrize("option,frames", [
    ("soft", 1), ("uniform_init", 1), ("soft", 2), ("uniform_init", 2)])
def test_path_runs_the_kernels_plain_versions(option, frames):
    # float32 on the CPU: kernel C's wrapper once a decomposition (the
    # start and each iteration; no start under uniform_init) and kernel
    # B's once a frame (once a frame an iteration under uniform_init)
    shape = (frames, 32, 40) if frames > 1 else (32, 40)
    x = torch.from_numpy(_data(shape).astype(np.float32))
    fn = T.richardson_lucy_stack if frames > 1 else T.richardson_lucy
    _build.reset_counters()
    out = fn(x, PSFS["hann5"], iterations=4, **OPTIONS[option])
    uniform = option == "uniform_init"
    assert _build.PLAIN_CALLS == {
        "decompose_group": 4 if uniform else 5,
        "median_select": frames * (4 if uniform else 1)}
    assert not _build.LAUNCHES
    _build.reset_counters()
    plain = fn(x, PSFS["hann5"], iterations=4, fuse=False, **OPTIONS[option])
    assert _build.PLAIN_CALLS == {
        "median_select": frames * (4 if uniform else 1)}
    assert torch.equal(out, plain)


def test_input_rules():
    x = (_data((20, 24)) * 100).astype(np.uint16)
    p = PSFS["hann5"]
    got = T.richardson_lucy(x, p, iterations=2, device="cpu")
    assert got.dtype == torch.float64  # the reference's integer recast
    assert_rel(got, np.asarray(J.richardson_lucy(x, p, iterations=2)), 1e-12)
    with pytest.raises(ValueError):
        T.richardson_lucy(x, p[None], device="cpu")
    assert to_np(T.richardson_lucy(torch.from_numpy(x.astype(np.float32)),
                                   p.astype(np.float32),
                                   iterations=1)).dtype == np.float32
