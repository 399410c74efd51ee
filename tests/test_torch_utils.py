"""The port's ``utils`` against the JAX package's: the σ_e noise
calibration (the per-batch statistic on the same noise, and the tables
within Monte-Carlo spread), ``checked`` and ``assert_finite``, and the
profiling tools (``Cost`` counts, ``StageTimer``, ``roofline`` and
``trace`` on the CPU, the H100 bound).

Tolerances: the statistic of float64 noise within 1e-12 relative, of
float32 noise within 5e-6 relative (a std over a plane, summed over the
batch); the tables as ``tests/test_calibration.py`` holds the JAX
package's (rtol 0.08 for 8 trials in 2-D, 0.12 for 16 in 1-D, 0.3 for
2 bilateral trials); the cost counts exactly."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import wavelets_tpu as J
import wavelets_tpu_torch as T
from tests.torch_parity import assert_rel
from wavelets_tpu.core.transform import decompose as jdecompose
from wavelets_tpu.utils import profiling as jprof
from wavelets_tpu_torch.ops import _build
from wavelets_tpu_torch.utils import noise_calibration as tcal
from wavelets_tpu_torch.utils import profiling as tprof
from wavelets_tpu_torch.utils.validation import assert_finite, checked


def _jax_batch_sigma_sum(noise, sf, n_scales, bilateral=None):
    """The body of the JAX package's calibration scan
    (wavelets_tpu/utils/noise_calibration.py:46-55) on given noise."""
    n_dim = noise.ndim - 1
    planes = jdecompose(jnp.asarray(noise), n_scales, sf,
                        axes=tuple(range(1, n_dim + 1)), bilateral=bilateral)
    stds = jnp.std(planes[:-1], axis=tuple(range(2, n_dim + 2)))
    return np.asarray(jnp.sum(stds, axis=1))


# bilateral on the 1-D and 2-D trials: JAX takes 10-25 s to compile the
# 3-D bilateral transform
@pytest.mark.parametrize("n_dim,shape,bilateral", [
    (1, (4, 176), False), (1, (4, 176), True), (2, (3, 44, 44), False),
    (2, (3, 44, 44), True), (3, (2, 12, 16, 20), False)])
@pytest.mark.parametrize("cls", ["B3spline", "Triangle"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_batch_statistic_matches_jax(n_dim, shape, bilateral, cls, dtype):
    noise = np.random.default_rng(n_dim).normal(size=shape).astype(dtype)
    spec = getattr(J, cls)._spec
    bil = (1.0, 2.0, 1.0) if bilateral else None
    ref = _jax_batch_sigma_sum(noise, spec, 2, bil)
    got = tcal.batch_sigma_sum(torch.from_numpy(noise),
                               getattr(T, cls)._spec, 2, bil)
    assert got.shape == (2,) and got.dtype == torch.from_numpy(noise).dtype
    assert_rel(got, ref, 1e-12 if dtype == np.float64 else 5e-6)


def test_compute_noise_weights_matches_table_2d():
    got = T.B3spline(2).compute_noise_weights(4, n_trials=8, seed=0,
                                              device="cpu")
    assert got.shape == (4,) and got.dtype == np.float32
    np.testing.assert_allclose(got, T.B3spline(2).sigma_e()[:4], rtol=0.08)


def test_compute_noise_weights_matches_table_1d():
    got = T.Triangle(1).compute_noise_weights(4, n_trials=16, seed=1,
                                              device="cpu")
    np.testing.assert_allclose(got, T.Triangle(1).sigma_e()[:4], rtol=0.12)


def test_compute_noise_weights_bilateral():
    got = T.B3spline(2).compute_noise_weights(3, n_trials=2, bilateral=1,
                                              seed=2, device="cpu")
    assert got.shape == (3,)
    np.testing.assert_allclose(got, T.B3spline(2).sigma_e(bilateral=1)[:3],
                               rtol=0.3)


def test_compute_noise_weights_batches_and_seed():
    # the batches cover the trials in order: one batch of 6 is the mean
    # of the statistic over the generator's first 6 draws; the same seed
    # gives the same numbers, another seed others
    kw = dict(sf=T.B3SPLINE, n_dim=2, n_scales=2, n_trials=6, device="cpu")
    one = tcal.compute_noise_weights(batch=6, **kw)
    gen = torch.Generator().manual_seed(0)
    noise = torch.randn((6, 44, 44), generator=gen, dtype=torch.float32)
    assert np.array_equal(
        one, (tcal.batch_sigma_sum(noise, T.B3SPLINE, 2) / 6).numpy())
    assert np.array_equal(one, tcal.compute_noise_weights(batch=6, **kw))
    # batch 4 does not divide 6: it falls to 3
    three = tcal.compute_noise_weights(batch=4, **kw)
    assert_rel(three, one, 1e-6)
    assert not np.array_equal(tcal.compute_noise_weights(seed=1, **kw), one)


def test_compute_noise_weights_runs_kernel_c_plain_version():
    _build.reset_counters()
    tcal.compute_noise_weights(T.B3SPLINE, 2, 4, n_trials=4, batch=2,
                               device="cpu")
    # two batches, each a 4-scale decomposition: groups of 3 and 1
    assert _build.PLAIN_CALLS == {"decompose_group": 4}


def test_checked_raises_and_names_the_operation():
    fn = checked(lambda x: torch.log(x) + 1)
    with pytest.raises(FloatingPointError, match="aten.log"):
        fn(torch.tensor([-1.0, 2.0]))
    with pytest.raises(FloatingPointError, match="aten.div"):
        checked(lambda x: x / 0.0)(torch.ones(3))
    assert torch.equal(fn(torch.ones(2)), torch.ones(2))


def test_checked_passes_a_finite_pipeline():
    x = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    recon, _ = checked(T.wow)(x, denoise_coefficients=[5, 2], device="cpu")
    ref, _ = T.wow(x, denoise_coefficients=[5, 2], device="cpu")
    assert torch.equal(recon, ref)
    out = checked(T.richardson_lucy)(x * x + 1, np.ones((3, 3)) / 9,
                                     iterations=2, device="cpu")
    assert bool(torch.isfinite(out).all())


def test_checked_checks_the_outputs():
    # an output no PyTorch operation produced (as a kernel's, written
    # through ctypes) is checked on the way out
    bad = torch.tensor([np.nan])
    with pytest.raises(FloatingPointError, match="returned"):
        checked(lambda: bad)()


def test_assert_finite():
    assert_finite(np.ones(4))
    assert_finite(torch.ones(4))
    with pytest.raises(FloatingPointError, match="x: 2/4"):
        assert_finite(torch.tensor([1.0, np.inf, np.nan, 0.0]), "x")


@pytest.mark.parametrize("shape", [(1024, 1024), (4096, 4096), (3, 64, 64)])
@pytest.mark.parametrize("level", [1, 6, 10])
@pytest.mark.parametrize("denoise", [False, True])
def test_cost_counts_match_jax(shape, level, denoise):
    for sf_t, sf_j in ((T.B3SPLINE, J.B3SPLINE), (T.TRIANGLE, J.TRIANGLE)):
        a = tprof.decompose_cost(shape, level, sf_t)
        b = jprof.decompose_cost(shape, level, sf_j)
        assert (a.flops, a.hbm_bytes) == (b.flops, b.hbm_bytes)
        a = tprof.wow_cost(shape, level, sf_t, denoise=denoise)
        b = jprof.wow_cost(shape, level, sf_j, denoise=denoise)
        assert (a.flops, a.hbm_bytes) == (b.flops, b.hbm_bytes)
        both = a + tprof.decompose_cost(shape, level, sf_t)
        assert both.flops == a.flops + tprof.decompose_cost(
            shape, level, sf_t).flops


def test_bounds_are_the_h100s():
    c = tprof.Cost(flops=67e9, hbm_bytes=3.35e9)
    assert c.bound_ms() == pytest.approx(1.0)
    assert c.bound_ms(bw_gbps=1675.0) == pytest.approx(2.0)
    assert tprof.bound_ms(3.35e9, 1.0) == (pytest.approx(1.0), "bytes")
    assert tprof.bound_ms(1.0, 134e9) == (pytest.approx(2.0), "operations")


def test_stage_timer_on_the_cpu():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(128, 128)).astype(np.float32))
    t = tprof.StageTimer(device="cpu")
    for _ in range(2):
        with t.stage("decompose") as box:
            box["out"] = T.decompose(x, 3, T.B3SPLINE)
    assert len(t.times["decompose"]) == 2 and min(t.times["decompose"]) > 0
    assert "decompose" in t.report() and "best of 2" in t.report()


def test_roofline_on_the_cpu():
    x = torch.ones(256, 256)
    r = tprof.roofline(lambda a: a * 2 + 1, (x,),
                       tprof.Cost(flops=x.numel() * 2,
                                  hbm_bytes=2 * x.numel() * 4),
                       iters=3, device="cpu")
    assert r["measured_ms"] > 0 and r["achieved_gbps"] > 0
    assert r["bound_ms"] == pytest.approx(2 * x.numel() * 4 / 3.35e12 * 1e3)


def test_trace_on_the_cpu(tmp_path):
    x = torch.ones(64, 64)
    with tprof.trace(str(tmp_path / "t"), device="cpu") as prof:
        T.decompose(x, 2, T.B3SPLINE)
    assert len(prof.key_averages()) > 0
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_timers_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprof.StageTimer()
