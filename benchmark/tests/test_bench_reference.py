"""The plain reference against the port's CPU path at small sizes, with
both configurations' options, on the benchmark's own frames."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import wavelets_tpu_torch as wt  # noqa: E402
from benchmark import harness  # noqa: E402
from benchmark.frames import make_frames  # noqa: E402
from benchmark.reference import wow as ref  # noqa: E402

# float32 round-off: the standard path's folds and divisions only; the
# bilateral range weights amplify the round-off of the local variance on
# frames of a large mean (hundreds of counts)
TOL = {None: 1e-6, 1: 3e-4}


def _frames(h, w, n=2, seed=2 ** 36 + 11):
    config = dict(harness.resolve(harness.load_spec(), "aia_wow.frame").config,
                  height=h, width=w)
    return make_frames(config, n, seed, "cpu")


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("bilateral", [None, 1])
@pytest.mark.parametrize("shape", [(128, 128), (96, 160)])
def test_wow_matches_the_port(bilateral, shape):
    kw = dict(denoise_coefficients=[5, 2])
    if bilateral is not None:
        kw["bilateral"] = bilateral
    for x in _frames(*shape):
        recon, coeffs = wt.wow(x, device="cpu", **kw)
        r_recon, r_planes = ref.wow(x, **kw)
        assert len(coeffs) == len(r_planes) == ref.auto_scales(*shape) + 1
        assert _rel(recon, r_recon) < TOL[bilateral]
        for s in range(len(r_planes)):
            assert _rel(coeffs[s], r_planes[s]) < TOL[bilateral], s


def test_wow_stack_matches_per_frame():
    x = _frames(128, 128, n=4)
    recon, planes = wt.wow_stack(x, with_coefficients=False, device="cpu",
                                 denoise_coefficients=[5, 2])
    assert planes is None
    for b in range(4):
        r, _ = ref.wow(x[b], denoise_coefficients=[5, 2], keep_planes=False)
        assert _rel(recon[b], r) < TOL[None]


def test_the_decomposition_sums_to_the_frame():
    x = _frames(64, 64, n=1)[0]
    for bil in (None, [1.0] * 6):
        planes = ref.decompose(x, 5, bil)
        assert torch.allclose(sum(planes), x, rtol=0, atol=1e-3)


def test_known_noise_and_the_median():
    x = _frames(64, 64, n=1)[0]
    r, _ = ref.wow(x, denoise_coefficients=[5, 2], noise=3.0)
    p, _ = wt.wow(x, device="cpu", denoise_coefficients=[5, 2], noise=3.0)
    assert _rel(p, r) < TOL[None]
    v = torch.tensor([3.0, -1.0, 2.0, -4.0])
    assert float(ref.median_abs(v)) == 2.5


@pytest.mark.parametrize("key,value", [("scaling_function", "Triangle"),
                                       ("soft_threshold", False), ("h", 0.5)])
def test_options_the_reference_does_not_compute_are_refused(key, value):
    config = harness.resolve(harness.load_spec(), "aia_wow.frame").config
    assert ref.options(config)["soft_threshold"] is True
    with pytest.raises(ValueError):
        ref.options(dict(config, **{key: value}))
    with pytest.raises(KeyError):
        ref.options({k: v for k, v in config.items() if k != key})
    with pytest.raises(ValueError):
        ref.wow(_frames(32, 32, n=1)[0], **dict(ref.options(config),
                                                soft_threshold=False))
