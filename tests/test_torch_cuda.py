"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at small shapes.  Marked ``cuda``: without a CUDA device every
test skips (decided in the fixture, not at import).  On a GPU machine,
which has no JAX: ``python -m pytest tests/test_torch_cuda.py -q
--noconftest`` (tests/conftest.py sets up JAX).

Tolerances (as chip_smoke.py): the carry (``c_next``) within 1 unit in
the last place of its magnitude (the folds are rounded step by step in
both versions, so bitwise is expected); whitened planes, ``acc`` and the
reconstruction within ``5e-6·max(|ref|, 1)`` (``erff`` against
``torch.erf``); kernel B bitwise."""

import numpy as np
import pytest
import torch

from tests.torch_parity import assert_close_scaled, to_np
from wavelets_tpu_torch import wow
from wavelets_tpu_torch.ops import _build, hopper_conv, hopper_deep, hopper_stats
from wavelets_tpu_torch.ops.filters import B3SPLINE, TRIANGLE

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _carry_ok(got, ref):
    ref = to_np(ref)
    err = np.abs(to_np(got) - ref).max()
    assert err <= np.spacing(np.float32(np.abs(ref).max())), err


@pytest.mark.parametrize("shape", [(64, 96), (37, 70)])
@pytest.mark.parametrize("s", [0, 2, 5])
@pytest.mark.parametrize("mode", ["soft", "hard", "unmasked"])
def test_deep_step_kernel_vs_plain(dev, shape, s, mode):
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.normal(size=(2,) + shape).astype(np.float32))
    x = x.to(dev)
    thr = torch.tensor([0.1, 0.0], device=dev)
    recon = torch.from_numpy(rng.normal(size=(2,) + shape)
                             .astype(np.float32)).to(dev)
    kw = dict(sf=B3SPLINE, scale=s, weight=1.5, soft=mode == "soft",
              masked=mode != "unmasked")
    r_k, r_p = recon.clone(), recon.clone()
    w_k, _, c_k = hopper_deep.deep_whiten_step(x, r_k, thr, **kw)
    w_p, _, c_p = hopper_deep.deep_whiten_step_plain(x, r_p, thr, **kw)
    torch.cuda.synchronize()
    _carry_ok(c_k, c_p)
    assert_close_scaled(w_k, w_p, 5e-6)
    assert_close_scaled(r_k, r_p, 5e-6)


@pytest.mark.parametrize("sf", [B3SPLINE, TRIANGLE], ids=["b3", "tri"])
@pytest.mark.parametrize("need_cube", [True, False])
def test_group_kernel_vs_plain(dev, sf, need_cube):
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(80, 72))
                         .astype(np.float32)).to(dev)
    args = ([2.0, 1.0, 0.5], torch.tensor([0.3, 0.0, 0.01], device=dev), 3,
            sf)
    kw = dict(offset=1, soft=True, masked=(True, True, False),
              need_cube=need_cube)
    rows_k, acc_k = hopper_conv.fused_wow_group(x, *args, **kw)
    rows_p, acc_p = hopper_conv.fused_wow_group_plain(x, *args, **kw)
    torch.cuda.synchronize()
    assert len(rows_k) == len(rows_p)
    for a, b in zip(rows_k[:-1], rows_p[:-1]):
        assert_close_scaled(a, b, 5e-6)
    _carry_ok(rows_k[-1], rows_p[-1])
    assert_close_scaled(acc_k, acc_p, 5e-6)


@pytest.mark.parametrize("n", [1, 2, 1001, 65536])
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_median_kernel_bitwise(dev, n, kind):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) if kind == "normal"
         else rng.choice([-1.0, 0.0, 2.0, 2.5], size=n)).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    got = hopper_stats.median_abs(xt)
    plain = hopper_stats.median_abs(xt, hopper_stats.median_bits2_plain)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    want = np.median(np.abs(x))
    assert to_np(got).tobytes() == want.tobytes()
    assert to_np(plain).tobytes() == want.tobytes()


def test_wow_kernel_path_vs_plain(dev):
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(256, 256))
                         .astype(np.float32) * 3 + 10).to(dev)
    _build.reset_counters()
    r_k, c_k = wow(x, n_scales=6, denoise_coefficients=[5, 2])
    torch.cuda.synchronize()
    launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
    r_p, c_p = wow(x, n_scales=6, denoise_coefficients=[5, 2], fuse=False)
    # one kernel A launch per scale
    assert len(c_k) == 7
    assert launches == {"whiten_step": 6, "median_select": 1}
    assert plain == {}
    assert r_k.device.type == "cuda" and bool(torch.isfinite(r_k).all())
    scale = float(r_p.abs().max())
    assert_close_scaled(r_k, r_p, 5e-6)
    for k in range(len(c_p)):
        assert_close_scaled(c_k[k], c_p[k], 5e-6, scale)


def test_wrappers_refuse_what_the_kernel_cannot_take(dev):
    x = torch.zeros(1, 16, 16, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        hopper_deep.deep_whiten_step(x, None, torch.zeros(1, device=dev),
                                     sf=B3SPLINE, scale=0, weight=1.0)
    with pytest.raises(TypeError):
        hopper_stats.median_bits2(x.reshape(-1), (0, 0))
    # float64 on the card runs the plain versions by the documented
    # dtype rule, with no launch
    _build.reset_counters()
    r, _ = wow(torch.ones(64, 64, dtype=torch.float64, device=dev),
               denoise_coefficients=[3])
    assert r.device.type == "cuda" and not _build.LAUNCHES
