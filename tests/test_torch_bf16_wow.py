"""bfloat16 WOW on the merged route: the port's bfloat16 merged body
against JAX's ``_wow_body_merged`` in interpret mode, serving against its
cube-bearing twin, and the route's geometry and launch counts against the
JAX plan.  Its kernels alone: tests/test_torch_bf16.py.

Tolerances: carries bitwise; whitened planes, ``acc`` and the
reconstruction within ``2^-8·max|ref|`` (one bfloat16 unit in the last
place at the largest value), the planes at the reconstruction's scale.
The JAX kernels in interpret mode are themselves up to about one float32
unit off the plain float32 chain (XLA's CPU arithmetic), which flips the
bfloat16 rounding of a few values: measured, a white differs by one
bfloat16 unit at most at 0.4% of its pixels, and most planes are
bitwise."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_close_scaled, to_np
from wavelets_tpu.ops import pallas_conv, pallas_deep
from wavelets_tpu.ops.filters import B3SPLINE as JB3
from wavelets_tpu.ops.filters import TRIANGLE as JTRI
from wavelets_tpu_torch.ops import _build, hopper_deep
from wavelets_tpu_torch.ops.filters import B3SPLINE, TRIANGLE

JW = importlib.import_module("wavelets_tpu.models.wow")
TW = importlib.import_module("wavelets_tpu_torch.models.wow")

RTOL = 2 ** -8


def _pair(shape, seed, mean=10.0):
    """The same bfloat16 input for both packages."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    j = jnp.asarray(x * 3 + mean).astype(jnp.bfloat16)
    return j, torch.from_numpy(to_np(j)).to(torch.bfloat16)


def _carry_bitwise(got, ref):
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(got), to_np(ref))


# ---------------------------------------------------------------------
# (b) the bfloat16 merged body against JAX's
# ---------------------------------------------------------------------

MERGED = {
    "512-L6": ((512, 512), (0.0,) * 7),
    "512-L6-denoise": ((512, 512), (5.0, 2.0) + (0.0,) * 5),
    "256-L6": ((256, 256), (0.0,) * 7),
}


@pytest.fixture(scope="module")
def merged_jax():
    """JAX's bfloat16 merged body (interpret mode), once a case: about
    10 s each."""
    out = {}
    for name, (shape, den) in MERGED.items():
        j, t = _pair(shape, len(name))
        out[name] = (t, JW._wow_body_merged(
            j, jnp.asarray(1.0, jnp.bfloat16), True, JB3, 6, (1.0,) * 7,
            den, True, need_planes=True, planes_layout="rows"))
    return out


def _statics(den, n=6):
    return dict(sf=B3SPLINE, n_scales=n, weights=(1.0,) * (n + 1),
                whitening=True, denoise_coefficients=den, bilateral=None,
                bilateral_scaling=False, soft_threshold=True,
                preserve_variance=False, gamma=3.2, gamma_min=None,
                gamma_max=None, h=0.0, has_noise=True)


@pytest.mark.parametrize("case", sorted(MERGED))
@pytest.mark.parametrize("layout", ["rows", "cube"])
def test_merged_wow_matches_jax_bf16(merged_jax, case, layout):
    # measured: the residual row bitwise; recon one bfloat16 unit (2.0 at
    # |ref| 410) at up to 3 pixels, the whites as the kernels above
    t, (r_j, rows_j) = merged_jax[case]
    den = MERGED[case][1]
    _build.reset_counters()
    r_t, planes = TW.wow_core(t, torch.tensor(1.0, dtype=torch.bfloat16),
                              planes_layout=layout, **_statics(den))
    # JAX's plan: one group of scales 0-3, the pair (4, 5)
    assert dict(_build.PLAIN_CALLS) == {"whiten_group_bf16": 1,
                                        "whiten_pair_bf16": 1}
    assert r_t.dtype == torch.bfloat16
    scale = float(np.abs(to_np(r_j)).max())
    assert_close_scaled(r_t, r_j, RTOL)
    assert len(planes) == len(rows_j) == 7
    for k in range(7):
        assert planes[k].dtype == torch.bfloat16
        assert_close_scaled(planes[k], rows_j[k], RTOL, scale)


@pytest.mark.parametrize("case", ["512-L6", "512-L6-denoise"])
def test_merged_serving_bitwise_to_its_twin(merged_jax, case):
    t = merged_jax[case][0]
    st = _statics(MERGED[case][1])
    noise = torch.tensor(1.0, dtype=torch.bfloat16)
    r_cube, _ = TW.wow_core(t, noise, **st)
    r_serve, p = TW.wow_core(t, noise, need_planes=False, **st)
    assert p is None
    np.testing.assert_array_equal(to_np(r_serve), to_np(r_cube))
    # a serving stack through wow_core (the JAX wow_core merges bfloat16
    # stacks; its wow_stack does not): each frame bitwise to the frame
    stack = torch.stack([t, t.flip(0)])
    _build.reset_counters()
    r_stack, p = TW.wow_core(stack, noise.expand(2), axes=(1, 2),
                             need_planes=False, **st)
    assert p is None
    assert dict(_build.PLAIN_CALLS) == {"whiten_group_bf16": 1,
                                        "whiten_pair_bf16": 1}
    for b in range(2):
        r_one, _ = TW.wow(stack[b], n_scales=6, noise=1.0,
                          denoise_coefficients=list(
                              st["denoise_coefficients"][:2]))
        np.testing.assert_array_equal(to_np(r_stack[b]), to_np(r_one))


# ---------------------------------------------------------------------
# (f) the route and its geometry against the JAX plan
# ---------------------------------------------------------------------

GEOMETRY = [(256, 256), (512, 512), (1024, 1024), (4096, 4096), (256, 512),
            (512, 256), (4096, 1024), (768, 1280), (2048, 4096),
            (300, 512), (512, 300), (96, 128)]


def _jax_tail(H, W, jsf, n_fast, n):
    probe = jnp.zeros((1, H, W), jnp.bfloat16)
    plan, s = [], n_fast
    while s < n:
        if (s + 1 < n and (H >> s) <= 32
                and pallas_deep.can_deep2(probe, jsf, s, None)):
            plan.append((s, s + 1))
            s += 2
        else:
            plan.append(s)
            s += 1
    return plan


@pytest.mark.parametrize("shape", GEOMETRY)
@pytest.mark.parametrize("sf", ["b3", "tri"])
def test_lowp_geometry_matches_jax(shape, sf):
    jsf, tsf = {"b3": (JB3, B3SPLINE), "tri": (JTRI, TRIANGLE)}[sf]
    H, W = shape
    x_j = jnp.zeros(shape, jnp.bfloat16)
    x_t = torch.zeros(shape, dtype=torch.bfloat16)
    ds = JW._deep_start(x_j, jsf)
    assert TW._lowp_deep_start(H, W, tsf) == ds
    for n in (2, 4, 5, 6, 8, 10):
        # JAX's bfloat16 gate: sides of 256 multiples, _can_merge_whiten
        gate = not (H % 256 or W % 256) and JW._can_merge_whiten(
            x_j, jsf, n, False, True, allow_cpu=True)
        assert TW._lowp_merges(x_t, tsf, n, False, True) == gate, n
        assert not TW._lowp_merges(x_t, tsf, n, True, True)
        if not gate:
            continue
        n_fast = min(n, ds)
        assert pallas_conv.plan_wow_prefix(H, W, n_fast, jsf.half_width,
                                           2) == ([(0, n_fast)], n_fast)
        probe = torch.zeros((1, H, W), dtype=torch.bfloat16)
        for s in range(n_fast, n):
            assert TW._lowp_can_deep(H, W, tsf, s) == pallas_deep.can_deep(
                x_j[None], jsf, s, None)
        ours = []
        s = n_fast
        while s < n:
            if (s + 1 < n and (H >> s) <= 32
                    and TW._lowp_can_pair(H, W, tsf, s)
                    and hopper_deep.can_deep2(probe, tsf, s)):
                ours.append((s, s + 1))
                s += 2
            else:
                ours.append(s)
                s += 1
        assert ours == _jax_tail(H, W, jsf, n_fast, n)


@pytest.mark.parametrize("shape,n,expect", [
    ((512, 512), 6, {"whiten_group_bf16": 1, "whiten_pair_bf16": 1}),
    ((1024, 1024), 8, {"whiten_group_bf16": 1, "whiten_step_bf16": 2,
                       "whiten_pair_bf16": 1}),
    ((256, 512), 5, {"whiten_group_bf16": 1, "whiten_step_bf16": 1}),
    ((256, 256), 3, {"whiten_group_bf16": 1}),
])
def test_bf16_dispatch_counts(shape, n, expect):
    _, t = _pair(shape, 3)
    _build.reset_counters()
    r, c = TW.wow(t, n_scales=n, denoise_coefficients=[3, 1], noise=0.5)
    # the plain versions of exactly the JAX plan's kernels, nothing else
    assert dict(_build.PLAIN_CALLS) == expect
    assert not _build.LAUNCHES
    assert r.dtype == torch.bfloat16 and len(c) == n + 1
    # the same call with fuse=False takes the plain body: no kernel's
    # plain version
    _build.reset_counters()
    TW.wow(t, n_scales=n, denoise_coefficients=[3, 1], noise=0.5,
           fuse=False)
    assert not _build.PLAIN_CALLS and not _build.LAUNCHES
