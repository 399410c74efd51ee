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
from wavelets_tpu_torch.models import lowp_route
from wavelets_tpu_torch.ops import _build, hopper_conv, hopper_deep
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


def test_merged_wow_matches_jax_bf16_wide():
    # ROADMAP C1: at 512x4096 L8 the JAX plan pairs (4, 5), whose float32
    # tori kernel E cannot hold; the port ran 4, (5, 6), 7 and missed the
    # recon by 0.0112*max.  Now the split pair keeps the JAX rounding.
    # Reference: JAX's _wow_body_merged in interpret mode (about 17 s).
    j, t = _pair((512, 4096), 11, mean=0.0)
    r_j, rows_j = JW._wow_body_merged(
        j, jnp.asarray(1.0, jnp.bfloat16), True, JB3, 8, (1.0,) * 9,
        (0.0,) * 9, True, need_planes=True, planes_layout="rows")
    _build.reset_counters()
    r_t, planes = TW.wow_core(t, torch.tensor(1.0, dtype=torch.bfloat16),
                              planes_layout="rows",
                              **_statics((0.0,) * 9, n=8))
    assert dict(_build.PLAIN_CALLS) == {"whiten_group_bf16": 1,
                                        "whiten_step_bf16": 4}
    scale = float(np.abs(to_np(r_j)).max())
    assert_close_scaled(r_t, r_j, RTOL)
    for k in range(9):
        assert_close_scaled(planes[k], rows_j[k], RTOL, scale)


def test_split_pair_bitwise_to_the_pair_plain():
    # the float32-carry pair: two bfloat16 steps of kernel A's plain
    # version, the middle carry float32, bitwise the pair's plain version
    _, t = _pair((2, 256, 384), 5, mean=0.0)
    acc = torch.randn((2, 256, 384)).to(torch.bfloat16)
    thr = torch.tensor([[0.4, 0.6], [0.0, 0.3]])
    for s, masked in ((4, (True, False)), (5, (False, True))):
        kw = dict(sf=B3SPLINE, scale=s, weights=(1.25, 0.75),
                  masked=masked)
        a1, a2 = acc.clone(), acc.clone()
        _build.reset_counters()
        got = hopper_deep.deep_whiten_step2_split(t, a1, thr, **kw)
        assert dict(_build.PLAIN_CALLS) == {"whiten_step_bf16": 2}
        ref = hopper_deep.deep_whiten_step2_plain(t, a2, thr, **kw)
        for g, r in zip(got, ref):
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(to_np(g), to_np(r))


def test_bf16_group_without_tile_runs_plain():
    # the documented dispatch rule: a bfloat16 group that kernel A's tile
    # cannot hold runs the plain group body, never deep steps (which
    # round elsewhere); float32 keeps its deep steps (bitwise there)
    _, t = _pair((256, 512), 7, mean=0.0)
    thr = torch.tensor([0.5])
    assert hopper_conv.group_plan(1, 256, 512, 1, 2, 7, 2) is None
    _build.reset_counters()
    rows, acc = hopper_conv.fused_wow_group(t, (1.0,), thr, 1, B3SPLINE,
                                           offset=7, masked=(True,))
    assert dict(_build.PLAIN_CALLS) == {"whiten_group_bf16": 1}
    r_rows, r_acc = hopper_conv.fused_wow_group_plain(
        t, (1.0,), thr, 1, B3SPLINE, offset=7, masked=(True,))
    for g, r in zip(rows + (acc,), r_rows + (r_acc,)):
        np.testing.assert_array_equal(to_np(g), to_np(r))
    _build.reset_counters()
    hopper_conv.fused_wow_group(t.float(), (1.0,), thr, 1, B3SPLINE,
                                offset=7, masked=(True,))
    assert dict(_build.PLAIN_CALLS) == {"whiten_step": 1}


def test_bf16_wide_route_runs_the_jax_groups():
    # 256x25600 L8: the JAX stream refuses every scale, so JAX merges the
    # groups (0,4), (4,1), (5,2), (7,1); the port runs them, the deep
    # groups on the plain group body (no deep step, no pair)
    _, t = _pair((256, 25600), 9, mean=0.0)
    _build.reset_counters()
    r, _ = TW.wow_core(t, torch.tensor(1.0, dtype=torch.bfloat16),
                       need_planes=False, **_statics((0.0,) * 9, n=8))
    assert dict(_build.PLAIN_CALLS) == {"whiten_group_bf16": 4}
    assert r.dtype == torch.bfloat16 and bool(torch.isfinite(r).all())


# ---------------------------------------------------------------------
# (f) the route and its geometry against the JAX plan
# ---------------------------------------------------------------------

GEOMETRY = [(256, 256), (512, 512), (1024, 1024), (4096, 4096), (256, 512),
            (512, 256), (4096, 1024), (768, 1280), (2048, 4096),
            (300, 512), (512, 300), (96, 128),
            # ROADMAP C1: wide frames, where the JAX stream's and pair
            # stream's budgets and kernel E's shared memory refuse
            (512, 4096), (1024, 4096), (1024, 8192), (2048, 8192),
            (1024, 14080), (4096, 16384), (8192, 16384), (256, 25600)]


class _Shape:
    """A bfloat16 array's shape alone: the JAX gates read no values, and
    the widest frames here would take 268 MB each as arrays."""

    dtype = jnp.dtype(jnp.bfloat16)

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(self.shape)

    def __getitem__(self, key):
        assert key is None
        return _Shape((1,) + self.shape)


def _jax_tail(H, W, jsf, n_fast, n):
    probe = _Shape((1, H, W))
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


def _port_tail(H, W, tsf, n_fast, n):
    """The scales of the port's bfloat16 ``_deep_tail_scales`` and the
    route of each pair: kernel E where its tori fit, else the split pair
    (two steps of kernel A with a float32 middle carry)."""
    probe = torch.empty((1, H, W), dtype=torch.bfloat16, device="meta")
    plan, routes, s = [], [], n_fast
    while s < n:
        if (s + 1 < n and (H >> s) <= 32
                and TW._lowp_can_pair(H, W, tsf, s)):
            plan.append((s, s + 1))
            routes.append("pair" if hopper_deep.can_deep2(probe, tsf, s)
                          else "split")
            s += 2
        else:
            plan.append(s)
            s += 1
    return plan, routes


@pytest.mark.parametrize("shape", GEOMETRY)
@pytest.mark.parametrize("sf", ["b3", "tri"])
def test_lowp_geometry_matches_jax(shape, sf):
    jsf, tsf = {"b3": (JB3, B3SPLINE), "tri": (JTRI, TRIANGLE)}[sf]
    H, W = shape
    x_j = _Shape(shape)
    x_t = torch.empty(shape, dtype=torch.bfloat16, device="meta")
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
        # the JAX plan's groups below the deep start, where the recon rounds
        assert lowp_route.lowp_groups(H, W, n_fast, tsf.half_width) == \
            pallas_conv.plan_wow_prefix(H, W, n_fast, jsf.half_width, 2)
        for s in range(n_fast, n):
            assert TW._lowp_can_deep(H, W, tsf, s) == pallas_deep.can_deep(
                x_j[None], jsf, s, None)
        assert _port_tail(H, W, tsf, n_fast, n)[0] == \
            _jax_tail(H, W, jsf, n_fast, n)


@pytest.mark.parametrize("shape,n,tail,routes,groups", [
    # ROADMAP C1's table: the JAX tail, and where kernel E's tori do not
    # fit, the split pair
    ((512, 4096), 8, [(4, 5), 6, 7], ["split"], [(0, 4)]),
    ((1024, 4096), 8, [4, (5, 6), 7], ["split"], [(0, 4)]),
    ((1024, 8192), 8, [4, (5, 6), 7], ["split"], [(0, 4)]),
    ((2048, 8192), 8, [4, 5, (6, 7)], ["split"], [(0, 4)]),
    ((2048, 8192), 10, [4, 5, (6, 7), 8, 9], ["split"], [(0, 4)]),
    ((1024, 14080), 8, [4, 5, 6, 7], [], [(0, 4)]),
    ((4096, 16384), 10, [4, 5, 6, 7, 8, 9], [], [(0, 4)]),
    ((8192, 16384), 10, [4, 5, 6, 7, 8, 9], [], [(0, 4)]),
    ((256, 25600), 8, [], [], [(0, 4), (4, 1), (5, 2), (7, 1)]),
])
def test_c1_route_pinned(shape, n, tail, routes, groups):
    H, W = shape
    n_fast = min(n, TW._lowp_deep_start(H, W, B3SPLINE))
    assert lowp_route.lowp_groups(H, W, n_fast, 2) == (groups, n_fast)
    assert _port_tail(H, W, B3SPLINE, n_fast, n) == (tail, routes)


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
