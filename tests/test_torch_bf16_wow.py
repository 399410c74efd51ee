"""bfloat16 WOW on the merged route: the port's bfloat16 merged body on a
bfloat16 frame against JAX's ``_wow_body_merged`` in float32 on the
widened frame (interpret mode), serving against its cube-bearing twin,
the route's gate against the JAX package's, and its geometry (the
float32 route's) and launch counts.  The route is bfloat16 at the
boundary and float32 inside, and departs on purpose from the JAX
package's bfloat16 arithmetic (PERF.md, section 6).
Its kernels alone: tests/test_torch_bf16.py.

Tolerances: the whitened planes and the reconstruction within
``2^-8·max|ref|`` of JAX's float32 outputs (the route rounds each once to
bfloat16, at most half a bfloat16 unit, and the JAX kernels in interpret
mode are about one float32 unit off the plain float32 chain), the planes
at the reconstruction's scale."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_close_scaled, to_np
from wavelets_tpu.ops import pallas_deep
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
    """JAX's float32 merged body on the widened bfloat16 frame (interpret
    mode), once a case: about 10 s each."""
    out = {}
    for name, (shape, den) in MERGED.items():
        j, t = _pair(shape, len(name))
        out[name] = (t, JW._wow_body_merged(
            j.astype(jnp.float32), jnp.asarray(1.0, jnp.float32), True, JB3,
            6, (1.0,) * 7, den, True, need_planes=True,
            planes_layout="rows"))
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
    # measured: at most half a bfloat16 unit off JAX's float32 outputs,
    # as rounding the port's float32 route gives (bitwise so on the CPU)
    t, (r_j, rows_j) = merged_jax[case]
    den = MERGED[case][1]
    _build.reset_counters()
    r_t, planes = TW.wow_core(t, torch.tensor(1.0, dtype=torch.bfloat16),
                              planes_layout=layout, **_statics(den))
    # one group of scales 0-3, the pair (4, 5)
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
    # at 512x4096 L8 kernel E's float32 tori cannot hold (4, 5): the route
    # takes one step at 4, the pair (5, 6) and a step at 7, as float32
    # does.  Reference: JAX's float32 _wow_body_merged on the widened
    # frame in interpret mode (about 17 s).
    j, t = _pair((512, 4096), 11, mean=0.0)
    r_j, rows_j = JW._wow_body_merged(
        j.astype(jnp.float32), jnp.asarray(1.0, jnp.float32), True, JB3, 8,
        (1.0,) * 9, (0.0,) * 9, True, need_planes=True,
        planes_layout="rows")
    _build.reset_counters()
    r_t, planes = TW.wow_core(t, torch.tensor(1.0, dtype=torch.bfloat16),
                              planes_layout="rows",
                              **_statics((0.0,) * 9, n=8))
    assert dict(_build.PLAIN_CALLS) == {"whiten_group_bf16": 1,
                                        "whiten_step_bf16": 2,
                                        "whiten_pair_bf16": 1}
    scale = float(np.abs(to_np(r_j)).max())
    assert_close_scaled(r_t, r_j, RTOL)
    for k in range(9):
        assert_close_scaled(planes[k], rows_j[k], RTOL, scale)


def test_split_pair_bitwise_to_the_pair_plain():
    # a pair as two steps of kernel A's plain version from a float32
    # carry, bfloat16 whites, the middle carry float32, bitwise the pair's
    # plain version: which kernel takes a scale changes no white, so the
    # route's geometry is free
    _, t = _pair((2, 256, 384), 5, mean=0.0)
    t = t.float()
    acc = torch.randn((2, 256, 384)).to(torch.bfloat16).float()
    thr = torch.tensor([[0.4, 0.6], [0.0, 0.3]])
    bf = torch.bfloat16
    for s, masked in ((4, (True, False)), (5, (False, True))):
        a1, a2 = acc.clone(), acc.clone()
        _build.reset_counters()
        w1, _, mid = hopper_deep.deep_whiten_step_plain(
            t, a1, thr[0], sf=B3SPLINE, scale=s, weight=1.25,
            masked=masked[0], white_dtype=bf)
        w2, _, c = hopper_deep.deep_whiten_step_plain(
            mid, a1, thr[1], sf=B3SPLINE, scale=s + 1, weight=0.75,
            masked=masked[1], white_dtype=bf)
        assert dict(_build.PLAIN_CALLS) == {"whiten_step_bf16": 2}
        ref = hopper_deep.deep_whiten_step2_plain(
            t, a2, thr, sf=B3SPLINE, scale=s, weights=(1.25, 0.75),
            masked=masked, white_dtype=bf)
        assert w1.dtype == w2.dtype == bf and mid.dtype == torch.float32
        for g, r in zip((w1, w2, a1, c), ref):
            np.testing.assert_array_equal(to_np(g), to_np(r))


@pytest.mark.parametrize("side", [256, 512])
def test_bf16_route_within_rounding_of_the_benchmark_reference(side):
    # the deployment of the benchmark's cell aia_wow_bf16.frame at a size
    # the CPU holds: its own frames of hundreds of counts, its known
    # noise; every array within bfloat16 rounding of the plain float32
    # reference on the same frame (the cell's limits, 4e-3 and 1e-2; the
    # JAX package's bfloat16 rounding read 0.11 and 0.45 here)
    import json
    from pathlib import Path

    from benchmark import frames
    from benchmark.harness import compare
    from benchmark.reference import wow as ref
    root = Path(__file__).resolve().parents[1]
    cfg = json.loads((root / "benchmark" / "configs" /
                      "aia_wow_bf16.json").read_text())
    cfg = dict(cfg, height=side, width=side)
    x = frames.make_frames(cfg, 1, 12345, "cpu")[0]
    assert x.dtype == torch.bfloat16
    kw = ref.options(cfg)
    _build.reset_counters()
    r, c = TW.wow(x, **kw)
    assert set(_build.PLAIN_CALLS) <= {"whiten_group_bf16",
                                       "whiten_step_bf16", "whiten_pair_bf16"}
    r_ref, planes_ref = ref.wow(x, keep_planes=True, **kw)
    assert len(c) == len(planes_ref)
    for got, want in zip([r, *c], [r_ref, *planes_ref]):
        assert got.dtype == torch.bfloat16
        n = compare(got, want)
        assert n["rel_l2"] <= 4e-3 and n["max_err"] <= 1e-2, n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scalar_noise_is_the_float32_tensor_noise(dtype):
    # a known scalar noise enters as float32 (a fill on the card, no
    # copy): bitwise a 0-d float32 tensor's outputs, on float32 and
    # bfloat16 frames alike, and not rounded to a bfloat16 frame's type
    _, t = _pair((256, 256), 13, mean=300.0)
    t = t.to(dtype)
    kw = dict(n_scales=5, denoise_coefficients=[5, 2])
    r_s, c_s = TW.wow(t, noise=6.437, **kw)
    for noise in (torch.tensor(6.437, dtype=torch.float32),
                  np.float64(6.437)):
        r_t, c_t = TW.wow(t, noise=noise, **kw)
        assert torch.equal(r_s, r_t)
        assert all(torch.equal(a, b) for a, b in zip(c_s, c_t))
    if dtype == torch.bfloat16:
        # 6.437 is 6.4375 in bfloat16: another noise, other whites
        _, c_b = TW.wow(t, noise=float(torch.tensor(6.437).to(dtype)), **kw)
        assert not all(torch.equal(a, b) for a, b in zip(c_s, c_b))


@pytest.mark.parametrize("g,offset", [(1, 7), (2, 5)])
def test_bf16_group_without_tile_runs_plain(g, offset):
    # a group whose rings kernel A's streamed group cannot hold runs one
    # deep step a scale on the widened frame (here their plain versions),
    # bitwise the plain group body, in bfloat16 as in float32: the route
    # is float32 inside, its whites round on store wherever they are made
    _, t = _pair((256, 512), 7, mean=0.0)
    thr = torch.tensor([0.5, 0.3][:g])
    args = ((1.0, 0.5)[:g], thr, g, B3SPLINE)
    kw = dict(offset=offset, masked=(True,) * g)
    assert hopper_conv.group_plan(1, 256, 512, g, 2, offset, 2) is None
    _build.reset_counters()
    rows, acc = hopper_conv.fused_wow_group(t, *args, **kw)
    assert dict(_build.PLAIN_CALLS) == {"whiten_step_bf16": g}
    r_rows, r_acc = hopper_conv.fused_wow_group_plain(t, *args, **kw)
    for a, r in zip(rows + (acc,), r_rows + (r_acc,)):
        assert a.dtype == r.dtype
        np.testing.assert_array_equal(to_np(a), to_np(r))
    assert rows[0].dtype == torch.bfloat16
    assert rows[-1].dtype == acc.dtype == torch.float32
    _build.reset_counters()
    hopper_conv.fused_wow_group(t.float(), *args, **kw)
    assert dict(_build.PLAIN_CALLS) == {"whiten_step": g}


def test_bf16_wide_route_runs_one_group():
    # 256x25600 L8, where the JAX stream refuses every scale and the JAX
    # plan cuts the scales into four groups: the route's one group of
    # scales 0-3, steps at 4 and 5 and the pair (6, 7), here each on its
    # plain version
    _, t = _pair((256, 25600), 9, mean=0.0)
    _build.reset_counters()
    r, _ = TW.wow_core(t, torch.tensor(1.0, dtype=torch.bfloat16),
                       need_planes=False, **_statics((0.0,) * 9, n=8))
    assert dict(_build.PLAIN_CALLS) == {"whiten_group_bf16": 1,
                                        "whiten_step_bf16": 2,
                                        "whiten_pair_bf16": 1}
    assert r.dtype == torch.bfloat16 and bool(torch.isfinite(r).all())


# ---------------------------------------------------------------------
# (f) the route's gate against the JAX package's, and its geometry
# ---------------------------------------------------------------------

GEOMETRY = [(256, 256), (512, 512), (1024, 1024), (4096, 4096), (256, 512),
            (512, 256), (4096, 1024), (768, 1280), (2048, 4096),
            (300, 512), (512, 300), (96, 128),
            # wide frames, where the JAX stream's budget and kernel E's
            # shared memory refuse
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


def _route_tail(monkeypatch, H, W, tsf, start, n, white_dtype):
    """The scales ``_deep_tail_scales`` takes from ``start`` on an ``(H,
    W)`` float32 carry (shapes only), recorded from its calls of kernel
    A's deep step (a scale) and of kernel E (a pair)."""
    taken = []

    def step(carry, acc, thr, *, scale, **kw):
        taken.append(scale)
        return None, None, carry

    def pair(carry, acc, thr, *, scale, **kw):
        taken.append((scale, scale + 1))
        return None, None, None, carry

    monkeypatch.setattr(hopper_deep, "deep_whiten_step", step)
    monkeypatch.setattr(hopper_deep, "deep_whiten_step2", pair)
    carry = torch.empty((H, W), dtype=torch.float32, device="meta")
    TW._deep_tail_scales(
        carry, torch.empty_like(carry), lambda s: torch.zeros(()), tsf,
        start, n, (1.0,) * (n + 1), (0.0,) * (n + 1), True, True,
        write_planes=False, white_dtype=white_dtype)
    return taken


@pytest.mark.parametrize("shape", GEOMETRY)
@pytest.mark.parametrize("sf", ["b3", "tri"])
def test_lowp_geometry_matches_jax(monkeypatch, shape, sf):
    # the gate is JAX's; the tail is the float32 route's on the same shape
    jsf, tsf = {"b3": (JB3, B3SPLINE), "tri": (JTRI, TRIANGLE)}[sf]
    H, W = shape
    x_j = _Shape(shape)
    x_t = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    ds = JW._deep_start(x_j, jsf)
    assert lowp_route.lowp_deep_start(H, W, tsf) == ds
    for n in (2, 4, 5, 6, 8, 10):
        # JAX's bfloat16 gate: sides of 256 multiples, _can_merge_whiten
        gate = not (H % 256 or W % 256) and JW._can_merge_whiten(
            x_j, jsf, n, False, True, allow_cpu=True)
        assert TW._lowp_merges(x_t, tsf, n, False, True) == gate, n
        assert not TW._lowp_merges(x_t, tsf, n, True, True)
        if not gate:
            continue
        for s in range(min(n, ds), n):
            assert lowp_route.lowp_can_deep(H, W, tsf, s) == \
                pallas_deep.can_deep(x_j[None], jsf, s, None)
        start = min(n, hopper_conv.N_STREAM)
        assert _route_tail(monkeypatch, H, W, tsf, start, n,
                           torch.bfloat16) == \
            _route_tail(monkeypatch, H, W, tsf, start, n, None)


@pytest.mark.parametrize("shape,n,tail", [
    # the wide frames, where kernel E's tori do not fit at the first scale
    # the pair rule admits: a step there, the pair one scale later
    ((512, 4096), 8, [4, (5, 6), 7]),
    ((1024, 4096), 8, [4, 5, (6, 7)]),
    ((1024, 8192), 8, [4, 5, (6, 7)]),
    ((2048, 8192), 8, [4, 5, 6, 7]),
    ((2048, 8192), 10, [4, 5, 6, (7, 8), 9]),
    ((1024, 14080), 8, [4, 5, (6, 7)]),
    ((4096, 16384), 10, [4, 5, 6, 7, (8, 9)]),
    ((8192, 16384), 10, [4, 5, 6, 7, (8, 9)]),
    ((256, 25600), 8, [4, 5, (6, 7)]),
    # the cell aia_wow_bf16.frame
    ((4096, 4096), 10, [4, 5, 6, (7, 8), 9]),
])
def test_c1_route_pinned(monkeypatch, shape, n, tail):
    H, W = shape
    assert TW._lowp_merges(
        torch.empty(shape, dtype=torch.bfloat16, device="meta"), B3SPLINE,
        n, False, True)
    assert _route_tail(monkeypatch, H, W, B3SPLINE, hopper_conv.N_STREAM,
                       n, torch.bfloat16) == tail


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
    # the plain versions of exactly the route's kernels, nothing else
    assert dict(_build.PLAIN_CALLS) == expect
    assert not _build.LAUNCHES
    assert r.dtype == torch.bfloat16 and len(c) == n + 1
    # the same call with fuse=False takes the plain body: no kernel's
    # plain version
    _build.reset_counters()
    TW.wow(t, n_scales=n, denoise_coefficients=[3, 1], noise=0.5,
           fuse=False)
    assert not _build.PLAIN_CALLS and not _build.LAUNCHES
