"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at small shapes.  Marked ``cuda``: without a CUDA device every
test skips (decided in the fixture, not at import).  On a GPU machine,
which has no JAX: ``python -m pytest tests/test_torch_cuda.py -q
--noconftest`` (tests/conftest.py sets up JAX).

Tolerances (as chip_smoke.py): the carry (``c_next``) within 1 unit in
the last place of its magnitude (the folds are rounded step by step in
both versions, so bitwise is expected); kernel C's details and carry and
kernel E's carry bitwise; whitened planes, ``acc``, the gamma sum and the
reconstruction within ``5e-6·max(|ref|, 1)`` (``erff`` against
``torch.erf``); kernel B bitwise; kernels F and G (the bilateral chain,
rounded step by step in both versions) within ``5e-6·max(|ref|, 1)``
(``expf`` against ``torch.exp``), and kernels F and G bitwise to the same
scales run through kernel G's earlier five per-pixel launches, the
check-only ``deep_bilateral_whiten_step_ref`` (``expf`` and ``erff`` on
both sides)."""

import collections
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from tests.torch_parity import assert_close_scaled, to_np
from wavelets_tpu_torch import tracing, wow, wow_stack
from wavelets_tpu_torch.ops import (_build, hopper_bilateral, hopper_conv,
                                    hopper_deep, hopper_stats, hopper_wow)
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


@pytest.mark.parametrize("shape", [(80, 72), (37, 70), (2, 130, 70),
                                   (16, 16), (3, 64, 64)])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("sf", [B3SPLINE, TRIANGLE], ids=["b3", "tri"])
@pytest.mark.parametrize("need_cube", [True, False])
def test_group_tile_kernel_vs_plain(dev, shape, offset, sf, need_cube):
    # ragged tile edges, W not a multiple of 4 (no 16-byte fill), a frame
    # smaller than the halo, frame stacks; one launch, carry bitwise
    x = torch.from_numpy(np.random.default_rng(offset).normal(size=shape)
                         .astype(np.float32) * 3 + 10).to(dev)
    B = shape[0] if len(shape) == 3 else 1
    thr = torch.tensor([[0.3] * B, [0.0] * B, [0.01] * B], device=dev)
    args = ([2.0, 1.0, 0.5], thr, 3, sf)
    kw = dict(offset=offset, soft=True, masked=(True, True, False),
              need_cube=need_cube)
    _build.reset_counters()
    rows_k, acc_k = hopper_conv.fused_wow_group(x, *args, **kw)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"whiten_group": 1}
    rows_p, acc_p = hopper_conv.fused_wow_group_plain(x, *args, **kw)
    assert len(rows_k) == len(rows_p) == (4 if need_cube else 1)
    for a, b in zip(rows_k[:-1], rows_p[:-1]):
        assert_close_scaled(a, b, 5e-6)
    assert torch.equal(rows_k[-1], rows_p[-1])
    assert_close_scaled(acc_k, acc_p, 5e-6)


def test_group_without_a_tile_launches_deep_steps(dev):
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(1, 64, 96))
                         .astype(np.float32)).to(dev)
    args = ([1.0, 1.0, 1.0], torch.tensor([0.2, 0.0, 0.1], device=dev), 3,
            B3SPLINE)
    _build.reset_counters()
    rows_k, acc_k = hopper_conv.fused_wow_group(x, *args, offset=2)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"whiten_step": 3}
    rows_p, acc_p = hopper_conv.fused_wow_group_plain(x, *args, offset=2)
    assert torch.equal(rows_k[-1], rows_p[-1])
    assert_close_scaled(acc_k, acc_p, 5e-6)


@pytest.mark.parametrize("shape", [(1, 37, 70), (2, 257, 96)])
@pytest.mark.parametrize("s", list(range(10)))
def test_deep_step_every_dilation_bitwise(dev, shape, s):
    # D up to 512 on 37 x 70: the taps reflect many times
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 3
                         + 10).to(dev)
    recon = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    recon = recon.to(dev)
    thr = torch.tensor([0.5] * shape[0], device=dev)
    kw = dict(sf=B3SPLINE, scale=s, weight=1.5, soft=True, masked=True)
    r_k, r_p = recon.clone(), recon.clone()
    w_k, _, c_k = hopper_deep.deep_whiten_step(x, r_k, thr, **kw)
    w_p, _, c_p = hopper_deep.deep_whiten_step_plain(x, r_p, thr, **kw)
    torch.cuda.synchronize()
    assert torch.equal(c_k, c_p)
    assert_close_scaled(w_k, w_p, 5e-6)
    assert_close_scaled(r_k, r_p, 5e-6)


@pytest.mark.parametrize("shape,s", [((1, 3, 30000), 0), ((1, 5, 29057), 3),
                                     ((2, 4, 33001), 6)])
def test_deep_step_row_segments(dev, shape, s):
    # rows too long for shared memory: segments with an hw*D halo
    assert hopper_conv.step_plan(*shape, 1 << s, 2).seg > 0
    x = torch.from_numpy(np.random.default_rng(s).normal(size=shape)
                         .astype(np.float32)).to(dev)
    thr = torch.zeros(shape[0], device=dev)
    kw = dict(sf=B3SPLINE, scale=s, weight=1.0)
    w_k, _, c_k = hopper_deep.deep_whiten_step(x, None, thr, **kw)
    w_p, _, c_p = hopper_deep.deep_whiten_step_plain(x, None, thr, **kw)
    torch.cuda.synchronize()
    assert torch.equal(c_k, c_p)
    assert_close_scaled(w_k, w_p, 5e-6)


@pytest.mark.parametrize("shape,s", [((1, 256, 256), 4), ((1, 512, 512), 7),
                                     ((2, 64, 128), 3), ((1, 1024, 512), 6),
                                     ((1, 16, 32), 4)])
def test_pair_cluster_bitwise_to_two_steps(dev, shape, s):
    # a cluster of 8 blocks (D = 16, 64, 128) and one narrowed to 4 (D = 8);
    # at 16 x 32, s = 4, the torus is 2 x 4, shorter than the taps' reach,
    # and the wrap takes its remainder form
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 3 + 10)
    x = x.to(dev)
    recon = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    recon = recon.to(dev)
    B = shape[0]
    thr = torch.tensor([[0.2] * B, [0.05] * B], device=dev)
    plan = hopper_deep.pair_plan(*shape, s)
    assert plan.cluster == min(8, (1 << s) // 2)
    r_k, r_a = recon.clone(), recon.clone()
    w1, w2, _, c_k = hopper_deep.deep_whiten_step2(
        x, r_k, thr, sf=B3SPLINE, scale=s, weights=(1.5, 0.5),
        masked=(True, True))
    a1, _, mid = hopper_deep.deep_whiten_step(
        x, r_a, thr[0], sf=B3SPLINE, scale=s, weight=1.5, masked=True)
    a2, _, c_a = hopper_deep.deep_whiten_step(
        mid, r_a, thr[1], sf=B3SPLINE, scale=s + 1, weight=0.5, masked=True)
    torch.cuda.synchronize()
    assert torch.equal(c_k, c_a) and torch.equal(w1, a1)
    assert torch.equal(w2, a2) and torch.equal(r_k, r_a)


def _replan(monkeypatch, module, name, **change):
    plan = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a: dataclasses.replace(
        plan(*a), **change))


def _tensors(out):
    for t in out:
        if isinstance(t, tuple):
            yield from t
        elif t is not None:
            yield t


@pytest.mark.parametrize("variant", ["tile 64 rows", "cluster 1",
                                     "cluster 2"])
def test_plan_variants_run_and_keep_the_bits(dev, monkeypatch, variant):
    # the kernels launch the wrapper's plan as given: another legal plan
    # (a 64-row tile, a narrower cluster) gives the same bits
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 128, 128))
                         .astype(np.float32) * 3 + 10).to(dev)
    thr = torch.tensor([[0.2], [0.05], [0.1]], device=dev)
    if variant.startswith("tile"):
        p = hopper_conv.group_plan(1, 128, 128, 3, 2, 0)
        change = dict(tile_h=64, grid=(p.grid[0], 2, 1),
                      smem_bytes=hopper_conv._group_smem(64, p.halo,
                                                         p.halo_cols))
        module, name = hopper_conv, "group_plan"

        def run():
            return hopper_conv.fused_wow_group(
                x, [1.5, 0.5, 1.0], thr, 3, B3SPLINE,
                masked=(True, True, False))
    else:
        change = dict(cluster=int(variant.split()[1]))
        module, name = hopper_deep, "pair_plan"

        def run():
            return hopper_deep.deep_whiten_step2(
                x, None, thr[:2], sf=B3SPLINE, scale=4, weights=(1.5, 0.5),
                masked=(True, False))
    want = list(_tensors(run()))
    _replan(monkeypatch, module, name, **change)
    got = list(_tensors(run()))
    torch.cuda.synchronize()
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("kernel,change", [
    ("group", dict(grid=(1, 4, 1))), ("group", dict(smem_bytes=4096)),
    ("step", dict(grid=(100, 1, 1))), ("step", dict(smem_bytes=64)),
    ("pair", dict(cluster=3)), ("pair", dict(grid=(8, 4, 1))),
    ("select", dict(scratch_bytes=1024)), ("select", dict(blocks=0)),
    ("select", dict(cap=1 << 20)),
    ("bilateral", dict(smem_bytes=1024)), ("bilateral", dict(rows=0)),
    ("bilateral", dict(grid=(1, 1, 1))), ("decompose", dict(smem_bytes=64)),
    ("decompose", dict(grid=(1, 1, 1))), ("bilateral step", dict(seg=64)),
    ("bilateral step", dict(grid=(100, 1, 1))), ("plane", dict(seg=64)),
    ("plane", dict(grid=(100, 1, 1))), ("pieces", dict(smem_bytes=64)),
    ("pieces", dict(grid=(1, 1, 1))),
    ("pieces", dict(seg=1, grid=(128, 128, 1))),
    # the streamed group: shared bytes below its rings, a grid, strip or
    # band that does not cover the frame, a strip off 8 columns, a halo
    # or column margin other than the group's
    ("group bf16", dict(smem_bytes=4096)), ("group bf16", dict(grid=(1, 1, 1))),
    ("group bf16", dict(strip_w=12)), ("group bf16", dict(band_h=0)),
    ("group bf16", dict(band_h=200)), ("group bf16", dict(halo=40)),
    ("group bf16", dict(halo_cols=40)),
    # kernel E's stream: a group that is no power of two, shared bytes
    # below its rings, a chunk of none, a window past the block, a grid
    # past the items
    ("pair bf16", dict(k=3)), ("pair bf16", dict(smem_bytes=4096)),
    ("pair bf16", dict(chunk=0)), ("pair bf16", dict(run=100)),
    ("pair bf16", dict(grid=10 ** 6)), ("pair bf16", dict(threads=96))])
def test_a_plan_the_kernel_cannot_run_is_refused(dev, monkeypatch, kernel,
                                                 change):
    # the C entry checks the plan it is given and refuses it before any
    # launch
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(1, 128, 128))
                         .astype(np.float32)).to(dev)
    thr = torch.zeros((3, 1), device=dev)
    xh = x.to(torch.bfloat16)
    runs = {
        "group": (hopper_conv, "group_plan", lambda: hopper_conv
                  .fused_wow_group(x, [1.0] * 3, thr, 3, B3SPLINE)),
        "group bf16": (hopper_conv, "group_plan", lambda: hopper_conv
                       .fused_wow_group(xh, [1.0] * 3, thr, 3, B3SPLINE)),
        "step": (hopper_conv, "step_plan", lambda: hopper_deep
                 .deep_whiten_step(x, None, thr[0], sf=B3SPLINE, scale=3,
                                   weight=1.0)),
        "pair": (hopper_deep, "pair_plan", lambda: hopper_deep
                 .deep_whiten_step2(x, None, thr[:2], sf=B3SPLINE, scale=4,
                                    weights=(1.0, 1.0))),
        "pair bf16": (hopper_deep, "pair_stream_plan", lambda: hopper_deep
                      .deep_whiten_step2(x, None, thr[:2], sf=B3SPLINE,
                                         scale=4, weights=(1.0, 1.0),
                                         white_dtype=torch.bfloat16)),
        "select": (hopper_stats, "select_plan",
                   lambda: hopper_stats.median_abs(x)),
        "bilateral": (hopper_bilateral, "bilateral_plan", lambda:
                      hopper_bilateral.fused_bilateral_group(
                          x, 2, B3SPLINE, (1.0, 1.0))),
        "decompose": (hopper_conv, "step_plan", lambda: hopper_conv
                      .fused_group(x, 3, B3SPLINE)),
        "bilateral step": (hopper_deep, "step_plan", lambda: hopper_deep
                           .deep_bilateral_whiten_step(
                               x, thr[0], sf=B3SPLINE, scale=3,
                               var_factor=1.0, weight=1.0)),
        "plane": (hopper_wow, "step_plan", lambda: hopper_deep
                  .deep_whiten_plane(x, thr[0], sf=B3SPLINE, scale=3,
                                     weight=1.0)),
        # seg 1 < Dc = 4 at scale 2: the segment's halo is not contiguous
        "pieces": (hopper_wow, "pieces_plan", lambda: hopper_wow
                   .fused_whiten_pieces((x[None],) * 3, torch.ones(3),
                                        thr, B3SPLINE, 3,
                                        ((0, 0), (1, 0), (2, 0)))),
    }
    module, name, run = runs[kernel]
    _replan(monkeypatch, module, name, **change)
    _build.reset_counters()
    with pytest.raises(RuntimeError, match="CUDA error"):
        run()
    assert not _build.LAUNCHES


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
    # kernels C (one scale) and B for the lazy noise, kernel A's group for
    # scales 0-2, its deep step for 5, kernel E for the pair (3, 4):
    # 256 >> 3 = 32 rows per residue class
    assert len(c_k) == 7
    assert launches == {"decompose_group": 1, "whiten_group": 1,
                        "whiten_step": 1, "whiten_pair": 1,
                        "median_select": 1}
    assert plain == {}
    assert r_k.device.type == "cuda" and bool(torch.isfinite(r_k).all())
    scale = float(r_p.abs().max())
    assert_close_scaled(r_k, r_p, 5e-6)
    for k in range(len(c_p)):
        assert_close_scaled(c_k[k], c_p[k], 5e-6, scale)


@pytest.mark.parametrize("shape,launched", [
    ((512, 512), {"whiten_group": 1, "whiten_step": 1, "whiten_pair": 1}),
    # 8 does not divide 250: kernel E's gate refuses, two kernel A steps
    ((250, 256), {"whiten_group": 1, "whiten_step": 3}),
])
def test_wow_pair_route_on_the_card(dev, shape, launched):
    x = torch.from_numpy(np.random.default_rng(5).normal(size=shape)
                         .astype(np.float32) * 3 + 10).to(dev)
    _build.reset_counters()
    r_k, c_k = wow(x, n_scales=6, denoise_coefficients=[5, 2])
    torch.cuda.synchronize()
    # the lazy noise: kernel C's one scale, then kernel B
    assert dict(_build.LAUNCHES) == {**launched, "decompose_group": 1,
                                     "median_select": 1}
    r_p, c_p = wow(x, n_scales=6, denoise_coefficients=[5, 2], fuse=False)
    scale = float(r_p.abs().max())
    assert_close_scaled(r_k, r_p, 5e-6)
    for k in range(len(c_p)):
        assert_close_scaled(c_k[k], c_p[k], 5e-6, scale)


@pytest.mark.parametrize("side", [512, 4096])
def test_lazy_noise_on_kernel_c_is_bitwise_the_plain_w0(dev, side):
    # a lazy frame's w0 is the detail row of one kernel C launch, bit for
    # bit x − smooth(x, 0): its recon and planes are those of a call given
    # the plain w0's MAD noise as known noise, and it waits for the card
    # nowhere
    from wavelets_tpu_torch.models.wow import normalize_wow_params, wow_core
    from wavelets_tpu_torch.ops.conv import smooth
    from wavelets_tpu_torch.ops.stats import mad_noise
    x = torch.from_numpy((np.random.default_rng(side).normal(
        size=(side, side)) * 3 + 100).astype(np.float32)).to(dev)
    w0 = x - smooth(x, B3SPLINE, scale=0, axes=(-2, -1))
    assert torch.equal(hopper_conv.fused_group(x, 1, B3SPLINE)[0], w0)
    noise = mad_noise(w0, float(B3SPLINE.sigma_e(2, False)[0]))
    kw = dict(denoise_coefficients=[5, 2])
    wow(x, **kw)
    torch.cuda.synchronize()
    _build.reset_counters()
    tracing.reset()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with tracing.record():
                r_l, c_l = wow(x, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    said = [f"{w.filename}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]
    syncs = tracing.totals()["syncs"]
    tracing.reset()
    assert not syncs and not said, (syncs, said)
    assert _build.LAUNCHES["decompose_group"] == 1
    assert _build.LAUNCHES["median_select"] == 1 and not _build.PLAIN_CALLS
    n, w, d, _ = normalize_wow_params(B3SPLINE, None, [], [5, 2], None, 0,
                                      2, side)
    r_k, p_k = wow_core(
        x, noise, sf=B3SPLINE, n_scales=n, weights=w, whitening=True,
        denoise_coefficients=d, bilateral=None, bilateral_scaling=False,
        soft_threshold=True, preserve_variance=False, gamma=3.2,
        gamma_min=None, gamma_max=None, h=0.0, has_noise=True,
        planes_layout="rows")
    assert torch.equal(r_l, r_k)
    assert len(c_l) == len(p_k) == n + 1
    for k in range(n + 1):
        assert torch.equal(c_l[k], p_k[k]), k


@pytest.mark.parametrize("dtype,fuse", [(torch.float32, False),
                                        (torch.bfloat16, True),
                                        (torch.float16, True)])
def test_lazy_frame_on_a_plain_route_launches_nothing(dev, dtype, fuse):
    # fuse=False and the bfloat16 and float16 plain routes keep the plain
    # smooth for the lazy noise's w0
    x = torch.from_numpy((np.random.default_rng(4).normal(size=(256, 256))
                          * 3 + 10).astype(np.float32)).to(dev).to(dtype)
    _build.reset_counters()
    r, _ = wow(x, denoise_coefficients=[5, 2], fuse=fuse)
    torch.cuda.synchronize()
    assert not _build.LAUNCHES
    assert r.dtype == dtype and bool(torch.isfinite(r).all())


@pytest.mark.parametrize("path", ["atrous", "denoise", "wow-h", "wow-pv",
                                  "wow-coefficients"])
def test_paths_launch_only_kernels(dev, path):
    import wavelets_tpu_torch as wt
    x = np.random.default_rng(6).normal(size=(128, 192)) * 3
    if "bilateral" not in path:
        x = x + 10   # zero mean keeps the bilateral chain well conditioned
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    runs = {
        "atrous": (lambda f: wt.AtrousTransform()(x, 5).data
                   if f else wt.decompose(x, 5, wt.B3SPLINE, fuse=False),
                   {"decompose_group"}),
        "denoise": (lambda f: wt.denoise(x, [3, 2], fuse=f),
                    {"decompose_group", "median_select"}),
        "wow-h": (lambda f: wow(x, denoise_coefficients=[5, 2], h=0.5,
                                fuse=f)[0],
                  {"decompose_group", "whiten_plane", "median_select"}),
        "wow-pv": (lambda f: wow(x, preserve_variance=True, fuse=f)[0],
                   {"decompose_group", "whiten_plane"}),
        "wow-coefficients": (lambda f: wow(wt.AtrousTransform()(x, 5),
                                           fuse=f)[0],
                             {"decompose_group", "whiten_plane"}),
        "atrous-bilateral": (
            lambda f: wt.AtrousTransform(bilateral=1)(x, 5).data if f
            else wt.decompose(x, 5, wt.B3SPLINE, bilateral=(1.0,) * 6,
                              fuse=False),
            {"bilateral_group"}),
        "denoise-bilateral": (lambda f: wt.denoise(x, [3, 3, 3], bilateral=1,
                                                   fuse=f),
                              {"bilateral_group", "median_select"}),
        "wow-bilateral-coefficients": (
            lambda f: wow(wt.AtrousTransform(bilateral=1)(x, 5), fuse=f)[0],
            {"bilateral_group", "whiten_plane"}),
    }
    run, kernels = runs[path]
    _build.reset_counters()
    got = run(True)
    torch.cuda.synchronize()
    assert set(_build.LAUNCHES) == kernels and not _build.PLAIN_CALLS
    if "whiten_plane" in kernels:
        # 5 scales: one pieces launch for 0-2, one a deep plane for 3, 4
        assert _build.LAUNCHES["whiten_plane"] == 3
    assert got.is_cuda and bool(torch.isfinite(got).all())
    assert_close_scaled(got, run(False), 5e-6)


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


@pytest.mark.parametrize("shape", [(64, 96), (37, 70), (2, 40, 56),
                                   (3, 37, 70)])
@pytest.mark.parametrize("g,offset", [(1, 0), (3, 0), (3, 2), (3, 3),
                                      (2, 1)])
@pytest.mark.parametrize("smooth_only", [False, True])
def test_decompose_group_kernel_bitwise(dev, shape, g, offset, smooth_only):
    # one row-buffer launch a scale, c_next alternating between the carry
    # row and a spare plane; W = 70 is not a multiple of 4
    x = torch.from_numpy(np.random.default_rng(g).normal(size=shape)
                         .astype(np.float32)).to(dev)
    x0 = x.clone()
    _build.reset_counters()
    got = hopper_conv.fused_group(x, g, B3SPLINE, offset, smooth_only)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"decompose_group": 1}
    want = hopper_conv.fused_group_plain(x, g, B3SPLINE, offset, smooth_only)
    assert got.shape == want.shape == ((1 if smooth_only else g + 1),) + shape
    assert torch.equal(got, want)
    assert torch.equal(x, x0)


@pytest.mark.parametrize("shape,g,offset", [
    ((1, 3, 30001), 3, 0),       # row segments, contiguous halo
    ((2, 5, 40000), 3, 11),      # segments of tap windows (Dc > 4096)
    ((1, 4, 33001), 1, 14),
    ((2, 37, 70), 3, 40),        # dilations past the map's period
    ((65537, 2, 3), 2, 0),       # more frames than the grid's z
])
@pytest.mark.parametrize("smooth_only", [False, True])
def test_decompose_group_kernel_coverage(dev, shape, g, offset,
                                         smooth_only):
    x = torch.from_numpy(np.random.default_rng(offset).normal(size=shape)
                         .astype(np.float32)).to(dev)
    got = hopper_conv.fused_group(x, g, B3SPLINE, offset, smooth_only)
    want = hopper_conv.fused_group_plain(x, g, B3SPLINE, offset, smooth_only)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("per_frame", [False, True])
@pytest.mark.parametrize("write_planes,write_gamma",
                         [(True, True), (False, False), (True, False)])
def test_whiten_pieces_kernel_vs_plain(dev, per_frame, write_planes,
                                       write_gamma):
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 64, 80))
                         .astype(np.float32)).to(dev)
    pieces = (hopper_conv.fused_group_plain(x, 3, B3SPLINE),)
    fac = torch.tensor([[1.5, 0.5], [2.0, 1.0], [0.7, 0.7]], device=dev)
    fac = fac if per_frame else fac[:, 0]
    thr = torch.tensor([[0.3, 0.0], [0.0, 0.1], [0.2, 0.2]], device=dev)
    args = (pieces, fac, thr, B3SPLINE, 3, ((0, 0), (0, 1), (0, 2)))
    kw = dict(soft=True, write_planes=write_planes, write_gamma=write_gamma)
    got = hopper_wow.fused_whiten_pieces(*args, **kw)
    want = hopper_wow.fused_whiten_pieces_plain(*args, **kw)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            assert_close_scaled(a, b, 5e-6)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("mode", ["soft", "hard", "unmasked"])
def test_deep_plane_kernel_vs_plain(dev, s, mode):
    rng = np.random.default_rng(s)
    c = torch.from_numpy(rng.normal(size=(2, 64, 96)).astype(np.float32))
    c = c.to(dev)
    g_k = torch.ones_like(c)
    g_p = g_k.clone()
    kw = dict(sf=B3SPLINE, scale=s, soft=mode == "soft",
              masked=mode != "unmasked")
    thr = torch.tensor([0.5, 0.0], device=dev)
    weight = torch.tensor([1.5, 0.25], device=dev)
    w_k = hopper_deep.deep_whiten_plane(c, thr, weight=weight, gamma=g_k,
                                        **kw)
    w_p = hopper_deep.deep_whiten_plane_plain(c, thr, weight=weight,
                                              gamma=g_p, **kw)
    torch.cuda.synchronize()
    assert_close_scaled(w_k, w_p, 5e-6)
    assert_close_scaled(g_k, g_p, 5e-6)


# kernel D against its first-port design (two per-pixel launches through
# a scratch plane, the check-only reference): odd widths, a dilation past
# the frame and past the map's period, rows in segments, frames past
# 65535 (several launches)
PLANE_CASES = [((1, 64, 96), 3), ((2, 37, 70), 5), ((1, 257, 513), 8),
               ((2, 3, 30001), 13), ((1, 16, 16), 40), ((65537, 2, 3), 1)]
PIECES_CASES = [((2, 64, 80), 3), ((1, 37, 70), 2), ((3, 20, 9700), 3),
                ((1, 5, 40001), 3), ((65537, 2, 3), 3), ((1, 9, 7), 1)]


def _frames(shape, seed, mean=0.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=shape) * 3 + mean)
                            .astype(np.float32))


@pytest.mark.parametrize("case", range(len(PLANE_CASES) + len(PIECES_CASES)))
@pytest.mark.parametrize("mode", ["soft", "hard", "unmasked"])
@pytest.mark.parametrize("outputs", ["all", "some"])
def test_whiten_plane_bitwise_to_reference(dev, case, mode, outputs):
    # "all": white, recon += and gamma += (pieces: whites, recon and
    # gamma); "some": write_plane=False with recon, no gamma (pieces: no
    # whites, no gamma)
    _build.reset_counters()
    if case < len(PLANE_CASES):
        shape, s = PLANE_CASES[case]
        c = _frames(shape, s).to(dev)
        recon = _frames(shape, s + 1).to(dev)
        gamma = _frames(shape, s + 2).to(dev)
        thr = torch.full((shape[0],), 1.5, device=dev)
        fac = torch.linspace(0.5, 2.0, shape[0], device=dev)
        kw = dict(sf=B3SPLINE, scale=s, weight=fac, soft=mode == "soft",
                  masked=mode != "unmasked", write_plane=outputs == "all")
        r_k, r_r, r_p = recon.clone(), recon.clone(), recon.clone()
        g_k, g_r, g_p = ((gamma.clone(), gamma.clone(), gamma.clone())
                         if outputs == "all" else (None, None, None))
        w_k = hopper_deep.deep_whiten_plane(c, thr, recon=r_k, gamma=g_k,
                                            **kw)
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {"whiten_plane": 1}
        w_r = hopper_deep.deep_whiten_plane_ref(c, thr, recon=r_r,
                                                gamma=g_r, **kw)
        w_p = hopper_deep.deep_whiten_plane_plain(c, thr, recon=r_p,
                                                  gamma=g_p, **kw)
        torch.cuda.synchronize()
        got, want, plain = (w_k, r_k, g_k), (w_r, r_r, g_r), (w_p, r_p, g_p)
    else:
        shape, n = PIECES_CASES[case - len(PLANE_CASES)]
        B = shape[0]
        cube = _frames((n,) + shape, n).to(dev)
        rows = (cube[:1], cube[1:])       # two pieces, as decompose gives
        layout = ((0, 0),) + tuple((1, k) for k in range(n - 1))
        fac = torch.linspace(0.5, 2.0, n * B, device=dev).reshape(n, B)
        thr = torch.full((n, B), 1.5, device=dev)
        if mode == "unmasked":
            thr.zero_()
        args = (rows, fac, thr, B3SPLINE, n, layout)
        kw = dict(soft=mode != "hard", write_planes=outputs == "all",
                  write_gamma=outputs == "all")
        got = hopper_wow.fused_whiten_pieces(*args, **kw)
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {"whiten_plane": 1}
        want = hopper_wow.fused_whiten_pieces_ref(*args, **kw)
        plain = hopper_wow.fused_whiten_pieces_plain(*args, **kw)
        torch.cuda.synchronize()
    assert dict(_build.LAUNCHES)["whiten_plane_ref"] >= 1
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    for a, b in zip(got, plain):
        if b is not None:
            assert_close_scaled(a, b, 5e-6)


@pytest.mark.parametrize("kernel", ["step", "decompose", "plane", "pieces"])
def test_row_buffer_passes_at_their_whole_row_limit(dev, kernel):
    # the widest rows each plan takes whole: the row-buffer pass's
    # dynamic shared memory and its static tap-row table share the 227 KB
    # opt-in (the pieces form takes whole rows while four blocks fit an
    # SM)
    W = {"pieces": 2372}.get(kernel, 29038)
    x = _frames((1, 3, W), 11, 10.0).to(dev)
    thr = torch.full((3, 1), 0.5, device=dev)
    if kernel != "pieces":
        assert hopper_conv.step_plan(1, 3, W, 1, 2).seg == 0
        assert hopper_conv.step_plan(1, 3, W + 1, 1, 2).seg > 0
    if kernel == "step":
        got = hopper_deep.deep_whiten_step(x, None, thr[0], sf=B3SPLINE,
                                           scale=0, weight=1.0)
        want = hopper_deep.deep_whiten_step_plain(x, None, thr[0],
                                                  sf=B3SPLINE, scale=0,
                                                  weight=1.0)
    elif kernel == "decompose":
        got = (hopper_conv.fused_group(x, 1, B3SPLINE),)
        want = (hopper_conv.fused_group_plain(x, 1, B3SPLINE),)
    elif kernel == "plane":
        got = (hopper_deep.deep_whiten_plane(x, thr[0], sf=B3SPLINE,
                                             scale=0, weight=1.0),)
        want = (hopper_deep.deep_whiten_plane_ref(x, thr[0], sf=B3SPLINE,
                                                  scale=0, weight=1.0),)
    else:
        assert hopper_wow.pieces_plan(1, 3, W, 3, 2).seg == 0
        assert hopper_wow.pieces_plan(1, 3, W + 1, 3, 2).seg > 0
        args = ((x[None].expand(3, 1, 3, W).contiguous(),), torch.ones(3),
                thr, B3SPLINE, 3, ((0, 0), (0, 1), (0, 2)))
        got = hopper_wow.fused_whiten_pieces(*args, write_gamma=True)
        want = hopper_wow.fused_whiten_pieces_ref(*args, write_gamma=True)
    torch.cuda.synchronize()
    if kernel == "step":
        assert torch.equal(got[2], want[2])
        assert_close_scaled(got[0], want[0], 5e-6)
        return
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,s", [((1, 64, 96), 3), ((2, 40, 56), 2),
                                     ((1, 512, 512), 4), ((1, 16, 24), 0)])
@pytest.mark.parametrize("masked", [(True, False), (True, True),
                                    (False, False)])
@pytest.mark.parametrize("with_recon", [False, True])
def test_pair_kernel_vs_two_steps(dev, shape, s, masked, with_recon):
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 3 + 10)
    x = x.to(dev)
    recon = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    recon = recon.to(dev)
    thr = torch.tensor([[0.2] * shape[0], [0.05] * shape[0]], device=dev)
    kw = dict(sf=B3SPLINE, scale=s, weights=(1.5, 0.5), soft=True,
              masked=masked)
    assert hopper_deep.can_deep2(x, B3SPLINE, s)
    r_k = recon.clone() if with_recon else None
    r_p = recon.clone() if with_recon else None
    w1_k, w2_k, _, c_k = hopper_deep.deep_whiten_step2(x, r_k, thr, **kw)
    w1_p, w2_p, _, c_p = hopper_deep.deep_whiten_step2_plain(x, r_p, thr,
                                                             **kw)
    # two kernel A steps: the same bits, erff included
    r_a = recon.clone()
    a1, _, mid = hopper_deep.deep_whiten_step(
        x, r_a, thr[0], sf=B3SPLINE, scale=s, weight=1.5, masked=masked[0])
    a2, _, c_a = hopper_deep.deep_whiten_step(
        mid, r_a, thr[1], sf=B3SPLINE, scale=s + 1, weight=0.5,
        masked=masked[1])
    torch.cuda.synchronize()
    assert torch.equal(c_k, c_p) and torch.equal(c_k, c_a)
    assert torch.equal(w1_k, a1) and torch.equal(w2_k, a2)
    assert_close_scaled(w1_k, w1_p, 5e-6)
    assert_close_scaled(w2_k, w2_p, 5e-6)
    if with_recon:
        assert torch.equal(r_k, r_a)
        assert_close_scaled(r_k, r_p, 5e-6)


def test_pair_gate_refuses_and_the_kernel_raises(dev):
    x = torch.zeros(1, 36, 72, device=dev)
    assert not hopper_deep.can_deep2(x, B3SPLINE, 3)    # 36 % 8 != 0
    assert not hopper_deep.can_deep2(torch.zeros(1, 512, 512, device=dev),
                                     B3SPLINE, 1)       # torus too large
    with pytest.raises(ValueError, match="can_deep2"):
        hopper_deep.deep_whiten_step2(x, None, torch.zeros(2, device=dev),
                                      sf=B3SPLINE, scale=3,
                                      weights=(1.0, 1.0))


@pytest.mark.parametrize("shape", [(64, 96), (37, 70), (2, 40, 56)])
@pytest.mark.parametrize("g,offset", [(1, 0), (3, 0), (3, 2)])
@pytest.mark.parametrize("scaling", [False, True])
def test_bilateral_group_kernel_vs_plain(dev, shape, g, offset, scaling):
    x = torch.from_numpy(np.random.default_rng(g).normal(size=shape)
                         .astype(np.float32)).to(dev)
    variances = (1.0, 2.25, 0.25)[:g]
    got = hopper_bilateral.fused_bilateral_group(x, g, B3SPLINE, variances,
                                                 offset, scaling)
    want = hopper_bilateral.fused_bilateral_group_plain(
        x, g, B3SPLINE, variances, offset, scaling)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (g + 1,) + shape
    assert_close_scaled(got, want, 5e-6)


@pytest.mark.parametrize("sf", [B3SPLINE, TRIANGLE], ids=["b3", "tri"])
def test_bilateral_group_kernel_large_mean(dev, sf):
    # m2 - mean*mean cancels at a mean of 1000: any contraction into an
    # FMA would move every range weight
    x = torch.from_numpy((np.random.default_rng(7).normal(size=(48, 64))
                          + 1000).astype(np.float32)).to(dev)
    got = hopper_bilateral.fused_bilateral_group(x, 3, sf, (1.0,) * 3)
    want = hopper_bilateral.fused_bilateral_group_plain(x, 3, sf, (1.0,) * 3)
    torch.cuda.synchronize()
    assert_close_scaled(got, want, 5e-6)


@pytest.mark.parametrize("shape,s", [((1, 64, 96), 0), ((2, 40, 56), 2),
                                     ((1, 37, 70), 5)])
@pytest.mark.parametrize("mode", ["soft", "hard", "unmasked"])
@pytest.mark.parametrize("scaling", [False, True])
def test_bilateral_step_kernel_vs_plain(dev, shape, s, mode, scaling):
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    recon = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    recon = recon.to(dev)
    thr = torch.tensor([0.3, 0.0][:shape[0]], device=dev)
    kw = dict(sf=B3SPLINE, scale=s, var_factor=2.25, weight=1.5,
              soft=mode == "soft", masked=mode != "unmasked",
              bilateral_scaling=scaling)
    r_k, r_p = recon.clone(), recon.clone()
    w_k, c_k = hopper_deep.deep_bilateral_whiten_step(x, thr, recon=r_k,
                                                      **kw)
    w_p, c_p = hopper_deep.deep_bilateral_whiten_step_plain(x, thr,
                                                            recon=r_p, **kw)
    torch.cuda.synchronize()
    assert_close_scaled(c_k, c_p, 5e-6)
    assert_close_scaled(w_k, w_p, 5e-6)
    assert_close_scaled(r_k, r_p, 5e-6)


@pytest.mark.parametrize("shape,s", [
    ((1, 64, 96), 0), ((2, 40, 56), 2), ((1, 37, 70), 5), ((1, 257, 513), 8),
    ((1, 96, 1000), 9),
    ((2, 3, 30001), 13),         # second pass in segments of tap windows
    ((1, 16, 16), 40),           # a dilation past the map's period
    ((65537, 2, 3), 1),          # more frames than the grid's z
])
@pytest.mark.parametrize("mode", ["soft", "hard", "unmasked", "scaling"])
def test_bilateral_step_bitwise_to_reference(dev, shape, s, mode):
    # the ring and the row-buffer second pass against the earlier five
    # per-pixel launches: c_next, white and recon bitwise
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    recon = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    recon = recon.to(dev)
    thr = torch.full((shape[0],), 0.3, device=dev)
    kw = dict(sf=B3SPLINE, scale=s, var_factor=2.25, weight=1.5,
              soft=mode != "hard", masked=mode in ("soft", "hard"),
              bilateral_scaling=mode == "scaling")
    r_k, r_r = recon.clone(), recon.clone()
    _build.reset_counters()
    w_k, c_k = hopper_deep.deep_bilateral_whiten_step(x, thr, recon=r_k,
                                                      **kw)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"bilateral_step": 1}
    w_r, c_r = hopper_deep.deep_bilateral_whiten_step_ref(x, thr, recon=r_r,
                                                          **kw)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"bilateral_step": 1,
                                     "bilateral_step_ref": 1}
    assert torch.equal(c_k, c_r)
    assert torch.equal(w_k, w_r)
    assert torch.equal(r_k, r_r)


def test_bilateral_wow_path_vs_plain(dev):
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(512, 512))
                         .astype(np.float32) * 3).to(dev)
    kw = dict(n_scales=6, bilateral=1, denoise_coefficients=[5, 2],
              noise=1.0)
    _build.reset_counters()
    r_k, c_k = wow(x, **kw)
    torch.cuda.synchronize()
    launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
    # kernel F for scales 0-2, kernel D whitens them in one launch,
    # kernel G takes 3-5
    assert launches == {"bilateral_group": 1, "whiten_plane": 1,
                        "bilateral_step": 3}
    assert plain == {}
    r_p, c_p = wow(x, fuse=False, **kw)
    assert r_k.is_cuda and bool(torch.isfinite(r_k).all())
    scale = float(r_p.abs().max())
    assert_close_scaled(r_k, r_p, 5e-6)
    for k in range(len(c_p)):
        assert_close_scaled(c_k[k], c_p[k], 5e-6, scale)


def test_bilateral_wrappers_refuse_what_the_kernels_cannot_take(dev):
    x = torch.zeros(1, 16, 16, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        hopper_bilateral.fused_bilateral_group(x, 1, B3SPLINE, (1.0,))
    with pytest.raises(TypeError):
        hopper_deep.deep_bilateral_whiten_step(
            x, torch.zeros(1, device=dev), sf=B3SPLINE, scale=0,
            var_factor=1.0, weight=1.0)
    with pytest.raises(ValueError):
        hopper_bilateral.fused_bilateral_group(
            torch.zeros(16, 16, device=dev), 2, B3SPLINE, (1.0,))


def _select_case(kind, n, rng):
    i = np.arange(n)
    if kind == "normal":
        return rng.normal(size=n)
    if kind == "equal":
        return np.full(n, -1.75)
    if kind == "zeros":
        return np.where(rng.random(n) < 0.5, 0.0, -0.0)
    if kind == "subnormal":
        return rng.integers(-2 ** 23, 2 ** 23, n) * 2.0 ** -149
    if kind == "ties":
        return rng.choice([-2.0, 0.0, 1.0, 2.5], size=n)
    if kind == "straddle1":   # the middle pair in two first-digit bins
        return np.where(i < n // 2, 0.5, -3.0)
    if kind == "straddle2":   # ... in two second-digit bins
        return np.where(i < n // 2, 1.0, 1.0 + 2.0 ** -12)
    # ... in two last-digit bins
    return np.where(i < n // 2, 1.0,
                    float(np.nextafter(np.float32(1), np.float32(2))))


@pytest.mark.parametrize("side", [512, 4096])
@pytest.mark.parametrize("kind", ["normal", "equal", "zeros", "subnormal",
                                  "ties", "straddle1", "straddle2",
                                  "straddle3"])
@pytest.mark.parametrize("head", [0, 3])
def test_median_kernel_adversarial_bitwise(dev, side, kind, head):
    # ties past the candidate cap read the plane again; ``head`` patterns
    # before the first 16-byte boundary take the scalar head path
    n = side * side + (1 if side == 512 else 0)
    x = _select_case(kind, n + head, np.random.default_rng(side))
    x = x.astype(np.float32)
    xt = torch.from_numpy(x).to(dev)[head:]
    _build.reset_counters()
    got = hopper_stats.median_abs(xt)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"median_select": 1}
    assert to_np(got).tobytes() == np.median(np.abs(x[head:])).tobytes()


@pytest.mark.parametrize("cap", [1, None])
def test_median_kernel_either_route_keeps_the_bits(dev, monkeypatch, cap):
    # a cap of one candidate sends every digit after the first to the
    # plane; the answer is the same
    x = np.random.default_rng(4).normal(size=300001).astype(np.float32)
    if cap is not None:
        _replan(monkeypatch, hopper_stats, "select_plan", cap=cap)
    got = hopper_stats.median_abs(torch.from_numpy(x).to(dev))
    assert to_np(got).tobytes() == np.median(np.abs(x)).tobytes()


def _g_chain(x, sf, variances, offset, scaling):
    """The same bilateral scales through kernel G's earlier three-pass
    chain (wt_bilateral.cuh, the check-only reference entry): details,
    then the carry."""
    cur = x if x.ndim == 3 else x[None]
    rows = []
    for k, var in enumerate(variances):
        _, c_next = hopper_deep.deep_bilateral_whiten_step_ref(
            cur, torch.zeros(cur.shape[0], device=cur.device), sf=sf,
            scale=offset + k, var_factor=var, weight=1.0,
            bilateral_scaling=scaling)
        rows.append(cur - c_next)
        cur = c_next
    rows.append(cur)
    out = torch.stack(rows)
    return out if x.ndim == 3 else out[:, 0]


@pytest.mark.parametrize("shape", [(37, 70), (2, 257, 96), (6, 9000)])
@pytest.mark.parametrize("offset", list(range(7)))
@pytest.mark.parametrize("sf", [B3SPLINE, TRIANGLE], ids=["b3", "tri"])
def test_bilateral_ring_bitwise_to_kernel_g_chain(dev, shape, offset, sf):
    # every offset 0-6, odd shapes (H, W below hw·D from offset 4), a width
    # that needs row segments
    x = torch.from_numpy(np.random.default_rng(offset).normal(size=shape)
                         .astype(np.float32)).to(dev)
    variances, scaling = (2.25, 1.0, 0.25), offset % 2 == 1
    _build.reset_counters()
    got = hopper_bilateral.fused_bilateral_group(x, 3, sf, variances, offset,
                                                 scaling)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"bilateral_group": 1}
    want = _g_chain(x, sf, variances, offset, scaling)
    assert torch.equal(got, want)
    assert_close_scaled(got, hopper_bilateral.fused_bilateral_group_plain(
        x, 3, sf, variances, offset, scaling), 5e-6)


def test_bilateral_ring_bitwise_at_mean_1000(dev):
    x = torch.from_numpy((np.random.default_rng(7).normal(size=(257, 513))
                          + 1000).astype(np.float32)).to(dev)
    got = hopper_bilateral.fused_bilateral_group(x, 3, B3SPLINE, (1.0,) * 3)
    assert torch.equal(got, _g_chain(x, B3SPLINE, (1.0,) * 3, 0, False))


@pytest.mark.parametrize("seg", [256, 1024])
def test_bilateral_plan_variants_keep_the_bits(dev, monkeypatch, seg):
    # narrower segments (the windows layout where D >= seg) launch the
    # same arithmetic
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(64, 2048))
                         .astype(np.float32)).to(dev)
    want = hopper_bilateral.fused_bilateral_group(x, 3, B3SPLINE, (1.0,) * 3,
                                                  6)
    plan = hopper_bilateral.bilateral_plan

    def narrower(B, H, W, D, hw):
        p = plan(B, H, W, D, hw)
        return dataclasses.replace(
            p, seg=seg, grid=(p.grid[0], -(-W // seg), B),
            smem_bytes=hopper_bilateral.ring_smem(hw, D, seg))

    monkeypatch.setattr(hopper_bilateral, "bilateral_plan", narrower)
    got = hopper_bilateral.fused_bilateral_group(x, 3, B3SPLINE, (1.0,) * 3,
                                                 6)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shift", [1, 2])
def test_bilateral_ring_off_a_16_byte_boundary(dev, shift):
    # a frame that starts off a 16-byte boundary: the ring rows' in-frame
    # columns go in 4-byte copies, the bits stay
    H, W = 64, 1024
    buf = torch.from_numpy(np.random.default_rng(shift).normal(
        size=H * W + shift).astype(np.float32)).to(dev)
    x = buf[shift:].view(H, W)
    assert x.data_ptr() % 16 != 0
    got = hopper_bilateral.fused_bilateral_group(x, 3, B3SPLINE, (1.0,) * 3)
    assert torch.equal(got, _g_chain(x.clone(), B3SPLINE, (1.0,) * 3, 0,
                                     False))


@pytest.mark.parametrize("offset", [7, 27, 30, 58])
def test_bilateral_ring_past_the_maps_period(dev, offset):
    # dilations of 2H and beyond run as their remainder mod 2H, 2W: at
    # 64 x 64 every one from 2^7 on names the same taps
    x = torch.from_numpy(np.random.default_rng(offset).normal(size=(2, 64, 64))
                         .astype(np.float32)).to(dev)
    variances = (2.25, 1.0, 0.25)
    got = hopper_bilateral.fused_bilateral_group(x, 3, B3SPLINE, variances,
                                                 offset)
    assert torch.equal(got, hopper_bilateral.fused_bilateral_group(
        x, 3, B3SPLINE, variances, 7))
    assert_close_scaled(got, hopper_bilateral.fused_bilateral_group_plain(
        x, 3, B3SPLINE, variances, offset), 5e-6)


# ---------------------------------------------------------------------
# Frame stacks: kernel D's batch-major pieces, wow_stack, process_stack
# ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 96, 1000), (2, 3, 40000),
                                   (4, 257, 513)])
@pytest.mark.parametrize("rows", [3, 7])
def test_pieces_batch_major_bitwise_to_scale_major(dev, shape, rows):
    # rows 0-2 of the (B, rows, H, W) cube, bitwise to the scale-major
    # whites permuted and to the first-port reference; rows past 2 are the
    # caller's (a sentinel stays)
    x = torch.from_numpy(np.random.default_rng(rows).normal(
        size=shape).astype(np.float32)).to(dev)
    cube = hopper_conv.fused_group(x, 3, B3SPLINE)
    B = shape[0]
    thr = torch.arange(1, B + 1, device=dev).repeat(3, 1) * 0.3
    args = ((cube[:1], cube[1:]), torch.tensor([1.0, 2.0, 0.5], device=dev),
            thr, B3SPLINE, 3, ((0, 0), (1, 0), (1, 1)))
    out = torch.full((B, rows) + shape[1:], -7.0, device=dev)
    got = hopper_wow.fused_whiten_pieces(
        *args, batch_major=True, out_rows_total=rows, out=out,
        write_gamma=True)
    sm = hopper_wow.fused_whiten_pieces(*args, write_gamma=True)
    ref = hopper_wow.fused_whiten_pieces_ref(
        *args, batch_major=True, out_rows_total=rows, write_gamma=True)
    plain = hopper_wow.fused_whiten_pieces_plain(
        *args, batch_major=True, out_rows_total=rows, write_gamma=True)
    assert got[0].data_ptr() == out.data_ptr()
    assert torch.equal(got[0][:, :3], sm[0].permute(1, 0, 2, 3))
    assert torch.equal(got[0][:, :3], ref[0][:, :3])
    assert torch.equal(got[1], sm[1]) and torch.equal(got[2], sm[2])
    assert bool((got[0][:, 3:] == -7.0).all())
    scale = float(plain[1].abs().max())
    assert_close_scaled(got[0][:, :3], plain[0][:, :3], 5e-6, scale)
    assert_close_scaled(got[1], plain[1], 5e-6)


STACK_CASES = {
    "merged": dict(noise=1.0, with_coefficients=False),
    "lazy": dict(with_coefficients=False),
    "planes": dict(noise=[0.5, 1.0], with_coefficients=True),
    "bilateral": dict(bilateral=1, with_coefficients=False),
    "h": dict(h=0.5, with_coefficients=True),
}


@pytest.mark.parametrize("case", sorted(STACK_CASES))
def test_wow_stack_kernels_vs_plain(dev, case):
    from wavelets_tpu_torch import wow_stack
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 256, 320)).astype(np.float32)).to(dev)
    kw = dict(STACK_CASES[case], n_scales=5, denoise_coefficients=[5, 2])
    _build.reset_counters()
    r_k, p_k = wow_stack(x, **kw)
    assert not _build.PLAIN_CALLS and _build.LAUNCHES
    r_p, p_p = wow_stack(x, fuse=False, **kw)
    scale = float(r_p.abs().max())
    assert_close_scaled(r_k, r_p, 5e-6)
    if kw["with_coefficients"]:
        assert p_k.shape == (2, 6, 256, 320)
        assert_close_scaled(p_k, p_p, 5e-6, scale)
    for b in range(2):
        one = {k: v for k, v in kw.items() if k != "with_coefficients"}
        if isinstance(one.get("noise"), list):
            one["noise"] = one["noise"][b]
        r1, _ = wow(x[b], **one)
        assert_close_scaled(r_k[b], r1, 5e-6)


def test_process_stack_on_the_card(dev, tmp_path):
    from wavelets_tpu_torch import process_stack, wow_stack
    from wavelets_tpu_torch.utils.frameio import write_array
    host = np.random.default_rng(2).integers(0, 4096, size=(5, 256, 256),
                                             dtype=np.uint16)
    write_array(str(tmp_path / "in.raw"), host)
    kw = dict(n_scales=5, denoise_coefficients=[5, 2])
    n, _, fps = process_stack(str(tmp_path / "in.raw"),
                              str(tmp_path / "out.raw"), 5, (256, 256),
                              batch=2, **kw)
    assert n == 5 and fps > 0
    got = np.fromfile(tmp_path / "out.raw", np.float32).reshape(5, 256, 256)
    for b0 in range(0, 5, 2):
        batch = torch.from_numpy(host[b0:b0 + 2].astype(np.float32)).to(dev)
        want = wow_stack(batch, with_coefficients=False, **kw)[0]
        assert np.array_equal(got[b0:b0 + 2], to_np(want))


def _rl_input(shape, seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x * x + 1


def _hanning(n):
    h = np.hanning(n + 2)[1:-1]
    p = np.outer(h, h)
    return (p / p.sum()).astype(np.float32)


RL_CASES = {
    "direct": dict(fft=False),
    "fft": dict(fft=True),
    "auto-hard": dict(threshold_type="hard"),
    "uniform-not-persistent": dict(uniform_init=True, persistent_mrs=False,
                                   threshold_type="hard"),
}


@pytest.mark.parametrize("case", sorted(RL_CASES))
@pytest.mark.parametrize("frames", [1, 2])
def test_richardson_lucy_kernels_vs_plain(dev, case, frames):
    # kernels C and B are bitwise to their plain versions, and nothing
    # else differs between the two runs, so the deconvolutions are too;
    # kernel C once a decomposition (3 scales: one group), kernel B once
    # a frame, or once a frame an iteration under uniform_init
    from wavelets_tpu_torch import richardson_lucy, richardson_lucy_stack
    shape = (frames, 160, 200) if frames > 1 else (160, 200)
    x = torch.from_numpy(_rl_input(shape)).to(dev)
    psf = _hanning(7 if "fft" in case or "auto" in case else 5)
    fn = richardson_lucy_stack if frames > 1 else richardson_lucy
    kw = dict(RL_CASES[case], iterations=4)
    _build.reset_counters()
    got = fn(x, psf, **kw)
    torch.cuda.synchronize()
    uniform = kw.get("uniform_init", False)
    assert dict(_build.LAUNCHES) == {
        "decompose_group": 4 if uniform else 5,
        "median_select": frames * (4 if uniform else 1)}
    assert not _build.PLAIN_CALLS
    plain = fn(x, psf, fuse=False, **kw)
    assert got.is_cuda and bool(torch.isfinite(got).all())
    assert torch.equal(got, plain)
    if frames > 1:
        # a frame of a stack keeps a single frame's bits
        for b in range(frames):
            assert torch.equal(got[b], richardson_lucy(x[b], psf, **kw))


@pytest.mark.parametrize("shape", [(160, 200), (2, 96, 80)])
@pytest.mark.parametrize("n", [3, 5, 15])
def test_conv2d_without_tf32_matches_the_shift_add(dev, shape, n):
    # cuDNN would compute a float32 convolution in TF32 (about three
    # decimal digits) unless told otherwise: the direct path's F.conv2d
    # must agree with the float32 shift-add to float32 round-off
    import importlib
    trl = importlib.import_module("wavelets_tpu_torch.models.richardson_lucy")
    x = torch.from_numpy(_rl_input(shape, seed=n)).to(dev)
    psf = torch.from_numpy(_hanning(n)).to(dev)
    got = trl._correlate2d_symmetric(x, psf)
    ref = trl._correlate2d_shift_add(x, psf)
    assert_close_scaled(got, ref, 5e-6)
    rng_psf = torch.from_numpy(np.random.default_rng(n).uniform(
        size=(n, n + 1)).astype(np.float32)).to(dev)
    assert_close_scaled(trl._correlate2d_symmetric(x, rng_psf),
                        trl._correlate2d_shift_add(x, rng_psf), 5e-6)


@pytest.mark.parametrize("noise", [None, [0.5, None, 1.0]])
@pytest.mark.parametrize("bilateral", [None, 1])
def test_enhance_channels_kernels_vs_plain(dev, noise, bilateral):
    from wavelets_tpu_torch import enhance
    x = np.random.default_rng(3).normal(size=(3, 160, 200)).astype(
        np.float32)
    xt = torch.from_numpy(x if bilateral else x * 3 + 10).to(dev)
    args = () if noise is None else (noise,)
    kw = dict(weights=[[1.5, 1.2]] * 3, denoise=[[5, 3]] * 3,
              bilateral=bilateral)
    _build.reset_counters()
    got = enhance(xt, *args, **kw)
    torch.cuda.synchronize()
    group = "bilateral_group" if bilateral else "decompose_group"
    assert dict(_build.LAUNCHES) == {group: 1, "median_select": 3}
    assert not _build.PLAIN_CALLS
    plain = enhance(xt, *args, fuse=False, **kw)
    if bilateral:
        assert_close_scaled(got, plain, 5e-6)
    else:
        assert torch.equal(got, plain)
    one = enhance(xt[1], weights=[1.5, 1.2], denoise=[5, 3],
                  bilateral=bilateral)
    assert_close_scaled(got[1], one, 5e-6)


@pytest.mark.parametrize("shape,level", [((160, 200), 6), ((40, 36), 5),
                                         ((2, 96, 80), 3)])
def test_recursive_kernels_vs_plain(dev, shape, level):
    # (40, 36) at level 5 pads by 32 on a side: the padded frame reflects
    # more than once
    from wavelets_tpu_torch import AtrousTransform, decompose
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=shape).astype(np.float32)).to(dev)
    axes = (1, 2) if len(shape) == 3 else None
    _build.reset_counters()
    got = decompose(x, level, B3SPLINE, axes=axes, recursive_borders=True)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"decompose_group": -(-level // 3)}
    plain = decompose(x, level, B3SPLINE, axes=axes, recursive_borders=True,
                      fuse=False)
    assert torch.equal(got, plain)
    if len(shape) == 2:
        c = AtrousTransform()(x, level, recursive=True)
        assert torch.equal(c.data, got)


def test_noise_calibration_on_the_card(dev):
    from wavelets_tpu_torch import B3spline
    from wavelets_tpu_torch.utils import noise_calibration as tcal
    _build.reset_counters()
    got = B3spline(2).compute_noise_weights(4, n_trials=8)
    torch.cuda.synchronize()
    # 176² trials, all 8 in one batch: a group of 3 and one of 1
    assert dict(_build.LAUNCHES) == {"decompose_group": 2}
    np.testing.assert_allclose(got, B3spline(2).sigma_e()[:4], rtol=0.08)
    noise = torch.randn((8, 176, 176), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    k = tcal.batch_sigma_sum(noise, B3SPLINE, 4)
    p = tcal.batch_sigma_sum(noise, B3SPLINE, 4, fuse=False)
    assert torch.equal(k, p)
    assert np.array_equal(got, (k / 8).cpu().numpy())


# ---------------------------------------------------------------------
# The bfloat16 route's forms of kernels A (group and deep step) and E,
# float32 inside: bitwise to their plain versions on the card (the
# float32 plain versions on the widened input, the whites rounded on
# store), inputs unchanged
# ---------------------------------------------------------------------

def _bf16(rng, shape, dev, mean=10.0):
    x = rng.normal(size=shape).astype(np.float32) * 3 + mean
    return torch.from_numpy(x).to(dev).to(torch.bfloat16)


def _bitwise(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got, ref), float((got.float() - ref.float())
                                        .abs().max())


@pytest.mark.parametrize("shape", [(80, 72), (2, 257, 130), (256, 256),
                                   (16, 16), (300, 204), (512, 512)])
@pytest.mark.parametrize("g,offset", [(4, 0), (3, 0), (3, 1), (4, 1),
                                      (3, 2)])
@pytest.mark.parametrize("sf", [B3SPLINE, TRIANGLE], ids=["b3", "tri"])
@pytest.mark.parametrize("mode", ["soft", "hard", "unmasked"])
@pytest.mark.parametrize("need_cube", [True, False])
def test_bf16_group_kernel_bitwise(dev, shape, g, offset, sf, mode,
                                   need_cube):
    # the streamed group: offsets 0-2, both taps, a frame smaller than the
    # halo (16x16), widths off 8 columns (130, 300x204's 204), and bands
    # that end inside the frame (300 rows)
    rng = np.random.default_rng(g + offset)
    x = _bf16(rng, shape, dev)
    x0 = x.clone()
    masked = (mode != "unmasked",) * (g - 1) + (False,)
    args = ([1.0, 2.0, 0.5, 1.5][:g],
            torch.tensor([0.9, 0.5, 0.0, 0.2][:g], device=dev), g, sf)
    kw = dict(offset=offset, soft=mode == "soft", masked=masked,
              need_cube=need_cube)
    _build.reset_counters()
    rows_k, acc_k = hopper_conv.fused_wow_group(x, *args, **kw)
    assert dict(_build.LAUNCHES) == {"whiten_group_bf16": 1}
    rows_p, acc_p = hopper_conv.fused_wow_group_plain(x, *args, **kw)
    torch.cuda.synchronize()
    assert len(rows_k) == len(rows_p) == (g + 1 if need_cube else 1)
    for a, b in zip(rows_k, rows_p):
        _bitwise(a, b)
    assert rows_k[-1].dtype == acc_k.dtype == torch.float32
    _bitwise(acc_k, acc_p)
    _bitwise(x, x0)


@pytest.mark.parametrize("g", [4, 3])
def test_bf16_group_kernel_bitwise_at_4096(dev, g):
    # the route's group at its own size, on a frame of counts
    rng = np.random.default_rng(g)
    x = torch.from_numpy(rng.poisson(300.0, size=(4096, 4096)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    args = ([1.0, 1.0, 1.0, 1.0][:g],
            torch.tensor([32.2, 13.5, 0.0, 0.0][:g], device=dev), g,
            B3SPLINE)
    kw = dict(masked=(True, True, False, False)[:g])
    _build.reset_counters()
    rows_k, acc_k = hopper_conv.fused_wow_group(x, *args, **kw)
    assert dict(_build.LAUNCHES) == {"whiten_group_bf16": 1}
    rows_p, acc_p = hopper_conv.fused_wow_group_plain(x, *args, **kw)
    torch.cuda.synchronize()
    for a, b in zip((*rows_k, acc_k), (*rows_p, acc_p)):
        _bitwise(a, b)


@pytest.mark.parametrize("strip_w,band_h", [(128, 16), (64, 40), (8, 100),
                                             (16, 7), (32, 100)])
def test_bf16_group_stream_plan_variants_keep_the_bits(dev, monkeypatch,
                                                       strip_w, band_h):
    # the kernel launches the strip and band it is given: other legal
    # plans (bands ending inside the frame, strips of 8 columns) give the
    # bits of the plain version
    x = _bf16(np.random.default_rng(3), (2, 100, 300), dev)
    args = ([1.0, 2.0, 0.5, 1.5], torch.tensor([0.9, 0.5, 0.0, 0.2],
                                               device=dev), 4, B3SPLINE)
    kw = dict(masked=(True, True, False, True))
    plan = hopper_conv.stream_plan(2, 100, 300, 4, 2, 0)
    _replan(monkeypatch, hopper_conv, "group_plan", strip_w=strip_w,
            band_h=band_h, grid=(-(-300 // strip_w), -(-100 // band_h), 2),
            smem_bytes=hopper_conv.stream_smem(strip_w, 4, 2, 0))
    assert plan.band_h != band_h or plan.strip_w != strip_w
    _build.reset_counters()
    rows_k, acc_k = hopper_conv.fused_wow_group(x, *args, **kw)
    assert dict(_build.LAUNCHES) == {"whiten_group_bf16": 1}
    rows_p, acc_p = hopper_conv.fused_wow_group_plain(x, *args, **kw)
    torch.cuda.synchronize()
    for a, b in zip((*rows_k, acc_k), (*rows_p, acc_p)):
        _bitwise(a, b)


@pytest.mark.parametrize("shape", [(1, 64, 96), (2, 257, 130),
                                   (1, 512, 512)])
@pytest.mark.parametrize("s", [0, 3, 5])
@pytest.mark.parametrize("mode", ["soft", "hard", "unmasked"])
def test_bf16_deep_step_kernel_bitwise(dev, shape, s, mode):
    # the route's step: a float32 carry and recon, the white in bfloat16
    rng = np.random.default_rng(s)
    x = _bf16(rng, shape, dev).float()
    recon = _bf16(rng, shape, dev, mean=0.0).float()
    x0 = x.clone()
    thr = torch.tensor([0.9, 0.0][:shape[0]], device=dev)
    kw = dict(sf=B3SPLINE, scale=s, weight=1.5, soft=mode == "soft",
              masked=mode != "unmasked", white_dtype=torch.bfloat16)
    r_k, r_p = recon.clone(), recon.clone()
    _build.reset_counters()
    w_k, _, c_k = hopper_deep.deep_whiten_step(x, r_k, thr, **kw)
    assert dict(_build.LAUNCHES) == {"whiten_step_bf16": 1}
    w_p, _, c_p = hopper_deep.deep_whiten_step_plain(x, r_p, thr, **kw)
    torch.cuda.synchronize()
    for a, b in ((w_k, w_p), (c_k, c_p), (r_k, r_p), (x, x0)):
        _bitwise(a, b)


@pytest.mark.parametrize("shape,s,sf", [
    ((1, 256, 256), 4, B3SPLINE), ((2, 64, 96), 3, B3SPLINE),
    ((1, 512, 512), 4, B3SPLINE), ((1, 4096, 4096), 7, B3SPLINE),
    ((3, 512, 512), 4, B3SPLINE), ((1, 512, 512), 5, TRIANGLE),
    # 512x4096 at (4, 5), which the gate leaves to two steps (the kernel
    # takes it);
    # D = 1 and D = 2; windows of the columns at one point a thread and at
    # four classes a group
    ((1, 512, 4096), 4, B3SPLINE), ((2, 12, 20), 0, B3SPLINE),
    ((1, 16, 24), 1, TRIANGLE), ((1, 6, 600), 0, B3SPLINE),
    ((1, 48, 4800), 3, B3SPLINE)])
@pytest.mark.parametrize("masked", [(True, False), (False, False)])
@pytest.mark.parametrize("with_recon", [False, True])
def test_bf16_pair_kernel_bitwise(dev, shape, s, sf, masked, with_recon):
    # the stream (csrc/whiten_pair.cu, wt_whiten_pair_bf16) bitwise to the
    # pair's plain version: float32 carries and recon, bfloat16 whites
    rng = np.random.default_rng(s)
    x = _bf16(rng, shape, dev).float()
    x0 = x.clone()
    recon = _bf16(rng, shape, dev, mean=0.0).float() if with_recon else None
    thr = torch.full((2, shape[0]), 0.7, device=dev)
    kw = dict(sf=sf, scale=s, weights=(1.5, 0.5), soft=True,
              masked=masked, white_dtype=torch.bfloat16)
    r_k = recon.clone() if with_recon else None
    r_p = recon.clone() if with_recon else None
    _build.reset_counters()
    w1k, w2k, _, ck = hopper_deep.deep_whiten_step2(x, r_k, thr, **kw)
    assert dict(_build.LAUNCHES) == {"whiten_pair_bf16": 1}
    w1p, w2p, _, cp = hopper_deep.deep_whiten_step2_plain(x, r_p, thr, **kw)
    torch.cuda.synchronize()
    for a, b in ((w1k, w1p), (w2k, w2p), (ck, cp), (x, x0)):
        _bitwise(a, b)
    if with_recon:
        _bitwise(r_k, r_p)


def _forced_pair_plan(k, run, chunk, grid, threads=512):
    """A stand-in for hopper_deep.pair_stream_plan: the given group,
    window and chunk (cut to what the shape takes), grid (at most the
    items) and threads, with the shared bytes the layout needs."""
    def plan(B, H, W, D, hw):
        classes = max(1, D // 2)
        M, N = H // D, W // D
        rows_out, cols_out = (M, N) if D == 1 else (2 * M, 2 * N)
        kk, rr, ch = min(k, classes), min(run, cols_out), min(chunk, rows_out)
        window = rr + 10 * hw if rr else 2 * N
        runs = -(-cols_out // rr) if rr else 1
        items = B * -(-rows_out // ch) * classes * runs * (classes // kk)
        return hopper_deep.PairStreamPlan(
            kk, rr, ch, threads,
            hopper_deep.pair_stream_smem(kk, window, hw, rr == 0),
            min(grid, items))
    return plan


@pytest.mark.parametrize("plan", [(2, 0, 5, 3), (8, 0, 1, 1), (1, 5, 3, 7),
                                  (4, 3, 7, 132), (2, 9, 64, 2),
                                  (4, 0, 5, 9, 128), (1, 3, 2, 5, 256),
                                  (8, 0, 16, 100, 256)])
@pytest.mark.parametrize("sf", [B3SPLINE, TRIANGLE], ids=["b3", "tri"])
def test_bf16_pair_forced_plans_bitwise(dev, monkeypatch, plan, sf):
    # the stream launches the plan as given: groups of fewer classes,
    # chunks across the circle's turn, windows of the columns, a grid
    # smaller than the items (blocks take items grid-stride) keep the bits
    rng = np.random.default_rng(len(plan))
    shape = (2, 64, 96)
    x = _bf16(rng, shape, dev).float()
    recon = _bf16(rng, shape, dev, mean=0.0).float()
    thr = torch.tensor([[0.7, 0.0], [0.3, 0.5]], device=dev)
    kw = dict(sf=sf, scale=3, weights=(1.5, 0.5), masked=(True, True),
              white_dtype=torch.bfloat16)
    r_k, r_p = recon.clone(), recon.clone()
    monkeypatch.setattr(hopper_deep, "pair_stream_plan",
                        _forced_pair_plan(*plan))
    out_k = hopper_deep.deep_whiten_step2(x, r_k, thr, **kw)
    out_p = hopper_deep.deep_whiten_step2_plain(x, r_p, thr, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        _bitwise(a, b)


@pytest.mark.parametrize("shape,launched", [
    ((512, 512), {"whiten_group_bf16": 1, "whiten_pair_bf16": 1}),
    ((1024, 1024), {"whiten_group_bf16": 1, "whiten_step_bf16": 2}),
])
@pytest.mark.parametrize("frame", ["zero-mean", "counts"])
def test_bf16_wow_merged_on_the_card(dev, shape, launched, frame):
    # zero-mean frames, and frames of hundreds of counts, where the JAX
    # package's bfloat16 rounding strayed from its float32 path
    rng = np.random.default_rng(7)
    if frame == "counts":
        x = torch.from_numpy(rng.poisson(300.0, size=shape).astype(
            np.float32)).to(dev).to(torch.bfloat16)
        kw = dict(n_scales=6, denoise_coefficients=[5, 2], noise=17.3)
    else:
        x = _bf16(rng, shape, dev, mean=0.0)
        kw = dict(n_scales=6, denoise_coefficients=[5, 2], noise=1.0)
    _build.reset_counters()
    r_k, c_k = wow(x, **kw)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == launched
    assert dict(_build.PLAIN_CALLS) == {}
    assert r_k.dtype == torch.bfloat16 and bool(torch.isfinite(r_k).all())
    # the same frame through the plain versions on the CPU
    _build.reset_counters()
    r_c, c_c = wow(x.cpu(), **kw)
    assert dict(_build.LAUNCHES) == {}
    scale = float(r_c.float().abs().max())
    # one bfloat16 unit at the largest value, 2^(floor(log2 max) - 7):
    # 2^-8 of the max held on the zero-mean frames, the unit itself (up
    # to 2^-7 of it) on counts, whose recon passes 2048
    unit = 2.0 ** (np.floor(np.log2(scale)) - 7) / scale
    rtol = 2 ** -8 if frame == "zero-mean" else unit
    assert_close_scaled(r_k, r_c, rtol, scale)
    for k in range(len(c_c)):
        assert_close_scaled(c_k[k], c_c[k], rtol, scale)
    # and within one bfloat16 unit of the float32 kernels on the same
    # (widened) frame (JAX's bfloat16 standard held it to 2e-2)
    r32, c32 = wow(x.float(), **kw)
    assert_close_scaled(r_k, r32, unit, scale)
    for k in range(len(c32)):
        assert_close_scaled(c_k[k], c32[k], unit, scale)


def test_bf16_known_noise_frame_at_4096(dev):
    # the deployment: a 4096² bfloat16 frame of counts, a known scalar
    # noise, the automatic 10 scales: the route's launches, nothing
    # plain, no host wait (the noise is a fill, not a copy), and every
    # output within bfloat16 rounding of the float32 route on the frame
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.poisson(300.0, size=(4096, 4096)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    kw = dict(denoise_coefficients=[5, 2], noise=6.44)
    wow(x, **kw)
    torch.cuda.synchronize()
    _build.reset_counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r_k, c_k = wow(x, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"whiten_group_bf16": 1,
                                     "whiten_step_bf16": 4,
                                     "whiten_pair_bf16": 1}
    assert dict(_build.PLAIN_CALLS) == {}
    assert r_k.dtype == torch.bfloat16 and len(c_k) == 11
    r32, c32 = wow(x.float(), **kw)
    scale = float(r32.abs().max())
    assert_close_scaled(r_k, r32, 2 ** -8)
    for k in range(11):
        assert c_k[k].dtype == torch.bfloat16
        assert_close_scaled(c_k[k], c32[k], 2 ** -8, scale)


@pytest.mark.parametrize("route", ["bilateral", "stack"])
def test_fused_body_waits_for_no_earlier_call(dev, route):
    # the fused body's factor table is filled on the card: a warm bilateral
    # frame and a stack on the pieces route, lazy noise, at 1024², make no
    # synchronising CUDA operation
    x = torch.from_numpy((np.random.default_rng(23).normal(
        size=(4, 1024, 1024)) * 3 + 100).astype(np.float32)).to(dev)
    kw = dict(denoise_coefficients=[5, 2])
    run = {"bilateral": lambda: wow(x[0], bilateral=1, **kw),
           "stack": lambda: wow_stack(x, with_coefficients=False, **kw)}[route]
    run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_bf16_merged_route_raises_without_its_kernel(dev, monkeypatch):
    x = _bf16(np.random.default_rng(8), (512, 512), dev)

    def no_kernel():
        raise RuntimeError("the bfloat16 group kernel did not build")

    monkeypatch.setattr(hopper_conv, "_lib_group", no_kernel)
    _build.reset_counters()
    with pytest.raises(RuntimeError, match="did not build"):
        wow(x, n_scales=6, noise=1.0)
    assert not _build.PLAIN_CALLS
    # float16 has no kernel form: the wrappers refuse it on the card
    h = x.to(torch.float16)[None]
    with pytest.raises(TypeError):
        hopper_deep.deep_whiten_step(h, None, torch.zeros(1, device=dev),
                                     sf=B3SPLINE, scale=4, weight=1.0)
    with pytest.raises(TypeError):
        hopper_conv.fused_wow_group(h, [1.0], torch.zeros(1, device=dev), 1,
                                    B3SPLINE)
    # and float16 WOW on the card runs the plain bodies by the dtype rule
    _build.reset_counters()
    r, _ = wow(h[0], n_scales=6, noise=1.0)
    assert r.dtype == torch.float16 and r.is_cuda and not _build.LAUNCHES


# ---------------------------------------------------------------------
# kernel A's deep step in halo mode (the sharded band tail) and the
# bfloat16 pair with a float32 middle carry (C1)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 96), (37, 70)])
@pytest.mark.parametrize("s", [0, 3, 6])
@pytest.mark.parametrize("mode", ["soft", "hard", "unmasked"])
def test_halo_step_kernel_bitwise(dev, shape, s, mode):
    # 2 bands extended as the sharded engine extends them: every output
    # bitwise to the plain version, the bands concatenated bitwise to the
    # frame's deep step
    from wavelets_tpu_torch.ops.conv import boundary_index

    rng = np.random.default_rng(s)
    H = shape[0]
    x = torch.from_numpy(rng.normal(size=(2,) + shape).astype(np.float32))
    recon = torch.from_numpy(rng.normal(size=(2,) + shape)
                             .astype(np.float32))
    x, recon = x.to(dev), recon.to(dev)
    thr = torch.tensor([0.1, 0.0], device=dev)
    kw = dict(sf=B3SPLINE, scale=s, weight=1.5, soft=mode == "soft",
              masked=mode != "unmasked")
    r_1 = recon.clone()
    w_1, _, c_1 = hopper_deep.deep_whiten_step(x, r_1, thr, **kw)
    R = 2 * B3SPLINE.half_width << s
    hb = -(-H // 2)
    parts = []
    for lo in (0, hb):
        hi = min(H, lo + hb)
        ext = x.index_select(1, boundary_index(H, lo - R, "symmetric", dev,
                                               hi - lo + 2 * R)).contiguous()
        r_k = recon[:, lo:hi].contiguous()
        r_p = r_k.clone()
        n0 = _build.LAUNCHES["whiten_step_halo"]
        out_k = hopper_deep.deep_whiten_step(ext, r_k, thr, halo=R, **kw)
        out_p = hopper_deep.deep_whiten_step_plain(ext, r_p, thr, halo=R,
                                                   **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["whiten_step_halo"] == n0 + 1
        for a, b in zip(out_k, out_p):
            assert torch.equal(a, b)
        parts.append(out_k)
    for k, ref in enumerate((w_1, r_1, c_1)):
        assert torch.equal(torch.cat([p[k] for p in parts], 1), ref)


def test_halo_step_raises_on_bf16(dev):
    x = torch.zeros((1, 64 + 64, 128), device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        hopper_deep.deep_whiten_step(x, None, torch.zeros(1, device=dev),
                                     sf=B3SPLINE, scale=3, weight=1.0,
                                     halo=32)


def _two_steps(x, acc, thr, *, sf, scale, weights, masked, **kw):
    """A pair as two steps of kernel A, the middle carry float32 → the
    pair's returns."""
    w1, _, mid = hopper_deep.deep_whiten_step(
        x, acc, thr[0], sf=sf, scale=scale, weight=weights[0],
        masked=masked[0], **kw)
    w2, _, c = hopper_deep.deep_whiten_step(
        mid, acc, thr[1], sf=sf, scale=scale + 1, weight=weights[1],
        masked=masked[1], **kw)
    return w1, w2, acc, c


@pytest.mark.parametrize("shape,s", [((256, 2048), 4), ((512, 256), 5)])
def test_bf16_split_pair_bitwise(dev, shape, s):
    # two launches of kernel A's bfloat16 step, the middle carry float32,
    # bitwise the pair's plain version
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.normal(size=(2,) + shape).astype(np.float32))
    x = x.to(dev).to(torch.bfloat16).float()
    acc = torch.zeros_like(x)
    thr = torch.tensor([[0.4, 0.0], [0.2, 0.6]], device=dev)
    kw = dict(sf=B3SPLINE, scale=s, weights=(1.25, 0.75),
              masked=(True, True), white_dtype=torch.bfloat16)
    a_k, a_p = acc.clone(), acc.clone()
    n0 = _build.LAUNCHES["whiten_step_bf16"]
    out_k = _two_steps(x, a_k, thr, **kw)
    out_p = hopper_deep.deep_whiten_step2_plain(x, a_p, thr, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["whiten_step_bf16"] == n0 + 2
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)
    assert out_k[0].dtype == out_k[1].dtype == torch.bfloat16


def test_bf16_wide_route_launches_the_groups_the_plan_takes(dev):
    # 256x25600 L8: the streamed group takes scales 0-3, kernel A's
    # bfloat16 deep step scales 4 and 5, kernel E's stream (6, 7), and
    # nothing runs plain
    from wavelets_tpu_torch.models.wow import wow_core
    x = _bf16(np.random.default_rng(9), (256, 25600), dev, mean=0.0)
    _build.reset_counters()
    r, _ = wow_core(
        x, torch.tensor(1.0, dtype=torch.bfloat16, device=dev),
        need_planes=False, sf=B3SPLINE, n_scales=8, weights=(1.0,) * 9,
        whitening=True, denoise_coefficients=(0.0,) * 9, bilateral=None,
        bilateral_scaling=False, soft_threshold=True,
        preserve_variance=False, gamma=3.2, gamma_min=None, gamma_max=None,
        h=0.0, has_noise=True)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"whiten_group_bf16": 1,
                                     "whiten_step_bf16": 2,
                                     "whiten_pair_bf16": 1}
    assert not _build.PLAIN_CALLS
    assert r.dtype == torch.bfloat16 and bool(torch.isfinite(r).all())


@pytest.mark.parametrize("g,offset", [(1, 7), (2, 5)])
def test_bf16_group_without_tile_runs_plain_on_the_card(dev, g, offset):
    # a bfloat16 group whose rings no strip holds runs kernel A's
    # bfloat16 deep step, one launch a scale on the widened frame, never
    # the plain group body, and is bitwise that body
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(256, 512))
                         .astype(np.float32)).to(dev).to(torch.bfloat16)
    args = ((1.0, 0.5)[:g], torch.tensor([0.5, 0.3][:g], device=dev), g,
            B3SPLINE)
    kw = dict(offset=offset, masked=(True,) * g)
    _build.reset_counters()
    rows, acc = hopper_conv.fused_wow_group(x, *args, **kw)
    assert dict(_build.LAUNCHES) == {"whiten_step_bf16": g}
    assert not _build.PLAIN_CALLS
    r_rows, r_acc = hopper_conv.fused_wow_group_plain(x, *args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(rows + (acc,), r_rows + (r_acc,)):
        _bitwise(a, b)
    assert rows[0].is_cuda and rows[0].dtype == torch.bfloat16
    assert acc.dtype == torch.float32


# ---------------------------------------------------------------------
# kernel A's deep step on the residue-class stream (one launch a scale,
# the detail on chip): the bfloat16 step, the split pair's two halves and
# halo mode, at the paths' shapes and on forced plans (runs of columns,
# tap windows, chunks, a grid smaller than the items)
# ---------------------------------------------------------------------

def _m2_band(x, R):
    """M2's band tail on one rank: the whole frame extended by R rows a
    side with its symmetric reflection, as the sharded engine builds it."""
    from wavelets_tpu_torch.ops.conv import boundary_index
    H = x.shape[1]
    return x.index_select(1, boundary_index(H, -R, "symmetric", x.device,
                                            H + 2 * R)).contiguous()


@pytest.mark.parametrize("shape,s", [((4096, 4096), 4), ((4096, 4096), 9),
                                     ((256, 25600), 4), ((256, 25600), 6)])
def test_stream_bf16_and_split_bitwise_at_the_paths_shapes(dev, shape, s):
    rng = np.random.default_rng(s)
    x = _bf16(rng, (1,) + shape, dev).float()
    recon = _bf16(rng, (1,) + shape, dev, mean=0.0).float()
    thr = torch.tensor([0.9], device=dev)
    kw = dict(sf=B3SPLINE, scale=s, weight=1.5, soft=True, masked=True,
              white_dtype=torch.bfloat16)
    r_k, r_p = recon.clone(), recon.clone()
    _build.reset_counters()
    out_k = hopper_deep.deep_whiten_step(x, r_k, thr, **kw)
    assert dict(_build.LAUNCHES) == {"whiten_step_bf16": 1}
    out_p = hopper_deep.deep_whiten_step_plain(x, r_p, thr, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        _bitwise(a, b)
    s2 = min(s, 8)
    thr2 = torch.tensor([[0.4], [0.0]], device=dev)
    kw2 = dict(sf=B3SPLINE, scale=s2, weights=(1.25, 0.75),
               masked=(True, False), white_dtype=torch.bfloat16)
    a_k, a_p = recon.clone(), recon.clone()
    out_k = _two_steps(x, a_k, thr2, **kw2)
    assert dict(_build.LAUNCHES) == {"whiten_step_bf16": 3}
    out_p = hopper_deep.deep_whiten_step2_plain(x, a_p, thr2, **kw2)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        _bitwise(a, b)


@pytest.mark.parametrize("shape,scales", [((4096, 4096), (3, 9)),
                                          ((256, 25600), (5,))])
def test_stream_halo_m2_band_bitwise(dev, shape, scales):
    # one rank's band: the frame extended by R rows a side; the kernel
    # bitwise to its plain version and to the frame's float32 step
    rng = np.random.default_rng(len(scales))
    x = torch.from_numpy(rng.normal(size=(1,) + shape).astype(np.float32))
    recon = torch.from_numpy(rng.normal(size=(1,) + shape).astype(np.float32))
    x, recon = x.to(dev), recon.to(dev)
    thr = torch.tensor([0.3], device=dev)
    for s in scales:
        R = 2 * B3SPLINE.half_width << s
        kw = dict(sf=B3SPLINE, scale=s, weight=1.5, soft=True, masked=True)
        ext = _m2_band(x, R)
        r_k, r_p, r_1 = recon.clone(), recon.clone(), recon.clone()
        _build.reset_counters()
        out_k = hopper_deep.deep_whiten_step(ext, r_k, thr, halo=R, **kw)
        assert dict(_build.LAUNCHES) == {"whiten_step_halo": 1}
        out_p = hopper_deep.deep_whiten_step_plain(ext, r_p, thr, halo=R,
                                                   **kw)
        out_1 = hopper_deep.deep_whiten_step(x, r_1, thr, **kw)
        torch.cuda.synchronize()
        for a, b, c in zip(out_k, out_p, out_1):
            assert torch.equal(a, b) and torch.equal(a, c)


def _forced_stream_plan(seg, chunk, grid):
    """A stand-in for hopper_conv.stream_step_plan: the given run width,
    chunk length (at most a class's rows) and grid (at most the items),
    with the shared bytes the layout needs."""
    def plan(B, H, W, D, hw, halo=False):
        sg = seg if seg < W else 0
        _, n_cls, P, _ = hopper_conv.stream_classes(H, D, halo)
        ch = min(chunk, P)
        runs = -(-W // sg) if sg else 1
        items = B * runs * n_cls * -(-P // ch)
        return hopper_conv.StreamStepPlan(
            sg, ch, hopper_conv.stream_step_smem(W, D, hw, sg),
            min(grid, items))
    return plan


@pytest.mark.parametrize("plan", [(0, 1, 1), (0, 2, 7), (8, 3, 5),
                                  (16, 1, 64), (64, 2, 3)])
@pytest.mark.parametrize("shape,s", [((3, 37, 70), 1), ((3, 37, 70), 3),
                                     ((3, 37, 70), 6), ((1, 8, 129), 4),
                                     ((2, 19, 40), 9), ((2, 64, 70), 3)])
@pytest.mark.parametrize("sf", [B3SPLINE, TRIANGLE], ids=["b3", "tri"])
def test_stream_forced_plans_bitwise(dev, monkeypatch, plan, shape, s, sf):
    # runs of 8, 16 and 64 columns (tap windows where Dc passes the run),
    # chunks of 1-3 positions, grids below the items (grid-stride), H not
    # a multiple of D, D >= H, odd widths, three frames: every form
    # bitwise to its plain version
    monkeypatch.setattr(hopper_conv, "stream_step_plan",
                        _forced_stream_plan(*plan))
    rng = np.random.default_rng(s)
    x = _bf16(rng, shape, dev).float()
    recon = _bf16(rng, shape, dev, mean=0.0).float()
    B = shape[0]
    thr = torch.tensor([0.9, 0.0, 0.5][:B], device=dev)
    kw = dict(sf=sf, scale=s, weight=1.5, soft=True, masked=True)
    bf = dict(white_dtype=torch.bfloat16)
    r_k, r_p = recon.clone(), recon.clone()
    out_k = hopper_deep.deep_whiten_step(x, r_k, thr, **kw, **bf)
    out_p = hopper_deep.deep_whiten_step_plain(x, r_p, thr, **kw, **bf)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        _bitwise(a, b)
    thr2 = torch.stack([thr, thr.flip(0)])
    kw2 = dict(sf=sf, scale=s, weights=(1.25, 0.75), masked=(True, False),
               **bf)
    a_k, a_p = recon.clone(), recon.clone()
    out_k = _two_steps(x, a_k, thr2, **kw2)
    out_p = hopper_deep.deep_whiten_step2_plain(x, a_p, thr2, **kw2)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        _bitwise(a, b)
    R = 2 * sf.half_width << s
    ext = _m2_band(x, R)
    r_k, r_p = recon.clone(), recon.clone()
    out_k = hopper_deep.deep_whiten_step(ext, r_k, thr, halo=R, **kw)
    out_p = hopper_deep.deep_whiten_step_plain(ext, r_p, thr, halo=R, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)


@pytest.mark.parametrize("wrong", ["smem", "seg", "chunk", "grid"])
def test_stream_entry_refuses_a_wrong_plan(dev, monkeypatch, wrong):
    # the C entry lays out the shared memory itself and refuses a plan it
    # cannot run (cudaErrorInvalidValue), before any launch
    real = hopper_conv.stream_step_plan

    def bad(*args):
        p = real(*args)
        return dataclasses.replace(p, **{
            "smem": dict(smem_bytes=p.smem_bytes - 16),
            "seg": dict(seg=12),
            "chunk": dict(chunk=1 << 20),
            "grid": dict(grid=1 << 20)}[wrong])
    monkeypatch.setattr(hopper_conv, "stream_step_plan", bad)
    x = _bf16(np.random.default_rng(0), (1, 64, 96), dev).float()
    _build.reset_counters()
    with pytest.raises(RuntimeError, match="CUDA error"):
        hopper_deep.deep_whiten_step(x, None, torch.zeros(1, device=dev),
                                     sf=B3SPLINE, scale=3, weight=1.0,
                                     white_dtype=torch.bfloat16)
    assert not _build.LAUNCHES


# ---- tracing: the sync sites and kernel spans of the benchmark's entries

def _cell_entries(dev):
    """One call of each benchmark cell's entry at 512²: a frame to
    ``wow``, a stack of 4 to ``wow_stack`` without planes, a bilateral
    frame, lazy noise on counts of about 100."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy((rng.normal(size=(4, 512, 512)) * 3 + 100)
                         .astype(np.float32)).to(dev)
    kw = dict(denoise_coefficients=[5, 2])
    return {
        "frame": lambda: wow(x[0], **kw),
        "stack4": lambda: wow_stack(x, with_coefficients=False, **kw),
        "bilateral": lambda: wow(x[0], bilateral=1, **kw),
    }


@pytest.mark.parametrize("cell", ["frame", "stack4", "bilateral"])
def test_sync_sites_match_the_sync_debug_mode(dev, cell):
    # every place the host waits for the card is a counted sync site: the
    # count of one warm call equals the synchronising operations that
    # PyTorch's sync debug mode reports for it
    run = _cell_entries(dev)[cell]
    run()
    torch.cuda.synchronize()
    tracing.reset()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with tracing.record():
                run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # the mode's own notice ("a prototype feature") is no operation
    said = [f"{w.filename}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]
    syncs = tracing.totals()["syncs"]
    tracing.reset()
    assert sum(syncs.values()) == len(said), (syncs, said)


def test_kernel_spans_cover_their_kernels(dev, tmp_path):
    # each kernel a wrapper launches lies inside the wrapper's span as the
    # profiler draws it on the card (gpu_user_annotation)
    from torch.profiler import ProfilerActivity, profile

    runs = _cell_entries(dev)
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for run in runs.values():
            run()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    host = [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith("wt.k.")]
    gpu = [e for e in events if e.get("cat") == "gpu_user_annotation"
           and e["name"].startswith("wt.k.")]
    kernels = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "kernel"
               and "correlation" in e.get("args", {})}
    covered = collections.Counter()
    for r in events:
        corr = r.get("args", {}).get("correlation")
        if r.get("cat") != "cuda_runtime" or corr not in kernels:
            continue
        around = [h for h in host if h["tid"] == r["tid"]
                  and h["ts"] <= r["ts"] <= h["ts"] + h["dur"]]
        if not around:
            continue
        span = max(around, key=lambda h: h["ts"])["name"]
        k = kernels[corr]
        assert any(g["name"] == span and g["ts"] <= k["ts"]
                   and k["ts"] + k["dur"] <= g["ts"] + g["dur"]
                   for g in gpu), (span, k["name"])
        covered[span] += 1
    assert set(covered) == {h["name"] for h in host}, covered
