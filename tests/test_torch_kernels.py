"""Kernel A's plain version (``hopper_conv.fused_wow_group_plain``)
against the TPU kernel it replaces, ``pallas_conv._fused_wow_group``, in
interpret mode; the wrappers' dispatch on CPU tensors; the build helper.

Tolerances: whitened planes and ``acc`` within ``5e-6·max|ref|`` (the
standard of tests/test_pallas_merged.py:61; the TPU kernel's
Abramowitz-Stegun erf differs from the true erf by ≤1.5e-7).  The
carry is held to ≤1 ulp (0 measured) against the JAX package's XLA
smooth chain, which the TPU kernel matches bitwise on hardware; against
the interpret-mode kernel it is held to the JAX package's own interpret
standard, 4 units in the last place of its magnitude (interpret mode
contracts one FMA per fold, tests/test_pallas_deep.py:1-13 and :34-46;
measured 2-3 here)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_parity import assert_close_scaled, to_np, ulp_distance
from wavelets_tpu.ops import conv as jconv
from wavelets_tpu.ops import pallas_conv
from wavelets_tpu.ops.filters import B3SPLINE as JB3
from wavelets_tpu_torch.ops import _build, hopper_conv, hopper_deep, hopper_stats
from wavelets_tpu_torch.ops.filters import B3SPLINE, ScalingFunction


@pytest.fixture(scope="module")
def frame():
    return np.random.default_rng(7).normal(size=(256, 256)).astype(np.float32)


def _carry_at(x, off):
    c = jnp.asarray(x)
    for s in range(off):
        c = jconv.smooth(c, JB3, scale=s)
    return np.array(c)


def _assert_carry(got, interp, x, off, g):
    xla = jnp.asarray(x)
    for s in range(off, off + g):
        xla = jconv.smooth(xla, JB3, scale=s)
    assert ulp_distance(got, xla) <= 1
    interp = to_np(interp)
    err = np.abs(to_np(got) - interp).max()
    assert err <= 4 * np.spacing(np.abs(interp).max()), err


@pytest.mark.parametrize("off,g", [(0, 3), (3, 2), (5, 1)])
@pytest.mark.parametrize("soft", [True, False])
@pytest.mark.parametrize("masked", [True, False])
def test_group_plain_vs_pallas(frame, off, g, soft, masked):
    cur = _carry_at(frame, off)
    fac = np.asarray([1.5, 0.5, 2.0][:g], np.float32)
    # thresholds near the detail scale; a zero one exercises "no mask"
    sig = float(np.std(cur - _carry_at(cur, 1)))
    thr = np.asarray([2.0 * sig, 0.0, 0.7 * sig][:g], np.float32)
    msk = (masked,) * g
    rows, acc = pallas_conv._fused_wow_group(
        jnp.asarray(cur), jnp.asarray(fac), jnp.asarray(thr), g, JB3,
        offset=off, soft=soft, masked=msk, interpret=True)
    grows, gacc = hopper_conv.fused_wow_group_plain(
        torch.from_numpy(cur), fac.tolist(), torch.from_numpy(thr), g,
        B3SPLINE, offset=off, soft=soft, masked=msk)
    assert len(grows) == g + 1
    for k in range(g):
        assert_close_scaled(grows[k], rows[k], 5e-6)
    _assert_carry(grows[g], rows[g], cur, off, g)
    assert_close_scaled(gacc, acc, 5e-6)


def test_group_without_cube_and_batched(frame):
    x = torch.from_numpy(np.stack([frame, 2 * frame]))
    thr = torch.tensor([[0.3, 0.0], [0.1, 0.2]], dtype=torch.float32)
    rows, acc = hopper_conv.fused_wow_group_plain(
        x, [1.0, 1.0], thr, 2, B3SPLINE, soft=True, masked=(True, True))
    carry_only, acc2 = hopper_conv.fused_wow_group_plain(
        x, [1.0, 1.0], thr, 2, B3SPLINE, soft=True, masked=(True, True),
        need_cube=False)
    assert len(rows) == 3 and len(carry_only) == 1
    assert torch.equal(carry_only[0], rows[2]) and torch.equal(acc, acc2)
    # per-frame thresholds: frame b of the batch is the single-frame call
    for b in range(2):
        r1, a1 = hopper_conv.fused_wow_group_plain(
            x[b], [1.0, 1.0], thr[:, b], 2, B3SPLINE, soft=True,
            masked=(True, True))
        assert torch.equal(a1, acc[b]) and torch.equal(r1[1], rows[1][b])


def test_group_acc_is_its_own_tensor(frame):
    rows, acc = hopper_conv.fused_wow_group_plain(
        torch.from_numpy(frame), [1.0], torch.zeros(1), 1, B3SPLINE)
    assert acc.data_ptr() != rows[0].data_ptr()
    assert torch.equal(acc, rows[0])


def test_group_rejects_bad_arguments(frame):
    x = torch.from_numpy(frame)
    with pytest.raises(ValueError):
        hopper_conv.fused_wow_group_plain(x, [1.0], torch.zeros(2), 2,
                                          B3SPLINE)
    with pytest.raises(ValueError):
        hopper_conv.fused_wow_group_plain(x, [], torch.zeros(0), 0, B3SPLINE)


def test_cpu_wrappers_take_the_plain_versions(frame):
    x = torch.from_numpy(frame)
    _build.reset_counters()
    rows, acc = hopper_conv.fused_wow_group(
        x, [1.0, 2.0], torch.tensor([0.2, 0.0]), 2, B3SPLINE,
        masked=(True, False))
    ref_rows, ref_acc = hopper_conv.fused_wow_group_plain(
        x, [1.0, 2.0], torch.tensor([0.2, 0.0]), 2, B3SPLINE,
        masked=(True, False))
    assert torch.equal(acc, ref_acc)
    assert all(torch.equal(a, b) for a, b in zip(rows, ref_rows))
    recon = torch.zeros_like(x)[None]
    white, r2, c_next = hopper_deep.deep_whiten_step(
        x[None], recon, torch.tensor([0.0]), sf=B3SPLINE, scale=4,
        weight=1.0)
    assert r2 is recon and torch.equal(recon, white)
    hopper_stats.median_bits2(x.view(torch.int32), (5, 6))
    assert _build.PLAIN_CALLS == {"whiten_group": 2, "whiten_step": 1,
                                  "median_select": 1}
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("bad", ["float64", "strided", "asymmetric"])
def test_kernel_input_check(bad):
    x = torch.zeros(8, 8)
    sf = B3SPLINE
    if bad == "float64":
        x = x.double()
    elif bad == "strided":
        x = torch.zeros(8, 16)[:, ::2]
    else:
        sf = ScalingFunction("asym", (0.1, 0.5, 0.4))
    with pytest.raises((TypeError, ValueError)):
        hopper_conv.check_kernel_input(x, sf, "test")


def test_build_helper(tmp_path, monkeypatch):
    # every kernel source of the package is present and named in the
    # build, and the library name follows the source and header hash
    names = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    assert names == ["bilateral_group", "bilateral_step", "decompose_group",
                     "median_select", "whiten_group", "whiten_pair",
                     "whiten_plane", "whiten_step"]
    p1 = _build._library_path("whiten_step")
    assert p1.parent == _build.BUILD_DIR and p1.suffix == ".so"
    src = tmp_path / "whiten_step.cu"
    src.write_text((_build.CSRC_DIR / "whiten_step.cu").read_text())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    p2 = _build._library_path("whiten_step")
    assert p2 != p1     # the shared header is part of the hash
    (tmp_path / "wt_common.cuh").write_text("// edited\n")
    assert _build._library_path("whiten_step") not in (p1, p2)
    # without a CUDA toolkit the build says so instead of half-working
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_counters_reset():
    _build.LAUNCHES["whiten_step"] += 2
    _build.PLAIN_CALLS["median_select"] += 1
    _build.reset_counters()
    assert not _build.LAUNCHES and not _build.PLAIN_CALLS
