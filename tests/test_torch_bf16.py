"""The kernels of the bfloat16 merged route: the plain versions of
kernel A (group and deep step) and kernel E on a bfloat16 frame against
the JAX package's Pallas kernels in float32 on the widened frame
(interpret mode, as tests/test_r5.py runs them), their whites rounded to
bfloat16 on store.  The route is bfloat16 at the boundary and float32
inside, and departs on purpose from the JAX package's bfloat16 kernels,
which round every pass and the carry (PERF.md, section 6).  The route
itself: tests/test_torch_bf16_wow.py.

Tolerances: the float32 carries within 4 units in the last place of
their magnitude (the JAX package's interpret standard: interpret mode
contracts one FMA per fold; measured 0-3), the float32 ``acc`` within
``5e-6·max|ref|`` (the float32 kernels' standard, tests/
test_torch_kernels.py); the bfloat16 whites within ``2^-8·max|ref|``
(one bfloat16 unit in the last place at the largest value) of the JAX
whites rounded, since the interpret kernels' float32 unit flips the
rounding of a few values (measured: one bfloat16 unit, most planes
bitwise)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_close_scaled, to_np
from wavelets_tpu.ops import pallas_conv, pallas_deep
from wavelets_tpu.ops.filters import B3SPLINE as JB3
from wavelets_tpu_torch.ops import _build, hopper_conv, hopper_deep
from wavelets_tpu_torch.ops.filters import B3SPLINE

RTOL = 2 ** -8


def _pair(shape, seed, mean=10.0):
    """The same bfloat16 input for both packages."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    j = jnp.asarray(x * 3 + mean).astype(jnp.bfloat16)
    return j, torch.from_numpy(to_np(j)).to(torch.bfloat16)


def _carry_close(got, ref):
    """A float32 carry against the interpret-mode kernel's: 4 units in
    the last place of its magnitude."""
    assert got.dtype == torch.float32
    ref = to_np(ref)
    err = np.abs(to_np(got) - ref).max()
    assert err <= 4 * np.spacing(np.abs(ref).max()), err


def _rounded(j):
    """A JAX float32 output as the route stores it: bfloat16."""
    return jnp.asarray(j).astype(jnp.bfloat16)


# ---------------------------------------------------------------------
# (a) the plain kernels against JAX's float32 ones, interpret mode
# ---------------------------------------------------------------------

@pytest.mark.parametrize("g,offset", [(4, 0), (3, 0), (4, 1), (3, 4)])
def test_group_plain_matches_jax_bf16(g, offset):
    # measured: carry 2-3 float32 units; whites one bfloat16 unit (max
    # 0.0156 at |ref| 10.1), most planes bitwise
    j, t = _pair((256, 256), g + offset)
    fac = [1.0, 2.0, 0.5, 1.5][:g]
    thr = [0.9, 0.0, 0.5, 0.2][:g]
    masked = (True, False, True, False)[:g]
    rows_j, acc_j = pallas_conv._fused_wow_group(
        j.astype(jnp.float32), jnp.asarray(fac, jnp.float32),
        jnp.asarray(thr, jnp.float32), g, JB3, offset=offset, soft=True,
        masked=masked, interpret=True)
    _build.reset_counters()
    rows_t, acc_t = hopper_conv.fused_wow_group_plain(
        t, fac, torch.tensor(thr), g, B3SPLINE, offset=offset, soft=True,
        masked=masked)
    assert dict(_build.PLAIN_CALLS) == {"whiten_group_bf16": 1}
    assert acc_t.dtype == torch.float32
    scale = float(np.abs(to_np(acc_j)).max())
    _carry_close(rows_t[g], rows_j[g])
    for k in range(g):
        assert rows_t[k].dtype == torch.bfloat16
        assert_close_scaled(rows_t[k], _rounded(rows_j[k]), RTOL, scale)
    assert_close_scaled(acc_t, acc_j, RTOL)


@pytest.mark.parametrize("s", [4, 5])
@pytest.mark.parametrize("mode", ["soft", "unmasked"])
def test_deep_step_plain_matches_jax_bf16(s, mode):
    # measured: c_next bitwise; white one bfloat16 unit (0.0078 at |ref|
    # 3.7)
    j, t = _pair((1, 512, 512), s)
    kw = dict(scale=s, weight=1.5, soft=True, masked=mode == "soft")
    w_j, _, c_j = pallas_deep.deep_whiten_step(
        j.astype(jnp.float32), None, jnp.asarray([0.4], jnp.float32),
        sf=JB3, interpret=True, **kw)
    recon = torch.zeros(t.shape)
    _build.reset_counters()
    w_t, r_t, c_t = hopper_deep.deep_whiten_step_plain(
        t, recon, torch.tensor([0.4]), sf=B3SPLINE, **kw)
    assert dict(_build.PLAIN_CALLS) == {"whiten_step_bf16": 1}
    _carry_close(c_t, c_j)
    assert w_t.dtype == torch.bfloat16
    assert_close_scaled(w_t, _rounded(w_j), RTOL)
    # recon += the unrounded white, which rounds to the stored one
    assert r_t.dtype == torch.float32
    assert_close_scaled(r_t, w_j, 5e-6)
    np.testing.assert_array_equal(to_np(r_t.to(torch.bfloat16)),
                                  to_np(w_t))


@pytest.mark.parametrize("masked", [(True, False), (False, True)])
def test_pair_plain_matches_jax_bf16(masked):
    # measured: c_next2 one float32 unit; whites one bfloat16 unit
    j, t = _pair((1, 512, 512), 45)
    thr = [[0.4], [0.2]]
    kw = dict(scale=4, weights=(1.5, 0.5), soft=True, masked=masked)
    w1j, w2j, _, cj = pallas_deep.deep_whiten_step2(
        j.astype(jnp.float32), None, jnp.asarray(thr, jnp.float32), sf=JB3,
        interpret=True, **kw)
    _build.reset_counters()
    w1t, w2t, _, ct = hopper_deep.deep_whiten_step2_plain(
        t, None, torch.tensor(thr), sf=B3SPLINE, **kw)
    assert dict(_build.PLAIN_CALLS) == {"whiten_pair_bf16": 1}
    _carry_close(ct, cj)
    # the whites at the scale of the reconstruction they add into, the
    # frame's (a white of |ref| 3.75 is one unit, 0.0156, off)
    scale = float(np.abs(to_np(j)).max())
    assert_close_scaled(w1t, _rounded(w1j), RTOL, scale)
    assert_close_scaled(w2t, _rounded(w2j), RTOL, scale)
    # two steps from the float32 middle carry: the pair's bits
    _, _, c_mid = hopper_deep.deep_whiten_step_plain(
        t, None, torch.zeros(1), sf=B3SPLINE, scale=4, weight=1.0)
    _, _, c_two = hopper_deep.deep_whiten_step_plain(
        c_mid, None, torch.zeros(1), sf=B3SPLINE, scale=5, weight=1.0)
    assert c_mid.dtype == torch.float32 and torch.equal(c_two, ct)
