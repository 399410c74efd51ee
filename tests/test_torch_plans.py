"""The host-side launch plans of kernel A (group and deep forms) and
kernel E, and the index arithmetic of their CUDA kernels replayed in
numpy on the CPU.  Each wrapper passes its plan's grid, shared-memory
bytes (and cluster width, offset width) to the kernel's C entry, which
checks it and launches it as given, so these plans are what runs.

* ``hopper_conv.group_plan`` against the JAX package's
  ``pallas_conv._wow_group_halo``: the tile's halo is the group's reach,
  the tile fits the H100's 232448 bytes of opt-in shared memory (the
  main path's two blocks to an SM), and the tiles cover the frame.
* ``csrc/whiten_group.cu``'s tile algorithm (fill through the symmetric
  index map, then per scale the margins ``M_k = max(2hd, M_(k+1) + hd)``
  with plain offsets) replayed in float32 numpy, one IEEE operation at a
  time as the kernel rounds: the carry is bitwise the plain version's and
  the whites and ``acc`` within ``5e-6·max`` (``torch.erf``, the same
  function on both sides here).
* ``hopper_conv.step_plan``: whole rows or segments, and the residue-
  class row order visits every row once.
* ``hopper_deep.pair_plan`` and ``csrc/whiten_pair.cu``'s sector
  mapping: every torus point of every block of a cluster is loaded once,
  from the image point the torus names, in sector-complete runs of
  contiguous columns.
* ``hopper_bilateral.bilateral_plan`` (kernel F): the ring and its
  ``tm``, ``tq`` rows within the shared memory, residue-class chunks
  covering every row once, segments covering every column and their
  layout holding every tap's column, dilations past the symmetric map's
  period taken modulo it; and ``csrc/wt_ring.cuh``'s ring algorithm
  replayed in float32 torch, one operation at a time as the kernel
  rounds (``torch.exp`` on both sides here): bitwise the plain version's
  details and carry.
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import assert_close_scaled
from wavelets_tpu.ops import pallas_conv
from wavelets_tpu_torch.ops import (_build, hopper_bilateral, hopper_conv,
                                    hopper_deep, hopper_wow)
from wavelets_tpu_torch.ops.filters import B3SPLINE, TRIANGLE

SFS = {"b3": B3SPLINE, "tri": TRIANGLE}


def _reach(hw, offset, g):
    """The carry margin the group's scales need, by the kernel's rule."""
    m = 0
    for k in reversed(range(g)):
        hd = hw << (offset + k)
        m = max(2 * hd, m + hd)
    return m


@pytest.mark.parametrize("sf", list(SFS), ids=list(SFS))
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("g", list(range(1, hopper_conv.N_FAST + 1)))
def test_group_plan_halo_and_shared_memory(sf, offset, g):
    hw = SFS[sf].half_width
    plan = hopper_conv.group_plan(1, 4096, 4096, g, hw, offset)
    halo = pallas_conv._wow_group_halo(hw, offset, g)
    assert hopper_conv.group_halo(hw, offset, g) == halo
    assert halo >= _reach(hw, offset, g)
    if plan is None:
        # no tile of 16 rows fits: the scales run as deep steps
        sw = 64 + 2 * (-(-halo // 4) * 4)
        assert 4 * (2 * (16 + 2 * halo) * sw + 8 * sw) > hopper_conv.SMEM_OPTIN
        return
    assert plan.halo == halo
    assert plan.halo_cols >= halo and plan.halo_cols % 4 == 0
    sw = hopper_conv.GROUP_TILE_W + 2 * plan.halo_cols
    assert plan.smem_bytes == 4 * (2 * (plan.tile_h + 2 * halo) * sw + 8 * sw)
    assert plan.smem_bytes <= hopper_conv.SMEM_OPTIN == 232448
    # blocks to an SM: 228 KB per SM, 1 KB of it reserved per block
    per_sm = (228 * 1024) // (plan.smem_bytes + 1024)
    assert per_sm >= 1
    if (g, offset) == (hopper_conv.N_FAST, 0):
        # the main path's group: at least two blocks to an SM
        assert per_sm >= 2 and plan.tile_h == 32
    if plan.tile_h != 32:
        # taller or shorter only where the 32-row tile does not fit two
        assert hopper_conv._group_smem(32, halo, plan.halo_cols) > (
            hopper_conv.SMEM_TWO_PER_SM)


def _tile_took_bf16(g, hw, offset):
    """Whether the bfloat16 tile of the earlier design took a group: a
    tile of 64, 32 or 16 rows of 2-byte elements, halo columns in 8s,
    within the opt-in shared memory."""
    if offset + g > 20:
        return False
    halo = hopper_conv.group_halo(hw, offset, g)
    sw = 64 + 2 * (-(-halo // 8) * 8)
    return any(2 * (2 * (th + 2 * halo) * sw + 8 * sw)
               <= hopper_conv.SMEM_OPTIN for th in (64, 32, 16))


@pytest.mark.parametrize("sf", list(SFS), ids=list(SFS))
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("g", [1, 2, 3, 4])
def test_group_plan_bf16(sf, offset, g):
    # kernel A's bfloat16 group is the streamed design: group_plan with
    # 2-byte elements is stream_plan, which takes every group the
    # bfloat16 tile took, its rings within the opt-in shared memory
    hw = SFS[sf].half_width
    plan = hopper_conv.group_plan(1, 4096, 4096, g, hw, offset, 2)
    assert plan == hopper_conv.stream_plan(1, 4096, 4096, g, hw, offset)
    if _tile_took_bf16(g, hw, offset):
        assert plan is not None
    if plan is None:
        assert all(hopper_conv.stream_smem(ws, g, hw, offset)
                   > hopper_conv.SMEM_OPTIN
                   for ws in hopper_conv.STREAM_STRIPS)
        return
    assert plan.halo == pallas_conv._wow_group_halo(hw, offset, g)
    assert plan.halo_cols % 8 == 0
    assert plan.halo_cols >= hopper_conv.stream_margins(g, hw, offset)[2][0]
    assert plan.smem_bytes == hopper_conv.stream_smem(plan.strip_w, g, hw,
                                                      offset)
    assert plan.smem_bytes <= hopper_conv.SMEM_OPTIN
    if (g, offset, hw) == (4, 0, 2):
        # the merged bfloat16 path's group (JAX's plan: scales 0-3): two
        # blocks an SM, one wave that fills at least 90% of the slots
        assert plan.halo == 46
        assert plan.smem_bytes <= hopper_conv.SMEM_TWO_PER_SM
        blocks = plan.grid[0] * plan.grid[1]
        assert 0.9 * 2 * hopper_conv.H100_SMS <= blocks <= (
            2 * hopper_conv.H100_SMS)


@pytest.mark.parametrize("hw", [1, 2, 3, 8])
def test_stream_plan_takes_what_the_tile_took(hw):
    # every depth and offset the bfloat16 tile took, at any shape
    for g in range(1, 9):
        for offset in range(20):
            took = _tile_took_bf16(g, hw, offset)
            for shape in ((1, 4096, 4096), (3, 16, 16), (1, 257, 25600)):
                plan = hopper_conv.stream_plan(*shape, g, hw, offset)
                assert plan is not None or not took, (g, offset, shape)


@pytest.mark.parametrize("shape", [(1, 4096, 4096), (4, 4096, 4096),
                                   (1, 1000, 1536), (1, 257, 513),
                                   (3, 16, 16), (2, 37, 70), (1, 512, 4096),
                                   (1, 1024, 14080), (1, 256, 25600)])
@pytest.mark.parametrize("g,offset,sf", [(4, 0, "b3"), (3, 0, "b3"),
                                         (4, 1, "tri"), (3, 2, "b3"),
                                         (1, 4, "b3"), (5, 0, "tri")])
def test_stream_plan_covers_the_frame(shape, g, offset, sf):
    # strips and bands cover the frame once, the grid within its limits,
    # the rings within the shared memory, one or two blocks an SM
    B, H, W = shape
    plan = hopper_conv.stream_plan(B, H, W, g, SFS[sf].half_width, offset)
    gx, gy, gz = plan.grid
    assert gz == B and gy <= 65535
    assert gx * plan.strip_w >= W > (gx - 1) * plan.strip_w
    assert gy * plan.band_h >= H > (gy - 1) * plan.band_h
    assert plan.strip_w in hopper_conv.STREAM_STRIPS
    assert plan.band_h <= H
    assert plan.smem_bytes <= hopper_conv.SMEM_OPTIN


def test_stream_plan_refuses_rings_past_the_shared_memory():
    # the B3spline's groups (5, 2) and (7, 1) at 256x25600: no strip's
    # rings fit, so they keep the documented plain rule; (4, 1) launches
    assert hopper_conv.stream_plan(1, 256, 25600, 2, 2, 5) is None
    assert hopper_conv.stream_plan(1, 256, 25600, 1, 2, 7) is None
    assert hopper_conv.group_plan(1, 256, 25600, 1, 2, 4, 2) is not None
    # float32 keeps the tile
    assert isinstance(hopper_conv.group_plan(1, 4096, 4096, 3, 2, 0),
                      hopper_conv.GroupPlan)


@pytest.mark.parametrize("shape", [(1, 4096, 4096), (1, 1000, 1536),
                                   (1, 257, 513), (3, 16, 16), (2, 37, 70)])
@pytest.mark.parametrize("offset", [0, 1])
def test_group_plan_covers_the_frame(shape, offset):
    B, H, W = shape
    plan = hopper_conv.group_plan(B, H, W, 3, 2, offset)
    gx, gy, gz = plan.grid
    tw = hopper_conv.GROUP_TILE_W
    assert gz == B
    assert gx * tw >= W > (gx - 1) * tw
    assert gy * plan.tile_h >= H > (gy - 1) * plan.tile_h


def _fold(a, taps, axis, d, lo, hi, other):
    """x*t0 + sum_j t_j*(l + r) along ``axis`` of ``a`` (float32, one
    rounding per operation) for the points lo..hi-1 of that axis (an
    offset into ``a``) and the slice ``other`` of the other axis."""
    hw = (len(taps) - 1) // 2
    t = np.asarray(taps[hw:], np.float32)

    def take(s):
        idx = slice(lo + s, hi + s)
        return a[idx, other] if axis == 0 else a[other, idx]

    out = take(0) * t[0]
    for j in range(1, hw + 1):
        out = out + t[j] * (take(-j * d) + take(j * d))
    return out


def _whiten(c, lp, fac, thr, masked):
    lp = np.sqrt(np.where(lp <= 0, np.float32(1e-15), lp))
    if masked and thr != 0:
        c = c * torch.erf(torch.from_numpy(np.abs(c / thr))).numpy()
    return c * (np.float32(fac) / lp)


def _emulate_group(x, plan, g, taps, offset, facs, thrs, masked):
    """whiten_group.cu's per-tile algorithm on one (H, W) frame."""
    H, W = x.shape
    hw = (len(taps) - 1) // 2
    TH, R, Rc = plan.tile_h, plan.halo, plan.halo_cols
    TW = hopper_conv.GROUP_TILE_W

    def sym(k, n):   # numpy's periodic symmetric index map
        p = np.mod(k, 2 * n)
        return np.where(p < n, p, 2 * n - 1 - p)

    whites = [np.zeros((H, W), np.float32) for _ in range(g)]
    carry = np.zeros((H, W), np.float32)
    acc = np.zeros((H, W), np.float32)
    for h0 in range(0, H, TH):
        for w0 in range(0, W, TW):
            rows = sym(np.arange(h0 - R, h0 + TH + R), H)
            cols = sym(np.arange(w0 - Rc, w0 + TW + Rc), W)
            X = x[np.ix_(rows, cols)].astype(np.float32)
            a = None
            for k in range(g):
                d = 1 << (offset + k)
                hd = hw * d
                cm = max(hd, _reach(hw, offset + k + 1, g - k - 1))
                mk = cm + hd
                # chain smooth: rows fold on rows [-cm, TH+cm), columns
                # [-mk, TW+mk); cols fold on [-cm, TW+cm)
                T = np.zeros_like(X)
                T[R - cm:R + TH + cm, Rc - mk:Rc + TW + mk] = _fold(
                    X, taps, 0, d, R - cm, R + TH + cm,
                    slice(Rc - mk, Rc + TW + mk))
                C = np.zeros_like(X)
                C[R - cm:R + TH + cm, Rc - cm:Rc + TW + cm] = _fold(
                    T, taps, 1, d, Rc - cm, Rc + TW + cm,
                    slice(R - cm, R + TH + cm))
                Dt = X.copy()
                sl = (slice(R - hd, R + TH + hd), slice(Rc - hd, Rc + TW + hd))
                Dt[sl] = X[sl] - C[sl]
                sq = Dt * Dt
                P = np.zeros_like(X)
                P[R:R + TH, Rc - hd:Rc + TW + hd] = _fold(
                    sq, taps, 0, d, R, R + TH, slice(Rc - hd, Rc + TW + hd))
                lp = _fold(P, taps, 1, d, Rc, Rc + TW, slice(R, R + TH))
                v = _whiten(Dt[R:R + TH, Rc:Rc + TW], lp, facs[k], thrs[k],
                            masked[k])
                a = v if a is None else a + v
                hh, ww = min(TH, H - h0), min(TW, W - w0)
                whites[k][h0:h0 + hh, w0:w0 + ww] = v[:hh, :ww]
                X = C
            carry[h0:h0 + hh, w0:w0 + ww] = X[R:R + hh, Rc:Rc + ww]
            acc[h0:h0 + hh, w0:w0 + ww] = a[:hh, :ww]
    return whites, carry, acc


@pytest.mark.parametrize("shape,offset,sf", [
    ((37, 70), 0, "b3"),     # ragged tiles, W not a multiple of 4
    ((16, 16), 0, "b3"),     # a frame smaller than the halo of 22
    ((80, 72), 1, "tri"),
    ((70, 130), 1, "b3"),    # one block to an SM, halo 44
])
def test_group_tile_algorithm_replayed(shape, offset, sf):
    spec = SFS[sf]
    x = (np.random.default_rng(11).normal(size=shape) * 3 + 10).astype(
        np.float32)
    facs, masked = (2.0, 1.0, 0.5), (True, True, False)
    thrs = (0.3, 0.0, 0.01)
    plan = hopper_conv.group_plan(1, *shape, 3, spec.half_width, offset)
    whites, carry, acc = _emulate_group(x, plan, 3, spec.taps, offset, facs,
                                        thrs, masked)
    rows, acc_p = hopper_conv.fused_wow_group_plain(
        torch.from_numpy(x), list(facs), torch.tensor(thrs), 3, spec,
        offset=offset, masked=masked)
    assert np.array_equal(carry, rows[3].numpy())
    for k in range(3):
        assert_close_scaled(torch.from_numpy(whites[k]), rows[k], 5e-6)
    assert_close_scaled(torch.from_numpy(acc), acc_p, 5e-6)


def _replay_stream(x, plan, g, taps, offset, facs, thrs, masked, soft):
    """whiten_group.cu's streamed group on a (B, H, W) bfloat16 stack,
    in float32 torch as the kernel computes it (float32 inside: only the
    whites round, on store; carry and acc float32).  Per block (a
    strip of columns, a band of rows, a frame) the input rows of virtual
    row ``a0 + q`` (``a0``: the band's first row less the halo) enter the
    input's ring through the symmetric map, 8 a step.  Per step and
    scale k: the rows fold and cols fold of 8 rows of carry_k (those
    that scale k - 1 wrote this step, less ``hd``) into carry_(k+1)'s
    ring, the detail and its square into sq_k's ring; then the power
    smooth of the 8 rows ``hd`` behind, the whitening and the float32
    acc ring.  Row q
    sits in slot ``q mod rows`` of a ring; rings start as NaN, so a value
    read before it was written, or after it was overwritten, shows."""
    bf = torch.bfloat16
    B, H, W = x.shape
    hw = (len(taps) - 1) // 2
    t = torch.tensor(taps[hw:], dtype=torch.float32)
    rs = hopper_conv.STREAM_ROWS
    hd, ec, ecar = hopper_conv.stream_margins(g, hw, offset)
    eq = [hopper_conv._even(h) for h in hd]
    R, rc, ws, hb = plan.halo, plan.halo_cols, plan.strip_w, plan.band_h
    rows_c = ([2 * hd[0] + 2 * rs] + [2 * h + rs for h in hd[1:]]
              + [hd[g - 1] + rs])
    rows_q = [2 * h + rs for h in hd]
    rows_a = R - 2 * hd[0] + rs
    xs = x.float()
    whites = torch.full((g, B, H, W), float("nan"))
    carry = torch.full((B, H, W), float("nan"))
    acc = torch.full((B, H, W), float("nan"))

    def sym(k, n):
        p = np.mod(k, 2 * n)
        return torch.from_numpy(np.where(p < n, p, 2 * n - 1 - p))

    def vfold(ring, q, d, lo, hi):
        # rows q (8 of them) folded at dilation d, columns lo..hi-1
        n = ring.shape[0]
        cols = slice(rc + lo, rc + hi)
        out = ring[q % n][:, cols] * t[0]
        for j in range(1, hw + 1):
            out = out + t[j] * (ring[(q - j * d) % n][:, cols]
                                + ring[(q + j * d) % n][:, cols])
        return out

    def hfold(a, d, lo, hi):
        # columns lo..hi-1 of rows a (origin rc), dilation d
        out = a[:, rc + lo:rc + hi] * t[0]
        for j in range(1, hw + 1):
            out = out + t[j] * (a[:, rc + lo - j * d:rc + hi - j * d]
                                + a[:, rc + lo + j * d:rc + hi + j * d])
        return out

    def put(dst, gh, h0, h1, w0, vals):
        for i in np.nonzero((gh >= h0) & (gh < h1))[0]:
            n = min(ws, W - w0)
            dst[gh[i], w0:w0 + n] = vals[i, :n]

    width = ws + 2 * rc
    r8 = np.arange(rs)
    for b in range(B):
        for h0 in range(0, H, hb):
            for w0 in range(0, W, ws):
                h1, a0 = min(h0 + hb, H), h0 - R
                steps = -(-(h1 - h0 + 2 * R) // rs)
                cr = [torch.full((n, width), float("nan")) for n in rows_c]
                qr = [torch.full((n, width), float("nan")) for n in rows_q]
                ar = torch.full((rows_a, ws), float("nan"))
                cols = sym(np.arange(w0 - rc, w0 + ws + rc), W)

                def fetch(step):
                    q = step * rs + r8
                    cr[0][q % rows_c[0]] = xs[b][sym(a0 + q, H)][:, cols]

                fetch(0)
                for step in range(steps):
                    if step + 1 < steps:
                        fetch(step + 1)
                    for k in range(g):
                        # this step's c_next rows of scale k
                        d = 1 << (offset + k)
                        u = step * rs - hd[0] * ((2 << k) - 1) + r8
                        tmp = torch.full((rs, width), float("nan"))
                        tmp[:, rc - ecar[k]:rc + ws + ecar[k]] = vfold(
                            cr[k], u, d, -ecar[k], ws + ecar[k])
                        c = hfold(tmp, d, -ec[k], ws + ec[k])
                        cr[k + 1][u % rows_c[k + 1],
                                  rc - ec[k]:rc + ws + ec[k]] = c
                        e = (cr[k][u % rows_c[k]][
                            :, rc - eq[k]:rc + ws + eq[k]]
                            - c[:, ec[k] - eq[k]:ec[k] + ws + eq[k]])
                        qr[k][u % rows_q[k], rc - eq[k]:rc + ws + eq[k]] = (
                            e * e)
                        if k == g - 1:
                            put(carry[b], a0 + u, h0, h1, w0,
                                c[:, ec[k]:ec[k] + ws])
                        p = u - hd[k]
                        tmp = torch.full((rs, width), float("nan"))
                        tmp[:, rc - eq[k]:rc + ws + eq[k]] = vfold(
                            qr[k], p, d, -eq[k], ws + eq[k])
                        lp = hfold(tmp, d, 0, ws)
                        e = (cr[k][p % rows_c[k]][:, rc:rc + ws]
                             - cr[k + 1][p % rows_c[k + 1]][:, rc:rc + ws])
                        lp = torch.sqrt(torch.where(lp <= 0, 1e-15, lp))
                        if masked[k] and thrs[k] != 0:
                            thr = torch.tensor(thrs[k], dtype=torch.float32)
                            m = (torch.erf(torch.abs(e / thr)) if soft
                                 else (torch.abs(e) > thr).float())
                            e = e * m
                        v = e * torch.div(torch.tensor(facs[k]), lp)
                        put(whites[k, b], a0 + p, h0, h1, w0, v)
                        if k > 0:
                            v = ar[p % rows_a] + v
                        ar[p % rows_a] = v
                        if k == g - 1:
                            put(acc[b], a0 + p, h0, h1, w0, v)
    return ([w.to(bf) for w in whites] + [carry]), acc


@pytest.mark.parametrize("shape,g,offset,sf,band", [
    ((1, 37, 70), 4, 0, "b3", None),   # W not a multiple of 8, ragged
    ((1, 16, 16), 4, 0, "b3", None),   # a frame smaller than the halo 46
    ((1, 80, 72), 4, 1, "tri", None),
    ((1, 100, 300), 4, 0, "b3", (64, 40)),   # bands end at rows 40, 80
    ((1, 61, 45), 3, 0, "b3", (32, 16)),
    ((2, 37, 70), 3, 0, "b3", None),   # a batch of 2
    ((1, 50, 91), 3, 2, "tri", None),
])
def test_group_stream_algorithm_replayed(shape, g, offset, sf, band):
    import dataclasses
    spec = SFS[sf]
    x = torch.from_numpy((np.random.default_rng(g + offset).normal(
        size=shape) * 3 + 10).astype(np.float32)).to(torch.bfloat16)
    facs = (2.0, 1.0, 0.5, 1.5)[:g]
    masked = (True, True, False, True)[:g]
    thrs = (0.9, 0.0, 0.01, 0.2)[:g]
    plan = hopper_conv.stream_plan(*shape, g, spec.half_width, offset)
    if band is not None:
        ws, hb = band
        plan = dataclasses.replace(
            plan, strip_w=ws, band_h=hb,
            grid=(-(-shape[2] // ws), -(-shape[1] // hb), shape[0]))
    for soft in (True, False):
        rows, acc = _replay_stream(x, plan, g, spec.taps, offset, facs, thrs,
                                   masked, soft)
        ref, ref_acc = hopper_conv.fused_wow_group_plain(
            x, list(facs), torch.tensor(thrs), g, spec, offset=offset,
            soft=soft, masked=masked)
        for got, want in zip(rows + [acc], list(ref) + [ref_acc]):
            assert torch.equal(got, want)


@pytest.mark.parametrize("need_cube", [True, False])
def test_group_without_a_tile_runs_deep_steps(need_cube):
    # the B3spline at offset 2, g = 3: no tile fits, so the wrapper runs
    # one deep step per scale, on the CPU as on the card
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 48, 40))
                         .astype(np.float32))
    assert hopper_conv.group_plan(2, 48, 40, 3, 2, 2) is None
    args = ([1.0, 2.0, 0.5], torch.tensor([[0.3, 0.1], [0.0, 0.0],
                                          [0.2, 0.05]]), 3, B3SPLINE)
    kw = dict(offset=2, soft=False, masked=(True, False, True),
              need_cube=need_cube)
    _build.reset_counters()
    rows, acc = hopper_conv.fused_wow_group(x, *args, **kw)
    assert dict(_build.PLAIN_CALLS) == {"whiten_step": 3}
    ref, ref_acc = hopper_conv.fused_wow_group_plain(x, *args, **kw)
    assert len(rows) == len(ref)
    assert all(torch.equal(a, b) for a, b in zip(rows, ref))
    assert torch.equal(acc, ref_acc)
    assert all(acc.data_ptr() != r.data_ptr() for r in rows)


@pytest.mark.parametrize("W,D,hw,seg", [
    (4096, 512, 2, 0), (513, 512, 2, 0), (29038, 1, 2, 0),
    (29039, 1, 2, hopper_conv.STEP_SEGS[0]),
    (29057, 4, 2, hopper_conv.STEP_SEGS[0]), (60000, 4096, 1,
                                          hopper_conv.STEP_SEGS[0])])
def test_step_plan(W, D, hw, seg):
    plan = hopper_conv.step_plan(1, 5, W, D, hw)
    assert plan.seg == seg
    # the dynamic bytes leave room for the kernel's static tap-row table
    assert (plan.smem_bytes + hopper_conv.STEP_STATIC_SMEM
            <= hopper_conv.SMEM_OPTIN)
    if seg:
        assert plan.smem_bytes == 4 * (2 * seg + 2 * hw * D)
        assert plan.grid[1] * seg >= W > (plan.grid[1] - 1) * seg
    assert plan.index_bits == 32


def test_step_plan_refuses_a_halo_beyond_the_shared_memory():
    # a contiguous hw·D halo of 65536 columns passes the shared memory:
    # the segment's buffer then holds the 2hw+1 tap windows side by side,
    # which always fit; what the plan refuses is a reach past 32-bit
    # index math
    plan = hopper_conv.step_plan(1, 8, 40000, 1 << 14, 2)
    assert 4 * (2 * plan.seg + 2 * 2 * (1 << 14)) > hopper_conv.SMEM_OPTIN
    assert plan.seg == 4096
    assert plan.smem_bytes == 4 * (2 + 2 * 2) * 4096 <= hopper_conv.SMEM_OPTIN
    with pytest.raises(ValueError, match="32-bit"):
        hopper_conv.step_plan(1, 2 ** 29, 8, 2 ** 29, 4)
    with pytest.raises(ValueError, match="32-bit"):
        hopper_conv.step_plan(1, 2 ** 30, 1, 1, 2)
    assert hopper_conv.step_plan(3000, 1000, 1000, 1, 2).index_bits == 64


@pytest.mark.parametrize("H,D", [(4096, 8), (4096, 512), (257, 8),
                                 (257, 512), (250, 256), (7, 1), (40, 16)])
def test_step_rows_in_residue_class_order_cover_every_row(H, D):
    plan = hopper_conv.step_plan(1, H, 64, D, 2)
    seen = []
    for i in range(plan.grid[0]):
        if D < H:
            P = -(-H // D)
            h = (i % P) * D + i // P
        else:
            h = i
        if h < H:
            seen.append(h)
    assert sorted(seen) == list(range(H))


def _torus_pos(u, M, r, D):
    return r + u * D if u < M else (D - 1 - r) + (2 * M - 1 - u) * D


@pytest.mark.parametrize("H,W,s", [(4096, 4096, 7), (512, 512, 4),
                                   (64, 96, 3), (40, 56, 2), (16, 24, 0),
                                   (16, 32, 1), (128, 256, 4), (64, 64, 5)])
def test_pair_cluster_sectors(H, W, s):
    plan = hopper_deep.pair_plan(1, H, W, s)
    D = 1 << s
    assert plan.cluster == min(8, max(1, D // 2))
    assert plan.smem_bytes == 16 * (2 * H // D) * (2 * W // D) <= 232448
    assert plan.grid[0] % plan.cluster == 0
    assert hopper_deep.can_deep2(torch.zeros(1, H, W), B3SPLINE, s)
    cw, M, N = plan.cluster, H // D, W // D
    Lc, items, per = 2 * N, 4 * M * N, 256 // cw
    r = plan.grid[1] - 1           # the last row class pair
    for q0 in range(0, plan.grid[0], cw):
        written = np.zeros((cw, 2 * M, 2 * N), int)
        for rank in range(cw):
            for slot in range(per):
                for it in range(rank * per + slot, items, cw * per):
                    u, v = divmod(it, Lc)
                    base = (q0 + v * D if v < N else
                            (D - q0 - cw) + (2 * N - 1 - v) * D)
                    cols = [base + e for e in range(cw)]
                    if cw == 8:   # one whole, aligned 32-byte sector
                        assert base % 8 == 0
                    for e, col in enumerate(cols):
                        owner = e if v < N else cw - 1 - e
                        q = q0 + owner
                        assert col == _torus_pos(v, N, q, D)
                        written[owner, u, v] += 1
                        assert 0 <= col < W
                        assert 0 <= _torus_pos(u, M, r, D) < H
        assert (written == 1).all()


def _sym(k, n):
    p = np.mod(k, 2 * n)
    return np.where(p < n, p, 2 * n - 1 - p)


def _ring_columns(plan, by, D, hw, W):
    """The image column each shared index of a ring row holds (before and
    after the symmetric map), as wt_ring.cuh's load_row lays them out for
    the true dilation ``D``."""
    D = hopper_bilateral.map_step(D, W)
    S = min(D, plan.seg)
    v = np.arange(hopper_bilateral.ring_span(hw, D, plan.seg))
    q = v // S
    raw = by * plan.seg + (q - hw) * D + (v - q * S)
    return raw, _sym(raw, W)


def _ring_blocks(plan, H, D):
    """(class, first row index, end) of every block row of the grid that
    has rows, as bilateral_ring picks them for the true dilation ``D``."""
    n_cls = min(D, H)
    D = hopper_bilateral.map_step(D, H)
    for bx in range(plan.grid[0]):
        cls, i0 = bx % n_cls, (bx // n_cls) * plan.rows
        P = -(-(H - cls) // D)
        if i0 < P:
            yield cls, i0, min(i0 + plan.rows, P)


@pytest.mark.parametrize("shape", [(1, 4096, 4096), (1, 512, 512),
                                   (2, 37, 70), (1, 8, 9000), (1, 257, 513),
                                   (3, 5, 3)])
@pytest.mark.parametrize("s", [0, 1, 3, 4, 6, 9, 12])
@pytest.mark.parametrize("hw", [1, 2, 4])
def test_bilateral_plan(shape, s, hw):
    B, H, W = shape
    D = 1 << s
    plan = hopper_bilateral.bilateral_plan(B, H, W, D, hw)
    span = hopper_bilateral.ring_span(hw, D, plan.seg)
    assert plan.smem_bytes == hopper_bilateral.ring_smem(hw, D, plan.seg)
    # 2hw+1 slots, each a span started up to 3 floats in on a 16-byte
    # boundary, then the tm and tq rows
    assert plan.smem_bytes >= 4 * ((2 * hw + 1) * (span + 3) + 2 * span)
    assert plan.smem_bytes % 16 == 8 * span % 16
    assert plan.smem_bytes <= hopper_conv.SMEM_OPTIN == 232448
    # narrower only where no wider segment fits two blocks to an SM
    wider = [w for w in ((W,) if W <= 4096 else ()) + (4096, 2048, 1024, 512,
                                                      256)
             if plan.seg < w <= W]
    assert all(hopper_bilateral.ring_smem(hw, D, w)
               > hopper_conv.SMEM_TWO_PER_SM for w in wider)
    assert plan.grid[2] == B
    assert plan.index_bits == 32
    # every row once, in chunks of one residue class
    Dr = hopper_bilateral.map_step(D, H)
    rows = [cls + i * Dr for cls, i0, i1 in _ring_blocks(plan, H, D)
            for i in range(i0, i1)]
    assert sorted(rows) == list(range(H))
    assert 1 <= plan.rows <= hopper_bilateral.RING_ROWS
    # every column once, and each tap's column in the segment's layout
    gy = plan.grid[1]
    assert gy * plan.seg >= W > (gy - 1) * plan.seg
    S = min(D, plan.seg)
    for by in {0, gy - 1}:
        raw, mapped = _ring_columns(plan, by, D, hw, W)
        assert ((0 <= mapped) & (mapped < W)).all()
        u = np.arange(min(plan.seg, W - by * plan.seg))
        for dx in range(-hw, hw + 1):
            want = _sym(by * plan.seg + u + dx * D, W)
            assert (mapped[(dx + hw) * S + u] == want).all()


@pytest.mark.parametrize("n", [1, 2, 5, 37, 4096])
@pytest.mark.parametrize("s", [0, 3, 12, 13, 27, 40, 62])
def test_map_step_names_the_same_taps(n, s):
    # the symmetric map's period is 2n: the kernel's dilation names the
    # true one's taps, residue classes and segment layout in 32 bits
    D = 1 << s
    step = hopper_bilateral.map_step(D, n)
    assert step == D if D < 2 * n else 2 * n <= step < 4 * n
    k = np.arange(-3 * n, 4 * n).astype(object)   # Python ints: no overflow
    for j in range(-4, 5):
        assert (_sym(k + j * step, n) == _sym(k + j * D, n)).all()
    assert min(step, n) == min(D, n)          # the residue classes
    if D >= n:                                # one row a class
        assert (-(-(n - np.arange(n)) // step) == 1).all()
    for seg in {1, n // 2 + 1, n}:            # the segment layout's S
        assert min(step, seg) == min(D, seg)


def _load_span(d_off, g_off, c0, length, W):
    """wt_ring.cuh's load_span on float offsets mod 16 bytes: ``d_off``
    of ``dst``, ``g_off`` of ``row`` → (column each index gets, copies of
    each index, shared offsets of the 16-byte copies, their global
    offsets)."""
    lo = min(max(-c0, 0), length)
    hi = max(min(W - c0, length), lo)
    col = np.full(length, -1)
    hits = np.zeros(length, int)
    for v in range(lo + length - hi):         # reflected, one by one
        u = v if v < lo else hi + (v - lo)
        col[u] = _sym(c0 + u, W)
        hits[u] += 1
    d, g, n = d_off + lo, g_off + c0 + lo, hi - lo
    head, n4 = n, 0
    if (d - g) % 4 == 0:
        head = min(n, (4 - d % 4) % 4)
        n4 = (n - head) // 4
    starts = lo + head + 4 * np.arange(n4)
    for u0 in starts:                          # 16 bytes a copy
        col[u0:u0 + 4] = c0 + np.arange(u0, u0 + 4)
        hits[u0:u0 + 4] += 1
    for v in range(n - 4 * n4):                # the head and the tail
        u = lo + (v if v < head else v + 4 * n4)
        col[u] = c0 + u
        hits[u] += 1
    return col, hits, d_off + starts, g_off + c0 + starts


@pytest.mark.parametrize("c0,length,W", [
    (-2, 4100, 4096), (-8, 4112, 4096), (0, 2048, 4096), (-8, 70, 9),
    (5, 16, 70), (60, 16, 70), (-100, 16, 13), (-3, 40, 37)])
@pytest.mark.parametrize("d_off,g_off", [(0, 0), (2, 2), (1, 3), (3, 0)])
def test_ring_load_span(c0, length, W, d_off, g_off):
    col, hits, d16, g16 = _load_span(d_off, g_off, c0, length, W)
    assert (hits == 1).all()
    assert (col == _sym(c0 + np.arange(length), W)).all()
    assert (d16 % 4 == 0).all() and (g16 % 4 == 0).all()
    # where index 0's shared and global addresses agree mod 16 bytes, at
    # most 3 + 3 of the frame's columns go one by one
    inside = int(((c0 + np.arange(length) >= 0)
                  & (c0 + np.arange(length) < W)).sum())
    if (d_off - g_off - c0) % 4 == 0:
        assert inside - 4 * len(d16) <= 6


@pytest.mark.parametrize("W", [4096, 512, 9000])
@pytest.mark.parametrize("s", [0, 1, 2, 3, 7, 12])
def test_ring_rows_start_where_the_frame_is_16_byte_aligned(W, s):
    # a ring row starts c0 mod 4 floats past a 16-byte boundary, so on a
    # frame of rows a multiple of 16 bytes every block's in-frame columns
    # copy 16 bytes at a time
    hw = 2
    D = 1 << s
    plan = hopper_bilateral.bilateral_plan(1, 64, W, D, hw)
    span = hopper_bilateral.ring_span(hw, D, plan.seg)
    stride = -(-(span + 3) // 4) * 4
    for by in range(plan.grid[1]):
        w0 = by * plan.seg
        c0 = w0 - hw * hopper_bilateral.map_step(D, W)
        pad = c0 % 4
        for slot in range(2 * hw + 1):
            base = slot * stride + pad
            assert base + span <= (slot + 1) * stride
            if D < plan.seg:
                pieces = [(base, c0, span)]
            else:
                pieces = [(base + q * plan.seg, w0 + (q - hw) * D, plan.seg)
                          for q in range(2 * hw + 1)]
            for d_off, c, n in pieces:
                assert (d_off - c) % 4 == 0   # the row itself is aligned
                col, hits, _, _ = _load_span(d_off % 4, 0, c, n, W)
                assert (hits == 1).all()


def test_bilateral_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="half width"):
        hopper_bilateral.bilateral_plan(1, 64, 64, 1, 5)
    with pytest.raises(ValueError, match="dilation"):
        hopper_bilateral.bilateral_plan(1, 64, 64, 1 << 63, 2)
    with pytest.raises(ValueError, match="32-bit"):
        hopper_bilateral.bilateral_plan(1, 1 << 29, 1, 1 << 29, 2)
    # the scale does not bound the plan: a dilation past the map's period
    # runs as its remainder
    assert (hopper_bilateral.bilateral_plan(1, 64, 64, 1 << 40, 2)
            == hopper_bilateral.bilateral_plan(1, 64, 64, 256, 2))
    assert hopper_bilateral.bilateral_plan(3000, 1000, 1000, 1,
                                           2).index_bits == 64


def _replay_ring_scale(carry, sf, D, sig2, scl, plan):
    """wt_ring.cuh's bilateral_ring on one (H, W) float32 frame, block by
    block and row by row, each step one float32 torch operation in the
    kernel's order → (c_next, detail)."""
    H, W = carry.shape
    hw = sf.half_width
    N = 2 * hw + 1
    f32 = torch.float32
    t = [torch.tensor(sf.taps[hw + j], dtype=f32) for j in range(hw + 1)]
    kern = torch.from_numpy(sf.kernel_nd(2)).to(f32)
    sig2 = torch.tensor(sig2, dtype=f32)
    scl = torch.tensor(scl, dtype=f32)
    S = min(D, plan.seg)
    c_next = torch.full_like(carry, float("nan"))
    detail = torch.full_like(carry, float("nan"))
    written = np.zeros((H, W), int)
    for cls, i0, i1 in _ring_blocks(plan, H, D):
        for by in range(plan.grid[1]):
            w0 = by * plan.seg
            u = torch.arange(min(plan.seg, W - w0))
            cols = torch.from_numpy(_ring_columns(plan, by, D, hw, W)[1])
            Dr = hopper_bilateral.map_step(D, H)
            h = cls + i0 * Dr
            ring = [carry[int(_sym(h + (j - hw) * Dr, H))][cols]
                    for j in range(N)]
            slot0 = 0
            for i in range(i0, i1):
                ro = [ring[(slot0 + j) % N] for j in range(N)]
                c = ro[hw]
                m, q = c * t[0], (c * c) * t[0]
                for j in range(1, hw + 1):
                    lo, hi = ro[hw - j], ro[hw + j]
                    m = m + t[j] * (lo + hi)
                    q = q + t[j] * (lo * lo + hi * hi)
                vc = hw * S + u
                mean, m2 = m[vc] * t[0], q[vc] * t[0]
                for j in range(1, hw + 1):
                    mean = mean + t[j] * (m[vc - j * S] + m[vc + j * S])
                    m2 = m2 + t[j] * (q[vc - j * S] + q[vc + j * S])
                vari = m2 - mean * mean
                vari = torch.where(vari <= 0, torch.tensor(1e-20, dtype=f32),
                                   vari)
                iv = torch.div(torch.tensor(0.5, dtype=f32),
                               (vari * sig2) * scl)
                cc = c[vc]
                acc = cc * kern[hw, hw]
                nrm = torch.full_like(cc, float(kern[hw, hw]))
                for ty in range(N):
                    for tx in range(N):
                        k = kern[N - 1 - ty, N - 1 - tx]
                        if (ty, tx) == (hw, hw) or float(k) == 0.0:
                            continue
                        sh = ro[N - 1 - ty][(N - 1 - tx) * S + u]
                        diff = cc - sh
                        w = k * torch.exp(-(diff * diff) * iv)
                        nrm = nrm + w
                        acc = acc + w * sh
                cn = acc / nrm
                c_next[h, w0 + u] = cn
                detail[h, w0 + u] = cc - cn
                written[h, w0 + u.numpy()] += 1
                if i + 1 < i1:
                    ring[slot0] = carry[int(_sym(h + (hw + 1) * Dr, H))][cols]
                    slot0 = (slot0 + 1) % N
                    h += Dr
    assert (written == 1).all()
    return c_next, detail


@pytest.mark.parametrize("shape,offset,seg", [
    ((37, 70), 0, None), ((37, 70), 1, None), ((37, 70), 2, None),
    ((37, 70), 3, 16),       # segments with a contiguous halo, then windows
    ((37, 70), 4, None), ((37, 70), 5, 24), ((37, 70), 6, None),
    ((9, 13), 2, 4),         # H, W below hw·D: the taps reflect many times
    ((20, 33), 0, 8),
    ((9, 13), 27, None),     # dilations past the map's period, 2H and 2W
    ((20, 33), 30, 8), ((37, 70), 58, None),
])
@pytest.mark.parametrize("sf", ["b3", "tri"])
def test_ring_algorithm_replayed(shape, offset, seg, sf):
    spec = SFS[sf]
    x = torch.from_numpy(np.random.default_rng(offset).normal(size=shape)
                         .astype(np.float32))
    variances, scaling = (2.25, 1.0, 0.25), offset % 2 == 1
    cur, rows = x, []
    for k in range(3):
        D = 1 << (offset + k)
        plan = hopper_bilateral.bilateral_plan(1, *shape, D, spec.half_width)
        if seg is not None:
            plan = hopper_bilateral.BilateralPlan(
                plan.rows, seg, plan.smem_bytes,
                (plan.grid[0], -(-shape[1] // seg), 1), plan.index_bits)
        cur_next, det = _replay_ring_scale(
            cur, spec, D, variances[k],
            float(offset + k + 1) if scaling else 1.0, plan)
        rows.append(det)
        cur = cur_next
    rows.append(cur)
    want = hopper_bilateral.fused_bilateral_group_plain(
        x, 3, spec, variances, offset, scaling)
    got = torch.stack(rows)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------
# The row-buffer pass (csrc/wt_step.cuh) of kernels A, C and G, kernel
# C's buffers and kernel G's two plans
# ---------------------------------------------------------------------

def _step_plan_ok(p, hw, B, H, W, D):
    """csrc/wt_step.cuh::step_plan_ok: what the C entries of kernels A, C
    and G check before they launch a row-buffer pass."""
    if not (H < 2 ** 30 and W < 2 ** 30 and (p.seg == 0 or p.seg < W)):
        return False
    Dr, Dc = hopper_conv.map_step(D, H), hopper_conv.map_step(D, W)
    S = Dc if p.seg == 0 else min(Dc, p.seg)
    need = 8 * W if p.seg == 0 else 4 * (2 * p.seg + 2 * hw * S)
    frames = min(B, 65535)
    return (H + hw * Dr < 2 ** 31 and W + p.seg + hw * Dc < 2 ** 31
            and p.grid[0] == (H if Dr >= H else Dr * -(-H // Dr))
            and p.grid[1] == (1 if p.seg == 0 else -(-W // p.seg))
            and p.grid[1] <= 65535 and p.grid[2] == frames
            and need <= p.smem_bytes
            <= hopper_conv.SMEM_OPTIN - hopper_conv.STEP_STATIC_SMEM
            and (p.index_bits == 64 or frames * H * W < 2 ** 31))


def _ring_plan_ok(p, hw, H, W, D):
    """csrc/wt_ring.cuh::ring_plan_ok plus the frames and offset width
    that kernel G's C entry checks."""
    n_cls, P = min(D, H), -(-H // D)
    return (H < 2 ** 30 and W < 2 ** 30 and 1 <= p.rows <= P
            and 1 <= p.seg <= W
            and p.grid[0] == n_cls * -(-P // p.rows) < 2 ** 31
            and p.grid[1] == -(-W // p.seg) <= 65535
            and hopper_bilateral.ring_smem(hw, D, p.seg) <= p.smem_bytes
            <= hopper_conv.SMEM_OPTIN
            and H + (hw + 1) * hopper_conv.map_step(D, H) < 2 ** 31
            and W + p.seg + hw * hopper_conv.map_step(D, W) < 2 ** 31)


def _step_rows(plan, H, D):
    """The image row of every block row of the grid, in launch order, as
    step_pass picks it (residue classes of the rows' dilation)."""
    Dr = hopper_conv.map_step(D, H)
    P = -(-H // Dr)
    for bx in range(plan.grid[0]):
        h = (bx % P) * Dr + bx // P if Dr < H else bx
        if h < H:
            yield h


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("smooth_only", [False, True])
def test_decompose_buffers(level, smooth_only):
    # kernel C's buffer choice, as its C entry checks it and as the rows
    # fold needs it: no scale writes what it reads, x is only read, the
    # last scale lands in the carry row, no written detail is written
    # again, one spare plane from g = 2 on
    bufs = hopper_conv.decompose_buffers(level, smooth_only)
    carry = 0 if smooth_only else level
    assert len(bufs) == level
    assert bufs[0][0] == "x" and bufs[-1][1] == carry
    written = set()
    for k, (src, dst, det) in enumerate(bufs):
        assert src != dst and dst != "x" and det != "x"
        assert det is None if smooth_only else det == k
        assert det not in (src, dst)
        if k:
            assert src == bufs[k - 1][1]
        assert dst not in written and det not in written
        if det is not None:
            written.add(det)
    assert any("spare" in b for b in bufs) == (level > 1)


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("smooth_only", [False, True])
@pytest.mark.parametrize("offset", [0, 3])
def test_decompose_buffers_replayed(level, smooth_only, offset):
    # the chain through the named buffers, each scale's source read whole
    # before its outputs are stored, as a launch's blocks may: the cube is
    # bitwise the plain version's and x is unchanged
    x = torch.from_numpy(np.random.default_rng(level).normal(size=(2, 19, 23))
                         .astype(np.float32))
    x0 = x.clone()
    n_rows = 1 if smooth_only else level + 1
    out = torch.full((n_rows,) + tuple(x.shape), float("nan"))
    spare = torch.full_like(x, float("nan"))

    def buf(name):
        return x if name == "x" else spare if name == "spare" else out[name]

    for k, (src, dst, det) in enumerate(
            hopper_conv.decompose_buffers(level, smooth_only)):
        cur = buf(src).clone()
        c_next = hopper_conv.smooth(cur, B3SPLINE, scale=offset + k,
                                    axes=(-2, -1))
        buf(dst).copy_(c_next)
        if det is not None:
            buf(det).copy_(cur - c_next)
    want = hopper_conv.fused_group_plain(x, level, B3SPLINE, offset,
                                         smooth_only)
    assert torch.equal(out, want)
    assert torch.equal(x, x0)


def _replay_step_pass(x, taps, D, seg, second):
    """wt_step.cuh's step_pass on one (H, W) float32 frame, row by row and
    segment by segment, each step one float32 numpy operation in the
    kernel's order: FIRST → (c_next, detail), SECOND → lp (the power
    smooth of x²)."""
    H, W = x.shape
    hw = (len(taps) - 1) // 2
    t = np.asarray(taps[hw:], np.float32)
    Dr = hopper_conv.map_step(D, H)
    Dc = hopper_conv.map_step(D, W)
    out = np.full((H, W), np.nan, np.float32)
    det = np.full((H, W), np.nan, np.float32)
    segs = [(0, W, Dc, False)] if seg == 0 else [
        (w0, min(seg, W - w0), min(Dc, seg), min(Dc, seg) < Dc)
        for w0 in range(0, W, seg)]
    for h in range(H):
        rows = [x[int(_sym(h + j * Dr, H))] for j in range(-hw, hw + 1)]
        if second:
            rows = [r * r for r in rows]
        for w0, n_out, S, windows in segs:
            if seg == 0:
                cols = np.arange(W)
            elif windows:
                v = np.arange(2 * hw * S + seg)
                cols = _sym(w0 + (v // S - hw) * Dc + v % S, W)
            else:
                cols = _sym(w0 - hw * S + np.arange(2 * hw * S + n_out), W)
            T = rows[hw][cols] * t[0]
            for j in range(1, hw + 1):
                T = T + t[j] * (rows[hw - j][cols] + rows[hw + j][cols])
            o = np.arange(n_out)
            if seg == 0:
                v, lv, rv = o, None, None
                f = T[v] * t[0]
                for j in range(1, hw + 1):
                    f = f + t[j] * (T[_sym(o - j * Dc, W)]
                                    + T[_sym(o + j * Dc, W)])
            else:
                v = o + hw * S
                f = T[v] * t[0]
                for j in range(1, hw + 1):
                    f = f + t[j] * (T[v - j * S] + T[v + j * S])
            out[h, w0 + o] = f
            det[h, w0 + o] = x[h, w0 + o] - f
    return out if second else (out, det)


@pytest.mark.parametrize("shape,seg", [
    ((9, 70), 16), ((9, 70), 0), ((5, 37), 8), ((7, 13), 4)])
@pytest.mark.parametrize("scale", [0, 1, 2, 3, 4, 5, 6, 8, 40])
@pytest.mark.parametrize("sf", ["b3", "tri"])
def test_step_pass_layout_replayed(shape, seg, scale, sf):
    # whole rows, and segments whose buffer is a contiguous hw·Dc halo
    # (Dc <= seg) or the 2hw+1 tap windows side by side (Dc > seg), at
    # dilations past the frame and past the symmetric map's period: the
    # first pass is bitwise the plain smooth and its detail, the second
    # pass's lp bitwise the plain power smooth
    spec = SFS[sf]
    x = (np.random.default_rng(scale).normal(size=shape) * 3 + 10).astype(
        np.float32)
    D = 1 << scale
    c_next, det = _replay_step_pass(x, spec.taps, D, seg, False)
    xt = torch.from_numpy(x)
    want = hopper_conv.smooth(xt, spec, scale=scale, axes=(-2, -1))
    assert np.array_equal(c_next, want.numpy())
    assert np.array_equal(det, (xt - want).numpy())
    lp = _replay_step_pass(det, spec.taps, D, seg, True)
    dt = torch.from_numpy(det)
    assert np.array_equal(lp, hopper_conv.smooth(dt * dt, spec, scale=scale,
                                                 axes=(-2, -1)).numpy())


@pytest.mark.parametrize("shape,scales", [((4096, 4096), range(3, 10)),
                                          ((257, 513), (8,))])
def test_bilateral_step_plans(shape, scales):
    # kernel G's two launches a scale: the ring at one scale (kernel F's
    # plan) and the row-buffer second pass, each checked as its C entry
    # checks it, each covering every row once
    H, W = shape
    for s in scales:
        D = 1 << s
        ring = hopper_bilateral.bilateral_plan(1, H, W, D, 2)
        step = hopper_conv.step_plan(1, H, W, D, 2)
        assert _ring_plan_ok(ring, 2, H, W, D)
        assert _step_plan_ok(step, 2, 1, H, W, D)
        assert step.seg == 0 and step.smem_bytes == 8 * W
        assert ring.index_bits == step.index_bits == 32
        assert ring.grid[2] == step.grid[2] == 1
        Dr = hopper_conv.map_step(D, H)
        assert sorted(cls + i * Dr for cls, i0, i1 in _ring_blocks(ring, H, D)
                      for i in range(i0, i1)) == list(range(H))
        assert sorted(_step_rows(step, H, D)) == list(range(H))


# shapes and scales the earlier per-pixel kernels C and G took (any B, H,
# W; C any offset + g <= 62, G any scale); sides past 2^28 columns are
# left out (see step_plan)
COVER_SHAPES = [(1, 4096, 4096), (1, 257, 513), (3, 37, 70), (1, 1, 1),
                (2, 1, 9), (1, 9, 1), (70000, 4, 5), (65536, 1, 3),
                (1, 3, 29057), (2, 5, 40000), (1, 2, 1 << 20),
                (1, 1 << 20, 3)]


@pytest.mark.parametrize("shape", COVER_SHAPES,
                         ids=["x".join(map(str, s)) for s in COVER_SHAPES])
@pytest.mark.parametrize("scale", [0, 3, 9, 12, 15, 20, 27, 40, 61])
@pytest.mark.parametrize("kernel", ["C", "G"])
def test_new_plans_take_what_the_old_kernels_took(shape, scale, kernel):
    # kernel C's row-buffer launches (half widths up to 8) and kernel G's
    # ring and second pass (half widths 1..4) at every shape and scale;
    # a batch past 65535 frames runs as launches of 65535 and the rest
    B, H, W = shape
    D = 1 << scale
    for hw in ((1, 2, 8) if kernel == "C" else (1, 2, 4)):
        step = hopper_conv.step_plan(B, H, W, D, hw)
        assert _step_plan_ok(step, hw, B, H, W, D)
        if kernel == "G":
            ring = hopper_bilateral.bilateral_plan(step.grid[2], H, W, D, hw)
            assert _ring_plan_ok(ring, hw, H, W, D)
            assert ring.grid[2] == step.grid[2]
            assert ring.index_bits == step.index_bits
    frames = step.grid[2]
    chunks = [min(frames, B - b0) for b0 in range(0, B, frames)]
    assert sum(chunks) == B and max(chunks) <= 65535


# ---------------------------------------------------------------------
# Kernel D (csrc/whiten_plane.cu): the deep-plane form runs step_plan,
# the pieces form pieces_plan
# ---------------------------------------------------------------------

def _pieces_plan_ok(p, hw, n, B, H, W, rows=1):
    """csrc/whiten_plane.cu::pieces_plan_ok: what the pieces entry checks
    before it launches; ``rows`` planes a frame in the whites' output
    (its frame stride ``wstride = rows·H·W``)."""
    wstride = rows * H * W
    if not (1 <= n <= 3 and H < 2 ** 30 and W < 2 ** 30
            and (p.seg == 0 or p.seg < W) and wstride >= H * W):
        return False
    for s in range(n):
        Dr = hopper_conv.map_step(1 << s, H)
        Dc = hopper_conv.map_step(1 << s, W)
        if (H + hw * Dr >= 2 ** 31 or W + p.seg + hw * Dc >= 2 ** 31
                or (p.seg and Dc > p.seg)):
            return False
    frames = min(B, 65535)
    return (p.grid[0] == H
            and p.grid[1] == (1 if p.seg == 0 else -(-W // p.seg))
            and p.grid[1] <= 65535 and p.grid[2] == frames
            and hopper_wow.pieces_smem(n, hw, W, p.seg) <= p.smem_bytes
            and (p.index_bits == 64 or frames * wstride < 2 ** 31))


@pytest.mark.parametrize("B,H,W,rows", [(4, 4096, 4096, 7),
                                        (4, 4096, 4096, 32),
                                        (3, 96, 1000, 3),
                                        (70000, 64, 64, 7),
                                        (1, 30000, 30000, 3)])
def test_pieces_plan_batch_major(B, H, W, rows):
    # the batch-major cube (B, rows, H, W) changes only the whites' frame
    # stride: the same segments, shared bytes and grid, and 32-bit offsets
    # while a launch's whites span fewer than 2^31 elements (4 × 4096² at
    # 32 rows a frame is exactly 2^31)
    for n in range(1, 4):
        plan = hopper_wow.pieces_plan(B, H, W, n, 2, rows)
        base = hopper_wow.pieces_plan(B, H, W, n, 2)
        assert _pieces_plan_ok(plan, 2, n, B, H, W, rows)
        assert (plan.seg, plan.smem_bytes, plan.grid) == \
            (base.seg, base.smem_bytes, base.grid)
        frames = plan.grid[2]
        assert plan.index_bits == (
            32 if frames * rows * H * W < 2 ** 31 else 64)
        if plan.index_bits == 32:
            # the farthest white a launch writes: frame frames-1, scale
            # n-1 (its pointer), the last pixel, within 32-bit offsets
            # from the scale's pointer, and no scale reaches the next
            # frame's rows
            assert (frames - 1) * rows * H * W + H * W - 1 < 2 ** 31
            assert n <= rows
    assert (4, 4096, 4096, 32) != (B, H, W, rows) or plan.index_bits == 64
    with pytest.raises(ValueError):
        hopper_wow.pieces_plan(B, H, W, 3, 2, 0)


@pytest.mark.parametrize("W", [70, 2372, 2373, 4096, 9700, 40000, 1 << 20])
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("hw", [1, 2, 8])
def test_pieces_plan(W, n, hw):
    # whole rows while the 2n rows of floats let four blocks share an SM
    # beside the kernel's static tap-row table (W <= 2372 at n = 3), else
    # segments of 2048 covering every column with their contiguous halos
    plan = hopper_wow.pieces_plan(2, 5, W, n, hw)
    assert _pieces_plan_ok(plan, hw, n, 2, 5, W)
    per_block = (plan.smem_bytes + hopper_wow.PIECES_STATIC_SMEM + 1024)
    assert 4 * per_block <= 233472
    assert plan.smem_bytes + hopper_wow.PIECES_STATIC_SMEM <= \
        hopper_conv.SMEM_OPTIN
    assert (plan.seg == 0) == (8 * n * W <= hopper_wow.PIECES_SMEM)
    if n == 3 and W in (2372, 2373):
        assert (plan.seg == 0) == (W == 2372)
    if plan.seg:
        assert plan.seg == next(
            sg for sg in hopper_conv.STEP_SEGS
            if hopper_wow.pieces_smem(n, hw, W, sg) <= hopper_wow.PIECES_SMEM)
        assert plan.seg == 2048 or n < 3
        assert plan.grid[1] * plan.seg >= W > (plan.grid[1] - 1) * plan.seg
        assert plan.smem_bytes == 4 * sum(
            2 * plan.seg + 2 * hw * (1 << s) for s in range(n))
    else:
        assert plan.grid[1] == 1 and plan.smem_bytes == 8 * n * W
    assert plan.grid == (5, plan.grid[1], 2) and plan.index_bits == 32
    with pytest.raises(ValueError):
        hopper_wow.pieces_plan(1, 5, W, 4, hw)


def _replay_pieces_pass(planes, taps, seg, facs, thrs, soft):
    """whiten_plane.cu's pieces_pass on n (H, W) float32 planes (scale s
    at dilation 2^s), row by row and segment by segment, each step one
    float32 operation in the kernel's order (torch.sqrt and torch.erf for
    the square root and erff: the plain version's functions, as the
    comparison is on the CPU) → the whites, recon = (w0 + w1) + w2 and
    gamma = (wc0 + wc1) + wc2."""
    n = len(planes)
    H, W = planes[0].shape
    hw = (len(taps) - 1) // 2
    t = np.asarray(taps[hw:], np.float32)
    whites = np.full((n, H, W), np.nan, np.float32)
    recon = np.full((H, W), np.nan, np.float32)
    gamma = np.full((H, W), np.nan, np.float32)
    segs = [(0, W)] if seg == 0 else [(w0, min(seg, W - w0))
                                      for w0 in range(0, W, seg)]
    for h in range(H):
        for w0, n_out in segs:
            o = np.arange(n_out)
            rec = gam = None
            for s in range(n):
                x = planes[s]
                Dr = hopper_conv.map_step(1 << s, H)
                Dc = hopper_conv.map_step(1 << s, W)
                rows = [x[int(_sym(h + j * Dr, H))] for j in range(-hw, hw + 1)]
                if seg == 0:
                    cols = np.arange(W)
                else:
                    cols = _sym(w0 - hw * Dc + np.arange(2 * hw * Dc + n_out),
                                W)
                sq = [r[cols] * r[cols] for r in rows]
                T = sq[hw] * t[0]
                for j in range(1, hw + 1):
                    T = T + t[j] * (sq[hw - j] + sq[hw + j])
                if seg == 0:
                    f = T[o] * t[0]
                    for j in range(1, hw + 1):
                        f = f + t[j] * (T[_sym(o - j * Dc, W)]
                                        + T[_sym(o + j * Dc, W)])
                else:
                    v = o + hw * Dc
                    f = T[v] * t[0]
                    for j in range(1, hw + 1):
                        f = f + t[j] * (T[v - j * Dc] + T[v + j * Dc])
                lp = torch.sqrt(torch.from_numpy(
                    np.where(f <= 0, np.float32(1e-15), f))).numpy()
                wc = x[h, w0 + o]
                thr = np.float32(thrs[s])
                if thr != 0:
                    if soft:
                        m = torch.erf(torch.from_numpy(
                            np.abs(wc / thr))).numpy()
                    else:
                        m = (np.abs(wc) > thr).astype(np.float32)
                    wc = wc * m
                white = wc * (np.float32(facs[s]) / lp)
                whites[s, h, w0 + o] = white
                rec = white if rec is None else rec + white
                gam = wc if gam is None else gam + wc
            recon[h, w0 + o] = rec
            gamma[h, w0 + o] = gam
    return whites, recon, gamma


@pytest.mark.parametrize("shape,seg", [
    ((9, 70), 0), ((9, 70), 16), ((5, 37), 8), ((3, 13), 4), ((2, 3), 0)])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("mode", ["soft", "hard"])
@pytest.mark.parametrize("sf", ["b3", "tri"])
def test_pieces_pass_replayed(shape, seg, n, mode, sf):
    # whole rows and segments with a contiguous hw·2^s halo, scales at
    # dilations past the frame (2^2 > 3 rows): the whites, recon and gamma
    # bitwise to the plain version (whiten_detail_plain's folds, the
    # set/+=/+= sums)
    spec = SFS[sf]
    rng = np.random.default_rng(len(shape) + seg + n)
    planes = (rng.normal(size=(n,) + shape) * 3).astype(np.float32)
    facs = np.float32([1.5, 0.5, 2.0])[:n]
    thrs = np.float32([2.0, 0.0, 1.0])[:n]
    whites, recon, gamma = _replay_pieces_pass(
        list(planes), spec.taps, seg, facs, thrs, mode == "soft")
    pieces = (torch.from_numpy(planes)[:, None],)
    want = hopper_wow.fused_whiten_pieces_plain(
        pieces, torch.from_numpy(facs), torch.from_numpy(thrs), spec, n,
        tuple((0, s) for s in range(n)), soft=mode == "soft",
        write_gamma=True)
    assert np.array_equal(whites, want[0][:, 0].numpy())
    assert np.array_equal(recon, want[1][0].numpy())
    assert np.array_equal(gamma, want[2][0].numpy())


@pytest.mark.parametrize("shape", COVER_SHAPES,
                         ids=["x".join(map(str, s)) for s in COVER_SHAPES])
@pytest.mark.parametrize("scale", [0, 3, 9, 12, 15, 20, 27, 40, 61])
def test_new_plans_take_what_the_old_kernel_took(shape, scale):
    # the per-pixel kernel D took any (B, H, W): a deep plane at any
    # scale (now step_plan's one launch) and the pieces of scales 0..n-1
    # (now pieces_plan's), taps of half width up to 8; a batch past 65535
    # frames runs as launches of 65535 and the rest
    B, H, W = shape
    for hw in (1, 2, 8):
        step = hopper_conv.step_plan(B, H, W, 1 << scale, hw)
        assert _step_plan_ok(step, hw, B, H, W, 1 << scale)
        for n in range(1, 4):
            pieces = hopper_wow.pieces_plan(B, H, W, n, hw)
            assert _pieces_plan_ok(pieces, hw, n, B, H, W)
            assert pieces.grid[2] == step.grid[2]
    frames = step.grid[2]
    chunks = [min(frames, B - b0) for b0 in range(0, B, frames)]
    assert sum(chunks) == B and max(chunks) <= 65535
