"""Kernel A's deep step on the residue-class stream (``csrc/
whiten_step.cu``: the bfloat16 route's step, a float32 carry to a
bfloat16 white, and halo mode), on the CPU.

* The stream's algorithm replayed in PyTorch, one float32 operation at a
  time as the kernel rounds: work items (frame, run of columns, chunk,
  residue class), the carry's ring of ``2hw+2`` float32 rows and the
  detail's ring of ``2hw+1`` float32 rows addressed by slot as the
  kernel addresses them, the warm-up of a chunk, positions outside the
  class read through the symmetric map, halo offsets, and runs of columns
  laid out as contiguous margins or tap windows.  Bitwise to
  ``deep_whiten_step_plain`` with bfloat16 whites, to two such steps as
  ``deep_whiten_step2_plain`` (the pair where kernel E's gate refuses),
  and to the halo plain version in float32 (``torch.erf`` and
  ``torch.sqrt`` on both sides here; the kernel is held bitwise to the
  same plain versions on the card, tests/test_torch_cuda.py).
* ``hopper_conv.stream_step_plan`` against a mirror of the C entry's
  check (``stream_layout``): every shape the two-launch entries took,
  the bfloat16 route's geometry, M2's bands, and wrong plans refused.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_bf16_wow import GEOMETRY
from tests.test_torch_plans import COVER_SHAPES
from wavelets_tpu_torch.ops import _build, hopper_conv, hopper_deep
from wavelets_tpu_torch.ops.conv import boundary_index
from wavelets_tpu_torch.ops.filters import B3SPLINE, TRIANGLE

SFS = {"b3": B3SPLINE, "tri": TRIANGLE}
SMEM_MAX = hopper_conv.SMEM_OPTIN


def _sym(k, n):
    k = np.asarray(k) % (2 * n)
    return np.where(k < n, k, 2 * n - 1 - k)


def _a16(n):
    return -(-n // 16) * 16


def _layout(p, hw, B, H, W, D, halo):
    """csrc/whiten_step.cu::stream_layout: the layout of the plan ``p``,
    or None where the C entry refuses it."""
    if not (B >= 1 and H >= 1 and W >= 1 and D >= 1 and H < 2 ** 30
            and W < 2 ** 30 and p.seg >= 0 and p.chunk >= 1 and p.grid >= 1
            and (p.seg == 0 or (p.seg % 8 == 0 and p.seg < W))):
        return None
    if halo and not (D < 2 ** 26 and halo == 2 * hw * D
                     and H + 2 * halo < 2 ** 30):
        return None
    Dr = D if halo else hopper_conv.map_step(D, H)
    Dc = hopper_conv.map_step(D, W)
    mirror = not halo and Dr < H and H % Dr == 0 and Dr % 2 == 0
    n_cls = Dr // 2 if mirror else min(Dr, H)
    P = 2 * (H // Dr) if mirror else -(-H // Dr)
    S = min(Dc, p.seg) if p.seg else 0
    m = p.seg or W
    span_c = 4 * hw * S + m if p.seg else W
    span_d = 2 * hw * S + m if p.seg else W
    pitch_c, pitch_d = -(-span_c // 4) * 4, -(-span_d // 4) * 4
    need = (_a16((2 * hw + 2) * pitch_c * 4) + _a16(4 * span_c)
            + _a16(4 * span_d) + _a16((2 * hw + 1) * pitch_d * 4)
            + _a16(m * 4))
    runs = -(-W // p.seg) if p.seg else 1
    items = B * runs * n_cls * -(-P // p.chunk)
    if (p.chunk > P or need > p.smem_bytes or p.smem_bytes > SMEM_MAX
            or p.grid > items or p.grid >= 2 ** 31):
        return None
    return dict(Dr=Dr, Dc=Dc, n_cls=n_cls, P=P, mirror=mirror, S=S,
                windows=bool(p.seg) and S < Dc, runs=runs, items=items)


def _replay(carry, recon, thr, taps, scale, plan, fac, masked, soft,
            white_dtype, halo=0):
    """The stream kernel on the float32 ``carry`` (B, H + 2·halo, W), item
    by item and tick by tick, in the kernel's order and rounding →
    (white, recon', c_next); ``recon`` (float32) is updated in place as
    the kernel's acc, by the unrounded white."""
    B, Hs, W = carry.shape
    H = Hs - 2 * halo
    hw = (len(taps) - 1) // 2
    t = [torch.tensor(v, dtype=torch.float32) for v in taps[hw:]]
    D = 1 << scale
    st = white_dtype
    lay = _layout(plan, hw, B, H, W, D, halo)
    assert lay is not None
    Dr, Dc, S, seg = lay["Dr"], lay["Dc"], lay["S"], plan.seg
    NC, ND = 2 * hw + 2, 2 * hw + 1
    c_next = torch.full((B, H, W), float("nan"), dtype=torch.float32)
    white = torch.full((B, H, W), float("nan"), dtype=st)
    n_chunks = -(-lay["P"] // plan.chunk)
    for item in range(lay["items"]):
        q, r = divmod(item, lay["n_cls"])
        q, k = divmod(q, n_chunks)
        b, g = divmod(q, lay["runs"])
        # a class's positions; with mirror, the pair (r, Dr - 1 - r) as
        # one stream, the output rows through the symmetric map
        P = lay["P"] if lay["mirror"] else -(-(H - r) // Dr)

        def out_row(p):
            v = r + p * Dr
            return int(_sym(v, H)) if lay["mirror"] else v
        p0 = k * plan.chunk
        if p0 >= P:
            continue
        p1 = min(p0 + plan.chunk, P)
        w0 = g * seg
        n_out = W if seg == 0 else min(seg, W - w0)
        if seg == 0:
            ccols = np.arange(W)
        else:
            m = seg if lay["windows"] else n_out
            v = np.arange(4 * hw * S + m)
            ccols = _sym(w0 + (v // S - 2 * hw) * Dc + v % S, W)
        ring, det = [None] * NC, [None] * ND

        def src_row(p):
            v = r + p * Dr
            return halo + v if halo else int(_sym(v, H))

        def fetch(p):
            ring[(p - p0 + 2 * hw) % NC] = carry[b, src_row(p)][ccols]

        def fold(T, centre):
            # the cols fold at shared indices `centre`
            f = T[centre] * t[0]
            for j in range(1, hw + 1):
                if seg == 0:
                    lo, hi = _sym(centre - j * Dc, W), _sym(centre + j * Dc, W)
                else:
                    lo, hi = centre - j * S, centre + j * S
                f = f + t[j] * (T[lo] + T[hi])
            return f

        for p in range(p0 - 2 * hw, p0 + 1):
            fetch(p)
        for ti in range(p1 - p0 + 2 * hw + 1):
            qc = p0 - hw + ti
            qo = qc - hw - 1
            chain, out = qc < p1 + hw, qo >= p0
            if qc + hw + 1 < p1 + 2 * hw:
                fetch(qc + hw + 1)
            so = [ring[(ti + i) % NC].float() for i in range(2 * hw + 1)]
            dso = [det[(ti + i) % ND] for i in range(2 * hw + 1)]
            if chain:
                T1 = so[hw] * t[0]
                for j in range(1, hw + 1):
                    T1 = T1 + t[j] * (so[hw - j] + so[hw + j])
            if out:
                T2 = (dso[hw] * dso[hw]) * t[0]
                for j in range(1, hw + 1):
                    T2 = T2 + t[j] * (dso[hw - j] * dso[hw - j]
                                      + dso[hw + j] * dso[hw + j])
            if chain:
                u = np.arange(W if seg == 0 else len(ccols) - 2 * hw * S)
                uc = u if seg == 0 else u + hw * S
                f = fold(T1, uc)
                det[ti % ND] = so[hw][uc] - f
                if p0 <= qc < p1:
                    o = u if seg == 0 else u - hw * S
                    keep = (o >= 0) & (o < n_out)
                    c_next[b, out_row(qc), w0 + o[keep]] = f[keep]
            if out:
                o = np.arange(n_out)
                u = o if seg == 0 else o + hw * S
                lp = fold(T2, u)
                c = dso[hw][u]
                lp = torch.sqrt(torch.where(lp <= 0, torch.tensor(1e-15),
                                            lp))
                wc = c
                if masked and float(thr[b]) != 0:
                    tb = thr[b].float()
                    m_ = (torch.erf(torch.abs(wc / tb)) if soft
                          else (torch.abs(wc) > tb).float())
                    wc = wc * m_
                v2 = wc * (torch.tensor(fac, dtype=torch.float32) / lp)
                row = out_row(qo)
                white[b, row, w0:w0 + n_out] = v2.to(st)
                recon[b, row, w0:w0 + n_out] = (
                    recon[b, row, w0:w0 + n_out] + v2)
    return white, recon, c_next


def _plan(B, H, W, D, hw, seg, chunk, grid, halo=False):
    """A plan of the given run width, chunk and grid, as the stream
    takes one (the chunk at most a class's positions, the grid at most
    the items), with the shared bytes its layout needs."""
    seg = seg if seg < W else 0
    _, n_cls, P, _ = hopper_conv.stream_classes(H, D, halo)
    chunk = min(chunk, P)
    runs = -(-W // seg) if seg else 1
    items = B * runs * n_cls * -(-P // chunk)
    return hopper_conv.StreamStepPlan(
        seg, chunk, hopper_conv.stream_step_smem(W, D, hw, seg),
        min(grid, items))


# (B, H, W), scale, (seg, chunk, grid): H not a multiple of D, D >= H,
# 8-row frames, odd widths, runs of columns (contiguous margins where
# Dc <= seg, tap windows beyond), three frames, mirror pairs (D divides
# H: 32 and 16 rows), chunks across a pair's turn, and the plan's own
# choice
REPLAY_CASES = [
    ((3, 19, 37), 2, None), ((3, 19, 37), 2, (16, 2, 5)),
    ((2, 32, 37), 2, (0, 3, 5)), ((1, 16, 40), 3, (8, 5, 2)),
    ((1, 8, 40), 3, (8, 1, 3)), ((1, 8, 40), 5, None),
    ((2, 21, 70), 4, (16, 3, 7)), ((1, 13, 29), 6, (8, 2, 1)),
    ((1, 37, 45), 1, (0, 4, 2)),
]


@pytest.mark.parametrize("shape,scale,spec", REPLAY_CASES)
@pytest.mark.parametrize("sf", ["b3", "tri"])
def test_stream_algorithm_replayed_bf16(shape, scale, spec, sf):
    # the bfloat16 route's step (a float32 carry, a bfloat16 white) and
    # two of them as the pair where kernel E's gate refuses: bitwise to
    # the plain versions
    tsf = SFS[sf]
    rng = np.random.default_rng(scale + len(sf))
    B, H, W = shape
    x = torch.from_numpy((rng.normal(size=shape) * 3 + 10).astype(
        np.float32)).to(torch.bfloat16).float()
    recon = torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(torch.bfloat16).float()
    thr = torch.tensor([0.9, 0.0, 0.5][:B])
    hw = tsf.half_width
    bf = torch.bfloat16

    def plan(s):
        if spec is None:
            return hopper_conv.stream_step_plan(B, H, W, 1 << s, hw)
        return _plan(B, H, W, 1 << s, hw, *spec)

    want = hopper_deep.deep_whiten_step_plain(
        x, recon.clone(), thr, sf=tsf, scale=scale, weight=1.5, masked=True,
        white_dtype=bf)
    got = _replay(x, recon.clone(), thr, tsf.taps, scale, plan(scale), 1.5,
                  True, True, bf)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    thr2 = torch.stack([thr, thr.flip(0)])
    w1, w2, r_p, c_p = hopper_deep.deep_whiten_step2_plain(
        x, recon.clone(), thr2, sf=tsf, scale=scale, weights=(1.25, 0.75),
        masked=(True, False), white_dtype=bf)
    acc = recon.clone()
    v1, _, mid = _replay(x, acc, thr2[0], tsf.taps, scale, plan(scale),
                         1.25, True, True, bf)
    v2, _, c_k = _replay(mid, acc, thr2[1], tsf.taps, scale + 1,
                         plan(scale + 1), 0.75, False, True, bf)
    for a, b in ((v1, w1), (v2, w2), (acc, r_p), (c_k, c_p)):
        assert torch.equal(a, b)


HALO_CASES = [((2, 19, 37), 2, None), ((1, 8, 40), 3, (16, 2, 3)),
              ((3, 13, 29), 4, (8, 1, 4)), ((1, 40, 70), 1, (0, 3, 2))]


@pytest.mark.parametrize("shape,scale,spec", HALO_CASES)
@pytest.mark.parametrize("sf", ["b3", "tri"])
def test_stream_algorithm_replayed_halo(shape, scale, spec, sf):
    # halo mode on a band extended as the sharded engine extends it: every
    # position a real row at an offset; bitwise to the halo plain version
    tsf = SFS[sf]
    rng = np.random.default_rng(scale)
    B, H, W = shape
    R = 2 * tsf.half_width << scale
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    ext = x.index_select(1, boundary_index(H, -R, "symmetric",
                                           length=H + 2 * R)).contiguous()
    recon = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    thr = torch.tensor([0.3, 0.0, 0.7][:B])
    hw, D = tsf.half_width, 1 << scale
    plan = (hopper_conv.stream_step_plan(B, H, W, D, hw, True)
            if spec is None else _plan(B, H, W, D, hw, *spec, True))
    _build.reset_counters()
    want = hopper_deep.deep_whiten_step_plain(
        ext, recon.clone(), thr, sf=tsf, scale=scale, weight=1.5,
        masked=True, halo=R)
    assert dict(_build.PLAIN_CALLS) == {"whiten_step_halo": 1}
    got = _replay(ext, recon.clone(), thr, tsf.taps, scale, plan, 1.5, True,
                  True, torch.float32, halo=R)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------
# The stream's plan, as the C entry checks it
# ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", COVER_SHAPES,
                         ids=["x".join(map(str, s)) for s in COVER_SHAPES])
@pytest.mark.parametrize("scale", [0, 3, 9, 12, 20, 40, 61])
def test_stream_plan_takes_what_the_two_launch_entries_took(shape, scale):
    # every shape, batch (past 65535 frames: one launch) and scale the
    # row-buffer pass took, half widths 1-8
    B, H, W = shape
    D = 1 << scale
    for hw in (1, 2, 8):
        hopper_conv.step_plan(B, H, W, D, hw)  # the old entries took it
        p = hopper_conv.stream_step_plan(B, H, W, D, hw)
        assert _layout(p, hw, B, H, W, D, 0) is not None
        assert p.grid <= hopper_conv.H100_SMS


@pytest.mark.parametrize("shape", GEOMETRY)
def test_stream_plan_takes_the_bf16_geometry(shape):
    # the bfloat16 route's frames (deep steps from scale 3 up): whole rows
    # to 4148 columns (float32 rings), runs beyond
    H, W = shape
    for s in range(3, 13):
        p = hopper_conv.stream_step_plan(1, H, W, 1 << s, 2)
        assert _layout(p, 2, 1, H, W, 1 << s, 0) is not None
        assert (p.seg == 0) == (hopper_conv.stream_step_smem(
            W, 1 << s, 2, 0) <= SMEM_MAX)


@pytest.mark.parametrize("H,W", [(4096, 4096), (1024, 4096), (8, 64),
                                 (257, 513), (4096, 4150)])
def test_stream_plan_takes_m2_bands(H, W):
    # the sharded band tail: bands extended by R = 2hw·2^s up to 2048
    # rows a side, float32, whole rows at 4096 columns (224 KB)
    for s in range(0, 10):
        R = 4 << s
        p = hopper_conv.stream_step_plan(1, H, W, 1 << s, 2, True)
        assert _layout(p, 2, 1, H, W, 1 << s, R) is not None
        if W == 4096:
            assert p.seg == 0 and p.smem_bytes == 229376
    m2 = [hopper_conv.stream_step_plan(1, 4096, 4096, 1 << s, 2, True)
          for s in range(3, 10)]
    assert [p.chunk for p in m2] == [32, 32, 32, 32, 32, 16, 8]
    assert not any(hopper_conv.stream_classes(4096, 1 << s, True)[3]
                   for s in range(3, 10))


def test_stream_plan_at_4096():
    # the bf16 cells' steps: s = 4 walks 8 mirror pairs of 512 positions
    # in chunks of 32, 128 blocks, whole float32 rows (224 KiB); s = 9
    # 256 pairs of 16 positions, 132 blocks grid-stride (without pairs:
    # 512 classes of 8, warm-up 1.5x)
    p4 = hopper_conv.stream_step_plan(1, 4096, 4096, 16, 2)
    p9 = hopper_conv.stream_step_plan(1, 4096, 4096, 512, 2)
    assert (p4.seg, p4.chunk, p4.grid, p4.smem_bytes) == (0, 32, 128, 229376)
    assert (p9.seg, p9.chunk, p9.grid) == (0, 16, 132)
    assert hopper_conv.stream_classes(4096, 512) == (512, 256, 16, True)
    assert hopper_conv.stream_classes(4000, 512) == (512, 512, 8, False)


@pytest.mark.parametrize("wrong", ["smem", "seg8", "seg_w", "chunk", "grid",
                                   "halo", "over"])
def test_stream_check_refuses_a_wrong_plan(wrong):
    B, H, W, D, hw = 2, 64, 96, 8, 2
    p = hopper_conv.stream_step_plan(B, H, W, D, hw)
    assert _layout(p, hw, B, H, W, D, 0) is not None
    bad = {"smem": dict(smem_bytes=p.smem_bytes - 16),
           "seg8": dict(seg=12), "seg_w": dict(seg=96),
           "chunk": dict(chunk=H + 1), "grid": dict(grid=10 ** 6),
           "halo": {}, "over": dict(smem_bytes=SMEM_MAX + 16)}[wrong]
    import dataclasses
    q = dataclasses.replace(p, **bad)
    halo = 2 * hw * D + 1 if wrong == "halo" else 0
    assert _layout(q, hw, B, H, W, D, halo) is None


def test_stream_plan_raises_where_nothing_fits():
    with pytest.raises(ValueError, match="2\\^30"):
        hopper_conv.stream_step_plan(1, 2 ** 30, 8, 1, 2)
    with pytest.raises(ValueError, match="2\\^30"):
        hopper_conv.stream_step_plan(1, 2 ** 29, 8, 2 ** 27, 2, True)
