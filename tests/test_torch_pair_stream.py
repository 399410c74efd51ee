"""Kernel E's pair of the bfloat16 route on the residue-class stream
(``csrc/whiten_pair.cu``, ``wt_whiten_pair_bf16``: a float32 carry and
recon, bfloat16 whites), on the CPU.

* The stream's algorithm replayed in PyTorch, one float32 operation at a
  time as the kernel rounds: work items (frame, chunk of the row circle,
  row class pair, column window, group of ``k`` column classes), the
  carry's ring of ``2hw+2`` float32 rows fetched in memory order (the
  mirror half's classes reversed) two ticks ahead, the middle carry's,
  the details' and ``white_s``'s float32 rings addressed by slot as the
  kernel addresses them, the rows-fold buffers with the circle's margins
  filled by copies (or a window's margins computed), the warm-up of a
  chunk around the circle, and the recon row a tick ahead.  Every ring
  starts as NaN and the rows-fold buffers are NaN again every tick, so a
  slot or index read before it is written reaches an output.  Bitwise to
  ``deep_whiten_step2_plain`` with bfloat16 whites (``torch.erf`` and
  ``torch.sqrt`` on both sides here; the kernel is held bitwise to the
  same plain version on the card, tests/test_torch_cuda.py).
* ``hopper_deep.pair_stream_plan`` against a mirror of the C entry's
  check (``pair_layout``): every shape kernel E's gate admits (batches to
  65535, every dilation up to the frame, half widths 1-8, the bfloat16
  route's frames), and wrong plans refused.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_bf16_wow import GEOMETRY
from wavelets_tpu_torch.models import lowp_route
from wavelets_tpu_torch.models.wow import PAIR_MAX_CLASS_ROWS
from wavelets_tpu_torch.ops import hopper_conv, hopper_deep
from wavelets_tpu_torch.ops.filters import B3SPLINE, TRIANGLE

SFS = {"b3": B3SPLINE, "tri": TRIANGLE}
SMEM_MAX = hopper_conv.SMEM_OPTIN


def _layout(p, hw, B, H, W, D):
    """csrc/whiten_pair.cu::pair_layout: the layout of the plan ``p``, or
    None where the C entry refuses it."""
    if not (1 <= B <= 65535 and H >= 1 and W >= 1 and D >= 1
            and D & (D - 1) == 0 and H % D == 0 and W % D == 0
            and H < 2 ** 30 and W < 2 ** 30):
        return None
    classes = D // 2 if D >= 2 else 1
    k, run, chunk = p.k, p.run, p.chunk
    if not (k >= 1 and k & (k - 1) == 0 and classes % k == 0 and run >= 0
            and chunk >= 1 and p.grid >= 1 and 64 <= p.threads <= 512
            and p.threads % 64 == 0):
        return None
    M, N = H // D, W // D
    rows_out = M if D == 1 else 2 * M
    cols_out = N if D == 1 else 2 * N
    window = run + 10 * hw if run else 2 * N
    pts = window * k
    if pts > (2 if k >= 2 else 1) * p.threads or chunk > rows_out \
            or run > cols_out:
        return None
    m1, m2 = (0, 0) if run else (hw, 2 * hw)
    pf = -(-pts // 4) * 4
    t1 = -(-(window + 2 * m1) * k // 4) * 4
    t2 = -(-(window + 2 * m2) * k // 4) * 4
    need = (4 * pf * ((2 * hw + 2) + 2 + (3 * hw + 2) + (4 * hw + 2)
                      + (2 * hw + 2) + (hw + 2) + (4 * hw + 2)
                      + (2 * hw + 2)) + 4 * 2 * (2 * t1 + 2 * t2))
    runs = -(-cols_out // run) if run else 1
    chunks = -(-rows_out // chunk)
    items = B * chunks * classes * runs * (classes // k)
    if need > p.smem_bytes or p.smem_bytes > SMEM_MAX or p.grid > items \
            or p.grid >= 2 ** 31:
        return None
    return dict(M=M, N=N, classes=classes, rows_out=rows_out,
                cols_out=cols_out, window=window, pts=pts, m1=m1, m2=m2,
                runs=runs, chunks=chunks, items=items,
                lead=5 * hw if run else 0)


def _replay(carry, recon, thr, sf, scale, plan, weights, masked, soft,
            write_plane=True):
    """The stream kernel on a float32 ``carry`` (B, H, W), item by item
    and tick by tick, in the kernel's order and rounding → (white_s,
    white_s+1 in bfloat16, recon', c_next2 in float32); ``recon`` (float32
    or None) is updated in place as the kernel's."""
    B, H, W = carry.shape
    taps = sf.taps
    hw = (len(taps) - 1) // 2
    tp = [torch.tensor(v, dtype=torch.float32) for v in taps[hw:]]
    D = 1 << scale
    lay = _layout(plan, hw, B, H, W, D)
    assert lay is not None
    M, N, k = lay["M"], lay["N"], plan.k
    Lr, Lc = 2 * M, 2 * N
    Vw, lead, pts, run = lay["window"], lay["lead"], lay["pts"], plan.run
    NC, N1, NQ1, ND1 = 2 * hw + 2, 4 * hw + 2, 2 * hw + 2, hw + 2
    NQ2, ND2, NW = 4 * hw + 2, 2 * hw + 2, 3 * hw + 2
    bf, nan = torch.bfloat16, float("nan")
    c_next = torch.full((B, H, W), nan)
    whites = [torch.full((B, H, W), nan, dtype=bf) if write_plane else None
              for _ in range(2)]
    f = torch.arange(pts)
    lam, e = f // k, f % k
    circle = run == 0
    ones = torch.ones(pts, dtype=torch.bool)
    r1 = ones if circle else (lam >= hw) & (lam < Vw - hw)
    r2 = ones if circle else (lam >= 3 * hw) & (lam < Vw - 3 * hw)
    ro = ones if circle else (lam >= 5 * hw) & (lam < Vw - 5 * hw)
    m1, m2 = lay["m1"], lay["m2"]
    x1, x2 = (lam + m1) * k + e, (lam + m2) * k + e
    cp1, cp2 = ((lam + m1) % Vw) * k + e, ((lam + m2) % Vw) * k + e
    lim1, lim2 = (Vw + 2 * m1) * k, (Vw + 2 * m2) * k
    period = Vw * k
    # the memory order of a ring row: element v is column class q0 +
    # (v % k) of window position v // k, or of its mirror
    ml, mi = f // k, f % k

    def fold(rows):
        out = rows[hw] * tp[0]
        for j in range(1, hw + 1):
            out = out + tp[j] * (rows[hw - j] + rows[hw + j])
        return out

    def fold_buf(T, x, step):
        def at(i):
            return T[i.clamp(0, T.numel() - 1)]
        return fold([at(x + j * step) for j in range(-hw, hw + 1)])

    def put(T, c0, lim, v, mask):
        m = 0
        while True:
            idx = c0 + m * period
            sel = mask & (idx < lim)
            if not sel.any():
                break
            T[idx[sel]] = v[sel]
            m += 1

    def whiten(d, lp, s_k, b):
        th = torch.as_tensor(thr[s_k][b], dtype=torch.float32)
        w, _ = hopper_conv.whiten_power_plain(d, lp, float(weights[s_k]), th,
                                              soft, bool(masked[s_k]))
        return w

    for item in range(lay["items"]):
        q, g = divmod(item, lay["classes"] // k)
        q, rn = divmod(q, lay["runs"])
        q, r = divmod(q, lay["classes"])
        b, ck = divmod(q, lay["chunks"])
        q0, v0 = g * k, rn * run
        p0 = ck * plan.chunk
        p1 = min(p0 + plan.chunk, lay["rows_out"])
        vt = (v0 - lead + lam) % Lc
        rev = vt >= N
        ri = lam * k + torch.where(rev, k - 1 - e, e)
        col = torch.where(rev, (2 * N - 1 - vt) * D + (D - 1 - q0 - e),
                          vt * D + q0 + e)
        own = ro & ((D != 1) | ~rev)
        if not circle:
            own = own & (lam - lead < min(run, lay["cols_out"] - v0))
        w_m = (v0 - lead + ml) % Lc
        mcol = torch.where(w_m < N, w_m * D + q0 + mi,
                           (2 * N - 1 - w_m) * D + (D - q0 - k) + mi)

        def row_of(p):
            u = p % Lr
            return r + u * D if u < M else (D - 1 - r) + (Lr - 1 - u) * D

        def rows(n, dtype=torch.float32):
            return torch.full((n, pts), nan, dtype=dtype)
        ring, rst, w1r = rows(NC), rows(2), rows(NW)
        c1r, q1r, d1r, q2r, d2r = rows(N1), rows(NQ1), rows(ND1), rows(NQ2), \
            rows(ND2)

        def fetch(dst, src, p):
            dst[:] = src[b, row_of(p)][mcol]

        T = (p1 - p0) + 8 * hw + 2
        for i in range(NC):
            fetch(ring[i], carry, p0 - 5 * hw + i)
        for t in range(T):
            q1 = p0 - 4 * hw + t
            q2, o1, o2 = q1 - 2 * hw - 1, q1 - hw - 1, q1 - 4 * hw - 2
            a1, a2 = t < T - 2, 4 * hw + 1 <= t < T - 1
            aw1, aw2 = p0 <= o1 < p1, t >= 8 * hw + 2
            T1, T2 = torch.full((lim1,), nan), torch.full((lim1,), nan)
            T1b, T2b = torch.full((lim2,), nan), torch.full((lim2,), nan)
            # the rows folds; every ring but the carry's reads its oldest
            # row first, slot (t + 1) mod n
            if a1:
                put(T1, cp1, lim1, fold([ring[(t + i) % NC][ri].float()
                                         for i in range(2 * hw + 1)]), ones)
            if a2:
                put(T1b, cp2, lim2, fold([c1r[(t + 1 + 2 * i) % N1]
                                          for i in range(2 * hw + 1)]), r1)
            if aw1:
                put(T2, cp1, lim1, fold([q1r[(t + 1 + i) % NQ1]
                                         for i in range(2 * hw + 1)]), r1)
            if aw2:
                put(T2b, cp2, lim2, fold([q2r[(t + 1 + 2 * i) % NQ2]
                                          for i in range(2 * hw + 1)]), r2)
            # after the barrier: the carry two ticks ahead, the recon row
            # one tick ahead
            if t + 2 < T - 2:
                fetch(ring[t % NC], carry, q1 + hw + 2)
            if recon is not None and 8 * hw + 2 <= t + 1 < T:
                fetch(rst[(t + 1) & 1], recon, o2 + 1)
            # the cols folds
            if a1:
                c = fold_buf(T1, x1, k)
                d = ring[(t + hw) % NC][ri].float() - c
                c1r[t % N1][r1] = c[r1]
                q1r[t % NQ1][r1] = (d * d)[r1]
                d1r[t % ND1][r1] = d[r1]
            if a2:
                c = fold_buf(T1b, x2, 2 * k)
                d = c1r[(t + 2 * hw + 1) % N1] - c
                q2r[t % NQ2][r2] = (d * d)[r2]
                d2r[t % ND2][r2] = d[r2]
                if p0 <= q2 < p1:
                    c_next[b, row_of(q2), col[own]] = c[own]
            if aw1:
                w = whiten(d1r[(t + 1) % ND1], fold_buf(T2, x1, k), 0, b)
                if write_plane:
                    whites[0][b, row_of(o1), col[own]] = w[own].to(bf)
                w1r[t % NW][ro] = w[ro]
            if aw2:
                w = whiten(d2r[(t + 1) % ND2],
                           fold_buf(T2b, x2, 2 * k), 1, b)
                row = row_of(o2)
                if write_plane:
                    whites[1][b, row, col[own]] = w[own].to(bf)
                if recon is not None:
                    rc = rst[t & 1][ri]
                    w1 = w1r[(t + 1) % NW]
                    out = (rc + w1) + w
                    recon[b, row, col[own]] = out[own]
    return whites[0], whites[1], recon, c_next


def _forced(B, H, W, D, hw, k, run, chunk, threads=512, grid=132):
    """A plan of the given group, window, chunk and threads (each cut to
    what the shape takes), with the shared bytes its layout needs."""
    classes = max(1, D // 2)
    M, N = H // D, W // D
    rows_out, cols_out = (M, N) if D == 1 else (2 * M, 2 * N)
    k = min(k, classes)
    run = min(run, cols_out)
    chunk = min(chunk, rows_out)
    window = run + 10 * hw if run else 2 * N
    runs = -(-cols_out // run) if run else 1
    items = B * -(-rows_out // chunk) * classes * runs * (classes // k)
    return hopper_deep.PairStreamPlan(
        k, run, chunk, threads,
        hopper_deep.pair_stream_smem(k, window, hw, run == 0),
        min(grid, items))


# (B, H, W), scale, plan (None: the plan's own; else k, run, chunk),
# scaling function, masked, recon: the bfloat16 cells' pairs (256² at
# (3, 4), 512² at (4, 5) alone and in three frames), D = 1 and D = 2 (one
# class, its own mirror or its mirror's), several groups, windows of the
# columns (one point a thread at k = 1, pairs beyond), chunks across the
# circle's turn; each scale masked and unmasked, with and without recon
TF, FT = (True, False), (False, True)
REPLAY_CASES = [
    ((1, 256, 256), 3, None, "tri", TF, True),
    ((1, 256, 256), 3, None, "b3", FT, False),
    ((1, 512, 512), 4, None, "b3", TF, True),
    ((3, 512, 512), 4, None, "b3", FT, True),
    ((2, 12, 20), 0, None, "b3", TF, True),
    ((2, 12, 20), 0, None, "tri", FT, False),
    ((1, 16, 24), 1, None, "tri", TF, True),
    ((1, 16, 24), 1, None, "b3", FT, False),
    ((1, 64, 64), 3, (2, 0, 5), "b3", TF, True),
    ((1, 32, 64), 2, (2, 6, 3, 128), "tri", FT, True),
    ((2, 6, 40), 0, (1, 7, 4, 256), "b3", FT, True),
    ((1, 32, 96), 4, (4, 3, 7, 128), "b3", TF, False),
    ((1, 24, 48), 3, (1, 5, 48, 128), "tri", TF, True),
]


@pytest.mark.parametrize("shape,scale,spec,sf,masked,with_recon",
                         REPLAY_CASES)
def test_pair_stream_algorithm_replayed_bf16(shape, scale, spec, sf, masked,
                                             with_recon):
    tsf = SFS[sf]
    rng = np.random.default_rng(scale + len(sf))
    B, H, W = shape
    D, hw = 1 << scale, tsf.half_width
    x = torch.from_numpy((rng.normal(size=shape) * 3 + 10).astype(
        np.float32)).to(torch.bfloat16).float()
    recon = torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(torch.bfloat16).float()
    plan = (hopper_deep.pair_stream_plan(B, H, W, D, hw) if spec is None
            else _forced(B, H, W, D, hw, *spec))
    # a zero threshold (no mask) in a frame
    thr = torch.tensor([[0.9, 0.0, 0.5][:B], [0.3, 0.6, 0.0][:B]])
    kw = dict(sf=tsf, scale=scale, weights=(1.25, 0.75), masked=masked,
              white_dtype=torch.bfloat16)
    r_p = recon.clone() if with_recon else None
    r_k = recon.clone() if with_recon else None
    want = hopper_deep.deep_whiten_step2_plain(x, r_p, thr, **kw)
    got = _replay(x, r_k, thr, tsf, scale, plan, (1.25, 0.75), masked, True)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert torch.equal(a, b)


def test_pair_stream_replayed_serving_without_planes():
    # write_plane=False: only c_next2 and recon
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(1, 128, 128)).astype(
        np.float32)).to(torch.bfloat16).float()
    recon = torch.zeros_like(x)
    thr = torch.tensor([[0.4], [0.0]])
    plan = hopper_deep.pair_stream_plan(1, 128, 128, 16, 2)
    kw = dict(sf=B3SPLINE, scale=4, weights=(1.0, 2.0), masked=(True, True),
              white_dtype=torch.bfloat16)
    r_p = recon.clone()
    want = hopper_deep.deep_whiten_step2_plain(x, r_p, thr, write_plane=False,
                                               **kw)
    r_k = recon.clone()
    got = _replay(x, r_k, thr, B3SPLINE, 4, plan, (1.0, 2.0), (True, True),
                  True, write_plane=False)
    assert got[0] is None and got[1] is None
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])


# ---------------------------------------------------------------------
# The stream's plan, as the C entry checks it
# ---------------------------------------------------------------------

def _gate_shapes():
    """Shapes and scales kernel E's gate admits (D | H, D | W, the float32
    tori within the shared memory): small frames at every dilation up to
    the frame, D = 1 included, and the widest columns it takes."""
    out = []
    for H, W in ((1, 1), (2, 6), (12, 20), (48, 4800), (6, 3632),
                 (60, 60), (64, 96), (128, 32), (256, 256), (512, 512),
                 (4096, 4096), (512, 4096), (8192, 64), (1, 3632)):
        for s in range(0, 14):
            D = 1 << s
            if D > H or H % D or W % D:
                continue
            if hopper_deep.pair_plan(1, H, W, s) is not None:
                out.append((H, W, s))
    return out


GATE = _gate_shapes()


@pytest.mark.parametrize("H,W,s", GATE,
                         ids=[f"{H}x{W}s{s}" for H, W, s in GATE])
def test_pair_stream_plan_takes_what_kernel_e_took(H, W, s):
    # every half width 1-8, one frame and 65535 (one launch: the blocks
    # take items grid-stride)
    D = 1 << s
    for hw in (1, 2, 3, 8):
        for B in (1, 65535):
            p = hopper_deep.pair_stream_plan(B, H, W, D, hw)
            lay = _layout(p, hw, B, H, W, D)
            assert lay is not None, (B, hw, p)
            # at most the blocks that fit 132 SMs at once
            assert p.grid <= hopper_conv.H100_SMS * (
                hopper_deep.PAIR_STREAM_SM_THREADS // p.threads)
            assert p.smem_bytes == hopper_deep.pair_stream_smem(
                p.k, lay["window"], hw, p.run == 0)


@pytest.mark.parametrize("shape", GEOMETRY)
@pytest.mark.parametrize("sf", ["b3", "tri"])
def test_pair_stream_plan_takes_the_bf16_route(shape, sf):
    # wherever the bfloat16 route pairs on kernel E, the stream takes it
    tsf = SFS[sf]
    H, W = shape
    for s in range(3, 14):
        D = 1 << s
        if not (lowp_route.lowp_can_pair(H, W, tsf, s)
                and H >> s <= PAIR_MAX_CLASS_ROWS
                and hopper_deep.can_deep2(
                    torch.empty((1, H, W), dtype=torch.bfloat16,
                                device="meta"), tsf, s)):
            continue
        p = hopper_deep.pair_stream_plan(1, H, W, D, tsf.half_width)
        assert _layout(p, tsf.half_width, 1, H, W, D) is not None


def test_pair_stream_plan_at_the_cells():
    # 4096² (7, 8): 8 classes a group (whole 32-byte sectors of float32),
    # the whole circle of 64 rows an item, 512 items on one 256-thread
    # block an SM (122 KiB of float32 rings, two points a thread); 512²
    # (4, 5): the 8 classes, chunks of 4 of the 64 rows, 128 items; three
    # frames: chunks of 13
    p = hopper_deep.pair_stream_plan(1, 4096, 4096, 128, 2)
    assert (p.k, p.run, p.chunk, p.threads, p.grid, p.smem_bytes) == (
        8, 0, 64, 256, 132, 124416)
    p = hopper_deep.pair_stream_plan(1, 512, 512, 16, 2)
    assert (p.k, p.run, p.chunk, p.threads, p.grid) == (8, 0, 4, 256, 128)
    p = hopper_deep.pair_stream_plan(3, 512, 512, 16, 2)
    assert (p.k, p.run, p.chunk, p.threads) == (8, 0, 13, 256)
    # past the block: windows of the column circle
    p = hopper_deep.pair_stream_plan(1, 6, 3632, 1, 2)
    assert p.k == 1 and 0 < p.run and p.run + 20 <= p.threads


@pytest.mark.parametrize("wrong", ["k3", "k_big", "run_big", "pts", "chunk0",
                                   "chunk_big", "smem", "over", "grid",
                                   "threads", "shape"])
def test_pair_stream_check_refuses_a_wrong_plan(wrong):
    B, H, W, D, hw = 2, 64, 96, 8, 2
    p = hopper_deep.pair_stream_plan(B, H, W, D, hw)
    assert _layout(p, hw, B, H, W, D) is not None
    bad = {"k3": dict(k=3), "k_big": dict(k=8), "run_big": dict(run=25),
           "pts": dict(k=4, run=300), "chunk0": dict(chunk=0),
           "chunk_big": dict(chunk=17), "smem": dict(
               smem_bytes=p.smem_bytes - 16),
           "over": dict(smem_bytes=SMEM_MAX + 16), "grid": dict(grid=10 ** 6),
           "threads": dict(threads=96), "shape": {}}[wrong]
    q = dataclasses.replace(p, **bad)
    shape = (B, H + 4, W, D) if wrong == "shape" else (B, H, W, D)
    assert _layout(q, hw, *shape) is None


def test_pair_stream_plan_raises_where_the_kernel_cannot_run():
    with pytest.raises(ValueError, match="power of two"):
        hopper_deep.pair_stream_plan(1, 36, 72, 8, 2)
    with pytest.raises(ValueError, match="out of range"):
        hopper_deep.pair_stream_plan(65536, 64, 64, 8, 2)
    with pytest.raises(ValueError, match="out of range"):
        hopper_deep.pair_stream_plan(1, 64, 64, 8, 9)
