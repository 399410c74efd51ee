"""Kernel B's launch plan and algorithm on the CPU.

``csrc/median_select.cu`` selects numpy's two middle order statistics of
``|x|`` by three radix digits of the 31-bit pattern (bits 20-30, 10-19,
0-9) in four launches, as ``hopper_stats.select_plan`` says.  Its
algorithm is replayed here in numpy, block by block as the kernel splits
the patterns: the first digit's histogram and each block's offset in the
candidate scratch, the compaction of the chosen bin (or, beyond the
plan's cap, the later digits read over the plane), the upper statistic
from the three levels above the lower one.  The replay must give
``np.median(np.abs(x))`` bitwise, and the compaction must write every
candidate slot exactly once.
"""

import numpy as np
import pytest
import torch

from wavelets_tpu_torch.ops import hopper_stats

ABS = np.uint32(0x7FFFFFFF)
#: the kernel's block width and first digit (bits 20-30), its constants
THREADS = 256
FIRST_BINS = 2048


def _owner(n, head, blocks, threads=THREADS):
    """The block that reads each pattern in ``for_each``: 16-byte vectors
    from the first boundary (``head`` patterns before it), 64 vectors a
    warp, grid-strided; the last block takes the head and the tail."""
    owner = np.full(n, blocks - 1)
    n4 = (n - head) // 4
    vec = np.arange(n4) % (2 * blocks * threads) // (2 * threads)
    owner[head:head + 4 * n4] = np.repeat(vec, 4)
    return owner


def _choose(hist, k):
    """(bin, count below it, its count, first non-empty bin above)."""
    cum = np.cumsum(hist)
    b = int(np.searchsorted(cum, k, side="right"))
    below = int(cum[b] - hist[b])
    above = np.nonzero(hist[b + 1:])[0]
    return b, below, int(hist[b]), (b + 1 + int(above[0]) if above.size
                                    else len(hist))


def replay_select(bits, ks, plan, head=0):
    """median_select.cu's algorithm: returns ``(lo, hi, compacted)``, the
    two patterns and whether the candidates went through the scratch."""
    v = bits.astype(np.uint32) & ABS
    n = v.size
    k_lo, k_hi = ks
    owner = _owner(n, head, plan.blocks)
    d1 = v >> 20
    bhist = np.zeros((plan.blocks, FIRST_BINS), np.int64)
    np.add.at(bhist, (owner, d1), 1)
    b1, below, cnt, _ = _choose(bhist.sum(0), k_lo)
    k, less = k_lo - below, below
    compact = cnt <= plan.cap
    base = np.concatenate([[0], np.cumsum(bhist[:, b1])[:-1]])
    gt1 = v[d1 > b1].min(initial=0xFFFFFFFF)
    if compact:
        cand = np.zeros(cnt, np.uint32)
        written = np.zeros(cnt, int)
        for b in range(plan.blocks):
            mine = v[(owner == b) & (d1 == b1)]
            assert mine.size == bhist[b, b1]
            cand[base[b]:base[b] + mine.size] = mine
            written[base[b]:base[b] + mine.size] += 1
        assert (written == 1).all() and cnt <= plan.cap
        src = cand
    else:
        src = v[d1 == b1]   # the plane again, filtered by the prefix
    b2, below, _, _ = _choose(np.bincount((src >> 10) & 1023,
                                          minlength=1024), k)
    k, less = k - below, less + below
    prefix = np.uint32((b1 << 20) | (b2 << 10))
    hi = prefix >> 10
    gt2 = src[(src >> 10) > hi].min(initial=0xFFFFFFFF)
    b3, below, cnt3, nxt = _choose(
        np.bincount(src[(src >> 10) == hi] & 1023, minlength=1024), k)
    lo = int(prefix) | b3
    gt = min(int(gt1), int(gt2), int(prefix) | nxt if nxt < 1024
             else 0xFFFFFFFF)
    hi_val = lo if less + below + cnt3 > k_hi else gt
    return lo, hi_val, compact


def _median(lo, hi):
    vals = torch.tensor([lo, hi], dtype=torch.int64).to(torch.int32)
    vals = vals.view(torch.float32)
    return ((vals[0] + vals[1]) / 2).numpy()


def _case(kind, n, rng):
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
        return np.where(np.arange(n) < n // 2, 0.5, -3.0)
    if kind == "straddle2":   # ... in two bins of the second digit
        return np.where(np.arange(n) < n // 2, 1.0, 1.0 + 2.0 ** -12)
    if kind == "straddle3":   # ... in two bins of the last digit
        return np.where(np.arange(n) < n // 2, 1.0,
                        float(np.nextafter(np.float32(1), np.float32(2))))
    raise ValueError(kind)


KINDS = ["normal", "equal", "zeros", "subnormal", "ties", "straddle1",
         "straddle2", "straddle3"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 2, 3, 1001, 4096, 40000])
def test_select_replay_is_numpy_median(kind, n):
    rng = np.random.default_rng(n)
    x = _case(kind, n, rng).astype(np.float32)
    plan = hopper_stats.select_plan(n, 2)    # several blocks at 40000
    ks = hopper_stats.middle_ranks(n)
    lo, hi, compact = replay_select(x.view(np.int32), ks, plan)
    assert _median(lo, hi).tobytes() == np.median(np.abs(x)).tobytes()
    srt = np.sort(np.abs(x)).view(np.uint32)
    assert (lo, hi) == (int(srt[ks[0]]), int(srt[ks[1]]))
    if kind in ("equal", "zeros", "straddle2", "straddle3") and n > 3:
        # the whole plane in the first digit's bin: over the cap, the
        # later digits read the plane
        assert not compact
    if kind == "normal":
        assert compact


@pytest.mark.parametrize("head", [1, 2, 3])
@pytest.mark.parametrize("kind", ["normal", "straddle1", "ties"])
def test_select_replay_with_a_head_before_the_first_vector(head, kind):
    # patterns that do not start on a 16-byte boundary: the last block
    # takes the head and the tail
    n = 20003
    x = _case(kind, n, np.random.default_rng(head)).astype(np.float32)
    plan = hopper_stats.select_plan(n, 1)
    owner = _owner(n, head, plan.blocks)
    assert np.bincount(owner, minlength=plan.blocks).sum() == n
    assert (owner[:head] == plan.blocks - 1).all()
    lo, hi, _ = replay_select(x.view(np.int32), hopper_stats.middle_ranks(n),
                              plan, head)
    assert _median(lo, hi).tobytes() == np.median(np.abs(x)).tobytes()


@pytest.mark.parametrize("n", [1, 7, 4096, 4097, 512 * 512, 4096 * 4096,
                               64 * 1024 * 1024])
@pytest.mark.parametrize("n_sms", [1, 132])
def test_select_plan(n, n_sms):
    plan = hopper_stats.select_plan(n, n_sms)
    assert 1 <= plan.blocks <= 4 * n_sms
    assert plan.blocks == 1 or (plan.blocks - 1) * 4096 < n
    assert plan.cap == -(-n // 4) and 1 <= plan.cap <= n
    # state, three histograms, offsets, the per-block table, candidates
    want = (64 + 8 * (2048 + 1024 + 1024) + 16 * -(-plan.blocks // 2)
            + 4 * 2048 * plan.blocks + 4 * plan.cap)
    assert plan.scratch_bytes == want


def test_select_plan_refuses_nothing_to_select():
    with pytest.raises(ValueError):
        hopper_stats.select_plan(0, 132)


def test_cpu_version_takes_any_ranks():
    # the kernel takes a median's neighbouring ranks only, the plain
    # version any
    bits = torch.zeros(8, dtype=torch.int32)
    assert hopper_stats.median_bits2(bits, (1, 5)).tolist() == [0, 0]
