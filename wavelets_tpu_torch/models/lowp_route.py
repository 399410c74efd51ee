"""The bfloat16 merged route's geometry: which scales each kernel takes.

In float32 the kernels are bitwise to the plain chain, so the port
chose its own group and deep steps.  In bfloat16 the group rounds after
every pass, the deep stream only on store and the pair not at its
middle carry, so the scales each route takes decide the bits.  These
are the JAX package's plan (``_deep_start``, ``_can_merge_whiten``,
``plan_wow_prefix``, ``can_deep``, ``can_deep2``, ``_stream_rows``,
``_stream2_rows``; wavelets_tpu/models/wow.py:501-560,
ops/pallas_conv.py:380-540 and :774-821, ops/pallas_deep.py:98-129,
:296-310 and :675-710) copied as **shape predicates**: they define the
reference's rounding route on a TPU, VMEM budgets and cost model
included, and are not H100 tile plans (the kernels' launches are
``ops/hopper_*.py``'s).  Where the H100 cannot take a JAX kernel, the
port keeps its rounding another way:

* a pair whose float32 tori do not fit kernel E's shared memory runs as
  two bfloat16 deep steps of kernel A with a float32 middle carry
  (``hopper_deep.deep_whiten_step2_split``);
* a group that kernel A's bfloat16 tile cannot hold
  (``hopper_conv.group_plan(...) is None``) runs the plain group body
  on the card (``hopper_conv.fused_wow_group``), as float64 runs plain.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

from ..ops.filters import ScalingFunction

__all__ = ["STREAM_MIN_REACH", "stream_rows", "stream2_rows",
           "lowp_can_deep", "lowp_can_pair", "lowp_padded_deep",
           "lowp_deep_start", "lowp_groups"]

#: the first scale of the JAX deep stream: a mirror of ``hw·2^s`` at
#: least this many columns (pallas_deep.py:119-123)
STREAM_MIN_REACH = 32

# the JAX stream's and pair stream's VMEM budgets and footprints, in
# bytes per (block row × column) (pallas_deep.py:283-310, :670-686)
_STREAM_BUDGET = 16 << 20
_STREAM_PER_ELEM = {4: 30 * 4, 2: 21 * 4}
_STREAM2_BUDGET = 16 << 20
_STREAM2_PER_ELEM = {4: 53 * 4, 2: 38 * 4}


def _block_rows(H: int, W: int, D: int, per_elem: int, budget: int) -> int:
    for T in (32, 16, 8):
        if D % T or H % T:
            continue
        if per_elem * T * W <= budget:
            return T
    return 0


def stream_rows(H: int, W: int, D: int, itemsize: int = 2) -> int:
    """The JAX stream's block height (``_stream_rows``): 32, 16 or 8 rows
    dividing ``D`` and ``H`` within the VMEM budget, else 0."""
    return _block_rows(H, W, D, _STREAM_PER_ELEM[itemsize], _STREAM_BUDGET)


def stream2_rows(H: int, W: int, D: int, itemsize: int = 2) -> int:
    """The JAX pair stream's block height (``_stream2_rows``), else 0."""
    return _block_rows(H, W, D, _STREAM2_PER_ELEM[itemsize], _STREAM2_BUDGET)


def lowp_can_deep(H: int, W: int, sf: ScalingFunction, s: int) -> bool:
    """The JAX ``can_deep`` for a bfloat16 carry (its stream; the
    BlockSpec fallback is float32 only): ``W % 128 == 0``, one
    reflection (``2hw·D ≤ H``), ``hw·D ≥ 32``, ``D | H``, ``H/D ≥ 2hw``
    and a stream block within the budget (:func:`stream_rows`)."""
    D, hw = 1 << s, sf.half_width
    return (W % 128 == 0 and 2 * hw * D <= H
            and hw * D >= STREAM_MIN_REACH and H % D == 0
            and H // D >= 2 * hw and stream_rows(H, W, D) > 0)


def lowp_can_pair(H: int, W: int, sf: ScalingFunction, s: int) -> bool:
    """The JAX ``can_deep2`` for a bfloat16 carry: ``W % 128 == 0``,
    ``hw·D ≥ 32``, ``D | H``, ``H/D ≥ 5hw + 1``, ``W ≥ 4hw·D`` and a
    pair-stream block within the budget (:func:`stream2_rows`)."""
    D, hw = 1 << s, sf.half_width
    return (W % 128 == 0 and hw * D >= STREAM_MIN_REACH and H % D == 0
            and H // D >= 5 * hw + 1 and W >= 4 * hw * D
            and stream2_rows(H, W, D) > 0)


def lowp_padded_deep(H: int, W: int, sf: ScalingFunction, s: int) -> bool:
    """The JAX ``_padded_deep_plan``: the stream on the carry padded by
    the scale's reach, where the padded area stays under 1.8×."""
    D = 1 << s
    reach = 2 * sf.half_width * D
    Hp = -(-(H + 2 * reach) // D) * D
    Wp = -(-(W + 2 * reach) // 128) * 128
    return Hp * Wp <= 1.8 * H * W and lowp_can_deep(Hp, Wp, sf, s)


def lowp_deep_start(H: int, W: int, sf: ScalingFunction) -> int:
    """The first scale the JAX deep stream owns, directly or padded
    (``_deep_start``): 4 for the B3spline and 5 for the Triangle on most
    frames of 256-multiple sides; 16 where the stream's budget refuses
    every scale (a bfloat16 row past about 25000 columns)."""
    s = 0
    while not (lowp_can_deep(H, W, sf, s) or lowp_padded_deep(H, W, sf, s)):
        s += 1
        if s > 16:
            return 16
    return s


# ---------------------------------------------------------------------
# The JAX whiten-group planner (pallas_conv.py), for bfloat16: the split
# of the scales below the deep start into groups decides where the recon
# rounds (each group sums its whites in float32 and rounds once).
# ---------------------------------------------------------------------

_MAX_FUSED_LEVELS = 6
_N_SLOTS = 2
_BW = 700e9
_STEP_OVH = 4e-6
_VPU_EFF = 1.1e12
_TILE_BUDGET = 90 << 20
_TILE_SIZES = (1024, 768, 512, 384, 256, 128)


def _wow_group_halo(hw: int, offset: int, g: int) -> int:
    return hw * (2 ** offset) * (3 * (2 ** (g - 1)) - 1)


def _aligned_halos(R: int) -> Tuple[int, int]:
    return max(-(-R // 16) * 16, 16), max(-(-R // 64) * 64, 64)


def _vmem_bytes(TH, TW, level, R, itemsize, reuse):
    Rr, Rc = _aligned_halos(R)
    window = (TH + 2 * Rr) * (TW + 2 * Rc)
    n_temps = 1 if itemsize == 4 else 2
    out_win = 2 * (level + 1) * TH * TW * itemsize + 2 * TH * TW * itemsize
    edge = _N_SLOTS * (TH + 2 * Rr) * 2 * Rc * itemsize if reuse else 0
    return ((_N_SLOTS + 3) * window * itemsize + n_temps * window * 4
            + out_win + edge)


def _group_cost(H, W, g, R, TH, TW, itemsize):
    Rr, Rc = _aligned_halos(R)
    steps = (H // TH) * (W // TW)
    if W // TW > 1:
        amp = (1 + 2 * Rr / TH) * (1 + 2 * Rc / W)
    else:
        amp = (TH + 2 * Rr) * (TW + 2 * Rc) / (TH * TW)
    bytes_ = H * W * itemsize * (amp + g + 2)
    vpu_amp = (TH + 2 * Rr) * (TW + 2 * Rc) / (TH * TW)
    vpu = H * W * vpu_amp * g * 4 * 6
    return bytes_ / _BW + vpu / _VPU_EFF + steps * _STEP_OVH


def _padded(n: int, R: int, T: int) -> int:
    return n if n % T == 0 else -(-(n + R) // T) * T


def _plan_tiles(H, W, level, R, itemsize) -> Optional[Tuple[int, int]]:
    cands = []
    for TH in _TILE_SIZES:
        Hp = _padded(H, R, TH)
        for TW in _TILE_SIZES:
            Wp = _padded(W, R, TW)
            if max(_aligned_halos(R)) > min(TH, TW):
                continue
            if _vmem_bytes(TH, TW, level, R, itemsize,
                           Wp // TW > 1) <= _TILE_BUDGET:
                cands.append((_group_cost(Hp, Wp, level, R, TH, TW,
                                          itemsize), Hp * Wp, TH, TW))
    if not cands:
        return None
    min_area = min(c[1] for c in cands)
    _, _, TH, TW = min(c for c in cands if c[1] <= 1.15 * min_area)
    return TH, TW


def _plan_wow_groups(H, W, level, hw, itemsize):
    INF = float("inf")
    best = [(0.0, None)] * (level + 1)
    for s in range(level - 1, -1, -1):
        cands = [(INF, None)]
        for g in range(1, min(level - s, _MAX_FUSED_LEVELS) + 1):
            R = _wow_group_halo(hw, s, g)
            tiles = _plan_tiles(H, W, g, R, itemsize)
            if tiles is None:
                continue
            c = _group_cost(H, W, g, R, *tiles, itemsize)
            if s + g < level:
                c += 2 * H * W * itemsize / _BW
            if best[s + g][0] < INF or s + g == level:
                cands.append((c + best[s + g][0], g))
        best[s] = min(cands, key=lambda t: t[0])
    groups, s = [], 0
    while s < level and best[s][1] is not None:
        groups.append((s, best[s][1]))
        s += best[s][1]
    return groups, s


def lowp_groups(H: int, W: int, level: int,
                hw: int) -> Tuple[List[Tuple[int, int]], int]:
    """The JAX ``plan_wow_prefix`` for bfloat16: the groups ``(offset,
    g)`` of the longest prefix of scales ``0..k−1`` that its cost model
    covers, and ``k``.  One group ``(0, 4)`` for the B3spline below the
    deep start on most frames; ``[(0, 4), (4, 1), (5, 2), (7, 1)]`` at
    256×25600, eight scales."""
    groups, k = _lowp_groups(H, W, level, hw)
    return list(groups), k


@functools.lru_cache(maxsize=None)
def _lowp_groups(H, W, level, hw):
    # the cost model takes about 1.7 ms of host time a call: once a shape
    for k in range(level, 0, -1):
        groups, covered = _plan_wow_groups(H, W, k, hw, 2)
        if covered == k:
            return tuple(groups), k
    return (), 0
