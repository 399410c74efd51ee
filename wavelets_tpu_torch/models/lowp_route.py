"""Which bfloat16 frames take the merged route: the JAX package's gate.

The bfloat16 merged route is float32 inside (its whites, residual plane
and recon round once, on store), so its geometry is the float32
route's: one group of kernel A, deep steps and pairs
(``models/wow.py::_wow_body_merged``); which kernel takes a scale does not
change a white.  Which frames merge at all stays the JAX package's
answer (``_can_merge_whiten`` for bfloat16, wavelets_tpu/models/wow.py:
501-560, ops/pallas_deep.py:98-129 and :296-310) until the
low-precision plain routes decide otherwise (ROADMAP C4).  Its
predicates are copied here as **shape predicates**: they describe the
JAX deep stream on a TPU (VMEM budget included), not an H100 launch.
"""

from __future__ import annotations

from ..ops.filters import ScalingFunction

__all__ = ["STREAM_MIN_REACH", "stream_rows", "lowp_can_deep",
           "lowp_padded_deep", "lowp_deep_start", "lowp_merges_shape"]

#: the first scale of the JAX deep stream: a mirror of ``hw·2^s`` at
#: least this many columns (pallas_deep.py:119-123)
STREAM_MIN_REACH = 32

# the JAX stream's VMEM budget and bfloat16 footprint, in bytes per
# (block row × column) (pallas_deep.py:283-310)
_STREAM_BUDGET = 16 << 20
_STREAM_PER_ELEM = 21 * 4

#: the JAX group planner's widest tile: past ``hw·2^s = 512`` one scale's
#: halo (``2·hw·2^s``) no longer fits it, so the scales below the deep
#: stream cannot be covered (pallas_conv.py:380-540)
_GROUP_REACH = 512


def stream_rows(H: int, W: int, D: int) -> int:
    """The JAX bfloat16 stream's block height (``_stream_rows``): 32, 16
    or 8 rows dividing ``D`` and ``H`` within the VMEM budget, else 0."""
    for T in (32, 16, 8):
        if D % T or H % T:
            continue
        if _STREAM_PER_ELEM * T * W <= _STREAM_BUDGET:
            return T
    return 0


def lowp_can_deep(H: int, W: int, sf: ScalingFunction, s: int) -> bool:
    """The JAX ``can_deep`` for a bfloat16 carry (its stream; the
    BlockSpec fallback is float32 only): ``W % 128 == 0``, one
    reflection (``2hw·D ≤ H``), ``hw·D ≥ 32``, ``D | H``, ``H/D ≥ 2hw``
    and a stream block within the budget (:func:`stream_rows`)."""
    D, hw = 1 << s, sf.half_width
    return (W % 128 == 0 and 2 * hw * D <= H
            and hw * D >= STREAM_MIN_REACH and H % D == 0
            and H // D >= 2 * hw and stream_rows(H, W, D) > 0)


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


def lowp_merges_shape(H: int, W: int, sf: ScalingFunction,
                      n_scales: int) -> bool:
    """The shape half of the JAX bfloat16 merged gate: sides that are
    multiples of 256, the group planner able to cover every scale below
    :func:`lowp_deep_start` (the last of them reaches less than
    ``_GROUP_REACH``), and every deeper scale on the JAX stream
    (:func:`lowp_can_deep`)."""
    if H % 256 or W % 256:
        return False
    n_fast = min(n_scales, lowp_deep_start(H, W, sf))
    if n_fast and sf.half_width << (n_fast - 1) >= _GROUP_REACH:
        return False
    return all(lowp_can_deep(H, W, sf, s) for s in range(n_fast, n_scales))
