"""The card's published peaks and the per-pixel operation counts that the
cost files of the configurations price a call with.

Copied from the program's instruments (``utils/profiling.py``), so that
the yardstick stays fixed when the program changes.  NVIDIA H100 SXM data
sheet, dense rates at the 700 W limit.
"""

#: device memory, bytes/s
PEAK_BYTES = 3.35e12
#: float32 FLOP/s outside the tensor cores
PEAK_F32 = 67e12

#: a 5-tap symmetric fold: one multiply and two adds, one multiply per tap
#: pair (7), two per separable smooth
FOLD_OPS = 7
#: one accurate ``expf`` (range reduction, ex2, scaling)
EXPF_OPS = 8
#: the range-weighted taps of one bilateral smooth (5×5 less the centre)
BIL_TAPS = 24
#: one whitened scale of standard WOW per pixel: the chain smooth and the
#: power smooth, two separable folds each, and 8 more (detail, square,
#: clamp, sqrt, mask, division, product, sum)
WHITEN_SCALE_OPS = 4 * FOLD_OPS + 8
#: one bilateral chain smooth per pixel and scale: rows moments (two
#: folds, five squares) 19, cols moments and range factor 20, 24 taps of
#: 7 operations and one expf, 3 to finish (centre, division, detail)
BIL_OPS = 19 + 20 + BIL_TAPS * (7 + EXPF_OPS) + 3
#: the power smooth (two folds, five squares) and the whitening epilogue
#: (clamp, sqrt, mask, division, product, recon add) of a bilateral scale
BIL_WHITEN_OPS = 2 * FOLD_OPS + 5 + 12


#: bytes an element of each frame type: input and outputs alike
ITEM_BYTES = {"float32": 4, "bfloat16": 2}


def auto_scales(height: int, width: int, n_taps: int = 5) -> int:
    """watroo's automatic scale count, ``round(log2(min side) - log2(taps))``."""
    import math
    return int(round(math.log2(min(height, width)) - math.log2(n_taps)))


def wow_work(config: dict, traffic: dict, ops_per_scale: int) -> dict:
    """The work of one call, counted once whatever implements it: each
    input byte read once, each output byte the call returns written once
    (the recon, and the whitened planes where the entry returns them, in
    the configuration's ``dtype``),
    and ``ops_per_scale`` float32 operations a pixel and scale."""
    h, w = int(config["height"]), int(config["width"])
    n = config["n_scales"] or auto_scales(h, w)
    frames = int(traffic["batch"])
    pixels = frames * h * w
    planes = (n + 1) if traffic.get("with_coefficients", True) else 0
    size = ITEM_BYTES[config["dtype"]]
    return {"frames": frames, "scales": n,
            "bytes": size * float(pixels) * (1 + 1 + planes),
            "ops": float(pixels) * n * ops_per_scale}


def least_seconds(work: dict) -> float:
    """The least time the card could take: bytes at the memory peak or
    operations at the float32 peak, whichever is longer."""
    return max(work["bytes"] / PEAK_BYTES, work["ops"] / PEAK_F32)
