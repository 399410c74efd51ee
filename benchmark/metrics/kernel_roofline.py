"""The least time for a call's work (``cost/<config>.py``: each input byte
read once, each returned byte written once, the frozen operation count, at
the card's published peaks) over the device busy time per call in the
traced slice, in percent."""

from benchmark.cost.h100 import least_seconds


def read(ctx):
    t = ctx.trace
    if t is None or t["calls"] == 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * least_seconds(ctx.work) / (t["busy_s"] / t["calls"])
