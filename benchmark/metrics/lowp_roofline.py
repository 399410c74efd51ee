"""The share of their roofline that the bfloat16 route's whitening kernels
reach, in percent: the frozen bytes of those launches a call
(``kernel_bytes`` of ``cost/<config>.py``) at the card's memory peak, over
the device time a call of those kernels takes in the traced slice.  The
kernels are found in the slice's ``device_ops`` by the names below (kernel
A's streamed group and deep step, kernel E's stream).  None without a
trace, without a frozen count, or where none of them ran."""

from benchmark.cost.h100 import PEAK_BYTES

#: the kernels' function names, as the trace gives them
KERNELS = ("whiten_stream<", "deep_stream<", "pair_stream<")


def read(ctx):
    t = ctx.trace
    moved = ctx.work.get("kernel_bytes")
    if t is None or t["calls"] == 0 or not moved:
        return None
    secs = sum(s for name, s in t["device_ops"]
               if any(k in name for k in KERNELS))
    if secs <= 0:
        return None
    return 100.0 * (moved / PEAK_BYTES) / (secs / t["calls"])
