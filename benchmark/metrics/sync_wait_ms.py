"""Host milliseconds a call spent inside ``wt.sync.*`` spans, the places
where the program's dispatch waits for the card, read from
``wavelets_tpu_torch.tracing`` over its outermost entry spans while armed:
in a ``--trace 1`` run, the traced slice.  None where the port has no
tracing module or recorded no entry span."""

from benchmark.metrics.host_syncs_per_call import _totals


def read(ctx):
    t = _totals()
    if t is None:
        return None
    wait = sum(v["total_s"] for name, v in t["spans"].items()
               if name.startswith("wt.sync."))
    return 1e3 * wait / sum(t["calls"].values())
