"""Host waits for the card a call: the sync sites (``wt.sync.<site>``) that
``wavelets_tpu_torch.tracing`` counted while its spans were armed, over the
outermost entry spans it recorded then.  In a ``--trace 1`` run the spans
arm under the profiler alone, so both counts are the traced slice's.  None
where the port has no tracing module or recorded no entry span."""

import importlib


def _totals():
    try:
        tracing = importlib.import_module("wavelets_tpu_torch.tracing")
    except ImportError:
        return None
    t = tracing.totals()
    return t if sum(t["calls"].values()) > 0 else None


def read(ctx):
    t = _totals()
    if t is None:
        return None
    return sum(t["syncs"].values()) / sum(t["calls"].values())
