"""Where a benchmark cell's calls spend their time, by the port's spans.

    python3 scripts/span_times.py --workload aia_wow.frame --calls 200

In one process, the cell's frames, entry and closed loop as the benchmark
makes them (``benchmark/harness.py``), a warm-up of two rounds of the
pool, then:

1. ``wavelets_tpu_torch.tracing.record()`` over ``--calls`` calls, no
   profiler: host ms a call by span, total and self (the split of the
   dispatch by layer), and the mean dispatch;
2. a ``torch.profiler`` trace of ``--calls`` more calls: device ms a call
   under each span, each kernel, copy and memset given to the innermost
   span around the host call that launched it; kernel spans by scale
   (``name@scale``), the recorder's scales matched to the trace's spans
   in order.

The last line is one JSON object.  ``--device cpu --size 128 128``
rehearses it on the CPU (no device times there).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run as _run  # noqa: E402,F401  (the build cache paths)

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _key(name, scale):
    return name if scale is None else f"{name}@{scale}"


def device_by_span(events, log):
    """Device seconds by innermost span (``name@scale``) of a Chrome
    trace's events; ``log``: the recorder's spans of the same calls."""
    host = sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith("wt.")),
                  key=lambda e: (e["ts"], -e["dur"]))
    scales = collections.defaultdict(list)
    for sp in sorted(log, key=lambda s: s.start):
        scales[sp.name].append(sp.scale)
    seen = collections.Counter()
    for e in host:
        got = scales[e["name"]]
        k = seen[e["name"]]
        e["key"] = _key(e["name"], got[k] if k < len(got) else None)
        seen[e["name"]] += 1
    by_tid = collections.defaultdict(list)
    for e in host:
        by_tid[e.get("tid")].append(e)
    starts = {t: [e["ts"] for e in es] for t, es in by_tid.items()}
    launched = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if corr is not None and e.get("cat") in ("cuda_runtime",
                                                 "cuda_driver"):
            launched[corr] = e
    out = collections.defaultdict(float)
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        r = launched.get(e.get("args", {}).get("correlation"))
        key = "no span"
        if r is not None:
            spans, ts = by_tid.get(r.get("tid"), []), r["ts"]
            # the innermost span around the launch: the latest start
            # before it whose end is after it
            i = bisect.bisect_right(starts.get(r.get("tid"), []), ts)
            for h in reversed(spans[:i]):
                if h["ts"] + h["dur"] >= ts:
                    key = h["key"]
                    break
        out[key] += e["dur"] * 1e-6
    return dict(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--size", type=int, nargs=2, default=None)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import frames, harness

    device = torch.device(args.device)
    cell = harness.resolve(harness.load_spec(), args.workload)
    config, traffic = dict(cell.config), cell.traffic
    if args.size:
        config["height"], config["width"] = args.size
    wt = harness.import_port()
    from wavelets_tpu_torch import tracing

    batches = cell.entry.inputs(frames.make_frames(
        config, int(traffic["pool"]), args.seed, device), traffic)
    call = cell.entry.call(wt, config, traffic)
    loop = dict(in_flight=int(traffic["in_flight"]), calls=args.calls)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    harness.serve(call, batches, device, in_flight=loop["in_flight"],
                  calls=2 * len(batches))
    sync()
    tracing.reset()
    with tracing.record():
        w = harness.serve(call, batches, device, **loop)
        sync()
    t = tracing.totals()
    n = sum(t["calls"].values())
    host = {name: {"total_ms": 1e3 * v["total_s"] / n,
                   "self_ms": 1e3 * v["self_s"] / n}
            for name, v in sorted(t["spans"].items())}
    dispatch = 1e3 * sum(r[1] - r[0] for r in w["records"]) / len(
        w["records"])

    tracing.reset()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        harness.serve(call, batches, device, spans=True, **loop)
        sync()
    n_traced = sum(tracing.totals()["calls"].values())
    fd, path = tempfile.mkstemp(prefix="span-times-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            doc = json.load(fh)
    finally:
        os.unlink(path)
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"
              and "dur" in e]
    dev = device_by_span(events, tracing.spans())
    result = {
        "workload": args.workload, "calls": n, "traced_calls": n_traced,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "dispatch_ms": dispatch, "host_ms": host,
        "syncs_per_call": sum(t["syncs"].values()) / n,
        "device_ms": {k: 1e3 * v / n_traced for k, v in sorted(
            dev.items(), key=lambda kv: -kv[1])},
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
