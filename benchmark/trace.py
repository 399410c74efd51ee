"""Reading a ``torch.profiler`` Chrome trace of the traced slice.

The harness marks every call with two host spans of its own,
``bench.dispatch`` (the entry call and the event recorded after it) and
``bench.wait`` (the wait for the call's event).  The traced window runs
from the first dispatch's start to the last wait's end; device activity
(kernels, copies, memsets) is clipped to it.
"""

from __future__ import annotations

import collections
import json
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
DISPATCH, WAIT = "bench.dispatch", "bench.wait"
TOP = 10


def load_events(path: str) -> List[dict]:
    with open(path) as fh:
        doc = json.load(fh)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _label_gaps(gaps, host) -> List[str]:
    """The host's activity at each gap's midpoint, ``outer > inner``: the
    outermost and innermost spans of the harness thread covering it."""
    mids = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    host = sorted(host, key=lambda e: (e[0], -e[1]))
    labels = ["host: no span"] * len(gaps)
    stack: List[Tuple[float, float, str]] = []
    k = 0
    for gi in mids:
        m = (gaps[gi][0] + gaps[gi][1]) / 2
        while k < len(host) and host[k][0] <= m:
            while stack and stack[-1][1] <= host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        live = [s for s in stack if s[0] <= m <= s[1]]
        if live:
            outer, inner = live[0][2], live[-1][2]
            labels[gi] = outer if outer == inner else f"{outer} > {inner}"
    return labels


def summarize(events: List[dict]) -> Optional[Dict]:
    """``window_s``, ``busy_s``, ``calls``, ``kernels`` and the breakdown
    of the traced slice, or None where the trace holds no marked call."""
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] in (DISPATCH, WAIT)]
    dispatch = [e for e in spans if e["name"] == DISPATCH]
    waits = [e for e in spans if e["name"] == WAIT]
    if not dispatch or not waits:
        return None
    t0 = min(e["ts"] for e in dispatch)
    t1 = max(e["ts"] + e["dur"] for e in waits)
    device = []
    kernels = 0
    by_name: Dict[str, float] = collections.defaultdict(float)
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if b <= a:
            continue
        device.append((a, b))
        by_name[e["name"][:96]] += (b - a) * 1e-6
        if e["cat"] == "kernel":
            kernels += 1
    busy = _union(device)
    gaps, cur = [], t0
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if cur < t1:
        gaps.append((cur, t1))
    tid = dispatch[0].get("tid")
    host = [(e["ts"], e["ts"] + e["dur"], e["name"][:64]) for e in events
            if e.get("cat") in HOST_CATS and e.get("tid") == tid
            and e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    idle: Dict[str, float] = collections.defaultdict(float)
    for (a, b), label in zip(gaps, _label_gaps(gaps, host)):
        idle[label] += (b - a) * 1e-6
    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "calls": len(dispatch),
        "kernels": kernels,
        "device_ops": sorted(([n, s] for n, s in by_name.items()),
                             key=lambda x: -x[1])[:TOP],
        "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                            key=lambda x: -x[1])[:TOP],
    }
