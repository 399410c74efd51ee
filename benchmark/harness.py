"""One run of one cell: set-up, the measured window, the traced slice, and
the check of the window's outputs against the plain reference.

Everything a cell needs is found by name from ``BENCHMARK.json``:

* ``configs/<config>.json`` — the deployment: frame size and type, WOW
  options, the parameters of its frames for the one generator in
  ``frames.py``;
* ``traffic/<traffic>.json`` — how frames are handed to the program:
  the entry, batch, calls in flight, frame pool, frames checked;
* ``entries/<entry>.py`` — the entry a traffic file names: its inputs,
  the timed call, the split of its result into frames, and the plain
  reference of a frame;
* ``cost/<config>.py`` — ``work(config, traffic)``, the work of a call;
* ``metrics/<metric>.py`` — ``read(ctx)`` of each per-layer metric;
* ``limits/<workload>.json`` — each number compared, with its limit and
  the readings the limit was set from, and the type of the control.

The loop is closed with ``in_flight`` calls outstanding: the harness
dispatches call i+1, then waits on a CUDA event recorded after call i.
A call's latency runs from its dispatch until the host sees that event
complete.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import random
import statistics
import sys
import tempfile
import time
from collections import deque
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from benchmark import frames as frame_gen
from benchmark import trace as trace_reader

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PACKAGE = "wavelets_tpu_torch"
#: top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "wavelets_tpu")
#: length of the traced slice after the window, in a ``--trace 1`` run
TRACE_SECONDS = 2.0
#: calls of the warm-up, per batch of the pool
WARM_ROUNDS = 2


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names held in ``sys.modules``, compared
    whole: ``wavelets_tpu_torch`` is not ``wavelets_tpu``."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names.intersection(FORBIDDEN))


# ---- finding a cell's files by name ----

def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _json(kind: str, name: str, bench: Path) -> dict:
    with open(bench / kind / f"{name}.json") as fh:
        return json.load(fh)


def load_module(kind: str, name: str, bench: Optional[Path] = None):
    """``<bench>/<kind>/<name>.py`` as a module of its own."""
    path = (BENCH if bench is None else bench) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(path)
    mod_name = "benchmark_" + kind + "_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    entry: object
    cost: object
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, object]


def resolve(spec: dict, workload: str, bench: Optional[Path] = None) -> Cell:
    """The cell ``workload`` of ``spec`` with every file it names loaded,
    from ``bench`` (this folder by default); raises if one is missing."""
    bench = BENCH if bench is None else bench
    matches = [w for w in spec["workloads"] if w["name"] == workload]
    if len(matches) != 1:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = matches[0]
    per_layer = [m for m in spec["per_layer"] if _applies(m, workload)]
    traffic = _json("traffic", w["traffic"], bench)
    return Cell(
        name=workload, workload=w,
        config=_json("configs", w["config"], bench),
        traffic=traffic,
        entry=load_module("entries", traffic["entry"], bench),
        cost=load_module("cost", w["config"], bench),
        limits={k: v for k, v in _json("limits", workload, bench).items()
                if isinstance(v, dict)},
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=per_layer,
        readers={m["name"]: load_module("metrics", m["name"], bench)
                 for m in per_layer})


def control_dtype(workload: str, bench: Optional[Path] = None) -> torch.dtype:
    """The type the cell's control casts its frames to before each call
    (``control`` in ``limits/<workload>.json``): the program's own path
    one precision below the configuration's."""
    limits = _json("limits", workload, BENCH if bench is None else bench)
    return getattr(torch, limits["control"])


# ---- the program's entry ----

def import_port():
    """The package under test, which must be the checkout's own."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import wavelets_tpu_torch as wt
    where = Path(wt.__file__).resolve()
    if ROOT not in where.parents:
        raise ImportError(f"{PACKAGE} was found at {where}, outside the "
                          f"checkout {ROOT}")
    return wt


# ---- the serving loop ----

class _Done:
    """Completion of a call: a CUDA event on the card; the call itself on
    the CPU, where it has returned complete."""

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()


class Reservoir:
    """A uniform sample of ``k`` of the window's calls, drawn from the
    seed, holding their outputs until the window has closed."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen = k, 0
        self.rng = random.Random(f"check-sample-{seed}")
        self.items: List = []

    def offer(self, index: int, result):
        if len(self.items) < self.k:
            self.items.append((index, result))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = (index, result)
        self.seen += 1


def serve(call: Callable, batches: List[torch.Tensor], device: torch.device,
          *, in_flight: int, seconds: float = math.inf,
          calls: Optional[int] = None, start: int = 0,
          sample: Optional[Reservoir] = None, spans: bool = False) -> dict:
    """The closed loop: dispatch call i, then wait for call
    ``i - in_flight + 1``; stop dispatching after ``seconds`` or ``calls``
    calls, then drain.  Returns each call's ``(start, returned, done)``
    host times and the loop's first start and last done."""
    mark = (torch.profiler.record_function if spans
            else lambda _: contextlib.nullcontext())
    pending = deque()
    records = []
    t0 = time.perf_counter()
    i = 0

    def retire():
        j, ts, tr, done, out = pending.popleft()
        with mark(trace_reader.WAIT):
            done.wait()
        records.append((ts, tr, time.perf_counter()))
        if sample is not None:
            sample.offer(j, out)

    while (calls is None or i < calls) and time.perf_counter() - t0 < seconds:
        x = batches[(start + i) % len(batches)]
        with mark(trace_reader.DISPATCH):
            ts = time.perf_counter()
            out = call(x)
            tr = time.perf_counter()
            done = _Done(device)
        pending.append((start + i, ts, tr, done, out))
        i += 1
        if len(pending) >= in_flight:
            retire()
    while pending:
        retire()
    return {"records": records, "t0": t0,
            "t1": records[-1][2] if records else t0, "next": start + i}


# ---- the check ----

def compare(out: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """``rel_l2``: the norm of the difference over the reference's norm;
    ``max_err``: the largest difference over the reference's largest
    magnitude.  NaN where the output holds one."""
    a, b = out.double(), ref.double()
    diff = a - b
    return {"rel_l2": float(diff.norm() / b.norm()),
            "max_err": float(diff.abs().max() / b.abs().max())}


def check(samples, inputs: List[torch.Tensor], cell: "Cell", config: dict,
          limits: dict) -> dict:
    """Every frame output of the sampled calls against the entry's plain
    reference on the same input frame (the recon and every plane the
    reference gives) → the worst of each number, the count of frames
    judged wrong and of frames compared."""
    worst = {name: 0.0 for name in limits}
    failed = compared = 0
    entry, traffic = cell.entry, cell.traffic
    per_frame = []
    for index, result in samples:
        k = index % len(inputs)
        for b, item in enumerate(entry.split(result, inputs[k])):
            per_frame.append(((k, b),) + item)
    per_frame.sort(key=lambda t: t[0])
    refs: Dict[tuple, tuple] = {}
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for key, frame, recon, planes in per_frame:
            if key not in refs:
                refs.clear()
                refs[key] = entry.reference(frame, config, traffic)
            ref_recon, ref_planes = refs[key]
            numbers = [compare(recon, ref_recon)]
            if len(planes) != len(ref_planes):
                numbers.append({n: math.inf for n in limits})
            numbers += [compare(p, r) for p, r in zip(planes, ref_planes)]
            bad = False
            for name in limits:
                vals = [n[name] for n in numbers]
                # max() would pass over a NaN that is not first
                v = math.nan if any(map(math.isnan, vals)) else max(vals)
                if math.isnan(v) or math.isnan(worst[name]):
                    worst[name] = math.nan
                else:
                    worst[name] = max(worst[name], v)
                bad |= not (v <= limits[name]["limit"])
            failed += bad
            compared += 1
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return {"worst": worst, "failed": failed, "compared": compared}


# ---- one run ----

def quarter_rates(done: List[float], t0: float, batch: int) -> List[float]:
    """Frames completed in each quarter of the window, per second: a rate
    that falls through the window shows the card's clocks settling."""
    if not done:
        return []
    q = (done[-1] - t0) / 4
    counts = [0] * 4
    for t in done:
        counts[min(3, int((t - t0) / q))] += batch
    return [c / q for c in counts]


@dataclasses.dataclass
class Context:
    """What the per-layer readers read."""

    cell: Cell
    work: dict
    window: dict
    loop_peak_bytes: int
    trace: Optional[dict]


def _device_info(device: torch.device, chips: int, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": peak}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def traced_slice(call, batches, device, in_flight: int, start: int,
                 seconds: float) -> Optional[dict]:
    """Profile ``seconds`` more of the same loop and read the trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=activities) as prof:
        serve(call, batches, device, in_flight=in_flight, seconds=seconds,
              start=start, spans=True)
        _sync(device)
    fd, path = tempfile.mkstemp(prefix="bench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace_reader.summarize(trace_reader.load_events(path))
    finally:
        os.unlink(path)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device="cuda", spec: Optional[dict] = None,
             size: Optional[tuple] = None, wrap: Optional[Callable] = None,
             cast: Optional[torch.dtype] = None, log=print) -> dict:
    """One run of ``workload``: the result object of the run's last line,
    without the ``checks`` entry's print.  ``size`` (tests only) replaces
    the configuration's frame size; ``wrap(call)`` replaces the timed
    call (tests plant faults with it); ``cast`` runs the entry on frames
    cast to that dtype (the control)."""
    device = torch.device(device)
    cell = resolve(load_spec() if spec is None else spec, workload)
    config, traffic = dict(cell.config), cell.traffic
    if size is not None:
        config["height"], config["width"] = size
    wt = import_port()
    log(f"setup: port imported {time.perf_counter() - t_start:.3f} s "
        f"after start")
    if device.type == "cuda":
        torch.cuda.init()
        log(f"setup: CUDA ready {time.perf_counter() - t_start:.3f} s")
        from wavelets_tpu_torch.ops import _build
        _build.build_all()
        for name, (secs, _) in sorted(_build.BUILD_LOG.items()):
            log(f"build: nvcc {name}.cu {secs:.3f} s")
        log(f"setup: kernels loaded {time.perf_counter() - t_start:.3f} s")

    batch = int(traffic["batch"])
    pool = frame_gen.make_frames(config, int(traffic["pool"]), seed, device)
    batches = cell.entry.inputs(pool, traffic)
    call = cell.entry.call(wt, config, traffic, cast)
    if wrap is not None:
        call = wrap(call)
    in_flight = int(traffic["in_flight"])
    _sync(device)
    log(f"setup: frames made {time.perf_counter() - t_start:.3f} s")

    # the deployment's footprint: the serving loop's peak, the frame pool
    # and the calls in flight, read over the warm-up (the same calls at
    # the same depth); the window's peak would add the check's sample
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    warm = serve(call, batches, device, in_flight=in_flight,
                 calls=WARM_ROUNDS * len(batches))
    _sync(device)
    loop_peak = (torch.cuda.max_memory_allocated(device)
                 if device.type == "cuda" else 0)
    log(f"setup: warm-up {len(warm['records'])} calls "
        f"{warm['t1'] - warm['t0']:.3f} s")

    sample = Reservoir(max(1, math.ceil(int(traffic["check_frames"]) / batch)),
                       seed)
    # what set-up left behind is never scanned again: a full collection
    # inside the window scans only the window's own objects
    gc.collect()
    gc.freeze()
    gc_before = sum(g["collections"] for g in gc.get_stats()[2:])
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    window = serve(call, batches, device, in_flight=in_flight,
                   seconds=seconds, start=warm["next"], sample=sample)
    gc_window = sum(g["collections"] for g in gc.get_stats()[2:]) - gc_before
    gc.unfreeze()
    traced = None
    if trace:
        traced = traced_slice(call, batches, device, in_flight,
                              window["next"], min(TRACE_SECONDS, seconds))
    _sync(device)
    dev = _device_info(device, int(cell.workload["chips"]), loop_peak)

    verdict = check(sample.items, batches, cell, config, cell.limits)
    sample.items.clear()

    records = window["records"]
    frames_done = len(records) * batch
    window_s = window["t1"] - window["t0"]
    result = {
        "correct": verdict["failed"] == 0 and verdict["compared"] > 0,
        "attempted": frames_done,
        "failed": verdict["failed"],
    }
    ctx = Context(cell=cell, work=cell.cost.work(config, traffic),
                  window=window, loop_peak_bytes=loop_peak, trace=traced)
    if not trace:
        lat = sorted((r[2] - r[0]) * 1e3 for r in records)
        values = {
            "frames_per_s": frames_done / window_s,
            "call_ms_p95": (statistics.quantiles(lat, n=20)[-1]
                            if len(lat) >= 2 else lat[0]),
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    else:
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if traced is not None:
            dev["busy_s"] = traced["busy_s"]
            dev["window_s"] = traced["window_s"]
    result["metrics"] = metrics
    result["device"] = dev
    if trace and traced is not None:
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = {name: {"value": verdict["worst"][name],
                               "limit": cell.limits[name]["limit"]}
                        for name in cell.limits}
    done = [r[2] for r in records]
    longest = max((b - a for a, b in zip(done, done[1:])), default=0.0)
    log(f"window: {len(records)} calls, {frames_done} frames, "
        f"{window_s:.3f} s; longest wait between completions "
        f"{longest * 1e3:.3f} ms; full collections {gc_window}; "
        f"checked {verdict['compared']} frames")
    log("window: frames/s by quarter " + " ".join(
        f"{v:.3f}" for v in quarter_rates(done, window["t0"], batch)))
    if len(records) >= 2:
        # how far the tail of a call's latency follows the host's dispatch
        call_q = statistics.quantiles(
            [(r[2] - r[0]) * 1e3 for r in records], n=100)
        disp_q = statistics.quantiles(
            [(r[1] - r[0]) * 1e3 for r in records], n=100)
        log("window: call ms p50 {:.3f} p95 {:.3f} p99 {:.3f}; dispatch ms "
            "p50 {:.3f} p95 {:.3f} p99 {:.3f}".format(
                call_q[49], call_q[94], call_q[98],
                disp_q[49], disp_q[94], disp_q[98]))
    return result
