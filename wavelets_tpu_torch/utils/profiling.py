"""Timing and roofline instrumentation for the H100.

Counterpart of ``wavelets_tpu/utils/profiling.py``:

* :class:`StageTimer` — per-stage times, CUDA events on the card and the
  host's ``perf_counter`` on the CPU;
* :class:`Cost`, :func:`decompose_cost` and :func:`wow_cost` — the JAX
  package's analytic counts (bytes moved, FLOPs), kept here as a copy;
* :func:`roofline` — a measured time against the bound of a cost;
* :func:`trace` — a ``torch.profiler`` trace of a block;
* the H100 SXM's published peaks and the operation counts that
  ``chip_smoke.py`` prices its kernels with (:func:`bound_ms`), so one
  place owns the card's roofline.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..api import DEFAULT_DEVICE, _target_device
from ..ops.filters import ScalingFunction

__all__ = ["StageTimer", "Cost", "decompose_cost", "wow_cost", "roofline",
           "device_sync", "trace", "bound_ms", "group_bytes", "step_bytes",
           "pair_bytes", "WHITEN_SCALE_OPS", "H100_HBM_GBPS",
           "H100_F32_GFLOPS", "count_collectives", "halo_step_bytes",
           "halo_step_ops"]

# ---- the card: NVIDIA H100 SXM, published peaks (data sheet, 700 W) ----
#: device memory, bytes/s
PEAK_BYTES = 3.35e12
#: float32 FLOP/s outside the tensor cores
PEAK_F32 = 67e12
H100_HBM_GBPS = PEAK_BYTES / 1e9
H100_F32_GFLOPS = PEAK_F32 / 1e9
#: float32 instruction issue (an FMA counts two of the 67 TFLOP/s) and the
#: special-function pipe (16 ex2 a clock on each of 132 SMs at 1.98 GHz)
PEAK_F32_INSTR = PEAK_F32 / 2
PEAK_SFU = 132 * 16 * 1.98e9

# ---- operation counts of the kernels' work (chip_smoke.py's bounds) ----
#: float32 operations per output pixel and scale: a 5-tap fold is one
#: multiply and two adds plus one multiply per tap pair (7), two per
#: separable smooth
FOLD_OPS = 7
#: float32 instructions of one accurate ``expf`` (range reduction, ex2,
#: scaling), as counted for the bilateral kernels' bound
EXPF_OPS = 8
#: the range-weighted taps of one bilateral chain smooth (5×5 less the
#: centre)
BIL_TAPS = 24
#: one bilateral chain smooth per pixel and scale (kernels F and G): rows
#: moments (two folds, five squares) 19, cols moments and range factor
#: (two folds, mean², difference, clamp, two products, division) 20, 24
#: taps of 7 operations and one expf, 3 to finish (centre, division,
#: detail)
BIL_OPS = 19 + 20 + BIL_TAPS * (7 + EXPF_OPS) + 3
#: kernel G's power smooth (two folds, five squares) and whitening
#: epilogue (clamp, sqrt, mask, division, product, recon add)
BIL_WHITEN_OPS = 2 * FOLD_OPS + 5 + 12


#: one whitened scale per pixel (kernels A and E): the chain smooth and
#: the power smooth, two separable folds each, and 8 more (detail,
#: square, clamp, sqrt, mask, division, product, sum); the bfloat16 forms
#: fold in float32 too
WHITEN_SCALE_OPS = 4 * FOLD_OPS + 8


# ---- bytes of kernels A and E: each input read once, each output
# written once; the frame and the whites ``itemsize`` bytes an element
# (4 float32, 2 bfloat16), the carries and recon float32 in both routes ----

def group_bytes(pixels: int, g: int, need_cube: bool = True,
                itemsize: int = 4) -> int:
    """Kernel A's group of ``g`` scales: read the frame, write the ``g``
    whites (with ``need_cube``), the carry and acc."""
    return pixels * (itemsize * (1 + (g if need_cube else 0)) + 2 * 4)


def step_bytes(pixels: int, recon: bool = True, white: bool = True,
               itemsize: int = 4) -> int:
    """Kernel A's deep step: read the carry (and recon), write c_next, the
    white and recon; the float32 detail between its two launches is
    scratch, not the function's."""
    return pixels * (4 * (2 + 2 * int(recon)) + itemsize * int(white))


def pair_bytes(pixels: int, recon: bool = True, whites: bool = True,
               itemsize: int = 4) -> int:
    """Kernel E: read the carry (and recon), write c_next2, two whites and
    recon."""
    return pixels * (4 * (2 + 2 * int(recon)) + itemsize * 2 * int(whites))


def halo_step_bytes(H: int, W: int, halo: int, itemsize: int = 4) -> int:
    """Kernel A's deep step in halo mode on a band of ``H`` interior rows:
    read the carry extended by ``halo`` rows a side and recon, write
    c_next, the white and recon."""
    return W * itemsize * ((H + 2 * halo) + 4 * H)


def halo_step_ops(H: int, W: int, halo: int) -> int:
    """Its float32 operations: the chain smooth and the detail on the
    ``H + halo`` rows the power smooth reads, then the power smooth and
    the epilogue on the ``H`` interior rows."""
    return W * ((H + halo) * (2 * FOLD_OPS + 1) + H * (2 * FOLD_OPS + 7))


def bound_ms(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """The least time the H100 could take for work that moves ``n_bytes``
    (each input read once, each output written once) and does ``n_ops``
    float32 operations: ``(ms, "bytes" or "operations")``."""
    t_b, t_o = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def device_sync(device=None) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    device = torch.device(DEFAULT_DEVICE if device is None else device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str, device=DEFAULT_DEVICE):
    """``torch.profiler`` trace of the enclosed block, written as a Chrome
    trace to ``log_dir/trace.json`` (open with Perfetto); the profiler is
    yielded for ``key_averages()``.  Traces the card's kernels on a CUDA
    ``device``, the host's operations only on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    device = _target_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        device_sync(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclasses.dataclass
class Cost:
    """Analytic cost of a pipeline stage."""

    flops: float
    hbm_bytes: float

    def bound_ms(self, bw_gbps: float = H100_HBM_GBPS,
                 flops_gflops: float = H100_F32_GFLOPS) -> float:
        """Roofline bound (ms): the larger of the bandwidth and compute
        limits, at the H100 SXM's peaks unless others are given."""
        t_bw = self.hbm_bytes / (bw_gbps * 1e9)
        t_fl = self.flops / (flops_gflops * 1e9)
        return max(t_bw, t_fl) * 1e3

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.flops + other.flops,
                    self.hbm_bytes + other.hbm_bytes)


def decompose_cost(shape: Tuple[int, ...], level: int,
                   sf: ScalingFunction, itemsize: int = 4) -> Cost:
    """Ideal cost of a ``level``-scale decomposition: read the image
    once, write ``level+1`` planes, ``2·k`` taps of multiply-add per
    element per scale (separable passes)."""
    n = float(np.prod(shape))
    k = len(sf.taps)
    flops = n * level * 2 * (2 * k)
    bytes_ = n * itemsize * (1 + (level + 1))
    return Cost(flops, bytes_)


def wow_cost(shape: Tuple[int, ...], n_scales: int, sf: ScalingFunction,
             denoise: bool = False, itemsize: int = 4) -> Cost:
    """Ideal cost of standard WOW: decomposition, per-scale local power
    smoothing, elementwise whitening and synthesis."""
    n = float(np.prod(shape))
    k = len(sf.taps)
    c = decompose_cost(shape, n_scales, sf, itemsize)
    flops = c.flops + n * n_scales * (2 * (2 * k) + 8)
    bytes_ = c.hbm_bytes + n * itemsize * (2 * (n_scales + 1) + 1)
    if denoise:
        flops += n * 10
        bytes_ += n * itemsize * 10
    return Cost(flops, bytes_)


class _Clock:
    """Start/stop timing of one stage: CUDA events on the card, the host
    clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self.a.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        """Seconds since :meth:`start`, waiting for the card's work."""
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            return self.a.elapsed_time(self.b) / 1e3
        return time.perf_counter() - self.t0


class StageTimer:
    """Per-stage times in seconds: CUDA events on a CUDA ``device`` (the
    default), the host's ``perf_counter`` on the CPU.

    >>> t = StageTimer(device="cpu")
    >>> with t.stage("decompose"):
    ...     planes = decompose(x, 6, B3SPLINE)
    >>> print(t.report())
    """

    def __init__(self, device=DEFAULT_DEVICE):
        self.device = _target_device(device)
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time the enclosed block; yields a dict, as the JAX package's
        timer does (its ``"out"`` entry is not needed to synchronize)."""
        clock = _Clock(self.device)
        box = {}
        clock.start()
        try:
            yield box
        finally:
            self.times.setdefault(name, []).append(clock.stop())

    def report(self) -> str:
        lines = []
        for name, ts in self.times.items():
            best = min(ts) * 1e3
            lines.append(f"{name:30s} {best:9.3f} ms (best of {len(ts)})")
        return "\n".join(lines)


def roofline(fn: Callable, args: tuple, cost: Cost, iters: int = 10,
             bw_gbps: float = H100_HBM_GBPS,
             flops_gflops: float = H100_F32_GFLOPS,
             device=DEFAULT_DEVICE) -> Dict[str, float]:
    """``fn(*args)`` in steady state (chained when the output has the
    first argument's shape and dtype, else repeated), timed on ``device``
    (CUDA events, or the host clock on the CPU), against the roofline
    bound of ``cost``."""
    clock = _Clock(_target_device(device))
    out = fn(*args)
    chained = (isinstance(out, torch.Tensor) and len(args) >= 1
               and isinstance(args[0], torch.Tensor)
               and out.shape == args[0].shape and out.dtype == args[0].dtype)
    device_sync(device)
    clock.start()
    x = args[0] if args else None
    for _ in range(iters):
        if chained:
            x = fn(x, *args[1:])
        else:
            fn(*args)
    dt = clock.stop() / iters
    bound = cost.bound_ms(bw_gbps, flops_gflops) / 1e3
    return {
        "measured_ms": dt * 1e3,
        "bound_ms": bound * 1e3,
        "roofline_fraction": bound / dt if dt > 0 else 0.0,
        "achieved_gbps": cost.hbm_bytes / dt / 1e9,
        "achieved_gflops": cost.flops / dt / 1e9,
    }


def count_collectives(fn: Callable, *args) -> Dict[str, int]:
    """The collectives that one call ``fn(*args)`` issued from this rank,
    by the JAX package's HLO names (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``collective-permute``, ``all-to-all``; JAX
    ``utils/profiling.py:191``).  The counts are the sharded engine's own
    (``parallel.mesh.COLLECTIVES``, kept by its wrappers), so they are
    the calls made at run time: a loop of collectives counts each round,
    where JAX counts the op once in the compiled program; a halo exchange
    counts two permutes, JAX's two ``ppermute``."""
    from ..parallel.mesh import COLLECTIVES

    before = dict(COLLECTIVES)
    fn(*args)
    return {op: COLLECTIVES[op] - before.get(op, 0)
            for op in ("all-reduce", "all-gather", "reduce-scatter",
                       "collective-permute", "all-to-all")}
