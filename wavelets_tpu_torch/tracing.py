"""Spans and counters of ``wavelets_tpu_torch``: the one home of both.

**Counters.**  ``LAUNCHES[name]`` counts a hand-written kernel's launches
and ``PLAIN_CALLS[name]`` runs of its plain PyTorch version, always, on
and off; a kernel's bfloat16 form counts under :func:`counter`'s name.
A caller clears both (:func:`reset_counters`) to see which path a run
took.  ``ops/_build.py`` exports the same objects under the same names.

**Spans.**  A span marks a layer boundary: the entries (``wt.wow``,
``wt.wow_stack``, ``wt.process_stack``, ``wt.sharded_wow``), the body
``wow_core`` takes (``wt.body.merged``, ``wt.body.fused``,
``wt.body.plain``, ``wt.body.frames``), the stages inside the bodies
(``wt.noise``, ``wt.decompose``, ``wt.deep_tail``, ``wt.residual``),
each kernel wrapper (``wt.k.<its launch counter>``, kernel D's pieces
form ``wt.k.whiten_pieces``; the same span around the plain version,
which counts ``PLAIN_CALLS``), each place the host waits for the card
(``wt.sync.<site>``), the stages of ``process_stack``
(``wt.stack.read``, ``wt.stack.h2d``, ``wt.stack.run``,
``wt.stack.fetch``, ``wt.stack.write``) and a kernel's first load in a
process (``wt.build.<name>``).  Names do not carry the scale; the
recorder keys kernel spans by ``(name, scale)`` as well.

Spans are armed while a ``torch.profiler`` profile runs and inside a
``with record():`` block, and only then.  Disarmed, a span site costs a
flag test and returns a shared null context: no ``record_function``, no
clock read, no allocation.  Armed, a span

* enters ``torch.profiler.record_function(name)`` while a profiler runs,
  so it sits in the profiler's trace beside the kernels, on its clock
  (on the card as ``gpu_user_annotation`` over the kernels it launched);
* keeps, in memory, the stack of open spans, and per name (and per
  kernel and scale) the count, the host seconds and the self seconds
  (its seconds less those of its child spans, whose own bookkeeping and
  ``record_function`` calls fall in the parent's self time); the
  outermost span of a call gives the call id that every span inside it
  shares.  While armed it also counts launches and plain calls by
  kernel, host waits by site and nvcc builds by kernel.

:func:`totals` returns what the recorder holds, :func:`spans` the last
finished spans, :func:`reset` clears both.  The profiler's Chrome trace
is the timeline; nothing here writes a file.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

__all__ = ["LAUNCHES", "PLAIN_CALLS", "reset_counters", "counter",
           "record", "armed", "span", "entry", "launch", "plain", "sync",
           "as_tensor", "built", "totals", "spans", "reset", "Span"]

LAUNCHES: collections.Counter = collections.Counter()
PLAIN_CALLS: collections.Counter = collections.Counter()

#: finished spans the recorder keeps for :func:`spans`, newest last
LOG_SPANS = 1 << 16

_NULL = contextlib.nullcontext()
#: open ``record()`` blocks
_recording = 0


def reset_counters() -> None:
    LAUNCHES.clear()
    PLAIN_CALLS.clear()


def counter(name: str, dtype) -> str:
    """The counter of kernel ``name`` on tensors of ``dtype``: its own
    for float32, ``name`` and ``_bf16`` for its bfloat16 form."""
    return f"{name}_bf16" if dtype == torch.bfloat16 else name


def armed() -> bool:
    """Whether span sites record: inside :func:`record`, or while a
    ``torch.profiler`` profile runs."""
    return _recording > 0 or _profiler._is_profiler_enabled


@contextlib.contextmanager
def record():
    """Arm the spans for the enclosed block, without a profiler."""
    global _recording
    with _recorder.lock:
        _recording += 1
    try:
        yield
    finally:
        with _recorder.lock:
            _recording -= 1


class Span(NamedTuple):
    """A finished span: its call id, its own id and its parent's (None
    for the outermost span of a call), name, scale (None where it has
    none), ``perf_counter`` start and end, and self seconds."""
    call: int
    id: int
    parent: Optional[int]
    name: str
    scale: Optional[int]
    start: float
    end: float
    self_s: float


class _Recorder:
    """What armed spans keep in memory; one per process (:func:`totals`,
    :func:`reset`).  Each thread has its own stack of open spans."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.clear()

    def clear(self):
        with self.lock:
            self.spans: Dict[str, List[float]] = {}
            self.kernels: Dict[tuple, List[float]] = {}
            self.calls = collections.Counter()
            self.launches = collections.Counter()
            self.plain_calls = collections.Counter()
            self.syncs = collections.Counter()
            self.builds = collections.Counter()
            self.log = collections.deque(maxlen=LOG_SPANS)
            self.ids = itertools.count(1)
            self.call_ids = itertools.count(1)

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


_recorder = _Recorder()


def _add(table: dict, key, dur: float, own: float) -> None:
    t = table.get(key)
    if t is None:
        t = table[key] = [0, 0.0, 0.0]
    t[0] += 1
    t[1] += dur
    t[2] += own


class _Open:
    """An armed span; :func:`span` and its kinds make it.  ``tally`` is
    the recorder's counter (an attribute name) and the key it counts
    under; a launch counts only when its block completes, and then in
    ``LAUNCHES`` too."""

    __slots__ = ("name", "scale", "entry", "tally", "stack", "rf", "t0",
                 "inner", "id", "call", "parent")

    def __init__(self, name: str, scale: Optional[int] = None,
                 entry: bool = False, tally: Optional[tuple] = None):
        self.name, self.scale, self.entry = name, scale, entry
        self.tally = tally

    def __enter__(self):
        rec = _recorder
        stack = self.stack = rec.stack()
        # itertools.count is atomic under the interpreter lock
        self.id = next(rec.ids)
        if stack:
            self.call, self.parent = stack[-1].call, stack[-1].id
        else:
            self.call, self.parent = next(rec.call_ids), None
        stack.append(self)
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.inner = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack = self.stack
        if stack and stack[-1] is self:
            stack.pop()
        dur = t1 - self.t0
        own = dur - self.inner
        if stack:
            stack[-1].inner += dur
        rec = _recorder
        with rec.lock:
            if self.entry and self.parent is None:
                rec.calls[self.name] += 1
            if self.tally is not None:
                kind, key = self.tally
                if kind != "launches":
                    getattr(rec, kind)[key] += 1
                elif exc[0] is None:
                    LAUNCHES[key] += 1
                    rec.launches[key] += 1
            _add(rec.spans, self.name, dur, own)
            if self.name.startswith("wt.k."):
                _add(rec.kernels, (self.name, self.scale), dur, own)
            rec.log.append(Span(self.call, self.id, self.parent, self.name,
                                self.scale, self.t0, t1, own))
        return False


def span(name: str, scale: Optional[int] = None):
    """A span named ``name`` (``wt.…``) around the enclosed block."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _NULL
    return _Open(name, scale)


def entry(name: str):
    """Decorator: the entry span ``name`` around every call of the
    function; the outermost entry span of a call counts as a call."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not (_recording or _profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _Open(name, entry=True):
                return fn(*args, **kwargs)
        return run
    return wrap


class _Launch:
    """A disarmed launch site: it counts the launch of its kernel when the
    enclosed block completes (a launch that raises is not counted)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            LAUNCHES[self.name] += 1
        return False


_launches: Dict[str, _Launch] = {}


def launch(name: str, scale: Optional[int] = None,
           label: Optional[str] = None):
    """The span ``wt.k.<label or name>`` around a launch of kernel
    ``name``, counted in ``LAUNCHES`` when the block completes."""
    if not (_recording or _profiler._is_profiler_enabled):
        site = _launches.get(name)
        if site is None:
            site = _launches[name] = _Launch(name)
        return site
    return _Open("wt.k." + (label or name), scale,
                 tally=("launches", name))


def plain(name: str, scale: Optional[int] = None,
          label: Optional[str] = None):
    """Count a run of kernel ``name``'s plain version (``PLAIN_CALLS``)
    and open the kernel's span around it."""
    PLAIN_CALLS[name] += 1
    if not (_recording or _profiler._is_profiler_enabled):
        return _NULL
    return _Open("wt.k." + (label or name), scale,
                 tally=("plain_calls", name))


def _waits_on(device: torch.device) -> bool:
    """Whether the host waits at a sync site on ``device``'s tensors."""
    return device.type == "cuda"


def sync(site: str, device):
    """The span ``wt.sync.<site>`` around a place where the host waits
    for the card, counted under ``site``; nothing off the card."""
    if not (_recording or _profiler._is_profiler_enabled) or not _waits_on(
            torch.device(device)):
        return _NULL
    return _Open("wt.sync." + site, tally=("syncs", site))


def as_tensor(value, *, dtype=None, device, site: str) -> torch.Tensor:
    """``torch.as_tensor(value, dtype=dtype, device=device)``, inside the
    sync span of ``site`` where it copies a host value (a number, a
    sequence or a CPU tensor) to the card: a copy from pageable memory
    without ``non_blocking``, after which PyTorch waits for the stream."""
    if (_recording or _profiler._is_profiler_enabled) and not (
            isinstance(value, torch.Tensor)
            and value.device.type == torch.device(device).type):
        with sync(site, device):
            return torch.as_tensor(value, dtype=dtype, device=device)
    return torch.as_tensor(value, dtype=dtype, device=device)


def built(name: str) -> None:
    """Count an nvcc build of kernel ``name`` while armed."""
    if _recording or _profiler._is_profiler_enabled:
        with _recorder.lock:
            _recorder.builds[name] += 1


def _table(t: dict) -> dict:
    return {k: {"count": v[0], "total_s": v[1], "self_s": v[2]}
            for k, v in t.items()}


def totals() -> dict:
    """What armed spans recorded since the last :func:`reset`:

    * ``spans``: name → ``count``, ``total_s`` (host seconds),
      ``self_s`` (less the child spans' seconds);
    * ``kernels``: ``(span name, scale)`` → the same, kernel spans only;
    * ``calls``: entry name → outermost entry spans (calls);
    * ``launches``, ``plain_calls``: kernel counter → count;
    * ``syncs``: site → host waits; ``builds``: kernel → nvcc builds."""
    rec = _recorder
    with rec.lock:
        return {"spans": _table(rec.spans), "kernels": _table(rec.kernels),
                "calls": dict(rec.calls), "launches": dict(rec.launches),
                "plain_calls": dict(rec.plain_calls),
                "syncs": dict(rec.syncs), "builds": dict(rec.builds)}


def spans() -> List[Span]:
    """The last :data:`LOG_SPANS` finished spans, in the order they
    ended."""
    with _recorder.lock:
        return list(_recorder.log)


def reset() -> None:
    """Clear what the recorder holds (not ``LAUNCHES``/``PLAIN_CALLS``)."""
    _recorder.clear()
