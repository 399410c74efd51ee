"""Build and load the hand-written CUDA kernels of ``wavelets_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use, by ``nvcc`` alone (no PyTorch headers, so a build takes
seconds), into ``build/kernels/<name>-<hash>.so`` at the repository
root, then loaded with ``ctypes``.  The hash is that of the source and
of the shared headers (``csrc/*.cuh``), so an edited source or header is
rebuilt and a stale library is never loaded.  :func:`build_all` starts
one ``nvcc`` per source, all at once.
Pointers and the stream are passed as ``ctypes.c_void_p`` taken from
``tensor.data_ptr()`` and ``torch.cuda.current_stream().cuda_stream``.

Nothing here runs at import time: the CPU tests import every module.

The launch counters ``LAUNCHES`` and ``PLAIN_CALLS``, ``reset_counters``
and ``counter`` live in ``wavelets_tpu_torch/tracing.py``, with the
spans; they are exported here under the same names.  A kernel's first
:func:`load` in a process is the span ``wt.build.<name>``, and each
``nvcc`` run is counted while spans are armed.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

from .. import tracing
from ..tracing import LAUNCHES, PLAIN_CALLS, counter, reset_counters

__all__ = ["LAUNCHES", "PLAIN_CALLS", "reset_counters", "dtype_suffix",
           "counter", "load",
           "build_all", "check", "stream_ptr", "CSRC_DIR", "BUILD_DIR"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: seconds and compiler output of each build made by this process
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def dtype_suffix(dtype) -> str:
    """The suffix of a kernel's entry for tensors of ``dtype``: ``bf16``
    (its bfloat16 form) for bfloat16, else ``f32``."""
    return "bf16" if dtype == torch.bfloat16 else "f32"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source hash
    exists; raise with nvcc's output if the build fails."""
    out = _library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name and rename: a concurrent build never
    # loads a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[name] = (time.perf_counter() - t0, proc.stderr)
    tracing.built(name)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with tracing.span("wt.build." + name):
        lib = ctypes.CDLL(str(_build(name)))
    lib.wt_error_string.argtypes = [ctypes.c_int]
    lib.wt_error_string.restype = ctypes.c_char_p
    return lib


def build_all() -> Dict[str, Path]:
    """Build every kernel source, one ``nvcc`` each, all at once, then
    load them; returns name → library path."""
    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build, names))
    for name in names:
        load(name)
    return {name: _library_path(name) for name in names}


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (its return value
    is ``cudaGetLastError()`` after its launches, or a bad argument)."""
    if code != 0:
        msg = lib.wt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
