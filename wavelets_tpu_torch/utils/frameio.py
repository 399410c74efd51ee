"""Frame-stack IO: a reader of raw frame stacks stored on disk.

Counterpart of ``wavelets_tpu/utils/frameio.py`` (the port's own copy):
frames are memory-mapped by the C++ library ``native/frameio.cc`` and
converted to float32 with multi-threaded native conversion and endian
swapping.  The library is built with ``g++`` on first use into
``build/frameio/libwtio-<hash>.so`` at the repository root, keyed by the
hash of the source, so an edited source is rebuilt and no committed or
stale library is ever loaded; where it cannot be built the native reader
raises.  ``native=False`` selects the plain numpy reader of the same
stored layouts (the dtype table, big-endian, a header ``offset``), the
native reader's plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

__all__ = ["FrameStack", "native_available", "write_array"]

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "frameio.cc"
BUILD_DIR = ROOT / "build" / "frameio"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")

#: stored dtype → (its enum in frameio.cc, stored itemsize)
DTYPES = {
    np.dtype(np.uint8): (0, 1),
    np.dtype(np.uint16): (1, 2),
    np.dtype(np.int16): (2, 2),
    np.dtype(np.uint32): (3, 4),
    np.dtype(np.int32): (4, 4),
    np.dtype(np.float32): (5, 4),
    np.dtype(np.float64): (6, 8),
    np.dtype(">u2"): (7, 2),
    np.dtype(">f4"): (8, 4),
}


def _library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libwtio-{digest}.so"


def _build() -> Path:
    """Compile ``native/frameio.cc`` unless a library of the same source
    hash exists; raise with the compiler's output if it fails."""
    out = _library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("frameio: no C++ compiler (g++ or $CXX) to "
                           "build native/frameio.cc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name and rename: a concurrent build never
    # loads a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                           "-lpthread"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"frameio: {cxx} failed to build {SOURCE.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """The native library, built if needed; raises if it cannot be."""
    lib = ctypes.CDLL(str(_build()))
    lib.wtio_open.restype = ctypes.c_void_p
    lib.wtio_open.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                              ctypes.c_int64, ctypes.c_int64]
    lib.wtio_prefetch.restype = None
    lib.wtio_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.wtio_read_frame_f32.restype = ctypes.c_int
    lib.wtio_read_frame_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int]
    lib.wtio_read_batch_f32.restype = ctypes.c_int
    lib.wtio_read_batch_f32.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int]
    lib.wtio_close.restype = None
    lib.wtio_close.argtypes = [ctypes.c_void_p]
    lib.wtio_write.restype = ctypes.c_int
    lib.wtio_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                               ctypes.c_int64]
    return lib


def native_available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class FrameStack:
    """Reader of ``n_frames`` raw frames of ``shape`` stored contiguously
    in ``path`` after ``offset`` header bytes, in ``dtype`` (a key of
    :data:`DTYPES`, big-endian ``>u2`` and ``>f4`` included); frames read
    as float32.  ``native=True`` reads through the native library (built
    on first use, or a raise), ``native=False`` through numpy."""

    def __init__(self, path: str, n_frames: int, shape: Tuple[int, ...],
                 dtype="uint16", offset: int = 0, threads: int = 4,
                 native: bool = True):
        self._lib = self._handle = None
        self.path = str(path)
        self.n_frames = int(n_frames)
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        if self.dtype not in DTYPES:
            raise ValueError(f"unsupported stored dtype {self.dtype}")
        self._enum, itemsize = DTYPES[self.dtype]
        self.n_elems = int(np.prod(self.shape))
        self.frame_bytes = self.n_elems * itemsize
        self.offset = int(offset)
        self.threads = int(threads)
        if native:
            self._lib = _load()
            self._handle = self._lib.wtio_open(
                self.path.encode(), self.offset, self.frame_bytes,
                self.n_frames)
            if not self._handle:
                raise OSError(f"wtio_open failed for {self.path!r} (size/"
                              "offset mismatch?)")
        else:
            self._mm = np.memmap(self.path, mode="r", dtype=np.uint8)
            need = self.offset + self.frame_bytes * self.n_frames
            if self.n_frames <= 0 or self._mm.size < need:
                raise OSError(f"{self.path!r} too small for frame stack")

    def __len__(self) -> int:
        return self.n_frames

    def prefetch(self, idx: int) -> None:
        if self._handle:
            self._lib.wtio_prefetch(self._handle, int(idx))

    def __getitem__(self, idx: int) -> np.ndarray:
        if not 0 <= idx < self.n_frames:
            raise IndexError(idx)
        out = np.empty(self.shape, np.float32)
        if self._lib is not None:
            rc = self._lib.wtio_read_frame_f32(
                self._handle, int(idx), self._enum, _f32p(out), self.n_elems,
                self.threads)
            if rc != 0:
                raise OSError(f"wtio_read_frame_f32 failed rc={rc}")
            return out
        start = self.offset + idx * self.frame_bytes
        raw = self._mm[start:start + self.frame_bytes]
        out[...] = raw.view(self.dtype).reshape(self.shape)
        return out

    def read_batch(self, indices: Sequence[int],
                   out: np.ndarray = None) -> np.ndarray:
        """Read ``indices`` into a contiguous ``(B, *shape)`` float32
        batch, ``out`` when given (pinned host memory, say)."""
        idx = np.asarray(list(indices), np.int64)
        if out is None:
            out = np.empty((len(idx),) + self.shape, np.float32)
        if out.shape != (len(idx),) + self.shape or out.dtype != np.float32 \
                or not out.flags.c_contiguous:
            raise ValueError(f"read_batch: out must be a contiguous float32 "
                             f"{(len(idx),) + self.shape} array")
        if self._lib is not None:
            if len(idx) and not ((idx >= 0) & (idx < self.n_frames)).all():
                raise IndexError(f"frames {idx.tolist()} of {self.n_frames}")
            rc = self._lib.wtio_read_batch_f32(
                self._handle,
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(idx), self._enum, _f32p(out), self.n_elems, self.threads)
            if rc != 0:
                raise OSError(f"wtio_read_batch_f32 failed rc={rc}")
            return out
        for i, j in enumerate(idx):
            out[i] = self[int(j)]
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.wtio_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def write_array(path: str, arr: np.ndarray, native: bool = True) -> None:
    """Write an array's bytes to ``path``, through the native library
    (built on first use, or a raise) or, with ``native=False``, numpy's
    ``tofile``."""
    arr = np.ascontiguousarray(arr)
    if not native:
        arr.tofile(path)
        return
    rc = _load().wtio_write(str(path).encode(), arr.ctypes.data, arr.nbytes)
    if rc != 0:
        raise OSError(f"wtio_write failed rc={rc}")
