"""wavelets_tpu_torch — the à trous wavelet engine in PyTorch for NVIDIA Hopper.

The port of ``wavelets_tpu`` (JAX on a TPU), module by module, to
PyTorch with hand-written CUDA kernels for the H100.  The ported slice
is standard WOW on one 2-D float32 or float64 frame: decomposition,
per-scale whitening with erf/hard significance denoising and lazy MAD
noise.  The kernels live in ``csrc/`` and are built with ``nvcc`` on
first use (``ops/_build.py``); a CPU tensor runs each kernel's plain
PyTorch version.  This package never imports JAX.
"""

from .ops.filters import B3SPLINE, TRIANGLE, ScalingFunction
from .api import AtrousTransform, B3spline, Coefficients, Triangle
from .models.wow import wow, wow_core

__all__ = [
    "AtrousTransform",
    "B3spline",
    "Triangle",
    "Coefficients",
    "wow",
    "wow_core",
    "ScalingFunction",
    "TRIANGLE",
    "B3SPLINE",
]
