"""wavelets_tpu_torch — the à trous wavelet engine in PyTorch for NVIDIA Hopper.

The port of ``wavelets_tpu`` (JAX on a TPU), module by module, to
PyTorch with hand-written CUDA kernels for the H100.  The ported slice:
the à trous decomposition and synthesis, standard and bilateral (1-D,
2-D frames and stacks, 3-D volumes), ``denoise`` (bilateral too), and
WOW on a 2-D float32 or float64 frame or a 3-D volume with all its
options (bilateral with ``bilateral_scaling``, denoising with lazy MAD
noise, ``preserve_variance``, the gamma blend, ``whitening=False`` and
the ``wow(Coefficients)`` reuse entry), frame-stack serving
(``wow_stack`` with per-frame statistics, ``process_stack`` from disk to
disk over the native frame reader, ``python -m wavelets_tpu_torch``) and
``Coefficients`` saved to and loaded from npz.  The kernels live in
``csrc/`` and are built with ``nvcc`` on first use (``ops/_build.py``); a
CPU tensor runs each kernel's plain PyTorch version.  Array input goes
to the card unless the caller passes ``device="cpu"`` or a CPU tensor.
This package never imports JAX.
"""

from .ops.filters import B3SPLINE, TRIANGLE, ScalingFunction
from .api import AtrousTransform, B3spline, Coefficients, Triangle
from .core.transform import decompose, synthesize
from .models.denoise import denoise
from .models.pipeline import process_stack
from .models.wow import wow, wow_core, wow_stack

__all__ = [
    "AtrousTransform",
    "B3spline",
    "Triangle",
    "Coefficients",
    "decompose",
    "synthesize",
    "denoise",
    "wow",
    "wow_core",
    "wow_stack",
    "process_stack",
    "ScalingFunction",
    "TRIANGLE",
    "B3SPLINE",
]
