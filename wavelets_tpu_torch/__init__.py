"""wavelets_tpu_torch — the à trous wavelet engine in PyTorch for NVIDIA Hopper.

The port of ``wavelets_tpu`` (JAX on a TPU) to PyTorch with hand-written
CUDA kernels for the H100, with the reference watroo's public surface
(``watroo/__init__.py:1-4``): the à trous decomposition and synthesis,
standard and bilateral (1-D, 2-D frames and stacks, 3-D volumes, the
recursive algorithm's borders), ``convolution``, ``atrous_convolution``
and ``sdev_loc``, ``denoise`` and ``enhance``, WOW on a 2-D frame or a
3-D volume with all its options, frame-stack serving (``wow_stack``,
``process_stack`` from disk to disk, ``python -m wavelets_tpu_torch``),
multiresolution Richardson-Lucy deconvolution of frames and stacks, the
σ_e noise calibration, ``Coefficients`` saved to and loaded from npz,
and in ``utils`` validation and profiling.  The kernels live in
``csrc/`` and are built with ``nvcc`` on first use (``ops/_build.py``); a
CPU tensor runs each kernel's plain PyTorch version.  Array input goes
to the card unless the caller passes ``device="cpu"`` or a CPU tensor.
This package never imports JAX.
"""

from .version import __version__

from .ops.filters import B3SPLINE, TRIANGLE, ScalingFunction
from .ops.stats import generalized_anscombe
from .api import (
    AbstractScalingFunction,
    AtrousTransform,
    B3spline,
    Coefficients,
    Triangle,
    atrous_convolution,
    convolution,
    sdev_loc,
)
from .core.transform import decompose, synthesize
from .models.denoise import denoise
from .models.enhance import enhance, prepare_params
from .models.pipeline import process_stack
from .models.richardson_lucy import richardson_lucy, richardson_lucy_stack
from .models.wow import wow, wow_core, wow_stack

__all__ = [
    # watroo-parity surface (watroo/wavelets.py:11 + watroo/utils.py:7)
    "AtrousTransform",
    "B3spline",
    "Triangle",
    "Coefficients",
    "generalized_anscombe",
    "convolution",
    "denoise",
    "wow",
    "wow_stack",
    "richardson_lucy",
    "richardson_lucy_stack",
    # documented-but-unexported reference helpers (watroo/utils.py:36, :10)
    "enhance",
    "prepare_params",
    "atrous_convolution",
    "sdev_loc",
    "AbstractScalingFunction",
    # native functional layer
    "ScalingFunction",
    "TRIANGLE",
    "B3SPLINE",
    "__version__",
    # the port's own entry points
    "decompose",
    "synthesize",
    "wow_core",
    "process_stack",
]
