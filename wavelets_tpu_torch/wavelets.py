"""Module-path compatibility shim: ``watroo.wavelets`` → this module.

Lets reference users port ``from watroo.wavelets import AtrousTransform``
as ``from wavelets_tpu_torch.wavelets import AtrousTransform``, as
``wavelets_tpu.wavelets`` does for the JAX package.  The canonical home
of these symbols is the package root / ``wavelets_tpu_torch.api``."""

from .api import (  # noqa: F401
    AbstractScalingFunction,
    AtrousTransform,
    B3spline,
    Coefficients,
    Triangle,
    atrous_convolution,
    convolution,
    sdev_loc,
)
from .ops.stats import generalized_anscombe  # noqa: F401

__all__ = [
    "AtrousTransform",
    "B3spline",
    "Triangle",
    "Coefficients",
    "generalized_anscombe",
    "convolution",
    "atrous_convolution",
    "sdev_loc",
    "AbstractScalingFunction",
]
