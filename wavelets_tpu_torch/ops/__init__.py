from .filters import (B3SPLINE, TRIANGLE, ScalingFunction,
                      get_scaling_function, scaling_function_from_arrays)
from .conv import atrous_conv_nd, local_variance, separable_smooth_axis, smooth
from .stats import mad_noise, median_abs, significance_hard, significance_soft

__all__ = [
    "ScalingFunction",
    "TRIANGLE",
    "B3SPLINE",
    "get_scaling_function",
    "scaling_function_from_arrays",
    "smooth",
    "separable_smooth_axis",
    "local_variance",
    "atrous_conv_nd",
    "median_abs",
    "mad_noise",
    "significance_soft",
    "significance_hard",
]
