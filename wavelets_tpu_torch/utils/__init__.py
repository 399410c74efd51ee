from .frameio import FrameStack, native_available, write_array
from .io import load_coefficients, save_coefficients
from .noise_calibration import compute_noise_weights
from .profiling import Cost, StageTimer, decompose_cost, roofline, wow_cost

__all__ = [
    "compute_noise_weights",
    "save_coefficients",
    "load_coefficients",
    "FrameStack",
    "write_array",
    "native_available",
    "StageTimer",
    "Cost",
    "decompose_cost",
    "wow_cost",
    "roofline",
    # watroo.utils module-path compatibility (lazy: avoids import cycles)
    "denoise",
    "wow",
    "richardson_lucy",
    "enhance",
    "prepare_params",
]

_WATROO_UTILS_COMPAT = {
    "denoise": ("wavelets_tpu_torch.models.denoise", "denoise"),
    "wow": ("wavelets_tpu_torch.models.wow", "wow"),
    "richardson_lucy": ("wavelets_tpu_torch.models.richardson_lucy",
                        "richardson_lucy"),
    "enhance": ("wavelets_tpu_torch.models.enhance", "enhance"),
    "prepare_params": ("wavelets_tpu_torch.models.enhance", "prepare_params"),
}


def __getattr__(name):
    """``watroo.utils`` path parity: ``from wavelets_tpu_torch.utils import
    wow`` works like the reference's ``from watroo.utils import wow``."""
    try:
        mod_name, attr = _WATROO_UTILS_COMPAT[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    return getattr(importlib.import_module(mod_name), attr)
