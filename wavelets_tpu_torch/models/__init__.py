from .denoise import denoise, denoise_core
from .enhance import enhance, prepare_params
from .pipeline import process_stack
from .richardson_lucy import richardson_lucy, richardson_lucy_stack
from .wow import wow, wow_core, wow_stack

__all__ = ["denoise", "denoise_core", "enhance", "prepare_params",
           "process_stack", "richardson_lucy", "richardson_lucy_stack", "wow",
           "wow_core", "wow_stack"]
