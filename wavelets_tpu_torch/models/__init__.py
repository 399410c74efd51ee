from .denoise import denoise, denoise_core
from .pipeline import process_stack
from .wow import wow, wow_core, wow_stack

__all__ = ["denoise", "denoise_core", "process_stack", "wow", "wow_core",
           "wow_stack"]
