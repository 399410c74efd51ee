from .denoise import denoise, denoise_core
from .wow import wow, wow_core

__all__ = ["denoise", "denoise_core", "wow", "wow_core"]
