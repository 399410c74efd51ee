from .frameio import FrameStack, native_available, write_array
from .io import load_coefficients, save_coefficients

__all__ = ["FrameStack", "native_available", "write_array",
           "save_coefficients", "load_coefficients"]
