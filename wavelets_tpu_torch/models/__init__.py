from .wow import wow, wow_core

__all__ = ["wow", "wow_core"]
