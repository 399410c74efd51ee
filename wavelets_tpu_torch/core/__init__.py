from .transform import decompose, synthesize

__all__ = ["decompose", "synthesize"]
