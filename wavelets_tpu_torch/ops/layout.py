"""Plane-cube assembly (counterpart of ``wavelets_tpu/ops/layout.py``)."""

from typing import Sequence

import torch

__all__ = ["stack_planes"]


def stack_planes(rows: Sequence[torch.Tensor]) -> torch.Tensor:
    """``(level+1, ...)`` cube from per-scale planes: ``torch.stack`` on
    dim 0."""
    return torch.stack(list(rows), dim=0)
