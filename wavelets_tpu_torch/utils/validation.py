"""Debug-mode numerical validation.

Counterpart of ``wavelets_tpu/utils/validation.py``.  The reference's
only guards are silent clamps; a debug run wants a loud failure that names
the operation which first produced a non-finite value.  JAX gets that
from ``checkify`` float checks; here a ``TorchDispatchMode`` checks the
floating outputs of every PyTorch operation.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["checked", "assert_finite"]

#: operations whose outputs are uninitialized memory by contract
_UNINITIALIZED = {"aten::empty", "aten::empty_like", "aten::empty_strided",
                  "aten::new_empty", "aten::new_empty_strided"}


def _non_finite(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.numel() > 0 and not bool(torch.isfinite(t).all()))


class _FiniteMode(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first operation whose floating
    output holds a NaN or an Inf."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func._schema.name not in _UNINITIALIZED:
            for t in tree_leaves(out):
                if _non_finite(t):
                    raise FloatingPointError(
                        f"checked: {func} produced non-finite values "
                        f"({int(torch.isnan(t).sum())} NaN, "
                        f"{int(torch.isinf(t).sum())} Inf of {t.numel()})")
        return out


def checked(fn: Callable) -> Callable:
    """Wrap ``fn`` so a NaN or Inf produced anywhere inside raises
    ``FloatingPointError`` naming the operation (a debug tool: every
    operation's output is read back).

    Limit: the hand-written kernels are called through ``ctypes`` and
    bypass PyTorch's dispatch, so a non-finite value that a kernel writes
    is caught at the next operation that reads it, or, if none does, in
    the wrapped function's outputs, which are checked too."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _FiniteMode():
            out = fn(*args, **kwargs)
        for t in tree_leaves(out):
            if _non_finite(t):
                raise FloatingPointError(
                    f"checked: {getattr(fn, '__name__', fn)} returned "
                    "non-finite values")
        return out

    return wrapper


def assert_finite(x, name: str = "array") -> None:
    """Eager finiteness check for host-side debugging."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    arr = np.asarray(x)
    if not np.isfinite(arr).all():
        n_bad = int((~np.isfinite(arr)).sum())
        raise FloatingPointError(
            f"{name}: {n_bad}/{arr.size} non-finite values")
