"""watroo-compatible object façade over the functional core.

Counterpart of ``wavelets_tpu/api.py`` for the ported slice:
``AtrousTransform`` (standard algorithm), ``B3spline``/``Triangle``
(classes instantiated with ``n_dim``) and ``Coefficients`` (per-scale
rows or a cube, ``noise``, ``__len__``, ``__getitem__``, ``__array__``).

Tensors keep their device: a ``torch.Tensor`` input stays where it is,
and a numpy input goes to the ``device`` argument (CPU by default).
There is no device auto-detection.

Reference surface: ``watroo/wavelets.py:108-149`` (Coefficients),
``:152-287`` (scaling functions), ``:290-444`` (AtrousTransform).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.transform import decompose
from .ops.filters import B3SPLINE, TRIANGLE, ScalingFunction
from .ops.layout import stack_planes

__all__ = [
    "AbstractScalingFunction",
    "Triangle",
    "B3spline",
    "Coefficients",
    "AtrousTransform",
]

# Input dtypes the reference recasts to float64 (watroo/wavelets.py:297).
_RECASTING_TYPES = [np.int32, np.int64, ">f4", ">f8", "int16", "uint16",
                    "int32", "uint32"]
_RECASTING_TORCH = (torch.int16, torch.int32, torch.int64, torch.uint16,
                    torch.uint32)


def _as_tensor(arr, device=None) -> torch.Tensor:
    """numpy/torch → tensor with the reference dtype recast rules
    (watroo/wavelets.py:319-320): the listed int and big-endian dtypes
    become float64; float32 is preserved.  A tensor stays on its device;
    anything else goes to ``device`` (default CPU)."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype in _RECASTING_TORCH:
            return arr.to(torch.float64)
        return arr
    arr = np.asarray(arr)
    if arr.dtype in _RECASTING_TYPES:
        arr = arr.astype(np.float64)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("="))
    return torch.as_tensor(arr, device=device)


class AbstractScalingFunction:
    """Class-style scaling function, instantiated per ``n_dim`` like the
    reference (watroo/wavelets.py:152-229), backed by a frozen
    :class:`~wavelets_tpu_torch.ops.filters.ScalingFunction` spec."""

    _spec: ScalingFunction = None  # set by subclasses

    def __init__(self, n_dim: int):
        if self._spec is None:
            raise TypeError("AbstractScalingFunction is abstract")
        if n_dim not in (1, 2, 3):
            raise ValueError("Unsupported number of dimensions")
        self.name = self._spec.name
        self.n_dim = n_dim
        self.kernel = self._spec.kernel_nd(n_dim)

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        spec = cls._spec
        if spec is not None:
            cls.coefficients_1d = np.asarray(spec.taps)
            for nd in (1, 2, 3):
                for bil, suffix in ((False, ""), (True, "_bilateral")):
                    setattr(cls, f"sigma_e_{nd}d{suffix}",
                            spec.sigma_e(nd, bil))

    @property
    def spec(self) -> ScalingFunction:
        return self._spec

    def sigma_e(self, bilateral=None):
        return self._spec.sigma_e(self.n_dim, bilateral is not None)


class Triangle(AbstractScalingFunction):
    """Triangle scaling function, taps [1/4, 1/2, 1/4]
    (watroo/wavelets.py:232-258)."""

    _spec = TRIANGLE


class B3spline(AbstractScalingFunction):
    """B3-spline scaling function, taps [1/16, 1/4, 3/8, 1/4, 1/16]
    (watroo/wavelets.py:261-287).  The default everywhere."""

    _spec = B3SPLINE


def _spec_of(scaling_function) -> ScalingFunction:
    """Accept a ScalingFunction spec, a compat class, or a compat instance."""
    if isinstance(scaling_function, ScalingFunction):
        return scaling_function
    if isinstance(scaling_function, AbstractScalingFunction):
        return scaling_function.spec
    if isinstance(scaling_function, type) and issubclass(
        scaling_function, AbstractScalingFunction
    ):
        return scaling_function._spec
    raise TypeError(f"Not a scaling function: {scaling_function!r}")


class Coefficients:
    """À trous coefficient planes + their noise level
    (watroo/wavelets.py:108-149).

    ``data`` is a ``(level+1, *shape)`` tensor.  Construction also takes
    the planes as a tuple/list of per-scale tensors (the rows form
    :func:`~wavelets_tpu_torch.models.wow.wow` returns); the cube is then
    stacked on first ``.data`` access, while ``len`` and integer indexing
    read the rows directly."""

    def __init__(self, data, scaling_function, bilateral=None):
        if isinstance(data, (tuple, list)) and all(
            isinstance(r, (torch.Tensor, np.ndarray)) for r in data
        ):
            self._rows = tuple(torch.as_tensor(r) for r in data)
            self._cube = None
        else:
            self._rows = None
            self._cube = (data if isinstance(data, torch.Tensor)
                          else torch.as_tensor(np.asarray(data)))
        self.scaling_function = scaling_function
        self.bilateral = bilateral
        self.noise = None

    @property
    def data(self) -> torch.Tensor:
        if self._cube is None:
            self._cube = stack_planes(self._rows)
            self._rows = None
        return self._cube

    def __len__(self):
        return len(self._rows) if self._rows is not None else len(self.data)

    def __getitem__(self, s):
        """``coeffs[s]`` ≡ ``coeffs.data[s]`` without stacking the rows."""
        if isinstance(s, (int, np.integer)) and self._rows is not None:
            return self._rows[s]
        return self.data[s]

    def __array__(self, dtype=None, copy=None):
        out = self.data.detach().cpu().numpy()
        if dtype is not None:
            out = out.astype(dtype)
        return out


class AtrousTransform:
    """À trous transform engine (watroo/wavelets.py:290-328), standard
    algorithm."""

    def __init__(self, scaling_function_class=B3spline, bilateral=None,
                 bilateral_scaling=False):
        self.scaling_function_class = scaling_function_class
        self.bilateral = bilateral
        self.bilateral_scaling = bilateral_scaling

    def __call__(self, arr, level, recursive=False):
        """Decompose ``arr`` over ``level`` scales → ``Coefficients`` with
        ``level+1`` planes."""
        if self.bilateral is not None:
            raise NotImplementedError(
                "the bilateral transform is not ported yet "
                "(ROADMAP.md queue A: bilateral)")
        if recursive:
            raise NotImplementedError(
                "recursive=True is not ported yet "
                "(ROADMAP.md queue A: transform options)")
        arr = _as_tensor(arr)
        if arr.ndim > 3:
            raise ValueError("Unsupported number of dimensions")
        sf_compat = self.scaling_function_class(arr.ndim)
        planes = decompose(arr, level, sf_compat.spec)
        return Coefficients(planes, sf_compat, self.bilateral)
