"""watroo-compatible object façade over the functional core.

Counterpart of ``wavelets_tpu/api.py``: ``AtrousTransform`` (standard
and bilateral, ``recursive=True``), ``B3spline``/``Triangle`` (classes
instantiated with ``n_dim``, with the reference's kernel methods and
``compute_noise_weights``), ``Coefficients`` (per-scale rows or a cube,
``noise``, ``get_noise``, ``significance``, ``denoise``, item
assignment, ``__array__``) and the free functions ``convolution``,
``atrous_convolution`` and ``sdev_loc`` (plain PyTorch: no TPU kernel
computes them either).

Devices: a ``torch.Tensor`` input keeps its device, which is how a
caller asks for the CPU.  Anything else (numpy, lists) goes to the
``device`` argument, ``"cuda"`` by default, as the JAX package puts
numpy input on its accelerator; without a card that raises unless
``device="cpu"`` is given, and never carries on silently on the CPU.

Reference surface: ``watroo/wavelets.py:108-149`` (Coefficients),
``:152-287`` (scaling functions), ``:290-444`` (AtrousTransform).
"""

from __future__ import annotations

import numpy as np
import torch

from . import tracing
from .core.transform import decompose, normalize_bilateral
from .ops import conv as _conv
from .ops import stats as _stats
from .ops.filters import B3SPLINE, TRIANGLE, ScalingFunction
from .ops.layout import stack_planes

__all__ = [
    "AbstractScalingFunction",
    "Triangle",
    "B3spline",
    "Coefficients",
    "AtrousTransform",
    "convolution",
    "atrous_convolution",
    "sdev_loc",
]

# Input dtypes the reference recasts to float64 (watroo/wavelets.py:297).
_RECASTING_TYPES = [np.int32, np.int64, ">f4", ">f8", "int16", "uint16",
                    "int32", "uint32"]
_RECASTING_TORCH = (torch.int16, torch.int32, torch.int64, torch.uint16,
                    torch.uint32)


#: where the entry points put an input that is not a tensor
DEFAULT_DEVICE = "cuda"


def _target_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: wavelets_tpu_torch puts array input on the "
            "card by default; pass device='cpu' (or a CPU tensor) to run "
            "on the CPU")
    return device


def _as_tensor(arr, device=DEFAULT_DEVICE) -> torch.Tensor:
    """numpy/torch → tensor with the reference dtype recast rules
    (watroo/wavelets.py:319-320): the listed int and big-endian dtypes
    become float64; float32 is preserved.  A tensor stays on its device;
    anything else goes to ``device`` (the card by default, which raises
    without one)."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype in _RECASTING_TORCH:
            return arr.to(torch.float64)
        return arr
    arr = np.asarray(arr)
    if arr.dtype in _RECASTING_TYPES:
        arr = arr.astype(np.float64)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("="))
    return _on_device(arr, device)


def _on_device(arr, device=DEFAULT_DEVICE) -> torch.Tensor:
    """A tensor as it is; anything else as a tensor on ``device``."""
    if isinstance(arr, torch.Tensor):
        return arr
    return tracing.as_tensor(np.asarray(arr), device=_target_device(device),
                             site="input")


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

    @property
    def coefficients_2d(self):
        return self._spec.kernel_nd(2)

    @property
    def coefficients_3d(self):
        return self._spec.kernel_nd(3)

    def make_kernel(self):
        return self._spec.kernel_nd(self.n_dim)

    def atrous_kernel(self, scale: int):
        """Dense dilated kernel (watroo/wavelets.py:191-197), for
        compatibility only: the engine never materializes the holes."""
        return self._spec.atrous_kernel_nd(self.n_dim, scale)

    def sigma_e(self, bilateral=None):
        return self._spec.sigma_e(self.n_dim, bilateral is not None)

    def compute_noise_weights(self, n_scales, n_trials=100, bilateral=None,
                              seed=0, fuse=True, device=DEFAULT_DEVICE):
        """Monte-Carlo regeneration of the σ_e tables
        (watroo/wavelets.py:221-229) on ``device``, the card by default:
        :func:`~wavelets_tpu_torch.utils.noise_calibration.
        compute_noise_weights`."""
        from .utils.noise_calibration import compute_noise_weights

        return compute_noise_weights(
            self._spec, self.n_dim, n_scales, n_trials=n_trials,
            bilateral=bilateral, seed=seed, fuse=fuse, device=device)


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


def _warn_output_ignored(output, fn_name):
    if output is not None:
        import warnings

        warnings.warn(
            f"{fn_name}(output=...) is accepted for signature parity but "
            "IGNORED: the engine is functional, the supplied buffer is "
            "never filled (the reference writes the result into it, "
            "watroo/wavelets.py:57-64).  Use the return value.",
            stacklevel=3)


def convolution(arr, scaling_function, s=0, output=None,
                device=DEFAULT_DEVICE):
    """Dense separable dilated smoothing ≡ reference ``convolution``
    (watroo/wavelets.py:35-71), with the per-ndim boundary (``symmetric``
    for 2-D/3-D, ``reflect`` for 1-D).

    .. warning:: ``output`` is accepted for signature parity but
       **ignored**, as in the JAX package: the buffer is never filled,
       and passing one emits a ``UserWarning``.  Use the return value."""
    _warn_output_ignored(output, "convolution")
    arr = _as_tensor(arr, device)
    return _conv.smooth(arr, _spec_of(scaling_function), scale=s)


def sdev_loc(image, scaling_function, s=0, variance=False,
             device=DEFAULT_DEVICE):
    """Local std (or variance) under the scaling window
    (watroo/wavelets.py:24-32)."""
    image = _as_tensor(image, device)
    return _conv.sdev_loc(image, _spec_of(scaling_function), scale=s,
                          variance=variance)


def atrous_convolution(image, kernel, bilateral_variance=None, s=0,
                       mode="symmetric", output=None, device=DEFAULT_DEVICE):
    """Generic n-D à trous convolution and its bilateral variant
    (watroo/wavelets.py:74-105).  ``kernel`` is the dense *undilated*
    kernel (numpy); ``mode`` one of numpy's ``symmetric``, ``reflect``,
    ``wrap`` or ``edge``; ``bilateral_variance`` goes to ``image``'s
    device.  ``output`` is ignored with a ``UserWarning``, see
    :func:`convolution`."""
    _warn_output_ignored(output, "atrous_convolution")
    image = _as_tensor(image, device)
    if bilateral_variance is not None:
        bilateral_variance = _as_tensor(bilateral_variance, image.device)
    return _conv.atrous_conv_nd(image, np.asarray(kernel), scale=s,
                                bilateral_variance=bilateral_variance,
                                boundary=mode)


class Coefficients:
    """À trous coefficient planes + their noise level
    (watroo/wavelets.py:108-149).

    ``data`` is a ``(level+1, *shape)`` tensor.  Construction also takes
    the planes as a tuple/list of per-scale tensors (the rows form
    :func:`~wavelets_tpu_torch.models.wow.wow` returns); the cube is then
    stacked on first ``.data`` access, while ``len``, integer indexing,
    ``get_noise`` and ``significance`` read the rows directly.  Arrays
    that are not tensors go to ``device``, the card by default.

    As in the JAX package, ``denoise`` and item assignment rebind the
    planes instead of writing into them: ``coeffs[s] = coeffs[s] * mask``
    replaces plane ``s``."""

    def __init__(self, data, scaling_function, bilateral=None,
                 device=DEFAULT_DEVICE):
        if isinstance(data, (tuple, list)) and all(
            isinstance(r, (torch.Tensor, np.ndarray)) for r in data
        ):
            self._rows = tuple(_on_device(r, device) for r in data)
            self._cube = None
        else:
            self._rows = None
            self._cube = _on_device(data, device)
        self.scaling_function = scaling_function
        self.bilateral = bilateral
        self.noise = None

    @property
    def data(self) -> torch.Tensor:
        if self._cube is None:
            self._cube = stack_planes(self._rows)
            self._rows = None
        return self._cube

    @data.setter
    def data(self, value):
        self._cube = torch.as_tensor(value, device=self._plane(0).device)
        self._rows = None

    def _plane(self, s):
        return self._rows[s] if self._rows is not None else self._cube[s]

    def __len__(self):
        return len(self._rows) if self._rows is not None else len(self.data)

    def __getitem__(self, s):
        """``coeffs[s]`` ≡ ``coeffs.data[s]`` without stacking the rows."""
        if isinstance(s, (int, np.integer)) and self._rows is not None:
            return self._rows[s]
        return self.data[s]

    def __setitem__(self, s, value):
        """Replace plane(s) ``s`` — the counterpart of the reference's
        in-place ``coeffs.data[s] *= mask`` (watroo/wavelets.py:145-149);
        rows stay rows, and a cube gets a new cube."""
        value = torch.as_tensor(value, device=self._plane(0).device)
        if self._rows is not None and isinstance(s, (int, np.integer)):
            rows = list(self._rows)
            rows[s] = value
            self._rows = tuple(rows)
            return
        cube = self.data.clone()
        cube[s] = value
        self.data = cube

    def __array__(self, dtype=None, copy=None):
        out = self.data.detach().cpu().numpy()
        if dtype is not None:
            out = out.astype(dtype)
        return out

    @property
    def sigma_e(self):
        return self.scaling_function.sigma_e(bilateral=self.bilateral)

    def get_noise(self):
        """MAD noise from the finest plane (watroo/wavelets.py:126-127),
        a 0-d tensor on the planes' device."""
        return _stats.mad_noise(self._plane(0), float(self.sigma_e[0]))

    def significance(self, sigma, scale, soft_threshold=True):
        """Per-plane significance mask (watroo/wavelets.py:129-143)."""
        if sigma != 0:
            if self.noise is None:
                self.noise = self.get_noise()
            noise = self.noise
            if not isinstance(noise, (np.ndarray, torch.Tensor)) or (
                getattr(noise, "ndim", 1) == 0
            ):
                if float(noise) == 0:
                    return torch.ones_like(self._plane(0))
            return _stats.significance(
                self._plane(scale), sigma, torch.as_tensor(noise),
                float(self.sigma_e[scale]), soft_threshold)
        return torch.ones_like(self._plane(0))

    def denoise(self, sigma, weights=None, soft_threshold=True):
        """Scale-wise thresholding (watroo/wavelets.py:145-149); rebinds
        ``data``.  ``zip`` truncation is kept: the residual plane is
        untouched when ``len(sigma) == level``."""
        sigma = tuple(sigma)
        if weights is None:
            weights = (1,) * len(sigma)
        if any(s != 0 for s in sigma) and self.noise is None:
            self.noise = self.get_noise()
        noise = self.noise if self.noise is not None else 0.0
        self.data = _stats.apply_denoise(
            self.data, sigma, tuple(weights),
            tuple(float(v) for v in self.sigma_e[: len(sigma)]),
            torch.as_tensor(noise), soft_threshold)


class AtrousTransform:
    """À trous transform engine (watroo/wavelets.py:290-328), standard or
    bilateral (``bilateral``: per-scale σ_b, a scalar or a list, padded
    to ``level+1`` entries at each call as the reference pads it)."""

    def __init__(self, scaling_function_class=B3spline, bilateral=None,
                 bilateral_scaling=False):
        self.scaling_function_class = scaling_function_class
        self.bilateral = bilateral
        self.bilateral_scaling = bilateral_scaling

    def __call__(self, arr, level, recursive=False, fuse=True,
                 device=DEFAULT_DEVICE):
        """Decompose ``arr`` over ``level`` scales → ``Coefficients`` with
        ``level+1`` planes, through :func:`~.core.transform.decompose`
        (kernel C on the card for float32, kernel F when bilateral;
        ``fuse=False`` the plain chain).  ``recursive=True`` gives the
        reference recursive algorithm's output: the same interior, the
        borders of one symmetric pad by ``half_width·2^(level−1)``.  A
        tensor stays on its device; other input goes to ``device``."""
        if np.ndim(arr) > 3:
            raise ValueError("Unsupported number of dimensions")
        arr = _as_tensor(arr, device)
        sf_compat = self.scaling_function_class(arr.ndim)
        planes = decompose(arr, level, sf_compat.spec,
                           bilateral=normalize_bilateral(self.bilateral,
                                                         level),
                           bilateral_scaling=self.bilateral_scaling,
                           recursive_borders=bool(recursive), fuse=fuse)
        return Coefficients(planes, sf_compat, self.bilateral)

    # Parity aliases of the reference's method names
    # (watroo/wavelets.py:330, :408): the plane cube as a numpy array.
    def atrous_standard(self, arr, level, scaling_function=None,
                        device=DEFAULT_DEVICE):
        return np.asarray(self(arr, level, device=device).data.cpu())

    def atrous_recursive(self, arr, level, scaling_function=None,
                         device=DEFAULT_DEVICE):
        return np.asarray(self(arr, level, recursive=True,
                               device=device).data.cpu())
