"""Scaling-function filter bank: taps and σ_e calibration tables.

Counterpart of ``wavelets_tpu/ops/filters.py``.  A scaling function is a
frozen dataclass of 1-D taps plus the per-scale noise tables (the
expected standard deviation of each detail plane when the input is unit
Gaussian noise; watroo/wavelets.py:239-254 Triangle, :268-283
B3spline).  These are the only parameters a WOW run has, so the port
owns its copy; :func:`scaling_function_from_arrays` carries another
filter bank across from plain arrays (e.g. the JAX package's fields).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["ScalingFunction", "TRIANGLE", "B3SPLINE", "get_scaling_function",
           "scaling_function_from_arrays"]

_SIGMA_FIELDS = ("sigma_e_1d", "sigma_e_2d", "sigma_e_3d",
                 "sigma_e_1d_bilateral", "sigma_e_2d_bilateral",
                 "sigma_e_3d_bilateral")


@dataclasses.dataclass(frozen=True)
class ScalingFunction:
    """A separable, symmetric scaling function (filter bank entry).

    ``taps`` is the 1-D kernel; n-D kernels are its outer products
    (cf. ``watroo/wavelets.py:170-179``)."""

    name: str
    taps: Tuple[float, ...]
    # σ_e tables keyed by dimensionality; ``None`` where the reference has
    # no table either.
    sigma_e_1d: Optional[Tuple[float, ...]] = None
    sigma_e_2d: Optional[Tuple[float, ...]] = None
    sigma_e_3d: Optional[Tuple[float, ...]] = None
    sigma_e_1d_bilateral: Optional[Tuple[float, ...]] = None
    sigma_e_2d_bilateral: Optional[Tuple[float, ...]] = None
    sigma_e_3d_bilateral: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if len(self.taps) % 2 != 1:
            raise ValueError("taps must have odd length")

    @property
    def half_width(self) -> int:
        return (len(self.taps) - 1) // 2

    @property
    def is_symmetric(self) -> bool:
        t = self.taps
        return all(abs(t[i] - t[-1 - i]) == 0.0 for i in range(len(t) // 2))

    def reach(self, scale: int) -> int:
        """Spatial reach (halo width) of the dilated kernel at ``scale``."""
        return self.half_width * (2 ** scale)

    def cumulative_reach(self, level: int) -> int:
        """Total reach of ``level`` chained smoothings: hw·(2^level − 1)."""
        return self.half_width * ((2 ** level) - 1)

    def kernel_nd(self, n_dim: int, dtype=np.float64) -> np.ndarray:
        """Dense n-D kernel by outer products (watroo/wavelets.py:170-189)."""
        t = np.asarray(self.taps, dtype=dtype)
        if n_dim == 1:
            return t
        if n_dim == 2:
            return np.outer(t, t)
        if n_dim == 3:
            return np.einsum("i,j,k->ijk", t, t, t)
        raise ValueError("Unsupported number of dimensions")

    def atrous_kernel_nd(self, n_dim: int, scale: int,
                         dtype=np.float64) -> np.ndarray:
        """Dense dilated kernel with 2^scale−1 zeros between taps (API
        compatibility only; the transform never materializes the zeros)."""
        base = self.kernel_nd(n_dim, dtype)
        d = 2 ** scale
        shape = tuple((s - 1) * d + 1 for s in base.shape)
        k = np.zeros(shape, dtype=dtype)
        k[tuple(slice(None, None, d) for _ in range(n_dim))] = base
        return k

    def sigma_e(self, n_dim: int, bilateral: bool = False) -> Optional[np.ndarray]:
        """Per-scale noise std table (watroo/wavelets.py:199-219)."""
        table = {
            (1, False): self.sigma_e_1d,
            (2, False): self.sigma_e_2d,
            (3, False): self.sigma_e_3d,
            (1, True): self.sigma_e_1d_bilateral,
            (2, True): self.sigma_e_2d_bilateral,
            (3, True): self.sigma_e_3d_bilateral,
        }.get((n_dim, bool(bilateral)))
        if table is None:
            return None
        return np.asarray(table, dtype=np.float64)


def scaling_function_from_arrays(name: str, taps, **sigma_tables) -> ScalingFunction:
    """Build a :class:`ScalingFunction` from array-valued fields.

    ``taps`` and each ``sigma_e_*`` keyword (one of the six table names,
    or None) may be any 1-D array-like; values are carried across as
    Python floats, so a float64 source round-trips exactly."""
    unknown = set(sigma_tables) - set(_SIGMA_FIELDS)
    if unknown:
        raise TypeError(f"unknown σ_e tables: {sorted(unknown)}")

    def as_tuple(a):
        if a is None:
            return None
        return tuple(float(v) for v in np.asarray(a, dtype=np.float64).ravel())

    return ScalingFunction(
        name=name, taps=as_tuple(taps),
        **{k: as_tuple(v) for k, v in sigma_tables.items()})


# Taps and σ_e calibration constants from the reference
# (watroo/wavelets.py:239-254 and :268-283; algorithms from Starck &
# Murtagh, Handbook of Astronomical Data Analysis, Appendix A).
TRIANGLE = ScalingFunction(
    name="triangle",
    taps=(1 / 4, 1 / 2, 1 / 4),
    sigma_e_1d=(0.60840933, 0.33000059, 0.21157957, 0.145824, 0.10158388,
                0.07155912, 0.04902655, 0.03529812, 0.02409187, 0.01722846,
                0.01144442),
    sigma_e_2d=(0.7999247, 0.27308452, 0.11998217, 0.05793947, 0.0288104,
                0.01447795, 0.00733832, 0.0037203, 0.00192882, 0.00098568,
                0.00048533),
    sigma_e_3d=(0.89736751, 0.19514386, 0.06239262, 0.02311278, 0.00939645),
    sigma_e_2d_bilateral=(0.31063172, 0.34575647, 0.23712331, 0.13559906,
                          0.07172004, 0.03665405, 0.01850046, 0.00928768,
                          0.00465967, 0.00234445, 0.00119249),
    sigma_e_3d_bilateral=(0.3828863, 0.36182913, 0.19520299, 0.08498861,
                          0.03363142),
)

B3SPLINE = ScalingFunction(
    name="b3spline",
    taps=(1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16),
    sigma_e_1d=(0.72514976, 0.28538683, 0.17901161, 0.12222841, 0.08469601,
                0.06027006, 0.04242257, 0.02919823, 0.01805671, 0.01383672,
                0.00943623),
    sigma_e_2d=(8.907e-01, 2.0072e-01, 8.5551e-02, 4.1261e-02, 2.0470e-02,
                1.0232e-02, 5.1435e-03, 2.6008e-03, 1.3161e-03, 6.7359e-04,
                4.0040e-04),
    sigma_e_3d=(0.95633954, 0.12491933, 0.03933029, 0.01489642, 0.0064108),
    # NB: the reference 2-D bilateral table has 10 entries, one short of
    # the others (watroo/wavelets.py:280-281) — preserved verbatim.
    sigma_e_2d_bilateral=(0.38234752, 0.24305799, 0.16012153, 0.10633541,
                          0.07083733, 0.04728659, 0.03163678, 0.02122341,
                          0.01429102, 0.00952376),
    sigma_e_3d_bilateral=(0.44111772, 0.3552894, 0.16137159, 0.05769064,
                          0.01932497),
)

_BY_NAME = {"triangle": TRIANGLE, "b3spline": B3SPLINE}


def get_scaling_function(name: str) -> ScalingFunction:
    try:
        return _BY_NAME[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown scaling function {name!r}; available: {sorted(_BY_NAME)}"
        ) from None
