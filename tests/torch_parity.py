"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
numpy in, numpy out, so the JAX package and the port see the same
inputs."""

import numpy as np
import torch


def to_np(t):
    """numpy of a tensor (a bfloat16 one as float32, which holds it
    exactly) or of any array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if getattr(t, "dtype", None) is not None and str(t.dtype) == "bfloat16":
        return np.asarray(t, np.float32)
    return np.asarray(t)


def ulp_distance(a, b) -> int:
    """Largest distance in float32 units in the last place between
    matching elements of ``a`` and ``b``."""
    a = np.ascontiguousarray(to_np(a), np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(to_np(b), np.float32).view(np.int32).astype(np.int64)
    # map the sign-magnitude patterns onto a monotone integer line
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max())


def assert_close_scaled(got, ref, rtol, scale=None):
    """``max|got − ref| ≤ rtol·max(scale, 1)``, ``scale`` defaulting to
    ``max|ref|``: the standard of the JAX package's kernel tests
    (tests/test_pallas_merged.py:61, and :105-106 where the planes of a
    whole WOW run are held at the reconstruction's scale)."""
    got, ref = to_np(got), to_np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if scale is None:
        scale = float(np.abs(ref).max())
    scale = max(scale, 1.0)
    err = float(np.abs(got.astype(np.float64) - ref.astype(np.float64)).max())
    assert err <= rtol * scale, f"max abs err {err} > {rtol} * {scale}"


def assert_rel(got, ref, rtol):
    """``max|got − ref| ≤ rtol·max|ref|``."""
    got, ref = to_np(got), to_np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), (err, rtol)
