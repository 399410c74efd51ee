"""The sharded wavelet engine on ``torch.distributed`` (counterpart of
``wavelets_tpu/parallel``): a ``(data, rows, cols)`` mesh of ranks,
halo exchange for the dilated stencils, exact distributed statistics,
and the sharded transform and WOW."""

from .mesh import (COL_AXIS, DATA_AXIS, ROW_AXIS, init_distributed,
                   make_mesh)
from .reductions import distributed_median, kth_smallest
from .sharded import sharded_decompose, sharded_wow

__all__ = [
    "make_mesh",
    "DATA_AXIS",
    "ROW_AXIS",
    "COL_AXIS",
    "sharded_decompose",
    "sharded_wow",
    "distributed_median",
    "kth_smallest",
]
