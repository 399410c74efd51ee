"""Process mesh of the sharded wavelet engine, and its counted collectives.

Counterpart of ``wavelets_tpu/parallel/mesh.py``: a batch ("data") axis
and a 2-D spatial tiling ("rows" × "cols") over the ranks of a
``torch.distributed`` group, as a :class:`DeviceMesh` with the data axis
outermost.  One rank is one card (NCCL) or one CPU process (gloo).

The engine's communication goes through the wrappers below, which count
what they issue in :data:`COLLECTIVES` under the JAX package's HLO names
(``all-reduce``, ``all-gather``, ``collective-permute``,
``all-to-all``), as ``ops/_build.py`` counts kernel launches;
``utils.profiling.count_collectives`` reads them.
"""

from __future__ import annotations

import collections
import os
from typing import List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
ROW_AXIS = "rows"
COL_AXIS = "cols"
AXES = (DATA_AXIS, ROW_AXIS, COL_AXIS)

__all__ = ["make_mesh", "init_distributed", "DATA_AXIS", "ROW_AXIS",
           "COL_AXIS", "COLLECTIVES", "spatial_group", "mesh_device"]

#: collectives issued by this process, by the JAX package's HLO names
COLLECTIVES: collections.Counter = collections.Counter()

# the flattened (rows, cols) group of each mesh, built once with it
_SPATIAL = {}

# a tiled all-gather into one tensor: all_gather_single where PyTorch has
# it, else its earlier name
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join the process group before building a mesh: a thin wrapper over
    ``dist.init_process_group``.  ``init_method`` defaults to ``env://``
    (``MASTER_ADDR``/``MASTER_PORT``), ``world_size`` and ``rank`` to
    ``WORLD_SIZE`` and ``RANK`` (as ``torchrun`` sets them), ``backend``
    to NCCL where a card is present, else gloo.  A NCCL rank takes card
    ``LOCAL_RANK`` (default: ``rank`` modulo the cards)."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("init_distributed: this PyTorch has no NCCL")
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def make_mesh(data: int = 1, rows: int = 1, cols: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ``(data, rows, cols)`` mesh over ranks ``0 .. data·rows·cols−1``
    of the default group, the data axis outermost (global rank ``d·rows·
    cols + r·cols + c``), so the spatial axes' neighbours are adjacent
    ranks, as the JAX mesh places them.  Every rank calls it (it builds
    the axis groups); it raises where the world is too small, and for a
    card mesh (``device_type="cuda"``, the default) on any backend but
    NCCL, which alone moves CUDA tensors between ranks."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call init_distributed first")
    n = data * rows * cols
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"mesh {data}x{rows}x{cols} needs {n} devices, "
                         f"have {world}")
    if device_type == "cuda" and dist.get_backend() != "nccl":
        raise RuntimeError(f"make_mesh: a CUDA mesh needs the NCCL backend, "
                           f"not {dist.get_backend()}")
    mesh = DeviceMesh(device_type, torch.arange(n).reshape(data, rows, cols),
                      mesh_dim_names=AXES)
    # the statistics reduce over (rows, cols) of one data index: a group
    # a data index, every rank creating every group in the same order
    mine = None
    for d in range(data):
        ranks = list(range(d * rows * cols, (d + 1) * rows * cols))
        group = dist.new_group(ranks)
        if dist.get_rank() in ranks:
            mine = group
    _SPATIAL[id(mesh)] = (mesh, mine)
    return mesh


def spatial_group(mesh: DeviceMesh):
    """This rank's flattened ``(rows, cols)`` group of ``mesh``: its rank
    in the group is ``r·cols + c``, the row-band order."""
    return _SPATIAL[id(mesh)][1]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device of this rank's blocks."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# ---------------------------------------------------------------------
# counted collectives
# ---------------------------------------------------------------------

def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place ``all_reduce`` of ``t`` over ``group``; returns ``t``."""
    COLLECTIVES["all-reduce"] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_axis(x: torch.Tensor, axis: int, group) -> torch.Tensor:
    """The blocks of ``group``'s ranks concatenated along ``axis`` in rank
    order (JAX's tiled ``all_gather``)."""
    n = dist.get_world_size(group)
    lead = x.movedim(axis, 0).contiguous()
    out = torch.empty((n * lead.shape[0],) + tuple(lead.shape[1:]),
                      dtype=x.dtype, device=x.device)
    COLLECTIVES["all-gather"] += 1
    _all_gather_single(out, lead, group=group)
    return out.movedim(0, axis)


def exchange(sends: List, recvs: List, group) -> None:
    """Post ``sends`` (tensor, group rank) and ``recvs`` (buffer, group
    rank) as one batch of point-to-point operations over ``group`` and
    wait: the two ring shifts of a halo exchange (JAX's two
    ``ppermute``), counted as two collective permutes."""
    COLLECTIVES["collective-permute"] += 2
    ops = ([dist.P2POp(dist.isend, t.contiguous(),
                       dist.get_global_rank(group, p), group)
            for t, p in sends]
           + [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, p),
                         group) for t, p in recvs])
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def all_to_all(chunks: torch.Tensor, group) -> torch.Tensor:
    """``chunks[j]`` to rank ``j`` of ``group``; returns what each rank
    sent here, in rank order on the leading axis."""
    chunks = chunks.contiguous()
    out = torch.empty_like(chunks)
    COLLECTIVES["all-to-all"] += 1
    dist.all_to_all_single(out, chunks, group=group)
    return out
