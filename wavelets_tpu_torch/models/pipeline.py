"""Streaming serving pipeline: disk → device → WOW → disk.

Counterpart of ``wavelets_tpu/models/pipeline.py``: a stored frame stack
streams through the native frame reader (``utils/frameio.py``) in
batches; each batch is read into pinned host memory, copied to the card
asynchronously and dispatched to :func:`~.wow.wow_stack` with
``with_coefficients=False``, and only then is the previous batch's
result fetched and written.  Host IO for batch k+1 so overlaps device
work for batch k, as the JAX package overlaps them through its
asynchronous dispatch.  Each batch's stages are spans (``wt.stack.read``,
``wt.stack.h2d``, ``wt.stack.run``, ``wt.stack.fetch``, in which the
host waits for the card, and ``wt.stack.write``; ``wavelets_tpu_torch.
tracing``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Tuple

import torch

from .. import tracing
from ..api import DEFAULT_DEVICE, _target_device
from ..utils.frameio import FrameStack

__all__ = ["process_stack"]


def _write(result, out_f, device) -> None:
    """Fetch a batch's result from the card and write it."""
    with tracing.span("wt.stack.fetch"), tracing.sync("stack.fetch", device):
        host = result.cpu()
    with tracing.span("wt.stack.write"):
        host.numpy().tofile(out_f)


@tracing.entry("wt.process_stack")
def process_stack(
    input_path: str,
    output_path: str,
    n_frames: int,
    shape: Tuple[int, int],
    dtype="uint16",
    offset: int = 0,
    batch: int = 4,
    progress: bool = False,
    mesh=None,
    device=DEFAULT_DEVICE,
    **wow_kwargs,
):
    """Run WOW over every frame of a stored stack.

    ``input_path``: a raw frame stack (see :class:`FrameStack`);
    ``output_path``: the
    float32 raw output, in the same frame order; ``batch``: frames per
    :func:`~.wow.wow_stack` call (a short last batch runs as it is: the
    statistics are per frame).  The remaining keyword arguments go to
    ``wow_stack``; ``device`` is the card by default.  Returns
    ``(n_frames, seconds, frames/s)``.

    ``mesh``: a mesh from :func:`wavelets_tpu_torch.parallel.make_mesh`
    (JAX ``pipeline.py:55-68``): every rank reads each batch, the batch
    runs through :func:`~wavelets_tpu_torch.parallel.sharded_wow` with
    ``with_coefficients=False`` (frames over the data axis, each frame
    tiled over rows × cols), a short last batch padded with its last frame
    to a multiple of the data extent, and rank 0 of the default group
    writes the output; ``device`` is then the mesh's."""
    from .wow import wow_stack

    if mesh is not None:
        from ..api import _spec_of
        from ..parallel.mesh import mesh_device
        from ..parallel.sharded import sharded_wow

        sf_cls = wow_kwargs.pop("scaling_function", None)
        if sf_cls is not None:
            wow_kwargs["sf"] = _spec_of(sf_cls)
        n_data = mesh.mesh.shape[0]

        def run_batch(dev):
            pad = -dev.shape[0] % n_data
            if pad:
                dev = torch.cat([dev, dev[-1:].expand(pad, *dev.shape[1:])])
            recon, _ = sharded_wow(dev, mesh, with_coefficients=False,
                                   **wow_kwargs)
            return recon.full_tensor()[:dev.shape[0] - pad]

        device = mesh_device(mesh)
        writer = torch.distributed.get_rank() == 0
    else:
        def run_batch(dev):
            # the coefficients are never kept here: no plane writes
            recon, _ = wow_stack(dev, with_coefficients=False, **wow_kwargs)
            return recon

        device = _target_device(device)
        writer = True
    t0 = time.perf_counter()
    # two host buffers, pinned for the card, in turn: batch k+2 reuses
    # batch k's only after batch k's result was fetched, which waited for
    # everything queued before it, batch k's copy included
    host = [torch.empty((min(batch, n_frames),) + tuple(shape),
                        dtype=torch.float32, pin_memory=device.type == "cuda")
            for _ in range(2)]
    pending = None
    with FrameStack(input_path, n_frames, shape, dtype=dtype,
                    offset=offset) as fs, \
            (open(output_path, "wb") if writer
             else contextlib.nullcontext()) as out_f:
        for k, b0 in enumerate(range(0, n_frames, batch)):
            idx = list(range(b0, min(b0 + batch, n_frames)))
            buf = host[k % 2][:len(idx)]
            with tracing.span("wt.stack.read"):
                fs.read_batch(idx, out=buf.numpy())
            with tracing.span("wt.stack.h2d"):
                dev = buf.to(device, non_blocking=True)
            with tracing.span("wt.stack.run"):
                recon = run_batch(dev)
            if pending is not None and writer:
                _write(pending, out_f, device)
            pending = recon
            if progress:
                print(f"dispatched frames {idx[0]}..{idx[-1]}", flush=True)
        if pending is not None and writer:
            _write(pending, out_f, device)
    dt = time.perf_counter() - t0
    return n_frames, dt, n_frames / dt
