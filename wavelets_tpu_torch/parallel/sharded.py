"""Sharded à trous transform and WOW over a process mesh.

Counterpart of ``wavelets_tpu/parallel/sharded.py``: images or frame
stacks are tiled over a ``(data, rows, cols)`` mesh of ranks
(:func:`~.mesh.make_mesh`); every scale-``s`` convolution exchanges
``hw·2^s`` boundary rows or columns with its neighbours
(:mod:`.halo`), and the global statistics (the MAD noise median, the
residual std, the gamma bounds) are collectives (:mod:`.reductions`).
Each rank runs its own block; JAX's ``shard_map`` over one program
becomes one call per rank, and its ``NamedSharding`` a ``DTensor``.

Dispatch, as JAX's (three stages):

* **stage 1**, a data-only mesh and a stack: each rank runs the port's
  ``_stack_core`` (the single-device stack dispatch) on its own frames;
* **stage 2**, a spatially tiled mesh on float32 standard WOW (whitening,
  no bilateral, ``h == 0``, no ``preserve_variance``): kernel A's group
  on blocks extended by the group's reach and cropped (overlap-save),
  then the deep tail resharded to full-width row bands (one
  ``all_to_all`` over the cols group, none where ``n_cols == 1``),
  extended by the neighbours' rows (or a gathered window where the reach
  passes the band) and whitened by **kernel A's deep step in halo
  mode**, then resharded back;
* **the halo body** for everything else: the decomposition and the
  bilateral smooth on extended blocks and the port's ``_wow_body`` with
  halo smoothing and collective reductions.

Stage 2's group and band plans are the port's own (kernel A's group of
:data:`~wavelets_tpu_torch.ops.hopper_conv.N_FAST` scales, the halo
step on any band), not JAX's v5e planners; the one limit kept is JAX's
single-neighbour reach, a group's reach at most the local extent.  In
float32 the routes agree to the float32 standard.

Numerical contract: :func:`sharded_decompose` is bitwise the
single-device plain decomposition (the same per-element fold order).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import tracing
from ..core.transform import normalize_bilateral
from ..models.wow import _stack_core, _wow_body, normalize_wow_params
from ..ops.conv import _noncenter_offsets, atrous_conv_nd, boundary_index
from ..ops.filters import B3SPLINE, ScalingFunction
from ..ops.hopper_conv import N_FAST, fused_wow_group, group_halo
from ..ops.hopper_deep import deep_whiten_step
from ..ops.layout import stack_planes
from ..ops.stats import MAD_TO_SIGMA, _div_scalars, significance
from .halo import halo_exchange_axis, halo_smooth_axis
from .mesh import (COL_AXIS, ROW_AXIS, all_gather_axis, all_to_all,
                   exchange, mesh_device, spatial_group)
from .reductions import (distributed_max, distributed_mean,
                         distributed_median, distributed_min,
                         distributed_std)

__all__ = ["sharded_decompose", "sharded_wow", "ShardedReduceOps"]


class _Grid:
    """This rank's place in a mesh: the axes' extents, its coordinates,
    the rows, cols and flattened (rows, cols) groups and its device."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self.n_data, self.n_rows, self.n_cols = tuple(mesh.mesh.shape)
        coord = mesh.get_coordinate()
        if coord is None:
            raise RuntimeError("this rank holds no block of the mesh")
        self.d, self.r, self.c = coord
        self.rows = mesh.get_group(ROW_AXIS)
        self.cols = mesh.get_group(COL_AXIS)
        self.spatial = spatial_group(mesh)
        self.device = mesh_device(mesh)


class ShardedReduceOps:
    """Collective reductions over the spatial ranks, per batch element;
    results keep singleton spatial dimensions, so they broadcast against
    the local blocks."""

    def __init__(self, group, total_count: int, batch_ndim: int):
        self.group = group
        self.total_count = total_count
        self.batch_ndim = batch_ndim

    def _expand(self, v, ndim):
        return v.reshape(v.shape + (1,) * (ndim - v.ndim))

    def median_abs(self, x):
        return self._expand(distributed_median(
            torch.abs(x), self.group, self.total_count, self.batch_ndim),
            x.ndim)

    def mean(self, x):
        return self._expand(distributed_mean(
            x, self.group, self.total_count, self.batch_ndim), x.ndim)

    def std(self, x):
        return self._expand(distributed_std(
            x, self.group, self.total_count, self.batch_ndim), x.ndim)

    def min(self, x):
        return self._expand(distributed_min(x, self.group, self.batch_ndim),
                            x.ndim)

    def max(self, x):
        return self._expand(distributed_max(x, self.group, self.batch_ndim),
                            x.ndim)


# ---------------------------------------------------------------------
# blocks in and out
# ---------------------------------------------------------------------

def _local_block(x, grid: _Grid, batched: bool) -> torch.Tensor:
    """This rank's block of ``x``: a global tensor (or array), the same
    on every rank, sliced; a DTensor redistributed to the blocks."""
    data_pl = [Shard(0) if batched else Replicate(), Shard(x.ndim - 2),
               Shard(x.ndim - 1)]
    if isinstance(x, DTensor):
        return x.redistribute(grid.mesh, data_pl).to_local().contiguous()
    x = torch.as_tensor(x)
    H, W = x.shape[-2:]
    if H % grid.n_rows or W % grid.n_cols or (
            batched and x.shape[0] % grid.n_data):
        raise ValueError(f"a {tuple(x.shape)} input does not tile the "
                         f"{grid.n_data}x{grid.n_rows}x{grid.n_cols} mesh")
    Hl, Wl = H // grid.n_rows, W // grid.n_cols
    x = x[..., grid.r * Hl:(grid.r + 1) * Hl, grid.c * Wl:(grid.c + 1) * Wl]
    if batched:
        Bl = x.shape[0] // grid.n_data
        x = x[grid.d * Bl:(grid.d + 1) * Bl]
    return x.to(grid.device).contiguous()


def _frame_noise(noise, data_shape, dtype, grid: _Grid, batched: bool):
    """Known noise on this rank's device: 0-d, or this rank's frames of a
    per-frame ``(B,)`` noise."""
    noise = torch.as_tensor(noise, dtype=dtype).to(grid.device)
    if batched and noise.ndim == 1:
        Bl = data_shape[0] // grid.n_data
        noise = noise[grid.d * Bl:(grid.d + 1) * Bl].contiguous()
    return noise


def _as_dtensor(t: torch.Tensor, grid: _Grid,
                batch_axis: Optional[int]) -> DTensor:
    """A block as a DTensor sharded as JAX's ``out_specs``: the frames on
    data (``batch_axis``, or replicated for one frame), the last two axes
    on rows and cols."""
    first = Replicate() if batch_axis is None else Shard(batch_axis)
    return DTensor.from_local(
        t, grid.mesh, [first, Shard(t.ndim - 2), Shard(t.ndim - 1)],
        run_check=False)


# ---------------------------------------------------------------------
# the halo chain
# ---------------------------------------------------------------------

def _smooth_local(x, sf: ScalingFunction, s: int, grid: _Grid):
    """Separable dilated smoothing of a local block with halo exchange on
    both spatial axes (its last two)."""
    out = halo_smooth_axis(x, sf.taps, s, x.ndim - 2, grid.rows, "symmetric")
    return halo_smooth_axis(out, sf.taps, s, x.ndim - 1, grid.cols,
                            "symmetric")


def _halo_extend_2d(x, h: int, grid: _Grid):
    """Extend a local block by ``h`` on all four sides; the corners are
    right because the column exchange runs on the row-extended block."""
    ext = halo_exchange_axis(x, h, x.ndim - 2, grid.rows, "symmetric")
    return halo_exchange_axis(ext, h, x.ndim - 1, grid.cols, "symmetric")


def _bilateral_smooth_local(x, var, sf: ScalingFunction, s: int,
                            grid: _Grid):
    """Bilateral à trous smoothing of a local block: the dense 2-D tap
    loop on a halo-extended block, in the tap order of
    :func:`~wavelets_tpu_torch.ops.conv.atrous_conv_nd`."""
    d = 2 ** s
    hw = sf.half_width
    h = hw * d
    row_axis, col_axis = x.ndim - 2, x.ndim - 1
    nloc_r, nloc_c = x.shape[row_axis], x.shape[col_axis]
    kernel = sf.kernel_nd(2)
    if h > nloc_r or h > nloc_c:
        # deep-scale fallback: gather the plane and its variance, run the
        # dense bilateral conv, take this block back
        def full(a):
            return all_gather_axis(all_gather_axis(a, row_axis, grid.rows),
                                   col_axis, grid.cols)

        out = atrous_conv_nd(full(x), kernel, s,
                             bilateral_variance=full(var),
                             boundary="symmetric")
        out = out.narrow(row_axis, grid.r * nloc_r, nloc_r)
        return out.narrow(col_axis, grid.c * nloc_c, nloc_c)
    ext = _halo_extend_2d(x, h, grid)
    center = float(kernel[hw, hw])
    inv_two_var = torch.div(torch.tensor(0.5, dtype=x.dtype), var)
    out = x * torch.tensor(center, dtype=x.dtype)
    norm = torch.full_like(x, center)
    for off in _noncenter_offsets(kernel.shape):
        k = float(kernel[hw + off[0], hw + off[1]])
        shifted = ext.narrow(row_axis, h + off[0] * d, nloc_r).narrow(
            col_axis, h + off[1] * d, nloc_c)
        diff = x - shifted
        w = torch.tensor(k, dtype=x.dtype) * torch.exp(
            -(diff * diff) * inv_two_var)
        norm = norm + w
        out = out + w * shifted
    return out / norm


def _local_variance(x, sf, s, grid, floor=1e-20):
    mean = _smooth_local(x, sf, s, grid)
    vari = _smooth_local(x * x, sf, s, grid) - mean * mean
    return torch.where(vari <= 0, torch.tensor(floor, dtype=x.dtype), vari)


def _decompose_local(x, level: int, sf: ScalingFunction, grid: _Grid,
                     bilateral: Optional[Tuple[float, ...]],
                     bilateral_scaling: bool):
    planes = []
    c = x
    for s in range(level):
        if bilateral is None:
            c_next = _smooth_local(c, sf, s, grid)
        else:
            var = _local_variance(c, sf, s, grid)
            var = var * torch.tensor(bilateral[s] ** 2, dtype=c.dtype)
            if bilateral_scaling:
                var = var * (s + 1)
            c_next = _bilateral_smooth_local(c, var, sf, s, grid)
        planes.append(c - c_next)
        c = c_next
    planes.append(c)
    return stack_planes(planes)


def sharded_decompose(x, level: int, sf: ScalingFunction,
                      mesh: DeviceMesh, *, bilateral=None,
                      bilateral_scaling: bool = False) -> DTensor:
    """À trous decomposition of a 2-D image ``(H, W)`` or a frame stack
    ``(B, H, W)`` tiled over ``mesh`` → the planes ``(level+1, [B,] H,
    W)`` as a DTensor sharded on data, rows and cols.  ``x`` is a global
    tensor, the same on every rank, or a DTensor on ``mesh``.  Bitwise
    the single-device plain decomposition."""
    grid = _Grid(mesh)
    batched = x.ndim == 3
    local = _local_block(x, grid, batched)
    planes = _decompose_local(local, level, sf, grid,
                              normalize_bilateral(bilateral, level),
                              bilateral_scaling)
    return _as_dtensor(planes, grid, 1 if batched else None)


# ---------------------------------------------------------------------
# stage 2: kernel A on extended blocks, the band tail in halo mode
# ---------------------------------------------------------------------

def _band_halo_extend(x, h: int, grid: _Grid, axis: int):
    """Extend a full-width row band by ``h`` rows a side: interior halos
    from the neighbouring bands (flattened ``(rows, cols)`` order), the
    first and last band's from the image's symmetric reflection.
    Requires ``h ≤`` the band's rows."""
    n = x.shape[axis]
    nb = grid.n_rows * grid.n_cols
    b = dist.get_rank(grid.spatial)
    top = x.narrow(axis, 0, h).flip(axis)
    bot = x.narrow(axis, n - h, h).flip(axis)
    sends, recvs = [], []
    if b > 0:
        top = torch.empty_like(top)
        sends.append((x.narrow(axis, 0, h), b - 1))
        recvs.append((top, b - 1))
    if b < nb - 1:
        bot = torch.empty_like(bot)
        sends.append((x.narrow(axis, n - h, h), b + 1))
        recvs.append((bot, b + 1))
    if nb > 1:
        exchange(sends, recvs, grid.spatial)
    return torch.cat([top, x, bot], dim=axis)


def _band_gather_extend(x, h: int, grid: _Grid, axis: int):
    """Deep-reach extension (``h`` past the band): all-gather the plane
    over the flattened axes and read this band's window, ``h`` rows a
    side, through the symmetric index map (any reach)."""
    n = x.shape[axis]
    full = all_gather_axis(x, axis, grid.spatial)
    b = dist.get_rank(grid.spatial)
    idx = boundary_index(full.shape[axis], b * n - h, "symmetric",
                         x.device, n + 2 * h)
    return full.index_select(axis, idx)


def _tiled_wow_plan(Hl: int, Wl: int, n_scales: int, sf: ScalingFunction):
    """The port's stage-2 groups on a local ``Hl × Wl`` block: kernel A's
    group of the first :data:`~wavelets_tpu_torch.ops.hopper_conv.N_FAST`
    scales, as the single-device merged body runs it, shortened until its
    reach fits the local extent (JAX's single-neighbour limit) →
    ``(groups, covered)``."""
    g = min(N_FAST, n_scales)
    while g and group_halo(sf.half_width, 0, g) > min(Hl, Wl):
        g -= 1
    return ([(0, g)] if g else []), g


def _deep_tail_band_plan(Hl: int, n_cols: int, covered: int,
                         n_scales: int) -> int:
    """The band tail's rows: the tiles of one row of the mesh cut into
    ``n_cols`` full-width bands of ``Hl / n_cols`` rows, where the tail
    has scales and the rows divide (kernel A's halo step takes any band
    and dilation); else 0, and the tail runs the halo chain."""
    if covered >= n_scales or Hl % n_cols:
        return 0
    return Hl // n_cols


def _to_band(a, grid: _Grid):
    # (.., Hl, Wl) tiles → (.., Hl/n_cols, W) bands: rows chunk j to col j
    n = grid.n_cols
    if n == 1:
        return a
    *lead, Hl, Wl = a.shape
    chunks = a.reshape(*lead, n, Hl // n, Wl).movedim(-3, 0)
    got = all_to_all(chunks, grid.cols)
    return got.movedim(0, -2).reshape(*lead, Hl // n, n * Wl)


def _from_band(a, grid: _Grid):
    # (.., Hb, W) bands → (.., Hb·n_cols, W/n_cols) tiles
    n = grid.n_cols
    if n == 1:
        return a
    *lead, Hb, W = a.shape
    chunks = a.reshape(*lead, Hb, n, W // n).movedim(-2, 0)
    got = all_to_all(chunks, grid.cols)
    return got.movedim(0, -3).reshape(*lead, n * Hb, W // n)


def _tiled_wow_local(x, noise_v, *, groups, covered, sf, n_scales, weights,
                     dcs, soft_threshold, has_noise, grid, rops,
                     with_coefficients, band_rows):
    """Stage 2 on one block: per group, the block extended by the group's
    reach (overlap-save: every cropped value reads only true neighbour
    data), kernel A's group, the crop; the deep tail on row bands with
    kernel A's halo-mode step (or, without a band plan, the halo chain);
    statistics by ``rops``."""
    sigma_e = sf.sigma_e(2, False)
    batched = x.ndim == 3
    if not has_noise and any(d != 0 for d in dcs[:n_scales]):
        w0 = x - _smooth_local(x, sf, 0, grid)
        med = rops.median_abs(w0)
        noise_v = _div_scalars(med, MAD_TO_SIGMA, float(sigma_e[0]))
        noise_v = noise_v.reshape(med.shape[:x.ndim - 2])
    noise32 = torch.as_tensor(noise_v, dtype=torch.float32,
                              device=x.device)
    if batched:
        noise32 = noise32.reshape(-1).expand(x.shape[0]).contiguous()

    def thr_of(s):
        if dcs[s] == 0:
            return torch.zeros_like(noise32)
        return (dcs[s] * float(sigma_e[s])) * noise32

    out_rows = []
    recon = None
    cur = x
    for off, g in groups:
        R = group_halo(sf.half_width, off, g)
        ext = _halo_extend_2d(cur, R, grid).contiguous()
        rows_g, acc = fused_wow_group(
            ext, weights[off:off + g],
            torch.stack([thr_of(off + k) for k in range(g)]), g, sf,
            offset=off, soft=soft_threshold,
            masked=tuple(dcs[off + k] != 0 for k in range(g)),
            need_cube=with_coefficients)

        def crop(a):
            return a[..., R:-R, R:-R].contiguous()

        if with_coefficients:
            out_rows.extend(crop(rows_g[k]) for k in range(g))
        cur = crop(rows_g[-1])
        acc = crop(acc)
        recon = acc if recon is None else recon + acc

    row_ax = cur.ndim - 2
    if band_rows:
        cur_b = _to_band(cur, grid)
        recon_b = _to_band(recon, grid).contiguous()
        one = (lambda a: a) if batched else (lambda a: a[None])
        for s in range(covered, n_scales):
            R = 2 * sf.half_width * (1 << s)
            if R <= band_rows:
                ext = _band_halo_extend(cur_b, R, grid, row_ax)
            else:
                ext = _band_gather_extend(cur_b, R, grid, row_ax)
            white, _, cb = deep_whiten_step(
                one(ext.contiguous()), one(recon_b), thr_of(s).reshape(-1),
                sf=sf, scale=s, weight=float(weights[s]),
                soft=soft_threshold, masked=dcs[s] != 0,
                write_plane=with_coefficients, halo=R)
            if with_coefficients:
                out_rows.append(_from_band(white if batched else white[0],
                                           grid))
            cur_b = cb if batched else cb[0]
        cur = _from_band(cur_b, grid)
        recon = _from_band(recon_b, grid)
    else:
        noise_b = noise32[:, None, None] if batched else noise32
        for s in range(covered, n_scales):
            c_next = _smooth_local(cur, sf, s, grid)
            c = cur - c_next
            lp = _smooth_local(c * c, sf, s, grid)
            lp = torch.sqrt(torch.where(lp <= 0, 1e-15, lp))
            if dcs[s] != 0:
                c = c * significance(c, dcs[s], noise_b, float(sigma_e[s]),
                                     soft_threshold)
            c = c * torch.div(torch.tensor(weights[s], dtype=lp.dtype), lp)
            if with_coefficients:
                out_rows.append(c)
            recon = c if recon is None else recon + c
            cur = c_next

    lp = rops.std(cur)
    lp = torch.where(lp <= 0, 1e-15, lp)
    c = cur * torch.div(torch.tensor(weights[n_scales], dtype=lp.dtype), lp)
    recon = recon + c
    if not with_coefficients:
        return recon, None
    out_rows.append(c)
    if batched:
        return recon, torch.stack(out_rows, dim=1)
    return recon, stack_planes(out_rows)


@tracing.entry("wt.sharded_wow")
def sharded_wow(data, mesh: DeviceMesh, *, sf: ScalingFunction = None,
                n_scales: Optional[int] = None, weights=(),
                whitening: bool = True, denoise_coefficients=(), noise=None,
                bilateral=None, bilateral_scaling: bool = False,
                soft_threshold: bool = True, preserve_variance: bool = False,
                gamma: float = 3.2, gamma_min: Optional[float] = None,
                gamma_max: Optional[float] = None, h: float = 0,
                with_coefficients: bool = True):
    """WOW on a mesh-tiled image ``(H, W)`` or frame stack ``(B, H, W)``:
    the semantics of :func:`~wavelets_tpu_torch.models.wow.wow`, with the
    global reductions as collectives and per-frame statistics along the
    data axis.  ``data`` is a global tensor, the same on every rank, or a
    DTensor on ``mesh``; ``noise`` a scalar or one value a frame.
    Returns ``(recon, planes)`` as DTensors sharded as the input tiling,
    the planes batch-major ``(B, n_scales+1, H, W)`` for a stack (as
    :func:`~wavelets_tpu_torch.models.wow.wow_stack`) and ``(n_scales+1,
    H, W)`` for a frame; ``with_coefficients=False`` writes no planes and
    returns ``(recon, None)``.  Dispatch: the module's three stages."""
    if sf is None:
        sf = B3SPLINE
    grid = _Grid(mesh)
    batched = data.ndim == 3
    spatial_shape = tuple(data.shape[-2:])
    n_scales, rec_w, dcs, sigma_bilateral = normalize_wow_params(
        sf, n_scales, weights, denoise_coefficients, bilateral, h,
        n_dims=2, min_extent=min(spatial_shape))
    local = _local_block(data, grid, batched)
    has_noise = noise is not None
    noise_v = (_frame_noise(noise, data.shape, local.dtype, grid, batched)
               if has_noise else torch.zeros((), dtype=local.dtype,
                                             device=local.device))
    total_count = int(np.prod(spatial_shape))
    rops = ShardedReduceOps(grid.spatial, total_count, 1 if batched else 0)

    def out(recon, planes):
        batch_axis = 0 if batched else None
        return (_as_dtensor(recon, grid, batch_axis),
                None if planes is None
                else _as_dtensor(planes, grid, batch_axis))

    # stage 1: whole frames a rank, the single-device stack dispatch
    if batched and grid.n_rows == 1 and grid.n_cols == 1:
        statics = dict(
            sf=sf, n_scales=n_scales, weights=rec_w,
            whitening=bool(whitening), denoise_coefficients=dcs,
            bilateral=sigma_bilateral,
            bilateral_scaling=bool(bilateral_scaling),
            soft_threshold=bool(soft_threshold),
            preserve_variance=bool(preserve_variance), gamma=float(gamma),
            gamma_min=None if gamma_min is None else float(gamma_min),
            gamma_max=None if gamma_max is None else float(gamma_max),
            h=float(h), has_noise=has_noise)
        nz = noise_v.reshape(-1).expand(local.shape[0]).contiguous()
        return out(*_stack_core(local, nz, with_coefficients, statics))

    # stage 2: spatially tiled, float32 standard WOW
    if (whitening and float(h) == 0 and sigma_bilateral is None
            and not preserve_variance and local.dtype == torch.float32):
        Hl, Wl = local.shape[-2:]
        groups, covered = _tiled_wow_plan(Hl, Wl, n_scales, sf)
        if covered >= 1:
            return out(*_tiled_wow_local(
                local, noise_v, groups=groups, covered=covered, sf=sf,
                n_scales=n_scales, weights=rec_w, dcs=dcs,
                soft_threshold=bool(soft_threshold), has_noise=has_noise,
                grid=grid, rops=rops, with_coefficients=with_coefficients,
                band_rows=_deep_tail_band_plan(Hl, grid.n_cols, covered,
                                               n_scales)))

    # the halo body
    planes = _decompose_local(local, n_scales, sf, grid, sigma_bilateral,
                              bilateral_scaling)
    if batched and noise_v.ndim == 1:
        noise_v = noise_v[:, None, None]
    recon, out_planes = _wow_body(
        planes, noise_v, has_noise, sf, n_scales, rec_w, whitening, dcs,
        soft_threshold, preserve_variance, float(gamma), gamma_min,
        gamma_max, float(h), bilateral=sigma_bilateral is not None,
        smooth_fn=lambda p, s: _smooth_local(p, sf, s, grid), rops=rops,
        n_dim=2)
    if not with_coefficients:
        return out(recon, None)
    if batched:
        out_planes = out_planes.movedim(0, 1).contiguous()
    return out(recon, out_planes)
