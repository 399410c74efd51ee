"""The group kernels of the transform: decompose (kernel C) and merged
decompose + whiten (kernel A, group form).

Counterpart of ``wavelets_tpu/ops/pallas_conv.py``: ``_fused_group`` is
:func:`fused_group` (kernel C, ``csrc/decompose_group.cu``), with the
pieces decomposition built on it (:func:`fused_decompose_pieces`,
:func:`fused_decompose`, :func:`fused_volume_decompose`); groups are of
:data:`N_FAST` scales and every scale runs on the kernel, which takes any
dilation, so there is no plain tail.

``_fused_wow_group`` is :func:`fused_wow_group`, with its signature and
return contract.  Per scale ``s = offset + k``:

1. chain smooth at dilation ``2^s``, symmetric reflection of the
   current smooth at the image border;
2. detail = carry − next;
3. power smooth of detail² at the same dilation, clamped ``≤0 → 1e-15``,
   then sqrt;
4. erf or hard significance mask, a threshold of 0 meaning no mask;
5. multiply by ``factor/lp``;
6. accumulate into ``acc``.

On a CUDA tensor the whole group is one launch of the hand-written
kernel ``csrc/whiten_group.cu`` (counter ``whiten_group``) on the
shared-memory tile that :func:`group_plan` sizes; where no tile fits (a
rule on the shape, scale offset and taps alone), each scale is one deep
step of kernel A's deep form, ``csrc/whiten_step.cu`` (counter
``whiten_step``, two launches sized by :func:`step_plan`).  On a CPU
tensor the plain PyTorch versions below run, along the same route.
There is no fallback between kernel and plain version: a CUDA tensor the
kernel cannot take raises.  The same holds for kernel C.

Kernel A has a bfloat16 form of both its entries (``wt_whiten_group_bf16``
and ``wt_whiten_step_bf16``, counters ``whiten_group_bf16`` and
``whiten_step_bf16``), the JAX package's bfloat16 instantiations of
``_fused_wow_group`` and ``deep_whiten_step``: every fold in float32,
the values rounded to bfloat16 where the JAX kernels store them (the
group: after each separable pass, the detail, its square and the whites,
carry and acc; the deep step: only c_next, the white and the recon add),
thresholds and factors float32.  The plain versions take the same
rounding points for any dtype below float32 (:func:`low_precision`).
Kernel C has no bfloat16 form: the JAX package sends a bfloat16
decomposition to XLA (pallas_conv.py:517-519).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .conv import low_precision, separable_smooth_axis, smooth, widen
from .filters import ScalingFunction
from .layout import stack_planes

__all__ = ["N_FAST", "fused_group", "fused_group_plain", "group_pieces",
           "fused_decompose_pieces", "fused_decompose",
           "fused_volume_decompose", "fused_wow_group",
           "fused_wow_group_plain", "whiten_scale_plain",
           "whiten_detail_plain", "whiten_power_plain", "threshold_dtype",
           "GroupPlan", "group_halo", "group_plan",
           "StepPlan", "step_plan", "step_smem", "map_step", "MAX_FRAMES",
           "decompose_buffers", "SMEM_OPTIN", "STEP_STATIC_SMEM"]

KERNEL = "whiten_step"
GROUP_KERNEL = "whiten_group"
DECOMPOSE_KERNEL = "decompose_group"

#: scales per group: the decompose groups (kernel C), the merged WOW
#: group (kernel A's group form) and the whitening of decompose pieces
#: (kernel D) take scales ``[0, N_FAST)`` together, the deeper ones one
#: scale or one pair at a time.  For the WOW group the split is a tile:
#: the whitening reach of g scales, ``hw·2^offset·(3·2^(g−1)−1)`` (22
#: pixels for the B3spline at g = 3, offset 0), is the halo of the
#: shared-memory tile of ``csrc/whiten_group.cu``, whose 32 × 64 output
#: tile then takes 70 KB, at least two blocks to an SM
#: (:func:`group_plan`).
N_FAST = 3

#: shared memory one block may opt in to on an H100 (227 KB): the
#: dynamic bytes of a launch and the kernel's static ones together
SMEM_OPTIN = 232448
#: the row-buffer pass's static shared bytes (its tap-row offset table,
#: 17 offsets of 8 bytes, as ptxas lays it out), which the dynamic bytes
#: of its plan leave room for
STEP_STATIC_SMEM = 144
#: the most one block may take so that two fit on an SM (228 KB per SM,
#: 1 KB of it reserved per block)
SMEM_TWO_PER_SM = 115712
#: the group kernel's output tile: 64 columns, a row of the tile per warp
GROUP_TILE_W = 64
GROUP_TILE_HS = (64, 32, 16)
#: the tile height tried first where two blocks fit an SM, by element
#: size: 32 rows for float32 (g = 3: 6% faster than 64, more blocks in
#: flight), 64 for bfloat16 (g = 4, halo 46: 1.72 against 2.26 ms of
#: device time at 4096², the halo recomputed less; scripts/
#: kernel_variants.py on an H100 80GB HBM3 at 700 W)
GROUP_TILE_TWO_PER_SM = {4: 32, 2: 64}
GROUP_WARPS = 8
#: the row-buffer pass (kernel A's deep step, kernels C and G): whole
#: rows while a row buffer and the centre row fit, else segments of the
#: first of these widths whose buffer fits
STEP_SEGS = (4096, 2048, 1024, 512, 256)
#: frames one launch takes (the grid's z); a larger batch runs as
#: several launches over consecutive frames
MAX_FRAMES = 65535


def group_halo(hw: int, offset: int, g: int) -> int:
    """The reach of a whitening group of ``g`` scales from dilation
    ``2^offset`` (the JAX ``_wow_group_halo``)."""
    return hw * (1 << offset) * (3 * (1 << (g - 1)) - 1)


@dataclass(frozen=True)
class GroupPlan:
    """The group kernel's launch, passed to ``csrc/whiten_group.cu`` as
    it stands (the kernel checks it and launches it): a ``tile_h ×``
    :data:`GROUP_TILE_W` output tile per block with ``halo`` rows and
    ``halo_cols`` columns of halo (rounded up to 16 bytes: 4 float32 or 8
    bfloat16 elements, for 16-byte copies), ``smem_bytes`` of shared
    memory, ``grid = (column tiles, row tiles, frames)``."""
    tile_h: int
    halo: int
    halo_cols: int
    smem_bytes: int
    grid: Tuple[int, int, int]


def _group_smem(tile_h: int, halo: int, halo_cols: int,
                itemsize: int = 4) -> int:
    # two (tile_h + 2·halo) × (64 + 2·halo_cols) planes, a row buffer a warp
    sw = GROUP_TILE_W + 2 * halo_cols
    return itemsize * (2 * (tile_h + 2 * halo) * sw + GROUP_WARPS * sw)


def group_plan(B: int, H: int, W: int, g: int, hw: int, offset: int,
               itemsize: int = 4) -> Optional[GroupPlan]:
    """The tile of :func:`fused_wow_group` on the card, from the shape,
    group depth, half width of the taps, scale offset and element size
    (4 for float32, 2 for bfloat16) alone: a tile of
    :data:`GROUP_TILE_TWO_PER_SM` rows (32 for float32, 64 for bfloat16)
    where two blocks fit an SM, else the tallest tile of 64, 32 or 16
    rows that fits the opt-in shared memory, else None (the scales then
    run as deep steps).  The bfloat16 group of the merged path, g = 4 at
    offset 0 (halo 46), takes the 64-row tile in 100 KB, two blocks an
    SM; in float32 the same group would need 200 KB, one block an SM.
    At offset 0, g = 3 the float32 32-row tile ran a few percent faster
    than the 64-row one on an H100 (``scripts/kernel_variants.py``): more
    blocks in flight outweigh its larger halo share.  A 16-row tile is
    never taken for the second block on an SM: its halo would be
    recomputed 5-6 times."""
    if g < 1:
        raise ValueError("a group needs at least one scale")
    if offset + g > 20:
        return None
    halo = group_halo(hw, offset, g)
    vec = 16 // itemsize
    halo_cols = -(-halo // vec) * vec
    for th, limit in ((GROUP_TILE_TWO_PER_SM[itemsize], SMEM_TWO_PER_SM),
                      *((t, SMEM_OPTIN) for t in GROUP_TILE_HS)):
        smem = _group_smem(th, halo, halo_cols, itemsize)
        if smem <= limit:
            grid = (-(-W // GROUP_TILE_W), -(-H // th), B)
            return GroupPlan(th, halo, halo_cols, smem, grid)
    return None


def map_step(D: int, n: int) -> int:
    """The dilation a kernel takes on an axis of ``n`` for a true
    dilation ``D``: ``D``, or from ``2n`` on (the symmetric index map's
    period) ``2n + D mod 2n``, which names the same taps, residue classes
    and segment layout in 32-bit index math (``csrc/wt_tile.cuh``)."""
    return D if D < 2 * n else 2 * n + D % (2 * n)


@dataclass(frozen=True)
class StepPlan:
    """The row-buffer pass's launch (``csrc/wt_step.cuh``), passed to the
    C entries of kernels A, C and G as it stands (they check it and
    launch it): whole rows (``seg == 0``) or segments of ``seg`` columns,
    ``smem_bytes`` per block, ``grid = (rows in residue-class order,
    segments, frames a launch)`` (a batch of more frames runs as several
    launches), 32- or 64-bit offsets."""
    seg: int
    smem_bytes: int
    grid: Tuple[int, int, int]
    index_bits: int


def step_smem(W: int, D: int, hw: int, seg: int) -> int:
    """Shared bytes of a row-buffer block: two rows of floats, or for a
    segment of ``seg`` columns its row buffer, ``2hw·min(Dc, seg) + seg``
    floats (a contiguous ``hw·Dc`` halo, or the ``2hw+1`` tap windows side
    by side where the columns' dilation ``Dc`` passes the segment), and
    its centre row."""
    if seg == 0:
        return 8 * W
    return 4 * (2 * seg + 2 * hw * min(map_step(D, W), seg))


def step_plan(B: int, H: int, W: int, D: int, hw: int,
              src_rows: int = 0) -> StepPlan:
    """The row-buffer pass's launch on the card, from the shape, the true
    dilation and the half width of the taps: whole rows where two rows
    fit the shared memory beside the static tap-row table
    (:data:`STEP_STATIC_SMEM`; ``W ≤ 29038``), else the widest segment of
    :data:`STEP_SEGS` whose buffer fits (at any dilation: past the
    segment the buffer holds the tap windows only); raises where the
    taps' reach (:func:`map_step`) passes 32-bit index math, a side
    reaches 2^30 or a row more than 65535 segments (2^28 columns).
    ``src_rows`` is halo mode (kernel A's deep step on a pre-extended
    band): the ``H`` output rows read a source of ``src_rows`` rows a
    frame at the true dilation, without reflection."""
    if not 1 <= D < 2 ** 63:
        raise ValueError(f"step_plan: dilation {D} not in 1..2^62")
    if max(H, W, src_rows) >= 2 ** 30:
        raise ValueError(f"step_plan: a {H}x{W} frame passes 32-bit "
                         "index math (2^30 a side)")
    budget = SMEM_OPTIN - STEP_STATIC_SMEM
    if 8 * W <= budget:
        seg = 0
    else:
        seg = next(s for s in STEP_SEGS if step_smem(W, D, hw, s) <= budget)
    Dr = D if src_rows else map_step(D, H)
    Dc = map_step(D, W)
    Hi = max(H, src_rows)
    if max(Hi + hw * Dr, W + seg + hw * Dc) >= 2 ** 31:
        raise ValueError(f"step_plan: the taps of a {H}x{W} frame at "
                         f"dilation {D} reach past 32-bit index math "
                         "(2^31)")
    rows = H if Dr >= H else Dr * -(-H // Dr)
    frames = min(B, MAX_FRAMES)
    grid = (rows, 1 if seg == 0 else -(-W // seg), frames)
    if grid[1] > 65535:
        raise ValueError(f"step_plan: {grid[1]} segments of a {W}-column "
                         "row pass the grid's 65535")
    return StepPlan(seg, step_smem(W, D, hw, seg), grid,
                    32 if frames * Hi * W < 2 ** 31 else 64)


#: kernel A's deep-step entries by (carry, c_next) dtype: the float32 and
#: bfloat16 forms, and the two halves of the bfloat16 pair with a float32
#: middle carry (hopper_deep.deep_whiten_step2_split)
_STEP_ENTRIES = {
    (torch.float32, torch.float32): "wt_whiten_step_f32",
    (torch.bfloat16, torch.bfloat16): "wt_whiten_step_bf16",
    (torch.bfloat16, torch.float32): "wt_whiten_step_bf16_f32next",
    (torch.float32, torch.bfloat16): "wt_whiten_step_bf16_f32carry",
}
# pointers, acc_mode, thr, fac, masked, soft, taps, n_taps
_STEP_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p,
              ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_int])
# a plan: seg, grid rows, grid segments, frames, shared bytes; index bits
_PLAN_ARGS = [ctypes.c_longlong] * 5 + [ctypes.c_int]


def _lib():
    lib = _build.load(KERNEL)
    for entry in _STEP_ENTRIES.values():
        fn = getattr(lib, entry)
        # B, H, W, D, then the plan
        fn.argtypes = (_STEP_ARGS + [ctypes.c_longlong] * 4 + _PLAN_ARGS
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    fn = lib.wt_whiten_step_halo_f32
    # B, H, W, D, halo, then the two passes' plans
    fn.argtypes = (_STEP_ARGS + [ctypes.c_longlong] * 5 + _PLAN_ARGS * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _lib_group():
    lib = _build.load(GROUP_KERNEL)
    for sfx in ("f32", "bf16"):
        fn = getattr(lib, f"wt_whiten_group_{sfx}")
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def check_kernel_input(x: torch.Tensor, sf: ScalingFunction,
                       what: str, bf16: bool = False) -> None:
    """Raise unless ``x`` is a contiguous float32 CUDA tensor (or
    bfloat16, for a kernel with a bfloat16 form: ``bf16``) and ``sf`` has
    the symmetric taps the kernel folds pairwise."""
    if x.dtype != torch.float32 and not (bf16 and x.dtype == torch.bfloat16):
        raise TypeError(f"{what}: the CUDA kernel takes float32"
                        f"{' or bfloat16' if bf16 else ''}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the CUDA kernel needs a contiguous tensor")
    if not sf.is_symmetric or sf.half_width > 8:
        raise ValueError(f"{what}: the CUDA kernel needs symmetric taps "
                         "of half width <= 8")


def launch_whiten_step(carry, c_next, detail, white, acc, acc_mode, thr,
                       fac, masked, soft, sf, scale) -> None:
    """One scale of kernel A's deep form (two launches) on ``(B, H, W)``
    CUDA tensors, float32 or (the bfloat16 form) a bfloat16 carry,
    c_next, white and acc, or one half of the bfloat16 pair with a
    float32 middle carry (a float32 ``c_next`` or carry beside bfloat16
    white and acc, :data:`_STEP_ENTRIES`); ``detail`` is float32 scratch
    that the caller holds by name until the launches are queued, ``thr``
    float32.  The launch counter, the white's dtype's, is incremented here
    and nowhere else."""
    lib = _lib()
    B, H, W = carry.shape
    plan = step_plan(B, H, W, 1 << scale, sf.half_width)
    taps = (ctypes.c_double * len(sf.taps))(*sf.taps)
    store = (white if white is not None else acc if acc is not None
             else c_next).dtype
    if carry.dtype != store and c_next.dtype != store:
        raise TypeError("launch_whiten_step: carry, c_next and the stores "
                        "must share a dtype, bar the pair's float32 "
                        "middle carry")
    entry = getattr(lib, _STEP_ENTRIES[(carry.dtype, c_next.dtype)])
    code = entry(
        _ptr(carry), _ptr(c_next), _ptr(detail), _ptr(white), _ptr(acc),
        int(acc_mode), _ptr(thr), float(fac), int(bool(masked)),
        int(bool(soft)), taps, len(sf.taps), B, H, W, 1 << scale, plan.seg,
        plan.grid[0], plan.grid[1], plan.grid[2], plan.smem_bytes,
        plan.index_bits, _build.stream_ptr(carry.device))
    _build.check(lib, code, "whiten_step")
    _build.LAUNCHES[_build.counter(KERNEL, store)] += 1


def whiten_detail_plain(c: torch.Tensor, fac, thr, sf: ScalingFunction,
                        scale: int, soft: bool, masked: bool = True):
    """Whiten a detail plane in plain PyTorch on the last two axes →
    ``(white, wc)``: power smooth at dilation ``2^scale``, clamped
    ``≤0 → 1e-15``, sqrt, the erf or hard mask (a threshold of 0 meaning
    no mask) giving ``wc``, then ``white = wc·(fac/lp)``.  ``fac`` is a
    float or a tensor and ``thr`` a tensor, each broadcasting against
    ``c`` (a scalar, or ``(B, 1, 1)`` per frame)."""
    return whiten_power_plain(c, smooth(c * c, sf, scale=scale,
                                        axes=(-2, -1)), fac, thr, soft,
                              masked)


def whiten_power_plain(c: torch.Tensor, lp: torch.Tensor, fac, thr,
                       soft: bool, masked: bool = True):
    """The whitening epilogue of :func:`whiten_detail_plain` from the
    detail ``c`` and its power smooth ``lp`` (same dtype) → ``(white,
    wc)``."""
    lp = torch.sqrt(torch.where(lp <= 0, 1e-15, lp))
    if masked:
        safe_t = torch.where(thr == 0, torch.ones_like(thr), thr)
        if soft:
            mask = torch.erf(torch.abs(c / safe_t))
        else:
            mask = (torch.abs(c) > safe_t).to(c.dtype)
        c = c * torch.where(thr == 0, torch.ones_like(mask), mask)
    if not isinstance(fac, torch.Tensor):
        fac = torch.tensor(fac, dtype=lp.dtype)
    # a true division: ``fac / lp`` with a Python float multiplies by the
    # reciprocal, one rounding more than the kernel and the JAX package
    return c * torch.div(fac, lp), c


def whiten_scale_plain(carry: torch.Tensor, thr: torch.Tensor, fac: float,
                       sf: ScalingFunction, scale: int, soft: bool,
                       masked: bool):
    """One WOW scale in plain PyTorch on the last two axes → ``(white,
    c_next)``.  ``thr`` broadcasts against ``carry`` (a scalar, or
    ``(B, 1, 1)`` per frame)."""
    c_next = smooth(carry, sf, scale=scale, axes=(-2, -1))
    white, _ = whiten_detail_plain(carry - c_next, fac, thr, sf, scale, soft,
                                   masked)
    return white, c_next


def _group_args(x, factors, thresholds, g, masked):
    if g < 1:
        raise ValueError("a group needs at least one scale")
    batched = x.ndim == 3
    xb = x if batched else x[None]
    B = xb.shape[0]
    factors = [float(f) for f in factors]
    masked = tuple(bool(m) for m in masked) or (False,) * g
    if len(factors) != g or len(masked) != g:
        raise ValueError("factors and masked need one entry per scale")
    # thresholds stay float32 below float32, as the JAX kernels take them
    thr = torch.as_tensor(thresholds, dtype=threshold_dtype(x.dtype),
                          device=x.device)
    thr = thr.reshape(g, -1).expand(g, B)
    return batched, xb, factors, masked, thr


def threshold_dtype(dtype):
    """The dtype the kernels and their plain versions take thresholds
    in: float32 for a carry below float32, else the carry's."""
    return torch.float32 if low_precision(dtype) else dtype


def _pass(x: torch.Tensor, sf: ScalingFunction, scale: int,
          axis: int) -> torch.Tensor:
    """One separable pass, in float32 below float32 and rounded back to
    ``x``'s dtype: a pass of the JAX group kernel into its scratch of the
    input dtype (pallas_conv.py:_conv_pass_ref)."""
    return separable_smooth_axis(widen(x), sf.taps, scale, axis,
                                 "symmetric").to(x.dtype)


def fused_wow_group_plain(x: torch.Tensor, factors: Sequence[float],
                          thresholds, g: int, sf: ScalingFunction,
                          offset: int = 0, soft: bool = True,
                          masked: Tuple[bool, ...] = (),
                          need_cube: bool = True):
    """Plain PyTorch version of :func:`fused_wow_group` (any dtype or
    device).  Below float32 it keeps the rounding points of the JAX
    group kernel in that dtype (pallas_conv.py:137, :300-376): each pass
    of the chain smooth, the detail, its square and each pass of the
    power smooth round to the input dtype; the mask and the whitening
    run in float32, the whites round on store, acc sums in float32 and
    rounds once.  At float32 and above every rounding is a no-op."""
    _build.PLAIN_CALLS[_build.counter(GROUP_KERNEL, x.dtype)] += 1
    batched, xb, factors, masked, thr = _group_args(
        x, factors, thresholds, g, masked)
    rows, acc, cur = [], None, xb
    for k in range(g):
        s = offset + k
        c_next = _pass(_pass(cur, sf, s, -2), sf, s, -1)
        detail = cur - c_next
        power = _pass(_pass(detail * detail, sf, s, -2), sf, s, -1)
        white, _ = whiten_power_plain(
            widen(detail), widen(power), factors[k], thr[k][:, None, None],
            soft, masked[k])
        acc = white if acc is None else acc + white
        if need_cube:
            rows.append(white.to(xb.dtype))
        cur = c_next
    # its own tensor, as the kernel's acc is, also where g = 1
    rows.append(cur)
    acc = acc.to(xb.dtype, copy=g == 1)
    if not batched:
        return tuple(r[0] for r in rows), acc[0]
    return tuple(rows), acc


def fused_wow_group(x: torch.Tensor, factors: Sequence[float], thresholds,
                    g: int, sf: ScalingFunction, offset: int = 0,
                    soft: bool = True, masked: Tuple[bool, ...] = (),
                    need_cube: bool = True):
    """Fused decompose+whiten of ``g`` scales at dilation base
    ``2^offset``: returns ``(rows, acc)`` where ``rows`` holds the ``g``
    whitened detail planes then the carry (the carry alone when
    ``need_cube=False``) and ``acc`` is Σ whitened.

    ``x`` is ``(H, W)`` or a frame stack ``(B, H, W)``; ``factors`` are
    ``g`` host floats (the per-scale weights); ``thresholds`` is a tensor
    of shape ``(g,)`` or ``(g, B)`` on ``x``'s device, used for the scales
    with ``masked[k]``.

    Route, by :func:`group_plan` (shape, ``g``, taps, ``offset`` and
    element size only): where a tile fits, one launch of
    ``csrc/whiten_group.cu`` on a CUDA ``x`` (its bfloat16 form for a
    bfloat16 ``x``; :func:`fused_wow_group_plain` on a CPU ``x``); where
    none fits (the float32 B3spline from offset 2 at g = 3), one
    :func:`~.hopper_deep.deep_whiten_step` per scale (kernel A's deep
    form on a CUDA ``x``, its plain version on a CPU ``x``), bitwise the
    group in float32.  A bfloat16 group no tile holds (the JAX plan's
    deep groups of a frame wider than its stream's budget, 256×25600)
    runs :func:`fused_wow_group_plain` on any device, the JAX group's
    rounding.  A CUDA ``x`` the kernels cannot take (float16, float64)
    raises."""
    from .hopper_deep import deep_whiten_step
    batched, xb, factors, masked, thr = _group_args(
        x, factors, thresholds, g, masked)
    B, H, W = xb.shape
    plan = group_plan(B, H, W, g, sf.half_width, offset, x.element_size())
    if plan is None and low_precision(x.dtype):
        # a documented dispatch rule, as float64 runs plain: below float32
        # the deep steps would round elsewhere than the JAX group (after
        # every pass), so a group no tile holds runs the plain group body
        return fused_wow_group_plain(x, factors, thresholds, g, sf, offset,
                                     soft, masked, need_cube)
    if plan is None:
        rows, acc, cur = [], None, xb
        for k in range(g):
            white, acc, cur = deep_whiten_step(
                cur, acc, thr[k], sf=sf, scale=offset + k,
                weight=factors[k], soft=soft, masked=masked[k],
                write_plane=need_cube or k == 0)
            if k == 0:
                # acc starts as scale 0's white, in a tensor of its own
                acc = white.clone() if need_cube else white
            if need_cube:
                rows.append(white)
    elif not x.is_cuda:
        return fused_wow_group_plain(x, factors, thresholds, g, sf, offset,
                                     soft, masked, need_cube)
    else:
        check_kernel_input(x, sf, "fused_wow_group", bf16=True)
        thr = thr.contiguous()
        acc = torch.empty_like(xb)
        cur = torch.empty_like(xb)
        rows = [torch.empty_like(xb) for _ in range(g)] if need_cube else []
        lib = _lib_group()
        taps = (ctypes.c_double * len(sf.taps))(*sf.taps)
        entry = getattr(lib, f"wt_whiten_group_{_build.dtype_suffix(x.dtype)}")
        code = entry(
            _ptr(xb), (ctypes.c_void_p * g)(*[r.data_ptr() for r in rows])
            if need_cube else None, _ptr(cur), _ptr(acc), _ptr(thr),
            (ctypes.c_float * g)(*factors),
            (ctypes.c_int * g)(*[int(m) for m in masked]), int(bool(soft)),
            g, offset, taps, len(sf.taps), B, H, W, plan.tile_h, plan.halo,
            plan.halo_cols, plan.grid[0], plan.grid[1], plan.smem_bytes,
            _build.stream_ptr(x.device))
        _build.check(lib, code, "whiten_group")
        _build.LAUNCHES[_build.counter(GROUP_KERNEL, x.dtype)] += 1
    rows.append(cur)
    if not batched:
        return tuple(r[0] for r in rows), acc[0]
    return tuple(rows), acc


# ---------------------------------------------------------------------
# Kernel C: the decompose group
# ---------------------------------------------------------------------

def _lib_decompose():
    lib = _build.load(DECOMPOSE_KERNEL)
    fn = lib.wt_decompose_group_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 3
                   + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _group_rows(level: int, smooth_only: bool) -> int:
    if level < 1:
        raise ValueError("a decompose group needs at least one scale")
    return 1 if smooth_only else level + 1


def decompose_buffers(level: int, smooth_only: bool = False):
    """Kernel C's buffers, scale by scale: ``(source, c_next, detail)``,
    each ``"x"`` (the input), ``"spare"`` (a scratch plane) or a row of
    the output cube (``detail`` None with ``smooth_only``).  The rows fold
    reads carry rows that belong to other blocks, so no scale writes its
    own source: ``c_next`` alternates between the cube's carry row and the
    spare, the last scale in the carry row, and ``x`` is only read.  No
    cube row can be the spare: the last scale reads the carry of the one
    before while it writes its detail and the carry row, and the rows
    before hold earlier details.  So one scale needs no spare and ``g ≥
    2`` one plane."""
    carry = _group_rows(level, smooth_only) - 1
    out, src = [], "x"
    for k in range(level):
        dst = carry if (level - 1 - k) % 2 == 0 else "spare"
        out.append((src, dst, None if smooth_only else k))
        src = dst
    return out


def fused_group_plain(x: torch.Tensor, level: int, sf: ScalingFunction,
                      offset: int = 0,
                      smooth_only: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_group` (any dtype or
    device)."""
    _build.PLAIN_CALLS[DECOMPOSE_KERNEL] += 1
    _group_rows(level, smooth_only)
    rows, cur = [], x
    for k in range(level):
        c_next = smooth(cur, sf, scale=offset + k, axes=(-2, -1))
        if not smooth_only:
            rows.append(cur - c_next)
        cur = c_next
    rows.append(cur)
    return stack_planes(rows)


def fused_group(x: torch.Tensor, level: int, sf: ScalingFunction,
                offset: int = 0, smooth_only: bool = False) -> torch.Tensor:
    """Decomposition of ``level`` scales at dilation base ``2^offset`` on
    the last two axes.  ``x`` is ``(H, W)`` or a frame stack
    ``(B, H, W)``; returns ``(level+1, *x.shape)``: the detail planes of
    scales ``offset .. offset+level−1``, then the carry, or with
    ``smooth_only`` the carry alone, ``(1, *x.shape)`` (the 3-D volume
    path's in-plane pass).  A CPU ``x`` runs :func:`fused_group_plain`; a
    CUDA ``x`` runs kernel C (``csrc/decompose_group.cu``: one row-buffer
    launch a scale, each sized by :func:`step_plan`, in the buffers of
    :func:`decompose_buffers`) or raises."""
    if not x.is_cuda:
        return fused_group_plain(x, level, sf, offset, smooth_only)
    check_kernel_input(x, sf, "fused_group")
    if x.ndim not in (2, 3):
        raise ValueError("fused_group takes (H, W) or (B, H, W)")
    n_rows = _group_rows(level, smooth_only)
    out = torch.empty((n_rows,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    B = x.shape[0] if x.ndim == 3 else 1
    H, W = x.shape[-2:]
    plans = [step_plan(B, H, W, 1 << (offset + k), sf.half_width)
             for k in range(level)]
    bufs = decompose_buffers(level, smooth_only)
    # scratch held by name until the launches are queued
    spare = torch.empty_like(x) if level > 1 else None

    def ptrs(i):
        names = [b[i] for b in bufs]
        return (ctypes.c_void_p * level)(*[
            0 if n is None else x.data_ptr() if n == "x"
            else spare.data_ptr() if n == "spare" else out[n].data_ptr()
            for n in names])

    def per_scale(field):
        return (ctypes.c_longlong * level)(*[field(p) for p in plans])

    lib = _lib_decompose()
    taps = (ctypes.c_double * len(sf.taps))(*sf.taps)
    code = lib.wt_decompose_group_f32(
        ptrs(0), ptrs(1), ptrs(2), int(level), int(offset), taps,
        len(sf.taps), B, H, W, per_scale(lambda p: p.seg),
        per_scale(lambda p: p.grid[0]), per_scale(lambda p: p.grid[1]),
        plans[0].grid[2], per_scale(lambda p: p.smem_bytes),
        plans[0].index_bits, _build.stream_ptr(x.device))
    _build.check(lib, code, "decompose_group")
    _build.LAUNCHES[DECOMPOSE_KERNEL] += 1
    return out


def group_pieces(x: torch.Tensor, level: int, run_group,
                 defer_tail: bool = False):
    """``(pieces, layout, tail)`` of a decomposition run as groups of
    :data:`N_FAST` scales: ``run_group(carry, g, offset)`` returns the
    ``(g+1, *x.shape)`` cube of one group (details, then the carry).
    Shared by the standard (kernel C) and bilateral (kernel F) pieces."""
    pieces, layout, cur = [], {}, x
    last = min(level, N_FAST) if defer_tail else level
    for offset in range(0, last, N_FAST):
        g = min(N_FAST, last - offset)
        planes = run_group(cur, g, offset)
        for s in range(g):
            layout[offset + s] = (len(pieces), s)
        pieces.append(planes)
        cur = planes[g]
    if last < level:
        return pieces, layout, (cur, level - last)
    layout[level] = (len(pieces) - 1, g)
    return pieces, layout, None


def fused_decompose_pieces(x: torch.Tensor, level: int, sf: ScalingFunction,
                           *, defer_tail: bool = False):
    """Multi-scale decomposition as ``(pieces, layout, tail)`` with no
    plane-cube concatenation: ``pieces[k]`` is the cube of one group of
    :data:`N_FAST` scales (the last group may be shorter), ``layout[s] =
    (k, row)`` locates scale ``s`` and ``layout[level]`` the residual.

    ``defer_tail=True`` stops after the first group and returns ``tail =
    (carry, level − N_FAST)``: the deeper scales are left to the consumer,
    which whitens them from the carry without materializing their detail
    planes (``models/wow.py::_deep_tail_scales``).  ``tail`` is None when
    every scale was computed.  ``x``: ``(H, W)`` or ``(B, H, W)``."""
    return group_pieces(
        x, level, lambda cur, g, offset: fused_group(cur, g, sf, offset),
        defer_tail)


def fused_decompose(x: torch.Tensor, level: int,
                    sf: ScalingFunction) -> torch.Tensor:
    """Plane-cube form of :func:`fused_decompose_pieces` (one stack)."""
    pieces, layout, _ = fused_decompose_pieces(x, level, sf)
    return stack_planes([pieces[k][r] for s in range(level + 1)
                         for (k, r) in [layout[s]]])


def fused_volume_decompose(x: torch.Tensor, level: int,
                           sf: ScalingFunction) -> torch.Tensor:
    """3-D à trous decomposition of a volume ``(D, H, W)`` with the
    in-plane passes on kernel C: per scale, the axial dilated pass in
    plain PyTorch (the JAX package leaves it to XLA), then the in-plane
    pass as a one-scale ``smooth_only`` group with the depth as the
    batch, then the 3-D detail ``cur − c_next``.  The axis order (axial,
    rows, cols) is that of :func:`~.conv.smooth`, so the result is
    bitwise the plain chain's (watroo/wavelets.py:47-64)."""
    planes, cur = [], x
    for s in range(level):
        axial = separable_smooth_axis(cur, sf.taps, s, 0, "symmetric")
        c_next = fused_group(axial, 1, sf, offset=s, smooth_only=True)[0]
        planes.append(cur - c_next)
        cur = c_next
    planes.append(cur)
    return stack_planes(planes)
