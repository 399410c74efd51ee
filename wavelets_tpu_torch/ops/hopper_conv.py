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
``whiten_step``, two launches sized by :func:`step_plan`; in bfloat16
and in halo mode one launch of its residue-class stream, sized by
:func:`stream_step_plan`).  In bfloat16 the group is the same source's
streamed design, sized by :func:`stream_plan`: a block walks a band of
rows down a strip of columns with each scale on rings of rows, so the
vertical halo is computed once a band, not once a tile.  The merged
route's group takes :data:`N_FAST` scales on the tile and
:data:`N_STREAM` on the streamed group; the rest of its geometry is the
same in every dtype (``models/wow.py``).  On a CPU
tensor the plain PyTorch versions below run, along the same route.
There is no fallback between kernel and plain version: a CUDA tensor the
kernel cannot take raises.  The same holds for kernel C.

Kernel A has a bfloat16 form of both its entries (``wt_whiten_group_bf16``,
the streamed group, and ``wt_whiten_step_bf16``, counters
``whiten_group_bf16`` and ``whiten_step_bf16``): bfloat16 at the
boundary, float32 inside.  The group reads a bfloat16 frame, computes
every pass, the detail, its square, the power smooth, the mask and the
white in float32, and stores the whites in bfloat16, the carry and acc
in float32; the deep step reads and writes float32 carries and acc and
stores its white in bfloat16.  Thresholds and factors are float32.  The
plain versions are the float32 plain versions on the widened input, the
whites rounded on store.  This departs on purpose from the JAX package's
bfloat16 kernels, which round every pass and the carry to bfloat16: on
frames of hundreds of counts that rounding missed a float32 WOW of the
same frame by up to 0.25 (rel. L2) in a plane (PERF.md, section 6).
Kernel C has no bfloat16 form: the JAX package sends a bfloat16
decomposition to XLA (pallas_conv.py:517-519).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from .. import tracing
from . import _build
from .conv import low_precision, separable_smooth_axis, smooth, widen
from .filters import ScalingFunction
from .layout import stack_planes

__all__ = ["N_FAST", "N_STREAM", "fused_group", "fused_group_plain",
           "group_pieces", "fused_decompose_pieces", "fused_decompose",
           "fused_volume_decompose", "fused_wow_group",
           "fused_wow_group_plain", "whiten_scale_plain",
           "whiten_detail_plain", "whiten_power_plain", "threshold_dtype",
           "GroupPlan", "group_halo", "group_plan", "StreamPlan",
           "stream_plan", "stream_smem", "stream_margins",
           "StepPlan", "step_plan", "step_smem", "map_step", "MAX_FRAMES",
           "StreamStepPlan", "stream_step_plan", "stream_step_smem",
           "stream_classes", "stream_chunk", "H100_SMS",
           "decompose_buffers", "SMEM_OPTIN", "STEP_STATIC_SMEM"]

KERNEL = "whiten_step"
#: the launch counter of kernel A's deep step in halo mode
HALO_KERNEL = "whiten_step_halo"
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
#: scales of the bfloat16 merged route's group (the streamed group of
#: ``csrc/whiten_group.cu``): its rings hold a group's vertical halo once
#: a band, not once a tile, so a fourth scale costs one more ring, not a
#: tile twice as tall; g = 4 at 4096² takes two 107 KiB blocks an SM
#: (:func:`stream_plan`), the group ``aia_wow_bf16.frame`` runs and was
#: measured at (PERF.md, section 5)
N_STREAM = 4

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
#: the tile height tried first where two blocks fit an SM: 32 rows
#: (g = 3: 6% faster than 64, more blocks in flight)
GROUP_TILE_TWO_PER_SM = 32
GROUP_WARPS = 8
#: the streamed group (bfloat16): rows a step (one a warp), the table at
#: the front of its shared memory, the strip widths and band heights its
#: plan weighs, and the SMs of an H100 SXM that it fills
STREAM_ROWS = 8
STREAM_TABLE_BYTES = 1024
STREAM_STRIPS = (128, 96, 64, 32, 16, 8)
STREAM_BANDS = (1024, 512, 256, 128, 64, 32, 16, 8)
H100_SMS = 132
#: the row-buffer pass (kernel A's deep step, kernels C and G): whole
#: rows while a row buffer and the centre row fit, else segments of the
#: first of these widths whose buffer fits
STEP_SEGS = (4096, 2048, 1024, 512, 256)
#: the residue-class stream (kernel A's deep step in bfloat16 and in halo
#: mode): whole rows while its rings fit, else runs of the first of these
#: widths whose rings fit (multiples of 8, for 16-byte copies)
STREAM_STEP_SEGS = (4096, 2048, 1024, 512, 256, 128, 64, 32, 16, 8)
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


def _group_smem(tile_h: int, halo: int, halo_cols: int) -> int:
    # two (tile_h + 2·halo) × (64 + 2·halo_cols) float planes, a row
    # buffer a warp
    sw = GROUP_TILE_W + 2 * halo_cols
    return 4 * (2 * (tile_h + 2 * halo) * sw + GROUP_WARPS * sw)


def group_plan(B: int, H: int, W: int, g: int, hw: int, offset: int,
               itemsize: int = 4):
    """The launch of :func:`fused_wow_group` on the card, from the shape,
    group depth, half width of the taps, scale offset and element size
    alone.  Float32 (``itemsize`` 4) takes the tile: 32 rows where two
    blocks fit an SM, else the tallest tile of 64, 32 or 16 rows that
    fits the opt-in shared memory, else None (the scales then run as deep
    steps).  At offset 0, g = 3 the 32-row tile ran a few percent faster
    than the 64-row one on an H100 (``scripts/kernel_variants.py``): more
    blocks in flight outweigh its larger halo share.  A 16-row tile is
    never taken for the second block on an SM: its halo would be
    recomputed 5-6 times.  Bfloat16 (``itemsize`` 2) takes the streamed
    group, :func:`stream_plan`."""
    if g < 1:
        raise ValueError("a group needs at least one scale")
    if itemsize != 4:
        return stream_plan(B, H, W, g, hw, offset)
    if offset + g > 20:
        return None
    halo = group_halo(hw, offset, g)
    halo_cols = -(-halo // 4) * 4
    for th, limit in ((GROUP_TILE_TWO_PER_SM, SMEM_TWO_PER_SM),
                      *((t, SMEM_OPTIN) for t in GROUP_TILE_HS)):
        smem = _group_smem(th, halo, halo_cols)
        if smem <= limit:
            grid = (-(-W // GROUP_TILE_W), -(-H // th), B)
            return GroupPlan(th, halo, halo_cols, smem, grid)
    return None


@dataclass(frozen=True)
class StreamPlan:
    """The streamed group's launch (``csrc/whiten_group.cu``,
    ``wt_whiten_group_bf16``), passed to the kernel as it stands (it
    lays out its rings, checks the plan against them and launches it): a
    strip of ``strip_w`` output columns and a band of ``band_h`` output
    rows a block, the group's reach ``halo`` in rows, the input ring's
    column margin ``halo_cols`` (the scales' margins rounded up to 16
    bytes), ``smem_bytes`` of shared memory, ``grid = (strips, bands,
    frames)``."""
    strip_w: int
    band_h: int
    halo: int
    halo_cols: int
    smem_bytes: int
    grid: Tuple[int, int, int]


def stream_margins(g: int, hw: int, offset: int):
    """The streamed group's column margins, scale by scale: ``(hd, ec,
    ecar)``, the reach ``hw·2^(offset+k)`` of each scale, the margin of
    its c_next and that of its chain's rows fold (and of its carry's
    ring), each even (a lane folds two columns), from the last scale
    back: ``ec_k = even(max(hd_k, ecar_(k+1)))``, ``ecar_k = even(ec_k +
    hd_k)``."""
    hd = [hw << (offset + k) for k in range(g)]
    ec, ecar, nxt = [0] * g, [0] * g, 0
    for k in reversed(range(g)):
        ec[k] = _even(max(hd[k], nxt))
        ecar[k] = nxt = _even(ec[k] + hd[k])
    return hd, ec, ecar


def _even(n: int) -> int:
    return n + (n & 1)


# bfloat16 elements a 16-byte copy: the input ring's column margin is a
# multiple of it
_STREAM_VEC = 8


def stream_smem(strip_w: int, g: int, hw: int, offset: int) -> int:
    """Shared bytes of a streamed block, as ``csrc/whiten_group.cu::
    stream_layout`` lays them out, each region on 16 bytes: the block's
    table (:data:`STREAM_TABLE_BYTES`); the input's ring of ``2hd_0 +
    2·8`` rows (one step read, the next arriving) of the strip and
    ``halo_cols`` a side, in bfloat16; in float32, per scale the ring of
    its c_next, ``2hd_(k+1) + 8`` rows (the last one ``hd + 8``) and
    that of its squared detail, ``2hd_k + 8`` rows, the sums of the
    whites, ``R − 2hd_0 + 8`` rows of the strip, and a row a warp."""
    rs = STREAM_ROWS
    hd, ec, ecar = stream_margins(g, hw, offset)
    rc = -(-ecar[0] // _STREAM_VEC) * _STREAM_VEC
    halo = group_halo(hw, offset, g)
    regions = [(2 * hd[0] + 2 * rs) * (strip_w + 2 * rc) * 2]
    regions += [(2 * hd[k] + rs) * (strip_w + 2 * ec[k - 1]) * 4
                for k in range(1, g)]
    regions.append((hd[g - 1] + rs) * (strip_w + 2 * ec[g - 1]) * 4)
    regions += [(2 * hd[k] + rs) * (strip_w + 2 * _even(hd[k])) * 4
                for k in range(g)]
    regions.append((halo - 2 * hd[0] + rs) * strip_w * 4)
    regions.append(rs * (strip_w + 2 * ecar[0]) * 4)
    return STREAM_TABLE_BYTES + sum(-(-n // 16) * 16 for n in regions)


def _stream_step_cost(strip_w: int, g: int, hw: int, offset: int) -> int:
    # a warp's column-pair passes in one step of every scale: the chain's
    # two folds, the power smooth's two, 64 columns a pass
    hd, ec, ecar = stream_margins(g, hw, offset)
    cols = [w for k in range(g) for w in (
        strip_w + 2 * ecar[k], strip_w + 2 * ec[k],
        strip_w + 2 * _even(hd[k]), strip_w)]
    return sum(-(-w // 64) for w in cols)


@functools.lru_cache(maxsize=None)
def stream_plan(B: int, H: int, W: int, g: int, hw: int,
                offset: int) -> Optional[StreamPlan]:
    """The streamed group's launch on an H100 from the shape, group
    depth, half width of the taps and scale offset alone: of the strips
    of :data:`STREAM_STRIPS` columns whose rings fit the
    opt-in shared memory (:func:`stream_smem`) and the bands of
    :data:`STREAM_BANDS` rows or of the frame cut into 1..64 bands
    (rounded up to 8 rows), the pair that takes the fewest steps on the
    busiest SM, counting two blocks an SM where two fit
    (:data:`SMEM_TWO_PER_SM`), each step priced by its column-pair
    passes; ties go to the taller band, then the wider strip.  At 4096²,
    g = 4 (the bfloat16 route's group, float32 rings): 64 columns by
    1024 rows, 256 blocks of 107 KiB, two an SM.  None where no strip
    fits (a dilation whose rings pass 227 KB: the B3spline at ``(5, 2)``
    or ``(7, 1)``)."""
    if g < 1:
        raise ValueError("a group needs at least one scale")
    if g > 8 or offset + g > 20 or (hw << (offset + g - 1)) > 1 << 20:
        return None
    halo = group_halo(hw, offset, g)
    best = None
    for ws in STREAM_STRIPS:
        smem = stream_smem(ws, g, hw, offset)
        if smem > SMEM_OPTIN:
            continue
        slots = H100_SMS * (2 if smem <= SMEM_TWO_PER_SM else 1)
        step = _stream_step_cost(ws, g, hw, offset)
        cuts = {-(-(-(-H // n)) // STREAM_ROWS) * STREAM_ROWS
                for n in range(1, 65)}
        for hb in sorted({min(b, H) for b in (*STREAM_BANDS, *cuts)},
                         reverse=True):
            bands = -(-H // hb)
            if bands > 65535:
                continue
            blocks = -(-W // ws) * bands * B
            steps = -(-(hb + 2 * halo) // STREAM_ROWS)
            cost = -(-blocks // slots) * steps * step
            if best is None or cost < best[0]:
                best = (cost, ws, hb, smem)
    if best is None:
        return None
    _, ws, hb, smem = best
    halo_cols = (-(-stream_margins(g, hw, offset)[2][0] // _STREAM_VEC)
                 * _STREAM_VEC)
    return StreamPlan(ws, hb, halo, halo_cols, smem,
                      (-(-W // ws), -(-H // hb), B))


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


def step_plan(B: int, H: int, W: int, D: int, hw: int) -> StepPlan:
    """The row-buffer pass's launch on the card, from the shape, the true
    dilation and the half width of the taps: whole rows where two rows
    fit the shared memory beside the static tap-row table
    (:data:`STEP_STATIC_SMEM`; ``W ≤ 29038``), else the widest segment of
    :data:`STEP_SEGS` whose buffer fits (at any dilation: past the
    segment the buffer holds the tap windows only); raises where the
    taps' reach (:func:`map_step`) passes 32-bit index math, a side
    reaches 2^30 or a row more than 65535 segments (2^28 columns)."""
    if not 1 <= D < 2 ** 63:
        raise ValueError(f"step_plan: dilation {D} not in 1..2^62")
    if max(H, W) >= 2 ** 30:
        raise ValueError(f"step_plan: a {H}x{W} frame passes 32-bit "
                         "index math (2^30 a side)")
    budget = SMEM_OPTIN - STEP_STATIC_SMEM
    if 8 * W <= budget:
        seg = 0
    else:
        seg = next(s for s in STEP_SEGS if step_smem(W, D, hw, s) <= budget)
    Dr, Dc = map_step(D, H), map_step(D, W)
    if max(H + hw * Dr, W + seg + hw * Dc) >= 2 ** 31:
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
                    32 if frames * H * W < 2 ** 31 else 64)


@dataclass(frozen=True)
class StreamStepPlan:
    """The residue-class stream's launch (kernel A's deep step in bfloat16
    and in halo mode, ``csrc/whiten_step.cu``), passed to its C entries
    as it stands (they lay out its shared memory, check it and launch
    it): whole rows (``seg == 0``) or runs of ``seg`` columns, ``chunk``
    positions of a residue class a work item walks, ``smem_bytes`` per
    block, ``grid`` blocks, each taking the items (frame, run, chunk,
    class) grid-stride, so any batch is one launch."""
    seg: int
    chunk: int
    smem_bytes: int
    grid: int


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def stream_step_smem(W: int, D: int, hw: int, seg: int) -> int:
    """Shared bytes of a stream block, as ``csrc/whiten_step.cu::
    stream_layout`` lays them out, each region on 16 bytes, all float32:
    the carry's ring of ``2hw+2`` rows (rows padded to 16 bytes), the
    chain's rows-fold row and the power smooth's, the detail's ring of
    ``2hw+1`` rows, and the acc row.  A row is ``W`` columns, or for a
    run of ``seg`` columns with ``S = min(Dc, seg)`` its layout: ``4hw·S
    + seg`` for the carry and the chain (its smooth is needed ``2hw·Dc``
    beyond the run), ``2hw·S + seg`` for the detail and the power
    smooth."""
    if seg == 0:
        span_c = span_d = m = W
    else:
        S = min(map_step(D, W), seg)
        span_c, span_d, m = 4 * hw * S + seg, 2 * hw * S + seg, seg
    pitch_c = -(-span_c // 4) * 4
    pitch_d = -(-span_d // 4) * 4
    return (_a16((2 * hw + 2) * pitch_c * 4) + _a16(4 * span_c)
            + _a16(4 * span_d) + _a16((2 * hw + 1) * pitch_d * 4)
            + _a16(m * 4))


def stream_classes(H: int, D: int, halo: bool = False):
    """The stream's residue classes on ``H`` output rows at the true
    dilation ``D`` → ``(Dr, n_cls, P, mirror)``: the rows' dilation
    (``map_step(D, H)``, the true ``D`` in halo mode), the classes a work
    item takes, their most positions, and whether an item walks a class
    and its mirror as one stream.  Where ``Dr`` divides ``H`` (and is
    even, not in halo mode), position ``P + k`` of class ``r`` is row
    ``sym(r + (P + k)·Dr)``, position ``P − 1 − k`` of class ``Dr − 1 −
    r``: the pair is one stream of ``2P`` positions, and the reflected
    warm-up at a class's ends is the mirror's own rows."""
    Dr = D if halo else map_step(D, H)
    mirror = not halo and Dr < H and H % Dr == 0 and Dr % 2 == 0
    if mirror:
        return Dr, Dr // 2, 2 * (H // Dr), True
    return Dr, min(Dr, H), -(-H // Dr), False


def stream_chunk(P: int, per: int, warm: int) -> Tuple[int, int]:
    """The chunk length of a residue-class stream (kernel A's deep step,
    kernel E's bfloat16 pair): ``per`` work items a chunk index, each
    walking ``L`` of a class's ``P`` positions after ``warm`` warm-up
    ticks.  Of ``P``, ``P`` cut into 1..64 chunks and the powers of two
    below ``P``, the length that takes the fewest ticks on the busiest of
    :data:`H100_SMS` SMs, ties to the longer chunk → ``(L, ticks)``."""
    lengths = {P, *(-(-P // n) for n in range(1, 65)),
               *(1 << k for k in range(31) if 1 << k < P)}

    def cost(L):
        return -(-(per * -(-P // L)) // H100_SMS) * (L + warm), -L

    chunk = min(lengths, key=cost)
    return chunk, cost(chunk)[0]


@functools.lru_cache(maxsize=None)
def stream_step_plan(B: int, H: int, W: int, D: int, hw: int,
                     halo: bool = False) -> StreamStepPlan:
    """The stream's launch on an H100 from the shape (``H`` output rows;
    in halo mode a band of ``H`` rows extended by ``2hw·D`` a side), the
    true dilation and the half width of the taps.  Whole rows where their
    rings fit the opt-in
    shared memory (:func:`stream_step_smem`), else the widest run of
    :data:`STREAM_STEP_SEGS` columns that fits.  The rows' dilation is
    ``map_step(D, H)`` (the true ``D`` in halo mode, where nothing
    reflects): ``min(Dr, H)`` residue classes of up to ``P = ⌈H/Dr⌉``
    positions, or pairs of mirror classes (:func:`stream_classes`).  The
    chunk length is the one that takes the fewest ticks
    on the busiest of :data:`H100_SMS` blocks, one block an SM (a chunk
    of ``L`` positions takes ``L + 2hw + 1`` ticks: it warms up on the
    ``2hw`` before it), ties to the longer chunk; the grid is one block an
    SM, or one an item where there are fewer.  Raises where a side
    reaches 2^30 or no run fits."""
    if not 1 <= D < 2 ** 63:
        raise ValueError(f"stream_step_plan: dilation {D} not in 1..2^62")
    rows = H + 4 * hw * D if halo else H
    if max(rows, W) >= 2 ** 30 or min(H, W, B) < 1:
        raise ValueError(f"stream_step_plan: a {rows}x{W} frame passes "
                         "32-bit index math (2^30 a side)")
    seg = 0
    if stream_step_smem(W, D, hw, 0) > SMEM_OPTIN:
        seg = next((s for s in STREAM_STEP_SEGS if s < W and
                    stream_step_smem(W, D, hw, s) <= SMEM_OPTIN), None)
        if seg is None:
            raise ValueError(f"stream_step_plan: no run of a {W}-column row "
                             f"at dilation {D} fits the shared memory")
    _, n_cls, P, _ = stream_classes(H, D, halo)
    per = B * (1 if seg == 0 else -(-W // seg)) * n_cls
    chunk, _ = stream_chunk(P, per, 2 * hw + 1)
    items = per * -(-P // chunk)
    return StreamStepPlan(seg, chunk, stream_step_smem(W, D, hw, seg),
                          min(items, H100_SMS))


#: kernel A's float32 deep step (the row-buffer pass, two launches)
_STEP_ENTRY = "wt_whiten_step_f32"
#: its entries on the residue-class stream: the bfloat16 route's (a
#: float32 carry, the white stored in bfloat16) and halo mode's
_STREAM_ENTRY = "wt_whiten_step_bf16"
_HALO_ENTRY = "wt_whiten_step_halo_f32"
# acc_mode, thr, fac, masked, soft, taps, n_taps
_EPILOGUE_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
# a plan: seg, grid rows, grid segments, frames, shared bytes; index bits
_PLAN_ARGS = [ctypes.c_longlong] * 5 + [ctypes.c_int]


def _lib():
    lib = _build.load(KERNEL)
    fn = getattr(lib, _STEP_ENTRY)
    # carry, c_next, detail, white, acc, the epilogue, B, H, W, D, the plan
    fn.argtypes = ([ctypes.c_void_p] * 5 + _EPILOGUE_ARGS
                   + [ctypes.c_longlong] * 4 + _PLAN_ARGS + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    for entry in (_STREAM_ENTRY, _HALO_ENTRY):
        fn = getattr(lib, entry)
        # carry, c_next, white, acc, the epilogue, B, H, W, D (and halo),
        # then seg, chunk, grid, shared bytes
        n_shape = 5 if entry == _HALO_ENTRY else 4
        fn.argtypes = ([ctypes.c_void_p] * 4 + _EPILOGUE_ARGS
                       + [ctypes.c_longlong] * (n_shape + 4)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


#: the group's entries, the float32 tile and the bfloat16 streamed
#: group, and the number of plan integers after the shape (tile_h or
#: strip_w and band_h, then halo and halo_cols)
_GROUP_ENTRIES = {"wt_whiten_group_f32": 3, "wt_whiten_group_bf16": 4}


def _lib_group():
    lib = _build.load(GROUP_KERNEL)
    for name, n_plan in _GROUP_ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_longlong] * 3 + [ctypes.c_int] * n_plan
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
    """One scale of kernel A's float32 deep step (two launches of the
    row-buffer pass) on ``(B, H, W)`` float32 CUDA tensors; ``detail`` is
    float32 scratch that the caller holds by name until the launches are
    queued.  The launch counter is incremented here and nowhere else."""
    with tracing.launch(KERNEL, scale):
        lib = _lib()
        B, H, W = carry.shape
        plan = step_plan(B, H, W, 1 << scale, sf.half_width)
        taps = (ctypes.c_double * len(sf.taps))(*sf.taps)
        code = getattr(lib, _STEP_ENTRY)(
            _ptr(carry), _ptr(c_next), _ptr(detail), _ptr(white), _ptr(acc),
            int(acc_mode), _ptr(thr), float(fac), int(bool(masked)),
            int(bool(soft)), taps, len(sf.taps), B, H, W, 1 << scale,
            plan.seg, plan.grid[0], plan.grid[1], plan.grid[2],
            plan.smem_bytes, plan.index_bits, _build.stream_ptr(carry.device))
        _build.check(lib, code, "whiten_step")


def launch_whiten_stream(carry, c_next, white, acc, acc_mode, thr, fac,
                         masked, soft, sf, scale, halo: int = 0) -> None:
    """One scale of kernel A's deep step on the residue-class stream (one
    launch, the detail kept on chip) from a float32 carry to a float32
    c_next and acc: the bfloat16 route's step, the white (when written)
    stored in bfloat16; or, ``halo > 0``, a float32 band of ``H + 2·halo``
    rows whose ``H`` interior rows c_next, a float32 white and acc cover.
    ``thr`` float32.  The launch counter (``whiten_step_bf16``, or
    :data:`HALO_KERNEL`) is incremented here and nowhere else."""
    lib = _lib()
    B, H, W = c_next.shape
    white_dtype = torch.float32 if halo else torch.bfloat16
    if (carry.dtype != torch.float32 or c_next.dtype != torch.float32
            or (acc is not None and acc.dtype != torch.float32)
            or (white is not None and white.dtype != white_dtype)):
        raise TypeError("launch_whiten_stream: float32 carry, c_next and "
                        f"acc, a {white_dtype} white")
    if halo:
        entry, counter, shape = (_HALO_ENTRY, HALO_KERNEL,
                                 (B, H, W, 1 << scale, halo))
    else:
        entry, counter, shape = (_STREAM_ENTRY,
                                 _build.counter(KERNEL, white_dtype),
                                 (B, H, W, 1 << scale))
    plan = stream_step_plan(B, H, W, 1 << scale, sf.half_width, bool(halo))
    with tracing.launch(counter, scale):
        taps = (ctypes.c_double * len(sf.taps))(*sf.taps)
        code = getattr(lib, entry)(
            _ptr(carry), _ptr(c_next), _ptr(white), _ptr(acc), int(acc_mode),
            _ptr(thr), float(fac), int(bool(masked)), int(bool(soft)), taps,
            len(sf.taps), *shape, plan.seg, plan.chunk, plan.grid,
            plan.smem_bytes, _build.stream_ptr(carry.device))
        _build.check(lib, code, counter)


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
    thr = tracing.as_tensor(thresholds, dtype=threshold_dtype(x.dtype),
                            device=x.device, site="group.thresholds")
    thr = thr.reshape(g, -1).expand(g, B)
    return batched, xb, factors, masked, thr


def threshold_dtype(dtype):
    """The dtype the kernels and their plain versions take thresholds
    in: float32 for a carry below float32, else the carry's."""
    return torch.float32 if low_precision(dtype) else dtype


def fused_wow_group_plain(x: torch.Tensor, factors: Sequence[float],
                          thresholds, g: int, sf: ScalingFunction,
                          offset: int = 0, soft: bool = True,
                          masked: Tuple[bool, ...] = (),
                          need_cube: bool = True):
    """Plain PyTorch version of :func:`fused_wow_group` (any dtype or
    device).  Below float32 it is the float32 version on the widened
    input (:func:`~.conv.widen`): every pass, the detail, its square, the
    power smooth, the mask and the whitening in float32, the whites
    rounded to the input's dtype on store, the carry and acc left in
    float32.  At float32 and above everything keeps the input's dtype."""
    store = x.dtype
    with tracing.plain(tracing.counter(GROUP_KERNEL, store), offset):
        batched, xb, factors, masked, thr = _group_args(
            widen(x), factors, thresholds, g, masked)
        rows, acc, cur = [], None, xb
        for k in range(g):
            s = offset + k
            c_next = separable_smooth_axis(
                separable_smooth_axis(cur, sf.taps, s, -2, "symmetric"),
                sf.taps, s, -1, "symmetric")
            detail = cur - c_next
            power = separable_smooth_axis(
                separable_smooth_axis(detail * detail, sf.taps, s, -2,
                                      "symmetric"),
                sf.taps, s, -1, "symmetric")
            white, _ = whiten_power_plain(detail, power, factors[k],
                                          thr[k][:, None, None], soft,
                                          masked[k])
            acc = white if acc is None else acc + white
            if need_cube:
                rows.append(white.to(store))
            cur = c_next
        rows.append(cur)
        # its own tensor, as the kernel's acc is, also where g = 1
        acc = acc.clone() if g == 1 else acc
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
    with ``masked[k]``.  The whites are stored in ``x``'s dtype; the carry
    and acc in float32 for a bfloat16 ``x`` (the bfloat16 route: float32
    inside), else in ``x``'s dtype.

    Route, by :func:`group_plan` (shape, ``g``, taps, ``offset`` and
    element size only): where a plan fits, one launch of
    ``csrc/whiten_group.cu`` on a CUDA ``x`` (the float32 tile, or the
    bfloat16 streamed group; :func:`fused_wow_group_plain` on a CPU
    ``x``); where no plan fits (a float32 tile: the B3spline from offset
    2 at g = 3; a streamed group whose rings pass the shared memory: the
    B3spline at ``(5, 2)`` or ``(7, 1)``), one
    :func:`~.hopper_deep.deep_whiten_step` per scale on the widened input
    (kernel A's deep form on a CUDA ``x``, its plain version on a CPU
    ``x``), bitwise the group: the route is float32 inside, so its whites
    round only on store wherever they are made.  A CUDA ``x`` the kernels
    cannot take (float16, float64) raises."""
    from .hopper_deep import deep_whiten_step
    store = x.dtype
    lowp = low_precision(store)
    batched, xb, factors, masked, thr = _group_args(
        x, factors, thresholds, g, masked)
    B, H, W = xb.shape
    plan = group_plan(B, H, W, g, sf.half_width, offset, x.element_size())
    if plan is None:
        rows, acc, cur = [], None, widen(xb)
        if lowp:
            # the whites round on store, so acc sums them unrounded from
            # zero in float32
            acc = torch.zeros(cur.shape, dtype=cur.dtype, device=x.device)
        for k in range(g):
            white, acc, cur = deep_whiten_step(
                cur, acc, thr[k], sf=sf, scale=offset + k,
                weight=factors[k], soft=soft, masked=masked[k],
                write_plane=need_cube or acc is None, white_dtype=store)
            if acc is None:
                # acc starts as scale 0's white, in a tensor of its own
                acc = white.clone() if need_cube else white
            if need_cube:
                rows.append(white)
    elif not x.is_cuda:
        return fused_wow_group_plain(x, factors, thresholds, g, sf, offset,
                                     soft, masked, need_cube)
    else:
        check_kernel_input(x, sf, "fused_wow_group", bf16=True)
        with tracing.launch(tracing.counter(GROUP_KERNEL, store), offset):
            thr = thr.contiguous()
            wide = xb.dtype if not lowp else torch.float32
            acc = torch.empty(xb.shape, dtype=wide, device=x.device)
            cur = torch.empty(xb.shape, dtype=wide, device=x.device)
            rows = ([torch.empty(xb.shape, dtype=store, device=x.device)
                     for _ in range(g)] if need_cube else [])
            lib = _lib_group()
            taps = (ctypes.c_double * len(sf.taps))(*sf.taps)
            # a plan of 4-byte elements is the float32 tile's
            if isinstance(plan, StreamPlan):
                entry, shape = (lib.wt_whiten_group_bf16,
                                (plan.strip_w, plan.band_h))
            else:
                entry, shape = lib.wt_whiten_group_f32, (plan.tile_h,)
            code = entry(
                _ptr(xb),
                (ctypes.c_void_p * g)(*[r.data_ptr() for r in rows])
                if need_cube else None, _ptr(cur), _ptr(acc), _ptr(thr),
                (ctypes.c_float * g)(*factors),
                (ctypes.c_int * g)(*[int(m) for m in masked]),
                int(bool(soft)), g, offset, taps, len(sf.taps), B, H, W,
                *shape, plan.halo, plan.halo_cols, plan.grid[0],
                plan.grid[1], plan.smem_bytes, _build.stream_ptr(x.device))
            _build.check(lib, code, "whiten_group")
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
    with tracing.plain(DECOMPOSE_KERNEL, offset):
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

    with tracing.launch(DECOMPOSE_KERNEL, offset):
        lib = _lib_decompose()
        taps = (ctypes.c_double * len(sf.taps))(*sf.taps)
        code = lib.wt_decompose_group_f32(
            ptrs(0), ptrs(1), ptrs(2), int(level), int(offset), taps,
            len(sf.taps), B, H, W, per_scale(lambda p: p.seg),
            per_scale(lambda p: p.grid[0]), per_scale(lambda p: p.grid[1]),
            plans[0].grid[2], per_scale(lambda p: p.smem_bytes),
            plans[0].index_bits, _build.stream_ptr(x.device))
        _build.check(lib, code, "decompose_group")
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
