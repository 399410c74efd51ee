#!/usr/bin/env python3
"""Where kernels A-G of ``wavelets_tpu_torch`` spend their time, on one NVIDIA GPU: times variants of their current sources,
each with one part changed or cut out, at the main path's shapes.

    python3 scripts/kernel_variants.py [--root DIR] [KERNEL ...]

(``KERNEL``: source names such as ``median_select``; default all.  With
``--root DIR`` the package of another checkout, such as a parent commit
unpacked with ``git archive``, is imported and timed as built, with no
variant: its wrappers take the same arguments.)

Run from the repository root on a machine with a CUDA device and the
CUDA toolkit.  A variant is either a build of the unmodified source with
one ``-DWT_VARIANT_<NAME>`` hook defined (the hooks are listed in the
sources' notes and in ``csrc/wt_tile.cuh``; ``nvcc`` writes them under
the git-ignored ``build/variants/``), or another launch plan of the
production build (a 64-row group tile, a pair cluster of one block).
Either way the port's own wrappers launch it, so the arguments are the
production ones.  Variants that cut a part out compute wrong values and
are only timed.

* kernel E (``whiten_pair.cu``), the pair (7, 8) at 4096²: as built;
  one block a class with no cluster (4-byte accesses D floats apart);
  the wrap by remainder (no compare-and-add); the taps' half width at run
  time (no unrolled tap loop); the load and store phases alone; the
  compute passes alone;
* kernel A's deep step (``whiten_step.cu``), s = 3, 6, 9 at 4096²: as
  built; the taps at run time;
* kernel A's group (``whiten_group.cu``), scales 0-2 at 4096²: as built
  (32-row tile); a 64-row tile; the taps at run time; no whitening
  epilogue; one fold a lane at a time (no four-way overlap);
* the bfloat16 forms (``whiten_group_bf16``, ``whiten_step_bf16``,
  ``whiten_pair_bf16``): the group g = 4 (scales 0-3) at 4096² as
  planned (the streamed group, float32 inside: 64-column strips,
  1024-row bands), with strips of 96 and 64 columns (bands filling one
  wave), no whitening epilogue,
  its bits held against the plain version; the deep step s = 4..9 and
  s = 4 without recon (the residue-class stream, one launch a scale; the
  parent's two launches apart with ``--root``), with one column a thread
  in place of a pair, and with no whitening epilogue; the pair (7, 8) at
  4096² and (4, 5) on 512², three 512² frames and 512×4096 (the
  residue-class stream; a parent that refuses a shape says so), with no
  whitening epilogue, and as the split pair (two launches of the deep
  step with a float32 middle carry);
* kernel A's deep step in halo mode (``whiten_step_halo``, float32), one
  scale each of s = 3..9 on M2's band: the 4096² frame extended by
  ``R = 2hw·2^s`` rows a side, as the sharded engine's band tail on one
  rank takes it, launch by launch; also with no whitening epilogue;
* kernel B (``median_select.cu``), median(|x|) at 4096² and 512²: as
  built, with the device time of each of its four launches;
* kernel F (``bilateral_group.cu``, ``wt_ring.cuh``), a group of 3 at
  4096², offsets 0 and 3: as built; segments of 2048 columns (more
  blocks to an SM); and the instruction counts of its B3spline instance
  (``cuobjdump -sass``);
* kernel C (``decompose_group.cu``), a group of 3 at 4096², offsets 0
  and 3, and the volume path's one-scale ``smooth_only`` pass at
  64×1024²: as built (a row-buffer launch a scale), its bits held
  against the plain version;
* kernel G (``bilateral_step.cu``), one scale each of s = 3..9 at
  4096²: as built, the device time of its two launches apart;
* kernel D (``whiten_plane.cu``), the pieces form (scales 0-2 at 4096²,
  per-frame factors, gamma on) and one deep plane each of s = 3..9 at
  4096² with ``recon +=``: as built (one launch for the pieces, its bits
  held against the check-only first-port reference); the pieces as three
  deep-form launches (set, +=, +=); the pieces in whole rows (two 98 KB
  blocks to an SM against the plan's four of 2048-column segments).  With ``--root`` on a checkout
  whose ``deep_whiten_plane`` has no ``recon``, the deep plane's time
  includes the ``recon.add_`` that its caller ran.

Each wall time is the median of 20 runs after 3 warm-ups (CUDA events
around the wrapper, so the host's launch work is in it); each queued
time that of 20 calls launched back to back between two CUDA events,
per call (the device's time where the host keeps ahead); each device
time the kernels' own time from ``torch.profiler``, per call over 5
calls.  The variants run in two rounds, so the spread shows.  The card's
name and power limit are printed first.
"""

import collections
import contextlib
import ctypes
import dataclasses
import inspect
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

#: name -> (kernel, -DWT_VARIANT_ hooks, launch plan change or None)
VARIANTS = {
    "pair": ("whiten_pair", (), None),
    "pair, no cluster": ("whiten_pair", (), "cluster 1"),
    "pair, wrap by remainder": ("whiten_pair", ("WRAP_REM",), None),
    "pair, taps at run time": ("whiten_pair", ("RUNTIME_TAPS",), None),
    "pair, load and store only": ("whiten_pair", ("NO_COMPUTE",), None),
    "pair, compute only": ("whiten_pair", ("NO_MEMORY",), None),
    "step": ("whiten_step", (), None),
    "step, taps at run time": ("whiten_step", ("RUNTIME_TAPS",), None),
    "group": ("whiten_group", (), None),
    "group, 64-row tile": ("whiten_group", (), "tile 64"),
    "group, taps at run time": ("whiten_group", ("RUNTIME_TAPS",), None),
    "group, no whitening epilogue": ("whiten_group", ("NO_EPILOGUE",),
                                     None),
    "group, one fold a lane": ("whiten_group", ("ONE_FOLD",), None),
    "group bf16": ("whiten_group_bf16", (), None),
    "group bf16, 96-column strips": ("whiten_group_bf16", (), "strip 96"),
    "group bf16, 64-column strips": ("whiten_group_bf16", (), "strip 64"),
    "group bf16, no whitening epilogue": ("whiten_group_bf16",
                                          ("NO_EPILOGUE",), None),
    "step bf16": ("whiten_step_bf16", (), None),
    "step halo": ("whiten_step_halo", (), None),
    "step bf16, one column a thread": ("whiten_step_bf16",
                                       ("STREAM_SCALAR",), None),
    "step bf16, no whitening epilogue": ("whiten_step_bf16",
                                         ("NO_EPILOGUE",), None),
    "step halo, no whitening epilogue": ("whiten_step_halo",
                                         ("NO_EPILOGUE",), None),
    "pair bf16": ("whiten_pair_bf16", (), None),
    "pair bf16, no whitening epilogue": ("whiten_pair_bf16",
                                         ("NO_EPILOGUE",), None),
    "pair bf16, k = 8 on two 256-thread blocks an SM": (
        "whiten_pair_bf16", (), "k 8"),
    "pair bf16 split": ("whiten_pair_bf16", (), "split"),
    "median": ("median_select", (), None),
    "bilateral group": ("bilateral_group", (), None),
    "bilateral group, 2048-column segments": ("bilateral_group", (),
                                              "seg 2048"),
    "decompose group": ("decompose_group", (), None),
    "bilateral step": ("bilateral_step", (), None),
    "whiten plane": ("whiten_plane", (), None),
    "whiten plane, pieces as three deep-form launches": (
        "whiten_plane", (), "three launches"),
    "whiten plane, pieces in whole rows": ("whiten_plane", (),
                                           "pieces whole rows"),
}
#: kernels whose device time is printed launch by launch
PARTS = {"median_select", "decompose_group", "bilateral_step",
         "whiten_plane", "whiten_step_bf16", "whiten_step_halo"}


def source(kernel):
    """The source (and library) of a kernel: a bfloat16 form and the
    halo mode are built from the float32 kernel's source."""
    return kernel.removesuffix("_bf16").removesuffix("_halo")


def build_variants(_build, kernels):
    """One ``nvcc`` per variant with hooks of ``kernels``, all at once;
    name → CDLL."""
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (kernel, hooks, _)) in enumerate(VARIANTS.items()):
        if not hooks or kernel not in kernels:
            continue
        so = out_dir / f"v{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
               *(f"-DWT_VARIANT_{h}" for h in hooks), "-o", str(so),
               str(_build.CSRC_DIR / f"{source(kernel)}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.wt_error_string.argtypes = [ctypes.c_int]
        lib.wt_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def sass_counts(_build, so, function):
    """Instructions of each function of ``so`` whose name holds
    ``function``, from ``cuobjdump -sass`` (beside ``nvcc``): the total
    and those of a few opcodes (MUFU: the special-function pipe)."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(so)],
                         capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if function not in name:
                name = None
            else:
                counts[name] = collections.Counter()
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            op = line.split("*/")[1].split()
            op = op[1] if op and op[0].startswith("@") else (op[0] if op
                                                              else "")
            c = counts[name]
            c["all"] += 1
            for key in ("MUFU", "BRA", "FSEL", "SEL", "LDS", "FMUL", "FADD",
                        "FFMA"):
                if op.split(".")[0] == key:
                    c[key] += 1
    return counts


@contextlib.contextmanager
def replaced(module, attr, value):
    old = getattr(module, attr)
    setattr(module, attr, value)
    try:
        yield
    finally:
        setattr(module, attr, old)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device")
    args = sys.argv[1:]
    root = ROOT
    if args[:1] == ["--root"]:
        root = Path(args[1]).resolve()
        args = args[2:]
        for name in [n for n, (_, hooks, plan) in VARIANTS.items()
                     if hooks or plan]:
            del VARIANTS[name]
    sys.path.insert(0, str(root))
    from wavelets_tpu_torch.ops import (_build, hopper_bilateral,
                                        hopper_conv, hopper_deep,
                                        hopper_stats, hopper_wow)
    from wavelets_tpu_torch.ops.filters import B3SPLINE

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(f"package: {root / 'wavelets_tpu_torch'}")
    kernels = set(args) or {k for k, _, _ in VARIANTS.values()}
    libs = build_variants(_build, kernels)
    if "whiten_pair_bf16" in kernels and hasattr(_build, "BUILD_LOG"):
        # what the compiler made of the bfloat16 pair's stream (B3spline,
        # pairs of points, the whole column circle)
        for fn, c in sass_counts(_build, _build._build("whiten_pair"),
                                 "pair_stream").items():
            if "ILi2ELi2ELb1EE" in fn:
                print(f"  SASS {fn}: {dict(c)}")
    if "bilateral_group" in kernels:
        # what the compiler made of the ring kernel (B3spline, 32-bit)
        for fn, c in sass_counts(_build, _build._build("bilateral_group"),
                                 "bilateral_ring").items():
            if "ILi2EiLb0EE" in fn:
                print(f"  SASS {fn}: {dict(c)}")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def timed(fn, n=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(n):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        queued = a.elapsed_time(b) / n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in kern) / 5e3
        parts = {e.key.replace("(anonymous namespace)::", "")
                 .split("(")[0][:24]: e.self_device_time_total / 5e3
                 for e in kern}
        return float(np.median(ms)), queued, dev_ms, parts

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 4096, 4096)).astype(np.float32)
                         * 3 + 10).to(dev)
    recon = torch.zeros_like(x)
    thr2 = torch.full((2, 1), 0.5, device=dev)
    thr3 = torch.tensor([1.0, 1.0, 0.0], device=dev)
    zero1 = torch.zeros(1, device=dev)
    group_plan, pair_plan = hopper_conv.group_plan, hopper_deep.pair_plan

    def tile(th):
        def plan(*a):
            p = group_plan(*a)
            return dataclasses.replace(
                p, tile_h=th, grid=(p.grid[0], -(-a[1] // th), p.grid[2]),
                smem_bytes=hopper_conv._group_smem(th, p.halo, p.halo_cols))
        return plan

    stream_plan = getattr(hopper_conv, "stream_plan", None)

    def strip(ws):
        # a strip of ws columns, the band that fills one wave
        def plan(B, H, W, g, hw, off, itemsize=2):
            smem = hopper_conv.stream_smem(ws, g, hw, off)
            slots = hopper_conv.H100_SMS * (
                2 if smem <= hopper_conv.SMEM_TWO_PER_SM else 1)
            bands = max(1, slots // (-(-W // ws) * B))
            hb = -(-(-(-H // bands)) // 8) * 8
            return dataclasses.replace(
                stream_plan(B, H, W, g, hw, off), strip_w=ws,
                band_h=hb, grid=(-(-W // ws), -(-H // hb), B),
                smem_bytes=smem)
        return plan

    pair_stream_plan = getattr(hopper_deep, "pair_stream_plan", None)
    deep_step = hopper_deep.deep_whiten_step

    def two_steps(carry, recon, thr, *, sf, scale, weights, masked,
                  **kw):
        # the pair as two steps of kernel A, the middle carry float32
        w1, _, mid = deep_step(carry, recon, thr[0], sf=sf, scale=scale,
                               weight=weights[0], masked=masked[0], **kw)
        w2, _, c = deep_step(mid, recon, thr[1], sf=sf, scale=scale + 1,
                             weight=weights[1], masked=masked[1], **kw)
        return w1, w2, recon, c

    def pair_group(k):
        # the bfloat16 pair's stream on groups of k classes, two points a
        # thread, the whole column circle, the plan's chunk search
        def plan(B, H, W, D, hw):
            p = pair_stream_plan(B, H, W, D, hw)
            classes = max(1, D // 2)
            kk, M, N = min(k, classes), H // D, W // D
            if kk < 2 or 2 * N * kk > 2 * 512:
                return p
            threads = max(64, -(-2 * N * kk // 2 // 64) * 64)
            smem = hopper_deep.pair_stream_smem(kk, 2 * N, hw, True)
            per = B * classes * (classes // kk)
            chunk, _ = hopper_conv.stream_chunk(2 * M, per, 8 * hw + 2)
            per_sm = min(hopper_deep.SM_SMEM // (smem + 1024),
                         512 // threads)
            items = per * -(-2 * M // chunk)
            return dataclasses.replace(
                p, k=kk, run=0, chunk=chunk, threads=threads,
                smem_bytes=smem, grid=min(items, 132 * per_sm))
        return plan

    bil_plan = hopper_bilateral.bilateral_plan

    def seg2048(B, H, W, D, hw):
        p = bil_plan(B, H, W, D, hw)
        seg = min(2048, W)
        return dataclasses.replace(
            p, seg=seg, grid=(p.grid[0], -(-W // seg), B),
            smem_bytes=hopper_bilateral.ring_smem(hw, D, seg))

    def three_launches(pieces, factors, thresholds, sf, n, layout,
                       write_planes=True, write_gamma=False, **_):
        # the pieces form as n deep-form launches: set, then +=
        B, H, W = pieces[0].shape[1:]
        planes = torch.empty((n, B, H, W), device=dev)
        recon = torch.empty((B, H, W), device=dev)
        gamma = torch.empty_like(recon)
        for s in range(n):
            k, r = layout[s]
            mode = 1 if s == 0 else 2
            hopper_wow.launch_whiten_plane(
                pieces[k][r], planes[s] if write_planes else None, recon,
                mode, gamma, mode if write_gamma else 0, factors[s],
                thresholds[s], True, sf, s)
        return planes, recon, gamma

    pieces_plan = getattr(hopper_wow, "pieces_plan", None)

    def pieces_whole(B, H, W, n, hw, rows=1):
        p = pieces_plan(B, H, W, n, hw, rows)
        return dataclasses.replace(p, seg=0, grid=(H, 1, p.grid[2]),
                                   smem_bytes=8 * n * W)

    plans = {
        "three launches": (hopper_wow, "fused_whiten_pieces",
                           three_launches),
        "pieces whole rows": (hopper_wow, "pieces_plan", pieces_whole),
        "seg 2048": (hopper_bilateral, "bilateral_plan", seg2048),
        "tile 64": (hopper_conv, "group_plan", tile(64)),
        "strip 96": (hopper_conv, "group_plan", strip(96)),
        "strip 64": (hopper_conv, "group_plan", strip(64)),
        "cluster 1": (hopper_deep, "pair_plan", lambda *a: dataclasses
                      .replace(pair_plan(*a), cluster=1)),
        "k 8": (hopper_deep, "pair_stream_plan", pair_group(8)),
        "split": (hopper_deep, "deep_whiten_step2", two_steps),
    }

    x512 = torch.from_numpy(rng.normal(size=(512, 512)).astype(np.float32)
                            ).to(dev)
    xb = torch.from_numpy(rng.normal(size=(4096, 4096)).astype(np.float32)
                          * 3).to(dev)

    xv = torch.from_numpy(rng.normal(size=(64, 1024, 1024))
                          .astype(np.float32) * 3 + 10).to(dev)

    # kernel D: scales 0-2 of a decomposition, per-frame factors as
    # preserve_variance's, the thresholds of denoise [5, 2]
    cube = hopper_conv.fused_group_plain(x[0], 3, B3SPLINE)[:, None]
    fac3 = torch.stack([w * torch.sqrt(torch.mean(cube[s] ** 2))
                        for s, w in enumerate((1.0, 2.0, 0.5))])[:, None]
    thr3d = torch.tensor([[1.0], [0.5], [0.0]], device=dev)
    pieces_args = ((cube,), fac3, thr3d, B3SPLINE, 3,
                   ((0, 0), (0, 1), (0, 2)))
    has_recon = "recon" in inspect.signature(
        hopper_deep.deep_whiten_plane).parameters

    def deep_plane(s):
        kw = dict(sf=B3SPLINE, scale=s, weight=fac3[0], masked=True)
        if has_recon:
            return hopper_deep.deep_whiten_plane(x, thr3d[1], recon=recon,
                                                 **kw)
        return recon.add_(hopper_deep.deep_whiten_plane(x, thr3d[1], **kw))

    xh = x.to(torch.bfloat16)
    # the bfloat16 route's steps and pair: float32 carries and recon
    # (the frame's values), bfloat16 whites
    xf = xh.float()
    bf = dict(white_dtype=torch.bfloat16)
    thr4 = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev)

    def runs(kernel):
        if kernel == "whiten_group_bf16":
            yield "scales 0-3", lambda: hopper_conv.fused_wow_group(
                xh[0], [1.0] * 4, thr4, 4, B3SPLINE,
                masked=(True, True, True, False))
        elif kernel == "whiten_step_bf16":
            rh = torch.zeros_like(xf)
            for s in range(4, 10):
                yield f"s={s}", lambda s=s: hopper_deep.deep_whiten_step(
                    xf, rh, zero1, sf=B3SPLINE, scale=s, weight=1.0, **bf)
            yield "s=4, no recon", lambda: hopper_deep.deep_whiten_step(
                xf, None, zero1, sf=B3SPLINE, scale=4, weight=1.0, **bf)
        elif kernel == "whiten_step_halo":
            from wavelets_tpu_torch.ops.conv import boundary_index
            for s in range(3, 10):
                R = 2 * B3SPLINE.half_width << s
                ext = x.index_select(1, boundary_index(
                    4096, -R, "symmetric", dev, 4096 + 2 * R)).contiguous()
                yield f"s={s}", lambda s=s, ext=ext, R=R: (
                    hopper_deep.deep_whiten_step(
                        ext, recon, zero1, sf=B3SPLINE, scale=s, weight=1.0,
                        halo=R))
        elif kernel == "whiten_pair_bf16":
            rh = torch.zeros_like(xf)
            yield "(7, 8)", lambda: hopper_deep.deep_whiten_step2(
                xf, rh, thr2, sf=B3SPLINE, scale=7, weights=(1.0, 1.0),
                masked=(True, False), **bf)
            for b, h, w in ((1, 512, 512), (3, 512, 512), (1, 512, 4096)):
                xs = xf[:, :h * b, :w].reshape(b, h, w).contiguous()
                rs = torch.zeros_like(xs)
                ts = thr2.expand(2, b).contiguous()
                yield f"{b}x{h}x{w} (4, 5)", lambda xs=xs, rs=rs, ts=ts: (
                    hopper_deep.deep_whiten_step2(
                        xs, rs, ts, sf=B3SPLINE, scale=4, weights=(1.0, 1.0),
                        masked=(True, False), **bf))
        elif kernel == "whiten_plane":
            yield "pieces 0-2", lambda: hopper_wow.fused_whiten_pieces(
                *pieces_args, write_gamma=True)
            for s in range(3, 10):
                yield f"plane s={s}", lambda s=s: deep_plane(s)
        elif kernel == "decompose_group":
            for off in (0, 3):
                yield f"g=3 offset {off}", lambda off=off: (
                    hopper_conv.fused_group(x[0], 3, B3SPLINE, off))
            yield "volume pass", lambda: hopper_conv.fused_group(
                xv, 1, B3SPLINE, 0, smooth_only=True)
        elif kernel == "bilateral_step":
            for s in range(3, 10):
                yield f"s={s}", lambda s=s: (
                    hopper_deep.deep_bilateral_whiten_step(
                        xb[None], zero1, sf=B3SPLINE, scale=s,
                        var_factor=1.0, weight=1.0, recon=recon))
        elif kernel == "median_select":
            yield "4096²", lambda: hopper_stats.median_abs(x[0])
            yield "512²", lambda: hopper_stats.median_abs(x512)
        elif kernel == "bilateral_group":
            for off in (0, 3):
                yield f"offset {off}", lambda off=off: (
                    hopper_bilateral.fused_bilateral_group(
                        xb, 3, B3SPLINE, (1.0,) * 3, off))
        elif kernel == "whiten_pair":
            yield "(7, 8)", lambda: hopper_deep.deep_whiten_step2(
                x, recon, thr2, sf=B3SPLINE, scale=7, weights=(1.0, 1.0),
                masked=(True, False))
        elif kernel == "whiten_step":
            for s in (3, 6, 9):
                yield f"s={s}", lambda s=s: hopper_deep.deep_whiten_step(
                    x, recon, zero1, sf=B3SPLINE, scale=s, weight=1.0)
        else:
            yield "scales 0-2", lambda: hopper_conv.fused_wow_group(
                x[0], [1.0] * 3, thr3, 3, B3SPLINE,
                masked=(True, True, False))

    load = _build.load
    print(f"ms at 4096², two rounds, on {card}: wall (median of 20) and "
          "device (profiler)")
    for rnd in range(2):
        for name, (kernel, _, plan) in VARIANTS.items():
            if kernel not in kernels:
                continue
            lib = libs.get(name)
            with contextlib.ExitStack() as stack:
                if lib is not None:
                    stack.enter_context(replaced(
                        _build, "load", lambda n, k=source(kernel), lib=lib:
                        lib if n == k else load(n)))
                if plan is not None:
                    stack.enter_context(replaced(*plans[plan]))
                for what, fn in runs(kernel):
                    try:
                        wall, queued, dev_ms, parts = timed(fn)
                    except ValueError as err:  # a shape a parent refuses
                        print(f"  round {rnd}: {name:32s} {what:14s} "
                              f"not taken ({err})")
                        continue
                    print(f"  round {rnd}: {name:32s} {what:14s} "
                          f"wall {wall:.3f} queued {queued:.3f} "
                          f"device {dev_ms:.3f}")
                    if kernel in PARTS:
                        print("      " + ", ".join(
                            f"{k} {v:.4f}" for k, v in parts.items()))
                    if kernel == "decompose_group" and rnd == 0:
                        off, g, so = ((0, 1, True) if what == "volume pass"
                                      else (int(what[-1]), 3, False))
                        src = xv if so else x[0]
                        same = torch.equal(fn(), hopper_conv
                                           .fused_group_plain(
                                               src, g, B3SPLINE, off, so))
                        print(f"      bitwise to the plain version: {same}")
                    if kernel == "whiten_group_bf16" and rnd == 0:
                        rows, acc = fn()
                        rp, ap = hopper_conv.fused_wow_group_plain(
                            xh[0], [1.0] * 4, thr4, 4, B3SPLINE,
                            masked=(True, True, True, False))
                        same = all(torch.equal(a, b) for a, b in
                                   zip((*rows, acc), (*rp, ap)))
                        print(f"      bitwise to the plain version: {same}")
                    if (kernel == "whiten_plane" and rnd == 0
                            and what.startswith("pieces")
                            and hasattr(hopper_wow,
                                        "fused_whiten_pieces_ref")):
                        ref = hopper_wow.fused_whiten_pieces_ref(
                            *pieces_args, write_gamma=True)
                        same = all(torch.equal(a, b)
                                   for a, b in zip(fn(), ref))
                        print("      bitwise to the first-port reference: "
                              f"{same}")
            sys.stdout.flush()


if __name__ == "__main__":
    main()
