#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100 / sm_90a).

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and the
CUDA toolkit.  It

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. builds the hand-written kernels from ``wavelets_tpu_torch/csrc`` into
   ``build/kernels`` (one ``nvcc`` per source, all at once) and prints the
   build seconds;
3. holds each kernel against its plain PyTorch version on the card at the
   paths' shapes: kernel A's deep step (4096² at s ∈ {0, 3, 6, 9}, masked
   soft, hard and unmasked, plus 1000×1536 and 257×513, where s = 9
   reflects more than once) and its group (scales 0-2 at the same shapes,
   also offset 1 at 257×513, ``need_cube`` on and off, one launch each),
   carries bitwise, kernel B (even and odd n, heavy ties, and at 4096² and
   512² all equal, zeros, subnormals, ties straddling a bin of each digit,
   patterns off a 16-byte boundary; bitwise, and bitwise to
   ``np.median``), kernel C (groups at 4096², 1000×1536, 257×513, a
   batch of 3, 5×40000 (rows in segments) and a dilation past the map's
   period, and the volume's one-scale pass at 64×1024², ``smooth_only``
   on and off; bitwise, inputs unchanged), kernel D (the pieces form,
   scales 0-2 in one launch, at 4096², a batch of 3 and 2×3×40000 (rows
   in segments), soft, hard and unmasked, whites and gamma on and off,
   per-frame factors computed on the card; the deep-plane form at s =
   3..9 on 4096², 8 on 257×513, 5 and 9 on a batch and 13 on 2×3×40000,
   with white, ``recon +=`` and gamma, or ``recon +=`` alone; bitwise to
   the first-port design, the check-only reference entry, inputs
   unchanged; and the batch-major layout of a frame stack's plane cube,
   4×4096² into rows 0-2 of a (4, 7, H, W) cube, bitwise to the
   scale-major form permuted and to the reference entry, rows 3-6 left
   as a sentinel) and kernel E (the pairs
   (7, 8) at 4096² and (4, 5) at 512² against two plain steps, carry
   bitwise, and against two kernel A steps, bitwise), kernel F
   (bilateral groups at 4096², 1000×1536 and 257×513, offsets 0, 3 and
   6, σ scalar and a list, scaling on and off, and a mean of 1000; and
   bitwise to the same scales run through kernel G's earlier three-pass
   chain, the check-only reference entry, at offsets 0-6, a width that
   needs row segments and a mean of 1000) and kernel G (deep bilateral
   scales 3, 6, 8, 9 at 4096², 8 at 257×513, 9 on a batch of 3 and 13 at
   2×3×40000, masked soft, hard, unmasked and with bilateral scaling;
   c_next, white and recon bitwise to the reference entry, the earlier
   five launches);
4. drives every ported path with the launch counters reset just before
   and read just after — the main path (``wow`` 4096² auto 10 scales and
   512² L6, denoise [5, 2], lazy noise), P1 ``AtrousTransform()(x, 6)``,
   P2 ``denoise`` of 4096² frames and of a 64×1024×1024 volume, P3
   ``wow`` with the gamma blend, with ``preserve_variance`` and from
   ``AtrousTransform()(x, 10)``, and the bilateral paths B1 (``wow``
   4096² auto 10 scales, ``bilateral=1``, known noise; B1-lazy with lazy
   noise and ``bilateral_scaling``), B2 ``AtrousTransform(bilateral=1)(x,
   6)``, B3 ``denoise(x, [3, 3, 3], bilateral=1)`` and B4 ``wow`` of
   ``AtrousTransform(bilateral=1)(x, 10)``, the frame-stack cells of the
   JAX rows ``wow_stack_4x4k_*`` — S1 ``wow_stack`` 4×4096² L6, denoise
   [5, 2], noise 1.0, serving (the merged route), S2 the same with lazy
   noise (the pieces route, kernel B once a frame), S3 bilateral=1 with
   lazy noise on a zero-mean stack, S4 S1 with the planes (kernel D's
   batch-major cube) — S5 ``process_stack`` of 10 uint16 frames of
   4096² from a file in batches of 4 (bitwise to ``wow_stack`` over the
   same batches) and S6 ``wow`` of a 64×1024² volume — then R1-R4
   ``richardson_lucy`` (the JAX rows ``richardson_lucy_1k_10it_direct``
   and ``_fft``, 4096² auto, ``richardson_lucy_stack2_1k_10it_auto``
   with each frame against a single-frame call, and 1024² hard,
   ``uniform_init``, not persistent), E1 ``enhance`` of 3×4096² channels
   and E2 of one 4096² frame, T1 ``AtrousTransform()(x, 6,
   recursive=True)`` at 4096² (its interior bitwise to the standard
   transform), T2 ``convolution`` at s = 0..3, N1
   ``B3spline(2).compute_noise_weights(6, n_trials=100)`` against the
   σ_e table and C1 ``python -m wavelets_tpu_torch rl`` on 4 uint16
   frames of 1024² (bitwise to ``richardson_lucy`` per frame) — and
   requires that each expected kernel launched (for B1-B4, S1-S6, R1-R4,
   E1-E2, T1 and N1 exactly the expected counts), that no plain version
   ran, that the outputs are finite, on the card, and agree with
   ``fuse=False`` on the same tensors and with the float64 CPU path on a
   small input, and that each frame of S1-S4 agrees with single-frame
   ``wow`` of that frame (bitwise where both take the same route); S2 is
   also run on the merged body forced, for its time; RL's direct path
   (``F.conv2d`` with TF32 off) is held against the float32 shift-add,
   and timed against it and against the FFT path (PSFs 3×3 to 15×15 at
   1024² and 4096², 10 iterations), beside cuFFT's first-call plan
   time;
5. times each path, kernels against plain, and each kernel against its
   plain version and, where one exists, one PyTorch call computing the
   same function, with CUDA events (median of 20 runs after warm-up),
   beside the kernel's bound: the larger of its bytes (each input read
   once, each output written once) over 3.35 TB/s and its float32
   operations over 67 TFLOP/s, the H100 SXM's published peaks
   (``wavelets_tpu_torch/utils/profiling.py``; an ``expf`` counted as
   ``EXPF_OPS`` instructions); kernel B at 4096²
   and 512² (and the device kernels of one call, profiled: at most 4),
   kernels C and F per group at offsets 0 and 3, kernel C's one-scale
   volume pass at 64×1024², kernel D's pieces form (scales 0-2; at
   4×4096² batch-major against scale-major) and its deep plane per scale
   s = 3..9, each beside the first-port reference entry, kernel G per
   scale s = 3..9; frames/s of S1-S6;
6. traces each path's kernel route with ``torch.profiler`` over 5 runs:
   device-busy ms per run, the idle share against the CUDA-event time,
   and the kernels that take the most device time.

The bfloat16 slice adds: the bfloat16 forms of kernel A (the streamed
group, g = 3 and 4 at offsets 0-2, the B3spline and the Triangle, at
4096², 1000×1536, 257×513, 300×1020, 16², a batch of 3 and one of 4 at
4096², the groups of the wide frames 512×4096, 1024×14080 and
256×25600, ``need_cube`` on
and off, soft, hard and unmasked; deep step s = 4..9 at 4096², an odd
shape and a batch) and of kernel E's residue-class stream ((7, 8) at
4096², (4, 5) at 512², a batch, 512×4096), each bitwise to its bfloat16 plain version, inputs unchanged,
the measured max abs error of the 4096² checks in the ``kernels`` line;
the paths ``wow_4k_L6_bf16_known_noise`` and ``wow_4k_L10_bf16``, with
exact bfloat16 launch counts and no float32 kernel, and on the plain
route (no launch) a bfloat16 S1 (``wow_stack`` 4×4096² L6 serving, a
plain frame at a time as the JAX ``wow_stack`` runs it), float16
``wow`` 4096² L10 and bfloat16 ``richardson_lucy`` 1024² direct
(no launch; ``fft=True`` raises), each recon within 2e-2·max of the
float32 kernels on the same zero-mean frame, a 512² crop within 2^-8 of
the same route on the CPU, and timed against ``fuse=False`` and the
float32 kernels; the three bfloat16 kernels timed at 4096² beside their
2-byte bounds, and the streamed group's computed issue floor on a line
of its own (not measured).

The sharded slice adds: kernel A's deep step in halo mode (the sharded
engine's band tail), 4096² on a batch of 3 and 257×513 split into 4 row
bands, each extended as the engine extends them (s = 9 at 4096² needs a
gathered window), s = 3..9, soft, hard and unmasked, every output bitwise
to its plain version and the bands concatenated bitwise to the
single-frame deep step; the bfloat16 pair with a float32 middle carry
(two launches of kernel A's bfloat16 step, where kernel E's gate
refuses the shape) bitwise to ``deep_whiten_step2_plain``; and the paths M1-M4 of
``wavelets_tpu_torch.parallel`` on a one-rank NCCL group set up in this
process — M1 ``sharded_wow_1chip_4k_L6_serving`` (stage 1, bitwise to
``wow_stack``), M2 ``sharded_wow`` of one 4096² frame, L10, denoise [5, 2],
lazy noise (stage 2: kernel A's group on the reflected block, the band
tail on the halo step, the bisection median; held to ``wow``), M3
``sharded_decompose`` 4096² L6 (held to ``AtrousTransform``) and M4
``process_stack(mesh=)`` on S5's file (bitwise to S5's output) — each
with its launches and its collectives (``count_collectives``).  A mesh
of more ranks cannot run on one card: NCCL refuses two ranks on one
device and gloo has no CUDA send or receive, so the 4-rank checks are
the gloo tests on the CPU (tests/test_torch_parallel.py).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero before that line.  It imports nothing of JAX.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: whitened planes / acc / recon: erff against torch.erf (a last-place
#: difference in the mask), the standard of the JAX package's kernels
WHITE_RTOL = 5e-6
N_TIMED = 20
N_WARM = 3


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def device_kernel(event):
    """A profiler event that ran on the card (a kernel, copy or memset),
    not a wrapper's ``wt.`` span, which the profiler draws there too as a
    ``gpu_user_annotation``."""
    from torch.autograd import DeviceType
    return (event.device_type == DeviceType.CUDA
            and not event.key.startswith("wt."))


def max_err(got, ref):
    return float((got.double() - ref.double()).abs().max())


def check_white(got, ref, what, scale=None):
    if scale is None:
        scale = float(ref.abs().max())
    err = max_err(got, ref)
    require(err <= WHITE_RTOL * max(scale, 1.0),
            f"{what}: max abs err {err} > {WHITE_RTOL} * {scale}")
    return err


def check_bitwise(got, ref, what):
    import torch
    require(got.shape == ref.shape and bool(torch.equal(got, ref)),
            f"{what}: not bitwise equal (max abs err {max_err(got, ref)})")


def timed(fn, torch, n=N_TIMED):
    """Median milliseconds of ``fn`` over ``n`` runs, CUDA events."""
    for _ in range(N_WARM):
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
    return float(np.median(ms))


class Phase:
    """Prints a phase's seconds when it ends."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"---- {self.name}")
        sys.stdout.flush()

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"     {self.name}: {time.perf_counter() - self.t0:.1f} s")
            sys.stdout.flush()


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only "
                         "on a GPU and never continues on the CPU")
    require((ROOT / "wavelets_tpu_torch" / "csrc").is_dir(),
            f"the port's sources are not beside this script in {ROOT}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    sys.stdout.flush()

    sys.path.insert(0, str(ROOT))
    import wavelets_tpu_torch as wt
    # the H100's peaks and the kernels' operation counts (one owner)
    from wavelets_tpu_torch.utils.profiling import (
        BIL_OPS, BIL_TAPS, BIL_WHITEN_OPS, EXPF_OPS, FOLD_OPS, PEAK_F32_INSTR,
        PEAK_SFU, WHITEN_SCALE_OPS, bound_ms, group_bytes, halo_step_bytes,
        halo_step_ops, pair_bytes, step_bytes)
    from wavelets_tpu_torch.core.transform import decompose, decompose_pieces
    from wavelets_tpu_torch.models.wow import (_wow_body_fused,
                                               _wow_body_merged)
    from wavelets_tpu_torch.ops import (_build, hopper_bilateral,
                                        hopper_conv, hopper_deep,
                                        hopper_stats, hopper_wow)
    from wavelets_tpu_torch.ops.filters import B3SPLINE, TRIANGLE

    require("jax" not in sys.modules, "the port imported jax")

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s for {sorted(libs)} into {_build.BUILD_DIR}")
    for name, (secs, log) in sorted(_build.BUILD_LOG.items()):
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {name}: nvcc {secs:.2f} s; " + " | ".join(regs))

    rng = np.random.default_rng(0)
    sig = B3SPLINE.sigma_e(2)
    plane_bytes = 4096 * 4096 * 4

    def frame(shape, b=None, mean=10.0, gen=None):
        size = shape if b is None else (b,) + shape
        x = (gen or rng).normal(size=size).astype(np.float32) * 3 + mean
        return torch.from_numpy(x).to(dev)

    def bil_frame(shape, b=None):
        # zero mean: the range weights exp(-d²/2V) amplify float32
        # round-off of the local variance, which cancels on a large mean
        # (the float64 comparison would read conditioning, not the port)
        return frame(shape, b, mean=0.0)

    # ---- 3a. kernel A against its plain version ------------------------
    errs_a = {"white": 0.0, "carry": 0.0}
    errs_grp = {"white": 0.0, "carry": 0.0}
    with Phase("kernel A checks"):
        n_checks = n_group = 0
        thr3 = torch.tensor([9.0 * float(sig[k]) for k in range(3)],
                            device=dev)
        for shape, scales in [((4096, 4096), (0, 3, 6, 9)),
                              ((1000, 1536), (0, 3, 6, 9)),
                              ((257, 513), (0, 3, 6, 9))]:
            x = frame(shape, b=1)
            recon = frame(shape, b=1)
            # the deep form: two launches per scale
            for s in scales:
                thr = torch.tensor([3.0 * 3.0 * float(sig[s])], device=dev)
                for mode in ("soft", "hard", "unmasked"):
                    kw = dict(sf=B3SPLINE, scale=s, weight=1.5,
                              soft=mode == "soft", masked=mode != "unmasked")
                    r_k, r_p = recon.clone(), recon.clone()
                    w_k, _, c_k = hopper_deep.deep_whiten_step(x, r_k, thr,
                                                               **kw)
                    w_p, _, c_p = hopper_deep.deep_whiten_step_plain(
                        x, r_p, thr, **kw)
                    torch.cuda.synchronize()
                    what = f"kernel A step {shape} s={s} {mode}"
                    e_w = check_white(w_k, w_p, what)
                    check_white(r_k, r_p, what + " recon")
                    check_bitwise(c_k, c_p, what + " carry")
                    if shape == (4096, 4096):
                        errs_a["white"] = max(errs_a["white"], e_w)
                        errs_a["carry"] = max(errs_a["carry"],
                                              max_err(c_k, c_p))
                    n_checks += 1
            # the group form: one launch for scales offset .. offset+2
            offsets = (0, 1) if shape == (257, 513) else (0,)
            for offset in offsets:
                for need_cube in (True, False):
                    args = ([1.0, 2.0, 0.5], thr3, 3, B3SPLINE)
                    kw = dict(offset=offset, soft=True,
                              masked=(True, True, False), need_cube=need_cube)
                    n0 = _build.LAUNCHES["whiten_group"]
                    rows_k, acc_k = hopper_conv.fused_wow_group(x[0], *args,
                                                                **kw)
                    rows_p, acc_p = hopper_conv.fused_wow_group_plain(
                        x[0], *args, **kw)
                    torch.cuda.synchronize()
                    what = (f"kernel A group {shape} offset={offset} "
                            f"need_cube={need_cube}")
                    require(_build.LAUNCHES["whiten_group"] == n0 + 1,
                            what + ": not one launch")
                    require(len(rows_k) == len(rows_p), what + " row count")
                    for a, b in zip(rows_k[:-1], rows_p[:-1]):
                        e = check_white(a, b, what + " plane")
                        if shape == (4096, 4096):
                            errs_grp["white"] = max(errs_grp["white"], e)
                    check_bitwise(rows_k[-1], rows_p[-1], what + " carry")
                    if shape == (4096, 4096):
                        errs_grp["carry"] = max(
                            errs_grp["carry"], max_err(rows_k[-1], rows_p[-1]))
                    check_white(acc_k, acc_p, what + " acc")
                    n_group += 1
            del x, recon
        print(f"kernel A: {n_checks} deep-step and {n_group} group checks "
              f"passed, carries bitwise; 4096² max abs err white: step "
              f"{errs_a['white']:.3e}, group {errs_grp['white']:.3e}")

    # ---- 3b. kernel B: bitwise ------------------------------------------
    with Phase("kernel B checks"):
        cases_b = {
            "4096² even n": rng.normal(size=4096 * 4096),
            "999×1001 odd n": rng.normal(size=999 * 1001),
            "4096² heavy ties": rng.choice([-2.0, 0.0, 1.0, 2.5],
                                           size=4096 * 4096),
        }
        err_b = 0.0
        for what, host in cases_b.items():
            host = host.astype(np.float32)
            xt = torch.from_numpy(host).to(dev)
            got = hopper_stats.median_abs(xt)
            plain = hopper_stats.median_abs(xt,
                                            hopper_stats.median_bits2_plain)
            want = np.median(np.abs(host))
            got_h, plain_h = got.cpu().numpy(), plain.cpu().numpy()
            require(got_h.tobytes() == plain_h.tobytes() == want.tobytes(),
                    f"kernel B {what}: {got_h!r} plain {plain_h!r} "
                    f"np.median {want!r}")
            err_b = max(err_b, abs(float(got_h) - float(want)))
            print(f"kernel B {what}: {float(got_h)!r} bitwise == plain == "
                  "np.median")
        # the adversarial cases: ties past the candidate cap (the later
        # digits read the plane), the middle pair in two bins of each
        # digit, and patterns off a 16-byte boundary (the scalar head)
        n_adv = 0
        for side in (4096, 512):
            n = side * side
            i = np.arange(n + 3)
            adv = {
                "all equal": np.full(n + 3, -1.75),
                "zeros": np.where(rng.random(n + 3) < 0.5, 0.0, -0.0),
                "subnormals": rng.integers(-2 ** 23, 2 ** 23, n + 3)
                * 2.0 ** -149,
                "straddle digit 1": np.where(i < (n + 3) // 2, 0.5, -3.0),
                "straddle digit 2": np.where(i < (n + 3) // 2, 1.0,
                                             1.0 + 2.0 ** -12),
                "straddle digit 3": np.where(
                    i < (n + 3) // 2, 1.0,
                    float(np.nextafter(np.float32(1), np.float32(2)))),
            }
            for what, host in adv.items():
                host = host.astype(np.float32)
                xt = torch.from_numpy(host).to(dev)
                for head in (0, 3):
                    got = hopper_stats.median_abs(xt[head:head + n])
                    want = np.median(np.abs(host[head:head + n]))
                    got_h = got.cpu().numpy()
                    require(got_h.tobytes() == want.tobytes(),
                            f"kernel B {side}² {what} head {head}: "
                            f"{got_h!r} np.median {want!r}")
                    n_adv += 1
        print(f"kernel B: {n_adv} adversarial cases at 4096² and 512² "
              "bitwise to np.median")

    # ---- 3c. kernel C: bitwise ------------------------------------------
    err_c = 0.0
    with Phase("kernel C checks"):
        n_c = 0
        # a batch, W not a multiple of 4, rows in segments (contiguous
        # halo, then tap windows past 4096 columns), a dilation past the
        # map's period, and the volume's in-plane pass (batch = depth)
        for shape, groups in [((4096, 4096), ((3, 0), (3, 3))),
                              ((1000, 1536), ((3, 0), (3, 6))),
                              ((257, 513), ((3, 0), (3, 3), (3, 6), (2, 40))),
                              ((3, 257, 513), ((3, 0), (3, 3))),
                              ((5, 40000), ((3, 0), (3, 11))),
                              ((64, 1024, 1024), ((1, 0), (1, 1), (1, 2)))]:
            x = frame(shape)
            x0 = x.clone()
            for g, off in groups:
                for smooth_only in (False, True):
                    got = hopper_conv.fused_group(x, g, B3SPLINE, off,
                                                  smooth_only)
                    want = hopper_conv.fused_group_plain(x, g, B3SPLINE, off,
                                                         smooth_only)
                    torch.cuda.synchronize()
                    check_bitwise(got, want, f"kernel C {shape} g={g} "
                                  f"offset={off} smooth_only={smooth_only}")
                    if shape == (4096, 4096):
                        err_c = max(err_c, max_err(got, want))
                    n_c += 1
                    del got, want
            check_bitwise(x, x0, f"kernel C {shape}: its input")
            del x, x0
        print(f"kernel C: {n_c} checks passed, details and carry bitwise, "
              "inputs unchanged")

    # ---- 3d. kernel D ---------------------------------------------------
    err_d = 0.0
    with Phase("kernel D checks"):
        n_d = 0

        def check_d(got, ref, plain, what, scale=None):
            """Bitwise to the first-port reference entry, within 5e-6·max
            of the plain version; returns the max abs error."""
            e = 0.0
            for k, (a, r, p) in enumerate(zip(got, ref, plain)):
                require((a is None) == (r is None) == (p is None),
                        f"{what}: output {k} present in one version only")
                if a is not None:
                    check_bitwise(a, r, f"{what} output {k} vs reference")
                    e = max(e, check_white(a, p, f"{what} output {k}",
                                           scale))
            return e

        # the pieces form: scales 0-2 of a decomposition at 4096² (and a
        # batch, and rows in segments), preserve_variance's factors
        # computed on the card, gamma and the whites on and off
        for shape in ((4096, 4096), (3, 96, 1000), (2, 3, 40000)):
            x = frame(shape)
            cube = hopper_conv.fused_group(x, 3, B3SPLINE)
            cube = cube if x.ndim == 3 else cube[:, None]
            cube0 = cube.clone()
            pieces = (cube[:1], cube[1:])
            layout = ((0, 0), (1, 0), (1, 1))
            B = cube.shape[1]
            fac = torch.stack([w * torch.sqrt(torch.mean(
                cube[s] ** 2, dim=(-2, -1))) for s, w in
                enumerate((1.0, 2.0, 0.5))])
            for mode in ("soft", "hard", "unmasked"):
                t = (0.0 if mode == "unmasked" else 1.0)
                thr = torch.tensor([[t * 9.0 * float(sig[k])] * B
                                    for k in range(3)], device=dev)
                for planes_on, gamma_on in ((True, True), (False, False),
                                            (True, False), (False, True)):
                    if shape != (4096, 4096) and not planes_on:
                        continue
                    args = (pieces, fac, thr, B3SPLINE, 3, layout)
                    kw = dict(soft=mode != "hard", write_planes=planes_on,
                              write_gamma=gamma_on)
                    got = hopper_wow.fused_whiten_pieces(*args, **kw)
                    ref = hopper_wow.fused_whiten_pieces_ref(*args, **kw)
                    plain = hopper_wow.fused_whiten_pieces_plain(*args, **kw)
                    torch.cuda.synchronize()
                    what = (f"kernel D pieces {shape} {mode} planes "
                            f"{planes_on} gamma {gamma_on}")
                    scale = float(plain[1].abs().max())
                    e = check_d(got, ref, plain, what, scale)
                    if shape == (4096, 4096):
                        err_d = max(err_d, e)
                    n_d += 1
                    del got, ref, plain
            check_bitwise(cube, cube0, f"kernel D pieces {shape}: input")
            del x, cube, cube0, pieces

        # the deep-plane form: s = 3..9 at 4096² (soft, hard, unmasked in
        # turn), with white, recon += and gamma +=, or recon += alone
        # (write_plane=False); 257×513 at s = 8, a batch, rows in segments
        # of tap windows at s = 13
        for shape, scales in (((4096, 4096), range(3, 10)),
                              ((257, 513), (8,)), ((3, 96, 1000), (5, 9)),
                              ((2, 3, 40000), (13,))):
            x = frame(shape, b=None if len(shape) == 3 else 1)
            x0 = x.clone()
            B = x.shape[0]
            recon, gamma = frame(x.shape), frame(x.shape)
            fac = torch.sqrt(torch.mean(x ** 2, dim=(-2, -1))) * 0.5
            for s in scales:
                thr = torch.full((B,), 2.0 * float(sig[min(s, 9)]),
                                 device=dev)
                for k, mode in enumerate(("soft", "hard", "unmasked")):
                    if shape == (4096, 4096) and k != s % 3:
                        continue
                    for outputs in ("all", "recon"):
                        kw = dict(sf=B3SPLINE, scale=s, weight=fac,
                                  soft=mode == "soft",
                                  masked=mode != "unmasked",
                                  write_plane=outputs == "all")
                        rs = [recon.clone() for _ in range(3)]
                        gs = ([gamma.clone() for _ in range(3)]
                              if outputs == "all" else [None] * 3)
                        w_k = hopper_deep.deep_whiten_plane(
                            x, thr, recon=rs[0], gamma=gs[0], **kw)
                        w_r = hopper_deep.deep_whiten_plane_ref(
                            x, thr, recon=rs[1], gamma=gs[1], **kw)
                        w_p = hopper_deep.deep_whiten_plane_plain(
                            x, thr, recon=rs[2], gamma=gs[2], **kw)
                        torch.cuda.synchronize()
                        what = f"kernel D plane {shape} s={s} {mode} {outputs}"
                        e = check_d((w_k, rs[0], gs[0]), (w_r, rs[1], gs[1]),
                                    (w_p, rs[2], gs[2]), what)
                        if shape == (4096, 4096):
                            err_d = max(err_d, e)
                        n_d += 1
                        del rs, gs, w_k, w_r, w_p
            check_bitwise(x, x0, f"kernel D plane {shape}: input")
            del x, x0, recon, gamma
        print(f"kernel D: {n_d} checks passed, bitwise to the first-port "
              f"reference; vs plain 4096² max abs err {err_d:.3e}")

    # ---- 3d'. kernel D's batch-major pieces form -------------------------
    with Phase("kernel D batch-major pieces 4×4096²"):
        # the frame stack's plane cube (B, 7, H, W): rows 0-2 written in
        # place, bitwise to the scale-major form permuted and to the
        # first-port reference; rows 3-6 stay the caller's (a sentinel)
        x = frame((4096, 4096), b=4)
        cube = hopper_conv.fused_group(x, 3, B3SPLINE)
        pieces, layout = (cube[:1], cube[1:]), ((0, 0), (1, 0), (1, 1))
        fac = torch.stack([w * torch.sqrt(torch.mean(
            cube[s] ** 2, dim=(-2, -1))) for s, w in
            enumerate((1.0, 2.0, 0.5))])
        sentinel = -1234.5
        n_bm = 0
        err_bm = 0.0
        for mode in ("soft", "hard"):
            thr = torch.stack([torch.arange(1, 5, device=dev) * 2.0
                               * float(sig[k]) for k in range(3)])
            args = (pieces, fac, thr, B3SPLINE, 3, layout)
            kw = dict(soft=mode == "soft", write_gamma=True)
            out = torch.full((4, 7, 4096, 4096), sentinel, device=dev)
            got = hopper_wow.fused_whiten_pieces(
                *args, batch_major=True, out_rows_total=7, out=out, **kw)
            ref = hopper_wow.fused_whiten_pieces_ref(
                *args, batch_major=True, out_rows_total=7, **kw)
            sm = hopper_wow.fused_whiten_pieces(*args, **kw)
            plain = hopper_wow.fused_whiten_pieces_plain(
                *args, batch_major=True, out_rows_total=7, **kw)
            torch.cuda.synchronize()
            what = f"kernel D batch-major 4×4096² {mode}"
            require(got[0].data_ptr() == out.data_ptr()
                    and got[0].shape == (4, 7, 4096, 4096),
                    what + ": not written into the given cube")
            check_bitwise(got[0][:, :3], sm[0].permute(1, 0, 2, 3),
                          what + " vs scale-major permuted")
            check_bitwise(got[0][:, :3], ref[0][:, :3],
                          what + " vs reference")
            for k in (1, 2):
                check_bitwise(got[k], sm[k], f"{what} output {k} vs "
                              "scale-major")
                check_bitwise(got[k], ref[k], f"{what} output {k} vs "
                              "reference")
            require(bool((got[0][:, 3:] == sentinel).all()),
                    what + ": rows 3-6 were written")
            scale = float(plain[1].abs().max())
            err_bm = max(err_bm, check_white(got[0][:, :3], plain[0][:, :3],
                                             what, scale),
                         check_white(got[1], plain[1], what + " recon"))
            n_bm += 1
            del out, got, ref, sm, plain
        del x, cube, pieces
        print(f"kernel D batch-major: {n_bm} checks, bitwise to the "
              "scale-major form permuted and to the reference, rows 3-6 "
              f"untouched; vs plain max abs err {err_bm:.3e}")

    # ---- 3e. kernel E ---------------------------------------------------
    err_e = {"white": 0.0, "carry": 0.0}
    with Phase("kernel E checks"):
        for shape, s in (((4096, 4096), 7), ((512, 512), 4)):
            x = frame(shape, b=1)
            recon = frame(shape, b=1)
            thr = torch.tensor([[3.0 * float(sig[s])],
                                [2.0 * float(sig[s + 1])]], device=dev)
            require(hopper_deep.can_deep2(x, B3SPLINE, s),
                    f"kernel E gate refuses {shape} s={s}")
            for masked in ((True, True), (False, True), (False, False)):
                kw = dict(sf=B3SPLINE, scale=s, weights=(1.5, 0.5),
                          soft=True, masked=masked)
                r_k, r_p, r_a = recon.clone(), recon.clone(), recon.clone()
                w1, w2, _, c_k = hopper_deep.deep_whiten_step2(x, r_k, thr,
                                                               **kw)
                p1, p2, _, c_p = hopper_deep.deep_whiten_step2_plain(
                    x, r_p, thr, **kw)
                a1, _, mid = hopper_deep.deep_whiten_step(
                    x, r_a, thr[0], sf=B3SPLINE, scale=s, weight=1.5,
                    masked=masked[0])
                a2, _, c_a = hopper_deep.deep_whiten_step(
                    mid, r_a, thr[1], sf=B3SPLINE, scale=s + 1, weight=0.5,
                    masked=masked[1])
                torch.cuda.synchronize()
                what = f"kernel E {shape} ({s}, {s + 1}) masked={masked}"
                check_bitwise(c_k, c_p, what + " carry vs plain")
                check_bitwise(c_k, c_a, what + " carry vs kernel A")
                check_bitwise(w1, a1, what + " white_s vs kernel A")
                check_bitwise(w2, a2, what + " white_s+1 vs kernel A")
                check_bitwise(r_k, r_a, what + " recon vs kernel A")
                e = max(check_white(w1, p1, what), check_white(w2, p2, what),
                        check_white(r_k, r_p, what + " recon"))
                err_e["white"] = max(err_e["white"], e)
                err_e["carry"] = max(err_e["carry"], max_err(c_k, c_p))
        print(f"kernel E: carry bitwise to two plain steps, everything "
              f"bitwise to two kernel A steps; whites vs plain max abs err "
              f"{err_e['white']:.3e}")

    # ---- 3f. kernel F ---------------------------------------------------
    err_f = 0.0
    with Phase("kernel F checks"):
        n_f = 0
        for shape, offsets in [((4096, 4096), (0, 3)),
                               ((1000, 1536), (0, 3)),
                               ((257, 513), (0, 3, 6))]:
            x = bil_frame(shape)
            for off in offsets:
                for sig2, scaling in (((1.0,) * 3, False),
                                      ((2.25, 1.0, 0.25), True),
                                      ((2.25, 1.0, 0.25), False),
                                      ((1.0,) * 3, True)):
                    got = hopper_bilateral.fused_bilateral_group(
                        x, 3, B3SPLINE, sig2, off, scaling)
                    want = hopper_bilateral.fused_bilateral_group_plain(
                        x, 3, B3SPLINE, sig2, off, scaling)
                    torch.cuda.synchronize()
                    e = check_white(got, want, f"kernel F {shape} offset="
                                    f"{off} σ²={sig2} scaling={scaling}")
                    if shape == (4096, 4096):
                        err_f = max(err_f, e)
                    n_f += 1
            del x
        for shape in ((4096, 4096), (257, 513)):
            # m2 - mean·mean cancels at a mean of 1000
            x = frame(shape, mean=1000.0)
            got = hopper_bilateral.fused_bilateral_group(x, 3, B3SPLINE,
                                                         (1.0,) * 3)
            want = hopper_bilateral.fused_bilateral_group_plain(
                x, 3, B3SPLINE, (1.0,) * 3)
            torch.cuda.synchronize()
            e = check_white(got, want, f"kernel F {shape} mean 1000")
            print(f"kernel F {shape} mean 1000: max abs err {e:.3e}")
            n_f += 1
            del x
        print(f"kernel F: {n_f} checks passed; 4096² max abs err "
              f"{err_f:.3e}")

        def g_chain(x, sig2, offset, scaling):
            # the same scales through kernel G's earlier three passes (the
            # check-only reference entry)
            cur, rows = x[None], []
            for k, var in enumerate(sig2):
                _, c_next = hopper_deep.deep_bilateral_whiten_step_ref(
                    cur, torch.zeros(1, device=dev), sf=B3SPLINE,
                    scale=offset + k, var_factor=var, weight=1.0,
                    bilateral_scaling=scaling)
                rows.append(cur - c_next)
                cur = c_next
            rows.append(cur)
            return torch.stack(rows)[:, 0]

        n_fg = 0
        for shape, offsets, mean in [((4096, 4096), (0, 3), 0.0),
                                     ((257, 513), range(7), 0.0),
                                     ((6, 9000), (0, 5), 0.0),
                                     ((4096, 4096), (0,), 1000.0)]:
            x = frame(shape, mean=mean)
            for off in offsets:
                sig2, scaling = (2.25, 1.0, 0.25), off % 2 == 1
                got = hopper_bilateral.fused_bilateral_group(
                    x, 3, B3SPLINE, sig2, off, scaling)
                want = g_chain(x, sig2, off, scaling)
                torch.cuda.synchronize()
                check_bitwise(got, want, f"kernel F {shape} offset={off} "
                              f"mean {mean} vs kernel G's reference chain")
                n_fg += 1
            del x
        print(f"kernel F: {n_fg} groups bitwise to kernel G's reference "
              "chain (details and carry)")

    # ---- 3g. kernel G ---------------------------------------------------
    err_g = {"white": 0.0, "carry": 0.0}
    with Phase("kernel G checks"):
        n_g = 0
        # against the plain version, and bitwise against the earlier five
        # per-pixel launches (the check-only reference entry); a batch and
        # rows in segments of tap windows too
        for shape, scales in [((4096, 4096), (3, 6, 8, 9)),
                              ((257, 513), (8,)), ((3, 96, 1000), (9,)),
                              ((2, 3, 40000), (13,))]:
            x = bil_frame(shape[-2:], b=shape[0] if len(shape) == 3 else 1)
            recon = bil_frame(shape[-2:], b=x.shape[0])
            for s in scales:
                thr = torch.full((x.shape[0],), 3.0 * float(sig[min(s, 9)]),
                                 device=dev)
                for mode in ("soft", "hard", "unmasked", "scaling"):
                    kw = dict(sf=B3SPLINE, scale=s, var_factor=2.25,
                              weight=1.5, soft=mode != "hard",
                              masked=mode in ("soft", "hard"),
                              bilateral_scaling=mode == "scaling")
                    r_k, r_p, r_r = recon.clone(), recon.clone(), recon.clone()
                    w_k, c_k = hopper_deep.deep_bilateral_whiten_step(
                        x, thr, recon=r_k, **kw)
                    w_r, c_r = hopper_deep.deep_bilateral_whiten_step_ref(
                        x, thr, recon=r_r, **kw)
                    w_p, c_p = hopper_deep.deep_bilateral_whiten_step_plain(
                        x, thr, recon=r_p, **kw)
                    torch.cuda.synchronize()
                    what = f"kernel G {shape} s={s} {mode}"
                    check_bitwise(c_k, c_r, what + " carry vs reference")
                    check_bitwise(w_k, w_r, what + " white vs reference")
                    check_bitwise(r_k, r_r, what + " recon vs reference")
                    e_c = check_white(c_k, c_p, what + " carry")
                    e_w = check_white(w_k, w_p, what)
                    check_white(r_k, r_p, what + " recon")
                    if shape == (4096, 4096):
                        err_g["white"] = max(err_g["white"], e_w)
                        err_g["carry"] = max(err_g["carry"], e_c)
                    n_g += 1
            del x, recon
        print(f"kernel G: {n_g} checks passed, c_next, white and recon "
              "bitwise to the five-launch reference; vs plain 4096² max abs "
              f"err white {err_g['white']:.3e} carry {err_g['carry']:.3e}")

    # ---- 3h. the bfloat16 forms of kernels A and E: bitwise -------------
    def bf16_frame(shape, b=None, mean=10.0, gen=None):
        return frame(shape, b, mean, gen).to(torch.bfloat16)

    with Phase("bfloat16 kernel checks"):
        n_lp = {"whiten_group_bf16": 0, "whiten_step_bf16": 0,
                "whiten_pair_bf16": 0}
        # measured max abs error against the plain version, over every
        # output of the 4096² checks (the group at g = 3 and 4, a frame
        # and a batch of 4; the steps s = 4..9; the pair (7, 8))
        err_lp = dict.fromkeys(n_lp, 0.0)

        def check_lp(name, got, ref, what, shape):
            check_bitwise(got, ref, what)
            if shape == (4096, 4096):
                err_lp[name] = max(err_lp[name], max_err(got, ref))
        thr4 = torch.tensor([9.0 * float(sig[k]) for k in range(4)],
                            device=dev)

        def counted(name, fn):
            n0 = _build.LAUNCHES[name]
            out = fn()
            require(_build.LAUNCHES[name] == n0 + 1,
                    f"{name}: not one launch")
            n_lp[name] += 1
            return out

        # A's group (the streamed design): g = 3 and 4 (the merged route's)
        # at offsets 0-2, the B3spline and the Triangle, need_cube on and
        # off, soft, hard and unmasked; a batch of 3 and one of 4 at 4096²;
        # a frame smaller than the halo (16²); widths off 8 columns (513,
        # 1020); the groups of ROADMAP C1's wide frames: (0, 4) of 512×4096
        # L8 and 1024×14080, (0, 4) and (4, 1) of 256×25600 (its (5, 2) and
        # (7, 1) have no plan: the documented plain rule).  The shapes
        # after the first five take frames of their own generator, so every
        # later phase draws the same frames from rng as before they came
        b3, tri = B3SPLINE, TRIANGLE
        own = np.random.default_rng(12)
        group_cases = (
            ((4096, 4096), None, ((3, 0, b3), (4, 0, b3), (4, 1, b3),
                                  (3, 2, b3), (4, 0, tri))),
            ((1000, 1536), None, ((3, 0, b3), (4, 0, b3))),
            ((257, 513), None, ((3, 0, b3), (4, 0, b3), (4, 1, tri),
                                (3, 2, b3))),
            ((512, 512), 3, ((3, 0, b3), (4, 0, b3))),
            ((4096, 4096), 4, ((3, 0, b3), (4, 0, b3))),
            ((16, 16), None, ((4, 0, b3), (4, 1, tri))),
            ((300, 1020), None, ((4, 0, b3),)),
            ((512, 4096), None, ((4, 0, b3),)),
            ((1024, 14080), None, ((4, 0, b3),)),
            ((256, 25600), None, ((4, 0, b3), (1, 4, b3))))
        for i, (shape, b, groups) in enumerate(group_cases):
            x = bf16_frame(shape, b, gen=own if i >= 5 else None)
            x0 = x.clone()
            for g, off, sf in groups:
                for need_cube in (True, False):
                    for mode in ("soft", "hard", "unmasked"):
                        args = ([1.0, 2.0, 0.5, 1.5][:g], thr4[:g], g, sf)
                        kw = dict(offset=off, soft=mode == "soft",
                                  need_cube=need_cube,
                                  masked=(mode != "unmasked",) * (g - 1)
                                  + (False,))
                        rows_k, acc_k = counted(
                            "whiten_group_bf16",
                            lambda: hopper_conv.fused_wow_group(
                                x, *args, **kw))
                        rows_p, acc_p = hopper_conv.fused_wow_group_plain(
                            x, *args, **kw)
                        torch.cuda.synchronize()
                        what = (f"bf16 group {shape} b={b} g={g} "
                                f"offset={off} hw={sf.half_width} {mode} "
                                f"need_cube={need_cube}")
                        require(len(rows_k) == len(rows_p), what + " rows")
                        for a, r in zip(rows_k, rows_p):
                            check_lp("whiten_group_bf16", a, r, what, shape)
                        check_lp("whiten_group_bf16", acc_k, acc_p,
                                 what + " acc", shape)
            check_bitwise(x, x0, f"bf16 group {shape}: input changed")
            del x, x0
        # A's deep step, s = 4..9 at 4096², an odd shape, a batch of 3
        # (the bfloat16 route's step: a float32 carry and recon, the white
        # stored in bfloat16)
        for shape, b, scales in (((4096, 4096), 1, range(4, 10)),
                                 ((257, 513), 1, (4, 6)),
                                 ((512, 512), 3, (4, 5))):
            x = bf16_frame(shape, b).float()
            x0 = x.clone()
            recon = bf16_frame(shape, b, mean=0.0).float()
            thr = torch.full((b,), 0.9, device=dev)
            for s_ in scales:
                for mode in ("soft", "hard", "unmasked"):
                    kw = dict(sf=B3SPLINE, scale=s_, weight=1.5,
                              soft=mode == "soft", masked=mode != "unmasked",
                              white_dtype=torch.bfloat16)
                    r_k, r_p = recon.clone(), recon.clone()
                    w_k, _, c_k = counted(
                        "whiten_step_bf16",
                        lambda: hopper_deep.deep_whiten_step(x, r_k, thr,
                                                             **kw))
                    w_p, _, c_p = hopper_deep.deep_whiten_step_plain(
                        x, r_p, thr, **kw)
                    torch.cuda.synchronize()
                    what = f"bf16 step {shape} b={b} s={s_} {mode}"
                    for a, r in ((w_k, w_p), (c_k, c_p), (r_k, r_p)):
                        check_lp("whiten_step_bf16", a, r, what, shape)
            check_bitwise(x, x0, f"bf16 step {shape}: input changed")
        # kernel E at (7, 8) on 4096², (4, 5) on 512², a batch of 3, and
        # on C1's 512×4096 (the stream takes it; the gate, kernel E's
        # float32 tori's, leaves it to the split on the route)
        for shape, b, s_ in (((4096, 4096), 1, 7), ((512, 512), 1, 4),
                             ((512, 512), 3, 4), ((512, 4096), 1, 4)):
            x = bf16_frame(shape, b).float()
            x0 = x.clone()
            for with_recon in (True, False):
                recon = (bf16_frame(shape, b, mean=0.0).float() if with_recon
                         else None)
                r_k = recon.clone() if with_recon else None
                r_p = recon.clone() if with_recon else None
                kw = dict(sf=B3SPLINE, scale=s_, weights=(1.5, 0.5),
                          soft=True, masked=(True, False),
                          white_dtype=torch.bfloat16)
                thr2 = torch.full((2, b), 0.9, device=dev)
                out_k = counted("whiten_pair_bf16",
                                lambda: hopper_deep.deep_whiten_step2(
                                    x, r_k, thr2, **kw))
                out_p = hopper_deep.deep_whiten_step2_plain(x, r_p, thr2,
                                                            **kw)
                torch.cuda.synchronize()
                what = f"bf16 pair {shape} b={b} s={s_} recon={with_recon}"
                for a, r in zip(out_k, out_p):
                    if a is not None:
                        check_lp("whiten_pair_bf16", a, r, what, shape)
            check_bitwise(x, x0, f"bf16 pair {shape}: input changed")
        del x, x0, recon
        print(f"bfloat16 kernels: {n_lp} checks, every output bitwise to "
              "the plain version (float32 inside, the whites rounded), "
              "inputs unchanged; measured max "
              f"abs err at 4096² {err_lp}")

    # ---- 3i. kernel A's deep step in halo mode: bitwise -----------------
    # the sharded engine's band tail: a frame split into 4 row bands, each
    # extended as the engine extends it (a neighbour's rows, the border's
    # reflection, past a band a window of the gathered plane through the
    # symmetric map: s = 9 at 4096²), held bitwise to the plain version,
    # and the bands concatenated bitwise to the single-frame step
    from wavelets_tpu_torch.ops.conv import boundary_index
    err_halo = {"white": 0.0, "carry": 0.0}
    with Phase("kernel A halo-mode checks"):
        n_halo = 0
        for shape, b in (((4096, 4096), 3), ((257, 513), 1)):
            H = shape[0]
            x = frame(shape, b=b)
            recon = frame(shape, b=b, mean=0.0)
            x0 = x.clone()
            thr = torch.full((b,), 9.0 * float(sig[5]), device=dev)
            for s_ in range(3, 10):
                R = 2 * B3SPLINE.half_width << s_
                for mode in ("soft", "hard", "unmasked"):
                    kw = dict(sf=B3SPLINE, scale=s_, weight=1.5,
                              soft=mode == "soft",
                              masked=mode != "unmasked")
                    r_1 = recon.clone()
                    w_1, _, c_1 = hopper_deep.deep_whiten_step(x, r_1, thr,
                                                               **kw)
                    hb = -(-H // 4)
                    parts = []
                    for k in range(4):
                        lo, hi = k * hb, min(H, (k + 1) * hb)
                        ext = x.index_select(1, boundary_index(
                            H, lo - R, "symmetric", dev,
                            hi - lo + 2 * R)).contiguous()
                        r_k = recon[:, lo:hi].contiguous()
                        r_p = r_k.clone()
                        n0 = _build.LAUNCHES["whiten_step_halo"]
                        out_k = hopper_deep.deep_whiten_step(
                            ext, r_k, thr, halo=R, **kw)
                        out_p = hopper_deep.deep_whiten_step_plain(
                            ext, r_p, thr, halo=R, **kw)
                        torch.cuda.synchronize()
                        what = (f"halo step {shape} b={b} s={s_} {mode} "
                                f"band {k}")
                        require(_build.LAUNCHES["whiten_step_halo"] == n0 + 1,
                                what + ": not one launch")
                        for a, r_, nm in zip(out_k, out_p,
                                             ("white", "recon", "carry")):
                            check_bitwise(a, r_, f"{what} {nm}")
                            if H == 4096 and nm != "recon":
                                err_halo[nm] = max(err_halo[nm],
                                                   max_err(a, r_))
                        parts.append(out_k)
                        n_halo += 1
                    what = f"halo bands {shape} s={s_} {mode}"
                    for j, ref in enumerate((w_1, r_1, c_1)):
                        check_bitwise(torch.cat([p_[j] for p_ in parts], 1),
                                      ref, f"{what} vs the frame's step")
            check_bitwise(x, x0, f"halo step {shape}: input changed")
            del x, x0, recon, parts, ext
        print(f"kernel A halo mode: {n_halo} band checks bitwise to the "
              "plain version, the bands concatenated bitwise to the "
              "single-frame step (s = 3..9, 4096² b=3 and 257×513)")

    # ---- 3j. the bfloat16 pair as two steps (C1) -------------------------
    def bf16_two_steps(x, acc, thr2, *, sf, scale, weights, masked, **kw):
        w1, _, mid = hopper_deep.deep_whiten_step(
            x, acc, thr2[0], sf=sf, scale=scale, weight=weights[0],
            masked=masked[0], **kw)
        w2, _, c = hopper_deep.deep_whiten_step(
            mid, acc, thr2[1], sf=sf, scale=scale + 1, weight=weights[1],
            masked=masked[1], **kw)
        return w1, w2, acc, c

    with Phase("bfloat16 split pair checks"):
        n_split = 0
        for shape, b, s_ in (((512, 4096), 1, 4), ((1024, 8192), 1, 5),
                             ((512, 4096), 3, 4), ((4096, 4096), 1, 7)):
            x = bf16_frame(shape, b, mean=0.0).float()
            acc = bf16_frame(shape, b, mean=0.0).float()
            x0 = x.clone()
            for masked in ((True, False), (False, True)):
                kw = dict(sf=B3SPLINE, scale=s_, weights=(1.25, 0.75),
                          masked=masked, white_dtype=torch.bfloat16)
                thr2 = torch.full((2, b), 0.9, device=dev)
                a_k, a_p = acc.clone(), acc.clone()
                n0 = _build.LAUNCHES["whiten_step_bf16"]
                out_k = bf16_two_steps(x, a_k, thr2, **kw)
                out_p = hopper_deep.deep_whiten_step2_plain(x, a_p, thr2,
                                                            **kw)
                torch.cuda.synchronize()
                what = f"split pair {shape} b={b} s={s_} masked={masked}"
                require(_build.LAUNCHES["whiten_step_bf16"] == n0 + 2,
                        what + ": not two launches")
                for a, r_ in zip(out_k, out_p):
                    check_bitwise(a, r_, what)
                n_split += 1
            check_bitwise(x, x0, f"split pair {shape}: input changed")
        del x, x0, acc
        print(f"bfloat16 split pair: {n_split} checks bitwise to "
              "deep_whiten_step2_plain (the route's pair where kernel "
              "E's gate refuses: (4, 5) on 512×4096, (5, 6) on "
              "1024×8192)")

    # ---- 4. the paths ----------------------------------------------------
    launches = {}

    def drive(what, fn, expect):
        """Run ``fn`` with the counters reset just before and read just
        after; every kernel in ``expect`` must launch (exactly as often
        as a dict ``expect`` says, and no other) and no plain version may
        run."""
        torch.cuda.synchronize()
        _build.reset_counters()
        out = fn()
        torch.cuda.synchronize()
        run_launches = dict(_build.LAUNCHES)
        run_plain = dict(_build.PLAIN_CALLS)
        for name, n in run_launches.items():
            launches[name] = launches.get(name, 0) + n
        print(f"{what}: launches {run_launches} plain calls {run_plain}")
        for name in expect:
            require(run_launches.get(name, 0) >= 1,
                    f"{what}: kernel {name} did not launch")
        if isinstance(expect, dict):
            require(run_launches == expect,
                    f"{what}: launches {run_launches}, expected {expect}")
        require(not run_plain, f"{what}: plain versions ran: {run_plain}")
        return out, run_launches

    def on_card(t, what, shape=None, dtype=torch.float32):
        require(t.is_cuda and t.dtype == dtype, f"{what}: not on the card")
        require(shape is None or tuple(t.shape) == tuple(shape),
                f"{what}: shape {tuple(t.shape)}")
        require(bool(torch.isfinite(t).all()), f"{what}: not finite")

    def check_wow(what, recon, coeffs, r_p, c_p, n_planes):
        require(len(coeffs) == n_planes, f"{what}: plane count")
        on_card(recon, what + " recon")
        for k in range(len(coeffs)):
            on_card(coeffs[k], f"{what} plane {k}")
        scale = float(r_p.abs().max())
        e_r = check_white(recon, r_p, what + " recon vs fuse=False")
        e_p = max(check_white(coeffs[k], c_p[k], f"{what} plane {k}",
                              max(scale, float(c_p[k].abs().max())))
                  for k in range(len(coeffs)))
        print(f"  vs fuse=False on the card: recon max abs err {e_r:.3e}, "
              f"planes {e_p:.3e} (scale {scale:.4g})")

    def small_vs_cpu(what, run, shape=(256, 256), mean=10.0):
        """``run(x, **device)`` on a small float32 input on the card
        against the float64 CPU path; returns the max abs error."""
        small = rng.normal(size=shape) * 3 + mean
        got = run(torch.from_numpy(small.astype(np.float32)).to(dev))
        ref = run(small, device="cpu")
        scale = float(ref.abs().max())
        err = check_white(got.cpu(), ref, f"{what} vs float64 CPU", scale)
        print(f"  {shape} on the card vs the float64 CPU path: max abs err "
              f"{err:.3e} (scale {scale:.4g})")
        return err

    x4k = frame((4096, 4096))
    paths = {}

    # the main path: kernel C's one scale and kernel B the lazy noise,
    # kernel A's group takes scales 0-2, its deep step the single deeper
    # scales, kernel E the pair where H >> s <= 32
    configs = {
        "4096² L10 (auto), denoise [5, 2], lazy noise":
            (x4k, dict(denoise_coefficients=[5, 2]), 10,
             {"decompose_group": 1, "whiten_group": 1, "whiten_step": 5,
              "whiten_pair": 1, "median_select": 1}),
        "512² L6, denoise [5, 2], lazy noise":
            (frame((512, 512)), dict(n_scales=6,
                                     denoise_coefficients=[5, 2]), 6,
             {"decompose_group": 1, "whiten_group": 1, "whiten_step": 1,
              "whiten_pair": 1, "median_select": 1}),
    }
    main_launches = {}
    with Phase("main path"):
        for what, (x, kw, n_scales, expect) in configs.items():
            (recon, coeffs), run = drive(
                f"main path {what}", lambda: wt.wow(x, **kw), expect)
            for name, n in run.items():
                main_launches[name] = main_launches.get(name, 0) + n
            # a group launch covers N_FAST scales, a step one, a pair two
            covered = (hopper_conv.N_FAST * run.get("whiten_group", 0)
                       + run.get("whiten_step", 0)
                       + 2 * run.get("whiten_pair", 0))
            require(covered == n_scales,
                    f"main path {what}: launches cover {covered} scales")
            r_p, c_p = wt.wow(x, fuse=False, **kw)
            torch.cuda.synchronize()
            check_wow(what, recon, coeffs, r_p, c_p, n_scales + 1)
        small_vs_cpu("main path 256²", lambda x, **d: wt.wow(
            x, denoise_coefficients=[5, 2], **d)[0])

    # the low-precision paths: the JAX rows wow_4k_L6_bf16_known_noise
    # and wow_4k_L10_bf16 (the bfloat16 merged route: A's group g = 4,
    # deep steps from 4, E where H >> s <= 32), and on their plain routes
    # a bfloat16 S1 (the JAX wow_stack merges float32 stacks only: its
    # frames run one by one), float16 and bfloat16 RL.  Zero-mean frames:
    # on a mean of 10 the residual's std falls below the carry's bfloat16
    # spacing and the JAX package's own bfloat16 path strays 15% from its
    # float32
    lowp_out, lowp_main = {}, {}
    xb4k = bf16_frame((4096, 4096), mean=0.0)
    xs4 = bf16_frame((4096, 4096), b=4, mean=0.0)
    lowp = {
        "wow_4k_L6_bf16_known_noise":
            (lambda x, **k: wt.wow(x, **k)[0], xb4k,
             dict(n_scales=6, denoise_coefficients=[5, 2], noise=1.0),
             {"whiten_group_bf16": 1, "whiten_step_bf16": 2}),
        "wow_4k_L10_bf16":
            (lambda x, **k: wt.wow(x, **k)[0], xb4k,
             dict(n_scales=10, noise=0.0),
             {"whiten_group_bf16": 1, "whiten_step_bf16": 4,
              "whiten_pair_bf16": 1}),
        "bf16 S1 wow_stack 4×4096² L6 [5, 2] noise 1.0 serving":
            (lambda x, **k: wt.wow_stack(x, **k)[0], xs4,
             dict(n_scales=6, denoise_coefficients=[5, 2], noise=1.0,
                  with_coefficients=False), {}),
        "float16 wow 4096² L10 (plain route)":
            (lambda x, **k: wt.wow(x, **k)[0], xb4k.to(torch.float16),
             dict(n_scales=10, noise=0.0), {}),
    }
    for what, (run, x, kw, expect) in lowp.items():
        with Phase(what):
            got, run_l = drive(what, lambda: run(x, **kw), expect)
            if expect:
                lowp_main[what] = run_l
            on_card(got, what, x.shape, x.dtype)
            x32 = x.float()
            ref32 = run(x32, **kw)
            plain = run(x, fuse=False, **kw)
            torch.cuda.synchronize()
            scale = max(float(ref32.abs().max()), 1.0)
            e32 = max_err(got, ref32)
            require(e32 <= 2e-2 * scale, f"{what}: recon {e32} from "
                    f"float32's, more than 2e-2 * {scale}")
            e_p = max_err(got, plain)
            print(f"  recon vs the float32 kernels: max abs err {e32:.4g} "
                  f"(scale {scale:.4g}, {e32 / scale:.3e} relative); vs "
                  f"fuse=False in {x.dtype}: {e_p:.4g}")
            if x.ndim == 3:
                # per-frame statistics: a frame keeps its bits whatever
                # frames stand beside it
                one = run(x[:1], **kw)
                check_bitwise(got[:1], one, what + " frame 0 vs a stack of 1")
                print("  frame 0 bitwise to a stack of one")
            # the same route on a small frame against the CPU's plain
            # versions of the same kernels.  In bfloat16: at most one
            # bfloat16 unit of the CPU result's top binade, 2^(floor(log2
            # max) - 7), a pixel, and at most 1 pixel in 4096 off at all
            # (the card's float32 erf and division flip a rounding now and
            # then: 4 pixels over 24 frames of L6; a route that leaves
            # JAX's rounding points differs at a third of the pixels by
            # about three units); float16 (the plain route) within 2^-8·max
            small = x[..., :512, :512].contiguous()
            on_cpu = run(small.cpu(), **kw)
            diff = (run(small, **kw).cpu().float() - on_cpu.float()).abs()
            e_c, n_c = float(diff.max()), int((diff > 0).sum())
            top = float(on_cpu.float().abs().max())
            if x.dtype == torch.bfloat16:
                unit = 2.0 ** (math.floor(math.log2(top)) - 7)
                require(e_c <= unit and n_c * 4096 <= diff.numel(),
                        f"{what}: 512² on the card vs the CPU {e_c} "
                        f"(one bfloat16 unit {unit}) at {n_c} of "
                        f"{diff.numel()} pixels")
            else:
                require(e_c <= 2 ** -8 * max(top, 1.0),
                        f"{what}: 512² on the card vs the CPU {e_c}")
            t32 = timed(lambda: run(x32, **kw), torch)
            print(f"  512² on the card vs the CPU: max abs err {e_c:.4g} at "
                  f"{n_c} of {diff.numel()} pixels (max {top:.4g}); "
                  f"float32 kernels on the same frame {t32:.3f} ms")
            lowp_out[what] = dict(recon_vs_f32_max_abs_err=e32,
                                  f32_scale=scale, vs_plain_max_abs_err=e_p,
                                  small_vs_cpu_max_abs_err=e_c,
                                  small_vs_cpu_pixels=n_c, f32_ms=t32,
                                  launches=run_l)
            paths[what] = (lambda run=run, x=x, kw=kw: run(x, **kw),
                           lambda run=run, x=x, kw=kw: run(x, fuse=False,
                                                           **kw))
    what = "bf16 richardson_lucy 1024² direct 5×5, 10 iterations"
    with Phase(what):
        hann5 = np.outer(np.hanning(7)[1:-1], np.hanning(7)[1:-1])
        hann5 = (hann5 / hann5.sum()).astype(np.float32)
        xr = frame((1024, 1024)).abs().to(torch.bfloat16)
        got, _ = drive(what, lambda: wt.richardson_lucy(
            xr, hann5, fft=False), {})
        on_card(got, what, xr.shape, torch.bfloat16)
        on_cpu = wt.richardson_lucy(xr[:256, :256].cpu(), hann5, fft=False)
        e_c = max_err(wt.richardson_lucy(xr[:256, :256].contiguous(), hann5,
                                         fft=False).cpu(), on_cpu)
        require(e_c <= 2 ** -8 * float(on_cpu.abs().max()),
                f"{what}: 256² on the card vs the CPU {e_c}")
        xr32 = xr.float()
        ref32 = wt.richardson_lucy(xr32, hann5, fft=False)
        e32 = max_err(got, ref32) / float(ref32.abs().max())
        try:
            wt.richardson_lucy(xr, hann5, fft=True)
            require(False, what + ": fft=True ran in bfloat16")
        except ValueError:
            pass
        t32 = timed(lambda: wt.richardson_lucy(xr32, hann5, fft=False),
                    torch, n=5)
        print(f"  256² on the card vs the CPU: {e_c:.4g}; vs float32 "
              f"{e32:.3e} relative (10 iterations); fft=True raises "
              f"ValueError; float32 {t32:.3f} ms")
        lowp_out[what] = dict(small_vs_cpu_max_abs_err=e_c,
                              vs_f32_relative=e32, f32_ms=t32)
        paths[what] = (lambda: wt.richardson_lucy(xr, hann5, fft=False),
                       lambda: wt.richardson_lucy(xr, hann5, fft=False,
                                                  fuse=False))

    # P1: decomposition
    with Phase("P1 AtrousTransform 4096² L6"):
        coeffs, _ = drive("P1 AtrousTransform()(x4096, 6)",
                          lambda: wt.AtrousTransform()(x4k, 6),
                          ("decompose_group",))
        on_card(coeffs.data, "P1 planes", (7, 4096, 4096))
        check_bitwise(coeffs.data, decompose(x4k, 6, B3SPLINE, fuse=False),
                      "P1 vs fuse=False")
        rt = max_err(wt.synthesize(coeffs.data), x4k)
        require(rt <= WHITE_RTOL * max(1.0, float(x4k.abs().max())),
                f"P1 round trip err {rt}")
        print(f"  bitwise to fuse=False; round trip max abs err {rt:.3e}")
        small_vs_cpu("P1 256²", lambda x, **d: wt.AtrousTransform()(
            x, 6, **d).data)
        paths["P1 AtrousTransform 4096² L6"] = (
            lambda: wt.AtrousTransform()(x4k, 6),
            lambda: decompose(x4k, 6, B3SPLINE, fuse=False))
        del coeffs

    # P2: denoise
    x_vol = frame((64, 1024, 1024))
    p2 = {
        "P2 denoise 4096² [3, 3, 3]": (x4k, ([3, 3, 3],), {}),
        "P2 denoise 4096² [5, 3] Triangle": (x4k, ([5, 3], wt.Triangle), {}),
        "P2 denoise volume 64×1024² [5, 3, 2]": (x_vol, ([5, 3, 2],), {}),
    }
    for what, (x, args, kw) in p2.items():
        with Phase(what):
            out, _ = drive(what, lambda: wt.denoise(x, *args, **kw),
                           ("decompose_group", "median_select"))
            on_card(out, what, x.shape)
            plain = wt.denoise(x, *args, fuse=False, **kw)
            torch.cuda.synchronize()
            e = check_white(out, plain, what + " vs fuse=False")
            print(f"  vs fuse=False on the card: max abs err {e:.3e}")
            small = (16, 64, 64) if x.ndim == 3 else (256, 256)
            small_vs_cpu(what, lambda y, **d: wt.denoise(y, *args, **d),
                         small)
            paths[what] = (
                lambda x=x, args=args: wt.denoise(x, *args),
                lambda x=x, args=args: wt.denoise(x, *args, fuse=False))

    # P3: the materialized-plane WOW route
    p3 = {
        "P3 wow 4096² h=0.5, denoise [5, 2]":
            dict(denoise_coefficients=[5, 2], h=0.5),
        "P3 wow 4096² preserve_variance, h=0.5, denoise [5, 2]":
            dict(denoise_coefficients=[5, 2], h=0.5, preserve_variance=True),
    }
    for what, kw in p3.items():
        with Phase(what):
            (recon, coeffs), _ = drive(
                what, lambda: wt.wow(x4k, **kw),
                ("decompose_group", "whiten_plane", "median_select"))
            r_p, c_p = wt.wow(x4k, fuse=False, **kw)
            torch.cuda.synchronize()
            check_wow(what, recon, coeffs, r_p, c_p, 11)
            small_vs_cpu(what, lambda y, **d: wt.wow(y, **kw, **d)[0])
            paths[what] = (lambda kw=kw: wt.wow(x4k, **kw),
                           lambda kw=kw: wt.wow(x4k, fuse=False, **kw))
    what = "P3 wow(AtrousTransform()(x4096, 10))"
    with Phase(what):
        (recon, coeffs), _ = drive(
            what, lambda: wt.wow(wt.AtrousTransform()(x4k, 10)),
            {"decompose_group": 4, "whiten_plane": 8})
        planes = wt.AtrousTransform()(x4k, 10)
        r_p, c_p = wt.wow(planes, fuse=False)
        torch.cuda.synchronize()
        check_wow(what, recon, coeffs, r_p, c_p, 11)
        small_vs_cpu(what, lambda y, **d: wt.wow(
            wt.AtrousTransform()(y, 6, **d))[0])
        paths[what] = (lambda: wt.wow(planes), lambda: wt.wow(
            planes, fuse=False))

    # the materialized-plane body with a deferred tail against the main
    # path's body: the route the JAX package takes for lazy noise
    with Phase("route A/B: pieces + deferred tail vs merged, 4096² L10"):
        d = (5.0, 2.0) + (0.0,) * 8 + (1.0,)
        w = (1.0,) * 11
        zero = torch.zeros((), device=dev)

        def route_fused():
            pieces, layout, tail = decompose_pieces(x4k, 10, B3SPLINE,
                                                    defer_tail=True)
            return _wow_body_fused(pieces, layout, tail, zero, False,
                                           B3SPLINE, 10, w, d, True,
                                           planes_layout="rows")

        def route_merged():
            return _wow_body_merged(x4k, zero, False, B3SPLINE, 10,
                                            w, d, True, kernels=True)

        (r_f, c_f), _ = drive("pieces + deferred tail", route_fused,
                              ("decompose_group", "whiten_plane",
                               "whiten_pair", "median_select"))
        r_m, c_m = route_merged()
        torch.cuda.synchronize()
        e = check_white(r_f, r_m, "route A/B recon")
        print(f"  pieces route vs merged route: recon max abs err {e:.3e}")
        paths["route pieces + deferred tail 4096² L10 lazy [5, 2]"] = (
            route_fused, route_merged)

    # B1-B4: the bilateral paths, on a zero-mean frame (see bil_frame)
    xb4k = bil_frame((4096, 4096))
    b1 = {
        "B1 wow 4096² L10 bilateral=1, denoise [5, 2], noise 1.0":
            (dict(bilateral=1, denoise_coefficients=[5, 2], noise=1.0),
             {"bilateral_group": 1, "whiten_plane": 1,
              "bilateral_step": 7}),
        "B1-lazy wow 4096² L10 bilateral=1 scaling, denoise [5, 2]":
            (dict(bilateral=1, bilateral_scaling=True,
                  denoise_coefficients=[5, 2]),
             {"bilateral_group": 1, "whiten_plane": 1, "bilateral_step": 7,
              "median_select": 1}),
    }
    for what, (kw, expect) in b1.items():
        with Phase(what):
            (recon, coeffs), _ = drive(what, lambda: wt.wow(xb4k, **kw),
                                       expect)
            r_p, c_p = wt.wow(xb4k, fuse=False, **kw)
            torch.cuda.synchronize()
            check_wow(what, recon, coeffs, r_p, c_p, 11)
            small_vs_cpu(what, lambda y, **d: wt.wow(y, **kw, **d)[0],
                         mean=0.0)
            paths[what] = (lambda kw=kw: wt.wow(xb4k, **kw),
                           lambda kw=kw: wt.wow(xb4k, fuse=False, **kw))
    what = "B2 AtrousTransform(bilateral=1) 4096² L6"
    with Phase(what):
        coeffs, _ = drive(what, lambda: wt.AtrousTransform(
            bilateral=1)(xb4k, 6), {"bilateral_group": 2})
        on_card(coeffs.data, what, (7, 4096, 4096))
        plain = decompose(xb4k, 6, B3SPLINE, bilateral=(1.0,) * 7,
                          fuse=False)
        e = check_white(coeffs.data, plain, what + " vs fuse=False")
        rt = max_err(wt.synthesize(coeffs.data), xb4k)
        require(rt <= WHITE_RTOL * max(1.0, float(xb4k.abs().max())),
                f"B2 round trip err {rt}")
        print(f"  vs fuse=False: max abs err {e:.3e}; round trip max abs "
              f"err {rt:.3e}")
        small_vs_cpu(what, lambda y, **d: wt.AtrousTransform(bilateral=1)(
            y, 6, **d).data, mean=0.0)
        paths[what] = (
            lambda: wt.AtrousTransform(bilateral=1)(xb4k, 6),
            lambda: decompose(xb4k, 6, B3SPLINE, bilateral=(1.0,) * 7,
                              fuse=False))
        del coeffs, plain
    what = "B3 denoise 4096² [3, 3, 3] bilateral=1"
    with Phase(what):
        out, _ = drive(what, lambda: wt.denoise(xb4k, [3, 3, 3],
                                                bilateral=1),
                       {"bilateral_group": 1, "median_select": 1})
        on_card(out, what, xb4k.shape)
        plain = wt.denoise(xb4k, [3, 3, 3], bilateral=1, fuse=False)
        torch.cuda.synchronize()
        e = check_white(out, plain, what + " vs fuse=False")
        print(f"  vs fuse=False on the card: max abs err {e:.3e}")
        small_vs_cpu(what, lambda y, **d: wt.denoise(y, [3, 3, 3],
                                                     bilateral=1, **d),
                     mean=0.0)
        paths[what] = (
            lambda: wt.denoise(xb4k, [3, 3, 3], bilateral=1),
            lambda: wt.denoise(xb4k, [3, 3, 3], bilateral=1, fuse=False))
    what = "B4 wow(AtrousTransform(bilateral=1)(x4096, 10))"
    with Phase(what):
        # four kernel F groups (3, 3, 3, 1 scales); kernel D whitens
        # scales 0-2 from the pieces in one launch and 3-9 one plane each
        (recon, coeffs), _ = drive(
            what, lambda: wt.wow(wt.AtrousTransform(bilateral=1)(xb4k, 10)),
            {"bilateral_group": 4, "whiten_plane": 8})
        bplanes = wt.AtrousTransform(bilateral=1)(xb4k, 10)
        r_p, c_p = wt.wow(bplanes, fuse=False)
        torch.cuda.synchronize()
        check_wow(what, recon, coeffs, r_p, c_p, 11)
        small_vs_cpu(what, lambda y, **d: wt.wow(
            wt.AtrousTransform(bilateral=1)(y, 6, **d))[0], mean=0.0)
        paths[what + ": wow of the planes"] = (
            lambda: wt.wow(bplanes), lambda: wt.wow(bplanes, fuse=False))

    # S1-S6: frame-stack serving (wow_stack, process_stack) and the
    # volume WOW; the stacks of the JAX rows wow_stack_4x4k_*
    # (wavelets_tpu/evidence.py:145-179): [x, x/2, x+1, 2x] of a standard
    # normal frame, zero-mean [x, x/2, -x, 2x] for bilateral (see bil_frame)
    big = torch.from_numpy(rng.normal(size=(4096, 4096)).astype(
        np.float32)).to(dev)
    stack4 = torch.stack([big, big * 0.5, big + 1.0, big * 2.0])
    stackb = torch.stack([big, big * 0.5, -big, big * 2.0])
    l6 = dict(n_scales=6, denoise_coefficients=[5, 2])
    stack_cells = {
        # merged route: kernel A's group (scales 0-2), its deep step 3-5
        "S1 wow_stack 4×4096² L6 [5, 2] noise 1.0 serving":
            (stack4, dict(l6, noise=1.0, with_coefficients=False),
             {"whiten_group": 1, "whiten_step": 3}, True),
        # pieces route: kernel C's group, kernel B a frame, kernel D's
        # pieces form, the deferred tail on kernel A's deep step
        "S2 wow_stack 4×4096² L6 [5, 2] lazy serving":
            (stack4, dict(l6, with_coefficients=False),
             {"decompose_group": 1, "median_select": 4, "whiten_plane": 1,
              "whiten_step": 3}, False),
        # kernel F's group, kernel B a frame, kernel D, kernel G 3-5
        "S3 wow_stack 4×4096² L6 bilateral=1 [5, 2] lazy serving":
            (stackb, dict(l6, bilateral=1, with_coefficients=False),
             {"bilateral_group": 1, "median_select": 4, "whiten_plane": 1,
              "bilateral_step": 3}, True),
        # S1 with the planes: the pieces route, kernel D batch-major
        "S4 wow_stack 4×4096² L6 [5, 2] noise 1.0 with_coefficients":
            (stack4, dict(l6, noise=1.0, with_coefficients=True),
             {"decompose_group": 1, "whiten_plane": 1, "whiten_step": 3},
             False),
    }
    stack_fps = {}
    for what, (xs, kw, expect, same_route) in stack_cells.items():
        with Phase(what):
            (recon, s_planes), _ = drive(what, lambda: wt.wow_stack(xs, **kw),
                                       expect)
            on_card(recon, what + " recon", xs.shape)
            wc = kw["with_coefficients"]
            require((s_planes is not None) == wc, what + ": planes")
            if wc:
                on_card(s_planes, what + " planes", (4, 7, 4096, 4096))
            r_p, c_p = wt.wow_stack(xs, fuse=False, **kw)
            torch.cuda.synchronize()
            scale = float(r_p.abs().max())
            e_r = check_white(recon, r_p, what + " recon vs fuse=False")
            e_c = (check_white(s_planes, c_p,
                               what + " planes vs fuse=False",
                               scale) if wc else 0.0)
            del r_p, c_p
            # each frame against single-frame wow of that frame
            one_kw = {k: v for k, v in kw.items() if k != "with_coefficients"}
            e_f = 0.0
            for b in range(xs.shape[0]):
                r1, c1 = wt.wow(xs[b], **one_kw)
                torch.cuda.synchronize()
                if same_route:
                    check_bitwise(recon[b], r1, f"{what} frame {b} vs wow")
                else:
                    e_f = max(e_f, check_white(recon[b], r1,
                                               f"{what} frame {b} vs wow"))
                if wc:
                    for k in range(7):
                        e_f = max(e_f, check_white(
                            s_planes[b, k], c1[k],
                            f"{what} frame {b} plane {k} vs wow",
                            float(r1.abs().max())))
                del r1, c1
            print(f"  vs fuse=False: recon {e_r:.3e}, planes {e_c:.3e}; "
                  f"frames vs single-frame wow: "
                  + ("bitwise" if same_route and not wc else
                     f"max abs err {e_f:.3e}"))
            del recon, s_planes
            paths[what] = (
                lambda xs=xs, kw=kw: wt.wow_stack(xs, **kw),
                lambda xs=xs, kw=kw: wt.wow_stack(xs, fuse=False, **kw))
            stack_fps[what] = 4
    small_vs_cpu("S2 wow_stack 2×256²", lambda y, **d: wt.wow_stack(
        y, n_scales=5, denoise_coefficients=[5, 2],
        with_coefficients=False, **d)[0], (2, 256, 256))

    # the dispatch's route for S2 against the merged body forced: the
    # stack half of the lazy-noise route question (no dispatch change)
    zero4 = torch.zeros(4, device=dev)
    d6 = (5.0, 2.0, 0.0, 0.0, 0.0, 0.0, 1.0)
    what = "route S2 stack: pieces (dispatch) vs merged forced"
    with Phase(what):
        def s2_merged():
            return _wow_body_merged(stack4, zero4, False, B3SPLINE, 6,
                                    (1.0,) * 7, d6, True, kernels=True,
                                    need_planes=False)[0]

        r_m, _ = drive(what + ": merged forced", s2_merged,
                       {"decompose_group": 1, "whiten_group": 1,
                        "whiten_step": 3, "median_select": 4})
        r_d = wt.wow_stack(stack4, with_coefficients=False, **l6)[0]
        torch.cuda.synchronize()
        e = check_white(r_d, r_m, what)
        print(f"  pieces route vs merged route: recon max abs err {e:.3e}")
        paths["route S2 stack 4×4096² L6 lazy [5, 2]"] = (
            lambda: wt.wow_stack(stack4, with_coefficients=False, **l6),
            s2_merged)
        del r_m, r_d

    # S5: process_stack from disk: 10 uint16 frames of 4096², batches of
    # 4 (the last one short), S2's options
    what = "S5 process_stack 10×4096² uint16, batch 4, L6 [5, 2] lazy"
    import tempfile
    from wavelets_tpu_torch.utils.frameio import FrameStack, write_array
    tmp_dir = tempfile.TemporaryDirectory(dir=ROOT / "build")
    raw = Path(tmp_dir.name) / "frames.raw"
    with Phase(what):
        host = rng.integers(0, 4096, size=(10, 4096, 4096), dtype=np.uint16)
        write_array(str(raw), host)
        del host
        out_k = Path(tmp_dir.name) / "out_kernels.raw"
        out_p = Path(tmp_dir.name) / "out_plain.raw"

        def s5(out=out_k, **kw):
            return wt.process_stack(str(raw), str(out), 10, (4096, 4096),
                                    batch=4, **l6, **kw)

        (n, secs, fps), _ = drive(
            what, s5, {"decompose_group": 3, "median_select": 10,
                       "whiten_plane": 3, "whiten_step": 9})
        print(f"  {n} frames in {secs:.3f} s = {fps:.2f} frames/s "
              "(first call)")
        s5(out=out_p, fuse=False)
        got = np.fromfile(out_k, np.float32).reshape(10, 4096, 4096)
        with FrameStack(str(raw), 10, (4096, 4096)) as fs:
            for b0 in range(0, 10, 4):
                idx = list(range(b0, min(b0 + 4, 10)))
                batch = torch.from_numpy(fs.read_batch(idx)).to(dev)
                want = wt.wow_stack(batch, with_coefficients=False, **l6)[0]
                check_bitwise(torch.from_numpy(got[idx]).to(dev), want,
                              f"{what} frames {idx} vs wow_stack")
        require(np.isfinite(got).all(), what + ": not finite")
        plain = np.fromfile(out_p, np.float32).reshape(10, 4096, 4096)
        e = check_white(torch.from_numpy(got), torch.from_numpy(plain),
                        what + " vs fuse=False")
        print(f"  bitwise to wow_stack over the same batches; vs "
              f"fuse=False max abs err {e:.3e}")
        del got, plain, batch, want
        paths[what] = (lambda: s5(), lambda: s5(out=out_p, fuse=False))
        stack_fps[what] = 10

    # S6: WOW of a 64×1024² volume: kernel C's volume pass, kernel B on
    # the finest plane, the plain whitening loop
    what = "S6 wow volume 64×1024² [5, 2] lazy"
    xv6 = frame((64, 1024, 1024))
    with Phase(what):
        (recon, coeffs), _ = drive(
            what, lambda: wt.wow(xv6, denoise_coefficients=[5, 2]),
            {"decompose_group": 4, "median_select": 1})
        r_p, c_p = wt.wow(xv6, denoise_coefficients=[5, 2], fuse=False)
        torch.cuda.synchronize()
        on_card(recon, what + " recon", xv6.shape)
        check_wow(what, recon, coeffs, r_p, c_p, 5)
        small_vs_cpu(what, lambda y, **d: wt.wow(
            y, denoise_coefficients=[5, 2], **d)[0], (16, 64, 64))
        del recon, coeffs, r_p, c_p
        paths[what] = (
            lambda: wt.wow(xv6, denoise_coefficients=[5, 2]),
            lambda: wt.wow(xv6, denoise_coefficients=[5, 2], fuse=False))
        stack_fps[what] = 1

    # R1-R4: Richardson-Lucy, the JAX rows richardson_lucy_1k_10it_* and
    # richardson_lucy_stack2_1k_10it_auto (wavelets_tpu/evidence.py:
    # 241-262): x·x + 1 of a standard normal frame, a normalized 15×15
    # Hanning PSF, soft (5, 2, 1), 10 iterations.  Kernel C once a
    # 3-scale decomposition (the start and each iteration), kernel B once
    # a frame, or once a frame an iteration under uniform_init
    import importlib
    trl = importlib.import_module("wavelets_tpu_torch.models.richardson_lucy")
    han = np.hanning(15)
    psf15 = np.outer(han, han).astype(np.float32)
    psf15 /= psf15.sum()

    def rl_input(shape):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return x.to(dev) * x.to(dev) + 1.0

    pos1k, pos4k = rl_input((1024, 1024)), rl_input((4096, 4096))
    stack2 = torch.stack([pos1k, pos1k * 2.0])
    rl_kw = dict(iterations=10, denoise_coefficients=(5, 2, 1))
    rl_out = {}
    # time to first frame: the process's first FFT (cuFFT's load and a
    # plan), a plan alone (cache cleared), and the transform planned
    for n, x in ((1024, pos1k), (4096, pos4k)):
        plans = torch.backends.cuda.cufft_plan_cache
        plans.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.fft.irfft2(torch.fft.rfft2(x), s=x.shape)
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
        rl_out[f"cufft_first_call_ms_{n}"] = first
        rl_out[f"cufft_planned_ms_{n}"] = timed(
            lambda x=x: torch.fft.irfft2(torch.fft.rfft2(x), s=x.shape),
            torch)
        print(f"  cuFFT rfft2 + irfft2 {n}²: first call after the plan "
              f"cache was cleared {first:.3f} ms (host clock, the process's "
              f"{'first FFT' if n == 1024 else 'plan'}), planned "
              f"{rl_out[f'cufft_planned_ms_{n}']:.3f} ms")

    def check_path(what, got, plain, shape):
        on_card(got, what, shape)
        e = check_white(got, plain, what + " vs fuse=False")
        same = bool(torch.equal(got, plain))
        print(f"  vs fuse=False on the card: "
              + ("bitwise" if same else f"max abs err {e:.3e}"))

    def rl_vs_cpu(what, kw, shape=(256, 256)):
        # float32 on the card against float64 on the CPU, a small x·x + 1
        small = rng.normal(size=shape) ** 2 + 1
        fn = wt.richardson_lucy_stack if len(shape) == 3 else \
            wt.richardson_lucy
        got = fn(torch.from_numpy(small.astype(np.float32)).to(dev),
                 psf15, **kw)
        ref = fn(small, psf15.astype(np.float64), device="cpu", **kw)
        scale = float(ref.abs().max())
        err = check_white(got.cpu(), ref, f"{what} vs float64 CPU", scale)
        print(f"  {shape} on the card vs the float64 CPU path: max abs err "
              f"{err:.3e} (scale {scale:.4g})")

    r4_kw = dict(rl_kw, threshold_type="hard", uniform_init=True,
                 persistent_mrs=False)
    rl_cells = {
        "R1 richardson_lucy_1k_10it_direct":
            (pos1k, dict(rl_kw, fft=False), 11, 1, wt.richardson_lucy),
        "R1 richardson_lucy_1k_10it_fft":
            (pos1k, dict(rl_kw, fft=True), 11, 1, wt.richardson_lucy),
        "R2 richardson_lucy 4096² 10it auto":
            (pos4k, dict(rl_kw, fft="auto"), 11, 1, wt.richardson_lucy),
        "R3 richardson_lucy_stack2_1k_10it_auto":
            (stack2, dict(rl_kw, fft="auto"), 11, 2,
             wt.richardson_lucy_stack),
        "R4 richardson_lucy 1k 10it hard uniform_init not persistent":
            (pos1k, r4_kw, 10, 10, wt.richardson_lucy),
    }
    for what, (x, kw, n_c, n_b, fn) in rl_cells.items():
        with Phase(what):
            got, _ = drive(what, lambda: fn(x, psf15, **kw),
                           {"decompose_group": n_c, "median_select": n_b})
            plain = fn(x, psf15, fuse=False, **kw)
            torch.cuda.synchronize()
            check_path(what, got, plain, x.shape)
            if x.ndim == 3:
                for b in range(x.shape[0]):
                    check_bitwise(got[b], wt.richardson_lucy(x[b], psf15,
                                                             **kw),
                                  f"{what} frame {b} vs richardson_lucy")
                print("  each frame bitwise to single-frame richardson_lucy")
            # hard thresholds flip where a coefficient meets the threshold
            # (float32 against float64), so R4's float64 check is soft
            small_kw = dict(kw, threshold_type="soft")
            rl_vs_cpu(what, small_kw, (2, 128, 128) if x.ndim == 3
                      else (256, 256))
            paths[what] = (lambda x=x, kw=kw, fn=fn: fn(x, psf15, **kw),
                           lambda x=x, kw=kw, fn=fn: fn(x, psf15, fuse=False,
                                                        **kw))
            del got, plain

    # the direct path's correlation: F.conv2d (TF32 off) against the
    # float32 shift-add in the JAX tap order, then the direct against
    # the FFT path, 10 iterations (the JAX rule takes FFT above 36 taps)
    with Phase("RL: correlation and the direct/FFT crossover"):
        corr = {}
        for n, x in ((1024, pos1k), (4096, pos4k)):
            for k in (5, 15):
                h = np.hanning(k + 2)[1:-1]
                p = torch.from_numpy((np.outer(h, h) / np.outer(h, h).sum())
                                     .astype(np.float32)).to(dev)
                c_k = trl._correlate2d_symmetric(x, p)
                c_s = trl._correlate2d_shift_add(x, p)
                e = check_white(c_k, c_s, f"conv2d vs shift-add {n}² {k}×{k}")
                t_c = timed(lambda: trl._correlate2d_symmetric(x, p), torch)
                t_s = timed(lambda: trl._correlate2d_shift_add(x, p), torch,
                            n=5)
                corr[f"{n}x{n}_{k}x{k}"] = {"conv2d_ms": t_c,
                                            "shift_add_ms": t_s,
                                            "max_abs_err": e}
                print(f"  correlation {n}² {k}×{k}: conv2d (TF32 off) "
                      f"{t_c:.3f} ms, shift-add {t_s:.3f} ms, max abs err "
                      f"{e:.3e}")
        rl_out["correlation"] = corr
        cross = {}
        for n, x in ((1024, pos1k), (4096, pos4k)):
            for k in (3, 5, 7, 9, 15):
                h = np.hanning(k + 2)[1:-1]
                p = (np.outer(h, h) / np.outer(h, h).sum()).astype(np.float32)
                t_d = timed(lambda: wt.richardson_lucy(x, p, fft=False,
                                                       **rl_kw), torch, n=5)
                t_f = timed(lambda: wt.richardson_lucy(x, p, fft=True,
                                                       **rl_kw), torch, n=5)
                cross[f"{n}x{n}_{k}x{k}"] = {"direct_ms": t_d, "fft_ms": t_f,
                                             "auto": "fft" if trl._fft_auto(
                                                 "auto", p.shape)
                                             else "direct"}
                print(f"  RL 10 it {n}² PSF {k}×{k} ({k * k} taps): direct "
                      f"{t_d:.3f} ms, FFT {t_f:.3f} ms; faster "
                      f"{'direct' if t_d < t_f else 'FFT'}, auto takes "
                      f"{cross[f'{n}x{n}_{k}x{k}']['auto']}")
        rl_out["crossover"] = cross

    # E1-E2: enhance (wavelets_tpu/models/enhance.py), denoise [5, 3],
    # weights [1.5, 1.2], lazy noise: E1 the batched pass over three
    # 4096² channels (kernel C once, kernel B a channel), E2 one frame
    x3 = frame((3, 4096, 4096))
    en_cells = {
        "E1 enhance 3×4096² [5, 3] × [1.5, 1.2] lazy":
            (x3, dict(weights=[[1.5, 1.2]] * 3, denoise=[[5, 3]] * 3), 3,
             (3, 64, 64)),
        "E2 enhance 4096² [5, 3] × [1.5, 1.2] lazy":
            (x4k, dict(weights=[1.5, 1.2], denoise=[5, 3]), 1, (256, 256)),
    }
    for what, (x, kw, n_b, small) in en_cells.items():
        with Phase(what):
            got, _ = drive(what, lambda: wt.enhance(x, **kw),
                           {"decompose_group": 1, "median_select": n_b})
            plain = wt.enhance(x, fuse=False, **kw)
            torch.cuda.synchronize()
            check_path(what, got, plain, x.shape)
            if x.ndim == 3:
                one = wt.enhance(x[1], weights=[1.5, 1.2], denoise=[5, 3])
                e = check_white(got[1], one, what + " channel 1 vs 2-D")
                print(f"  channel 1 vs a 2-D enhance: "
                      + ("bitwise" if torch.equal(got[1], one)
                         else f"max abs err {e:.3e}"))
            small_vs_cpu(what, lambda y, **d: wt.enhance(y, **kw, **d), small)
            paths[what] = (lambda x=x, kw=kw: wt.enhance(x, **kw),
                           lambda x=x, kw=kw: wt.enhance(x, fuse=False, **kw))
            del got, plain

    # T1: the recursive algorithm's borders at 4096² L6: a pad of
    # 2·2^5 = 64 on each side, kernel C's two groups on 4224²
    what = "T1 AtrousTransform()(x4096, 6, recursive=True)"
    with Phase(what):
        coeffs, _ = drive(what, lambda: wt.AtrousTransform()(
            x4k, 6, recursive=True), {"decompose_group": 2})
        plain = decompose(x4k, 6, B3SPLINE, recursive_borders=True,
                          fuse=False)
        check_path(what, coeffs.data, plain, (7, 4096, 4096))
        reach = B3SPLINE.half_width * (2 ** 6 - 1)
        inner = (slice(None), slice(reach, -reach), slice(reach, -reach))
        std = wt.AtrousTransform()(x4k, 6).data
        check_bitwise(coeffs.data[inner], std[inner],
                      what + " interior vs the standard transform")
        rt = max_err(wt.synthesize(coeffs.data), x4k)
        require(rt <= WHITE_RTOL * max(1.0, float(x4k.abs().max())),
                f"T1 round trip err {rt}")
        print(f"  interior (beyond {reach} px) bitwise to the standard "
              f"transform; round trip max abs err {rt:.3e}")
        small_vs_cpu(what, lambda y, **d: wt.AtrousTransform()(
            y, 6, recursive=True, **d).data)
        paths[what] = (
            lambda: wt.AtrousTransform()(x4k, 6, recursive=True),
            lambda: wt.AtrousTransform()(x4k, 6, recursive=True, fuse=False))
        del coeffs, plain, std

    # T2: convolution (plain PyTorch, no kernel) at s = 0..3
    what = "T2 convolution 4096² s = 0..3"
    with Phase(what):
        for s in range(4):
            got, _ = drive(f"{what}: s={s}", lambda: wt.convolution(
                x4k, wt.B3spline, s=s), {})
            on_card(got, f"{what} s={s}", x4k.shape)
            small_vs_cpu(f"{what} s={s}", lambda y, **d: wt.convolution(
                y, wt.B3spline, s=s, **d))
        del got

    # N1: the σ_e table by Monte Carlo on the card: 100 trials of 704²
    # in 10 batches of 10, each a 6-scale decomposition (two groups)
    what = "N1 B3spline(2).compute_noise_weights(6, n_trials=100)"
    with Phase(what):
        t0 = time.perf_counter()
        got, _ = drive(what, lambda: wt.B3spline(2).compute_noise_weights(
            6, n_trials=100), {"decompose_group": 20})
        n1_s = time.perf_counter() - t0
        table = wt.B3spline(2).sigma_e()[:6]
        # the JAX package's Monte-Carlo tolerance (tests/test_calibration.py)
        require(np.allclose(got, table, rtol=0.08),
                f"{what}: {got} against the table {table}")
        plain = wt.B3spline(2).compute_noise_weights(6, n_trials=100,
                                                     fuse=False)
        require(np.array_equal(got, plain), f"{what}: not bitwise to "
                f"fuse=False ({got} against {plain})")
        rl_out["noise_weights"] = {"got": got.tolist(),
                                   "table": table.tolist(), "s": n1_s}
        print(f"  {got} against the table {table} (largest relative "
              f"difference {np.abs(got / table - 1).max():.4f}, tolerance "
              f"0.08); bitwise to fuse=False; {n1_s:.3f} s")

    # C1: python -m wavelets_tpu_torch rl on 4 uint16 frames of 1024²
    what = "C1 python -m wavelets_tpu_torch rl 4×1024² uint16"
    with Phase(what):
        host = ((rng.normal(size=(4, 1024, 1024)) ** 2 + 1) * 100).astype(
            np.uint16)
        rl_in = Path(tmp_dir.name) / "rl_in.raw"
        rl_res = Path(tmp_dir.name) / "rl_out.raw"
        psf_file = Path(tmp_dir.name) / "psf15.npy"
        write_array(str(rl_in), host)
        np.save(psf_file, psf15)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "wavelets_tpu_torch", "rl", str(rl_in),
             str(rl_res), "--frames", "4", "--shape", "1024", "1024",
             "--dtype", "uint16", "--psf", str(psf_file), "--device",
             "cuda"], cwd=ROOT, capture_output=True, text=True, timeout=600)
        c1_s = time.perf_counter() - t0
        require(proc.returncode == 0, f"{what}: exit {proc.returncode}\n"
                f"{proc.stdout}\n{proc.stderr}")
        print(f"  {proc.stdout.strip()} ({c1_s:.2f} s, a new process)")
        got = np.fromfile(rl_res, np.float32).reshape(4, 1024, 1024)
        require(np.isfinite(got).all(), what + ": not finite")
        for k in range(4):
            want = wt.richardson_lucy(
                torch.from_numpy(host[k].astype(np.float32)).to(dev), psf15,
                fft=False, **rl_kw)
            check_bitwise(torch.from_numpy(got[k]).to(dev), want,
                          f"{what} frame {k} vs richardson_lucy")
        print("  each frame bitwise to richardson_lucy on the card")
        rl_out["c1_s"] = c1_s
        del host, got, want

    # ---- 4m. the sharded engine (parallel/) on a one-rank NCCL group ---
    # M1-M4, the mesh set up in this process.  More ranks cannot run on one
    # card (NCCL refuses two ranks on one device, and gloo has no CUDA send
    # or receive): the 4-rank checks are the gloo tests on the CPU
    # (tests/test_torch_parallel.py).
    import socket

    import torch.distributed as dist
    from wavelets_tpu_torch import parallel as wpar
    from wavelets_tpu_torch.parallel.mesh import init_distributed
    from wavelets_tpu_torch.utils.profiling import count_collectives

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    init_distributed(f"tcp://localhost:{port}", 1, 0, "nccl")
    mesh1 = wpar.make_mesh(1, 1, 1)
    sharded_main, sharded_out = {}, {}

    def sharded_drive(what, fn, expect):
        """``drive`` with the collectives the call issued."""
        box = {}
        coll = count_collectives(
            lambda: box.update(res=drive(what, fn, expect)))
        print(f"  collectives: {coll}")
        out, run = box["res"]
        sharded_main[what] = run
        sharded_out[what] = dict(launches=run, collectives=coll)
        return out

    what = "M1 sharded_wow_1chip_4k_L6_serving"
    with Phase(what):
        # stage 1: the frame stack of one on a data-only mesh
        m1 = dict(n_scales=6, denoise_coefficients=[5, 2], noise=1.0,
                  with_coefficients=False)
        m1_r, m1_p = sharded_drive(what, lambda: wpar.sharded_wow(
            big[None], mesh1, **m1), {"whiten_group": 1, "whiten_step": 3})
        require(m1_p is None, what + ": planes in serving mode")
        m1_got = m1_r.full_tensor()
        on_card(m1_got, what, (1, 4096, 4096))
        check_bitwise(m1_got, wt.wow_stack(big[None], **m1)[0],
                      what + " vs wow_stack")
        print("  bitwise to wow_stack of the same frame")
        paths[what] = (lambda: wpar.sharded_wow(big[None], mesh1, **m1),
                       lambda: wt.wow_stack(big[None], **m1))

    what = "M2 sharded_wow 4096² L10 [5, 2] lazy, 1x1x1 mesh"
    with Phase(what):
        # stage 2: kernel A's group on the reflected block, the band tail
        # on kernel A's halo step, the exact median by bisection
        m2 = dict(denoise_coefficients=[5, 2])
        m2_r, m2_p = sharded_drive(what, lambda: wpar.sharded_wow(
            x4k, mesh1, **m2), {"whiten_group": 1, "whiten_step_halo": 7})
        m2_got, m2_planes = m2_r.full_tensor(), m2_p.full_tensor()
        on_card(m2_got, what, (4096, 4096))
        on_card(m2_planes, what + " planes", (11, 4096, 4096))
        r_w, c_w = wt.wow(x4k, **m2)
        for k in range(10):
            check_bitwise(m2_planes[k], c_w[k], f"{what} plane {k} vs wow")
        # the residual plane is the last carry over its std, 4e-4 of its
        # mean on this mean-10 frame: the engine sums the std in float64,
        # wow takes torch.std in float32; both against the float64 std
        carry = wt.AtrousTransform()(x4k, 10)[10].double()
        ref10 = (carry / carry.std(correction=0)).float()
        e_s = check_white(m2_planes[10], ref10,
                          what + " residual vs the float64 std")
        e_w = max_err(c_w[10], ref10)
        check_white(m2_got, r_w - c_w[10] + m2_planes[10],
                          what + " recon vs wow's details + its residual")
        print(f"  details bitwise to wow; the residual plane vs the float64 "
              f"std: max abs err {e_s:.3e} (wow's {e_w:.3e}, scale "
              f"{float(ref10.abs().max()):.4g}); recon vs wow "
              f"{max_err(m2_got, r_w):.3e}")
        # a zero-mean frame, where the residual is well conditioned
        xz = bil_frame((4096, 4096))
        rz = wpar.sharded_wow(xz, mesh1, **m2)[0].full_tensor()
        e_z = check_white(rz, wt.wow(xz, **m2)[0], what + " zero mean")
        print(f"  zero-mean 4096² frame vs wow: recon max abs err {e_z:.3e}")
        sharded_out[what].update(residual_vs_f64_std=e_s,
                                 wow_residual_vs_f64_std=e_w,
                                 recon_vs_wow=max_err(m2_got, r_w),
                                 zero_mean_recon_vs_wow=e_z)
        paths[what] = (lambda: wpar.sharded_wow(x4k, mesh1, **m2),
                       lambda: wt.wow(x4k, **m2))
        del m2_got, m2_planes, m2_r, m2_p, c_w, carry, ref10, xz, rz

    what = "M3 sharded_decompose 4096² L6, 1x1x1 mesh"
    with Phase(what):
        # the halo chain: one rank's smooths are the plain separable ones
        m3_d = sharded_drive(what, lambda: wpar.sharded_decompose(
            x4k, 6, B3SPLINE, mesh1), {})
        m3_got = m3_d.full_tensor()
        on_card(m3_got, what, (7, 4096, 4096))
        m3_ref = wt.AtrousTransform()(x4k, 6).data
        e = check_white(m3_got, m3_ref, what + " vs AtrousTransform")
        print(f"  vs AtrousTransform (kernel C): max abs err {e:.3e}, "
              f"bitwise: {bool(torch.equal(m3_got, m3_ref))}")
        sharded_out[what].update(max_abs_err=e)
        paths[what] = (
            lambda: wpar.sharded_decompose(x4k, 6, B3SPLINE, mesh1),
            lambda: wt.AtrousTransform()(x4k, 6))
        del m3_got, m3_ref, m3_d

    what = "M4 process_stack(mesh=) 10×4096² uint16, batch 4, L6 [5, 2] lazy"
    out_m4 = Path(tmp_dir.name) / "out_mesh.raw"
    with Phase(what):
        def m4():
            return wt.process_stack(str(raw), str(out_m4), 10, (4096, 4096),
                                    batch=4, mesh=mesh1, **l6)

        n, secs, fps = sharded_drive(
            what, m4, {"decompose_group": 3, "median_select": 10,
                       "whiten_plane": 3, "whiten_step": 9})
        m4_got = np.fromfile(out_m4, np.float32)
        s5_out = np.fromfile(Path(tmp_dir.name) / "out_kernels.raw",
                             np.float32)
        require(m4_got.shape == s5_out.shape
                and np.array_equal(m4_got, s5_out),
                what + ": not bitwise to S5's output file")
        print(f"  {n} frames in {secs:.3f} s = {fps:.2f} frames/s (first "
              "call); bitwise to S5's output file")
        paths[what] = (m4, lambda: s5())
        stack_fps[what] = 10
        del m4_got, s5_out

    # ---- 5. timings -----------------------------------------------------
    print(f"timings on {card}: median of {N_TIMED} runs, CUDA events")
    e2e = {}
    with Phase("timings: paths"):
        for what, (x, kw, _, _) in configs.items():
            t_k = timed(lambda: wt.wow(x, **kw), torch)
            t_p = timed(lambda: wt.wow(x, fuse=False, **kw), torch)
            e2e[what] = (t_k, t_p)
            print(f"  wow {what}: kernels {t_k:.3f} ms, plain {t_p:.3f} ms")
        for what, (run_k, run_p) in paths.items():
            t_k = timed(run_k, torch)
            t_p = timed(run_p, torch)
            e2e[what] = (t_k, t_p)
            label = ("merged" if what.startswith("route")
                     else "single-device" if what[:1] == "M" else "plain")
            print(f"  {what}: kernels {t_k:.3f} ms, {label} {t_p:.3f} ms")
        del x_vol
        fps_out = {what: {"frames_per_s": n / e2e[what][0] * 1e3,
                          "plain_frames_per_s": n / e2e[what][1] * 1e3}
                   for what, n in stack_fps.items()}
        for what, v in fps_out.items():
            print(f"  {what}: {v['frames_per_s']:.2f} frames/s, plain "
                  f"{v['plain_frames_per_s']:.2f}")

    kernels_out = []
    with Phase("timings: kernels"):
        # kernel A, group form: scales 0-2 at 4096², need_cube on and off
        x = frame((4096, 4096))
        thr3 = torch.tensor([1.0, 1.0, 0.0], device=dev)
        grp = {}
        for need_cube in (True, False):
            gkw = dict(masked=(True, True, False), need_cube=need_cube)
            grp[need_cube] = timed(lambda: hopper_conv.fused_wow_group(
                x, [1.0] * 3, thr3, 3, B3SPLINE, **gkw), torch)
        grp_p = timed(lambda: hopper_conv.fused_wow_group_plain(
            x, [1.0] * 3, thr3, 3, B3SPLINE, masked=(True, True, False)),
            torch)
        print(f"  kernel A group 4096² g=3: {grp[True]:.3f} ms, need_cube "
              f"off {grp[False]:.3f} ms, plain {grp_p:.3f} ms")
        # read x; write 3 whites, the carry, acc
        b_grp = bound_ms(6 * plane_bytes,
                         3 * 4096 * 4096 * (4 * FOLD_OPS + 8))
        kernels_out.append(dict(
            name="whiten_group", route="cuda",
            source="wavelets_tpu_torch/csrc/whiten_group.cu",
            replaces="wavelets_tpu/ops/pallas_conv.py:607",
            launches=launches.get("whiten_group", 0),
            main_path_launches=main_launches.get("whiten_group", 0),
            max_abs_err=errs_grp["white"],
            carry_max_abs_err=errs_grp["carry"],
            ms=grp[True], plain_ms=grp_p, bound_ms=b_grp[0],
            bound_by=b_grp[1], library_ms=None,
            ms_need_cube_off=grp[False],
            bound_ms_need_cube_off=bound_ms(
                3 * plane_bytes, 3 * 4096 * 4096 * (4 * FOLD_OPS + 8))[0],
            timed="one group, scales 0-2 at 4096², need_cube on",
            library="none: PyTorch has no numpy-symmetric pad or dilated "
                    "smooth in one call"))

        # kernel A, deep form: one step per scale, 0-9 at 4096²
        x = frame((4096, 4096), b=1)
        recon = torch.zeros_like(x)
        zero1 = torch.zeros(1, device=dev)
        thr1 = torch.tensor([1.0], device=dev)
        step_k = step_p = 0.0
        per_scale = {}
        for s in range(10):
            kw = dict(sf=B3SPLINE, scale=s, weight=1.0, soft=True,
                      masked=s < 2)
            t = thr1 if s < 2 else zero1
            tk = timed(lambda: hopper_deep.deep_whiten_step(x, recon, t,
                                                            **kw), torch)
            tp = timed(lambda: hopper_deep.deep_whiten_step_plain(
                x, recon, t, **kw), torch)
            per_scale[s] = tk
            if s >= 3:
                step_k += tk
                step_p += tp
            print(f"  kernel A step 4096² s={s}: {tk:.3f} ms, plain "
                  f"{tp:.3f} ms")
        # per step: read carry and recon, write white, c_next, recon
        b_a = bound_ms(7 * 5 * plane_bytes,
                       7 * 4096 * 4096 * (4 * FOLD_OPS + 8))
        kernels_out.append(dict(
            name="whiten_step", route="cuda",
            source="wavelets_tpu_torch/csrc/whiten_step.cu",
            replaces="wavelets_tpu/ops/pallas_deep.py:514",
            launches=launches.get("whiten_step", 0),
            main_path_launches=main_launches.get("whiten_step", 0),
            max_abs_err=errs_a["white"], carry_max_abs_err=errs_a["carry"],
            ms=step_k, plain_ms=step_p, bound_ms=b_a[0], bound_by=b_a[1],
            library_ms=None, per_scale_ms=per_scale,
            timed="scales 3-9 at 4096², one step each",
            library="none: PyTorch has no numpy-symmetric pad or dilated "
                    "smooth in one call"))

        # kernel A in halo mode: M2's band tail, the 4096² frame as one
        # band extended by R = 2hw·2^s rows a side, s = 3..9
        recon = torch.zeros_like(x)
        halo_k = halo_p = 0.0
        halo_bytes = halo_ops = 0
        per_halo = {}
        for s in range(3, 10):
            R = 2 * B3SPLINE.half_width << s
            ext = x.index_select(1, boundary_index(
                4096, -R, "symmetric", dev, 4096 + 2 * R)).contiguous()
            kw = dict(sf=B3SPLINE, scale=s, weight=1.0, soft=True,
                      masked=False, halo=R)
            per_halo[s] = timed(lambda: hopper_deep.deep_whiten_step(
                ext, recon, zero1, **kw), torch)
            halo_k += per_halo[s]
            halo_p += timed(lambda: hopper_deep.deep_whiten_step_plain(
                ext, recon, zero1, **kw), torch, n=5)
            halo_bytes += halo_step_bytes(4096, 4096, R)
            halo_ops += halo_step_ops(4096, 4096, R)
        del ext
        b_h = bound_ms(halo_bytes, halo_ops)
        print(f"  kernel A halo step 4096² s=3..9: {halo_k:.3f} ms ("
              + ", ".join(f"{v:.3f}" for v in per_halo.values())
              + f"), plain {halo_p:.3f} ms, bound {b_h[0]:.3f} ({b_h[1]})")
        m2_name = "M2 sharded_wow 4096² L10 [5, 2] lazy, 1x1x1 mesh"
        kernels_out.append(dict(
            name="whiten_step_halo", route="cuda",
            source="wavelets_tpu_torch/csrc/whiten_step.cu",
            replaces="wavelets_tpu/ops/pallas_deep.py:311 (the stream, "
                     "halo mode :343-350; deep_whiten_step :514, "
                     "pallas_call :593)",
            launches=launches.get("whiten_step_halo", 0),
            main_path_launches=sharded_main[m2_name].get(
                "whiten_step_halo", 0),
            max_abs_err=err_halo["white"],
            carry_max_abs_err=err_halo["carry"],
            ms=halo_k, plain_ms=halo_p, bound_ms=b_h[0], bound_by=b_h[1],
            library_ms=None, per_scale_ms=per_halo,
            timed="M2's band tail: scales 3-9, the 4096² frame extended by "
                  "2hw·2^s rows a side, one halo step each",
            library="none: PyTorch has no dilated smooth in one call"))

        # kernel B
        med = {}
        for side in (4096, 512):
            x = frame((side, side))
            med[side] = (
                timed(lambda: hopper_stats.median_abs(x), torch),
                timed(lambda: hopper_stats.median_abs(
                    x, hopper_stats.median_bits2_plain), torch),
                timed(lambda: torch.quantile(x.abs(), 0.5), torch),
                bound_ms(side * side * 4, side * side * 2)[0])
            print(f"  kernel B {side}²: {med[side][0]:.3f} ms, plain "
                  f"{med[side][1]:.3f} ms, torch.quantile "
                  f"{med[side][2]:.3f} ms, bound {med[side][3]:.4f} ms")
        med_k, med_p, med_l, _ = med[4096]
        # the device kernels of one call: the plan's launches, at most 4
        from torch.profiler import ProfilerActivity, profile
        bits = frame((4096, 4096)).reshape(-1).view(torch.int32)
        ks = hopper_stats.middle_ranks(bits.numel())
        hopper_stats.median_bits2(bits, ks)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            hopper_stats.median_bits2(bits, ks)
            torch.cuda.synchronize()
        b_per_call = sum(e.count for e in prof.key_averages()
                         if device_kernel(e))
        require(1 <= b_per_call <= 4,
                f"kernel B: {b_per_call} device kernels in one call")
        print(f"  kernel B: {b_per_call} device kernels in one call")
        del bits
        b_b = bound_ms(plane_bytes, 4096 * 4096 * 2)
        kernels_out.append(dict(
            name="median_select", route="cuda",
            source="wavelets_tpu_torch/csrc/median_select.cu",
            replaces="wavelets_tpu/ops/pallas_stats.py:129",
            launches=launches.get("median_select", 0),
            main_path_launches=main_launches.get("median_select", 0),
            max_abs_err=err_b,
            ms=med_k, plain_ms=med_p, bound_ms=b_b[0], bound_by=b_b[1],
            library_ms=med_l, timed="median(|x|) of a 4096² frame",
            ms_512=med[512][0], plain_ms_512=med[512][1],
            library_ms_512=med[512][2], bound_ms_512=med[512][3],
            launches_per_call=b_per_call,
            library="torch.quantile(x.abs(), 0.5) (takes 2^24 elements)"))
        x = frame((4096, 4096))

        # kernel C: one group of 3 scales at 4096², offsets 0 and 3, and
        # the volume path's in-plane pass (one scale, smooth_only, the
        # depth as the batch) at 64×1024²
        c_t = {}
        for off in (0, 3):
            c_t[off] = (
                timed(lambda: hopper_conv.fused_group(x, 3, B3SPLINE, off),
                      torch),
                timed(lambda: hopper_conv.fused_group_plain(
                    x, 3, B3SPLINE, off), torch))
            print(f"  kernel C 4096² g=3 offset {off}: {c_t[off][0]:.3f} ms, "
                  f"plain {c_t[off][1]:.3f} ms")
        xv = frame((64, 1024, 1024))
        c_vol = (timed(lambda: hopper_conv.fused_group(
                     xv, 1, B3SPLINE, 0, smooth_only=True), torch),
                 timed(lambda: hopper_conv.fused_group_plain(
                     xv, 1, B3SPLINE, 0, smooth_only=True), torch))
        print(f"  kernel C 64×1024² one scale smooth_only: {c_vol[0]:.3f} "
              f"ms, plain {c_vol[1]:.3f} ms")
        del xv
        c_k, c_p = c_t[0]
        # read x; write 3 details and the carry
        b_c = bound_ms(5 * plane_bytes, 3 * 4096 * 4096 * (2 * FOLD_OPS + 1))
        kernels_out.append(dict(
            name="decompose_group", route="cuda",
            source="wavelets_tpu_torch/csrc/decompose_group.cu",
            replaces="wavelets_tpu/ops/pallas_conv.py:542",
            launches=launches.get("decompose_group", 0),
            main_path_launches=main_launches.get("decompose_group", 0),
            max_abs_err=err_c,
            ms=c_k, plain_ms=c_p, bound_ms=b_c[0], bound_by=b_c[1],
            library_ms=None, timed="one group, scales 0-2 at 4096²",
            ms_offset3=c_t[3][0], plain_ms_offset3=c_t[3][1],
            ms_volume_pass=c_vol[0], plain_ms_volume_pass=c_vol[1],
            # read the plane, write the carry
            bound_ms_volume_pass=bound_ms(
                2 * 64 * 1024 * 1024 * 4,
                64 * 1024 * 1024 * 2 * FOLD_OPS)[0],
            library="none: PyTorch has no numpy-symmetric pad"))

        # kernel D: the pieces of scales 0-2 at 4096², planes and gamma
        # (one launch), and one deep plane each of s = 3..9 with recon +=
        # (one launch a scale); the first-port reference entry beside them
        cube = hopper_conv.fused_group(x, 3, B3SPLINE)
        args = ((cube[:, None],), torch.ones(3, device=dev),
                torch.full((3,), 0.5, device=dev), B3SPLINE, 3,
                ((0, 0), (0, 1), (0, 2)))
        d_k = timed(lambda: hopper_wow.fused_whiten_pieces(
            *args, write_gamma=True), torch)
        d_r = timed(lambda: hopper_wow.fused_whiten_pieces_ref(
            *args, write_gamma=True), torch)
        d_p = timed(lambda: hopper_wow.fused_whiten_pieces_plain(
            *args, write_gamma=True), torch)
        print(f"  kernel D 4096² pieces, scales 0-2 with gamma: {d_k:.3f} ms, "
              f"first-port reference {d_r:.3f} ms, plain {d_p:.3f} ms")
        del cube, args
        # a frame stack's pieces, 4×4096², scale-major and batch-major
        cube4 = hopper_conv.fused_group(frame((4096, 4096), b=4), 3,
                                        B3SPLINE)
        args4 = ((cube4,), torch.ones(3, device=dev),
                 torch.full((3,), 0.5, device=dev), B3SPLINE, 3,
                 ((0, 0), (0, 1), (0, 2)))
        out4 = torch.empty((4, 7, 4096, 4096), device=dev)
        d_bm = timed(lambda: hopper_wow.fused_whiten_pieces(
            *args4, batch_major=True, out_rows_total=7, out=out4), torch)
        d_sm = timed(lambda: hopper_wow.fused_whiten_pieces(*args4), torch)
        d_bp = timed(lambda: hopper_wow.fused_whiten_pieces_plain(
            *args4, batch_major=True, out_rows_total=7, out=out4), torch)
        print(f"  kernel D 4×4096² pieces, scales 0-2: batch-major "
              f"{d_bm:.3f} ms, scale-major {d_sm:.3f} ms, plain "
              f"{d_bp:.3f} ms")
        del cube4, args4, out4
        xd = frame((4096, 4096), b=1)
        rd = torch.zeros_like(xd)
        one1 = torch.ones(1, device=dev)
        dp_k, dp_r, dp_p = {}, {}, {}
        for s in range(3, 10):
            kw = dict(sf=B3SPLINE, scale=s, weight=one1, masked=True)
            dp_k[s] = timed(lambda: hopper_deep.deep_whiten_plane(
                xd, thr1, recon=rd, **kw), torch)
            dp_r[s] = timed(lambda: hopper_deep.deep_whiten_plane_ref(
                xd, thr1, recon=rd, **kw), torch)
            dp_p[s] = timed(lambda: hopper_deep.deep_whiten_plane_plain(
                xd, thr1, recon=rd, **kw), torch)
            print(f"  kernel D 4096² plane s={s} with recon +=: "
                  f"{dp_k[s]:.3f} ms, first-port reference {dp_r[s]:.3f} "
                  f"ms, plain {dp_p[s]:.3f} ms")
        del xd, rd
        # pieces: read 3 planes; write 3 whites, recon, gamma
        b_d = bound_ms(8 * plane_bytes, 3 * 4096 * 4096 * (FOLD_OPS * 2 + 12))
        # a deep plane: read it and recon; write the white and recon
        b_dp = bound_ms(4 * plane_bytes, 4096 * 4096 * (FOLD_OPS * 2 + 12))
        kernels_out.append(dict(
            name="whiten_plane", route="cuda",
            source="wavelets_tpu_torch/csrc/whiten_plane.cu",
            replaces="wavelets_tpu/ops/pallas_wow.py:300",
            also_replaces="wavelets_tpu/ops/pallas_deep.py:1161",
            launches=launches.get("whiten_plane", 0),
            main_path_launches=main_launches.get("whiten_plane", 0),
            max_abs_err=err_d,
            ms=d_k, plain_ms=d_p, bound_ms=b_d[0], bound_by=b_d[1],
            library_ms=None, reference_ms=d_r,
            timed="fused_whiten_pieces, scales 0-2 at 4096², gamma on",
            deep_plane_per_scale_ms=dp_k,
            deep_plane_reference_per_scale_ms=dp_r,
            deep_plane_plain_per_scale_ms=dp_p,
            deep_plane_bound_ms=b_dp[0], deep_plane_bound_by=b_dp[1],
            batch_major_max_abs_err=err_bm,
            batch_major_4x4096_ms=d_bm, scale_major_4x4096_ms=d_sm,
            batch_major_plain_4x4096_ms=d_bp,
            # read 3 planes, write 3 whites and recon, 4 frames
            batch_major_bound_ms=bound_ms(
                4 * 7 * plane_bytes,
                4 * 3 * 4096 * 4096 * (FOLD_OPS * 2 + 12))[0],
            library="none: PyTorch has no numpy-symmetric pad"))

        # kernel E: the pairs against their plain versions and against two
        # kernel A steps
        pair_ab = {}
        for shape, s in (((4096, 4096), 7), ((512, 512), 4)):
            xb = frame(shape, b=1)
            rb = torch.zeros_like(xb)
            thr2 = torch.full((2, 1), 0.5, device=dev)
            kw = dict(sf=B3SPLINE, scale=s, weights=(1.0, 1.0), soft=True,
                      masked=(True, False))
            e_k = timed(lambda: hopper_deep.deep_whiten_step2(xb, rb, thr2,
                                                              **kw), torch)
            e_p = timed(lambda: hopper_deep.deep_whiten_step2_plain(
                xb, rb, thr2, **kw), torch)

            def two_steps():
                _, _, mid = hopper_deep.deep_whiten_step(
                    xb, rb, thr2[0], sf=B3SPLINE, scale=s, weight=1.0,
                    masked=True)
                hopper_deep.deep_whiten_step(mid, rb, thr2[1], sf=B3SPLINE,
                                             scale=s + 1, weight=1.0)

            e_a = timed(two_steps, torch)
            pair_ab[f"{shape[0]}² ({s}, {s + 1})"] = (e_k, e_a, e_p)
            print(f"  kernel E {shape[0]}² ({s}, {s + 1}): {e_k:.3f} ms, "
                  f"two kernel A steps {e_a:.3f} ms, plain {e_p:.3f} ms")
        e_k, _, e_p = pair_ab["4096² (7, 8)"]
        # read carry and recon; write two whites, c_next2, recon
        b_e = bound_ms(6 * plane_bytes, 2 * 4096 * 4096 * (4 * FOLD_OPS + 8))
        kernels_out.append(dict(
            name="whiten_pair", route="cuda",
            source="wavelets_tpu_torch/csrc/whiten_pair.cu",
            replaces="wavelets_tpu/ops/pallas_deep.py:929",
            launches=launches.get("whiten_pair", 0),
            main_path_launches=main_launches.get("whiten_pair", 0),
            max_abs_err=err_e["white"], carry_max_abs_err=err_e["carry"],
            ms=e_k, plain_ms=e_p, bound_ms=b_e[0], bound_by=b_e[1],
            library_ms=None, timed="the pair (7, 8) at 4096²",
            two_kernel_a_steps_ms={k: v[1] for k, v in pair_ab.items()},
            pair_ms={k: v[0] for k, v in pair_ab.items()},
            library="none: PyTorch has no numpy-symmetric pad"))

        # kernel F: one bilateral group of 3 scales at 4096²
        xf = bil_frame((4096, 4096))
        f_t = {}
        for off in (0, 3):
            f_t[off] = (
                timed(lambda: hopper_bilateral.fused_bilateral_group(
                    xf, 3, B3SPLINE, (1.0,) * 3, off), torch),
                timed(lambda: hopper_bilateral.fused_bilateral_group_plain(
                    xf, 3, B3SPLINE, (1.0,) * 3, off), torch))
            print(f"  kernel F 4096² g=3 offset {off}: {f_t[off][0]:.3f} ms, "
                  f"plain {f_t[off][1]:.3f} ms")
        f_k, f_p = f_t[0]
        # read x; write 3 details and the carry
        b_f = bound_ms(5 * plane_bytes, 3 * 4096 * 4096 * BIL_OPS)
        px3 = 3 * 4096 * 4096
        print(f"  kernel F computed floors, not measured: instruction "
              f"issue {px3 * BIL_OPS / PEAK_F32_INSTR * 1e3:.3f} ms, "
              f"special-function pipe {px3 * BIL_TAPS / PEAK_SFU * 1e3:.3f}"
              " ms a group of 3 at 4096²")
        kernels_out.append(dict(
            name="bilateral_group", route="cuda",
            source="wavelets_tpu_torch/csrc/bilateral_group.cu",
            replaces="wavelets_tpu/ops/pallas_bilateral.py:341",
            launches=launches.get("bilateral_group", 0),
            main_path_launches=main_launches.get("bilateral_group", 0),
            max_abs_err=err_f,
            ms=f_k, plain_ms=f_p, bound_ms=b_f[0], bound_by=b_f[1],
            library_ms=None, timed="one group, scales 0-2 at 4096², σ_b 1",
            ms_offset3=f_t[3][0], plain_ms_offset3=f_t[3][1],
            ops_per_pixel_scale=BIL_OPS, expf_ops=EXPF_OPS,
            library="none: PyTorch has no bilateral filter"))

        # kernel G: one step per scale, 3-9 at 4096² (B1's tail)
        xg = bil_frame((4096, 4096), b=1)
        rg = torch.zeros_like(xg)
        g_k = g_p = 0.0
        g_scale = {}
        for s in range(3, 10):
            kw = dict(sf=B3SPLINE, scale=s, var_factor=1.0, weight=1.0,
                      soft=True, masked=False)
            tk = timed(lambda: hopper_deep.deep_bilateral_whiten_step(
                xg, zero1, recon=rg, **kw), torch)
            tp = timed(lambda: hopper_deep.deep_bilateral_whiten_step_plain(
                xg, zero1, recon=rg, **kw), torch)
            g_k += tk
            g_p += tp
            g_scale[s] = tk
            print(f"  kernel G 4096² s={s}: {tk:.3f} ms, plain {tp:.3f} ms")
        # per step: read carry and recon; write white, c_next, recon
        b_g = bound_ms(7 * 5 * plane_bytes,
                       7 * 4096 * 4096 * (BIL_OPS + BIL_WHITEN_OPS))
        kernels_out.append(dict(
            name="bilateral_step", route="cuda",
            source="wavelets_tpu_torch/csrc/bilateral_step.cu",
            replaces="wavelets_tpu/ops/pallas_deep.py:1455",
            launches=launches.get("bilateral_step", 0),
            main_path_launches=main_launches.get("bilateral_step", 0),
            max_abs_err=err_g["white"], carry_max_abs_err=err_g["carry"],
            ms=g_k, plain_ms=g_p, bound_ms=b_g[0], bound_by=b_g[1],
            library_ms=None, timed="scales 3-9 at 4096², one step each",
            per_scale_ms=g_scale,
            ops_per_pixel_scale=BIL_OPS + BIL_WHITEN_OPS, expf_ops=EXPF_OPS,
            library="none: PyTorch has no bilateral filter"))
        del xf, xg, rg

    # the bfloat16 forms of kernels A and E (bounds from their arguments:
    # the frame and whites 2 bytes, the carries and recon 4)
    with Phase("timings: bfloat16 kernels"):
        n = 4096 * 4096
        xb = bf16_frame((4096, 4096))
        thr4 = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev)
        gkw = dict(masked=(True, True, True, False))
        g_k = {c: timed(lambda: hopper_conv.fused_wow_group(
            xb, [1.0] * 4, thr4, 4, B3SPLINE, need_cube=c, **gkw), torch)
            for c in (True, False)}
        g_p = timed(lambda: hopper_conv.fused_wow_group_plain(
            xb, [1.0] * 4, thr4, 4, B3SPLINE, **gkw), torch)
        b_g = bound_ms(group_bytes(n, 4, True, 2), 4 * n * WHITEN_SCALE_OPS)
        print(f"  bf16 group 4096² g=4: {g_k[True]:.3f} ms, need_cube off "
              f"{g_k[False]:.3f} ms, plain {g_p:.3f} ms, bound "
              f"{b_g[0]:.3f} ({b_g[1]})")
        # the streamed group's own work, from its plan: the folds it
        # computes (the strip's margins and each band's warm-up included)
        # and the whitening epilogue, one float32 instruction an operation
        sp = hopper_conv.stream_plan(1, 4096, 4096, 4, 2, 0)
        hd_, ec_, ecar_ = hopper_conv.stream_margins(4, 2, 0)
        width = sum(4 * sp.strip_w + 2 * (ecar_[k] + ec_[k] + hd_[k]
                                          + hd_[k] % 2) for k in range(4))
        rows = sum(8 * -(-(min(sp.band_h, 4096 - h0) + 2 * sp.halo) // 8)
                   for h0 in range(0, 4096, sp.band_h))
        folds = sp.grid[0] * rows * width / n
        print(f"  bf16 group computed floor, not measured: instruction issue "
              f"{n * (folds * FOLD_OPS + 4 * 8) / PEAK_F32_INSTR * 1e3:.3f} "
              f"ms at 4096² g=4 ({folds:.1f} folds an output pixel on "
              f"{sp.strip_w}-column strips and {sp.band_h}-row bands)")
        kernels_out.append(dict(
            name="whiten_group_bf16", route="cuda",
            source="wavelets_tpu_torch/csrc/whiten_group.cu",
            replaces="wavelets_tpu/ops/pallas_conv.py:607",
            launches=launches.get("whiten_group_bf16", 0),
            main_path_launches={k: v.get("whiten_group_bf16", 0)
                                for k, v in lowp_main.items()},
            max_abs_err=err_lp["whiten_group_bf16"], ms=g_k[True],
            plain_ms=g_p, bound_ms=b_g[0],
            bound_by=b_g[1], library_ms=None, ms_need_cube_off=g_k[False],
            bound_ms_need_cube_off=bound_ms(group_bytes(n, 4, False, 2),
                                            4 * n * WHITEN_SCALE_OPS)[0],
            checks=n_lp["whiten_group_bf16"],
            timed="one bfloat16 group, scales 0-3 at 4096², need_cube on",
            library="none: PyTorch has no numpy-symmetric pad or dilated "
                    "smooth in one call"))
        # the route's steps and pair: float32 carries and recon,
        # bfloat16 whites
        xs = xb[None].float()
        rb = torch.zeros_like(xs)
        thr1 = torch.tensor([1.0], device=dev)
        s_k, s_p, per = 0.0, 0.0, {}
        for s_ in range(4, 10):
            kw = dict(sf=B3SPLINE, scale=s_, weight=1.0, soft=True,
                      masked=s_ < 6, white_dtype=torch.bfloat16)
            per[s_] = timed(lambda: hopper_deep.deep_whiten_step(
                xs, rb, thr1, **kw), torch)
            s_k += per[s_]
            s_p += timed(lambda: hopper_deep.deep_whiten_step_plain(
                xs, rb, thr1, **kw), torch, n=5)
        b_s = bound_ms(6 * step_bytes(n, itemsize=2), 6 * n * WHITEN_SCALE_OPS)
        print(f"  bf16 steps 4096² s=4..9: {s_k:.3f} ms ("
              + ", ".join(f"{v:.3f}" for v in per.values())
              + f"), plain {s_p:.3f} ms, bound {b_s[0]:.3f} ({b_s[1]})")
        kernels_out.append(dict(
            name="whiten_step_bf16", route="cuda",
            source="wavelets_tpu_torch/csrc/whiten_step.cu",
            replaces="wavelets_tpu/ops/pallas_deep.py:311 (the stream's "
                     "bfloat16 form; deep_whiten_step :514)",
            launches=launches.get("whiten_step_bf16", 0),
            main_path_launches={k: v.get("whiten_step_bf16", 0)
                                for k, v in lowp_main.items()},
            max_abs_err=err_lp["whiten_step_bf16"], ms=s_k, plain_ms=s_p,
            bound_ms=b_s[0],
            bound_by=b_s[1], library_ms=None, per_scale_ms=per,
            checks=n_lp["whiten_step_bf16"],
            timed="bfloat16 scales 4-9 at 4096², one step each, recon +=",
            library="none: PyTorch has no numpy-symmetric pad or dilated "
                    "smooth in one call"))
        thr2 = torch.tensor([[1.0], [0.0]], device=dev)
        pkw = dict(sf=B3SPLINE, scale=7, weights=(1.0, 1.0), soft=True,
                   masked=(True, False), white_dtype=torch.bfloat16)
        p_k = timed(lambda: hopper_deep.deep_whiten_step2(xs, rb, thr2,
                                                          **pkw), torch)
        p_p = timed(lambda: hopper_deep.deep_whiten_step2_plain(
            xs, rb, thr2, **pkw), torch, n=5)
        b_p = bound_ms(pair_bytes(n, itemsize=2), 2 * n * WHITEN_SCALE_OPS)
        p_s = timed(lambda: bf16_two_steps(xs, rb, thr2, **pkw), torch)
        print(f"  bf16 pair (7, 8) 4096²: {p_k:.3f} ms, plain {p_p:.3f} "
              f"ms, bound {b_p[0]:.3f} ({b_p[1]}); the split pair (two "
              f"launches of kernel A's stream) {p_s:.3f} ms")
        kernels_out.append(dict(
            name="whiten_pair_bf16", route="cuda",
            source="wavelets_tpu_torch/csrc/whiten_pair.cu",
            replaces="wavelets_tpu/ops/pallas_deep.py:929",
            launches=launches.get("whiten_pair_bf16", 0),
            main_path_launches={k: v.get("whiten_pair_bf16", 0)
                                for k, v in lowp_main.items()},
            max_abs_err=err_lp["whiten_pair_bf16"], ms=p_k, plain_ms=p_p,
            bound_ms=b_p[0],
            bound_by=b_p[1], library_ms=None,
            checks=n_lp["whiten_pair_bf16"],
            timed="the bfloat16 pair (7, 8) at 4096², recon +=",
            library="none: PyTorch has no numpy-symmetric pad"))
        del xb, xs, rb

    # ---- 6. where the time goes ----------------------------------------
    with Phase("profile"):
        from torch.profiler import ProfilerActivity, profile

        routes = {what: wt_run for what, (wt_run, _) in paths.items()}
        for what, (x, kw, _, _) in configs.items():
            routes[what] = lambda x=x, kw=kw: wt.wow(x, **kw)
        for what, run in routes.items():
            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    run()
                torch.cuda.synchronize()
            kern = [e for e in prof.key_averages() if device_kernel(e)]
            busy = sum(e.self_device_time_total for e in kern) / 5e3
            wall = e2e[what][0]
            top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
            print(f"  {what}: busy {busy:.3f} ms of {wall:.3f} ms, idle "
                  f"share {1 - busy / wall:.3f}; top: " + ", ".join(
                      f"{e.key[:40]} {e.self_device_time_total / 5e3:.3f}"
                      f" (x{e.count // 5})" for e in top))

    dist.destroy_process_group()
    tmp_dir.cleanup()
    require(not raw.exists(), "S5's frame file was not deleted")

    summary = {
        "card": card,
        "build_s": build_s,
        "path_ms": {k: {"kernels": v[0], "plain": v[1]}
                    for k, v in e2e.items()},
        "stack_fps": fps_out,
        "richardson_lucy": rl_out,
        "low_precision": lowp_out,
        "sharded": sharded_out,
        "kernels": kernels_out,
    }
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
