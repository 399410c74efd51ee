#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100 / sm_90a).

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and the
CUDA toolkit.  It

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. builds the hand-written kernels from ``wavelets_tpu_torch/csrc`` into
   ``build/kernels`` and prints the build seconds;
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (kernel A: 4096² at s ∈ {0, 3, 6, 9}, masked soft,
   masked hard and unmasked, plus 1000×1536 and 257×513, where s = 9
   reflects more than once; kernel B: even
   and odd n and heavy ties, bitwise, and bitwise to ``np.median``);
4. drives the main path, ``wow`` on a 4096² float32 frame (auto 10
   scales, denoise [5, 2], lazy MAD noise) and the 512² L6 entry
   configuration, with the launch counters reset just before and read
   just after: every kernel must have launched, no plain version may
   have run, and the outputs must be finite, on the card, and agree with
   ``fuse=False`` on the same tensors and with the float64 CPU path on a
   small frame;
5. times both paths and each kernel against its plain version with CUDA
   events (median of 20 runs after warm-up).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero before that line.  It imports nothing of JAX.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: carry (c_next): the folds round step by step in both versions, so
#: bitwise is expected; allowed: 1 unit in the last place of its magnitude
CARRY_ULPS = 1
#: whitened planes / acc / recon: erff against torch.erf (a last-place
#: difference in the mask), the standard of the JAX package's kernels
WHITE_RTOL = 5e-6
N_TIMED = 20
N_WARM = 3


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def max_err(got, ref):
    return float((got.double() - ref.double()).abs().max())


def check_white(got, ref, what, scale=None):
    if scale is None:
        scale = float(ref.abs().max())
    err = max_err(got, ref)
    require(err <= WHITE_RTOL * max(scale, 1.0),
            f"{what}: max abs err {err} > {WHITE_RTOL} * {scale}")
    return err


def check_carry(got, ref, what):
    err = max_err(got, ref)
    ulp = float(np.spacing(np.float32(float(ref.abs().max()))))
    require(err <= CARRY_ULPS * ulp, f"{what}: carry err {err} > {ulp}")
    return err


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
    from wavelets_tpu_torch import wow
    from wavelets_tpu_torch.ops import _build, hopper_conv, hopper_deep
    from wavelets_tpu_torch.ops import hopper_stats
    from wavelets_tpu_torch.ops.filters import B3SPLINE

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

    def frame(shape, b=None):
        size = shape if b is None else (b,) + shape
        x = rng.normal(size=size).astype(np.float32) * 3 + 10
        return torch.from_numpy(x).to(dev)

    # ---- 3a. kernel A against its plain version ------------------------
    errs_a = {"white": 0.0, "carry": 0.0}
    n_checks = 0
    for shape, scales in [((4096, 4096), (0, 3, 6, 9)),
                          ((1000, 1536), (0, 3, 6, 9)),
                          ((257, 513), (0, 3, 6, 9))]:
        x = frame(shape, b=1)
        recon = frame(shape, b=1)
        for s in scales:
            thr = torch.tensor([3.0 * 3.0 * float(sig[s])], device=dev)
            for mode in ("soft", "hard", "unmasked"):
                kw = dict(sf=B3SPLINE, scale=s, weight=1.5,
                          soft=mode == "soft", masked=mode != "unmasked")
                r_k, r_p = recon.clone(), recon.clone()
                w_k, _, c_k = hopper_deep.deep_whiten_step(x, r_k, thr, **kw)
                w_p, _, c_p = hopper_deep.deep_whiten_step_plain(
                    x, r_p, thr, **kw)
                torch.cuda.synchronize()
                what = f"kernel A {shape} s={s} {mode}"
                e_w = check_white(w_k, w_p, what)
                check_white(r_k, r_p, what + " recon")
                e_c = check_carry(c_k, c_p, what)
                if shape == (4096, 4096):
                    errs_a["white"] = max(errs_a["white"], e_w)
                    errs_a["carry"] = max(errs_a["carry"], e_c)
                n_checks += 1
        del x, recon
    x = frame((4096, 4096))
    thr3 = torch.tensor([9.0 * float(sig[k]) for k in range(3)], device=dev)
    for need_cube in (True, False):
        args = ([1.0, 2.0, 0.5], thr3, 3, B3SPLINE)
        kw = dict(offset=0, soft=True, masked=(True, True, False),
                  need_cube=need_cube)
        rows_k, acc_k = hopper_conv.fused_wow_group(x, *args, **kw)
        rows_p, acc_p = hopper_conv.fused_wow_group_plain(x, *args, **kw)
        torch.cuda.synchronize()
        require(len(rows_k) == len(rows_p), "group row count")
        for a, b in zip(rows_k[:-1], rows_p[:-1]):
            errs_a["white"] = max(errs_a["white"],
                                  check_white(a, b, "group plane"))
        errs_a["carry"] = max(errs_a["carry"],
                              check_carry(rows_k[-1], rows_p[-1], "group"))
        check_white(acc_k, acc_p, "group acc")
        n_checks += 1
    print(f"kernel A: {n_checks} checks passed; 4096² max abs err "
          f"white {errs_a['white']:.3e} carry {errs_a['carry']:.3e}")

    # ---- 3b. kernel B: bitwise ------------------------------------------
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
        plain = hopper_stats.median_abs(xt, hopper_stats.median_bits2_plain)
        want = np.median(np.abs(host))
        got_h, plain_h = got.cpu().numpy(), plain.cpu().numpy()
        require(got_h.tobytes() == plain_h.tobytes() == want.tobytes(),
                f"kernel B {what}: {got_h!r} plain {plain_h!r} "
                f"np.median {want!r}")
        err_b = max(err_b, abs(float(got_h) - float(want)))
        print(f"kernel B {what}: {float(got_h)!r} bitwise == plain == "
              "np.median")

    # ---- 4. the main path ---------------------------------------------
    configs = {
        "4096² L10 (auto), denoise [5, 2], lazy noise":
            (frame((4096, 4096)), dict(denoise_coefficients=[5, 2]), 10),
        "512² L6, denoise [5, 2], lazy noise":
            (frame((512, 512)), dict(n_scales=6,
                                     denoise_coefficients=[5, 2]), 6),
    }
    launches = {}
    for what, (x, kw, n_scales) in configs.items():
        torch.cuda.synchronize()
        _build.reset_counters()
        recon, coeffs = wow(x, **kw)
        torch.cuda.synchronize()
        run_launches = dict(_build.LAUNCHES)
        run_plain = dict(_build.PLAIN_CALLS)
        for name, n in run_launches.items():
            launches[name] = launches.get(name, 0) + n
        print(f"main path {what}: launches {run_launches} "
              f"plain calls {run_plain}")
        require(run_launches.get("whiten_step", 0) >= n_scales,
                f"kernel A launched {run_launches.get('whiten_step', 0)} "
                f"times for {n_scales} scales")
        require(run_launches.get("median_select", 0) >= 1,
                "kernel B did not launch")
        require(not run_plain, f"plain versions ran: {run_plain}")
        require(len(coeffs) == n_scales + 1, "plane count")
        require(recon.is_cuda and recon.shape == x.shape
                and recon.dtype == torch.float32, "recon placement")
        require(bool(torch.isfinite(recon).all()), "recon not finite")
        for k in range(len(coeffs)):
            require(coeffs[k].is_cuda and bool(torch.isfinite(coeffs[k]).all()),
                    f"plane {k} not finite on the card")
        r_p, c_p = wow(x, fuse=False, **kw)
        torch.cuda.synchronize()
        scale = float(r_p.abs().max())
        e_r = check_white(recon, r_p, what + " recon vs fuse=False")
        e_p = max(check_white(coeffs[k], c_p[k], f"{what} plane {k}", scale)
                  for k in range(len(coeffs)))
        print(f"  vs fuse=False on the card: recon max abs err {e_r:.3e}, "
              f"planes {e_p:.3e} (scale {scale:.4g})")

    # a small frame against the float64 path on the CPU
    small = rng.normal(size=(256, 256)) * 3 + 10
    r_gpu, c_gpu = wow(torch.from_numpy(small.astype(np.float32)).to(dev),
                       denoise_coefficients=[5, 2])
    r_ref, c_ref = wow(small, denoise_coefficients=[5, 2])
    scale = float(r_ref.abs().max())
    e_small = check_white(r_gpu.cpu(), r_ref, "256² vs float64 CPU", scale)
    for k in range(len(c_ref)):
        check_white(c_gpu[k].cpu(), c_ref[k], f"256² plane {k} vs CPU",
                    scale)
    print(f"256² kernel path vs float64 CPU path: recon max abs err "
          f"{e_small:.3e} (scale {scale:.4g})")

    # ---- 5. timings -----------------------------------------------------
    print(f"timings on {card}: median of {N_TIMED} runs, CUDA events")
    e2e = {}
    for what, (x, kw, _) in configs.items():
        t_k = timed(lambda: wow(x, **kw), torch)
        t_p = timed(lambda: wow(x, fuse=False, **kw), torch)
        e2e[what] = (t_k, t_p)
        print(f"  wow {what}: kernels {t_k:.3f} ms, plain {t_p:.3f} ms")
    x = frame((4096, 4096), b=1)
    recon = torch.zeros_like(x)
    zero = torch.zeros(1, device=dev)
    thr = torch.tensor([1.0], device=dev)
    step_k = step_p = 0.0
    for s in range(10):
        kw = dict(sf=B3SPLINE, scale=s, weight=1.0, soft=True,
                  masked=s < 2)
        t = thr if s < 2 else zero
        tk = timed(lambda: hopper_deep.deep_whiten_step(x, recon, t, **kw),
                   torch)
        tp = timed(lambda: hopper_deep.deep_whiten_step_plain(x, recon, t,
                                                              **kw), torch)
        step_k += tk
        step_p += tp
        print(f"  kernel A 4096² s={s}: {tk:.3f} ms, plain {tp:.3f} ms")
    x = frame((4096, 4096))
    med_k = timed(lambda: hopper_stats.median_abs(x), torch)
    med_p = timed(lambda: hopper_stats.median_abs(
        x, hopper_stats.median_bits2_plain), torch)
    print(f"  kernel B 4096²: {med_k:.3f} ms, plain {med_p:.3f} ms")

    summary = {
        "card": card,
        "build_s": build_s,
        "wow_ms": {k: {"kernels": v[0], "plain": v[1]}
                   for k, v in e2e.items()},
        "kernels": [
            {"name": "whiten_step", "route": "cuda",
             "source": "wavelets_tpu_torch/csrc/whiten_step.cu",
             "replaces": "wavelets_tpu/ops/pallas_conv.py:607",
             "also_replaces": "wavelets_tpu/ops/pallas_deep.py:514",
             "launches": launches.get("whiten_step", 0),
             "max_abs_err": errs_a["white"],
             "carry_max_abs_err": errs_a["carry"],
             "ms": step_k, "plain_ms": step_p,
             "timed": "scales 0-9 at 4096², one step each"},
            {"name": "median_select", "route": "cuda",
             "source": "wavelets_tpu_torch/csrc/median_select.cu",
             "replaces": "wavelets_tpu/ops/pallas_stats.py:129",
             "launches": launches.get("median_select", 0),
             "max_abs_err": err_b,
             "ms": med_k, "plain_ms": med_p,
             "timed": "median(|x|) of a 4096² frame"},
        ],
    }
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
