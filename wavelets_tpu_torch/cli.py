"""Command-line interface.

Counterpart of ``wavelets_tpu/cli.py`` with its arguments plus
``--device`` (the card by default).  Examples::

    # enhance a raw uint16 frame stack (whiten + denoise), write f32 raw
    python -m wavelets_tpu_torch wow in.raw out.raw --frames 100 \\
        --shape 4096 4096 --dtype uint16 --denoise 5 2 --batch 4

    # decompose one f32 frame and save the coefficient cube
    python -m wavelets_tpu_torch decompose in.raw coeffs.npz \\
        --shape 2048 2048 --dtype float32 --level 6

    # Richardson-Lucy deconvolve each frame of a stack, write f32 raw
    python -m wavelets_tpu_torch rl in.raw out.raw --frames 4 \\
        --shape 1024 1024 --dtype uint16 --psf psf.npy --iterations 10

``bench`` parses its arguments, then raises ``NotImplementedError``: the
benchmark is not ported yet.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _add_stack_args(p):
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--shape", type=int, nargs=2, required=True,
                   metavar=("H", "W"))
    p.add_argument("--dtype", default="float32")
    p.add_argument("--offset", type=int, default=0,
                   help="header bytes to skip")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")


def _parser():
    ap = argparse.ArgumentParser(
        prog="wavelets_tpu_torch",
        description="à trous wavelet engine in PyTorch for NVIDIA Hopper")
    sub = ap.add_subparsers(dest="cmd", required=True)

    w = sub.add_parser("wow", help="WOW-enhance a frame stack")
    _add_stack_args(w)
    w.add_argument("--frames", type=int, required=True)
    w.add_argument("--batch", type=int, default=4)
    w.add_argument("--n-scales", type=int, default=None)
    w.add_argument("--denoise", type=float, nargs="*", default=[])
    w.add_argument("--weights", type=float, nargs="*", default=[])
    w.add_argument("--bilateral", type=float, default=None)
    w.add_argument("--hard", action="store_true",
                   help="hard thresholding instead of erf soft masks")
    w.add_argument("--gamma-blend", type=float, default=0.0,
                   metavar="H", help="gamma blend weight h")
    w.add_argument("--scaling-function", default="b3spline",
                   choices=["b3spline", "triangle"])

    d = sub.add_parser("decompose", help="decompose one frame to npz")
    _add_stack_args(d)
    d.add_argument("--level", type=int, required=True)
    d.add_argument("--frame", type=int, default=0)
    d.add_argument("--frames", type=int, default=1)

    dn = sub.add_parser("denoise", help="wavelet-denoise a frame stack")
    _add_stack_args(dn)
    dn.add_argument("--frames", type=int, required=True)
    dn.add_argument("--weights", type=float, nargs="+", required=True,
                    metavar="SIGMA",
                    help="per-scale significance thresholds, e.g. 5 3")
    dn.add_argument("--hard", action="store_true")
    dn.add_argument("--anscombe", action="store_true",
                    help="variance-stabilize Poisson-like data first")
    dn.add_argument("--bilateral", type=float, default=None)
    dn.add_argument("--scaling-function", default="b3spline",
                    choices=["b3spline", "triangle"])

    rl = sub.add_parser(
        "rl", help="Richardson-Lucy deconvolve a frame stack")
    _add_stack_args(rl)
    rl.add_argument("--frames", type=int, required=True)
    rl.add_argument("--psf", required=True,
                    help="PSF as .npy (2-D, any float dtype)")
    rl.add_argument("--iterations", type=int, default=10)
    rl.add_argument("--denoise", type=float, nargs="*", default=[5, 2, 1])
    rl.add_argument("--hard", action="store_true")
    rl.add_argument("--fft", action="store_true")
    rl.add_argument("--uniform-init", action="store_true")

    sub.add_parser("bench", help="run the headline benchmark (not ported)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    from .models.wow import _not_ported

    if args.cmd == "bench":
        raise _not_ported("the bench command", "A1, the benchmark")

    from .api import B3spline, Triangle

    sf = {"b3spline": B3spline, "triangle": Triangle}[
        getattr(args, "scaling_function", "b3spline")]

    if args.cmd == "wow":
        from .models.pipeline import process_stack

        n, dt, fps = process_stack(
            args.input, args.output, args.frames, tuple(args.shape),
            dtype=args.dtype, offset=args.offset, batch=args.batch,
            progress=True, device=args.device,
            scaling_function=sf,
            n_scales=args.n_scales,
            denoise_coefficients=list(args.denoise),
            weights=list(args.weights),
            bilateral=args.bilateral,
            soft_threshold=not args.hard,
            h=args.gamma_blend,
        )
        print(f"processed {n} frames in {dt:.2f}s = {fps:.2f} frames/s")
        return 0

    from .utils.frameio import FrameStack

    if args.cmd == "decompose":
        from .api import AtrousTransform
        from .utils.io import save_coefficients

        with FrameStack(args.input, args.frames, tuple(args.shape),
                        dtype=args.dtype, offset=args.offset) as fs:
            img = fs[args.frame]
        coeffs = AtrousTransform()(img, args.level, device=args.device)
        save_coefficients(args.output, coeffs)
        print(f"saved {len(coeffs)} planes to {args.output}")
        return 0

    if args.cmd == "denoise":
        from .models.denoise import denoise

        with FrameStack(args.input, args.frames, tuple(args.shape),
                        dtype=args.dtype, offset=args.offset) as fs, \
                open(args.output, "wb") as out_f:
            for k in range(args.frames):
                out = denoise(fs[k].astype(np.float32), list(args.weights),
                              scaling_function=sf, bilateral=args.bilateral,
                              soft_threshold=not args.hard,
                              anscombe=args.anscombe, device=args.device)
                out.cpu().numpy().astype(np.float32).tofile(out_f)
        print(f"denoised {args.frames} frames -> {args.output}")
        return 0

    if args.cmd == "rl":
        from .models.richardson_lucy import richardson_lucy

        psf = np.load(args.psf).astype(np.float32)
        with FrameStack(args.input, args.frames, tuple(args.shape),
                        dtype=args.dtype, offset=args.offset) as fs, \
                open(args.output, "wb") as out_f:
            for k in range(args.frames):
                out = richardson_lucy(
                    fs[k].astype(np.float32), psf,
                    iterations=args.iterations,
                    denoise_coefficients=tuple(args.denoise),
                    threshold_type="hard" if args.hard else "soft",
                    uniform_init=args.uniform_init, fft=args.fft,
                    device=args.device)
                out.cpu().numpy().astype(np.float32).tofile(out_f)
        print(f"deconvolved {args.frames} frames -> {args.output}")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
