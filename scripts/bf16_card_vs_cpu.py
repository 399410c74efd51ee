#!/usr/bin/env python3
"""How far the bfloat16 merged route of ``wavelets_tpu_torch.wow`` on the
card lies from the same route on the CPU, frame by frame, on one NVIDIA
GPU.

    python3 scripts/bf16_card_vs_cpu.py [FRAMES]

Run from the repository root on a machine with a CUDA device and the
CUDA toolkit.  For each of ``FRAMES`` (default 24) zero-mean 512²
frames (``normal × 3`` from seeds 0, 1, ..., cast to bfloat16, as
``chip_smoke.py`` draws them) and each of the two bfloat16 rows of
``chip_smoke.py`` (``wow_4k_L6_bf16_known_noise``, ``wow_4k_L10_bf16``
cut to 512²), prints the kernels launched, whether the recon with kernel
A's bfloat16 group is bitwise the recon with its plain version on the
card, and the card's recon against the CPU's (kernel and plain group
alike): the max abs difference, the pixels that differ, the recon's max
|value|, the difference in bfloat16 units at that max (``2^(e − 7)`` for
a max in ``[2^e, 2^(e+1))``) and against ``chip_smoke.py``'s limit
``2^-8·max``.  The card's name and power limit are printed first; the
last line sums the frames up.
"""

import math
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

ROWS = {
    "wow_4k_L6_bf16_known_noise": dict(n_scales=6,
                                       denoise_coefficients=[5, 2],
                                       noise=1.0),
    "wow_4k_L10_bf16": dict(n_scales=10, noise=0.0),
}


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bf16_card_vs_cpu: no CUDA device")
    frames = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    sys.path.insert(0, str(ROOT))
    import wavelets_tpu_torch as wt
    from wavelets_tpu_torch.ops import _build, hopper_conv

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    kernel = hopper_conv.fused_wow_group
    summary = {}
    for row, kw in ROWS.items():
        worst, flips, same_all = 0.0, 0, True
        for seed in range(frames):
            x = torch.from_numpy(np.random.default_rng(seed).normal(
                size=(512, 512)).astype(np.float32) * 3).to(torch.bfloat16)
            xc = x.cuda()
            _build.reset_counters()
            k = wt.wow(xc, **kw)[0]
            launched = dict(_build.LAUNCHES)
            hopper_conv.fused_wow_group = hopper_conv.fused_wow_group_plain
            try:
                p = wt.wow(xc, **kw)[0]
            finally:
                hopper_conv.fused_wow_group = kernel
            c = wt.wow(x, device="cpu", **kw)[0].float()
            torch.cuda.synchronize()
            same = torch.equal(k, p)
            e_k = float((k.cpu().float() - c).abs().max())
            e_p = float((p.cpu().float() - c).abs().max())
            n_k = int((k.cpu().float() != c).sum())
            m = float(c.abs().max())
            unit = 2.0 ** (math.floor(math.log2(m)) - 7)
            limit = 2 ** -8 * max(m, 1.0)
            same_all &= same
            flips += n_k
            worst = max(worst, e_k / unit)
            print(f"{row} seed {seed} launches {launched} kernel == plain "
                  f"group on the card: {same} | card vs CPU: kernel {e_k} "
                  f"plain {e_p} pixels {n_k} max {m} = {e_k / unit:g} "
                  f"bf16 units, limit 2^-8·max {limit:.5g}"
                  f"{' EXCEEDED' if e_k > limit else ''}")
        summary[row] = dict(frames=frames, kernel_is_plain=same_all,
                            pixels_differing=flips, worst_units=worst)
    print(summary)


if __name__ == "__main__":
    main()
