#!/usr/bin/env python3
"""Wall time of a few end-to-end paths of ``wavelets_tpu_torch`` on one
NVIDIA GPU, for comparing two checkouts in alternating processes.

    python3 scripts/path_ab.py [--root DIR] [LABEL]

Imports the package from ``DIR`` (default: this checkout), builds its
kernels, and times each path with CUDA events (median of 20 runs after 3
warm-ups) on the frames ``chip_smoke.py`` uses (seed 0): the main path
``wow`` at 4096² (10 scales) and 512² (6 scales) with denoise [5, 2] and
lazy noise, B2 ``AtrousTransform(bilateral=1)(x, 6)`` and B3 bilateral
``denoise(x, [3, 3, 3])`` at 4096² on a zero-mean frame.  Prints the
card's name and power limit, then one JSON line ``{"label": ..., "ms":
{path: ms}}``.  Run parent, change, change, parent, ... in one call and
compare the two sides' spreads.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("path_ab: no CUDA device")
    args = sys.argv[1:]
    root = ROOT
    if args[:1] == ["--root"]:
        root = Path(args[1]).resolve()
        args = args[2:]
    label = args[0] if args else str(root)
    sys.path.insert(0, str(root))
    import wavelets_tpu_torch as wt
    from wavelets_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    _build.build_all()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def frame(shape, mean):
        x = rng.normal(size=shape).astype(np.float32) * 3 + mean
        return torch.from_numpy(x).to(dev)

    x4k, x512, xb = (frame((4096, 4096), 10.0), frame((512, 512), 10.0),
                     frame((4096, 4096), 0.0))
    paths = {
        "wow 4096² L10": lambda: wt.wow(x4k, denoise_coefficients=[5, 2]),
        "wow 512² L6": lambda: wt.wow(x512, n_scales=6,
                                      denoise_coefficients=[5, 2]),
        "B2": lambda: wt.AtrousTransform(bilateral=1)(xb, 6),
        "B3": lambda: wt.denoise(xb, [3, 3, 3], bilateral=1),
    }
    out = {}
    for what, fn in paths.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(20):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        out[what] = float(np.median(ms))
    print(json.dumps({"label": label, "ms": out}))


if __name__ == "__main__":
    main()
