"""The readings that a cell's correctness limits are set from, on the card.

    python3 benchmark/readings.py --workload aia_wow.frame --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 2

In one process, for each seed of ``--seeds``, one short window of the
cell as the benchmark runs it, and for each of ``--control-seeds`` the
control: the same window with the program's own path in the precision
below the configuration's ``dtype`` switched on, the frames cast before
each call to the type the cell's ``limits/<cell>.json`` names under
``control`` (bfloat16 for float32 frames).  Each window's outputs are checked as a run
checks them; each line prints the numbers compared.  The last line is a
JSON object with the largest program reading and the smallest control
reading of each number.  The benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run as _run  # noqa: E402,F401  (the build cache paths)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    spec = harness.load_spec()
    control = harness.control_dtype(args.workload)
    out = {"workload": args.workload, "program": {}, "control": {}}
    for kind, seeds, cast in (("program", args.seeds, None),
                              ("control", args.control_seeds, control)):
        for seed in (int(s) for s in seeds.split(",") if s):
            r = harness.run_cell(args.workload, seed, args.seconds, False,
                                 t_start=time.perf_counter(), device="cuda:0",
                                 spec=spec, cast=cast, log=lambda m: None)
            readings = {k: v["value"] for k, v in r["checks"].items()}
            fps = r["metrics"].get("frames_per_s", {}).get("value")
            print(f"{kind} seed {seed} correct {r['correct']} "
                  f"frames {r['attempted']} frames_per_s {fps} "
                  + " ".join(f"{k} {v!r}" for k, v in readings.items()),
                  flush=True)
            for k, v in readings.items():
                pick = max if kind == "program" else min
                prev = out[kind].get(k)
                out[kind][k] = v if prev is None else pick(prev, v)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
