"""Run one cell of the benchmark of wavelets_tpu_torch once, on the card.

    python3 benchmark/run.py --workload aia_wow.frame --seed 7 --seconds 10 --trace 0

Earlier lines of standard output hold progress, the kernels' build log and
the set-up's parts; the last line is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` (and
``breakdown`` with ``--trace 1``), and last ``checks``, each number
compared with its limit.  The same numbers are the last lines of standard
error.  Without a CUDA card, with fewer cards than the cell asks for, or
with JAX or the JAX package loaded once the window has closed, the run
prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's build caches stay inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / var.lower())
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    t_torch = time.perf_counter() - T_START
    from benchmark import harness

    spec = harness.load_spec()
    chips = next((int(w["chips"]) for w in spec["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(2)

    def log(msg):
        print(msg, flush=True)

    # a checkout without the port fails here, before any line is printed
    harness.import_port()
    log(f"setup: torch imported {t_torch:.3f} s after start")

    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START,
                              device="cuda:0", spec=spec, log=log)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for c in result["checks"].values():
        # a NaN reading fails its check; JSON has no NaN
        if c["value"] != c["value"]:
            c["value"] = None
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
