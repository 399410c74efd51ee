"""The check that decides ``correct`` fails its control and the faults a
cell can have, at a size a test run holds, on the CPU.

The control is the program's own bfloat16 path (the precision below the
configurations' float32).  The faults are planted in the timed call and
the rest of the run is driven as on the card: a call whose output is its
input unchanged, a stack call that computes half of its frames and gives
the rest their mean, and a recon with one pixel altered where it is
produced (by the recon's largest magnitude); for ``wow``, a NaN in one
whitened plane and the planes left out.  The same runs unbroken come out
correct.
"""

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

CELLS = ["aia_wow.frame", "aia_wow.stack4", "aia_wow_bilateral.frame"]
SIZE = (128, 128)
SEED = 2 ** 35 + 17


def _run(workload, wrap=None, cast=None):
    return harness.run_cell(workload, SEED, 0.2, False,
                            t_start=time.perf_counter(), device="cpu",
                            size=SIZE, wrap=wrap, cast=cast,
                            log=lambda m: None)


def _unchanged(call):
    def broken(x):
        recon, rest = call(x)
        return x.clone(), rest
    return broken


def _half_batch(call):
    def broken(x):
        half = x.shape[0] // 2
        recon, rest = call(x[:half])
        mean = recon.mean(dim=0, keepdim=True).expand(x.shape[0] - half,
                                                      *recon.shape[1:])
        return torch.cat([recon, mean]), rest
    return broken


def _altered(call):
    def broken(x):
        recon, rest = call(x)
        recon = recon.clone()
        recon[..., SIZE[0] // 2, SIZE[1] // 2] += recon.abs().max()
        return recon, rest
    return broken


def _nan_in_a_plane(call):
    def broken(x):
        recon, coeffs = call(x)
        plane = coeffs[3].clone()
        plane[0, 0] = float("nan")
        coeffs[3] = plane
        return recon, coeffs
    return broken


def _planes_dropped(call):
    def broken(x):
        recon, _ = call(x)
        return recon, []
    return broken


@pytest.mark.parametrize("workload", CELLS)
def test_sound_runs_are_correct(workload):
    r = _run(workload)
    assert r["correct"] is True and r["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    assert harness.control_dtype(workload) == torch.bfloat16
    r = _run(workload, cast=harness.control_dtype(workload))
    assert r["correct"] is False and r["failed"] > 0


@pytest.mark.parametrize("fault", [_unchanged, _altered])
@pytest.mark.parametrize("workload", CELLS)
def test_a_fault_is_not_correct(workload, fault):
    r = _run(workload, wrap=fault)
    assert r["correct"] is False


def test_half_a_stack_left_out_is_not_correct():
    r = _run("aia_wow.stack4", wrap=_half_batch)
    assert r["correct"] is False


@pytest.mark.parametrize("fault", [_nan_in_a_plane, _planes_dropped])
def test_a_wrong_plane_is_not_correct(fault):
    r = _run("aia_wow.frame", wrap=fault)
    assert r["correct"] is False
