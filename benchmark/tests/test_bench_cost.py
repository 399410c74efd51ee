"""The frozen work counts at 4096² L10, against the figures worked by hand
in PERF.md §2."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.cost import h100  # noqa: E402

N = 4096 * 4096


def _work(workload):
    cell = harness.resolve(harness.load_spec(), workload)
    return cell.cost.work(cell.config, cell.traffic)


def test_the_peaks_and_counts():
    assert (h100.PEAK_BYTES, h100.PEAK_F32) == (3.35e12, 67e12)
    assert h100.WHITEN_SCALE_OPS == 36
    assert (h100.BIL_OPS, h100.BIL_WHITEN_OPS) == (402, 31)
    assert h100.auto_scales(4096, 4096) == 10


def test_aia_wow_frame():
    w = _work("aia_wow.frame")
    # the frame in, the recon and 11 whitened planes out
    assert w["bytes"] == 4 * N * 13 == 872_415_232
    assert w["ops"] == N * 10 * 36 == 6_039_797_760
    assert h100.least_seconds(w) == pytest.approx(0.2604225e-3, rel=1e-6)


def test_aia_wow_stack4():
    w = _work("aia_wow.stack4")
    # four frames in, four recons out, no planes
    assert w["bytes"] == 4 * 4 * N * 2 == 536_870_912
    assert w["ops"] == 4 * N * 10 * 36 == 24_159_191_040
    assert h100.least_seconds(w) == pytest.approx(0.3605849e-3, rel=1e-6)


def test_aia_wow_bilateral_frame():
    w = _work("aia_wow_bilateral.frame")
    assert w["bytes"] == 872_415_232
    assert w["ops"] == N * 10 * 433 == 72_645_345_280
    assert h100.least_seconds(w) == pytest.approx(1.0842589e-3, rel=1e-6)
