"""The cell ``aia_wow_bf16.frame`` at 256² on the CPU: its sound run is
correct, its control (the frames rounded through ``float8_e5m2``) and the
faults a cell can have are not; the frozen bytes of the bfloat16 route's
whitening launches; ``lowp_roofline`` from a trace's ``device_ops``."""

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from test_bench_control import (SEED, _altered, _nan_in_a_plane,  # noqa: E402
                                _planes_dropped, _unchanged)

CELL = "aia_wow_bf16.frame"
SIZE = (256, 256)


def _run(wrap=None, cast=None):
    return harness.run_cell(CELL, SEED, 0.2, False,
                            t_start=time.perf_counter(), device="cpu",
                            size=SIZE, wrap=wrap, cast=cast,
                            log=lambda m: None)


def _cell():
    return harness.resolve(harness.load_spec(), CELL)


def test_the_sound_run_is_correct():
    r = _run()
    assert r["correct"] is True and r["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


def test_the_control_is_not_correct():
    assert harness.control_dtype(CELL) == torch.float8_e5m2
    r = _run(cast=harness.control_dtype(CELL))
    assert r["correct"] is False and r["failed"] > 0


@pytest.mark.parametrize("fault", [_unchanged, _altered, _nan_in_a_plane,
                                   _planes_dropped])
def test_a_fault_is_not_correct(fault):
    assert _run(wrap=fault)["correct"] is False


def test_kernel_bytes_at_4096():
    # PERF.md section 2: 110 bytes a pixel, 1 845 493 760 a frame
    cell = _cell()
    cost = cell.cost
    assert [k for k, _ in cost.launches(cell.config)] == [
        "group", "step", "step", "step", "pair", "step"]
    assert cost.kernel_bytes(cell.config) == 1845493760
    work = cost.work(cell.config, cell.traffic)
    assert work["kernel_bytes"] == 1845493760
    assert work["bytes"] == 2 * 4096 * 4096 * 13


def test_lowp_roofline_from_the_device_ops():
    cell = _cell()
    reader = cell.readers["lowp_roofline"]
    work = cell.cost.work(cell.config, cell.traffic)
    ctx = SimpleNamespace(cell=cell, work=work, trace=None)
    assert reader.read(ctx) is None
    ops = [["void (anonymous namespace)::whiten_stream<__nv_bfloat16, "
            "__nv_bfloat16, 2>((anonymous namespace)::StreamArgs<__nv_bfl",
            0.018],
           ["void (anonymous namespace)::deep_stream<2, true, "
            "__nv_bfloat16>((anonymous namespace)::StreamArgs<__nv_bfloa",
            0.010],
           ["void (anonymous namespace)::pair_stream<2, 2, true>((anonymous "
            "namespace)::PairStream)", 0.004],
           ["void at::native::vectorized_elementwise_kernel<4, at::native::",
            0.003]]
    ctx.trace = {"calls": 10, "device_ops": ops}
    want = 100.0 * (1845493760 / 3.35e12) / (0.032 / 10)
    assert reader.read(ctx) == pytest.approx(want)
    ctx.trace = {"calls": 10, "device_ops": ops[3:]}
    assert reader.read(ctx) is None


def test_the_configuration_is_the_float32_one_in_bfloat16():
    # aia_wow_bf16 is aia_wow with bfloat16 frames and a known noise
    cfgs = ROOT / "benchmark" / "configs"
    base = json.loads((cfgs / "aia_wow.json").read_text())
    bf = json.loads((cfgs / "aia_wow_bf16.json").read_text())
    same = ("height", "width", "scaling_function", "n_scales",
            "denoise_coefficients", "bilateral", "soft_threshold", "gamma",
            "h", "frames")
    assert all(bf[k] == base[k] for k in same)
    assert bf["dtype"] == "bfloat16" and bf["noise"] > 0
