"""The readers of the program's own spans and counters,
``host_syncs_per_call`` and ``sync_wait_ms``, on the CPU."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

NAMES = ("host_syncs_per_call", "sync_wait_ms")


def _readers():
    return {n: harness.load_module("metrics", n) for n in NAMES}


def _totals(calls, syncs, spans):
    return {"spans": spans, "kernels": {}, "calls": calls, "launches": {},
            "plain_calls": {}, "syncs": syncs, "builds": {}}


def test_none_without_the_module_or_an_entry_span(monkeypatch):
    from wavelets_tpu_torch import tracing

    readers = _readers()
    tracing.reset()
    assert all(r.read(None) is None for r in readers.values())
    monkeypatch.setattr(tracing, "totals", lambda: _totals(
        {}, {"fused.factors": 3}, {"wt.sync.fused.factors": {
            "count": 3, "total_s": 0.1, "self_s": 0.1}}))
    assert all(r.read(None) is None for r in readers.values())
    # a checkout whose port has no tracing module, as the parent has not
    monkeypatch.setitem(sys.modules, "wavelets_tpu_torch.tracing", None)
    assert all(r.read(None) is None for r in readers.values())


def test_exact_values_from_the_recorder(monkeypatch):
    from wavelets_tpu_torch import tracing

    def span(count, total):
        return {"count": count, "total_s": total, "self_s": total}

    monkeypatch.setattr(tracing, "totals", lambda: _totals(
        {"wt.wow_stack": 3, "wt.wow": 1},
        {"fused.factors": 9, "plane.weight": 1},
        {"wt.sync.fused.factors": span(9, 0.018),
         "wt.sync.plane.weight": span(1, 0.002),
         "wt.wow_stack": span(3, 0.5), "wt.body.fused": span(3, 0.4)}))
    r = _readers()
    assert r["host_syncs_per_call"].read(None) == 10 / 4
    assert r["sync_wait_ms"].read(None) == pytest.approx(1e3 * 0.020 / 4)


def test_a_traced_cpu_run_reports_both(monkeypatch):
    from wavelets_tpu_torch import tracing

    tracing.reset()
    r = harness.run_cell("aia_wow.stack4", 2 ** 33 + 5, 0.2, True,
                         t_start=time.perf_counter(), device="cpu",
                         size=(128, 128), log=lambda m: None)
    assert r["correct"] is True
    m = r["metrics"]
    # the traced slice's calls, and no site waits on the CPU
    assert m["host_syncs_per_call"] == {"value": 0.0, "unit": "count"}
    assert m["sync_wait_ms"] == {"value": 0.0, "unit": "ms"}
    assert sum(tracing.totals()["calls"].values()) >= 1
    assert not tracing.armed()
    tracing.reset()
