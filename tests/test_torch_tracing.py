"""The spans and counters of ``wavelets_tpu_torch.tracing`` on the CPU, at
64² (frames) and 4×64² (a stored stack): disarmed sites that touch neither
the profiler nor the recorder; the span tree of ``wow``, ``wow_stack`` and
a bilateral frame under ``record()``; the same spans in a CPU profiler's
Chrome trace; ``process_stack``'s stages in order; the sync sites, counted
with the device check stubbed (no site waits on the CPU)."""

import collections
import json

import numpy as np
import pytest
import torch

from wavelets_tpu_torch import process_stack, tracing, wow, wow_stack
from wavelets_tpu_torch.ops import _build

KW = dict(denoise_coefficients=[5, 2], device="cpu")


def _frame(seed=0, shape=(64, 64)):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape)
                            .astype(np.float32))


CASES = {
    "frame": lambda: wow(_frame(), **KW),
    "stack": lambda: wow_stack(torch.stack([_frame(1), _frame(2)]),
                               with_coefficients=False, **KW),
    "bilateral": lambda: wow(_frame(3), bilateral=1, **KW),
}

# (name, scale, children) of each case's one call: a 64² frame has 4
# scales, the first group (0-2) and one deep scale
TREES = {
    "frame": ("wt.wow", None, [
        ("wt.body.merged", None, [
            ("wt.noise", None, [("wt.k.decompose_group", 0, []),
                                ("wt.k.median_select", None, [])]),
            ("wt.k.whiten_group", 0, []),
            ("wt.deep_tail", None, [("wt.k.whiten_step", 3, [])]),
            ("wt.residual", None, [])])]),
    "stack": ("wt.wow_stack", None, [
        ("wt.body.fused", None, [
            ("wt.decompose", None, [("wt.k.decompose_group", 0, [])]),
            ("wt.noise", None, [("wt.k.median_select", None, [])] * 2),
            ("wt.k.whiten_pieces", None, []),
            ("wt.deep_tail", None, [("wt.k.whiten_step", 3, [])]),
            ("wt.residual", None, [])])]),
    "bilateral": ("wt.wow", None, [
        ("wt.body.fused", None, [
            ("wt.decompose", None, [("wt.k.bilateral_group", 0, [])]),
            ("wt.noise", None, [("wt.k.median_select", None, [])]),
            ("wt.k.whiten_pieces", None, []),
            ("wt.deep_tail", None, [("wt.k.bilateral_step", 3, [])]),
            ("wt.residual", None, [])])]),
}


def _trees(log):
    """The finished spans as ``(name, scale, children)`` trees, one per
    outermost span, children in the order they started."""
    kids = collections.defaultdict(list)
    for sp in sorted(log, key=lambda s: s.start):
        kids[sp.parent].append(sp)

    def tree(sp):
        return (sp.name, sp.scale, [tree(c) for c in kids[sp.id]])
    return [tree(sp) for sp in kids[None]]


@pytest.fixture
def clean():
    tracing.reset()
    tracing.reset_counters()
    yield
    tracing.reset()


def test_disarmed_sites_touch_neither_profiler_nor_recorder(clean,
                                                            monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called while disarmed")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not tracing.armed()
    for run in CASES.values():
        run()
    t = tracing.totals()
    assert all(not v for v in t.values()), t
    assert tracing.spans() == []
    assert _build.LAUNCHES is tracing.LAUNCHES
    assert _build.PLAIN_CALLS is tracing.PLAIN_CALLS
    assert _build.reset_counters is tracing.reset_counters
    assert _build.counter is tracing.counter
    assert not _build.LAUNCHES
    assert _build.PLAIN_CALLS == {
        "median_select": 4, "whiten_group": 1, "whiten_step": 2,
        "decompose_group": 2, "whiten_plane": 2, "bilateral_group": 1,
        "bilateral_step": 1}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_span_tree_under_record(clean, monkeypatch, case):
    def refuse(*a, **k):
        raise AssertionError("record() arms no profiler span")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with tracing.record():
        assert tracing.armed()
        CASES[case]()
        CASES[case]()
    assert not tracing.armed()
    log = tracing.spans()
    assert _trees(log) == [TREES[case]] * 2
    # one call id a call, shared by every span inside it
    roots = [sp for sp in log if sp.parent is None]
    assert sorted(sp.call for sp in roots) == [1, 2]
    by_id = {sp.id: sp for sp in log}
    for sp in log:
        if sp.parent is not None:
            parent = by_id[sp.parent]
            assert sp.call == parent.call
            assert parent.start <= sp.start <= sp.end <= parent.end
        assert 0 <= sp.self_s <= sp.end - sp.start
    t = tracing.totals()
    assert t["calls"] == {TREES[case][0]: 2}
    assert {n: v["count"] for n, v in t["spans"].items()} == dict(
        collections.Counter(sp.name for sp in log))
    for v in list(t["spans"].values()) + list(t["kernels"].values()):
        assert 0 <= v["self_s"] <= v["total_s"]
    kernels = collections.Counter((sp.name, sp.scale) for sp in log
                                  if sp.name.startswith("wt.k."))
    assert {k: v["count"] for k, v in t["kernels"].items()} == dict(kernels)
    plain = collections.Counter()
    for name, n in _build.PLAIN_CALLS.items():
        plain[name] += n
    assert t["plain_calls"] == dict(plain) and not t["launches"]
    assert not t["syncs"] and not t["builds"]


def test_the_profiler_trace_holds_the_spans_as_recorded(clean, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    CASES["stack"]()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.armed()
        for run in CASES.values():
            run()
    assert not tracing.armed()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"
              and e["name"].startswith("wt.")]
    t = tracing.totals()
    assert dict(collections.Counter(e["name"] for e in events)) == {
        n: v["count"] for n, v in t["spans"].items()}

    # each event's parent: the innermost wt. event around it, as recorded
    def parents(items):
        out = collections.Counter()
        items = sorted(items, key=lambda i: (i[0], -i[1]))
        for k, (a, b, name) in enumerate(items):
            around = [i for i in items[:k] if i[0] <= a and b <= i[1]]
            out[(around[-1][2] if around else None, name)] += 1
        return out

    names = {sp.id: sp.name for sp in tracing.spans()}
    recorded = collections.Counter(
        (names.get(sp.parent), sp.name) for sp in tracing.spans())
    assert parents([(e["ts"], e["ts"] + e["dur"], e["name"])
                    for e in events]) == recorded


def test_process_stack_stages_in_order(clean, tmp_path):
    rng = np.random.default_rng(4)
    src, dst = tmp_path / "in.raw", tmp_path / "out.raw"
    rng.integers(0, 4000, size=(4, 64, 64)).astype(np.uint16).tofile(src)
    with tracing.record():
        process_stack(str(src), str(dst), 4, (64, 64), batch=2, **KW)
    log = sorted(tracing.spans(), key=lambda s: s.start)
    stages = [sp.name for sp in log if sp.name.startswith("wt.stack.")]
    assert stages == ["wt.stack." + s for s in (
        "read", "h2d", "run", "read", "h2d", "run", "fetch", "write",
        "fetch", "write")]
    (root,) = [sp for sp in log if sp.parent is None]
    assert root.name == "wt.process_stack"
    assert {sp.call for sp in log} == {root.call}
    by_id = {sp.id: sp for sp in log}
    for sp in log:
        if sp.name.startswith("wt.stack."):
            assert sp.parent == root.id
        if sp.name == "wt.wow_stack":
            assert by_id[sp.parent].name == "wt.stack.run"
    assert tracing.totals()["calls"] == {"wt.process_stack": 1}
    # on the CPU no site waits: the fetch is no sync there
    assert not tracing.totals()["syncs"]


def test_sync_sites_count_on_a_device_the_host_waits_on(clean, monkeypatch,
                                                         tmp_path):
    cuda = torch.device("cuda")
    with tracing.sync("x", cuda):
        pass
    with tracing.record():
        with tracing.sync("x", "cpu"):
            pass
        with tracing.sync("x", cuda):
            pass
    assert tracing.totals()["syncs"] == {"x": 1}
    assert [sp.name for sp in tracing.spans()] == ["wt.sync.x"]

    # the CPU stands in for the card: the sites the paths reach
    monkeypatch.setattr(tracing, "_waits_on", lambda device: True)
    tracing.reset()
    with tracing.record():
        CASES["frame"]()
        # a known scalar noise is a fill on the card, not a copy
        wow(_frame(), noise=1.0, **KW)
    assert tracing.totals()["syncs"] == {}
    with tracing.record():
        wow(_frame(), noise=np.asarray(1.0), **KW)
        CASES["stack"]()
        CASES["bilateral"]()
        t = torch.zeros(3)
        assert tracing.as_tensor(t, dtype=torch.float32, device=t.device,
                                 site="y") is t
    # the fused body's factor table is a fill on the card, not a copy
    assert tracing.totals()["syncs"] == {"noise": 1}
    sync_spans = [sp for sp in tracing.spans()
                  if sp.name.startswith("wt.sync.")]
    names = {sp.id: sp.name for sp in tracing.spans()}
    assert collections.Counter(
        (names[sp.parent], sp.name) for sp in sync_spans) == {
        ("wt.wow", "wt.sync.noise"): 1}
    tracing.reset()
    # under preserve_variance the factors are the device power norms
    with tracing.record():
        wow(_frame(4), preserve_variance=True, **KW)
        wow_stack(torch.stack([_frame(5), _frame(6)]), preserve_variance=True,
                  with_coefficients=False, **KW)
    assert tracing.totals()["syncs"] == {}
    tracing.reset()
    src, dst = tmp_path / "in.raw", tmp_path / "out.raw"
    np.ones((4, 64, 64), np.uint16).tofile(src)
    with tracing.record():
        process_stack(str(src), str(dst), 4, (64, 64), batch=2, **KW)
    assert tracing.totals()["syncs"] == {"stack.fetch": 2}


def test_counters_while_armed(clean):
    tracing.built("x")
    with tracing.launch("k", 2):
        pass
    assert tracing.LAUNCHES == {"k": 1} and tracing.spans() == []
    with tracing.record():
        with tracing.launch("k", 2):
            with tracing.span("wt.inner"):
                pass
        with tracing.plain("k", label="kk"):
            pass
        tracing.built("x")
    assert tracing.LAUNCHES == {"k": 2} and tracing.PLAIN_CALLS == {"k": 1}
    t = tracing.totals()
    assert t["launches"] == {"k": 1} and t["plain_calls"] == {"k": 1}
    assert t["builds"] == {"x": 1}
    assert set(t["kernels"]) == {("wt.k.k", 2), ("wt.k.kk", None)}
    assert t["spans"]["wt.k.k"]["self_s"] <= t["spans"]["wt.k.k"]["total_s"]
    assert t["calls"] == {}
    assert tracing.counter("k", torch.bfloat16) == "k_bf16"
    assert tracing.counter("k", torch.float32) == "k"
