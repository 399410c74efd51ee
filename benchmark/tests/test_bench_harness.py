"""The benchmark's loader, names, import guard, trace reader and entry
point, on the CPU."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import frames, harness, trace  # noqa: E402
from benchmark.reference import wow as ref  # noqa: E402

BENCH = ROOT / "benchmark"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return harness.load_spec()


def test_every_workload_resolves(spec):
    for w in spec["workloads"]:
        cell = harness.resolve(spec, w["name"])
        assert cell.config["name"] == w["config"]
        assert set(cell.limits) == {"rel_l2", "max_err"}
        for fn in ("inputs", "call", "split", "reference"):
            assert callable(getattr(cell.entry, fn))
        ref.options(cell.config)
        assert harness.control_dtype(w["name"]).itemsize < frames.dtype_of(
            cell.config).itemsize
        assert cell.cost.work(cell.config, cell.traffic)["ops"] > 0
        assert {m["name"] for m in cell.per_layer} <= set(cell.readers)
        for m in spec["per_layer"]:
            if "workloads" not in m or w["name"] in m["workloads"]:
                assert hasattr(cell.readers[m["name"]], "read")


def test_a_cell_added_as_files_alone_is_found(spec, tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (bench / "traffic" / "stack8.json").write_text(json.dumps(
        dict(json.loads((bench / "traffic" / "stack4.json").read_text()),
             batch=8)))
    (bench / "limits" / "aia_wow.stack8.json").write_text(
        (bench / "limits" / "aia_wow.stack4.json").read_text())
    (bench / "metrics" / "calls_per_s.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    new = json.loads(json.dumps(spec))
    new["workloads"].append({"name": "aia_wow.stack8", "config": "aia_wow",
                             "traffic": "stack8", "chips": 1, "why": "x"})
    new["per_layer"].append({"name": "calls_per_s", "unit": "1/s",
                             "better": "higher", "source": "host_clock",
                             "layer": "entry", "moves": "frames_per_s",
                             "workloads": ["aia_wow.stack8"]})
    cell = harness.resolve(new, "aia_wow.stack8", bench)
    assert cell.traffic["batch"] == 8
    assert cell.cost.work(cell.config, cell.traffic)["frames"] == 8
    assert cell.readers["calls_per_s"].read(None) == 1.0
    assert "calls_per_s" not in harness.resolve(new, "aia_wow.frame",
                                                bench).readers
    with pytest.raises(FileNotFoundError):
        new["workloads"].append(dict(new["workloads"][-1], name="nope.x",
                                     traffic="nope"))
        harness.resolve(new, "nope.x", bench)


def test_a_cell_of_a_new_entry_and_dtype_added_as_files_alone_runs(
        spec, tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    config = json.loads((bench / "configs" / "aia_wow.json").read_text())
    (bench / "configs" / "aia_wow_bf16.json").write_text(json.dumps(
        dict(config, name="aia_wow_bf16", dtype="bfloat16")))
    (bench / "cost" / "aia_wow_bf16.py").write_text(
        (bench / "cost" / "aia_wow.py").read_text())
    # an entry of its own: the recon only, of wow on each frame
    (bench / "entries" / "wow_recon.py").write_text(
        "from benchmark.reference import wow as ref\n"
        "def inputs(pool, traffic):\n"
        "    return list(pool)\n"
        "def call(wt, config, traffic, cast=None):\n"
        "    kw = ref.options(config)\n"
        "    return lambda x: wt.wow(x, **kw)[0]\n"
        "def split(result, x):\n"
        "    return [(x, result, [])]\n"
        "def reference(frame, config, traffic):\n"
        "    return ref.wow(frame, keep_planes=False, **ref.options(config))\n")
    (bench / "traffic" / "recon.json").write_text(json.dumps(
        {"entry": "wow_recon", "batch": 1, "with_coefficients": False,
         "in_flight": 2, "pool": 2,
         "check_frames": 2}))
    (bench / "limits" / "aia_wow_bf16.recon.json").write_text(json.dumps(
        {"rel_l2": {"limit": 10.0}, "max_err": {"limit": 10.0}}))
    new = json.loads(json.dumps(spec))
    new["configs"].append(dict(new["configs"][0], name="aia_wow_bf16",
                               file="benchmark/configs/aia_wow_bf16.json"))
    new["workloads"].append({"name": "aia_wow_bf16.recon",
                             "config": "aia_wow_bf16", "traffic": "recon",
                             "chips": 1, "why": "x"})
    cell = harness.resolve(new, "aia_wow_bf16.recon", bench)
    assert cell.cost.work(dict(cell.config, height=64, width=64),
                          cell.traffic)["bytes"] == 2 * 64 * 64 * 2
    saved = harness.BENCH
    try:
        harness.BENCH = bench
        r = harness.run_cell("aia_wow_bf16.recon", 5, 0.05, False,
                             t_start=0.0, device="cpu", spec=new,
                             size=(64, 64), log=lambda m: None)
    finally:
        harness.BENCH = saved
    assert r["correct"] is True and r["attempted"] > 0
    assert all(0 < c["value"] < 10 for c in r["checks"].values())


def test_a_frame_type_no_frame_is_made_in_is_refused(spec):
    config = harness.resolve(spec, "aia_wow.frame").config
    small = dict(config, height=16, width=16)
    assert frames.make_frames(small, 1, 3, "cpu").dtype == frames.DTYPES[
        config["dtype"]]
    assert frames.make_frames(dict(small, dtype="bfloat16"), 1, 3,
                              "cpu").dtype.itemsize == 2
    with pytest.raises(ValueError):
        frames.make_frames(dict(small, dtype="float16"), 1, 3, "cpu")


def test_names_and_units(spec):
    names = [c["name"] for c in spec["configs"]]
    names += [w["name"] for w in spec["workloads"]]
    names += [w[k] for w in spec["workloads"] for k in ("config", "traffic")]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [k for c in spec["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in spec[kind]]
        assert len(got) == len(set(got)), kind
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in spec["paths"]))
    assert len(json.dumps(spec).encode()) <= 64 * 1024


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for path in files:
        found = set(_imports(path)) & {"jax", "jaxlib", "flax",
                                      "wavelets_tpu"}
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert "wavelets_tpu_torch" not in set(_imports(path)), path


def test_forbidden_modules_compare_whole_names():
    assert harness.forbidden_modules(["wavelets_tpu_torch.ops",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["jax.numpy", "wavelets_tpu.ops",
                                      "flax"]) == ["flax", "jax",
                                                   "wavelets_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from benchmark import harness\n"
            "harness.run_cell('aia_wow.stack4', 3, 0.05, False, "
            "t_start=time.perf_counter(), device='cpu', size=(64, 64), "
            "log=lambda m: None)\n"
            "print(harness.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "aia_wow.frame",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    if out.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert out.stdout.strip() == ""


def test_a_bare_checkout_has_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "aia_wow.frame",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    with pytest.raises(ImportError):
        saved = harness.ROOT
        try:
            harness.ROOT = tmp_path
            harness.import_port()
        finally:
            harness.ROOT = saved


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def test_the_trace_reader():
    events = [
        _x("user_annotation", trace.DISPATCH, 0, 10),
        _x("cpu_op", "aten::add", 2, 3),
        _x("cuda_runtime", "cudaLaunchKernel", 3, 1),
        _x("kernel", "k1", 5, 20, tid=7),
        _x("user_annotation", trace.DISPATCH, 12, 8),
        _x("kernel", "k2", 20, 10, tid=7),
        _x("gpu_memcpy", "Memcpy DtoD", 26, 2, tid=7),
        _x("user_annotation", trace.WAIT, 21, 20),
        _x("cuda_runtime", "cudaEventSynchronize", 22, 18),
        _x("kernel", "k2", 34, 2, tid=7),
        _x("user_annotation", trace.WAIT, 41, 9),
        _x("kernel", "late", 60, 5, tid=7),
    ]
    t = trace.summarize(events)
    assert t["calls"] == 2 and t["kernels"] == 3
    assert t["window_s"] == pytest.approx(50e-6)
    # busy: [5, 30) and [34, 36)
    assert t["busy_s"] == pytest.approx(27e-6)
    assert t["device_ops"] == [["k1", pytest.approx(20e-6)],
                               ["k2", pytest.approx(12e-6)],
                               ["Memcpy DtoD", pytest.approx(2e-6)]]
    gaps = dict(t["idle_gaps"])
    assert gaps["bench.dispatch > aten::add"] == pytest.approx(5e-6)
    assert gaps["bench.wait > cudaEventSynchronize"] == pytest.approx(4e-6)
    assert gaps["bench.wait"] == pytest.approx(14e-6)
    assert trace.summarize([_x("kernel", "k", 0, 1)]) is None


def test_the_reservoir_is_seeded_and_bounded():
    def draw(seed):
        r = harness.Reservoir(3, seed)
        for i in range(1000):
            r.offer(i, i)
        return sorted(i for i, _ in r.items)

    assert draw(2 ** 40 + 1) == draw(2 ** 40 + 1)
    assert len(draw(5)) == 3 and draw(5) != draw(6)


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "aia_wow.frame",
         "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu"
