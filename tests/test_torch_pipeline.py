"""Frame-stack serving from disk to disk: the port's ``FrameStack`` and
``write_array`` (the native reader, built from ``native/frameio.cc`` at
first use, and its plain numpy version), ``process_stack``, the command
line (``python -m wavelets_tpu_torch``) and ``Coefficients`` in npz,
against the JAX package's.

Tolerances: float32 outputs within ``5e-6·max|ref|`` of the JAX
package's; the readers bitwise to numpy's conversion."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import wavelets_tpu as J
import wavelets_tpu_torch as T
from tests.torch_parity import assert_close_scaled, assert_rel, to_np
from wavelets_tpu.cli import main as jcli
from wavelets_tpu.models.pipeline import process_stack as j_process_stack
from wavelets_tpu.utils.io import load_coefficients as j_load
from wavelets_tpu.utils.io import save_coefficients as j_save
from wavelets_tpu_torch.cli import main as tcli
from wavelets_tpu_torch.utils import frameio
from wavelets_tpu_torch.utils.io import load_coefficients as t_load
from wavelets_tpu_torch.utils.io import save_coefficients as t_save

REPO = Path(__file__).resolve().parents[1]
SHAPE = (64, 48)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(5).uniform(0, 60000, size=(5,) + SHAPE)


def _stored(frames, dtype):
    if np.dtype(dtype).kind in "ui":
        info = np.iinfo(np.dtype(dtype).newbyteorder("="))
        return np.clip(frames - 30000, info.min, info.max).astype(dtype)
    return (frames - 30000).astype(dtype)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("dtype", [str(np.dtype(d)) for d in frameio.DTYPES])
def test_frame_stack_reads_every_layout(tmp_path, frames, native, dtype):
    # every stored dtype (big-endian too) after a header of 7 bytes
    stored = _stored(frames, dtype)
    path = tmp_path / "stack.raw"
    path.write_bytes(b"\x01" * 7 + stored.tobytes())
    want = stored.astype(np.float32)
    with frameio.FrameStack(str(path), 5, SHAPE, dtype=dtype, offset=7,
                            native=native) as fs:
        assert len(fs) == 5
        assert np.array_equal(fs[3], want[3])
        got = fs.read_batch([4, 0, 2])
        assert got.dtype == np.float32 and np.array_equal(got, want[[4, 0, 2]])
        out = np.empty((2,) + SHAPE, np.float32)
        assert fs.read_batch([1, 1], out=out) is out
        assert np.array_equal(out, want[[1, 1]])


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_frame_stack_bounds(tmp_path, frames, native):
    path = tmp_path / "stack.raw"
    _stored(frames, "uint16").tofile(path)
    with frameio.FrameStack(str(path), 5, SHAPE, native=native) as fs:
        for idx in (-1, 5):
            with pytest.raises(IndexError):
                fs[idx]
        with pytest.raises(IndexError):
            fs.read_batch([0, 5])
        with pytest.raises(ValueError):
            fs.read_batch([0], out=np.empty((2,) + SHAPE, np.float32))
    with pytest.raises(OSError):
        frameio.FrameStack(str(path), 6, SHAPE, native=native)
    with pytest.raises(OSError):
        frameio.FrameStack(str(path), 5, SHAPE, offset=1, native=native)
    with pytest.raises(ValueError):
        frameio.FrameStack(str(path), 5, SHAPE, dtype="complex64",
                           native=native)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_write_array(tmp_path, frames, native):
    arr = frames.astype(np.float32)[:, ::2]  # not contiguous
    frameio.write_array(str(tmp_path / "a.raw"), arr, native=native)
    back = np.fromfile(tmp_path / "a.raw", np.float32).reshape(arr.shape)
    assert np.array_equal(back, arr)


def test_native_library_builds_from_source():
    # built into build/frameio/, keyed by the source's hash: never a
    # committed or stale library
    assert frameio.native_available()
    lib = frameio._library_path()
    assert lib.exists() and lib.parent == frameio.BUILD_DIR
    assert frameio.SOURCE.read_bytes()
    assert lib.name.startswith("libwtio-") and lib.suffix == ".so"


def test_native_reader_raises_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(frameio, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(frameio, "_library_path",
                        lambda: tmp_path / "b" / "libwtio-x.so")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    frameio._load.cache_clear()
    try:
        assert not frameio.native_available()
        with pytest.raises((RuntimeError, OSError)):
            frameio.write_array(str(tmp_path / "a.raw"), np.zeros(3))
    finally:
        frameio._load.cache_clear()


@pytest.fixture
def stack_file(tmp_path):
    frames = np.random.default_rng(9).uniform(
        100, 60000, size=(5, 128, 128)).astype(np.uint16)
    path = tmp_path / "in.raw"
    frames.tofile(path)
    return str(path), frames


@pytest.mark.parametrize("batch", [2, 5])
def test_process_stack_matches_jax(stack_file, tmp_path, batch):
    # batch 2: a short last batch, run unpadded (per-frame statistics)
    path, frames = stack_file
    kw = dict(n_scales=4, denoise_coefficients=[5, 2])
    j_process_stack(path, str(tmp_path / "j.raw"), 5, (128, 128),
                    batch=batch, **kw)
    n, secs, fps = T.process_stack(path, str(tmp_path / "t.raw"), 5,
                                   (128, 128), batch=batch, device="cpu",
                                   **kw)
    assert n == 5 and secs > 0 and fps > 0
    want = np.fromfile(tmp_path / "j.raw", np.float32).reshape(5, 128, 128)
    got = np.fromfile(tmp_path / "t.raw", np.float32).reshape(5, 128, 128)
    assert_close_scaled(got, want, 5e-6)
    # the unpadded tail equals the padded batch's frames
    tail = torch.from_numpy(frames[4:].astype(np.float32))
    padded = torch.cat([tail, tail])
    r_pad, _ = T.wow_stack(padded, with_coefficients=False, **kw)
    assert torch.equal(torch.from_numpy(got[4]), r_pad[0])


def test_process_stack_known_noise_and_mesh(stack_file, tmp_path):
    # the output is wow_stack of each batch as read; on a one-rank mesh
    # (a gloo group in this process) the sharded engine's stage 1 gives
    # the same bits (the 4-rank runs: tests/test_torch_parallel.py)
    import torch.distributed as dist

    from wavelets_tpu_torch.parallel import make_mesh
    from wavelets_tpu_torch.parallel.mesh import init_distributed

    path, frames = stack_file
    kw = dict(n_scales=3, noise=100.0, denoise_coefficients=[3])
    T.process_stack(path, str(tmp_path / "t.raw"), 5, (128, 128), batch=3,
                    device="cpu", **kw)
    got = np.fromfile(tmp_path / "t.raw", np.float32).reshape(5, 128, 128)
    want = torch.cat([T.wow_stack(frames[b0:b0 + 3].astype(np.float32),
                                  with_coefficients=False, device="cpu",
                                  **kw)[0] for b0 in (0, 3)])
    assert torch.equal(torch.from_numpy(got), want)
    init_distributed(f"file://{tmp_path / 'rdzv'}", 1, 0, "gloo")
    try:
        T.process_stack(path, str(tmp_path / "m.raw"), 5, (128, 128),
                        batch=3, mesh=make_mesh(device_type="cpu"), **kw)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(
        np.fromfile(tmp_path / "m.raw", np.float32).reshape(5, 128, 128),
        got)


CLI = {
    "wow": ["--frames", "5", "--dtype", "uint16", "--denoise", "5", "2",
            "--batch", "2", "--n-scales", "4"],
    "wow-options": ["--frames", "5", "--dtype", "uint16", "--denoise", "3",
                    "--batch", "3", "--n-scales", "3", "--hard",
                    "--weights", "1", "2", "--gamma-blend", "0.5",
                    "--scaling-function", "triangle"],
    "denoise": ["--frames", "2", "--dtype", "uint16", "--weights", "3",
                "2", "--anscombe"],
    "decompose": ["--frames", "5", "--dtype", "uint16", "--level", "3",
                  "--frame", "2"],
}


@pytest.mark.parametrize("cmd", sorted(CLI))
def test_cli_matches_jax(stack_file, tmp_path, cmd):
    path, _ = stack_file
    sub = cmd.split("-")[0]
    ext = ".npz" if sub == "decompose" else ".raw"
    args = [path, "--shape", "128", "128"] + CLI[cmd]
    assert jcli([sub] + args[:1] + [str(tmp_path / f"j{ext}")]
                + args[1:]) == 0
    assert tcli([sub] + args[:1] + [str(tmp_path / f"t{ext}")] + args[1:]
                + ["--device", "cpu"]) == 0
    if sub == "decompose":
        want, got = (np.load(tmp_path / f"{p}.npz") for p in "jt")
        assert sorted(got.files) == sorted(want.files)
        assert_close_scaled(got["data"], want["data"], 5e-6)
        for key in ("scaling_function", "n_dim", "bilateral"):
            assert np.array_equal(got[key], want[key])
        return
    want, got = (np.fromfile(tmp_path / f"{p}.raw", np.float32)
                 for p in "jt")
    assert got.size == want.size
    assert_close_scaled(got, want, 5e-6)


def test_cli_not_ported_and_module_entry(tmp_path):
    with pytest.raises(NotImplementedError, match="A1"):
        tcli(["bench"])
    with pytest.raises(SystemExit):  # rl is ported; --psf is required
        tcli(["rl", "a.raw", "b.raw", "--shape", "8", "8", "--frames", "1"])
    with pytest.raises(SystemExit):
        tcli(["wow", "a.raw", "b.raw"])  # --shape and --frames required
    out = subprocess.run([sys.executable, "-m", "wavelets_tpu_torch",
                          "--help"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "wow" in out.stdout


RL_CLI = {
    "default": ["--iterations", "3"],
    "hard-fft": ["--iterations", "2", "--hard", "--fft", "--denoise", "4",
                 "2"],
    "uniform-init": ["--iterations", "2", "--uniform-init"],
}


@pytest.mark.parametrize("case", sorted(RL_CLI))
def test_rl_cli_matches_jax(stack_file, tmp_path, case):
    # python -m wavelets_tpu_torch rl against the JAX package's command and
    # against per-frame richardson_lucy of the port
    path, _ = stack_file
    h = np.hanning(7)[1:-1]
    psf = np.outer(h, h) / np.outer(h, h).sum()
    np.save(tmp_path / "psf.npy", psf)
    args = [path, "--shape", "128", "128", "--frames", "3", "--dtype",
            "uint16", "--psf", str(tmp_path / "psf.npy")] + RL_CLI[case]
    assert jcli(["rl"] + args[:1] + [str(tmp_path / "j.raw")] + args[1:]) \
        == 0
    assert tcli(["rl"] + args[:1] + [str(tmp_path / "t.raw")] + args[1:]
                + ["--device", "cpu"]) == 0
    want, got = (np.fromfile(tmp_path / f"{p}.raw", np.float32)
                 for p in "jt")
    assert got.size == want.size == 3 * 128 * 128
    assert_close_scaled(got, want, 5e-6)
    kw = dict(iterations=int(RL_CLI[case][1]),
              threshold_type="hard" if "--hard" in RL_CLI[case] else "soft",
              fft="--fft" in RL_CLI[case],
              uniform_init="--uniform-init" in RL_CLI[case])
    if "--denoise" in RL_CLI[case]:
        kw["denoise_coefficients"] = (4.0, 2.0)
    with frameio.FrameStack(path, 3, (128, 128), dtype="uint16") as fs:
        for k in range(3):
            one = T.richardson_lucy(fs[k], psf.astype(np.float32),
                                    device="cpu", **kw)
            assert np.array_equal(got.reshape(3, 128, 128)[k], one.numpy())


@pytest.mark.parametrize("case", ["plain", "bilateral-noise", "volume"])
def test_coefficients_npz_across_packages(tmp_path, case):
    # a file written by either package loads in the other, and wow of
    # what was loaded agrees between the packages
    rng = np.random.default_rng(3)
    shape = (12, 40, 48) if case == "volume" else (64, 80)
    x = rng.normal(size=shape)
    bil = 1.5 if case == "bilateral-noise" else None
    jc = J.AtrousTransform(bilateral=bil)(x, 3)
    tc = T.AtrousTransform(bilateral=bil)(x, 3, device="cpu")
    if case == "bilateral-noise":
        jc.noise = 0.25
        tc.noise = 0.25
    j_save(str(tmp_path / "j.npz"), jc)
    t_save(str(tmp_path / "t.npz"), tc)
    for path in ("j.npz", "t.npz"):
        jl = j_load(str(tmp_path / path))
        tl = t_load(str(tmp_path / path), device="cpu")
        assert tl.data.device.type == "cpu"
        assert_rel(tl.data, np.asarray(jl.data), 1e-12)
        assert tl.scaling_function.name == jl.scaling_function.name
        assert tl.scaling_function.n_dim == jl.scaling_function.n_dim
        assert tl.bilateral == jl.bilateral and tl.noise == jl.noise
        rj, cj = J.wow(jl, denoise_coefficients=[3, 1])
        rt, ct = T.wow(tl, denoise_coefficients=[3, 1])
        assert_rel(rt, np.asarray(rj), 1e-12)
        for k in range(len(cj)):
            assert_rel(ct[k], np.asarray(cj[k]), 1e-12)
    noise = torch.tensor(0.5)
    tc.noise = noise
    t_save(str(tmp_path / "n.npz"), tc)
    assert t_load(str(tmp_path / "n.npz"), device="cpu").noise == 0.5
    assert to_np(t_load(str(tmp_path / "n.npz"), device="cpu").data).shape \
        == (4,) + shape


def test_serving_modules_load_no_jax():
    modules = ["wavelets_tpu_torch.cli", "wavelets_tpu_torch.models.pipeline",
               "wavelets_tpu_torch.utils.frameio",
               "wavelets_tpu_torch.utils.io"]
    code = (f"import sys, importlib; [importlib.import_module(m) for m in "
            f"{modules!r}]; print('jax' in sys.modules, "
            f"'wavelets_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]
