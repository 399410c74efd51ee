"""The sharded engine (``wavelets_tpu_torch.parallel``) across 4 gloo
ranks on the CPU, held against the JAX package's ``parallel/`` on the
forced 8-device CPU mesh (tests/conftest.py, x64 on).

One spawn of 4 worker processes (tests/_torch_parallel_worker.py) runs
every case in a module fixture; each test checks one case.  References,
named in each test: JAX's ``sharded_decompose`` and ``sharded_wow``
(the halo body, XLA, no Pallas kernel), JAX's reductions under
``shard_map``, and, for the kernels' stages (stage 1 runs the Pallas
stack bodies and stage 2 its groups and halo stream, too slow in
interpret mode), JAX's single-device XLA path (``wow_stack``, ``wow``).

Tolerances, ROADMAP's standards: decomposition bitwise (against JAX
run op by op); the median and
k-th statistic exact; float64 to 1e-12·max|ref|; float32 to
5e-6·max|ref|, planes at the reconstruction's scale.
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from tests import _torch_parallel_worker as worker
from tests.torch_parity import assert_close_scaled
from wavelets_tpu import B3SPLINE as JB3
from wavelets_tpu import TRIANGLE as JTRI
from wavelets_tpu import wow as jwow
from wavelets_tpu.core.transform import decompose as jdecompose
from wavelets_tpu.models.pipeline import process_stack as jprocess_stack
from wavelets_tpu.models.wow import wow_stack as jwow_stack
from wavelets_tpu.parallel import make_mesh as jmake_mesh
from wavelets_tpu.parallel import sharded_decompose as jsharded_decompose
from wavelets_tpu.parallel import sharded_wow as jsharded_wow
from wavelets_tpu.parallel import reductions as jred
from wavelets_tpu.utils.profiling import count_collectives as jcount

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

SPAWN_TIMEOUT = 180
F64, F32 = 1e-12, 5e-6
X = worker.inputs()


def _mesh(data, rows, cols):
    return jmake_mesh(data=data, rows=rows, cols=cols,
                      devices=jax.devices()[:data * rows * cols])


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The 4 ranks' results, one spawn for every case."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    X["frames"].tofile(tmp / "frames.raw")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    script = os.path.join(os.path.dirname(__file__),
                          "_torch_parallel_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), "4", str(tmp)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    deadline = time.monotonic() + SPAWN_TIMEOUT
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        outs.append(f"timed out after {SPAWN_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{outs[-1][-3000:]}"
    return dict(np.load(tmp / "out.npz")), tmp


def _get(port, name, k=0):
    res, _ = port
    err = res.get(f"error:{name}")
    assert err is None, str(err)
    return res[f"{name}:{k}"]


def _rel(got, ref, rtol, scale=None):
    assert_close_scaled(got, np.asarray(ref), rtol, scale)


# ---------------------------------------------------------------------
# sharded_decompose: bitwise to JAX op by op, and to its sharded one
# ---------------------------------------------------------------------

DECOMPOSE = {
    "dec_22_tri_2": ((1, 2, 2), "img128", 2, JTRI, {}),
    "dec_22_tri_4": ((1, 2, 2), "img128", 4, JTRI, {}),
    "dec_22_b3_2": ((1, 2, 2), "img128", 2, JB3, {}),
    "dec_22_b3_4": ((1, 2, 2), "img128", 4, JB3, {}),
    "dec_41_b3_3": ((1, 4, 1), "img128", 3, JB3, {}),
    "dec_14_b3_3": ((1, 1, 4), "img128", 3, JB3, {}),
    # reach 32 past the 16-row blocks: the all-gather fallback
    "dec_41_gather": ((1, 4, 1), "img64", 5, JB3, {}),
    "dec_22_f32": ((1, 2, 2), "img128", 4, JB3, {}),
    "dec_221_batched": ((2, 2, 1), "stack64", 3, JB3, {}),
}


@pytest.mark.parametrize("case", sorted(DECOMPOSE))
def test_sharded_decompose_bitwise(port, case):
    # references: JAX's decompose run op by op (jax.disable_jit; jitted
    # XLA contracts the folds to FMAs, ROADMAP's standards), bitwise; JAX's
    # own tests hold it bitwise to its jitted sharded_decompose, which is
    # the second reference, on the same mesh shape, to the float standard
    mesh, key, level, sf, kw = DECOMPOSE[case]
    x = X[key].astype(np.float32) if case.endswith("f32") else X[key]
    got = _get(port, case)
    with jax.disable_jit():
        ref = jdecompose(jnp.asarray(x), level, sf,
                         axes=(1, 2) if x.ndim == 3 else None)
    assert got.dtype == x.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, np.asarray(ref))
    _rel(got, jsharded_decompose(jnp.asarray(x), level, sf, _mesh(*mesh),
                                 **kw), F32 if x.dtype == np.float32 else F64)


@pytest.mark.parametrize("case,mesh,key,level,bil", [
    ("dec_22_bil", (1, 2, 2), "img128", 2, (1.0, 1.0, 1.0)),
    # reach past the blocks: the bilateral all-gather fallback
    ("dec_41_bil_gather", (1, 4, 1), "img64", 5, (1.0,) * 6),
])
def test_sharded_bilateral_decompose(port, case, mesh, key, level, bil):
    # reference: JAX's sharded_decompose; the range weights' exp differs
    # between XLA and torch in the last place, so float64 to 1e-12
    ref = jsharded_decompose(jnp.asarray(X[key]), level, JB3, _mesh(*mesh),
                             bilateral=bil)
    _rel(_get(port, case), ref, F64)


# ---------------------------------------------------------------------
# the reductions: against JAX's under shard_map, and numpy
# ---------------------------------------------------------------------

def _jax_reduce(fn, a, batch=False):
    mesh = _mesh(1, 2, 2)
    spec = P(None, "rows", "cols") if batch else P("rows", "cols")
    f = shard_map(fn, mesh=mesh, in_specs=(spec,), out_specs=P())
    return np.asarray(jax.jit(f)(jax.device_put(
        jnp.asarray(a), NamedSharding(mesh, spec))))


@pytest.mark.parametrize("case,key,k,dtype", [
    ("kth_f64", "abs32", 317, np.float64),
    ("kth_f32", "abs32", 500, np.float32),
])
def test_kth_smallest_exact(port, case, key, k, dtype):
    a = X[key].astype(dtype)
    got = _get(port, case)
    assert got.dtype == dtype
    assert got == np.sort(a.ravel())[k]
    assert got == _jax_reduce(
        lambda v: jred.kth_smallest(v, k, ("rows", "cols")), a)


def test_distributed_median_exact(port):
    a = X["abs64"]
    assert _get(port, "median_f64") == np.median(a)
    assert _get(port, "median_f64") == _jax_reduce(
        lambda v: jred.distributed_median(v, ("rows", "cols"), a.size), a)


def test_distributed_median_batched(port):
    a = X["babs32"]
    np.testing.assert_array_equal(_get(port, "median_batched"),
                                  np.median(a, axis=(1, 2)))


@pytest.mark.parametrize("row,name", enumerate(["mean", "std", "min",
                                                "max"]))
def test_distributed_moments(port, row, name):
    # reference: JAX's distributed_* under shard_map, per frame
    a = X["babs32"]
    n = (a[0].size,) if name in ("mean", "std") else ()
    fn = getattr(jred, f"distributed_{name}")
    ref = _jax_reduce(
        lambda v: fn(v, ("rows", "cols"), *n, batch_ndim=1), a, batch=True)
    _rel(_get(port, "moments_batched")[row], ref, F64)


# ---------------------------------------------------------------------
# sharded_wow, stage 1 (data-only mesh): against JAX's wow_stack (XLA)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("case,key,kw,rtol", [
    ("s1_known", "stack256", dict(noise=1.0), F32),
    ("s1_lazy", "stack256s", {}, F32),
    ("s1_f64", "stack64", {}, F64),
])
def test_stage1_matches_wow_stack(port, case, key, kw, rtol):
    ref_r, ref_p = jwow_stack(jnp.asarray(X[key]),
                              denoise_coefficients=[5.0, 2.0], **kw)
    r = _get(port, case)
    _rel(r, ref_r, rtol)
    scale = float(np.abs(np.asarray(ref_r)).max())
    p = _get(port, case, 1)
    assert p.shape == ref_p.shape  # batch-major (B, L+1, H, W)
    _rel(p, ref_p, rtol, scale)


def test_stage1_serving_recon(port):
    # serving mode (merged body) against planes mode (pieces): the same
    # math on other kernels, and JAX's serving wow_stack
    ref, _ = jwow_stack(jnp.asarray(X["stack256"]), noise=1.0,
                        denoise_coefficients=[5.0, 2.0],
                        with_coefficients=False)
    _rel(_get(port, "s1_serving"), ref, F32)
    _rel(_get(port, "s1_serving"), _get(port, "s1_known"), F32)


# ---------------------------------------------------------------------
# sharded_wow, stage 2 (tiled float32, kernel A's group and the band tail
# in halo mode): against JAX's single-device XLA wow
# ---------------------------------------------------------------------

STAGE2 = {
    # 2x2, L7: bands of 128 rows; tail scales 3-6 reach 32, 64, 128 (halo
    # exchange) and 256 (the gathered window); lazy noise: the bisection
    "s2_lazy_22": ("img512", dict(n_scales=7)),
    "s2_known_41": ("img512", dict(n_scales=6, noise=1.0)),
    "s2_known_14": ("img512", dict(n_scales=6, noise=1.0)),
    # 258 rows on 4 columns of ranks: no band plan, the halo chain's tail
    "s2_chain_14": ("img258", dict(n_scales=6, noise=1.0)),
}


@pytest.mark.parametrize("case", sorted(STAGE2))
def test_stage2_matches_wow(port, case):
    key, kw = STAGE2[case]
    ref_r, ref_c = jwow(jnp.asarray(X[key]),
                        denoise_coefficients=[5.0, 2.0], **kw)
    _rel(_get(port, case), ref_r, F32)
    scale = float(np.abs(np.asarray(ref_r)).max())
    _rel(_get(port, case, 1), np.asarray(ref_c.data), F32, scale)


def test_stage2_serving_bitwise(port):
    # no plane writes on the same plan: the recon is unchanged
    np.testing.assert_array_equal(_get(port, "s2_serving_22"),
                                  _get(port, "s2_lazy_22"))


def test_stage2_batched_per_frame(port):
    # data x rows mesh over a stack: per-frame statistics, each frame
    # against JAX's single-frame wow
    got = _get(port, "s2_batched")
    assert _get(port, "s2_batched", 1).shape == (2, 7, 512, 256)
    for i in range(2):
        ref, _ = jwow(jnp.asarray(X["stack512"][i]), n_scales=6,
                      denoise_coefficients=[5.0, 2.0])
        _rel(got[i], ref, F32)


# ---------------------------------------------------------------------
# sharded_wow, the halo body: against JAX's sharded_wow (XLA halo body)
# ---------------------------------------------------------------------

HALO = {
    "halo_plain": ((1, 2, 2), "img128", {}),
    "halo_gamma": ((1, 2, 2), "img128",
                   dict(denoise_coefficients=[5, 2], h=0.5,
                        weights=[1.1, 0.9])),
    "halo_pv": ((1, 2, 2), "img128", dict(preserve_variance=True)),
    "halo_bilateral": ((1, 2, 2), "img128",
                       dict(bilateral=1, denoise_coefficients=[5, 2])),
    "halo_hard": ((1, 2, 2), "img128",
                  dict(denoise_coefficients=[4, 2], soft_threshold=False)),
    "halo_batched": ((2, 2, 1), "stack64", dict(denoise_coefficients=[5, 2])),
}


@pytest.mark.parametrize("case", sorted(HALO))
def test_halo_body_matches_jax_sharded(port, case):
    mesh, key, kw = HALO[case]
    ref_r, ref_p = jsharded_wow(jnp.asarray(X[key]), _mesh(*mesh), **kw)
    _rel(_get(port, case), ref_r, F64)
    scale = float(np.abs(np.asarray(ref_r)).max())
    got_p = _get(port, case, 1)
    assert got_p.shape == ref_p.shape
    _rel(got_p, ref_p, F64, scale)


# ---------------------------------------------------------------------
# process_stack(mesh=) and count_collectives
# ---------------------------------------------------------------------

def test_process_stack_mesh(port, tmp_path):
    # reference: JAX's process_stack (no mesh: its mesh path would run the
    # Pallas stack bodies in interpret mode) and the port's own, bitwise
    from wavelets_tpu_torch.models.pipeline import process_stack

    n, shape, batch = worker.PSTACK
    _, tmp = port
    got = _get(port, "pstack")
    jprocess_stack(str(tmp / "frames.raw"), str(tmp_path / "j.raw"), n,
                   shape, batch=batch, denoise_coefficients=[5, 2],
                   noise=2.0)
    ref = np.fromfile(tmp_path / "j.raw", np.float32).reshape(got.shape)
    _rel(got, ref, F32)
    process_stack(str(tmp / "frames.raw"), str(tmp_path / "t.raw"), n, shape,
                  batch=batch, denoise_coefficients=[5, 2], noise=2.0,
                  device="cpu")
    np.testing.assert_array_equal(
        got, np.fromfile(tmp_path / "t.raw", np.float32).reshape(got.shape))


def test_count_collectives_decompose(port):
    # no loop in the program: the port's calls equal the ops of JAX's
    # compiled HLO, two permutes an axis a scale
    got = dict(zip(worker.COLLECTIVE_KEYS, _get(port, "coll_dec")))
    mesh = _mesh(1, 2, 2)
    ref = jcount(lambda x: jsharded_decompose(x, 2, JB3, mesh),
                 jnp.asarray(X["img128"]))
    assert got == ref == {"all-reduce": 0, "all-gather": 0,
                          "reduce-scatter": 0, "collective-permute": 8,
                          "all-to-all": 0}


def test_count_collectives_stage2(port):
    # 2x2, 512², L7, lazy noise: w0's smooth (4 permutes), the 64-round
    # bisection median, the group's extension (4), four band scales (3
    # exchanges of 2, one gather), the bands' reshard in and out (recon and
    # carry in, four whites, carry and recon out: 8 all-to-alls) and the
    # residual's std (2 all-reduces)
    got = dict(zip(worker.COLLECTIVE_KEYS, _get(port, "coll_s2")))
    assert got == {"all-reduce": 66, "all-gather": 1, "reduce-scatter": 0,
                   "collective-permute": 14, "all-to-all": 8}


def test_stage2_plans():
    # the port's own stage-2 plans (JAX's: test_sharded_fast.py::
    # test_band_plan_engages): kernel A's group of up to 3 scales while its
    # reach (4, 10, 22 rows for g = 1, 2, 3) fits the block; bands of
    # Hl / n_cols rows where they divide and the tail has scales
    from wavelets_tpu_torch.ops.filters import B3SPLINE
    from wavelets_tpu_torch.parallel.sharded import (_deep_tail_band_plan,
                                                      _tiled_wow_plan)

    assert _tiled_wow_plan(256, 256, 7, B3SPLINE) == ([(0, 3)], 3)
    assert _tiled_wow_plan(16, 256, 7, B3SPLINE) == ([(0, 2)], 2)
    assert _tiled_wow_plan(4, 256, 7, B3SPLINE) == ([(0, 1)], 1)
    assert _tiled_wow_plan(3, 256, 7, B3SPLINE) == ([], 0)
    assert _tiled_wow_plan(256, 256, 2, B3SPLINE) == ([(0, 2)], 2)
    assert _deep_tail_band_plan(256, 2, 3, 7) == 128
    assert _deep_tail_band_plan(258, 4, 3, 6) == 0
    assert _deep_tail_band_plan(256, 2, 7, 7) == 0
