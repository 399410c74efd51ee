"""One rank of the sharded engine's CPU parity run (tests/test_torch_parallel.py).

``python tests/_torch_parallel_worker.py RANK WORLD DIR`` joins a gloo
group of WORLD ranks through ``file://DIR/rdzv``, runs every case of
:func:`_cases` on the meshes of :data:`MESHES`, and rank 0 writes the global
results to ``DIR/out.npz`` (an array a case, or its error message under
``error:<name>``).  Torch, numpy and the port only: the parent test holds
the results against the JAX package.  The inputs come from
:func:`inputs`, which the parent calls with the same seeds.
"""

from __future__ import annotations

import os
import sys
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from wavelets_tpu_torch.models.pipeline import process_stack  # noqa: E402
from wavelets_tpu_torch.ops.filters import B3SPLINE, TRIANGLE  # noqa: E402
from wavelets_tpu_torch.parallel import (  # noqa: E402
    distributed_median, kth_smallest, make_mesh, sharded_decompose,
    sharded_wow)
from wavelets_tpu_torch.parallel.mesh import (  # noqa: E402
    init_distributed, spatial_group)
from wavelets_tpu_torch.parallel.reductions import (  # noqa: E402
    distributed_max, distributed_mean, distributed_min, distributed_std)
from wavelets_tpu_torch.utils.profiling import count_collectives  # noqa: E402

#: the meshes, (data, rows, cols), of a world of 4
MESHES = ((1, 2, 2), (1, 4, 1), (1, 1, 4), (4, 1, 1), (2, 2, 1))
#: process_stack's frames: count, shape, batch
PSTACK = (8, (64, 64), 4)
#: the order of count_collectives' keys in the saved counts
COLLECTIVE_KEYS = ("all-reduce", "all-gather", "reduce-scatter",
                   "collective-permute", "all-to-all")


def inputs():
    """The cases' inputs, from fixed seeds: the parent builds the same."""
    rng = np.random.default_rng(20261017)
    x = {}
    x["img128"] = rng.normal(size=(128, 128))
    x["img64"] = rng.normal(size=(64, 64))
    x["stack64"] = rng.normal(size=(4, 64, 64)) * np.array(
        [1, 2, 3, 4])[:, None, None]
    x["abs32"] = np.abs(rng.normal(size=(32, 32)))
    x["abs64"] = np.abs(rng.normal(size=(64, 64)))
    x["babs32"] = np.abs(rng.normal(size=(2, 32, 32)))
    x["stack256"] = rng.normal(size=(4, 256, 256)).astype(np.float32)
    x["stack256s"] = (rng.normal(size=(4, 256, 256)) * np.array(
        [1, 2, 3, 4])[:, None, None]).astype(np.float32)
    x["img512"] = rng.normal(size=(512, 512)).astype(np.float32)
    x["img258"] = rng.normal(size=(258, 512)).astype(np.float32)
    x["stack512"] = (rng.normal(size=(2, 512, 256)) * np.array(
        [1, 3])[:, None, None]).astype(np.float32)
    n, shape, _ = PSTACK
    x["frames"] = rng.integers(0, 4000, size=(n,) + shape).astype(np.uint16)
    return x


def _cases(X, meshes, tmp):
    """name → a function of no arguments returning the global result."""
    m22, m41, m14, m4, m221 = (meshes[k] for k in MESHES)
    t = {k: torch.from_numpy(v) for k, v in X.items()}

    def full(d):
        return d.full_tensor()

    def wow_pair(*args, **kw):
        r, p = sharded_wow(*args, **kw)
        return [full(r)] + ([] if p is None else [full(p)])

    def mine(a, mesh):
        # this rank's block of a (H, W) or (B, H, W) array on a data=1 mesh
        _, nr, nc = mesh.mesh.shape
        _, r, c = mesh.get_coordinate()
        Hl, Wl = a.shape[-2] // nr, a.shape[-1] // nc
        return a[..., r * Hl:(r + 1) * Hl, c * Wl:(c + 1) * Wl].contiguous()

    def collectives(fn, *args):
        got = count_collectives(fn, *args)
        return torch.tensor([got[k] for k in COLLECTIVE_KEYS])

    sp22 = spatial_group(m22)
    cases = {}
    for sfn, sf in (("tri", TRIANGLE), ("b3", B3SPLINE)):
        for level in (2, 4):
            cases[f"dec_22_{sfn}_{level}"] = (
                lambda sf=sf, level=level:
                full(sharded_decompose(t["img128"], level, sf, m22)))
    cases["dec_41_b3_3"] = lambda: full(
        sharded_decompose(t["img128"], 3, B3SPLINE, m41))
    cases["dec_14_b3_3"] = lambda: full(
        sharded_decompose(t["img128"], 3, B3SPLINE, m14))
    cases["dec_41_gather"] = lambda: full(
        sharded_decompose(t["img64"], 5, B3SPLINE, m41))
    cases["dec_22_f32"] = lambda: full(sharded_decompose(
        t["img128"].float(), 4, B3SPLINE, m22))
    cases["dec_221_batched"] = lambda: full(
        sharded_decompose(t["stack64"], 3, B3SPLINE, m221))
    cases["dec_22_bil"] = lambda: full(sharded_decompose(
        t["img128"], 2, B3SPLINE, m22, bilateral=(1.0, 1.0, 1.0)))
    cases["dec_41_bil_gather"] = lambda: full(sharded_decompose(
        t["img64"], 5, B3SPLINE, m41, bilateral=(1.0,) * 6))
    cases["kth_f64"] = lambda: kth_smallest(mine(t["abs32"], m22), 317, sp22)
    cases["kth_f32"] = lambda: kth_smallest(
        mine(t["abs32"].float(), m22), 500, sp22)
    cases["median_f64"] = lambda: distributed_median(
        mine(t["abs64"], m22), sp22, 64 * 64)
    cases["median_batched"] = lambda: distributed_median(
        mine(t["babs32"], m22), sp22, 32 * 32, batch_ndim=1)
    cases["moments_batched"] = lambda: torch.stack([
        f(mine(t["babs32"], m22), sp22, *n, batch_ndim=1)
        for f, n in ((distributed_mean, (1024,)), (distributed_std, (1024,)),
                     (distributed_min, ()), (distributed_max, ()))])
    cases["s1_known"] = lambda: wow_pair(
        t["stack256"], m4, noise=1.0, denoise_coefficients=[5.0, 2.0])
    cases["s1_lazy"] = lambda: wow_pair(
        t["stack256s"], m4, denoise_coefficients=[5.0, 2.0])
    cases["s1_serving"] = lambda: wow_pair(
        t["stack256"], m4, noise=1.0, denoise_coefficients=[5.0, 2.0],
        with_coefficients=False)
    cases["s1_f64"] = lambda: wow_pair(
        t["stack64"], m4, denoise_coefficients=[5.0, 2.0])
    cases["s2_lazy_22"] = lambda: wow_pair(
        t["img512"], m22, n_scales=7, denoise_coefficients=[5.0, 2.0])
    cases["s2_known_41"] = lambda: wow_pair(
        t["img512"], m41, n_scales=6, noise=1.0,
        denoise_coefficients=[5.0, 2.0])
    cases["s2_known_14"] = lambda: wow_pair(
        t["img512"], m14, n_scales=6, noise=1.0,
        denoise_coefficients=[5.0, 2.0])
    # 258 rows do not cut into 4 bands: the tail runs the halo chain
    cases["s2_chain_14"] = lambda: wow_pair(
        t["img258"], m14, n_scales=6, noise=1.0,
        denoise_coefficients=[5.0, 2.0])
    cases["s2_serving_22"] = lambda: wow_pair(
        t["img512"], m22, n_scales=7, denoise_coefficients=[5.0, 2.0],
        with_coefficients=False)
    cases["s2_batched"] = lambda: wow_pair(
        t["stack512"], m221, n_scales=6, denoise_coefficients=[5.0, 2.0])
    cases["halo_plain"] = lambda: wow_pair(t["img128"], m22)
    cases["halo_gamma"] = lambda: wow_pair(
        t["img128"], m22, denoise_coefficients=[5, 2], h=0.5,
        weights=[1.1, 0.9])
    cases["halo_pv"] = lambda: wow_pair(
        t["img128"], m22, preserve_variance=True)
    cases["halo_bilateral"] = lambda: wow_pair(
        t["img128"], m22, bilateral=1, denoise_coefficients=[5, 2])
    cases["halo_hard"] = lambda: wow_pair(
        t["img128"], m22, denoise_coefficients=[4, 2], soft_threshold=False)
    cases["halo_batched"] = lambda: wow_pair(
        t["stack64"], m221, denoise_coefficients=[5, 2])
    cases["coll_dec"] = lambda: collectives(
        sharded_decompose, t["img128"], 2, B3SPLINE, m22)
    cases["coll_s2"] = lambda: collectives(
        lambda: sharded_wow(t["img512"], m22, n_scales=7,
                            denoise_coefficients=[5.0, 2.0]))

    def pstack():
        n, shape, batch = PSTACK
        out = os.path.join(tmp, "pstack_mesh.raw")
        process_stack(os.path.join(tmp, "frames.raw"), out, n, shape,
                      batch=batch, mesh=m4, denoise_coefficients=[5, 2],
                      noise=2.0)
        return torch.from_numpy(np.fromfile(out, np.float32).reshape(
            (n,) + shape) if dist.get_rank() == 0 else np.zeros(0))

    cases["pstack"] = pstack
    return cases


def main(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    init_distributed(f"file://{os.path.join(tmp, 'rdzv')}", world, rank,
                     "gloo")
    meshes = {m: make_mesh(*m, device_type="cpu") for m in MESHES}
    results = {}
    for name, fn in _cases(inputs(), meshes, tmp).items():
        try:
            got = fn()
            got = got if isinstance(got, list) else [got]
            for k, g in enumerate(got):
                results[f"{name}:{k}"] = g.detach().float().numpy() \
                    if g.dtype == torch.bfloat16 else g.detach().numpy()
        except Exception:  # report the case and go on with the next
            results[f"error:{name}"] = np.array(traceback.format_exc())
    dist.barrier()
    if rank == 0:
        np.savez(os.path.join(tmp, "out.npz"), **results)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
