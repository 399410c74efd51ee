"""Frame-stack WOW: ``wavelets_tpu_torch.wow_stack`` against the JAX
package's ``wow_stack`` (its per-frame ``vmap`` of the XLA path on the
CPU) and against ``wavelets_tpu.models.wow._stack_core(..., force=True)``
(the batched Pallas kernels in interpret mode, the dispatch the JAX
package takes on a TPU); per-frame equality with single-frame ``wow``;
the per-frame statistics ``median_abs_frames``/``mad_noise_frames``;
kernel D's batch-major pieces layout against the TPU kernel's; the
dispatch rule and the error cases.

Tolerances: float64 recon and planes ≤1e-12 relative; float32 recon and
planes within ``5e-6·max|ref recon|`` (planes at the reconstruction's
scale, as the JAX package holds its merged body)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wavelets_tpu as J
import wavelets_tpu_torch as T
from tests.torch_parity import assert_close_scaled, assert_rel, to_np
from wavelets_tpu.ops import pallas_wow
from wavelets_tpu.ops import stats as jstats
from wavelets_tpu.ops.filters import B3SPLINE as JB3
from wavelets_tpu.ops.filters import TRIANGLE as JTRI
from wavelets_tpu_torch.ops import _build, hopper_wow
from wavelets_tpu_torch.ops import stats as tstats
from wavelets_tpu_torch.ops.filters import B3SPLINE

jwow = importlib.import_module("wavelets_tpu.models.wow")
twow = importlib.import_module("wavelets_tpu_torch.models.wow")

#: wow_stack options, the noise apart
CASES = {
    "known": dict(noise=0.4, denoise_coefficients=[3, 1]),
    "per-frame-noise": dict(noise=[0.4, 0.9], denoise_coefficients=[3, 1]),
    "lazy": dict(denoise_coefficients=[5, 2]),
    "lazy-hard-weights": dict(denoise_coefficients=[4, 2],
                              soft_threshold=False, weights=[0.5, 2, 1]),
    "h-0.5": dict(h=0.5, denoise_coefficients=[3]),
    "h-1": dict(h=1, n_scales=3, denoise_coefficients=[3]),
    "no-whitening": dict(whitening=False, denoise_coefficients=[3]),
    "preserve-variance": dict(preserve_variance=True, noise=0.5,
                              denoise_coefficients=[2]),
    "triangle": dict(scaling_function="triangle",
                     denoise_coefficients=[5, 2]),
    "bilateral": dict(bilateral=1, denoise_coefficients=[5, 2]),
}

SF = {"triangle": (J.Triangle, T.Triangle)}


def _kw(case, pkg):
    """The options of ``case`` for package ``pkg`` (0 JAX, 1 port), at
    four scales unless the case says."""
    kw = dict(CASES[case])
    kw.setdefault("n_scales", 4)
    if "scaling_function" in kw:
        kw["scaling_function"] = SF[kw["scaling_function"]][pkg]
    return kw


@pytest.fixture(scope="module")
def stack():
    # zero mean: bilateral float32 is ill-conditioned on a large mean
    # (ROADMAP.md queue C), so every case shares the data it needs
    rng = np.random.default_rng(88)
    scales = np.array([1.0, 2.5])[:, None, None]
    return rng.normal(size=(2, 256, 256)) * scales


def _hold(got, ref, dtype):
    recon, planes = got
    r_ref, p_ref = (np.asarray(a) if a is not None else None for a in ref)
    assert recon.shape == r_ref.shape
    if dtype == np.float64:
        assert_rel(recon, r_ref, 1e-12)
        if p_ref is not None:
            assert_rel(planes, p_ref, 1e-12)
    else:
        assert_close_scaled(recon, r_ref, 5e-6)
        if p_ref is not None:
            assert_close_scaled(planes, p_ref, 5e-6,
                                float(np.abs(r_ref).max()))
    assert (planes is None) == (p_ref is None)


#: float32 on the routes that round differently; float64 everywhere
XLA_CASES = ([(c, np.float64) for c in sorted(CASES)]
             + [(c, np.float32) for c in ("bilateral", "h-0.5", "known",
                                          "lazy", "preserve-variance")])


@pytest.mark.parametrize("case,dtype", XLA_CASES,
                         ids=[f"{np.dtype(d).name}-{c}" for c, d in XLA_CASES])
def test_wow_stack_matches_jax(stack, case, dtype):
    x = stack.astype(dtype)
    wc = case not in ("lazy", "h-1")
    ref = J.wow_stack(x, with_coefficients=wc, **_kw(case, 0))
    got = T.wow_stack(x, with_coefficients=wc, device="cpu", **_kw(case, 1))
    assert got[0].dtype == torch.from_numpy(x).dtype
    if wc:
        assert got[1].shape == (2, len(got[1][0])) + x.shape[1:]
    _hold(got, ref, dtype)


KERNEL_CASES = [("known", True), ("known", False), ("lazy", False),
                ("bilateral", False), ("h-0.5", True),
                ("preserve-variance", True), ("triangle", True)]


@pytest.mark.parametrize("case,wc", KERNEL_CASES,
                         ids=[f"{c}-{'planes' if w else 'serving'}"
                              for c, w in KERNEL_CASES])
def test_wow_stack_matches_jax_kernels(stack, case, wc):
    # the batched Pallas bodies in interpret mode: the merged route in
    # serving mode with known noise, the pieces route (batch-major cube)
    # for the rest, as the JAX package dispatches a stack on a TPU
    x = stack.astype(np.float32)
    kw = _kw(case, 0)
    spec = JTRI if kw.pop("scaling_function", None) else JB3
    noise = kw.pop("noise", None)
    n, w, d, sb = jwow.normalize_wow_params(
        spec, kw.pop("n_scales"), kw.pop("weights", []),
        kw.pop("denoise_coefficients", []), kw.pop("bilateral", None),
        float(kw.get("h", 0)), 2, 256)
    statics = dict(sf=spec, n_scales=n, weights=w, whitening=True,
                   denoise_coefficients=d, bilateral=sb,
                   bilateral_scaling=False, soft_threshold=True,
                   preserve_variance=kw.pop("preserve_variance", False),
                   gamma=3.2, gamma_min=None, gamma_max=None,
                   h=float(kw.pop("h", 0)), has_noise=noise is not None)
    assert not kw
    noise_arr = jnp.broadcast_to(jnp.asarray(
        0.0 if noise is None else noise, jnp.float32), (2,))
    ref = jwow._stack_core(jnp.asarray(x), noise_arr, wc, statics,
                           force=True)
    got = T.wow_stack(x, with_coefficients=wc, device="cpu", **_kw(case, 1))
    _hold(got, ref, np.float32)


@pytest.mark.parametrize("case", ["known", "lazy", "bilateral", "h-0.5",
                                  "no-whitening"])
def test_frames_equal_single_frame_wow(stack, case):
    # per-frame statistics: frame b of the stack is wow of frame b (on
    # the CPU the plain versions of both routes round alike)
    x = stack.astype(np.float32)
    recon, planes = T.wow_stack(x, device="cpu", **_kw(case, 1))
    for b in range(2):
        kw = _kw(case, 1)
        r1, c1 = T.wow(x[b], device="cpu", **kw)
        assert torch.equal(recon[b], r1)
        assert torch.equal(planes[b], c1.data)


def test_noise_scalar_equals_noise_per_frame(stack):
    x = stack.astype(np.float32)
    a = T.wow_stack(x, noise=0.4, device="cpu", **_kw("lazy", 1))
    b = T.wow_stack(x, noise=[0.4, 0.4], device="cpu", **_kw("lazy", 1))
    c = T.wow_stack(x, noise=torch.tensor([0.4, 0.9]), device="cpu",
                    **_kw("lazy", 1))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    r1, _ = T.wow(x[1], noise=0.9, device="cpu", **_kw("lazy", 1))
    assert torch.equal(c[0][1], r1)


# the routes a stack takes, read from the plain versions' counters (a
# CPU tensor runs each kernel's plain version): the merged body only in
# serving mode with known noise; a frame's lazy noise takes the merged
# body (the port's single-frame rule) but a stack's the pieces route
ROUTES = {
    "known-serving": (dict(noise=0.4, with_coefficients=False),
                      {"whiten_group": 1, "whiten_step": 1}),
    "known-planes": (dict(noise=0.4),
                     {"decompose_group": 1, "whiten_plane": 1,
                      "whiten_step": 1}),
    "lazy-serving": (dict(with_coefficients=False),
                     {"decompose_group": 1, "whiten_plane": 1,
                      "whiten_step": 1, "median_select": 2}),
    "bilateral": (dict(bilateral=1, with_coefficients=False),
                  {"bilateral_group": 1, "whiten_plane": 1,
                   "bilateral_step": 1, "median_select": 2}),
    "h-0.5": (dict(h=0.5), {"decompose_group": 2, "whiten_plane": 2,
                            "median_select": 2}),
    "h-1": (dict(h=1), {"decompose_group": 4, "median_select": 2}),
    "no-whitening": (dict(whitening=False),
                     {"decompose_group": 4, "median_select": 2}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_stack_dispatch(stack, route):
    kw, plain = ROUTES[route]
    x = stack.astype(np.float32)
    _build.reset_counters()
    T.wow_stack(x, n_scales=4, denoise_coefficients=[5, 2], device="cpu",
                **kw)
    assert dict(_build.PLAIN_CALLS) == plain
    assert not _build.LAUNCHES


def test_wow_core_stack_axes(stack):
    # wow_core(axes=(1, 2)) is the stack; other axes are refused
    x = torch.from_numpy(stack.astype(np.float32))
    st = dict(sf=B3SPLINE, n_scales=3, weights=(1.0,) * 4, whitening=True,
              denoise_coefficients=(0.0,) * 4, bilateral=None,
              bilateral_scaling=False, soft_threshold=True,
              preserve_variance=False, gamma=3.2, gamma_min=None,
              gamma_max=None, h=0.0, has_noise=True)
    noise = torch.zeros(2)
    r, p = twow.wow_core(x, noise, axes=(1, 2), need_planes=False, **st)
    r2, _ = twow.wow_core(x, noise, axes=(-2, -1), **st)
    assert p is None and torch.equal(r, r2)
    with pytest.raises(ValueError, match="axes"):
        twow.wow_core(x, noise, axes=(0, 1), **st)


#: the fused body's calls to kernel D: (a stack?, options)
TABLE_CASES = {
    "bilateral-frame": (False, dict(bilateral=1,
                                    denoise_coefficients=[5, 2])),
    "bilateral-frame-weights": (False, dict(
        bilateral=1, weights=[0.3, 2, 1.1], denoise_coefficients=[5, 2])),
    "stack-weights": (True, dict(with_coefficients=False,
                                 weights=[0.3, 2, 1.1],
                                 denoise_coefficients=[5, 2])),
    "preserve-variance-stack": (True, dict(
        preserve_variance=True, noise=0.5, weights=[0.3, 2, 1.1],
        denoise_coefficients=[2])),
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_fused_factor_table_is_the_host_copy(stack, monkeypatch, case):
    # kernel D's factor table, filled on the frame's device, holds the
    # bits of torch.as_tensor of each weight (under preserve_variance, of
    # the device power norms w·sqrt(mean(c²)) per frame), and the call's
    # recon and planes are those that the copied table gives
    batched, kw = TABLE_CASES[case]
    x = torch.from_numpy(stack.astype(np.float32))
    w = [float(v) for v in kw.get("weights", [])] + [1.0] * 8
    pv = kw.get("preserve_variance", False)
    real = hopper_wow.fused_whiten_pieces
    tables, copied = [], []

    def spy(pieces, factors, thresholds, sf, n_fast, layout, **opts):
        def value(s):
            if not pv:
                return w[s]
            k, r = layout[s]
            norm = torch.stack([torch.sqrt(torch.mean(c ** 2))
                                for c in pieces[k][r]])
            return w[s] * (norm if opts["batch_major"] else norm[0])

        host = torch.stack([torch.as_tensor(value(s), dtype=torch.float32)
                            for s in range(n_fast)])
        tables.append((factors, host))
        return real(pieces, host if copied else factors, thresholds, sf,
                    n_fast, layout, **opts)

    monkeypatch.setattr(hopper_wow, "fused_whiten_pieces", spy)

    def run():
        if batched:
            return T.wow_stack(x, device="cpu", **kw)
        recon, coeffs = T.wow(x[0], device="cpu", **kw)
        return recon, coeffs.data

    filled = run()
    copied.append(True)
    recon, planes = run()
    assert len(tables) == 2
    factors, host = tables[0]
    assert factors.shape == ((3, 2) if batched and pv else (3,))
    assert torch.equal(factors, host)
    assert torch.equal(filled[0], recon)
    assert (planes is None) == (filled[1] is None)
    if planes is not None:
        assert torch.equal(filled[1], planes)


@pytest.mark.parametrize("dtype", ["bf16", "f16"])
def test_wow_stack_low_precision(dtype):
    # once refused: a serving stack below float32 runs the per-frame
    # plain loop, as the JAX _stack_core does (it merges float32 stacks
    # only), though a 256² bfloat16 frame alone takes the bfloat16 merged
    # body; it matches the JAX package's wow_stack within 2^-8·max (CPU
    # tensors)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float16, torch.float16))
    j = jnp.asarray(np.random.default_rng(6).normal(size=(2, 256, 256))
                    .astype(np.float32)).astype(jd)
    x = torch.from_numpy(to_np(j).astype(np.float32)).to(td)
    kw = dict(n_scales=5, denoise_coefficients=[3, 1])
    _build.reset_counters()
    r, p = T.wow_stack(x, noise=0.5, with_coefficients=False, **kw)
    assert p is None and r.dtype == td
    assert not _build.PLAIN_CALLS and not _build.LAUNCHES
    r_j, _ = J.wow_stack(j, noise=0.5, with_coefficients=False, **kw)
    assert_close_scaled(to_np(r).astype(np.float32),
                        to_np(r_j).astype(np.float32), 2 ** -8)


@pytest.mark.parametrize("bad", ["2d", "4d", "kwarg", "noise"])
def test_wow_stack_errors(bad):
    cpu = dict(device="cpu")
    calls = {
        "2d": (ValueError, lambda: T.wow_stack(np.zeros((64, 64)), **cpu)),
        "4d": (ValueError,
               lambda: T.wow_stack(np.zeros((1, 2, 64, 64)), **cpu)),
        "kwarg": (TypeError, lambda: T.wow_stack(np.zeros((2, 64, 64)),
                                                 nonsense=1, **cpu)),
        "noise": (RuntimeError, lambda: T.wow_stack(
            np.zeros((2, 64, 64)), noise=[1.0, 2.0, 3.0], **cpu)),
    }
    err, call = calls[bad]
    with pytest.raises(err):
        call()
    with pytest.raises(TypeError):
        J.wow_stack(np.zeros((2, 64, 64)), nonsense=1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(3, 64, 80), (2, 33, 17)])
def test_median_abs_frames(dtype, shape):
    x = np.random.default_rng(shape[1]).normal(size=shape).astype(dtype)
    x[1, :5] = 0.0
    ref = np.asarray(jstats.median_abs_frames(jnp.asarray(x)))
    for fuse in (True, False):
        _build.reset_counters()
        got = tstats.median_abs_frames(torch.from_numpy(x), fuse)
        assert got.shape == (shape[0],)
        assert np.array_equal(to_np(got), ref)
        if dtype == np.float32:
            # kernel B's wrapper once a frame (its plain version here)
            assert _build.PLAIN_CALLS == {"median_select": shape[0]}
        got = tstats.mad_noise_frames(torch.from_numpy(x), 0.89, fuse)
        want = np.asarray(jstats.mad_noise_frames(jnp.asarray(x), 0.89))
        assert_rel(got, want, 1e-6 if dtype == np.float32 else 1e-12)


@pytest.mark.parametrize("mode,rows", [("soft", 7), ("hard", 3),
                                       ("unmasked", 7)])
def test_pieces_batch_major_plain_vs_pallas(rows, mode):
    # the plain version of kernel D's batch-major layout against the TPU
    # kernel's (interpret mode), rows < n_fast; per-frame factors and
    # thresholds
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(2, 256, 256)).astype(np.float32) * 3
    from wavelets_tpu.ops import pallas_conv
    cube = np.array(pallas_conv._fused_group(jnp.asarray(x), 3, JB3,
                                             interpret=True))
    fac = np.array([[1.0, 0.5], [2.0, 1.5], [0.5, 3.0]], np.float32)
    thr = (np.array([[0.8, 1.6]] * 3, np.float32)
           * (0.0 if mode == "unmasked" else 1.0))
    layout = ((0, 0), (1, 0), (1, 1))
    kw = dict(soft=mode != "hard", batch_major=True, out_rows_total=rows,
              write_gamma=True)
    ref = pallas_wow.fused_whiten_pieces(
        (jnp.asarray(cube[:1]), jnp.asarray(cube[1:])), jnp.asarray(fac),
        jnp.asarray(thr), JB3, 3, layout, interpret=True, **kw)
    pieces = (torch.from_numpy(cube[:1]), torch.from_numpy(cube[1:]))
    got = hopper_wow.fused_whiten_pieces(
        pieces, torch.from_numpy(fac), torch.from_numpy(thr), B3SPLINE, 3,
        layout, **kw)
    assert got[0].shape == (2, rows, 256, 256)
    scale = float(np.abs(np.asarray(ref[1])).max())
    assert_close_scaled(got[0][:, :3], np.asarray(ref[0])[:, :3], 5e-6,
                        scale)
    assert_close_scaled(got[1], np.asarray(ref[1]), 5e-6)
    assert_close_scaled(got[2], np.asarray(ref[2]), 5e-6)
