"""The EKF kernels' variant rule and the tiled update's schedule, on the CPU.

``ops/fused_ekf.py`` runs the per-element kernels K1/K2 where their
workspace fits in a block's shared memory and the tiled variants K1t/K2t
otherwise. The rule is held at its edges with the H100's shared-memory
opt-in (232,448 bytes per block) and with a smaller one.

K1t (``csrc/ekf_tiled.cu``) factors the augmented matrix
[S; (H P)ᵀ; innovᵀ; I] in one launch (``csrc/tiled_chol.cuh``: panels of
32, a grid barrier between them, S's preparation folded into the first
touch of each tile, log N and μ = m + Zᵀ z in the epilogue) and forms the
gain as K = Zᵀ L⁻¹. That schedule is written out below in numpy, phase by
phase as the launch computes it (the factor, shared with K8t, in
``testing.augmented_factor``: on NaN-seeded scratch, its tasks checked to
read nothing another task of their phase writes), and held to the JAX
package's XLA twin (``fused_ekf._update_xla``) at shapes that are not
multiples of the panel or of a tile and at config 5's (dx, dy) = (512,
256) and (512, 128), with a non-positive-definite S failing in the first,
a middle or the last panel. K2t is two launches: F_x P and F_q Q as one
grouped launch (two products in one grid, the product picked by block
index), then lower(F_x P F_xᵀ + F_q Q F_qᵀ) mirrored; both are written out
block by block (``testing.run_gemms``: each block's tile, its share of
the inner dimension and the cluster's sum, on a NaN-seeded scratch
addressed as the kernel addresses it, no entry stored twice) and held to
``fused_ekf._predict_xla`` at config 5's dx = dq = 512 and at ragged
shapes, at B = 1 and 3. The port's wrappers on CPU tensors (the plain
twins) are held to JAX at the same shapes. The CUDA kernels themselves run
only on the card (tests/test_torch_cuda.py).

The references run in float64. Tolerances (relative to max(1,
max|reference|)): float64 1e-9, float32 1e-4, as
tests/test_torch_kernels.py: the same formulas in another order, and
float32 rounding through a Cholesky of S.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianfiltering_tpu.ops import fused_ekf as jfe
from bayesianfiltering_tpu_torch import testing
from bayesianfiltering_tpu_torch.ops import fused_ekf as fe

torch.set_num_threads(1)

H100_OPTIN = 232_448  # cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100
NB = 32               # csrc/ekf_tiled.cu kNb
TOL = {"float64": 1e-9, "float32": 1e-4}


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def assert_close(got, want, dtype):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.nanmax(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


# the JAX references compile at XLA's lowest optimisation level (their
# blocked factorisations unroll) and once per shape, in float64
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
JITTER = 1e-4


def _jax_run(fn, *args):
    args = [jnp.asarray(a, jnp.float64) for a in args]
    compiled = jax.jit(fn).lower(*args).compile(FAST_COMPILE)
    return [np.asarray(x) for x in compiled(*args)]


@functools.lru_cache(maxsize=None)
def update_case(B, dx, dy):
    """Inputs and the JAX reference of the update at one shape."""
    args = testing.update_inputs(np.random.default_rng(dx + dy), B, dx, dy)
    update = jax.vmap(lambda *a: jfe._update_xla(*a, JITTER))
    return args, _jax_run(update, *args)


# ---------------------------------------------------------------------------
# The rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dx,dy,itemsize,optin,want", [
    (64, 32, 4, H100_OPTIN, "K1"),     # the batched Lorenz-96 filter
    (64, 32, 8, H100_OPTIN, "K1"),
    (127, 32, 4, H100_OPTIN, "K1"),    # 58,048 elements: fits to the byte
    (128, 32, 4, H100_OPTIN, "K1T"),
    (117, 40, 4, H100_OPTIN, "K1"),    # the edge at dy = 40 in float32
    (118, 40, 4, H100_OPTIN, "K1T"),
    (75, 32, 8, H100_OPTIN, "K1"),     # and at dy = 32 in float64
    (76, 32, 8, H100_OPTIN, "K1T"),
    (14, 67, 8, H100_OPTIN, "K1"),     # 29,024 elements: fits to the byte
    (14, 68, 8, H100_OPTIN, "K1T"),
    (100, 50, 4, H100_OPTIN, "K1"),
    (100, 50, 8, H100_OPTIN, "K1T"),
    (512, 256, 4, H100_OPTIN, "K1T"),  # config 5, joint update
    (512, 128, 4, H100_OPTIN, "K1T"),  # config 5, chunked update
    (64, 32, 4, 48 * 1024, "K1T"),     # a card without the opt-in
])
def test_update_variant_rule(dx, dy, itemsize, optin, want):
    assert fe.update_kernel(dx, dy, itemsize, optin) is getattr(fe, want)


@pytest.mark.parametrize("dx,dq,itemsize,optin,want", [
    (64, 64, 4, H100_OPTIN, "K2"),
    (64, 64, 8, H100_OPTIN, "K2"),     # 24,576 elements
    (65, 65, 8, H100_OPTIN, "K2T"),
    (96, 96, 4, H100_OPTIN, "K2"),     # 55,296 elements
    (97, 97, 4, H100_OPTIN, "K2T"),
    (76, 118, 4, H100_OPTIN, "K2"),    # 58,048 elements: fits to the byte
    (512, 512, 4, H100_OPTIN, "K2T"),  # config 5
    (64, 64, 8, 64 * 1024, "K2T"),
])
def test_predict_variant_rule(dx, dq, itemsize, optin, want):
    assert fe.predict_kernel(dx, dq, itemsize, optin) is getattr(fe, want)


def test_the_rule_flips_once_along_each_dimension():
    """Growing any dimension moves a shape from the per-element kernel to
    the tiled one and never back."""
    for itemsize in (4, 8):
        for dy in (1, 33, 128):
            picks = [fe.update_kernel(dx, dy, itemsize, H100_OPTIN).name
                     for dx in range(1, 300)]
            flip = picks.index(fe.K1T.name)
            assert set(picks[:flip]) <= {fe.K1.name}
            assert set(picks[flip:]) == {fe.K1T.name}
        picks = [fe.predict_kernel(dx, dx, itemsize, H100_OPTIN).name
                 for dx in range(1, 200)]
        flip = picks.index(fe.K2T.name)
        assert set(picks[:flip]) == {fe.K2.name}
        assert set(picks[flip:]) == {fe.K2T.name}


# ---------------------------------------------------------------------------
# K1t's schedule
# ---------------------------------------------------------------------------

def tiled_batch(args, jitter, blocks=132):
    """K1t over a batch, launch by launch, on scratch seeded with NaN: the
    products (H P)ᵀ and G = lower((H P) Hᵀ), the one-launch factor with
    its epilogue (ll, μ), K = Zᵀ L⁻¹, then the Joseph covariance."""
    m, P, H, R, inn = args
    dx, dy = P.shape[-1], inn.shape[-1]
    HPt = np.swapaxes(P, -1, -2) @ np.swapaxes(H, -1, -2)     # (H P)ᵀ
    G = np.full(HPt.shape[:-2] + (dy, dy), np.nan, P.dtype)
    lower = np.tri(dy, dtype=bool)
    G[:, lower] = (np.swapaxes(HPt, -1, -2) @ np.swapaxes(H, -1, -2))[:,
                                                                     lower]
    f = testing.augmented_factor(G, HPt, inn, R, jitter, blocks)
    ll, mean = f.gain(dx, m)
    Zt, Linv_t = f.L[:, dy:dy + dx], f.L[:, dy + dx + 1:]
    K = Zt @ np.swapaxes(Linv_t, -1, -2)
    Rs = 0.5 * (R + np.swapaxes(R, -1, -2))
    A = np.eye(dx) - K @ H
    cov = np.tril((A @ P) @ np.swapaxes(A, -1, -2)
                  + (K @ Rs) @ np.swapaxes(K, -1, -2))
    cov = cov + np.swapaxes(np.tril(cov, -1), -1, -2)          # mirrored
    return ll, mean, cov, K


TILED_SHAPES = [(2, 9, 1), (1, 65, 33), (3, 100, 40)]


@pytest.mark.parametrize("B,dx,dy", TILED_SHAPES)
def test_tiled_update_schedule_matches_the_reference(B, dx, dy):
    args, want = update_case(B, dx, dy)
    for g, w in zip(tiled_batch(args, JITTER), want):
        assert_close(g, w, "float64")


@pytest.mark.parametrize("B,dx,dy", [(1, 20, 97), (2, 7, 64)])
def test_tiled_update_schedule_over_more_panels_matches_the_plain_twin(
        B, dx, dy):
    """Three and four panels (the port's plain twin is held to JAX above
    and in tests/test_torch_kernels.py; JAX's unrolled factorisation
    compiles slowly at these widths)."""
    args = testing.update_inputs(np.random.default_rng(dy), B, dx, dy)
    want = fe._update_plain(*(torch.as_tensor(a) for a in args), JITTER)
    for g, w in zip(tiled_batch(args, JITTER), want):
        assert_close(g, w, "float64")


@pytest.mark.parametrize("fail_at", [0, 40, 69])
def test_tiled_update_schedule_gives_nan_on_a_non_pd_s(fail_at):
    """A negative pivot in the first panel, the middle one or only in the
    last (ragged) one: every output is NaN, as in the plain twin."""
    m, P, H, R, inn = testing.update_inputs(np.random.default_rng(3), 1, 12,
                                            70)
    R[0, fail_at, fail_at] = -1e3
    got = tiled_batch((m, P, H, R, inn), 0.0)
    want = fe._update_plain(*(torch.as_tensor(a) for a in (m, P, H, R, inn)))
    for g, w in zip(got, want):
        assert np.isnan(g).all() and torch.isnan(w).all()


# config 5's joint and chunked updates, held to the XLA twin in float64
# (1e-10) and in float32 (1e-3), the bound chip_smoke.py holds K1t to
CONFIG5_TOL = {"float64": 1e-10, "float32": 1e-3}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dy", [256, 128])
def test_tiled_update_schedule_at_config_5_matches_jax(dtype, dy):
    args, want = update_case(1, 512, dy)
    got = tiled_batch([a.astype(dtype) for a in args], JITTER)
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=CONFIG5_TOL[dtype] * scale)


# ---------------------------------------------------------------------------
# K2t's schedule
# ---------------------------------------------------------------------------

def tiled_predict(Fx, P, Fq, Q):
    """K2t over a batch, launch by launch, on its scratch (F_x P, then
    F_q Q an element) seeded with NaN, in the inputs' dtype. Returns Σ and
    the two launches' plans."""
    B, dx, dq = Fq.shape
    dt = P.dtype
    st = testing.k2t_scratch(dx, dq)
    xx, xq = dx * dx, dx * dq
    fx, p, fq, q = (np.ascontiguousarray(a).ravel() for a in (Fx, P, Fq, Q))
    ws = np.full(B * st, np.nan, dt)
    Mat, Gemm = testing.Mat, testing.Gemm
    # 1. F_x P and F_q Q, one grouped launch (Q shared: batch stride 0)
    phase1 = testing.run_gemms([
        Gemm(dx, dx, B, (dx, 0), (Mat(fx, 0, dx, xx), None),
             (Mat(p, 0, dx, xx), None), (1.0, 0.0), ws, 0, dx, st),
        Gemm(dx, dq, B, (dq, 0), (Mat(fq, 0, dq, xq), None),
             (Mat(q, 0, dq, 0), None), (1.0, 0.0), ws, xx, dq, st)])
    # 2. Σ = lower(F_x P F_xᵀ + F_q Q F_qᵀ), mirrored
    cov = np.full(B * xx, np.nan, dt)
    phase2 = testing.run_gemms([Gemm(
        dx, dx, B, (dx, dq), (Mat(ws, 0, dx, st), Mat(ws, xx, dq, st)),
        (Mat(fx, 0, dx, xx, True), Mat(fq, 0, dq, xq, True)), (1.0, 1.0),
        cov, 0, dx, xx, tri=testing.LOWER_MIRROR)])
    return cov.reshape(B, dx, dx), phase1, phase2


@functools.lru_cache(maxsize=None)
def predict_case(B, dx, dq):
    """Inputs and the JAX reference of the covariance predict."""
    args = testing.predict_inputs(np.random.default_rng(dx + dq), B, dx, dq)
    want = _jax_run(jax.vmap(lambda *a: (jfe._predict_xla(*a),),
                             in_axes=(0, 0, 0, None)), *args)[0]
    return args, want


# config 5's (dx = dq = 512), a panel and a tile ragged, dq = 1, dq > dx;
# held as config 5's update (1e-10 / 1e-3)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dx,dq", [(512, 512), (200, 70), (100, 1),
                                   (33, 97)])
def test_tiled_predict_schedule_matches_jax(dtype, B, dx, dq):
    args, want = predict_case(B, dx, dq)
    got, phase1, _ = tiled_predict(*(a.astype(dtype) for a in args))
    assert np.isfinite(got).all() and got.shape == want.shape
    np.testing.assert_array_equal(got, np.swapaxes(got, -1, -2))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.astype(np.float64), want, rtol=0,
                               atol=CONFIG5_TOL[dtype] * scale)
    if (B, dx, dq) == (1, 512, 512):
        # 2 × 128 tiles of 64 × 32 in one launch fill the card without a
        # k-split, where each product alone took a split of 2
        assert phase1 == {"tile": (64, 32), "threads": 128, "split": 1,
                          "blocks": 256}


# ---------------------------------------------------------------------------
# The wrappers at K1t's and K2t's shapes (the plain twins on CPU tensors)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B,dx,dy", TILED_SHAPES)
def test_update_wrapper_at_tiled_shapes_matches_jax(dtype, B, dx, dy):
    args, want = update_case(B, dx, dy)
    got = fe.fused_update(*(torch.as_tensor(np.asarray(a, dtype))
                            for a in args), JITTER)
    for g, w in zip(got, want):
        assert_close(g, w, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B,dx,dq", [(1, 121, 121), (3, 65, 9), (2, 9, 33)])
def test_predict_wrapper_at_tiled_shapes_matches_jax(dtype, B, dx, dq):
    args = testing.predict_inputs(np.random.default_rng(dx + dq), B, dx, dq)
    want = _jax_run(jax.vmap(lambda *a: (jfe._predict_xla(*a),),
                             in_axes=(0, 0, 0, None)), *args)[0]
    got = fe.fused_predict_cov(*(torch.as_tensor(np.asarray(a, dtype))
                                 for a in args))
    assert_close(got, want, dtype)
