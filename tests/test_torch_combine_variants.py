"""The block combines' launch plan and schedules, on the CPU.

K10b and K12b (``csrc/bank_combine.cu`` ``tiled_combine_kernel``,
``tiled_smoother_combine_kernel``) keep one lane's workspace in shared
memory with a leading dimension of 64 where dx ≤ 64 and it fits
(``ops/bank_combine.py`` ``block_tile``), else in global scratch with the
leading dimension rounded up to 64; K10b runs 512 threads a block at the
scan's narrow levels in float32 (``block_threads``). The rules are held at
their edges with the H100's shared-memory opt-in (232,448 bytes) and with
a smaller one.

The kernels' schedules are written out below in numpy, step by step, on
workspace matrices seeded with NaN, so that any read of an entry the
kernel never wrote shows, from the numpy models of
``bayesianfiltering_tpu_torch/testing.py`` (shared with
tests/test_torch_ut_block.py, which holds K8 and K9 the same way):

- ``tile_mm``: the register-tiled product of ``csrc/block_mm.cuh``, thread
  tile by thread tile over its super-tiles, with its skip rules and the
  masks of its epilogues (the ragged edge at dx = 9, 33, 63, 64, 65, 96);
- ``panel_cholesky``: ``common.cuh`` ``block_cholesky_panels`` with a
  leading dimension (the diagonal block, the rows below it, the lower
  trailing update, the pivots' reciprocals parked in the strict upper
  part), and K10b's handling of its two fail values: U zeroed unless every
  pivot is positive, the inner factor's pivots' reciprocals NaN;
- ``tri_solve``: the panel triangular solve, here with two right-hand
  sides, that replaces the inner factor's explicit inverse;
- the whole lane loops of K10b and K12b.

Each schedule is held, in float64 and float32, to the JAX package's XLA
twins ``bank_combine._combine_xla`` and ``bank_smoother._scombine_xla``
(float64), including the Cholesky guard (a C1 that is not positive
definite: M⁻¹ = I) and an inner matrix that is not positive definite
(NaN throughout). The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py).

Tolerances (relative to max(1, max|reference|)): float64 1e-10, float32
1e-3 (the bound chip_smoke.py holds every kernel to): the same function
in another order of summation.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianfiltering_tpu.ops import bank_combine as jbc
from bayesianfiltering_tpu.ops import bank_smoother as jbs
from bayesianfiltering_tpu_torch import testing
from bayesianfiltering_tpu_torch.ops import bank_combine as bc
from bayesianfiltering_tpu_torch.testing import panel_cholesky, put

torch.set_num_threads(1)

H100_OPTIN = 232_448  # cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100
H100_SMS = 132
TOL = {"float64": 1e-10, "float32": 1e-3}
NB = testing.PANEL  # the panel width (kWarp)
DXS = (9, 33, 63, 64, 65, 96)


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


_COMPILED = {}


def _jax_run(fn, *args):
    """``fn(*args)`` in float64, compiled once per function and shapes."""
    args = [jnp.asarray(a, jnp.float64) for a in args]
    key = (fn, tuple(a.shape for a in args))
    if key not in _COMPILED:
        _COMPILED[key] = jax.jit(fn).lower(*args).compile(FAST_COMPILE)
    return [np.asarray(o) for o in _COMPILED[key](*args)]


def _combine_xla(*a):
    return jbc._combine_xla(a[:5], a[5:])


def _scombine_xla(*a):
    return jbs._scombine_xla(a[:3], a[3:])


def assert_close(got, want, dtype):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------

K10B, K12B = bc.BLOCK_COMBINE, bc.BLOCK_SCOMBINE


@pytest.mark.parametrize("kind,dx,itemsize,optin,want", [
    (K10B, 9, 4, H100_OPTIN, 64),      # the band's lower edge
    (K10B, 33, 4, H100_OPTIN, 64),
    (K10B, 64, 4, H100_OPTIN, 64),     # path C
    (K10B, 65, 4, H100_OPTIN, 0),
    (K10B, 512, 4, H100_OPTIN, 0),     # the band's upper edge
    (K10B, 9, 8, H100_OPTIN, 64),
    (K10B, 64, 8, H100_OPTIN, 64),     # 25,344 elements: 202,752 bytes
    (K10B, 65, 8, H100_OPTIN, 0),
    (K12B, 64, 4, H100_OPTIN, 64),
    (K12B, 65, 4, H100_OPTIN, 0),
    (K12B, 64, 8, H100_OPTIN, 64),
    (K12B, 65, 8, H100_OPTIN, 0),
    (K10B, 64, 4, 96 * 1024, 0),       # a card with less: 101,376 bytes
    (K10B, 9, 4, 96 * 1024, 0),
    (K12B, 64, 4, 96 * 1024, 64),      # 83,968 bytes
])
def test_block_tile_rule(kind, dx, itemsize, optin, want):
    assert bc.block_tile(kind, dx, itemsize, optin) == want


def test_tiled_workspace_fits_the_h100_where_the_rule_says():
    assert bc.tiled_ws(K10B, 64) * 8 + 256 <= H100_OPTIN
    assert bc.tiled_ws(K10B, 64) * 4 + 256 > 96 * 1024
    assert bc.tiled_ws(K12B, 64) * 4 + 256 <= 96 * 1024


@pytest.mark.parametrize("kind,M,tile,itemsize,want", [
    (K10B, 1, 64, 4, 512),      # the scan's top levels
    (K10B, 4, 64, 4, 512),      # path C's narrow level
    (K10B, 132, 64, 4, 512),    # one lane an SM
    (K10B, 133, 64, 4, 256),
    (K10B, 512, 64, 4, 256),    # path C's in-chunk combines
    (K10B, 65_536, 64, 4, 256),  # path C's step 4
    (K10B, 4, 0, 4, 256),       # no 512-thread kernel on the global route
    (K10B, 4, 64, 8, 256),      # float64 keeps 256
    (K12B, 4, 64, 4, 256),      # K12b keeps 256 throughout
    (K12B, 1, 64, 4, 256),
    (K12B, 512, 64, 4, 256),
])
def test_block_threads_rule(kind, M, tile, itemsize, want):
    assert bc.block_threads(kind, M, tile, itemsize, H100_SMS) == want


# ---------------------------------------------------------------------------
# csrc/block_mm.cuh and common.cuh, step by step
# ---------------------------------------------------------------------------

def tile_mm(A, B, n, at, plan, K=None, a_row=0, b_row=0, row_lo=0,
            lower=False):
    """``testing.tile_mm`` over n × n outputs with the launch's threads."""
    return testing.tile_mm(A, B, n, n, n if K is None else K, at, plan[2],
                           a_row=a_row, b_row=b_row, row_lo=row_lo,
                           lower=lower)


def workspace(ld, count, dtype):
    return [np.full((ld, ld), np.nan, dtype) for _ in range(count)]


def plan_for(kind, dx, dtype, nt):
    """(ld, tile, threads) of a launch at dx on an H100: ``nt`` threads
    where a kernel of that size is built, else 256."""
    tile = bc.block_tile(kind, dx, np.dtype(dtype).itemsize, H100_OPTIN)
    if kind != K10B or tile != bc.TILE or dtype != np.float32:
        nt = 256
    return (tile or -(-dx // 64) * 64), tile, nt


def k10b_model(left, right, dtype, nt=256):
    """K10b's lane loop in numpy: the workspace B0..B5 (NaN-seeded, kept
    from lane to lane), the same steps as ``tiled_combine_kernel``."""
    n = left[0].shape[-1]
    M = left[0].shape[0]
    plan = plan_for(K10B, n, dtype, nt)
    ld = plan[0]
    B0, B1, B2, B3, B4, B5 = workspace(ld, 6, dtype)
    dinv = np.full(ld, np.nan, dtype)
    cast = lambda x: np.asarray(x, dtype)
    out = [np.empty((M, n, n), dtype), np.empty((M, n), dtype),
           np.empty((M, n, n), dtype), np.empty((M, n, n), dtype),
           np.empty((M, n), dtype)]
    idx = np.arange(n)
    low = idx[:, None] >= idx[None, :]  # i ≥ j
    eye = np.eye(ld, dtype=dtype)
    for m in range(M):
        A1, b1, C1, J1, e1 = (cast(x[m]) for x in left)
        A2, b2, C2, J2, e2 = (cast(x[m]) for x in right)
        B0[:n, :n], B1[:n, :n] = C1, J2
        eps = dtype(1e-7) * np.trace(B0[:n, :n]) / dtype(n) + dtype(1e-30)
        v0 = b1 + B0[:n, :n] @ e2
        v1 = e2 - B1[:n, :n] @ b1
        # lower(C1 + εI), column-major, factored; U zeroed unless PD
        sub = B2[:n, :n].T.copy()
        sub[low] = (B0[:n, :n] + eps * np.eye(n, dtype=dtype))[low]
        B2[:n, :n] = sub.T
        bad_u = panel_cholesky(B2, n)
        U = np.where(low.T & (not bad_u), B2[:n, :n], 0).astype(dtype)  # Uᵀ
        B2[:n, :n] = U
        B3[:n, :n] = U.T
        C, mask = tile_mm(B1, B3, n, False, plan)   # (J2 U)ᵀ
        B4.T[mask] = C[mask]
        put(B5, *tile_mm(B4, B3, n, False, plan))  # (Uᵀ J2 U)ᵀ
        B3[:n, :n] = A2.T                            # A2ᵀ
        G = B5[:n, :n].copy()
        inner = (0.5 * (G + G.T) + np.eye(n, dtype=dtype)).astype(dtype)
        sub = B5[:n, :n].T.copy()
        sub[low] = inner[low]
        B5[:n, :n] = sub.T
        bad_inner = panel_cholesky(B5, n)
        dinv[:] = np.nan if bad_inner else 1
        if not bad_inner:
            dinv[:n] = 1 / np.diag(B5[:n, :n])
        testing.tri_solve(B5, dinv, B2, n, B4, n, n, plan[2])  # X, Y
        put(B5, *tile_mm(B2, B4, n, True, plan), f=lambda c: eye - c)
        put(B2, *tile_mm(B5, B1, n, True, plan))    # M⁻ᵀ J2
        put(B4, *tile_mm(B3, B5, n, True, plan))    # A2M
        v2 = B5[:n, :n].T @ v1
        B1[:n, :n] = A1
        put(B5, *tile_mm(B4, B0, n, False, plan))   # A2M C1
        out[1][m] = B4[:n, :n] @ v0 + b2
        put(B0, *tile_mm(B2, B1, n, False, plan))   # M⁻ᵀ J2 A1
        C, mask = tile_mm(B4, B1, n, False, plan)   # A
        out[0][m] = np.where(mask[:n, :n], C[:n, :n], np.nan)
        out[4][m] = B1[:n, :n].T @ v2 + e1
        put(B2, *tile_mm(B1, B0, n, True, plan))    # A1ᵀ M⁻ᵀ J2 A1
        put(B4, *tile_mm(B5, B3, n, False, plan))   # A2M C1 A2ᵀ
        B2[:n, :n] += J1
        B4[:n, :n] += C2
        for X, o in ((B2, 3), (B4, 2)):
            T = X[:n, :n].copy()
            X[:n, :n] = 0.5 * (T + T.T)
            out[o][m] = X[:n, :n]
    return out


def k12b_model(earlier, later, dtype):
    """K12b's lane loop in numpy (``tiled_smoother_combine_kernel``)."""
    n = earlier[0].shape[-1]
    M = earlier[0].shape[0]
    plan = plan_for(K12B, n, dtype, 256)
    B0, B1, B2, B3, B4 = workspace(plan[0], 5, dtype)
    cast = lambda x: np.asarray(x, dtype)
    out = [np.empty((M, n, n), dtype), np.empty((M, n), dtype),
           np.empty((M, n, n), dtype)]
    idx = np.arange(n)
    low = idx[:, None] >= idx[None, :]
    for m in range(M):
        E1, g1, L1 = (cast(x[m]) for x in earlier)
        E2, g2, L2 = (cast(x[m]) for x in later)
        B4[:n, :n], B0[:n, :n], B1[:n, :n], B2[:n, :n] = L1, E1.T, E2, L2
        C, mask = tile_mm(B0, B1, n, True, plan)      # E
        out[0][m] = np.where(mask[:n, :n], C[:n, :n], np.nan)
        put(B3, *tile_mm(B0, B2, n, True, plan))      # X = E1 L2
        out[1][m] = B0[:n, :n].T @ g2 + g1
        C, mask = tile_mm(B3, B0, n, False, plan, lower=True)
        assert mask[:n, :n][low].all()               # W's lower half
        put(B1, C, mask)
        W = np.where(low, B1[:n, :n], B1[:n, :n].T)  # read from the lower
        L = B4[:n, :n]
        out[2][m] = 0.5 * ((W + L) + (W + L.T))
    return out


# ---------------------------------------------------------------------------
# The product, the factor and the solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dx", DXS)
@pytest.mark.parametrize("nt", [256, 512])
@pytest.mark.parametrize("at,lower", [(True, False), (False, False),
                                      (False, True)])
def test_tile_mm_masks_the_ragged_edge(dx, nt, at, lower):
    """Every output below n is the exact product, read only from the
    entries the caller wrote (the rest is NaN); nothing past n is stored;
    the lower-half product still stores all of i ≥ j."""
    plan = plan_for(K10B, dx, np.float32, nt)
    ld = plan[0]
    rng = np.random.default_rng(dx)
    A, B, X = workspace(ld, 3, np.float64)
    a, b = rng.standard_normal((2, dx, dx))
    A[:dx, :dx] = a.T if at else a
    B[:dx, :dx] = b
    put(X, *tile_mm(A, B, dx, at, plan, lower=lower))
    want = a @ b
    got = X[:dx, :dx]
    keep = np.tril(np.ones((dx, dx), bool)) if lower else np.ones_like(
        got, bool)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-12, atol=1e-12)
    assert np.isnan(X[dx:]).all() and np.isnan(X[:, dx:]).all()


@pytest.mark.parametrize("dx", DXS)
@pytest.mark.parametrize("pd", [True, False])
def test_panel_factor_zeroes_u_and_its_strict_upper_part(dx, pd):
    """K10b's first factor on NaN-seeded scratch: U = chol(C1 + εI) with a
    zero strict upper part (the panel factor leaves it as it was and parks
    its pivots' reciprocals there), or zero throughout when some pivot is
    not positive (the guard)."""
    rng = np.random.default_rng(dx)
    ld = -(-dx // 32) * 32
    C1 = testing.spd(rng, 1, dx)[0]
    if not pd:
        C1[dx // 2, dx // 2] = -1.0
    W = np.full((ld, ld), np.nan)
    idx = np.arange(dx)
    low = idx[:, None] >= idx[None, :]
    sub = W[:dx, :dx].T.copy()
    sub[low] = C1[low]
    W[:dx, :dx] = sub.T
    bad = panel_cholesky(W, dx)
    U = np.where(low.T & (not bad), W[:dx, :dx], 0).T
    assert bad == (not pd)
    if pd:
        assert np.isfinite(W[:dx, :dx][low.T]).all()
        assert (np.triu(U, 1) == 0).all()
        np.testing.assert_allclose(U @ U.T, C1, rtol=0, atol=1e-10)
        assert dx <= NB or np.isfinite(W[NB, :NB]).all()  # parked
    else:
        assert (U == 0).all()


@pytest.mark.parametrize("dx", DXS)
def test_panel_solve_matches_a_triangular_solve(dx):
    rng = np.random.default_rng(dx)
    plan = plan_for(K10B, dx, np.float64, 256)
    ld = plan[0]
    L = np.linalg.cholesky(testing.spd(rng, 1, dx)[0] + np.eye(dx))
    Lc, R1, R2 = workspace(ld, 3, np.float64)
    Lc[:dx, :dx] = np.where(np.tril(np.ones((dx, dx), bool)), L, np.nan).T
    dinv = np.full(ld, 7.0)
    dinv[:dx] = 1 / np.diag(L)
    r1, r2 = rng.standard_normal((2, dx, dx))
    R1[:dx, :dx], R2[:dx, :dx] = r1, r2
    testing.tri_solve(Lc, dinv, R1, dx, R2, dx, dx, plan[2])
    np.testing.assert_allclose(R1[:dx, :dx], np.linalg.solve(L, r1),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(R2[:dx, :dx], np.linalg.solve(L, r2),
                               rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# Whole lanes against the JAX twins
# ---------------------------------------------------------------------------

M_LANES = 3


def filter_lanes(dx, seed):
    rng = np.random.default_rng(seed)
    make = lambda: testing.filter_elements(rng, M_LANES, dx, max(1, dx // 2),
                                           normalized=True)
    return make(), make()


@functools.lru_cache(maxsize=None)
def combine_case(dx, case):
    """(left, right, JAX's combine): "plain", "guard" (lane 0's C1 with a
    −1e-4 eigenvalue, below what its factor takes in either type) or
    "nan_inner" (J2 = −1e3·I: the inner matrix is not positive
    definite)."""
    left, right = filter_lanes(dx, dx)
    if case == "guard":
        C = left[2].copy()
        C[0] = testing.guard_lanes(np.random.default_rng(0), left,
                                   neg=-1e-4)[2][0]
        left = left[:2] + (C,) + left[3:]
    if case == "nan_inner":
        J = np.broadcast_to(-1e3 * np.eye(dx), right[3].shape).copy()
        right = right[:3] + (J,) + right[4:]
    want = _jax_run(_combine_xla, *left, *right)
    return left, right, want


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dx", DXS)
def test_k10b_schedule_matches_jax(dx, dtype):
    left, right, want = combine_case(dx, "plain")
    got = k10b_model(left, right, np.dtype(dtype).type)
    for g, w in zip(got, want):
        assert_close(g, w, dtype)


@pytest.mark.parametrize("dx", [33, 64])
def test_k10b_narrow_schedule_matches_jax(dx):
    """512 threads a block: thread tiles of 4 × 2."""
    left, right, want = combine_case(dx, "plain")
    got = k10b_model(left, right, np.float32, nt=512)
    for g, w in zip(got, want):
        assert_close(g, w, "float32")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dx", [9, 64, 65])
def test_k10b_guard_gives_the_identity_solve(dx, dtype):
    """Lane 0's C1 fails its factor on both sides: U = 0, M⁻¹ = I."""
    left, right, want = combine_case(dx, "guard")
    got = k10b_model(left, right, np.dtype(dtype).type)
    for g, w in zip(got, want):
        assert_close(g, w, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dx", [33, 96])
def test_k10b_failed_inner_factor_is_nan(dx, dtype):
    left, right, want = combine_case(dx, "nan_inner")
    got = k10b_model(left, right, np.dtype(dtype).type)
    for g, w in zip(got, want):
        assert np.isnan(g).all() and np.isnan(w).all()


@functools.lru_cache(maxsize=None)
def smoother_case(dx):
    rng = np.random.default_rng(dx)
    earlier = testing.smoother_elements(rng, M_LANES, dx)
    later = testing.smoother_elements(rng, M_LANES, dx)
    want = _jax_run(_scombine_xla, *earlier, *later)
    return earlier, later, want


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dx", DXS)
def test_k12b_schedule_matches_jax(dx, dtype):
    earlier, later, want = smoother_case(dx)
    got = k12b_model(earlier, later, np.dtype(dtype).type)
    for g, w in zip(got, want):
        assert_close(g, w, dtype)
