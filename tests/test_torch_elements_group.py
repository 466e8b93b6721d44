"""The RTS smoothing elements K11 (dx ≤ 8) written out in numpy, group by
group, on the CPU.

``csrc/bank_combine.cu`` ``bank_smoother_elements_kernel`` (K11) gives each
lane a group of MX threads (MX = 4 for dx ≤ 4, else 8) on
``csrc/lane_group.cuh``, thread i holding row i of the lane's Pf, Pp and F.
Below, the numpy model ``testing.Group`` stands for the groups (one array
row a thread, shuffles as index exchanges, the board seeded with NaN so
that a read of an entry no thread wrote shows), and the steps are the
kernel's, in its order and with its four slots and bounds: Pf | mp and F
to the board; Lp = chol(Pp) by the column sweep (over the dx real pivots
in the groups of 4 threads, over all 8 with unit padded pivots in those of
8), NaN on a failed pivot; each thread's column of F Pf from F's rows and
Pf's column; its forward substitution (column i of Y = Lp⁻¹ F Pf) and back
substitution (row i of G) with Lp's rows from the board; L = sym(Pf) − YᵀY
from the board's rows of Yᵀ; g = mf − G mp.

The schedule is held to the JAX package's XLA twin
``bank_smoother._elements_xla`` at dx = 1, 2, 3, 4, 5 and 8 with F shared
and banked, in float64 and float32, and to its Pallas kernel
``_elements_pallas`` in interpret mode at dx = 2 and 4 (the interpret-mode
lattice at dx = 8 takes a minute); a non-positive-definite Pp makes every
output of its lane NaN and leaves the others as they were; L is exactly
symmetric (the board's bank layout at four slots is checked with K3's and
K4's in tests/test_torch_bank_update_group.py). The CUDA kernel runs only
on the card (tests/test_torch_cuda.py).

Tolerances (relative to max(1, max|reference|)): float64 1e-10, float32
1e-3 (the bound chip_smoke.py holds every kernel to): the same function in
another order of summation.
"""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianfiltering_tpu.ops import bank_smoother as jbs
from bayesianfiltering_tpu_torch import testing
from bayesianfiltering_tpu_torch.ops import bank_smoother as tbs
from bayesianfiltering_tpu_torch.testing import Group

pl = pytest.importorskip("jax.experimental.pallas")
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

SOURCE = (Path(__file__).resolve().parents[1] / "bayesianfiltering_tpu_torch"
          / "csrc" / "bank_combine.cu")
found = re.search(r"constexpr int kElementsSlots = (\d+);", SOURCE.read_text())
assert found
SLOTS = int(found[1])  # csrc/bank_combine.cu kElementsSlots
TOL = {"float64": 1e-10, "float32": 1e-3}
DXS = (1, 2, 3, 4, 5, 8)
LANES = 6


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
_COMPILED = {}


def _elements_xla(*args):
    """``bank_smoother._elements_xla`` in float64, compiled once per
    shape."""
    args = [jnp.asarray(a, jnp.float64) for a in args]
    key = tuple(a.shape for a in args)
    if key not in _COMPILED:
        _COMPILED[key] = jax.jit(jbs._elements_xla).lower(*args).compile(
            FAST_COMPILE)
    return [np.asarray(o) for o in _COMPILED[key](*args)]


def k11_model(fm, fP, pm, pP, F, dtype):
    """``bank_smoother_elements_kernel`` over M = len(fm) lanes, F shared
    (dx, dx) or banked (M, dx, dx). Returns ``(E, g, L)``."""
    M, dx = fm.shape
    mx = 4 if dx <= 4 else 8
    nx = dx if mx == 4 else mx  # the bound of the factor and the solves
    g = Group(M, mx, dx, dtype, slots=SLOTS)
    lanes = np.arange(M)
    Fl = F if F.ndim == 3 else np.broadcast_to(F, (M, dx, dx))
    pf, lp, f = (g.load(x, lanes) for x in (fP, pP, Fl))
    mf, mpe = g.load(fm, lanes), g.load(pm, lanes)
    i = g.i[None, :]
    own = (g.i[:, None] == g.i[None, :])[None]      # thread i's entry i
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        # first exchange: Pf | mp, F, then Lp | 1/diag(Lp)
        g.put_row(0, pf)
        g.put_row(1, f)
        g.put_el(0, mpe)
        lp = np.where(own & (i >= dx)[..., None], 1, lp).astype(dtype)
        L, ok, rinv = g.chol(lp, nx)
        L = np.where(ok[:, None, None], L, np.nan).astype(dtype)
        rinv = np.where(ok[:, None], rinv, np.nan).astype(dtype)
        g.put_row(2, L)
        g.put_el(2, rinv)
        # each thread: X[:, i] = F Pf[:, i], Lp y = X[:, i], Lpᵀ e = y
        y = g.rowmul_t(g.get_col(0), 1)
        rl = g.get_vec(2)
        for j in range(nx):
            lj = g.get_row(2, j)
            a = y[..., j]
            for k in range(j):
                a = a - lj[..., k] * y[..., k]
            y[..., j] = a * rl[..., j]
        g.put_row(3, y)
        e = y.copy()
        for j in reversed(range(nx)):
            lj = g.get_row(2, j)
            e[..., j] = e[..., j] * rl[..., j]
            for k in range(j):
                e[..., k] = e[..., k] - lj[..., k] * e[..., j]
        # second exchange: Yᵀ; L = sym(Pf) − YᵀY, g = mf − G mp
        w = g.rowmul_t(y, 3)
        Lo = (dtype(0.5) * (pf + g.get_col(0)) - w).astype(dtype)
        go = (mf - g.dot(e, g.get_vec(0))).astype(dtype)
    return e[:, :dx, :dx], go[:, :dx], Lo[:, :dx, :dx]


def assert_matches(got, want, dtype):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


@functools.lru_cache(maxsize=None)
def case(dx):
    """Inputs over LANES lanes (F banked), and the XLA twin's outputs with
    F banked and with lane 0's F shared."""
    raw = testing.smoother_element_inputs(np.random.default_rng(dx), LANES,
                                          dx)
    fm, fP, pm, pP, F = raw
    shared = np.broadcast_to(F[0], F.shape)
    return raw, _elements_xla(*raw), _elements_xla(fm, fP, pm, pP, shared)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dx", DXS)
def test_k11_schedule_matches_jax(dx, dtype, shared):
    (fm, fP, pm, pP, F), banked_want, shared_want = case(dx)
    dt = np.dtype(dtype).type
    got = k11_model(fm, fP, pm, pP, F[0] if shared else F, dt)
    for gv, w in zip(got, shared_want if shared else banked_want):
        assert gv.dtype == np.dtype(dtype)
        assert_matches(gv, w, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dx", [2, 4])
def test_k11_schedule_matches_the_pallas_kernel(dx, dtype):
    """The kernel's XLA twin in each dtype, and the TPU kernel itself in
    interpret mode once, at the smallest shape (dx = 2, float32; its 1e-30
    diagonal floor is far below either dtype's rounding)."""
    (fm, fP, pm, pP, F), _, _ = case(dx)
    dt = np.dtype(dtype)
    args = tuple(jnp.asarray(a, dt) for a in (fm, fP, pm, pP, F))
    got = k11_model(fm, fP, pm, pP, F, dt.type)
    for gv, w in zip(got, jbs._elements_xla(*args)):
        assert_matches(gv, np.asarray(w), dtype)
    if (dx, dtype) == (2, "float32"):
        with pltpu.force_tpu_interpret_mode():
            want = jbs._elements_pallas(*args)
        for gv, w in zip(got, want):
            assert_matches(gv, np.asarray(w), dtype)


@pytest.mark.parametrize("dx,fail_at", [(4, 0), (4, 3), (2, 1), (5, 4),
                                        (8, 0), (1, 0)])
def test_a_non_pd_pp_makes_its_lane_nan(dx, fail_at):
    """Pp of lane 2 with −1e3 at pivot ``fail_at`` (at its last real pivot
    for fail_at = dx − 1): G, g and L of lane 2 are NaN throughout, as the
    plain version's (``psd_solve``), and the other lanes match it."""
    fm, fP, pm, pP, F = testing.smoother_element_inputs(
        np.random.default_rng(dx + 30), LANES, dx)
    pP = pP.copy()
    pP[2, fail_at, fail_at] = -1e3
    got = k11_model(fm, fP, pm, pP, F, np.float64)
    want = tbs._elements_plain(*(torch.as_tensor(a)
                                 for a in (fm, fP, pm, pP, F)))
    keep = np.arange(LANES) != 2
    for gv, w in zip(got, want):
        w = w.numpy()
        assert np.isnan(gv[2]).all() and np.isnan(w[2]).all()
        np.testing.assert_allclose(gv[keep], w[keep], rtol=0, atol=1e-10)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dx", DXS)
def test_l_is_exactly_symmetric(dx, dtype):
    """Entry (i, j) of YᵀY is y_i · y_j summed in one order on thread i and
    y_j · y_i in the same order on thread j: the same bits."""
    (fm, fP, pm, pP, F), _, _ = case(dx)
    _, _, L = k11_model(fm, fP, pm, pP, F, np.dtype(dtype).type)
    np.testing.assert_array_equal(L, np.swapaxes(L, 1, 2))
