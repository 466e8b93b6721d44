"""The UT update (K8) and predict (K9) kernels' schedules, on the CPU.

K8 and K9 (``csrc/fused_ut.cu`` ``ut_update_kernel``,
``ut_predict_kernel``) run one thread block an element on
``csrc/block_mm.cuh``: sigma-point rows staged in chunks of 64, centred in
place and reduced by one register-tiled product a chunk whose epilogue
adds into a shared accumulator (K8 [S | C] += Hcᵀ [Hc | Xc], K9 the lower
tiles of Σ ccᵀ); K8 then factors S with the panel factor (panels of 8
at dy ≤ 8, of 32 above), solves
[Z | z] = L⁻¹ [C | innov] with one rectangular panel solve and forms
cov = sym(P) − ZᵀZ as one lower-half product whose epilogue stores each
tile and its mirror, μ = m + Zᵀz and ll from the factor's diagonal and
zᵀz; K9 sums the staged chunks for μ first, then centres them and forms
the products (the last chunk first: it is still staged), and the final
product's epilogue weights the accumulated tiles, adds w0c·d0 d0ᵀ and
sym(Q) and stores each tile and its mirror.

Both schedules are written out below in numpy, step by step, on
workspaces laid out as the kernels lay them out and seeded with NaN (the
pad columns between Hc and Xc, and between S and C, stay NaN throughout),
with the block_mm.cuh models of ``bayesianfiltering_tpu_torch/testing.py``
(``tile_mm`` thread tile by thread tile, ``panel_cholesky``,
``tri_solve``), and held to the JAX package's XLA twins
``fused_ut._ut_update_xla`` and ``_ut_predict_xla`` (float64) at the
batched Lorenz-96 UKF's shapes (128 and 192 rows, dx = 64, dy = 32; 128
and 256 rows), the range-bearing banks' (12 rows, dx = 4, dy = 2), ragged
edges (dy = 33, dx = 65), two and three panels (dy = 64, 96), rows that
are not a multiple of the chunk, a non-positive-definite S (NaN
throughout, failing in the first or in the third panel), and an S with a
condition number of ~6e5, where every output holds the float32 tolerance
too and the mean m + Zᵀz is no less accurate than the explicit-inverse
form K8 had before (m + (L⁻ᵀL⁻¹C)ᵀ innov).

Tolerances (relative to max(1, max|reference|)): float64 1e-10, float32
1e-3, the bound chip_smoke.py holds every kernel to on the card. The CUDA
kernels themselves run only on the card (tests/test_torch_cuda.py).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesianfiltering_tpu.ops import fused_ut as jfu
from bayesianfiltering_tpu_torch import testing
from bayesianfiltering_tpu_torch.ops import fused_ut as fu
from bayesianfiltering_tpu_torch.ops.ukf import ParamsUKF, ut_weights

TOL = {"float64": 1e-10, "float32": 1e-3}
CHUNK = fu._ROW_CHUNK  # csrc/fused_ut.cu kRowChunk
NT = fu._THREADS       # kUtThreads
REL_JITTER = 1e-6      # common.cuh kRelJitter
NARROW_PANEL = 8       # fused_ut.cu kNarrowPanel: K8's panel at dy ≤ 8


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jax_run(fn, *args):
    args = [jnp.asarray(a, jnp.float64) for a in args]
    compiled = jax.jit(fn).lower(*args).compile(FAST_COMPILE)
    return [np.asarray(x) for x in compiled(*args)]


def assert_close(got, want, dtype):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


def weights(rows):
    """(w_side, w0m, w0c) of a UT over rows/2 dimensions (α = 1, β = 2)."""
    return ut_weights(rows // 2, ParamsUKF(1.0, 2.0, 0.0))[1]


def _ru(x, m):
    return -(-x // m) * m


def _nan(dtype, *shape):
    return np.full(shape, np.nan, dtype)


def _mirror(out, cov, mask):
    """put_rows then put_cols of every stored tile: (i, j) and (j, i)."""
    at = np.nonzero(mask)
    cov[at] = out[at]
    cov[at[1], at[0]] = out[at]
    n = cov.shape[0]
    assert (mask | mask.T)[:n, :n].all()  # every entry is stored


# ---------------------------------------------------------------------------
# K8, step by step
# ---------------------------------------------------------------------------

def update_layout(dx, dy):
    """``UpdateWs``: C's first column oc, the staged rows' and the
    accumulator's leading dimensions, P's, and the accumulator's rows."""
    oc = _ru(dy, 4)
    lstg, lsc = _ru(oc + dx, 32), _ru(oc + _ru(dx + 1, 4), 32)
    ldx, ry = _ru(dx, 32), _ru(dy, 32)
    assert (CHUNK * lstg + ry * lsc + dx * ldx + lstg + 2 * ry
            == fu._update_ws(dx, dy))
    return oc, lstg, lsc, ldx, ry


def k8_model(pts, hpts, cy, mu_y, m, P, R, innov, w, add_r, dtype):
    """One element of K8 in ``dtype``: (ll, mean, cov)."""
    cast = lambda x: np.asarray(x, dtype)
    pts, hpts, cy, mu_y, m, P, innov = map(
        cast, (pts, hpts, cy, mu_y, m, P, innov))
    R = cast(R) if add_r else None
    w_side, _, w0c = (dtype(x) for x in w)
    rows, dy = hpts.shape
    dx = m.shape[0]
    oc, lstg, lsc, ldx, ry = update_layout(dx, dy)
    stg, sc, ps = _nan(dtype, CHUNK, lstg), _nan(dtype, ry, lsc), _nan(
        dtype, dx, ldx)
    cv, d0, dinv = _nan(dtype, lstg), _nan(dtype, ry), _nan(dtype, ry)
    # 1. the centres [μy | 0 | m] and d0; the accumulator's dy rows cleared
    cv[:oc + dx] = 0
    cv[:dy], cv[oc:oc + dx] = mu_y, m
    d0[:dy] = cy - mu_y
    sc[:dy] = 0
    # 2. chunks: stage, centre in place, [S | C] += Hcᵀ [Hc | Xc]
    for r0 in range(0, rows, CHUNK):
        nr = min(CHUNK, rows - r0)
        stg[:nr, :dy] = hpts[r0:r0 + nr]
        stg[:nr, oc:oc + dx] = pts[r0:r0 + nr, :dx]
        if r0 == 0:
            ps[:, :dx] = P
        stg[:nr, :oc + dx] -= cv[:oc + dx]
        C, mask = testing.tile_mm(stg, stg, dy, oc + dx, nr, True, NT)
        at = np.nonzero(mask)
        sc[at] = sc[at] - (-C[at])
    # 3. S = sym(w_side·S + w0c·d0 d0ᵀ + R) from the lower entries, the
    #    diagonal with the relative floor; C ← w_side·C; the innovation
    V = w_side * sc[:dy, :dy] + w0c * np.outer(d0[:dy], d0[:dy])
    if R is not None:
        V = V + dtype(0.5) * (R + R.T)
    lo = np.tril_indices(dy, -1)
    sc[lo] = V[lo]
    sc[lo[1], lo[0]] = V[lo]
    diag = np.diag(V).copy()
    diag += dtype(REL_JITTER) * np.abs(diag).max()
    sc[np.arange(dy), np.arange(dy)] = diag
    sc[:dy, oc:oc + dx] *= w_side
    sc[:dy, oc + dx] = innov
    # 4. the panel factor in place (panels of 8 at dy ≤ 8, else of 32);
    #    the pivots' reciprocals, NaN unless every pivot is positive
    width = NARROW_PANEL if dy <= NARROW_PANEL else testing.PANEL
    bad = testing.panel_cholesky(sc, dy, width)
    dinv[:] = np.nan if bad else 1
    if not bad:
        dinv[:dy] = 1 / np.diag(sc)[:dy]
    # 5. [Z | z] = L⁻¹ [C | innov] in place
    testing.tri_solve(sc, dinv, sc[:, oc:], dx + 1, None, 0, dy, NT, width)
    Z = sc[:, oc:]
    # 6. cov = sym(P) − ZᵀZ: lower tiles, each stored and mirrored
    Psym = dtype(0.5) * (ps[:, :dx] + ps[:, :dx].T)
    cov = _nan(dtype, dx, dx)
    C, mask = testing.tile_mm(Z, Z, dx, dx, dy, True, NT, lower=True)
    _mirror(Psym - C[:dx, :dx], cov, mask)
    mean = cv[oc:oc + dx] + Z[:dy, :dx].T @ Z[:dy, dx]
    ll = dtype(-0.5) * (dtype(dy * math.log(2 * math.pi))
                        + 2 * np.log(np.diag(sc)[:dy]).sum()
                        + (Z[:dy, dx] ** 2).sum())
    return ll, mean, cov


def k8_batch(args, w, add_r, dtype):
    pts, hpts, cy, mu_y, m, P, R, innov = args
    outs = [k8_model(pts[b], hpts[b], cy[b], mu_y[b], m[b], P[b], R,
                     innov[b], w, add_r, dtype)
            for b in range(m.shape[0])]
    return [np.stack(x) for x in zip(*outs)]


def _jax_update(args, y, w, add_r, dx):
    pts, hpts, cy, _, m, P, R, _ = args
    update = jax.vmap(
        lambda p, h, c, m_, P_, R_, y_: jfu._ut_update_xla(
            p, h, c, m_, P_, R_, y_, w, add_r),
        in_axes=(0, 0, 0, 0, 0, None, 0))
    return _jax_run(update, pts[..., :dx], hpts, cy, m, P, R, y)


@functools.lru_cache(maxsize=None)
def update_case(B, rows, ld, dx, dy, add_r):
    """The update's inputs with μy and the innovation of the JAX twin, the
    weights, and the JAX reference (ll, mean, cov)."""
    rng = np.random.default_rng(rows + dx + dy)
    pts, hpts, cy, _, m, P, R, _ = testing.ut_update_inputs(rng, B, rows, ld,
                                                            dx, dy)
    y = rng.standard_normal((B, dy))
    w = weights(rows)
    mu_y = w[0] * hpts.sum(-2) + w[1] * cy
    args = (pts, hpts, cy, mu_y, m, P, R, y - mu_y)
    return args, w, _jax_update(args, y, w, add_r, dx)


# (B, rows, ld, dx, dy, add_r): the L96 UKF additive and augmented, the
# range-bearing banks (B = 100 and 64), a ragged S and C (dy = 33, dx = 65:
# a panel and one row, C at column 36), S in two and three panels, rows
# that are not a multiple of the chunk (130, 200, 70), both sides of the
# narrow panel (dy = 8 | 9), one measurement
UPDATE_SHAPES = [(2, 128, 64, 64, 32, True), (2, 192, 96, 64, 32, False),
                 (100, 12, 6, 4, 2, False), (64, 12, 6, 4, 2, False),
                 (2, 130, 70, 65, 33, True), (2, 130, 50, 40, 64, True),
                 (1, 200, 100, 40, 96, True), (3, 70, 35, 30, 5, True),
                 (3, 40, 20, 12, 8, True), (3, 40, 20, 12, 9, True),
                 (2, 18, 9, 9, 1, True)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B,rows,ld,dx,dy,add_r", UPDATE_SHAPES)
def test_k8_schedule_matches_jax(B, rows, ld, dx, dy, add_r, dtype):
    args, w, want = update_case(B, rows, ld, dx, dy, add_r)
    got = k8_batch(args, w, add_r, np.dtype(dtype).type)
    for g, wt in zip(got, want):
        assert_close(g, wt, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dy,fail_at", [(70, 0), (70, 69), (2, 1)])
def test_k8_schedule_gives_nan_on_a_non_pd_s(dy, fail_at, dtype):
    """A negative pivot in the first panel, or only in the third, or in the
    one narrow panel at dy = 2: every output is NaN, as in the port's plain
    version (cholesky_nan)."""
    args = list(testing.ut_update_inputs(np.random.default_rng(3), 2, 24, 12,
                                         12, dy))
    args[6] = args[6].copy()
    args[6][fail_at, fail_at] = -1e3
    got = k8_batch(args, weights(24), True, np.dtype(dtype).type)
    for g in got:
        assert np.isnan(g).all()


@functools.lru_cache(maxsize=None)
def ill_conditioned_case(B=2, rows=128, dx=64, dy=32):
    """L96-sized inputs whose images span dy directions with gains from 1
    to 1e-3 and R = 1e-6·I: cond(S) ~ 6e5 (returned); the measurement is
    drawn from N(μy, S), as a consistent filter sees it."""
    rng = np.random.default_rng(7)
    w = weights(rows)
    pts = rng.standard_normal((B, rows, dx))
    U, _ = np.linalg.qr(rng.standard_normal((dx, dx)))
    V, _ = np.linalg.qr(rng.standard_normal((dy, dy)))
    hpts = pts @ (U[:, :dy] * np.logspace(0, -3, dy)) @ V.T
    cy = 0.1 * rng.standard_normal((B, dy))
    m = rng.standard_normal((B, dx))
    P = testing.spd(rng, B, dx)
    R = 1e-6 * np.eye(dy)
    mu_y = w[0] * hpts.sum(-2) + w[1] * cy
    cen, d0 = hpts - mu_y[:, None], cy - mu_y
    S = (w[0] * np.swapaxes(cen, -1, -2) @ cen
         + w[2] * d0[:, :, None] * d0[:, None, :] + R)
    y = mu_y + (np.linalg.cholesky(S) @ rng.standard_normal((B, dy, 1)))[
        ..., 0]
    args = (pts, hpts, cy, mu_y, m, P, R, y - mu_y)
    return (args, w, _jax_update(args, y, w, True, dx),
            float(np.linalg.cond(S).max()))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_k8_schedule_holds_at_an_ill_conditioned_s(dtype):
    args, w, want, cond = ill_conditioned_case()
    assert 1e5 < cond < 1e7
    got = k8_batch(args, w, True, np.dtype(dtype).type)
    for g, wt in zip(got, want):
        assert_close(g, wt, dtype)


def explicit_inverse_mean(args, w):
    """The float32 mean in the form K8 had before: L⁻¹ formed explicitly,
    Kᵀ = L⁻ᵀ(L⁻¹C), μ = m + K innov (S and C as K8 forms them)."""
    f = np.float32
    pts, hpts, cy, mu_y, m, P, R, innov = args
    w_side, _, w0c = (f(x) for x in w)
    dx, dy = m.shape[-1], hpts.shape[-1]
    means = []
    for b in range(m.shape[0]):
        hc = (hpts[b] - mu_y[b]).astype(f)
        xc = (pts[b, :, :dx] - m[b]).astype(f)
        d0 = (cy[b] - mu_y[b]).astype(f)
        S = (w_side * (hc.T @ hc) + w0c * np.outer(d0, d0)
             + f(0.5) * (R + R.T).astype(f))
        S += f(REL_JITTER) * np.abs(np.diag(S)).max() * np.eye(dy, dtype=f)
        Li = np.linalg.inv(np.linalg.cholesky(S)).astype(f)
        Kt = Li.T @ (Li @ (w_side * (hc.T @ xc)))
        means.append(m[b].astype(f) + Kt.T @ innov[b].astype(f))
    return np.stack(means)


def test_k8_float32_mean_is_no_worse_than_the_explicit_inverse_form():
    """At cond(S) ~6e5 the mean m + Zᵀz errs no more than the
    explicit-inverse form K8 had before (both 7e-4 to 8e-4 of max|μ|,
    under the 1e-3 bound)."""
    args, w, want, _ = ill_conditioned_case()
    scale = max(1.0, float(np.abs(want[1]).max()))
    err = lambda mean: float(np.abs(mean - want[1]).max()) / scale
    ours = err(k8_batch(args, w, True, np.float32)[1])
    before = err(explicit_inverse_mean(args, w))
    assert ours <= TOL["float32"]
    assert ours <= 1.25 * before


# ---------------------------------------------------------------------------
# K9, step by step
# ---------------------------------------------------------------------------

def k9_model(fpts, center, Q, w, add_q, dtype):
    """One element of K9 in ``dtype``: (μ, Σ)."""
    cast = lambda x: np.asarray(x, dtype)
    fpts, center, Q = map(cast, (fpts, center, Q))
    w_side, w0m, w0c = (dtype(x) for x in w)
    rows, dx = fpts.shape
    ldx = _ru(dx, 32)
    assert (CHUNK + dx) * ldx + 2 * ldx + max(ldx, NT) == fu._predict_ws(dx)
    stg, acc = _nan(dtype, CHUNK, ldx), _nan(dtype, dx, ldx)
    mu, d0, part = _nan(dtype, ldx), _nan(dtype, ldx), _nan(dtype,
                                                           max(NT, ldx))
    # μ: every chunk staged in turn and summed by columns, max(1, 256/dx)
    # interleaved parts of its rows a column, the parts then summed
    parts = max(1, NT // dx)
    chunks = range(0, rows, CHUNK)
    part[:parts * dx] = 0
    for r0 in chunks:
        nr = min(CHUNK, rows - r0)
        stg[:nr, :dx] = fpts[r0:r0 + nr]
        for p in range(parts):
            part[p * dx:(p + 1) * dx] += stg[p:nr:parts, :dx].sum(0)
    acc[:] = 0
    s = part[:parts * dx].reshape(parts, dx).sum(0)
    mu[:dx] = w_side * s + w0m * center
    d0[:dx] = center - mu[:dx]
    cov = _nan(dtype, dx, dx)
    # the centred products, the last chunk (still staged) first
    for r0 in reversed(chunks):
        nr = min(CHUNK, rows - r0)
        if r0 != chunks[-1]:
            stg[:nr, :dx] = fpts[r0:r0 + nr]
        stg[:nr, :dx] -= mu[:dx]
        C, mask = testing.tile_mm(stg, stg, dx, dx, nr, True, NT, lower=True)
        at = np.nonzero(mask)
        if r0 > 0:
            acc[at] = acc[at] - (-C[at])
            continue
        # the final product's epilogue: weights, d0 d0ᵀ, sym(Q), mirrored
        out = (w_side * (acc[:dx, :dx] + C[:dx, :dx])
               + w0c * np.outer(d0[:dx], d0[:dx]))
        if add_q:
            out = out + dtype(0.5) * (Q + Q.T)
        _mirror(out, cov, mask)
    return mu[:dx].copy(), cov


@functools.lru_cache(maxsize=None)
def predict_case(B, rows, dx, add_q):
    """The predict's inputs (fpts, center, Q) with an asymmetric Q, the
    weights, and the JAX reference (μ, Σ)."""
    rng = np.random.default_rng(rows + dx)
    fpts, center, Q = testing.ut_predict_inputs(rng, B, rows, dx)
    Q = Q + 0.1 * np.triu(rng.standard_normal((dx, dx)), 1)
    w = weights(rows)
    predict = jax.vmap(lambda f, c, q: jfu._ut_predict_xla(f, c, q, w, add_q),
                       in_axes=(0, 0, None))
    return (fpts, center, Q), w, _jax_run(predict, fpts, center, Q)


# (B, rows, dx, add_q): the L96 UKF additive and augmented, the
# range-bearing banks (B = 100 and 32), ragged widths with rows that are
# not a multiple of the chunk, one dimension
PREDICT_SHAPES = [(2, 128, 64, True), (2, 256, 64, False),
                  (100, 12, 4, False), (32, 12, 4, False),
                  (2, 130, 65, True), (3, 70, 33, False), (2, 4, 1, True)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B,rows,dx,add_q", PREDICT_SHAPES)
def test_k9_schedule_matches_jax(B, rows, dx, add_q, dtype):
    (fpts, center, Q), w, want = predict_case(B, rows, dx, add_q)
    dt = np.dtype(dtype).type
    outs = [k9_model(fpts[b], center[b], Q, w, add_q, dt) for b in range(B)]
    for g, wt in zip([np.stack(x) for x in zip(*outs)], want):
        assert_close(g, wt, dtype)
