"""The EKF update (K1) and covariance predict (K2) kernels' schedules, on the
CPU.

K1 and K2 (``csrc/fused_ekf.cu`` ``ekf_update_kernel``,
``ekf_predict_cov_kernel``) run one thread block an element on
``csrc/block_mm.cuh``. K1 stages P, H and Rt, forms H P (stored, and
stored transposed), S = sym(Rt + H (H P)ᵀ) with the relative floor,
factors S with the panel factor (panels of 8 at dy ≤ 8, of 16 above),
solves [Z | z | L⁻¹] = L⁻¹ [H P | innov | I] with one rectangular panel
solve, forms W = Kᵀ = L⁻ᵀ Z, Aᵀ = I − Hᵀ W, [A P | K Rt]ᵀ = [sym(P) Aᵀ ;
sym(Rt) W] and the Joseph covariance as one product [A P | K Rt] · [Aᵀ ;
W] over its packed lower tiles (``tile_mm_lower``) whose epilogue stores
each tile and its mirror; μ = m + K innov and ll from the factor's
diagonal and z. K2 stages [Fx | 0 | Fq], P and Q, symmetrises P and Q,
stores (Fx P)ᵀ and (Fq Q)ᵀ below one another and forms Σ⁺ = [Fx | 0 |
Fq] · G as one lower-half product (``tile_mm``'s lower mode), mirrored.

Both schedules are written out below in numpy, step by step, on one flat
workspace laid out as ``UpdateWs`` and ``PredictWs`` lay it out (regions
reused where the kernel reuses them) and seeded with NaN, so that a read
of an entry the kernel never wrote, or of a region a later step has
overwritten, shows as NaN; each step also checks that what it writes
does not overlap what it reads in the same barrier interval. The
block_mm.cuh models are those of ``bayesianfiltering_tpu_torch/testing.py``
(``tile_mm`` thread tile by thread tile, ``tile_mm_lower``, ``put``,
``put_t``, ``put_mirrored``, ``panel_cholesky``, ``tri_solve``). The
schedules are
held to the JAX package's XLA twins ``fused_ekf._update_xla`` and
``_predict_xla`` (float64) at the batched Lorenz-96 EKF's shapes (dx = 64,
dy = 32; dx = dq = 64), the bearings-only widths (dx = 4, dy = 1 and 2:
the narrow panel; dq = 2), ragged edges (dx = 65, dy = 33), four and six
panels (dy = 64, 96), both sides of the narrow panel (dy = 8 | 9), an
asymmetric P, Rt and Q (the kernels symmetrise them, as the reference's
symmetrised outputs imply), a non-positive-definite S failing in the first
or in a later panel, or in the one narrow panel (NaN throughout), and an S
with a condition number of ~6e5 (H with singular values from 1 to 1e-3,
Rt = 2e-6·I). There the float32 gain cannot hold 1e-3 by any float32
evaluation of the reference's algorithm: the port's plain version errs
4.5e-3 in the gain and 1.03e-3 in the mean. So there the schedule's float32
log-likelihood and covariance are held to 1e-3, every float32 output to
no more than 1.25 times the plain version's float32 error on the same
inputs (the schedule's: 3.8e-3 and 1.02e-3), and the Joseph covariance
must stay exactly symmetric and positive semidefinite to rounding.

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
import torch

from bayesianfiltering_tpu.ops import fused_ekf as jfe
from bayesianfiltering_tpu_torch import testing
from bayesianfiltering_tpu_torch.ops import fused_ekf as fe

TOL = {"float64": 1e-10, "float32": 1e-3}
NT = 256               # csrc/fused_ekf.cu kThreads
REL_JITTER = 1e-6      # common.cuh kRelJitter
PANEL = 16             # fused_ekf.cu kPanel: the factor's and solve's panel
NARROW_PANEL = 8       # kNarrowPanel: the panel at dy ≤ 8
JITTER = 1e-4


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

def _jax_each(fn, *args, in_axes=None, wide=True):
    """``fn`` (one element's twin) over the batch in float64. Where
    ``wide`` (a factored dimension above 16) and the batch is at most 4:
    element by element, eagerly, stacked; on a concrete single element the
    JAX package factors by its native route
    (``utils/linalg._effectively_unbatched``), where the jitted, vmapped
    batch unrolls its blocked factorisation and compiled for 10-20 s at the
    wide shapes; the two agree to rounding. Else vmapped and jitted (the
    unrolled factor of a small matrix runs slowly op by op)."""
    in_axes = in_axes or (0,) * len(args)
    B = next(a.shape[0] for a, ax in zip(args, in_axes) if ax == 0)
    if not wide or B > 4:
        return _jax_run(jax.vmap(fn, in_axes=in_axes), *args)
    f64 = lambda a: jnp.asarray(a, jnp.float64)
    outs = [fn(*(f64(a[b]) if ax == 0 else f64(a)
                 for a, ax in zip(args, in_axes)))
            for b in range(B)]
    if not isinstance(outs[0], (tuple, list)):
        return np.stack([np.asarray(o) for o in outs])
    return [np.stack([np.asarray(o[k]) for o in outs])
            for k in range(len(outs[0]))]



def assert_close(got, want, dtype):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


def _ru(x, m):
    return -(-x // m) * m


class Workspace:
    """One block's flat workspace, seeded with NaN, and its named regions
    (offset, rows, leading dimension) as 2-D views."""

    def __init__(self, total, regions, dtype):
        self.flat = np.full(total, np.nan, dtype)
        self.regions = regions
        for off, rows, ld in regions.values():
            assert off % 32 == 0 and ld % 32 == 0 and off + rows * ld <= total

    def __getitem__(self, name):
        off, rows, ld = self.regions[name]
        return self.flat[off:off + rows * ld].reshape(rows, ld)

    def step(self, reads, writes):
        """A barrier interval: what it writes must not overlap what it
        reads (regions updated in place are not listed)."""
        def cover(names):
            m = np.zeros(self.flat.size, bool)
            for n in names:
                off, rows, ld = self.regions[n]
                m[off:off + rows * ld] = True
            return m
        assert not (cover(reads) & cover(writes)).any(), (reads, writes)


def symmetrize(X, n):
    """block_mm.cuh ``symmetrize``: each pair below the diagonal and its
    mirror ← their mean, in place."""
    lo = np.tril_indices(n, -1)
    v = X.dtype.type(0.5) * (X[lo] + X[lo[1], lo[0]])
    X[lo] = v
    X[lo[1], lo[0]] = v


# ---------------------------------------------------------------------------
# K1, step by step
# ---------------------------------------------------------------------------

def update_layout(dx, dy):
    """``UpdateWs``: (total, regions, oi), with [(A P)ᵀ ; (K Rt)ᵀ] over H
    and the right-hand side, and (H P)ᵀ and S under Aᵀ and W."""
    ldx, ldy = _ru(dx, 32), _ru(dy, 32)
    oi = _ru(dx + 1, 4)
    ldr = _ru(oi + dy, 32)
    rt = dx * ldx
    h = rt + dy * ldy
    rhs = h + _ru(dy, 4) * ldx
    q = max(rhs + ldy * ldr, h + (dx + dy) * ldx)
    lc, w = q + dx * ldy, q + dx * ldx
    dinv = max(lc + ldy * ldr, w + dy * ldx)
    total = dinv + 2 * ldy
    assert total == fe._update_ws(dx, dy)
    regions = dict(P=(0, dx, ldx), Rt=(rt, dy, ldy), H=(h, _ru(dy, 4), ldx),
                   rhs=(rhs, ldy, ldr), Xt=(h, dx + dy, ldx),
                   HPt=(q, dx, ldy), S=(lc, ldy, ldr), At=(q, dx, ldx),
                   W=(w, dy, ldx), AtW=(q, dx + dy, ldx), dinv=(dinv, 1, ldy),
                   inn=(dinv + ldy, 1, ldy))
    return total, regions, oi


def k1_model(m, P, H, R, inn, jitter, dtype):
    """One element of K1 in ``dtype``: (ll, mean, cov, gain K)."""
    m, P, H, R, inn = (np.asarray(x, dtype) for x in (m, P, H, R, inn))
    dx, dy = P.shape[-1], inn.shape[-1]
    total, regions, oi = update_layout(dx, dy)
    ws = Workspace(total, regions, dtype)
    ps, rs, hs, rhs, xt = ws["P"], ws["Rt"], ws["H"], ws["rhs"], ws["Xt"]
    hpt, lc, at, wr = ws["HPt"], ws["S"], ws["At"], ws["W"]
    dinv, innv = ws["dinv"][0], ws["inn"][0]
    # 0. staging; the innovation and the identity into the right-hand side
    ps[:, :dx], hs[:dy, :dx], rs[:, :dy] = P, H, R
    innv[:dy] = inn
    rhs[:dy, dx] = inn
    rhs[:dy, oi:oi + dy] = np.eye(dy, dtype=dtype)
    # 1. H P into the right-hand side, and its transpose
    ws.step(["H", "P"], ["rhs", "HPt"])
    C, mask = testing.tile_mm(hs, ps, dy, dx, dx, False, NT)
    testing.put(rhs, C, mask)
    testing.put_t(hpt, C, mask)
    # 2. Rt + H (H P)ᵀ into S; P symmetrised in place
    ws.step(["H", "HPt", "Rt"], ["S"])
    C, mask = testing.tile_mm(hs, hpt, dy, dy, dx, False, NT)
    at_ = np.nonzero(mask)
    lc[at_] = rs[at_] + C[at_]
    symmetrize(ps, dx)
    # 3. S = sym(Rt + G) with the floor; Rt symmetrised in place
    symmetrize(lc, dy)
    symmetrize(rs, dy)
    d = np.arange(dy)
    lc[d, d] += dtype(jitter) + dtype(REL_JITTER) * np.abs(lc[d, d]).max()
    # 4. the panel factor; the pivots' reciprocals (NaN unless every pivot
    #    is positive) and Σ log Lᵢᵢ
    width = NARROW_PANEL if dy <= NARROW_PANEL else PANEL
    bad = testing.panel_cholesky(lc, dy, width)
    dinv[:] = np.nan if bad else 1
    if not bad:
        dinv[:dy] = 1 / lc[d, d]
    logdet = np.log(lc[d, d]).sum()
    # 5. [Z | z | L⁻¹] = L⁻¹ [H P | innov | I] in place
    testing.tri_solve(lc, dinv, rhs, dx + 1, rhs[:, oi:], dy, dy, NT, width)
    # 6. ll; W = Kᵀ = L⁻ᵀ Z below Aᵀ and as the gain
    ws.step(["rhs"], ["W"])
    z = rhs[:dy, dx]
    ll = dtype(-0.5) * (dtype(dy * math.log(2 * math.pi)) + 2 * logdet
                        + (z * z).sum())
    C, mask = testing.tile_mm(rhs[:, oi:], rhs, dy, dx, dy, True, NT)
    testing.put(wr, C, mask)
    kt = np.full((dy, dx), np.nan, dtype)
    testing.put(kt, C, mask)
    # 7. Aᵀ = I − Hᵀ W; μ = m + K innov
    ws.step(["H", "W", "inn"], ["At"])
    C, mask = testing.tile_mm(hs, wr, dx, dx, dy, True, NT)
    testing.put(at, C, mask, lambda c: np.eye(*c.shape, dtype=dtype) - c)
    mean = m + wr[:dy, :dx].T @ innv[:dy]
    # 8. [(A P)ᵀ ; (K Rt)ᵀ] = [sym(P) Aᵀ ; sym(Rt) W] over H and the
    #    right-hand side
    ws.step(["At", "W", "P", "Rt"], ["Xt"])
    C, mask = testing.tile_mm(ps, at, dx, dx, dx, True, NT)
    testing.put(xt, C, mask)
    C, mask = testing.tile_mm(rs, wr, dy, dx, dy, True, NT)
    testing.put(xt[dx:], C, mask)
    # 9. cov = [A P | K Rt] · [Aᵀ ; W]: the packed lower tiles, mirrored
    C, mask = testing.tile_mm_lower(xt, ws["AtW"], dx, dx + dy)
    cov = np.full((dx, dx), np.nan, dtype)
    testing.put_mirrored(cov, C, mask)
    return ll, mean, cov, kt.T.copy()


def k1_batch(args, jitter, dtype):
    outs = [k1_model(*(a[b] for a in args), jitter, dtype)
            for b in range(args[0].shape[0])]
    return [np.stack(x) for x in zip(*outs)]


def _jax_update(args, jitter=JITTER):
    return _jax_each(lambda *a: jfe._update_xla(*a, jitter), *args,
                     wide=max(args[1].shape[-1], args[3].shape[-1]) > 16)


def _asymmetric(rng, X, scale=0.05):
    """X plus a strictly upper-triangular perturbation in every element."""
    n = X.shape[-1]
    return X + scale * np.triu(rng.standard_normal((n, n)), 1)


@functools.lru_cache(maxsize=None)
def update_case(B, dx, dy, asym):
    """The update's inputs (with an asymmetric P and Rt when ``asym``) and
    the JAX reference (ll, mean, cov, K)."""
    rng = np.random.default_rng(dx + dy)
    args = list(testing.update_inputs(rng, B, dx, dy))
    if asym:
        args[1], args[3] = _asymmetric(rng, args[1]), _asymmetric(rng, args[3])
    return args, _jax_update(args)


# (B, dx, dy, asymmetric P and Rt): the batched Lorenz-96 EKF (S in two
# panels of 16), the bearings-only widths (dy = 1 and 2 in one narrow
# panel), a ragged S and H P (dy = 33, dx = 65: two panels and one row, I
# from column 68), four and six panels (dy = 64, 96), both sides of the
# narrow panel (dy = 8 | 9), small odd widths, one state and one
# measurement
UPDATE_SHAPES = [(2, 64, 32, False), (2, 64, 32, True), (4, 4, 1, False),
                 (4, 4, 2, True), (2, 65, 33, False), (2, 40, 64, True),
                 (1, 40, 96, False), (3, 12, 8, False), (3, 12, 9, True),
                 (2, 7, 3, False), (2, 1, 1, False)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B,dx,dy,asym", UPDATE_SHAPES)
def test_k1_schedule_matches_jax(B, dx, dy, asym, dtype):
    args, want = update_case(B, dx, dy, asym)
    got = k1_batch(args, JITTER, np.dtype(dtype).type)
    for g, w in zip(got, want):
        assert_close(g, w, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dy,fail_at", [(70, 0), (70, 69), (2, 1)])
def test_k1_schedule_gives_nan_on_a_non_pd_s(dy, fail_at, dtype):
    """A negative pivot in the first panel, or only in the fifth (the last,
    rows 64–69), or in the one narrow panel at dy = 2: every output is NaN,
    as in the port's plain version (cholesky_nan)."""
    args = list(testing.update_inputs(np.random.default_rng(3), 2, 12, dy))
    args[3] = args[3].copy()
    args[3][:, fail_at, fail_at] = -1e3
    for g in k1_batch(args, 0.0, np.dtype(dtype).type):
        assert np.isnan(g).all()


@functools.lru_cache(maxsize=None)
def ill_conditioned_case(B=2, dx=64, dy=32):
    """L96-sized inputs whose H has singular values from 1 to 1e-3 and
    Rt = 2e-6·I: cond(S) ~ 6e5 (returned); the innovation is drawn from
    N(0, S), as a consistent filter sees it."""
    rng = np.random.default_rng(7)
    U, _ = np.linalg.qr(rng.standard_normal((dx, dx)))
    V, _ = np.linalg.qr(rng.standard_normal((dy, dy)))
    H = np.broadcast_to(V @ (np.logspace(0, -3, dy)[:, None] * U[:, :dy].T),
                        (B, dy, dx))
    m = rng.standard_normal((B, dx))
    P = testing.spd(rng, B, dx)
    R = np.broadcast_to(2e-6 * np.eye(dy), (B, dy, dy))
    S = H @ P @ np.swapaxes(H, -1, -2) + R
    inn = (np.linalg.cholesky(S) @ rng.standard_normal((B, dy, 1)))[..., 0]
    args = [np.ascontiguousarray(a) for a in (m, P, H, R, inn)]
    return args, _jax_update(args, 0.0), float(np.linalg.cond(S).max())


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return (float(np.abs(np.asarray(got, np.float64) - want).max())
            / max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_k1_schedule_holds_at_an_ill_conditioned_s(dtype):
    """float64: every output within 1e-10. float32: ll and cov within 1e-3,
    and every output no less accurate than the plain version (the
    reference's algorithm in PyTorch) in float32 on the same inputs, up to
    a factor 1.25."""
    args, want, cond = ill_conditioned_case()
    assert 1e5 < cond < 1e7
    got = k1_batch(args, 0.0, np.dtype(dtype).type)
    if dtype == "float64":
        for g, w in zip(got, want):
            assert_close(g, w, dtype)
    else:
        assert_close(got[0], want[0], dtype)
        assert_close(got[2], want[2], dtype)
        plain = fe._update_plain(*(torch.as_tensor(a, dtype=torch.float32)
                                   for a in args), 0.0)
        for g, p, w in zip(got, plain, want):
            assert np.isfinite(g).all()
            assert _rel(g, w) <= max(TOL[dtype], 1.25 * _rel(p.numpy(), w))
    cov = got[2].astype(np.float64)
    assert (cov == np.swapaxes(cov, -1, -2)).all()
    eig = np.linalg.eigvalsh(cov)
    assert (eig >= -TOL[dtype] * np.abs(eig).max(-1, keepdims=True)).all()


# ---------------------------------------------------------------------------
# K2, step by step
# ---------------------------------------------------------------------------

def predict_layout(dx, dq):
    """``PredictWs``: (total, regions, oq)."""
    oq = _ru(dx, 4)
    ldF, ldx, ldq = _ru(oq + dq, 32), _ru(dx, 32), _ru(dq, 32)
    p = oq * ldF
    q = p + dx * ldx
    g = q + dq * ldq
    total = g + (oq + dq) * ldx
    assert total == fe._predict_ws(dx, dq)
    return total, dict(F=(0, oq, ldF), P=(p, dx, ldx), Q=(q, dq, ldq),
                       G=(g, oq + dq, ldx)), oq


def k2_model(Fx, P, Fq, Q, dtype):
    """One element of K2 in ``dtype``: Σ⁺."""
    Fx, P, Fq, Q = (np.asarray(x, dtype) for x in (Fx, P, Fq, Q))
    dx, dq = Fq.shape
    total, regions, oq = predict_layout(dx, dq)
    ws = Workspace(total, regions, dtype)
    fs, ps, qs, gs = ws["F"], ws["P"], ws["Q"], ws["G"]
    # 0. staging; the pad columns of F and the pad rows of G zeroed
    fs[:dx, :dx], fs[:dx, dx:oq], fs[:dx, oq:oq + dq] = Fx, 0, Fq
    ps[:, :dx], qs[:, :dq] = P, Q
    gs[dx:oq] = 0
    # 1. P and Q symmetrised in place
    symmetrize(ps, dx)
    symmetrize(qs, dq)
    # 2. (Fx P)ᵀ and (Fq Q)ᵀ into G, stored transposed
    ws.step(["F", "P", "Q"], ["G"])
    C, mask = testing.tile_mm(fs, ps, dx, dx, dx, False, NT)
    testing.put_t(gs, C, mask)
    C, mask = testing.tile_mm(fs[:, oq:], qs, dx, dq, dq, False, NT)
    testing.put_t(gs[oq:], C, mask)
    # 3. Σ⁺ = [Fx | 0 | Fq] · G: lower tiles (tile_mm's lower mode), each
    #    mirrored
    C, mask = testing.tile_mm(fs, gs, dx, dx, oq + dq, False, NT, lower=True)
    cov = np.full((dx, dx), np.nan, dtype)
    testing.put_mirrored(cov, C, mask)
    return cov


@functools.lru_cache(maxsize=None)
def predict_case(B, dx, dq):
    """The predict's inputs with an asymmetric P and Q, and the JAX
    reference Σ⁺."""
    rng = np.random.default_rng(dx + dq)
    Fx, P, Fq, Q = testing.predict_inputs(rng, B, dx, dq)
    args = (Fx, _asymmetric(rng, P), Fq, _asymmetric(rng, Q))
    predict = jax.vmap(lambda *a: (jfe._predict_xla(*a),),
                       in_axes=(0, 0, 0, None))
    return args, _jax_run(predict, *args)[0]


# (B, dx, dq): the batched Lorenz-96 EKF, the bearings-only widths, ragged
# widths on either side (Fq from column 68 | 12), small odd widths, one
# noise dimension
PREDICT_SHAPES = [(2, 64, 64), (4, 4, 2), (2, 65, 9), (2, 9, 33), (2, 7, 3),
                  (2, 33, 1)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B,dx,dq", PREDICT_SHAPES)
def test_k2_schedule_matches_jax(B, dx, dq, dtype):
    (Fx, P, Fq, Q), want = predict_case(B, dx, dq)
    dt = np.dtype(dtype).type
    got = np.stack([k2_model(Fx[b], P[b], Fq[b], Q, dt) for b in range(B)])
    assert_close(got, want, dtype)
    assert (got == np.swapaxes(got, -1, -2)).all()
