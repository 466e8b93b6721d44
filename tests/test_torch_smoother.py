"""The port's linear-Gaussian filters and smoothers (sequential and
temporally parallel) and the plain versions of the combine kernels K10–K12
against the JAX package, on the CPU.

The model is the parallel Kalman benchmark's (F = 0.99·I + 0.01·N/dx,
H = N/dx, Q = R = 0.1·I) at small T, with N(0, 1) emissions, made with
numpy and carried into the port by ``params_from_jax``. On the CPU the JAX
package runs its XLA combines (its kernels' gate is off there) and the port
its plain versions.

Tolerances, relative to max(1, max|reference|): float64 1e-10 — the same
formulas, factored and summed in another order; float32 1e-4 — a few
thousand float32 combines through a Woodbury inverse. The parallel paths
meet the sequential oracle only to 1e-6 in float64: the Woodbury combine's
trace-relative jitter (ε = 1e-7·tr/dx) moves them at the 1e-7 level, the
same on both sides of the JAX comparison, which uses the same combine tree.
The plain combines
against the Pallas kernels in interpret mode (float32) use the bounds
``tests/test_pallas.py`` holds those kernels to against XLA: 2e-5 for the
two combines, 2e-4 for the elements, whose gain goes through a Cholesky
solve of Pp.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianfiltering_tpu.ops import associative as jas
from bayesianfiltering_tpu.ops import bank_combine as jbc
from bayesianfiltering_tpu.ops import bank_smoother as jbs
from bayesianfiltering_tpu.ops import linear as jlin
from bayesianfiltering_tpu_torch import _build, testing
from bayesianfiltering_tpu_torch.models import params_from_jax
from bayesianfiltering_tpu_torch.ops import associative as tas
from bayesianfiltering_tpu_torch.ops import bank_combine as tbc
from bayesianfiltering_tpu_torch.ops import bank_smoother as tbs
from bayesianfiltering_tpu_torch.ops import linear as tlin

pl = pytest.importorskip("jax.experimental.pallas")
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

torch.set_num_threads(1)

TOL = {"float64": 1e-10, "float32": 1e-4}
ORACLE_TOL = 1e-6

# jitted: the eager JAX scan costs five times the compile
_jax_smoother = jax.jit(jas.parallel_kalman_smoother,
                        static_argnames=("solver", "chunk"))


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@contextlib.contextmanager
def jax_in(dtype):
    """JAX with 64-bit types on for float64 and off for float32 (with them
    on, the JAX package's float64 bias defaults would promote a float32
    run)."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def assert_close(got, want, tol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def lgssm(dx, dy, T, dtype, seed=0, q_rank=None):
    """(JAX params, port params, emissions) of the benchmark's model;
    ``q_rank`` < dx makes Q rank-deficient (singular C1 in the combine).
    Call the JAX side inside ``jax_in(dtype)``."""
    rng = np.random.default_rng(seed)
    F = 0.99 * np.eye(dx) + 0.01 * rng.standard_normal((dx, dx)) / dx
    H = rng.standard_normal((dy, dx)) / dx
    Q = 0.1 * np.eye(dx)
    if q_rank is not None:
        G = rng.standard_normal((dx, q_rank))
        Q = 0.1 * G @ G.T
    fields = dict(initial_mean=np.zeros(dx), initial_covariance=np.eye(dx),
                  dynamics_matrix=F, dynamics_covariance=Q, emission_matrix=H,
                  emission_covariance=0.1 * np.eye(dy))
    jp = jlin.ParamsLGSSM(**{k: jnp.asarray(v, dtype)
                             for k, v in fields.items()})
    template = tlin.ParamsLGSSM(**{k: torch.zeros(v.shape)
                                   for k, v in fields.items()})
    tp = params_from_jax(jp, template, dtype=getattr(torch, dtype),
                         device="cpu")
    ys = rng.standard_normal((T, dy)).astype(dtype)
    return jp, tp, ys


def compare_posteriors(got, want, tol, smoothed=True):
    names = ["marginal_loglik", "filtered_means", "filtered_covariances",
             "predicted_means", "predicted_covariances"]
    if smoothed:
        names += ["smoothed_means", "smoothed_covariances"]
    for name in names:
        assert_close(getattr(got, name), getattr(want, name), tol)


class TestSequential:
    """``ops.linear``: the exactness oracle."""

    @pytest.mark.parametrize("dx,dy,T", [(2, 1, 300), (4, 2, 300),
                                         (8, 3, 300), (4, 2, 1), (4, 2, 2)])
    def test_kalman_smoother_matches_jax_float64(self, dx, dy, T):
        jp, tp, ys = lgssm(dx, dy, T, "float64", seed=dx)
        with jax_in("float64"):
            want = jlin.kalman_smoother(jp, jnp.asarray(ys))
        got = tlin.kalman_smoother(tp, torch.as_tensor(ys))
        compare_posteriors(got, want, TOL["float64"])

    def test_kalman_filter_matches_jax_float32(self):
        jp, tp, ys = lgssm(4, 2, 300, "float32")
        with jax_in("float32"):
            want = jlin.kalman_filter(jp, jnp.asarray(ys))
        got = tlin.kalman_filter(tp, torch.as_tensor(ys))
        compare_posteriors(got, want, TOL["float32"], smoothed=False)


PARALLEL_CASES = [
    # (dx, dy, T, chunk, solver, dtype)
    (4, 2, 300, None, "woodbury", "float64"),
    (4, 2, 300, None, "native", "float32"),
    (4, 2, 300, 8, "woodbury", "float64"),
    (4, 2, 300, 8, "woodbury", "float32"),
    (4, 2, 300, 8, "native", "float64"),
    (4, 2, 300, 128, "woodbury", "float64"),
    (4, 2, 300, 128, "native", "float32"),
    (2, 1, 300, 8, "woodbury", "float64"),
    (8, 3, 300, 8, "woodbury", "float32"),
    (4, 2, 1, 8, "woodbury", "float64"),
    (4, 2, 2, None, "woodbury", "float64"),
]


@pytest.mark.parametrize("dx,dy,T,chunk,solver,dtype", PARALLEL_CASES)
def test_parallel_smoother_matches_jax(dx, dy, T, chunk, solver, dtype):
    """T=300 at chunk 8 recurses three levels (300 → 38 → 5) and pads."""
    jp, tp, ys = lgssm(dx, dy, T, dtype, seed=dx + T)
    with jax_in(dtype):
        want = _jax_smoother(jp, jnp.asarray(ys), solver=solver, chunk=chunk)
    got = tas.parallel_kalman_smoother(tp, torch.as_tensor(ys),
                                       solver=solver, chunk=chunk)
    compare_posteriors(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_parallel_smoother_rank_deficient_q(dtype):
    """Q of rank 2 < dx = 4: C1 of every t ≥ 1 element is singular, and only
    the trace-relative ε keeps its factor finite. (In float32 the parallel
    smoother then parts from the sequential one by a few percent, on both
    sides alike; float64 meets it.)"""
    jp, tp, ys = lgssm(4, 2, 200, dtype, seed=5, q_rank=2)
    with jax_in(dtype):
        want = _jax_smoother(jp, jnp.asarray(ys), chunk=8)
    got = tas.parallel_kalman_smoother(tp, torch.as_tensor(ys), chunk=8)
    compare_posteriors(got, want, TOL[dtype])
    if dtype == "float64":
        oracle = tlin.kalman_smoother(tp, torch.as_tensor(ys))
        compare_posteriors(got, oracle, ORACLE_TOL)


def test_time_invariant_elements_match_jax_and_the_generic_element():
    jp, tp, ys = lgssm(4, 2, 6, "float64", seed=2)
    with jax_in("float64"):
        want = jas._elements_time_invariant(jp, jnp.asarray(ys))
    got = tas._elements_time_invariant(tp, torch.as_tensor(ys))
    for g, w in zip(got, want):
        assert_close(g, w, TOL["float64"])
    for t in range(1, len(ys)):
        one = tas._generic_element(tp, torch.as_tensor(ys[t]))
        for g, e in zip(got, one):
            assert_close(g[t], e, TOL["float64"])


@pytest.mark.parametrize("chunk", [None, 8])
def test_parallel_smoother_matches_sequential_oracle(chunk):
    _, tp, ys = lgssm(4, 2, 300, "float64", seed=1)
    ys = torch.as_tensor(ys)
    compare_posteriors(tas.parallel_kalman_smoother(tp, ys, chunk=chunk),
                       tlin.kalman_smoother(tp, ys), ORACLE_TOL)


def test_chunked_schedule_counts_the_main_path_combines():
    """At T = 1M and chunk 128 the schedule makes 320 combines: 128 over
    7,813 lanes, 128 over 62, 62 single ones, then the two broadcasts over
    (128, 62) and (128, 7,813) (a scalar sum stands in for the combine)."""
    T = 1_000_000
    x = torch.arange(T, dtype=torch.float64) % 7
    lanes = []

    def add(a, b):
        lanes.append(torch.broadcast_shapes(a[0].shape, b[0].shape))
        return (a[0] + b[0],)

    (out,) = tas.chunked_associative_scan(
        add, (x,), (torch.zeros((), dtype=torch.float64),), chunk=128)
    assert torch.equal(out, torch.cumsum(x, 0))
    count = {}
    for s in lanes:
        count[s] = count.get(s, 0) + 1
    assert count == {(7813,): 128, (62,): 128, (): 62, (128, 62): 1,
                     (128, 7813): 1}


# ---------------------------------------------------------------------------
# K10–K12 plain versions against the JAX twins and Pallas kernels
# ---------------------------------------------------------------------------


def pair(arrays, dtype):
    return (tuple(jnp.asarray(a, dtype) for a in arrays),
            tuple(torch.as_tensor(np.asarray(a, dtype)) for a in arrays))


def assert_same_nonfinite(got, want, tol):
    """Non-finite entries in the same places, finite ones close."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    bad = ~np.isfinite(want)
    np.testing.assert_array_equal(~np.isfinite(got), bad)
    assert_close(np.where(bad, 0.0, got), np.where(bad, 0.0, want), tol)


class TestCombineTwins:

    @pytest.mark.parametrize("dx", [2, 4, 8])
    def test_filter_combine_matches_xla(self, dx):
        rng = np.random.default_rng(dx)
        jl, tl = pair(testing.filter_elements(rng, 96, dx, singular_head=20),
                      "float64")
        jr_, tr_ = pair(testing.filter_elements(rng, 96, dx), "float64")
        want = jbc._combine_xla(jl, jr_)
        got = tbc.bank_filter_combine(tl, tr_)
        for g, w in zip(got, want):
            assert_close(g, w, TOL["float64"])

    @pytest.mark.parametrize("dx", [2, 4])
    def test_filter_combine_matches_pallas(self, dx):
        """dx ≤ 4: the interpret-mode lattice at dx = 8 takes a minute;
        dx = 8 is held to the XLA twin above."""
        rng = np.random.default_rng(dx + 10)
        jl, tl = pair(testing.filter_elements(rng, 96, dx, singular_head=20),
                      "float32")
        jr_, tr_ = pair(testing.filter_elements(rng, 96, dx), "float32")
        with pltpu.force_tpu_interpret_mode():
            want = jbc._combine_pallas(jl, jr_)
        for g, w in zip(tbc.bank_filter_combine(tl, tr_), want):
            assert_close(g, w, 2e-5)

    @pytest.mark.parametrize("dtype", ["float64", "float32"])
    def test_guard_lanes(self, dtype):
        """Lane 0: C1 with a −1e-8 eigenvalue (below ε); lane 1: an
        infinite off-diagonal pair. Both factors fail and are zeroed
        (M⁻¹ = I) on both sides; lane 1's b and C are then non-finite in
        the same places. The Pallas kernel (~isfinite guard) agrees on
        lane 0."""
        rng = np.random.default_rng(7)
        left = testing.guard_lanes(rng, testing.filter_elements(rng, 96, 4))
        jl, tl = pair(left, dtype)
        jr_, tr_ = pair(testing.filter_elements(rng, 96, 4), dtype)
        got = tbc.bank_filter_combine(tl, tr_)
        for g, w in zip(got, jbc._combine_xla(jl, jr_)):
            assert_same_nonfinite(g, w, TOL[dtype])
        for name, g in zip("A J eta".split(), (got[0], got[3], got[4])):
            assert torch.isfinite(g).all(), name
        if dtype == "float32":
            keep = np.arange(96) != 1
            with pltpu.force_tpu_interpret_mode():
                want = jbc._combine_pallas(tuple(x[keep] for x in jl),
                                           tuple(x[keep] for x in jr_))
            for g, w in zip(got, want):
                assert_close(g[torch.as_tensor(keep)], w, 2e-5)

    def test_filter_combine_broadcast(self):
        """The chunked scan's step 4: left (1, G, ...) against right
        (chunk, G, ...)."""
        rng = np.random.default_rng(3)
        G, C, dx = 6, 4, 3
        left = tuple(x[None] for x in testing.filter_elements(rng, G, dx))
        right = tuple(x.reshape((C, G) + x.shape[1:])
                      for x in testing.filter_elements(rng, C * G, dx))
        jl, tl = pair(left, "float32")
        jr_, tr_ = pair(right, "float32")
        with pltpu.force_tpu_interpret_mode():
            want = jbc.bank_filter_combine(jl, jr_, use_pallas=True)
        for g, w in zip(tbc.bank_filter_combine(tl, tr_), want):
            assert g.shape == (C, G) + g.shape[2:]
            assert_close(g, w, 2e-5)

    @pytest.mark.parametrize("dx", [2, 4, 8])
    def test_elements_match_xla_and_pallas(self, dx):
        rng = np.random.default_rng(dx + 20)
        raw = testing.smoother_element_inputs(rng, 96, dx)
        j64, t64 = pair(raw, "float64")
        for g, w in zip(tbs.bank_smoother_elements(*t64),
                        jbs._elements_xla(*j64)):
            assert_close(g, w, TOL["float64"])
        if dx == 8:
            return  # the interpret-mode lattice at dx = 8 is slow
        j32, t32 = pair(raw, "float32")
        with pltpu.force_tpu_interpret_mode():
            want = jbs._elements_pallas(*j32)
        for g, w in zip(tbs.bank_smoother_elements(*t32), want):
            assert_close(g, w, 2e-4)

    def test_elements_with_a_shared_transition(self):
        rng = np.random.default_rng(4)
        fm, fP, pm, pP, F = testing.smoother_element_inputs(rng, 50, 4)
        _, t = pair((fm, fP, pm, pP, F[0]), "float64")
        shared = tbs.bank_smoother_elements(*t[:4], t[4].expand(50, 4, 4))
        banked = tbs.bank_smoother_elements(
            *t[:4], t[4].expand(50, 4, 4).contiguous())
        for s, b in zip(shared, banked):
            assert torch.equal(s, b)

    @pytest.mark.parametrize("dx", [2, 4, 8])
    def test_smoother_combine_matches_xla_and_pallas(self, dx):
        rng = np.random.default_rng(dx + 30)
        e1 = testing.smoother_elements(rng, 64, dx)
        e2 = testing.smoother_elements(rng, 64, dx)
        (j1, t1), (j2, t2) = pair(e1, "float64"), pair(e2, "float64")
        for g, w in zip(tbs.bank_smoother_combine(t1, t2),
                        jbs._scombine_xla(j1, j2)):
            assert_close(g, w, TOL["float64"])
        if dx == 8:
            return  # the interpret-mode lattice at dx = 8 is slow
        (j1, t1), (j2, t2) = pair(e1, "float32"), pair(e2, "float32")
        with pltpu.force_tpu_interpret_mode():
            want = jbs._scombine_pallas(j1, j2)
        for g, w in zip(tbs.bank_smoother_combine(t1, t2), want):
            assert_close(g, w, 2e-5)

    def test_smoother_combine_broadcast(self):
        rng = np.random.default_rng(5)
        G, C, dx = 5, 4, 3
        e1 = tuple(x[None] for x in testing.smoother_elements(rng, G, dx))
        e2 = tuple(x.reshape((C, G) + x.shape[1:])
                   for x in testing.smoother_elements(rng, C * G, dx))
        (j1, t1), (j2, t2) = pair(e1, "float32"), pair(e2, "float32")
        with pltpu.force_tpu_interpret_mode():
            want = jbs.bank_smoother_combine(j1, j2, use_pallas=True)
        for g, w in zip(tbs.bank_smoother_combine(t1, t2), want):
            assert_close(g, w, 2e-5)

    def test_lanes_form_broadcast_matches_torch_broadcasting(self):
        """The operands the kernels take (lanes, read m mod lanes) and the
        plain version the backward re-runs on them pair lanes as torch
        broadcasting does."""
        rng = np.random.default_rng(6)
        G, C, dx = 6, 4, 3
        left = tuple(torch.as_tensor(x[None])
                     for x in testing.filter_elements(rng, G, dx))
        right = tuple(torch.as_tensor(x.reshape((C, G) + x.shape[1:]))
                      for x in testing.filter_elements(rng, C * G, dx))
        flat = [tbc.as_lanes(x, (C, G), core)
                for x, core in zip((*left, *right), (2, 1, 2, 2, 1) * 2)]
        assert [n for _, n in flat] == [G] * 5 + [C * G] * 5
        got = tbc._combine_lanes(*(x for x, _ in flat))
        for g, w in zip(got, tas._combine(left, right)):
            assert torch.equal(g.reshape(w.shape), w)

    def test_backward_reruns_the_plain_combine(self):
        rng = np.random.default_rng(8)
        left = [torch.as_tensor(x).requires_grad_()
                for x in testing.filter_elements(rng, 5, 3)]
        right = [torch.as_tensor(x)
                 for x in testing.filter_elements(rng, 5, 3)]
        flat = [x.reshape(x.shape) for x in (*left, *right)]
        out = tbc._bank_combine(*flat)
        sum(o.sum() for o in out).backward()
        grads = [x.grad.clone() for x in left]
        for x in left:
            x.grad = None
        sum(o.sum() for o in tas._combine(left, right)).backward()
        for g, x in zip(grads, left):
            assert_close(g, x.grad, 1e-12)


def test_cpu_tensors_never_launch():
    _build.reset_launch_counts()
    _, tp, ys = lgssm(4, 2, 40, "float64")
    tas.parallel_kalman_smoother(tp, torch.as_tensor(ys), chunk=8)
    assert all(k.launches == 0 for k in _build.KERNELS)


def test_params_from_jax_carries_lgssm():
    jp, tp, _ = lgssm(3, 2, 1, "float64")
    for name in jlin.ParamsLGSSM._fields:
        want, got = getattr(jp, name), getattr(tp, name)
        if want is None:
            assert got is None
        else:
            assert got.dtype == torch.float64
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(jp, tp._replace(dynamics_matrix=torch.zeros(2, 2)),
                        dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="None"):
        params_from_jax(jp, tp._replace(dynamics_bias=torch.zeros(3)),
                        dtype=torch.float64, device="cpu")
