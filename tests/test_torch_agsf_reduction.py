"""Optimal resampling and the AGSF's ``"optimal"`` reduction, the
splitting-covariance solvers of ``utils/sdp.py`` and ``compat_fixed_keys``
against the JAX package, on the CPU.

The JAX filters (the AGSF-optimal and the UAGSF with the optimal
reduction on the stochastic-volatility model with its regime switch at
T/2, and the AGSF with the reference's fixed keys on Experiment A's model)
run once each in a module fixture (``agsf_parity``) at T = 8, and the port
gets the normals and uniforms of JAX's key schedule. Tolerances relative
to max(1, max|reference|): float64 1e-8 for the filters and 1e-10 for the
solvers, float32 1e-4; optimal resampling's indices exactly and its
weights to 1e-12.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from agsf_parity import FAST_COMPILE, POSTERIOR, T, assert_close, run_case, t
from bayesianfiltering_tpu import containers as jcont
from bayesianfiltering_tpu.utils import resampling as jrs
from bayesianfiltering_tpu.utils import sdp as jsdp
from bayesianfiltering_tpu_torch import containers
from bayesianfiltering_tpu_torch.utils import resampling as rs
from bayesianfiltering_tpu_torch.utils import sdp

torch.set_num_threads(1)

SOLVER_TOL = {"float64": 1e-10, "float32": 1e-4}
# (label, model, filter, components, keyword arguments)
CASES = [
    ("agsf optimal msv", "stochastic_volatility", "optimal", (4, 2, 2),
     dict(opt_args=(0.1, 0.1))),
    ("uagsf optimal msv", "stochastic_volatility", "unscented", (4, 2, 2),
     dict(opt_args=(0.1, 0.1), reduction="optimal")),
    ("agsf fixed keys sine", "sine_quadratic", "augmented", (3, 2, 2),
     dict(opt_args=(0.8, 1.0), compat_fixed_keys=True)),
]


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


class LazyCases(dict):
    """Each case's (JAX, port) results, run when a test first asks for
    them and kept for the module: a case's JAX compile is charged to its
    own test, not all of them to the first."""

    def __missing__(self, label):
        i, c = next((i, c) for i, c in enumerate(CASES) if c[0] == label)
        self[label] = run_case(*c[1:], seed=i + 11)
        return self[label]


@pytest.fixture(scope="module")
def results(x64):
    return LazyCases()


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_filter_matches_jax_with_its_draws(results, label):
    (want, want_aux), (got, got_aux) = results[label]
    for name in POSTERIOR:
        assert_close(getattr(got, name), getattr(want, name))
    for name in ("Deltas", "Lambdas", "pre_weights", "updated_means"):
        assert_close(got_aux[name], want_aux[name])


def test_optimal_reduction_weights_are_not_uniform(results):
    """The optimal reduction carries the weights it returns: the MSV
    mixture's weights part from 1/M and still sum to one."""
    _, (got, _) = results["agsf optimal msv"]
    assert float((got.weights - 0.25).abs().max()) > 1e-3
    torch.testing.assert_close(got.weights.sum(0),
                               torch.ones(T, dtype=torch.float64))


def solver_problem(n, batch=(), seed=0):
    rng = np.random.default_rng(seed + n)
    A = rng.standard_normal(batch + (n, n))
    P = A @ np.swapaxes(A, -1, -2) + np.eye(n)
    J = rng.standard_normal(batch + (2, n))
    Hs = rng.standard_normal(batch + (2, n, n))
    return P, J, Hs + np.swapaxes(Hs, -1, -2)


def jax_solver(fn, n, args, dtype, **kw):
    """The JAX solver on one problem (or a vmapped batch), jitted and
    compiled at XLA's lowest backend optimisation level."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        run = jax.jit(lambda p, j, h: fn(n, 2, p, j, h, 0.8, **kw))
        jargs = [jnp.asarray(a, dtype) for a in args]
        return np.asarray(run.lower(*jargs).compile(FAST_COMPILE)(*jargs))
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("fn,dtype", [("sdp_opt", "float64"),
                                      ("sdp_opt", "float32"),
                                      ("sdp_opt2", "float64")])
@pytest.mark.parametrize("n", [1, 3, 4])
def test_sdp_solvers_match(fn, n, dtype):
    args = solver_problem(n)
    want = jax_solver(getattr(jsdp, fn), n, args, dtype, tol=1e-3)
    got = getattr(sdp, fn)(n, 2, *(torch.tensor(a, dtype=getattr(torch, dtype))
                                   for a in args), 0.8, tol=1e-3)
    assert_close(got, want, SOLVER_TOL[dtype])


@pytest.mark.parametrize("n", [1, 3])
def test_sdp_batch_stops_each_problem_as_vmap_does(n):
    """A batch whose problems converge after different iteration counts:
    each keeps the value of its own last iteration, as JAX's vmapped
    while-loop keeps it."""
    P, J, Hs = solver_problem(n, batch=(6,), seed=5)
    P[::2] *= 20.0
    want = jax_solver(lambda *a, **k: jax.vmap(
        lambda p, j, h: jsdp.sdp_opt(*a[:2], p, j, h, *a[5:], **k))(*a[2:5]),
        n, (P, J, Hs), "float64", tol=1e-4)
    got = sdp.sdp_opt(n, 2, *(torch.tensor(a) for a in (P, J, Hs)), 0.8,
                      tol=1e-4)
    assert_close(got, want, SOLVER_TOL["float64"])


@pytest.mark.parametrize("n", [1, 3, 4])
def test_gradient_descent_matches(n):
    rng = np.random.default_rng(n)
    X0, P, H = (rng.standard_normal((n, n)) for _ in range(3))
    want = jsdp.gradient_descent(n, 4, 0.7, *(jnp.asarray(a)
                                              for a in (X0, P, H)), 5, 0.05)
    got = sdp.gradient_descent(n, 4, 0.7, *(torch.tensor(a)
                                            for a in (X0, P, H)), 5, 0.05)
    assert_close(got, want, SOLVER_TOL["float64"])


def weight_vectors():
    """20 (weights, N): Dirichlet draws at several sizes and
    concentrations, ties (equal weights, repeated values, a tie across
    the threshold), and N = 1."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(12):
        m, N = ((5, 2), (12, 4), (40, 10))[i % 3]
        out.append((rng.dirichlet(np.full(m, (0.2, 1.0, 5.0)[i // 4])), N))
    out += [(np.full(12, 1 / 12), 6), (np.full(8, 1 / 8), 1),
            (np.repeat([0.05, 0.15], 5), 3),
            (np.array([0.3, 0.3, 0.1, 0.1, 0.1, 0.05, 0.05]), 3),
            (np.array([0.25, 0.25, 0.25, 0.125, 0.125]), 2),
            (rng.dirichlet(np.ones(9)), 1), (rng.dirichlet(np.ones(3)), 3),
            (np.array([0.9, 0.05, 0.05]), 2)]
    return out


@pytest.mark.parametrize("case", range(20))
def test_optimal_resampling_picks_the_same_components(case):
    w, N = weight_vectors()[case]
    w = w / w.sum()
    key = jr.PRNGKey(100 + case)
    idx, weights = jrs.optimal_resampling(jnp.asarray(w), N, key)
    u = jr.uniform(key, rs.UNIFORM_SHAPES["optimal"](N, len(w)), jnp.float64)
    got_idx, got_w = rs.optimal_resampling(t(w), N, u=t(u))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(weights), rtol=0,
                               atol=1e-12)


def test_optimal_reduction_of_a_mixture_matches():
    rng = np.random.default_rng(11)
    means, covs = rng.standard_normal((12, 2)), np.tile(np.eye(2), (12, 1, 1))
    w = rng.dirichlet(np.full(12, 0.5))
    key = jr.PRNGKey(8)
    want = jcont.reduce_gaussian_sum(
        jcont.GaussianSum(*(jnp.asarray(a) for a in (means, covs, w))), 4,
        key, "optimal")
    got = containers.reduce_gaussian_sum(
        containers.GaussianSum(t(means), t(covs), t(w)), 4, "optimal",
        u=t(jr.uniform(key, (12,), jnp.float64)))
    for a, b in zip(got, want):
        assert_close(a, b, 1e-12)


