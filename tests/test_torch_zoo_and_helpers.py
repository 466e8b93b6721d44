"""The port's remaining model zoo, nonlinearities, Monte-Carlo moments,
linear-algebra, resampling and container helpers, the reference-exact
EKF (``compat_scalar``), ``ekf_step`` and ``swap_axes_on_values`` against
the JAX package, on the CPU.

Inputs are made with numpy from a seed, or drawn by JAX where the port
takes draws made beforehand (the normals and uniforms of the JAX key
handed over). Tolerances relative to max(1, max|reference|): float64
1e-10 (1e-8 for the filters), float32 1e-4 (the JAX float32 reference
runs with 64-bit types off).
"""
import contextlib

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import bayesianfiltering_tpu.inference as jgf
from bayesianfiltering_tpu import containers as jcont
from bayesianfiltering_tpu.models import zoo as jzoo
from bayesianfiltering_tpu.ops import ekf as jekf
from bayesianfiltering_tpu.ops import slr as jslr
from bayesianfiltering_tpu.utils import linalg as jla
from bayesianfiltering_tpu.utils import resampling as jrs
from bayesianfiltering_tpu_torch import containers
from bayesianfiltering_tpu_torch import inference as inf
from bayesianfiltering_tpu_torch.models import zoo
from bayesianfiltering_tpu_torch.ops import ekf as tekf
from bayesianfiltering_tpu_torch.ops import slr
from bayesianfiltering_tpu_torch.utils import linalg as tla
from bayesianfiltering_tpu_torch.utils import resampling as rs

torch.set_num_threads(1)

TOL = {"float64": 1e-10, "float32": 1e-4}
FILTER_TOL = {"float64": 1e-8, "float32": 1e-4}


@contextlib.contextmanager
def jax_in(dtype):
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module", autouse=True)
def x64():
    with jax_in("float64"):
        yield


def t(x, dtype="float64"):
    return torch.as_tensor(np.array(x), dtype=getattr(torch, dtype))


def assert_close(got, want, tol=TOL["float64"]):
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

# (model, input, dtype): the stochastic-volatility model in both regimes,
# the models with a width-1 slice or a 3-D state in float32 too
MODELS = [(name, u, dtype)
          for name, u in (("quadratic_measurement", 0), ("sine_quadratic", 0),
                          ("tsp_lorenz63", 0), ("stochastic_volatility", 0),
                          ("stochastic_volatility", 1), ("lorenz63", 0))
          for dtype in ("float64", "float32")
          if dtype == "float64" or name in ("stochastic_volatility",
                                            "lorenz63")]


@pytest.mark.parametrize("name,u,dtype", MODELS)
def test_model_functions_jacobians_and_log_density_match(name, u, dtype):
    """f, h, their four Jacobians (``jacfwd`` on both sides) and the BPF's
    log-density over a batch of states, and the model's arrays."""
    with jax_in(dtype):
        jmodel, jparams, jbpf = getattr(jzoo, name)()
    _, tparams, tbpf = getattr(zoo, name)(dtype=getattr(torch, dtype),
                                          device="cpu")
    dx, dq = jmodel.state_dim, jmodel.state_noise_dim
    dy, dr = jmodel.emission_dim, jmodel.emission_noise_dim
    rng = np.random.default_rng(len(name) + u)
    x = rng.standard_normal((5, dx))
    q, r = 0.3 * rng.standard_normal(dq), 0.3 * rng.standard_normal(dr)
    y = rng.standard_normal(dy)
    for field in ("initial_mean", "initial_covariance",
                  "dynamics_noise_covariance", "emission_noise_covariance"):
        assert_close(getattr(tparams, field), getattr(jparams, field),
                     TOL[dtype])
    with jax_in(dtype):
        jx, jq, jr_, jy = (jnp.asarray(a, dtype) for a in (x, q, r, y))
        ju = jnp.asarray(u)
        f, h = jparams.dynamics_function, jparams.emission_function
        one = lambda fn: jax.vmap(lambda xx: fn(xx, jq, ju))
        other = lambda fn: jax.vmap(lambda xx: fn(xx, jr_, ju))
        want = dict(
            f=one(f)(jx), h=other(h)(jx),
            F_x=one(jax.jacfwd(f, 0))(jx),
            F_q=one(jax.jacfwd(f, 1))(jx),
            H_x=other(jax.jacfwd(h, 0))(jx),
            H_r=other(jax.jacfwd(h, 1))(jx),
            log_prob=jax.vmap(jbpf.emission_distribution_log_prob,
                              (0, None, None))(jx, jy, ju))
    tx, tq, tr_, ty = (t(a, dtype) for a in (x, q, r, y))
    tu = torch.tensor(u)
    f, h = tparams.dynamics_function, tparams.emission_function
    vm = torch.func.vmap
    jac = torch.func.jacfwd
    got = dict(
        f=f(tx, tq, tu), h=h(tx, tr_, tu),
        F_x=vm(jac(f, 0), (0, None, None))(tx, tq, tu),
        F_q=vm(jac(f, 1), (0, None, None))(tx, tq, tu),
        H_x=vm(jac(h, 0), (0, None, None))(tx, tr_, tu),
        H_r=vm(jac(h, 1), (0, None, None))(tx, tr_, tu),
        log_prob=tbpf.emission_distribution_log_prob(tx, ty, tu))
    for key, w in want.items():
        assert got[key].dtype == getattr(torch, dtype), key
        assert_close(got[key], w, TOL[dtype])


def test_stochastic_volatility_hessian_keeps_the_dtype():
    """The AGSF's ``"trace"``/``"sdp"`` rules take ``jacrev`` of the
    emission Jacobian; with the regime input a width-1 slice it stays in
    float32."""
    _, p, _ = zoo.stochastic_volatility(device="cpu")
    x, r0, u = torch.ones(2, 3), torch.zeros(3), torch.tensor(1)
    H_x = torch.func.jacfwd(p.emission_function, argnums=0)
    hess = torch.func.vmap(torch.func.jacrev(H_x), (0, None, None))(x, r0, u)
    assert hess.shape == (2, 3, 3, 3) and hess.dtype == torch.float32


# (name, args, dimension of x)
NONLINEARITIES = [("power_nonlinearity", (3.0,), 3),
                  ("power_nonlinearity", (-1.0,), 2),
                  ("sinc_nonlinearity", (), 3),
                  ("linear_nonlinear_product", (), 2),
                  ("linear_nonlinear_sum", (), 2),
                  ("quadratic_form", (2.0, 0.5), 2)]


@pytest.mark.parametrize("name,args,n", NONLINEARITIES)
def test_nonlinearities_match(name, args, n):
    """f, J and H at a batch of points, each row against the JAX function
    at that point."""
    x = np.random.default_rng(n).standard_normal((4, n))
    want = getattr(jzoo, name)(*args)
    got = getattr(zoo, name)(*args)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for jfn, tfn in zip(want, got):
        assert_close(tfn(t(x)), np.stack([np.asarray(jfn(jnp.asarray(row)))
                                          for row in x]))


# ---------------------------------------------------------------------------
# Monte-Carlo moments
# ---------------------------------------------------------------------------

def _mc_problem():
    rng = np.random.default_rng(21)
    A = rng.standard_normal((2, 2))
    return (rng.standard_normal(2), A @ A.T + np.eye(2),
            0.1 * np.eye(2), 0.2 * np.eye(2))


def test_mc_moments_match_with_jax_normals():
    m, P, cov_add, _ = _mc_problem()
    key = jr.PRNGKey(4)
    func = lambda x: jnp.stack([jnp.sin(x[0]) * x[1], x[0] ** 2])
    tfunc = lambda x: torch.stack([torch.sin(x[0]) * x[1], x[0] ** 2])
    want = jslr.mc_moments(key, jnp.asarray(m), jnp.asarray(P), func,
                           jnp.asarray(cov_add), 50)
    eps = jr.normal(key, (50, 2), jnp.float64)
    got = slr.mc_moments(t(m), t(P), tfunc, t(cov_add), 50, eps=t(eps))
    for a, b in zip(got, want):
        assert_close(a, b)


def test_mcla_moments_match_with_jax_normals():
    m, P, cov_add, delta = _mc_problem()
    key = jr.PRNGKey(5)
    func = lambda x: jnp.stack([jnp.sin(x[0]) * x[1], x[0] ** 2])
    tfunc = lambda x: torch.stack([torch.sin(x[0]) * x[1], x[0] ** 2])
    want = jslr.mcla_moments(key, jnp.asarray(m), jnp.asarray(P), func,
                             jax.jacfwd(func), jnp.asarray(cov_add),
                             jnp.asarray(delta), 40)
    eps = jr.normal(key, (40, 2), jnp.float64)
    got = slr.mcla_moments(t(m), t(P), tfunc, torch.func.jacfwd(tfunc),
                           t(cov_add), t(delta), 40, eps=t(eps))
    for a, b in zip(got, want):
        assert_close(a, b)


def test_mc_moments_of_a_scalar_function_from_a_generator():
    """A scalar transform gives (1,) moments; a generator's draws work."""
    m, P, cov_add, _ = _mc_problem()
    mean, var, cov = slr.mc_moments(
        t(m), t(P), lambda x: (x * x).sum(), t(cov_add[:1, :1]), 30,
        torch.Generator().manual_seed(0))
    assert mean.shape == (1,) and var.shape == (1, 1) and cov.shape == (2, 1)


# ---------------------------------------------------------------------------
# linear algebra
# ---------------------------------------------------------------------------

def test_linalg_helpers_match():
    rng = np.random.default_rng(2)
    L = np.tril(rng.standard_normal((3, 4, 4))) + 4 * np.eye(4)
    b, B = rng.standard_normal((3, 4)), rng.standard_normal((3, 4, 2))
    F, P = rng.standard_normal((3, 5, 4)), rng.standard_normal((3, 4, 4))
    for rhs in (b, B):
        assert_close(tla.tri_solve_lower(t(L), t(rhs)),
                     jla.tri_solve_lower(jnp.asarray(L), jnp.asarray(rhs)))
    assert_close(tla.sandwich(t(F), t(P)),
                 jla.sandwich(jnp.asarray(F), jnp.asarray(P)))
    A, Bm = rng.standard_normal((4, 3)), rng.standard_normal((4, 3))
    assert_close(tla.matrix_projection(t(A), t(Bm)),
                 jla.matrix_projection(jnp.asarray(A), jnp.asarray(Bm)))


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------

def test_full_reset_matches_with_jax_uniforms():
    rng = np.random.default_rng(3)
    w = rng.dirichlet(np.ones(30))
    particles = rng.standard_normal((30, 2))
    key = jr.PRNGKey(4)
    want_w, want_p, _ = jrs._resample(jnp.asarray(w), jnp.asarray(particles),
                                      key)
    u = jr.uniform(jr.split(key)[0], (30,), jnp.float64)
    got_w, got_p, _ = rs._resample(t(w), t(particles), u=t(u))
    assert_close(got_w, want_w)
    assert_close(got_p, want_p)
    gen = torch.Generator().manual_seed(0)
    assert rs._resample(t(w), t(particles), gen)[2] is gen


def test_three_dimensional_resample_and_retain_match():
    w = np.random.default_rng(4).dirichlet(np.ones(2 * 3 * 4)).reshape(2, 3, 4)
    key = jr.PRNGKey(6)
    want = jrs.resample(jnp.asarray(w), 7, key)
    u = jr.uniform(key, (7,), jnp.float64)
    np.testing.assert_array_equal(rs.resample(t(w), 7, u=t(u)).numpy(),
                                  np.asarray(want))
    np.testing.assert_array_equal(rs.retain(t(w), 5).numpy(),
                                  np.asarray(jrs.retain(jnp.asarray(w), 5)))


def test_retain_breaks_ties_as_top_k():
    w = np.array([0.1, 0.3, 0.1, 0.3, 0.2]).reshape(5, 1)
    np.testing.assert_array_equal(rs.retain(t(w), 4).numpy(),
                                  np.asarray(jrs.retain(jnp.asarray(w), 4)))


def test_split_by_sampling_matches_with_jax_normals():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((3, 3))
    cov = A @ A.T + 2 * np.eye(3)
    mean = rng.standard_normal(3)
    key = jr.PRNGKey(7)
    want = jrs.split_by_sampling(key, jnp.asarray(mean), jnp.asarray(cov),
                                 jnp.eye(3), 6)
    eps = jr.normal(key, (6, 3), jnp.float64)
    got = rs.split_by_sampling(t(mean), t(cov), torch.eye(3).double(), 6,
                               eps=t(eps))
    assert_close(got, want)


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

def _mixture(rng, M=3, dx=2):
    A = rng.standard_normal((M, dx, dx))
    return (rng.standard_normal((M, dx)),
            A @ np.swapaxes(A, -1, -2) + np.eye(dx), rng.dirichlet(np.ones(M)))


def test_gaussian_sum_and_its_methods_match():
    means, covs, w = _mixture(np.random.default_rng(6))
    jgs = jcont.gaussian_sum(list(jnp.asarray(means)), list(jnp.asarray(covs)),
                             list(jnp.asarray(2 * w)))
    tgs = containers.gaussian_sum(list(t(means)), list(t(covs)),
                                  list(t(2 * w)))
    for a, b in zip(tgs, jgs):
        assert_close(a, b)
    assert tgs.state_dim == jgs.state_dim == 2
    assert bool(tgs._check_normalization()) == bool(jgs._check_normalization())
    assert_close(tgs._sum_weights(), jgs._sum_weights())
    for a, b in zip(tgs.normalize(), jgs.normalize()):
        assert_close(a, b)
    for a, b in zip(tgs.normalize().collapse(), jgs.normalize().collapse()):
        assert_close(a, b)
    assert containers.num_prt1 == jcont.num_prt1
    assert containers.num_prt2 == jcont.num_prt2


def test_component_list_shims_match_with_jax_normals():
    means, covs, w = _mixture(np.random.default_rng(7))
    jcomps = jcont._gaussian_sum_to_components(
        jcont.GaussianSum(*(jnp.asarray(a) for a in (means, covs, w))))
    tcomps = containers._gaussian_sum_to_components(
        containers.GaussianSum(t(means), t(covs), t(w)))
    assert len(tcomps) == len(jcomps) == 3
    for a, b in zip(containers._components_to_gaussian_sum(tcomps),
                    jcont._components_to_gaussian_sum(jcomps)):
        assert_close(a, b)
    assert isinstance(tcomps[0], containers.GaussianComponent)

    split_covs, counts, key = 0.5 * covs, (2, 3, 1), jr.PRNGKey(9)
    want = jcont._branches_from_tree1(jcomps, jnp.asarray(split_covs), counts,
                                      key)
    eps = [t(jr.normal(k, (1, n, 2), jnp.float64))
           for k, n in zip(jr.split(key, 3), counts)]
    got = containers._branches_from_tree2(tcomps, t(split_covs), counts,
                                          eps=eps)
    assert [len(c) for c in got] == list(counts)
    for children_t, children_j in zip(got, want):
        for ct, cj in zip(children_t, children_j):
            for a, b in zip(ct, cj):
                assert_close(a, b)


# ---------------------------------------------------------------------------
# the reference-exact EKF, ekf_step, swap_axes_on_values
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["quadratic_measurement",
                                  "stochastic_volatility"])
def test_compat_scalar_ekf_matches(name, dtype):
    """The reference's update (LU gain of S + 1e-6, difference-form
    covariance) and its u_t predict, T = 20 (the quadratic model's means
    stay at its zero prior mean: its Jacobian vanishes there); on the
    stochastic-volatility model the regime switches at t = 10, where the
    u_t predict differs from the default u_{t+1}."""
    T = 20
    with jax_in("float64"):
        jmodel, jparams, _ = getattr(jzoo, name)()
        inputs = jnp.array([0] * 10 + [1] * 10)
        _, ys = jmodel.sample(jparams, jr.PRNGKey(1), T, inputs=inputs)
        ys = np.asarray(ys)
    with jax_in(dtype):
        jparams = getattr(jzoo, name)()[1]
        want = jgf.extended_kalman_filter(jparams, jnp.asarray(ys, dtype),
                                          inputs=inputs, compat_scalar=True)
    tparams = getattr(zoo, name)(dtype=getattr(torch, dtype), device="cpu")[1]
    got = inf.extended_kalman_filter(tparams, t(ys, dtype),
                                     inputs=t(np.asarray(inputs), dtype),
                                     compat_scalar=True)
    for a, b in zip(got, want):
        assert_close(a, b, FILTER_TOL[dtype])
    if name == "stochastic_volatility":
        default = inf.extended_kalman_filter(
            tparams, t(ys, dtype), inputs=t(np.asarray(inputs), dtype))
        assert not torch.allclose(default.filtered_means, got.filtered_means)


def test_ekf_condition_on_ref_matches():
    _, jparams, _ = jzoo.tsp_lorenz63()
    _, tparams, _ = zoo.tsp_lorenz63(dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(8)
    m, y = rng.standard_normal(3), rng.standard_normal(1)
    A = rng.standard_normal((3, 3))
    P = A @ A.T + np.eye(3)
    h = jparams.emission_function
    want = jekf.ekf_condition_on_ref(
        jnp.asarray(m), jnp.asarray(P), h, jax.jacfwd(h, 0),
        jax.jacfwd(h, 1), jparams.emission_noise_covariance,
        jparams.emission_noise_bias, 0, jnp.asarray(y))
    th = tparams.emission_function
    got = tekf.ekf_condition_on_ref(
        t(m)[None], t(P)[None], th, torch.func.jacfwd(th, 0),
        torch.func.jacfwd(th, 1), tparams.emission_noise_covariance,
        tparams.emission_noise_bias, torch.tensor(0), t(y))
    for a, b in zip(got, want):
        assert_close(a[0], b)


def test_ekf_step_matches():
    _, jparams, _ = jzoo.lorenz63()
    _, tparams, _ = zoo.lorenz63(dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(9)
    m, y = rng.standard_normal(3), rng.standard_normal(1)
    A = rng.standard_normal((3, 3))
    P = A @ A.T + np.eye(3)
    jp, tp = jparams, tparams
    jf, jh = jp.dynamics_function, jp.emission_function
    want = jekf.ekf_step(
        jnp.asarray(m), jnp.asarray(P), jf, jax.jacfwd(jf, 0),
        jax.jacfwd(jf, 1), jp.dynamics_noise_covariance,
        jp.dynamics_noise_bias, 0, jh, jax.jacfwd(jh, 0), jax.jacfwd(jh, 1),
        jp.emission_noise_covariance, jp.emission_noise_bias, jnp.asarray(y))
    tf, th = tp.dynamics_function, tp.emission_function
    jac = torch.func.jacfwd
    got = tekf.ekf_step(
        t(m)[None], t(P)[None], tf, jac(tf, 0), jac(tf, 1),
        tp.dynamics_noise_covariance, tp.dynamics_noise_bias,
        torch.tensor(0), th, jac(th, 0), jac(th, 1),
        tp.emission_noise_covariance, tp.emission_noise_bias, t(y))
    for a, b in zip(got, want):
        assert_close(a[0], b)


def test_swap_axes_on_values_matches():
    x = np.arange(24.0).reshape(2, 3, 4)
    want = jgf.swap_axes_on_values({"a": jnp.asarray(x), "b": jnp.asarray(x)},
                                   1, 2)
    got = inf.swap_axes_on_values({"a": t(x), "b": t(x)}, 1, 2)
    assert set(got) == {"a", "b"}
    for k in got:
        assert_close(got[k], want[k])
    assert inf.swap_axes_on_values({"a": t(x)})["a"].shape == (3, 2, 4)
