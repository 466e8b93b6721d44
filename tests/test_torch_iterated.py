"""The port's parallel iterated smoothers (IEKS, LM-IEKS, IPLS) against the
JAX package and against float64 numpy oracles, on the CPU.

The JAX package's four iterated-smoother results are computed once each
for the module, by the case that needs it (each JAX call traces and
compiles for seconds): the damped IEKS and the
LM-IEKS on the BOT experiment's range-bearing model (wrapped bearings,
dq = 2 < dx = 4, the EKF filter seed), the augmented IPLS on the same
model and the additive IPLS on the UNGM (``zoo.scalar_growth``, whose
dq = dx), all at T = 10 with 2 iterations in float64, held to 1e-8
relative to max(1, max|reference|). The other variants (recentering off,
the rollout and array nominals, the chunked schedule, the native solver)
are held to the sequential float64 oracles of
``tests/test_parallel_iterated.py`` (``np_tv_kf_rts``,
``np_ieks_quadratic``; copied here, since ``tests/`` is not a package):
1e-9 with the native solver, 1e-6 with the Woodbury one, whose
trace-relative jitter moves the scan at the 1e-7 level.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianfiltering_tpu.models import zoo as jzoo
from bayesianfiltering_tpu.ops import ParamsUKF as JParamsUKF
from bayesianfiltering_tpu.ops import (
    parallel_iterated_extended_smoother as jax_ieks,
)
from bayesianfiltering_tpu.ops import (
    parallel_iterated_sigma_point_smoother as jax_ipls,
)
from bayesianfiltering_tpu_torch import inference as inf
from bayesianfiltering_tpu_torch.models import (
    ParamsNLSSM,
    SampleDraws,
    params_from_jax,
    zoo,
)
from bayesianfiltering_tpu_torch.models.params import ARRAY_FIELDS
from bayesianfiltering_tpu_torch.ops import parallel_iterated as pi
from bayesianfiltering_tpu_torch.ops.ukf import ParamsUKF

torch.set_num_threads(1)

T, NUM_ITER = 10, 2
JAX_TOL = 1e-8
ORACLE_TOL = {"native": 1e-9, "woodbury": 1e-6}
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
POSTERIOR = ("marginal_loglik", "filtered_means", "filtered_covariances",
             "predicted_means", "predicted_covariances", "smoothed_means",
             "smoothed_covariances")
UP = (1.0, 0.0, 0.0, "cholesky")


def assert_close(got, want, tol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


# ---------------------------------------------------------------------------
# float64 numpy oracles (tests/test_parallel_iterated.py)
# ---------------------------------------------------------------------------


def np_tv_kf_rts(m0, P0, Fs, cs, Qs, Hs, ds, Rs, ys):
    """Sequential TV Kalman filter + RTS smoother, float64. Index t of
    Fs/cs/Qs is the transition INTO t (Fs[0] unused); t=0 conditions the
    prior directly (the module's convention)."""
    T = len(ys)
    fm, fP, pm_prev, pP_prev = [], [], [], []
    m, P = np.asarray(m0, np.float64), np.asarray(P0, np.float64)
    ll = 0.0
    for t in range(T):
        if t > 0:
            m = Fs[t] @ m + cs[t]
            P = Fs[t] @ P @ Fs[t].T + Qs[t]
        pm_prev.append(m)
        pP_prev.append(P)
        S = Hs[t] @ P @ Hs[t].T + Rs[t]
        resid = ys[t] - Hs[t] @ m - ds[t]
        ll += -0.5 * (len(resid) * np.log(2 * np.pi)
                      + np.linalg.slogdet(S)[1]
                      + resid @ np.linalg.solve(S, resid))
        K = np.linalg.solve(S, Hs[t] @ P).T
        m = m + K @ resid
        P = P - K @ S @ K.T
        fm.append(m)
        fP.append(P)
    sm, sP = [fm[-1]], [fP[-1]]
    for t in range(T - 2, -1, -1):
        Pp = Fs[t + 1] @ fP[t] @ Fs[t + 1].T + Qs[t + 1]
        mp = Fs[t + 1] @ fm[t] + cs[t + 1]
        G = np.linalg.solve(Pp, Fs[t + 1] @ fP[t]).T
        sm.insert(0, fm[t] + G @ (sm[0] - mp))
        sP.insert(0, fP[t] + G @ (sP[0] - Pp) @ G.T)
    return (np.array(fm), np.array(fP), np.array(sm), np.array(sP), ll)


def np_ieks_quadratic(a, b, q, r, ys, num_iter, nominal):
    """Sequential IEKS on the quadratic-measurement model (zoo), float64,
    with the module's linearization conventions (emission linearized at
    nominal[t], noise through exact F_q/H_r products)."""
    T = len(ys)
    m0, P0 = np.zeros(1), np.eye(1)
    Fs = np.tile(a * np.eye(1), (T, 1, 1))
    cs = np.zeros((T, 1))
    Qs = np.tile(q * np.eye(1), (T, 1, 1))
    Rs = np.tile(r * np.eye(1), (T, 1, 1))
    nom = np.asarray(nominal, np.float64)
    for _ in range(num_iter + 1):
        Hs = 2.0 * b * nom[:, None, :]
        ds = b * nom**2 - (Hs @ nom[:, :, None])[:, :, 0]
        fm, fP, sm, sP, ll = np_tv_kf_rts(m0, P0, Fs, cs, Qs, Hs, ds, Rs, ys)
        nom = sm
    return fm, sm, ll


# ---------------------------------------------------------------------------
# the JAX package's four results, once for the module
# ---------------------------------------------------------------------------


def jax_float64(jp):
    return jp._replace(**{k: jnp.asarray(getattr(jp, k), jnp.float64)
                          for k in ARRAY_FIELDS})


def port_params(jp, template):
    return params_from_jax(jp, template, dtype=torch.float64, device="cpu")


# (name, model, smoother, keyword arguments)
JAX_CASES = [
    ("ieks damped", "range_bearing", "extended",
     dict(nominal="filter", damping=0.7)),
    ("lm-ieks", "range_bearing", "extended",
     dict(nominal="filter", lm_lambda=100.0)),
    ("ipls augmented", "range_bearing", "sigma_point",
     dict(nominal="filter")),
    ("ipls additive", "scalar_growth", "sigma_point", dict(additive=True)),
]


@pytest.fixture(scope="module")
def problems():
    """Per model: (JAX params, port params, inputs, emissions), float64.
    The range-bearing emissions are sampled by the port from numpy draws;
    the UNGM's are N(0, 1), as in the parallel benchmark's IEKS row."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    model, template, _ = zoo.range_bearing_tracking(dtype=torch.float64,
                                                    device="cpu")
    jp = jax_float64(jzoo.range_bearing_tracking()[1])
    tp = port_params(jp, template)
    inputs = zoo.bot_experiment_inputs(T, device="cpu")
    rng = np.random.default_rng(0)
    draws = SampleDraws(*(torch.as_tensor(rng.standard_normal(s))
                          for s in [(4,), (T, 2), (T, 2)]))
    _, em = model.sample(tp, T, inputs=inputs, draws=draws)
    sg = jax_float64(jzoo.scalar_growth()[1])
    out = {"range_bearing": (jp, tp, inputs, em),
           "scalar_growth": (sg, port_params(sg, zoo.scalar_growth(
               device="cpu")[1]), None,
               torch.as_tensor(rng.standard_normal((T, 1))))}
    yield out
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def jax_results(problems):
    """The four JAX iterated-smoother calls of this file's tests, each
    jitted and compiled at XLA's lowest backend optimisation level when
    its case first asks for it, and kept for the module."""
    results = {}

    def result(name):
        if name not in results:
            _, model, smoother, kw = next(c for c in JAX_CASES
                                          if c[0] == name)
            jp, _, inputs, em = problems[model]
            ju = None if inputs is None else jnp.asarray(inputs.numpy())
            if smoother == "extended":
                fn = lambda e: jax_ieks(jp, e, num_iter=NUM_ITER, inputs=ju,
                                        **kw)
            else:
                fn = lambda e: jax_ipls(jp, JParamsUKF(*UP), e,
                                        num_iter=NUM_ITER, inputs=ju, **kw)
            je = jnp.asarray(em.numpy())
            results[name] = jax.jit(fn).lower(je).compile(FAST_COMPILE)(je)
        return results[name]

    return result


@pytest.mark.parametrize("name,model,smoother,kw", JAX_CASES,
                         ids=[c[0] for c in JAX_CASES])
def test_iterated_smoothers_match_jax(problems, jax_results, name, model,
                                      smoother, kw):
    _, tp, inputs, em = problems[model]
    if smoother == "extended":
        got, aux = inf.parallel_iterated_extended_smoother(
            tp, em, num_iter=NUM_ITER, inputs=inputs, **kw)
    else:
        got, aux = inf.parallel_iterated_sigma_point_smoother(
            tp, ParamsUKF(*UP), em, num_iter=NUM_ITER, inputs=inputs, **kw)
    want, want_aux = jax_results(name)
    assert isinstance(got, inf.PosteriorGaussianSmoothed)
    assert isinstance(aux, pi.IteratedSmootherAux)
    for field in POSTERIOR:
        assert_close(getattr(got, field), getattr(want, field), JAX_TOL)
    assert_close(aux.step_norms, want_aux.step_norms, JAX_TOL)


# ---------------------------------------------------------------------------
# the other variants against the numpy oracles
# ---------------------------------------------------------------------------


def quadratic_measurement(a=0.8, b=0.1, q=1.0, r=1.0):
    """The JAX zoo's quadratic-measurement model, f = a·x, h = b·x²."""
    return ParamsNLSSM(
        initial_mean=torch.zeros(1, dtype=torch.float64),
        initial_covariance=torch.eye(1, dtype=torch.float64),
        dynamics_function=lambda x, qn, u: a * x + qn,
        dynamics_noise_bias=torch.zeros(1, dtype=torch.float64),
        dynamics_noise_covariance=q * torch.eye(1, dtype=torch.float64),
        emission_function=lambda x, rn, u: b * x ** 2 + rn,
        emission_noise_bias=torch.zeros(1, dtype=torch.float64),
        emission_noise_covariance=r * torch.eye(1, dtype=torch.float64),
    )


@pytest.mark.parametrize("recenter,chunk,solver", [
    (True, None, "native"), (False, None, "native"), (True, 8, "native"),
    (False, 8, "woodbury"), (True, None, "woodbury")])
def test_ieks_with_an_array_nominal_matches_the_sequential_oracle(
        recenter, chunk, solver):
    """A nonzero array nominal (the all-zero one is a degenerate fixed
    point of the quadratic emission, H = 2b·x̄ = 0); recentering on and
    off, the flat and the chunked schedule, both solvers."""
    ys = np.random.default_rng(3).standard_normal((50, 1)) + 1.0
    nominal = np.full((50, 1), 1.0)
    fm, sm, ll = np_ieks_quadratic(0.8, 0.1, 1.0, 1.0, ys, 4, nominal)
    post, aux = inf.parallel_iterated_extended_smoother(
        quadratic_measurement(), torch.as_tensor(ys), num_iter=4,
        nominal=torch.as_tensor(nominal), solver=solver, chunk=chunk,
        recenter=recenter)
    tol = ORACLE_TOL[solver]
    assert_close(post.smoothed_means, sm, tol)
    assert_close(post.filtered_means, fm, tol)
    assert_close(post.marginal_loglik, ll, tol)
    assert aux.step_norms.shape == (4,)


@pytest.mark.parametrize("nominal", [None, "rollout"])
def test_ieks_from_the_rollout_is_exact_on_a_linear_model_with_inputs(
        nominal):
    """f = a·x + b·u_t is linear, so one pass is exact from any nominal,
    the default rollout included; the oracle drives the transition into t
    with u_t, the generative convention."""
    a, bu, q, r, n = 0.7, 0.9, 0.4, 0.1, 30
    rng = np.random.default_rng(7)
    u = rng.normal(size=(n, 1))
    ys = rng.normal(size=(n, 1))
    eye = torch.eye(1, dtype=torch.float64)
    params = ParamsNLSSM(
        initial_mean=torch.zeros(1, dtype=torch.float64),
        initial_covariance=eye,
        dynamics_function=lambda x, qn, uu: a * x + bu * uu + qn,
        dynamics_noise_bias=torch.zeros(1, dtype=torch.float64),
        dynamics_noise_covariance=q * eye,
        emission_function=lambda x, rn, uu: x + rn,
        emission_noise_bias=torch.zeros(1, dtype=torch.float64),
        emission_noise_covariance=r * eye,
    )
    ones = np.ones((n, 1, 1))
    _, _, sm, sP, ll = np_tv_kf_rts(np.zeros(1), np.eye(1), a * ones,
                                    bu * u, q * ones, ones, np.zeros((n, 1)),
                                    r * ones, ys)
    post, aux = inf.parallel_iterated_extended_smoother(
        params, torch.as_tensor(ys), num_iter=1, inputs=torch.as_tensor(u),
        nominal=nominal, solver="native")
    assert_close(post.smoothed_means, sm, ORACLE_TOL["native"])
    assert_close(post.smoothed_covariances, sP, ORACLE_TOL["native"])
    assert_close(post.marginal_loglik, ll, ORACLE_TOL["native"])
    # the rollout itself: x_t = a·x_{t-1} + b·u_t from the initial mean
    roll = pi._rollout(params, n, torch.as_tensor(u))
    want = np.zeros((n, 1))
    for t in range(1, n):
        want[t] = a * want[t - 1] + bu * u[t]
    assert_close(roll, want, 1e-14)


def mild_sine_model():
    """A mild 1-D model (f' ∈ [0.7, 0.9], h' = cos + 0.5): a single
    attractor, so the iterations contract."""
    eye = torch.eye(1, dtype=torch.float64)
    return ParamsNLSSM(
        initial_mean=0.5 * torch.ones(1, dtype=torch.float64),
        initial_covariance=0.25 * eye,
        dynamics_function=lambda x, qn, u: 0.8 * x + 0.1 * torch.sin(x) + qn,
        dynamics_noise_bias=torch.zeros(1, dtype=torch.float64),
        dynamics_noise_covariance=0.05 * eye,
        emission_function=lambda x, rn, u: torch.sin(x) + 0.5 * x + rn,
        emission_noise_bias=torch.zeros(1, dtype=torch.float64),
        emission_noise_covariance=0.05 * eye,
    )


@pytest.mark.parametrize("smoother", ["extended", "sigma_point", "lm"])
def test_step_norms_contract(smoother):
    params = mild_sine_model()
    ys = torch.as_tensor(np.sin(np.linspace(0.0, 3.0, 60))[:, None]
                         + 0.2 * np.random.default_rng(5).standard_normal(
                             (60, 1)))
    if smoother == "sigma_point":
        post, aux = inf.parallel_iterated_sigma_point_smoother(
            params, ParamsUKF(*UP), ys, num_iter=6)
    else:
        post, aux = inf.parallel_iterated_extended_smoother(
            params, ys, num_iter=6,
            lm_lambda=1.0 if smoother == "lm" else 0.0)
    norms = aux.step_norms
    assert norms.shape == (6,) and torch.isfinite(norms).all()
    assert norms[-1] < 1e-3 * norms[0]
    assert torch.isfinite(post.smoothed_means).all()


def test_num_iter_zero_is_one_pass_and_nominal_seeds_are_checked():
    params = mild_sine_model()
    ys = torch.zeros(10, 1, dtype=torch.float64)
    post, aux = inf.parallel_iterated_extended_smoother(params, ys,
                                                        num_iter=0)
    assert aux.step_norms.shape == (0,)
    assert post.smoothed_means.shape == (10, 1)
    with pytest.raises(ValueError, match="nominal seed"):
        inf.parallel_iterated_extended_smoother(params, ys, num_iter=1,
                                                nominal="bogus")
