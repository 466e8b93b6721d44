"""The port's nonlinear SSM classes against the JAX package, on the CPU:
the extended and unscented E-steps, per-sequence inputs, and EM on
``NonlinearSSM`` and the additive ``NonlinearGaussianSSM``.

The JAX models are built with 64-bit types on and their arrays cross by
``params_from_jax``; emissions are sampled by the port's model from a
seeded generator (on the CPU), or drawn with numpy. float64, 1e-8 relative to max(1, max|reference|): T
steps of a filter and a smoother, then sums over T.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianfiltering_tpu import models as jm
from bayesianfiltering_tpu.models import zoo as jzoo
from bayesianfiltering_tpu_torch import _build
from bayesianfiltering_tpu_torch import models as tm
from bayesianfiltering_tpu_torch.models import params_from_jax, zoo

torch.set_num_threads(1)

TOL = 1e-8
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def jax_fast(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def assert_close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def t(x):
    return torch.tensor(np.asarray(x))


def gen(seed):
    return torch.Generator().manual_seed(seed)


def port_of(name, jp, **kw):
    model, template, _ = getattr(zoo, name)(dtype=torch.float64,
                                            device="cpu", **kw)
    return model, params_from_jax(jp, template, dtype=torch.float64,
                                  device="cpu")


def noise_props(lib, params):
    """Q and R trained, every other field frozen (``tests/test_models.py``
    ``TestNonlinearEM``)."""
    frozen = lib.ParameterProperties(trainable=False)
    return params._replace(**{k: frozen for k in params._fields})._replace(
        dynamics_noise_covariance=lib.ParameterProperties(),
        emission_noise_covariance=lib.ParameterProperties())


def assert_stats(got, want):
    stats, ll = got
    assert_close(ll, want[1])
    for name in want[0]._fields:
        assert_close(getattr(stats, name), getattr(want[0], name))


# ---------------------------------------------------------------------------
# E-steps
# ---------------------------------------------------------------------------

def test_extended_e_step_on_range_bearing():
    """Range-bearing tracking (dx = 4, dy = 2, per-step turn inputs,
    analytic emission Jacobians), T = 20."""
    jmodel, jp, _ = jzoo.range_bearing_tracking()
    T = 20
    inputs = np.asarray(jzoo.bot_experiment_inputs(T))
    tmodel, tp = port_of("range_bearing_tracking", jp)
    _, em = tmodel.sample(tp, T, inputs=t(inputs), generator=gen(3))
    want = jax.jit(lambda e, u: jmodel.e_step(jp, e, u))(em.numpy(), inputs)
    assert_stats(tmodel.e_step(tp, em, t(inputs)), want)


@pytest.fixture(scope="module")
def ungm():
    """The UNGM with em_moments="ukf", inputs arange(T), T = 30."""
    jmodel, jp, _ = jzoo.scalar_growth()
    jmodel.em_moments = "ukf"
    T = 30
    inputs = np.arange(float(T))[:, None]
    tmodel, tp = port_of("scalar_growth", jp)
    tmodel.em_moments = "ukf"
    _, em = tmodel.sample(tp, T, inputs=t(inputs), generator=gen(10))
    return jmodel, jp, tmodel, tp, em.numpy(), inputs


def test_unscented_e_step_on_scalar_growth(ungm):
    jmodel, jp, tmodel, tp, em, inputs = ungm
    want = jax_fast(lambda e, u: jmodel.e_step(jp, e, u), em, inputs)
    got = tmodel.e_step(tp, t(em), t(inputs))
    assert_stats(got, want)
    assert float(got[1]) > -1000.0      # tests/test_models.py's bound


@pytest.mark.parametrize("moments", ["ekf", "ukf"])
def test_e_step_with_per_sequence_inputs(ungm, moments):
    """A batch of two sequences with inputs (B, T, 1): different inputs
    run one sequence at a time, equal ones as shared inputs in one
    batched smoother; both against JAX's vmap of the E-step."""
    jmodel, jp, tmodel, tp, em, inputs = ungm
    jmodel.em_moments = tmodel.em_moments = moments
    try:
        batch = np.stack([em, em[::-1]])
        run = jax.jit(jax.vmap(lambda e, u: jmodel.e_step(jp, e, u))).lower(
            batch, np.stack([inputs, inputs])).compile(FAST_COMPILE)
        for shift in (5.0, 0.0):
            u = np.stack([inputs, inputs + shift])
            assert_stats(tmodel.e_step(tp, t(batch), t(u)), run(batch, u))
    finally:
        jmodel.em_moments = tmodel.em_moments = "ukf"


def test_e_step_on_cpu_tensors_launches_nothing(ungm):
    _, _, tmodel, tp, em, inputs = ungm
    _build.reset_launch_counts()
    tmodel.e_step(tp, t(em), t(inputs))
    assert all(k.launches == 0 for k in _build.KERNELS)


# ---------------------------------------------------------------------------
# EM
# ---------------------------------------------------------------------------

def test_fit_em_quadratic_measurement():
    """NonlinearSSM, extended EM: two sequences of 30 steps, Q and R from
    8 and 0.1 (tests/test_models.py's misspecified start), 4
    iterations."""
    jmodel, jp, _ = jzoo.quadratic_measurement()
    truth, tp = port_of("quadratic_measurement", jp)
    em = truth.sample(tp, 30, generator=gen(20), batch_shape=(2,))[1].numpy()
    init = jp._replace(dynamics_noise_covariance=8.0 * jnp.eye(1),
                       emission_noise_covariance=0.1 * jnp.eye(1))
    want, want_lps = jmodel.fit_em(init, noise_props(jm, jp),
                                   jnp.asarray(em), num_iters=4,
                                   verbose=False)
    tmodel, tinit = port_of("quadratic_measurement", init)
    got, lps = tmodel.fit_em(tinit, noise_props(tm, tinit), t(em),
                             num_iters=4, verbose=False)
    assert_close(lps, want_lps)
    for name in ("dynamics_noise_covariance", "emission_noise_covariance",
                 "initial_mean", "initial_covariance"):
        assert_close(getattr(got, name), getattr(want, name))


def test_fit_em_unscented_with_batched_inputs(ungm):
    """The UNGM's unscented EM over two sequences with batched inputs
    (JAX's fit_em needs them batched), 3 iterations, Q and R trained."""
    jmodel, jp, tmodel, tp, em, inputs = ungm
    batch = np.stack([em, em[::-1]])
    u = np.stack([inputs, inputs])
    want, want_lps = jmodel.fit_em(jp, noise_props(jm, jp),
                                   jnp.asarray(batch), jnp.asarray(u),
                                   num_iters=3, verbose=False)
    got, lps = tmodel.fit_em(tp, noise_props(tm, tp), t(batch), t(u),
                             num_iters=3, verbose=False)
    assert_close(lps, want_lps)
    assert_close(got.dynamics_noise_covariance,
                 want.dynamics_noise_covariance)
    assert_close(got.emission_noise_covariance,
                 want.emission_noise_covariance)


def test_fit_em_additive_model():
    """NonlinearGaussianSSM (additive f(x), h(x)) through the non-additive
    wrapper: numpy emissions, Q from 4·I, 3 iterations, every field
    trained (props None)."""
    fields = dict(initial_mean=np.zeros(2), initial_covariance=np.eye(2),
                  dynamics_noise_bias=np.zeros(2),
                  dynamics_noise_covariance=4.0 * np.eye(2),
                  emission_noise_bias=np.zeros(2),
                  emission_noise_covariance=0.5 * np.eye(2))
    em = np.random.default_rng(6).standard_normal((2, 25, 2))
    jp = jm.ParamsNLSSM(**{k: jnp.asarray(v) for k, v in fields.items()},
                        dynamics_function=lambda x: 0.8 * jnp.tanh(x),
                        emission_function=lambda x: x + 0.1 * x ** 2)
    tp = tm.ParamsNLSSM(**{k: t(v) for k, v in fields.items()},
                        dynamics_function=lambda x: 0.8 * torch.tanh(x),
                        emission_function=lambda x: x + 0.1 * x ** 2)
    want, want_lps = jm.NonlinearGaussianSSM(2, 2).fit_em(
        jp, None, jnp.asarray(em), num_iters=3, verbose=False)
    model = tm.NonlinearGaussianSSM(2, 2)
    got, lps = model.fit_em(tp, None, t(em), num_iters=3, verbose=False)
    assert_close(lps, want_lps)
    for name in fields:
        assert_close(getattr(got, name), getattr(want, name))
    filt = model.filter(tp, t(em[0]))
    assert filt.filtered_means.dtype == torch.float64
    assert_close(model.marginal_log_prob(tp, t(em)),
                 [float(model.marginal_log_prob(tp, t(e))) for e in em])
