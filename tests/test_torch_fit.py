"""The port's model layer against the JAX package, on the CPU: the
bijectors and the constraint maps, the SSM log-probability, the
linear-Gaussian E- and M-steps (below and above the parallel smoother's
4,096 steps) and EM, and SGD fitting.

Inputs are made with numpy from a seed and go as they are to both sides.
Tolerances, relative to max(1, max|reference|): 1e-12 for the bijectors
and the log-det Jacobian, 1e-10 for the log-probabilities, 1e-8 for the
E-step statistics, the M-step, EM traces and SGD loss traces (float64).

SGD: JAX's ``fit_sgd`` vmaps the marginal log-likelihood over a
minibatch, and under that vmap its gradient through the EKF's custom VJP
is not the sum of the per-sequence gradients (tested below). So the
port's ``fit_sgd`` is held to JAX's ``fit_sgd`` at one sequence a
minibatch, and at two to JAX's ``run_sgd`` on the same loss summed one
sequence at a time.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bayesianfiltering_tpu import models as jm
from bayesianfiltering_tpu.models import bijectors as jb
from bayesianfiltering_tpu.models import zoo as jzoo
from bayesianfiltering_tpu.models._fit import run_sgd as jax_run_sgd
from bayesianfiltering_tpu.models.linear_gaussian import (
    SuffStatsLGSSM as JSuffStatsLGSSM,
)
from bayesianfiltering_tpu.ops import ParamsLGSSM as JParamsLGSSM
from bayesianfiltering_tpu_torch import models as tm
from bayesianfiltering_tpu_torch import testing
from bayesianfiltering_tpu_torch.models import bijectors as tb
from bayesianfiltering_tpu_torch.models import params_from_jax, zoo
from bayesianfiltering_tpu_torch.models import _fit
from bayesianfiltering_tpu_torch.models import linear_gaussian as tlg
from bayesianfiltering_tpu_torch.ops.linear import ParamsLGSSM

torch.set_num_threads(1)

EXACT_TOL = 1e-12
LOGPROB_TOL = 1e-10
FIT_TOL = 1e-8


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def assert_close(got, want, tol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def t(x):
    return torch.tensor(np.asarray(x))


FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args):
    """``fn(*args)`` jitted and compiled at XLA's lowest optimisation
    level (the JAX side's time here is its compile)."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


# ---------------------------------------------------------------------------
# Bijectors and the constraint maps
# ---------------------------------------------------------------------------

BIJECTORS = {
    "identity": (jb.Identity, tb.Identity, ()),
    "exp": (jb.Exp, tb.Exp, ()),
    "softplus": (jb.Softplus, tb.Softplus, ()),
    "sigmoid": (jb.Sigmoid, tb.Sigmoid, (-2.0, 3.0)),
    "real_to_psd": (jb.RealToPSD, tb.RealToPSD, (3,)),
}


@pytest.mark.parametrize("name", sorted(BIJECTORS))
def test_bijector_matches_jax(name):
    """forward, inverse of forward, and the log-det Jacobian, on values
    from −25 to 25 (softplus past torch's linear threshold of 20)."""
    jcls, tcls, args = BIJECTORS[name]
    rng = np.random.default_rng(len(name))
    x = rng.uniform(-4, 4, 6 if name == "real_to_psd" else 9)
    if name == "softplus":
        x = np.concatenate([x, [-25.0, 21.0, 25.0]])
    jbij, tbij = jcls(*args), tcls(*args)
    y, back, ldj = jax.jit(lambda x: (
        jbij.forward(x), jbij.inverse(jbij.forward(x)),
        jbij.forward_log_det_jacobian(x)))(jnp.asarray(x))
    assert_close(tbij.forward(t(x)), y, EXACT_TOL)
    assert_close(tbij(t(x)), y, EXACT_TOL)
    assert_close(tbij.inverse(t(y)), back, EXACT_TOL)
    assert_close(tbij.forward_log_det_jacobian(t(x)), ldj, EXACT_TOL)


def _props(lib, bij):
    """A mixed property set over ParamsNLSSM: Q through RealToPSD, R
    through Exp, the initial mean trainable and unconstrained, the initial
    covariance frozen under RealToPSD, the rest frozen."""
    frozen = lib.ParameterProperties(trainable=False)
    return lib.ParamsNLSSM(*[frozen] * 8)._replace(
        initial_mean=lib.ParameterProperties(),
        initial_covariance=lib.ParameterProperties(
            trainable=False, constrainer=bij.RealToPSD(2)),
        dynamics_noise_covariance=lib.ParameterProperties(
            constrainer=bij.RealToPSD(2)),
        emission_noise_covariance=lib.ParameterProperties(
            constrainer=bij.Exp()))


@pytest.fixture(scope="module")
def lg_model():
    jmodel, jp, _ = jzoo.linear_gaussian(2, 2, r=0.5)
    jp = jp._replace(dynamics_noise_covariance=jnp.array([[1.2, 0.3],
                                                          [0.3, 0.7]]),
                     emission_noise_covariance=jnp.array([[0.5, 0.1],
                                                          [0.1, 0.4]]))
    tmodel, template, _ = zoo.linear_gaussian(2, 2, dtype=torch.float64,
                                              device="cpu")
    tp = params_from_jax(jp, template, dtype=torch.float64, device="cpu")
    return jmodel, jp, tmodel, tp


def test_constraint_maps_match_jax(lg_model):
    _, jp, _, tp = lg_model
    jprops, tprops = _props(jm, jb), _props(tm, tb)
    arrays = [n for n in jprops._fields[:8]
              if not callable(getattr(jp, n))]

    def jmaps(*values):
        p = jp._replace(**dict(zip(arrays, values)))
        unc = jm.to_unconstrained(p, jprops)
        back = jm.from_unconstrained(unc, jprops)
        return ([getattr(unc, n) for n in arrays],
                [getattr(back, n) for n in arrays],
                jm.log_det_jac_constrain(p, jprops))

    junc, jback, jldj = jax_fast(jmaps, *(getattr(jp, n) for n in arrays))
    tunc = tm.to_unconstrained(tp, tprops)
    tback = tm.from_unconstrained(tunc, tprops)
    assert callable(tunc.dynamics_function)
    assert tback.emission_function is tp.emission_function
    for name, ju, jb_ in zip(arrays, junc, jback):
        assert_close(getattr(tunc, name), ju, EXACT_TOL)
        assert_close(getattr(tback, name), jb_, EXACT_TOL)
    assert_close(tm.log_det_jac_constrain(tp, tprops), jldj, EXACT_TOL)


def test_constraint_maps_on_dicts_and_frozen_gradients():
    """The JAX tests' dict parameter sets; a frozen parameter gets no
    gradient (JAX: zero), a trained one JAX's."""
    params = {"var": 2.5, "mean": 0.3, "a": 1.0, "b": 2.0}
    jprops = {"var": jm.ParameterProperties(constrainer=jb.Softplus()),
              "mean": jm.ParameterProperties(),
              "a": jm.ParameterProperties(trainable=False),
              "b": jm.ParameterProperties(constrainer=jb.Exp())}
    tprops = {"var": tm.ParameterProperties(constrainer=tb.Softplus()),
              "mean": tm.ParameterProperties(),
              "a": tm.ParameterProperties(trainable=False),
              "b": tm.ParameterProperties(constrainer=tb.Exp())}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v, dtype=torch.float64) for k, v in params.items()}

    def jloss(unc):
        p = jm.from_unconstrained(unc, jprops)
        return sum(v ** 2 for v in p.values())

    junc = jm.to_unconstrained(jp, jprops)
    jgrad = jax.grad(jloss)(junc)
    tunc = {k: v.requires_grad_() for k, v in
            tm.to_unconstrained(tp, tprops).items()}
    p = tm.from_unconstrained(tunc, tprops)
    sum(v ** 2 for v in p.values()).backward()
    for k in params:
        assert_close(tunc[k], junc[k], EXACT_TOL)
        if k == "a":
            assert float(jgrad[k]) == 0.0 and tunc[k].grad is None
        else:
            assert_close(tunc[k].grad, jgrad[k], EXACT_TOL)
    assert_close(tm.log_det_jac_constrain(tp, tprops),
                 jm.log_det_jac_constrain(jp, jprops), EXACT_TOL)


@pytest.mark.parametrize("shape,want", [((10, 3), (1, 10, 3)),
                                        ((4, 10, 3), (4, 10, 3))])
def test_ensure_array_has_batch_dim(shape, want):
    assert tuple(_fit.ensure_array_has_batch_dim(torch.zeros(shape),
                                                 (3,)).shape) == want
    assert _fit.ensure_array_has_batch_dim(None, (3,)) is None
    with pytest.raises(ValueError):
        _fit.ensure_array_has_batch_dim(torch.zeros(3), (3, 1))


# ---------------------------------------------------------------------------
# Log-probabilities and the distributions
# ---------------------------------------------------------------------------

def _lgssm_fields(seed):
    rng = np.random.default_rng(seed)
    f = testing.lgssm_fields(rng, 2, 1)
    f["dynamics_matrix"] = np.array([[0.9, 0.1], [0.0, 0.7]])
    f["dynamics_covariance"] = 0.2 * np.eye(2)
    f["emission_covariance"] = 0.3 * np.eye(1)
    return f


@pytest.mark.parametrize("model", ["nonlinear_ssm", "additive",
                                   "linear_gaussian", "scalar_growth"])
def test_log_prob_matches_jax(model):
    """SSM.log_prob (initial, transition and emission densities) of states
    and emissions drawn with numpy."""
    rng = np.random.default_rng(7)
    T = 12
    inputs = None
    if model == "nonlinear_ssm":
        jmodel, jp, _ = jzoo.linear_gaussian(2, 2, r=0.5)
        tmodel, template, _ = zoo.linear_gaussian(2, 2, dtype=torch.float64,
                                                  device="cpu")
        tp = params_from_jax(jp, template, dtype=torch.float64, device="cpu")
        dx = dy = 2
    elif model == "scalar_growth":
        jmodel, jp, _ = jzoo.scalar_growth()
        tmodel, template, _ = zoo.scalar_growth(dtype=torch.float64,
                                                device="cpu")
        tp = params_from_jax(jp, template, dtype=torch.float64, device="cpu")
        inputs = np.arange(float(T))[:, None]
        dx, dy = 1, 1
    elif model == "additive":
        jmodel, tmodel = jm.NonlinearGaussianSSM(2, 2), tm.NonlinearGaussianSSM(2, 2)
        fields = dict(initial_mean=np.zeros(2), initial_covariance=np.eye(2),
                      dynamics_noise_bias=np.zeros(2),
                      dynamics_noise_covariance=np.array([[1.0, 0.2],
                                                          [0.2, 0.5]]),
                      emission_noise_bias=np.zeros(2),
                      emission_noise_covariance=0.5 * np.eye(2))
        jp = jm.ParamsNLSSM(**{k: jnp.asarray(v) for k, v in fields.items()},
                            dynamics_function=lambda x: jnp.sin(x),
                            emission_function=lambda x: x ** 2)
        tp = tm.ParamsNLSSM(**{k: t(v) for k, v in fields.items()},
                            dynamics_function=lambda x: torch.sin(x),
                            emission_function=lambda x: x ** 2)
        dx = dy = 2
    else:
        f = _lgssm_fields(3)
        jmodel, tmodel = jm.LinearGaussianSSM(2, 1), tm.LinearGaussianSSM(2, 1)
        jp = JParamsLGSSM(**{k: jnp.asarray(v) for k, v in f.items()})
        tp = ParamsLGSSM(**{k: t(v) for k, v in f.items()})
        dx, dy = 2, 1
    states = rng.standard_normal((T, dx))
    emissions = rng.standard_normal((T, dy))
    ju = None if inputs is None else jnp.asarray(inputs)
    tu = None if inputs is None else t(inputs)
    def jside(states, emissions):
        dists = [getattr(jmodel, name)(jp, states[3],
                                       None if ju is None else ju[3])
                 for name in ("transition_distribution",
                              "emission_distribution")]
        return (jmodel.log_prob(jp, states, emissions, ju),
                [(d.log_prob(y), d.covariance())
                 for d, y in zip(dists, (states[4], emissions[4]))])

    want, dists = jax_fast(jside, jnp.asarray(states), jnp.asarray(emissions))
    assert_close(tmodel.log_prob(tp, t(states), t(emissions), tu), want,
                 LOGPROB_TOL)
    x = t(states[3])
    for name, (lp, cov), y in zip(
            ("transition_distribution", "emission_distribution"), dists,
            (states[4], emissions[4])):
        td = getattr(tmodel, name)(tp, x, None if tu is None else tu[3])
        assert_close(td.log_prob(t(y)), lp, LOGPROB_TOL)
        assert_close(td.covariance(), cov, LOGPROB_TOL)


def test_generic_sample_takes_its_draws():
    """SSM.sample with handed-in standard normals: t = 0 from the initial
    draw, every later state from the transition, each emission with its
    own draw — written out with the model's matrices."""
    f = _lgssm_fields(4)
    params = ParamsLGSSM(**{k: t(v) for k, v in f.items()})
    rng = np.random.default_rng(5)
    draws = tm.SampleDraws(*(t(rng.standard_normal(s))
                             for s in ((2,), (6, 2), (6, 1))))
    states, emissions = tm.LinearGaussianSSM(2, 1).sample(params, 6,
                                                          draws=draws)
    Lq = np.linalg.cholesky(f["dynamics_covariance"])
    Lr = np.linalg.cholesky(f["emission_covariance"])
    x = np.linalg.cholesky(f["initial_covariance"]) @ draws.initial.numpy()
    for s in range(6):
        if s > 0:
            x = f["dynamics_matrix"] @ x + Lq @ draws.dynamics[s].numpy()
        np.testing.assert_allclose(states[s].numpy(), x, atol=1e-14)
        np.testing.assert_allclose(
            emissions[s].numpy(),
            f["emission_matrix"] @ x + Lr @ draws.emission[s].numpy(),
            atol=1e-14)
    gen = torch.Generator().manual_seed(0)
    s, e = tm.LinearGaussianSSM(2, 1).sample(params, 5, generator=gen)
    assert s.shape == (5, 2) and e.shape == (5, 1)


# ---------------------------------------------------------------------------
# Linear-Gaussian EM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lgssm_long():
    """dx = 2, T = 4,100 (above the 4,096 dispatch), and the JAX E-step's
    statistics, jitted."""
    rng = np.random.default_rng(11)
    fields = testing.lgssm_fields(rng, 2, 2)
    emissions = rng.standard_normal((4100, 2))
    jp = JParamsLGSSM(**{k: jnp.asarray(v) for k, v in fields.items()})
    e_step = jm.LinearGaussianSSM(2, 2).e_step
    want = {T: jax_fast(e_step, jp, jnp.asarray(emissions[:T]))
            for T in (60, 4100)}
    return fields, emissions, want


@pytest.mark.parametrize("length", [60, 4100])
def test_lgssm_e_step_matches_jax(length, lgssm_long):
    """The statistics and log-likelihood of the sequential (T = 60) and
    the parallel (T = 4,100) smoother pass."""
    fields, emissions, want = lgssm_long
    emissions, want = emissions[:length], want[length]
    params = ParamsLGSSM(**{k: t(v) for k, v in fields.items()})
    stats, ll = tm.LinearGaussianSSM(2, 2).e_step(params, t(emissions))
    assert_close(ll, want[1], FIT_TOL)
    for name in want[0]._fields:
        assert_close(getattr(stats, name), getattr(want[0], name), FIT_TOL)


def test_lgssm_dispatch_length():
    assert tlg._PARALLEL_SMOOTHER_MIN_T == 4096


@pytest.fixture(scope="module")
def lgssm_em():
    """Three sequences of 60 steps, the JAX fit_em over 4 iterations from
    F = 0.5·I, Q = I, R = I, with H frozen."""
    rng = np.random.default_rng(12)
    fields = _lgssm_fields(12)
    fields.update(dynamics_matrix=0.5 * np.eye(2),
                  dynamics_covariance=np.eye(2),
                  emission_covariance=np.eye(1))
    emissions = rng.standard_normal((3, 60, 1))
    jprops = jm.PropsLGSSM(emission_matrix=jm.ParameterProperties(False))
    jp = JParamsLGSSM(**{k: jnp.asarray(v) for k, v in fields.items()})
    fitted, lls = jm.LinearGaussianSSM(2, 1).fit_em(
        jp, jprops, jnp.asarray(emissions), num_iters=4, verbose=False)
    return fields, emissions, fitted, lls


def test_lgssm_fit_em_matches_jax(lgssm_em):
    fields, emissions, want, want_lls = lgssm_em
    params = ParamsLGSSM(**{k: t(v) for k, v in fields.items()})
    props = tm.PropsLGSSM(emission_matrix=tm.ParameterProperties(False))
    fitted, lls = tm.LinearGaussianSSM(2, 1).fit_em(
        params, props, t(emissions), num_iters=4, verbose=False)
    assert_close(lls, want_lls, FIT_TOL)
    for name in fields:
        assert_close(getattr(fitted, name), getattr(want, name), FIT_TOL)
    assert torch.equal(fitted.emission_matrix, params.emission_matrix)


def test_lgssm_m_step_matches_jax(lgssm_em):
    """One M-step on the port's batch statistics of the three sequences,
    every field trained (props None)."""
    fields, emissions, _, _ = lgssm_em
    params = ParamsLGSSM(**{k: t(v) for k, v in fields.items()})
    tmodel = tm.LinearGaussianSSM(2, 1)
    stats, _ = tmodel.e_step(params, t(emissions))
    got, _ = tmodel.m_step(params, None, stats, None)
    jp = JParamsLGSSM(**{k: jnp.asarray(v) for k, v in fields.items()})
    jstats = JSuffStatsLGSSM(*(jnp.asarray(x.numpy()) for x in stats))
    want, _ = jax_fast(lambda p, s: jm.LinearGaussianSSM(2, 1).m_step(
        p, None, s, None), jp, jstats)
    for name in fields:
        assert_close(getattr(got, name), getattr(want, name), FIT_TOL)


# ---------------------------------------------------------------------------
# SGD
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "adam": (optax.adam(0.05), functools.partial(torch.optim.Adam, lr=0.05)),
    "sgd": (optax.sgd(0.01), functools.partial(torch.optim.SGD, lr=0.01)),
}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_run_sgd_matches_jax(opt):
    """run_sgd on a least-squares loss with a minibatch term: the loss
    trace and the fitted values, three sequences a minibatch."""
    rng = np.random.default_rng(3)
    A, b = rng.standard_normal((6, 3)), rng.standard_normal(6)
    data = rng.standard_normal((8, 3))

    def loss(lib, p, mb):
        w, s = p["w"], p["s"]
        return (((lib.asarray(A) @ w - lib.asarray(b)) ** 2).sum()
                + ((mb @ w) ** 2).sum() * s ** 2)

    jopt, topt = OPTIMIZERS[opt]
    p0 = {"w": np.ones(3), "s": np.array(0.5), "f": np.cos}
    want, want_losses = jax_run_sgd(
        lambda p, mb: loss(jnp, p, mb),
        {k: jnp.asarray(v) if k != "f" else v for k, v in p0.items()},
        jnp.asarray(data), jopt, batch_size=3, num_epochs=4)
    got, losses = _fit.run_sgd(
        lambda p, mb: loss(torch, p, mb),
        {k: t(v) if k != "f" else v for k, v in p0.items()}, t(data), topt,
        batch_size=3, num_epochs=4)
    assert_close(losses, want_losses, FIT_TOL)
    assert_close(got["w"], want["w"], FIT_TOL)
    assert got["f"] is np.cos and not got["w"].requires_grad


def _sgd_props(lib, bij):
    frozen = lib.ParameterProperties(trainable=False)
    return lib.ParamsNLSSM(*[frozen] * 8)._replace(
        initial_mean=lib.ParameterProperties(),
        dynamics_noise_covariance=lib.ParameterProperties(
            constrainer=bij.RealToPSD(2)),
        emission_noise_covariance=lib.ParameterProperties(
            constrainer=bij.RealToPSD(2)))


@pytest.fixture(scope="module")
def sgd_problem(lg_model):
    jmodel, jp, tmodel, tp = lg_model
    emissions = np.random.default_rng(1).standard_normal((4, 15, 2))
    return jmodel, jp, tmodel, tp, emissions


def test_fit_sgd_matches_jax_one_sequence_a_step(sgd_problem):
    """Adam, one sequence a minibatch, 2 epochs (8 steps): the JAX
    fit_sgd's loss trace and fitted Q, R and initial mean."""
    jmodel, jp, tmodel, tp, emissions = sgd_problem
    want, want_losses = jmodel.fit_sgd(
        jp, _sgd_props(jm, jb), jnp.asarray(emissions),
        optimizer=optax.adam(0.02), batch_size=1, num_epochs=2)
    got, losses = tmodel.fit_sgd(
        tp, _sgd_props(tm, tb), t(emissions),
        optimizer=functools.partial(torch.optim.Adam, lr=0.02),
        batch_size=1, num_epochs=2)
    assert_close(losses, want_losses, FIT_TOL)
    for name in ("initial_mean", "dynamics_noise_covariance",
                 "emission_noise_covariance"):
        assert_close(getattr(got, name), getattr(want, name), FIT_TOL)
    assert torch.equal(got.initial_covariance, tp.initial_covariance)


def test_fit_sgd_matches_the_per_sequence_sum(sgd_problem):
    """SGD, two sequences a minibatch: JAX's run_sgd on fit_sgd's loss
    with the sequences' log-likelihoods summed one at a time."""
    jmodel, jp, tmodel, tp, emissions = sgd_problem
    jprops = _sgd_props(jm, jb)
    size = emissions.size

    def jloss(unc, mb):
        params = jm.from_unconstrained(unc, jprops)
        lls = sum(jmodel.marginal_log_prob(params, y) for y in mb[0])
        return -(lls * len(emissions) / len(mb[0])) / size

    want, want_losses = jax_run_sgd(
        jloss, jm.to_unconstrained(jp, jprops), (jnp.asarray(emissions), None),
        optax.sgd(0.05), batch_size=2, num_epochs=2)
    got, losses = tmodel.fit_sgd(
        tp, _sgd_props(tm, tb), t(emissions),
        optimizer=functools.partial(torch.optim.SGD, lr=0.05),
        batch_size=2, num_epochs=2)
    assert_close(losses, want_losses, FIT_TOL)
    want = jm.from_unconstrained(want, jprops)
    assert_close(got.dynamics_noise_covariance,
                 want.dynamics_noise_covariance, FIT_TOL)


def test_jax_vmapped_gradient_is_not_the_per_sequence_sum(sgd_problem):
    """Why the test above sums one sequence at a time: the JAX package's
    gradient of the vmapped EKF log-likelihood over two sequences differs
    from the sum of its per-sequence gradients, which the port's batched
    gradient equals."""
    jmodel, jp, tmodel, tp, emissions = sgd_problem
    Q0 = jp.dynamics_noise_covariance

    def jvmapped(Q):
        p = jp._replace(dynamics_noise_covariance=Q)
        return jnp.sum(jax.vmap(lambda y: jmodel.marginal_log_prob(p, y))(
            jnp.asarray(emissions[:2])))

    def jsummed(Q):
        p = jp._replace(dynamics_noise_covariance=Q)
        return sum(jmodel.marginal_log_prob(p, jnp.asarray(y))
                   for y in emissions[:2])

    Q = tp.dynamics_noise_covariance.clone().requires_grad_()
    tmodel.marginal_log_prob(tp._replace(dynamics_noise_covariance=Q),
                             t(emissions[:2])).sum().backward()
    want, vmapped = jax_fast(lambda Q: (jax.grad(jsummed)(Q),
                                        jax.grad(jvmapped)(Q)), Q0)
    assert_close(Q.grad, want, FIT_TOL)
    assert np.abs(np.asarray(vmapped) - np.asarray(want)).max() > 1e-3
