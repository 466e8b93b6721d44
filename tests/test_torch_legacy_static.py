"""The port's legacy (v0) solvers, estimators and static helpers against
the JAX package's, on the CPU: ``sdp_opt_legacy`` and ``sdp_opt_test``,
the ALA mean estimators (``mean_estimators``), ``AugmentedJointApproximation``,
the oldest ALA API (``ala.StateSpaceModel``), the legacy nonlinearity zoo
and ``plot_cov_ellipse``; the JAX key schedule's normals are handed over.
``tests/test_torch_legacy.py`` holds the filters.

The JAX ALA class computes in float32 throughout (``jnp.float32`` casts).
Its float64 reference is the same class with the module's ``jnp`` seen
through a proxy whose ``float32`` is ``float64`` (the package's files stay
as they are); the float32 class as shipped holds the port's float32
deterministic filters at 5e-3.

Tolerances, relative to max(1, max|reference|): float64 1e-10; float32
5e-3, the port's end-to-end float32 bound.
"""
import types

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from agsf_parity import FAST_COMPILE
from bayesianfiltering_tpu.legacy import ala as jala
from bayesianfiltering_tpu.legacy import mean_estimators as jme
from bayesianfiltering_tpu.legacy import nonlinearities as jnl
from bayesianfiltering_tpu.legacy import static_utils as jsu
from bayesianfiltering_tpu.utils import sdp as jsdp
from bayesianfiltering_tpu_torch import utils
from bayesianfiltering_tpu_torch.legacy import ala, mean_estimators as me
from bayesianfiltering_tpu_torch.legacy import nonlinearities as nl
from bayesianfiltering_tpu_torch.legacy import static_utils as su
from bayesianfiltering_tpu_torch.legacy.gaussfilt import SimulateDraws

torch.set_num_threads(1)

TOL = {"float64": 1e-10, "float32": 5e-3}
F64 = jnp.float64


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def assert_close(got, want, dtype="float64"):
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


def t(x, dtype="float64"):
    return torch.as_tensor(np.array(x, dtype))


def jax_fast(fn, *args):
    """``fn(*args)`` jitted and compiled at XLA's lowest backend
    optimisation level, fetched to numpy."""
    out = jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)
    return jax.tree_util.tree_map(np.asarray, out)


def spd(rng, n, scale=1.0):
    a = rng.standard_normal((n, n))
    return scale * (a @ a.T / n + np.eye(n))


# ---------------------------------------------------------------------------
# the legacy solvers
# ---------------------------------------------------------------------------

def test_sdp_opt_legacy_matches_jax_over_a_batch():
    """Two problems at n = 2 and one at n = 3, 10 steps; the port takes
    the n = 2 pair as one batch. JAX runs eagerly (its 10 unrolled steps
    compile slower than they run)."""
    rng = np.random.default_rng(0)
    for n, B in ((2, 2), (3, 1)):
        P = np.stack([spd(rng, n) for _ in range(B)])
        H = np.stack([spd(rng, n, 0.5) for _ in range(B)])
        want = [np.asarray(jsdp.sdp_opt_legacy(n, 10, 1.0, jnp.asarray(p),
                                               jnp.asarray(p), jnp.asarray(h),
                                               10, 0.01))
                for p, h in zip(P, H)]
        got = utils.sdp_opt_legacy(n, 10, 1.0, t(P), t(P), t(H), 10, 0.01)
        assert got.shape == (B, n, n)
        assert_close(got, np.stack(want))
        one = utils.sdp_opt_legacy(n, 10, 1.0, t(P[0]), t(P[0]), t(H[0]), 10,
                                   0.01)
        assert_close(one, want[0])


@pytest.mark.parametrize("dim_out", [2, None])
def test_sdp_opt_test_matches_jax(dim_out):
    """A Hessian stack (num_prt, dim_out, n, n), and the 3-D scalar-output
    stack (num_prt, n, n); one problem and a batch of two."""
    rng = np.random.default_rng(1)
    n, num = 3, 3
    shape = (num, n, n) if dim_out is None else (num, dim_out, n, n)
    P = np.stack([spd(rng, n) for _ in range(2)])
    hess = 0.3 * rng.standard_normal((2,) + shape)
    hess = 0.5 * (hess + np.swapaxes(hess, -1, -2))
    want = [np.asarray(jsdp.sdp_opt_test(
        n, dim_out or 1, num, 0.1, jnp.asarray(p), jnp.asarray(p),
        jnp.asarray(h), 10, 0.1)) for p, h in zip(P, hess)]
    got = utils.sdp_opt_test(n, dim_out or 1, num, 0.1, t(P), t(P), t(hess),
                             10, 0.1)
    assert_close(got, np.stack(want))
    assert_close(utils.sdp_opt_test(n, dim_out or 1, num, 0.1, t(P[1]),
                                    t(P[1]), t(hess[1]), 10, 0.1), want[1])


# ---------------------------------------------------------------------------
# the ALA mean estimators and the static joint approximation
# ---------------------------------------------------------------------------

def quad_g(lib):
    if lib == "jax":
        return lambda x: jnp.sum(x ** 2) + jnp.sin(x[0])
    return lambda x: (x ** 2).sum(-1) + torch.sin(x[..., 0])


def test_each_estimator_matches_jax_with_its_normals():
    m, P = np.array([1.0, -0.5]), np.array([[1.0, 0.2], [0.2, 0.5]])
    delta = 0.4 * P
    key = jr.PRNGKey(2)
    jm, jP, jd = map(jnp.asarray, (m, P, delta))
    g, jg = quad_g("torch"), quad_g("jax")
    eps = t(jr.normal(key, (16, 2), F64))
    want = jax_fast(lambda m, P, d: (
        jme.mc_estimate(key, jg, m, P, 16),
        jme.mcl_estimate(key, jg, m, P, d, 16),
        jme.mcq_estimate(key, jg, m, P, d, 16),
        jme.mc2_estimate(key, jg, m, P, d, 5, 4),
        jme.simple_quadratic_estimate(jg, m, P),
        jme.smart_quadratic_estimate(jg, m, P, d)), jm, jP, jd)
    k1, k2 = jr.split(key)
    mc2_eps = (t(jr.normal(k1, (5, 2), F64)), t(jr.normal(k2, (4, 5, 2), F64)))
    got = (me.mc_estimate(g, t(m), t(P), 16, eps=eps),
           me.mcl_estimate(g, t(m), t(P), t(delta), 16, eps=eps),
           me.mcq_estimate(g, t(m), t(P), t(delta), 16, eps=eps),
           me.mc2_estimate(g, t(m), t(P), t(delta), 5, 4, eps=mc2_eps),
           me.simple_quadratic_estimate(g, t(m), t(P)),
           me.smart_quadratic_estimate(g, t(m), t(P), t(delta)))
    for gv, wv in zip(got, want):
        assert_close(gv, wv)
    assert_close(me.optimal_delta(g, t(m), t(P), 10),
                 jme.optimal_delta(jg, jm, jP, 10))
    with pytest.raises(ValueError, match="Generator"):
        me.mc_estimate(g, t(m), t(P), 16)


def compare_draws(key, B, trials, n, dx):
    """The normals of ``compare_estimators``: a baseline key and a trials
    key split from ``key``; each trial's key shared by MC, MCL and MCQ and
    split in two for MC2."""
    k_base, k_trials = jr.split(key)
    tr, out, inn = [], [], []
    for k in jr.split(k_trials, trials):
        tr.append(jr.normal(k, (n, dx), F64))
        k1, k2 = jr.split(k)
        out.append(jr.normal(k1, (n, dx), F64))
        inn.append(jr.normal(k2, (n, n, dx), F64))
    return me.CompareDraws(t(jr.normal(k_base, (B, dx), F64)),
                           *(t(jnp.stack(x)) for x in (tr, out, inn)))


def test_compare_estimators_matches_jax():
    """The comparison table at 4 trials of 5 samples and a 400-sample
    baseline (the reference script's sizes cut), Δ from the solver."""
    m, P = np.array([1.0, -1.0]), np.diag([0.5, 0.25])
    key = jr.PRNGKey(0)
    kw = dict(num_samples=5, num_trials=4, baseline_samples=400)
    # Δ from the solver eagerly (10 unrolled steps compile slower than they
    # run), the table jitted at XLA's lowest optimisation level
    delta = jme.optimal_delta(quad_g("jax"), jnp.asarray(m), jnp.asarray(P),
                              kw["num_samples"])
    want = jax_fast(lambda m, P, d: jme.compare_estimators(
        key, quad_g("jax"), m, P, delta=d, **kw), jnp.asarray(m),
        jnp.asarray(P), delta)
    got = me.compare_estimators(quad_g("torch"), t(m), t(P),
                                draws=compare_draws(key, 400, 4, 5, 2), **kw)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        if isinstance(w, dict):
            for stat in w:
                assert_close(got[name][stat], w[stat])
        else:
            assert_close(got[name], w)
    # from a generator alone
    out = me.compare_estimators(quad_g("torch"), t(m), t(P),
                                generator=torch.Generator().manual_seed(0),
                                **kw)
    assert torch.isfinite(out["mcq"]["var"])


def test_augmented_joint_approximation_matches_jax():
    kw = dict(num_comp=8, dim_in=2, dim_out=1)
    mats = dict(mu=np.zeros(2), cov=np.eye(2), cov_tol=0.1 * np.eye(1),
                Delta=0.3 * np.eye(2))
    key = jr.PRNGKey(11)
    jaja = jsu.AugmentedJointApproximation(
        f=lambda x: jnp.array([jnp.sum(x ** 2)]), **kw,
        **{k: jnp.asarray(v) for k, v in mats.items()})
    (wm, wc, ww), wg = jax_fast(lambda y: jaja.return_posterior(y, key),
                                jnp.array([1.0]))
    aja = su.AugmentedJointApproximation(
        f=lambda x: (x ** 2).sum(-1, keepdim=True), **kw,
        **{k: t(v) for k, v in mats.items()})
    post, grads = aja.return_posterior(t([1.0]),
                                       eps=t(jr.normal(key, (8, 2), F64)))
    assert isinstance(post, su.MixtureModel)
    for g, w in zip((*post, grads), (wm, wc, ww, wg)):
        assert_close(g, w)


def test_plot_cov_ellipse_matches_jax():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cov, pos = np.array([[2.0, 0.3], [0.3, 0.5]]), np.array([1.0, -1.0])
    fig, ax = plt.subplots()
    want = jsu.plot_cov_ellipse(jnp.asarray(cov), pos, ax=ax)
    got = su.plot_cov_ellipse(t(cov), t(pos), ax=ax)
    for name in ("width", "height", "angle"):
        assert getattr(got, name) == pytest.approx(getattr(want, name),
                                                   abs=1e-12)
    np.testing.assert_allclose(got.center, want.center)
    plt.close(fig)


# ---------------------------------------------------------------------------
# the nonlinearity zoo under its legacy names
# ---------------------------------------------------------------------------

def test_legacy_nonlinearities_match_jax():
    x = np.array([[0.3, -1.2], [1.5, 0.4]])
    x8 = np.random.default_rng(4).standard_normal(8)
    q, r, y = np.zeros(8), np.zeros(4), np.arange(4.0)
    names = ("f2", "f3", "J3", "H3", "f4", "J4", "H4", "f5", "J5", "H5")
    f96, g96, lp96 = jnl.make_lorenz96(8, 4)
    # the JAX side compiled as one program
    want = jax_fast(lambda a, b: (
        [jax.vmap(j)(a) for j in jnl.make_f1(1.5)],
        [jax.vmap(getattr(jnl, n))(a) for n in names],
        [f96(b, q, None), g96(b, r, None), lp96(b, y, None)]),
        jnp.asarray(x), jnp.asarray(x8))
    tx = t(x)
    for p, w in zip(nl.make_f1(1.5), want[0]):
        assert_close(p(tx), w)
    for n, w in zip(names, want[1]):
        assert_close(getattr(nl, n)(tx), w)
    assert sorted(nl.__all__) == sorted(jnl.__all__)
    got = nl.make_lorenz96(8, 4, dtype=torch.float64, device="cpu")
    for g, a, w in zip(got, (q, r, y), want[2]):
        assert_close(g(t(x8), t(a), None), w)


# ---------------------------------------------------------------------------
# the oldest ALA API
# ---------------------------------------------------------------------------

FREQ = 10.0
T_ALA = 10


def jax_ala_float64():
    """The JAX ALA module's ``jnp`` with ``float32`` read as ``float64``."""
    proxy = types.SimpleNamespace(**{n: getattr(jnp, n) for n in dir(jnp)
                                     if not n.startswith("__")})
    proxy.float32 = jnp.float64
    return proxy


def ala_models(lib, dtype="float64"):
    if lib == "jax":
        f = lambda x: jnp.sin(x) * jnp.sin(FREQ * x)
        jd = lambda x: (jnp.sin(x) * FREQ * jnp.cos(FREQ * x)
                        + jnp.cos(x) * jnp.sin(FREQ * x))
        return f, (lambda x: x), jd, (lambda x: jnp.ones(()))
    f = lambda x: torch.sin(x) * torch.sin(FREQ * x)
    jd = lambda x: (torch.sin(x) * FREQ * torch.cos(FREQ * x)
                    + torch.cos(x) * torch.sin(FREQ * x))
    return f, (lambda x: x), jd, (lambda x: torch.ones((), dtype=x.dtype))


def ala_draws(key, T, num_comp):
    """``simulate``'s normals (T keys split from the model's key, each in
    two) and ``latent_ekf``'s (a key folded per step)."""
    xs, ys = [], []
    for k in jr.split(key, T):
        k1, k2 = jr.split(k)
        xs.append(jr.normal(k1, (1,), F64))
        ys.append(jr.normal(k2, (1,), F64))
    latent = [jr.normal(jr.fold_in(key, s), (num_comp, 1), F64)
              for s in range(T)]
    return (SimulateDraws(t(jnp.stack(xs)), t(jnp.stack(ys))),
            t(jnp.stack(latent)))


def run_jax_ala(key, dtype):
    """simulate, the EKF, the latent EKF and the UKF of the JAX class at
    T_ALA, jitted at XLA's lowest backend optimisation level."""
    f, g, jd, jo = ala_models("jax")
    params = jala.LinearModelParameters(0.0, 0.0, 0.1, 0.1)

    def run(x0):
        ssm = jala.StateSpaceModel(1, 1, f, g, key=key)
        states, obs = ssm.simulate(T_ALA, x0, params)
        init = [jnp.zeros(1), jnp.eye(1)]
        return (states, obs,
                ssm.extended_kalman_filter(obs, jd, jo, params, init),
                ssm.latent_ekf(obs, 10, 0.05 * jnp.eye(1), jd, jo, params,
                               init),
                ssm.unscented_kalman_filter(obs, init, params, 10, 2, 1))

    x0 = jnp.zeros(1, F64 if dtype == "float64" else jnp.float32)
    out = jax.jit(run).lower(x0).compile(FAST_COMPILE)(x0)
    return jax.tree_util.tree_map(np.asarray, out)


def test_ala_workflow_matches_jax(monkeypatch):
    key = jr.PRNGKey(0)
    monkeypatch.setattr(jala, "jnp", jax_ala_float64())
    states, obs, ekf, latent, ukf = run_jax_ala(key, "float64")
    monkeypatch.undo()
    f, g, jd, jo = ala_models("torch")
    params = ala.LinearModelParameters(0.0, 0.0, 0.1, 0.1)
    ssm = ala.StateSpaceModel(1, 1, f, g, dtype=torch.float64, device="cpu")
    sim_draws, latent_eps = ala_draws(key, T_ALA, 10)
    got_states, got_obs = ssm.simulate(T_ALA, torch.zeros(1, dtype=torch.float64),
                                       params, draws=sim_draws)
    assert_close(got_states, states)
    assert_close(got_obs, obs)
    init = [torch.zeros(1, dtype=torch.float64),
            torch.eye(1, dtype=torch.float64)]
    for got, want in (
            (ssm.extended_kalman_filter(got_obs, jd, jo, params, init), ekf),
            (ssm.latent_ekf(got_obs, 10,
                            0.05 * torch.eye(1, dtype=torch.float64), jd, jo,
                            params, init, eps=latent_eps), latent),
            (ssm.unscented_kalman_filter(got_obs, init, params, 10, 2, 1),
             ukf)):
        for gv, wv in zip(got, want):
            assert gv.dtype == torch.float64
            assert_close(gv, wv)
    with pytest.raises(ValueError, match="Generator"):
        ssm.latent_ekf(got_obs, 10, 0.05, jd, jo, params, init)


def test_ala_float32_filters_match_the_shipped_jax_class():
    """The JAX class as shipped (float32, x64 off) against the port's
    default float32 on the JAX rollout's observations."""
    jax.config.update("jax_enable_x64", False)
    try:
        _, obs, ekf, _, ukf = run_jax_ala(jr.PRNGKey(1), "float32")
    finally:
        jax.config.update("jax_enable_x64", True)
    f, g, jd, jo = ala_models("torch")
    params = ala.LinearModelParameters(0.0, 0.0, 0.1, 0.1)
    ssm = ala.StateSpaceModel(1, 1, f, g, device="cpu")
    init = [torch.zeros(1), torch.eye(1)]
    ys = torch.as_tensor(obs)
    for got, want in ((ssm.extended_kalman_filter(ys, jd, jo, params, init),
                       ekf),
                      (ssm.unscented_kalman_filter(ys, init, params, 10, 2, 1),
                       ukf)):
        for gv, wv in zip(got, want):
            assert gv.dtype == torch.float32
            assert_close(gv, wv, "float32")
