"""The port's UKF family against the JAX package's, on the CPU.

Inputs are made with numpy and fed to both sides; the mixture filters get
JAX's own draws (the key schedule of tests/test_torch_gsf_agsf.py).
Covered: the PSD square roots and projections, the sigma points, ``MVN``
and the metrics, every ``ops/ukf.py`` primitive (with and without a
residual function), the IPLF at ``num_iter=2``, the plain versions of the
UT kernels K6–K9 against their XLA twins (and once each, at its smallest
shape, against the JAX kernel in Pallas interpret mode), the batched UKF
on Lorenz-96, the UGSF and UAGSF on bearings-only and range-bearing
tracking, and ``params_from_jax`` for the range-bearing model.

Tolerances, relative to max(1, max|reference|): float64 1e-9 — the same
formulas through other factorisation routines and summation orders;
float32 1e-4 — float32 rounding through the factorisations, at α = 1 (the
setting of every experiment). The reference's default α = 1e-3 puts
W₀ ≈ −1e6 on the center point, which cancels catastrophically in float32,
so it is held at float64 only.
"""
import contextlib
import importlib

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import bayesianfiltering_tpu.inference as jgf
from bayesianfiltering_tpu import distributions as jdist
from bayesianfiltering_tpu.models import zoo as jzoo
from bayesianfiltering_tpu.ops import fused_ut as jfu
from bayesianfiltering_tpu.ops import ukf as juk
from bayesianfiltering_tpu.utils import angles as jangles
from bayesianfiltering_tpu.utils import linalg as jla
from bayesianfiltering_tpu.utils import metrics as jmet
from bayesianfiltering_tpu_torch import _build, distributions, testing
from bayesianfiltering_tpu_torch import inference as inf
from bayesianfiltering_tpu_torch.models import params_from_jax, zoo
from bayesianfiltering_tpu_torch.models.params import ARRAY_FIELDS
from bayesianfiltering_tpu_torch.ops import fused_ut as fu
from bayesianfiltering_tpu_torch.ops import ukf
from bayesianfiltering_tpu_torch.utils import angles, linalg, metrics

# both packages' utils namespaces export a function of the same name
sp = importlib.import_module("bayesianfiltering_tpu_torch.utils.sigma_points")
jsp = importlib.import_module("bayesianfiltering_tpu.utils.sigma_points")

pl = pytest.importorskip("jax.experimental.pallas")
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

torch.set_num_threads(1)

TOL = {"float64": 1e-9, "float32": 1e-4}
CPU64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@contextlib.contextmanager
def jax_precision(dtype):
    """float32 cases run JAX with x64 off, so its constants are float32."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def assert_close(got, want, dtype="float64"):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.nanmax(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


def t(x, dtype="float64"):
    return torch.as_tensor(np.asarray(x, dtype))


FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args):
    """``fn(*args)`` jitted and compiled at XLA's lowest backend
    optimisation level: the references' time here is their compile."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


# ---------------------------------------------------------------------------
# numerical base
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 8, 130])
def test_psd_roots_and_projections_match_jax(n):
    rng = np.random.default_rng(n)
    spd = testing.spd(rng, 2, n)
    ill = spd @ np.diag(np.logspace(-5, 0, n)) @ spd / n
    ill = 0.5 * (ill + np.swapaxes(ill, -1, -2))
    sym = rng.standard_normal((2, n, n))
    assert_close(linalg.sqrtm_psd(t(spd)), jla.sqrtm_psd(jnp.asarray(spd)))
    assert_close(linalg.sqrtm_psd_eigh(t(spd)),
                 jla.sqrtm_psd_eigh(jnp.asarray(spd)))
    assert_close(linalg.project_to_psd(t(sym)),
                 jla.project_to_psd(jnp.asarray(sym)))
    if n <= 8:
        # Newton–Schulz: 14 steps, the same partial convergence on an
        # ill-conditioned matrix as the reference's
        for a in (spd, ill):
            assert_close(linalg.sqrtm_psd_ns(t(a)),
                         jla.sqrtm_psd_ns(jnp.asarray(a)))
        assert_close(linalg.project_to_psd_ns(t(sym)),
                     jla.project_to_psd_ns(jnp.asarray(sym)))


@pytest.mark.parametrize("method", ["cholesky", "sqrtm"])
def test_sigma_points_match_jax(method):
    rng = np.random.default_rng(11)
    m, P = testing.sigma_inputs(rng, 3, 5)
    _, _, bias, C = testing.sigma_aug_inputs(rng, 1, 1, 2)
    jb, jC = jnp.asarray(bias), jnp.asarray(C)
    # the JAX side compiled as one program
    pts, block, split, aug = jax_fast(lambda a, b: (
        jax.vmap(lambda x, y: jsp.sigma_points(x, y, 0.7, method))(a, b),
        jax.vmap(lambda x, y: jsp.sigma_points_blockdiag(
            x, y, jb, jC, -0.4, method))(a, b),
        jsp.split_to_sigma_points(a[0], b[0], 0.7),
        jax.vmap(lambda x, y: juk._augment(x, y, jb, jC))(a, b)),
        jnp.asarray(m), jnp.asarray(P))
    assert_close(sp.sigma_points(t(m), t(P), 0.7, method), pts)
    assert_close(sp.sigma_points_blockdiag(t(m), t(P), t(bias), t(C), -0.4,
                                           method), block)
    assert_close(sp.split_to_sigma_points(t(m[0]), t(P[0]), 0.7), split)
    for got, want in zip(sp.unscented_weights(5, 0.5, 2.0, 1.0),
                         jsp.unscented_weights(5, 0.5, 2.0, 1.0)):
        assert_close(torch.as_tensor(got), want)
    for got, want in zip(ukf._augment(t(m), t(P), t(bias), t(C)), aug):
        assert_close(got, want)


def test_non_pd_cholesky_points_are_nan_on_both_sides():
    m, P = testing.sigma_inputs(np.random.default_rng(2), 2, 4)
    P = -np.broadcast_to(np.eye(4), P.shape)
    got = sp.sigma_points(t(m), t(P), 0.0, "cholesky")
    want = jax.vmap(lambda a, b: jsp.sigma_points(a, b, 0.0, "cholesky"))(
        jnp.asarray(m), jnp.asarray(P))
    # JAX NaNs the factor's lower triangle, the port all of it: every
    # point set carries NaN on both sides, and nothing raises
    assert np.isnan(np.asarray(want)).any(axis=(-2, -1)).all()
    assert torch.isnan(got).all()
    assert torch.isnan(fu.fused_sigma(t(m), t(P), 2.0, "cholesky")).all()


def test_mvn_and_metrics_match_jax():
    rng = np.random.default_rng(5)
    mean, cov = rng.standard_normal(3), testing.spd(rng, 1, 3)[0]
    mean2, cov2 = rng.standard_normal(3), testing.spd(rng, 1, 3)[0]
    x = rng.standard_normal((4, 3))
    eps = rng.standard_normal((5, 3))
    est, base = rng.standard_normal((6, 3)), rng.standard_normal((6, 3))
    means, covs = rng.standard_normal((4, 3)), testing.spd(rng, 4, 3)
    w = rng.uniform(size=4)
    w = w / w.sum()
    parts = rng.standard_normal(7)

    def jax_side(mean, cov, mean2, cov2, x, est, base, means, covs, w,
                 parts):
        jmvn = jdist.MVN(mean, cov)
        return (jmvn.log_prob(x), jmvn.mean(), jmvn.covariance(),
                jmet.mse(est, base), jmet.rmse(est, base),
                jmet.collapse(means, covs, w),
                jmet.normal_KL_div(mean, mean2, cov, cov2),
                jmet.normal_kl(mean, mean2, cov, cov2),
                jmet.W_distance(means[:, 0], covs[:, 0, 0], parts, w),
                jmet.gaussian_logpdf(x[0], mean, cov),
                jmet.gm(0.3, means[:, 0], 0.5, 4),
                jmet.loss(covs[0], covs[1], 2.0, 3.0, covs[2]))

    # the JAX side compiled as one program
    (log_prob, jmean, jcov, mse, rmse, collapse, kl_div, kl, w_dist, logpdf,
     gm, loss) = jax_fast(jax_side, *map(jnp.asarray, (
         mean, cov, mean2, cov2, x, est, base, means, covs, w, parts)))
    tmvn = distributions.MVN(t(mean), t(cov))
    assert_close(tmvn.log_prob(t(x)), log_prob)
    assert_close(tmvn.sample(5, eps=t(eps)),
                 mean + eps @ np.linalg.cholesky(cov).T)
    assert_close(tmvn.mean(), jmean)
    assert_close(tmvn.covariance(), jcov)
    with pytest.raises(ValueError):
        distributions.MVN(t(mean))

    assert_close(metrics.mse(t(est), t(base)), mse)
    assert_close(metrics.rmse(t(est), t(base)), rmse)
    for g, j in zip(metrics.collapse(t(means), t(covs), t(w)), collapse):
        assert_close(g, j)
    args = tuple(map(t, (mean, mean2, cov, cov2)))
    assert_close(metrics.normal_KL_div(*args), kl_div)
    assert_close(metrics.normal_kl(*args), kl)
    assert_close(metrics.W_distance(t(means[:, 0]), t(covs[:, 0, 0]),
                                    t(parts), t(w)), w_dist)
    assert_close(metrics.gaussian_logpdf(t(x[0]), t(mean), t(cov)), logpdf)
    assert_close(metrics.gm(0.3, t(means[:, 0]), 0.5, 4), gm)
    assert_close(metrics.loss(*map(t, (covs[0], covs[1])), 2.0, 3.0,
                              t(covs[2])), loss)
    assert metrics.dec_to_base(255, 16) == jmet.dec_to_base(255, 16) == "FF"


# ---------------------------------------------------------------------------
# ops/ukf.py primitives
# ---------------------------------------------------------------------------

DX, NQ, DY = 4, 3, 2


def _models(lib):
    """(f_additive, f_nonadditive, h) in JAX (``lib == "jax"``) or torch;
    h's bearing is emission component 0."""
    if lib == "jax":
        f_add = lambda x, q, u: 0.9 * x + 0.2 * jnp.sin(x) + q
        f_aug = lambda x, q, u: (0.9 * x + 0.2 * jnp.sin(x)
                                 + jnp.concatenate([q, q[:1]]))
        h = lambda x, r, u: jnp.stack([jnp.arctan2(x[1], x[0]),
                                       x[2] * x[3]]) + r
        return f_add, f_aug, h
    f_add = lambda x, q, u: 0.9 * x + 0.2 * torch.sin(x) + q
    f_aug = lambda x, q, u: (0.9 * x + 0.2 * torch.sin(x)
                             + torch.cat([q, q[..., :1]], dim=-1))
    h = lambda x, r, u: torch.cat([torch.atan2(x[..., 1:2], x[..., 0:1]),
                                   x[..., 2:3] * x[..., 3:4]], dim=-1) + r
    return f_add, f_aug, h


def _step_inputs(seed):
    rng = np.random.default_rng(seed)
    m, P = testing.sigma_inputs(rng, 3, DX)
    return dict(m=m + 1.0, P=0.3 * P, Qa=testing.spd(rng, 1, DX, 0.1)[0],
                Qn=testing.spd(rng, 1, NQ, 0.1)[0], q0=0.05 * np.ones(NQ),
                R=testing.spd(rng, 1, DY, 0.2)[0], r0=0.01 * np.ones(DY),
                y=rng.standard_normal(DY))


UKF_SETTINGS = [("float64", (1e-3, 2.0, 0.0)), ("float64", (1.0, 0.0, 0.0)),
                ("float32", (1.0, 0.0, 0.0))]


STEPS = ["predict_additive", "predict_nonadditive", "condition_additive",
         "condition_nonadditive"]
_PRIMITIVES = {}


def jax_primitives(method, dtype, weights):
    """The four JAX primitives' results on ``_step_inputs(1)`` for one
    setting, vmapped over the batch and compiled as one program (a
    compile a setting, not a step), kept for the module."""
    key = (method, dtype, weights)
    if key not in _PRIMITIVES:
        x = _step_inputs(1)
        with jax_precision(dtype):
            jf_add, jf_aug, jh = _models("jax")
            up = juk.ParamsUKF(*weights, method)
            J = {k: jnp.asarray(v, dtype) for k, v in x.items()}

            def one(m, P):
                # the residual function on the condition steps with sqrtm
                jres = (jangles.angular_residual((0,))
                        if method == "sqrtm" else None)
                return (
                    juk.ukf_predict_additive(m, P, jf_add, None, J["Qa"], up,
                                             J["q0"]),
                    juk.ukf_predict_nonadditive(m, P, jf_aug, None, J["Qn"],
                                                up, J["q0"]),
                    juk.ukf_condition_on_additive(m, P, jh, J["R"], None,
                                                  J["y"], up, J["r0"], jres),
                    juk.ukf_condition_on_nonadditive(m, P, jh, J["R"], None,
                                                     J["y"], up, J["r0"],
                                                     jres))

            out = jax_fast(jax.vmap(one), J["m"], J["P"])
        _PRIMITIVES[key] = {s: [np.asarray(w) for w in o]
                            for s, o in zip(STEPS, out)}
    return _PRIMITIVES[key]


@pytest.mark.parametrize("dtype,weights", UKF_SETTINGS)
@pytest.mark.parametrize("method", ["cholesky", "sqrtm"])
@pytest.mark.parametrize("step", STEPS)
def test_ukf_primitives_match_jax(step, method, dtype, weights):
    x = _step_inputs(1)
    residual = step.startswith("condition") and method == "sqrtm"
    want = jax_primitives(method, dtype, weights)[step]
    tf_add, tf_aug, th = _models("torch")
    tres = angles.angular_residual((0,)) if residual else None
    up = ukf.ParamsUKF(*weights, method)
    T = {k: t(v, dtype) for k, v in x.items()}
    for fn in (getattr(ukf, f"ukf_{step.replace('condition', 'condition_on')}"),
               getattr(fu, f"fused_ukf_{step.replace('condition', 'condition_on')}")):
        if step == "predict_additive":
            got = fn(T["m"], T["P"], tf_add, None, T["Qa"], up, T["q0"])
        elif step == "predict_nonadditive":
            got = fn(T["m"], T["P"], tf_aug, None, T["Qn"], up, T["q0"])
        else:
            got = fn(T["m"], T["P"], th, T["R"], None, T["y"], up, T["r0"],
                     tres)
        for g, w in zip(got, want):
            assert g.dtype == getattr(torch, dtype)
            assert_close(g, w, dtype)


def test_iterated_posterior_linearization_matches_jax():
    x = _step_inputs(2)
    _, _, jh = _models("jax")
    _, _, th = _models("torch")
    jres, tres = jangles.angular_residual((0,)), angles.angular_residual((0,))
    J = {k: jnp.asarray(v) for k, v in x.items()}
    T = {k: t(v) for k, v in x.items()}
    for num_iter in (1, 2):
        want = jax_fast(jax.vmap(
            lambda m, P: juk.ukf_condition_on_nonadditive_iterated(
                m, P, jh, J["R"], None, J["y"], juk.ParamsUKF(1.0, 0.0, 0.0),
                J["r0"], num_iter, jres)), J["m"], J["P"])
        got = ukf.ukf_condition_on_nonadditive_iterated(
            T["m"], T["P"], th, T["R"], None, T["y"],
            ukf.ParamsUKF(1.0, 0.0, 0.0), T["r0"], num_iter, tres)
        for g, w in zip(got, want):
            assert_close(g, w)


# ---------------------------------------------------------------------------
# plain versions of K6–K9 against the JAX kernels and their XLA twins
# ---------------------------------------------------------------------------

def _interpret(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return fn(*args)


def _xla_twin(xla, args, batched_args):
    """The kernel's XLA twin, vmapped over the batch: the reference the
    plain versions are held to (tests/test_pallas.py holds each Pallas body
    to the same twin)."""
    return jax_fast(jax.vmap(lambda *b: xla(*b, *args)), *batched_args)


def _check_twin(got, want):
    got_t = got if isinstance(got, tuple) else (got,)
    want_t = tuple(want) if isinstance(want, (tuple, list)) else (want,)
    for g, w in zip(got_t, want_t):
        assert_close(g, w)


def _check_pallas(pallas, args, batched_args, got):
    """The JAX kernel itself in interpret mode on one element (batch 1, the
    smallest shape): once a kernel, since interpret mode costs seconds a
    call."""
    want = _interpret(pallas, *(b[0] for b in batched_args), *args)
    got_t = got if isinstance(got, tuple) else (got,)
    want_t = tuple(want) if isinstance(want, (tuple, list)) else (want,)
    for g, w in zip(got_t, want_t):
        assert_close(g[0], w)


@pytest.mark.parametrize("method", ["cholesky", "sqrtm"])
def test_sigma_kernels_plain_match_jax(method):
    rng = np.random.default_rng(21)
    m, P = testing.sigma_inputs(rng, 2, 6)
    want = _xla_twin(jfu._sigma_xla, (1.7, method),
                     (jnp.asarray(m), jnp.asarray(P)))
    _check_twin(fu.fused_sigma(t(m), t(P), 1.7, method), want)
    m, P, bias, C = testing.sigma_aug_inputs(rng, 2, 5, 3)
    aug = lambda k: (lambda a, b, *s: k(a, b, jnp.asarray(bias),
                                        jnp.asarray(C), *s))
    want = _xla_twin(aug(jfu._sigma_aug_xla), (1.3, method),
                     (jnp.asarray(m), jnp.asarray(P)))
    _check_twin(fu.fused_sigma_aug(t(m), t(P), t(bias), t(C), 1.3, method),
                want)
    if method == "cholesky":
        # K6 and K7 in interpret mode at their smallest shapes
        m, P = testing.sigma_inputs(rng, 1, 2)
        _check_pallas(jfu._sigma_pallas, (1.7, method),
                      (jnp.asarray(m), jnp.asarray(P)),
                      fu.fused_sigma(t(m), t(P), 1.7, method))
        m, P, bias, C = testing.sigma_aug_inputs(rng, 1, 2, 1)
        _check_pallas(aug(jfu._sigma_aug_pallas), (1.3, method),
                      (jnp.asarray(m), jnp.asarray(P)),
                      fu.fused_sigma_aug(t(m), t(P), t(bias), t(C), 1.3,
                                         method))


def _moment_cases(rng, add_noise, B, rows, ld, dx, dy, prows, pdx):
    """The UT update's and predict's JAX arguments and the port's results
    on one set of inputs: ``((pallas, xla, args, batched), got)`` each."""
    w_side, w0m, w0c = 1.0 / rows, -0.5, 1.2
    consts = (w_side, w0m, w0c)
    pts, hpts, cy, _, m, P, R, _ = testing.ut_update_inputs(rng, B, rows, ld,
                                                           dx, dy)
    ptsx = pts[..., :dx] if add_noise else pts  # the strided state part
    y = rng.standard_normal(dy)
    mu_y = w_side * hpts.sum(-2) + w0m * cy
    update = (
        lambda *a: jfu._ut_update_pallas(*a[:6], jnp.asarray(y), *a[6:]),
        lambda *a: jfu._ut_update_xla(*a[:6], jnp.asarray(y), *a[6:]),
        (consts, add_noise),
        tuple(jnp.asarray(a) for a in (pts[..., :dx], hpts, cy, m, P))
        + (jnp.broadcast_to(jnp.asarray(R), (B, dy, dy)),))
    got_u = fu.fused_ut_update(t(ptsx), t(hpts), t(cy), t(mu_y), t(m), t(P),
                               t(R), t(y - mu_y), w_side, w0c, add_noise)
    fpts, center, Q = testing.ut_predict_inputs(rng, B, prows, pdx)
    pconsts = (1.0 / prows, -0.5, 1.2)
    predict = (
        lambda a, b, *s: jfu._ut_predict_pallas(a, b, jnp.asarray(Q), *s),
        lambda a, b, *s: jfu._ut_predict_xla(a, b, jnp.asarray(Q), *s),
        (pconsts, add_noise), (jnp.asarray(fpts), jnp.asarray(center)))
    got_p = fu.fused_ut_predict(t(fpts), t(center), t(Q), *pconsts,
                                add_noise)
    return (update, got_u), (predict, got_p)


@pytest.mark.parametrize("add_noise", [True, False])
def test_moment_kernels_plain_match_jax(add_noise):
    rng = np.random.default_rng(22)
    for (pallas, xla, args, batched), got in _moment_cases(
            rng, add_noise, 2, 12, 7, 5, 3, 10, 4):
        _check_twin(got, _xla_twin(xla, args, batched))
    if add_noise:
        # K8 and K9 in interpret mode at their smallest shapes
        for (pallas, xla, args, batched), got in _moment_cases(
                rng, add_noise, 1, 4, 3, 2, 1, 4, 2):
            _check_pallas(pallas, args, batched, got)


def test_kernel_ops_backward_matches_jax_vjp():
    """The kernel ops' backward re-runs the plain version under autograd;
    it must match ``jax.vjp`` of the XLA twins (float64)."""
    rng = np.random.default_rng(23)
    m, P = testing.sigma_inputs(rng, 2, 4)
    ct = rng.standard_normal((2, 8, 4))
    tm, tP = t(m).requires_grad_(), t(P).requires_grad_()
    fu.fused_sigma(tm, tP, 1.5, "sqrtm").backward(t(ct))
    want = jax_fast(lambda a, b, c: jax.vjp(jax.vmap(
        lambda a, b: jfu._sigma_xla(a, b, 1.5, "sqrtm")), a, b)[1](c),
        jnp.asarray(m), jnp.asarray(P), jnp.asarray(ct))
    for g, w in zip((tm.grad, tP.grad), want):
        assert_close(g, w)
    fpts, center, Q = testing.ut_predict_inputs(rng, 2, 8, 3)
    cts = (rng.standard_normal((2, 3)), rng.standard_normal((2, 3, 3)))
    ins = [t(a).requires_grad_() for a in (fpts, center, Q)]
    torch.autograd.backward(fu.fused_ut_predict(*ins, 0.125, 0.0, 0.0, True),
                            [t(c) for c in cts])
    want = jax_fast(lambda a, b, q, c: jax.vjp(jax.vmap(
        lambda a, b, q: jfu._ut_predict_xla(a, b, q, (0.125, 0.0, 0.0), True),
        in_axes=(0, 0, None)), a, b, q)[1](c),
        *map(jnp.asarray, (fpts, center, Q)), tuple(map(jnp.asarray, cts)))
    for g, w in zip((x.grad for x in ins), want):
        assert_close(g, w)


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------


def jax_params(params, dtype):
    return params._replace(**{k: jnp.asarray(getattr(params, k), dtype)
                              for k in ARRAY_FIELDS})


@pytest.fixture(scope="module")
def lorenz96_emissions(x64):
    model, params, _ = zoo.lorenz96(8, 4, integrator="rk4", **CPU64)
    g = torch.Generator().manual_seed(0)
    _, emissions = model.sample(params, 15, generator=g, batch_shape=(3,))
    return emissions.numpy()


@pytest.mark.parametrize("additive,dtype,weights,method", [
    (True, "float64", (1.0, 0.0, 0.0), "sqrtm"),
    (False, "float64", (1.0, 0.0, 0.0), "cholesky"),
    (True, "float64", (1e-3, 2.0, 0.0), "cholesky"),
    (False, "float64", (1e-3, 2.0, 0.0), "sqrtm"),
    (True, "float32", (1.0, 0.0, 0.0), "cholesky"),
    (False, "float32", (1.0, 0.0, 0.0), "sqrtm"),
])
def test_ukf_lorenz96_batched(lorenz96_emissions, additive, dtype, weights,
                              method):
    """At the default α = 1e-3 the moments cancel terms of size |W₀| ≈ 1e6,
    so each step's rounding is ~1e6 ulp, which the filter carries on; as in
    tests/test_golden_parity.py, those runs are held over their first step
    (one update and one predict)."""
    em = lorenz96_emissions
    if weights[0] < 1.0:
        em = em[:, :1]
    with jax_precision(dtype):
        _, jp, _ = jzoo.lorenz96(8, 4)
        jp = jax_params(jp, dtype)
        up = juk.ParamsUKF(*weights, method)
        want = jax_fast(jax.vmap(lambda e: jgf.unscented_kalman_filter(
            jp, up, e, additive=additive)), jnp.asarray(em, dtype))
        want = jax.tree_util.tree_map(np.asarray, want)
    _, tp, _ = zoo.lorenz96(8, 4, dtype=getattr(torch, dtype), device="cpu")
    got = inf.unscented_kalman_filter(tp, ukf.ParamsUKF(*weights, method),
                                      t(em, dtype), additive=additive)
    for name in want._fields:
        assert_close(getattr(got, name), getattr(want, name), dtype)


def test_ukf_single_sequence_iplf_and_options(lorenz96_emissions):
    em = lorenz96_emissions
    _, jp, _ = jzoo.lorenz96(8, 4)
    _, tp, _ = zoo.lorenz96(8, 4, **CPU64)
    up = ukf.ParamsUKF(1.0, 0.0, 0.0)
    want = jax_fast(lambda e: jgf.unscented_kalman_filter(
        jp, juk.ParamsUKF(1.0, 0.0, 0.0), e, num_iter=2), jnp.asarray(em[1]))
    got = inf.unscented_kalman_filter(tp, up, t(em[1]), num_iter=2)
    assert got.filtered_means.shape == (15, 8)
    for name in want._fields:
        assert_close(getattr(got, name), getattr(want, name))
    with pytest.raises(ValueError, match="IPLF"):
        inf.unscented_kalman_filter(tp, up, t(em), additive=True, num_iter=2)
    with pytest.raises(ValueError, match="sqrt_method"):
        inf.unscented_kalman_filter(tp, ukf.ParamsUKF(1.0, 0.0, 0.0, "eigh"),
                                    t(em), additive=True)


T_MIX = 10
MIX_MODELS = {
    "bot": (jzoo.bearings_only_tracking, jzoo.bot_maneuver_inputs,
            lambda: zoo.bearings_only_tracking(**CPU64)),
    "range_bearing": (jzoo.range_bearing_tracking, jzoo.bot_experiment_inputs,
                      lambda: zoo.range_bearing_tracking(**CPU64)),
}


@pytest.fixture(scope="module", params=sorted(MIX_MODELS))
def mixture_problem(request, x64):
    jmake, jinputs, tmake = MIX_MODELS[request.param]
    jmodel, jparams, _ = jmake()
    inputs = jinputs(T_MIX)
    _, emissions = jmodel.sample(jparams, jr.PRNGKey(4), T_MIX, inputs=inputs)
    return dict(jparams=jparams, tparams=tmake()[1], inputs=np.asarray(inputs),
                emissions=np.asarray(emissions))


UP = (1.0, 0.0, 0.0)


def test_ugsf_with_injected_initial_means(mixture_problem):
    p, M, key = mixture_problem, 4, jr.PRNGKey(3)
    want = jax_fast(lambda e, u: jgf.unscented_gaussian_sum_filter(
        p["jparams"], juk.ParamsUKF(*UP), e, M, inputs=u, key=key),
        jnp.asarray(p["emissions"]), jnp.asarray(p["inputs"]))
    got = inf.unscented_gaussian_sum_filter(
        p["tparams"], ukf.ParamsUKF(*UP), t(p["emissions"]), M,
        inputs=t(p["inputs"]), init_eps=t(jr.normal(key, (M, 4), jnp.float64)))
    for name in ("means", "covariances", "weights", "predicted_means",
                 "predicted_covariances", "marginal_loglik"):
        assert_close(getattr(got, name), getattr(want, name))


def jax_agsf_draws(rng_key, T, M, N, L, dx, reduction):
    """The normals and uniforms JAX's _agsf_engine draws."""
    init_key, scan_key = jr.split(rng_key)
    split1, split2, reduce = [], [], []
    for step in range(T):
        k1, k2, kr = jr.split(jr.fold_in(scan_key, step), 3)
        split1.append(jr.normal(k1, (M, N, dx), jnp.float64))
        split2.append(jr.normal(k2, (M * N, L, dx), jnp.float64))
        if reduction == "systematic":
            reduce.append(jr.uniform(kr, (), jnp.float64))
    return inf.AGSFDraws(
        t(jr.normal(init_key, (M, dx), jnp.float64)),
        t(jnp.stack(split1)), t(jnp.stack(split2)),
        t(jnp.stack(reduce)) if reduce else None)


@pytest.mark.parametrize("reduction,T", [("topk", T_MIX), ("systematic", 1)])
def test_uagsf_with_injected_draws(mixture_problem, reduction, T):
    p, rng_key = mixture_problem, jr.PRNGKey(1)
    want_post, want_aux = jax_fast(lambda e, u: jgf.unscented_agsf(
        p["jparams"], juk.ParamsUKF(*UP), e, [4, 2, 2], rng_key, 1,
        (0.9, 0.9), u, reduction=reduction),
        jnp.asarray(p["emissions"][:T]), jnp.asarray(p["inputs"][:T]))
    got_post, got_aux = inf.speedy_unscented_agsf(
        p["tparams"], ukf.ParamsUKF(*UP), t(p["emissions"][:T]), [4, 2, 2],
        opt_args=(0.9, 0.9), inputs=t(p["inputs"][:T]), reduction=reduction,
        draws=jax_agsf_draws(rng_key, T, 4, 2, 2, 4, reduction))
    for name in ("means", "covariances", "weights", "marginal_loglik"):
        assert_close(getattr(got_post, name), getattr(want_post, name))
    assert sorted(got_aux) == sorted(want_aux)
    for name in want_aux:
        assert_close(got_aux[name], want_aux[name])


def test_ukf_family_on_cpu_tensors_never_launches(mixture_problem):
    _build.reset_launch_counts()
    p = mixture_problem
    up, e, u = ukf.ParamsUKF(*UP), t(p["emissions"][:3]), t(p["inputs"][:3])
    g = torch.Generator().manual_seed(0)
    inf.unscented_kalman_filter(p["tparams"], up, e, inputs=u)
    _, lp, _ = zoo.lorenz96(6, 3, **CPU64)
    inf.unscented_kalman_filter(lp, up, lp.initial_mean.new_ones(4, 3),
                                additive=True)
    inf.unscented_gaussian_sum_filter(p["tparams"], up, e, 3, inputs=u,
                                      generator=g)
    inf.unscented_agsf(p["tparams"], up, e, [2, 2, 2], g, inputs=u,
                       reduction="stratified")
    assert all(k.launches == 0 for k in _build.KERNELS)


# ---------------------------------------------------------------------------
# models and the device policy
# ---------------------------------------------------------------------------


def test_params_from_jax_carries_the_range_bearing_model():
    _, jp, _ = jzoo.range_bearing_tracking()
    _, template, _ = zoo.range_bearing_tracking(device="cpu")
    got = params_from_jax(jp, template, dtype=torch.float64, device="cpu")
    for name in ARRAY_FIELDS:
        value = getattr(got, name)
        assert value.dtype == torch.float64 and value.device.type == "cpu"
        assert_close(value, getattr(jp, name))
    for name in ("dynamics_function", "emission_function",
                 "emission_jacobian_x", "emission_jacobian_r",
                 "emission_residual"):
        assert getattr(got, name) is getattr(template, name)
    x = np.array([0.3, 0.1, -0.7, 0.2])
    assert_close(template.emission_jacobian_x(t(x, "float32"), None, None),
                 jp.emission_jacobian_x(jnp.asarray(x), None, None), "float32")
    assert_close(template.emission_jacobian_r(t(x), None, None), np.eye(2))
    np.testing.assert_array_equal(zoo.bot_experiment_inputs(23, "cpu").numpy(),
                                  np.asarray(jzoo.bot_experiment_inputs(23)))


@pytest.mark.parametrize("make", [
    lambda: zoo.lorenz96(8, 4),
    lambda: zoo.bearings_only_tracking(),
    lambda: zoo.range_bearing_tracking(),
    lambda: zoo.linear_gaussian(),
    lambda: zoo.bot_maneuver_inputs(6),
    lambda: zoo.bot_experiment_inputs(6),
])
def test_zoo_names_no_device_then_needs_a_card(make, monkeypatch):
    """The zoo builds on the card by default; without one, a call that
    names no device raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
