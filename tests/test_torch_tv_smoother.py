"""The port's time-varying parallel Kalman filter and smoother, its
extended and unscented RTS smoothers, ``project_to_psd_fast`` and
``zoo.scalar_growth`` against the JAX package, on the CPU.

The time-varying stacks are made with numpy from a seed (the random
model of ``tests/test_parallel_iterated.py``) and go as they are to both
sides; the nonlinear models' arrays cross by ``params_from_jax``.
Tolerances, relative to max(1, max|reference|): float64 1e-10 for the
time-varying scans (the same combine tree, factored and summed in another
order) and 1e-9 for the RTS smoothers (T steps of a filter, then the
backward recursion); float32 1e-4. The range-bearing model runs in float64
only: its R = 2.5e-5 makes the float32 filter stiff. The JAX scans are
jitted and compiled at XLA's lowest backend optimisation level.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesianfiltering_tpu.inference as jgf
from bayesianfiltering_tpu.models import zoo as jzoo
from bayesianfiltering_tpu.ops import associative as jas
from bayesianfiltering_tpu.ops.ukf import ParamsUKF as JParamsUKF
from bayesianfiltering_tpu.utils import linalg as jla
from bayesianfiltering_tpu_torch import inference as inf
from bayesianfiltering_tpu_torch.models import SampleDraws, params_from_jax, zoo
from bayesianfiltering_tpu_torch.models.params import ARRAY_FIELDS
from bayesianfiltering_tpu_torch.ops import associative as tas
from bayesianfiltering_tpu_torch.ops import linear as tlin
from bayesianfiltering_tpu_torch.ops.ukf import ParamsUKF
from bayesianfiltering_tpu_torch.utils import linalg as tla

torch.set_num_threads(1)

TV_TOL = {"float64": 1e-10, "float32": 1e-4}
RTS_TOL = 1e-9
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
POSTERIOR = ("marginal_loglik", "filtered_means", "filtered_covariances",
             "predicted_means", "predicted_covariances", "smoothed_means",
             "smoothed_covariances")
T = 40


@pytest.fixture(scope="module", autouse=True)
def x64():
    """64-bit JAX types for the file (the JAX models are built with them
    on); float32 references run inside ``jax_in("float32")``."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@contextlib.contextmanager
def jax_in(dtype):
    """JAX with 64-bit types on for float64 and off for float32."""
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


def compare(got, want, tol, fields=POSTERIOR):
    for name in fields:
        assert_close(getattr(got, name), getattr(want, name), tol)


def random_tv(T, dx, dy, seed, q_rank=None):
    """(m0, P0, Fs, cs, Qs, Hs, ds, Rs, ys) of a random time-varying model;
    ``q_rank`` < dx gives every step a Q of that rank."""
    rng = np.random.default_rng(seed)
    Fs = 0.7 * np.tile(np.eye(dx), (T, 1, 1)) + 0.1 * rng.normal(
        size=(T, dx, dx))
    cs = 0.1 * rng.normal(size=(T, dx))
    if q_rank is None:
        mats = rng.normal(size=(T, dx, dx))
        Qs = 0.5 * np.einsum("tij,tkj->tik", mats, mats) + np.eye(dx)
    else:
        G = rng.normal(size=(dx, q_rank))
        Qs = np.tile(0.1 * G @ G.T, (T, 1, 1))
    Hs = rng.normal(size=(T, dy, dx))
    ds = 0.1 * rng.normal(size=(T, dy))
    em = rng.normal(size=(T, dy, dy))
    Rs = 0.5 * np.einsum("tij,tkj->tik", em, em) + np.eye(dy)
    ys = rng.normal(size=(T, dy))
    return (rng.normal(size=(dx,)), np.eye(dx), Fs, cs, Qs, Hs, ds, Rs, ys)


def np_tv_kf(m0, P0, Fs, cs, Qs, Hs, ds, Rs, ys):
    """Sequential time-varying Kalman filter in float64: filtered means
    and covariances and the marginal log-likelihood (the oracle of
    ``tests/test_parallel_iterated.py``)."""
    fm, fP, ll = [], [], 0.0
    m, P = m0, P0
    for t in range(len(ys)):
        if t > 0:
            m = Fs[t] @ m + cs[t]
            P = Fs[t] @ P @ Fs[t].T + Qs[t]
        S = Hs[t] @ P @ Hs[t].T + Rs[t]
        resid = ys[t] - Hs[t] @ m - ds[t]
        ll += -0.5 * (len(resid) * np.log(2 * np.pi)
                      + np.linalg.slogdet(S)[1]
                      + resid @ np.linalg.solve(S, resid))
        K = np.linalg.solve(S, Hs[t] @ P).T
        m, P = m + K @ resid, P - K @ S @ K.T
        fm.append(m)
        fP.append(P)
    return np.array(fm), np.array(fP), ll


def jax_tv_smoother(args, dtype, solver, chunk):
    with jax_in(dtype):
        jargs = [jnp.asarray(a, dtype) for a in args]
        run = jax.jit(lambda *a: jas.parallel_kalman_smoother_tv(
            *a, solver=solver, chunk=chunk))
        return run.lower(*jargs).compile(FAST_COMPILE)(*jargs)


TV_CASES = [
    # (dx, dy, solver, chunk, dtype): each solver, each schedule and each
    # dtype, at both widths
    (3, 2, "woodbury", None, "float64"),
    (4, 2, "woodbury", 8, "float64"),
    (3, 2, "native", 8, "float64"),
    (4, 3, "native", None, "float64"),
    (4, 2, "woodbury", None, "float32"),
    (3, 2, "woodbury", 8, "float32"),
    (4, 2, "native", 8, "float32"),
]


@pytest.mark.parametrize("dx,dy,solver,chunk,dtype", TV_CASES)
def test_tv_filter_and_smoother_match_jax(dx, dy, solver, chunk, dtype):
    args = random_tv(T, dx, dy, seed=dx + 10 * dy)
    want = jax_tv_smoother(args, dtype, solver, chunk)
    got = tas.parallel_kalman_smoother_tv(
        *(torch.as_tensor(a, dtype=getattr(torch, dtype)) for a in args),
        solver=solver, chunk=chunk)
    compare(got, want, TV_TOL[dtype])


@pytest.mark.parametrize("chunk", [None, 8])
def test_tv_smoother_with_rank_deficient_q_matches_jax(chunk):
    """Q of rank 2 < dx = 4 at every step (the BOT family's F_q Q F_qᵀ):
    singular C1 in every Woodbury combine."""
    args = random_tv(30, 4, 2, seed=3, q_rank=2)
    want = jax_tv_smoother(args, "float64", "woodbury", chunk)
    got = tas.parallel_kalman_smoother_tv(*map(torch.as_tensor, args),
                                          chunk=chunk)
    compare(got, want, TV_TOL["float64"])
    fm, _, ll = np_tv_kf(*args)
    # the Woodbury combine's jitter moves the scan off the sequential
    # oracle at the 1e-7 level
    assert_close(got.filtered_means, fm, 1e-6)
    assert_close(got.marginal_loglik, ll, 1e-6)


def test_tv_filter_is_the_smoothers_forward_pass():
    args = [torch.as_tensor(a) for a in random_tv(T, 3, 2, seed=5)]
    post = tas.parallel_kalman_filter_tv(*args, chunk=8)
    smoothed = tas.parallel_kalman_smoother_tv(*args, chunk=8)
    compare(smoothed, post, 0.0, fields=post._fields[:5])
    assert post.smoothed_means is None


def test_tv_marginal_loglik_matches_jax_and_the_oracle():
    args = random_tv(T, 4, 3, seed=7)
    fm, fP, ll = np_tv_kf(*args)
    with jax_in("float64"):
        want = jas._marginal_loglik_tv(*map(jnp.asarray, args),
                                       jnp.asarray(fm), jnp.asarray(fP))
    got = tas._marginal_loglik_tv(*map(torch.as_tensor, args),
                                  torch.as_tensor(fm), torch.as_tensor(fP))
    assert_close(got, want, 1e-12)
    assert_close(got, ll, 1e-12)


def test_tv_elements_match_the_per_step_jax_elements():
    args = random_tv(6, 3, 2, seed=9)
    Fs, cs, Qs, Hs, ds, Rs, ys = args[2:]
    with jax_in("float64"):
        want = [jas._generic_element_tv(*(jnp.asarray(a[t]) for a in
                                          (Fs, cs, Qs, Hs, ds, Rs, ys)))
                for t in range(1, 6)]
    got = tas._generic_elements_tv(
        *(torch.as_tensor(a[1:]) for a in (Fs, cs, Qs, Hs, ds, Rs, ys)))
    for i, g in enumerate(got):
        assert_close(g, np.stack([w[i] for w in want]), 1e-12)


# ---------------------------------------------------------------------------
# project_to_psd_fast and zoo.scalar_growth
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,batch", [(1, (5,)), (4, (3,)), (130, ())])
def test_project_to_psd_fast_matches_jax(n, batch):
    """Newton–Schulz up to 128, the eigenvalue clamp above; the input is
    indefinite."""
    rng = np.random.default_rng(n)
    A = rng.normal(size=batch + (n, n))
    A = A + np.swapaxes(A, -1, -2) - 0.5 * n * np.eye(n)
    with jax_in("float64"):
        want = jla.project_to_psd_fast(jnp.asarray(A))
    got = tla.project_to_psd_fast(torch.as_tensor(A))
    assert_close(got, want, 1e-10)
    assert torch.linalg.eigvalsh(got).min() > -1e-6 * n


def test_scalar_growth_matches_jax():
    _, jp, _ = jzoo.scalar_growth(q=3.0, r=0.5)
    _, tp, _ = zoo.scalar_growth(q=3.0, r=0.5, dtype=torch.float64,
                                 device="cpu")
    for name in ARRAY_FIELDS:
        assert_close(getattr(tp, name), getattr(jp, name), 0.0)
    rng = np.random.default_rng(0)
    with jax_in("float64"):
        for _ in range(4):
            x, q, r = (rng.normal(size=1) * s for s in (4.0, 1.0, 1.0))
            for u in (rng.normal(size=1), np.asarray(rng.normal())):
                jx, tx = jnp.asarray(x), torch.as_tensor(x)
                ju, tu = jnp.asarray(u), torch.as_tensor(u)
                for jf, tf, noise in ((jp.dynamics_function,
                                       tp.dynamics_function, q),
                                      (jp.emission_function,
                                       tp.emission_function, r)):
                    jn, tn = jnp.asarray(noise), torch.as_tensor(noise)
                    assert_close(tf(tx, tn, tu), jf(jx, jn, ju), 1e-14)
                    for arg in (0, 1):
                        assert_close(
                            torch.func.jacfwd(tf, argnums=arg)(tx, tn, tu),
                            jax.jacfwd(jf, argnums=arg)(jx, jn, ju), 1e-14)
    # float32 stays float32 under jacfwd (a width-1 slice of the input)
    x32 = torch.ones(1)
    jac = torch.func.jacfwd(zoo.scalar_growth(device="cpu")[1]
                            .dynamics_function)(x32, x32, torch.zeros(1))
    assert jac.dtype == torch.float32


# ---------------------------------------------------------------------------
# the extended and unscented RTS smoothers
# ---------------------------------------------------------------------------


def jax_float64(jp):
    with jax_in("float64"):
        return jp._replace(**{k: jnp.asarray(getattr(jp, k), jnp.float64)
                              for k in ARRAY_FIELDS})


def port_params(jp, template):
    return params_from_jax(jp, template, dtype=torch.float64, device="cpu")


def range_bearing():
    """(JAX params, port params, inputs, emissions) of the T = 500 BOT
    experiment's model at T = 40, float64, emissions sampled by the port
    from numpy draws."""
    model, template, _ = zoo.range_bearing_tracking(dtype=torch.float64,
                                                    device="cpu")
    jp = jax_float64(jzoo.range_bearing_tracking()[1])
    tp = port_params(jp, template)
    inputs = zoo.bot_experiment_inputs(T, device="cpu")
    rng = np.random.default_rng(1)
    draws = SampleDraws(*(torch.as_tensor(rng.standard_normal(s))
                          for s in [(4,), (T, 2), (T, 2)]))
    _, em = model.sample(tp, T, inputs=inputs, draws=draws)
    return jp, tp, inputs, em


def scalar_growth():
    """The UNGM with a ramp input u_t = t/4 and N(0, 1) emissions."""
    jp = jax_float64(jzoo.scalar_growth()[1])
    tp = port_params(jp, zoo.scalar_growth(device="cpu")[1])
    inputs = torch.arange(T, dtype=torch.float64)[:, None] / 4
    em = torch.as_tensor(np.random.default_rng(2).standard_normal((T, 1)))
    return jp, tp, inputs, em


RTS_CASES = [
    # (model, smoother, additive)
    ("range_bearing", "extended", None),
    ("range_bearing", "unscented", False),
    ("scalar_growth", "extended", None),
    ("scalar_growth", "unscented", False),
    ("scalar_growth", "unscented", True),
]


@pytest.mark.parametrize("model,smoother,additive", RTS_CASES)
def test_rts_smoothers_match_jax(model, smoother, additive):
    jp, tp, inputs, em = (range_bearing if model == "range_bearing"
                          else scalar_growth)()
    ju, je = jnp.asarray(inputs.numpy()), jnp.asarray(em.numpy())
    with jax_in("float64"):
        if smoother == "extended":
            want = jgf.extended_rts_smoother(jp, je, inputs=ju)
        else:
            want = jgf.unscented_rts_smoother(
                jp, JParamsUKF(1.0, 0.0, 0.0, "cholesky"), je, inputs=ju,
                additive=additive)
    if smoother == "extended":
        got = inf.extended_rts_smoother(tp, em, inputs=inputs)
    else:
        got = inf.unscented_rts_smoother(
            tp, ParamsUKF(1.0, 0.0, 0.0, "cholesky"), em, inputs=inputs,
            additive=additive)
    assert isinstance(got, inf.PosteriorGaussianSmoothed)
    compare(got, want, RTS_TOL)


@pytest.mark.parametrize("smoother", ["extended", "unscented"])
def test_rts_smoothers_are_exact_on_a_linear_model(smoother):
    """On a linear-Gaussian model the ERTS is the Kalman smoother and the
    URTS too (the unscented transform is exact for a linear map), up to
    the filters' relative floor of 1e-6·max diag S on the innovation
    covariance, which moves them at the 1e-7 level."""
    model, params, _ = zoo.linear_gaussian(3, 2, dtype=torch.float64,
                                           device="cpu")
    lg = zoo.linear_gaussian_lgssm(3, 2, dtype=torch.float64, device="cpu")
    _, em = model.sample(params, 25,
                         generator=torch.Generator().manual_seed(0))
    want = tlin.kalman_smoother(lg, em)
    if smoother == "extended":
        got = inf.extended_rts_smoother(params, em)
    else:
        got = inf.unscented_rts_smoother(params, ParamsUKF(1.0, 0.0, 0.0),
                                         em)
    compare(got, want, 1e-6)


def test_rts_smoother_of_one_step_is_the_filter():
    _, tp, inputs, em = scalar_growth()
    post = inf.extended_rts_smoother(tp, em[:1], inputs=inputs[:1])
    assert torch.equal(post.smoothed_means, post.filtered_means)
    assert torch.equal(post.smoothed_covariances, post.filtered_covariances)
