"""The port's legacy (v0) filters against the JAX package's, on the CPU:
``SSM.simulate`` and ``Simulation``, the ``GaussFilt`` family (EKF of order
1 and 2, UKF, MCF, MCLAF), the composite bank, the standalone GSF, the
original AGSF in each selection mode, and ``BootstrapPF``, with the
normals and uniforms of the JAX key schedule handed over (``fold_in(key,
t)``, then ``split``). ``tests/test_torch_legacy_static.py`` holds the
solvers, the estimators, the static approximation and the ALA API.

Models: the linear fixture and the scalar nonlinear model of
tests/test_legacy.py, and the dx = 2 sinusoid of
experiments/legacy_experiment.py. Each JAX run is jitted and compiled at
XLA's lowest backend optimisation level (``agsf_parity.FAST_COMPILE``),
once a case, at T ≤ 10 and at most 256 particles.

Tolerances, relative to max(1, max|reference|): float64 1e-10; the
deterministic Gaussian filters (EKF, UKF, the GSFs) also in float32 at
5e-3, the port's end-to-end float32 bound, with JAX run with x64 off. The
BPF is held in float64 only: a float32 count can move by one.
"""
import contextlib

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from agsf_parity import FAST_COMPILE
from bayesianfiltering_tpu import legacy as jleg
from bayesianfiltering_tpu_torch import _build
from bayesianfiltering_tpu_torch import legacy as leg
from bayesianfiltering_tpu_torch.inference import BPFDraws
from bayesianfiltering_tpu_torch.legacy.gaussfilt import (
    BankDraws,
    SimulateDraws,
)
from bayesianfiltering_tpu_torch.legacy.gausssumfilt import AugDraws
from bayesianfiltering_tpu_torch.utils import resampling as rs

torch.set_num_threads(1)

TOL = {"float64": 1e-10, "float32": 5e-3}
T = 8
F64 = jnp.float64


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
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


def t(x, dtype="float64"):
    return torch.as_tensor(np.asarray(x, dtype))


def jax_fast(fn, *args):
    """``fn(*args)`` jitted and compiled at XLA's lowest optimisation
    level, fetched to numpy."""
    args = tuple(jnp.asarray(a) for a in args)
    out = jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)
    return jax.tree_util.tree_map(np.asarray, jax.device_get(out))


# ---------------------------------------------------------------------------
# the models, on both sides
# ---------------------------------------------------------------------------

def jax_model(name, dtype="float64"):
    d = jnp.dtype(dtype)
    if name == "linear":
        A, H = 0.8 * jnp.eye(2, dtype=d), 0.5 * jnp.eye(2, dtype=d)
        return jleg.SSM(2, 2, jnp.zeros(2, d), 0.1 * jnp.eye(2, dtype=d),
                        jnp.zeros(2, d), 0.1 * jnp.eye(2, dtype=d),
                        f=lambda x: A @ x, g=lambda x: H @ x)
    if name == "scalar":
        return jleg.SSM(1, 1, jnp.zeros(1, d), 0.5 * jnp.eye(1, dtype=d),
                        jnp.zeros(1, d), 0.5 * jnp.eye(1, dtype=d),
                        f=lambda x: 0.8 * x + 0.1 * jnp.sin(x),
                        g=lambda x: 0.5 * x + 0.05 * x ** 2)
    H = jnp.asarray(SINUSOID_H, d)
    return jleg.SSM(2, 1, jnp.zeros(2, d), jnp.eye(2, dtype=d),
                    jnp.zeros(1, d), 0.1 * jnp.eye(1, dtype=d),
                    f=lambda x: jnp.array([x[0] + jnp.sin(x[1]), 0.9 * x[0]]),
                    g=lambda x: (H @ x) / jnp.sum(H))


SINUSOID_H = np.array([[0.3, 0.7]])


def port_model(name, dtype="float64"):
    kw = dict(dtype=getattr(torch, dtype), device="cpu")
    if name == "linear":
        A, H = 0.8 * torch.eye(2, **kw), 0.5 * torch.eye(2, **kw)
        return leg.SSM(2, 2, torch.zeros(2, **kw), 0.1 * torch.eye(2, **kw),
                       torch.zeros(2, **kw), 0.1 * torch.eye(2, **kw),
                       f=lambda x: A @ x, g=lambda x: H @ x)
    if name == "scalar":
        return leg.SSM(1, 1, torch.zeros(1, **kw), 0.5 * torch.eye(1, **kw),
                       torch.zeros(1, **kw), 0.5 * torch.eye(1, **kw),
                       f=lambda x: 0.8 * x + 0.1 * torch.sin(x),
                       g=lambda x: 0.5 * x + 0.05 * x ** 2)
    H = torch.as_tensor(SINUSOID_H, **kw)
    return leg.SSM(2, 1, torch.zeros(2, **kw), torch.eye(2, **kw),
                   torch.zeros(1, **kw), 0.1 * torch.eye(1, **kw),
                   # width-1 slices: a 0-dim slice times a Python float
                   # makes jacfwd promote float32 to float64
                   f=lambda x: torch.cat([x[..., 0:1] + torch.sin(x[..., 1:2]),
                                          0.9 * x[..., 0:1]], -1),
                   g=lambda x: (x @ H.T) / H.sum())


DIMS = {"linear": (2, 2), "scalar": (1, 1), "sinusoid": (2, 1)}


def per_step(one, T):
    """``one(t)`` for t < T, vmapped and jitted: the key schedule's draws
    step by step, as one program (jax.random gives the same bits under
    vmap), as numpy."""
    out = jax.jit(jax.vmap(one))(jnp.arange(T))
    return jax.tree_util.tree_map(np.asarray, out)


def simulate_draws(key, T, dx, dy):
    """The normals of the legacy ``SSM.simulate``: T keys split from
    ``key``, each split in two."""
    def one(step):
        k1, k2 = jr.split(jr.split(key, T)[step])
        return jr.normal(k1, (dx,), F64), jr.normal(k2, (dy,), F64)
    return SimulateDraws(*map(t, per_step(one, T)))


@pytest.fixture(scope="module")
def data(x64):
    """Per model: (JAX states, JAX emissions) of a JAX rollout at T steps,
    and the port's rollout with the same draws."""
    out = {}
    for i, name in enumerate(sorted(DIMS)):
        dx, dy = DIMS[name]
        key = jr.PRNGKey(10 + i)
        x0 = 0.5 * np.ones(dx)
        want = jax_fast(lambda x: jax_model(name).simulate(T, x, key=key), x0)
        got = leg.Simulation(port_model(name), T, t(x0),
                             draws=simulate_draws(key, T, dx, dy))
        out[name] = (want, (got.states, got.observs))
    return out


def test_simulate_and_simulation_match_jax(data):
    for name, (want, got) in data.items():
        for g, w in zip(got, want):
            assert_close(g, w)
    # the wrapper takes a generator too, and a stochastic entry point
    # without one raises
    sim = leg.Simulation(port_model("linear"), 4, torch.zeros(2,
                         dtype=torch.float64),
                         generator=torch.Generator().manual_seed(0))
    assert sim.states.shape == (4, 2) and sim.observs.shape == (4, 2)
    with pytest.raises(ValueError, match="Generator"):
        port_model("linear").simulate(2, torch.zeros(2, dtype=torch.float64))


# ---------------------------------------------------------------------------
# the GaussFilt family
# ---------------------------------------------------------------------------

NUM_PARTICLES = 16


def gaussfilt_draws(key, T, N, dx):
    """The normals of ``GaussFilt.run``: a key folded per step, split into
    the predict's and the update's, (N, dx) each."""
    def one(step):
        k1, k2 = jr.split(jr.fold_in(key, step))
        return jnp.stack([jr.normal(k1, (N, dx), F64),
                          jr.normal(k2, (N, dx), F64)])
    return t(per_step(one, T))


def make_filter(pkg, ssm, kind, key=None):
    if kind == "ekf1":
        return pkg.EKF(ssm, order=1)
    if kind == "ekf2":
        return pkg.EKF(ssm, order=2)
    if kind == "ukf":
        return pkg.UKF(ssm, alpha=1.0, beta=2.0, kappa=0.0)
    extra = {} if key is None else {"key": key}
    if kind == "mcf":
        return pkg.MCF(ssm, NUM_PARTICLES, **extra)
    # two SDP steps (the default is 10): each unrolls three Newton–Schulz
    # projections into JAX's scan body, whose compile grows with them;
    # sdp_opt_legacy is held at 10 steps in test_torch_legacy_static.py
    return pkg.MCLAF(ssm, NUM_PARTICLES, sdp_steps=2, **extra)


GAUSS_CASES = [
    ("ekf1", "linear", "float64"), ("ekf1", "linear", "float32"),
    ("ekf2", "scalar", "float64"), ("ekf2", "sinusoid", "float64"),
    ("ekf2", "sinusoid", "float32"),
    ("ukf", "sinusoid", "float64"), ("ukf", "sinusoid", "float32"),
    ("mcf", "scalar", "float64"), ("mclaf", "sinusoid", "float64"),
]


@pytest.mark.parametrize("kind,model,dtype", GAUSS_CASES)
def test_gauss_filters_match_jax(data, kind, model, dtype):
    dx = DIMS[model][0]
    ys = np.asarray(data[model][0][1])
    m0, P0 = np.zeros(dx), np.eye(dx)
    key = jr.PRNGKey(4)
    with jax_precision(dtype):
        jfilt = make_filter(jleg, jax_model(model, dtype), kind, key)
        want = jax_fast(lambda *a: jfilt.run(*a),
                        *(np.asarray(a, dtype) for a in (ys, m0, P0)))
    pfilt = make_filter(leg, port_model(model, dtype), kind)
    draws = (gaussfilt_draws(key, T, NUM_PARTICLES, dx)
             if kind in ("mcf", "mclaf") else None)
    got = pfilt.run(t(ys, dtype), t(m0, dtype), t(P0, dtype), draws=draws)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        assert_close(g, w, dtype)


def test_order_two_differs_and_stochastic_filters_need_randomness(data):
    ys = t(data["scalar"][0][1])
    one = leg.EKF(port_model("scalar"), order=1).run(ys, t([0.0]), t([[1.0]]))
    two = leg.EKF(port_model("scalar"), order=2).run(ys, t([0.0]), t([[1.0]]))
    assert not torch.allclose(one[1], two[1])
    with pytest.raises(ValueError, match="Generator"):
        leg.MCF(port_model("scalar"), 4).run(ys, t([0.0]), t([[1.0]]))
    with pytest.raises(ValueError, match="unknown step"):
        leg.UKF(port_model("scalar")).which_step("smooth")
    g = torch.Generator().manual_seed(1)
    ll, means, covs = leg.MCLAF(port_model("scalar"), 8, generator=g).run(
        ys, t([0.0]), t([[1.0]]))
    assert means.shape == (T, 1) and torch.isfinite(covs).all()


# ---------------------------------------------------------------------------
# the Gaussian-sum filters
# ---------------------------------------------------------------------------

BANK = 4


def bank_draws(key, T, M, N, dx, stochastic, dtype="float64"):
    """The composite bank's normals: an init key and a run key split from
    ``key``; each step's folded key split over the M components, each of
    those into the predict's and the update's. JAX draws other bits in
    float32: a float32 case takes its draws in float32."""
    k_init, k_run = jr.split(key)

    def one(step):
        def comp(k):
            k1, k2 = jr.split(k)
            return jnp.stack([jr.normal(k1, (N, dx), F64),
                              jr.normal(k2, (N, dx), F64)])
        return jax.vmap(comp)(jr.split(jr.fold_in(k_run, step), M))
    return BankDraws(t(jr.normal(k_init, (M, dx), jnp.dtype(dtype)), dtype),
                     t(per_step(one, T)) if stochastic else None)


@pytest.mark.parametrize("kind,model,dtype", [
    ("ekf1", "linear", "float32"), ("ukf", "sinusoid", "float64"),
    ("mcf", "scalar", "float64"),
])
def test_composite_bank_matches_jax(data, kind, model, dtype):
    dx = DIMS[model][0]
    ys = np.asarray(data[model][0][1])
    m0, P0 = np.zeros(dx), np.eye(dx)
    key = jr.PRNGKey(5)
    with jax_precision(dtype):
        bank = jleg.CompositeGaussSumFilt(
            make_filter(jleg, jax_model(model, dtype), kind), BANK)
        want = jax_fast(lambda *a: bank.run(*a, key=key),
                        *(np.asarray(a, dtype) for a in (ys, m0, P0)))
        draws = bank_draws(key, T, BANK, NUM_PARTICLES, dx, kind == "mcf",
                           dtype)
    pbank = leg.CompositeGaussSumFilt(
        make_filter(leg, port_model(model, dtype), kind), BANK)
    got = pbank.run(t(ys, dtype), t(m0, dtype), t(P0, dtype), draws=draws)
    for g, w in zip(got, want):
        assert_close(g, w, dtype)
    # the same bank from a generator alone
    means, covs, weights, point = pbank.run(
        t(ys, dtype), t(m0, dtype), t(P0, dtype),
        generator=torch.Generator().manual_seed(0))
    assert means.shape == (T, BANK, dx) and point.shape == (T, dx)
    torch.testing.assert_close(weights.sum(1), torch.ones(T, dtype=weights.dtype))


@pytest.mark.parametrize("model,dtype", [
    ("sinusoid", "float64"), ("sinusoid", "float32"),
])
def test_standalone_gsf_matches_jax(data, model, dtype):
    dx = DIMS[model][0]
    ys = np.asarray(data[model][0][1])
    m0, P0 = np.zeros(dx), np.eye(dx)
    key = jr.PRNGKey(0)  # run's default key
    with jax_precision(dtype):
        gsf = jleg.GaussSumFilt(jax_model(model, dtype), BANK)
        want = jax_fast(lambda *a: gsf.run(*a),
                        *(np.asarray(a, dtype) for a in (ys, m0, P0)))
        init = t(jr.normal(key, (BANK, dx), jnp.dtype(dtype)), dtype)
    got = leg.GaussSumFilt(port_model(model, dtype), BANK).run(
        t(ys, dtype), t(m0, dtype), t(P0, dtype), init_eps=init)
    for g, w in zip(got, want):
        assert_close(g, w, dtype)


def aug_draws(key, T, M, N, L, dx):
    """The AGSF's draws: a key folded per step, split five ways (the
    predict's 'test' points over M keys, the first split, the update's
    'test' points over M·N keys, the second split, the reduction)."""
    def one(step):
        k1, k2, k3, k4, k5 = jr.split(jr.fold_in(key, step), 5)
        test_points = jax.vmap(lambda k: jr.normal(k, (3, dx), F64))
        return (test_points(jr.split(k1, M)), jr.normal(k2, (M, N, dx), F64),
                test_points(jr.split(k3, M * N)),
                jr.normal(k4, (M * N, L, dx), F64),
                jr.uniform(k5, (M,), F64))
    return AugDraws(*map(t, per_step(one, T)))


# The SDP modes unroll 10 projected-gradient steps of three Newton–Schulz
# projections each into JAX's scan body: one such run compiles for 15-20 s
# at XLA's lowest level, two in one body for ~60 s. "opt_lip" and
# "opt_max_grad" are held to the JAX class's own ``_select`` instead
# (below), with the carried gradient bound step by step.
AUG_MODES = [
    (("prop", "prop"), (0.2, 0.2), "scalar"),
    (("test", "test"), (0.1, 0.1), "sinusoid"),
    (("input", "input"), (0.05, 0.05), "scalar"),
]


@pytest.mark.parametrize("modes,args,model", AUG_MODES,
                         ids=["-".join(m[0]) for m in AUG_MODES])
def test_aug_gsf_selection_modes_match_jax(data, modes, args, model):
    dx = DIMS[model][0]
    M, N, L = 3, 2, 2
    ys = np.asarray(data[model][0][1])
    m0, P0 = np.zeros(dx), np.eye(dx)
    key = jr.PRNGKey(8)
    jargs = tuple(a * jnp.eye(dx) for a in args) if modes[0] == "input" \
        else args
    agsf = jleg.AugGaussSumFilt(jax_model(model), M, N, L, key=key)
    agsf.set_aug_selection_params(*jargs, mode1=modes[0], mode2=modes[1])
    want = jax_fast(lambda *a: agsf.run(*a), ys, m0, P0)
    pargs = tuple(a * torch.eye(dx, dtype=torch.float64) for a in args) \
        if modes[0] == "input" else args
    pagsf = leg.AugGaussSumFilt(port_model(model), M, N, L)
    pagsf.set_aug_selection_params(*pargs, mode1=modes[0], mode2=modes[1])
    got = pagsf.run(t(ys), t(m0), t(P0),
                    draws=aug_draws(key, T, M, N, L, dx))
    for g, w in zip(got, want):
        assert_close(g, w)


@pytest.mark.parametrize("mode,side", [("opt_lip", "upd"),
                                       ("opt_max_grad", "pred")])
def test_aug_gsf_sdp_selection_matches_jax(mode, side):
    """The JAX class's own ``_select`` (eager, one component at a time)
    against the port's batched one on the sinusoid, with a gradient bound
    of 2.5 carried in."""
    rng = np.random.default_rng(3)
    means = rng.standard_normal((2, 2))
    covs = np.stack([np.eye(2) + 0.3 * np.diag(rng.uniform(size=2))
                     for _ in range(2)])
    jagsf = jleg.AugGaussSumFilt(jax_model("sinusoid"), 2, 2, 2)
    pagsf = leg.AugGaussSumFilt(port_model("sinusoid"), 2, 2, 2)
    if side == "pred":
        jargs = (jagsf.f_hessian, jagsf.f_jacobian, 2, 2)
        hess, num = pagsf.f_hessian, 2
    else:
        jargs = (jagsf.g_hessian, jagsf.g_jacobian, 2, 1)
        hess, num = pagsf.g_hessian, 2
    want = [np.asarray(jagsf._select(mode, 0.7, jnp.asarray(m),
                                     jnp.asarray(P), *jargs, 2.5, None))
            for m, P in zip(means, covs)]
    got = pagsf._select(mode, 0.7, t(means), t(covs), hess, num,
                        t(2.5), None)
    assert_close(got, np.stack(want))


def test_aug_gsf_carries_the_gradient_bound(data):
    """"opt_max_grad" scales the Lipschitz constant by the largest |∂f/∂x|
    over the previous step's branched means (1 at the first step). The
    port's run with JAX's draws, each step's Δ against the JAX class's own
    ``_select`` at the port's carried mixture and that bound, rebuilt here
    from the draws (the scalar model: ∂f/∂x = 0.8 + 0.1 cos x)."""
    M, N, L, steps = 3, 2, 2, 2
    ys = np.asarray(data["scalar"][0][1])[:steps]
    draws = aug_draws(jr.PRNGKey(8), steps, M, N, L, 1)
    pagsf = leg.AugGaussSumFilt(port_model("scalar"), M, N, L)
    pagsf.set_aug_selection_params(0.5, 0.2, mode1="opt_max_grad",
                                   mode2="prop")
    means, covs, _, deltas, _ = pagsf.run(t(ys), t([0.0]), t([[1.0]]),
                                          draws=draws)
    jagsf = jleg.AugGaussSumFilt(jax_model("scalar"), M, N, L)
    m, P, bound = np.zeros((M, 1)), np.ones((M, 1, 1)), 1.0
    for step in range(steps):
        want = [np.asarray(jagsf._select(
            "opt_max_grad", 0.5, jnp.asarray(mi), jnp.asarray(Pi),
            jagsf.f_hessian, jagsf.f_jacobian, N, 1, bound, None))
            for mi, Pi in zip(m, P)]
        assert_close(deltas[step], np.stack(want))
        spread = np.sqrt(np.maximum(P - deltas[step].numpy(), 0.0))[:, 0, 0]
        branched = m + spread[:, None] * draws.split1[step].numpy()[..., 0]
        bound = float(np.max(np.abs(0.8 + 0.1 * np.cos(branched))))
        m, P = means[step].numpy(), covs[step].numpy()


def test_aug_gsf_generator_default_and_unknown_mode(data):
    ys = t(data["scalar"][0][1])
    agsf = leg.AugGaussSumFilt(port_model("scalar"), 3, 2, 2,
                               generator=torch.Generator().manual_seed(0))
    means, covs, point, deltas, lambdas = agsf.run(ys, t([0.0]), t([[1.0]]))
    # the default selection is proportional with 0.1
    assert means.shape == (T, 3, 1) and lambdas.shape == (T, 6, 1, 1)
    assert torch.isfinite(point).all()
    agsf.set_aug_selection_params(0.1, 0.1, mode1="prop", mode2="bogus")
    with pytest.raises(ValueError, match="unknown selection mode"):
        agsf.run(ys, t([0.0]), t([[1.0]]))
    with pytest.raises(ValueError, match="Generator"):
        leg.AugGaussSumFilt(port_model("scalar"), 3, 2, 2).run(
            ys, t([0.0]), t([[1.0]]))


# ---------------------------------------------------------------------------
# the bootstrap particle filter
# ---------------------------------------------------------------------------

def bpf_draws(key, T, N, dx, resampler):
    k_init, k_run = jr.split(key)

    def one(step):
        k_prop, k_res = jr.split(jr.fold_in(k_run, step))
        return (jr.normal(k_prop, (N, dx), F64),
                jr.uniform(k_res, rs.UNIFORM_SHAPES[resampler](N), F64))
    dyn, res = per_step(one, T)
    return BPFDraws(t(jr.normal(k_init, (N, dx), F64)), t(dyn), t(res))


@pytest.mark.parametrize("resampler,model,N", [
    ("systematic", "linear", 256), ("stratified", "sinusoid", 64),
    ("multinomial", "scalar", 64),
])
def test_bootstrap_pf_matches_jax(data, resampler, model, N):
    dx = DIMS[model][0]
    ys = np.asarray(data[model][0][1])
    m0, P0 = np.zeros(dx), np.eye(dx)
    key = jr.PRNGKey(10)
    bpf = jleg.BootstrapPF(jax_model(model), N, key=key, resampler=resampler)
    want = jax_fast(lambda *a: bpf.run(*a), ys, m0, P0)
    _build.reset_launch_counts()
    got = leg.BootstrapPF(port_model(model), N, resampler=resampler).run(
        t(ys), t(m0), t(P0), draws=bpf_draws(key, T, N, dx, resampler))
    assert_close(got, want)
    # CPU tensors run K5's plain version: no launch
    assert all(k.launches == 0 for k in _build.KERNELS)


def test_bootstrap_pf_generator_and_unknown_resampler(data):
    pf = leg.BootstrapPF(port_model("linear"), 32,
                         generator=torch.Generator().manual_seed(0))
    hist = pf.run(t(data["linear"][0][1]), t(np.zeros(2)), t(np.eye(2)))
    assert hist.shape == (T, 32, 2) and torch.isfinite(hist).all()
    with pytest.raises(ValueError, match="unknown resampler"):
        leg.BootstrapPF(port_model("linear"), 32, resampler="residual")
