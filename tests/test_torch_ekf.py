"""The port's batched ``extended_kalman_filter`` against the JAX package's
(vmapped over sequences), on the CPU.

Emissions are sampled once with the port's model from numpy draws and the
very same arrays go to both filters. Tolerances (relative to
max(1, max|reference|)): float64 1e-9 — identical formulas, different
factorization routines, over T steps of a filter that damps rounding;
float32 1e-4 — float32 rounding through T steps of Cholesky updates (both
sides then run in float32 throughout).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesianfiltering_tpu.inference as jgf
from bayesianfiltering_tpu.models import zoo as jzoo
from bayesianfiltering_tpu_torch import inference as inf
from bayesianfiltering_tpu_torch.models import SampleDraws, zoo
from bayesianfiltering_tpu_torch.models.params import ARRAY_FIELDS

torch.set_num_threads(1)

TOL = {"float64": 1e-9, "float32": 1e-4}


FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args):
    """``fn(*args)`` jitted and compiled at XLA's lowest backend
    optimisation level: the reference's time here is its compile."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def assert_close(got, want, dtype):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


def sample_emissions(model, params, T, B, seed, inputs=None):
    """(B, T, dy) float64 emissions from numpy draws."""
    rng = np.random.default_rng(seed)
    dx = params.initial_mean.shape[-1]
    dq = params.dynamics_noise_bias.shape[-1]
    dr = params.emission_noise_bias.shape[-1]
    draws = SampleDraws(*(torch.as_tensor(rng.standard_normal(s)) for s in
                          [(B, dx), (B, T, dq), (B, T, dr)]))
    _, emissions = model.sample(params, T, inputs=inputs, draws=draws,
                                batch_shape=(B,))
    return emissions.numpy()


def jax_params(params, dtype):
    return params._replace(**{k: jnp.asarray(getattr(params, k), dtype)
                              for k in ARRAY_FIELDS})


@contextlib.contextmanager
def jax_precision(dtype):
    """float32 runs build and run the JAX model with x64 off, so its model
    constants are float32 too; float64 runs keep the module's x64 mode."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def run_both(jmodel_fn, tmodel_fn, emissions, dtype, inputs=None, **kw):
    """The JAX EKF vmapped over sequences and the port's batched EKF."""
    with jax_precision(dtype):
        _, jp, _ = jmodel_fn()
        jp = jax_params(jp, dtype)
        j_in = None if inputs is None else jnp.asarray(inputs)
        want = jax_fast(jax.vmap(
            lambda e: jgf.extended_kalman_filter(jp, e, inputs=j_in, **kw)),
            jnp.asarray(emissions, dtype))
        want = jax.tree_util.tree_map(np.asarray, want)
    _, tp, _ = tmodel_fn(dtype=getattr(torch, dtype), device="cpu")
    t_in = None if inputs is None else torch.as_tensor(inputs)
    got = inf.extended_kalman_filter(
        tp, torch.as_tensor(emissions.astype(dtype)), inputs=t_in, **kw)
    return got, want


def check(got, want, dtype):
    for name in ("filtered_means", "filtered_covariances", "predicted_means",
                 "predicted_covariances", "marginal_loglik"):
        assert_close(getattr(got, name), getattr(want, name), dtype)


@pytest.fixture(scope="module")
def lorenz96_case(x64):
    model, params, _ = zoo.lorenz96(8, 4, integrator="rk4",
                                    dtype=torch.float64, device="cpu")
    return sample_emissions(model, params, 30, 3, 0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("num_iter", [1, 2])
def test_lorenz96_batched(lorenz96_case, dtype, num_iter):
    got, want = run_both(lambda: jzoo.lorenz96(8, 4),
                         lambda **k: zoo.lorenz96(8, 4, **k), lorenz96_case,
                         dtype, num_iter=num_iter)
    check(got, want, dtype)


def test_bearings_only_tracking_with_inputs(x64):
    """Maneuver inputs exercise the u_{t+1} predict alignment and the
    wrapped bearing residual."""
    T = 24
    inputs = zoo.bot_maneuver_inputs(T, device="cpu")
    model, params, _ = zoo.bearings_only_tracking(dtype=torch.float64,
                                                 device="cpu")
    emissions = sample_emissions(model, params, T, 2, 1, inputs)
    got, want = run_both(jzoo.bearings_only_tracking,
                         zoo.bearings_only_tracking, emissions, "float64",
                         inputs=inputs.numpy())
    check(got, want, "float64")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_linear_gaussian(x64, dtype):
    model, params, _ = zoo.linear_gaussian(3, 2, dtype=torch.float64,
                                          device="cpu")
    emissions = sample_emissions(model, params, 20, 2, 2)
    got, want = run_both(lambda: jzoo.linear_gaussian(3, 2),
                         lambda **k: zoo.linear_gaussian(3, 2, **k),
                         emissions, dtype, jitter=1e-6)
    check(got, want, dtype)


def test_single_sequence_matches_batch_row(lorenz96_case):
    """(T, dy) emissions give the (B, T, dy) run's row, without a batch
    axis."""
    emissions = lorenz96_case
    _, tp, _ = zoo.lorenz96(8, 4, dtype=torch.float64, device="cpu")
    batch = inf.extended_kalman_filter(tp, torch.as_tensor(emissions))
    one = inf.extended_kalman_filter(tp, torch.as_tensor(emissions[1]))
    assert one.filtered_means.shape == (30, 8)
    torch.testing.assert_close(one.filtered_means, batch.filtered_means[1])
    torch.testing.assert_close(one.marginal_loglik, batch.marginal_loglik[1])


def test_unported_options_raise(lorenz96_case):
    """``compat_scalar``, which the port once raised NotImplementedError
    for, runs the reference-exact update over the batch and matches the
    JAX package's on each sequence (float64)."""
    _, tp, _ = zoo.lorenz96(8, 4, dtype=torch.float64, device="cpu")
    jp = jzoo.lorenz96(8, 4)[1]
    e = torch.as_tensor(lorenz96_case)
    got = inf.extended_kalman_filter(tp, e, compat_scalar=True)
    want = jax_fast(jax.vmap(lambda y: jgf.extended_kalman_filter(
        jp, y, compat_scalar=True)), jnp.asarray(lorenz96_case))
    for g, w in zip(got, want):
        assert_close(g.numpy(), w, "float64")
