"""The port at the widths its wide kernel bands open, against the JAX
package on the CPU.

- BASELINE config 5's Lorenz-96 (dx = 512, dy = 256, one sequence) through
  the EKF with the joint update (K1t at dy = 256 on the card), the EKF with
  the sequential chunked update (``update_chunk=128``: two K1t launches per
  step) and the additive UKF with Cholesky sigma points (K6, K8, K9 at
  n = 512).
- The temporally parallel Kalman filter and smoother above dx = 8 (dx = 12,
  dy = 6), where the card runs the block variants of K10–K12, on the
  chunked schedule (chunk 128) with both solvers; the flat schedule is in
  ``tests/test_torch_wide_flat_scan.py`` (the two files split the JAX
  references' compile time, so that each runs in under a minute).

On the CPU the port runs its kernels' plain versions and the JAX package
its XLA paths; the kernels themselves are held to those plain versions on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3). Inputs
are made with numpy from a seed and the very same arrays go to both sides.

Tolerances, relative to max(1, max|reference|): float64 1e-8, the bound
``chip_smoke.py`` holds the card to the CPU with (the same formulas,
factored and summed in another order, over T steps); float32 5e-3, its
float32 bound (JAX then runs with x64 off, so that its float64 bias
defaults do not promote the run).

The JAX references are jitted and compiled at XLA's lowest backend
optimisation level: their blocked factorisations unroll at these widths,
and the default level spends most of this file's time compiling them.
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
from bayesianfiltering_tpu.ops import linear as jlin
from bayesianfiltering_tpu.ops import ukf as juk
from bayesianfiltering_tpu_torch import _build, testing
from bayesianfiltering_tpu_torch import inference as inf
from bayesianfiltering_tpu_torch.models import SampleDraws, params_from_jax, zoo
from bayesianfiltering_tpu_torch.models.params import ARRAY_FIELDS
from bayesianfiltering_tpu_torch.ops import associative as tas
from bayesianfiltering_tpu_torch.ops import linear as tlin
from bayesianfiltering_tpu_torch.ops import ukf

torch.set_num_threads(1)

TOL = {"float64": 1e-8, "float32": 5e-3}
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
DX, DY, T5 = 512, 256, 3


@contextlib.contextmanager
def jax_in(dtype):
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def jax_run(fn, *args):
    """``fn(*args)`` jitted, compiled with ``FAST_COMPILE``, as numpy."""
    compiled = jax.jit(fn).lower(*args).compile(FAST_COMPILE)
    return jax.tree_util.tree_map(np.asarray, compiled(*args))


def assert_close(got, want, dtype):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


FILTERED = ("marginal_loglik", "filtered_means", "filtered_covariances",
            "predicted_means", "predicted_covariances")


def compare(got, want, dtype, names=FILTERED):
    for name in names:
        assert_close(getattr(got, name), getattr(want, name), dtype)


# ---------------------------------------------------------------------------
# BASELINE config 5: Lorenz-96 dx = 512, dy = 256
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def config5():
    """(JAX params, port params, (T, dy) emissions) in float64: data from
    the port's RK4 model driven by numpy draws, the Euler filter model on
    both sides."""
    rng = np.random.default_rng(5)
    data_model, data_params, _ = zoo.lorenz96(DX, DY, integrator="rk4",
                                              dtype=torch.float64,
                                              device="cpu")
    draws = SampleDraws(*(torch.as_tensor(rng.standard_normal(s)) for s in
                          [(DX,), (T5, DX), (T5, DY)]))
    _, emissions = data_model.sample(data_params, T5, draws=draws)
    _, tp, _ = zoo.lorenz96(DX, DY, dtype=torch.float64, device="cpu")
    with jax_in("float64"):
        _, jp, _ = jzoo.lorenz96(DX, DY)
        jp = jp._replace(**{k: jnp.asarray(getattr(jp, k), jnp.float64)
                            for k in ARRAY_FIELDS})
    return jp, tp, emissions.numpy()


@pytest.mark.parametrize("update_chunk", [None, 128])
def test_config5_ekf_matches_jax(config5, update_chunk):
    jp, tp, em = config5
    with jax_in("float64"):
        want = jax_run(lambda e: jgf.extended_kalman_filter(
            jp, e, update_chunk=update_chunk), jnp.asarray(em))
    _build.reset_launch_counts()
    got = inf.extended_kalman_filter(tp, torch.as_tensor(em),
                                     update_chunk=update_chunk)
    compare(got, want, "float64")
    assert all(k.launches == 0 for k in _build.KERNELS)


def test_config5_chunked_update_is_exact_for_diagonal_noise(config5):
    """Lorenz-96's R is diagonal, so the chunked update is the joint one."""
    _, tp, em = config5
    em = torch.as_tensor(em)
    compare(inf.extended_kalman_filter(tp, em, update_chunk=128),
            inf.extended_kalman_filter(tp, em), "float64")


def test_config5_additive_ukf_matches_jax(config5):
    jp, tp, em = config5
    with jax_in("float64"):
        want = jax_run(lambda e: jgf.unscented_kalman_filter(
            jp, juk.ParamsUKF(1.0, 0.0, 0.0, "cholesky"), e, additive=True),
            jnp.asarray(em))
    got = inf.unscented_kalman_filter(
        tp, ukf.ParamsUKF(1.0, 0.0, 0.0, "cholesky"), torch.as_tensor(em),
        additive=True)
    compare(got, want, "float64")


@pytest.mark.parametrize("update_chunk", [0, -128])
def test_update_chunk_argument_errors_match_jax(update_chunk):
    """A chunk below 1 raises ValueError on both sides (JAX's ``range``
    refuses 0; a negative chunk leaves no block to concatenate)."""
    rng = np.random.default_rng(0)
    em = rng.standard_normal((4, 4))
    with jax_in("float64"):
        _, jp, _ = jzoo.lorenz96(8, 4)
        with pytest.raises(ValueError):
            jgf.extended_kalman_filter(jp, jnp.asarray(em),
                                       update_chunk=update_chunk)
    _, tp, _ = zoo.lorenz96(8, 4, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="update_chunk"):
        inf.extended_kalman_filter(tp, torch.as_tensor(em),
                                   update_chunk=update_chunk)


def test_update_chunk_with_no_iterations_passes_the_prior_through():
    """``num_iter=0`` returns the prior before the chunk is read, on both
    sides, so even a chunk of 0 does not raise there."""
    rng = np.random.default_rng(1)
    em = rng.standard_normal((3, 4))
    with jax_in("float64"):
        _, jp, _ = jzoo.lorenz96(8, 4)
        want = jax_run(lambda e: jgf.extended_kalman_filter(
            jp, e, num_iter=0, update_chunk=0), jnp.asarray(em))
    _, tp, _ = zoo.lorenz96(8, 4, dtype=torch.float64, device="cpu")
    got = inf.extended_kalman_filter(tp, torch.as_tensor(em), num_iter=0,
                                     update_chunk=0)
    compare(got, want, "float64")


# ---------------------------------------------------------------------------
# The parallel filter and smoother above dx = 8
# ---------------------------------------------------------------------------


def lgssm(dx, dy, T, dtype, seed):
    """(JAX params, port params, emissions) of the parallel Kalman
    benchmark's model with N(0, 1) emissions. Call inside
    ``jax_in(dtype)``."""
    rng = np.random.default_rng(seed)
    fields = testing.lgssm_fields(rng, dx, dy)
    jp = jlin.ParamsLGSSM(**{k: jnp.asarray(v, dtype)
                             for k, v in fields.items()})
    template = tlin.ParamsLGSSM(**{k: torch.zeros(v.shape)
                                   for k, v in fields.items()})
    tp = params_from_jax(jp, template, dtype=getattr(torch, dtype),
                         device="cpu")
    return jp, tp, rng.standard_normal((T, dy)).astype(dtype)


@pytest.mark.parametrize("solver,dtype", [("woodbury", "float64"),
                                          ("native", "float64"),
                                          ("woodbury", "float32")])
def test_parallel_filter_and_smoother_above_the_lane_band(solver, dtype):
    """dx = 12, dy = 6, T = 256, chunk 128: the JAX package's jitted
    smoother (whose forward pass is its ``parallel_kalman_filter``) against
    the port's ``parallel_kalman_filter`` and ``parallel_kalman_smoother``.
    """
    chunk = 128
    with jax_in(dtype):
        jp, tp, ys = lgssm(12, 6, 256, dtype, seed=12)
        want = jax_run(lambda p, y: jas.parallel_kalman_smoother(
            p, y, solver=solver, chunk=chunk), jp, jnp.asarray(ys))
    ys = torch.as_tensor(ys)
    compare(tas.parallel_kalman_filter(tp, ys, solver=solver, chunk=chunk),
            want, dtype)
    compare(tas.parallel_kalman_smoother(tp, ys, solver=solver, chunk=chunk),
            want, dtype, FILTERED + ("smoothed_means",
                                     "smoothed_covariances"))
