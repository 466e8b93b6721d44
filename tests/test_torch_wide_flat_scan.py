"""The port's temporally parallel Kalman filter and smoother above dx = 8,
on the flat log-depth schedule (``chunk=None``), against the JAX package
on the CPU: dx = 12, dy = 6, T = 256, where the card runs the block
variants of K10–K12. (The chunked schedule at the same widths is in
``tests/test_torch_wide_bands.py``; the two files split the JAX
references' compile time, so that each runs in under a minute.)

On the CPU the port runs its kernels' plain versions and the JAX package
its XLA combines; the block kernels are held to the plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3). The model
is the parallel Kalman benchmark's, made with numpy from a seed, and the
very same arrays go to both sides.

Tolerances, relative to max(1, max|reference|): float64 1e-8 and float32
5e-3, the bounds ``chip_smoke.py`` holds the card to the CPU with (JAX
float32 runs with x64 off, so that its float64 bias defaults do not
promote the run). The JAX smoother is jitted and compiled at XLA's lowest
backend optimisation level: the flat scan traces the Woodbury combine
once per level, each with its blocked factorisations unrolled.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianfiltering_tpu.ops import associative as jas
from bayesianfiltering_tpu.ops import linear as jlin
from bayesianfiltering_tpu_torch import testing
from bayesianfiltering_tpu_torch.models import params_from_jax
from bayesianfiltering_tpu_torch.ops import associative as tas
from bayesianfiltering_tpu_torch.ops import linear as tlin

torch.set_num_threads(1)

TOL = {"float64": 1e-8, "float32": 5e-3}
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
FIELDS = ("marginal_loglik", "filtered_means", "filtered_covariances",
          "predicted_means", "predicted_covariances")


@contextlib.contextmanager
def jax_in(dtype):
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def assert_close(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


@pytest.mark.parametrize("solver,dtype", [("woodbury", "float64"),
                                          ("native", "float64"),
                                          ("native", "float32")])
def test_flat_parallel_filter_and_smoother_above_the_lane_band(solver,
                                                               dtype):
    """The JAX package's jitted smoother (whose forward pass is its
    ``parallel_kalman_filter``) against the port's
    ``parallel_kalman_filter`` and ``parallel_kalman_smoother``."""
    rng = np.random.default_rng(12)
    fields = testing.lgssm_fields(rng, 12, 6)
    ys = rng.standard_normal((256, 6)).astype(dtype)
    with jax_in(dtype):
        jp = jlin.ParamsLGSSM(**{k: jnp.asarray(v, dtype)
                                 for k, v in fields.items()})
        run = jax.jit(lambda p, y: jas.parallel_kalman_smoother(
            p, y, solver=solver, chunk=None))
        want = run.lower(jp, jnp.asarray(ys)).compile(FAST_COMPILE)(
            jp, jnp.asarray(ys))
    template = tlin.ParamsLGSSM(**{k: torch.zeros(v.shape)
                                   for k, v in fields.items()})
    tp = params_from_jax(jp, template, dtype=getattr(torch, dtype),
                         device="cpu")
    y = torch.as_tensor(ys)
    filtered = tas.parallel_kalman_filter(tp, y, solver=solver, chunk=None)
    smoothed = tas.parallel_kalman_smoother(tp, y, solver=solver, chunk=None)
    for name in FIELDS:
        assert_close(getattr(filtered, name), getattr(want, name), dtype)
    for name in FIELDS + ("smoothed_means", "smoothed_covariances"):
        assert_close(getattr(smoothed, name), getattr(want, name), dtype)
