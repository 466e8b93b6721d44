"""The port's steady-state Kalman filter and smoother against the JAX
package's ``ops/steady_state.py``, on the CPU.

The model is ``tests/test_steady_state.py``'s well-damped random model
with biases (dx = 4, dy = 2), its arrays carried across; the emissions
are made with numpy from a seed. Tolerances relative to max(1,
max|reference|): float64 1e-10, float32 1e-4 (the JAX float32 reference
runs with 64-bit types off). The JAX functions are jitted whole and
compiled at XLA's lowest backend optimisation level.
"""
import contextlib

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from bayesianfiltering_tpu.ops import linear as jlin
from bayesianfiltering_tpu.ops import steady_state as jss
from bayesianfiltering_tpu_torch.ops import linear as tlin
from bayesianfiltering_tpu_torch.ops import steady_state as tss

torch.set_num_threads(1)

TOL = {"float64": 1e-10, "float32": 1e-4}
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
T = 300
HEAD = 64


@contextlib.contextmanager
def jax_in(dtype):
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def model_arrays():
    """``tests/test_steady_state.py::_params()``'s arrays, float64."""
    with jax_in("float64"):
        key = jr.PRNGKey(0)
        dx, dy = 4, 2
        F = 0.7 * jnp.eye(dx) + 0.05 * jr.normal(key, (dx, dx))
        H = jr.normal(jr.fold_in(key, 1), (dy, dx)) / dx
        return [np.asarray(a) for a in (
            jnp.ones(dx), 2.0 * jnp.eye(dx), F, 0.3 * jnp.eye(dx), H,
            0.2 * jnp.eye(dy), 0.1 * jnp.ones(dx), -0.2 * jnp.ones(dy))]


def jax_run(fn, dtype, ys, **static):
    """``fn(params, ys, **static)`` of the JAX package, jitted."""
    with jax_in(dtype):
        args = (jparams(dtype), jnp.asarray(ys, dtype))
        run = jax.jit(lambda p, y: fn(p, y, **static))
        return run.lower(*args).compile(FAST_COMPILE)(*args)


ARRAYS = model_arrays()
YS = np.random.default_rng(3).standard_normal((T, 2))


def jparams(dtype):
    return jlin.ParamsLGSSM(*(jnp.asarray(a, dtype) for a in ARRAYS))


def tparams(dtype):
    return tlin.ParamsLGSSM(*(torch.tensor(a, dtype=getattr(torch, dtype))
                              for a in ARRAYS))


def assert_close(got, want, dtype):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


def assert_posterior(got, want, dtype):
    for name in jlin.PosteriorKalman._fields:
        w = getattr(want, name)
        if w is None:
            assert getattr(got, name) is None, name
            continue
        assert_close(getattr(got, name), w, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("num_iters", [128, 20])
def test_gains_match(dtype, num_iters):
    with jax_in(dtype):
        p = jparams(dtype)
        run = jax.jit(lambda p: jss.steady_state_gains(p, num_iters))
        want = run.lower(p).compile(FAST_COMPILE)(p)
    got = tss.steady_state_gains(tparams(dtype), num_iters=num_iters)
    for name in tss.SteadyStateGains._fields:
        assert_close(getattr(got, name), getattr(want, name), dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["filter", "smoother"])
def test_long_sequence_matches(dtype, kind):
    """T = 300 past a head of 64: the exact head, the frozen-gain tail by
    the constant-matrix scan and, for the smoother, the exact backward
    pass over the head and the end's covariance transient."""
    fn = f"steady_state_kalman_{kind}"
    want = jax_run(getattr(jss, fn), dtype, YS)
    got = getattr(tss, fn)(tparams(dtype),
                           torch.tensor(YS, dtype=getattr(torch, dtype)))
    assert_posterior(got, want, dtype)


@pytest.mark.parametrize("kind,T_short,head,exact", [
    ("filter", 40, HEAD, "kalman_filter"),       # T ≤ head
    ("filter", HEAD, HEAD, "kalman_filter"),     # T = head
    ("smoother", 100, HEAD, "kalman_smoother"),  # T ≤ 2·head
    ("smoother", 2 * HEAD, HEAD, "kalman_smoother"),
])
def test_short_sequences_fall_through_to_the_exact_pass(kind, T_short, head,
                                                        exact):
    ys = YS[:T_short]
    want = jax_run(getattr(jss, f"steady_state_kalman_{kind}"), "float64",
                   ys, head=head)
    got = getattr(tss, f"steady_state_kalman_{kind}")(
        tparams("float64"), torch.tensor(ys), head=head)
    assert_posterior(got, want, "float64")
    exact_got = getattr(tlin, exact)(tparams("float64"), torch.tensor(ys))
    for name, x in exact_got._asdict().items():
        if x is None:
            assert getattr(got, name) is None, name
        else:
            assert torch.equal(getattr(got, name), x), name


@pytest.mark.parametrize("T_edge,head", [(2 * HEAD + 1, HEAD), (150, 70),
                                         (300, 8)])
def test_smoother_at_the_head_and_end_edges(T_edge, head):
    """T = 2·head + 1 leaves no steady interior (n_mid = 0); the others
    put the end transient at min(head, T − head − 1) steps."""
    ys = YS[:T_edge]
    want = jax_run(jss.steady_state_kalman_smoother, "float64", ys,
                   head=head)
    got = tss.steady_state_kalman_smoother(tparams("float64"),
                                           torch.tensor(ys), head=head)
    assert_posterior(got, want, "float64")


@pytest.mark.parametrize("n", [1, 2, 37, 64])
def test_affine_scan_constant_matches(n):
    rng = np.random.default_rng(n)
    A = 0.3 * rng.standard_normal((4, 4))
    u = rng.standard_normal((n, 4))
    with jax_in("float64"):
        want = jss._affine_scan_constant(jnp.asarray(A), jnp.asarray(u))
    got = tss._affine_scan_constant(torch.tensor(A), torch.tensor(u))
    assert_close(got, want, "float64")


def test_bad_head_raises():
    with pytest.raises(ValueError):
        tss.steady_state_kalman_filter(tparams("float64"),
                                       torch.tensor(YS), head=0)
    with pytest.raises(ValueError):
        tss.steady_state_kalman_smoother(tparams("float64"),
                                         torch.tensor(YS), head=-1)


def test_converged_tail_is_close_to_the_exact_smoother():
    """Past the head the frozen gain differs from the exact one by the
    Riccati residual only: on this well-damped model the smoothed means
    agree with the exact smoother's to ~1e-8."""
    p = tparams("float64")
    got = tss.steady_state_kalman_smoother(p, torch.tensor(YS))
    exact = tlin.kalman_smoother(p, torch.tensor(YS))
    assert float(tss.steady_state_gains(p).rel_delta) < 1e-12
    torch.testing.assert_close(got.smoothed_means, exact.smoothed_means,
                               rtol=0, atol=1e-8)
    torch.testing.assert_close(got.smoothed_covariances,
                               exact.smoothed_covariances, rtol=0, atol=1e-8)
