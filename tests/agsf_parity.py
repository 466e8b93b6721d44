"""JAX-side helpers of the AGSF parity tests: the JAX engine's draws, a
jitted JAX filter compiled at XLA's lowest backend optimisation level, the
problems sampled by JAX and one case run on both sides. Imported by
``tests/test_torch_agsf_*.py`` (not a test file itself); callers turn
64-bit JAX types on."""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import torch

import bayesianfiltering_tpu.inference as jgf
from bayesianfiltering_tpu.models import zoo as jzoo
from bayesianfiltering_tpu_torch import inference as inf
from bayesianfiltering_tpu_torch.models import zoo
from bayesianfiltering_tpu_torch.utils import resampling as rs

FILTER_TOL = 1e-8
T = 8
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
POSTERIOR = ("means", "covariances", "weights", "marginal_loglik")


def t(x):
    return torch.as_tensor(np.array(x))


def assert_close(got, want, tol=FILTER_TOL):
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def jax_agsf_draws(rng_key, T, M, N, L, dx, reduction, fixed=False):
    """The normals and uniforms of the JAX engine's key schedule
    (``_agsf_engine``: the init key and a key folded per step; with
    ``compat_fixed_keys`` PRNGKey(0) for the init and the reduction and
    ``rng_key`` reused at every step, so one step's draws)."""
    if fixed:
        init_key, scan_key = jr.PRNGKey(0), rng_key
    else:
        init_key, scan_key = jr.split(rng_key)
    split1, split2, reduce = [], [], []
    for step in range(1 if fixed else T):
        key_t = scan_key if fixed else jr.fold_in(scan_key, step)
        k1, k2, kr = jr.split(key_t, 3)
        if fixed:
            kr = jr.PRNGKey(0)
        split1.append(jr.normal(k1, (M, N, dx), jnp.float64))
        split2.append(jr.normal(k2, (M * N, L, dx), jnp.float64))
        if reduction in rs.UNIFORM_SHAPES:
            reduce.append(jr.uniform(
                kr, rs.UNIFORM_SHAPES[reduction](M, M * N * L), jnp.float64))
    return inf.AGSFDraws(t(jr.normal(init_key, (M, dx), jnp.float64)),
                         t(jnp.stack(split1)), t(jnp.stack(split2)),
                         t(jnp.stack(reduce)) if reduce else None)


def jax_filter(fn, emissions, **kw):
    run = jax.jit(lambda e: fn(e, **kw))
    e = jnp.asarray(emissions)
    return jax.device_get(run.lower(e).compile(FAST_COMPILE)(e))


def problem(name):
    """(JAX params, port params, inputs or None, emissions) at T steps,
    sampled by JAX."""
    jmodel, jparams, _ = getattr(jzoo, name)()
    tparams = getattr(zoo, name)(dtype=torch.float64, device="cpu")[1]
    inputs = None
    if name == "stochastic_volatility":
        inputs = jnp.array([0] * (T // 2) + [1] * (T - T // 2))
    elif name == "bearings_only_tracking":
        inputs = jzoo.bot_maneuver_inputs(T)
    _, ys = jmodel.sample(jparams, jr.PRNGKey(0), T, inputs=inputs)
    return jparams, tparams, inputs, np.asarray(ys)


FILTERS = {
    "augmented": (jgf.augmented_gaussian_sum_filter,
                  inf.augmented_gaussian_sum_filter),
    "optimal": (jgf.augmented_gaussian_sum_filter_optimal,
                inf.augmented_gaussian_sum_filter_optimal),
    "unscented": (jgf.unscented_agsf, inf.unscented_agsf),
}


def run_case(model, kind, comps, kw, seed):
    """One filter of ``FILTERS`` (the UKF's with ParamsUKF(1, 0, 0)) on
    ``problem(model)``: (JAX's (posterior, aux), the port's with JAX's
    draws)."""
    jparams, tparams, inputs, ys = problem(model)
    jfn, tfn = FILTERS[kind]
    M, N, L = comps
    reduction = ("optimal" if kind == "optimal"
                 else kw.get("reduction", "multinomial"))
    ukf = ((jgf.ParamsUKF(1.0, 0.0, 0.0),), (inf.ParamsUKF(1.0, 0.0, 0.0),)) \
        if kind == "unscented" else ((), ())
    want = jax_filter(
        lambda e, **k: jfn(jparams, *ukf[0], e, list(comps),
                           jr.PRNGKey(seed), 1, inputs=inputs, **k), ys, **kw)
    draws = jax_agsf_draws(jr.PRNGKey(seed), T, M, N, L,
                           jparams.initial_mean.shape[-1], reduction,
                           fixed=kw.get("compat_fixed_keys", False))
    got = tfn(tparams, *ukf[1], t(ys), list(comps), num_iter=1,
              inputs=None if inputs is None else t(inputs), draws=draws,
              **kw)
    return want, got
