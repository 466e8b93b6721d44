"""The port's Gaussian-sum filter and AGSF against the JAX package's on
bearings-only tracking, on the CPU, with the JAX draws handed over.

JAX's threefry streams cannot be reproduced in torch, so the tests rebuild
the JAX engine's key schedule (as tests/test_golden_parity.py does) and give
the port the very normals and uniforms JAX draws. float64 throughout;
tolerance 1e-9 relative to max(1, max|reference|): identical formulas and
draws, different factorization routines. (BOT's bearing noise R = 2.5e-5
makes the weights sensitive, which float64 absorbs.)
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import bayesianfiltering_tpu.inference as jgf
from bayesianfiltering_tpu import containers as jcont
from bayesianfiltering_tpu.models import zoo as jzoo
from bayesianfiltering_tpu.utils import resampling as jrs
from bayesianfiltering_tpu_torch import containers
from bayesianfiltering_tpu_torch import inference as inf
from bayesianfiltering_tpu_torch.models import zoo
from bayesianfiltering_tpu_torch.utils import resampling as rs

torch.set_num_threads(1)

TOL = 1e-9
T_BOT = 12


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def assert_close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


@pytest.fixture(scope="module")
def bot(x64):
    """The graft entry's problem: BOT with maneuver inputs, sampled by JAX."""
    jmodel, jparams, _ = jzoo.bearings_only_tracking()
    inputs = jzoo.bot_maneuver_inputs(T_BOT)
    states, emissions = jmodel.sample(jparams, jr.PRNGKey(0), T_BOT,
                                      inputs=inputs)
    _, tparams, _ = zoo.bearings_only_tracking(dtype=torch.float64,
                                          device="cpu")
    return dict(jparams=jparams, tparams=tparams, inputs=np.asarray(inputs),
                states=np.asarray(states), emissions=np.asarray(emissions))


def t(x):
    return torch.as_tensor(np.array(x))


def test_gsf_with_injected_initial_means(bot):
    M, key = 4, jr.PRNGKey(3)
    want = jgf.gaussian_sum_filter(bot["jparams"], jnp.asarray(bot["emissions"]),
                                   M, inputs=jnp.asarray(bot["inputs"]),
                                   key=key)
    # JAX's _init_mixture draws mvn_sample(key, m0, S0, (M,)): normals (M, dx)
    eps = jr.normal(key, (M, 4), jnp.float64)
    got = inf.gaussian_sum_filter(bot["tparams"], t(bot["emissions"]), M,
                                  inputs=t(bot["inputs"]), init_eps=t(eps))
    for name in ("means", "covariances", "weights", "predicted_means",
                 "marginal_loglik"):
        assert_close(getattr(got, name), getattr(want, name))


def jax_agsf_draws(rng_key, T, M, N, L, dx, reduction):
    """The normals and uniforms JAX's _agsf_engine draws
    (inference.py:712-749, containers.py:121, resampling.py:87-121)."""
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


@pytest.mark.parametrize("reduction,T", [("topk", T_BOT), ("systematic", 1)])
def test_agsf_flagship_with_injected_draws(bot, reduction, T):
    """AGSF [8,2,2] on the graft entry's BOT problem; "systematic" for one
    step with its uniform injected."""
    rng_key = jr.PRNGKey(1)
    emissions, inputs = bot["emissions"][:T], bot["inputs"][:T]
    want_post, want_aux = jgf.augmented_gaussian_sum_filter(
        bot["jparams"], jnp.asarray(emissions), [8, 2, 2], rng_key, 1,
        (0.1, 0.1), jnp.asarray(inputs), reduction=reduction)
    draws = jax_agsf_draws(rng_key, T, 8, 2, 2, 4, reduction)
    got_post, got_aux = inf.augmented_gaussian_sum_filter(
        bot["tparams"], t(emissions), [8, 2, 2], num_iter=1,
        opt_args=(0.1, 0.1), inputs=t(inputs), reduction=reduction,
        draws=draws)
    for name in ("means", "covariances", "weights", "marginal_loglik"):
        assert_close(getattr(got_post, name), getattr(want_post, name))
    for name in ("updated_means", "pre_weights", "Deltas", "Lambdas", "gain",
                 "grads_dyn", "grads_obs"):
        assert_close(got_aux[name], want_aux[name])


@pytest.mark.parametrize("method", ["multinomial", "systematic", "stratified"])
@pytest.mark.parametrize("n", [5, 16])
def test_resamplers_pick_the_same_indices(method, n):
    """Each resampler, given JAX's uniforms, picks JAX's indices exactly."""
    key = jr.PRNGKey(n)
    w = jr.uniform(jr.PRNGKey(100 + n), (3 * n,), jnp.float64) ** 3
    w = w / jnp.sum(w)
    want = getattr(jrs, f"{method}_resample")(key, w, n)
    u = jr.uniform(key, rs.UNIFORM_SHAPES[method](n), jnp.float64)
    got = rs.get_resampler(method)(t(w), n, u=t(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_drops_a_start_equal_to_n():
    """A particle whose children start at slot n is dropped, as JAX's
    ``mode="drop"`` scatter does."""
    counts = jnp.asarray([0.0, 2.0, 2.0, 4.0, 4.0])
    want = jrs._scatter_counts_to_parents(counts, 4)
    got = rs._scatter_counts_to_parents(t(counts), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_split_collapses_non_psd_onto_the_mean():
    """P − Δ not PSD: the factor is zeroed, the children sit on the mean."""
    means = torch.tensor([[1.0, 2.0]], dtype=torch.float64)
    covs = torch.eye(2, dtype=torch.float64)[None]
    mix = containers.GaussianSum(means, covs, torch.ones(1, dtype=torch.float64))
    out = containers.split_gaussian_sum(mix, 2.0 * covs, 3,
                                        eps=torch.ones(1, 3, 2,
                                                       dtype=torch.float64))
    torch.testing.assert_close(out.means, means.expand(3, 2))
    jout = jcont.split_gaussian_sum(
        jr.PRNGKey(0), jcont.GaussianSum(jnp.asarray(means.numpy()),
                                         jnp.asarray(covs.numpy()),
                                         jnp.ones(1)), 2.0 * jnp.asarray(covs.numpy()), 3)
    np.testing.assert_allclose(out.means.numpy(), np.asarray(jout.means))


def test_unported_options_raise(bot):
    """The options the port once raised NotImplementedError for,
    ``autocov="sdp"`` and ``reduction="optimal"``, run on the graft
    entry's BOT problem and match the JAX package with its draws (AGSF
    [2,2,2], three steps)."""
    for option in (dict(autocov="sdp", reduction="topk"),
                   dict(reduction="optimal")):
        agsf_option_matches_jax(bot, option)


def agsf_option_matches_jax(bot, option):
    T, rng_key = 3, jr.PRNGKey(2)
    emissions, inputs = bot["emissions"][:T], bot["inputs"][:T]
    want_post, want_aux = jgf.augmented_gaussian_sum_filter(
        bot["jparams"], jnp.asarray(emissions), [2, 2, 2], rng_key, 1,
        (0.1, 0.1), jnp.asarray(inputs), **option)
    reduction = option["reduction"]
    init_key, scan_key = jr.split(rng_key)
    split1, split2, reduce = [], [], []
    for step in range(T):
        k1, k2, kr = jr.split(jr.fold_in(scan_key, step), 3)
        split1.append(jr.normal(k1, (2, 2, 4), jnp.float64))
        split2.append(jr.normal(k2, (4, 2, 4), jnp.float64))
        if reduction == "optimal":
            reduce.append(jr.uniform(kr, (8,), jnp.float64))
    draws = inf.AGSFDraws(t(jr.normal(init_key, (2, 4), jnp.float64)),
                          t(jnp.stack(split1)), t(jnp.stack(split2)),
                          t(jnp.stack(reduce)) if reduce else None)
    got_post, got_aux = inf.augmented_gaussian_sum_filter(
        bot["tparams"], t(emissions), [2, 2, 2], opt_args=(0.1, 0.1),
        inputs=t(inputs), draws=draws, **option)
    for name in ("means", "covariances", "weights", "marginal_loglik"):
        assert_close(getattr(got_post, name), getattr(want_post, name))
    for name in ("Deltas", "Lambdas", "pre_weights"):
        assert_close(got_aux[name], want_aux[name])
