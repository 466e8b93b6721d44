"""The port's bootstrap particle filter and its parents kernel's plain
version (K5) against the JAX package, on the CPU.

K5: the parents are integers, so the port's plain version must equal the
JAX scatter formulation and the JAX Pallas kernel (interpret mode) index
for index, at every weight profile of ``testing.PARENT_PROFILES``.

BPF: JAX's threefry streams cannot be reproduced in torch, so the tests
rebuild the JAX key schedule (``inference.bootstrap_particle_filter``:
one split for the initial particles, then three keys per step) and hand
the very normals and uniforms JAX draws to the port as ``BPFDraws``.
float64 at 1e-10 relative to max(1, max|reference|): the same formulas on
the same draws, rounding only (the resampling's ceil and the ESS trigger
are discontinuous, but no value lands within float64 rounding of a jump).
float32 is held to tracking, not to trajectories: there rounding may pick
another parent and the paths part.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import bayesianfiltering_tpu.inference as jgf
from bayesianfiltering_tpu.models import zoo as jzoo
from bayesianfiltering_tpu.ops import resample_gather as jrg
from bayesianfiltering_tpu.utils import resampling as jrs
from bayesianfiltering_tpu_torch import _build, testing
from bayesianfiltering_tpu_torch import inference as inf
from bayesianfiltering_tpu_torch.models import params_from_jax, zoo
from bayesianfiltering_tpu_torch.ops import linear
from bayesianfiltering_tpu_torch.ops import resample_gather as rg
from bayesianfiltering_tpu_torch.utils import resampling as rs

pl = pytest.importorskip("jax.experimental.pallas")
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-10
PROFILES = testing.PARENT_PROFILES


def port_parents(counts, n):
    return rg.windowed_parents(torch.as_tensor(counts), n).numpy()


class TestParents:
    """K5's plain version: parent(j) = #{i : counts_i ≤ j}, clamped."""

    @pytest.mark.parametrize("profile", PROFILES)
    @pytest.mark.parametrize("n", [4096, 5000, 8192])
    def test_plain_equals_jax_scatter(self, profile, n):
        counts = testing.resampling_counts(profile, n,
                                           np.random.default_rng(n))
        want = np.asarray(jrs._scatter_counts_to_parents(
            jnp.asarray(counts, jnp.float32), n))
        got = port_parents(counts, n)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("profile", PROFILES)
    @pytest.mark.parametrize("n", [4096, 5000])
    def test_plain_equals_jax_pallas_kernel(self, profile, n):
        """The JAX entry point in interpret mode: its kernel where the
        window covers the tile's parents, its scatter fallback where not
        ("spread")."""
        counts = testing.resampling_counts(profile, n,
                                           np.random.default_rng(n + 1))
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jrg.windowed_parents(
                jnp.asarray(counts, jnp.float32), n))
        np.testing.assert_array_equal(port_parents(counts, n), want)

    def test_tail_slot_is_clamped(self):
        n = 4096
        counts = testing.resampling_counts("tail", n,
                                           np.random.default_rng(9))
        assert counts[-1] == n - 1
        assert port_parents(counts, n)[-1] == n - 1

    def test_integer_counts_take_the_same_path(self):
        """stratified_counts gives integer counts, systematic float ones:
        both are clipped and converted to int32 first."""
        n = 5000
        counts = testing.resampling_counts("dirichlet", n,
                                           np.random.default_rng(2))
        np.testing.assert_array_equal(
            rg.windowed_parents(torch.as_tensor(counts).long(), n).numpy(),
            port_parents(counts, n))

    def test_cpu_dispatch_keeps_the_scatter_above_the_gate(self):
        """On CPU tensors the counts→parents inversion runs the scatter and
        never launches, at the JAX package's 2¹⁶ gate too (on CUDA tensors
        K5 runs at every size); the parents are int64 like every
        resampler's indices."""
        n = 1 << 16
        counts = testing.resampling_counts("dirichlet", n,
                                           np.random.default_rng(3))
        _build.reset_launch_counts()
        got = rs._counts_to_parents(torch.as_tensor(counts), n)
        assert rg.K5.launches == 0
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(
            got.numpy(), rs._scatter_counts_to_parents(
                torch.as_tensor(counts), n).numpy())

    @pytest.mark.parametrize("m,n", [(200, 50), (24, 6), (300, 300)])
    def test_count_formula_equals_the_scatter_for_a_reduction(self, m, n):
        """K5's formula, ``min(#{i : counts_i ≤ j}, m − 1)`` over m counts
        and n slots, against the plain version (the scatter) where a
        Gaussian-sum reduction keeps n of m components."""
        rng = np.random.default_rng(m + n)
        w = torch.as_tensor(rng.dirichlet(np.full(m, 0.5)))
        counts = rs.systematic_counts(w, n, u=torch.tensor(0.37))
        c = np.clip(counts.numpy(), 0, n).astype(np.int32)
        formula = np.minimum(np.searchsorted(c, np.arange(n), side="right"),
                             m - 1)
        np.testing.assert_array_equal(rg.windowed_parents(counts, n).numpy(),
                                      formula)

    @pytest.mark.parametrize("resampler", ["systematic", "stratified",
                                           "multinomial"])
    def test_counts_fns_match_jax(self, x64, resampler):
        """``get_counts_fn``: the cumulative-count core of a counts-based
        resampler equals JAX's on the same uniforms; multinomial has none."""
        jfn, fn = jrs.get_counts_fn(resampler), rs.get_counts_fn(resampler)
        if resampler == "multinomial":
            assert jfn is None and fn is None
            return
        n = 2500
        w = np.random.default_rng(5).dirichlet(np.full(n, 0.4))
        key = jr.PRNGKey(11)
        u = jr.uniform(key, rs.UNIFORM_SHAPES[resampler](n),
                       dtype=jnp.float64)
        got = fn(torch.as_tensor(w), n, u=torch.as_tensor(np.asarray(u)))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jfn(key, jnp.asarray(w), n)))

    @pytest.mark.parametrize("resampler", ["systematic", "stratified"])
    def test_resamplers_match_jax(self, x64, resampler):
        n = 3000
        w = np.random.default_rng(4).dirichlet(np.full(n, 0.3))
        key = jr.PRNGKey(7)
        want = jrs.get_resampler(resampler)(key, jnp.asarray(w), n)
        u = jr.uniform(key, rs.UNIFORM_SHAPES[resampler](n),
                       dtype=jnp.float64)
        got = rs.get_resampler(resampler)(torch.as_tensor(w), n,
                                          u=torch.as_tensor(np.asarray(u)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The bootstrap particle filter against JAX, with JAX's draws
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def jax_bpf_draws(key, T, P, dx, dq, resampler):
    """The normals and uniforms of ``bootstrap_particle_filter``'s key
    schedule: ``key, key_init = split(key)``, then per step
    ``key, key_prop, key_res = split(key, 3)``."""
    key, key_init = jr.split(key)
    init = jr.normal(key_init, (P, dx), dtype=jnp.float64)
    dyn, res = [], []
    shape = rs.UNIFORM_SHAPES[resampler](P)
    for _ in range(T):
        key, key_prop, key_res = jr.split(key, 3)
        dyn.append(jr.normal(key_prop, (P, dq), dtype=jnp.float64))
        res.append(jr.uniform(key_res, shape, dtype=jnp.float64))
    return inf.BPFDraws(*(torch.as_tensor(np.asarray(a))
                          for a in (init, jnp.stack(dyn), jnp.stack(res))))


@pytest.fixture(scope="module")
def l96(x64):
    """Lorenz-96 dx=4, dy=2: data from the RK4 model, filter on Euler."""
    _, _, jbpf = jzoo.lorenz96(4, 2)
    dm, dp, _ = jzoo.lorenz96(4, 2, integrator="rk4")
    _, em = dm.sample(dp, jr.PRNGKey(3), 12)
    template = zoo.lorenz96(4, 2, dtype=torch.float64, device="cpu")[2]
    tbpf = params_from_jax(jbpf, template, dtype=torch.float64, device="cpu")
    return jbpf, tbpf, np.asarray(em)


def assert_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


BPF_CASES = [
    (512, 0.5, "systematic", "summary"),
    (2048, 2.0, "systematic", "summary"),
    (512, 2.0, "stratified", "summary"),
    (2048, 0.5, "stratified", "summary"),
    (512, 0.5, "multinomial", "summary"),
    (2048, 2.0, "multinomial", "summary"),
    (512, 2.0, "systematic", "all"),
    (512, 0.5, "multinomial", "all"),
]


@pytest.mark.parametrize("P,threshold,resampler,store", BPF_CASES)
def test_bpf_matches_jax_float64(l96, P, threshold, resampler, store):
    jbpf, tbpf, em = l96
    key = jr.PRNGKey(P + int(threshold))
    want = jgf.bootstrap_particle_filter(
        jbpf, jnp.asarray(em), P, key, ess_threshold=threshold,
        resampler=resampler, store=store)
    draws = jax_bpf_draws(key, len(em), P, 4, 4, resampler)
    got = inf.bootstrap_particle_filter(
        tbpf, torch.as_tensor(em), P, ess_threshold=threshold,
        resampler=resampler, store=store, draws=draws)
    assert set(got) == set(want)
    for name in want:
        assert_close(got[name], want[name])
    if store == "summary" and threshold < 1:
        # the trigger both fired and held back over the run
        ess = np.asarray(want["ess"])
        assert (ess < threshold * P).any() and (ess >= threshold * P).any()


def test_bpf_float32_tracks_the_kalman_filter():
    """float32, drawn from a generator: the BPF mean tracks the exact
    Kalman filter on a linear-Gaussian model (the JAX package's bound)."""
    model, params, bpf = zoo.linear_gaussian(2, 2, r=0.5, device="cpu")
    gen = torch.Generator().manual_seed(1)
    _, emissions = model.sample(params, 40, generator=gen)
    out = inf.bootstrap_particle_filter(bpf, emissions, 4000, gen,
                                        store="summary")
    assert out["means"].shape == (40, 2) and out["ess"].shape == (40,)
    assert torch.isfinite(out["means"]).all()
    assert bool((out["ess"] >= 1.0 - 1e-3).all())
    kf = linear.kalman_filter(zoo.linear_gaussian_lgssm(2, 2, r=0.5,
                                                        device="cpu"),
                              emissions)
    err = float((out["means"] - kf.filtered_means).abs().max())
    assert err < 0.35, err


def test_bpf_store_all_shapes_and_weights():
    model, params, bpf = zoo.linear_gaussian(3, 2, device="cpu")
    gen = torch.Generator().manual_seed(2)
    _, emissions = model.sample(params, 7, generator=gen)
    out = inf.bootstrap_particle_filter(bpf, emissions, 300, gen,
                                        resampler="stratified")
    assert out["particles"].shape == (300, 7, 3)
    assert out["weights"].shape == (300, 7)
    torch.testing.assert_close(out["weights"].sum(0),
                               torch.ones(7, dtype=out["weights"].dtype))


def test_bpf_draws_shapes():
    gen = torch.Generator().manual_seed(0)
    like = torch.zeros(1, dtype=torch.float64)
    d = inf.bpf_draws(gen, 5, 64, 4, 2, "stratified", like)
    assert (d.init.shape, d.dynamics.shape, d.resample.shape) == (
        (64, 4), (5, 64, 2), (5, 64))
    assert inf.bpf_draws(gen, 5, 64, 4, 2, "systematic",
                         like).resample.shape == (5,)


def test_bpf_refuses_unknown_resampler_and_missing_randomness():
    _, _, bpf = zoo.linear_gaussian(2, 2, device="cpu")
    em = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="unknown resampler"):
        inf.bootstrap_particle_filter(bpf, em, 16, torch.Generator(),
                                      resampler="residual")
    with pytest.raises(ValueError, match="Generator"):
        inf.bootstrap_particle_filter(bpf, em, 16)


def test_params_from_jax_carries_a_bpf_model(x64):
    _, _, jbpf = jzoo.lorenz96(4, 2)
    template = zoo.lorenz96(4, 2, dtype=torch.float64, device="cpu")[2]
    got = params_from_jax(jbpf, template, dtype=torch.float64, device="cpu")
    assert got.emission_distribution_log_prob is \
        template.emission_distribution_log_prob
    for name in ("initial_mean", "initial_covariance",
                 "dynamics_noise_covariance", "emission_noise_covariance"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(jbpf, name)))
    wrong = zoo.lorenz96(6, 2, dtype=torch.float64, device="cpu")[2]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(jbpf, wrong, dtype=torch.float64, device="cpu")
