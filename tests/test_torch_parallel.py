"""The port's data- and particle-parallel layer (``parallel/batch.py``,
``parallel/particle.py``) against the JAX package, on the CPU: the ranks
are spawned processes of a gloo group (``parallel.launch.run_ranks``), at
world sizes 1, 2 and 4; the JAX side runs on the conftest's 8-device CPU
mesh.

* ``batched_filter`` of the EKF against the single-sequence JAX EKF over
  the batch (float64 at 1e-10; the port's float32 to the float64
  reference at 1e-4), and of a one-sequence filter (the GSF) against the
  port's own calls one by one (the same calls: 1e-12);
* ``sharded_bootstrap_particle_filter`` against JAX's sharded filter on a
  mesh of as many devices as there are ranks, in both resampling modes:
  JAX's per-shard key schedule (``fold_in(key, shard)``, then ``split``
  into the initial and the scan keys, three keys a step; the gather
  mode's comb from ``fold_in(key, t)``) is rebuilt and its normals and
  uniforms handed to each rank as its ``BPFDraws``. float64 at 1e-10
  relative to max(1, max|reference|): the same formulas on the same draws,
  the normaliser summed in another order.

One spawn a world size computes every case; the checks read its results.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import bayesianfiltering_tpu.inference as jgf
from bayesianfiltering_tpu.models import zoo as jzoo
from bayesianfiltering_tpu.parallel import make_mesh as jmake_mesh
from bayesianfiltering_tpu.parallel import (
    sharded_bootstrap_particle_filter as jsharded_bpf,
)
from bayesianfiltering_tpu_torch.parallel import (
    Mesh,
    batched_filter,
    make_mesh,
    run_ranks,
    sharded_bootstrap_particle_filter,
)
from bayesianfiltering_tpu_torch.inference import extended_kalman_filter
from parallel_ranks import run_cases, spawn_worlds

torch.set_num_threads(1)

WORLDS = (1, 2, 4)
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
B, T_EKF = 8, 10
P, T_BPF = 512, 12
BPF_MODEL = ("linear_gaussian", {"state_dim": 2, "emission_dim": 2,
                                 "r": 0.5})
EKF_MODEL = ("linear_gaussian", {"state_dim": 2, "emission_dim": 2})
GSF_M = 3
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def assert_close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def jax_bpf_draws(key, n, mode):
    """Each shard's normals and uniforms of JAX's sharded BPF on an
    n-device mesh: (init (P/n, dx), dynamics (T, P/n, dq), resample (T,)),
    the local combs in "local" mode, the global comb in "gather" mode."""
    local_n = P // n
    comb = jnp.stack([jr.uniform(jr.fold_in(key, s), (), jnp.float64)
                      for s in range(T_BPF)])
    draws = []
    for shard in range(n):
        k_init, k = jr.split(jr.fold_in(key, shard))
        dyn, res = [], []
        for _ in range(T_BPF):
            k, k_prop, k_res = jr.split(k, 3)
            dyn.append(jr.normal(k_prop, (local_n, 2), jnp.float64))
            res.append(jr.uniform(k_res, (), jnp.float64))
        draws.append((t(jr.normal(k_init, (local_n, 2), jnp.float64)),
                      t(jnp.stack(dyn)),
                      t(comb if mode == "gather" else jnp.stack(res))))
    return draws


@pytest.fixture(scope="module")
def problem(x64):
    jmodel, jparams, jbpf = jzoo.linear_gaussian(2, 2, r=0.5)
    _, ys_bpf = jmodel.sample(jparams, jr.PRNGKey(1), T_BPF)
    emodel, eparams, _ = jzoo.linear_gaussian(2, 2)
    ys_batch = jnp.stack([emodel.sample(eparams, k, T_EKF)[1]
                          for k in jr.split(jr.PRNGKey(0), B)])
    ekf = jax.jit(jax.vmap(lambda e: jgf.extended_kalman_filter(eparams, e)))
    want_ekf = jax.device_get(
        ekf.lower(ys_batch).compile(FAST_COMPILE)(ys_batch))
    key = jr.PRNGKey(2)
    bpf_want, bpf_draws = {}, {}
    for n in WORLDS:
        mesh = jmake_mesh((n,), ("particle",))
        for mode in ("local", "gather"):
            bpf_want[n, mode] = jax.device_get(jsharded_bpf(
                jbpf, ys_bpf, P, mesh, key=key, resampling_mode=mode))
            bpf_draws[n, mode] = jax_bpf_draws(key, n, mode)
    eps = np.random.default_rng(3).standard_normal((GSF_M, 2))
    return dict(ys_bpf=t(ys_bpf), ys_batch=t(ys_batch), want_ekf=want_ekf,
                bpf_want=bpf_want, bpf_draws=bpf_draws, eps=t(eps))


def world_cases(problem, n):
    cases = [
        (f"ekf {dt}", "batched_ekf",
         dict(model=EKF_MODEL, ys=problem["ys_batch"], dtype=dt))
        for dt in (torch.float64, torch.float32)]
    cases.append(("ekf slice", "batched_ekf",
                  dict(model=EKF_MODEL, ys=problem["ys_batch"],
                       gather=False)))
    cases.append(("gsf", "batched_gsf",
                  dict(model=EKF_MODEL, ys=problem["ys_batch"], M=GSF_M,
                       eps=problem["eps"])))
    cases += [(f"bpf {mode}", "bpf",
               dict(model=BPF_MODEL, ys=problem["ys_bpf"], P=P,
                    mode=mode, draws=problem["bpf_draws"][n, mode]))
              for mode in ("local", "gather")]
    return cases


@pytest.fixture(scope="module")
def ranks(problem):
    """Each world size's per-rank results of every case: one spawn each,
    the three at once."""
    return spawn_worlds(WORLDS, lambda n: world_cases(problem, n))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", WORLDS)
def test_batched_ekf_matches_the_jax_ekf_over_the_batch(ranks, problem, n,
                                                        dtype):
    got = ranks[n][0][f"ekf {dtype}"]
    want = problem["want_ekf"]
    for name in ("filtered_means", "filtered_covariances",
                 "marginal_loglik"):
        assert_close(got[name], getattr(want, name), TOL[dtype])


@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_returns_the_whole_batch(ranks, n):
    first = ranks[n][0]
    assert first["ekf torch.float64"]["filtered_means"].shape == (B, T_EKF, 2)
    for other in ranks[n][1:]:
        for key in ("ekf torch.float64", "gsf"):
            for name, x in first[key].items():
                assert torch.equal(other[key][name], x), (key, name)


@pytest.mark.parametrize("n", WORLDS)
def test_batched_filter_without_the_gather_keeps_each_ranks_slice(
        ranks, problem, n):
    want = problem["want_ekf"]
    size = B // n
    for rank, out in enumerate(ranks[n]):
        got = out["ekf slice"]
        rows = slice(rank * size, (rank + 1) * size)
        for name in ("filtered_means", "marginal_loglik"):
            assert got[name].shape[0] == size
            assert_close(got[name], getattr(want, name)[rows],
                         TOL[torch.float64])


@pytest.mark.parametrize("n", WORLDS)
def test_batched_filter_of_a_one_sequence_filter(ranks, n):
    """The GSF takes one sequence: each rank runs its slice one sequence
    at a time and the outputs are stacked and gathered."""
    got = ranks[n][0]["gsf"]
    assert got["means"].shape == (B, GSF_M, T_EKF, 2)
    assert_close(got["means"], got["single_means"], 1e-12)
    assert_close(got["loglik"], got["single_loglik"], 1e-12)


@pytest.mark.parametrize("mode", ["local", "gather"])
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_bpf_matches_jax_with_its_key_schedule(ranks, problem, n,
                                                       mode):
    want = problem["bpf_want"][n, mode]
    for rank_out in ranks[n]:
        got = rank_out[f"bpf {mode}"]
        assert_close(got["means"], want["means"], TOL[torch.float64])
        assert_close(got["ess"], want["ess"], TOL[torch.float64])


@pytest.mark.parametrize("mode", ["local", "gather"])
def test_sharded_bpf_shapes_do_not_depend_on_the_rank_count(ranks, mode):
    """Weak scaling: the summaries keep their shapes as the ranks double,
    and the ESS stays in (0, P]."""
    for n in WORLDS:
        got = ranks[n][0][f"bpf {mode}"]
        assert got["means"].shape == (T_BPF, 2)
        assert got["ess"].shape == (T_BPF,)
        assert bool((got["ess"] > 0).all() and (got["ess"] <= P + 1e-6).all())


def fake_mesh(axis, size=4):
    """A rank of a 4-rank axis, for the argument checks that raise before
    any collective."""
    return Mesh(None, axis, 0, size, torch.device("cpu"))


def test_indivisible_sizes_raise():
    from bayesianfiltering_tpu_torch.models import zoo

    model, params, bpf = zoo.linear_gaussian(2, 2, device="cpu")
    ys = torch.zeros(6, 5, 2)
    with pytest.raises(ValueError, match="divisible"):
        batched_filter(extended_kalman_filter, params, ys,
                       mesh=fake_mesh("batch"))
    with pytest.raises(ValueError, match="divisible"):
        sharded_bootstrap_particle_filter(
            bpf, ys[0], 30, fake_mesh("particle"),
            torch.Generator().manual_seed(0))


def test_a_mesh_axis_must_match_the_function():
    from bayesianfiltering_tpu_torch.models import zoo

    _, params, bpf = zoo.linear_gaussian(2, 2, device="cpu")
    with pytest.raises(ValueError, match="mesh axis"):
        sharded_bootstrap_particle_filter(
            bpf, torch.zeros(5, 2), 32, fake_mesh("batch"),
            torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="resampling_mode"):
        sharded_bootstrap_particle_filter(
            bpf, torch.zeros(5, 2), 32, fake_mesh("particle"),
            torch.Generator().manual_seed(0), resampling_mode="global")


def test_make_mesh_without_a_group():
    """A world of one rank is a mesh without torch.distributed; a larger
    one needs a group of its size, and the layer's meshes have one axis."""
    mesh = make_mesh((1,), ("batch",), device="cpu")
    assert (mesh.rank, mesh.size, mesh.axis_name) == (0, 1, "batch")
    assert mesh.block(8) == (0, 8)
    with pytest.raises(ValueError, match="group of 1"):
        make_mesh((2,), ("batch",), device="cpu")
    with pytest.raises(ValueError, match="one mesh axis"):
        make_mesh((1, 1), ("a", "b"), device="cpu")


def test_a_failing_rank_fails_the_call():
    with pytest.raises(RuntimeError, match="a rank failed"):
        run_ranks(run_cases, 2, [("x", "no such kind", {})], device="cpu",
                  timeout_s=60)
